// The dense-Schur local BA's per-edge terms and point blocks: three kernels
// of one LM step over a cam-major [C, N] edge table.
//
// Replaces the reference's orbslam2_with_quadrics_tpu/ops/ba.py::
// _dense_schur_step (:409-620) up to the reduced camera system, with its
// _residual_planes (:339-374) and _cost_grid (:377-389): there every
// per-edge scalar is a [C, N] plane laid out for the TPU's (8, 128) tiles
// and the point blocks reach the L local slots by a one-hot MXU matmul per
// camera. It computes what the port's plain version (ops/ba.py::
// dense_terms_plain) computes:
//   * per edge: the residual e = obs - (u, v, u_r), the Jacobians Jc [3x6]
//     and Jp [3x3] (zero for a fixed camera / point), chi2 with the stereo
//     row weighted by is_stereo, ok = valid (z > 0.05), the Huber weight
//     and robust cost (plain chi2 where huber_delta2 is 0);
//   * ba_dense_terms_pass, one block per camera c: Hcc_d[c] = Hcc +
//     lam diag(Hcc) + (1e-8 + fixed_cam) I, bc[c] = -Jc^T W e and the
//     camera's cost; each edge's 27 numbers (Hpp's upper 6, bp's 3, V's 18)
//     added into row c of a [C, L + 1, 27] table (slot L is dropped: not
//     written);
//   * ba_dense_terms_points, one thread per local slot: the table summed
//     over c in camera order, Hpp damped by (1 + lam) on its diagonal plus
//     1e-8 (1.0 where |trace| <= 1e-12), its adjugate inverse Hpi
//     (determinant floored at 1e-20 in magnitude), Hpi bp and
//     VH = V Hpi [C, L, 6, 3];
//   * ba_dense_terms_cost, one block per camera: the robust cost alone (the LM
//     step's accept test at the candidate).
// No float atomics: each block reduces in a fixed order (a warp shuffle
// tree, then the 8 warps in warp order); the cost's per-camera partials are
// added in camera order by the last block to finish (an integer ticket), so
// a run repeats itself bit for bit. Two edges of one camera that share a
// local slot add up, as index_put_(accumulate=True) does: a block sorts its
// edges' (slot, edge) keys (bitonic, in shared memory) and the first edge of
// each run of equal slots sums the run in edge order and writes the slot.
// The build passes -fmad=false; the sums run in another order than the
// plain version's einsums, so the results agree to rounding, not bit for bit.
//
// What bounds it on an H100: bytes of the [C, L + 1, 27] table and of VH.
// At C = 49, N = 1024, L = 8192 the table is 43 MB (zeroed, written where
// edges are, read once) and VH 29 MB written: about 30 us at 3.35 TB/s;
// the edge terms are about 20 MFLOP (under 1 us).
//
// Design (simple and right first): 49 blocks of 256 threads for the terms
// (4 edges a thread at N = 1024), 64 blocks of 128 threads for the points;
// the table is zeroed by cudaMemsetAsync on the launch's stream.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPointThreads = 128;
constexpr int kAcc = 28;   // Hcc's upper triangle (21), the sum Jc^T W e (6), cost
constexpr int kRow = 27;   // a table entry: Hpp upper (6), bp (3), V (18)
constexpr unsigned kNone = 0xffffffffu;

// pointer table, in the order the wrapper passes it
enum {
  kPoses, kPoints, kK, kBf, kPntIdx, kUvr, kIsStereo, kInvSigma2, kValid, kFixedCam,
  kFixedPnt, kPloc, kLam, kNumPtrs
};

struct Problem {
  const float *poses, *points, *K, *bf_ptr;
  const int64_t* pnt_idx;
  const float *uvr, *is_stereo, *inv_sigma2, *valid, *fixed_cam, *fixed_pnt;
  const int64_t* ploc;
  const float* lam_ptr;
  float bf, lam, d2;  // bf and lam where their pointers are null
  int C, N, L, bits;  // bits: the edge index's width in a sort key
};

struct Outputs {
  float *Hcc_d, *bc, *cost, *cost_part, *table;
  unsigned* ticket;
};

struct Camera {  // one camera's pose, read once per block
  float q[4], t[3], R[9], K[4], bf, fc;
};

__device__ __forceinline__ int tri(int i, int j) {  // i <= j, row-major upper of 6
  return i * 6 - (i * (i - 1)) / 2 + (j - i);
}

__device__ void load_camera(const Problem& p, int c, Camera& cam) {
  const float* T = p.poses + 7 * c;
  const float w = T[0], x = T[1], y = T[2], z = T[3];
  cam.q[0] = w; cam.q[1] = x; cam.q[2] = y; cam.q[3] = z;
  cam.t[0] = T[4]; cam.t[1] = T[5]; cam.t[2] = T[6];
  // lie.quat_to_matrix: R = I + 2 w [u]x + 2 (u u^T - u.u I)
  const float un = x * x + y * y + z * z;
  cam.R[0] = 1.0f + 2.0f * (x * x - un);
  cam.R[1] = 2.0f * w * (-z) + 2.0f * (x * y);
  cam.R[2] = 2.0f * w * y + 2.0f * (x * z);
  cam.R[3] = 2.0f * w * z + 2.0f * (y * x);
  cam.R[4] = 1.0f + 2.0f * (y * y - un);
  cam.R[5] = 2.0f * w * (-x) + 2.0f * (y * z);
  cam.R[6] = 2.0f * w * (-y) + 2.0f * (z * x);
  cam.R[7] = 2.0f * w * x + 2.0f * (z * y);
  cam.R[8] = 1.0f + 2.0f * (z * z - un);
  for (int i = 0; i < 4; ++i) cam.K[i] = p.K[i];
  cam.bf = p.bf_ptr ? *p.bf_ptr : p.bf;
  cam.fc = 1.0f - p.fixed_cam[c];
}

struct Residual {
  float e[3], x, y, z, iz, chi2, ok, s, is2;
  int64_t pid;
};

// lie.se3_apply (quat_rotate) and residuals.residual_only of edge i
__device__ __forceinline__ Residual residual(const Problem& p, const Camera& cam, int64_t i) {
  Residual r;
  r.pid = p.pnt_idx[i];
  const float* pw = p.points + 3 * r.pid;
  const float vx = pw[0], vy = pw[1], vz = pw[2];
  const float qx = cam.q[1], qy = cam.q[2], qz = cam.q[3], w = cam.q[0];
  const float tx = 2.0f * (qy * vz - qz * vy);
  const float ty = 2.0f * (qz * vx - qx * vz);
  const float tz = 2.0f * (qx * vy - qy * vx);
  r.x = vx + w * tx + (qy * tz - qz * ty) + cam.t[0];
  r.y = vy + w * ty + (qz * tx - qx * tz) + cam.t[1];
  r.z = vz + w * tz + (qx * ty - qy * tx) + cam.t[2];
  const float zs = fabsf(r.z) < 1e-6f ? 1e-6f : r.z;
  r.iz = 1.0f / zs;
  const float u = cam.K[0] * r.x * r.iz + cam.K[2];
  const float v = cam.K[1] * r.y * r.iz + cam.K[3];
  const float* o = p.uvr + 3 * i;
  r.e[0] = o[0] - u;
  r.e[1] = o[1] - v;
  r.e[2] = o[2] - (u - cam.bf * r.iz);
  r.s = p.is_stereo[i];
  r.is2 = p.inv_sigma2[i];
  r.ok = p.valid[i] * (r.z > 0.05f ? 1.0f : 0.0f);
  r.chi2 = (r.e[0] * r.e[0] + r.e[1] * r.e[1] + r.e[2] * r.e[2] * r.s) * r.is2;
  return r;
}

__device__ __forceinline__ float robust(float chi2, float d2) {
  if (d2 <= 0.0f || !(chi2 > d2)) return chi2;
  return 2.0f * sqrtf(d2 * fmaxf(chi2, 1e-12f)) - d2;
}

// the weighted Jacobian rows of edge r: Jc [3][6], Jp [3][3], row weights
struct Jacobians {
  float Jc[3][6], Jp[3][3], wr[3];
};

__device__ __forceinline__ void jacobians(const Problem& p, const Camera& cam, const Residual& r,
                                          Jacobians& J) {
  const float fx = cam.K[0], fy = cam.K[1];
  const float iz2 = r.iz * r.iz;
  float hw = 1.0f;
  if (p.d2 > 0.0f && !(r.chi2 <= p.d2)) hw = sqrtf(p.d2 / fmaxf(r.chi2, 1e-12f));
  const float w = r.ok * r.is2 * hw;
  J.wr[0] = w;
  J.wr[1] = w;
  J.wr[2] = r.s * w;
  const float fp = 1.0f - p.fixed_pnt[r.pid];
  // d(u, v, u_r)/d(camera point) rows (a0, a1, a2)
  const float a[3][3] = {{fx * r.iz, 0.0f, -fx * r.x * iz2},
                         {0.0f, fy * r.iz, -fy * r.y * iz2},
                         {fx * r.iz, 0.0f, -fx * r.x * iz2 + cam.bf * iz2}};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float a0 = a[k][0], a1 = a[k][1], a2 = a[k][2];
    // -(a @ [-hat(pc) | I]), -hat(pc) = [[0, z, -y], [-z, 0, x], [y, -x, 0]]
    J.Jc[k][0] = -(a1 * (-r.z) + a2 * r.y) * cam.fc;
    J.Jc[k][1] = -(a0 * r.z + a2 * (-r.x)) * cam.fc;
    J.Jc[k][2] = -(a0 * (-r.y) + a1 * r.x) * cam.fc;
    J.Jc[k][3] = -a0 * cam.fc;
    J.Jc[k][4] = -a1 * cam.fc;
    J.Jc[k][5] = -a2 * cam.fc;
#pragma unroll
    for (int j = 0; j < 3; ++j)
      J.Jp[k][j] = -(a0 * cam.R[j] + a1 * cam.R[3 + j] + a2 * cam.R[6 + j]) * fp;
  }
}

// block-wide sums of kAcc values per thread, in a fixed order; the result
// lands in red[0][...]
__device__ void block_sum(float* acc, float (*red)[kAcc]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int v = 0; v < kAcc; ++v) {
    float s = acc[v];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s = s + __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) red[warp][v] = s;
  }
  __syncthreads();
  if (threadIdx.x < kAcc) {
    float s = red[0][threadIdx.x];
    for (int w = 1; w < kWarps; ++w) s = s + red[w][threadIdx.x];
    acc[0] = s;
  }
}

// the cost partial of camera c into cost_part; the last block to finish
// adds the partials in camera order into *cost
__device__ void cost_total(const Problem& p, const Outputs& out, int c, float part) {
  __shared__ bool last;
  if (threadIdx.x == 0) {
    out.cost_part[c] = part;
    __threadfence();
    last = atomicAdd(out.ticket, 1u) == static_cast<unsigned>(p.C - 1);
  }
  __syncthreads();
  if (last && threadIdx.x == 0) {
    __threadfence();
    const volatile float* cp = out.cost_part;
    float s = cp[0];
    for (int k = 1; k < p.C; ++k) s = s + cp[k];
    *out.cost = s;
  }
}

__global__ void __launch_bounds__(kThreads)
ba_dense_terms_cost(const Problem p, const Outputs out) {
  __shared__ Camera cam;
  __shared__ float red[kWarps];
  const int c = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) load_camera(p, c, cam);
  __syncthreads();
  float s = 0.0f;
  for (int n = threadIdx.x; n < p.N; n += kThreads) {
    const Residual r = residual(p, cam, static_cast<int64_t>(c) * p.N + n);
    s = s + robust(r.chi2, p.d2) * r.ok;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s = s + __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) red[warp] = s;
  __syncthreads();
  float part = red[0];
  for (int w = 1; w < kWarps; ++w) part = part + red[w];
  cost_total(p, out, c, part);
}

__global__ void __launch_bounds__(kThreads)
ba_dense_terms_pass(const Problem p, const Outputs out) {
  extern __shared__ unsigned keys[];  // [M]: M = 1 << p.bits, the sorted (slot, edge) keys
  __shared__ Camera cam;
  __shared__ float red[kWarps][kAcc];
  __shared__ float total[kAcc];
  const int c = blockIdx.x, tid = threadIdx.x;
  const int M = 1 << p.bits;
  if (tid == 0) load_camera(p, c, cam);
  const int64_t base = static_cast<int64_t>(c) * p.N;
  for (int i = tid; i < M; i += kThreads) {
    unsigned key = kNone;
    if (i < p.N) {
      const int64_t slot = p.ploc[base + i];
      if (slot < p.L) key = (static_cast<unsigned>(slot) << p.bits) | static_cast<unsigned>(i);
    }
    keys[i] = key;
  }
  __syncthreads();

  // the camera's blocks and cost
  float acc[kAcc] = {};
  for (int n = tid; n < p.N; n += kThreads) {
    const Residual r = residual(p, cam, base + n);
    acc[kAcc - 1] = acc[kAcc - 1] + robust(r.chi2, p.d2) * r.ok;
    Jacobians J;
    jacobians(p, cam, r, J);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        const float jw = J.Jc[k][i] * J.wr[k];
#pragma unroll
        for (int j = i; j < 6; ++j) acc[tri(i, j)] = acc[tri(i, j)] + jw * J.Jc[k][j];
        acc[21 + i] = acc[21 + i] + jw * r.e[k];
      }
    }
  }
  block_sum(acc, red);
  if (tid < kAcc) total[tid] = acc[0];
  __syncthreads();
  if (tid < 21) {
    int i = 0;
    while (tri(i, 5) < tid) ++i;
    const int j = i + (tid - tri(i, i));
    const float lam = p.lam_ptr ? *p.lam_ptr : p.lam;
    float h = total[tid];
    if (i == j) h = (h + lam * h) + (1e-8f + p.fixed_cam[c]);
    out.Hcc_d[36 * c + 6 * i + j] = h;
    out.Hcc_d[36 * c + 6 * j + i] = h;
  } else if (tid < 27) {
    out.bc[6 * c + tid - 21] = -total[tid];
  }

  // bitonic sort of the keys, ascending
  for (int k = 2; k <= M; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < M; i += kThreads) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const unsigned a = keys[i], b = keys[ixj];
          if ((a > b) == ((i & k) == 0)) {
            keys[i] = b;
            keys[ixj] = a;
          }
        }
      }
      __syncthreads();
    }
  }
  // the first edge of each run of one slot sums the run in edge order
  const unsigned mask = (1u << p.bits) - 1u;
  for (int i = tid; i < M; i += kThreads) {
    const unsigned key = keys[i];
    if (key == kNone || (i > 0 && (keys[i - 1] >> p.bits) == (key >> p.bits))) continue;
    const unsigned slot = key >> p.bits;
    float row[kRow] = {};
    for (int m = i; m < M && keys[m] != kNone && (keys[m] >> p.bits) == slot; ++m) {
      const Residual r = residual(p, cam, base + (keys[m] & mask));
      Jacobians J;
      jacobians(p, cam, r, J);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        float pw[3];
#pragma unroll
        for (int a = 0; a < 3; ++a) pw[a] = J.Jp[k][a] * J.wr[k];
        row[0] = row[0] + pw[0] * J.Jp[k][0];
        row[1] = row[1] + pw[0] * J.Jp[k][1];
        row[2] = row[2] + pw[0] * J.Jp[k][2];
        row[3] = row[3] + pw[1] * J.Jp[k][1];
        row[4] = row[4] + pw[1] * J.Jp[k][2];
        row[5] = row[5] + pw[2] * J.Jp[k][2];
#pragma unroll
        for (int a = 0; a < 3; ++a) row[6 + a] = row[6 + a] - pw[a] * r.e[k];
#pragma unroll
        for (int a = 0; a < 6; ++a) {
          const float cw = J.Jc[k][a] * J.wr[k];
#pragma unroll
          for (int b = 0; b < 3; ++b) row[9 + 3 * a + b] = row[9 + 3 * a + b] + cw * J.Jp[k][b];
        }
      }
    }
    float* dst = out.table + (static_cast<int64_t>(c) * (p.L + 1) + slot) * kRow;
#pragma unroll
    for (int v = 0; v < kRow; ++v) dst[v] = row[v];
  }
  __syncthreads();
  cost_total(p, out, c, total[kAcc - 1]);
}

__global__ void __launch_bounds__(kPointThreads)
ba_dense_terms_points(const float* __restrict__ table, const float* lam_ptr, float lam_val, int C,
                 int L, float* __restrict__ Hpi, float* __restrict__ bp,
                 float* __restrict__ Hpib, float* __restrict__ VH) {
  const int l = blockIdx.x * kPointThreads + threadIdx.x;
  if (l >= L) return;
  const float lam = lam_ptr ? *lam_ptr : lam_val;
  const int64_t stride = static_cast<int64_t>(L + 1) * kRow;
  float h[9] = {};
  for (int c = 0; c < C; ++c) {
    const float* src = table + c * stride + static_cast<int64_t>(l) * kRow;
#pragma unroll
    for (int v = 0; v < 9; ++v) h[v] = h[v] + src[v];
  }
  // the damped block (upper entries 0..5 = 00 01 02 11 12 22), then its
  // adjugate inverse as ops/ba.py::_inv3x3
  const float trace = (h[0] + h[3]) + h[5];
  const float add = fabsf(trace) > 1e-12f ? 1e-8f : 1.0f;
  const float a = (h[0] + lam * h[0]) + add, e = (h[3] + lam * h[3]) + add,
              i = (h[5] + lam * h[5]) + add;
  const float b = h[1], c_ = h[2], d = h[1], f = h[4], g = h[2], hh = h[4];
  const float co_a = e * i - f * hh;
  const float co_b = -(d * i - f * g);
  const float co_c = d * hh - e * g;
  const float det = a * co_a + b * co_b + c_ * co_c;
  const float idet = 1.0f / (fabsf(det) < 1e-20f ? 1e-20f : det);
  const float inv[9] = {co_a * idet, -(b * i - c_ * hh) * idet, (b * f - c_ * e) * idet,
                        co_b * idet, (a * i - c_ * g) * idet, -(a * f - c_ * d) * idet,
                        co_c * idet, -(a * hh - b * g) * idet, (a * e - b * d) * idet};
#pragma unroll
  for (int v = 0; v < 9; ++v) Hpi[9 * l + v] = inv[v];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    bp[3 * l + j] = h[6 + j];
    Hpib[3 * l + j] = inv[3 * j] * h[6] + inv[3 * j + 1] * h[7] + inv[3 * j + 2] * h[8];
  }
  for (int c = 0; c < C; ++c) {
    const float* V = table + c * stride + static_cast<int64_t>(l) * kRow + 9;
    float* dst = VH + (static_cast<int64_t>(c) * L + l) * 18;
#pragma unroll
    for (int r = 0; r < 6; ++r) {
      const float v0 = V[3 * r], v1 = V[3 * r + 1], v2 = V[3 * r + 2];
#pragma unroll
      for (int k = 0; k < 3; ++k) dst[3 * r + k] = v0 * inv[k] + v1 * inv[3 + k] + v2 * inv[6 + k];
    }
  }
}

Problem problem(const int64_t* ptrs, float bf, float lam, float d2, int C, int N, int L) {
  Problem p{};
  p.poses = reinterpret_cast<const float*>(ptrs[kPoses]);
  p.points = reinterpret_cast<const float*>(ptrs[kPoints]);
  p.K = reinterpret_cast<const float*>(ptrs[kK]);
  p.bf_ptr = reinterpret_cast<const float*>(ptrs[kBf]);
  p.pnt_idx = reinterpret_cast<const int64_t*>(ptrs[kPntIdx]);
  p.uvr = reinterpret_cast<const float*>(ptrs[kUvr]);
  p.is_stereo = reinterpret_cast<const float*>(ptrs[kIsStereo]);
  p.inv_sigma2 = reinterpret_cast<const float*>(ptrs[kInvSigma2]);
  p.valid = reinterpret_cast<const float*>(ptrs[kValid]);
  p.fixed_cam = reinterpret_cast<const float*>(ptrs[kFixedCam]);
  p.fixed_pnt = reinterpret_cast<const float*>(ptrs[kFixedPnt]);
  p.ploc = reinterpret_cast<const int64_t*>(ptrs[kPloc]);
  p.lam_ptr = reinterpret_cast<const float*>(ptrs[kLam]);
  p.bf = bf;
  p.lam = lam;
  p.d2 = d2;
  p.C = C;
  p.N = N;
  p.L = L;
  while ((1 << p.bits) < N) ++p.bits;
  return p;
}

}  // namespace

// ptrs: kNumPtrs addresses (poses, points, K, bf or 0, pnt_idx, uvr,
// is_stereo, inv_sigma2, valid, fixed_cam, fixed_pnt, ploc, lam or 0);
// out: Hcc_d [C,6,6], bc [C,6], cost [], cost_part [C] and ticket (scratch),
// table [C, L + 1, 27]. Zeroes the ticket and the table, then one launch.
extern "C" int ba_dense_terms_launch(const int64_t* ptrs, float bf, float lam, float d2, int C,
                                     int N, int L, void* Hcc_d, void* bc, void* cost,
                                     void* cost_part, void* ticket, void* table, void* stream) {
  const Problem p = problem(ptrs, bf, lam, d2, C, N, L);
  const int M = 1 << p.bits;
  // a key holds the slot above the edge index in 32 bits; M keys in shared memory
  if (C < 1 || N < 1 || L < 1 || M > 8192 || (static_cast<uint64_t>(L) << p.bits) >= kNone)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(ticket, 0, sizeof(unsigned), s);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(table, 0, static_cast<size_t>(C) * (L + 1) * kRow * sizeof(float), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Outputs out{static_cast<float*>(Hcc_d), static_cast<float*>(bc),
                    static_cast<float*>(cost), static_cast<float*>(cost_part),
                    static_cast<float*>(table), static_cast<unsigned*>(ticket)};
  ba_dense_terms_pass<<<C, kThreads, M * sizeof(unsigned), s>>>(p, out);
  return static_cast<int>(cudaGetLastError());
}

// table [C, L + 1, 27] from ba_dense_terms_launch; out: Hpi [L,3,3],
// bp [L,3], Hpib [L,3], VH [C,L,6,3].
extern "C" int ba_dense_points_launch(const void* table, const void* lam_ptr, float lam, int C,
                                      int L, void* Hpi, void* bp, void* Hpib, void* VH,
                                      void* stream) {
  if (C < 1 || L < 1) return static_cast<int>(cudaErrorInvalidValue);
  ba_dense_terms_points<<<(L + kPointThreads - 1) / kPointThreads, kPointThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(table), static_cast<const float*>(lam_ptr), lam, C, L,
      static_cast<float*>(Hpi), static_cast<float*>(bp), static_cast<float*>(Hpib),
      static_cast<float*>(VH));
  return static_cast<int>(cudaGetLastError());
}

// the robust cost alone: ptrs as above (ploc and lam unused), out: cost []
// and the scratch cost_part [C] and ticket.
extern "C" int ba_dense_cost_launch(const int64_t* ptrs, float bf, float d2, int C, int N,
                                    void* cost, void* cost_part, void* ticket, void* stream) {
  if (C < 1 || N < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Problem p = problem(ptrs, bf, 0.0f, d2, C, N, 1);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = cudaMemsetAsync(ticket, 0, sizeof(unsigned), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Outputs out{nullptr, nullptr, static_cast<float*>(cost), static_cast<float*>(cost_part),
                    nullptr, static_cast<unsigned*>(ticket)};
  ba_dense_terms_cost<<<C, kThreads, 0, s>>>(p, out);
  return static_cast<int>(cudaGetLastError());
}
