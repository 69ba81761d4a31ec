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
//   * ba_dense_terms_pass, S = ceil(N / 256) blocks per camera, one edge a
//     thread: each block's partial Hcc upper triangle, Jc^T W e and cost;
//     the last block of a camera to finish (an integer ticket) sums the S
//     partials in block order into Hcc_d[c] = Hcc + lam diag(Hcc) +
//     (1e-8 + fixed_cam) I, bc[c] = -Jc^T W e and the camera's cost, and
//     the last camera adds the costs in camera order. Each local edge's
//     point side, V's 18, Hpp's upper 6 and bp's 3 formed in float64 from
//     float64 Jacobians, and its camera go to its row of an [E, 28] float64
//     buffer, and its V in float32 to an [E, 20] one, in the order of the
//     point-major edge index (ops/ba.py::LocalEdges, built once per solve:
//     the edges by slot, in flat edge order inside a slot);
//   * ba_dense_terms_slots, one block of 256 threads per tile of 16 slots:
//     the tile's rows of V and VH zeroed for every camera with 16-byte
//     streaming stores in the layout [C, 6, Lp, 3] (Lp = L rounded up to
//     16), the
//     [6C, 3L] matrix of the S product, which the wrapper hands out as
//     [C, L, 6, 3] views; a thread a slot sums its segment of the buffer in
//     segment order into Hpp, damped by (1 + lam) on its diagonal plus 1e-8
//     (1.0 where |trace| <= 1e-12, an empty slot), its adjugate inverse Hpi
//     (determinant floored at 1e-20 in magnitude), bp and Hpi bp; then a
//     thread an edge of the tile: the first edge of each (camera, slot) run
//     sums the run in index order and writes that pair's V and VH = V Hpi
//     over the zeros;
//   * ba_dense_terms_cost, the terms pass's grid: the robust cost alone
//     (the LM step's accept test at the candidate), summed in the terms
//     pass's order, so both give the same number for the same state.
// No float atomics: a block reduces in a fixed order (a lane-transpose
// reduction in each warp, the 8 warps in warp order), partials are added
// in block and camera order by the last block (integer tickets), and a
// slot's edges are added by one thread in index order, so a run repeats
// itself bit for bit. The camera side (Hcc_d, bc, the cost) is float32 per
// edge, rounded as the plain version's ops on the card round it (-fmad=
// false, and a fused multiply-add by name where torch's op rounds as one:
// its cross products, the batched products of Jp), summed in float64. The
// point side (V, Hpi, bp, Hpi bp, VH) is float64 throughout, each output
// rounded once: the gradients cancel, and a point seen from nearly one
// direction has a near-singular block whose inverse, and its product with
// the coupling, the float32 rounding of its edges would decide; these are
// held to a float64 evaluation. So V and VH come from two different V's:
// the V handed out, which is held to the plain version within 1e-5, is
// formed in float32 as the plain version's ops round it on the card (each
// edge's V, and a (camera, slot) of at most two edges, bit for bit), and VH
// is the float64 V times Hpi, rounded once. The first is tied to how torch
// and cuBLAS round their ops (a fused multiply-add in the cross product,
// the batched products and the einsum, a 3-term sum outer pair first), which
// tests/test_torch_map_kernels.py::test_plain_route_rounds_as_the_kernel_models
// checks on the card.
//
// What bounds it on an H100: bytes. At C = 49, N = 1024, L = 8192 (about
// 50k local edges) V and VH are 29 MB each, written once (about 17 us at
// 3.35 TB/s); the float64 edge buffer is 11 MB written and read back (L2);
// the edges' inputs are read twice (terms and cost, 1.6 MB each); the edge
// terms are about 20 MFLOP (under 1 us).
//
// The design against the first version (a [C, L + 1, 27] table zeroed by a
// 43 MB memset, written where edges are and read back whole; a bitonic sort
// of each camera's (slot, edge) keys on every step; 49 blocks for the terms
// and a point pass of 64 blocks whose threads walked 108 B apart): the sort
// is the index, built once per solve; the table is the edge buffer, which
// holds only the local edges; the terms pass runs 4 blocks per camera (196
// at N = 1024); the slot pass runs 512 blocks that store whole 16-byte
// words of V and VH, which the S product then reads without a copy. Its
// (camera, slot) sums are spread a thread an edge, not walked by one thread
// a slot: on the mono map's window a few hundred observed slots of about 6
// edges each sit in the first blocks, and a thread that walks its slot's
// edges camera by camera makes a chain of dependent loads. The zeros alone
// take 0.019 ms there, about the bytes bound of V and VH; the observed
// tiles' sums come after their zeros, which 16-slot tiles and streaming
// stores shorten (0.037 -> 0.032 and 0.030 ms each, PERF.md).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // terms and cost passes: one edge a thread
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 16;          // slot pass: slots per block
constexpr int kSlotThreads = 256;  // and its threads: one edge of the tile a thread
constexpr int kAcc = 28;       // Hcc's upper triangle (21), the sum Jc^T W e (6), cost
// an edge's row of the buffer, in float64: V (18), Hpp's upper 6, bp's 3, camera
constexpr int kRow = 28;
constexpr int kVRow = 20;  // and of the float32 V buffer: V (18), a pad

// pointer table, in the order the wrapper passes it
enum {
  kPoses, kPoints, kK, kBf, kPntIdx, kUvr, kIsStereo, kInvSigma2, kValid, kFixedCam,
  kFixedPnt, kLam, kNumPtrs
};

struct Problem {
  const float *poses, *points, *K, *bf_ptr;
  const int64_t* pnt_idx;
  const float *uvr, *is_stereo, *inv_sigma2, *valid, *fixed_cam, *fixed_pnt;
  const float* lam_ptr;
  float bf, lam, d2;  // bf and lam where their pointers are null
  double d2_64;       // the Huber threshold as the float64 evaluation has it
  int C, N, S;        // S: blocks per camera
};

struct Outputs {
  float *Hcc_d, *bc, *cost;
  double* part;       // [C S, 28] the blocks' partials (the cost pass: [C S]), then [C] costs
  double* rows;       // [E, 28] the local edges' rows, in index order
  float* vrows;       // [E, 20] their V in float32 (18) and a pad, in index order
  const int* pos;     // [E] each edge's row, -1 for an edge of no local slot
  unsigned* tickets;  // [C + 1]
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
  // lie.quat_to_matrix: R = I + 2 w [u]x + 2 (u u^T - u.u I); torch.sum of
  // three adds the outer two first
  const float un = (x * x + z * z) + y * y;
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
  // torch.linalg.cross on the card rounds a_i b_j - a_j b_i as one fused
  // multiply-add, fma(a_i, b_j, -(a_j b_i))
  const float tx = 2.0f * __fmaf_rn(qy, vz, -(qz * vy));
  const float ty = 2.0f * __fmaf_rn(qz, vx, -(qx * vz));
  const float tz = 2.0f * __fmaf_rn(qx, vy, -(qy * vx));
  r.x = vx + w * tx + __fmaf_rn(qy, tz, -(qz * ty)) + cam.t[0];
  r.y = vy + w * ty + __fmaf_rn(qz, tx, -(qx * tz)) + cam.t[1];
  r.z = vz + w * tz + __fmaf_rn(qx, ty, -(qy * tx)) + cam.t[2];
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
  r.chi2 = ((r.e[0] * r.e[0] + r.e[2] * r.e[2] * r.s) + r.e[1] * r.e[1]) * r.is2;
  return r;
}

// Edge i's point side in float64 from the float inputs, as the float64
// evaluation of residuals.residual_and_jacobians and dense_terms_plain's
// weights forms it (lie.quat_to_matrix's R, the camera point, d(u, v,
// u_r)/d(camera point), Jc and Jp, the Huber weight where d2 > 0, z >
// 0.05): row = V = Jc^T W Jp (18), Hpp's upper 6, bp = -Jp^T W e (3), and
// the camera c. Every point-side output is formed from these, so that a
// block seen from nearly one direction and its coupling come from the same
// Jacobians and carry no float32 rounding.
__device__ __forceinline__ void point_side_f64(const Problem& p, int c, int64_t i,
                                               double (&row)[kRow]) {
  const float* T = p.poses + 7 * c;
  const double w = T[0], x = T[1], y = T[2], z = T[3];
  const double un = x * x + y * y + z * z;
  const double R[9] = {1.0 + 2.0 * (x * x - un), 2.0 * w * (-z) + 2.0 * (x * y),
                       2.0 * w * y + 2.0 * (x * z), 2.0 * w * z + 2.0 * (y * x),
                       1.0 + 2.0 * (y * y - un), 2.0 * w * (-x) + 2.0 * (y * z),
                       2.0 * w * (-y) + 2.0 * (z * x), 2.0 * w * x + 2.0 * (z * y),
                       1.0 + 2.0 * (z * z - un)};
  const int64_t pid = p.pnt_idx[i];
  const double vx = p.points[3 * pid], vy = p.points[3 * pid + 1], vz = p.points[3 * pid + 2];
  const double tx = 2.0 * (y * vz - z * vy), ty = 2.0 * (z * vx - x * vz),
               tz = 2.0 * (x * vy - y * vx);
  const double cx = vx + w * tx + (y * tz - z * ty) + static_cast<double>(T[4]);
  const double cy = vy + w * ty + (z * tx - x * tz) + static_cast<double>(T[5]);
  const double cz = vz + w * tz + (x * ty - y * tx) + static_cast<double>(T[6]);
  const double fx = p.K[0], fy = p.K[1], bf = p.bf_ptr ? *p.bf_ptr : p.bf;
  const double iz = 1.0 / (fabs(cz) < 1e-6 ? 1e-6 : cz), iz2 = iz * iz;
  const double u = fx * cx * iz + static_cast<double>(p.K[2]);
  const double v = fy * cy * iz + static_cast<double>(p.K[3]);
  const float* o = p.uvr + 3 * i;
  const double e[3] = {o[0] - u, o[1] - v, o[2] - (u - bf * iz)};
  const double s = p.is_stereo[i], is2 = p.inv_sigma2[i];
  const double ok = p.valid[i] * (cz > 0.05 ? 1.0 : 0.0);
  const double chi2 = (e[0] * e[0] + e[1] * e[1] + e[2] * e[2] * s) * is2;
  const double d2 = p.d2_64;
  const double hw = d2 > 0.0 && !(chi2 <= d2) ? sqrt(d2 / fmax(chi2, 1e-12)) : 1.0;
  const double wgt = ok * is2 * hw;
  const double wr[3] = {wgt, wgt, s * wgt};
  const double fp = 1.0 - p.fixed_pnt[pid], fc = 1.0 - p.fixed_cam[c];
  const double a[3][3] = {{fx * iz, 0.0, -fx * cx * iz2},
                          {0.0, fy * iz, -fy * cy * iz2},
                          {fx * iz, 0.0, -fx * cx * iz2 + bf * iz2}};
#pragma unroll
  for (int k = 0; k < kRow; ++k) row[k] = 0.0;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const double a0 = a[k][0], a1 = a[k][1], a2 = a[k][2];
    // -(a @ [-hat(pc) | I]), -(a @ R)
    const double Jc[6] = {-(a1 * (-cz) + a2 * cy) * fc, -(a0 * cz + a2 * (-cx)) * fc,
                          -(a0 * (-cy) + a1 * cx) * fc, -a0 * fc, -a1 * fc, -a2 * fc};
    double Jp[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) Jp[j] = -(a0 * R[j] + a1 * R[3 + j] + a2 * R[6 + j]) * fp;
#pragma unroll
    for (int m = 0; m < 6; ++m)
#pragma unroll
      for (int n = 0; n < 3; ++n) row[3 * m + n] += wr[k] * Jc[m] * Jp[n];
    int q = 18;
#pragma unroll
    for (int m = 0; m < 3; ++m) {
#pragma unroll
      for (int n = m; n < 3; ++n) row[q++] += wr[k] * Jp[m] * Jp[n];
      row[24 + m] -= wr[k] * Jp[m] * e[k];
    }
  }
  row[27] = c;
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
    // (cuBLAS rounds this product's two-term entries as separate products
    // and a sum), and -(a @ R), which it rounds as fused multiply-adds in k
    // order
    J.Jc[k][0] = -(a1 * (-r.z) + a2 * r.y) * cam.fc;
    J.Jc[k][1] = -(a0 * r.z + a2 * (-r.x)) * cam.fc;
    J.Jc[k][2] = -(a0 * (-r.y) + a1 * r.x) * cam.fc;
    J.Jc[k][3] = -a0 * cam.fc;
    J.Jc[k][4] = -a1 * cam.fc;
    J.Jc[k][5] = -a2 * cam.fc;
#pragma unroll
    for (int j = 0; j < 3; ++j)
      J.Jp[k][j] = __fmaf_rn(-a2, cam.R[6 + j], __fmaf_rn(-a1, cam.R[3 + j], -a0 * cam.R[j])) * fp;
  }
}

template <int H>
__device__ __forceinline__ void transpose_step(double (&v)[32], int lane) {
  const bool upper = (lane & H) != 0;
#pragma unroll
  for (int k = 0; k < H; ++k) {
    const double send = upper ? v[k] : v[k + H];
    const double keep = upper ? v[k + H] : v[k];
    v[k] = keep + __shfl_xor_sync(0xffffffffu, send, H);
  }
}

// Lane-transpose reduction of 32 values a lane over the warp in 31
// shuffles: lane l ends with the warp's sum of v[l]. Each sum is the
// butterfly of a shuffle-xor tree, so it repeats bit for bit.
__device__ __forceinline__ double warp_transpose_sum(double (&v)[32]) {
  const int lane = threadIdx.x & 31;
  transpose_step<16>(v, lane);
  transpose_step<8>(v, lane);
  transpose_step<4>(v, lane);
  transpose_step<2>(v, lane);
  transpose_step<1>(v, lane);
  return v[0];
}

__device__ __forceinline__ float block_cost(const Problem& p, const Camera& cam, int c, int n) {
  if (n >= p.N) return 0.0f;
  const Residual r = residual(p, cam, static_cast<int64_t>(c) * p.N + n);
  return robust(r.chi2, p.d2) * r.ok;
}

// Thread 0's total of the cameras' costs, each the sum of its S block
// partials part[c S + s] in block order, added in camera order: the block
// sums the cameras in parallel into buf (kThreads floats) and thread 0 adds
// them. Called by the whole block of the last block to finish.
__device__ double cameras_total(const double* part, int C, int S, double* buf) {
  double total = 0.0;
  for (int base = 0; base < C; base += kThreads) {
    const int c = base + threadIdx.x;
    if (c < C) {
      const double* q = part + static_cast<int64_t>(c) * S;
      double cs = __ldcg(q);
      for (int s = 1; s < S; ++s) cs = cs + __ldcg(q + s);
      buf[threadIdx.x] = cs;
    }
    __syncthreads();
    if (threadIdx.x == 0)
      for (int k = 0; k < min(kThreads, C - base); ++k)
        total = base + k == 0 ? buf[k] : total + buf[k];
    __syncthreads();
  }
  return total;
}

__global__ void __launch_bounds__(kThreads)
ba_dense_terms_cost(const Problem p, const Outputs out) {
  __shared__ Camera cam;
  __shared__ double red[kWarps], buf[kThreads];
  __shared__ bool last;
  const int c = blockIdx.x / p.S, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) load_camera(p, c, cam);
  __syncthreads();
  double s = block_cost(p, cam, c, (blockIdx.x % p.S) * kThreads + threadIdx.x);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s = s + __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) red[warp] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    double part = red[0];
    for (int w = 1; w < kWarps; ++w) part = part + red[w];
    out.part[blockIdx.x] = part;
    __threadfence();
    last = atomicAdd(out.tickets, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const double total = cameras_total(out.part, p.C, p.S, buf);
  if (threadIdx.x == 0) *out.cost = static_cast<float>(total);
}

__global__ void __launch_bounds__(kThreads, 2)
ba_dense_terms_pass(const Problem p, const Outputs out) {
  __shared__ Camera cam;
  __shared__ double red[kWarps][32];
  __shared__ bool last;
  const int c = blockIdx.x / p.S, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) load_camera(p, c, cam);
  __syncthreads();

  double acc[32] = {};  // kAcc sums in float64, padded to the warp's 32 lanes
  const int n = (blockIdx.x % p.S) * kThreads + tid;
  if (n < p.N) {
    const int64_t e = static_cast<int64_t>(c) * p.N + n;
    const Residual r = residual(p, cam, e);
    Jacobians J;
    jacobians(p, cam, r, J);
    const int at = out.pos[e];
    if (at >= 0) {  // the edge's point has a local slot: its row of the buffer
      double row[kRow];
      point_side_f64(p, c, e, row);
      double2* dst = reinterpret_cast<double2*>(out.rows + static_cast<int64_t>(at) * kRow);
#pragma unroll
      for (int q = 0; q < kRow / 2; ++q) dst[q] = make_double2(row[2 * q], row[2 * q + 1]);
      // and V in float32, its three residual rows summed as the plain
      // version's einsum (a batched product) rounds them: fused
      // multiply-adds in row order; the output V is this one
      float vr[kVRow] = {};
#pragma unroll
      for (int k = 0; k < 3; ++k)
#pragma unroll
        for (int a = 0; a < 6; ++a) {
          const float cw = J.Jc[k][a] * J.wr[k];
#pragma unroll
          for (int b = 0; b < 3; ++b) vr[3 * a + b] = __fmaf_rn(cw, J.Jp[k][b], vr[3 * a + b]);
        }
      float4* vd = reinterpret_cast<float4*>(out.vrows + static_cast<int64_t>(at) * kVRow);
#pragma unroll
      for (int q = 0; q < kVRow / 4; ++q)
        vd[q] = make_float4(vr[4 * q], vr[4 * q + 1], vr[4 * q + 2], vr[4 * q + 3]);
    }
    acc[kAcc - 1] = robust(r.chi2, p.d2) * r.ok;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        const float jw = J.Jc[k][i] * J.wr[k];
#pragma unroll
        for (int j = i; j < 6; ++j)
          acc[tri(i, j)] = __fma_rn(static_cast<double>(jw), static_cast<double>(J.Jc[k][j]),
                                    acc[tri(i, j)]);
        acc[21 + i] = __fma_rn(static_cast<double>(jw), static_cast<double>(r.e[k]), acc[21 + i]);
      }
    }
  }
  red[warp][lane] = warp_transpose_sum(acc);
  __syncthreads();
  double* part = out.part + static_cast<int64_t>(blockIdx.x) * kAcc;
  if (warp == 0 && lane < kAcc) {
    double s = red[0][lane];
    for (int w = 1; w < kWarps; ++w) s = s + red[w][lane];
    part[lane] = s;
    __threadfence();
  }
  __syncthreads();
  if (tid == 0) last = atomicAdd(out.tickets + c, 1u) == static_cast<unsigned>(p.S - 1);
  __syncthreads();
  if (!last) return;

  // the camera's last block: its S partials in block order
  __threadfence();
  double* cam_cost = out.part + static_cast<int64_t>(gridDim.x) * kAcc;
  if (warp == 0 && lane < kAcc) {
    const double* q = out.part + static_cast<int64_t>(c) * p.S * kAcc + lane;
    double hs = __ldcg(q);
#pragma unroll 4
    for (int s = 1; s < p.S; ++s) hs = hs + __ldcg(q + s * kAcc);
    float h = static_cast<float>(hs);
    if (lane < 21) {
      int i = 0;
      while (tri(i, 5) < lane) ++i;
      const int j = i + (lane - tri(i, i));
      const float lam = p.lam_ptr ? *p.lam_ptr : p.lam;
      if (i == j) h = (h + lam * h) + (1e-8f + p.fixed_cam[c]);
      out.Hcc_d[36 * c + 6 * i + j] = h;
      out.Hcc_d[36 * c + 6 * j + i] = h;
    } else if (lane < 27) {
      out.bc[6 * c + lane - 21] = -h;
    } else {
      cam_cost[c] = hs;
      __threadfence();
    }
  }
  __syncthreads();
  // the last camera to finish adds the cameras' costs in camera order
  if (tid == 0) last = atomicAdd(out.tickets + p.C, 1u) == static_cast<unsigned>(p.C - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  const double total = cameras_total(cam_cost, p.C, 1, &red[0][0]);
  if (tid == 0) *out.cost = static_cast<float>(total);
}

__global__ void __launch_bounds__(kSlotThreads)
ba_dense_terms_slots(const double* __restrict__ rows, const float* __restrict__ vrows,
                     const int* __restrict__ offsets, const float* lam_ptr, float lam_val, int C,
                     int L, int Lp, float* __restrict__ Hpi, float* __restrict__ bp,
                     float* __restrict__ Hpib, float* __restrict__ V, float* __restrict__ VH) {
  __shared__ double inv_s[kTile][9];
  __shared__ int off_s[kTile + 1];  // the tile's segments in the index
  const int tid = threadIdx.x, s0 = blockIdx.x * kTile;
  if (tid <= kTile) off_s[tid] = offsets[min(s0 + tid, L)];

  // 1. the tile's rows of V and VH for every camera, zeros: each (array,
  // camera, row) is 3 kTile floats of one row of the [6C, 3Lp] matrix,
  // written as 16-byte words
  constexpr int kWords = 3 * kTile / 4, kRowsAtOnce = kSlotThreads / kWords;
  if (tid < kRowsAtOnce * kWords) {
    const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int row = tid / kWords; row < 12 * C; row += kRowsAtOnce) {  // V's 6C rows, then VH's
      float* dst = (row < 6 * C ? V + static_cast<int64_t>(row) * Lp * 3
                                : VH + static_cast<int64_t>(row - 6 * C) * Lp * 3) + s0 * 3;
      __stcs(reinterpret_cast<float4*>(dst) + tid % kWords, zero);  // evict first
    }
  }

  // 2. one thread a slot: its segment's sums in index order, four edges'
  // loads in flight at a time; the damped block (upper entries 0..5 = 00 01
  // 02 11 12 22), its adjugate inverse as ops/ba.py::_inv3x3, Hpi bp and
  // (below) V Hpi, in float64 from the float64 sums and rounded once: a
  // point seen from nearly one direction has a block whose inverse
  // amplifies every rounding, and these are held to a float64 evaluation
  if (tid < kTile) {
    const int s = s0 + tid;
    double hs[9] = {};
    if (s < L) {
      const int end = offsets[s + 1];
      for (int m = offsets[s]; m < end; m += 4) {
        double v[4][9];
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int k = 0; k < 9; ++k)
            v[q][k] = m + q < end ? rows[static_cast<int64_t>(m + q) * kRow + 18 + k] : 0.0;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (m + q < end)
#pragma unroll
            for (int k = 0; k < 9; ++k) hs[k] = hs[k] + v[q][k];
      }
    }
    const double lam = lam_ptr ? *lam_ptr : lam_val;
    const double trace = (hs[0] + hs[3]) + hs[5];
    const double add = fabs(trace) > 1e-12 ? 1e-8 : 1.0;
    const double a = (hs[0] + lam * hs[0]) + add, e = (hs[3] + lam * hs[3]) + add,
                 i = (hs[5] + lam * hs[5]) + add;
    const double b = hs[1], c_ = hs[2], d = hs[1], f = hs[4], g = hs[2], hh = hs[4];
    const double co_a = e * i - f * hh;
    const double co_b = -(d * i - f * g);
    const double co_c = d * hh - e * g;
    const double det = a * co_a + b * co_b + c_ * co_c;
    const double idet = 1.0 / (fabs(det) < 1e-20 ? 1e-20 : det);
    const double inv[9] = {co_a * idet, -(b * i - c_ * hh) * idet, (b * f - c_ * e) * idet,
                           co_b * idet, (a * i - c_ * g) * idet, -(a * f - c_ * d) * idet,
                           co_c * idet, -(a * hh - b * g) * idet, (a * e - b * d) * idet};
#pragma unroll
    for (int v = 0; v < 9; ++v) inv_s[tid][v] = inv[v];
    if (s < L) {
#pragma unroll
      for (int v = 0; v < 9; ++v) Hpi[9 * s + v] = static_cast<float>(inv[v]);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        bp[3 * s + k] = static_cast<float>(hs[6 + k]);
        Hpib[3 * s + k] = static_cast<float>(inv[3 * k] * hs[6] + inv[3 * k + 1] * hs[7] +
                                             inv[3 * k + 2] * hs[8]);
      }
    }
  }
  // the zeros and the inverses before any (camera, slot) value
  __syncthreads();

  // 3. one thread an edge of the tile: the first edge of each (camera,
  // slot) run (a slot's edges are in camera order) sums the run in index
  // order, V in float32 as the plain version's accumulate and in float64
  // for VH = V Hpi, and writes the pair's 18 + 18 values over the zeros
  const int e0 = off_s[0], e1 = off_s[kTile];
  for (int m = e0 + tid; m < e1; m += kSlotThreads) {
    int t = 0;  // the slot of edge m: the last segment that starts at or before it
#pragma unroll
    for (int step = kTile / 2; step > 0; step >>= 1)
      if (off_s[t + step] <= m) t += step;
    const double cam = rows[static_cast<int64_t>(m) * kRow + 27];
    if (m > off_s[t] && rows[static_cast<int64_t>(m - 1) * kRow + 27] == cam) continue;
    const int end = off_s[t + 1];
    double v64[18] = {};
    float v32[18] = {};
    for (int j = m; j < end; ++j) {
      const double* src = rows + static_cast<int64_t>(j) * kRow;
      if (j > m && src[27] != cam) break;
      const float* vsrc = vrows + static_cast<int64_t>(j) * kVRow;
#pragma unroll
      for (int k = 0; k < 18; ++k) {
        v64[k] = v64[k] + src[k];
        v32[k] = v32[k] + vsrc[k];
      }
    }
    const int c = static_cast<int>(cam), s = s0 + t;
#pragma unroll
    for (int r = 0; r < 6; ++r) {
      float* v_out = V + ((static_cast<int64_t>(c) * 6 + r) * Lp + s) * 3;
      float* vh_out = VH + ((static_cast<int64_t>(c) * 6 + r) * Lp + s) * 3;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        v_out[k] = v32[3 * r + k];
        vh_out[k] = static_cast<float>(v64[3 * r] * inv_s[t][k] +
                                       v64[3 * r + 1] * inv_s[t][3 + k] +
                                       v64[3 * r + 2] * inv_s[t][6 + k]);
      }
    }
  }
}

Problem problem(const int64_t* ptrs, float bf, float lam, double d2, int C, int N) {
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
  p.lam_ptr = reinterpret_cast<const float*>(ptrs[kLam]);
  p.bf = bf;
  p.lam = lam;
  p.d2 = static_cast<float>(d2);
  p.d2_64 = d2;
  p.C = C;
  p.N = N;
  p.S = (N + kThreads - 1) / kThreads;
  return p;
}

}  // namespace

// ptrs: kNumPtrs addresses (poses, points, K, bf or 0, pnt_idx, uvr,
// is_stereo, inv_sigma2, valid, fixed_cam, fixed_pnt, lam or 0); pos [C N]
// int32 (the index's row of each edge, -1 for none); out: Hcc_d [C,6,6],
// bc [C,6], cost [], part [C S 28 + C] and tickets [C + 1] (scratch), rows
// [C N, 28]. Zeroes the tickets, then one launch of C S blocks.
extern "C" int ba_dense_terms_launch(const int64_t* ptrs, float bf, float lam, double d2, int C,
                                     int N, const void* pos, void* Hcc_d, void* bc, void* cost,
                                     void* part, void* tickets, void* rows, void* vrows,
                                     void* stream) {
  if (C < 1 || N < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Problem p = problem(ptrs, bf, lam, d2, C, N);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = cudaMemsetAsync(tickets, 0, (C + 1) * sizeof(unsigned), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Outputs out{static_cast<float*>(Hcc_d), static_cast<float*>(bc),
                    static_cast<float*>(cost),  static_cast<double*>(part),
                    static_cast<double*>(rows), static_cast<float*>(vrows),
                    static_cast<const int*>(pos), static_cast<unsigned*>(tickets)};
  ba_dense_terms_pass<<<C * p.S, kThreads, 0, s>>>(p, out);
  return static_cast<int>(cudaGetLastError());
}

// rows [C N, 28] and offsets [L + 1] int32 (the index's) from the terms
// pass; out: Hpi [L,3,3], bp [L,3], Hpib [L,3], V and VH [C, 6, Lp, 3]
// (Lp a multiple of 16, 16-byte aligned). One launch of Lp / 16 blocks.
extern "C" int ba_dense_slots_launch(const void* rows, const void* vrows, const void* offsets,
                                     const void* lam_ptr,
                                     float lam, int C, int L, int Lp, void* Hpi, void* bp,
                                     void* Hpib, void* V, void* VH, void* stream) {
  if (C < 1 || L < 1 || Lp < L || Lp % kTile != 0 ||
      (reinterpret_cast<uintptr_t>(V) | reinterpret_cast<uintptr_t>(VH)) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  ba_dense_terms_slots<<<Lp / kTile, kSlotThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(rows), static_cast<const float*>(vrows),
      static_cast<const int*>(offsets),
      static_cast<const float*>(lam_ptr), lam, C, L, Lp, static_cast<float*>(Hpi),
      static_cast<float*>(bp), static_cast<float*>(Hpib), static_cast<float*>(V),
      static_cast<float*>(VH));
  return static_cast<int>(cudaGetLastError());
}

// the robust cost alone: ptrs as above (lam unused), out: cost [] and the
// scratch part [C S] and tickets [1]. One launch of C S blocks.
extern "C" int ba_dense_cost_launch(const int64_t* ptrs, float bf, double d2, int C, int N,
                                    void* cost, void* part, void* tickets, void* stream) {
  if (C < 1 || N < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Problem p = problem(ptrs, bf, 0.0f, d2, C, N);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = cudaMemsetAsync(tickets, 0, sizeof(unsigned), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Outputs out{nullptr, nullptr, static_cast<float*>(cost), static_cast<double*>(part),
                    nullptr, nullptr, nullptr, static_cast<unsigned*>(tickets)};
  ba_dense_terms_cost<<<C * p.S, kThreads, 0, s>>>(p, out);
  return static_cast<int>(cudaGetLastError());
}
