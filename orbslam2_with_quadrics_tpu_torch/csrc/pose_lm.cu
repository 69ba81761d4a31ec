// Motion-only pose optimization of one camera pose against N fixed points,
// the whole Levenberg-Marquardt schedule in one launch.
//
// Replaces the reference's jitted solve orbslam2_with_quadrics_tpu/ops/
// pose_opt.py::pose_optimization (:190-280, one fori_loop per round, no
// host trips) and computes what the port's plain version
// (ops/pose_opt.py::pose_optimization_plain) computes, step for step:
//   * quaternion -> R at entry, R -> quaternion (Shepperd, w >= 0) at exit;
//   * `rounds` x `iters` LM, the Huber kernel (delta^2 = 7.815) in rounds
//     0-1 and none after; lambda from 1e-4, x0.5 on accept, x4 on reject,
//     clamped to [1e-10, 1e6]; Hd = H + lambda diag(H) + 1e-10 I, solved by
//     Cholesky of Hd + 1e-12 I (a pivot that is not positive gives a NaN
//     step, which is rejected, never floored);
//   * deferred accept: (H, b, cost) evaluated at the candidate in one pass,
//     kept when cost_c < cost and the step is finite;
//   * the Rodrigues retract with its Taylor branches below theta^2 = 1e-8;
//   * after each round, chi2 re-classification of every valid observation
//     (gates 5.991 mono / 7.815 stereo rows).
// Outputs T [7], the inlier mask [N] (bytes 0/1) and their count (int32),
// all on the device.
//
// What bounds it on an H100: latency. At N = 2048 a step reads 80 KB and
// does about 0.3 MFLOP, which is nothing for the card; the schedule is a
// chain of dependent links, each a block-wide reduction of 28 sums or the
// serial 6x6 solve and retract that follows it: 2 rounds (iters + 1) +
// rounds links in all (52 at 4 x 5, 18 at 2 x 3), one block long. A link's
// floor is its rows' arithmetic on one SM (N rows of about 180
// instructions over 128 lanes) plus one barrier and one shuffle tree.
//
// Design (the second: the first took 2.1 us a link at 4 x 5 on 1,024 rows,
// with 28 separate shuffle trees and three barriers a reduction, every
// observation read again on each pass, and thread 0 alone solving while 255
// threads waited):
//   * One block of 256 threads; each thread loads its observations (rows
//     tid, tid + 256, ...: 2, 4 or 8 of them, chosen per solve, so N <=
//     2048) into registers once per solve, its inlier flags with them; rows
//     past 2048 are read from memory on each pass.
//   * A row's evaluation is straight-line code (a row outside the inlier
//     mask, or past N, has weight 0 and adds exact zeros, as in the plain
//     version), so a thread's rows interleave; the u_r row is left out of
//     a solve where no row measures it (its weight is 0 everywhere).
//   * One barrier a reduction: each warp reduces its 28 sums by a
//     lane-transpose reduction (31 shuffles, lane l ends with sum l), the
//     8 warps' partials go to shared memory (double-buffered, so the next
//     reduction cannot overwrite what a slow warp still reads), one
//     __syncthreads, then every warp adds the 8 partials in warp order.
//     So every warp holds the same sums, lane l the l-th.
//   * No broadcast: every thread solves the damped 6x6 itself from the
//     shuffled sums (Cholesky, the two triangular solves, the finite check,
//     the retract and the accept test, in one fixed order), so every warp
//     holds the same step and the chain goes on without another barrier.
//     (One warp solving and handing the step over behind a second barrier
//     measured the same: the solve's latency, not the 8 copies, is what
//     costs.) The factor keeps 1 / L_jj from a correctly rounded
//     reciprocal square root and multiplies by it, so the chain holds 6 of
//     those and no division: 0.8 us less a step than 27 IEEE divisions.
//   * The structural zeros of the Jacobian rows are left out (each adds an
//     exact zero in the plain version).
//   * The chi2 re-classification touches only a thread's own rows: no
//     barrier. The inlier count takes one reduction at the end.
//   * No float atomics; sums in a fixed order, so a run repeats itself bit
//     for bit. The build passes -fmad=false: each multiply and add rounds
//     on its own, as the plain version's elementwise ops do (fused
//     multiply-adds in the sums move the free directions of a system that
//     two stereo rows barely fix by 1e-3, past the bar); only the order of
//     the sums differs from cuBLAS's einsum.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kAcc = 28;  // H upper triangle (21), J^T W e (6), cost
constexpr unsigned kAll = 0xffffffffu;
constexpr float kChi2Mono = 5.991f;
constexpr float kChi2Stereo = 7.815f;

__device__ __forceinline__ int tri(int i, int j) {  // i <= j, row-major upper
  return i * 6 - (i * (i - 1)) / 2 + (j - i);
}

struct Pose {
  float R[9], t[3];
};

struct Obs {  // one observation, loaded once per solve
  float p[3], o[3], st, is2;
  bool valid, inl;
};

struct Inputs {
  const float *pts, *obs, *stereo, *inv_s2, *valid;
  unsigned char* inlier;  // the mask: rows past those in registers keep it here
  float K[4], bf;
  int n;
};

__device__ __forceinline__ void load_obs(const Inputs& in, int i, Obs& r) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    r.p[k] = in.pts[3 * i + k];
    r.o[k] = in.obs[3 * i + k];
  }
  r.st = in.stereo[i];
  r.is2 = in.inv_s2[i];
  r.valid = in.valid[i] > 0.0f;
  r.inl = r.valid;
}

// Projection terms at pose T: the camera point and the residuals.
struct Proj {
  float x, y, z, iz, e[3];
};

__device__ __forceinline__ Proj project(const Pose& T, const Inputs& in, const Obs& r) {
  const float* R = T.R;
  const float* p = r.p;
  Proj q;
  q.x = R[0] * p[0] + R[1] * p[1] + R[2] * p[2] + T.t[0];
  q.y = R[3] * p[0] + R[4] * p[1] + R[5] * p[2] + T.t[1];
  q.z = R[6] * p[0] + R[7] * p[1] + R[8] * p[2] + T.t[2];
  const float zs = fabsf(q.z) < 1e-6f ? 1e-6f : q.z;
  q.iz = 1.0f / zs;
  const float u = in.K[0] * q.x * q.iz + in.K[2];
  const float v = in.K[1] * q.y * q.iz + in.K[3];
  const float ur = u - in.bf * q.iz;
  q.e[0] = r.o[0] - u;
  q.e[1] = r.o[1] - v;
  q.e[2] = r.o[2] - ur;
  return q;
}

__device__ __forceinline__ float chi2_of(const Proj& q, float stereo, float w_obs) {
  const float w_eff = w_obs * (q.z > 0.05f ? 1.0f : 0.0f);
  return (q.e[0] * q.e[0] + q.e[1] * q.e[1] + q.e[2] * q.e[2] * stereo) * w_eff;
}

// H and J^T W e of one Jacobian row J (weight ww, residual e); Z is the
// row's structural zero (the u rows have none in column 4, the v row in 3)
template <int Z>
__device__ __forceinline__ void add_jrow(const float (&J)[6], float ww, float e,
                                         float (&acc)[32]) {
#pragma unroll
  for (int a = 0; a < 6; ++a) {
    if (a == Z) continue;
    const float ja = J[a] * ww;
#pragma unroll
    for (int c = a; c < 6; ++c)
      if (c != Z) acc[tri(a, c)] = acc[tri(a, c)] + ja * J[c];
    acc[21 + a] = acc[21 + a] + ja * e;
  }
}

// One row's (H, J^T W e, robust cost) at pose T, into acc, without a
// branch, so that a thread's rows interleave: a row outside the inlier mask
// (or a zero-filled one) has weight 0 and adds exact zeros, as in the plain
// version. ST: some row of the problem measures u_r (else the u_r row has
// weight 0 everywhere and is left out).
template <bool ST>
__device__ __forceinline__ void add_obs(const Obs& r, const Pose& T, const Inputs& in,
                                        float delta2, float (&acc)[32]) {
  const Proj q = project(T, in, r);
  const float w_eff = ((r.inl ? 1.0f : 0.0f) * r.is2) * (q.z > 0.05f ? 1.0f : 0.0f);
  const float chi2 =
      (q.e[0] * q.e[0] + q.e[1] * q.e[1] + q.e[2] * q.e[2] * r.st) * w_eff;
  // the Huber kernel where delta2 > 0: weight sqrt(delta2 / chi2) and cost
  // 2 sqrt(delta2 chi2) - delta2 past delta2
  const float c = fmaxf(chi2, 1e-12f);
  const bool huber = delta2 > 0.0f;
  const float w = huber && !(chi2 <= delta2) ? w_eff * sqrtf(delta2 / c) : w_eff;
  const float rho = huber && chi2 > delta2 ? 2.0f * sqrtf(delta2 * c) - delta2 : chi2;
  const float iz = q.iz, iz2 = iz * iz;
  // d(u)/d(camera point) = (a0, 0, a2), d(v)/d(...) = (0, b1, b2); a Jacobian
  // row is [d @ hat(pc), -d] (g2o's EdgeSE3ProjectXYZOnlyPose)
  const float a0 = in.K[0] * iz, a2 = -in.K[0] * q.x * iz2;
  const float b1 = in.K[1] * iz, b2 = -in.K[1] * q.y * iz2;
  const float Ju[6] = {a2 * (-q.y), a0 * (-q.z) + a2 * q.x, a0 * q.y, -a0, 0.0f, -a2};
  const float Jv[6] = {b1 * q.z + b2 * (-q.y), b2 * q.x, b1 * (-q.x), 0.0f, -b1, -b2};
  add_jrow<4>(Ju, w, q.e[0], acc);
  add_jrow<3>(Jv, w, q.e[1], acc);
  if (ST) {  // the u_r row, weight 0 on a mono row
    const float c2 = a2 + in.bf * iz2;
    const float Jr[6] = {c2 * (-q.y), a0 * (-q.z) + c2 * q.x, a0 * q.y, -a0, 0.0f, -c2};
    add_jrow<4>(Jr, r.st * w, q.e[2], acc);
  }
  acc[kAcc - 1] = acc[kAcc - 1] + rho;
}

template <int H>
__device__ __forceinline__ void transpose_step(float (&v)[32], int lane) {
  const bool upper = (lane & H) != 0;
#pragma unroll
  for (int k = 0; k < H; ++k) {
    const float send = upper ? v[k] : v[k + H];
    const float keep = upper ? v[k + H] : v[k];
    v[k] = keep + __shfl_xor_sync(kAll, send, H);
  }
}

// Lane-transpose reduction of 32 values a lane over the warp in 31
// shuffles: lane l ends with the warp's sum of v[l]. Each sum is the
// butterfly of a shuffle-xor tree, so it repeats bit for bit.
__device__ __forceinline__ float warp_transpose_sum(float (&v)[32]) {
  const int lane = threadIdx.x & 31;
  transpose_step<16>(v, lane);
  transpose_step<8>(v, lane);
  transpose_step<4>(v, lane);
  transpose_step<2>(v, lane);
  transpose_step<1>(v, lane);
  return v[0];
}

// (H upper, J^T W e, robust cost) at pose T over every row, summed over the
// block with one barrier: lane l of every warp returns sum l (l < 28). R
// rows a thread in registers, the rest (past R kThreads) read from memory.
template <int R, bool ST>
__device__ __forceinline__ float normal_eq(const Obs (&rows)[R], const Pose& T,
                                           const Inputs& in, float delta2,
                                           float (*red)[kWarps][32], int& phase) {
  float acc[32];
#pragma unroll
  for (int k = 0; k < 32; ++k) acc[k] = 0.0f;
#pragma unroll
  for (int k = 0; k < R; ++k) add_obs<ST>(rows[k], T, in, delta2, acc);
  for (int i = threadIdx.x + R * kThreads; i < in.n; i += kThreads) {
    Obs r;
    load_obs(in, i, r);
    r.inl = in.inlier[i] != 0;
    add_obs<ST>(r, T, in, delta2, acc);
  }
  float(*buf)[32] = red[phase];
  phase ^= 1;
  buf[threadIdx.x >> 5][threadIdx.x & 31] = warp_transpose_sum(acc);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  float s = buf[0][lane];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) s = s + buf[w][lane];
  return s;
}

__device__ __forceinline__ void hat(const float* w, float* W) {
  W[0] = 0.0f; W[1] = -w[2]; W[2] = w[1];
  W[3] = w[2]; W[4] = 0.0f; W[5] = -w[0];
  W[6] = -w[1]; W[7] = w[0]; W[8] = 0.0f;
}

__device__ __forceinline__ void matmul3(const float* A, const float* B, float* C) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      C[3 * i + j] = A[3 * i] * B[j] + A[3 * i + 1] * B[3 + j] + A[3 * i + 2] * B[6 + j];
}

// The damped step from the incumbent's sums (lane l holds sum l) and lam,
// and the candidate pose Tc = exp(delta) T. Every thread computes all of it
// in the same order, so every warp holds the same step. Returns whether the
// step is finite (a pivot that is not positive fails it).
__device__ __forceinline__ bool lm_step(float sums, float lam, const Pose& T, Pose& Tc) {
  float A[21], g[6];
#pragma unroll
  for (int k = 0; k < 21; ++k) A[k] = __shfl_sync(kAll, sums, k);
#pragma unroll
  for (int k = 0; k < 6; ++k) g[k] = -__shfl_sync(kAll, sums, 21 + k);
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const float h = A[tri(i, i)];
    A[tri(i, i)] = ((h + lam * h) + 1e-10f) + 1e-12f;
  }
  // Cholesky A = L L^T, L packed by rows (L[i][j] at i (i + 1) / 2 + j),
  // its diagonal kept as 1 / L_jj (a correctly rounded reciprocal square
  // root): every later step multiplies where it would divide, which takes
  // the divisions' latency off the chain. A pivot that is not positive
  // fails the step (its NaN is never used).
  float L[21];
  bool ok = true;
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    float d = A[tri(j, j)];
#pragma unroll
    for (int k = 0; k < j; ++k) d -= L[j * (j + 1) / 2 + k] * L[j * (j + 1) / 2 + k];
    ok = ok && d > 0.0f;
    const float rj = __frsqrt_rn(d);
    L[j * (j + 1) / 2 + j] = rj;
#pragma unroll
    for (int i = j + 1; i < 6; ++i) {
      float v = A[tri(j, i)];
#pragma unroll
      for (int k = 0; k < j; ++k) v -= L[i * (i + 1) / 2 + k] * L[j * (j + 1) / 2 + k];
      L[i * (i + 1) / 2 + j] = v * rj;
    }
  }
  float y[6], delta[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float v = g[i];
#pragma unroll
    for (int k = 0; k < i; ++k) v -= L[i * (i + 1) / 2 + k] * y[k];
    y[i] = v * L[i * (i + 1) / 2 + i];
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float v = y[i];
#pragma unroll
    for (int k = i + 1; k < 6; ++k) v -= L[k * (k + 1) / 2 + i] * delta[k];
    delta[i] = v * L[i * (i + 1) / 2 + i];
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) ok = ok && isfinite(delta[i]);
  if (!ok) return false;
  // exp(delta) * (R, t), Rodrigues with Taylor fallbacks near 0
  const float* w = delta;
  const float* v = delta + 3;
  float W[9], W2[9];
  hat(w, W);
  matmul3(W, W, W2);
  const float theta2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  const float theta = sqrtf(fmaxf(theta2, 1e-16f));
  const bool small = theta2 < 1e-8f;
  const float safe2 = small ? 1.0f : theta2;
  const float sn = sinf(theta), cs = cosf(theta);
  const float sA = small ? 1.0f - theta2 / 6.0f : sn / theta;
  const float sB = small ? 0.5f - theta2 / 24.0f : (1.0f - cs) / safe2;
  const float sC = small ? 1.0f / 6.0f - theta2 / 120.0f : (theta - sn) / (safe2 * theta);
  float Rd[9], V[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const float e = (k % 4 == 0) ? 1.0f : 0.0f;
    Rd[k] = (e + sA * W[k]) + sB * W2[k];
    V[k] = (e + sB * W[k]) + sC * W2[k];
  }
  matmul3(Rd, T.R, Tc.R);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float rt = Rd[3 * i] * T.t[0] + Rd[3 * i + 1] * T.t[1] + Rd[3 * i + 2] * T.t[2];
    const float vv = V[3 * i] * v[0] + V[3 * i + 1] * v[1] + V[3 * i + 2] * v[2];
    Tc.t[i] = rt + vv;
  }
  return true;
}

__device__ __forceinline__ void quat_to_matrix(const float* q, float* R) {
  const float w = q[0], u[3] = {q[1], q[2], q[3]};
  const float un = u[0] * u[0] + u[1] * u[1] + u[2] * u[2];
  float H[9];
  hat(u, H);
  const float w2 = 2.0f * w;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      const float e = i == j ? 1.0f : 0.0f;
      R[3 * i + j] = (e + w2 * H[3 * i + j]) + 2.0f * (u[i] * u[j] - un * e);
    }
}

// Shepperd: the largest of the four linear candidates, sign w >= 0, then
// normalized (the plain version's lie.matrix_to_quat)
__device__ __forceinline__ void matrix_to_quat(const float* m, float* q) {
  const float tr0 = ((m[0] + m[4]) + m[8]) + 1.0f;
  const float tr1 = ((m[0] - m[4]) - m[8]) + 1.0f;
  const float tr2 = ((-m[0] + m[4]) - m[8]) + 1.0f;
  const float tr3 = ((-m[0] - m[4]) + m[8]) + 1.0f;
  float c[4][4] = {
      {tr0, m[7] - m[5], m[2] - m[6], m[3] - m[1]},
      {m[7] - m[5], tr1, m[1] + m[3], m[2] + m[6]},
      {m[2] - m[6], m[1] + m[3], tr2, m[5] + m[7]},
      {m[3] - m[1], m[2] + m[6], m[5] + m[7], tr3},
  };
  int k = 0;
  for (int i = 1; i < 4; ++i)
    if (c[i][i] > c[k][k]) k = i;
  const float den = 2.0f * sqrtf(fmaxf(c[k][k], 1e-8f));
  float o[4];
  for (int j = 0; j < 4; ++j) o[j] = c[k][j] / den;
  const float sg = o[0] < 0.0f ? -1.0f : 1.0f;
  for (int j = 0; j < 4; ++j) o[j] *= sg;
  const float nrm = fmaxf(sqrtf(o[0] * o[0] + o[1] * o[1] + o[2] * o[2] + o[3] * o[3]), 1e-8f);
  for (int j = 0; j < 4; ++j) q[j] = o[j] / nrm;
}

// every valid row's inlier flag at pose T: chi2 below its row's gate
__device__ __forceinline__ bool classify(const Obs& r, const Pose& T, const Inputs& in) {
  const Proj q = project(T, in, r);
  const float chi2 = chi2_of(q, r.st, (r.valid ? 1.0f : 0.0f) * r.is2);
  const float gate = r.st > 0.0f ? kChi2Stereo : kChi2Mono;
  return chi2 < gate && r.valid;
}

// The whole schedule with R rows a thread in registers (rows past n
// zero-filled: weight 0, never valid); ST as in add_obs.
template <int R, bool ST>
__device__ __forceinline__ void schedule(Inputs& in, Pose& T, int rounds, int iters,
                                         float (*red)[kWarps][32]) {
  const int tid = threadIdx.x;
  Obs rows[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    if (tid + k * kThreads < in.n) {
      load_obs(in, tid + k * kThreads, rows[k]);
    } else {
      rows[k] = Obs{{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}, 0.0f, 0.0f, false, false};
    }
  }
  for (int i = tid + R * kThreads; i < in.n; i += kThreads) in.inlier[i] = in.valid[i] > 0.0f;
  int phase = 0;
  for (int r = 0; r < rounds; ++r) {
    const float delta2 = r < 2 ? kChi2Stereo : 0.0f;
    float sums = normal_eq<R, ST>(rows, T, in, delta2, red, phase);  // the incumbent's
    float lam = 1e-4f;
    for (int it = 0; it < iters; ++it) {
      Pose Tc;
      bool ok = false;
      if (lm_step(sums, lam, T, Tc)) {  // a non-finite step is rejected unevaluated
        const float cand = normal_eq<R, ST>(rows, Tc, in, delta2, red, phase);
        ok = __shfl_sync(kAll, cand, kAcc - 1) < __shfl_sync(kAll, sums, kAcc - 1);
        if (ok) {
          T = Tc;
          sums = cand;
        }
      }
      lam = fminf(fmaxf(ok ? lam * 0.5f : lam * 4.0f, 1e-10f), 1e6f);
    }
    // re-classify every valid observation, so that outliers can come back;
    // a thread touches only its own rows
#pragma unroll
    for (int k = 0; k < R; ++k) rows[k].inl = classify(rows[k], T, in);
    for (int i = tid + R * kThreads; i < in.n; i += kThreads) {
      Obs o;
      load_obs(in, i, o);
      in.inlier[i] = classify(o, T, in);
    }
  }
#pragma unroll
  for (int k = 0; k < R; ++k)
    if (tid + k * kThreads < in.n) in.inlier[tid + k * kThreads] = rows[k].inl;
}

__global__ void __launch_bounds__(kThreads, 1)
pose_lm_kernel(const float* __restrict__ T_init, const float* __restrict__ K_in,
               const float* __restrict__ bf_ptr, float bf_val, const Inputs args,
               int rounds, int iters, float* __restrict__ T_out, int* __restrict__ n_inliers) {
  __shared__ float red[2][kWarps][32];
  __shared__ int count[kWarps];
  const int tid = threadIdx.x;
  Inputs in = args;
#pragma unroll
  for (int k = 0; k < 4; ++k) in.K[k] = K_in[k];
  in.bf = bf_ptr ? *bf_ptr : bf_val;
  Pose T;
  quat_to_matrix(T_init, T.R);
#pragma unroll
  for (int k = 0; k < 3; ++k) T.t[k] = T_init[4 + k];
  // the rows a thread keeps (2, 4 or 8), and whether any row measures u_r
  int st_any = 0;
  for (int i = tid; i < in.n; i += kThreads) st_any |= in.stereo[i] != 0.0f;
  const bool st = __syncthreads_or(st_any) != 0;
  const int per = (in.n + kThreads - 1) / kThreads;
  if (per <= 2) {
    st ? schedule<2, true>(in, T, rounds, iters, red) : schedule<2, false>(in, T, rounds, iters, red);
  } else if (per <= 4) {
    st ? schedule<4, true>(in, T, rounds, iters, red) : schedule<4, false>(in, T, rounds, iters, red);
  } else {
    st ? schedule<8, true>(in, T, rounds, iters, red) : schedule<8, false>(in, T, rounds, iters, red);
  }
  int cnt = 0;
  for (int i = tid; i < in.n; i += kThreads) cnt += in.inlier[i] ? 1 : 0;
  for (int off = 16; off > 0; off >>= 1) cnt += __shfl_down_sync(kAll, cnt, off);
  if ((tid & 31) == 0) count[tid >> 5] = cnt;
  __syncthreads();
  if (tid == 0) {
    int total = 0;
    for (int w = 0; w < kWarps; ++w) total += count[w];
    *n_inliers = total;
    float q[4];
    matrix_to_quat(T.R, q);
    for (int k = 0; k < 4; ++k) T_out[k] = q[k];
    for (int k = 0; k < 3; ++k) T_out[4 + k] = T.t[k];
  }
}

}  // namespace

extern "C" int pose_lm_launch(const void* T_init, const void* K, const void* bf_ptr,
                              float bf_val, const void* pts, const void* obs,
                              const void* stereo, const void* inv_s2, const void* valid,
                              int n, int rounds, int iters, void* T_out, void* inlier,
                              void* n_inliers, void* stream) {
  if (n < 0 || rounds < 0 || iters < 0) return static_cast<int>(cudaErrorInvalidValue);
  Inputs in{};
  in.pts = static_cast<const float*>(pts);
  in.obs = static_cast<const float*>(obs);
  in.stereo = static_cast<const float*>(stereo);
  in.inv_s2 = static_cast<const float*>(inv_s2);
  in.valid = static_cast<const float*>(valid);
  in.inlier = static_cast<unsigned char*>(inlier);
  in.n = n;
  pose_lm_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(T_init), static_cast<const float*>(K),
      static_cast<const float*>(bf_ptr), bf_val, in, rounds, iters,
      static_cast<float*>(T_out), static_cast<int*>(n_inliers));
  return static_cast<int>(cudaGetLastError());
}
