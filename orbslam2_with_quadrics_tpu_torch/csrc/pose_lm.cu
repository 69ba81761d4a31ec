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
//     step, which is rejected);
//   * deferred accept: (H, b, cost) evaluated at the candidate in one pass,
//     kept when cost_c < cost and the step is finite;
//   * the Rodrigues retract with its Taylor branches below theta^2 = 1e-8;
//   * after each round, chi2 re-classification of every valid observation
//     (gates 5.991 mono / 7.815 stereo rows).
// Outputs T [7], the inlier mask [N] (bytes 0/1) and their count (int32),
// all on the device.
//
// What bounds it on an H100: latency. At N = 2048 a step reads 80 KB (L1-
// and L2-resident after the first pass) and does about 0.3 MFLOP, which is
// nothing for the card; but the schedule is a chain of
// 2 * rounds * (iters + 1) + rounds dependent block-wide reductions (26 LM
// evaluations and 4 chi2 passes at 4 x 5), each followed by a serial 6x6
// Cholesky and retract. The eager PyTorch version pays ~100 launches per
// step on the host; here each link of the chain is a few microseconds of
// one block.
//
// Design (simple and right first):
//   * One block of 256 threads per problem; threads stride over the N
//     observations and accumulate 28 floats each (21 of H's upper
//     triangle, 6 of b, the robust cost) in a fixed order.
//   * Block reduction without atomics: a warp shuffle tree, then shared
//     memory summed across the 8 warps in warp order, so a run repeats
//     itself bit for bit.
//   * Thread 0 factors the damped 6x6, checks the step, retracts, and
//     decides accept / reject; the pose, H, b, cost and lambda live in
//     shared memory between the block's barriers.
//   * The build passes -fmad=false: each multiply and add rounds on its own,
//     as the plain version's elementwise ops do; only the order of the sums
//     differs from cuBLAS's einsum.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kAcc = 28;  // H upper triangle (21), b (6), cost
constexpr float kChi2Mono = 5.991f;
constexpr float kChi2Stereo = 7.815f;

struct Shared {
  float R[9], t[3];      // incumbent pose
  float Rc[9], tc[3];    // candidate pose
  float H[21], b[6], cost, lam;
  float red[kAcc];       // the last block reduction
  float part[kWarps][kAcc];
  int finite;            // the candidate step is finite
  int count[kWarps];
};

__device__ __forceinline__ int tri(int i, int j) {  // i <= j, row-major upper
  return i * 6 - (i * (i - 1)) / 2 + (j - i);
}

// Per-observation projection terms at pose (R, t); returns the camera point.
struct Proj {
  float x, y, z, iz, e[3];
};

__device__ __forceinline__ Proj project(const float* R, const float* t, const float* K,
                                        float bf, const float* p, const float* o) {
  Proj q;
  q.x = R[0] * p[0] + R[1] * p[1] + R[2] * p[2] + t[0];
  q.y = R[3] * p[0] + R[4] * p[1] + R[5] * p[2] + t[1];
  q.z = R[6] * p[0] + R[7] * p[1] + R[8] * p[2] + t[2];
  const float zs = fabsf(q.z) < 1e-6f ? 1e-6f : q.z;
  q.iz = 1.0f / zs;
  const float u = K[0] * q.x * q.iz + K[2];
  const float v = K[1] * q.y * q.iz + K[3];
  const float ur = u - bf * q.iz;
  q.e[0] = o[0] - u;
  q.e[1] = o[1] - v;
  q.e[2] = o[2] - ur;
  return q;
}

__device__ __forceinline__ float chi2_of(const Proj& q, float stereo, float w_obs) {
  const float w_eff = w_obs * (q.z > 0.05f ? 1.0f : 0.0f);
  return (q.e[0] * q.e[0] + q.e[1] * q.e[1] + q.e[2] * q.e[2] * stereo) * w_eff;
}

// Sum of each thread's kAcc values over the block, into s.red (fixed order).
__device__ void block_sum(float* acc, Shared& s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kAcc; ++k) {
    float v = acc[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) s.part[warp][k] = v;
  }
  __syncthreads();
  if (threadIdx.x < kAcc) {
    float v = s.part[0][threadIdx.x];
    for (int w = 1; w < kWarps; ++w) v += s.part[w][threadIdx.x];
    s.red[threadIdx.x] = v;
  }
  __syncthreads();
}

// (H, b, robust cost) at (R, t) over every observation, into s.red.
__device__ void normal_eq(const float* R, const float* t, const float* K, float bf,
                          const float* pts, const float* obs, const float* stereo,
                          const float* inv_s2, const unsigned char* inlier, int n,
                          float delta2, Shared& s) {
  float acc[kAcc];
#pragma unroll
  for (int k = 0; k < kAcc; ++k) acc[k] = 0.0f;
  const float fx = K[0], fy = K[1];
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const Proj q = project(R, t, K, bf, pts + 3 * i, obs + 3 * i);
    const float st = stereo[i];
    const float w_obs = (inlier[i] ? 1.0f : 0.0f) * inv_s2[i];
    const float w_eff = w_obs * (q.z > 0.05f ? 1.0f : 0.0f);
    const float chi2 = (q.e[0] * q.e[0] + q.e[1] * q.e[1] + q.e[2] * q.e[2] * st) * w_eff;
    float w = w_eff, rho = chi2;
    if (delta2 > 0.0f) {
      const float hw = chi2 <= delta2 ? 1.0f : sqrtf(delta2 / fmaxf(chi2, 1e-12f));
      w = w_eff * hw;
      if (chi2 > delta2) rho = 2.0f * sqrtf(delta2 * fmaxf(chi2, 1e-12f)) - delta2;
    }
    const float iz = q.iz, iz2 = iz * iz;
    // d(u, v, u_r)/d(camera point), rows r = 0..2
    float dp[3][3];
    dp[0][0] = fx * iz; dp[0][1] = 0.0f; dp[0][2] = -fx * q.x * iz2;
    dp[1][0] = 0.0f; dp[1][1] = fy * iz; dp[1][2] = -fy * q.y * iz2;
    dp[2][0] = dp[0][0]; dp[2][1] = dp[0][1]; dp[2][2] = dp[0][2] + bf * iz2;
    const float rw[3] = {1.0f, 1.0f, st};
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      // Jc row: [dpred_r @ hat(pc), -dpred_r]
      float J[6];
      J[0] = dp[r][0] * 0.0f + dp[r][1] * q.z + dp[r][2] * (-q.y);
      J[1] = dp[r][0] * (-q.z) + dp[r][1] * 0.0f + dp[r][2] * q.x;
      J[2] = dp[r][0] * q.y + dp[r][1] * (-q.x) + dp[r][2] * 0.0f;
      J[3] = -dp[r][0];
      J[4] = -dp[r][1];
      J[5] = -dp[r][2];
      const float ww = rw[r] * w;
      int k = 0;
#pragma unroll
      for (int a = 0; a < 6; ++a) {
        const float ja = J[a] * ww;
#pragma unroll
        for (int c = a; c < 6; ++c) acc[k++] += ja * J[c];
        acc[21 + a] += ja * q.e[r];
      }
    }
    acc[27] += rho;
  }
  block_sum(acc, s);
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

// Thread 0: the damped step from (H, b, lambda), and the candidate pose.
__device__ void lm_step(Shared& s) {
  float A[6][6];
  for (int i = 0; i < 6; ++i)
    for (int j = 0; j < 6; ++j) {
      const float h = s.H[i <= j ? tri(i, j) : tri(j, i)];
      float d = h;
      if (i == j) d = ((h + s.lam * h) + 1e-10f) + 1e-12f;
      A[i][j] = d;
    }
  // Cholesky A = L L^T; a pivot that is not positive fails the step
  float L[6][6];
  bool ok = true;
  for (int j = 0; j < 6 && ok; ++j) {
    float d = A[j][j];
    for (int k = 0; k < j; ++k) d -= L[j][k] * L[j][k];
    if (!(d > 0.0f)) { ok = false; break; }
    L[j][j] = sqrtf(d);
    for (int i = j + 1; i < 6; ++i) {
      float v = A[i][j];
      for (int k = 0; k < j; ++k) v -= L[i][k] * L[j][k];
      L[i][j] = v / L[j][j];
    }
  }
  float delta[6];
  if (ok) {
    float y[6];
    for (int i = 0; i < 6; ++i) {
      float v = s.b[i];
      for (int k = 0; k < i; ++k) v -= L[i][k] * y[k];
      y[i] = v / L[i][i];
    }
    for (int i = 5; i >= 0; --i) {
      float v = y[i];
      for (int k = i + 1; k < 6; ++k) v -= L[k][i] * delta[k];
      delta[i] = v / L[i][i];
    }
    for (int i = 0; i < 6; ++i) ok = ok && isfinite(delta[i]);
  }
  s.finite = ok ? 1 : 0;
  if (!ok) return;
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
  for (int k = 0; k < 9; ++k) {
    const float e = (k % 4 == 0) ? 1.0f : 0.0f;
    Rd[k] = (e + sA * W[k]) + sB * W2[k];
    V[k] = (e + sB * W[k]) + sC * W2[k];
  }
  matmul3(Rd, s.R, s.Rc);
  for (int i = 0; i < 3; ++i) {
    const float rt = Rd[3 * i] * s.t[0] + Rd[3 * i + 1] * s.t[1] + Rd[3 * i + 2] * s.t[2];
    const float vv = V[3 * i] * v[0] + V[3 * i + 1] * v[1] + V[3 * i + 2] * v[2];
    s.tc[i] = rt + vv;
  }
}

__device__ void quat_to_matrix(const float* q, float* R) {
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
__device__ void matrix_to_quat(const float* m, float* q) {
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

__global__ void __launch_bounds__(kThreads, 1)
pose_lm_kernel(const float* __restrict__ T_init, const float* __restrict__ K_in,
               const float* __restrict__ bf_ptr, float bf_val,
               const float* __restrict__ pts, const float* __restrict__ obs,
               const float* __restrict__ stereo, const float* __restrict__ inv_s2,
               const float* __restrict__ valid, int n, int rounds, int iters,
               float* __restrict__ T_out, unsigned char* __restrict__ inlier,
               int* __restrict__ n_inliers) {
  __shared__ Shared s;
  float K[4];
  for (int k = 0; k < 4; ++k) K[k] = K_in[k];
  const float bf = bf_ptr ? *bf_ptr : bf_val;
  if (threadIdx.x == 0) {
    quat_to_matrix(T_init, s.R);
    for (int k = 0; k < 3; ++k) s.t[k] = T_init[4 + k];
  }
  for (int i = threadIdx.x; i < n; i += kThreads) inlier[i] = valid[i] > 0.0f;
  __syncthreads();
  for (int r = 0; r < rounds; ++r) {
    const float delta2 = r < 2 ? kChi2Stereo : 0.0f;
    normal_eq(s.R, s.t, K, bf, pts, obs, stereo, inv_s2, inlier, n, delta2, s);
    if (threadIdx.x == 0) {
      for (int k = 0; k < 21; ++k) s.H[k] = s.red[k];
      for (int k = 0; k < 6; ++k) s.b[k] = -s.red[21 + k];
      s.cost = s.red[27];
      s.lam = 1e-4f;
    }
    __syncthreads();
    for (int it = 0; it < iters; ++it) {
      if (threadIdx.x == 0) lm_step(s);
      __syncthreads();
      const bool finite = s.finite != 0;
      if (finite)  // a non-finite step is rejected without an evaluation
        normal_eq(s.Rc, s.tc, K, bf, pts, obs, stereo, inv_s2, inlier, n, delta2, s);
      if (threadIdx.x == 0) {
        const bool ok = finite && s.red[27] < s.cost;
        if (ok) {
          for (int k = 0; k < 9; ++k) s.R[k] = s.Rc[k];
          for (int k = 0; k < 3; ++k) s.t[k] = s.tc[k];
          for (int k = 0; k < 21; ++k) s.H[k] = s.red[k];
          for (int k = 0; k < 6; ++k) s.b[k] = -s.red[21 + k];
          s.cost = s.red[27];
        }
        s.lam = fminf(fmaxf(ok ? s.lam * 0.5f : s.lam * 4.0f, 1e-10f), 1e6f);
      }
      __syncthreads();
    }
    // re-classify every valid observation, so that outliers can come back;
    // a thread touches only its own rows, which it alone reads next round
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const Proj q = project(s.R, s.t, K, bf, pts + 3 * i, obs + 3 * i);
      const bool is_valid = valid[i] > 0.0f;
      const float w_all = (is_valid ? 1.0f : 0.0f) * inv_s2[i];
      const float chi2 = chi2_of(q, stereo[i], w_all);
      const float gate = stereo[i] > 0.0f ? kChi2Stereo : kChi2Mono;
      inlier[i] = (chi2 < gate) && is_valid;
    }
  }
  int cnt = 0;
  for (int i = threadIdx.x; i < n; i += kThreads) cnt += inlier[i] ? 1 : 0;
  for (int off = 16; off > 0; off >>= 1) cnt += __shfl_down_sync(0xffffffffu, cnt, off);
  if ((threadIdx.x & 31) == 0) s.count[threadIdx.x >> 5] = cnt;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < kWarps; ++w) total += s.count[w];
    *n_inliers = total;
    float q[4];
    matrix_to_quat(s.R, q);
    for (int k = 0; k < 4; ++k) T_out[k] = q[k];
    for (int k = 0; k < 3; ++k) T_out[4 + k] = s.t[k];
  }
}

}  // namespace

extern "C" int pose_lm_launch(const void* T_init, const void* K, const void* bf_ptr,
                              float bf_val, const void* pts, const void* obs,
                              const void* stereo, const void* inv_s2, const void* valid,
                              int n, int rounds, int iters, void* T_out, void* inlier,
                              void* n_inliers, void* stream) {
  if (n < 0 || rounds < 0 || iters < 0) return static_cast<int>(cudaErrorInvalidValue);
  pose_lm_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(T_init), static_cast<const float*>(K),
      static_cast<const float*>(bf_ptr), bf_val, static_cast<const float*>(pts),
      static_cast<const float*>(obs), static_cast<const float*>(stereo),
      static_cast<const float*>(inv_s2), static_cast<const float*>(valid), n, rounds, iters,
      static_cast<float*>(T_out), static_cast<unsigned char*>(inlier),
      static_cast<int*>(n_inliers));
  return static_cast<int>(cudaGetLastError());
}
