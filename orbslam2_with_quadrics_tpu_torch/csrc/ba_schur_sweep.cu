// The PCG solver's two edge sweeps over an LM step's coupling blocks
// W_o = Jc_o^T w_o Jp_o ([O, 6, 3] float32, one block an edge of the table).
//
//   * ba_schur_sweep_cam_to_point (launched by ba_schur_cam_to_point_launch):
//     s[p] = sum over the live edges o of point p of W_o^T x[c_o] (x [C, 6]
//     per camera), into a [P, 4] float32 buffer whose first three columns
//     are s. Called by ops/ba.py::sweep_cam_to_point for W^T dc in the
//     back-substitution (_back_substitute) and W^T x in _schur_matvec with
//     a group.
//   * ba_schur_sweep_point_to_cam (ba_schur_point_to_cam_launch): out[c] =
//     init[c] - sum over the live edges o of camera c of W_o Hpp^-1[p_o]
//     s[p_o] (s [P, >= 3] with a row stride; Hpp^-1 [P, 3, 4], its rows
//     padded to 16 bytes), the point's 3x3 product taken per edge from L2.
//     init is base[c], or Hcc_d[c] x[c], or 0. Called by ops/ba.py::
//     sweep_point_to_cam for W Hpp^-1 bp in _schur_rhs (init bc) and for
//     W Hpp^-1 W^T x in _schur_matvec with a group (init 0).
//   * ba_schur_matvec_launch: both, for the PCG's S x = Hcc_d x -
//     W Hpp^-1 W^T x without a group (ops/ba.py::_schur_matvec; init
//     Hcc_d x): one call from the host where the host sets the pace.
//
// It replaces no Pallas kernel: the reference computes the same sweeps with
// jnp.einsum + segment_sum (orbslam2_with_quadrics_tpu/ops/ba.py:156,
// _schur_matvec), which XLA fuses. It was added because the port's eager
// version (a gather, a cuBLAS batched gemv of one 6x3 block a row, then
// index_add) ran at about 1/80 of its bytes bound on an H100, and the
// PCG's 80 sweeps an LM step were 83-86% of the global BA.
//
// What bounds it: bytes. A live row reads its block (72 B) and its two
// int64 indices (16 B); every row reads its valid flag (4 B). The camera
// and point vectors (49 KB and 4 MB on the KITTI-00 map) and Hpp^-1
// (9.4 MB) are gathered from L2; the FLOP (36 a row) are nothing. The
// design against that:
//   * live rows only: a warp reads its 32 rows' valid flags, and a warp
//     without a live row stops there. Otherwise it stages its 32 blocks
//     (2,304 contiguous bytes) in shared memory with 16-byte streaming
//     loads, skipping the 16-byte words that touch no live row, and each
//     live lane reads its block back as 9 float2 (a row is 18 floats, so
//     the 16 lanes of a half-warp hit 32 distinct banks). A dead row's
//     block is exactly 0 (its weight is 0 and its Jacobians finite), so
//     skipping it changes no sum. Nothing is reordered and no index built.
//   * cameras without contention: the point -> camera sweep sums the warp's
//     rows of one camera with a butterfly of shuffles and issues one atomic
//     per camera and component; two such rounds take the warp's first two
//     cameras (in a camera-major table, where a camera's rows are
//     contiguous, a warp almost always holds one), and whatever rows are
//     left add their own atomics: any row order is summed right.
//   * points with vector atomics: the camera -> point sweep adds a row's
//     three numbers (and a zero) into its point with one float4 atomicAdd,
//     one L2 transaction a row.
//   * Hpp^-1 s per edge: a live row gathers its point's s (one float4 where
//     s is the camera -> point sweep's [P, 4] buffer) and Hpp^-1's three
//     padded rows (three float4) from L2. On the KITTI-00 table (2.67 M of
//     4.1 M rows live; H100, 700 W) this sweep took 0.103 ms, against
//     0.110 ms with Hpp^-1 read unpadded (nine scalar loads) and 0.091 ms
//     for a point pass by hand (y = Hpp^-1 s into a [P, 4] buffer, then the
//     sweep gathering y): the point pass is a second kernel a call, and on
//     the TUM table (29 k live rows) the slowest of the three (0.0076 ms
//     against 0.0068 ms padded).
// Atomics make the order of the sums change from run to run, as index_add
// does on the card. float32 throughout; the products are the plain
// version's (ops/ba.py::sweep_cam_to_point_plain, sweep_point_to_cam_plain),
// with fused multiply-adds.
//
// The init rule: out's init is folded in only where the caller sums no
// ranks (ops/ba.py passes bc or Hcc_d and x only without a group). With a
// torch.distributed group the kernel gives the rank's coupling alone (init
// 0), the caller all_reduces it and adds base or Hcc_d x once after, so
// that they are not counted once per rank.
//
// The launchers zero the output (cudaMemsetAsync) and launch on the given
// stream; they allocate nothing and return cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;                          // warps a block
constexpr int kThreads = 32 * kWarps;
constexpr int kRowFloats = 18;                     // a [6, 3] block
constexpr int kTileFloats = 32 * kRowFloats;       // a warp's 32 blocks
constexpr int kTileWords = kTileFloats / 4;        // as 144 float4
constexpr int kCameraRounds = 2;                   // butterfly rounds a warp

// The warp's rows: its first row, how many it has (32 but at the table's
// end), and the live ones as a ballot.
struct Rows {
  long long first;
  int count;
  unsigned live;
};

__device__ __forceinline__ Rows warp_rows(const float* __restrict__ valid, long long n_rows,
                                          bool* lane_live) {
  const int lane = threadIdx.x & 31;
  Rows r;
  r.first = ((long long)blockIdx.x * kWarps + (threadIdx.x >> 5)) * 32;
  r.count = r.first < n_rows ? (int)min(32LL, n_rows - r.first) : 0;
  *lane_live = lane < r.count && __ldcs(valid + r.first + lane) > 0.f;
  r.live = __ballot_sync(kFull, *lane_live);
  return r;
}

// Stage the warp's blocks in ``tile``: only the 16-byte words that touch a
// live row are read (a word may span two rows: 18 floats are 4.5 words).
__device__ __forceinline__ void stage_blocks(const float* __restrict__ W, const Rows& r,
                                             float* tile) {
  const int lane = threadIdx.x & 31;
  const float* src = W + r.first * kRowFloats;
  if (r.count == 32) {
    const float4* src4 = reinterpret_cast<const float4*>(src);
    float4* dst4 = reinterpret_cast<float4*>(tile);
#pragma unroll
    for (int k = 0; k < (kTileWords + 31) / 32; ++k) {
      const int q = lane + 32 * k;
      if (q < kTileWords) {
        const int a = (4 * q) / kRowFloats, b = (4 * q + 3) / kRowFloats;
        if (((r.live >> a) | (r.live >> b)) & 1u) dst4[q] = __ldcs(src4 + q);
      }
    }
  } else {
    for (int f = lane; f < r.count * kRowFloats; f += 32)
      if ((r.live >> (f / kRowFloats)) & 1u) tile[f] = __ldcs(src + f);
  }
  __syncwarp();
}

__device__ __forceinline__ void lane_block(const float* tile, float w[kRowFloats]) {
  const float2* row = reinterpret_cast<const float2*>(tile + (threadIdx.x & 31) * kRowFloats);
#pragma unroll
  for (int k = 0; k < kRowFloats / 2; ++k) {
    const float2 v = row[k];
    w[2 * k] = v.x;
    w[2 * k + 1] = v.y;
  }
}

__global__ void __launch_bounds__(kThreads)
ba_schur_sweep_cam_to_point(const float* __restrict__ valid,
                            const long long* __restrict__ cam,
                            const long long* __restrict__ pnt, const float* __restrict__ W,
                            const float* __restrict__ x, float4* __restrict__ s,
                            long long n_rows) {
  __shared__ __align__(16) float tiles[kWarps][kTileFloats];
  bool live;
  const Rows r = warp_rows(valid, n_rows, &live);
  if (r.live == 0u) return;
  const long long row = r.first + (threadIdx.x & 31);
  long long c = 0, p = 0;
  if (live) {
    c = __ldcs(cam + row);
    p = __ldcs(pnt + row);
  }
  float* tile = tiles[threadIdx.x >> 5];
  stage_blocks(W, r, tile);
  if (!live) return;
  float w[kRowFloats];
  lane_block(tile, w);
  const float2* xc = reinterpret_cast<const float2*>(x + 6 * c);
  float xv[6];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float2 v = __ldg(xc + k);
    xv[2 * k] = v.x;
    xv[2 * k + 1] = v.y;
  }
  float t[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) t[j] = fmaf(w[3 * i + j], xv[i], t[j]);
  atomicAdd(s + p, make_float4(t[0], t[1], t[2], 0.f));
}

__global__ void __launch_bounds__(kThreads)
ba_schur_sweep_point_to_cam(const float* __restrict__ valid,
                            const long long* __restrict__ cam,
                            const long long* __restrict__ pnt, const float* __restrict__ W,
                            const float* __restrict__ hinv4, const float* __restrict__ s,
                            long long s_stride, const float* __restrict__ base,
                            const float* __restrict__ hcc, const float* __restrict__ x,
                            float* __restrict__ out, long long n_rows, long long n_cams) {
  __shared__ __align__(16) float tiles[kWarps][kTileFloats];
  // the init: one camera component a thread of the grid's first 6 C
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if ((base != nullptr || hcc != nullptr) && t < 6 * n_cams) {
    float a = base != nullptr ? base[t] : 0.f;
    if (hcc != nullptr) {
      const float* h = hcc + 6 * t;  // row t % 6 of camera t / 6's block
      const float* xc = x + 6 * (t / 6);
      float hx = 0.f;
#pragma unroll
      for (int j = 0; j < 6; ++j) hx = fmaf(h[j], xc[j], hx);
      a += hx;
    }
    atomicAdd(out + t, a);
  }
  bool live;
  const Rows r = warp_rows(valid, n_rows, &live);
  if (r.live == 0u) return;
  const int lane = threadIdx.x & 31;
  // s as rows of 4 floats (the camera -> point sweep's buffer): one load
  const bool s_vec = s_stride == 4 && (reinterpret_cast<unsigned long long>(s) & 15u) == 0;
  const long long row = r.first + lane;
  long long c = 0, p = 0;
  if (live) {
    c = __ldcs(cam + row);
    p = __ldcs(pnt + row);
  }
  float* tile = tiles[threadIdx.x >> 5];
  stage_blocks(W, r, tile);
  float v[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (live) {
    float w[kRowFloats];
    lane_block(tile, w);
    float s0, s1, s2;
    if (s_vec) {
      const float4 sv = __ldg(reinterpret_cast<const float4*>(s) + p);
      s0 = sv.x;
      s1 = sv.y;
      s2 = sv.z;
    } else {
      const float* sp = s + p * s_stride;
      s0 = __ldg(sp);
      s1 = __ldg(sp + 1);
      s2 = __ldg(sp + 2);
    }
    const float4* hp = reinterpret_cast<const float4*>(hinv4) + 3 * p;
    float y[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float4 h = __ldg(hp + i);
      y[i] = fmaf(h.z, s2, fmaf(h.y, s1, h.x * s0));
    }
#pragma unroll
    for (int i = 0; i < 6; ++i)
      v[i] = fmaf(w[3 * i + 2], y[2], fmaf(w[3 * i + 1], y[1], w[3 * i] * y[0]));
  }
  // the warp's first cameras: a butterfly over the lanes of each, one
  // atomic a component; the rest, an atomic a row and component
  bool pending = live;
  unsigned todo = r.live;
#pragma unroll
  for (int round = 0; round < kCameraRounds; ++round) {
    if (todo == 0u) break;
    const long long c0 = __shfl_sync(kFull, c, __ffs(todo) - 1);
    const bool mine = pending && c == c0;
    float mine_sum = 0.f;
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      float a = mine ? v[k] : 0.f;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) a += __shfl_xor_sync(kFull, a, off);
      if (lane == k) mine_sum = a;
    }
    if (lane < 6) atomicAdd(out + 6 * c0 + lane, -mine_sum);
    pending = pending && !mine;
    todo = __ballot_sync(kFull, pending);
  }
  if (pending)
#pragma unroll
    for (int k = 0; k < 6; ++k) atomicAdd(out + 6 * c + k, -v[k]);
}

inline unsigned blocks_for(long long threads) {
  return (unsigned)((threads + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int ba_schur_cam_to_point_launch(const float* valid, const long long* cam,
                                            const long long* pnt, const float* W,
                                            const float* x, float* s4, long long n_rows,
                                            long long n_points, cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(s4, 0, sizeof(float) * 4 * n_points, stream);
  if (err != cudaSuccess) return (int)err;
  if (n_rows > 0)
    ba_schur_sweep_cam_to_point<<<blocks_for(n_rows), kThreads, 0, stream>>>(
        valid, cam, pnt, W, x, reinterpret_cast<float4*>(s4), n_rows);
  return (int)cudaGetLastError();
}

extern "C" int ba_schur_point_to_cam_launch(const float* valid, const long long* cam,
                                            const long long* pnt, const float* W,
                                            const float* hinv4, const float* s,
                                            long long s_stride, const float* base,
                                            const float* hcc, const float* x, float* out,
                                            long long n_rows, long long n_cams,
                                            cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(out, 0, sizeof(float) * 6 * n_cams, stream);
  if (err != cudaSuccess) return (int)err;
  const long long threads = n_rows > 6 * n_cams ? n_rows : 6 * n_cams;
  if (threads > 0)
    ba_schur_sweep_point_to_cam<<<blocks_for(threads), kThreads, 0, stream>>>(
        valid, cam, pnt, W, hinv4, s, s_stride, base, hcc, x, out, n_rows, n_cams);
  return (int)cudaGetLastError();
}

// W Hpp^-1 W^T x and its init H x in one call: the camera -> point sweep
// into s4, then the point -> camera sweep from it into out (two launches).
extern "C" int ba_schur_matvec_launch(const float* valid, const long long* cam,
                                      const long long* pnt, const float* W, const float* hinv4,
                                      const float* hcc, const float* x, float* s4, float* out,
                                      long long n_rows, long long n_cams, long long n_points,
                                      cudaStream_t stream) {
  const int err = ba_schur_cam_to_point_launch(valid, cam, pnt, W, x, s4, n_rows, n_points,
                                               stream);
  if (err != 0) return err;
  return ba_schur_point_to_cam_launch(valid, cam, pnt, W, hinv4, s4, 4, nullptr, hcc, x, out,
                                      n_rows, n_cams, stream);
}
