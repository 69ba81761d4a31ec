// Masked Hamming best-two, batched: for each query descriptor of each of B
// problems, the lowest target index at minimum Hamming distance, that
// distance, and the second-best distance, over the targets admitted by a
// projection window.
//
// Replaces the TPU Pallas kernel orbslam2_with_quadrics_tpu/ops/
// pallas_kernels.py::_kernel (launched by masked_hamming_best2_tpu) and
// keeps the contract every production path of the reference follows,
// best_two(where(mask, hamming, BIG)) (pallas_kernels.py:223-239):
//   * argbest is the lowest target index reaching the minimum;
//   * second is the minimum with only that column masked, so exact ties
//     give second == best;
//   * a row with no admissible target returns (idx 0, BIG, BIG).
// mask(q, t) = |qu - tu| <= r_q && |qv - tv| <= r_q (float32)
//              && |lvl_q - lvl_t| <= level_tol && qvalid && tvalid.
//
// What bounds it on an H100: instruction throughput, not bytes. A
// (4096, 1024) problem moves about 0.3 MB (0.1 us at 3.35 TB/s) but has
// 4.2 M pairs. With every pair admitted the floor is the popcount pipe:
// 8 POPC per pair at 16 per clock per SM (NVIDIA's table of arithmetic
// throughput per compute capability, column 9.0) on 132 SMs at the 1.98 GHz
// boost clock is 8.0 us there and 2.0 us at (1024, 1024). On the system's
// inputs a 3-30 px window admits well under 1% of the pairs, so the work
// is the window test: two subtractions and two compares per pair, 0.5 us
// at (4096, 1024) at the card's fp32 rate (half of 67 TFLOP/s, which counts
// an FMA as two). That is below what any launch costs, so there the
// kernel's time is its fixed part: the launch, staging the targets once
// per block, one pass over them.
//
// Design:
//   * Decomposition. The grid is (query tiles, B). A block of 8 warps owns
//     `q_per_block` queries of one problem and ALL its targets, so no
//     atomics and no second pass are needed; the wrapper picks q_per_block
//     (8..64) so that about two blocks per SM exist at the main path's
//     shapes: 128 blocks at (1024, 1024), 256 at (4096, 1024) and at
//     B = 2, 260 at the fuse shape B = 10. A warp takes every 8th query of
//     the tile; the 32 lanes split the targets (target j of a 1024-target
//     chunk belongs to lane j % 32), so a thread tests 32 pairs per query.
//   * The window test comes first and is all the common path does. The
//     block stages a chunk of up to 1024 targets in shared memory; a lane
//     keeps the uv of its 32 targets in registers for all the warp's
//     queries, and an invalid or out-of-range target is staged with a NaN
//     uv, which fails both compares for free. A lane builds a 32-bit mask
//     of the pairs inside the window (4 operations and a predicated OR
//     per pair), then walks the set bits: only there are the level, the
//     two 16-byte descriptor halves and the 8 popcounts touched. An invalid
//     query is staged with a NaN radius and skipped by the whole warp.
//   * Shared-memory layout. The descriptor halves are two uint4 arrays
//     (not [j][2]): lanes reading neighbouring targets stride by 16 bytes,
//     which is conflict-free for 16-byte loads; uv (8 bytes) and level (4)
//     are read at unit stride too. The query's fields are read by all
//     lanes from one address (a broadcast).
//   * Merge. A partial is a packed key (d << 22) | target_index with d in
//     9 bits (511 = nothing admitted; restored to BIG at the end) and a
//     second-best distance. min over keys gives the lowest index among the
//     minima whatever the order the targets were seen in, and
//       key = min(k1, k2),  second = min(s1, s2, d(max(k1, k2)))
//     is associative and commutative. The 32 lane partials are merged by
//     two warp-wide integer min reductions (redux.sync): the key, then
//     per lane (second if the lane holds the winner, else its best d).
//     Chunks beyond the first (N > 1024) merge into a running partial that
//     lane i keeps for the warp's i-th query.
//   * Occupancy: nvcc -Xptxas -v reports 102 registers, no spills and
//     48,128 bytes of static shared memory; __launch_bounds__(256, 2) holds
//     it under 128 registers, so two blocks (16 warps) are resident per SM,
//     bound by registers (65,536 / (256 * 102)). The build keeps ptxas'
//     report beside the library.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 1024;             // targets staged per pass
constexpr int kPerLane = kChunk / 32;    // targets a lane owns per chunk
constexpr int kMaxQPerBlock = 64;        // so a warp has at most 8 queries
constexpr int kBig = 1 << 20;
constexpr int kIdxBits = 22;             // N < 2^22 (checked by the wrapper)
constexpr unsigned kNoneD = 511;         // 9-bit "nothing admitted" distance
constexpr unsigned kNoneKey = kNoneD << kIdxBits;

__device__ __forceinline__ void merge_partial(unsigned& key, unsigned& second,
                                              unsigned k2, unsigned s2) {
  const unsigned loser = max(key, k2) >> kIdxBits;
  key = min(key, k2);
  second = min(min(second, s2), loser);
}

__global__ void __launch_bounds__(kThreads, 2) masked_hamming_best2_kernel(
    const uint4* __restrict__ qdesc, const float2* __restrict__ quv,
    const float* __restrict__ qrad, const int* __restrict__ qlvl,
    const unsigned char* __restrict__ qvalid,
    const uint4* __restrict__ tdesc, const float2* __restrict__ tuv,
    const int* __restrict__ tlvl, const unsigned char* __restrict__ tvalid,
    int Q, int N, int t_batch_stride, int q_per_block, int level_tol,
    int* __restrict__ out_idx, int* __restrict__ out_best,
    int* __restrict__ out_second) {
  __shared__ uint4 s_tlo[kChunk];   // descriptor words 0-3
  __shared__ uint4 s_thi[kChunk];   // descriptor words 4-7
  __shared__ float2 s_tuv[kChunk];  // NaN where the target is masked
  __shared__ int s_tlvl[kChunk];
  __shared__ uint4 s_qlo[kMaxQPerBlock];
  __shared__ uint4 s_qhi[kMaxQPerBlock];
  __shared__ float2 s_quv[kMaxQPerBlock];
  __shared__ float s_qrad[kMaxQPerBlock];  // NaN where the query is masked
  __shared__ int s_qlvl[kMaxQPerBlock];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * q_per_block;
  const int n_q = min(q_per_block, Q - q0);
  const size_t qoff = static_cast<size_t>(b) * Q + q0;
  const size_t toff = static_cast<size_t>(b) * t_batch_stride;
  const float nan = __int_as_float(0x7fc00000);

  for (int i = tid; i < n_q; i += kThreads) {
    s_qlo[i] = qdesc[2 * (qoff + i)];
    s_qhi[i] = qdesc[2 * (qoff + i) + 1];
    s_quv[i] = quv[qoff + i];
    s_qrad[i] = qvalid[qoff + i] ? qrad[qoff + i] : nan;
    s_qlvl[i] = qlvl[qoff + i];
  }

  // lane i holds the running partial of the warp's i-th query
  unsigned run_key = kNoneKey, run_second = kNoneD;

  for (int base = 0; base < N; base += kChunk) {
    const int n_t = min(kChunk, N - base);
    const int k_max = (n_t + 31) >> 5;
    __syncthreads();  // previous chunk fully consumed
    for (int i = tid; i < 2 * n_t; i += kThreads) {
      const uint4 w = tdesc[2 * (toff + base) + i];  // coalesced
      if (i & 1) s_thi[i >> 1] = w; else s_tlo[i >> 1] = w;
    }
    for (int j = tid; j < 32 * k_max; j += kThreads) {
      const bool ok = j < n_t && tvalid[toff + base + j];
      s_tuv[j] = ok ? tuv[toff + base + j] : make_float2(nan, nan);
      s_tlvl[j] = j < n_t ? tlvl[toff + base + j] : 0;
    }
    __syncthreads();

    float2 t[kPerLane];  // NaN past the chunk's end: never inside a window
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      t[k] = k < k_max ? s_tuv[32 * k + lane] : make_float2(nan, nan);
    }

    for (int qi = 0, i = warp; i < n_q; ++qi, i += kWarps) {
      const float r = s_qrad[i];
      if (!(r == r)) continue;  // masked query: the whole warp skips it
      const float2 uv = s_quv[i];
      unsigned hits = 0;
#pragma unroll
      for (int k = 0; k < kPerLane; ++k) {
        const bool in = (fabsf(uv.x - t[k].x) <= r) & (fabsf(uv.y - t[k].y) <= r);
        if (in) hits |= 1u << k;
      }
      unsigned key = kNoneKey, second = kNoneD;
      if (hits) {
        const int lvl = s_qlvl[i];
        const uint4 d0 = s_qlo[i], d1 = s_qhi[i];
        do {
          const int j = 32 * (__ffs(hits) - 1) + lane;
          hits &= hits - 1;
          if (abs(s_tlvl[j] - lvl) > level_tol) continue;
          const uint4 a = s_tlo[j], c = s_thi[j];
          const unsigned d = __popc(d0.x ^ a.x) + __popc(d0.y ^ a.y) +
                             __popc(d0.z ^ a.z) + __popc(d0.w ^ a.w) +
                             __popc(d1.x ^ c.x) + __popc(d1.y ^ c.y) +
                             __popc(d1.z ^ c.z) + __popc(d1.w ^ c.w);
          merge_partial(key, second, (d << kIdxBits) | (base + j), kNoneD);
        } while (hits);
      }
      // the 32 lane partials -> one, the same in every lane
      const unsigned best = __reduce_min_sync(0xffffffffu, key);
      const unsigned rest = key == best ? second : key >> kIdxBits;
      const unsigned best_second = __reduce_min_sync(0xffffffffu, rest);
      if (lane == qi) merge_partial(run_key, run_second, best, best_second);
    }
  }

  const int i = warp + kWarps * lane;  // the query whose partial this lane holds
  if (i < n_q) {
    const unsigned d = run_key >> kIdxBits;
    const size_t o = qoff + i;
    out_idx[o] = d == kNoneD ? 0 : static_cast<int>(run_key & ((1u << kIdxBits) - 1));
    out_best[o] = d == kNoneD ? kBig : static_cast<int>(d);
    out_second[o] = run_second == kNoneD ? kBig : static_cast<int>(run_second);
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). Queries are [B, Q, ...];
// targets are [B, N, ...] (t_batched != 0) or one [N, ...] set shared by the
// batch; outputs are [B, Q] each. Launches on `stream`, does not
// synchronise, allocates nothing, and returns cudaGetLastError() after the
// launch. `q_per_block` must lie in [1, 64].
extern "C" int masked_hamming_best2_launch(
    const void* qdesc, const void* quv, const void* qrad, const void* qlvl,
    const void* qvalid, const void* tdesc, const void* tuv, const void* tlvl,
    const void* tvalid, int B, int Q, int N, int t_batched, int q_per_block,
    int level_tol, void* out_idx, void* out_best, void* out_second,
    void* stream) {
  if (q_per_block < 1 || q_per_block > kMaxQPerBlock) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((Q + q_per_block - 1) / q_per_block, B);
  masked_hamming_best2_kernel<<<grid, kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(qdesc), static_cast<const float2*>(quv),
      static_cast<const float*>(qrad), static_cast<const int*>(qlvl),
      static_cast<const unsigned char*>(qvalid),
      static_cast<const uint4*>(tdesc), static_cast<const float2*>(tuv),
      static_cast<const int*>(tlvl),
      static_cast<const unsigned char*>(tvalid), Q, N, t_batched ? N : 0,
      q_per_block, level_tol, static_cast<int*>(out_idx),
      static_cast<int*>(out_best), static_cast<int*>(out_second));
  return static_cast<int>(cudaGetLastError());
}
