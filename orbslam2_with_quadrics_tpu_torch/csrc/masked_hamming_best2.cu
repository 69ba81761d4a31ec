// Masked Hamming best-two: for each query descriptor, the lowest target
// index at minimum Hamming distance, that distance, and the second-best
// distance, over the targets admitted by a projection window.
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
// Design: one thread per query keeps its 8 descriptor words, uv, radius and
// level in registers; the block stages 256-target tiles (descriptors, uv,
// level, valid: ~11.3 KB) in shared memory and every thread walks the tile
// in increasing target order with a strict-< update, which yields the
// lowest-index tie-break. Any Q and N: the ragged edges are masked here,
// nothing is padded.
//
// What bounds it on an H100: at the main path's 4096x1024 it is bound by
// integer instructions, not bytes — 8 XOR+popcount per pair plus the window
// test, with targets reused from shared memory by all 256 queries of a
// block. 4096 queries in blocks of 256 give 16 blocks for 132 SMs; filling
// the card (splitting targets across blocks, or a warp per query tile) is
// later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 256;
constexpr int kBig = 1 << 20;

__global__ void masked_hamming_best2_kernel(
    const uint4* __restrict__ qdesc, const float2* __restrict__ quv,
    const float* __restrict__ qrad, const int* __restrict__ qlvl,
    const unsigned char* __restrict__ qvalid,
    const uint4* __restrict__ tdesc, const float2* __restrict__ tuv,
    const int* __restrict__ tlvl, const unsigned char* __restrict__ tvalid,
    int Q, int N, int level_tol,
    int* __restrict__ out_idx, int* __restrict__ out_best,
    int* __restrict__ out_second) {
  __shared__ uint4 s_desc[kTile][2];
  __shared__ float2 s_uv[kTile];
  __shared__ int s_lvl[kTile];
  __shared__ unsigned char s_ok[kTile];

  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = q < Q;
  uint4 d0 = make_uint4(0, 0, 0, 0), d1 = d0;
  float2 uv = make_float2(0.f, 0.f);
  float r = 0.f;
  int lvl = 0;
  bool qok = false;
  if (live) {
    d0 = qdesc[2 * q];
    d1 = qdesc[2 * q + 1];
    uv = quv[q];
    r = qrad[q];
    lvl = qlvl[q];
    qok = qvalid[q] != 0;
  }

  int best = kBig, second = kBig, bidx = 0;
  for (int base = 0; base < N; base += kTile) {
    const int n_tile = min(kTile, N - base);
    __syncthreads();  // previous tile fully consumed
    for (int j = threadIdx.x; j < n_tile; j += blockDim.x) {
      s_desc[j][0] = tdesc[2 * (base + j)];
      s_desc[j][1] = tdesc[2 * (base + j) + 1];
      s_uv[j] = tuv[base + j];
      s_lvl[j] = tlvl[base + j];
      s_ok[j] = tvalid[base + j];
    }
    __syncthreads();
    if (!qok) continue;
    for (int j = 0; j < n_tile; ++j) {
      const float2 t = s_uv[j];
      const bool ok = s_ok[j] && fabsf(uv.x - t.x) <= r &&
                      fabsf(uv.y - t.y) <= r &&
                      abs(s_lvl[j] - lvl) <= level_tol;
      if (!ok) continue;  // a masked candidate is BIG: never an update
      const uint4 a = s_desc[j][0], b = s_desc[j][1];
      const int d = __popc(d0.x ^ a.x) + __popc(d0.y ^ a.y) +
                    __popc(d0.z ^ a.z) + __popc(d0.w ^ a.w) +
                    __popc(d1.x ^ b.x) + __popc(d1.y ^ b.y) +
                    __popc(d1.z ^ b.z) + __popc(d1.w ^ b.w);
      if (d < best) {
        second = best;
        best = d;
        bidx = base + j;
      } else if (d < second) {
        second = d;
      }
    }
  }
  if (live) {
    out_idx[q] = bidx;
    out_best[q] = best;
    out_second[q] = second;
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() after the launch.
extern "C" int masked_hamming_best2_launch(
    const void* qdesc, const void* quv, const void* qrad, const void* qlvl,
    const void* qvalid, const void* tdesc, const void* tuv, const void* tlvl,
    const void* tvalid, int Q, int N, int level_tol, void* out_idx,
    void* out_best, void* out_second, void* stream) {
  const int threads = kTile;
  const int blocks = (Q + threads - 1) / threads;
  masked_hamming_best2_kernel<<<blocks, threads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(qdesc), static_cast<const float2*>(quv),
      static_cast<const float*>(qrad), static_cast<const int*>(qlvl),
      static_cast<const unsigned char*>(qvalid),
      static_cast<const uint4*>(tdesc), static_cast<const float2*>(tuv),
      static_cast<const int*>(tlvl),
      static_cast<const unsigned char*>(tvalid), Q, N, level_tol,
      static_cast<int*>(out_idx), static_cast<int*>(out_best),
      static_cast<int*>(out_second));
  return static_cast<int>(cudaGetLastError());
}
