// ORB detection for every pyramid level of one image in one launch: the
// FAST-9/16 score, 3x3 non-maximum suppression, the 19-px border, the
// per-cell 20 -> 7 threshold fallback and the per-cell top-`cap`.
//
// Replaces the reference's XLA-fused detection orbslam2_with_quadrics_tpu/
// ops/orb.py::detect_level (:176-221, with fast_score :112-140 and nms3
// :143-165) and computes, bit for bit, what the port's plain version
// (ops/orb.py::detect_level_plain) computes up to and including
// `cv, ci = topk_stable(cells, cap)`:
//   * each circle contrast is the fp32 difference rounded once to bf16
//     (round to nearest even); the score is the max over the 16 circular
//     windows of 9 of max(window min, -window max), exact in float;
//   * NMS keeps a pixel strictly above its raster-earlier neighbours and at
//     least equal to the later ones;
//   * a cell's threshold is th_high where its largest kept score exceeds
//     th_high, else th_low; values at or below it become -inf;
//   * a cell's `cap` slots hold its values in topk_stable's order (value
//     descending, ties to the lower in-cell index), -inf slots included.
// The plain version's torch.roll wraps at the level's edge. The border
// (19 px) is wider than the tile's 4-px halo, so no kept pixel and no NMS
// neighbour of one reads a wrapped value: the kernel reads only inside the
// level (0 outside) and gives the ragged right and bottom cells -inf.
//
// What bounds it on an H100: launches and latency. One 480x640 image's 8
// levels are 1.3 MB of fp32 pixels (0.4 us at 3.35 TB/s) and about 0.6 G
// min/max operations; the plain version spends ~100 launches per level.
//
// Design:
//   * The grid runs over the 32x32 cells of all levels (998 blocks at
//     480x640 / 8 levels); a block of 256 threads owns one cell and finds
//     its level from the per-level cell offsets in the launch parameters.
//   * The block stages the cell and a 4-px halo (40x40) in shared memory,
//     scores the 34x34 pixels the NMS reads, then each thread takes 4
//     consecutive in-cell indices (4 t .. 4 t + 3).
//   * Top-cap without a sort: the finite values (few per cell) are compacted
//     in index order by a block-wide prefix count; each one's rank is the
//     number of finite values before it in topk order; the -inf slots after
//     them take the -inf pixels in index order, whose rank follows from the
//     same prefix count. No atomics: a run repeats itself bit for bit.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCell = 32;
constexpr int kHalo = 4;
constexpr int kTile = kCell + 2 * kHalo;  // 40
constexpr int kScore = kCell + 2;         // 34: the cell and its NMS ring
constexpr int kEdge = 19;                 // EDGE_THRESHOLD
constexpr int kMaxLevels = 16;

__constant__ int kDy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
__constant__ int kDx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};

struct Level {
  const float* img;
  int h, w, ncx, ncy, cell_base, cap, out_base;
};

struct Params {
  Level lv[kMaxLevels];
  int n_levels;
  float th_high, th_low;
};

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__global__ void __launch_bounds__(kThreads)
orb_detect_kernel(const Params p, float* __restrict__ out_v, int* __restrict__ out_yx) {
  __shared__ float tile[kTile][kTile + 1];
  __shared__ float sc[kScore][kScore + 1];
  __shared__ float fval[kCell * kCell];
  __shared__ short fidx[kCell * kCell];
  __shared__ float wmax[kWarps];
  __shared__ int wcount[kWarps];

  int l = 0;
  while (l + 1 < p.n_levels && static_cast<int>(blockIdx.x) >= p.lv[l + 1].cell_base) ++l;
  const Level L = p.lv[l];
  const int cell = blockIdx.x - L.cell_base;
  const int y0 = (cell / L.ncx) * kCell, x0 = (cell % L.ncx) * kCell;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int i = tid; i < kTile * kTile; i += kThreads) {
    const int ty = i / kTile, tx = i % kTile;
    const int gy = y0 - kHalo + ty, gx = x0 - kHalo + tx;
    tile[ty][tx] = (gy >= 0 && gy < L.h && gx >= 0 && gx < L.w) ? L.img[gy * L.w + gx] : 0.0f;
  }
  __syncthreads();

  // FAST-9/16 score of the 34x34 pixels the NMS reads
  for (int i = tid; i < kScore * kScore; i += kThreads) {
    const int ry = i / kScore, rx = i % kScore;
    const int ty = ry + kHalo - 1, tx = rx + kHalo - 1;
    const float c = tile[ty][tx];
    float d[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) d[k] = bf16_round(tile[ty + kDy[k]][tx + kDx[k]] - c);
    float best = -INFINITY;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      float mn = d[k], mx = d[k];
#pragma unroll
      for (int j = 1; j < 9; ++j) {
        mn = fminf(mn, d[(k + j) & 15]);
        mx = fmaxf(mx, d[(k + j) & 15]);
      }
      best = fmaxf(best, fmaxf(mn, -mx));
    }
    sc[ry][rx] = best;
  }
  __syncthreads();

  // NMS and border for the thread's 4 in-cell indices 4 tid .. 4 tid + 3
  const int row = tid >> 3, col0 = (tid & 7) * 4;
  const int gy = y0 + row;
  float v[4];
  float vmax = -INFINITY;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int col = col0 + k, gx = x0 + col;
    float s = -INFINITY;
    if (gy >= kEdge && gy < L.h - kEdge && gx >= kEdge && gx < L.w - kEdge) {
      const int sy = row + 1, sx = col + 1;
      const float c = sc[sy][sx];
      const bool keep = c > sc[sy - 1][sx - 1] && c > sc[sy - 1][sx] && c > sc[sy - 1][sx + 1]
                        && c > sc[sy][sx - 1] && c >= sc[sy][sx + 1] && c >= sc[sy + 1][sx - 1]
                        && c >= sc[sy + 1][sx] && c >= sc[sy + 1][sx + 1];
      if (keep) s = c;
    }
    v[k] = s;
    vmax = fmaxf(vmax, s);
  }
  // the cell's largest kept score picks its threshold
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) vmax = fmaxf(vmax, __shfl_xor_sync(0xffffffffu, vmax, off));
  if (lane == 0) wmax[warp] = vmax;
  __syncthreads();
  float cmax = wmax[0];
  for (int w = 1; w < kWarps; ++w) cmax = fmaxf(cmax, wmax[w]);
  const float th = cmax > p.th_high ? p.th_high : p.th_low;
  int cnt = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (!(v[k] > th)) v[k] = -INFINITY;
    cnt += v[k] > -INFINITY ? 1 : 0;
  }
  // exclusive prefix count of finite values in index order
  int incl = cnt;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  if (lane == 31) wcount[warp] = incl;
  __syncthreads();
  int before = incl - cnt, nf = 0;
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) before += wcount[w];
    nf += wcount[w];
  }
  int pos = before;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (v[k] > -INFINITY) {
      fval[pos] = v[k];
      fidx[pos] = static_cast<short>(4 * tid + k);
      ++pos;
    }
  __syncthreads();

  const int cap = L.cap;
  const int base = L.out_base + cell * cap;
  // finite values: rank among them in topk order (ties to the lower index)
  for (int j = tid; j < nf; j += kThreads) {
    const float fj = fval[j];
    int rank = 0;
    for (int k = 0; k < nf; ++k) {
      const float fk = fval[k];
      rank += (fk > fj || (fk == fj && k < j)) ? 1 : 0;
    }
    if (rank < cap) {
      const int ci = fidx[j];
      out_v[base + rank] = fj;
      out_yx[2 * (base + rank)] = y0 + ci / kCell;
      out_yx[2 * (base + rank) + 1] = x0 + ci % kCell;
    }
  }
  // -inf slots: the -inf pixels in index order after the nf finite ones
  int seen = before;  // finite values at lower in-cell indices
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int ci = 4 * tid + k;
    if (v[k] > -INFINITY) {
      ++seen;
      continue;
    }
    const int slot = nf + (ci - seen);
    if (slot < cap) {
      out_v[base + slot] = -INFINITY;
      out_yx[2 * (base + slot)] = y0 + ci / kCell;
      out_yx[2 * (base + slot) + 1] = x0 + ci % kCell;
    }
  }
}

}  // namespace

// levels: n_levels rows of 8 int64 (image address, h, w, ncx, ncy,
// cell_base, cap, out_base); the grid is the total cell count.
extern "C" int orb_detect_launch(const int64_t* levels, int n_levels, int n_cells,
                                 float th_high, float th_low, void* out_v, void* out_yx,
                                 void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || n_cells < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  for (int l = 0; l < n_levels; ++l) {
    const int64_t* r = levels + 8 * l;
    p.lv[l] = Level{reinterpret_cast<const float*>(r[0]), static_cast<int>(r[1]),
                    static_cast<int>(r[2]), static_cast<int>(r[3]), static_cast<int>(r[4]),
                    static_cast<int>(r[5]), static_cast<int>(r[6]), static_cast<int>(r[7])};
  }
  p.n_levels = n_levels;
  p.th_high = th_high;
  p.th_low = th_low;
  orb_detect_kernel<<<n_cells, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      p, static_cast<float*>(out_v), static_cast<int*>(out_yx));
  return static_cast<int>(cudaGetLastError());
}
