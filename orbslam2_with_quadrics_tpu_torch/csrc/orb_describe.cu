// ORB orientation and rotated-BRIEF descriptors for every keypoint of one
// image in one launch.
//
// Replaces the descriptor stage of the reference's orbslam2_with_quadrics_
// tpu/ops/orb.py::extract (:366-467: on the TPU the patch cut as one-hot
// row/column matmuls and the BRIEF taps as a one-hot contraction) and
// computes what the port's plain version (ops/orb.py::describe_plain)
// computes:
//   * the 37x37 raw patch of each keypoint cut from a zero-padded canvas of
//     level 0's size: the start clamped as y0 = clamp(y - 18, 0, H0 - 37)
//     (likewise x), pixels outside the keypoint's own level read as 0; an
//     invalid keypoint is cut at (19, 19);
//   * the intensity-centroid moments (m01, m10) over the 31x31 centre with
//     the circular weights dy, dx (dy^2 + dx^2 <= 225), then
//     atan2f(m01, m10), 0 where the keypoint is not valid. The moments are
//     summed in float64 (each product dy * pixel is exact there) and
//     rounded once to float32: the plain version's float32 matmul loses up
//     to ~4e-4 rad at keypoints whose moments nearly cancel (measured on a
//     rendered 480x640 frame), so the kernel is held to a float64
//     evaluation and agrees with the plain version up to that error;
//   * the 7-tap Gaussian (sigma 2), vertical pass first, then horizontal,
//     each as acc = p0 k0, acc = acc + p_i k_i; only the 31x31 centre is
//     needed and its taps never reach the patch's edge;
//   * taps rx = rint(px ca - py sa), ry = rint(px sa + py ca) (round half
//     to even, as torch.round), clamped to [0, 30] after + 15; test t is
//     blur(tap 2t) < blur(tap 2t + 1); bit j of word w is test 32 w + j;
//     the words of an invalid keypoint are 0.
// The build passes -fmad=false, so each multiply and add rounds on its own
// as the plain version's elementwise ops do: the blur and the taps are
// bit-exact. cosf, sinf and atan2f are the CUDA math library's, as
// PyTorch's kernels call them. Where the float32 sums are exact (an
// integer image at one level) the angles and words are equal.
//
// What bounds it on an H100: latency, not bytes or operations. 1,024
// keypoints read at most 5.6 MB of patches (1.7 us at 3.35 TB/s) and do
// about 40 M instructions (1.2 us at 33.5 T/s, 2.9 M of them float64, which
// the H100 runs at half the float32 rate); the plain version dispatches
// about 40 small ops.
//
// Design (simple and right first): one block of 256 threads per keypoint.
// The raw patch, the vertically blurred 31x37 band and the blurred 31x31
// centre live in shared memory; the moments are a float64 block reduction
// (warp shuffle tree, then the 8 warps' sums in warp order: no atomics, a
// run repeats itself); thread t evaluates test t and each warp's
// __ballot_sync is one descriptor word.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kR = 15;               // PATCH_RADIUS
constexpr int kRs = kR + 3;          // the blur's 3-px support
constexpr int kSide = 2 * kRs + 1;   // 37
constexpr int kIn = 2 * kR + 1;      // 31
constexpr int kEdge = 19;            // EDGE_THRESHOLD: where an invalid keypoint is cut
constexpr int kMaxLevels = 16;

struct Level {
  const float* img;
  int h, w;
};

struct Params {
  Level lv[kMaxLevels];
  int h0, w0;
  float k[7];                 // float32(_gauss7(2.0))
  const int64_t* kp_y;
  int64_t sy;                 // element strides of kp_y and kp_x
  const int64_t* kp_x;
  int64_t sx;
  const int64_t* lvl;
  const bool* valid;
  const float* pattern;       // [512][2] (x, y) taps: pairs (2t, 2t + 1)
  float* angle;               // [N]
  int* desc;                  // [N][8]
};

__global__ void __launch_bounds__(kThreads) orb_describe_kernel(const Params p) {
  __shared__ float raw[kSide][kSide];
  __shared__ float band[kIn][kSide];
  __shared__ float blur[kIn][kIn];
  __shared__ double part[2][kWarps];
  __shared__ float rot[2];

  const int k = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool ok = p.valid[k];
  const int y = ok ? static_cast<int>(p.kp_y[k * p.sy]) : kEdge;
  const int x = ok ? static_cast<int>(p.kp_x[k * p.sx]) : kEdge;
  const Level L = p.lv[p.lvl[k]];
  const int y0 = min(max(y - kRs, 0), p.h0 - kSide);
  const int x0 = min(max(x - kRs, 0), p.w0 - kSide);

  for (int i = tid; i < kSide * kSide; i += kThreads) {
    const int r = i / kSide, c = i % kSide;
    const int gy = y0 + r, gx = x0 + c;
    raw[r][c] = (gy < L.h && gx < L.w) ? L.img[static_cast<int64_t>(gy) * L.w + gx] : 0.0f;
  }
  __syncthreads();

  // intensity-centroid moments over the circular 31x31 centre, in float64
  double m01 = 0.0, m10 = 0.0;
  for (int i = tid; i < kIn * kIn; i += kThreads) {
    const int dy = i / kIn - kR, dx = i % kIn - kR;
    if (dy * dy + dx * dx <= kR * kR) {
      const double v = raw[dy + kRs][dx + kRs];
      m01 = m01 + dy * v;
      m10 = m10 + dx * v;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    m01 = m01 + __shfl_xor_sync(0xffffffffu, m01, off);
    m10 = m10 + __shfl_xor_sync(0xffffffffu, m10, off);
  }
  if (lane == 0) {
    part[0][warp] = m01;
    part[1][warp] = m10;
  }
  // the vertical pass: band row r is the raw rows r..r+6 (centre row r + 3)
  for (int i = tid; i < kIn * kSide; i += kThreads) {
    const int r = i / kSide, c = i % kSide;
    float acc = raw[r][c] * p.k[0];
#pragma unroll
    for (int t = 1; t < 7; ++t) acc = acc + raw[r + t][c] * p.k[t];
    band[r][c] = acc;
  }
  __syncthreads();
  if (tid == 0) {
    double s01 = part[0][0], s10 = part[1][0];
    for (int w = 1; w < kWarps; ++w) {
      s01 = s01 + part[0][w];
      s10 = s10 + part[1][w];
    }
    const float a = ok ? atan2f(static_cast<float>(s01), static_cast<float>(s10)) : 0.0f;
    p.angle[k] = a;
    rot[0] = cosf(a);
    rot[1] = sinf(a);
  }
  // the horizontal pass over the centre columns
  for (int i = tid; i < kIn * kIn; i += kThreads) {
    const int r = i / kIn, c = i % kIn;
    float acc = band[r][c] * p.k[0];
#pragma unroll
    for (int t = 1; t < 7; ++t) acc = acc + band[r][c + t] * p.k[t];
    blur[r][c] = acc;
  }
  __syncthreads();

  // test tid: tap 2 tid against tap 2 tid + 1, rotated by the angle
  const float ca = rot[0], sa = rot[1];
  float v[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const float px = p.pattern[4 * tid + 2 * j], py = p.pattern[4 * tid + 2 * j + 1];
    const int rx = static_cast<int>(rintf(px * ca - py * sa));
    const int ry = static_cast<int>(rintf(px * sa + py * ca));
    v[j] = blur[min(max(ry + kR, 0), 2 * kR)][min(max(rx + kR, 0), 2 * kR)];
  }
  const unsigned word = __ballot_sync(0xffffffffu, v[0] < v[1]);
  if (lane == 0) p.desc[8 * k + warp] = ok ? static_cast<int>(word) : 0;
}

}  // namespace

// levels: n_levels rows of 3 int64 (image address, h, w); the grid is one
// block per keypoint. The level ids must lie in [0, n_levels).
extern "C" int orb_describe_launch(const int64_t* levels, int n_levels, int h0, int w0,
                                   const void* kp_y, int64_t sy, const void* kp_x, int64_t sx,
                                   const void* lvl, const void* valid, int n,
                                   const void* pattern, const float* gauss, void* angle,
                                   void* desc, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || n < 1 || h0 < kSide || w0 < kSide)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  for (int l = 0; l < n_levels; ++l) {
    const int64_t* r = levels + 3 * l;
    p.lv[l] = Level{reinterpret_cast<const float*>(r[0]), static_cast<int>(r[1]),
                    static_cast<int>(r[2])};
  }
  p.h0 = h0;
  p.w0 = w0;
  for (int t = 0; t < 7; ++t) p.k[t] = gauss[t];
  p.kp_y = static_cast<const int64_t*>(kp_y);
  p.sy = sy;
  p.kp_x = static_cast<const int64_t*>(kp_x);
  p.sx = sx;
  p.lvl = static_cast<const int64_t*>(lvl);
  p.valid = static_cast<const bool*>(valid);
  p.pattern = static_cast<const float*>(pattern);
  p.angle = static_cast<float*>(angle);
  p.desc = static_cast<int*>(desc);
  orb_describe_kernel<<<n, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
