// Texture kernels of the extraction stage: GLCM pair counts of uint8 frames
// and uniform LBP codes of uint8, uint16 or float32 frames.  Neither replaces a pallas_call: they replace XLA
// code of yamimageprocessor_tpu/ops/texture.py.
//
// glcm_counts (for glcm_j's .at[idx].add(1), texture.py:143): the (n, 256,
// 256) int32 counts of (I[y, x], I[y + dy, x + dx]) over the window where
// both lie in the frame, any offset.  256 KiB of counters a frame are more
// than one SM's shared memory, so the counts go straight to device memory,
// where a frame's table stays in the 50 MB L2.  Bound on the card: bytes
// (the frame read once, the table written once) unless many pixels share a
// pair, when the atomics on one address serialise: lanes of a warp holding
// the same pair are merged (__match_any_sync) and their leader adds the
// count once, so a flat frame issues one atomic a warp, not 32.  The output
// must be zero (the wrapper allocates it with torch.zeros).
//
// lbp_codes (for lbp_j, texture.py:70, and lbp_np, :40): the uniform code
// 0..P+1 of every pixel, as uint8, from frames of any of the three element
// types (a template parameter; every value is exact in float32 and float64,
// so the arithmetic after the load is the same).  A thread a pixel; the P <= 32 samples' parameters
// sit in shared memory, the frame is read through the cache with edge
// clamping (the reference pads by ceil(R) + 1 with edge values), the sample
// bits gather in one word, and ones and transitions are popcounts.  Bound:
// bytes (1 in, 1 out) at small P; at P = 24 about 4 * 24 cached reads and
// 3 * 24 fused multiply-adds a pixel.  Two arithmetics, a template flag:
//
// - float32 (the chain): each sample is the difference to the centre,
//   interpolated as XLA's CPU backend runs lbp_j, the weights folded into
//   one float32 constant a corner: fma(d0, w0, d1 * w1), then
//   fma(d2, w2, acc), fma(d3, w3, acc); the bit is acc >= 0;
// - float64 (the data path, lbp_np): the raw values interpolated with the
//   fractions formed per pixel, ry = (y + pad) + dr, fy = ry - floor(ry),
//   ((v00 (1 - fy)) (1 - fx) + (v01 (1 - fy)) fx) + ..., compared with the
//   centre; every operation rounded apart, as numpy does.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int GLCM_THREADS = 256;
constexpr int LBP_TX = 32, LBP_TY = 8;
constexpr int MAX_P = 32;

__global__ void __launch_bounds__(GLCM_THREADS)
glcm_counts_kernel(const uint8_t* __restrict__ src, int* __restrict__ out, int h, int w, int dx, int dy,
                   int r0, int c0, int rows, int cols) {
  const uint8_t* img = src + static_cast<long long>(blockIdx.y) * h * w;
  int* table = out + static_cast<long long>(blockIdx.y) * 65536;
  const long long total = static_cast<long long>(rows) * cols;
  const int lane = threadIdx.x & 31;
  const long long warp = (static_cast<long long>(blockIdx.x) * GLCM_THREADS + threadIdx.x) >> 5;
  const long long warps = (static_cast<long long>(gridDim.x) * GLCM_THREADS) >> 5;
  // warp-uniform trip count: every lane takes part in each match
  for (long long base = warp * 32; base < total; base += warps * 32) {
    const long long k = base + lane;
    int key = -1;
    if (k < total) {
      const int r = static_cast<int>(k / cols) + r0, c = static_cast<int>(k % cols) + c0;
      const int a = __ldg(img + static_cast<long long>(r) * w + c);
      const int b = __ldg(img + static_cast<long long>(r + dy) * w + (c + dx));
      key = a * 256 + b;
    }
    const unsigned peers = __match_any_sync(0xffffffffu, key);
    if (key >= 0 && lane == __ffs(peers) - 1) atomicAdd(table + key, __popc(peers));
  }
}

__device__ __forceinline__ int clampi(int v, int hi) { return v < 0 ? 0 : (v > hi ? hi : v); }

template <bool GOLDEN, typename T>
__global__ void __launch_bounds__(LBP_TX * LBP_TY)
lbp_codes_kernel(const T* __restrict__ src, uint8_t* __restrict__ dst, const void* __restrict__ params,
                 int h, int w, int p, int pad) {
  // float32: (p, 6) words (int32 y0, int32 x0, w00, w01, w10, w11); float64: (p, 2) (dr, dc)
  __shared__ float f32p[MAX_P * 6];
  __shared__ double f64p[MAX_P * 2];
  const int tid = threadIdx.y * LBP_TX + threadIdx.x;
  if (GOLDEN) {
    for (int k = tid; k < 2 * p; k += LBP_TX * LBP_TY) f64p[k] = static_cast<const double*>(params)[k];
  } else {
    for (int k = tid; k < 6 * p; k += LBP_TX * LBP_TY) f32p[k] = static_cast<const float*>(params)[k];
  }
  __syncthreads();
  const int x = blockIdx.x * LBP_TX + threadIdx.x, y = blockIdx.y * LBP_TY + threadIdx.y;
  if (x >= w || y >= h) return;
  const long long frame = static_cast<long long>(blockIdx.z) * h * w;
  const T* img = src + frame;
  const T centre = __ldg(img + static_cast<long long>(y) * w + x);
  unsigned bits = 0;
  for (int s = 0; s < p; ++s) {
    bool bit;
    if (GOLDEN) {
      const double ry = __dadd_rn(static_cast<double>(y + pad), f64p[2 * s]);
      const double cx = __dadd_rn(static_cast<double>(x + pad), f64p[2 * s + 1]);
      const double fy0 = floor(ry), fx0 = floor(cx);
      const double fy = __dsub_rn(ry, fy0), fx = __dsub_rn(cx, fx0);
      const int y0 = static_cast<int>(fy0) - pad, x0 = static_cast<int>(fx0) - pad;
      const int ya = clampi(y0, h - 1), yb = clampi(y0 + 1, h - 1);
      const int xa = clampi(x0, w - 1), xb = clampi(x0 + 1, w - 1);
      const double v00 = static_cast<double>(__ldg(img + static_cast<long long>(ya) * w + xa));
      const double v01 = static_cast<double>(__ldg(img + static_cast<long long>(ya) * w + xb));
      const double v10 = static_cast<double>(__ldg(img + static_cast<long long>(yb) * w + xa));
      const double v11 = static_cast<double>(__ldg(img + static_cast<long long>(yb) * w + xb));
      const double gy = __dsub_rn(1.0, fy), gx = __dsub_rn(1.0, fx);
      double val = __dmul_rn(__dmul_rn(v00, gy), gx);
      val = __dadd_rn(val, __dmul_rn(__dmul_rn(v01, gy), fx));
      val = __dadd_rn(val, __dmul_rn(__dmul_rn(v10, fy), gx));
      val = __dadd_rn(val, __dmul_rn(__dmul_rn(v11, fy), fx));
      bit = val >= static_cast<double>(centre);
    } else {
      const float* q = f32p + 6 * s;
      const int y0 = __float_as_int(q[0]) + y, x0 = __float_as_int(q[1]) + x;
      const int ya = clampi(y0, h - 1), yb = clampi(y0 + 1, h - 1);
      const int xa = clampi(x0, w - 1), xb = clampi(x0 + 1, w - 1);
      const float c = static_cast<float>(centre);
      const float d00 = __fsub_rn(static_cast<float>(__ldg(img + static_cast<long long>(ya) * w + xa)), c);
      const float d01 = __fsub_rn(static_cast<float>(__ldg(img + static_cast<long long>(ya) * w + xb)), c);
      const float d10 = __fsub_rn(static_cast<float>(__ldg(img + static_cast<long long>(yb) * w + xa)), c);
      const float d11 = __fsub_rn(static_cast<float>(__ldg(img + static_cast<long long>(yb) * w + xb)), c);
      float acc = __fmaf_rn(q[2], d00, __fmul_rn(q[3], d01));
      acc = __fmaf_rn(q[4], d10, acc);
      acc = __fmaf_rn(q[5], d11, acc);
      bit = acc >= 0.0f;
    }
    bits |= static_cast<unsigned>(bit) << s;
  }
  const unsigned mask = p == 32 ? 0xffffffffu : ((1u << p) - 1u);
  const unsigned rolled = ((bits << 1) | (bits >> (p - 1))) & mask;
  const int transitions = __popc(bits ^ rolled);
  const int code = transitions <= 2 ? __popc(bits) : p + 1;
  dst[frame + static_cast<long long>(y) * w + x] = static_cast<uint8_t>(code);
}

template <typename T>
cudaError_t lbp_launch(const void* src, void* dst, const void* params, int n, int h, int w, int p, int pad,
                       int golden, cudaStream_t stream) {
  const dim3 grid((w + LBP_TX - 1) / LBP_TX, (h + LBP_TY - 1) / LBP_TY, n), block(LBP_TX, LBP_TY);
  if (golden)
    lbp_codes_kernel<true, T><<<grid, block, 0, stream>>>(static_cast<const T*>(src), static_cast<uint8_t*>(dst),
                                                          params, h, w, p, pad);
  else
    lbp_codes_kernel<false, T><<<grid, block, 0, stream>>>(static_cast<const T*>(src), static_cast<uint8_t*>(dst),
                                                           params, h, w, p, pad);
  return cudaGetLastError();
}

}  // namespace

// src: (n, h, w) uint8; out: (n, 256, 256) int32, zero.  The window where
// both pixels of a pair lie in the frame must not be empty.
extern "C" int yam_glcm_counts(const void* src, void* out, int n, int h, int w, int dx, int dy, void* stream) {
  const int r0 = dy < 0 ? -dy : 0, r1 = dy < 0 ? h : h - dy;
  const int c0 = dx < 0 ? -dx : 0, c1 = dx < 0 ? w : w - dx;
  if (n < 1 || n > 65535 || r1 <= r0 || c1 <= c0) return static_cast<int>(cudaErrorInvalidValue);
  const long long total = static_cast<long long>(r1 - r0) * (c1 - c0);
  long long blocks = (total + GLCM_THREADS * 4 - 1) / (GLCM_THREADS * 4);  // 4 pairs a thread
  if (blocks > 4096) blocks = 4096;
  const dim3 grid(static_cast<unsigned>(blocks), n);
  glcm_counts_kernel<<<grid, GLCM_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), static_cast<int*>(out), h, w, dx, dy, r0, c0, r1 - r0, c1 - c0);
  return static_cast<int>(cudaGetLastError());
}

// src: (n, h, w) of kind 0 uint8, 1 uint16 or 2 float32; dst: (n, h, w)
// uint8; params: float32 (p, 6) words (golden 0) or float64 (p, 2) offsets
// (golden 1) on the card; 1 <= p <= 32.
extern "C" int yam_lbp_codes(const void* src, void* dst, const void* params, int n, int h, int w, int p, int pad,
                             int golden, int kind, void* stream) {
  if (n < 1 || n > 65535 || h < 1 || w < 1 || p < 1 || p > MAX_P) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case 0: return static_cast<int>(lbp_launch<uint8_t>(src, dst, params, n, h, w, p, pad, golden, s));
    case 1: return static_cast<int>(lbp_launch<uint16_t>(src, dst, params, n, h, w, p, pad, golden, s));
    case 2: return static_cast<int>(lbp_launch<float>(src, dst, params, n, h, w, p, pad, golden, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
