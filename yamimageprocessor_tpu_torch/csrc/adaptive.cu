// Adaptive threshold (cv2's ADAPTIVE_THRESH_GAUSSIAN_C with THRESH_BINARY)
// on uint8 gray frames: a replicate-border separable Gaussian of up to 255
// float32 taps in XLA's contracted order, rounded half to even and
// saturated to uint8, then gray > mean - C_ceil in int32 -> 255, else 0,
// in one launch.
//
// Replaces yamimageprocessor_tpu/ops/threshold.py:adaptive_threshold_j
// (:99), an XLA fusion of filters.py:sep_filter_j (not a pallas_call).
// XLA's CPU backend contracts each pass into fused multiply-adds:
// acc = fma(t0, x0, t1 * x1), then acc = fma(t_k, x_k, acc) for k >= 2 (the
// JAX package's compiled chain keeps that order at every block size the
// schema allows, 3 to 255, including frames narrower than the block;
// tests/test_torch_edges.py holds the plain version against it).  The
// kernel writes those operations with __fmul_rn and __fmaf_rn, which nvcc
// neither contracts nor reorders.  sepconv.cu's ring of 33 taps does not
// reach 255, hence a kernel of its own.
//
// A block a TILE_ROWS x TILE_COLS tile of one frame.  The input rows of the
// tile and its ring of R = k / 2 come into shared memory CHUNK rows at a
// time (replicate border: clamped indices), each chunk's x-pass into a
// (TILE_ROWS + 2R) x TILE_COLS float32 buffer in shared memory (81 KiB at
// 255 taps), then every thread takes the y-pass of its pixels, the
// rounding and the compare.  The taps and C_ceil are read on the card.
//
// Bound on the card: a pixel reads 1 B and writes 1 B and takes 2k fused
// multiply-adds (FP32).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int TILE_ROWS = 64;
constexpr int TILE_COLS = 64;
constexpr int CHUNK = 16;
constexpr int THREADS = 256;
constexpr int MAX_TAPS = 255;
constexpr int MAX_FRAMES = 65535;  // gridDim.y

__device__ __forceinline__ int clamp_index(int i, int n) { return i < 0 ? 0 : (i >= n ? n - 1 : i); }

// sum(taps[t] * x[t * stride]) in XLA's contracted order
__device__ __forceinline__ float fma_chain(const float* taps, const float* x, int stride, int k) {
  if (k == 1) return __fmul_rn(taps[0], x[0]);
  float acc = __fmaf_rn(taps[0], x[0], __fmul_rn(taps[1], x[stride]));
  for (int t = 2; t < k; ++t) acc = __fmaf_rn(taps[t], x[t * stride], acc);
  return acc;
}

size_t shared_bytes(int k) {
  const int r = k / 2;
  return sizeof(float) * (MAX_TAPS + 1) + sizeof(float) * static_cast<size_t>(TILE_ROWS + 2 * r) * TILE_COLS +
         sizeof(float) * static_cast<size_t>(CHUNK) * (TILE_COLS + 2 * r);
}

// grid (tiles, frames)
__global__ void __launch_bounds__(THREADS)
    adaptive_kernel(const uint8_t* __restrict__ in_all, uint8_t* __restrict__ out_all,
                    const float* __restrict__ taps_g, const int* __restrict__ c_ceil_p, int k, int h, int w,
                    int tiles_x) {
  extern __shared__ __align__(16) float smem_f[];
  const int r = k / 2;
  const int ih = TILE_ROWS + 2 * r, iw = TILE_COLS + 2 * r;
  float* s_taps = smem_f;
  float* s_x = s_taps + MAX_TAPS + 1;  // ih x TILE_COLS: the x-pass
  float* s_in = s_x + ih * TILE_COLS;  // CHUNK x iw: input rows as float32
  const long long hw = static_cast<long long>(h) * w;
  const uint8_t* frame = in_all + blockIdx.y * hw;
  uint8_t* out = out_all + blockIdx.y * hw;
  const int y0 = blockIdx.x / tiles_x * TILE_ROWS;
  const int x0 = blockIdx.x % tiles_x * TILE_COLS;
  for (int t = threadIdx.x; t < k; t += THREADS) s_taps[t] = __ldg(taps_g + t);

  for (int first = 0; first < ih; first += CHUNK) {
    const int rows = min(CHUNK, ih - first);
    __syncthreads();  // the taps are in; the last chunk's x-pass is done with s_in
    for (int i = threadIdx.x; i < rows * iw; i += THREADS) {
      const int row = i / iw, col = i - row * iw;
      const int y = clamp_index(y0 - r + first + row, h);
      const int x = clamp_index(x0 - r + col, w);
      s_in[i] = static_cast<float>(__ldg(frame + static_cast<long long>(y) * w + x));
    }
    __syncthreads();
    for (int i = threadIdx.x; i < rows * TILE_COLS; i += THREADS) {
      const int row = i / TILE_COLS, col = i - row * TILE_COLS;
      s_x[(first + row) * TILE_COLS + col] = fma_chain(s_taps, s_in + row * iw + col, 1, k);
    }
  }
  __syncthreads();

  const int c_ceil = __ldg(c_ceil_p);
  for (int i = threadIdx.x; i < TILE_ROWS * TILE_COLS; i += THREADS) {
    const int row = i / TILE_COLS, col = i - row * TILE_COLS;
    if (y0 + row >= h || x0 + col >= w) continue;
    const float mean = rintf(fma_chain(s_taps, s_x + row * TILE_COLS + col, TILE_COLS, k));
    const int m = mean <= 0.0f ? 0 : (mean >= 255.0f ? 255 : static_cast<int>(mean));
    const int below = static_cast<int>(static_cast<unsigned>(m) - static_cast<unsigned>(c_ceil));
    const long long p = static_cast<long long>(y0 + row) * w + x0 + col;
    out[p] = static_cast<int>(frame[p]) > below ? 255 : 0;
  }
}

}  // namespace

// in, out: (n, h, w) uint8 on the card; taps: k float32 on the card (k odd,
// at most 255); c_ceil: one int32 on the card.  More than 65535 frames go in
// slices.
extern "C" int yam_adaptive_threshold_u8(const void* in, void* out, const void* taps, const void* c_ceil, int k,
                                         int n, int h, int w, void* stream) {
  if (k < 1 || k > MAX_TAPS || k % 2 == 0 || h <= 0 || w <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t shared = shared_bytes(k);
  cudaError_t err = cudaFuncSetAttribute(adaptive_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(shared_bytes(MAX_TAPS)));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_x = (w + TILE_COLS - 1) / TILE_COLS;
  const int tiles = (h + TILE_ROWS - 1) / TILE_ROWS * tiles_x;
  const long long hw = static_cast<long long>(h) * w;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int first = 0; first < n; first += MAX_FRAMES) {
    const int frames = n - first < MAX_FRAMES ? n - first : MAX_FRAMES;
    adaptive_kernel<<<dim3(tiles, frames), THREADS, shared, s>>>(
        static_cast<const uint8_t*>(in) + first * hw, static_cast<uint8_t*>(out) + first * hw,
        static_cast<const float*>(taps), static_cast<const int*>(c_ceil), k, h, w, tiles_x);
  }
  return static_cast<int>(cudaGetLastError());
}
