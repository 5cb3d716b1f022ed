// Dense 2-D correlation of uint8, uint16 or float32 frames (the element type
// a template parameter, converted to float32 once a pixel) with a float32
// kernel, reflect-101 borders, rounded half to even and saturated to uint8.
//
// Replaces no pallas_call: yamimageprocessor_tpu/ops/filters.py filter2d_j
// (XLA code, line 179), used by the Gabor response (texture.py:211), and
// its numpy twin filter2d_np (line 55) on the Gabor data path.  Two orders,
// a template flag:
//
// - XLA (the chain): the CPU backend contracts each product into the sum,
//   fma(k0, x0, k1 * x1), then fma(k_t, x_t, acc) over the taps in raster
//   order;
// - numpy (gabor_data): acc + round(k_t * x_t) from zero, nothing fused.
//
// Bound on the card: operations, one FMA a tap a pixel (441 at ksize 21,
// 10201 at 101), far above the 2 bytes a pixel.  Design (simple first): a
// block of 32 x 8 threads computes a 32 x 32 tile, four rows a thread, so
// each tap's read of the kernel is shared by four outputs; the tile and its
// halo sit in shared memory as float32 (the conversion from uint8 is done
// once a pixel, not once a tap), at most (32 + 100)^2 * 4 = 69696 bytes at
// ksize 101; the taps are read from device memory, every thread the same
// word at a time (a broadcast from L1).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int TILE = 32;        // output columns and rows a block
constexpr int ROWS_PER = 4;     // output rows a thread
constexpr int THREADS_Y = TILE / ROWS_PER;

__device__ __forceinline__ int reflect101(int i, int n) {
  if (n == 1) return 0;
  const int period = 2 * (n - 1);
  i %= period;
  if (i < 0) i += period;
  return i < n ? i : period - i;
}

__device__ __forceinline__ uint8_t to_u8(float v) {
  // rint (half to even), then clamp: a cast before the clamp would wrap
  const float r = rintf(v);
  return static_cast<uint8_t>(fminf(fmaxf(r, 0.0f), 255.0f));
}

template <bool XLA, typename T>
__global__ void __launch_bounds__(TILE * THREADS_Y)
filter2d_kernel(const T* __restrict__ src, uint8_t* __restrict__ dst, const float* __restrict__ taps,
                int h, int w, int kh, int kw) {
  extern __shared__ float tile[];
  const int ry = kh / 2, rx = kw / 2;
  const int tw = TILE + 2 * rx, th = TILE + 2 * ry;
  const int x0 = blockIdx.x * TILE, y0 = blockIdx.y * TILE;
  const long long frame = static_cast<long long>(blockIdx.z) * h * w;
  const T* in = src + frame;
  const int tid = threadIdx.y * TILE + threadIdx.x;
  for (int k = tid; k < tw * th; k += TILE * THREADS_Y) {
    const int r = k / tw, c = k - r * tw;
    const int sy = reflect101(y0 - ry + r, h), sx = reflect101(x0 - rx + c, w);
    tile[k] = static_cast<float>(in[static_cast<long long>(sy) * w + sx]);
  }
  __syncthreads();
  const int tx = threadIdx.x;
  float acc[ROWS_PER];
  const int ntaps = kh * kw;
  if (XLA) {
    // fma(k0, x0, k1 * x1), then fma(k_t, x_t, acc)
    const float k0 = taps[0];
    if (ntaps == 1) {
#pragma unroll
      for (int q = 0; q < ROWS_PER; ++q) acc[q] = __fmul_rn(k0, tile[(threadIdx.y + q * THREADS_Y) * tw + tx]);
    } else {
      const float k1 = taps[1];
      const int j1 = 1 / kw, i1 = 1 - j1 * kw;
#pragma unroll
      for (int q = 0; q < ROWS_PER; ++q) {
        const int row = threadIdx.y + q * THREADS_Y;
        const float p1 = __fmul_rn(k1, tile[(row + j1) * tw + tx + i1]);
        acc[q] = __fmaf_rn(k0, tile[row * tw + tx], p1);
      }
      for (int j = 0; j < kh; ++j) {
        for (int i = (j == 0 ? 2 : (j == 1 && kw == 1 ? 1 : 0)); i < kw; ++i) {
          const float k = taps[j * kw + i];
#pragma unroll
          for (int q = 0; q < ROWS_PER; ++q)
            acc[q] = __fmaf_rn(k, tile[(threadIdx.y + q * THREADS_Y + j) * tw + tx + i], acc[q]);
        }
      }
    }
  } else {
#pragma unroll
    for (int q = 0; q < ROWS_PER; ++q) acc[q] = 0.0f;
    for (int j = 0; j < kh; ++j) {
      for (int i = 0; i < kw; ++i) {
        const float k = taps[j * kw + i];
#pragma unroll
        for (int q = 0; q < ROWS_PER; ++q)
          acc[q] = __fadd_rn(acc[q], __fmul_rn(k, tile[(threadIdx.y + q * THREADS_Y + j) * tw + tx + i]));
      }
    }
  }
  uint8_t* out = dst + frame;
#pragma unroll
  for (int q = 0; q < ROWS_PER; ++q) {
    const int y = y0 + threadIdx.y + q * THREADS_Y, x = x0 + tx;
    if (y < h && x < w) out[static_cast<long long>(y) * w + x] = to_u8(acc[q]);
  }
}

template <bool XLA, typename T>
cudaError_t filter2d_launch(const void* src, void* dst, const void* taps, int n, int h, int w, int kh, int kw,
                            cudaStream_t stream) {
  const int bytes = (TILE + 2 * (kh / 2)) * (TILE + 2 * (kw / 2)) * static_cast<int>(sizeof(float));
  const dim3 grid((w + TILE - 1) / TILE, (h + TILE - 1) / TILE, n), block(TILE, THREADS_Y);
  const cudaError_t err =
      cudaFuncSetAttribute(filter2d_kernel<XLA, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  filter2d_kernel<XLA, T><<<grid, block, bytes, stream>>>(static_cast<const T*>(src), static_cast<uint8_t*>(dst),
                                                          static_cast<const float*>(taps), h, w, kh, kw);
  return cudaGetLastError();
}

template <typename T>
cudaError_t filter2d_order(const void* src, void* dst, const void* taps, int n, int h, int w, int kh, int kw,
                           int xla_order, cudaStream_t stream) {
  return xla_order ? filter2d_launch<true, T>(src, dst, taps, n, h, w, kh, kw, stream)
                   : filter2d_launch<false, T>(src, dst, taps, n, h, w, kh, kw, stream);
}

}  // namespace

// src: (n, h, w) of kind 0 uint8, 1 uint16 or 2 float32, contiguous; dst:
// (n, h, w) uint8; taps: (kh, kw) float32 on the card.  xla_order: 1 for
// XLA's contracted order, 0 for numpy's.  n is at most 65535 (gridDim.z):
// the wrapper slices larger batches.
extern "C" int yam_filter2d_u8(const void* src, void* dst, const void* taps, int n, int h, int w, int kh, int kw,
                               int xla_order, int kind, void* stream) {
  if (n < 1 || n > 65535 || h < 1 || w < 1 || kh < 1 || kw < 1 || (kh % 2) == 0 || (kw % 2) == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case 0: return static_cast<int>(filter2d_order<uint8_t>(src, dst, taps, n, h, w, kh, kw, xla_order, s));
    case 1: return static_cast<int>(filter2d_order<uint16_t>(src, dst, taps, n, h, w, kh, kw, xla_order, s));
    case 2: return static_cast<int>(filter2d_order<float>(src, dst, taps, n, h, w, kh, kw, xla_order, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
