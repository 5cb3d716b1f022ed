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
// 10201 at 101; numpy's order two instructions a tap), far above the 2
// bytes a pixel.  Design:
//
// - a block of 8 warps stages its 128-column tile and the reflect-101 halo
//   in shared memory once, each pixel converted to float32 once: a warp
//   stages a row, a lane issuing up to 8 loads (the whole row up to ksize
//   129) before it stores them (small kernels spend their time here);
// - a thread owns a strip of 8 output columns of one row at a time.  For
//   each tap row it slides a register window along the staged row (two
//   16-byte loads, then one more for every 4 taps) and issues 8 FMAs a tap,
//   so a shared-memory load feeds 32 FMAs; each output still adds its taps
//   in raster order (j, then i), the order both references take;
// - the main path's ksize 21 has its own instance, fully unrolled in XLA's
//   order, its taps in the constant bank (__constant__, copied on the
//   launch's stream before it), so that each FFMA takes its tap straight
//   from the bank (numpy's order, twice the instructions, loops over the
//   tap rows: its body unrolled over them would not fit the instruction
//   cache).  Every other odd size runs the generic instance, which stages
//   the taps beside the tile in shared memory, each tap row padded to 16
//   bytes, and reads 4 taps by one broadcast 16-byte load.  At run-time
//   indices the constant bank is a load a tap, not a free operand: read
//   from it, ksize 101 took 23% longer and ksize 3 11% less (H100, one
//   call), and its taps would be shared with other streams' launches;
// - a block takes 32 output rows (2 a thread) where two blocks fit an SM,
//   else 16 (1 a thread): a large kernel's grid on a small frame then
//   still covers the SMs, 8 warps each;
// - a phase of 8 lanes of a 16-byte load is 4 strips of 2 rows, and a
//   staged row is an odd number of 16-byte chunks long, so the 8 lanes hit
//   8 different bank groups: no conflicts.
//
// The main instance's taps in the constant bank belong to the module: two
// ksize-21 launches on two streams at once would share them, so the
// wrapper takes one stream (ops/filter2d_cuda.py).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int STRIP = 8;                    // output columns a thread
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int BLOCK_COLS = 16 * STRIP;      // a warp's 16 strips
constexpr int MAIN_K = 21;                  // the main path's ksize: its own unrolled instance
constexpr int MAX_SHARED = 232448;          // bytes of shared memory a block may take
constexpr int STAGE_LOADS = 8;              // loads a lane keeps in flight while staging: a row of 256 columns

__constant__ float c_taps[MAIN_K * MAIN_K];

__device__ __forceinline__ int reflect101(int i, int n) {
  if (i >= 0 && i < n) return i;
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

// One tap t (raster index) on the 8 outputs of a strip, x the window at
// the tap's column.  XLA: tap 0 parks x0 in the accumulator (or, alone,
// is k0 * x0), tap 1 forms fma(k0, x0, k1 * x1), later taps fma(k, x, acc);
// HEAD false: t is known to be 2 or more.
template <bool XLA, bool HEAD>
__device__ __forceinline__ void tap_step(float (&acc)[STRIP], const float* x, float k, float k0, int t, int ntaps) {
#pragma unroll
  for (int c = 0; c < STRIP; ++c) {
    if (!XLA) {
      acc[c] = __fadd_rn(acc[c], __fmul_rn(k, x[c]));
    } else if (HEAD && t == 0) {
      acc[c] = ntaps == 1 ? __fmul_rn(k, x[c]) : x[c];
    } else if (HEAD && t == 1) {
      acc[c] = __fmaf_rn(k0, acc[c], __fmul_rn(k, x[c]));
    } else {
      acc[c] = __fmaf_rn(k, x[c], acc[c]);
    }
  }
}

__device__ __forceinline__ void load4(float* dst, const float* src) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  dst[0] = v.x;
  dst[1] = v.y;
  dst[2] = v.z;
  dst[3] = v.w;
}

// Four taps i..i+3 of row j on the window: the register window's next
// chunk is loaded, the taps applied, the window slid 4 columns.
template <bool XLA, bool HEAD>
__device__ __forceinline__ void four_taps(float (&acc)[STRIP], float (&win)[STRIP + 4], const float* rowp,
                                          const float (&k)[4], int j, int i, int kw, int ntaps, float k0) {
  load4(win + 8, rowp + i + 8);
#pragma unroll
  for (int tt = 0; tt < 4; ++tt) tap_step<XLA, HEAD>(acc, win + tt, k[tt], k0, j * kw + i + tt, ntaps);
#pragma unroll
  for (int c = 0; c < STRIP; ++c) win[c] = win[c + 4];
}

// The taps of row j of the kernel on the 8 outputs of a strip: the register
// window slides along the staged row, 16 bytes at a time.  K > 0: a K-wide
// kernel, unrolled, each tap a constant-bank operand; K == 0: kw at run
// time, the row's taps krow in shared memory (16-byte aligned, zero past kw).
// HEAD: the row holds tap 0 or 1 (XLA's first two taps differ).
template <bool XLA, int K, bool HEAD>
__device__ __forceinline__ void tap_row(float (&acc)[STRIP], const float* rowp, const float* krow, int j, int kw,
                                        int ntaps, float k0) {
  float win[STRIP + 4];
  load4(win, rowp);
  load4(win + 4, rowp + 4);
  int i = 0;
  float k[4];
  if constexpr (K > 0) {
#pragma unroll
    for (; i + 4 <= K; i += 4) {
#pragma unroll
      for (int tt = 0; tt < 4; ++tt) k[tt] = c_taps[j * K + i + tt];
      four_taps<XLA, HEAD>(acc, win, rowp, k, j, i, K, ntaps, k0);
    }
  } else {
#pragma unroll 4
    for (; i + 4 <= kw; i += 4) {
      load4(k, krow + i);
      four_taps<XLA, HEAD>(acc, win, rowp, k, j, i, kw, ntaps, k0);
    }
  }
  const int rest = kw - i;  // 0..3 taps
  if (rest == 0) return;
  if (rest > 1) load4(win + 8, rowp + i + 8);
  if constexpr (K == 0) load4(k, krow + i);
#pragma unroll
  for (int tt = 0; tt < 3; ++tt) {
    if (tt < rest) {
      const int tap = j * kw + i + tt;
      tap_step<XLA, HEAD>(acc, win + tt, K > 0 ? c_taps[tap] : k[tt], k0, tap, ntaps);
    }
  }
}

// K > 0: a K x K kernel, every loop unrolled, the taps constant-bank
// operands.  K == 0: kh x kw at run time, the taps staged after the tile,
// kpitch floats a row.
template <bool XLA, typename T, int K>
__global__ void __launch_bounds__(THREADS)
filter2d_kernel(const T* __restrict__ src, uint8_t* __restrict__ dst, const float* __restrict__ taps, int h, int w,
                int kh_arg, int kw_arg, int rows_a_thread, int pitch) {
  extern __shared__ __align__(16) float tile[];
  const int kh = K ? K : kh_arg, kw = K ? K : kw_arg;
  const int ntaps = kh * kw, kpitch = (kw + 3) & ~3;
  const int block_rows = 2 * WARPS * rows_a_thread;
  const int ry = kh / 2, rx = kw / 2;
  const int tile_rows = block_rows + kh - 1, tile_cols = BLOCK_COLS + kw - 1;
  const int x0 = blockIdx.x * BLOCK_COLS, y0 = blockIdx.y * block_rows;
  const long long frame = static_cast<long long>(blockIdx.z) * h * w;
  const T* in = src + frame;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < tile_rows; r += WARPS) {
    const T* row = in + static_cast<long long>(reflect101(y0 - ry + r, h)) * w;
    float* staged = tile + r * pitch;
    for (int c = lane; c < tile_cols; c += 32 * STAGE_LOADS) {
      float v[STAGE_LOADS];
#pragma unroll
      for (int u = 0; u < STAGE_LOADS; ++u) {
        const int cu = c + 32 * u;
        v[u] = cu < tile_cols ? static_cast<float>(row[reflect101(x0 - rx + cu, w)]) : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < STAGE_LOADS; ++u)
        if (c + 32 * u < tile_cols) staged[c + 32 * u] = v[u];
    }
  }
  float* const s_taps = tile + tile_rows * pitch;  // pitch is a multiple of 4: 16-byte aligned
  if constexpr (K == 0) {
    for (int e = threadIdx.x; e < kh * kpitch; e += THREADS) {
      const int j = e / kpitch, i = e - j * kpitch;
      s_taps[e] = i < kw ? taps[j * kw + i] : 0.0f;
    }
  }
  __syncthreads();

  // lanes 8q..8q+7: strips 4q..4q+3 of two neighbouring rows
  const int q = lane >> 3, part = lane & 7;
  const int group = part >> 2, strip = 4 * q + (part & 3);
  const int col = STRIP * strip;
  const float k0 = K > 0 ? c_taps[0] : s_taps[0];
  uint8_t* out = dst + frame;
  for (int t = 0; t < rows_a_thread; ++t) {
    const int y_local = warp * 2 * rows_a_thread + 2 * t + group;
    const float* base = tile + y_local * pitch + col;
    float acc[STRIP];
#pragma unroll
    for (int c = 0; c < STRIP; ++c) acc[c] = 0.0f;
    if constexpr (K > 0 && XLA) {
      // every tap's index is a constant here: the head checks fold away
#pragma unroll
      for (int j = 0; j < K; ++j) tap_row<XLA, K, true>(acc, base + j * pitch, nullptr, j, kw, ntaps, k0);
    } else if constexpr (K > 0) {
      // numpy's order is twice the instructions: unrolled over the tap rows
      // too, the body would outgrow the instruction cache
#pragma unroll 1
      for (int j = 0; j < K; ++j) tap_row<XLA, K, false>(acc, base + j * pitch, nullptr, j, kw, ntaps, k0);
    } else {
      const int head = kw == 1 ? 2 : 1;  // the rows that hold taps 0 and 1
      for (int j = 0; j < head && j < kh; ++j)
        tap_row<XLA, 0, true>(acc, base + j * pitch, s_taps + j * kpitch, j, kw, ntaps, k0);
      for (int j = head; j < kh; ++j)
        tap_row<XLA, 0, false>(acc, base + j * pitch, s_taps + j * kpitch, j, kw, ntaps, k0);
    }
    const int y = y0 + y_local, x = x0 + col;
    if (y >= h || x >= w) continue;
    uint8_t v[STRIP];
#pragma unroll
    for (int c = 0; c < STRIP; ++c) v[c] = to_u8(acc[c]);
    uint8_t* o = out + static_cast<long long>(y) * w + x;
    if (x + STRIP <= w && (reinterpret_cast<uintptr_t>(o) & 7) == 0) {
      uint2 packed;
      packed.x = v[0] | (v[1] << 8) | (v[2] << 16) | (static_cast<unsigned>(v[3]) << 24);
      packed.y = v[4] | (v[5] << 8) | (v[6] << 16) | (static_cast<unsigned>(v[7]) << 24);
      *reinterpret_cast<uint2*>(o) = packed;
    } else {
      for (int c = 0; c < STRIP && x + c < w; ++c) o[c] = v[c];
    }
  }
}

// The staged row's length in floats: the 128 columns, the halo and the
// window's overreach (up to 9 floats past the last tap), rounded to 16-byte
// chunks and made an odd number of them.
int tile_pitch(int kw) {
  int pitch = (BLOCK_COLS + kw + 9 + 3) / 4 * 4;
  if ((pitch / 4) % 2 == 0) pitch += 4;
  return pitch;
}

// Shared bytes of a block of 2 * WARPS * rows output rows: its staged
// tile and, for the generic instance, the taps (rows padded to 4 floats).
long long block_bytes(int rows, int kh, int kw, bool main) {
  const long long taps = main ? 0 : static_cast<long long>(kh) * ((kw + 3) / 4 * 4);
  return (static_cast<long long>(2 * WARPS * rows + kh - 1) * tile_pitch(kw) + taps) * sizeof(float);
}

// Rows a thread: 2 where two such blocks fit an SM, else 1 where one
// block fits; 0 where none fits (the launch is refused).
int launch_rows(int kh, int kw, bool main, long long* bytes) {
  *bytes = block_bytes(2, kh, kw, main);
  if (*bytes <= MAX_SHARED / 2 - 1024) return 2;
  *bytes = block_bytes(1, kh, kw, main);
  return *bytes <= MAX_SHARED ? 1 : 0;
}

template <bool XLA, typename T, int K>
cudaError_t filter2d_launch(const void* src, void* dst, const void* taps, int n, int h, int w, int kh, int kw,
                            cudaStream_t stream) {
  long long bytes = 0;
  const int rows = launch_rows(kh, kw, K > 0, &bytes);
  if (rows == 0) return cudaErrorInvalidValue;  // the tile of one row a thread does not fit
  const int block_rows = 2 * WARPS * rows;
  const dim3 grid((w + BLOCK_COLS - 1) / BLOCK_COLS, (h + block_rows - 1) / block_rows, n);
  cudaError_t err = cudaFuncSetAttribute(filter2d_kernel<XLA, T, K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  if (K > 0) {
    err = cudaMemcpyToSymbolAsync(c_taps, taps, static_cast<size_t>(K) * K * sizeof(float), 0,
                                  cudaMemcpyDeviceToDevice, stream);
    if (err != cudaSuccess) return err;
  }
  filter2d_kernel<XLA, T, K><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(src), static_cast<uint8_t*>(dst), static_cast<const float*>(taps), h, w, kh, kw, rows,
      tile_pitch(kw));
  return cudaGetLastError();
}

// The instance: ksize 21 unrolled, every other size generic.
template <bool XLA, typename T>
cudaError_t filter2d_size(const void* src, void* dst, const void* taps, int n, int h, int w, int kh, int kw,
                          cudaStream_t stream) {
  if (kh == MAIN_K && kw == MAIN_K) return filter2d_launch<XLA, T, MAIN_K>(src, dst, taps, n, h, w, kh, kw, stream);
  return filter2d_launch<XLA, T, 0>(src, dst, taps, n, h, w, kh, kw, stream);
}

template <typename T>
cudaError_t filter2d_order(const void* src, void* dst, const void* taps, int n, int h, int w, int kh, int kw,
                           int xla_order, cudaStream_t stream) {
  return xla_order ? filter2d_size<true, T>(src, dst, taps, n, h, w, kh, kw, stream)
                   : filter2d_size<false, T>(src, dst, taps, n, h, w, kh, kw, stream);
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
