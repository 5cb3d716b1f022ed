// Integer gradients (Sobel, Prewitt, Laplacian) and Canny's candidates on
// uint8 gray frames, with XLA's int32 arithmetic: every product and sum
// wraps modulo 2^32.
//
// Replaces yamimageprocessor_tpu/ops/edges.py:sobel_j (:89), prewitt_j
// (:125), laplacian_j (:153) and the candidate half of canny_j (:219):
// XLA fusions there, not pallas_calls.  C++ leaves signed overflow
// undefined, so the sums run in uint32_t and are reinterpreted; sums modulo
// 2^32 are exact in any order, so the taps may be regrouped freely.  Every
// gradient is then two separable correlations of one integer tap pair
// (t0, t1): A = sep(ky = t0, kx = t1), B = sep(ky = t1, kx = t0)
// (ops/edges.py:gradient_taps gives the pairs; the Laplacian's dense
// aperture is outer(t0, t1) + outer(t1, t0)).
//
//   gradient_kernel   a block a TILE x TILE tile of one frame.  The input
//                     tile and its reflect-101 ring of R = k / 2 come into
//                     shared memory (any frame size: the index reflects as
//                     numpy's pad does, periodically where R >= n), the
//                     x-passes of both correlations go to shared memory,
//                     then each thread takes the y-passes of its pixels and
//                     combines: Sobel isqrt32(A^2 + B^2), Prewitt the same
//                     with A and B saturated to 0..255 first, Laplacian
//                     |A + B| (|INT32_MIN| wraps, then saturates to 0).
//   canny_kernel      the same with a replicate border, on a tile with a
//                     ring of 1 more: the L1 magnitudes of the tile and the
//                     ring (0 outside the frame, canny_j's magp) stay in
//                     shared memory for the non-maximum suppression, which
//                     compares in fixed point (TG22 = 13573, shift 15) in
//                     wrapping int32 with canny_j's > and >= ties.  It
//                     writes 0 (none), 1 (a candidate, mag > low) or 2 (a
//                     strong one, mag > high); low and high are int32
//                     scalars on the card.
//
// isqrt32 is _isqrt_j step by step: the float32 root of the int32 sum
// rounded to nearest (NaN where the sum wrapped negative, which XLA's
// conversion sends to 0), truncated, then the +1 and -1 corrections, whose
// squares wrap in int32 near 46341^2.
//
// Bound on the card: device memory or the integer pipe.  A pixel reads 1 B
// and writes 1 B; the gradient takes 4k multiply-adds a pixel (two x-passes
// and two y-passes of k taps), Canny 4k plus the suppression.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int TILE = 32;
constexpr int THREADS = 256;
constexpr int MAX_TAPS = 31;
constexpr int MAX_FRAMES = 65535;  // gridDim.y
constexpr int TG22 = 13573;
constexpr int SHIFT = 15;

struct Taps {
  int t0[MAX_TAPS];
  int t1[MAX_TAPS];
};

// numpy's pad(mode="reflect") source index of position i (reflect-101),
// periodic where the ring is wider than the axis
__device__ __forceinline__ int reflect101(int i, int n) {
  if (n == 1) return 0;
  const int period = 2 * (n - 1);
  i %= period;
  if (i < 0) i += period;
  return i < n ? i : period - i;
}

__device__ __forceinline__ int clamp_index(int i, int n) { return i < 0 ? 0 : (i >= n ? n - 1 : i); }

__device__ __forceinline__ int isqrt32(int s) {
  const float root = __fsqrt_rn(__int2float_rn(s));
  int c;
  if (root != root) {
    c = 0;  // NaN: XLA converts it to 0
  } else if (root >= 2147483648.0f) {
    c = INT_MAX;
  } else {
    c = __float2int_rz(root);
  }
  const unsigned up = static_cast<unsigned>(c) + 1u;
  if (static_cast<int>(up * up) <= s) c = static_cast<int>(up);
  if (static_cast<int>(static_cast<unsigned>(c) * static_cast<unsigned>(c)) > s) c -= 1;
  return c;
}

__device__ __forceinline__ int magnitude(int a, int b) {
  const unsigned s = static_cast<unsigned>(a) * static_cast<unsigned>(a) +
                     static_cast<unsigned>(b) * static_cast<unsigned>(b);
  const int mag = isqrt32(static_cast<int>(s));
  return mag < 0 ? 0 : (mag > 255 ? 255 : mag);
}

// Stage the (oh + 2r) x (ow + 2r) input window whose top-left output lies at
// (y0, x0) into s_in, then both x-passes of its rows into s_xa (taps t1) and
// s_xb (taps t0), (oh + 2r) x ow each.
template <bool REPLICATE>
__device__ void x_passes(const uint8_t* __restrict__ frame, int h, int w, int y0, int x0, int oh, int ow,
                         int k, const Taps& taps, uint8_t* s_in, unsigned* s_xa, unsigned* s_xb) {
  const int r = k / 2;
  const int ih = oh + 2 * r, iw = ow + 2 * r;
  for (int i = threadIdx.x; i < ih * iw; i += THREADS) {
    const int row = i / iw, col = i - row * iw;
    const int y = REPLICATE ? clamp_index(y0 - r + row, h) : reflect101(y0 - r + row, h);
    const int x = REPLICATE ? clamp_index(x0 - r + col, w) : reflect101(x0 - r + col, w);
    s_in[i] = __ldg(frame + static_cast<long long>(y) * w + x);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < ih * ow; i += THREADS) {
    const int row = i / ow, col = i - row * ow;
    const uint8_t* src = s_in + row * iw + col;
    unsigned a = 0, b = 0;
    for (int t = 0; t < k; ++t) {
      const unsigned v = src[t];
      a += static_cast<unsigned>(taps.t1[t]) * v;
      b += static_cast<unsigned>(taps.t0[t]) * v;
    }
    s_xa[i] = a;
    s_xb[i] = b;
  }
  __syncthreads();
}

// the y-passes at (row, col) of an ow-wide x-pass pair: (A, B)
__device__ __forceinline__ void y_passes(const unsigned* s_xa, const unsigned* s_xb, int ow, int row, int col,
                                         int k, const Taps& taps, int& a, int& b) {
  unsigned sa = 0, sb = 0;
  for (int t = 0; t < k; ++t) {
    sa += static_cast<unsigned>(taps.t0[t]) * s_xa[(row + t) * ow + col];
    sb += static_cast<unsigned>(taps.t1[t]) * s_xb[(row + t) * ow + col];
  }
  a = static_cast<int>(sa);
  b = static_cast<int>(sb);
}

__host__ __device__ constexpr size_t gradient_shared(int k) {
  return static_cast<size_t>((TILE + k - 1) * (TILE + k - 1)) +
         2 * sizeof(unsigned) * static_cast<size_t>((TILE + k - 1) * TILE) + 16;
}

// grid (tiles, frames); kind 0 Sobel, 1 Prewitt, 2 Laplacian
__global__ void __launch_bounds__(THREADS)
    gradient_kernel(const uint8_t* __restrict__ in_all, uint8_t* __restrict__ out_all, int h, int w,
                    int tiles_x, int k, int kind, Taps taps) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ih = TILE + k - 1;
  unsigned* s_xa = reinterpret_cast<unsigned*>(smem);
  unsigned* s_xb = s_xa + ih * TILE;
  uint8_t* s_in = reinterpret_cast<uint8_t*>(s_xb + ih * TILE);
  const long long hw = static_cast<long long>(h) * w;
  const uint8_t* frame = in_all + blockIdx.y * hw;
  uint8_t* out = out_all + blockIdx.y * hw;
  const int y0 = blockIdx.x / tiles_x * TILE;
  const int x0 = blockIdx.x % tiles_x * TILE;
  x_passes<false>(frame, h, w, y0, x0, TILE, TILE, k, taps, s_in, s_xa, s_xb);
  for (int i = threadIdx.x; i < TILE * TILE; i += THREADS) {
    const int row = i / TILE, col = i - row * TILE;
    if (y0 + row >= h || x0 + col >= w) continue;
    int a, b;
    y_passes(s_xa, s_xb, TILE, row, col, k, taps, a, b);
    int v;
    if (kind == 2) {
      const int sum = static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
      const int mag = sum == INT_MIN ? INT_MIN : (sum < 0 ? -sum : sum);
      v = mag < 0 ? 0 : (mag > 255 ? 255 : mag);
    } else {
      if (kind == 1) {
        a = a < 0 ? 0 : (a > 255 ? 255 : a);
        b = b < 0 ? 0 : (b > 255 ? 255 : b);
      }
      v = magnitude(a, b);
    }
    out[static_cast<long long>(y0 + row) * w + x0 + col] = static_cast<uint8_t>(v);
  }
}

constexpr int RING = TILE + 2;  // the tile and its ring of 1

__host__ __device__ constexpr size_t canny_shared(int k) {
  return 3 * sizeof(int) * RING * RING + 2 * sizeof(unsigned) * static_cast<size_t>((RING + k - 1) * RING) +
         static_cast<size_t>((RING + k - 1) * (RING + k - 1)) + 16;
}

__device__ __forceinline__ unsigned uabs(int v) { return v < 0 ? 0u - static_cast<unsigned>(v) : v; }

// grid (tiles, frames); t0 the smooth taps, t1 the derivative's
__global__ void __launch_bounds__(THREADS)
    canny_kernel(const uint8_t* __restrict__ in_all, uint8_t* __restrict__ plane_all, const int* low_p,
                 const int* high_p, int h, int w, int tiles_x, int k, Taps taps) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* s_gx = reinterpret_cast<int*>(smem);
  int* s_gy = s_gx + RING * RING;
  int* s_mag = s_gy + RING * RING;
  const int ih = RING + k - 1;
  unsigned* s_xa = reinterpret_cast<unsigned*>(s_mag + RING * RING);
  unsigned* s_xb = s_xa + ih * RING;
  uint8_t* s_in = reinterpret_cast<uint8_t*>(s_xb + ih * RING);
  const long long hw = static_cast<long long>(h) * w;
  const uint8_t* frame = in_all + blockIdx.y * hw;
  uint8_t* plane = plane_all + blockIdx.y * hw;
  const int y0 = blockIdx.x / tiles_x * TILE;
  const int x0 = blockIdx.x % tiles_x * TILE;
  const int low = __ldg(low_p), high = __ldg(high_p);

  x_passes<true>(frame, h, w, y0 - 1, x0 - 1, RING, RING, k, taps, s_in, s_xa, s_xb);
  for (int i = threadIdx.x; i < RING * RING; i += THREADS) {
    const int row = i / RING, col = i - row * RING;
    const int y = y0 - 1 + row, x = x0 - 1 + col;
    int gx, gy;
    y_passes(s_xa, s_xb, RING, row, col, k, taps, gx, gy);
    s_gx[i] = gx;
    s_gy[i] = gy;
    const bool inside = y >= 0 && y < h && x >= 0 && x < w;
    s_mag[i] = inside ? static_cast<int>(uabs(gx) + uabs(gy)) : 0;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < TILE * TILE; i += THREADS) {
    const int row = i / TILE, col = i - row * TILE;
    if (y0 + row >= h || x0 + col >= w) continue;
    const int c = (row + 1) * RING + col + 1;
    const int m = s_mag[c], gx = s_gx[c], gy = s_gy[c];
    const unsigned x = uabs(gx);
    const int y = static_cast<int>(uabs(gy) << SHIFT);
    const unsigned tg22 = x * static_cast<unsigned>(TG22);
    const int tg22x = static_cast<int>(tg22);
    const int tg67x = static_cast<int>(tg22 + ((x + x) << SHIFT));
    const bool horiz = y < tg22x && m > s_mag[c - 1] && m >= s_mag[c + 1];
    const bool vert = y > tg67x && m > s_mag[c - RING] && m >= s_mag[c + RING];
    const bool s_neg = (gx ^ gy) < 0;
    const bool diag_pos = !s_neg && m > s_mag[c - RING - 1] && m > s_mag[c + RING + 1];
    const bool diag_neg = s_neg && m > s_mag[c - RING + 1] && m > s_mag[c + RING - 1];
    const bool diag = y >= tg22x && y <= tg67x && (diag_pos || diag_neg);
    const bool nms = m > low && (horiz || vert || diag);
    plane[static_cast<long long>(y0 + row) * w + x0 + col] = nms ? (m > high ? 2 : 1) : 0;
  }
}

Taps taps_from(const int* t0, const int* t1, int k) {
  Taps taps{};
  for (int i = 0; i < k; ++i) {
    taps.t0[i] = t0[i];
    taps.t1[i] = t1[i];
  }
  return taps;
}

}  // namespace

// in, out: (n, h, w) uint8 on the card; t0, t1: k host ints (k odd, at most
// 31); kind 0 Sobel, 1 Prewitt, 2 Laplacian.  More than 65535 frames go in
// slices.
extern "C" int yam_gradient_u8(const void* in, void* out, const int* t0, const int* t1, int k, int kind, int n,
                               int h, int w, void* stream) {
  if (k < 1 || k > MAX_TAPS || k % 2 == 0 || kind < 0 || kind > 2 || h <= 0 || w <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Taps taps = taps_from(t0, t1, k);
  const int tiles_x = (w + TILE - 1) / TILE;
  const int tiles = (h + TILE - 1) / TILE * tiles_x;
  const size_t shared = gradient_shared(k);
  const long long hw = static_cast<long long>(h) * w;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int first = 0; first < n; first += MAX_FRAMES) {
    const int frames = n - first < MAX_FRAMES ? n - first : MAX_FRAMES;
    gradient_kernel<<<dim3(tiles, frames), THREADS, shared, s>>>(
        static_cast<const uint8_t*>(in) + first * hw, static_cast<uint8_t*>(out) + first * hw, h, w, tiles_x, k,
        kind, taps);
  }
  return static_cast<int>(cudaGetLastError());
}

// in, plane: (n, h, w) uint8 on the card; low, high: one int32 each on the
// card; t0, t1: the aperture's smooth and derivative taps (host ints).
extern "C" int yam_canny_candidates_u8(const void* in, void* plane, const void* low, const void* high,
                                       const int* t0, const int* t1, int k, int n, int h, int w, void* stream) {
  if (k < 3 || k > 7 || k % 2 == 0 || h <= 0 || w <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Taps taps = taps_from(t0, t1, k);
  const int tiles_x = (w + TILE - 1) / TILE;
  const int tiles = (h + TILE - 1) / TILE * tiles_x;
  const size_t shared = canny_shared(k);
  const long long hw = static_cast<long long>(h) * w;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int first = 0; first < n; first += MAX_FRAMES) {
    const int frames = n - first < MAX_FRAMES ? n - first : MAX_FRAMES;
    canny_kernel<<<dim3(tiles, frames), THREADS, shared, s>>>(
        static_cast<const uint8_t*>(in) + first * hw, static_cast<uint8_t*>(plane) + first * hw,
        static_cast<const int*>(low), static_cast<const int*>(high), h, w, tiles_x, k, taps);
  }
  return static_cast<int>(cudaGetLastError());
}
