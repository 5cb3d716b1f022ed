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
// kernels write those operations with __fmul_rn and __fmaf_rn, which nvcc
// neither contracts nor reorders.
//
// Block sizes 3 to 33 (the default 11 among them) take adaptive_window<K,
// S, B>, an instance a size.  A persistent grid of warps walks units of
// `band` rows x 32 * S columns; a lane takes a strip of S columns (8 up to 7
// taps, 4 up to 15, 2 up to 33) and walks down the unit in blocks of B
// output rows (4; 2 past 15).  A block's B new input rows are made ready at
// once in the warp's ring of staged rows (rows.cuh: cp.async, AHEAD rows in
// flight, and deep enough that the gray rows R behind are still there), so
// the block's rows' arithmetic overlaps.  Each input row's window of S + K -
// 1 bytes is read from the ring as 4-byte words (a funnel shift puts them in
// place where S = 2), its bytes become floats exactly (0x4B000000 | b is
// 2^23 + b), and its x-pass goes into registers: the block's B + K - 1
// rows, the last K - 1 carried to the next block.  Each output row takes the
// y-pass, the rounding (clamp, then add 1.5 * 2^23: rint), the int32
// compare with the row's gray bytes (from the ring) and one S-byte store.
// The taps sit in registers, read once from the card with C_ceil, so no
// multiply-add reads shared memory.  Border: replicate.  An edge unit clamps
// the row index and repeats the frame's first or last byte in a word past
// its side (frames narrower than the block too); a unit whose words and ring
// of R rows lie inside the frame takes a path with no clamps.  Frames whose
// rows are not 16-byte aligned (a width not a multiple of 16, an unaligned
// base) are read byte by byte, each column clamped, without the ring.
//
// Larger sizes (35 to the schema's 255; sepconv.cu's ring also stops at 33)
// take adaptive_kernel: a block a TILE_ROWS x TILE_COLS tile of one frame.
// The input rows of the tile and its ring of R = k / 2 come into shared
// memory CHUNK rows at a time (clamped indices), each chunk's x-pass into a
// (TILE_ROWS + 2R) x TILE_COLS float32 buffer in shared memory (81 KiB at
// 255 taps), then every thread takes the y-pass of its pixels, the rounding
// and the compare, the taps read from shared memory.
//
// Bound on the card: a pixel reads 1 B and writes 1 B and takes 2k fused
// multiply-adds (FP32).  The window adds (S + K - 1) / S byte conversions
// (two instructions each), ~6 instructions of rounding and compare and
// (K - 1) / B register moves a pixel, and K - 1 rows' x-passes a unit.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "rows.cuh"

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

// ---------------------------------------------------------------------------
// adaptive_window: compile-time block sizes, a register window a lane

constexpr int WIN_WARPS = 4;
constexpr int WIN_THREADS = 32 * WIN_WARPS;
constexpr int MIN_BAND = 16;  // rows of a unit at least
constexpr int AHEAD = 4;      // rows a warp has in flight beyond the block it computes
// blocks an SM holds at least: caps the registers (at most 102), which the
// compiler would otherwise spend on overlapping a block's rows
constexpr int MIN_WINDOW_BLOCKS = 5;


// byte k of word as a float, exactly: 0x4B0000bb is 2^23 + b
__device__ __forceinline__ float byte_to_float(unsigned word, int k) {
  return __fsub_rn(__int_as_float(static_cast<int>(__byte_perm(word, 0x4B000000u, 0x7650u | k))), 8388608.0f);
}

// A lane's window of a row for K taps and a strip of S columns at x: the
// 4-byte words from word x / 4 - PAD on, shifted so that window byte j
// (column x - R + j) is byte FIRST + j.  A warp's staged row spans the
// columns [x0 - LEFT, x0 - LEFT + SPAN) of its unit at x0.
template <int K, int S>
struct Span {
  static constexpr int R = K / 2;
  static constexpr int PAD = (R + 3) / 4;                 // words left of the strip's first word
  static constexpr bool SHIFTED = S % 4 != 0;             // the strip may start inside a word
  static constexpr int FIRST = 4 * PAD - R;
  static constexpr int WORDS = (FIRST + S + K - 1 + 3) / 4;
  static constexpr int LOADED = WORDS + (SHIFTED ? 1 : 0);
  static constexpr int LEFT = (4 * PAD + 15) / 16 * 16;
  static constexpr int SPAN = (LEFT + 31 * S + 4 * (LOADED - PAD) + 15) / 16 * 16;
};

// Row i of a lane's window, replicate border, from the warp's staged row
// (16-byte aligned rows).  INTERIOR: every word lies inside the frame.
// Otherwise a word left of the frame repeats its first byte and one right of
// it its last.
template <int K, int S, bool INTERIOR, class Rows>
__device__ __forceinline__ void staged_window(const Rows& rows, int i, int w, int x,
                                              unsigned (&words)[Span<K, S>::WORDS]) {
  using G = Span<K, S>;
  const int first = (x >> 2) - G::PAD;
  const int last = w / 4 - 1;
  unsigned raw[G::LOADED];
#pragma unroll
  for (int q = 0; q < G::LOADED; ++q) {
    const int at = first + q;
    if (INTERIOR) {
      raw[q] = rows.word(i, 4 * at);
    } else {
      const unsigned v = rows.word(i, 4 * (at < 0 ? 0 : (at > last ? last : at)));
      raw[q] = at < 0 ? __byte_perm(v, 0, 0x0000) : (at > last ? __byte_perm(v, 0, 0x3333) : v);
    }
  }
#pragma unroll
  for (int q = 0; q < G::WORDS; ++q)
    words[q] = G::SHIFTED ? __funnelshift_r(raw[q], raw[q + 1], 8 * (x & 3)) : raw[q];
}

// Row y (clamped by the caller) of a lane's window on rows that are not
// 16-byte aligned: byte by byte, each column clamped.
template <int K, int S>
__device__ __forceinline__ void byte_window(const uint8_t* __restrict__ frame, int w, int y, int x,
                                            unsigned (&words)[Span<K, S>::WORDS]) {
  using G = Span<K, S>;
  const uint8_t* p = frame + static_cast<long long>(y) * w;
  const int first = (x >> 2) - G::PAD;
  unsigned raw[G::LOADED];
#pragma unroll
  for (int q = 0; q < G::LOADED; ++q) {
    raw[q] = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) raw[q] |= static_cast<unsigned>(__ldg(p + clamp_index(4 * (first + q) + b, w))) << (8 * b);
  }
#pragma unroll
  for (int q = 0; q < G::WORDS; ++q)
    words[q] = G::SHIFTED ? __funnelshift_r(raw[q], raw[q + 1], 8 * (x & 3)) : raw[q];
}

// the x-pass of a window row in XLA's contracted order
template <int K, int S>
__device__ __forceinline__ void window_x_pass(const unsigned (&words)[Span<K, S>::WORDS], const float (&tk)[K],
                                              float (&xo)[S]) {
  constexpr int FIRST = Span<K, S>::FIRST;
  float v[S + K - 1];
#pragma unroll
  for (int j = 0; j < S + K - 1; ++j) v[j] = byte_to_float(words[(FIRST + j) / 4], (FIRST + j) % 4);
#pragma unroll
  for (int c = 0; c < S; ++c) {
    float acc = __fmaf_rn(tk[0], v[c], __fmul_rn(tk[1], v[c + 1]));
#pragma unroll
    for (int t = 2; t < K; ++t) acc = __fmaf_rn(tk[t], v[c + t], acc);
    xo[c] = acc;
  }
}

// Output row `at` (its first byte) of a strip from its y-pass results and
// its gray bytes: the rounding, the saturation, the int32 compare and one
// S-byte store.
template <int S, bool INTERIOR>
__device__ __forceinline__ void finish_row(uint8_t* __restrict__ out, int w, long long at, int x, bool vec,
                                           const float (&mean)[S], const unsigned (&gray)[(S + 3) / 4], unsigned bias) {
  unsigned o[(S + 3) / 4] = {};
#pragma unroll
  for (int c = 0; c < S; ++c) {
    // rint, then saturation: 1.5 * 2^23 + clamp(mean, 0, 255) is 0x4B400000
    // + the rounded mean, so `bias` (0x4B400000 + C_ceil) leaves mean - C_ceil
    const unsigned rounded = __float_as_uint(__fadd_rn(fminf(fmaxf(mean[c], 0.0f), 255.0f), 12582912.0f));
    const int below = static_cast<int>(rounded - bias);
    const int g = static_cast<int>(__byte_perm(gray[c / 4], 0, 0x4440 | (c % 4)));
    o[c / 4] |= (g > below ? 0xFFu : 0u) << (8 * (c % 4));
  }
  uint8_t* dst = out + at;
  if (INTERIOR || vec) {
    if constexpr (S == 8)
      *reinterpret_cast<uint2*>(dst) = make_uint2(o[0], o[1]);
    else if constexpr (S == 4)
      *reinterpret_cast<unsigned*>(dst) = o[0];
    else
      *reinterpret_cast<unsigned short*>(dst) = static_cast<unsigned short>(o[0]);
  } else {
#pragma unroll
    for (int c = 0; c < S; ++c)
      if (x + c < w) dst[c] = static_cast<uint8_t>(o[c / 4] >> (8 * (c % 4)));
  }
}

// A lane's strip of S columns at x down the unit's rows [y0, y0 + rows):
// input rows y0 - R .. y0 + rows + R - 1, in blocks of B output rows: the
// x-passes of a block's B + K - 1 input rows in registers (the last K - 1
// carried to the next block), its B new rows made ready in the warp's ring
// at once (aligned rows) and their arithmetic overlapping.
template <int K, int S, int B, bool INTERIOR>
__device__ __forceinline__ void adaptive_strip(const uint8_t* __restrict__ frame, uint8_t* __restrict__ out, int h,
                                               int w, int y0, int x0, int x, int rows, bool vec, const float (&tk)[K],
                                               int c_ceil, uint8_t* slots) {
  using G = Span<K, S>;
  constexpr int R = K / 2;
  constexpr int WORDS = G::WORDS;
  constexpr int GRAY = (S + 3) / 4;
  const bool staged = INTERIOR || vec;
  if (!staged && x >= w) return;
  const int last = rows + K - 2;  // the unit's last input row
  auto y_of = [&](int i) {
    const int y = y0 - R + min(i, last);
    return INTERIOR ? y : clamp_index(y, h);
  };
  StagedRows<G::SPAN, ring_slots(R + B + AHEAD), AHEAD> ring{slots, frame, w, x0 - G::LEFT};
  if (staged) ring.begin();
  auto x_pass_row = [&](int i, float (&xo)[S]) {
    unsigned words[WORDS];
    if (staged)
      staged_window<K, S, INTERIOR>(ring, i, w, x, words);
    else
      byte_window<K, S>(frame, w, y_of(i), x, words);
    window_x_pass<K, S>(words, tk, xo);
  };
  float xr[B + K - 1][S];  // the block's input rows' x-passes
#pragma unroll
  for (int j = 0; j < K - 1; ++j) {
    if (staged) ring.template ready<1>(j, y_of);
    x_pass_row(j, xr[j]);
  }
  for (int o0 = 0; o0 < rows; o0 += B) {
    if (staged) ring.template ready<B>(o0 + K - 1, y_of);
    // the gray bytes of output rows o0 .. o0 + B - 1: input rows o0 + R + b,
    // still in the ring (its depth holds R rows behind the block)
    unsigned gray[B][GRAY];
#pragma unroll
    for (int b = 0; b < B; ++b) {
      if (staged) {
        const int xg = min(x, w - S) & ~3;
#pragma unroll
        for (int q = 0; q < GRAY; ++q) gray[b][q] = ring.word(o0 + R + b, xg + 4 * q) >> (8 * (x & 3));
      } else {
        const uint8_t* p = frame + static_cast<long long>(y0 + min(o0 + b, rows - 1)) * w + x;
#pragma unroll
        for (int q = 0; q < GRAY; ++q) gray[b][q] = 0;
#pragma unroll
        for (int c = 0; c < S; ++c)
          if (x + c < w) gray[b][c / 4] |= static_cast<unsigned>(__ldg(p + c)) << (8 * (c % 4));
      }
    }
#pragma unroll
    for (int b = 0; b < B; ++b) x_pass_row(o0 + K - 1 + b, xr[K - 1 + b]);
#pragma unroll
    for (int b = 0; b < B; ++b) {
      if (o0 + b >= rows) break;
      float mean[S];
#pragma unroll
      for (int c = 0; c < S; ++c) {
        float acc = __fmaf_rn(tk[0], xr[b][c], __fmul_rn(tk[1], xr[b + 1][c]));
#pragma unroll
        for (int t = 2; t < K; ++t) acc = __fmaf_rn(tk[t], xr[b + t][c], acc);
        mean[c] = acc;
      }
      if (!staged || x < w)
        finish_row<S, INTERIOR>(out, w, static_cast<long long>(y0 + o0 + b) * w + x, x, vec, mean, gray[b],
                                0x4B400000u + static_cast<unsigned>(c_ceil));
    }
#pragma unroll
    for (int j = 0; j < K - 1; ++j)
#pragma unroll
      for (int c = 0; c < S; ++c) xr[j][c] = xr[j + B][c];
  }
}

// A persistent 1-D grid; warp u of the grid takes units u, u + warps, ...:
// unit (frame, row band, column band) covers rows [rb * band, rb * band +
// band) and columns [cb * 32 * S, (cb + 1) * 32 * S), a lane S of them.
template <int K, int S, int B>
__global__ void __launch_bounds__(WIN_THREADS, MIN_WINDOW_BLOCKS)
    adaptive_window(const uint8_t* __restrict__ in_all, uint8_t* __restrict__ out_all,
                    const float* __restrict__ taps_g, const int* __restrict__ c_ceil_p, int h, int w, int col_bands,
                    int row_bands, int band, long long units, bool vec) {
  using G = Span<K, S>;
  __shared__ __align__(16) uint8_t slots[WIN_WARPS][ring_slots(G::R + B + AHEAD) * G::SPAN];
  float tk[K];
#pragma unroll
  for (int t = 0; t < K; ++t) tk[t] = __ldg(taps_g + t);
  const int c_ceil = __ldg(c_ceil_p);
  const long long hw = static_cast<long long>(h) * w;
  const long long per_frame = static_cast<long long>(col_bands) * row_bands;
  const long long warps = static_cast<long long>(gridDim.x) * WIN_WARPS;
  const int lane = threadIdx.x % 32;
  for (long long u = static_cast<long long>(blockIdx.x) * WIN_WARPS + threadIdx.x / 32; u < units; u += warps) {
    const long long f = u / per_frame;
    const int rest = static_cast<int>(u - f * per_frame);
    const int rb = rest / col_bands, cb = rest - rb * col_bands;
    const int y0 = rb * band, x0 = cb * 32 * S;
    const int rows = min(band, h - y0);
    // every lane's words and the window's ring of R rows inside the frame
    const bool interior = vec && x0 >= 4 * G::PAD && ((x0 + 31 * S) >> 2) - G::PAD + G::LOADED <= w / 4 &&
                          y0 >= G::R && y0 + band + G::R <= h;
    uint8_t* ring = slots[threadIdx.x / 32];
    if (interior)
      adaptive_strip<K, S, B, true>(in_all + f * hw, out_all + f * hw, h, w, y0, x0, x0 + lane * S, rows, vec, tk,
                                    c_ceil, ring);
    else
      adaptive_strip<K, S, B, false>(in_all + f * hw, out_all + f * hw, h, w, y0, x0, x0 + lane * S, rows, vec, tk,
                                     c_ceil, ring);
  }
}

template <int K, int S, int B>
cudaError_t launch_window(const uint8_t* in, uint8_t* out, const float* taps, const int* c_ceil, int n, int h, int w,
                          cudaStream_t stream) {
  const auto kernel = adaptive_window<K, S, B>;
  static int resident = 0;
  UnitPlan plan;
  cudaError_t err = cudaSuccess;
  if (!plan_units<WIN_WARPS, MIN_BAND>(kernel, resident, n, h, w, 32 * S, 1, plan, err)) return err;
  const bool vec = reinterpret_cast<uintptr_t>(in) % 16 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                   w % 16 == 0;
  kernel<<<plan.blocks, WIN_THREADS, 0, stream>>>(in, out, taps, c_ceil, h, w, plan.col_bands, plan.row_bands,
                                                  plan.band, plan.units, vec);
  return cudaGetLastError();
}

}  // namespace

// in, out: (n, h, w) uint8 on the card; taps: k float32 on the card (k odd,
// at most 255); c_ceil: one int32 on the card.  More than 65535 frames go in
// slices.
extern "C" int yam_adaptive_threshold_u8(const void* in, void* out, const void* taps, const void* c_ceil, int k,
                                         int n, int h, int w, void* stream) {
  if (k < 1 || k > MAX_TAPS || k % 2 == 0 || h <= 0 || w <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto* src = static_cast<const uint8_t*>(in);
  auto* dst = static_cast<uint8_t*>(out);
  const auto* tp = static_cast<const float*>(taps);
  const auto* cp = static_cast<const int*>(c_ceil);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 3: return static_cast<int>(launch_window<3, 8, 4>(src, dst, tp, cp, n, h, w, s));
    case 5: return static_cast<int>(launch_window<5, 8, 4>(src, dst, tp, cp, n, h, w, s));
    case 7: return static_cast<int>(launch_window<7, 8, 4>(src, dst, tp, cp, n, h, w, s));
    case 9: return static_cast<int>(launch_window<9, 4, 4>(src, dst, tp, cp, n, h, w, s));
    case 11: return static_cast<int>(launch_window<11, 4, 4>(src, dst, tp, cp, n, h, w, s));
    case 13: return static_cast<int>(launch_window<13, 4, 4>(src, dst, tp, cp, n, h, w, s));
    case 15: return static_cast<int>(launch_window<15, 4, 4>(src, dst, tp, cp, n, h, w, s));
    case 17: return static_cast<int>(launch_window<17, 2, 2>(src, dst, tp, cp, n, h, w, s));
    case 19: return static_cast<int>(launch_window<19, 2, 2>(src, dst, tp, cp, n, h, w, s));
    case 21: return static_cast<int>(launch_window<21, 2, 2>(src, dst, tp, cp, n, h, w, s));
    case 23: return static_cast<int>(launch_window<23, 2, 2>(src, dst, tp, cp, n, h, w, s));
    case 25: return static_cast<int>(launch_window<25, 2, 2>(src, dst, tp, cp, n, h, w, s));
    case 27: return static_cast<int>(launch_window<27, 2, 2>(src, dst, tp, cp, n, h, w, s));
    case 29: return static_cast<int>(launch_window<29, 2, 2>(src, dst, tp, cp, n, h, w, s));
    case 31: return static_cast<int>(launch_window<31, 2, 2>(src, dst, tp, cp, n, h, w, s));
    case 33: return static_cast<int>(launch_window<33, 2, 2>(src, dst, tp, cp, n, h, w, s));
    default: break;
  }
  const size_t shared = shared_bytes(k);
  cudaError_t err = cudaFuncSetAttribute(adaptive_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(shared_bytes(MAX_TAPS)));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_x = (w + TILE_COLS - 1) / TILE_COLS;
  const int tiles = (h + TILE_ROWS - 1) / TILE_ROWS * tiles_x;
  const long long hw = static_cast<long long>(h) * w;
  for (int first = 0; first < n; first += MAX_FRAMES) {
    const int frames = n - first < MAX_FRAMES ? n - first : MAX_FRAMES;
    adaptive_kernel<<<dim3(tiles, frames), THREADS, shared, s>>>(src + first * hw, dst + first * hw, tp, cp, k, h, w,
                                                                  tiles_x);
  }
  return static_cast<int>(cudaGetLastError());
}
