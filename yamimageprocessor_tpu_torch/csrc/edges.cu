// Integer gradients (Sobel, Prewitt, Laplacian) and Canny's candidates on
// uint8 gray frames, with XLA's int32 arithmetic: every product and sum
// wraps modulo 2^32.
//
// Replaces yamimageprocessor_tpu/ops/edges.py:sobel_j (:89), prewitt_j
// (:125), laplacian_j (:153) and the candidate half of canny_j (:219):
// XLA fusions there, not pallas_calls.  C++ leaves signed overflow
// undefined, so the sums run in uint32_t and are reinterpreted; sums modulo
// 2^32 are exact in any order, so the taps may be regrouped and folded
// freely.  Every gradient is then two separable correlations of one integer
// tap pair (t0, t1): A = sep(ky = t0, kx = t1), B = sep(ky = t1, kx = t0)
// (ops/edges.py:gradient_taps gives the pairs; the Laplacian's dense
// aperture is outer(t0, t1) + outer(t1, t0)).  Sobel is isqrt32(A^2 + B^2),
// Prewitt the same with A and B saturated to 0..255 first, the Laplacian
// |A + B| (|INT32_MIN| wraps, then saturates to 0).
//
//   gradient_window   the tap pairs of Sobel 1-7, Prewitt 3 and the
//                     Laplacian 1-7 (the Ints tap pairs below: the compiler
//                     folds the taps into adds and shifts).  A persistent
//                     grid of warps walks units of `band` rows x 32 * S
//                     columns of one frame.  A lane takes a strip of S = 8
//                     consecutive output columns and walks down the band: each input row of the strip
//                     is read once, as an S-byte vector and the 4-byte words
//                     on either side (the ring of R = K / 2 columns), both
//                     x-pass sums of the row go into a register ring of the
//                     last K rows (indices fixed at compile time: the row
//                     loop is unrolled by K), the y-passes read the ring,
//                     and each output row goes out as one S-byte vector.
//                     The next row's loads are issued before this row's
//                     arithmetic.  A unit whose window, with its ring of R
//                     rows and of a word of columns, lies inside a frame
//                     whose rows are 16-byte aligned takes a path with no
//                     reflect101 and no %.  Edge units reflect the row index
//                     where it leaves the frame, form the ring's columns at
//                     the frame's side from the strip's own bytes, and read
//                     byte by byte through reflect101 where rows are not
//                     aligned (periodically where R >= n, and on frames 1
//                     pixel wide or tall).
//   gradient_tile     any other odd k up to 31 (Sobel 9-31, the Laplacian
//                     9-19): a block a TILE x TILE tile, the tile and its
//                     ring staged in shared memory (directly inside the
//                     frame, through reflect101 at its edges), both
//                     x-passes to shared memory, the y-passes with runtime
//                     taps.
//   canny_window      Canny's candidates (replicate border, L1 magnitude,
//                     the fixed-point suppression) at apertures 3, 5 and 7,
//                     the only ones the op takes: compile-time tap pairs
//                     (Smooth k, Deriv k) folded like gradient_window's,
//                     gradient_window's units, a lane a strip of S columns
//                     (8 at aperture 3, 4 at 5 and 7), in blocks of B = 2
//                     output rows.  A block's B new input rows are made
//                     ready at once in the warp's ring of staged rows
//                     (rows.cuh: cp.async, AHEAD rows in flight), so its
//                     rows' arithmetic overlaps; a lane keeps the x-passes
//                     of the block's B + K - 1 input rows and the magnitudes
//                     |gx| + |gy| of its B + 2 gradient rows (0 outside the
//                     frame: canny_j's magp) with their four direction bits
//                     a pixel in registers, K - 1 and 2 of them carried to
//                     the next block.  The magnitudes at x - 1 and x + S
//                     come from the neighbouring lanes by __shfl_up_sync and
//                     __shfl_down_sync; lanes 0 and 31 compute that column
//                     themselves (one more x-pass and y-pass a row: 1/S of
//                     the passes).  Each output row goes out as one S-byte
//                     store of 0 (none), 1 (a candidate, mag > low) or 2 (a
//                     strong one, mag > high); low and high are int32
//                     scalars on the card.  The suppression compares in
//                     wrapping int32 (TG22 = 13573, shift 15; at aperture 7
//                     |gy| << 15 and |gx| * 13573 wrap) with canny_j's > and
//                     >= ties.  The border is replicated: an edge unit
//                     clamps the row index and forms a word past the frame's
//                     side from the strip's own bytes; a unit whose window,
//                     rings of R + 1 rows and a word of columns lie inside
//                     the frame takes a path with no clamps.  Rows that are
//                     not 16-byte aligned are read byte by byte, each
//                     column clamped, without the ring.
//
// isqrt32 is _isqrt_j step by step: the float32 root of the int32 sum
// rounded to nearest (NaN where the sum wrapped negative, which XLA's
// conversion sends to 0), truncated, then the +1 and -1 corrections, whose
// squares wrap in int32 near 46341^2.
//
// Bound on the card: device memory or the integer pipe.  A pixel reads 1 B
// and writes 1 B; the gradient takes 4k multiply-adds a pixel at most (two
// x-passes and two y-passes of k taps; fewer where taps fold), Canny the same
// passes, then ~30 operations of the magnitude, the directions and the
// suppression (chip_smoke.py:gradient_bounds, canny_bounds).  Most of
// Canny's are on the int32 pipe, which issues at half the FP32 rate.

#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cstdint>

#include "rows.cuh"

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

// Stage the ih x iw input window whose top-left output lies at (y0, x0)
// into s_in through reflect101.
__device__ void stage_window(const uint8_t* __restrict__ frame, int h, int w, int y0, int x0, int ih, int iw, int r,
                             uint8_t* s_in) {
  for (int i = threadIdx.x; i < ih * iw; i += THREADS) {
    const int row = i / iw, col = i - row * iw;
    s_in[i] = __ldg(frame + static_cast<long long>(reflect101(y0 - r + row, h)) * w + reflect101(x0 - r + col, w));
  }
}

// both x-passes of the staged rows into s_xa (taps t1) and s_xb (taps t0),
// ih x ow each
__device__ void x_pass_rows(int ih, int iw, int ow, int k, const Taps& taps, const uint8_t* s_in, unsigned* s_xa,
                            unsigned* s_xb) {
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

constexpr int SOBEL = 0, PREWITT = 1, LAPLACIAN = 2;

// the output byte of a gradient from its two sums
template <int KIND>
__device__ __forceinline__ unsigned combine(unsigned ua, unsigned ub) {
  if (KIND == LAPLACIAN) {
    const int sum = static_cast<int>(ua + ub);
    const int mag = sum == INT_MIN ? INT_MIN : (sum < 0 ? -sum : sum);
    return mag < 0 ? 0 : (mag > 255 ? 255 : mag);
  }
  int a = static_cast<int>(ua), b = static_cast<int>(ub);
  if (KIND == PREWITT) {
    a = a < 0 ? 0 : (a > 255 ? 255 : a);
    b = b < 0 ? 0 : (b > 255 ? 255 : b);
  }
  return magnitude(a, b);
}

__host__ __device__ constexpr size_t gradient_shared(int k) {
  return static_cast<size_t>((TILE + k - 1) * (TILE + k - 1)) +
         2 * sizeof(unsigned) * static_cast<size_t>((TILE + k - 1) * TILE) + 16;
}

// grid (tiles, frames); runtime taps (any odd k up to MAX_TAPS)
__global__ void __launch_bounds__(THREADS)
    gradient_tile(const uint8_t* __restrict__ in_all, uint8_t* __restrict__ out_all, int h, int w, int tiles_x,
                  int k, int kind, Taps taps) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int r = k / 2;
  const int ih = TILE + k - 1;
  unsigned* s_xa = reinterpret_cast<unsigned*>(smem);
  unsigned* s_xb = s_xa + ih * TILE;
  uint8_t* s_in = reinterpret_cast<uint8_t*>(s_xb + ih * TILE);
  const long long hw = static_cast<long long>(h) * w;
  const uint8_t* frame = in_all + blockIdx.y * hw;
  uint8_t* out = out_all + blockIdx.y * hw;
  const int y0 = blockIdx.x / tiles_x * TILE;
  const int x0 = blockIdx.x % tiles_x * TILE;
  static_assert(TILE + MAX_TAPS - 1 <= 64 && THREADS % 64 == 0, "a thread a staged column, 64 a row");
  if (y0 >= r && y0 + TILE + r <= h && x0 >= r && x0 + TILE + r <= w) {
    // interior: the window lies inside the frame
    const int col = threadIdx.x % 64;
    const uint8_t* src = frame + static_cast<long long>(y0 - r) * w + x0 - r + col;
    if (col < ih)
      for (int row = threadIdx.x / 64; row < ih; row += THREADS / 64)
        s_in[row * ih + col] = __ldg(src + static_cast<long long>(row) * w);
  } else {
    stage_window(frame, h, w, y0, x0, ih, ih, r, s_in);
  }
  __syncthreads();
  x_pass_rows(ih, ih, TILE, k, taps, s_in, s_xa, s_xb);
  __syncthreads();
  for (int i = threadIdx.x; i < TILE * TILE; i += THREADS) {
    const int row = i / TILE, col = i - row * TILE;
    if (y0 + row >= h || x0 + col >= w) continue;
    int a, b;
    y_passes(s_xa, s_xb, TILE, row, col, k, taps, a, b);
    const unsigned ua = static_cast<unsigned>(a), ub = static_cast<unsigned>(b);
    const unsigned v = kind == LAPLACIAN ? combine<LAPLACIAN>(ua, ub)
                                         : (kind == PREWITT ? combine<PREWITT>(ua, ub) : combine<SOBEL>(ua, ub));
    out[static_cast<long long>(y0 + row) * w + x0 + col] = static_cast<uint8_t>(v);
  }
}

// ---------------------------------------------------------------------------
// gradient_window: compile-time taps, a register window a lane

constexpr int GRAD_WARPS = 4;
constexpr int GRAD_THREADS = 32 * GRAD_WARPS;
constexpr int MIN_BAND = 16;  // rows of a unit at least: the K - 1 rows before the first output stay a few percent
// units a warp of the resident grid takes, where the frames hold enough
// rows: two at K = 7, whose window holds the most registers and the fewest
// warps an SM, so that shorter units even out the SMs' ends (PERF.md, section 6)
__host__ __device__ constexpr int units_a_warp(int k) { return k >= 7 ? 2 : 1; }

template <int... V>
struct Ints {
  static constexpr int size = sizeof...(V);
  __host__ __device__ static constexpr int at(int i) {
    constexpr int v[] = {V...};
    return v[i];
  }
};

// A lane's input row: S bytes at the strip's columns [x, x + S) and the
// 4-byte words on either side ([x - 4, x) and [x + S, x + S + 4)).
template <int S>
struct Row {
  unsigned main[S / 4];
  unsigned left, right;
};

template <int S>
__device__ __forceinline__ void load_main(Row<S>& row, const uint8_t* p) {
  static_assert(S == 8, "a strip is one 8-byte vector");
  const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
  row.main[0] = v.x;
  row.main[1] = v.y;
}

// S output bytes (the low byte of each o[c]) as one vector store
template <int S>
__device__ __forceinline__ void store_row(uint8_t* p, const unsigned (&o)[S]) {
  unsigned words[S / 4];
#pragma unroll
  for (int q = 0; q < S / 4; ++q)
    words[q] = __byte_perm(__byte_perm(o[4 * q], o[4 * q + 1], 0x0040), __byte_perm(o[4 * q + 2], o[4 * q + 3], 0x0040),
                           0x5410);
  if constexpr (S == 8)
    *reinterpret_cast<uint2*>(p) = make_uint2(words[0], words[1]);
  else
    *reinterpret_cast<unsigned*>(p) = words[0];
}

__device__ __forceinline__ unsigned load_word(const uint8_t* p) { return __ldg(reinterpret_cast<const unsigned*>(p)); }

// byte i of the lane's window [x - R, x + S + R)
template <int S, int R>
__device__ __forceinline__ int window_byte(const Row<S>& row, int i) {
  if (i < R) return __byte_perm(row.left, 0, 0x4440 | (4 - R + i));
  if (i < R + S) return __byte_perm(row.main[(i - R) / 4], 0, 0x4440 | ((i - R) % 4));
  return __byte_perm(row.right, 0, 0x4440 | (i - R - S));
}

// Row y of the lane's window.  INTERIOR: the row, the strip and both words
// lie inside the frame and rows are 16-byte aligned.  Otherwise the row index
// is reflected where it leaves the frame; with aligned rows (`vec`) a strip
// lies inside or outside the frame as a whole (the caller skips the outside
// ones), and a word past the frame's side is its reflection, formed from the
// strip's own bytes (w >= 16 > R); without, byte by byte through reflect101.
template <int S, int R, bool INTERIOR>
__device__ __forceinline__ Row<S> fetch_row(const uint8_t* __restrict__ frame, int h, int w, int y, int x, bool vec) {
  Row<S> row;
  if (INTERIOR) {
    const uint8_t* p = frame + static_cast<long long>(y) * w + x;
    load_main(row, p);
    row.left = load_word(p - 4);
    row.right = load_word(p + S);
    return row;
  }
  const int yy = (y >= 0 && y < h) ? y : reflect101(y, h);
  const uint8_t* p = frame + static_cast<long long>(yy) * w;
  if (vec) {
    load_main(row, p + x);
    row.left = x >= 4 ? load_word(p + x - 4) : __byte_perm(row.main[0], row.main[1], 0x1234);
    row.right = x + S + 4 <= w ? load_word(p + x + S) : __byte_perm(row.main[S / 4 - 2], row.main[S / 4 - 1], 0x3456);
    return row;
  }
  const bool inside = x >= R && x + S + R <= w;
  row.left = row.right = 0;
#pragma unroll
  for (int q = 0; q < S / 4; ++q) row.main[q] = 0;
#pragma unroll
  for (int i = 0; i < S + 2 * R; ++i) {
    const int pos = x - R + i;
    const unsigned b = __ldg(p + (inside ? pos : reflect101(pos, w)));
    if (i < R)
      row.left |= b << (8 * (4 - R + i));
    else if (i < R + S)
      row.main[(i - R) / 4] |= b << (8 * ((i - R) % 4));
    else
      row.right |= b << (8 * (i - R - S));
  }
  return row;
}

// both x-passes of a window row: xa with taps T1, xb with taps T0
template <class T0, class T1, int S>
__device__ __forceinline__ void x_pass(const Row<S>& row, unsigned (&xa)[S], unsigned (&xb)[S]) {
  constexpr int K = T0::size, R = K / 2;
  int v[S + K - 1];
#pragma unroll
  for (int i = 0; i < S + K - 1; ++i) v[i] = window_byte<S, R>(row, i);
#pragma unroll
  for (int c = 0; c < S; ++c) {
    unsigned a = 0, b = 0;
#pragma unroll
    for (int t = 0; t < K; ++t) {
      a += static_cast<unsigned>(T1::at(t)) * static_cast<unsigned>(v[c + t]);
      b += static_cast<unsigned>(T0::at(t)) * static_cast<unsigned>(v[c + t]);
    }
    xa[c] = a;
    xb[c] = b;
  }
}

// A lane's strip of S columns at x down the unit's rows [y0, y0 + rows).
template <int KIND, class T0, class T1, int S, bool INTERIOR>
__device__ __forceinline__ void window_strip(const uint8_t* __restrict__ frame, uint8_t* __restrict__ out, int h,
                                             int w, int y0, int x, int rows, bool vec) {
  constexpr int K = T0::size, R = K / 2;
  static_assert(T1::size == K && K % 2 == 1 && R <= 3, "odd tap pairs of at most 7: the ring is one word");
  if (!INTERIOR && x >= w) return;
  unsigned ra[K][S], rb[K][S];  // the last K rows' x-passes, row i in slot i % K
  const int last = rows + K - 1;  // input rows
  Row<S> next = fetch_row<S, R, INTERIOR>(frame, h, w, y0 - R, x, vec);
#pragma unroll
  for (int i = 0; i < K - 1; ++i) {
    const Row<S> cur = next;
    next = fetch_row<S, R, INTERIOR>(frame, h, w, y0 - R + i + 1, x, vec);
    x_pass<T0, T1, S>(cur, ra[i], rb[i]);
  }
  for (int base = K - 1; base < last; base += K) {
#pragma unroll
    for (int ph = 0; ph < K; ++ph) {
      const int i = base + ph;  // i % K == (K - 1 + ph) % K
      if (i >= last) break;
      const Row<S> cur = next;
      if (i + 1 < last) next = fetch_row<S, R, INTERIOR>(frame, h, w, y0 - R + i + 1, x, vec);
      x_pass<T0, T1, S>(cur, ra[(K - 1 + ph) % K], rb[(K - 1 + ph) % K]);
      // output row i - (K - 1): input rows i - K + 1 .. i, slots (ph + t) % K
      unsigned o[S];
#pragma unroll
      for (int c = 0; c < S; ++c) {
        unsigned sa = 0, sb = 0;
#pragma unroll
        for (int t = 0; t < K; ++t) {
          sa += static_cast<unsigned>(T0::at(t)) * ra[(ph + t) % K][c];
          sb += static_cast<unsigned>(T1::at(t)) * rb[(ph + t) % K][c];
        }
        o[c] = combine<KIND>(sa, sb);
      }
      uint8_t* dst = out + static_cast<long long>(y0 + i - (K - 1)) * w + x;
      if (INTERIOR || vec) {
        store_row<S>(dst, o);
      } else {
#pragma unroll
        for (int c = 0; c < S; ++c)
          if (x + c < w) dst[c] = static_cast<uint8_t>(o[c]);
      }
    }
  }
}

// A persistent 1-D grid; warp u of the grid takes units u, u + warps, ...:
// unit (frame, row band, column band) covers rows [rb * band, rb * band +
// band) and columns [cb * 32 * S, (cb + 1) * 32 * S), a lane S of them.
template <int KIND, class T0, class T1, int S>
__global__ void __launch_bounds__(GRAD_THREADS)
    gradient_window(const uint8_t* __restrict__ in_all, uint8_t* __restrict__ out_all, int h, int w, int col_bands,
                    int row_bands, int band, long long units, bool vec) {
  constexpr int R = T0::size / 2;
  const long long hw = static_cast<long long>(h) * w;
  const long long per_frame = static_cast<long long>(col_bands) * row_bands;
  const long long warps = static_cast<long long>(gridDim.x) * GRAD_WARPS;
  const int lane = threadIdx.x % 32;
  for (long long u = static_cast<long long>(blockIdx.x) * GRAD_WARPS + threadIdx.x / 32; u < units; u += warps) {
    const long long f = u / per_frame;
    const int rest = static_cast<int>(u - f * per_frame);
    const int rb = rest / col_bands, cb = rest - rb * col_bands;
    const int y0 = rb * band, x0 = cb * 32 * S;
    const int rows = min(band, h - y0);
    const bool interior = vec && x0 >= 4 && x0 + 32 * S + 4 <= w && y0 >= R && y0 + band + R <= h;
    if (interior)
      window_strip<KIND, T0, T1, S, true>(in_all + f * hw, out_all + f * hw, h, w, y0, x0 + lane * S, rows, vec);
    else
      window_strip<KIND, T0, T1, S, false>(in_all + f * hw, out_all + f * hw, h, w, y0, x0 + lane * S, rows, vec);
  }
}

// The tap pairs with compiled instances: (t0, t1) of ops/edges.py:gradient_taps.
using Centre3 = Ints<0, 1, 0>;
using Smooth3 = Ints<1, 2, 1>;
using Smooth5 = Ints<1, 4, 6, 4, 1>;
using Smooth7 = Ints<1, 6, 15, 20, 15, 6, 1>;
using Deriv3 = Ints<-1, 0, 1>;
using Deriv5 = Ints<-1, -2, 0, 2, 1>;
using Deriv7 = Ints<-1, -4, -5, 0, 5, 4, 1>;
using Box3 = Ints<1, 1, 1>;
using Diff3 = Ints<1, 0, -1>;
using Second3 = Ints<1, -2, 1>;
using Second5 = Ints<1, 0, -2, 0, 1>;
using Second7 = Ints<1, 2, -1, -4, -1, 2, 1>;

template <class T>
bool same_taps(const int* taps, int k) {
  if (k != T::size) return false;
  for (int i = 0; i < k; ++i)
    if (taps[i] != T::at(i)) return false;
  return true;
}

// Launch the instance for (kind, t0, t1) if it is this one; false if not.
template <int KIND, class T0, class T1, int S>
bool try_window(int kind, const int* t0, const int* t1, int k, const uint8_t* in, uint8_t* out, int n, int h, int w,
                cudaStream_t stream, cudaError_t& err) {
  if (kind != KIND || !same_taps<T0>(t0, k) || !same_taps<T1>(t1, k)) return false;
  const auto kernel = gradient_window<KIND, T0, T1, S>;
  static int resident = 0;
  UnitPlan plan;
  if (!plan_units<GRAD_WARPS, MIN_BAND>(kernel, resident, n, h, w, 32 * S, units_a_warp(T0::size), plan, err))
    return true;
  const bool vec = reinterpret_cast<uintptr_t>(in) % 16 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                   w % 16 == 0;
  kernel<<<plan.blocks, GRAD_THREADS, 0, stream>>>(in, out, h, w, plan.col_bands, plan.row_bands, plan.band,
                                                   plan.units, vec);
  err = cudaGetLastError();
  return true;
}

// ---------------------------------------------------------------------------
// canny_window: Canny's candidates from a register window a lane

__device__ __forceinline__ unsigned uabs(int v) { return v < 0 ? 0u - static_cast<unsigned>(v) : v; }

constexpr int CANNY_ROWS = 2;  // output rows a block of canny_strip
constexpr int AHEAD = 4;  // rows a warp has in flight beyond the block it computes
// blocks an SM holds at least: caps the registers (at most 128), which the
// compiler would otherwise spend on overlapping a block's rows
constexpr int MIN_WINDOW_BLOCKS = 4;

// Row i of a Canny lane's window from the warp's staged row (16-byte
// aligned rows), replicate border.  INTERIOR: the strip and both words lie
// inside the frame.  Otherwise a strip lies inside or outside the frame as
// a whole (one outside reads the frame's last strip: its magnitudes are 0
// and it stores nothing), and a word past the frame's side repeats the
// side's byte, formed from the strip's own bytes.
template <int S, bool INTERIOR, class Rows>
__device__ __forceinline__ Row<S> staged_row(const Rows& rows, int i, int w, int x) {
  Row<S> row;
  const int xs = INTERIOR ? x : min(x, w - S);
#pragma unroll
  for (int q = 0; q < S / 4; ++q) row.main[q] = rows.word(i, xs + 4 * q);
  if (INTERIOR) {
    row.left = rows.word(i, x - 4);
    row.right = rows.word(i, x + S);
  } else {
    row.left = xs >= 4 ? rows.word(i, xs - 4) : __byte_perm(row.main[0], 0, 0x0000);
    row.right = xs + S + 4 <= w ? rows.word(i, xs + S) : __byte_perm(row.main[S / 4 - 1], 0, 0x3333);
  }
  return row;
}

// Row y (clamped by the caller) of a Canny lane's window on rows that are
// not 16-byte aligned: byte by byte, each column clamped.
template <int S>
__device__ __forceinline__ Row<S> replicate_bytes(const uint8_t* __restrict__ frame, int w, int y, int x) {
  Row<S> row;
  const uint8_t* p = frame + static_cast<long long>(y) * w;
  row.left = row.right = 0;
#pragma unroll
  for (int q = 0; q < S / 4; ++q) row.main[q] = 0;
#pragma unroll
  for (int i = 0; i < S + 8; ++i) {
    const unsigned b = __ldg(p + clamp_index(x - 4 + i, w));
    if (i < 4)
      row.left |= b << (8 * i);
    else if (i < S + 4)
      row.main[(i - 4) / 4] |= b << (8 * (i % 4));
    else
      row.right |= b << (8 * (i - S - 4));
  }
  return row;
}

// Both x-passes of the lane's extra column: x - 1 (lanes 0-30; lane 0's
// left neighbour) or x + S (lane 31: its right neighbour).  e0, e1: the 8
// bytes around it, the column at byte 3.
template <class T0, class T1, int S>
__device__ __forceinline__ void x_pass_extra(const Row<S>& row, bool right_side, unsigned& a, unsigned& b) {
  constexpr int K = T0::size, R = K / 2;
  const unsigned e0 = right_side ? __byte_perm(row.main[S / 4 - 1], row.right, 0x4321) : row.left;
  const unsigned e1 = right_side ? __byte_perm(row.right, 0, 0x4321) : row.main[0];
  a = b = 0;
#pragma unroll
  for (int t = 0; t < K; ++t) {
    const int i = 3 - R + t;
    const unsigned v = __byte_perm(i < 4 ? e0 : e1, 0, 0x4440 | (i % 4));
    a += static_cast<unsigned>(T1::at(t)) * v;
    b += static_cast<unsigned>(T0::at(t)) * v;
  }
}

// canny_j's L1 magnitude and directions of one pixel from its gradient
// (gx, gy) as uint32 sums, in wrapping int32: bit 0 horizontal (|gy| << 15
// < |gx| * TG22), bit 1 vertical (|gy| << 15 > tg67x), bit 2 or 3 the
// diagonal between them by the signs' agreement (2 equal, 3 opposite).
__device__ __forceinline__ int magnitude_dirs(unsigned sa, unsigned sb, unsigned& dirs) {
  const int gx = static_cast<int>(sa), gy = static_cast<int>(sb);
  const unsigned ax = uabs(gx), ay = uabs(gy);
  const int y = static_cast<int>(ay << SHIFT);
  const unsigned tg22 = ax * static_cast<unsigned>(TG22);
  const int tg22x = static_cast<int>(tg22);
  const int tg67x = static_cast<int>(tg22 + ((ax + ax) << SHIFT));
  const bool diag = y >= tg22x && y <= tg67x;
  const bool neg = (gx ^ gy) < 0;
  dirs = static_cast<unsigned>(y < tg22x) | static_cast<unsigned>(y > tg67x) << 1 |
         static_cast<unsigned>(diag && !neg) << 2 | static_cast<unsigned>(diag && neg) << 3;
  return static_cast<int>(ax + ay);
}

// 0, 1 or 2: the suppression of magnitude m (directions d) against its
// neighbours in the rows above (u), at (c) and below (b), each [x - 1, x + 1]
__device__ __forceinline__ unsigned suppress(int m, unsigned d, int ul, int uc, int ur, int cl, int cr, int bl,
                                             int bc, int br, int low, int high) {
  const bool horiz = (d & 1u) && m > cl && m >= cr;
  const bool vert = (d & 2u) && m > uc && m >= bc;
  const bool pos = (d & 4u) && m > ul && m > br;
  const bool neg = (d & 8u) && m > ur && m > bl;
  return m > low && (horiz || vert || pos || neg) ? (m > high ? 2u : 1u) : 0u;
}

// A lane's strip of S columns at x down the unit's output rows [y0, y0 +
// rows): input rows y0 - 1 - R .. y0 + rows + R, gradient rows y0 - 1 ..
// y0 + rows, in blocks of B output rows: the x-passes of a block's B + K - 1
// input rows and the magnitudes of its B + 2 gradient rows in registers (K
// - 1 and 2 carried to the next block), its B new input rows made ready in
// the warp's ring at once (aligned rows) and their arithmetic overlapping.
template <class T0, class T1, int S, bool INTERIOR>
__device__ __forceinline__ void canny_strip(const uint8_t* __restrict__ frame, uint8_t* __restrict__ plane, int h,
                                            int w, int y0, int x0, int x, int rows, bool vec, int low, int high,
                                            uint8_t* slots) {
  constexpr int K = T0::size, R = K / 2, B = CANNY_ROWS;
  constexpr unsigned ALL = 0xffffffffu;
  const int lane = threadIdx.x % 32;
  const bool right_side = lane == 31;
  const int ex = right_side ? x + S : x - 1;  // the extra column
  const bool ex_in = INTERIOR || (ex >= 0 && ex < w);
  const int last = rows + K;  // the unit's last input row
  auto y_of = [&](int i) {
    const int y = y0 - 1 - R + min(i, last);
    return INTERIOR ? y : clamp_index(y, h);
  };
  const bool staged = INTERIOR || vec;
  StagedRows<32 * S + 32, ring_slots(B + AHEAD), AHEAD> ring{slots, frame, w, x0 - 16};
  if (staged) ring.begin();
  auto fetch = [&](int i) {
    return staged ? staged_row<S, INTERIOR>(ring, i, w, x) : replicate_bytes<S>(frame, w, y_of(i), x);
  };
  // gradient row g (frame row y0 - 1 + g) from the x-pass rows a[t], b[t],
  // ea[t], eb[t] (t < K): its magnitudes into m[0 .. S + 1] (0 outside the
  // frame: canny_j's magp; m[0] and m[S + 1] from the neighbouring lanes or
  // the lane's extra column), its directions into d
  auto gradient = [&](int g, auto row_a, auto row_b, auto extra_a, auto extra_b, int (&m)[S + 2], unsigned& d) {
    const int yg = y0 - 1 + g;
    const bool row_in = INTERIOR || (yg >= 0 && yg < h);
    d = 0;
#pragma unroll
    for (int c = 0; c < S; ++c) {
      unsigned sa = 0, sb = 0;
#pragma unroll
      for (int t = 0; t < K; ++t) {
        sa += static_cast<unsigned>(T0::at(t)) * row_a(t)[c];
        sb += static_cast<unsigned>(T1::at(t)) * row_b(t)[c];
      }
      unsigned dc;
      const int mc = magnitude_dirs(sa, sb, dc);
      m[c + 1] = row_in && (INTERIOR || x + c < w) ? mc : 0;
      d |= dc << (4 * c);
    }
    unsigned sa = 0, sb = 0;
#pragma unroll
    for (int t = 0; t < K; ++t) {
      sa += static_cast<unsigned>(T0::at(t)) * extra_a(t);
      sb += static_cast<unsigned>(T1::at(t)) * extra_b(t);
    }
    const int extra = row_in && ex_in ? static_cast<int>(uabs(static_cast<int>(sa)) + uabs(static_cast<int>(sb))) : 0;
    const int from_left = __shfl_up_sync(ALL, m[S], 1);
    const int from_right = __shfl_down_sync(ALL, m[1], 1);
    m[0] = lane == 0 ? extra : from_left;
    m[S + 1] = right_side ? extra : from_right;
  };
  // output row yo from the magnitudes of rows yo - 1 (u), yo (c), yo + 1 (b)
  auto emit = [&](int yo, const int (&u)[S + 2], const int (&c)[S + 2], const int (&b)[S + 2], unsigned d) {
    unsigned o[S];
#pragma unroll
    for (int k = 0; k < S; ++k)
      o[k] = suppress(c[k + 1], (d >> (4 * k)) & 15u, u[k], u[k + 1], u[k + 2], c[k], c[k + 2], b[k], b[k + 1],
                      b[k + 2], low, high);
    uint8_t* dst = plane + static_cast<long long>(yo) * w + x;
    if (INTERIOR || vec) {
      if (INTERIOR || x < w) store_row<S>(dst, o);
    } else {
#pragma unroll
      for (int k = 0; k < S; ++k)
        if (x + k < w) dst[k] = static_cast<uint8_t>(o[k]);
    }
  };
  static_assert(B >= 2, "the first K + 1 input rows fit a block's B + K - 1");
  unsigned xa[B + K - 1][S], xb[B + K - 1][S], ea[B + K - 1], eb[B + K - 1];
  int mag[B + 2][S + 2];  // gradient rows o0 .. o0 + B + 1 of the block at output row o0
  unsigned dirs[B + 2];
#pragma unroll
  for (int i = 0; i <= K; ++i) {
    if (staged) ring.template ready<1>(i, y_of);
    const Row<S> row = fetch(i);
    x_pass<T0, T1, S>(row, xa[i], xb[i]);
    x_pass_extra<T0, T1, S>(row, right_side, ea[i], eb[i]);
  }
#pragma unroll
  for (int g = 0; g < 2; ++g)
    gradient(
        g, [&](int t) -> const unsigned(&)[S] { return xa[g + t]; },
        [&](int t) -> const unsigned(&)[S] { return xb[g + t]; }, [&](int t) { return ea[g + t]; },
        [&](int t) { return eb[g + t]; }, mag[g], dirs[g]);
#pragma unroll
  for (int j = 0; j < K - 1; ++j) {  // carry input rows 2 .. K
#pragma unroll
    for (int c = 0; c < S; ++c) {
      xa[j][c] = xa[j + 2][c];
      xb[j][c] = xb[j + 2][c];
    }
    ea[j] = ea[j + 2];
    eb[j] = eb[j + 2];
  }
  for (int o0 = 0; o0 < rows; o0 += B) {
    if (staged) ring.template ready<B>(o0 + K + 1, y_of);
    // input rows o0 + K + 1 + b into slots K - 1 + b; gradient rows o0 + 2 + b from slots b .. b + K - 1
#pragma unroll
    for (int b = 0; b < B; ++b) {
      const Row<S> row = fetch(o0 + K + 1 + b);
      x_pass<T0, T1, S>(row, xa[K - 1 + b], xb[K - 1 + b]);
      x_pass_extra<T0, T1, S>(row, right_side, ea[K - 1 + b], eb[K - 1 + b]);
      gradient(
          o0 + 2 + b, [&](int t) -> const unsigned(&)[S] { return xa[b + t]; },
          [&](int t) -> const unsigned(&)[S] { return xb[b + t]; }, [&](int t) { return ea[b + t]; },
          [&](int t) { return eb[b + t]; }, mag[2 + b], dirs[2 + b]);
    }
#pragma unroll
    for (int b = 0; b < B; ++b) {
      if (o0 + b >= rows) break;
      emit(y0 + o0 + b, mag[b], mag[b + 1], mag[b + 2], dirs[b + 1]);
    }
#pragma unroll
    for (int j = 0; j < K - 1; ++j) {
#pragma unroll
      for (int c = 0; c < S; ++c) {
        xa[j][c] = xa[j + B][c];
        xb[j][c] = xb[j + B][c];
      }
      ea[j] = ea[j + B];
      eb[j] = eb[j + B];
    }
#pragma unroll
    for (int g = 0; g < 2; ++g) {
#pragma unroll
      for (int c = 0; c < S + 2; ++c) mag[g][c] = mag[B + g][c];
      dirs[g] = dirs[B + g];
    }
  }
}

// A persistent 1-D grid; warp u of the grid takes units u, u + warps, ...
// (as gradient_window's); low and high are int32 on the card.
template <class T0, class T1, int S>
__global__ void __launch_bounds__(GRAD_THREADS, MIN_WINDOW_BLOCKS)
    canny_window(const uint8_t* __restrict__ in_all, uint8_t* __restrict__ plane_all, const int* __restrict__ low_p,
                 const int* __restrict__ high_p, int h, int w, int col_bands, int row_bands, int band, long long units,
                 bool vec) {
  constexpr int R = T0::size / 2;
  __shared__ __align__(16) uint8_t slots[GRAD_WARPS][ring_slots(CANNY_ROWS + AHEAD) * (32 * S + 32)];
  const int low = __ldg(low_p), high = __ldg(high_p);
  const long long hw = static_cast<long long>(h) * w;
  const long long per_frame = static_cast<long long>(col_bands) * row_bands;
  const long long warps = static_cast<long long>(gridDim.x) * GRAD_WARPS;
  const int lane = threadIdx.x % 32;
  for (long long u = static_cast<long long>(blockIdx.x) * GRAD_WARPS + threadIdx.x / 32; u < units; u += warps) {
    const long long f = u / per_frame;
    const int rest = static_cast<int>(u - f * per_frame);
    const int rb = rest / col_bands, cb = rest - rb * col_bands;
    const int y0 = rb * band, x0 = cb * 32 * S;
    const int rows = min(band, h - y0);
    // the window, its ring of R + 1 rows and a word of columns inside the frame
    const bool interior = vec && x0 >= 4 && x0 + 32 * S + 4 <= w && y0 >= R + 1 && y0 + band + R + 1 <= h;
    uint8_t* ring = slots[threadIdx.x / 32];
    if (interior)
      canny_strip<T0, T1, S, true>(in_all + f * hw, plane_all + f * hw, h, w, y0, x0, x0 + lane * S, rows, vec, low,
                                      high, ring);
    else
      canny_strip<T0, T1, S, false>(in_all + f * hw, plane_all + f * hw, h, w, y0, x0, x0 + lane * S, rows, vec,
                                       low, high, ring);
  }
}

// Launch the instance for (t0, t1) if it is this one; false if not.
template <class T0, class T1, int S>
bool try_canny(const int* t0, const int* t1, int k, const uint8_t* in, uint8_t* plane, const int* low,
               const int* high, int n, int h, int w, cudaStream_t stream, cudaError_t& err) {
  if (!same_taps<T0>(t0, k) || !same_taps<T1>(t1, k)) return false;
  const auto kernel = canny_window<T0, T1, S>;
  static int resident = 0;
  UnitPlan plan;
  if (!plan_units<GRAD_WARPS, MIN_BAND>(kernel, resident, n, h, w, 32 * S, units_a_warp(T0::size), plan, err))
    return true;
  const bool vec = reinterpret_cast<uintptr_t>(in) % 16 == 0 && reinterpret_cast<uintptr_t>(plane) % 16 == 0 &&
                   w % 16 == 0;
  kernel<<<plan.blocks, GRAD_THREADS, 0, stream>>>(in, plane, low, high, h, w, plan.col_bands, plan.row_bands,
                                                   plan.band, plan.units, vec);
  err = cudaGetLastError();
  return true;
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
  const auto* src = static_cast<const uint8_t*>(in);
  auto* dst = static_cast<uint8_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  if (try_window<SOBEL, Centre3, Deriv3, 8>(kind, t0, t1, k, src, dst, n, h, w, s, err) ||
      try_window<SOBEL, Smooth3, Deriv3, 8>(kind, t0, t1, k, src, dst, n, h, w, s, err) ||
      try_window<SOBEL, Smooth5, Deriv5, 8>(kind, t0, t1, k, src, dst, n, h, w, s, err) ||
      try_window<SOBEL, Smooth7, Deriv7, 8>(kind, t0, t1, k, src, dst, n, h, w, s, err) ||
      try_window<PREWITT, Box3, Diff3, 8>(kind, t0, t1, k, src, dst, n, h, w, s, err) ||
      try_window<LAPLACIAN, Centre3, Second3, 8>(kind, t0, t1, k, src, dst, n, h, w, s, err) ||
      try_window<LAPLACIAN, Smooth3, Second3, 8>(kind, t0, t1, k, src, dst, n, h, w, s, err) ||
      try_window<LAPLACIAN, Smooth5, Second5, 8>(kind, t0, t1, k, src, dst, n, h, w, s, err) ||
      try_window<LAPLACIAN, Smooth7, Second7, 8>(kind, t0, t1, k, src, dst, n, h, w, s, err))
    return static_cast<int>(err);
  const Taps taps = taps_from(t0, t1, k);
  const int tiles_x = (w + TILE - 1) / TILE;
  const int tiles = (h + TILE - 1) / TILE * tiles_x;
  const size_t shared = gradient_shared(k);
  const long long hw = static_cast<long long>(h) * w;
  for (int first = 0; first < n; first += MAX_FRAMES) {
    const int frames = n - first < MAX_FRAMES ? n - first : MAX_FRAMES;
    gradient_tile<<<dim3(tiles, frames), THREADS, shared, s>>>(src + first * hw, dst + first * hw, h, w, tiles_x, k,
                                                               kind, taps);
  }
  return static_cast<int>(cudaGetLastError());
}

// in, plane: (n, h, w) uint8 on the card; low, high: one int32 each on the
// card; t0, t1: the aperture's smooth and derivative taps (host ints), a
// compiled pair (deriv_taps(0, k), deriv_taps(1, k) at k = 3, 5, 7).
extern "C" int yam_canny_candidates_u8(const void* in, void* plane, const void* low, const void* high,
                                       const int* t0, const int* t1, int k, int n, int h, int w, void* stream) {
  if (h <= 0 || w <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto* src = static_cast<const uint8_t*>(in);
  auto* dst = static_cast<uint8_t*>(plane);
  const auto* lo = static_cast<const int*>(low);
  const auto* hi = static_cast<const int*>(high);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  if (try_canny<Smooth3, Deriv3, 8>(t0, t1, k, src, dst, lo, hi, n, h, w, s, err) ||
      try_canny<Smooth5, Deriv5, 4>(t0, t1, k, src, dst, lo, hi, n, h, w, s, err) ||
      try_canny<Smooth7, Deriv7, 4>(t0, t1, k, src, dst, lo, hi, n, h, w, s, err))
    return static_cast<int>(err);
  return static_cast<int>(cudaErrorInvalidValue);
}
