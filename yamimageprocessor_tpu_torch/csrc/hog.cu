// HOG cell histograms of uint8, uint16 or float32 frames (the element type a
// template parameter: every value is exact in float32, so the arithmetic
// after the load is the same), bit for bit as the JAX package's chain
// computes them on XLA's CPU backend.
//
// Replaces no pallas_call: yamimageprocessor_tpu/ops/hogf.py
// hog_features_j's gradient-to-cell part (lines 89-110, XLA code).  For
// every pixel of the cropped cell grid: zero-border central differences in
// float32; the magnitude as jnp.hypot lowers, m * sqrt(fma(r, r, 1)) with
// m = max(|a|, |b|), r = min / m; the angle from glibc's atan2f (the fdlibm
// polynomial the XLA code calls; constants as the library stores them),
// times float32(180 / pi), jnp.remainder by 180 (fmod, + 180 below 0), and
// the bin trunc(ori * float32(1 / bin_width)) clamped (XLA multiplies by
// the reciprocal of a constant divisor).  Each cell sums its pixels' bins in
// the order LLVM vectorised XLA's reduce loop (ops/hogf.py:cell_order):
//
// - WINDOWS (sides 3, 5, 6, 7 and above 32): one thread a cell.  XLA splits
//   a reduce longer than 32 into 32 x 32 windows, the padding split low
//   (lo = (P - side) / 2, P the side rounded up to 32) and high; each window
//   is a row-major sum from zero over its pixels in the frame, and the
//   windows are added in row-major order from zero, or with window_pairs
//   (a power-of-two bin count) the 2 x 2 of them as (w00 + w01) + (w10 +
//   w11); one window, a row-major sum, at the small sides.  With peel (side
//   63) a window of 32 columns adds its last column after the others, row
//   by row;
// - LANES (2, 4, 8): eight threads a cell, thread r sums row r along its
//   columns, then the rows are added as halves by xor shuffles (4, 2, 1);
// - VECTOR (9 to 32): eight threads a cell, row by row (ops/hogf.py:
//   vector_plan): thread l < vf sums the columns l, l + vf, ... below
//   main_cols onto the running sum (thread 0) or -0, the vf partial sums
//   are added as halves; then two threads add the next pair_cols columns
//   two at a time and are added; then the remaining columns one by one.
//
// then multiplies by float32(1 / (side * side)).  Every operation is an
// explicit round-to-nearest intrinsic: nothing is contracted that XLA did
// not contract.
//
// Bound on the card: bytes (the frame read once, the histograms written
// once) against about 150 instructions a pixel (the polynomial, two
// divisions, the square root, a register a bin): operations bound it.
// Design (simple first): the frame is read through the cache (each pixel
// and its four neighbours), the bins are registers (nb <= 32, the loops
// unrolled), the groups' lanes meet through warp shuffles; nothing is
// staged in shared memory.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BINS = 32;
constexpr int WINDOWS = 0, LANES = 1, VECTOR = 2;
constexpr int WINDOW = 32;

__device__ __forceinline__ float f32(unsigned bits) { return __uint_as_float(bits); }

// glibc's atanf of a finite x >= 0
__device__ float atanf_glibc(float x) {
  const int ix = __float_as_int(x);
  if (ix >= 0x4c000000) return __fadd_rn(f32(0x3fc90fdau), f32(0x33a22168u));
  if (ix < 0x31000000) return x;
  int id;
  float xx;
  if (ix < 0x3ee00000) {
    id = -1;
    xx = x;
  } else if (ix < 0x3f300000) {
    id = 0;
    xx = __fdiv_rn(__fsub_rn(__fmul_rn(2.0f, x), 1.0f), __fadd_rn(2.0f, x));
  } else if (ix < 0x3f980000) {
    id = 1;
    xx = __fdiv_rn(__fsub_rn(x, 1.0f), __fadd_rn(x, 1.0f));
  } else if (ix < 0x401c0000) {
    id = 2;
    xx = __fdiv_rn(__fsub_rn(x, 1.5f), __fadd_rn(1.0f, __fmul_rn(1.5f, x)));
  } else {
    id = 3;
    xx = __fdiv_rn(-1.0f, x);
  }
  const float z = __fmul_rn(xx, xx), w = __fmul_rn(z, z);
  float s1 = __fadd_rn(f32(0x3d4bda59u), __fmul_rn(w, f32(0x3c8569d7u)));  // aT8 + w aT10
  s1 = __fadd_rn(f32(0x3d886b35u), __fmul_rn(w, s1));                      // aT6
  s1 = __fadd_rn(f32(0x3dba2e6eu), __fmul_rn(w, s1));                      // aT4
  s1 = __fadd_rn(f32(0x3e124925u), __fmul_rn(w, s1));                      // aT2
  s1 = __fadd_rn(f32(0x3eaaaaabu), __fmul_rn(w, s1));                      // aT0
  s1 = __fmul_rn(z, s1);
  float s2 = __fadd_rn(f32(0xbd6ef16bu), __fmul_rn(w, f32(0xbd15a221u)));  // aT7 + w aT9
  s2 = __fadd_rn(f32(0xbd9d8795u), __fmul_rn(w, s2));                      // aT5
  s2 = __fadd_rn(f32(0xbde38e38u), __fmul_rn(w, s2));                      // aT3
  s2 = __fadd_rn(f32(0xbe4ccccdu), __fmul_rn(w, s2));                      // aT1
  s2 = __fmul_rn(w, s2);
  const float t = __fmul_rn(xx, __fadd_rn(s1, s2));
  if (id < 0) return __fsub_rn(xx, t);
  // atan(0.5), atan(1), atan(1.5), atan(inf) as hi + lo (selects, not an indexed array)
  const unsigned hi = id == 0 ? 0x3eed6338u : id == 1 ? 0x3f490fdau : id == 2 ? 0x3f7b985eu : 0x3fc90fdau;
  const unsigned lo = id == 0 ? 0x31ac3769u : id == 1 ? 0x33222168u : id == 2 ? 0x33140fb4u : 0x33a22168u;
  return __fsub_rn(f32(hi), __fsub_rn(__fsub_rn(t, f32(lo)), xx));
}

// glibc's atan2f of finite operands
__device__ float atan2f_glibc(float y, float x) {
  const float pi = f32(0x40490fdbu), pi_lo = f32(0xb3bbbd2eu), pi_o_2 = f32(0x3fc90fdbu);
  const int hx = __float_as_int(x), hy = __float_as_int(y);
  const int ix = hx & 0x7fffffff, iy = hy & 0x7fffffff;
  const int m = ((hy >> 31) & 1) | ((hx >> 30) & 2);
  if (iy == 0) return m < 2 ? y : (m == 2 ? pi : -pi);
  if (ix == 0) return hy < 0 ? -pi_o_2 : pi_o_2;
  const int k = (iy - ix) >> 23;
  float z;
  if (k > 60)
    z = __fadd_rn(pi_o_2, __fmul_rn(0.5f, pi_lo));
  else if (hx < 0 && k < -60)
    z = 0.0f;
  else
    z = atanf_glibc(fabsf(__fdiv_rn(y, x)));
  switch (m) {
    case 0: return z;
    case 1: return -z;
    case 2: return __fsub_rn(pi, __fsub_rn(z, pi_lo));
    default: return __fsub_rn(__fsub_rn(z, pi_lo), pi);
  }
}

// magnitude and bin of pixel (y, x)
template <typename T>
__device__ __forceinline__ void pixel(const T* __restrict__ img, int h, int w, int y, int x, int nb,
                                      float recip_bw, float& mag, int& bin) {
  float gr = 0.0f, gc = 0.0f;
  const long long at = static_cast<long long>(y) * w + x;
  if (y >= 1 && y <= h - 2)
    gr = __fsub_rn(static_cast<float>(__ldg(img + at + w)), static_cast<float>(__ldg(img + at - w)));
  if (x >= 1 && x <= w - 2)
    gc = __fsub_rn(static_cast<float>(__ldg(img + at + 1)), static_cast<float>(__ldg(img + at - 1)));
  const float a = fabsf(gr), b = fabsf(gc);
  const float hi = fmaxf(a, b), lo = fminf(a, b);
  if (hi == 0.0f) {
    mag = hi;
  } else {
    const float r = __fdiv_rn(lo, hi);
    mag = __fmul_rn(hi, __fsqrt_rn(__fmaf_rn(r, r, 1.0f)));
  }
  const float deg = __fmul_rn(atan2f_glibc(gr, gc), f32(0x42652ee1u));
  const float rem = fmodf(deg, 180.0f);
  const float ori = rem < 0.0f ? __fadd_rn(rem, 180.0f) : rem;
  int q = static_cast<int>(__fmul_rn(ori, recip_bw));
  bin = q < 0 ? 0 : (q > nb - 1 ? nb - 1 : q);
}

template <int ORDER, typename T>
__global__ void __launch_bounds__(THREADS)
hog_cells_kernel(const T* __restrict__ src, float* __restrict__ out, int h, int w, int nb, int side, int vf,
                 int main_cols, int pair_cols, int peel, int window_pairs, float recip_bw, float recip_area) {
  constexpr int G = ORDER == WINDOWS ? 1 : 8;  // threads a cell
  const int ncr = h / side, ncc = w / side;
  const long long cells = static_cast<long long>(ncr) * ncc;
  const long long cell = static_cast<long long>(blockIdx.x) * (THREADS / G) + threadIdx.x / G;
  const int lane = threadIdx.x % G;
  const bool valid = cell < cells;
  const T* img = src + static_cast<long long>(blockIdx.y) * h * w;
  const int cy = valid ? static_cast<int>(cell / ncc) * side : 0;
  const int cx = valid ? static_cast<int>(cell % ncc) * side : 0;
  float acc[MAX_BINS];
#pragma unroll
  for (int b = 0; b < MAX_BINS; ++b) acc[b] = 0.0f;
  if (ORDER == WINDOWS) {
    if (!valid) return;
    const int padded = WINDOW * ((side + WINDOW - 1) / WINDOW), lo = (padded - side) / 2;
    const bool paired = window_pairs && padded == 2 * WINDOW;
    float top[MAX_BINS];  // w00 + w01, kept apart when the windows are added as pairs
    for (int wr = 0; wr < padded / WINDOW; ++wr) {
      const int r0 = max(0, WINDOW * wr - lo), r1 = min(side, WINDOW * (wr + 1) - lo);
      for (int wc = 0; wc < padded / WINDOW; ++wc) {
        const int c0 = max(0, WINDOW * wc - lo), c1 = min(side, WINDOW * (wc + 1) - lo);
        const int split = peel && c1 - c0 == WINDOW ? c1 - 1 : c1;  // columns from split on come last
        float win[MAX_BINS];
#pragma unroll
        for (int b = 0; b < MAX_BINS; ++b) win[b] = 0.0f;
        for (int r = r0; r < r1; ++r) {
          for (int c = c0; c < split; ++c) {
            float mag;
            int bin;
            pixel(img, h, w, cy + r, cx + c, nb, recip_bw, mag, bin);
#pragma unroll
            for (int b = 0; b < MAX_BINS; ++b)
              if (b == bin) win[b] = __fadd_rn(win[b], mag);
          }
        }
        for (int c = split; c < c1; ++c) {
          for (int r = r0; r < r1; ++r) {
            float mag;
            int bin;
            pixel(img, h, w, cy + r, cx + c, nb, recip_bw, mag, bin);
#pragma unroll
            for (int b = 0; b < MAX_BINS; ++b)
              if (b == bin) win[b] = __fadd_rn(win[b], mag);
          }
        }
#pragma unroll
        for (int b = 0; b < MAX_BINS; ++b) acc[b] = __fadd_rn(acc[b], win[b]);
      }
      if (paired && wr == 0) {
#pragma unroll
        for (int b = 0; b < MAX_BINS; ++b) {
          top[b] = acc[b];
          acc[b] = 0.0f;
        }
      }
    }
    if (paired) {
#pragma unroll
      for (int b = 0; b < MAX_BINS; ++b) acc[b] = __fadd_rn(top[b], acc[b]);
    }
  } else if (ORDER == LANES) {
    if (valid && lane < side) {
      for (int c = 0; c < side; ++c) {
        float mag;
        int bin;
        pixel(img, h, w, cy + lane, cx + c, nb, recip_bw, mag, bin);
#pragma unroll
        for (int b = 0; b < MAX_BINS; ++b)
          if (b == bin) acc[b] = __fadd_rn(acc[b], mag);
      }
    }
#pragma unroll
    for (int b = 0; b < MAX_BINS; ++b) {
      if (b < nb) {  // nb is uniform: every lane shuffles
        float v = acc[b];
        for (int off = side / 2; off >= 1; off /= 2) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
        acc[b] = v;
      }
    }
  } else {
    // a masked lane adds +0 where XLA adds nothing: the same sum (the running sum is never -0)
    const int chunks = (main_cols + vf - 1) / vf;  // <= 4
    const int tail = main_cols + pair_cols;        // the columns from here on are added one by one
    const int leader = (threadIdx.x & 31) & ~(G - 1);
    for (int r = 0; r < side; ++r) {
      float mm[4], pm[3], tm[7];
      int mb[4], pb[3], tb[7];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        mm[k] = 0.0f;
        mb[k] = -1;
        const int c = lane + vf * k;
        if (valid && lane < vf && c < main_cols) pixel(img, h, w, cy + r, cx + c, nb, recip_bw, mm[k], mb[k]);
      }
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        pm[k] = 0.0f;
        pb[k] = -1;
        const int c = main_cols + lane + 2 * k;
        if (valid && lane < 2 && c < tail) pixel(img, h, w, cy + r, cx + c, nb, recip_bw, pm[k], pb[k]);
      }
#pragma unroll
      for (int k = 0; k < 7; ++k) {
        tm[k] = 0.0f;
        tb[k] = -1;
        if (valid && tail + k < side) pixel(img, h, w, cy + r, cx + tail + k, nb, recip_bw, tm[k], tb[k]);
      }
#pragma unroll
      for (int b = 0; b < MAX_BINS; ++b) {
        if (b < nb) {  // nb, vf, chunks and the column counts are uniform: every lane shuffles
          float v = lane == 0 ? acc[b] : -0.0f;
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (k < chunks) v = __fadd_rn(v, mb[k] == b ? mm[k] : 0.0f);
          for (int off = vf / 2; off >= 1; off /= 2) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
          float run = __shfl_sync(0xffffffffu, v, leader);
          if (pair_cols > 0) {
            float e = lane == 0 ? run : -0.0f;
#pragma unroll
            for (int k = 0; k < 3; ++k)
              if (2 * k < pair_cols) e = __fadd_rn(e, pb[k] == b ? pm[k] : 0.0f);
            e = __fadd_rn(e, __shfl_xor_sync(0xffffffffu, e, 1));
            run = __shfl_sync(0xffffffffu, e, leader);
          }
#pragma unroll
          for (int k = 0; k < 7; ++k)
            if (tail + k < side) run = __fadd_rn(run, tb[k] == b ? tm[k] : 0.0f);
          acc[b] = run;
        }
      }
    }
  }
  if (!valid || lane != 0) return;
  float* o = out + (static_cast<long long>(blockIdx.y) * cells + cell) * nb;
#pragma unroll
  for (int b = 0; b < MAX_BINS; ++b)
    if (b < nb) o[b] = __fmul_rn(acc[b], recip_area);
}

struct Plan {
  int nb, side, vf, main_cols, pair_cols, peel, window_pairs;
  float recip_bw, recip_area;
};

template <typename T>
void hog_launch(const void* src, float* out, long long blocks, int n, int h, int w, int order, const Plan& p,
                cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>(blocks), n);
  const T* in = static_cast<const T*>(src);
  if (order == WINDOWS)
    hog_cells_kernel<WINDOWS, T><<<grid, THREADS, 0, s>>>(in, out, h, w, p.nb, p.side, p.vf, p.main_cols,
                                                          p.pair_cols, p.peel, p.window_pairs, p.recip_bw, p.recip_area);
  else if (order == LANES)
    hog_cells_kernel<LANES, T><<<grid, THREADS, 0, s>>>(in, out, h, w, p.nb, p.side, p.vf, p.main_cols,
                                                        p.pair_cols, p.peel, p.window_pairs, p.recip_bw, p.recip_area);
  else
    hog_cells_kernel<VECTOR, T><<<grid, THREADS, 0, s>>>(in, out, h, w, p.nb, p.side, p.vf, p.main_cols,
                                                         p.pair_cols, p.peel, p.window_pairs, p.recip_bw, p.recip_area);
}

}  // namespace

// src: (n, h, w) of kind 0 uint8, 1 uint16 or 2 float32; out: (n, h / side,
// w / side, nb) float32.  order: 0 windows (peel 0 or 1), 1 lanes (side 2, 4
// or 8), 2 vector (side 9 to 32: vf 4 or 8, main_cols in at most 4 vectors,
// pair_cols even and at most 6, at most 7 columns after them).  peel and
// window_pairs (0 or 1) shape the windows order.  n is at most 65535
// (gridDim.y).
extern "C" int yam_hog_cells(const void* src, void* out, int n, int h, int w, int nb, int side, int order, int vf,
                             int main_cols, int pair_cols, int peel, int window_pairs, float recip_bw,
                             float recip_area, int kind, void* stream) {
  const bool vector_ok = (vf == 4 || vf == 8) && side >= 9 && side <= WINDOW && main_cols >= 1 &&
                         main_cols <= side && (main_cols + vf - 1) / vf <= 4 && pair_cols >= 0 &&
                         pair_cols <= 6 && pair_cols % 2 == 0 && main_cols + pair_cols <= side &&
                         side - main_cols - pair_cols <= 7;
  if (n < 1 || n > 65535 || nb < 1 || nb > MAX_BINS || side < 1 || h < side || w < side || kind < 0 || kind > 2 ||
      (order == LANES && side != 2 && side != 4 && side != 8) || (order == VECTOR && !vector_ok) ||
      (order == WINDOWS && (peel < 0 || peel > 1 || window_pairs < 0 || window_pairs > 1)) || order < WINDOWS ||
      order > VECTOR)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long cells = static_cast<long long>(h / side) * (w / side);
  const int per_block = order == WINDOWS ? THREADS : THREADS / 8;
  const long long blocks = (cells + per_block - 1) / per_block;
  if (blocks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const Plan plan{nb, side, vf, main_cols, pair_cols, peel, window_pairs, recip_bw, recip_area};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (kind == 0)
    hog_launch<uint8_t>(src, o, blocks, n, h, w, order, plan, s);
  else if (kind == 1)
    hog_launch<uint16_t>(src, o, blocks, n, h, w, order, plan, s);
  else
    hog_launch<float>(src, o, blocks, n, h, w, order, plan, s);
  return static_cast<int>(cudaGetLastError());
}
