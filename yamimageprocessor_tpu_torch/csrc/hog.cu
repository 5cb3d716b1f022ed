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
// the order LLVM vectorised XLA's reduce loop (ops/hogf.py:cell_order),
// then multiplies by float32(1 / (side * side)).  Every operation is an
// explicit round-to-nearest intrinsic: nothing is contracted that XLA did
// not contract.
//
// Bound on the card: operations, a pixel's formulas (atan2f's two IEEE
// divisions and its 11-term polynomial, the hypot's division and root),
// against a byte a pixel read and a float a bin a cell written; at 32 bins
// on 2 x 2 cells the output (32 floats a cell) makes it bytes.
//
// Design.  A block takes a tile of whole cells, cc cells a row and cr rows
// of them (tile_plan: about TILE_COLS columns and TILE_PIXELS pixels), in
// three phases, with nothing computed twice:
//
// 1. stage: the tile's rows plus a one-pixel halo go into shared memory as
//    float32, 16-byte loads where a row's chunk is aligned, single elements
//    at its two ends;
// 2. pixels: neighbouring threads take neighbouring columns; each forms its
//    pixel's magnitude and bin once, with one division in atanf (the
//    reduction's quotient chosen by selects, not branches), and writes them
//    to shared memory (a float and a byte);
// 3. sums: a thread per (cell, bin).  A bin's sum depends only on that
//    bin's own additions in their order (a pixel of another bin adds +0,
//    and no running sum is -0 where it meets one: see ops/hogf.py), so a
//    thread walks its cell in cell_order's order and adds the magnitudes
//    of its bin only:
//    - LANES (2, 4, 8; a template on the side): the row sums, then the
//      rows added as halves (4, 2, 1);
//    - VECTOR (9 to 32): row by row, vf lane sums from the running sum
//      (lane 0) or -0 over the columns below main_cols, added as halves,
//      then two lanes over the next pair_cols columns, then the tail;
//    - WINDOWS (1, 3, 5, 6, 7, above 32, and the scalar loops): the 32 x
//      32 windows, with window_pairs and window_peel.
//    Consecutive threads take consecutive bins of consecutive cells of a
//    cell row, whose outputs are consecutive floats: a warp stores 32 of
//    them, 128 contiguous bytes.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int TILE_COLS = 128;    // a tile's cells span at most this many columns (one cell at the least)
constexpr int TILE_PIXELS = 4096;  // and at most this many pixels (one row of cells at the least)
constexpr int VECTOR_BYTES = 16;   // a staging load
constexpr int STAGE_BATCH = 4;     // staging loads a thread has in flight
constexpr int MAX_BINS = 32;
constexpr int MAX_SIDE = 64;
constexpr int WINDOWS = 0, LANES = 1, VECTOR = 2;
constexpr int WINDOW = 32;

__device__ __forceinline__ float f32(unsigned bits) { return __uint_as_float(bits); }

// glibc's atanf of x >= 0 (x may be inf or NaN where the caller discards
// the result).  The band's quotient is formed with the library's own
// operations for each band, selected, so a warp runs one division.
__device__ __forceinline__ float atanf_glibc(float x) {
  const int ix = __float_as_int(x);
  const int id = ix < 0x3ee00000 ? -1 : ix < 0x3f300000 ? 0 : ix < 0x3f980000 ? 1 : ix < 0x401c0000 ? 2 : 3;
  // id 0: (2x - 1) / (2 + x); 1: (x - 1) / (x + 1); 2: (x - 1.5) / (1 + 1.5x); 3: -1 / x
  const float num = id == 3 ? -1.0f : __fsub_rn(id == 0 ? __fmul_rn(2.0f, x) : x, id == 2 ? 1.5f : 1.0f);
  const float den = id == 3 ? x : id == 2 ? __fadd_rn(1.0f, __fmul_rn(1.5f, x)) : __fadd_rn(id == 0 ? 2.0f : 1.0f, x);
  const float quotient = __fdiv_rn(num, den);
  const float xx = id < 0 ? x : quotient;
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
  // atan(0.5), atan(1), atan(1.5), atan(inf) as hi + lo
  const unsigned hi = id == 0 ? 0x3eed6338u : id == 1 ? 0x3f490fdau : id == 2 ? 0x3f7b985eu : 0x3fc90fdau;
  const unsigned lo = id == 0 ? 0x31ac3769u : id == 1 ? 0x33222168u : id == 2 ? 0x33140fb4u : 0x33a22168u;
  float r = id < 0 ? __fsub_rn(xx, t) : __fsub_rn(f32(hi), __fsub_rn(__fsub_rn(t, f32(lo)), xx));
  if (ix < 0x31000000) r = x;
  if (ix >= 0x4c000000) r = __fadd_rn(f32(0x3fc90fdau), f32(0x33a22168u));
  return r;
}

// glibc's atan2f of finite operands, its special cases as selects
__device__ __forceinline__ float atan2f_glibc(float y, float x) {
  const float pi = f32(0x40490fdbu), pi_lo = f32(0xb3bbbd2eu), pi_o_2 = f32(0x3fc90fdbu);
  const int hx = __float_as_int(x), hy = __float_as_int(y);
  const int ix = hx & 0x7fffffff, iy = hy & 0x7fffffff;
  const int m = ((hy >> 31) & 1) | ((hx >> 30) & 2);
  const int k = (iy - ix) >> 23;
  const float za = atanf_glibc(fabsf(__fdiv_rn(y, x)));
  const float z = k > 60 ? __fadd_rn(pi_o_2, __fmul_rn(0.5f, pi_lo)) : (hx < 0 && k < -60) ? 0.0f : za;
  // m 0: z, 1: -z, 2: pi - (z - pi_lo), 3: (z - pi_lo) - pi; a - b is exactly -(b - a)
  const float base = m & 2 ? -__fsub_rn(__fsub_rn(z, pi_lo), pi) : z;
  float r = m & 1 ? -base : base;
  if (ix == 0) r = hy < 0 ? -pi_o_2 : pi_o_2;
  if (iy == 0) r = m < 2 ? y : (m == 2 ? pi : -pi);
  return r;
}

// jnp.remainder(deg, 180) for |deg| < 360: fmodf's value, without its
// software loop.  Below 180 in magnitude fmodf returns deg itself; from 180
// up to 360 it returns |deg| - 180 (exact: Sterbenz) with deg's sign, so
// +-180 give +-0.  The angle is at most float32(pi) in magnitude and
// float32(pi) * float32(180 / pi) rounds to 180.0, so |deg| <= 180 here.
__device__ __forceinline__ float remainder180(float deg) {
  return fabsf(deg) < 180.0f ? deg : copysignf(__fsub_rn(fabsf(deg), 180.0f), deg);
}

// magnitude and bin of the pixel at `at` in the staged tile (pitch floats a
// row), at (y, x) in the frame
__device__ __forceinline__ void pixel(const float* __restrict__ at, int pitch, int h, int w, int y, int x, int nb,
                                      float recip_bw, float& mag, int& bin) {
  float gr = 0.0f, gc = 0.0f;
  if (y >= 1 && y <= h - 2) gr = __fsub_rn(at[pitch], at[-pitch]);
  if (x >= 1 && x <= w - 2) gc = __fsub_rn(at[1], at[-1]);
  const float a = fabsf(gr), b = fabsf(gc);
  const float hi = fmaxf(a, b), lo = fminf(a, b);
  const float r = __fdiv_rn(lo, hi == 0.0f ? 1.0f : hi);
  mag = hi == 0.0f ? hi : __fmul_rn(hi, __fsqrt_rn(__fmaf_rn(r, r, 1.0f)));
  const float rem = remainder180(__fmul_rn(atan2f_glibc(gr, gc), f32(0x42652ee1u)));
  const float ori = rem < 0.0f ? __fadd_rn(rem, 180.0f) : rem;
  const int q = static_cast<int>(__fmul_rn(ori, recip_bw));
  bin = q < 0 ? 0 : (q > nb - 1 ? nb - 1 : q);
}

// A flat range walked by a stride: (row, col) of index start + k * stride
// in rows of `cols`, stepped without a division.
struct Walk {
  int row, col, drow, dcol, cols;
  __device__ Walk(int start, int stride, int n_cols)
      : row(start / n_cols), col(start % n_cols), drow(stride / n_cols), dcol(stride % n_cols), cols(n_cols) {}
  __device__ void step() {
    col += dcol;
    row += drow;
    if (col >= cols) {
      col -= cols;
      ++row;
    }
  }
};

struct Plan {
  int nb, side, vf, main_cols, pair_cols, peel, window_pairs;
  float recip_bw, recip_area;
  int cc, cr, tiles_x;
};

// One task's sum: bin b of the cell whose pixels start at mag / bins (pitch
// floats a row), in cell_order's order, the magnitudes of other bins left out.
template <int ORDER, int SIDE>
__device__ __forceinline__ float cell_sum(const float* __restrict__ mag, const uint8_t* __restrict__ bins, int pitch,
                                          int b, const Plan& p) {
  const int side = SIDE ? SIDE : p.side;
  if constexpr (ORDER == LANES) {
    float rs[SIDE ? SIDE : 8];
#pragma unroll
    for (int r = 0; r < SIDE; ++r) {
      rs[r] = 0.0f;
#pragma unroll
      for (int c = 0; c < SIDE; ++c)
        if (bins[r * pitch + c] == b) rs[r] = __fadd_rn(rs[r], mag[r * pitch + c]);
    }
#pragma unroll
    for (int half = SIDE / 2; half >= 1; half /= 2) {
#pragma unroll
      for (int r = 0; r < half; ++r) rs[r] = __fadd_rn(rs[r], rs[r + half]);
    }
    return rs[0];
  } else if constexpr (ORDER == VECTOR) {
    const int vf = p.vf, main_cols = p.main_cols, tail = p.main_cols + p.pair_cols;
    float total = 0.0f;
    for (int r = 0; r < side; ++r) {
      const float* mrow = mag + r * pitch;
      const uint8_t* brow = bins + r * pitch;
      float v[8];
      v[0] = total;
#pragma unroll
      for (int l = 1; l < 8; ++l) v[l] = -0.0f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
#pragma unroll
        for (int l = 0; l < 8; ++l) {
          const int c = k * vf + l;
          if (l < vf && c < main_cols && brow[c] == b) v[l] = __fadd_rn(v[l], mrow[c]);
        }
      }
      if (vf == 8) {
#pragma unroll
        for (int l = 0; l < 4; ++l) v[l] = __fadd_rn(v[l], v[l + 4]);
      }
      v[0] = __fadd_rn(v[0], v[2]);
      v[1] = __fadd_rn(v[1], v[3]);
      total = __fadd_rn(v[0], v[1]);
      if (p.pair_cols > 0) {
        float e0 = total, e1 = -0.0f;
        for (int c = main_cols; c < tail; c += 2) {
          if (brow[c] == b) e0 = __fadd_rn(e0, mrow[c]);
          if (brow[c + 1] == b) e1 = __fadd_rn(e1, mrow[c + 1]);
        }
        total = __fadd_rn(e0, e1);
      }
      for (int c = tail; c < side; ++c)
        if (brow[c] == b) total = __fadd_rn(total, mrow[c]);
    }
    return total;
  } else {
    const int padded = WINDOW * ((side + WINDOW - 1) / WINDOW), lo = (padded - side) / 2;
    const bool paired = p.window_pairs && padded == 2 * WINDOW;
    float acc = 0.0f, top = 0.0f;  // top: w00 + w01, kept apart when the windows are added as pairs
    for (int wr = 0; wr < padded / WINDOW; ++wr) {
      const int r0 = max(0, WINDOW * wr - lo), r1 = min(side, WINDOW * (wr + 1) - lo);
      for (int wc = 0; wc < padded / WINDOW; ++wc) {
        const int c0 = max(0, WINDOW * wc - lo), c1 = min(side, WINDOW * (wc + 1) - lo);
        const int split = p.peel && c1 - c0 == WINDOW ? c1 - 1 : c1;  // columns from split on come last
        float win = 0.0f;
        for (int r = r0; r < r1; ++r)
          for (int c = c0; c < split; ++c)
            if (bins[r * pitch + c] == b) win = __fadd_rn(win, mag[r * pitch + c]);
        for (int c = split; c < c1; ++c)
          for (int r = r0; r < r1; ++r)
            if (bins[r * pitch + c] == b) win = __fadd_rn(win, mag[r * pitch + c]);
        acc = __fadd_rn(acc, win);
      }
      if (paired && wr == 0) {
        top = acc;
        acc = 0.0f;
      }
    }
    return paired ? __fadd_rn(top, acc) : acc;
  }
}

// One element's bits in a word, and its float32 value from them.
template <typename T>
__device__ __forceinline__ unsigned bits_of(const T* at) {
  if constexpr (sizeof(T) == 4)
    return __float_as_uint(__ldg(at));
  else
    return static_cast<unsigned>(__ldg(at));
}

template <typename T>
__device__ __forceinline__ float element(unsigned bits) {
  if constexpr (sizeof(T) == 4)
    return __uint_as_float(bits);
  else
    return static_cast<float>(bits);
}

// Stage rows y0 - 1 .. y0 + rows and columns x0 - 1 .. x0 + cols of the
// frame (those inside it) as float32 at tile[(y - y0 + 1) * pitch + (x - x0
// + 1)]: a row's aligned 16-byte chunks as vectors, the elements before the
// first and after the last one by one.  The items of a row (head elements,
// chunks, tail elements) are at most `items`; a flat range over (row, item)
// keeps every lane busy, and a thread issues STAGE_BATCH loads before it
// stores any, so a block waits for device memory about once, not once an
// item.
template <typename T>
__device__ __forceinline__ void stage(const T* __restrict__ img, float* __restrict__ tile, int pitch, int h, int w,
                                      int y0, int x0, int rows, int cols) {
  constexpr int V = VECTOR_BYTES / static_cast<int>(sizeof(T));
  const int xa = max(0, x0 - 1), xb = min(w, x0 + cols + 1);
  const int items = (xb - xa) / V + 2 * (V - 1) + 1;
  Walk k(threadIdx.x, THREADS, items);
  while (k.row < rows + 2) {
    uint4 v[STAGE_BATCH];
    int at[STAGE_BATCH], count[STAGE_BATCH];  // where the item goes in the tile; its elements (0: nothing)
#pragma unroll
    for (int q = 0; q < STAGE_BATCH; ++q) {
      count[q] = 0;
      const int y = y0 - 1 + k.row;
      if (k.row < rows + 2 && y >= 0 && y < h) {
        const T* row = img + static_cast<long long>(y) * w;
        const int misalign = static_cast<int>(reinterpret_cast<uintptr_t>(row + xa) % VECTOR_BYTES);
        const int head = min(misalign ? (VECTOR_BYTES - misalign) / static_cast<int>(sizeof(T)) : 0, xb - xa);
        const int chunks = (xb - xa - head) / V;
        const int item = k.col - head;
        int x;
        if (item < 0) {
          x = xa + k.col;
          count[q] = 1;
        } else if (item < chunks) {
          x = xa + head + item * V;
          count[q] = V;
        } else {
          x = xa + head + chunks * V + (item - chunks);
          count[q] = x < xb;
        }
        if (count[q] == V)
          v[q] = __ldg(reinterpret_cast<const uint4*>(row + x));
        else if (count[q])
          v[q].x = bits_of(row + x);
        at[q] = k.row * pitch + 1 + x - x0;
      }
      k.step();
    }
#pragma unroll
    for (int q = 0; q < STAGE_BATCH; ++q) {
      if (count[q] == V) {
        const T* e = reinterpret_cast<const T*>(&v[q]);
#pragma unroll
        for (int j = 0; j < V; ++j) tile[at[q] + j] = static_cast<float>(e[j]);
      } else if (count[q]) {
        tile[at[q]] = element<T>(v[q].x);
      }
    }
  }
}

template <int ORDER, int SIDE, typename T>
__global__ void __launch_bounds__(THREADS)
hog_cells_kernel(const T* __restrict__ src, float* __restrict__ out, int h, int w, const Plan p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int side = SIDE ? SIDE : p.side;
  const int ncr = h / side, ncc = w / side;
  const int tile_cols = p.cc * side, tile_rows = p.cr * side;
  const int in_pitch = tile_cols + 2;
  float* tile = reinterpret_cast<float*>(smem);
  float* mag = tile + (tile_rows + 2) * in_pitch;
  uint8_t* bins = reinterpret_cast<uint8_t*>(mag + tile_rows * tile_cols);
  const int cell_r0 = (blockIdx.x / p.tiles_x) * p.cr, cell_c0 = (blockIdx.x % p.tiles_x) * p.cc;
  const int vr = min(p.cr, ncr - cell_r0), vc = min(p.cc, ncc - cell_c0);  // the tile's cells in the grid
  const int y0 = cell_r0 * side, x0 = cell_c0 * side, rows = vr * side, cols = vc * side;
  const T* img = src + static_cast<long long>(blockIdx.y) * h * w;

  stage(img, tile, in_pitch, h, w, y0, x0, rows, cols);
  __syncthreads();
  for (Walk k(threadIdx.x, THREADS, cols); k.row < rows; k.step()) {
    float m;
    int bin;
    pixel(tile + (k.row + 1) * in_pitch + k.col + 1, in_pitch, h, w, y0 + k.row, x0 + k.col, p.nb, p.recip_bw, m,
          bin);
    mag[k.row * tile_cols + k.col] = m;
    bins[k.row * tile_cols + k.col] = static_cast<uint8_t>(bin);
  }
  __syncthreads();
  // tasks (cell row qr, cell qc, bin b), b fastest: a step of THREADS adds
  // sb to b, sc to qc and sr to qr, with carries
  const int start = threadIdx.x, nb = p.nb;
  int b = start % nb, qc = (start / nb) % vc, qr = start / (nb * vc);
  const int sb = THREADS % nb, sc = (THREADS / nb) % vc, sr = THREADS / (nb * vc);
  float* o = out + static_cast<long long>(blockIdx.y) * ncr * ncc * nb;
  while (qr < vr) {
    const int at = qr * side * tile_cols + qc * side;
    const float sum = cell_sum<ORDER, SIDE>(mag + at, bins + at, tile_cols, b, p);
    o[(static_cast<long long>(cell_r0 + qr) * ncc + cell_c0 + qc) * nb + b] = __fmul_rn(sum, p.recip_area);
    b += sb;
    const int carry = b >= nb;
    b -= carry ? nb : 0;
    qc += sc + carry;
    const int carry2 = qc >= vc;
    qc -= carry2 ? vc : 0;
    qr += sr + carry2;
  }
}

// cells a tile row and rows of cells a tile
void tile_plan(int side, int ncr, int ncc, int* cc, int* cr) {
  const int cols = TILE_COLS / side < ncc ? TILE_COLS / side : ncc;
  *cc = cols > 1 ? cols : 1;
  const int rows = TILE_PIXELS / (side * side * *cc) < ncr ? TILE_PIXELS / (side * side * *cc) : ncr;
  *cr = rows > 1 ? rows : 1;
}

size_t tile_bytes(int side, int cc, int cr) {
  const size_t rows = static_cast<size_t>(cr) * side, cols = static_cast<size_t>(cc) * side;
  return (rows + 2) * (cols + 2) * sizeof(float) + rows * cols * (sizeof(float) + 1);
}

template <int ORDER, int SIDE, typename T>
cudaError_t hog_instance(const void* src, float* out, int h, int w, const Plan& p, dim3 grid, size_t bytes,
                         cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(hog_cells_kernel<ORDER, SIDE, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  hog_cells_kernel<ORDER, SIDE, T><<<grid, THREADS, bytes, s>>>(static_cast<const T*>(src), out, h, w, p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t hog_launch(const void* src, float* out, int h, int w, int order, const Plan& p, dim3 grid, size_t bytes,
                       cudaStream_t s) {
  if (order == WINDOWS) return hog_instance<WINDOWS, 0, T>(src, out, h, w, p, grid, bytes, s);
  if (order == VECTOR) return hog_instance<VECTOR, 0, T>(src, out, h, w, p, grid, bytes, s);
  if (p.side == 2) return hog_instance<LANES, 2, T>(src, out, h, w, p, grid, bytes, s);
  if (p.side == 4) return hog_instance<LANES, 4, T>(src, out, h, w, p, grid, bytes, s);
  return hog_instance<LANES, 8, T>(src, out, h, w, p, grid, bytes, s);
}

}  // namespace

// src: (n, h, w) of kind 0 uint8, 1 uint16 or 2 float32; out: (n, h / side,
// w / side, nb) float32.  order: 0 windows (peel 0 or 1), 1 lanes (side 2, 4
// or 8), 2 vector (side 9 to 32: vf 4 or 8, main_cols in at most 4 vectors,
// pair_cols even and at most 6, at most 7 columns after them).  peel and
// window_pairs (0 or 1) shape the windows order.  side 1 to 64, nb 1 to 32,
// n at most 65535 (gridDim.y).
extern "C" int yam_hog_cells(const void* src, void* out, int n, int h, int w, int nb, int side, int order, int vf,
                             int main_cols, int pair_cols, int peel, int window_pairs, float recip_bw,
                             float recip_area, int kind, void* stream) {
  const bool vector_ok = (vf == 4 || vf == 8) && side >= 9 && side <= WINDOW && main_cols >= 1 &&
                         main_cols <= side && (main_cols + vf - 1) / vf <= 4 && pair_cols >= 0 &&
                         pair_cols <= 6 && pair_cols % 2 == 0 && main_cols + pair_cols <= side &&
                         side - main_cols - pair_cols <= 7;
  if (n < 1 || n > 65535 || nb < 1 || nb > MAX_BINS || side < 1 || side > MAX_SIDE || h < side || w < side ||
      kind < 0 || kind > 2 || (order == LANES && side != 2 && side != 4 && side != 8) ||
      (order == VECTOR && !vector_ok) ||
      (order == WINDOWS && (peel < 0 || peel > 1 || window_pairs < 0 || window_pairs > 1)) || order < WINDOWS ||
      order > VECTOR)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ncr = h / side, ncc = w / side;
  int cc, cr;
  tile_plan(side, ncr, ncc, &cc, &cr);
  const int tiles_x = (ncc + cc - 1) / cc, tiles_y = (ncr + cr - 1) / cr;
  if (static_cast<long long>(tiles_x) * tiles_y >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const Plan plan{nb, side, vf, main_cols, pair_cols, peel, window_pairs, recip_bw, recip_area, cc, cr, tiles_x};
  const dim3 grid(static_cast<unsigned>(tiles_x * tiles_y), n);
  const size_t bytes = tile_bytes(side, cc, cr);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  cudaError_t err;
  if (kind == 0)
    err = hog_launch<uint8_t>(src, o, h, w, order, plan, grid, bytes, s);
  else if (kind == 1)
    err = hog_launch<uint16_t>(src, o, h, w, order, plan, grid, bytes, s);
  else
    err = hog_launch<float>(src, o, h, w, order, plan, grid, bytes, s);
  return static_cast<int>(err);
}
