// CLAHE on uint8 planes: the tile histograms and the bilinear table blend.
//
// tile_histogram: replaces yamimageprocessor_tpu/pallas_kernels.py
// histogram256_lane_grouped (pallas_call at line 457), which
// ops/clahe_pallas.py clahe_tile_histograms / clahe_tile_histograms_batch
// feed with every CLAHE grid tile of every frame after a transpose into a
// copy.  The TPU has no scatter, so the reference counts with carry-save
// bit-plane counters, groups 8 tiles into the lanes of one vector register
// and cuts the batch into chunks of 768 tiles for its scalar memory; none
// of that is carried over.  Here the grid is (tiles * parts, frames): each
// block reads its share of the rows of one tile in place, through the
// frame's strides (no transposed copy), counts into one 256-bin int32
// histogram per warp in shared memory with atomicAdd (warps do not contend
// with each other), then adds the warps' sums to the zeroed output with one
// global atomicAdd a bin.  A bin can hold a whole tile (a constant plane),
// so every counter is 32 bits; the wrapper refuses tiles of 2**31 pixels or
// more.  Counts are exact integers: any order of the atomics gives the
// reference's bits.
//
// clahe_blend: replaces yamimageprocessor_tpu/ops/clahe_pallas.py
// clahe_blend_pallas (pallas_call at line 137).  The TPU has no per-lane
// table read, so the reference packs the tables into words, picks each
// entry through a 63-select tree, and expands the row and column fractions
// into two full-frame weight maps.  Here a block is a band of BLEND_ROWS
// output rows by a span of BLEND_COLS columns of one frame.  The block
// stages the corner tables its band and span touch (tile rows y0 of its
// first row to y1 of its last, tile columns x0 of its first column to x1
// of its last, 256 bytes each: 2 KB on the bench's grid 4) and its rows'
// offsets and fractions in shared memory, so every table read is a
// shared-memory byte; each lane reads its 4 columns' x0, x1 and fx once
// and keeps them in registers over the band's rows.  A table read is a
// gather at the pixel's value, and a warp's lanes meet in few
// shared-memory words only while they read the same table, so a warp
// blends 128 consecutive columns, 4 a lane (16 a lane spread a warp over
// three tables and took longer than the kernel it replaced).  Rows move
// as 16-byte words where rows and pointers allow (4 rows of the warp's
// 128 columns at a time, through shared memory), else by bytes.  Bytes
// become floats and floats bytes by exact bit tricks, not by conversions.
// Where a grid's tables do not fit the block's shared memory (a grid
// thousands of tiles wide), a second instance of the same kernel reads
// them from global memory through the read-only cache; the wrapper picks
// it (ops/clahe.py:blend_table_bytes).
//
// The blend's order is the reference's as XLA's CPU backend runs clahe_j
// (ops/clahe.py:252-265): the weights are separate f32 products of
// separate differences, and the sum w00*t00 + w01*t01 + w10*t10 + w11*t11
// is contracted into three FMAs around the product w01*t01:
//   fma(w11, t11, fma(w10, t10, fma(w00, t00, w01 * t01)))
// Written with explicit intrinsics, so that nvcc's own contraction cannot
// pick another pairing.  Then rint (half to even), clip to 0..255, uint8.
// Tiles whose sides make every fraction dyadic (256-pixel tiles) cannot
// tell the orders apart; the tests use non-dyadic shapes.
//
// The stream instances (the streaming runtime's two passes over a frame
// cut into stream tiles, parallel/tiling.py):
//
// stream_grid_histogram: the stats pass, ops/clahe.py:grid_hist_stream
// (the reference's clahe_grid_hist_tile_j, yamimageprocessor_tpu/ops/
// clahe.py:408, which its streaming engine runs where the dense path runs
// histogram256_lane_grouped).  A stream tile lies anywhere in the frame,
// so its pixels fall in several grid cells, and the rows and columns that
// the dense path's reflect-101 grid padding copies count twice (a pixel
// whose row and column are both copied, four times).  The wrapper cuts
// each tile, from its origin and the frame's (h, w, grid), into work items
// that lie in one cell and carry one weight: a rectangle of the tile, the
// cell, the weight and the width of its loads.  A block counts a share of
// one item's rows into per-warp histograms in shared memory, adding the
// weight, and adds the sums into the one (gh, gw, 256) int32 output of
// the whole batch: every tile's counts merge there, and an integer sum is
// exact in any order.
//
// clahe_blend_kernel<..., STREAM = true>: the apply pass, ops/clahe.py:
// clahe_stream_blend (the reference's clahe_apply_from_hist_j, :440-504).
// The same blocks as the dense blend, with two changes.  The rows' and
// columns' tiles and fractions come from the window's origin: the
// reference's exact-integer interpolation, q = floor((2p - cell) / (2
// cell)) and the remainder r, clamped tile indices q and q + 1, the
// fraction f = r * (1 / (2 cell)) (XLA rewrites the division by a constant
// into this product with the float32 reciprocal).  One set of tables
// serves every window.  And the float32 order is XLA's CPU order of the
// streaming program, which differs from the dense one: the reference
// blends by a 256-pass loop over levels, and the loop body's weights are
// formed with 1 - f contracted, fma(-r, 1 / (2 cell), 1), while level 0
// (the loop's initial value, another fusion whose fraction feeds both
// factors) takes 1 - f rounded after the product.  The sum is the dense
// order, fma(w11, t11, fma(w10, t10, fma(w00, t00, w01 * t01))).
//
// Bound on the card: device memory.  The histogram reads 1 byte a pixel
// and writes 1 KB a tile; the blend reads 1 byte a pixel and writes 1
// (the tables and the row and column arrays are small beside them).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ void count4(int* bins, uint32_t word) {
  atomicAdd(&bins[word & 255u], 1);
  atomicAdd(&bins[(word >> 8) & 255u], 1);
  atomicAdd(&bins[(word >> 16) & 255u], 1);
  atomicAdd(&bins[word >> 24], 1);
}

// V bytes a load: 16, 4 or 1.  Every row of a tile starts at a multiple of
// V (the wrapper checks the base pointer, the frame width and the tile
// width).
template <int V>
__global__ void __launch_bounds__(THREADS)
    tile_histogram_kernel(const uint8_t* __restrict__ in, int* __restrict__ out,
                          int height, int width, int gh, int gw, int parts) {
  __shared__ int bins[WARPS][256];
  for (int i = threadIdx.x; i < WARPS * 256; i += THREADS) (&bins[0][0])[i] = 0;
  __syncthreads();

  const int th = height / gh;
  const int tw = width / gw;
  const int tile = blockIdx.x / parts;
  const int part = blockIdx.x % parts;
  const int ti = tile / gw;
  const int tj = tile % gw;
  const int r0 = static_cast<int>(static_cast<long long>(th) * part / parts);
  const int r1 = static_cast<int>(static_cast<long long>(th) * (part + 1) / parts);
  const unsigned per_row = static_cast<unsigned>(tw / V);
  const unsigned count = static_cast<unsigned>(r1 - r0) * per_row;
  const uint8_t* base = in +
                        (static_cast<long long>(blockIdx.y) * height +
                         static_cast<long long>(ti) * th + r0) * width +
                        static_cast<long long>(tj) * tw;
  int* hist = bins[threadIdx.x / 32];

  for (unsigned k = threadIdx.x; k < count; k += THREADS) {
    const unsigned r = k / per_row;
    const unsigned c = k - r * per_row;
    const uint8_t* p = base + static_cast<long long>(r) * width + c * V;
    if constexpr (V == 16) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
      count4(hist, v.x);
      count4(hist, v.y);
      count4(hist, v.z);
      count4(hist, v.w);
    } else if constexpr (V == 4) {
      count4(hist, __ldg(reinterpret_cast<const unsigned int*>(p)));
    } else {
      atomicAdd(&hist[__ldg(p)], 1);
    }
  }
  __syncthreads();

  for (int b = threadIdx.x; b < 256; b += THREADS) {
    int c = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) c += bins[w][b];
    if (c)
      atomicAdd(&out[(static_cast<long long>(blockIdx.y) * gh * gw + tile) * 256 + b], c);
  }
}

constexpr int BLEND_ROWS = 32;                        // output rows a block
constexpr int BLEND_PIXELS = 4;                       // pixels a lane blends in a row: one 4-byte word
constexpr int WARP_COLS = 32 * BLEND_PIXELS;          // a warp's columns: 128
constexpr int BLEND_COLS = WARPS * WARP_COLS;         // a block's columns: 1024
constexpr int GROUP_ROWS = 32 * 16 / WARP_COLS;       // rows a warp moves with a 16-byte word a lane: 4
static_assert(BLEND_PIXELS == 4, "a lane's pixels are one word");

// A byte as a float and a float in 0..255 as a byte by exact bit tricks,
// full-rate integer and float operations instead of conversions (which run
// at a quarter of the rate): 2^23 + b has b in its low mantissa bits, and
// adding 1.5 * 2^23 to x in [0, 255] rounds x half to even into them.
__device__ __forceinline__ float byte_to_float(uint32_t b) {
  return __fsub_rn(__int_as_float(0x4B000000 | b), 8388608.0f);
}

// the float bits of the blend of one pixel; its byte is the lowest.  gy
// and gx are 1 - fy and 1 - fx.
__device__ __forceinline__ uint32_t blend_one(float t00, float t01, float t10, float t11, float fy, float gy,
                                              float fx, float gx) {
  const float w00 = __fmul_rn(gy, gx);
  const float w01 = __fmul_rn(gy, fx);
  const float w10 = __fmul_rn(fy, gx);
  const float w11 = __fmul_rn(fy, fx);
  const float sum =
      __fmaf_rn(w11, t11, __fmaf_rn(w10, t10, __fmaf_rn(w00, t00, __fmul_rn(w01, t01))));
  // rint then clip equals clip then rint: the bounds are integers
  return __float_as_uint(__fadd_rn(fminf(fmaxf(sum, 0.0f), 255.0f), 12582912.0f));
}

// One position on an axis: its two tiles, the fraction between them, 1 -
// the fraction, and 1 - the fraction as the streaming program's loop body
// forms it (the dense blend's is the same as g).
struct Axis {
  int lo, hi;
  float f, g, g_fused;
};

// the dense blend's axis: the wrapper's arrays
__device__ __forceinline__ Axis array_axis(const int* lo, const int* hi, const float* f, int i) {
  const float fi = __ldg(f + i);
  const float g = __fsub_rn(1.0f, fi);
  return Axis{__ldg(lo + i), __ldg(hi + i), fi, g, g};
}

// the streaming blend's axis at absolute position pos: the reference's
// exact-integer interpolation (ops/clahe.py:472-478), recip = 1 / (2 cell)
// rounded to float32
__device__ __forceinline__ Axis stream_axis(int pos, int cell, int count, float recip) {
  const int two = 2 * cell;
  const int num = 2 * pos - cell;
  const int q = num >= 0 ? num / two : -((two - 1 - num) / two);  // floor
  const float rem = static_cast<float>(num - q * two);
  const float f = __fmul_rn(rem, recip);
  return Axis{min(max(q, 0), count - 1), min(max(q + 1, 0), count - 1), f, __fsub_rn(1.0f, f),
              __fmaf_rn(-rem, recip, 1.0f)};
}

struct BandRow {
  int top, bottom;  // byte offsets of the row's two tile rows of tables
  float fy, gy, gy_fused;
};

// A lane's columns: offsets of their left and right tables in a tile row
// of tables, their fractions, and 1 - the fractions (both forms).
struct Columns {
  int left[BLEND_PIXELS], right[BLEND_PIXELS];
  float fx[BLEND_PIXELS], gx[BLEND_PIXELS], gx_fused[BLEND_PIXELS];
};

// the blend of a lane's 4 pixels of one row, packed into a word; STREAM:
// levels 1..255 take the contracted 1 - f, level 0 the rounded one
template <bool STREAM>
__device__ __forceinline__ uint32_t blend_word(uint32_t word, const uint8_t* tab, const BandRow& row,
                                               const Columns& cols) {
  const uint8_t* top = tab + row.top;
  const uint8_t* bottom = tab + row.bottom;
  uint32_t b[BLEND_PIXELS];
#pragma unroll
  for (int j = 0; j < BLEND_PIXELS; ++j) {
    const uint32_t v = __byte_perm(word, 0, 0x4440 + j);  // byte j, zero-extended
    const bool fused = STREAM && v != 0;
    b[j] = blend_one(byte_to_float(top[cols.left[j] + v]), byte_to_float(top[cols.right[j] + v]),
                     byte_to_float(bottom[cols.left[j] + v]), byte_to_float(bottom[cols.right[j] + v]), row.fy,
                     fused ? row.gy_fused : row.gy, cols.fx[j], fused ? cols.gx_fused[j] : cols.gx[j]);
  }
  // the four lowest bytes into one word
  return __byte_perm(__byte_perm(b[0], b[1], 0x0040), __byte_perm(b[2], b[3], 0x0040), 0x5410);
}

// Grid (column spans, row bands, frames).  Reads rows and columns
// [0, h_out) x [0, w_out) of (height, width) frames and writes (h_out,
// w_out) frames: the crop back from the padded grid is free.  SHARED: the
// band's tables staged in dynamic shared memory (the wrapper sizes it for
// the largest window); else read from global memory.  A warp blends 128
// consecutive columns, a lane 4 of them, so that a warp's table reads
// mostly fall in the same tables and meet in few shared-memory words.
// VEC16 (rows, pointers and w_out allow 16-byte words): the warp moves 4
// rows of its 128 columns at a time, a 16-byte word a lane, through
// shared memory; else each lane reads and writes its 4 pixels by bytes.
// STREAM: the apply pass of the streaming runtime; the rows' and columns'
// tiles and fractions come from the frame's origin (origins[2 frame] its
// top, origins[2 frame + 1] its left, in a frame padded to tiles of cell_h
// x cell_w), every frame reads the same tables, and the order is the
// streaming program's (blend_word).  The row and column arrays are then
// unused.
template <bool SHARED, bool VEC16, bool STREAM>
__global__ void __launch_bounds__(THREADS)
    clahe_blend_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                       const uint8_t* __restrict__ luts, const int* __restrict__ y0,
                       const int* __restrict__ y1, const float* __restrict__ fy,
                       const int* __restrict__ x0, const int* __restrict__ x1,
                       const float* __restrict__ fx, const int* __restrict__ origins, int cell_h,
                       int cell_w, int height, int width, int h_out, int w_out, int gh, int gw) {
  extern __shared__ uint4 s_tables[];
  __shared__ BandRow s_rows[BLEND_ROWS];
  __shared__ uint4 s_io[WARPS][2][32];  // a warp's 4 rows of 128 bytes, in and out
  const long long frame = blockIdx.z;
  const int r_first = blockIdx.y * BLEND_ROWS;
  const int rows = min(BLEND_ROWS, h_out - r_first);
  const int c_first = blockIdx.x * BLEND_COLS;
  const uint8_t* tables = STREAM ? luts : luts + frame * gh * gw * 256;
  int top0 = 0, left0 = 0;
  float ry = 0.0f, rx = 0.0f;
  if constexpr (STREAM) {
    top0 = __ldg(origins + 2 * frame);
    left0 = __ldg(origins + 2 * frame + 1);
    ry = __frcp_rn(static_cast<float>(2 * cell_h));
    rx = __frcp_rn(static_cast<float>(2 * cell_w));
  }
  const auto row_axis = [&](int r) {
    return STREAM ? stream_axis(top0 + r, cell_h, gh, ry) : array_axis(y0, y1, fy, r);
  };
  const auto col_axis = [&](int c) {
    return STREAM ? stream_axis(left0 + c, cell_w, gw, rx) : array_axis(x0, x1, fx, c);
  };
  int ty_lo = 0, tx_lo = 0, nx = gw;
  if constexpr (SHARED) {
    // the window of tables: one run of nx contiguous tables a tile row
    ty_lo = row_axis(r_first).lo;
    tx_lo = col_axis(c_first).lo;
    nx = col_axis(min(c_first + BLEND_COLS, w_out) - 1).hi - tx_lo + 1;
    const int ny = row_axis(r_first + rows - 1).hi - ty_lo + 1;
    const int row_words = nx * 16;
    const uint4* src = reinterpret_cast<const uint4*>(tables);
    for (int i = threadIdx.x; i < ny * row_words; i += THREADS) {
      const int ty = i / row_words;
      s_tables[i] = __ldg(src + ((ty_lo + ty) * gw + tx_lo) * 16 + (i - ty * row_words));
    }
  }
  if (threadIdx.x < rows) {
    const Axis a = row_axis(r_first + threadIdx.x);
    s_rows[threadIdx.x] = BandRow{(a.lo - ty_lo) * nx * 256, (a.hi - ty_lo) * nx * 256, a.f, a.g, a.g_fused};
  }
  __syncthreads();
  const uint8_t* tab = SHARED ? reinterpret_cast<const uint8_t*>(s_tables) : tables;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wc0 = c_first + warp * WARP_COLS;
  if (wc0 >= w_out) return;
  const int c0 = wc0 + lane * BLEND_PIXELS;
  // this lane's columns, read once for the band's rows
  Columns cols;
#pragma unroll
  for (int j = 0; j < BLEND_PIXELS; ++j) {
    const Axis a = col_axis(min(c0 + j, w_out - 1));
    cols.left[j] = (a.lo - tx_lo) * 256;
    cols.right[j] = (a.hi - tx_lo) * 256;
    cols.fx[j] = a.f;
    cols.gx[j] = a.g;
    cols.gx_fused[j] = a.g_fused;
  }
  const uint8_t* src = in + (frame * height + r_first) * width;
  uint8_t* dst = out + (frame * h_out + r_first) * w_out;

  if constexpr (VEC16) {
    // lane l moves 16 bytes of row l / 8, columns 16 * (l % 8) on
    uint32_t* words_in = reinterpret_cast<uint32_t*>(s_io[warp][0]);
    uint32_t* words_out = reinterpret_cast<uint32_t*>(s_io[warp][1]);
    const int lr = lane / 8;
    const int lc = wc0 + (lane % 8) * 16;
    const bool mover = lc < w_out;  // w_out is a multiple of 16
    for (int i0 = 0; i0 < rows; i0 += GROUP_ROWS) {
      const bool row_in = i0 + lr < rows;
      if (mover && row_in)
        s_io[warp][0][lane] =
            __ldg(reinterpret_cast<const uint4*>(src + static_cast<long long>(i0 + lr) * width + lc));
      __syncwarp();
#pragma unroll
      for (int k = 0; k < GROUP_ROWS; ++k) {
        if (i0 + k < rows && c0 < w_out)
          words_out[k * 32 + lane] = blend_word<STREAM>(words_in[k * 32 + lane], tab, s_rows[i0 + k], cols);
      }
      __syncwarp();
      if (mover && row_in)
        *reinterpret_cast<uint4*>(dst + static_cast<long long>(i0 + lr) * w_out + lc) = s_io[warp][1][lane];
      __syncwarp();
    }
  } else {
    if (c0 >= w_out) return;
    for (int i = 0; i < rows; ++i) {
      const uint8_t* p = src + static_cast<long long>(i) * width + c0;
      uint32_t word = 0;
#pragma unroll
      for (int j = 0; j < BLEND_PIXELS; ++j)
        if (c0 + j < w_out) word |= static_cast<uint32_t>(__ldg(p + j)) << (8 * j);
      const uint32_t o = blend_word<STREAM>(word, tab, s_rows[i], cols);
      uint8_t* q = dst + static_cast<long long>(i) * w_out + c0;
#pragma unroll
      for (int j = 0; j < BLEND_PIXELS; ++j)
        if (c0 + j < w_out) q[j] = static_cast<uint8_t>(o >> (8 * j));
    }
  }
}

template <bool SHARED, bool VEC16, bool STREAM>
cudaError_t launch_blend(dim3 grid, int shared_bytes, cudaStream_t s, const uint8_t* in, uint8_t* out,
                         const uint8_t* luts, const int* y0, const int* y1, const float* fy,
                         const int* x0, const int* x1, const float* fx, const int* origins, int cell_h,
                         int cell_w, int height, int width, int h_out, int w_out, int gh, int gw) {
  auto kernel = clahe_blend_kernel<SHARED, VEC16, STREAM>;
  if (shared_bytes > 32 * 1024) {  // with the static 8.4 KB, above the default 48 KB
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared_bytes);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, THREADS, shared_bytes, s>>>(in, out, luts, y0, y1, fy, x0, x1, fx, origins, cell_h, cell_w,
                                             height, width, h_out, w_out, gh, gw);
  return cudaGetLastError();
}

// Work item of the stream histogram: rows [r0, r1) and columns [c0, c1)
// of tile `tile`, all in grid cell `cell` with weight `weight`; `vec` bytes
// a load (16, 4 or 1: c0, c1 - c0, the tile width and the base pointer are
// multiples of it).
struct StreamItem {
  int tile, r0, r1, c0, c1, cell, weight, vec;
};

template <int V>
__device__ __forceinline__ void count_rows(int* hist, const uint8_t* base, int tile_w, int rows, int cols,
                                           int weight) {
  const unsigned per_row = static_cast<unsigned>(cols / V);
  const unsigned count = static_cast<unsigned>(rows) * per_row;
  for (unsigned k = threadIdx.x; k < count; k += THREADS) {
    const unsigned r = k / per_row;
    const unsigned c = k - r * per_row;
    const uint8_t* p = base + static_cast<long long>(r) * tile_w + c * V;
    if constexpr (V == 16) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
      const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int b = 0; b < 4; ++b) atomicAdd(&hist[(words[i] >> (8 * b)) & 255u], weight);
    } else if constexpr (V == 4) {
      const uint32_t word = __ldg(reinterpret_cast<const unsigned int*>(p));
#pragma unroll
      for (int b = 0; b < 4; ++b) atomicAdd(&hist[(word >> (8 * b)) & 255u], weight);
    } else {
      atomicAdd(&hist[__ldg(p)], weight);
    }
  }
}

// Grid: (items * parts); block (item, part) counts its share of the item's
// rows.  tiles: (n, tile_h, tile_w) uint8; out: (gh * gw * 256) int32,
// zeroed, the batch's merged counts.
__global__ void __launch_bounds__(THREADS)
    stream_grid_histogram_kernel(const uint8_t* __restrict__ tiles, int* __restrict__ out,
                                 const StreamItem* __restrict__ items, int tile_h, int tile_w, int parts) {
  __shared__ int bins[WARPS][256];
  for (int i = threadIdx.x; i < WARPS * 256; i += THREADS) (&bins[0][0])[i] = 0;
  __syncthreads();
  const StreamItem it = items[blockIdx.x / parts];
  const int part = blockIdx.x % parts;
  const int rows = it.r1 - it.r0;
  const int r0 = it.r0 + static_cast<int>(static_cast<long long>(rows) * part / parts);
  const int r1 = it.r0 + static_cast<int>(static_cast<long long>(rows) * (part + 1) / parts);
  const uint8_t* base = tiles + (static_cast<long long>(it.tile) * tile_h + r0) * tile_w + it.c0;
  int* hist = bins[threadIdx.x / 32];
  const int cols = it.c1 - it.c0;
  if (it.vec == 16)
    count_rows<16>(hist, base, tile_w, r1 - r0, cols, it.weight);
  else if (it.vec == 4)
    count_rows<4>(hist, base, tile_w, r1 - r0, cols, it.weight);
  else
    count_rows<1>(hist, base, tile_w, r1 - r0, cols, it.weight);
  __syncthreads();
  for (int b = threadIdx.x; b < 256; b += THREADS) {
    int c = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) c += bins[w][b];
    if (c) atomicAdd(&out[it.cell * 256 + b], c);
  }
}

}  // namespace

// in: (n, height, width) uint8, contiguous, height and width multiples of
// gh and gw; out: (n, gh, gw, 256) int32, zeroed.  vec: 16, 4 or 1 bytes a
// load; parts: blocks a tile.
extern "C" int yam_tile_histogram_u8(const void* in, void* out, int n, int height, int width,
                                     int gh, int gw, int parts, int vec, void* stream) {
  const dim3 grid(gh * gw * parts, n);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* src = static_cast<const uint8_t*>(in);
  auto* dst = static_cast<int*>(out);
  if (vec == 16)
    tile_histogram_kernel<16><<<grid, THREADS, 0, s>>>(src, dst, height, width, gh, gw, parts);
  else if (vec == 4)
    tile_histogram_kernel<4><<<grid, THREADS, 0, s>>>(src, dst, height, width, gh, gw, parts);
  else if (vec == 1)
    tile_histogram_kernel<1><<<grid, THREADS, 0, s>>>(src, dst, height, width, gh, gw, parts);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// in: (n, height, width) uint8, contiguous; out: (n, h_out, w_out) uint8;
// luts: (n, gh, gw, 256) uint8; y0, y1 (int32) and fy (f32) hold h_out
// entries, x0, x1 and fx w_out.  band_rows and span_cols must be this
// source's BLEND_ROWS and BLEND_COLS.  shared_bytes: the dynamic shared
// memory of a block, enough for the largest window of tables a band and
// span touch, or 0 to read the tables from global memory.  vec: 16 when
// the frames, their width and w_out allow 16-byte words, else 1.
extern "C" int yam_clahe_blend_u8(const void* in, void* out, const void* luts, const void* y0,
                                  const void* y1, const void* fy, const void* x0, const void* x1,
                                  const void* fx, int n, int height, int width, int h_out,
                                  int w_out, int gh, int gw, int band_rows, int span_cols,
                                  int shared_bytes, int vec, void* stream) {
  if (band_rows != BLEND_ROWS || span_cols != BLEND_COLS || shared_bytes < 0 || (vec != 16 && vec != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((w_out + BLEND_COLS - 1) / BLEND_COLS, (h_out + BLEND_ROWS - 1) / BLEND_ROWS, n);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* src = static_cast<const uint8_t*>(in);
  auto* dst = static_cast<uint8_t*>(out);
  const auto* tables = static_cast<const uint8_t*>(luts);
  const auto* ry0 = static_cast<const int*>(y0);
  const auto* ry1 = static_cast<const int*>(y1);
  const auto* rfy = static_cast<const float*>(fy);
  const auto* cx0 = static_cast<const int*>(x0);
  const auto* cx1 = static_cast<const int*>(x1);
  const auto* cfx = static_cast<const float*>(fx);
  const auto go = [&](auto launch) {
    return static_cast<int>(launch(grid, shared_bytes, s, src, dst, tables, ry0, ry1, rfy, cx0, cx1, cfx,
                                   nullptr, 0, 0, height, width, h_out, w_out, gh, gw));
  };
  if (shared_bytes > 0)
    return vec == 16 ? go(launch_blend<true, true, false>) : go(launch_blend<true, false, false>);
  return vec == 16 ? go(launch_blend<false, true, false>) : go(launch_blend<false, false, false>);
}

// The stream histogram.  tiles: (n, tile_h, tile_w) uint8, contiguous;
// items: n_items StreamItem records (8 int32 each) on the device, every
// vec dividing the tile width and the base pointer; out: (gh * gw * 256)
// int32, zeroed.  parts: blocks an item.
extern "C" int yam_stream_grid_histogram_u8(const void* tiles, void* out, const void* items, int n_items,
                                            int tile_h, int tile_w, int parts, void* stream) {
  if (n_items <= 0 || parts <= 0) return static_cast<int>(cudaErrorInvalidValue);
  stream_grid_histogram_kernel<<<dim3(n_items * parts), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(tiles), static_cast<int*>(out), static_cast<const StreamItem*>(items), tile_h,
      tile_w, parts);
  return static_cast<int>(cudaGetLastError());
}

// The stream blend.  in, out: (n, height, width) uint8, contiguous, n
// windows of a frame padded to gh x gw tiles of cell_h x cell_w; origins:
// (n, 2) int32 on the device, each window's (top, left) in the frame; luts:
// (gh, gw, 256) uint8, the tables of every window.  band_rows, span_cols,
// shared_bytes and vec as for yam_clahe_blend_u8 (h_out = height, w_out =
// width).
extern "C" int yam_clahe_stream_blend_u8(const void* in, void* out, const void* luts, const void* origins, int n,
                                         int height, int width, int cell_h, int cell_w, int gh, int gw,
                                         int band_rows, int span_cols, int shared_bytes, int vec, void* stream) {
  if (band_rows != BLEND_ROWS || span_cols != BLEND_COLS || shared_bytes < 0 || (vec != 16 && vec != 1) ||
      cell_h <= 0 || cell_w <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((width + BLEND_COLS - 1) / BLEND_COLS, (height + BLEND_ROWS - 1) / BLEND_ROWS, n);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* src = static_cast<const uint8_t*>(in);
  auto* dst = static_cast<uint8_t*>(out);
  const auto* tables = static_cast<const uint8_t*>(luts);
  const auto* org = static_cast<const int*>(origins);
  const auto go = [&](auto launch) {
    return static_cast<int>(launch(grid, shared_bytes, s, src, dst, tables, nullptr, nullptr, nullptr, nullptr,
                                   nullptr, nullptr, org, cell_h, cell_w, height, width, height, width, gh, gw));
  };
  if (shared_bytes > 0)
    return vec == 16 ? go(launch_blend<true, true, true>) : go(launch_blend<true, false, true>);
  return vec == 16 ? go(launch_blend<false, true, true>) : go(launch_blend<false, false, true>);
}
