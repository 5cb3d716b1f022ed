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
// The stream kernels (the streaming runtime's two passes over a frame cut
// into stream tiles, parallel/tiling.py), each a kernel of its own and a
// template on the tiles' element type: uint8, uint16 or float32, read in
// that type (no conversion pass over the frame).  A value becomes a level
// as the reference's astype(int32) makes it: floats truncated toward zero,
// NaN 0, beyond int32's range saturated (cvt.rzi.s32.f32 does all three).
//
// stream_histogram_kernel: the stats pass, ops/clahe.py:grid_hist_stream
// (the reference's clahe_grid_hist_tile_j, yamimageprocessor_tpu/ops/
// clahe.py:408, which its streaming engine runs where the dense path runs
// histogram256_lane_grouped).  A stream tile lies anywhere in the frame,
// so its pixels fall in several grid cells, and the rows and columns that
// the dense path's reflect-101 grid padding copies count twice (a pixel
// whose row and column are both copied, four times).  The wrapper cuts
// each tile into work items that lie in one cell and carry one weight (a
// rectangle of the tile, its loads of 16, 4 or one element's bytes; a
// rectangle as wide as the tile is one run of loads) and numbers the
// batch's loads in item order.  The grid is persistent, sized from the
// occupancy API: block b takes loads [L b / B, L (b + 1) / B), whatever
// items they lie in, with HIST_UNROLL 16-byte loads a thread in flight.
// It counts raw occurrences into one 256-bin table with a column a lane
// (bin v of lane l at word 32 v + l: a warp's lanes add in their own banks
// however hot a level), and where the next item has another cell or
// weight, or its range ends, it flushes: each thread sums its bin's 32
// columns, zeroes them, and adds count x weight to the output with one
// global atomic.  An item's weight is applied once a flush, not a pixel.
// A launch takes up to PARAM_ITEMS items in its parameters (read through
// the constant cache: a block finds its first item and reads each next one
// without a trip to device memory); the wrapper launches larger batches'
// items PARAM_ITEMS at a time into the same output.
// The arithmetic is int32 modulo 2^32, as the reference's int32
// segment_sum is, so count x weight and the atomics' sums give its bits in
// any order and at any size.  A uint16 or float32 level outside 0..255
// (rare on real slides) goes straight to the output: the reference's flat
// index cell * 256 + v in int32 with wraparound, its weight added there
// when it lies in [0, gh gw 256) (another cell's bins) and dropped
// otherwise.
//
// stream_blend_kernel: the apply pass, ops/clahe.py:clahe_stream_blend
// (the reference's clahe_apply_from_hist_j, :440-504).  A position's tile
// pair is the reference's exact-integer interpolation, q = floor((2p -
// cell) / (2 cell)) and the remainder r, tiles clamp(q) and clamp(q + 1),
// the fraction f = r * (1 / (2 cell)) (XLA rewrites the division by a
// constant into this product with the float32 reciprocal).  The pair
// depends on q + 1 clamped to 0..g only, so a frame has (gh + 1) x (gw + 1)
// pairs of a tile-row pair and a tile-column pair.  The grid is
// persistent, sized from the occupancy API (4 blocks an SM, 64 registers);
// a block takes a contiguous run of the rows of strips (up to SB_COLS =
// 1024 columns of a window, a warp 128 of them, a lane 4 consecutive ones,
// whose pairs and fractions it keeps in registers), in chunks of rows of
// one strip.  For a chunk it stages in shared memory its rows' pairs and
// fractions, and the pairs its rows and the strip's columns touch, 256
// entries of 8 bytes a pair read from the uint8 tables: entry v the four
// corners' values at level v as float16 (exact: integers 0..255), (t00,
// t01) in one word and (t10, t11) in the other (8 KB on the 16380^2
// slide's 2048^2 cells).  A pixel then reads one entry, and each corner
// becomes a float by one conversion of a half (a 4-byte entry of bytes,
// each turned into a float by a byte permute and a subtraction of 2^23,
// took longer).  A chunk is SB_CHUNK rows, or fewer where its entries
// would not fit a block (cells a few pixels high); where even one row's
// would not, the strips are narrower than SB_COLS and the lanes past them
// idle (cells a few pixels wide; ops/clahe.py:stream_chunk_rows).  Each
// warp blends a step of rows (32 bytes a lane) with the next step's loads
// in flight; a row's staged values are read into registers at once.  A
// launch takes up to PARAM_WINDOWS windows' origins in its parameters;
// the wrapper launches larger batches PARAM_WINDOWS windows at a time.
// The float32 order is XLA's CPU order of the streaming program, which
// differs from the dense one: the reference blends by a 256-pass loop
// over levels whose body forms the weights with 1 - f contracted,
// fma(-r, 1 / (2 cell), 1), while a pixel the loop leaves alone (level 0, and any value outside 1..255,
// which also reads level 0's entries) keeps the loop's initial value,
// another fusion, whose 1 - f is rounded after the product.  The weights
// are separate products, the sum is fma(w11, t11, fma(w10, t10, fma(w00,
// t00, w01 * t01))), then rint to uint8 (the clip is left out: the sum
// lies in [0, 255.5), see stream_blend_one).
//
// Bound on the card: device memory.  The histograms read the pixels once
// and write 1 KB a tile (the stream histogram's output 1 KB a cell); the
// blends read the pixels once and write a byte each (the tables and the
// row and column arrays are small beside them).  The stream blend's
// instructions come near it: chip_smoke.py:stream_blend_least_ops counts
// the fewest exact ones a pixel.

#include <cuda_fp16.h>
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

// One position on an axis of the dense blend: its two tiles, the fraction
// between them and 1 - the fraction, from the wrapper's arrays.
struct Axis {
  int lo, hi;
  float f, g;
};

__device__ __forceinline__ Axis array_axis(const int* lo, const int* hi, const float* f, int i) {
  const float fi = __ldg(f + i);
  return Axis{__ldg(lo + i), __ldg(hi + i), fi, __fsub_rn(1.0f, fi)};
}

struct BandRow {
  int top, bottom;  // byte offsets of the row's two tile rows of tables
  float fy, gy;
};

// A lane's columns: offsets of their left and right tables in a tile row
// of tables, their fractions, and 1 - the fractions.
struct Columns {
  int left[BLEND_PIXELS], right[BLEND_PIXELS];
  float fx[BLEND_PIXELS], gx[BLEND_PIXELS];
};

// the blend of a lane's 4 pixels of one row, packed into a word
__device__ __forceinline__ uint32_t blend_word(uint32_t word, const uint8_t* tab, const BandRow& row,
                                               const Columns& cols) {
  const uint8_t* top = tab + row.top;
  const uint8_t* bottom = tab + row.bottom;
  uint32_t b[BLEND_PIXELS];
#pragma unroll
  for (int j = 0; j < BLEND_PIXELS; ++j) {
    const uint32_t v = __byte_perm(word, 0, 0x4440 + j);  // byte j, zero-extended
    b[j] = blend_one(byte_to_float(top[cols.left[j] + v]), byte_to_float(top[cols.right[j] + v]),
                     byte_to_float(bottom[cols.left[j] + v]), byte_to_float(bottom[cols.right[j] + v]), row.fy,
                     row.gy, cols.fx[j], cols.gx[j]);
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
template <bool SHARED, bool VEC16>
__global__ void __launch_bounds__(THREADS)
    clahe_blend_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                       const uint8_t* __restrict__ luts, const int* __restrict__ y0,
                       const int* __restrict__ y1, const float* __restrict__ fy,
                       const int* __restrict__ x0, const int* __restrict__ x1,
                       const float* __restrict__ fx, int height, int width, int h_out, int w_out, int gh,
                       int gw) {
  extern __shared__ uint4 s_tables[];
  __shared__ BandRow s_rows[BLEND_ROWS];
  __shared__ uint4 s_io[WARPS][2][32];  // a warp's 4 rows of 128 bytes, in and out
  const long long frame = blockIdx.z;
  const int r_first = blockIdx.y * BLEND_ROWS;
  const int rows = min(BLEND_ROWS, h_out - r_first);
  const int c_first = blockIdx.x * BLEND_COLS;
  const uint8_t* tables = luts + frame * gh * gw * 256;
  int ty_lo = 0, tx_lo = 0, nx = gw;
  if constexpr (SHARED) {
    // the window of tables: one run of nx contiguous tables a tile row
    ty_lo = __ldg(y0 + r_first);
    tx_lo = __ldg(x0 + c_first);
    nx = __ldg(x1 + min(c_first + BLEND_COLS, w_out) - 1) - tx_lo + 1;
    const int ny = __ldg(y1 + r_first + rows - 1) - ty_lo + 1;
    const int row_words = nx * 16;
    const uint4* src = reinterpret_cast<const uint4*>(tables);
    for (int i = threadIdx.x; i < ny * row_words; i += THREADS) {
      const int ty = i / row_words;
      s_tables[i] = __ldg(src + ((ty_lo + ty) * gw + tx_lo) * 16 + (i - ty * row_words));
    }
  }
  if (threadIdx.x < rows) {
    const Axis a = array_axis(y0, y1, fy, r_first + threadIdx.x);
    s_rows[threadIdx.x] = BandRow{(a.lo - ty_lo) * nx * 256, (a.hi - ty_lo) * nx * 256, a.f, a.g};
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
    const Axis a = array_axis(x0, x1, fx, min(c0 + j, w_out - 1));
    cols.left[j] = (a.lo - tx_lo) * 256;
    cols.right[j] = (a.hi - tx_lo) * 256;
    cols.fx[j] = a.f;
    cols.gx[j] = a.g;
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
          words_out[k * 32 + lane] = blend_word(words_in[k * 32 + lane], tab, s_rows[i0 + k], cols);
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
      const uint32_t o = blend_word(word, tab, s_rows[i], cols);
      uint8_t* q = dst + static_cast<long long>(i) * w_out + c0;
#pragma unroll
      for (int j = 0; j < BLEND_PIXELS; ++j)
        if (c0 + j < w_out) q[j] = static_cast<uint8_t>(o >> (8 * j));
    }
  }
}

template <bool SHARED, bool VEC16>
cudaError_t launch_blend(dim3 grid, int shared_bytes, cudaStream_t s, const uint8_t* in, uint8_t* out,
                         const uint8_t* luts, const int* y0, const int* y1, const float* fy,
                         const int* x0, const int* x1, const float* fx, int height, int width, int h_out,
                         int w_out, int gh, int gw) {
  auto kernel = clahe_blend_kernel<SHARED, VEC16>;
  if (shared_bytes > 32 * 1024) {  // with the static 8.4 KB, above the default 48 KB
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared_bytes);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, THREADS, shared_bytes, s>>>(in, out, luts, y0, y1, fy, x0, x1, fx, height, width, h_out, w_out,
                                             gh, gw);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the stream kernels

// A value of a stream tile as a level: astype(int32).
__device__ __forceinline__ int level_of(uint8_t x) { return x; }
__device__ __forceinline__ int level_of(uint16_t x) { return x; }
__device__ __forceinline__ int level_of(float x) { return __float2int_rz(x); }  // NaN 0, saturating

// element i of the words of a load
template <typename T>
__device__ __forceinline__ int word_level(const uint32_t* w, int i) {
  if constexpr (sizeof(T) == 1) {
    return static_cast<int>(__byte_perm(w[i / 4], 0, 0x4440 + i % 4));
  } else if constexpr (sizeof(T) == 2) {
    return static_cast<int>(__byte_perm(w[i / 2], 0, i % 2 ? 0x4432 : 0x4410));
  } else {
    return level_of(__uint_as_float(w[i]));
  }
}

// Work item of the stream histogram (8 int64, ops/clahe.py:stream_hist_items):
// `loads` loads of `vec` elements from element `base` of the tiles, the
// item's loads numbered from `start` in the batch; `per_row` loads a row,
// rows `stride` elements apart (per_row == loads: one contiguous run); all
// in grid cell `cell` with weight `weight`.
struct HistItem {
  long long base, start, loads, per_row, stride, cell, weight, vec;
};

constexpr int HIST_UNROLL = 4;  // loads a thread issues before it counts any
constexpr int HIST_TABLE_WORDS = 256 * 32;

// A lane's column of the block's table: bin v of lane l at word 32 v + l.
struct LaneColumn {
  int* table;
  int lane;
  __device__ __forceinline__ void add(uint32_t v, int k) const { atomicAdd(&table[v * 32 + lane], k); }
};

// Counts one level: 0..255 in the lane's column; any other (uint16 and
// float32 tiles only) adds its weight at the reference's flat index, in
// int32 with wraparound, when that lies in the output.
template <typename T>
__device__ __forceinline__ void count_level(const LaneColumn& col, int v, int* out, int cell256, int weight,
                                            int bins) {
  if (sizeof(T) == 1 || static_cast<unsigned>(v) <= 255u) {
    col.add(static_cast<uint32_t>(v), 1);
  } else {
    const int idx = static_cast<int>(static_cast<unsigned>(cell256) + static_cast<unsigned>(v));
    if (idx >= 0 && idx < bins) atomicAdd(out + idx, weight);
  }
}

// loads [a, z) of an item (indices within the item), NB bytes a load
template <typename T, int NB>
__device__ __forceinline__ void count_loads(const LaneColumn& col, const T* __restrict__ tiles, const HistItem& it,
                                            long long a, long long z, int* out, int bins) {
  constexpr int N = NB / static_cast<int>(sizeof(T));  // elements a load
  constexpr int W = NB >= 4 ? NB / 4 : 1;               // 32-bit words a load
  const int cell256 = static_cast<int>(it.cell) * 256;
  const int weight = static_cast<int>(it.weight);
  const bool run = it.per_row == it.loads;
  const unsigned per_row = static_cast<unsigned>(it.per_row);
  for (long long j0 = a + threadIdx.x; j0 < z; j0 += THREADS * HIST_UNROLL) {
    uint32_t w[HIST_UNROLL][W];
#pragma unroll
    for (int k = 0; k < HIST_UNROLL; ++k) {
      const long long j = j0 + k * THREADS;
      if (j < z) {
        long long e;
        if (run) {
          e = it.base + j * N;
        } else {
          const unsigned r = static_cast<unsigned>(j) / per_row;
          e = it.base + static_cast<long long>(r) * it.stride + (static_cast<unsigned>(j) - r * per_row) * N;
        }
        const T* p = tiles + e;
        if constexpr (NB == 16) {
          const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
          w[k][0] = v.x;
          w[k][1] = v.y;
          w[k][2] = v.z;
          w[k][3] = v.w;
        } else if constexpr (NB == 4) {
          w[k][0] = __ldg(reinterpret_cast<const unsigned int*>(p));
        } else {
          w[k][0] = static_cast<uint32_t>(level_of(__ldg(p)));  // one element: its level
        }
      }
    }
#pragma unroll
    for (int k = 0; k < HIST_UNROLL; ++k) {
      if (j0 + k * THREADS >= z) continue;
      if constexpr (NB < 4) {
        count_level<T>(col, static_cast<int>(w[k][0]), out, cell256, weight, bins);
      } else if constexpr (sizeof(T) == 1) {
        // a load of one level counts once
        const uint32_t rep = (w[k][0] & 255u) * 0x01010101u;
        bool same = true;
#pragma unroll
        for (int i = 0; i < W; ++i) same = same && w[k][i] == rep;
        if (same) {
          col.add(w[k][0] & 255u, N);
        } else {
#pragma unroll
          for (int i = 0; i < N; ++i) col.add(static_cast<uint32_t>(word_level<T>(w[k], i)), 1);
        }
      } else {
#pragma unroll
        for (int i = 0; i < N; ++i) count_level<T>(col, word_level<T>(w[k], i), out, cell256, weight, bins);
      }
    }
  }
}

// each thread its bin: the 32 lane columns' sum (lane (tid + l) % 32 at
// step l: a warp reads 32 banks), times the weight into the output; CLEAR:
// the columns zeroed for the next item
template <bool CLEAR>
__device__ __forceinline__ void flush_bins(int* table, int* out, long long cell, long long weight) {
  __syncthreads();
  const int tid = threadIdx.x;
  unsigned count = 0;
#pragma unroll 8
  for (int l = 0; l < 32; ++l) {
    int* c = &table[tid * 32 + (tid + l) % 32];
    count += static_cast<unsigned>(*c);
    if (CLEAR) *c = 0;
  }
  // modulo 2^32, as the reference's int32 sums
  if (count) atomicAdd(reinterpret_cast<unsigned*>(out) + cell * 256 + tid, count * static_cast<unsigned>(weight));
  if (CLEAR) __syncthreads();
}

// The items of a launch, in its parameters.
constexpr int PARAM_ITEMS = 48;
struct ItemList {
  HistItem v[PARAM_ITEMS];
};

// Persistent grid: block b counts loads [total b / B, total (b + 1) / B)
// of the n_items items in `list`.  out: (bins = gh gw 256) int32, zeroed.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    stream_histogram_kernel(const T* __restrict__ tiles, int* __restrict__ out, const __grid_constant__ ItemList list,
                            int n_items, long long total, int bins) {
  __shared__ uint4 table4[HIST_TABLE_WORDS / 4];
  int* table = reinterpret_cast<int*>(table4);
  const HistItem* items = list.v;
  for (int i = threadIdx.x; i < HIST_TABLE_WORDS / 4; i += THREADS) table4[i] = make_uint4(0, 0, 0, 0);
  const long long lo = total * blockIdx.x / gridDim.x;
  const long long hi = total * (blockIdx.x + 1) / gridDim.x;
  if (lo >= hi) return;  // uniform: before any barrier
  // the last item that starts at or before lo
  int k = 0;
  for (int span = n_items; span > 1;) {
    const int half = span / 2;
    if (items[k + half].start <= lo) k += half;
    span -= half;
  }
  __syncthreads();
  const LaneColumn col{table, static_cast<int>(threadIdx.x % 32)};
  long long pos = lo;
  long long cell = -1, weight = 0;
  for (; pos < hi; ++k) {
    const HistItem it = items[k];
    if (cell >= 0 && (it.cell != cell || it.weight != weight)) flush_bins<true>(table, out, cell, weight);
    cell = it.cell;
    weight = it.weight;
    const long long a = pos - it.start;
    const long long z = min(hi, it.start + it.loads) - it.start;
    const long long bytes = it.vec * static_cast<long long>(sizeof(T));
    if (bytes == 16)
      count_loads<T, 16>(col, tiles, it, a, z, out, bins);
    else if (sizeof(T) < 4 && bytes == 4)
      count_loads<T, sizeof(T) < 4 ? 4 : 16>(col, tiles, it, a, z, out, bins);
    else
      count_loads<T, static_cast<int>(sizeof(T))>(col, tiles, it, a, z, out, bins);
    pos = it.start + it.loads;
  }
  flush_bins<false>(table, out, cell, weight);
}

constexpr int SB_COLS = WARPS * WARP_COLS;  // the widest strip: 1024 columns of a window
constexpr int SB_CHUNK = 64;                // rows a block stages at once
constexpr int SB_STEP_BYTES = 32;           // bytes a lane loads a step (its rows: 32 / (4 sizeof(T)))

// the stream blend's row or column: its pair index q + 1 clamped to 0..g,
// the fraction, 1 - it rounded and 1 - it contracted
struct StreamAxis {
  int pair;
  float f, g, g_fused;
};

// at absolute position pos of an axis of `count` cells of `cell` pixels,
// recip = 1 / (2 cell) rounded to float32 (ops/clahe.py:stream_axis)
__device__ __forceinline__ StreamAxis stream_axis(int pos, int cell, int count, float recip) {
  const int two = 2 * cell;
  const int num = 2 * pos - cell;
  const int q = num >= 0 ? num / two : -((two - 1 - num) / two);  // floor
  const float rem = static_cast<float>(num - q * two);
  const float f = __fmul_rn(rem, recip);
  return StreamAxis{min(max(q + 1, 0), count), f, __fsub_rn(1.0f, f), __fmaf_rn(-rem, recip, 1.0f)};
}

struct __align__(16) StreamRow {
  int base;  // the row's pair row: the byte offset of its first entry in the staged pair entries
  float fy, gy, gy_fused;
};

// a staged row read whole into registers (one 16-byte shared load)
__device__ __forceinline__ StreamRow load_row(const StreamRow* row) {
  const float4 r = *reinterpret_cast<const float4*>(row);
  return StreamRow{__float_as_int(r.x), r.y, r.z, r.w};
}

// The stream blend of one pixel from its pair entry, in the reference's
// order; the result's lowest byte is the pixel.  No clip: every weight and
// entry is >= 0, and a pixel's rounded weights sum to at most 1 + 3 2^-24
// (1 - f and f to at most 1 + 2^-24 on each axis, each product rounded), so
// with the 4 roundings of the sum it lies in [0, 255.001) and rounds into
// 0..255 (tests/test_torch_stream_schedule.py blends 255s at every
// position of cells of 1 to 2048 pixels and checks it).
__device__ __forceinline__ uint32_t stream_blend_one(uint2 entry, float fy, float gy, float fx, float gx) {
  const float2 top = __half22float2(*reinterpret_cast<const __half2*>(&entry.x));     // t00, t01
  const float2 bottom = __half22float2(*reinterpret_cast<const __half2*>(&entry.y));  // t10, t11
  const float w00 = __fmul_rn(gy, gx);
  const float w01 = __fmul_rn(gy, fx);
  const float w10 = __fmul_rn(fy, gx);
  const float w11 = __fmul_rn(fy, fx);
  const float sum =
      __fmaf_rn(w11, bottom.y, __fmaf_rn(w10, bottom.x, __fmaf_rn(w00, top.x, __fmul_rn(w01, top.y))));
  return __float_as_uint(__fadd_rn(sum, 12582912.0f));  // rint, by the same bit trick as blend_one
}

// 4 elements of a lane: 4, 8 or 16 bytes
template <typename T>
struct Four {
  uint32_t w[sizeof(T)];
};

template <typename T, bool VEC>
__device__ __forceinline__ Four<T> load_four(const T* p, int valid) {
  Four<T> v;
  if constexpr (VEC) {
    if constexpr (sizeof(T) == 1) {
      v.w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
    } else if constexpr (sizeof(T) == 2) {
      const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
      v.w[0] = u.x;
      v.w[1] = u.y;
    } else {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
      v.w[0] = u.x;
      v.w[1] = u.y;
      v.w[2] = u.z;
      v.w[3] = u.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < static_cast<int>(sizeof(T)); ++i) v.w[i] = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j < valid) {
        if constexpr (sizeof(T) == 4) {
          v.w[j] = __float_as_uint(__ldg(p + j));
        } else {
          const uint32_t e = static_cast<uint32_t>(__ldg(p + j));
          v.w[j * sizeof(T) / 4] |= e << (8 * sizeof(T) * (j % (4 / sizeof(T))));
        }
      }
    }
  }
  return v;
}

// The window origins of a launch, in its parameters.
constexpr int PARAM_WINDOWS = 64;
struct OriginList {
  int v[2 * PARAM_WINDOWS];
};

// Persistent grid: block b takes rows [total b / B, total (b + 1) / B) of
// the n * spans strips' rows (strip s = window s / spans, columns
// strip_cols (s % spans) on: strip_cols <= SB_COLS, a multiple of 4; lanes
// past a narrower strip idle), in chunks of at most `chunk` (<= SB_CHUNK)
// rows of one strip.  in: (n, height, width) T; out: (n, height, width)
// uint8; luts: (gh, gw, 256) uint8; list: the n (<= PARAM_WINDOWS)
// windows' (top, left).  The dynamic shared memory holds the pair entries of the largest chunk
// (the wrapper sizes it, `chunk` and `strip_cols`); VEC: rows and pointers
// allow a lane's 4 elements as one load and its 4 bytes as one store.
template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS, 4)
    stream_blend_kernel(const T* __restrict__ in, uint8_t* __restrict__ out, const uint8_t* __restrict__ luts,
                        const __grid_constant__ OriginList list, int height, int width, int strip_cols,
                        int spans, long long total, int chunk, int cell_h, int cell_w, int gh, int gw) {
  const int* origins = list.v;
  extern __shared__ uint2 s_entries[];
  __shared__ StreamRow s_rows[SB_CHUNK];
  constexpr int STEP = SB_STEP_BYTES / (4 * static_cast<int>(sizeof(T)));  // rows a lane loads a step

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const float ry = __frcp_rn(static_cast<float>(2 * cell_h));
  const float rx = __frcp_rn(static_cast<float>(2 * cell_w));
  long long g = total * blockIdx.x / gridDim.x;
  const long long g_end = total * (blockIdx.x + 1) / gridDim.x;
  int strip = -1;
  // this lane's 4 columns: their pair columns' byte offsets in a pair row,
  // fractions, 1 - them
  int col_base[4];
  float fx[4], gx[4], gx_fused[4];
  int c0 = 0, valid = 0, pair_x0 = 0, pairs_x = 1, top = 0;
  long long frame = 0;
  while (g < g_end) {
    const int s = static_cast<int>(g / height);
    const int ra = static_cast<int>(g - static_cast<long long>(s) * height);
    const int rb = static_cast<int>(min(static_cast<long long>(min(height, ra + chunk)), ra + (g_end - g)));
    if (s != strip) {
      strip = s;
      frame = s / spans;
      const int x_first = (s % spans) * strip_cols;
      const int x_end = min(x_first + strip_cols, width);
      top = origins[2 * frame];
      const int left = origins[2 * frame + 1];
      pair_x0 = stream_axis(left + x_first, cell_w, gw, rx).pair;
      pairs_x = stream_axis(left + x_end - 1, cell_w, gw, rx).pair - pair_x0 + 1;
      c0 = x_first + warp * WARP_COLS + lane * 4;
      valid = max(0, min(4, x_end - c0));
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const StreamAxis a = stream_axis(left + min(c0 + j, width - 1), cell_w, gw, rx);
        col_base[j] = (a.pair - pair_x0) * 2048;
        fx[j] = a.f;
        gx[j] = a.g;
        gx_fused[j] = a.g_fused;
      }
    }
    const T* src = in + (frame * height + ra) * width + c0;
    uint8_t* dst = out + (frame * height + ra) * width + c0;
    const int rows = rb - ra;
    // the first step's loads go out before the staging
    Four<T> cur[STEP], nxt[STEP];
#pragma unroll
    for (int d = 0; d < STEP; ++d)
      if (valid > 0 && d < rows) cur[d] = load_four<T, VEC>(src + static_cast<long long>(d) * width, valid);
    __syncthreads();  // the last chunk's readers are done
    // the chunk's pair entries: pair (i, j) is tile rows clamp(i - 1),
    // clamp(i) and tile columns clamp(j - 1), clamp(j); its entry at level
    // v the four tables' values at v as float16, (t00, t01) and (t10, t11)
    const int pair_y0 = stream_axis(top + ra, cell_h, gh, ry).pair;
    const int pairs_y = stream_axis(top + rb - 1, cell_h, gh, ry).pair - pair_y0 + 1;
    for (int e = threadIdx.x; e < pairs_y * pairs_x * 64; e += THREADS) {  // 4 levels a thread
      const int pair = e / 64;
      const int i = pair_y0 + pair / pairs_x;
      const int j = pair_x0 + pair % pairs_x;
      const auto* t = reinterpret_cast<const uint32_t*>(luts) + e % 64;
      const int r0 = max(i - 1, 0) * gw, r1 = min(i, gh - 1) * gw, q0 = max(j - 1, 0), q1 = min(j, gw - 1);
      const uint32_t t00 = __ldg(t + (r0 + q0) * 64), t01 = __ldg(t + (r0 + q1) * 64);
      const uint32_t t10 = __ldg(t + (r1 + q0) * 64), t11 = __ldg(t + (r1 + q1) * 64);
      const auto half = [](uint32_t word, int k) {  // byte k of a table word
        return __ushort2half_rn(static_cast<unsigned short>((word >> (8 * k)) & 255u));
      };
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const __half2 upper = __halves2half2(half(t00, k), half(t01, k));
        const __half2 lower = __halves2half2(half(t10, k), half(t11, k));
        s_entries[pair * 256 + (e % 64) * 4 + k] =
            make_uint2(*reinterpret_cast<const uint32_t*>(&upper), *reinterpret_cast<const uint32_t*>(&lower));
      }
    }
    if (threadIdx.x < rows) {
      const StreamAxis a = stream_axis(top + ra + threadIdx.x, cell_h, gh, ry);
      s_rows[threadIdx.x] = StreamRow{(a.pair - pair_y0) * pairs_x * 2048, a.f, a.g, a.g_fused};
    }
    __syncthreads();
    if (valid > 0) {
      const char* tab_bytes = reinterpret_cast<const char*>(s_entries);
      // one row of a lane: its 4 pixels from their pair entries, 4 bytes out
      const auto blend_row = [&](const Four<T>& in4, const StreamRow* staged, uint8_t* q) {
        const StreamRow row = load_row(staged);
        uint32_t b[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int v = word_level<T>(in4.w, j);
          // the loop's levels 1..255 blend their own entries with the
          // contracted weights; any other value level 0's, rounded
          bool inside;
          int idx;
          if constexpr (sizeof(T) == 1) {
            inside = v != 0;
            idx = v;
          } else {
            inside = static_cast<unsigned>(v - 1) < 255u;
            idx = inside ? v : 0;
          }
          const uint2 entry = *reinterpret_cast<const uint2*>(tab_bytes + row.base + col_base[j] + idx * 8);
          b[j] = stream_blend_one(entry, row.fy, inside ? row.gy_fused : row.gy, fx[j], inside ? gx_fused[j] : gx[j]);
        }
        const uint32_t o = __byte_perm(__byte_perm(b[0], b[1], 0x0040), __byte_perm(b[2], b[3], 0x0040), 0x5410);
        if constexpr (VEC) {
          *reinterpret_cast<uint32_t*>(q) = o;
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (j < valid) q[j] = static_cast<uint8_t>(o >> (8 * j));
        }
      };
      const T* ahead = src + static_cast<long long>(STEP) * width;  // the next step's first row
      uint8_t* q = dst;
      for (int i0 = 0; i0 < rows; i0 += STEP) {
#pragma unroll
        for (int d = 0; d < STEP; ++d)
          if (i0 + STEP + d < rows) nxt[d] = load_four<T, VEC>(ahead + static_cast<long long>(d) * width, valid);
        ahead += static_cast<long long>(STEP) * width;
        if (i0 + STEP <= rows) {  // a whole step: its rows unchecked, free to interleave
#pragma unroll
          for (int d = 0; d < STEP; ++d) blend_row(cur[d], s_rows + i0 + d, q + static_cast<long long>(d) * width);
        } else {
#pragma unroll
          for (int d = 0; d < STEP; ++d)
            if (i0 + d < rows) blend_row(cur[d], s_rows + i0 + d, q + static_cast<long long>(d) * width);
        }
        q += static_cast<long long>(STEP) * width;
#pragma unroll
        for (int d = 0; d < STEP; ++d) cur[d] = nxt[d];
      }
    }
    g += rows;
  }
}

// blocks of a persistent grid: what the card holds at once, at most `most`
template <typename K>
cudaError_t resident_blocks(K kernel, int shared_bytes, long long most, long long* blocks) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, shared_bytes);
  *blocks = max(1LL, min(static_cast<long long>(per_sm) * sms, most));
  return err;
}

template <typename T, bool VEC>
cudaError_t launch_stream_blend(int shared_bytes, int chunk, int strip_cols, cudaStream_t s, const void* in,
                                void* out, const void* luts, const int* origins, int n, int height, int width,
                                int cell_h, int cell_w, int gh, int gw) {
  OriginList list;
  for (int i = 0; i < 2 * n; ++i) list.v[i] = origins[i];
  const auto kernel = stream_blend_kernel<T, VEC>;
  const int spans = (width + strip_cols - 1) / strip_cols;
  const long long total = static_cast<long long>(n) * spans * height;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared_bytes);
  long long blocks = 0;  // every block at least a few rows
  if (err == cudaSuccess) err = resident_blocks(kernel, shared_bytes, (total + 7) / 8, &blocks);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(blocks), THREADS, shared_bytes, s>>>(
      static_cast<const T*>(in), static_cast<uint8_t*>(out), static_cast<const uint8_t*>(luts), list, height, width,
      strip_cols, spans, total, chunk, cell_h, cell_w, gh, gw);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_stream_histogram(cudaStream_t s, const void* tiles, void* out, const void* items, int n_items,
                                    long long total, int bins) {
  ItemList list;
  for (int i = 0; i < n_items; ++i) list.v[i] = static_cast<const HistItem*>(items)[i];
  const auto kernel = stream_histogram_kernel<T>;
  long long blocks = 0;  // every block at least one load a thread
  const cudaError_t err = resident_blocks(kernel, 0, (total + THREADS - 1) / THREADS, &blocks);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(blocks), THREADS, 0, s>>>(static_cast<const T*>(tiles), static_cast<int*>(out), list,
                                                          n_items, total, bins);
  return cudaGetLastError();
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
    return static_cast<int>(launch(grid, shared_bytes, s, src, dst, tables, ry0, ry1, rfy, cx0, cx1, cfx, height,
                                   width, h_out, w_out, gh, gw));
  };
  if (shared_bytes > 0)
    return vec == 16 ? go(launch_blend<true, true>) : go(launch_blend<true, false>);
  return vec == 16 ? go(launch_blend<false, true>) : go(launch_blend<false, false>);
}

// The stream histogram.  tiles: uint8, uint16 or float32 (dtype 1, 2 or 4:
// the element's bytes), contiguous; items: n_items (1..PARAM_ITEMS)
// HistItem records on the host (8 int64 each, in order of `start`, the
// first at 0), every vec's bytes dividing the tile width's and the base
// pointer; total: the items' loads; out: (bins = gh gw 256) int32, to which
// the launch adds.
extern "C" int yam_stream_grid_histogram(const void* tiles, void* out, const void* items, int n_items,
                                         long long total, int bins, int dtype, void* stream) {
  if (n_items <= 0 || n_items > PARAM_ITEMS || total <= 0 || bins <= 0 || bins % 256)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto go = [&](auto launch) { return static_cast<int>(launch(s, tiles, out, items, n_items, total, bins)); };
  if (dtype == 1) return go(launch_stream_histogram<uint8_t>);
  if (dtype == 2) return go(launch_stream_histogram<uint16_t>);
  if (dtype == 4) return go(launch_stream_histogram<float>);
  return static_cast<int>(cudaErrorInvalidValue);
}


// The stream blend.  in: (n, height, width) uint8, uint16 or float32
// (dtype 1, 2 or 4), out: (n, height, width) uint8, both contiguous: n
// (1..PARAM_WINDOWS) windows of a frame padded to gh x gw cells of cell_h x
// cell_w; origins: (n, 2) int32 on the host, each window's (top, left) in
// the frame; luts: the (gh, gw, 256) uint8 tables of every window,
// contiguous and 4-byte aligned.  A block stages chunk_rows (1..SB_CHUNK)
// rows of a strip of strip_cols columns (a multiple of 4, at most SB_COLS)
// at once, whose pair entries must fit shared_bytes of dynamic shared
// memory (ops/clahe.py:stream_chunk_rows); vec: 1 when the windows' width
// is a multiple of 4 and both pointers aligned for a lane's 4 elements and
// 4 bytes.
extern "C" int yam_clahe_stream_blend(const void* in, void* out, const void* luts, const void* origins, int n,
                                      int height, int width, int cell_h, int cell_w, int gh, int gw, int chunk_rows,
                                      int strip_cols, int shared_bytes, int vec, int dtype, void* stream) {
  if (chunk_rows < 1 || chunk_rows > SB_CHUNK || strip_cols < 4 || strip_cols > SB_COLS || strip_cols % 4 ||
      shared_bytes <= 0 || n <= 0 || n > PARAM_WINDOWS || height <= 0 || width <= 0 || cell_h <= 0 || cell_w <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* org = static_cast<const int*>(origins);
  const auto go = [&](auto launch) {
    return static_cast<int>(
        launch(shared_bytes, chunk_rows, strip_cols, s, in, out, luts, org, n, height, width, cell_h, cell_w, gh, gw));
  };
  if (dtype == 1) return vec ? go(launch_stream_blend<uint8_t, true>) : go(launch_stream_blend<uint8_t, false>);
  if (dtype == 2) return vec ? go(launch_stream_blend<uint16_t, true>) : go(launch_stream_blend<uint16_t, false>);
  if (dtype == 4) return vec ? go(launch_stream_blend<float, true>) : go(launch_stream_blend<float, false>);
  return static_cast<int>(cudaErrorInvalidValue);
}
