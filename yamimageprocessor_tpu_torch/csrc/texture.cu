// Texture kernels of the extraction stage: GLCM pair counts of uint8 frames
// and uniform LBP codes of uint8, uint16 or float32 frames.  Neither replaces a pallas_call: they replace XLA
// code of yamimageprocessor_tpu/ops/texture.py.
//
// glcm_counts (for glcm_j's .at[idx].add(1), texture.py:143): the (n, 256,
// 256) int32 counts of (I[y, x], I[y + dy, x + dx]) over the window where
// both lie in the frame, any offset.  Bound on the card: bytes (the frame
// read once, the table written once); what a call costs besides is fixed
// (a launch, clearing the table) and the atomics of pairs that share a key.
// Design: one cooperative launch of as many blocks as the card holds at
// once (1024 threads and a 128 KiB table each, one a multiprocessor):
//
// 1. each block zeroes its share of the output (no torch.zeros: the wrapper
//    allocates it with torch.empty) and its private table;
// 2. it counts its first unit of pairs into the private table: 65536
//    counters as 16-bit halves of 32-bit words, key = a * 256 + b adds 1 <<
//    (16 * (key & 1)) to word key >> 1 with a shared-memory atomicAdd.  A
//    unit is whole rows of the window (a row's segment where a row has more
//    than GLCM_FILL pairs) of at most GLCM_FILL = 65535 pairs, so no half
//    can carry into its neighbour, not even on a flat frame; the walk over
//    a unit's rows and columns steps without a division;
// 3. a grid barrier: every share of the output is zero;
// 4. it reads the private table back, adds each non-zero counter to the
//    frame's table with a red.global.add, and zeroes the words it read; then
//    its next unit (u + gridDim.x), counted and flushed the same way.
//
// glcm_plan sizes the units so that one frame fills the grid (a 1024^2
// frame: 128 units of 8 rows) and a batch takes at most GLCM_FILL pairs a
// unit.  A refused launch returns its error, cleared; nothing falls back.
//
// lbp_codes (for lbp_j, texture.py:70, and lbp_np, :40): the uniform code
// 0..P+1 of every pixel, as uint8, from frames of any of the three element
// types (a template parameter; every value is exact in float32 and float64,
// so the arithmetic after the load is the same).  Two arithmetics, a
// template flag:
//
// - float32 (the chain): each sample is the difference to the centre,
//   interpolated as XLA's CPU backend runs lbp_j, the weights folded into
//   one float32 constant a corner: fma(d0, w0, d1 * w1), then
//   fma(d2, w2, acc), fma(d3, w3, acc); the bit is acc >= 0;
// - float64 (the data path, lbp_np): the raw values interpolated with the
//   fractions formed per pixel, ry = (y + pad) + dr, fy = ry - floor(ry),
//   ((v00 (1 - fy)) (1 - fx) + (v01 (1 - fy)) fx) + ..., compared with the
//   centre; every operation rounded apart, as numpy does.
//
// Bound on the card: operations.  Design: a block of 8 warps stages its
// 128 x 16 tile and a halo of pad = ceil(R) + 1, edge-clamped as the
// reference pads, in shared memory once (float32, or the values as double
// for the float64 path), so the inner loop has no clamps and no global
// loads; a thread computes 4 pixels of a row, 32 columns apart (a warp's
// loads of one corner are 32 consecutive words: no bank conflicts); the
// samples' corner offsets, weights and float64 offsets are a kernel
// parameter (the constant bank), the sample loop unrolled for P = 8, 16 and
// 24 and up to 32 otherwise.  In the float32 path each distinct corner's
// difference to the centre is formed once a pixel (the same rounded value
// in every sample that reads it): the chain's default (P 8, R 1) has its
// own instance, its 13 corners known at compile time (12 loads a pixel);
// any other geometry takes the corners it shares with the sample before
// from it (a relation code a sample, from the host).  The float64 path keeps the
// fractions per pixel (ry = (y + pad) + dr rounds differently from row to
// row), so only its loads move to the tile.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int GLCM_THREADS = 1024;
constexpr int GLCM_WORDS = 32768;  // a block's table: 65536 16-bit counters in 128 KiB
constexpr int GLCM_FILL = 65535;   // pairs a unit counts before it flushes: no 16-bit half can carry
constexpr int LBP_THREADS = 256, LBP_COLS = 128, LBP_ROWS = 16;
constexpr int MAX_P = 32;

// Count the pairs of one unit into the private table: the pixels at rows
// ra .. ra + nrows - 1 and columns ca .. ca + ncols - 1 of frame img, each
// with its partner (dy, dx) away.
__device__ __forceinline__ void glcm_count_unit(const uint8_t* __restrict__ img, unsigned* table, int w, int dx,
                                                int dy, int ra, int nrows, int ca, int ncols) {
  const long long down = static_cast<long long>(dy) * w + dx;
  int i = threadIdx.x / ncols, j = threadIdx.x % ncols;
  const int di = GLCM_THREADS / ncols, dj = GLCM_THREADS % ncols;
  while (i < nrows) {
    const long long at = static_cast<long long>(ra + i) * w + ca + j;
    const int key = __ldg(img + at) * 256 + __ldg(img + at + down);
    atomicAdd(table + (key >> 1), 1u << ((key & 1) << 4));
    j += dj;
    i += di;
    if (j >= ncols) {
      j -= ncols;
      ++i;
    }
  }
}

// Add the private table's non-zero counters to the frame's table and zero them.
__device__ __forceinline__ void glcm_flush(uint4* table, int* __restrict__ counts) {
  for (int k = threadIdx.x; k < GLCM_WORDS / 4; k += GLCM_THREADS) {
    const uint4 v = table[k];
    if ((v.x | v.y | v.z | v.w) == 0u) continue;
    table[k] = make_uint4(0u, 0u, 0u, 0u);
    const unsigned words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      int* at = counts + 8 * k + 2 * q;  // the counters of keys 2 (4k + q) and 2 (4k + q) + 1
      if (words[q] & 0xffffu) atomicAdd(at, static_cast<int>(words[q] & 0xffffu));
      if (words[q] >> 16) atomicAdd(at + 1, static_cast<int>(words[q] >> 16));
    }
  }
}

struct GlcmPlan {
  int r0, c0, rows, cols;  // the window
  int unit_rows, seg_cols, segs, units_per_frame;
  long long units;
};

__global__ void __launch_bounds__(GLCM_THREADS, 1)
glcm_counts_kernel(const uint8_t* __restrict__ src, int* __restrict__ out, int n, int h, int w, int dx, int dy,
                   const GlcmPlan p) {
  extern __shared__ uint4 glcm_table[];
  unsigned* table = reinterpret_cast<unsigned*>(glcm_table);
  const long long words4 = static_cast<long long>(n) * 65536 / 4;
  int4* zero = reinterpret_cast<int4*>(out);
  for (long long k = static_cast<long long>(blockIdx.x) * GLCM_THREADS + threadIdx.x; k < words4;
       k += static_cast<long long>(gridDim.x) * GLCM_THREADS)
    zero[k] = make_int4(0, 0, 0, 0);
  for (int k = threadIdx.x; k < GLCM_WORDS / 4; k += GLCM_THREADS) glcm_table[k] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  // gridDim.x <= units: every block has a first unit, and every block reaches the barrier once
  for (long long u = blockIdx.x; u < p.units; u += gridDim.x) {
    const int f = static_cast<int>(u / p.units_per_frame), rest = static_cast<int>(u % p.units_per_frame);
    const int ra = (rest / p.segs) * p.unit_rows, ca = (rest % p.segs) * p.seg_cols;
    glcm_count_unit(src + static_cast<long long>(f) * h * w, table, w, dx, dy, p.r0 + ra, min(p.unit_rows, p.rows - ra),
                    p.c0 + ca, min(p.seg_cols, p.cols - ca));
    if (u == blockIdx.x)
      cg::this_grid().sync();  // every block's share of the output is zero (and this block's counts are in)
    else
      __syncthreads();
    glcm_flush(glcm_table, out + static_cast<long long>(f) * 65536);
    __syncthreads();
  }
}

// Units of at most GLCM_FILL pairs: a row's segments of seg_cols columns
// (the whole row where it has at most GLCM_FILL pairs), unit_rows rows a
// unit, so that n frames fill about `resident` units.
GlcmPlan glcm_plan(int n, int r0, int c0, int rows, int cols, int resident) {
  GlcmPlan p{};
  p.r0 = r0;
  p.c0 = c0;
  p.rows = rows;
  p.cols = cols;
  p.seg_cols = cols < GLCM_FILL ? cols : GLCM_FILL;
  p.segs = (cols + p.seg_cols - 1) / p.seg_cols;
  const int cap_rows = GLCM_FILL / p.seg_cols;  // >= 1
  const int per_frame = resident / n > 1 ? resident / n : 1;
  const int want = (rows + per_frame - 1) / per_frame;
  p.unit_rows = want < 1 ? 1 : (want > cap_rows ? cap_rows : want);
  p.units_per_frame = (rows + p.unit_rows - 1) / p.unit_rows * p.segs;
  p.units = static_cast<long long>(n) * p.units_per_frame;
  return p;
}

__device__ __forceinline__ int clampi(int v, int hi) { return v < 0 ? 0 : (v > hi ? hi : v); }

// The samples of one launch, a kernel parameter (the constant bank).
// relation[s] says which corners sample s shares with sample s - 1: NONE,
// SAME (all four), RIGHT (x0 one more: 00 = 01 before, 10 = 11 before),
// LEFT, DOWN (y0 one more: 00 = 10 before, 01 = 11 before) or UP.
struct LbpParams {
  int corner[MAX_P][2];     // (y0, x0) of each sample's top-left corner from the centre
  float weight[MAX_P][4];   // the folded float32 weights of corners 00, 01, 10, 11
  int relation[MAX_P];
  double offset[MAX_P][2];  // (dr, dc), the float64 path's
};

enum Relation { NONE = 0, SAME = 1, RIGHT = 2, LEFT = 3, DOWN = 4, UP = 5 };

// The chain's default geometry, P 8 and R 1: each sample's top-left corner,
// the 13 distinct corners of the 8 samples, and each sample's 4 corners
// among them (00, 01, 10, 11).
constexpr int MAIN_P = 8, MAIN_CORNERS = 13;
constexpr int kMainCorner[MAIN_P][2] = {{0, 1}, {-1, 0}, {-1, 0}, {-1, -1}, {0, -1}, {0, -1}, {1, 0}, {0, 0}};
__host__ __device__ constexpr int main_distinct(int u, int axis) {
  constexpr int kMainDistinct[MAIN_CORNERS][2] = {{-1, -1}, {-1, 0}, {-1, 1}, {0, -1}, {0, 0}, {0, 1}, {0, 2},
                                                  {1, -1},  {1, 0},  {1, 1},  {1, 2}, {2, 0}, {2, 1}};
  return kMainDistinct[u][axis];
}
__host__ __device__ constexpr int main_use(int s, int k) {
  constexpr int kMainUses[MAIN_P][4] = {{5, 6, 9, 10}, {1, 2, 4, 5}, {1, 2, 4, 5}, {0, 1, 3, 4},
                                        {3, 4, 7, 8},  {3, 4, 7, 8}, {8, 9, 11, 12}, {4, 5, 8, 9}};
  return kMainUses[s][k];
}

bool is_main_geometry(const LbpParams& prm, int p) {
  if (p != MAIN_P) return false;
  for (int s = 0; s < MAIN_P; ++s)
    if (prm.corner[s][0] != kMainCorner[s][0] || prm.corner[s][1] != kMainCorner[s][1]) return false;
  return true;
}

__device__ __forceinline__ unsigned lbp_code(unsigned bits, int p) {
  const unsigned mask = p == 32 ? 0xffffffffu : ((1u << p) - 1u);
  const unsigned rolled = ((bits << 1) | (bits >> (p - 1))) & mask;
  const int transitions = __popc(bits ^ rolled);
  return transitions <= 2 ? __popc(bits) : p + 1;
}

// The float32 sample bits of the chain's default geometry: the 13
// distinct corners' differences once (the centre's own, c - c, loads
// nothing), then each sample's FMA chain on 4 of them.
__device__ __forceinline__ unsigned lbp_bits_main(const float* __restrict__ ctr, int pitch, const LbpParams& prm) {
  const float c = ctr[0];
  float d[MAIN_CORNERS];
#pragma unroll
  for (int u = 0; u < MAIN_CORNERS; ++u) {
    const int dy = main_distinct(u, 0), dx = main_distinct(u, 1);
    d[u] = __fsub_rn(dy == 0 && dx == 0 ? c : ctr[dy * pitch + dx], c);
  }
  unsigned bits = 0;
#pragma unroll
  for (int s = 0; s < MAIN_P; ++s) {
    const float* wt = prm.weight[s];
    float acc = __fmaf_rn(d[main_use(s, 0)], wt[0], __fmul_rn(d[main_use(s, 1)], wt[1]));
    acc = __fmaf_rn(d[main_use(s, 2)], wt[2], acc);
    acc = __fmaf_rn(d[main_use(s, 3)], wt[3], acc);
    bits |= static_cast<unsigned>(acc >= 0.0f) << s;
  }
  return bits;
}

// The float32 sample bits of the pixel whose centre is at ctr in the tile.
template <int P>
__device__ __forceinline__ unsigned lbp_bits_f32(const float* __restrict__ ctr, int pitch, int p,
                                                 const LbpParams& prm) {
  const float c = ctr[0];
  float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  unsigned bits = 0;
#pragma unroll
  for (int s = 0; s < (P ? P : MAX_P); ++s) {
    if (!P && s >= p) break;
    const float* at = ctr + prm.corner[s][0] * pitch + prm.corner[s][1];
    float e[4];
    switch (s == 0 ? NONE : prm.relation[s]) {
      case SAME:
        e[0] = d[0]; e[1] = d[1]; e[2] = d[2]; e[3] = d[3];
        break;
      case RIGHT:
        e[0] = d[1]; e[2] = d[3];
        e[1] = __fsub_rn(at[1], c); e[3] = __fsub_rn(at[pitch + 1], c);
        break;
      case LEFT:
        e[1] = d[0]; e[3] = d[2];
        e[0] = __fsub_rn(at[0], c); e[2] = __fsub_rn(at[pitch], c);
        break;
      case DOWN:
        e[0] = d[2]; e[1] = d[3];
        e[2] = __fsub_rn(at[pitch], c); e[3] = __fsub_rn(at[pitch + 1], c);
        break;
      case UP:
        e[2] = d[0]; e[3] = d[1];
        e[0] = __fsub_rn(at[0], c); e[1] = __fsub_rn(at[1], c);
        break;
      default:
        e[0] = __fsub_rn(at[0], c); e[1] = __fsub_rn(at[1], c);
        e[2] = __fsub_rn(at[pitch], c); e[3] = __fsub_rn(at[pitch + 1], c);
    }
    const float* wt = prm.weight[s];
    float acc = __fmaf_rn(e[0], wt[0], __fmul_rn(e[1], wt[1]));
    acc = __fmaf_rn(e[2], wt[2], acc);
    acc = __fmaf_rn(e[3], wt[3], acc);
    bits |= static_cast<unsigned>(acc >= 0.0f) << s;
    d[0] = e[0]; d[1] = e[1]; d[2] = e[2]; d[3] = e[3];
  }
  return bits;
}

// The float64 sample bits of pixel (y, x) of the frame, its tile origin at
// (ty0, tx0) (the frame coordinates of the tile's first row and column).
template <int P>
__device__ __forceinline__ unsigned lbp_bits_f64(const double* __restrict__ tile, int pitch, int y, int x, int ty0,
                                                 int tx0, int pad, int p, const LbpParams& prm) {
  const double c = tile[(y - ty0) * pitch + (x - tx0)];
  unsigned bits = 0;
#pragma unroll
  for (int s = 0; s < (P ? P : MAX_P); ++s) {
    if (!P && s >= p) break;
    const double ry = __dadd_rn(static_cast<double>(y + pad), prm.offset[s][0]);
    const double cx = __dadd_rn(static_cast<double>(x + pad), prm.offset[s][1]);
    const double fy0 = floor(ry), fx0 = floor(cx);
    const double fy = __dsub_rn(ry, fy0), fx = __dsub_rn(cx, fx0);
    const double* at = tile + (static_cast<int>(fy0) - pad - ty0) * pitch + (static_cast<int>(fx0) - pad - tx0);
    const double gy = __dsub_rn(1.0, fy), gx = __dsub_rn(1.0, fx);
    double val = __dmul_rn(__dmul_rn(at[0], gy), gx);
    val = __dadd_rn(val, __dmul_rn(__dmul_rn(at[1], gy), fx));
    val = __dadd_rn(val, __dmul_rn(__dmul_rn(at[pitch], fy), gx));
    val = __dadd_rn(val, __dmul_rn(__dmul_rn(at[pitch + 1], fy), fx));
    bits |= static_cast<unsigned>(val >= c) << s;
  }
  return bits;
}

// A block: LBP_COLS x LBP_ROWS pixels; a warp a row at a time, a lane the
// pixels lane, lane + 32, lane + 64 and lane + 96 of it.
template <bool GOLDEN, typename T, int P, bool MAIN>
__global__ void __launch_bounds__(LBP_THREADS)
lbp_codes_kernel(const T* __restrict__ src, uint8_t* __restrict__ dst, const __grid_constant__ LbpParams prm, int h,
                 int w, int p, int pad, int pitch) {
  using V = typename std::conditional<GOLDEN, double, float>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  V* tile = reinterpret_cast<V*>(smem);
  const int x0 = blockIdx.x * LBP_COLS, y0 = blockIdx.y * LBP_ROWS;
  const int ty0 = y0 - pad, tx0 = x0 - pad;
  const int tile_rows = LBP_ROWS + 2 * pad, tile_cols = LBP_COLS + 2 * pad;
  const long long frame = static_cast<long long>(blockIdx.z) * h * w;
  const T* in = src + frame;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // edge-clamped, as the reference pads by pad with edge values
  for (int r = warp; r < tile_rows; r += LBP_THREADS / 32) {
    const long long row = static_cast<long long>(clampi(ty0 + r, h - 1)) * w;
    for (int c = lane; c < tile_cols; c += 32)
      tile[r * pitch + c] = static_cast<V>(in[row + clampi(tx0 + c, w - 1)]);
  }
  __syncthreads();
  uint8_t* out = dst + frame;
  for (int r = warp; r < LBP_ROWS; r += LBP_THREADS / 32) {
    const int y = y0 + r;
    if (y >= h) break;
#pragma unroll 1
    for (int k = 0; k < LBP_COLS / 32; ++k) {
      const int x = x0 + lane + 32 * k;
      if (x >= w) break;
      unsigned bits;
      if constexpr (GOLDEN)
        bits = lbp_bits_f64<P>(tile, pitch, y, x, ty0, tx0, pad, p, prm);
      else if constexpr (MAIN)
        bits = lbp_bits_main(tile + (r + pad) * pitch + (x - tx0), pitch, prm);
      else
        bits = lbp_bits_f32<P>(tile + (r + pad) * pitch + (x - tx0), pitch, p, prm);
      out[static_cast<long long>(y) * w + x] = static_cast<uint8_t>(lbp_code(bits, p));
    }
  }
}

template <bool GOLDEN, typename T, int P, bool MAIN = false>
cudaError_t lbp_launch(const void* src, void* dst, const LbpParams& prm, int n, int h, int w, int p, int pad,
                       cudaStream_t stream) {
  const int pitch = LBP_COLS + 2 * pad;
  const long long bytes = static_cast<long long>(LBP_ROWS + 2 * pad) * pitch * (GOLDEN ? 8 : 4);
  if (bytes > 232448) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(lbp_codes_kernel<GOLDEN, T, P, MAIN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((w + LBP_COLS - 1) / LBP_COLS, (h + LBP_ROWS - 1) / LBP_ROWS, n);
  lbp_codes_kernel<GOLDEN, T, P, MAIN><<<grid, LBP_THREADS, bytes, stream>>>(
      static_cast<const T*>(src), static_cast<uint8_t*>(dst), prm, h, w, p, pad, pitch);
  return cudaGetLastError();
}

template <bool GOLDEN, typename T>
cudaError_t lbp_samples(const void* src, void* dst, const LbpParams& prm, int n, int h, int w, int p, int pad,
                        cudaStream_t stream) {
  if (!GOLDEN && is_main_geometry(prm, p)) return lbp_launch<false, T, MAIN_P, true>(src, dst, prm, n, h, w, p, pad, stream);
  switch (p) {
    case 8: return lbp_launch<GOLDEN, T, 8>(src, dst, prm, n, h, w, p, pad, stream);
    case 16: return lbp_launch<GOLDEN, T, 16>(src, dst, prm, n, h, w, p, pad, stream);
    case 24: return lbp_launch<GOLDEN, T, 24>(src, dst, prm, n, h, w, p, pad, stream);
    default: return lbp_launch<GOLDEN, T, 0>(src, dst, prm, n, h, w, p, pad, stream);
  }
}

template <typename T>
cudaError_t lbp_arith(const void* src, void* dst, const LbpParams& prm, int n, int h, int w, int p, int pad, int golden,
                      cudaStream_t stream) {
  return golden ? lbp_samples<true, T>(src, dst, prm, n, h, w, p, pad, stream)
                : lbp_samples<false, T>(src, dst, prm, n, h, w, p, pad, stream);
}

}  // namespace

namespace {

// How many blocks of the GLCM kernel the current device holds at once (the
// cooperative launch's grid at most).
cudaError_t glcm_resident_blocks(int* blocks) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaFuncSetAttribute(glcm_counts_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         GLCM_WORDS * 4);
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, glcm_counts_kernel, GLCM_THREADS, GLCM_WORDS * 4);
  *blocks = per_sm * sms;
  return err;
}

}  // namespace

// src: (n, h, w) uint8; out: (n, 256, 256) int32, any contents (the kernel
// zeroes it).  The window where both pixels of a pair lie in the frame must
// not be empty.  One cooperative launch.
extern "C" int yam_glcm_counts(const void* src, void* out, int n, int h, int w, int dx, int dy, void* stream) {
  const int r0 = dy < 0 ? -dy : 0, r1 = dy < 0 ? h : h - dy;
  const int c0 = dx < 0 ? -dx : 0, c1 = dx < 0 ? w : w - dx;
  if (n < 1 || n > 65535 || r1 <= r0 || c1 <= c0) return static_cast<int>(cudaErrorInvalidValue);
  int resident = 0;
  const cudaError_t err = glcm_resident_blocks(&resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (resident < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  GlcmPlan plan = glcm_plan(n, r0, c0, r1 - r0, c1 - c0, resident);
  const unsigned grid = static_cast<unsigned>(plan.units < resident ? plan.units : resident);
  const uint8_t* s = static_cast<const uint8_t*>(src);
  int* o = static_cast<int*>(out);
  void* args[] = {&s, &o, &n, &h, &w, &dx, &dy, &plan};
  const cudaError_t launched = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(glcm_counts_kernel),
                                                           dim3(grid), dim3(GLCM_THREADS), args, GLCM_WORDS * 4,
                                                           static_cast<cudaStream_t>(stream));
  if (launched != cudaSuccess) {
    cudaGetLastError();  // a refused launch leaves its error behind for the next launch's check: take it
    return static_cast<int>(launched);
  }
  return static_cast<int>(cudaGetLastError());
}

// src: (n, h, w) of kind 0 uint8, 1 uint16 or 2 float32; dst: (n, h, w)
// uint8.  Host arrays of the p <= 32 samples: corners int32 (p, 2), weights
// float32 (p, 4) and relations int32 (p) (the float32 path's), offsets
// float64 (p, 2) (the float64 path's); they travel as a kernel parameter.
extern "C" int yam_lbp_codes(const void* src, void* dst, const int* corners, const float* weights,
                             const int* relations, const double* offsets, int n, int h, int w, int p, int pad,
                             int golden, int kind, void* stream) {
  if (n < 1 || n > 65535 || h < 1 || w < 1 || p < 1 || p > MAX_P || pad < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  LbpParams prm = {};
  for (int s = 0; s < p; ++s) {
    for (int k = 0; k < 2; ++k) {
      prm.corner[s][k] = corners[2 * s + k];
      prm.offset[s][k] = offsets[2 * s + k];
    }
    for (int k = 0; k < 4; ++k) prm.weight[s][k] = weights[4 * s + k];
    prm.relation[s] = relations[s];
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case 0: return static_cast<int>(lbp_arith<uint8_t>(src, dst, prm, n, h, w, p, pad, golden, st));
    case 1: return static_cast<int>(lbp_arith<uint16_t>(src, dst, prm, n, h, w, p, pad, golden, st));
    case 2: return static_cast<int>(lbp_arith<float>(src, dst, prm, n, h, w, p, pad, golden, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
