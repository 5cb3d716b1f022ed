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
// into two full-frame weight maps.  Here a thread reads the four corner
// tables directly (uint8 tables through the read-only cache; at grid 64 a
// frame's tables are 1 MB, too large for shared memory, and the corners a
// block touches are few) and the per-row and per-column indices and
// fractions from small arrays.  Four pixels a thread, with 4-byte loads and
// stores where rows and pointers allow.
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
// Bound on the card: device memory.  The histogram reads 1 byte a pixel
// and writes 1 KB a tile; the blend reads 1 byte a pixel and writes 1.

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

struct Row {
  const uint8_t* top;     // tables of tile row y0: gw tables of 256 bytes
  const uint8_t* bottom;  // tables of tile row y1
  float fy;
  float gy;  // 1 - fy
};

__device__ __forceinline__ uint32_t blend_one(uint32_t v, const Row& row, int x0, int x1,
                                              float fx) {
  const float gx = __fsub_rn(1.0f, fx);
  const float w00 = __fmul_rn(row.gy, gx);
  const float w01 = __fmul_rn(row.gy, fx);
  const float w10 = __fmul_rn(row.fy, gx);
  const float w11 = __fmul_rn(row.fy, fx);
  const float t00 = static_cast<float>(__ldg(row.top + x0 * 256 + v));
  const float t01 = static_cast<float>(__ldg(row.top + x1 * 256 + v));
  const float t10 = static_cast<float>(__ldg(row.bottom + x0 * 256 + v));
  const float t11 = static_cast<float>(__ldg(row.bottom + x1 * 256 + v));
  const float sum =
      __fmaf_rn(w11, t11, __fmaf_rn(w10, t10, __fmaf_rn(w00, t00, __fmul_rn(w01, t01))));
  return static_cast<uint32_t>(fminf(fmaxf(rintf(sum), 0.0f), 255.0f));
}

// Grid (column blocks, output rows, frames); V pixels a thread (4 or 1).
// Reads row r, columns [0, w_out) of a (height, width) frame and writes an
// (h_out, w_out) frame: the crop back from the padded grid is free.
template <int V>
__global__ void __launch_bounds__(THREADS)
    clahe_blend_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                       const uint8_t* __restrict__ luts, const int* __restrict__ y0,
                       const int* __restrict__ y1, const float* __restrict__ fy,
                       const int* __restrict__ x0, const int* __restrict__ x1,
                       const float* __restrict__ fx, int height, int width, int h_out,
                       int w_out, int gh, int gw) {
  const int col = (blockIdx.x * THREADS + threadIdx.x) * V;
  if (col >= w_out) return;
  const int r = blockIdx.y;
  const long long frame = blockIdx.z;
  const uint8_t* tables = luts + frame * gh * gw * 256;
  Row row;
  row.top = tables + static_cast<long long>(__ldg(y0 + r)) * gw * 256;
  row.bottom = tables + static_cast<long long>(__ldg(y1 + r)) * gw * 256;
  row.fy = __ldg(fy + r);
  row.gy = __fsub_rn(1.0f, row.fy);
  const uint8_t* src = in + (frame * height + r) * width + col;
  uint8_t* dst = out + (frame * h_out + r) * w_out + col;

  if constexpr (V == 4) {
    const uint32_t v = __ldg(reinterpret_cast<const unsigned int*>(src));
    uint32_t o = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int c = col + k;
      o |= blend_one((v >> (8 * k)) & 255u, row, __ldg(x0 + c), __ldg(x1 + c), __ldg(fx + c))
           << (8 * k);
    }
    *reinterpret_cast<uint32_t*>(dst) = o;
  } else {
    *dst = static_cast<uint8_t>(
        blend_one(__ldg(src), row, __ldg(x0 + col), __ldg(x1 + col), __ldg(fx + col)));
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
// entries, x0, x1 and fx w_out.  vec: 4 or 1 pixels a thread.
extern "C" int yam_clahe_blend_u8(const void* in, void* out, const void* luts, const void* y0,
                                  const void* y1, const void* fy, const void* x0, const void* x1,
                                  const void* fx, int n, int height, int width, int h_out,
                                  int w_out, int gh, int gw, int vec, void* stream) {
  const int per_block = THREADS * vec;
  const dim3 grid((w_out + per_block - 1) / per_block, h_out, n);
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
  if (vec == 4)
    clahe_blend_kernel<4><<<grid, THREADS, 0, s>>>(src, dst, tables, ry0, ry1, rfy, cx0, cx1,
                                                   cfx, height, width, h_out, w_out, gh, gw);
  else if (vec == 1)
    clahe_blend_kernel<1><<<grid, THREADS, 0, s>>>(src, dst, tables, ry0, ry1, rfy, cx0, cx1,
                                                   cfx, height, width, h_out, w_out, gh, gw);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
