// Contour tracing of the extraction stage: the outer boundary of every
// 8-connected region of a batch of compact raster-first label maps, in
// Moore order.  It replaces no pallas_call: the reference traces on the host
// (yamimageprocessor_tpu/ops/shape.py:107 trace_external_contours, a
// sequential walk in Python) and this kernel reproduces that walk exactly:
//
// - a region starts at its raster-first pixel; the first search starts with
//   backtrack direction 6 (entered from the left), and a region with no
//   neighbour of its own is one point;
// - at each step the next pixel is the first neighbour of the region
//   clockwise after the backtrack direction (directions 0..7: up, up-right,
//   right, down-right, down, down-left, left, up-left); a neighbour outside
//   the frame reads as background;
// - Jacob's stop: the walk ends on re-entering the start pixel with the same
//   next pixel as the first visit; passing through the start with another
//   next pixel appends the start again;
// - a safety bound of 8 * (pixels + 1) steps.
//
// Four launches a call:
//
// 1. contour_seed_kernel: a warp a chunk of a row, reading the labels once
//    with coalesced loads; each region's start (its raster-first pixel, the
//    first pixel of a run: atomicMin of y * w + x) and pixel count (atomics
//    at the runs' ends, not a pixel), and the foreground packed as bits, a
//    __ballot_sync a word;
// 2. contour_neighbours_kernel: every foreground pixel's 8-bit mask of
//    foreground neighbours, one byte a pixel, a thread a word of the packed
//    bits (its eight directions as bit planes of three rows' words);
// 3. contour_walk_kernel<false>: a thread a (frame, label) walks its region
//    and writes its point count (0 for a label the frame lacks);
// 4. after an exclusive scan of the counts (torch.cumsum on the card), the
//    same walk again, contour_walk_kernel<true>, writes the (x, y) points at
//    the region's offset and the doubled shoelace area |sum x_i y_(i+1) -
//    y_i x_(i+1)| in int64, exact (0 below three points), which is
//    2 * contour_area of the reference's points bit for bit.
//
// Bound on the card: the label map read once, and the longest contour's
// chain of dependent steps.  The walk is latency-bound: one thread follows
// one boundary, and each step waits on the step before.  So the step is kept
// short: one byte load at the flat index (the neighbourhood formed in the
// parallel pass 2), the next direction by a rotate and __ffs, the index
// moved by the direction's packed row and column steps (no table).

#include <cstdint>
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int SEED_THREADS = 256;
constexpr int NB_THREADS = 32;  // a row of a 1024-wide frame holds 32 mask words
// a walk's step is one dependent load: a warp's lanes walk different
// regions, and a load of 32 lanes waits on 32 scattered lines, so a block
// holds few walkers and the walks spread over every SM
constexpr int WALK_THREADS = 8;

// A warp a chunk of 1024 pixels of one row (32 rounds of 32 consecutive
// pixels, coalesced): each round's foreground is one __ballot_sync, the
// chunk's 32 words of the packed mask written by the lanes at the end; a
// pixel whose left neighbour differs starts a run (atomicMin of its flat
// index into its region's start, minus its x into its region's pixel
// count), a pixel whose right neighbour differs ends one (x + 1 into the
// count), so a region costs three atomics a run.
__global__ void contour_seed_kernel(const int* __restrict__ labels, int* __restrict__ start,
                                    int* __restrict__ pixels, unsigned* __restrict__ mask, int n, int h, int w,
                                    int wpr, int nseg) {
  const int lane = threadIdx.x & 31;
  const int chunks = (w + 1023) / 1024;
  const long long tasks = static_cast<long long>(n) * h * chunks;
  const long long warps = static_cast<long long>(gridDim.x) * (blockDim.x >> 5);
  for (long long t = static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + (threadIdx.x >> 5); t < tasks;
       t += warps) {
    const int chunk = static_cast<int>(t % chunks);
    const long long row = t / chunks;  // frame * h + y
    const int y = static_cast<int>(row % h);
    const long long frame = row / h;
    const int* lab = labels + row * w;
    const int x0 = chunk * 1024;
    int v[32];  // the chunk's 32 rounds loaded before any is used: 32 loads in flight a lane
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int x = x0 + 32 * i + lane;
      v[i] = x < w ? __ldg(lab + x) : 0;
    }
    const int after = x0 + 1024 < w ? __ldg(lab + x0 + 1024) : 0;  // the label right of the chunk
    int carry = x0 > 0 ? __ldg(lab + x0 - 1) : 0;                   // the label left of a round's lane 0
    unsigned word = 0;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int x = x0 + 32 * i + lane;
      const unsigned bits = __ballot_sync(0xffffffffu, v[i] > 0);
      if (lane == i) word = bits;
      const int up = __shfl_up_sync(0xffffffffu, v[i], 1);
      const int left = lane == 0 ? carry : up;
      const int down = __shfl_down_sync(0xffffffffu, v[i], 1);
      const int next = i < 31 ? __shfl_sync(0xffffffffu, v[i + 1 < 32 ? i + 1 : 31], 0) : after;
      const int right = lane == 31 ? next : down;
      carry = __shfl_sync(0xffffffffu, v[i], 31);
      if (v[i] > 0) {
        const long long slot = frame * nseg + v[i];
        if (left != v[i]) {
          atomicMin(start + slot, y * w + x);
          atomicAdd(pixels + slot, -x);
        }
        if (right != v[i]) atomicAdd(pixels + slot, x + 1);
      }
    }
    const int q = x0 / 32 + lane;
    if (q < wpr) mask[row * wpr + q] = word;
  }
}

// the words of row y around word q of the packed mask (0 outside the
// frame): the word, and its left and right neighbours
struct Words {
  unsigned left, mid, right;
};
__device__ __forceinline__ Words row_words(const unsigned* __restrict__ m, int h, int wpr, int y, int q) {
  if (y < 0 || y >= h) return {0u, 0u, 0u};
  const unsigned* row = m + static_cast<long long>(y) * wpr;
  return {q > 0 ? __ldg(row + q - 1) : 0u, __ldg(row + q), q + 1 < wpr ? __ldg(row + q + 1) : 0u};
}

// bit j of the word's column x - 1 or x + 1, for each pixel j of the word
__device__ __forceinline__ unsigned west(Words r) { return (r.mid << 1) | (r.left >> 31); }
__device__ __forceinline__ unsigned east(Words r) { return (r.mid >> 1) | (r.right << 31); }

// every pixel's 8-bit foreground neighbour mask (0 for a background pixel),
// bit d for direction d, a thread a word of the packed mask (32 pixels):
// the 8 directions as bit planes of the three rows' words, then each
// pixel's byte gathered from bit j of the planes and stored 16 bytes at a
// time where the row's bytes allow.  A foreground 8-neighbour of a
// region's pixel is of the same region (regions are 8-connected
// components), so the masks stand for the reference's label comparison.
__global__ void contour_neighbours_kernel(const unsigned* __restrict__ mask, unsigned char* __restrict__ nb,
                                          int rows, int h, int w, int wpr) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= wpr) return;
  for (int row = blockIdx.y; row < rows; row += gridDim.y) {  // frame * h + y
    const int frame = static_cast<unsigned>(row) / static_cast<unsigned>(h);
    const int y = row - frame * h;
    const unsigned* m = mask + static_cast<long long>(frame) * h * wpr;
    const Words up = row_words(m, h, wpr, y - 1, q), mid = row_words(m, h, wpr, y, q),
                down = row_words(m, h, wpr, y + 1, q);
    const unsigned plane[8] = {up.mid, east(up), east(mid), east(down), down.mid, west(down), west(mid), west(up)};
    unsigned char* out = nb + static_cast<long long>(row) * w + 32 * q;
    const int count = w - 32 * q < 32 ? w - 32 * q : 32;
    unsigned packed[8];  // bytes j of the word, four to a 32-bit word
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      unsigned word = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int j = 4 * k + b;
        unsigned byte = 0;
#pragma unroll
        for (int d = 0; d < 8; ++d) byte |= ((plane[d] >> j) & 1u) << d;
        byte &= 0u - ((mid.mid >> j) & 1u);  // a background pixel's byte is 0
        word |= byte << (8 * b);
      }
      packed[k] = word;
    }
    if (count == 32 && (reinterpret_cast<uintptr_t>(out) & 15u) == 0) {
      reinterpret_cast<uint4*>(out)[0] = make_uint4(packed[0], packed[1], packed[2], packed[3]);
      reinterpret_cast<uint4*>(out)[1] = make_uint4(packed[4], packed[5], packed[6], packed[7]);
    } else {
      for (int j = 0; j < count; ++j) out[j] = static_cast<unsigned char>(packed[j >> 2] >> (8 * (j & 3)));
    }
  }
}

// direction d's row and column steps, (dy + 1) and (dx + 1) packed two bits
// a direction: no table lookup on the walk's chain
__device__ __forceinline__ int step_y(int d) { return static_cast<int>((0x1a90u >> (2 * d)) & 3u) - 1; }
__device__ __forceinline__ int step_x(int d) { return static_cast<int>((0x01a9u >> (2 * d)) & 3u) - 1; }

// the first direction of the region clockwise after `prev`, or -1
__device__ __forceinline__ int next_direction(unsigned m, int prev) {
  const int s = (prev + 1) & 7;
  const unsigned r = ((m >> s) | (m << (8 - s))) & 0xffu;
  if (r == 0) return -1;
  return (s + __ffs(r) - 1) & 7;
}

template <bool WRITE>
__global__ void contour_walk_kernel(const unsigned char* __restrict__ nb, const int* __restrict__ start,
                                    const int* __restrict__ pixels, int* __restrict__ counts,
                                    const long long* __restrict__ offsets, int* __restrict__ points,
                                    long long* __restrict__ area2, int n, int h, int w, int nseg) {
  const long long slot = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (slot >= static_cast<long long>(n) * nseg) return;
  const int region = static_cast<int>(slot % nseg);
  const int s = region == 0 ? INT_MAX : start[slot];
  if (s == INT_MAX) {  // label 0, or a label this frame lacks
    if (!WRITE) counts[slot] = 0;
    else area2[slot] = 0;
    return;
  }
  const unsigned char* frame = nb + (slot / nseg) * static_cast<long long>(h) * w;
  const int sy = s / w, sx = s % w;
  const long long max_steps = 8LL * (static_cast<long long>(pixels[slot]) + 1);
  long long count = 0;
  int* out = WRITE ? points + 2 * offsets[slot] : nullptr;
  long long shoelace = 0;
  int px = sx, py = sy;  // the last point emitted
  auto emit = [&](int y, int x) {
    if (WRITE) {
      out[2 * count] = x;
      out[2 * count + 1] = y;
      if (count > 0) shoelace += static_cast<long long>(px) * y - static_cast<long long>(py) * x;
      px = x;
      py = y;
    }
    ++count;
  };
  emit(sy, sx);
  int d = next_direction(__ldg(frame + s), 6);
  if (d >= 0) {
    const int first = s + step_y(d) * w + step_x(d);  // the first move's flat index
    int at = first, cy = sy + step_y(d), cx = sx + step_x(d), prev = (d + 4) & 7;
    for (long long step = 0; step < max_steps; ++step) {
      d = next_direction(__ldg(frame + at), prev);
      // Jacob's stop: the start again, the first move next
      if (at == s && (d < 0 || at + step_y(d) * w + step_x(d) == first)) break;
      emit(cy, cx);
      if (d < 0) break;
      at += step_y(d) * w + step_x(d);
      cy += step_y(d);
      cx += step_x(d);
      prev = (d + 4) & 7;
    }
  }
  if (WRITE) {
    shoelace += static_cast<long long>(px) * sy - static_cast<long long>(py) * sx;  // close the ring
    area2[slot] = count < 3 ? 0 : (shoelace < 0 ? -shoelace : shoelace);
  } else {
    counts[slot] = static_cast<int>(count);
  }
}

}  // namespace

// labels: (n, h, w) int32 compact labels; start, pixels: (n, nseg) int32,
// start filled with INT_MAX and pixels with 0 by the caller; mask: (n, h,
// (w + 31) / 32) uint32 and nb: (n, h, w) uint8, every element written here.
extern "C" int yam_contour_seed(const void* labels, void* start, void* pixels, void* mask, void* nb, int n, int h,
                                int w, int nseg, void* stream) {
  if (n < 1 || n > 65535 || h < 1 || w < 1 || nseg < 1 || static_cast<long long>(h) * w > INT_MAX / 2 ||
      static_cast<long long>(n) * h > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long tasks = static_cast<long long>(n) * h * ((w + 1023) / 1024);
  const long long warps = SEED_THREADS / 32;
  long long blocks = (tasks + warps - 1) / warps;
  if (blocks > 132 * 16) blocks = 132 * 16;  // a grid-stride loop over the rows' chunks
  contour_seed_kernel<<<static_cast<unsigned>(blocks), SEED_THREADS, 0, st>>>(
      static_cast<const int*>(labels), static_cast<int*>(start), static_cast<int*>(pixels),
      static_cast<unsigned*>(mask), n, h, w, (w + 31) / 32, nseg);
  const int rows = n * h;
  const int wpr = (w + 31) / 32;
  const dim3 nb_grid((wpr + NB_THREADS - 1) / NB_THREADS, rows < 65535 ? rows : 65535);
  contour_neighbours_kernel<<<nb_grid, NB_THREADS, 0, st>>>(static_cast<const unsigned*>(mask),
                                                            static_cast<unsigned char*>(nb), rows, h, w, wpr);
  return static_cast<int>(cudaGetLastError());
}

// The walk over every (frame, label) slot on the neighbour masks: with
// offsets null it writes the (n, nseg) int32 point counts; else the points
// (int32 (x, y) pairs at offsets[slot], the exclusive scan of the counts,
// int64) and the (n, nseg) int64 doubled areas.
extern "C" int yam_contour_walk(const void* nb, const void* start, const void* pixels, void* counts,
                                const void* offsets, void* points, void* area2, int n, int h, int w, int nseg,
                                void* stream) {
  if (n < 1 || n > 65535 || h < 1 || w < 1 || nseg < 1 || static_cast<long long>(h) * w > INT_MAX / 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long slots = static_cast<long long>(n) * nseg;
  const unsigned grid = static_cast<unsigned>((slots + WALK_THREADS - 1) / WALK_THREADS);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned char* m = static_cast<const unsigned char*>(nb);
  const int* s = static_cast<const int*>(start);
  const int* px = static_cast<const int*>(pixels);
  if (offsets == nullptr)
    contour_walk_kernel<false><<<grid, WALK_THREADS, 0, st>>>(m, s, px, static_cast<int*>(counts), nullptr,
                                                             nullptr, nullptr, n, h, w, nseg);
  else
    contour_walk_kernel<true><<<grid, WALK_THREADS, 0, st>>>(m, s, px, nullptr,
                                                            static_cast<const long long*>(offsets),
                                                            static_cast<int*>(points),
                                                            static_cast<long long*>(area2), n, h, w, nseg);
  return static_cast<int>(cudaGetLastError());
}
