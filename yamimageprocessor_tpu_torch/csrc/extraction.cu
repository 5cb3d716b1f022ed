// Per-region work of the region-properties extraction: row extremes,
// moment and perimeter sums, filled convex-hull pixel counts and the
// annotation, over int32 label frames (N, H, W) whose regions are numbered
// 1..R (0 is background).  Per-region outputs are (N, nseg, ...) with
// nseg = R + 1, region 0 unused.
//
// Replaces XLA code of the JAX package, not a pallas_call:
// yamimageprocessor_tpu/ops/regionprops.py row_extremes_j (:196),
// _moment_sums_matmul (:369) with _perimeter_weights_j (:500),
// hull_pixel_areas_j / _hull_areas_compact / _hull_areas_chains (:574-812),
// and ops/extraction_device.py region_annotate_j (:90).  The TPU has no
// scatter, so the reference reduces every region through one-hot matmuls
// and compare-select sweeps, O(H*W*capacity) work under a static capacity
// ladder (64/512/1024 regions), gift-wraps hulls under a 64-vertex cap and
// paints the annotation region by region over the whole frame.  Here the
// card scatters with atomics, so the work is O(H*W) at any region count,
// and every sum is an integer, exact in any order of the atomics.
//
// row_extremes_kernel (A)  a warp takes 32 pixels of a row; each run of one
//     label costs one atomicMin of its first column and one atomicMax of
//     its last into mn/mx[frame, label, row].  Bound: device memory, 4 B a
//     pixel read, the (N, nseg, H) extremes written once.
// moment_sums_kernel (B)  a block a 32 x 64 tile, labels staged in shared
//     memory with a 2-pixel halo (a pixel's perimeter category counts the
//     border flags of its neighbours, and a border flag needs their
//     neighbours).  A warp takes 32 pixels of a row; a run of one label is
//     summed in closed form from its length and first column (dr is
//     constant along a row, dc an arithmetic series), its perimeter
//     categories by popcounts of ballots.  The run's sums go into a
//     256-slot table of the regions the block meets (shared-memory 64-bit
//     atomics), flushed into sums[frame, label, 0..8] with global atomics
//     (a region the table cannot hold adds directly).  Columns: area,
//     Sum a, Sum b, Sum a^2, Sum b^2, Sum a*b, n1, n2, n3, where a = 2r -
//     (minr + maxr) and b = 2c - (minc + maxc) are twice the offsets from
//     the bbox centre, and n1/n2/n3 count skimage's perimeter categories
//     of weight 1, sqrt(2) and (1 + sqrt(2))/2.  Bound: device memory.
// hull_areas_kernel (C)  a warp a (frame, region).  The region's rows
//     minr..maxr of mx (then of -mn) come in 32 at a time; lane 0 runs
//     Andrew's monotone chain over them with exact int64 cross products,
//     the stack in global scratch (its top two in registers); then the
//     lanes share the rows of each hull edge and add floor(X(t)) as an
//     exact integer floor division.  width(t) = floor(RX) + floor(-LX) + 1.
//     No vertex cap, no coordinate limit below 2^31.  Bound: the serial
//     chain (latency), not bytes: one lane walks every row of its region.
// annotate_paint_kernel / annotate_colour_kernel (D)  a block a valid
//     (frame, region) writes paint keys into an int32 plane with atomicMax:
//     2L on its two nested bbox outlines (clipped as region_annotate_j's
//     border_mask clips them), 2L + 1 on its radius-3 disk; then one
//     elementwise pass copies a pixel's bytes from the green colour for an
//     even key, the red one for an odd key (BGR (0,255,0) and (0,0,255),
//     gray 85 for both, in the frame's dtype, from the wrapper), and from
//     the input where the key is 0.  The largest key is the reference's
//     last painter (later region over earlier, disk over border): O(sum of
//     outlines), not O(H*W*R).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BIG = 1 << 30;  // mn of a row without the region
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_FRAMES = 65535;  // gridDim.y
constexpr int GRID_CAP = 132 * 64;

// ---------------------------------------------------------------------------
// A: row extremes

constexpr int EXT_THREADS = 256;

__global__ void __launch_bounds__(EXT_THREADS) row_extremes_kernel(const int* __restrict__ lab, int* __restrict__ mn,
                                                                   int* __restrict__ mx, long long rows, int h, int w,
                                                                   int nseg) {
  const int lane = threadIdx.x & 31;
  const int chunks = (w + 31) / 32;
  const long long tasks = rows * chunks;
  const long long nwarps = static_cast<long long>(gridDim.x) * (EXT_THREADS / 32);
  for (long long t = blockIdx.x * static_cast<long long>(EXT_THREADS / 32) + threadIdx.x / 32; t < tasks;
       t += nwarps) {
    const long long row = t / chunks;  // frame * h + r
    const int c = static_cast<int>(t - row * chunks) * 32 + lane;
    const int label = c < w ? __ldg(lab + row * w + c) : 0;
    const int left = __shfl_up_sync(FULL, label, 1);
    const int right = __shfl_down_sync(FULL, label, 1);
    if (label <= 0 || label >= nseg) continue;
    const long long frame = row / h;
    const long long at = (frame * nseg + label) * h + (row - frame * h);
    if (lane == 0 || left != label) atomicMin(mn + at, c);
    if (lane == 31 || right != label) atomicMax(mx + at, c);
  }
}

// ---------------------------------------------------------------------------
// B: moment and perimeter sums

constexpr int MT_ROWS = 32;
constexpr int MT_COLS = 64;
constexpr int MT_THREADS = 256;
constexpr int SLOTS = 256;            // regions a block's table holds
constexpr int SUMS = 9;               // columns of sums
constexpr int LR = MT_ROWS + 4;       // staged labels: 2-pixel halo
constexpr int LC = MT_COLS + 4;
constexpr int BR = MT_ROWS + 2;       // border flags: 1-pixel halo
constexpr int BC = MT_COLS + 2;

__global__ void __launch_bounds__(MT_THREADS)
    moment_sums_kernel(const int* __restrict__ lab, const int* __restrict__ sr2, const int* __restrict__ sc2,
                       unsigned long long* __restrict__ sums, int h, int w, int nseg, int tiles_x) {
  __shared__ int s_lab[LR * LC];
  __shared__ unsigned char s_border[BR * BC];
  __shared__ int s_key[SLOTS];
  __shared__ unsigned long long s_val[SUMS * SLOTS];

  const long long frame = blockIdx.y;
  const int y0 = static_cast<int>(blockIdx.x / tiles_x) * MT_ROWS;
  const int x0 = static_cast<int>(blockIdx.x % tiles_x) * MT_COLS;
  const int* f = lab + frame * h * static_cast<long long>(w);
  for (int i = threadIdx.x; i < LR * LC; i += MT_THREADS) {
    const int y = y0 - 2 + i / LC, x = x0 - 2 + i % LC;
    s_lab[i] = (y >= 0 && y < h && x >= 0 && x < w) ? __ldg(f + static_cast<long long>(y) * w + x) : 0;
  }
  for (int i = threadIdx.x; i < SLOTS; i += MT_THREADS) s_key[i] = 0;
  for (int i = threadIdx.x; i < SUMS * SLOTS; i += MT_THREADS) s_val[i] = 0;
  __syncthreads();
  // border: a region pixel with a 4-neighbour of another label (outside
  // the frame is 0)
  for (int i = threadIdx.x; i < BR * BC; i += MT_THREADS) {
    const int* p = s_lab + (i / BC + 1) * LC + i % BC + 1;
    const int v = *p;
    s_border[i] = v > 0 && !(p[-LC] == v && p[LC] == v && p[-1] == v && p[1] == v);
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  for (int task = threadIdx.x / 32; task < MT_ROWS * (MT_COLS / 32); task += MT_THREADS / 32) {
    const int r = task / (MT_COLS / 32);
    const int cl = (task % (MT_COLS / 32)) * 32 + lane;
    const int y = y0 + r, x = x0 + cl;
    const int* p = s_lab + (r + 2) * LC + cl + 2;
    const unsigned char* b = s_border + (r + 1) * BC + cl + 1;
    const int label = (y < h && x < w) ? *p : 0;
    const bool ok = label > 0 && label < nseg;
    int cls = 0;  // 1: weight 1, 2: sqrt(2), 3: (1 + sqrt(2)) / 2
    if (ok && *b) {
      const int orth = (p[-LC] == label && b[-BC]) + (p[LC] == label && b[BC]) + (p[-1] == label && b[-1]) +
                       (p[1] == label && b[1]);
      const int diag = (p[-LC - 1] == label && b[-BC - 1]) + (p[-LC + 1] == label && b[-BC + 1]) +
                       (p[LC - 1] == label && b[BC - 1]) + (p[LC + 1] == label && b[BC + 1]);
      if (orth >= 2 && orth <= 3 && diag <= 2)
        cls = 1;
      else if ((orth == 0 && diag == 2) || (orth == 1 && diag == 3))
        cls = 2;
      else if (orth == 1 && (diag == 1 || diag == 2))
        cls = 3;
    }
    const unsigned m1 = __ballot_sync(FULL, cls == 1);
    const unsigned m2 = __ballot_sync(FULL, cls == 2);
    const unsigned m3 = __ballot_sync(FULL, cls == 3);
    const int left = __shfl_up_sync(FULL, label, 1);
    const int right = __shfl_down_sync(FULL, label, 1);
    const unsigned starts = __ballot_sync(FULL, lane == 0 || left != label);
    if (!ok || (lane != 31 && right == label)) continue;
    // the last lane of a run of `label`: its sums in closed form
    const unsigned upto = FULL >> (31 - lane);  // lanes 0..lane
    const int start = 31 - __clz(starts & upto);
    const unsigned run = upto & ~((1u << start) - 1u);
    const long long g = frame * nseg + label;
    const long long len = lane - start + 1;
    const long long a = 2LL * y - sr2[g];
    const long long b0 = 2LL * (x - (lane - start)) - sc2[g];
    const long long tri = len * (len - 1);                   // Sum 2j, j < len
    const long long sq = (len - 1) * len * (2 * len - 1) / 6;  // Sum j^2
    const long long sb = len * b0 + tri;                     // Sum (b0 + 2j)
    const long long v[SUMS] = {len, len * a, sb, len * a * a, len * b0 * b0 + 2 * b0 * tri + 4 * sq, a * sb,
                               __popc(m1 & run), __popc(m2 & run), __popc(m3 & run)};
    int slot = -1;
    const unsigned hash = (static_cast<unsigned>(label) * 2654435761u) >> 24;
    for (int k = 0; k < SLOTS; ++k) {
      const int s = (hash + k) & (SLOTS - 1);
      const int prev = atomicCAS(s_key + s, 0, label);
      if (prev == 0 || prev == label) {
        slot = s;
        break;
      }
    }
#pragma unroll
    for (int j = 0; j < SUMS; ++j) {
      if (v[j] == 0) continue;
      if (slot >= 0)
        atomicAdd(s_val + j * SLOTS + slot, static_cast<unsigned long long>(v[j]));
      else
        atomicAdd(sums + g * SUMS + j, static_cast<unsigned long long>(v[j]));
    }
  }
  __syncthreads();
  for (int s = threadIdx.x; s < SLOTS; s += MT_THREADS) {
    const int label = s_key[s];
    if (label == 0) continue;
    unsigned long long* o = sums + (frame * nseg + label) * SUMS;
#pragma unroll
    for (int j = 0; j < SUMS; ++j) {
      const unsigned long long v = s_val[j * SLOTS + s];
      if (v != 0) atomicAdd(o + j, v);
    }
  }
}

// ---------------------------------------------------------------------------
// C: filled convex-hull pixel counts

constexpr int HULL_WARPS = 4;

__device__ __forceinline__ long long floor_div(long long num, long long den) {  // den > 0
  const long long q = num / den;
  return (num % den != 0 && num < 0) ? q - 1 : q;
}

// Sum over rows t in [r0, r1] of floor(X(t)), X the upper envelope (in x)
// of the points (t, x(t)) of the rows the region has: x = mx[t], or
// x = -mn[t] for the left side (floor(-LX) = -ceil(LX)).  Per lane; the
// caller adds the lanes.
__device__ long long envelope_floor_sum(const int* __restrict__ row, bool left_side, int r0, int r1,
                                        int2* __restrict__ stack, int lane) {
  int size = 0;
  int t0 = 0, x0 = 0, t1 = 0, x1 = 0;  // lane 0: the stack's second and top entries
  for (int base = r0; base <= r1; base += 32) {
    const int t = base + lane;
    const int v = t <= r1 ? row[t] : (left_side ? BIG : -1);
    const bool has = left_side ? v < BIG : v >= 0;
    const int x = left_side ? -v : v;
    const unsigned rows_with = __ballot_sync(FULL, has);
    for (int j = 0; j < 32; ++j) {
      const int xj = __shfl_sync(FULL, x, j);
      if (lane != 0 || !((rows_with >> j) & 1u)) continue;
      const int tj = base + j;
      // pop the top while it lies on or below the chord from the second to (tj, xj)
      while (size >= 2 && static_cast<long long>(t1 - t0) * (xj - x0) -
                                  static_cast<long long>(x1 - x0) * (tj - t0) >= 0) {
        --size;
        t1 = t0;
        x1 = x0;
        if (size >= 2) {
          const int2 e = stack[size - 2];
          t0 = e.x;
          x0 = e.y;
        }
      }
      stack[size++] = make_int2(tj, xj);
      t0 = t1;
      x0 = x1;
      t1 = tj;
      x1 = xj;
    }
  }
  size = __shfl_sync(FULL, size, 0);
  __syncwarp();
  long long acc = 0;
  for (int k = 0; k + 1 < size; ++k) {
    const int2 a = stack[k], b = stack[k + 1];
    const long long dt = b.x - a.x, dx = b.y - a.y;
    for (int t = a.x + lane; t < b.x; t += 32) acc += floor_div(a.y * dt + (t - a.x) * dx, dt);
  }
  if (lane == 0 && size > 0) acc += stack[size - 1].y;  // the last vertex's row
  __syncwarp();
  return acc;
}

__global__ void __launch_bounds__(HULL_WARPS * 32)
    hull_areas_kernel(const int* __restrict__ mn, const int* __restrict__ mx, const int* __restrict__ minr,
                      const int* __restrict__ maxr, int2* __restrict__ scratch, long long* __restrict__ hull,
                      long long regions, int h, int nseg) {
  const long long g = blockIdx.x * static_cast<long long>(HULL_WARPS) + threadIdx.x / 32;
  if (g >= regions) return;
  const int lane = threadIdx.x & 31;
  const int r0 = minr[g], r1 = maxr[g];
  if (g % nseg == 0 || r1 < r0) {
    if (lane == 0) hull[g] = 0;
    return;
  }
  const long long base = g * h;
  long long acc = envelope_floor_sum(mx + base, false, r0, r1, scratch + base, lane);
  acc += envelope_floor_sum(mn + base, true, r0, r1, scratch + base, lane);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(FULL, acc, off);
  if (lane == 0) hull[g] = acc + (r1 - r0 + 1);
}

// ---------------------------------------------------------------------------
// D: annotation

constexpr int PAINT_THREADS = 128;
constexpr int BOX = 7;  // valid, minr, minc, maxr + 1, maxc + 1, floor(centroid r), floor(centroid c)

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); }

__global__ void __launch_bounds__(PAINT_THREADS)
    annotate_paint_kernel(const int* __restrict__ boxes, int* __restrict__ keys, int h, int w, int nseg) {
  const long long g = blockIdx.x;
  const int label = static_cast<int>(g % nseg);
  const int* box = boxes + g * BOX;
  if (label == 0 || box[0] == 0) return;
  int* k = keys + (g / nseg) * h * static_cast<long long>(w);
  const int border = 2 * label;
  const int y0 = box[1], x0 = box[2], y1 = box[3], x1 = box[4];
  for (int off = -1; off <= 0; ++off) {
    const int xa = x0 - off, ya = y0 - off, xb = x1 + off, yb = y1 + off;
    const int cxa = clampi(min(xa, xb), 0, w - 1), cxb = clampi(max(xa, xb), 0, w - 1);
    const int cya = clampi(min(ya, yb), 0, h - 1), cyb = clampi(max(ya, yb), 0, h - 1);
    for (int c = cxa + threadIdx.x; c <= cxb; c += PAINT_THREADS) {
      if (ya >= 0 && ya < h) atomicMax(k + static_cast<long long>(ya) * w + c, border);
      if (yb >= 0 && yb < h) atomicMax(k + static_cast<long long>(yb) * w + c, border);
    }
    for (int r = cya + threadIdx.x; r <= cyb; r += PAINT_THREADS) {
      if (xa >= 0 && xa < w) atomicMax(k + static_cast<long long>(r) * w + xa, border);
      if (xb >= 0 && xb < w) atomicMax(k + static_cast<long long>(r) * w + xb, border);
    }
  }
  if (threadIdx.x < 49) {
    const int dy = static_cast<int>(threadIdx.x) / 7 - 3, dx = static_cast<int>(threadIdx.x) % 7 - 3;
    const int y = box[5] + dy, x = box[6] + dx;
    if (dy * dy + dx * dx <= 9 && y >= 0 && y < h && x >= 0 && x < w)
      atomicMax(k + static_cast<long long>(y) * w + x, border + 1);
  }
}

// colours: the green pixel's bytes, then the red one's
__global__ void annotate_colour_kernel(const uint8_t* __restrict__ img, const int* __restrict__ keys,
                                       const uint8_t* __restrict__ colours, uint8_t* __restrict__ out,
                                       long long pixels, int pixel_bytes) {
  for (long long p = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; p < pixels;
       p += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int key = keys[p];
    const uint8_t* src = key == 0 ? img + p * pixel_bytes : colours + (key & 1) * pixel_bytes;
    uint8_t* o = out + p * pixel_bytes;
    for (int i = 0; i < pixel_bytes; ++i) o[i] = src[i];
  }
}

int grid_for(long long items, int per_block) {
  const long long blocks = (items + per_block - 1) / per_block;
  return static_cast<int>(blocks < GRID_CAP ? (blocks > 0 ? blocks : 1) : GRID_CAP);
}

}  // namespace

// lab: (n, h, w) int32; mn, mx: (n, nseg, h) int32, filled with 2**30 and
// -1 beforehand; labels outside 1..nseg-1 are skipped.
extern "C" int yam_row_extremes(const void* lab, void* mn, void* mx, int n, int h, int w, int nseg, void* stream) {
  if (n < 0 || h <= 0 || w <= 0 || nseg < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = static_cast<long long>(n) * h;
  const long long tasks = rows * ((w + 31) / 32);
  if (tasks > 0)
    row_extremes_kernel<<<grid_for(tasks, EXT_THREADS / 32), EXT_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(lab), static_cast<int*>(mn), static_cast<int*>(mx), rows, h, w, nseg);
  return static_cast<int>(cudaGetLastError());
}

// lab: (n, h, w) int32; sr2, sc2: (n, nseg) int32, minr + maxr and
// minc + maxc of each region; sums: (n, nseg, 9) int64, zeroed beforehand.
extern "C" int yam_moment_sums(const void* lab, const void* sr2, const void* sc2, void* sums, int n, int h, int w,
                               int nseg, void* stream) {
  if (n < 0 || h <= 0 || w <= 0 || nseg < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles_x = (w + MT_COLS - 1) / MT_COLS;
  const long long tiles = static_cast<long long>((h + MT_ROWS - 1) / MT_ROWS) * tiles_x;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const long long hw = static_cast<long long>(h) * w;
  for (int first = 0; first < n; first += MAX_FRAMES) {
    const int frames = n - first < MAX_FRAMES ? n - first : MAX_FRAMES;
    moment_sums_kernel<<<dim3(static_cast<unsigned>(tiles), frames), MT_THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(lab) + first * hw, static_cast<const int*>(sr2) + static_cast<long long>(first) * nseg,
        static_cast<const int*>(sc2) + static_cast<long long>(first) * nseg,
        static_cast<unsigned long long*>(sums) + static_cast<long long>(first) * nseg * SUMS, h, w, nseg, tiles_x);
  }
  return static_cast<int>(cudaGetLastError());
}

// mn, mx: (n, nseg, h) from yam_row_extremes; minr, maxr: (n, nseg) int32
// (maxr < minr for an empty region); scratch: (n, nseg, h) int2; hull:
// (n, nseg) int64 out, 0 for region 0 and empty regions.
extern "C" int yam_hull_areas(const void* mn, const void* mx, const void* minr, const void* maxr, void* scratch,
                              void* hull, int n, int h, int nseg, void* stream) {
  if (n < 0 || h <= 0 || nseg < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long regions = static_cast<long long>(n) * nseg;
  const long long blocks = (regions + HULL_WARPS - 1) / HULL_WARPS;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (blocks > 0)
    hull_areas_kernel<<<static_cast<unsigned>(blocks), HULL_WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(mn), static_cast<const int*>(mx), static_cast<const int*>(minr),
        static_cast<const int*>(maxr), static_cast<int2*>(scratch), static_cast<long long*>(hull), regions, h, nseg);
  return static_cast<int>(cudaGetLastError());
}

// img: (n, h, w) pixels of pixel_bytes bytes each (any dtype, any
// channels); boxes: (n, nseg, 7) int32 (valid, minr, minc, maxr + 1,
// maxc + 1, floor of the centroid's row and column); keys: (n, h, w) int32
// scratch; colours: the green and the red pixel, 2 * pixel_bytes bytes;
// out: like img.
extern "C" int yam_annotate(const void* img, const void* boxes, void* keys, void* out, const void* colours, int n,
                            int h, int w, int pixel_bytes, int nseg, void* stream) {
  if (n < 0 || h <= 0 || w <= 0 || nseg < 1 || pixel_bytes < 1 || pixel_bytes > 64)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long regions = static_cast<long long>(n) * nseg;
  const long long pixels = static_cast<long long>(n) * h * w;
  if (regions > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pixels == 0) return static_cast<int>(cudaGetLastError());
  cudaError_t err = cudaMemsetAsync(keys, 0, pixels * sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  annotate_paint_kernel<<<static_cast<unsigned>(regions), PAINT_THREADS, 0, s>>>(static_cast<const int*>(boxes),
                                                                                 static_cast<int*>(keys), h, w, nseg);
  annotate_colour_kernel<<<grid_for(pixels, 256), 256, 0, s>>>(
      static_cast<const uint8_t*>(img), static_cast<const int*>(keys), static_cast<const uint8_t*>(colours),
      static_cast<uint8_t*>(out), pixels, pixel_bytes);
  return static_cast<int>(cudaGetLastError());
}
