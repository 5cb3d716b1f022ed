// Per-region work of the region-properties extraction: row extremes,
// bounding boxes, moment and perimeter sums, filled convex-hull pixel
// counts and the annotation, over int32 label frames (N, H, W) whose
// regions are numbered 1..R (0 is background).  Per-region outputs are (N, nseg, ...) with
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
// region_scan_kernel (A+B)  one pass over the labels for what the
//     reference's row_extremes_j (:196), _moment_sums_matmul (:369) and
//     _perimeter_weights_j (:500) compute: the row extremes mn/mx[frame,
//     label, row] (leftmost and rightmost column, BIG and -1 where the
//     region has no pixel on the row), the inclusive bbox, and per region
//     the area, Sum r, Sum c, Sum r^2, Sum c^2, Sum rc about the frame's
//     origin and the counts of skimage's three perimeter categories
//     (weights 1, sqrt(2), (1 + sqrt(2)) / 2).  Its last phase moves the
//     moments to the bbox centre in place, in unsigned 64-bit arithmetic:
//     Sum a, Sum b, Sum a^2, Sum b^2, Sum ab with a = 2r - (minr + maxr), b
//     = 2c - (minc + maxc), exactly what a pass about the centre gives, so
//     the pass no longer needs the bbox first.
//     Bound: device memory, the labels read once (4 B a pixel), the
//     (N, nseg, H) extremes filled and written, the per-region rows out.
//     Design: one cooperative launch of persistent blocks in three phases
//     behind grid-wide barriers (fill the outputs; the pass; centre the
//     sums), so the pass costs one launch.  A warp owns a strip of 256
//     columns (8 a lane) of a chunk of rows, sized by
//     ops/regionprops.py:scan_plan so that the tasks fill the resident
//     warps about once (32 x 1024^2: chunks of 64 rows; one 1024^2 frame:
//     of 8) on a 1-D grid.  Rows come into the warp's ring of RING rows in
//     shared memory by cp.async, AHEAD rows in flight: two 16-byte copies
//     a lane where every row of the task is aligned and the strip lies in
//     the frame (a row pointer stepped by w, no 64-bit product a row),
//     else 16-byte copies where a row is aligned and 4-byte ones,
//     zero-filled past the frame, otherwise; lanes 0 and 31 also copy the
//     2 columns past each edge of the strip.  So each label leaves device
//     memory once apart from the halos.  Once row i is in, the border flags of row i - 1 (a pixel's
//     category counts its neighbours' flags, and a flag needs their
//     neighbours), then row i - 2's pixels; neighbours across lanes come by
//     shuffles, a warp row without labels is skipped.  A lane keeps the
//     sums of its current region in registers: its pixels' count, Sum j
//     and Sum j^2 of their offsets j from its first column, Sum y, Sum y^2,
//     Sum y j, the category counts and its bbox, so a row inside a region
//     costs no atomic; mn/mx take one atomicMin/atomicMax where the
//     region's run starts or ends in the lane (its neighbour across the
//     lane or strip differs).  A lane's pixels of another region go
//     straight to device memory as its runs; a row that has other regions
//     but not the lane's makes the first of them current after flushing
//     the old one.  At the end of a task the warp adds its lanes' sums
//     region by region with shuffles and flushes each region with 13
//     atomics.  Categories are computed only for border pixels, their
//     neighbours read from the ring.  Every value is an integer, so the
//     atomics' order changes no bit.
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

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

namespace cg = cooperative_groups;

constexpr int BIG = 1 << 30;  // mn of a row without the region
constexpr unsigned FULL = 0xffffffffu;
constexpr int GRID_CAP = 132 * 64;

// ---------------------------------------------------------------------------
// The label pass: row extremes, bounding boxes and moment and perimeter sums

constexpr int PX = 8;                          // a lane's columns
constexpr int WARP_COLS = 32 * PX;             // a warp's strip
constexpr int SCAN_WARPS = 1024 / WARP_COLS;   // a block: warps side by side over 1024 columns
constexpr int SCAN_THREADS = SCAN_WARPS * 32;
constexpr int RING = 8;                        // rows of a warp's ring in shared memory
constexpr int AHEAD = RING - 4;                // rows in flight: the ring holds rows i - 3 .. i + AHEAD
constexpr int ROW_INTS = WARP_COLS + 8;        // a ring row: [2] col -2, [3] col -1, [4 ..], then cols 256, 257
constexpr int SUMS = 9;                        // columns of sums
constexpr int EMPTY = -1;                      // no current region

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

// 4 bytes, or 4 zero bytes when !valid (src is then not read)
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

// One row of a warp's strip: a lane's 8 labels and, on lanes 0 and 31,
// the 2 columns past the strip's edge (lane 0: -2, -1; lane 31: 256, 257;
// 0 outside the frame).
struct Row {
  int a[PX];
  int h0, h1;
};

// Row y of the frame into a ring row by cp.async: 16 bytes where the row
// is aligned and the 4 columns lie in the frame, else 4 at a time (zeros
// past the frame's edge); a row outside the frame is zeros.  rp: the row's
// column 0; fast: every row of the task is aligned and the strip lies in
// the frame.
__device__ __forceinline__ void fetch_row(int* ring_row, const int* rp, bool inside, bool fast, int xw, int w,
                                          int lane) {
  int* own = ring_row + 4 + PX * lane;
  const int cx = xw + PX * lane;
  if (!inside) {
#pragma unroll
    for (int q = 0; q < PX / 4; ++q) reinterpret_cast<int4*>(own)[q] = make_int4(0, 0, 0, 0);
    if (lane == 0) ring_row[2] = ring_row[3] = 0;
    if (lane == 31) ring_row[WARP_COLS + 4] = ring_row[WARP_COLS + 5] = 0;
    return;
  }
  if (fast) {
#pragma unroll
    for (int q = 0; q < PX / 4; ++q) cp_async16(own + 4 * q, rp + cx + 4 * q);
  } else {
    const bool aligned = (reinterpret_cast<uintptr_t>(rp) & 15u) == 0;
#pragma unroll
    for (int q = 0; q < PX / 4; ++q) {
      const int c = cx + 4 * q;
      if (aligned && c + 3 < w) {
        cp_async16(own + 4 * q, rp + c);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) cp_async4(own + 4 * q + k, rp + (c + k < w ? c + k : 0), c + k < w);
      }
    }
  }
  if (lane == 0) {
    cp_async4(ring_row + 2, rp + (xw >= 2 ? xw - 2 : 0), xw >= 2);
    cp_async4(ring_row + 3, rp + (xw >= 1 ? xw - 1 : 0), xw >= 1);
  } else if (lane == 31) {
    cp_async4(ring_row + WARP_COLS + 4, rp + (xw + WARP_COLS < w ? xw + WARP_COLS : 0), xw + WARP_COLS < w);
    cp_async4(ring_row + WARP_COLS + 5, rp + (xw + WARP_COLS + 1 < w ? xw + WARP_COLS + 1 : 0),
              xw + WARP_COLS + 1 < w);
  }
}

__device__ __forceinline__ Row read_row(const int* ring_row, int lane) {
  Row r;
#pragma unroll
  for (int q = 0; q < PX / 4; ++q) {
    const int4 v = reinterpret_cast<const int4*>(ring_row + 4 + PX * lane)[q];
    r.a[4 * q] = v.x, r.a[4 * q + 1] = v.y, r.a[4 * q + 2] = v.z, r.a[4 * q + 3] = v.w;
  }
  // the halo, read by every lane (branch-free) and kept by lanes 0 and 31
  const int at = lane == 31 ? WARP_COLS + 4 : 2;
  const bool edge = lane == 0 || lane == 31;
  const int h0 = ring_row[at], h1 = ring_row[at + 1];
  r.h0 = edge ? h0 : 0;
  r.h1 = edge ? h1 : 0;
  return r;
}

__device__ __forceinline__ bool row_any(const Row& r) {
  int v = r.h0 | r.h1;
#pragma unroll
  for (int k = 0; k < PX; ++k) v |= r.a[k];
  return __any_sync(FULL, v != 0);
}

// The lane's columns 8l - 1 .. 8l + 8 of a row (neighbours by shuffles;
// lane 0's column -1 and lane 31's column 256 from the halo).
struct Window {
  int c[PX + 2];
};

__device__ __forceinline__ Window window(const Row& r, int lane) {
  const int left = __shfl_up_sync(FULL, r.a[PX - 1], 1);
  const int right = __shfl_down_sync(FULL, r.a[0], 1);
  Window w;
  w.c[0] = lane == 0 ? r.h1 : left;
#pragma unroll
  for (int k = 0; k < PX; ++k) w.c[k + 1] = r.a[k];
  w.c[PX + 1] = lane == 31 ? r.h0 : right;
  return w;
}

// a region pixel with a 4-neighbour of another label (outside the frame is 0)
__device__ __forceinline__ unsigned border(int v, int up, int down, int left, int right) {
  return v > 0 && !(up == v && down == v && left == v && right == v);
}

// Border flags of row M (window m) as PX + 2 bits, bit k for the window's
// column k (lanes 0 and 31 compute their outer column's flag from the
// halo, the others take their neighbours' by shuffles).
__device__ __forceinline__ unsigned border_flags(const Row& U, const Row& M, const Window& m, const Row& D,
                                                 int lane) {
  unsigned f = 0;
#pragma unroll
  for (int k = 1; k <= PX; ++k) f |= border(m.c[k], U.a[k - 1], D.a[k - 1], m.c[k - 1], m.c[k + 1]) << k;
  const unsigned edge = lane == 0    ? border(m.c[0], U.h1, D.h1, M.h0, m.c[1])
                        : lane == 31 ? border(m.c[PX + 1], U.h0, D.h0, m.c[PX], M.h1)
                                     : 0u;
  const unsigned left = __shfl_up_sync(FULL, f, 1);
  const unsigned right = __shfl_down_sync(FULL, f, 1);
  return f | (lane == 0 ? edge : (left >> PX) & 1u) | ((lane == 31 ? edge : (right >> 1) & 1u) << (PX + 1));
}

// skimage's perimeter category of the border pixel at column k of a
// lane's PX (1: weight 1, 2: sqrt(2), 3: (1 + sqrt(2)) / 2, 0: none): u,
// r, d point at the lane's column 0 in rows y - 1, y, y + 1 of the ring
// (the halo makes columns -1 and PX readable), fu, fr, fd are the rows'
// border flags (bit j: column j - 1).
__device__ __forceinline__ unsigned category(const int* u, const int* r, const int* d, int k, unsigned fu,
                                             unsigned fr, unsigned fd) {
  const int v = r[k];
  const int orth = (u[k] == v && ((fu >> (k + 1)) & 1u)) + (d[k] == v && ((fd >> (k + 1)) & 1u)) +
                   (r[k - 1] == v && ((fr >> k) & 1u)) + (r[k + 1] == v && ((fr >> (k + 2)) & 1u));
  const int diag = (u[k - 1] == v && ((fu >> k) & 1u)) + (u[k + 1] == v && ((fu >> (k + 2)) & 1u)) +
                   (d[k - 1] == v && ((fd >> k) & 1u)) + (d[k + 1] == v && ((fd >> (k + 2)) & 1u));
  if (orth >= 2 && orth <= 3 && diag <= 2) return 1u;
  if ((orth == 0 && diag == 2) || (orth == 1 && diag == 3)) return 2u;
  if (orth == 1 && (diag == 1 || diag == 2)) return 3u;
  return 0u;
}

struct ScanOut {
  int* mn;
  int* mx;
  int* box;                  // (n * nseg, 4)
  unsigned long long* sums;  // (n * nseg, 9): origin sums until the epilogue
  int h, w, nseg;
};

// The sums a lane keeps in registers for its current region g: its own
// pixels of g in the rows of the task so far, at columns x + j (x the
// lane's first column, j its offset): n pixels, Sum j, Sum j^2, Sum y,
// Sum y^2, Sum y j, and the category counts.  The sums about the origin
// follow at the flush: Sum c = x n + Sum j, Sum c^2 = x^2 n + 2 x Sum j +
// Sum j^2, Sum rc = x Sum y + Sum y j.
struct Acc {
  int g;  // the current region, or EMPTY
  int minr, maxr, minc, maxc;
  unsigned n, j1, j2, k1, k2, k3;
  unsigned long long r1, r2, rj;
};

__device__ __forceinline__ void acc_clear(Acc& a, int g) {
  a.g = g;
  a.minr = a.minc = BIG;
  a.maxr = a.maxc = -1;
  a.n = a.j1 = a.j2 = a.k1 = a.k2 = a.k3 = 0;
  a.r1 = a.r2 = a.rj = 0;
}

// The lane's nine sums about the origin (x: the lane's first column).
__device__ __forceinline__ void acc_sums(const Acc& a, int x, unsigned long long v[SUMS]) {
  const unsigned long long X = static_cast<unsigned>(x);
  v[0] = a.n;
  v[1] = a.r1;
  v[2] = X * a.n + a.j1;
  v[3] = a.r2;
  v[4] = (X * a.n + 2ull * a.j1) * X + a.j2;
  v[5] = X * a.r1 + a.rj;
  v[6] = a.k1;
  v[7] = a.k2;
  v[8] = a.k3;
}

// One lane's sums into device memory (its region changed mid-task, or a
// run of another region), by atomics without a reply.  Out of line, its
// arguments by value.
__device__ __noinline__ void acc_flush(unsigned long long* sums, int* boxes, Acc a, int x) {
  if (a.n == 0) return;
  unsigned long long v[SUMS];
  acc_sums(a, x, v);
  unsigned long long* sum = sums + static_cast<long long>(a.g) * SUMS;
#pragma unroll
  for (int j = 0; j < SUMS; ++j)
    if (v[j] != 0) atomicAdd(sum + j, v[j]);
  int* b = boxes + static_cast<long long>(a.g) * 4;
  atomicMin(b, a.minr);
  atomicMin(b + 1, a.minc);
  atomicMax(b + 2, a.maxr);
  atomicMax(b + 3, a.maxc);
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

template <bool MAX>
__device__ __forceinline__ int warp_extreme(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int o = __shfl_xor_sync(FULL, v, off);
    v = MAX ? max(v, o) : min(v, o);
  }
  return v;
}

// Every lane's sums into device memory at the end of a task (warp-wide):
// the lanes of one region are added across the warp first, so a region
// costs 13 atomics a warp, not 13 a lane.
__device__ __forceinline__ void acc_flush_warp(unsigned long long* sums, int* boxes, const Acc& a, int x, int lane) {
  unsigned long long own[SUMS];
  acc_sums(a, x, own);
  bool pending = a.n != 0;
  for (unsigned left = __ballot_sync(FULL, pending); left; left = __ballot_sync(FULL, pending)) {
    const int g = __shfl_sync(FULL, a.g, __ffs(left) - 1);
    const bool mine = pending && a.g == g;
    pending = pending && !mine;
    unsigned long long mv = 0;
#pragma unroll
    for (int j = 0; j < SUMS; ++j) {
      const unsigned long long t = warp_sum<unsigned long long>(mine ? own[j] : 0ull);
      mv = lane == j ? t : mv;
    }
    const int bx[4] = {warp_extreme<false>(mine ? a.minr : BIG), warp_extreme<false>(mine ? a.minc : BIG),
                       warp_extreme<true>(mine ? a.maxr : -1), warp_extreme<true>(mine ? a.maxc : -1)};
    int mb = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) mb = lane == SUMS + j ? bx[j] : mb;
    if (lane < SUMS && mv != 0) atomicAdd(sums + static_cast<long long>(g) * SUMS + lane, mv);
    int* b = boxes + static_cast<long long>(g) * 4;
    if (lane == SUMS || lane == SUMS + 1) atomicMin(b + lane - SUMS, mb);
    if (lane == SUMS + 2 || lane == SUMS + 3) atomicMax(b + lane - SUMS, mb);
  }
}

// Where a task's rows are: the warp's ring, the frame, the lane's columns.
struct Strip {
  int (*ring)[ROW_INTS];
  int frame_base, xw, x;  // x: the lane's first column
};

// Row y of the warp's strip (window r, border flags fu, fr, fd of rows y -
// 1, y, y + 1, which are ring rows ru, rr, rd).  A lane sums its own
// pixels of the warp's current region in registers, in closed form from
// the pixel offsets, and sets mn/mx at the region's first and last pixel
// in its columns where the neighbour across the lane (or strip) differs;
// other regions' pixels go to device memory as the lane's runs, with
// their extremes.  Categories of border pixels read their neighbours from the
// ring.  A row that meets other regions but not the current one makes the
// first of them current.
__device__ __forceinline__ void scan_row(const Window& r, unsigned fu, unsigned fr, unsigned fd, int ru, int rr,
                                         int rd, int y, const Strip& sp, int lane, const ScanOut& o,
                                         Acc& acc) {
  const int label = acc.g - sp.frame_base;  // the current region's label in this frame (valid, or none)
  unsigned km = 0;                          // the current region's pixels
#pragma unroll
  for (int k = 0; k < PX; ++k) km |= (r.c[k + 1] == label ? 1u : 0u) << k;
  unsigned vm = km;  // valid pixels: labels 1 .. nseg - 1
  if (km != (1u << PX) - 1) {
#pragma unroll
    for (int k = 0; k < PX; ++k)
      vm |= (static_cast<unsigned>(r.c[k + 1] - 1) < static_cast<unsigned>(o.nseg - 1) ? 1u : 0u) << k;
  }
  if (!__any_sync(FULL, vm != 0)) return;
  const int* ur = sp.ring[ru] + 4 + PX * lane;
  const int* rw = sp.ring[rr] + 4 + PX * lane;
  const int* dr = sp.ring[rd] + 4 + PX * lane;
  // perimeter categories of the border pixels: the current region's
  // counted here, the others' kept as 2-bit codes for their runs
  unsigned need = vm & (fr >> 1) & ((1u << PX) - 1), codes = 0, k1 = 0, k2 = 0, k3 = 0;
  while (need) {
    const int k = __ffs(need) - 1;
    need &= need - 1;
    const unsigned c = category(ur, rw, dr, k, fu, fr, fd);
    if (km >> k & 1u) {
      k1 += c == 1u;
      k2 += c == 2u;
      k3 += c == 3u;
    } else {
      codes |= c << (2 * k);
    }
  }
  if (km) {
    // Sum j and Sum j^2 over the offsets j = b0 + 2 b1 + 4 b2 of the pixels
    const unsigned n = __popc(km), p0 = __popc(km & 0xaau), p1 = __popc(km & 0xccu), p2 = __popc(km & 0xf0u);
    const unsigned s1 = p0 + 2 * p1 + 4 * p2;
    const unsigned s2 = p0 + 4 * p1 + 16 * p2 + 4 * __popc(km & 0x88u) + 8 * __popc(km & 0xa0u) + 16 * __popc(km & 0xc0u);
    const unsigned uy = static_cast<unsigned>(y);
    acc.n += n;
    acc.j1 += s1;
    acc.j2 += s2;
    acc.r1 += static_cast<unsigned long long>(uy) * n;
    acc.r2 += static_cast<unsigned long long>(uy) * uy * n;
    acc.rj += static_cast<unsigned long long>(uy) * s1;
    acc.k1 += k1;
    acc.k2 += k2;
    acc.k3 += k3;
    const int first = sp.x + __ffs(km) - 1, last = sp.x + 31 - __clz(km);
    acc.minc = min(acc.minc, first);
    acc.maxc = max(acc.maxc, last);
    acc.minr = min(acc.minr, y);
    acc.maxr = max(acc.maxr, y);
    // the first and last pixel of the region in the row, if they lie here
    const unsigned starts = km & ~((km << 1) | (r.c[0] == label ? 1u : 0u));
    const unsigned ends = km & ~((km >> 1) | (r.c[PX + 1] == label ? 1u << (PX - 1) : 0u));
    const long long at = static_cast<long long>(acc.g) * o.h + y;
    if (starts) atomicMin(o.mn + at, first);
    if (ends) atomicMax(o.mx + at, last);
  }
  // other regions' pixels: the lane's runs of them into device memory
  unsigned om = vm & ~km;
  int miss = EMPTY;
  while (om) {
    const int k = __ffs(om) - 1;
    const int v = rw[k];
    int e = k;
    unsigned cats = 1u << (8 * (codes >> (2 * k) & 3u)) >> 8;
    while (e < PX - 1 && (om >> (e + 1) & 1u) && rw[e + 1] == v) {
      ++e;
      cats += 1u << (8 * (codes >> (2 * e) & 3u)) >> 8;
    }
    om &= ~((2u << e) - (1u << k));
    const int g = sp.frame_base + v;
    const long long at = static_cast<long long>(g) * o.h + y;
    if (rw[k - 1] != v) atomicMin(o.mn + at, sp.x + k);
    if (rw[e + 1] != v) atomicMax(o.mx + at, sp.x + e);
    Acc run;  // n pixels from column sp.x + k: offsets 0 .. n - 1
    const unsigned n = e - k + 1, uy = static_cast<unsigned>(y);
    run.g = g;
    run.minr = run.maxr = y;
    run.minc = sp.x + k;
    run.maxc = sp.x + e;
    run.n = n;
    run.j1 = n * (n - 1) / 2;
    run.j2 = (n - 1) * n * (2 * n - 1) / 6;
    run.k1 = cats & 0xffu;
    run.k2 = (cats >> 8) & 0xffu;
    run.k3 = cats >> 16;
    run.r1 = static_cast<unsigned long long>(uy) * n;
    run.r2 = static_cast<unsigned long long>(uy) * uy * n;
    run.rj = static_cast<unsigned long long>(uy) * run.j1;
    acc_flush(o.sums, o.box, run, sp.x + k);
    if (miss == EMPTY) miss = g;
  }
  if (!km && miss != EMPTY) {
    acc_flush(o.sums, o.box, acc, sp.x);
    acc_clear(acc, miss);
  }
}

// mn, mx: BIG and -1; box: BIG, BIG, -1, -1; sums: 0 (grid-strided).
__device__ __forceinline__ void fill_outputs(const ScanOut& o, long long regions, long long first, long long stride) {
  const long long extremes = regions * o.h, quads = extremes / 4;  // torch's allocations are 16-byte aligned
  for (long long i = first; i < quads; i += stride) {
    reinterpret_cast<int4*>(o.mn)[i] = make_int4(BIG, BIG, BIG, BIG);
    reinterpret_cast<int4*>(o.mx)[i] = make_int4(-1, -1, -1, -1);
  }
  for (long long i = quads * 4 + first; i < extremes; i += stride) {
    o.mn[i] = BIG;
    o.mx[i] = -1;
  }
  for (long long g = first; g < regions; g += stride) reinterpret_cast<int4*>(o.box)[g] = make_int4(BIG, BIG, -1, -1);
  const long long pairs = regions * SUMS / 2;
  for (long long i = first; i < pairs; i += stride) reinterpret_cast<ulonglong2*>(o.sums)[i] = make_ulonglong2(0, 0);
  if (first == 0 && regions * SUMS % 2) o.sums[regions * SUMS - 1] = 0;
}

// The sums about the origin to the sums about each region's bbox centre,
// in place: with s = minr + maxr, t = minc + maxc, a = 2r - s and b = 2c -
// t, Sum a = 2 R1 - s A, Sum b = 2 C1 - t A, Sum a^2 = 4 R2 - 4 s R1 + s^2
// A, Sum b^2 = 4 C2 - 4 t C1 + t^2 A, Sum ab = 4 RC - 2 t R1 - 2 s C1 + s
// t A, modulo 2^64 (exact wherever the result fits an int64).
__device__ __forceinline__ void centre_sums(const ScanOut& o, long long regions, long long first, long long stride) {
  for (long long g = first; g < regions; g += stride) {
    const int4 b = reinterpret_cast<const int4*>(o.box)[g];
    unsigned long long* v = o.sums + g * SUMS;
    const unsigned long long A = v[0], R1 = v[1], C1 = v[2], R2 = v[3], C2 = v[4], RC = v[5];
    const unsigned long long s = static_cast<unsigned long long>(static_cast<long long>(b.x) + b.z);
    const unsigned long long t = static_cast<unsigned long long>(static_cast<long long>(b.y) + b.w);
    v[1] = 2 * R1 - s * A;
    v[2] = 2 * C1 - t * A;
    v[3] = 4 * R2 - 4 * s * R1 + s * s * A;
    v[4] = 4 * C2 - 4 * t * C1 + t * t * A;
    v[5] = 4 * RC - 2 * t * R1 - 2 * s * C1 + s * t * A;
  }
}

// Persistent blocks: warp task t is (frame, row chunk, strip of
// WARP_COLS columns), strips fastest, so a block's warps take 1024 columns
// of one chunk; warp b * SCAN_WARPS + w takes tasks b * SCAN_WARPS + w,
// + gridDim.x * SCAN_WARPS, ...  A warp walks its chunk's rows y0 - 2 ..
// y1 + 1 through its ring in shared memory, AHEAD rows in flight by
// cp.async: once row i is in, the border flags of row i - 1, then row i -
// 2's pixels.  Its lanes' sums go to device memory at the end of the task.
// One cooperative launch: the outputs are filled first and the sums
// centred last, each phase behind a grid-wide barrier.
__global__ void __launch_bounds__(SCAN_THREADS, 4)
    region_scan_kernel(const int* __restrict__ lab, ScanOut o, int n, int chunks, int span) {
  __shared__ __align__(16) int s_ring[SCAN_WARPS][RING][ROW_INTS];
  cg::grid_group grid = cg::this_grid();
  const long long regions = static_cast<long long>(n) * o.nseg;
  const long long thread = blockIdx.x * static_cast<long long>(SCAN_THREADS) + threadIdx.x;
  const long long threads = static_cast<long long>(gridDim.x) * SCAN_THREADS;
  fill_outputs(o, regions, thread, threads);
  grid.sync();
  const int lane = threadIdx.x & 31;
  const int h = o.h, w = o.w;
  const int strips = (w + WARP_COLS - 1) / WARP_COLS;
  const long long tasks = static_cast<long long>(n) * chunks * strips;
  Strip sp;
  sp.ring = s_ring[threadIdx.x / 32];
  for (long long task = blockIdx.x * static_cast<long long>(SCAN_WARPS) + threadIdx.x / 32; task < tasks;
       task += static_cast<long long>(gridDim.x) * SCAN_WARPS) {
    const int strip = static_cast<int>(task % strips);
    const long long rest = task / strips;
    const int chunk = static_cast<int>(rest % chunks);
    const int frame = static_cast<int>(rest / chunks);
    sp.xw = strip * WARP_COLS;
    sp.x = sp.xw + PX * lane;
    sp.frame_base = frame * o.nseg;
    const int y0 = chunk * span;
    const int rows = (y0 + span < h ? span : h - y0) + 4;  // y0 - 2 .. y1 + 1
    const int* frame_lab = lab + static_cast<long long>(frame) * h * w;
    const bool fast = (reinterpret_cast<uintptr_t>(frame_lab) & 15u) == 0 && w % 4 == 0 && sp.xw + WARP_COLS <= w;
    const int* rp = frame_lab + static_cast<long long>(y0 - 2) * w;  // the next row to fetch, column 0
    __syncwarp();  // every lane has read the last task's rows
#pragma unroll
    for (int j = 0; j < AHEAD; ++j, rp += w) {
      const int y = y0 - 2 + j;
      fetch_row(sp.ring[j], rp, y >= 0 && y < h, fast, sp.xw, w, lane);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
    Acc acc;
    acc_clear(acc, EMPTY);
    unsigned fu = 0, fr = 0;  // border flags of rows i - 3 and i - 2
    Window wr;                // the window of row i - 2
    unsigned any = 0;         // bit k: row i - k holds a label other than 0
    for (int i = 0; i < rows; ++i) {
      const int next = i + AHEAD, y = y0 - 2 + next;
      __syncwarp();  // row next - RING's ring row is no longer read
      if (next < rows) {
        fetch_row(sp.ring[next % RING], rp, y >= 0 && y < h, fast, sp.xw, w, lane);
        rp += w;
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
      asm volatile("cp.async.wait_group %0;\n" ::"n"(AHEAD) : "memory");
      __syncwarp();
      const Row d = read_row(sp.ring[i % RING], lane);
      any = (any << 1) | (row_any(d) ? 1u : 0u);
      // flags of row i - 1 (between rows i - 2 and i)
      unsigned fd = 0;
      Window wd;
      if (i >= 2 && (any & 2u)) {
        const Row m = read_row(sp.ring[(i + RING - 1) % RING], lane);
        wd = window(m, lane);
        fd = border_flags(read_row(sp.ring[(i + RING - 2) % RING], lane), m, wd, d, lane);
      }
      // row i - 2 (between rows i - 3 and i - 1)
      if (i >= 4 && (any & 4u))
        scan_row(wr, fu, fr, fd, (i + RING - 3) % RING, (i + RING - 2) % RING, (i + RING - 1) % RING, y0 + i - 4, sp,
                 lane, o, acc);
      fu = fr;
      fr = fd;
      wr = wd;
    }
    acc_flush_warp(o.sums, o.box, acc, sp.x, lane);
  }
  grid.sync();
  centre_sums(o, regions, thread, threads);
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

// blocks: how many blocks of the label pass the current device holds at
// once (what its cooperative launch allows).
extern "C" int yam_region_scan_resident_blocks(int* blocks) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, region_scan_kernel, SCAN_THREADS, 0);
  *blocks = per_sm * sms;
  return static_cast<int>(err);
}

// lab: (n, h, w) int32 (any base address); out: mn, mx (n, nseg, h) int32,
// box (n, nseg, 4) int32 and sums (n, nseg, 9) int64, all filled here.
// Labels outside 1..nseg-1 are skipped.  grid, chunks and span come from
// ops/regionprops.py:scan_plan (chunks of span rows cover each frame, grid
// at most yam_region_scan_resident_blocks).
extern "C" int yam_region_scan(const void* lab, void* mn, void* mx, void* box, void* sums, int n, int h, int w,
                               int nseg, int grid, int chunks, int span, void* stream) {
  if (n < 1 || h <= 0 || w <= 0 || nseg < 1 || static_cast<long long>(n) * nseg > 0x7fffffffLL || grid < 1 ||
      chunks < 1 || span < 1 || static_cast<long long>(chunks) * span < h ||
      static_cast<long long>(chunks - 1) * span >= h)
    return static_cast<int>(cudaErrorInvalidValue);
  const int* l = static_cast<const int*>(lab);
  ScanOut o{static_cast<int*>(mn), static_cast<int*>(mx), static_cast<int*>(box),
            static_cast<unsigned long long*>(sums), h, w, nseg};
  void* args[] = {&l, &o, &n, &chunks, &span};
  const cudaError_t err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(region_scan_kernel), dim3(grid),
                                    dim3(SCAN_THREADS), args, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) {
    cudaGetLastError();  // a refused launch leaves its error behind for the next launch's check: take it
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

// mn, mx: (n, nseg, h) from yam_region_scan; minr, maxr: (n, nseg) int32
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
