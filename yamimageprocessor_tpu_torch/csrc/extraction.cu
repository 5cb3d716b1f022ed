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
// hull_areas_kernel (C)  a warp a side of a (frame, region) (the rows'
//     mx, then -mn; the two warps of a region run side by side in one
//     block): the sum over the region's rows of floor(X(t)), X the upper
//     envelope; width(t) = floor(RX) + floor(-LX) + 1.  Exact integers, no
//     vertex cap, no scratch in device memory.  Bound: the serial
//     monotone chain (latency, one dependent step a row), not bytes (a
//     region's rows of mn and mx are read once).  Design: a side of at
//     most 32 rows stays in registers (hull_side_word: a lane a row, the
//     chain a bitmask that every lane runs alike by shuffles).  For a
//     taller one the lanes split the chain (hull_side).  Each lane owns consecutive 32-row words of the region's
//     rows, staged by coalesced loads through a 32 x 33 tile in shared
//     memory, and runs the chain over them, one pop or push a step, its top
//     vertices in registers and all of them as bits in shared memory (a
//     pop refills the registers ahead of need by a bit scan); five rounds
//     of bridge merges (a two-finger walk that clears the bits it passes)
//     join the lanes' chains, so a 4001-row region walks about 128 rows a
//     lane, not 4001.  The vertices then go into a stack in shared memory
//     (over the tile) sized by ops/regionprops.py:hull_stack_capacity (a
//     strictly convex lattice chain: 590 vertices at 4096^2), each word
//     gets its rank, and a lane a row finds its row's edge as its rank
//     among the vertices (a popcount) and adds the edge's exact floor.
// annotate_copy_kernel / annotate_paint_kernel / annotate_colour_kernel (D)
//     the reference's last painter (later region over earlier, disk over
//     outline) wins: O(outlines + disks) beside one copy of the image, not
//     O(H*W*R).  Bound: the image read and written once (bytes).  Design:
//     one launch copies the image's bytes (16-byte loads and stores, 4 in
//     flight, the ragged tail a byte at a time) and, in its other blocks,
//     zeroes the int32 key plane (allocated, never cleared) at exactly the
//     pixels the paint will touch; then the paint, atomicMax of 2L on the
//     two nested bbox outlines (clipped as region_annotate_j's border_mask
//     clips them) and 2L + 1 on the radius-3 disk; then the colour pass
//     walks the same pixels and writes the green (even key) or red (odd)
//     pixel where the plane holds the walker's own key.  All three walk
//     one generator, so no pixel outside the outlines and disks is read or
//     written in the plane.  The paint and the colour pass go out by
//     programmatic dependent launch: their blocks start while the launch
//     before them runs and wait (griddepcontrol.wait) before touching the
//     planes, which hides a launch's latency on one frame.  What sets the
//     sparse launches' time is their
//     scattered 32-byte transactions, not bytes: the outlines' columns
//     are walked four pixels a row, so neighbouring threads share a row's
//     sectors, and a pixel's colour goes out in stores of one width.  A
//     region gets `span` threads, a power of two from 8 (a blobs frame's
//     65536 small regions) to 16384 (one large region over 16 blocks).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

namespace cg = cooperative_groups;

constexpr int BIG = 1 << 30;  // mn of a row without the region
constexpr unsigned FULL = 0xffffffffu;

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
constexpr int TILE_PITCH = 33;                // a warp's 32 x 32 row tile, padded against bank conflicts
constexpr int TILE_BYTES = 32 * TILE_PITCH * 4;

__device__ __forceinline__ long long floor_div(long long num, long long den) {  // den > 0
  const long long q = num / den;
  return (num % den != 0 && num < 0) ? q - 1 : q;
}

// floor(X(t)) on the edge from (ta, xa) to (tb, xb), ta <= t < tb: 32-bit
// where the numerator fits (any frame up to 32768 a side)
__device__ __forceinline__ long long edge_floor(int ta, int xa, int tb, int xb, int t) {
  const long long dt = tb - ta, num = xa * dt + static_cast<long long>(t - ta) * (xb - xa);
  if (num >= INT32_MIN && num <= INT32_MAX) {
    const int n = static_cast<int>(num), d = static_cast<int>(dt), q = n / d;
    return (n % d != 0 && n < 0) ? q - 1 : q;
  }
  return floor_div(num, dt);
}

__device__ __forceinline__ long long cross(int ta, int xa, int tb, int xb, int tc, int xc) {
  return static_cast<long long>(tb - ta) * (xc - xa) - static_cast<long long>(xb - xa) * (tc - ta);
}

// A warp's shared memory: the row tile while the lanes' chains are built,
// then (over it) the hull's vertices; a bit a row of the region (set: a
// vertex of a chain); the vertices before each word of bits.
struct HullShared {
  int* tile;       // 32 x TILE_PITCH
  int2* stack;     // cap entries (t, x)
  unsigned* bits;  // (h + 31) / 32
  int* rank;       // (h + 31) / 32
  int cap;
};

// x of row t: mx[t], or -mn[t] on the left side
__device__ __forceinline__ int side_x(const int* __restrict__ row, bool left, int t) {
  const int v = __ldg(row + t);
  return left ? -v : v;
}

// The vertex before position p (one exists); cur: word q's bits, not yet stored.
__device__ __forceinline__ int prev_vertex(const unsigned* bits, unsigned cur, int q, int p) {
  int wq = p >> 5;
  unsigned m = (wq == q ? cur : bits[wq]) & ((1u << (p & 31)) - 1);
  while (m == 0) m = bits[--wq];
  return (wq << 5) + 31 - __clz(m);
}

// The vertex after position p (one exists).
__device__ __forceinline__ int next_vertex(const unsigned* bits, int p) {
  int wq = p >> 5;
  unsigned m = bits[wq] & ~((2u << (p & 31)) - 1);
  while (m == 0) m = bits[++wq];
  return (wq << 5) + __ffs(m) - 1;
}

// A lane chain's top vertices in registers, [0] the top: a push shifts
// them down, a pop up, and a refill reads the vertex below the deepest.
struct Top {
  int p[4], x[4];
  int depth;  // how many are held
  __device__ __forceinline__ void push(int pn, int xn) {
#pragma unroll
    for (int k = 3; k > 0; --k) p[k] = p[k - 1], x[k] = x[k - 1];
    p[0] = pn;
    x[0] = xn;
    depth = min(depth + 1, 4);
  }
  __device__ __forceinline__ void pop() {
#pragma unroll
    for (int k = 0; k < 3; ++k) p[k] = p[k + 1], x[k] = x[k + 1];
    --depth;
  }
  __device__ __forceinline__ int deepest() const {
    return depth == 1 ? p[0] : (depth == 2 ? p[1] : p[2]);
  }
  __device__ __forceinline__ void refill(int pn, int xn) {  // depth < 3
#pragma unroll
    for (int k = 1; k < 3; ++k)
      if (depth == k) p[k] = pn, x[k] = xn;
    ++depth;
  }
};

// One side of a region, warp-wide: the sum over its rows of floor(X(t)),
// X the upper envelope (in x) of the points (t, x(t)) of the rows r0 ..
// r0 + rows - 1 the region has, x = mx[t] or -mn[t] (floor(-LX) =
// -ceil(LX)).  Per lane; the caller adds the lanes.  Positions p = t - r0.
//  1. Each lane owns `per` consecutive 32-row words and runs the monotone
//     chain (collinear points popped) over their rows, the rows staged in
//     the tile 32 words at a time by coalesced loads, the chain's top
//     three or four in registers and all of it as set bits (a pop refills
//     the registers ahead of need: the vertex below by a bit scan, its x
//     from the tile or, in an earlier word, from L1).
//  2. Five rounds of bridge merges: the leader of 2, 4, ... lanes joins
//     the left chain's and the right chain's vertices by the two-finger
//     walk (drop the left's last vertex while it is not a strict turn
//     towards the right's current one, then the right's first, until
//     neither moves), clearing the bits it walks over.
//  3. The vertices into the stack in row order (a popcount scan over the
//     words) and each word's rank.
//  4. A lane a row of each word: the row's edge is its rank among the
//     vertices (a popcount of the word below it), its floor the edge's
//     exact floor; the last vertex's row its own x.
__device__ long long hull_side(const int* __restrict__ row, bool left, int r0, int rows, const HullShared& s,
                               int lane) {
  const int words = (rows + 31) >> 5;
  const int per = (words + 31) >> 5;  // words a lane
  const int active = (words + per - 1) / per;
  const int q0 = min(lane * per, words), q1 = min(q0 + per, words);
  int size = 0, first = -1;
  Top top;  // the chain's top vertices
  top.p[0] = 0;
  top.depth = 0;
  for (int c = 0; c < per; ++c) {
    int v[32];  // every load in flight before the first store
#pragma unroll
    for (int l = 0; l < 32; ++l) {
      const int p = ((l * per + c) << 5) + lane;
      v[l] = l < active && p < rows ? __ldg(row + r0 + p) : (left ? BIG : -1);
    }
    __syncwarp();  // the tile's last rows are read
#pragma unroll
    for (int l = 0; l < 32; ++l)
      if (l < active) s.tile[l * TILE_PITCH + lane] = v[l];
    __syncwarp();
    const int q = q0 + c;
    if (q >= q1) continue;
    const int* mine = s.tile + lane * TILE_PITCH;
    // one step a pop or a push: the lanes' chains pop at different rows,
    // and a step costs the warp what its slowest lane does
    unsigned cur = 0;
    const int rows_here = min(32, rows - (q << 5));
    for (int b = 0; b < rows_here;) {
      const int t = mine[b];
      const bool has = left ? t < BIG : t >= 0;
      const int p = (q << 5) + b, x = left ? -t : t;
      if (has && size >= 2 && cross(top.p[1], top.x[1], top.p[0], top.x[0], p, x) >= 0) {
        // the top lies on or below the chord from the second to (p, x): pop it
        const int gone = top.p[0];
        if ((gone >> 5) == q)
          cur &= ~(1u << (gone & 31));
        else
          s.bits[gone >> 5] &= ~(1u << (gone & 31));
        --size;
        top.pop();
        if (top.depth < 3 && size > top.depth) {  // refill below the deepest, ahead of need
          const int below = prev_vertex(s.bits, cur, q, top.deepest());
          const int u = (below >> 5) == q ? mine[below & 31] : __ldg(row + r0 + below);
          top.refill(below, left ? -u : u);
        }
      } else {
        if (has) {
          cur |= 1u << b;
          if (size == 0) first = p;
          top.push(p, x);
          ++size;
        }
        ++b;
      }
    }
    s.bits[q] = cur;
  }
  __syncwarp();
  int last = top.p[0];  // the lane's chain: first .. last (first < 0: no row)
  for (int step = 1; step < active; step <<= 1) {
    const int rfirst = __shfl_down_sync(FULL, first, step), rlast = __shfl_down_sync(FULL, last, step);
    if ((lane & (2 * step - 1)) == 0 && rfirst >= 0) {
      if (first < 0) {
        first = rfirst;
      } else {
        int i = last, j = rfirst;
        int xi = side_x(row, left, r0 + i), xj = side_x(row, left, r0 + j);
        for (bool moved = true; moved;) {
          moved = false;
          while (i != first) {
            const int p = prev_vertex(s.bits, 0u, -1, i), xp = side_x(row, left, r0 + p);
            if (cross(p, xp, i, xi, j, xj) < 0) break;
            s.bits[i >> 5] &= ~(1u << (i & 31));
            i = p;
            xi = xp;
            moved = true;
          }
          while (j != rlast) {
            const int n = next_vertex(s.bits, j), xn = side_x(row, left, r0 + n);
            if (cross(i, xi, j, xj, n, xn) < 0) break;
            s.bits[j >> 5] &= ~(1u << (j & 31));
            j = n;
            xj = xn;
            moved = true;
          }
        }
      }
      last = rlast;
    }
    __syncwarp();
  }
  // the vertices in row order, and each word's rank
  int size_all = 0;
  for (int base = 0; base < words; base += 32) {
    const int q = base + lane;
    const unsigned m = q < words ? s.bits[q] : 0u;
    const int n = __popc(m);
    int incl = n;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(FULL, incl, off);
      if (lane >= off) incl += o;
    }
    int k = size_all + incl - n;
    if (q < words) s.rank[q] = k;
    for (unsigned rest = m; rest; rest &= rest - 1, ++k) {
      const int t = r0 + (q << 5) + __ffs(rest) - 1;
      if (k < s.cap) s.stack[k] = make_int2(t, side_x(row, left, t));
    }
    size_all += __shfl_sync(FULL, incl, 31);
  }
  __syncwarp();
  long long acc = 0;
  if (size_all == 0) return acc;
  const int count = min(size_all, s.cap);
  const int lo = s.stack[0].x - r0, hi = s.stack[count - 1].x - r0;
#pragma unroll 4
  for (int q = lo >> 5; q <= (hi >> 5); ++q) {
    const int p = (q << 5) + lane;
    if (p < lo || p > hi) continue;
    const int k = s.rank[q] + __popc(s.bits[q] & ((2u << lane) - 1)) - 1;  // the last vertex at or above row p
    const int2 a = s.stack[k];
    if (k == count - 1) {
      acc += a.y;
    } else {
      const int2 b = s.stack[k + 1];
      acc += edge_floor(a.x, a.y, b.x, b.y, r0 + p);
    }
  }
  __syncwarp();  // every lane has read the stack and the bits before the next side
  return acc;
}

// One side of a region of at most 32 rows, in registers: a lane a row.
// Every lane runs the same chain over the rows (their x by shuffles, the
// stack as a bitmask with its top two in registers: no lane diverges),
// then each lane adds its row's floor, the ends of its edge found by a bit
// scan of the final chain and their x by shuffles.
__device__ long long hull_side_word(const int* __restrict__ row, bool left, int r0, int rows, int lane) {
  const int v = lane < rows ? __ldg(row + r0 + lane) : (left ? BIG : -1);
  const int x = left ? -v : v;
  const unsigned with = __ballot_sync(FULL, left ? v < BIG : v >= 0);
  unsigned chain = 0;
  int size = 0, p0 = 0, x0 = 0, p1 = 0, x1 = 0;  // the second and the top
  for (unsigned rest = with; rest; rest &= rest - 1) {
    const int p = __ffs(rest) - 1, xp = __shfl_sync(FULL, x, p);
    while (size >= 2 && cross(p0, x0, p1, x1, p, xp) >= 0) {
      chain &= ~(1u << p1);
      --size;
      p1 = p0;
      x1 = x0;
      if (size >= 2) {
        p0 = 31 - __clz(chain & ((1u << p1) - 1));
        x0 = __shfl_sync(FULL, x, p0);
      }
    }
    chain |= 1u << p;
    p0 = p1;
    x0 = x1;
    p1 = p;
    x1 = xp;
    ++size;
  }
  const unsigned upto = chain & ((2u << lane) - 1), beyond = chain & ~((2u << lane) - 1);
  const int a = upto ? 31 - __clz(upto) : 0, b = beyond ? __ffs(beyond) - 1 : a;
  const int xa = __shfl_sync(FULL, x, a), xb = __shfl_sync(FULL, x, b);
  if (!upto) return 0;                      // above the first vertex, or no chain
  if (!beyond) return lane == a ? xa : 0;  // the last vertex's row, or past it
  return edge_floor(a, xa, b, xb, lane);
}

// The bytes of a warp's shared memory: the tile or the stack, then bits and rank.
__host__ __device__ __forceinline__ long long hull_warp_bytes(int h, int cap) {
  const long long area = static_cast<long long>(cap) * 8 > TILE_BYTES ? static_cast<long long>(cap) * 8 : TILE_BYTES;
  return area + 8LL * ((h + 31) / 32);
}

// A warp a side of a (frame, region): warps 2k (right side, mx) and 2k + 1
// (left side, -mn) of a block take region 2 * block + k, so the two
// chains run side by side; the left warp hands its sum over by shared
// memory.
__global__ void __launch_bounds__(HULL_WARPS * 32)
    hull_areas_kernel(const int* __restrict__ mn, const int* __restrict__ mx, const int* __restrict__ minr,
                      const int* __restrict__ maxr, long long* __restrict__ hull, long long regions, int h,
                      int nseg, int cap) {
  extern __shared__ __align__(16) unsigned char s_hull[];
  __shared__ long long s_left[HULL_WARPS / 2];
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const bool left = warp & 1;
  const long long g = blockIdx.x * static_cast<long long>(HULL_WARPS / 2) + warp / 2;
  const int r0 = g < regions ? minr[g] : 0, r1 = g < regions ? maxr[g] : -1;
  const bool live = g < regions && g % nseg != 0 && r1 >= r0;
  long long acc = 0;
  if (live) {
    unsigned char* mine = s_hull + warp * hull_warp_bytes(h, cap);
    const long long area = hull_warp_bytes(h, cap) - 8LL * ((h + 31) / 32);
    HullShared s;
    s.tile = reinterpret_cast<int*>(mine);
    s.stack = reinterpret_cast<int2*>(mine);
    s.bits = reinterpret_cast<unsigned*>(mine + area);
    s.rank = reinterpret_cast<int*>(mine + area + 4LL * ((h + 31) / 32));
    s.cap = cap;
    const int* row = (left ? mn : mx) + g * h;
    const int rows = r1 - r0 + 1;
    acc = warp_sum<long long>(rows <= 32 ? hull_side_word(row, left, r0, rows, lane)
                                         : hull_side(row, left, r0, rows, s, lane));
  }
  if (left && lane == 0) s_left[warp / 2] = acc;
  __syncthreads();
  if (!left && lane == 0 && g < regions) hull[g] = live ? acc + s_left[warp / 2] + (r1 - r0 + 1) : 0;
}

// ---------------------------------------------------------------------------
// D: annotation

constexpr int ANNOTATE_THREADS = 128;  // a block: 128 / span regions, or one region of span threads
constexpr int COPY_BLOCKS = 132 * 16;  // blocks of the image copy at most
constexpr int BOX = 7;  // valid, minr, minc, maxr + 1, maxc + 1, floor(centroid r), floor(centroid c)
constexpr int MAX_PIXEL_BYTES = 64;
constexpr int MAX_SPAN = 16384;  // threads a region at most: 16 blocks of 1024

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); }

// f(p, key) for every pixel p (its index in the frame) of one region's
// paint, its span threads taking turns (i: the thread's index among
// them): key 2L on its two nested bbox outlines (clipped as
// region_annotate_j's border_mask clips them), 2L + 1 on its radius-3
// disk.  A pixel where outlines meet comes more than once.  The zeroing,
// the paint and the colour pass all walk these pixels, so the three pixel
// sets are one.
template <typename F>
__device__ __forceinline__ void for_each_painted(const int* box, int label, int h, int w, int i, int span, F f) {
  const int border = 2 * label;
  const int y0 = box[1], x0 = box[2], y1 = box[3], x1 = box[4];
  // the outlines' rows ya and yb (off 0: y0, y1; off -1: y0 + 1, y1 - 1), each over its columns
  for (int off = -1; off <= 0; ++off) {
    const int xa = x0 - off, ya = y0 - off, xb = x1 + off, yb = y1 + off;
    const int cxa = clampi(min(xa, xb), 0, w - 1), cxb = clampi(max(xa, xb), 0, w - 1);
    for (int c = cxa + i; c <= cxb; c += span) {
      if (ya >= 0 && ya < h) f(static_cast<long long>(ya) * w + c, border);
      if (yb >= 0 && yb < h) f(static_cast<long long>(yb) * w + c, border);
    }
  }
  // the outlines' columns xa and xb over their rows, four pixels a row (x0,
  // x0 + 1, x1 - 1, x1: off 0, -1, -1, 0), so neighbouring threads take
  // neighbouring pixels of a row and share its sectors
  const int ra0 = clampi(min(y0, y1), 0, h - 1), rb0 = clampi(max(y0, y1), 0, h - 1);
  const int ra1 = clampi(min(y0 + 1, y1 - 1), 0, h - 1), rb1 = clampi(max(y0 + 1, y1 - 1), 0, h - 1);
  const int lo = min(ra0, ra1), items = 4 * (max(rb0, rb1) - lo + 1);
  for (int k = i; k < items; k += span) {
    const int r = lo + (k >> 2), j = k & 3;
    const bool outer = j == 0 || j == 3;
    const int c = j == 0 ? x0 : (j == 1 ? x0 + 1 : (j == 2 ? x1 - 1 : x1));
    if (r >= (outer ? ra0 : ra1) && r <= (outer ? rb0 : rb1) && c >= 0 && c < w)
      f(static_cast<long long>(r) * w + c, border);
  }
  for (int k = i; k < 49; k += span) {
    const int dy = k / 7 - 3, dx = k % 7 - 3;
    const int y = box[5] + dy, x = box[6] + dx;
    if (dy * dy + dx * dx <= 9 && y >= 0 && y < h && x >= 0 && x < w) f(static_cast<long long>(y) * w + x, border + 1);
  }
}

// A pixel's n bytes from src (shared memory) to dst, in stores of one
// width for every pixel (4 bytes where n is a multiple of 4, else 2, else
// 1: out is 16-byte aligned, so every pixel is), so the lanes that write
// neighbouring pixels of a row run the same stores and share sectors.
__device__ __forceinline__ void put_pixel(uint8_t* dst, const uint8_t* src, int n) {
  if (n % 4 == 0) {
    for (int b = 0; b < n; b += 4)
      *reinterpret_cast<uint32_t*>(dst + b) = *reinterpret_cast<const uint32_t*>(src + b);
  } else if (n % 2 == 0) {
    for (int b = 0; b < n; b += 2)
      *reinterpret_cast<uint16_t*>(dst + b) = *reinterpret_cast<const uint16_t*>(src + b);
  } else {
    for (int b = 0; b < n; ++b) dst[b] = src[b];
  }
}

struct Annotation {
  const int* boxes;  // (n * nseg, BOX)
  int* keys;         // (n, h, w), read and written only at painted pixels
  long long regions;
  int h, w, nseg;
  int span;  // threads a region: a power of two, 8 .. MAX_SPAN, over span / blockDim.x blocks past 1024
};

// The (frame, region) of this thread's span in block `block`, or -1 for
// none (region 0, an empty region, past the end); the frame's key plane in
// *plane, the thread's index in its span in *i.
__device__ __forceinline__ long long span_region(const Annotation& a, long long block, int** plane, int* i) {
  long long g;
  if (a.span <= static_cast<int>(blockDim.x)) {
    g = block * (blockDim.x / a.span) + threadIdx.x / a.span;
    *i = threadIdx.x % a.span;
  } else {
    const int blocks = a.span / blockDim.x;
    g = block / blocks;
    *i = static_cast<int>(block % blocks) * blockDim.x + threadIdx.x;
  }
  if (g >= a.regions || g % a.nseg == 0 || a.boxes[g * BOX] == 0) return -1;
  *plane = a.keys + (g / a.nseg) * a.h * static_cast<long long>(a.w);
  return g;
}

// Blocks 0 .. copy_blocks - 1 copy the image's bytes to out (16 bytes a
// load and a store where both are aligned, 4 loads in flight, the ragged
// tail a byte at a time); the others zero the key plane at the pixels
// their regions paint.
__global__ void annotate_copy_kernel(const uint8_t* __restrict__ img, uint8_t* __restrict__ out, long long bytes,
                                     int copy_blocks, Annotation a) {
  asm volatile("griddepcontrol.launch_dependents;");  // the paint's blocks may start and wait for this grid
  if (static_cast<int>(blockIdx.x) < copy_blocks) {
    const long long thread = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
    const long long threads = static_cast<long long>(copy_blocks) * blockDim.x;
    const bool aligned = ((reinterpret_cast<uintptr_t>(img) | reinterpret_cast<uintptr_t>(out)) & 15u) == 0;
    const long long vectors = aligned ? bytes / 16 : 0;
    const uint4* src = reinterpret_cast<const uint4*>(img);
    uint4* dst = reinterpret_cast<uint4*>(out);
    long long v = thread;
    for (; v + 3 * threads < vectors; v += 4 * threads) {
      const uint4 v0 = src[v], v1 = src[v + threads], v2 = src[v + 2 * threads], v3 = src[v + 3 * threads];
      dst[v] = v0;
      dst[v + threads] = v1;
      dst[v + 2 * threads] = v2;
      dst[v + 3 * threads] = v3;
    }
    for (; v < vectors; v += threads) dst[v] = src[v];
    for (long long b = vectors * 16 + thread; b < bytes; b += threads) out[b] = img[b];
    return;
  }
  int* plane = nullptr;
  int i = 0;
  const long long g = span_region(a, blockIdx.x - copy_blocks, &plane, &i);
  if (g < 0) return;
  for_each_painted(a.boxes + g * BOX, static_cast<int>(g % a.nseg), a.h, a.w, i, a.span,
                   [plane](long long p, int) { plane[p] = 0; });
}

// The paint: atomicMax of each pixel's key, so the largest key is the
// reference's last painter (a later region over an earlier one, the disk
// over the outlines).
__global__ void annotate_paint_kernel(Annotation a) {
  asm volatile("griddepcontrol.launch_dependents;");
  int* plane = nullptr;
  int i = 0;
  const long long g = span_region(a, blockIdx.x, &plane, &i);
  asm volatile("griddepcontrol.wait;" ::: "memory");  // the copy and the zeros are done and visible
  if (g < 0) return;
  for_each_painted(a.boxes + g * BOX, static_cast<int>(g % a.nseg), a.h, a.w, i, a.span,
                   [plane](long long p, int key) { atomicMax(plane + p, key); });
}

// The colours: where a pixel's key is the walker's own, its bytes become
// the green pixel's (even key) or the red one's (odd), staged in shared
// memory.  The writers of one pixel all
// hold its largest key, so they write the same bytes.
__global__ void annotate_colour_kernel(Annotation a, const uint8_t* __restrict__ colours, uint8_t* __restrict__ out,
                                       int pixel_bytes) {
  __shared__ __align__(4) uint8_t s_colours[2 * MAX_PIXEL_BYTES];
  if (threadIdx.x < 2 * pixel_bytes) s_colours[threadIdx.x] = colours[threadIdx.x];
  __syncthreads();
  int* plane = nullptr;
  int i = 0;
  const long long g = span_region(a, blockIdx.x, &plane, &i);
  asm volatile("griddepcontrol.wait;" ::: "memory");  // the paint (after the copy) is done and visible
  if (g < 0) return;
  const int bytes = pixel_bytes;
  const uint8_t* pair = s_colours;
  uint8_t* frame = out + (g / a.nseg) * a.h * static_cast<long long>(a.w) * bytes;
  for_each_painted(a.boxes + g * BOX, static_cast<int>(g % a.nseg), a.h, a.w, i, a.span,
                   [plane, frame, bytes, pair](long long p, int key) {
                     if (__ldg(plane + p) == key) put_pixel(frame + p * bytes, pair + (key & 1) * bytes, bytes);
                   });
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
// (maxr < minr for an empty region); hull: (n, nseg) int64 out, 0 for
// region 0 and empty regions.  cap: the hull vertices a warp's stack
// holds, at least ops/regionprops.py:hull_stack_capacity of the frames
// (HULL_WARPS x hull_warp_bytes(h, cap) bytes of shared memory a block).
extern "C" int yam_hull_areas(const void* mn, const void* mx, const void* minr, const void* maxr, void* hull, int n,
                              int h, int nseg, int cap, void* stream) {
  if (n < 0 || h <= 0 || nseg < 1 || cap < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long regions = static_cast<long long>(n) * nseg;
  const long long blocks = (regions + HULL_WARPS / 2 - 1) / (HULL_WARPS / 2);
  const size_t shared = static_cast<size_t>(HULL_WARPS * hull_warp_bytes(h, cap));
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (blocks == 0) return static_cast<int>(cudaGetLastError());
  if (shared > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(hull_areas_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(shared));
    if (err != cudaSuccess) {
      cudaGetLastError();  // a refused attribute leaves its error behind for the next launch's check: take it
      return static_cast<int>(err);
    }
  }
  hull_areas_kernel<<<static_cast<unsigned>(blocks), HULL_WARPS * 32, shared, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(mn), static_cast<const int*>(mx), static_cast<const int*>(minr),
      static_cast<const int*>(maxr), static_cast<long long*>(hull), regions, h, nseg, cap);
  return static_cast<int>(cudaGetLastError());
}

// img: (n, h, w) pixels of pixel_bytes bytes each (any dtype, any
// channels); boxes: (n, nseg, 7) int32 (valid, minr, minc, maxr + 1,
// maxc + 1, floor of the centroid's row and column); keys: (n, h, w) int32
// scratch, any contents (only painted pixels are written and read);
// colours: the green and the red pixel, 2 * pixel_bytes bytes; out: like
// img, 16-byte aligned.  Three launches: the copy (and the keys zeroed
// where painted), the paint, the colours.  A region's pixels are walked
// by `span` threads: the power of two from 8 to MAX_SPAN (256 where there
// are 32 regions or more) that puts about a quarter of the threads the
// card holds at once (2048 an SM) on the regions, so a batch of many small
// regions and a frame of one large region both spread over the card.
extern "C" int yam_annotate(const void* img, const void* boxes, void* keys, void* out, const void* colours, int n,
                            int h, int w, int pixel_bytes, int nseg, void* stream) {
  if (n < 0 || h <= 0 || w <= 0 || nseg < 1 || pixel_bytes < 1 || pixel_bytes > MAX_PIXEL_BYTES)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long regions = static_cast<long long>(n) * nseg;
  const long long bytes = static_cast<long long>(n) * h * w * pixel_bytes;
  if (bytes == 0) return static_cast<int>(cudaGetLastError());
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int most = regions < 32 ? MAX_SPAN : 256;
  int span = 8;
  while (span < most && static_cast<long long>(span) * 2 * regions <= 512LL * sms) span *= 2;
  const int threads = span < ANNOTATE_THREADS ? ANNOTATE_THREADS : (span < 1024 ? span : 1024);
  const long long region_blocks =
      span <= threads ? (regions + threads / span - 1) / (threads / span) : regions * (span / threads);
  const long long want = (bytes / 16 + 4LL * threads - 1) / (4LL * threads);
  const int copy_blocks = static_cast<int>(want < 1 ? 1 : (want < COPY_BLOCKS ? want : COPY_BLOCKS));
  if (copy_blocks + region_blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Annotation a{static_cast<const int*>(boxes), static_cast<int*>(keys), regions, h, w, nseg, span};
  annotate_copy_kernel<<<static_cast<unsigned>(copy_blocks + region_blocks), threads, 0, s>>>(
      static_cast<const uint8_t*>(img), static_cast<uint8_t*>(out), bytes, copy_blocks, a);
  // the paint and the colours by programmatic dependent launch: their
  // blocks start while the grid before them runs, load their boxes, and
  // wait (griddepcontrol.wait) for it to finish before touching the planes
  cudaLaunchAttribute early;
  early.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  early.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(region_blocks));
  config.blockDim = dim3(threads);
  config.stream = s;
  config.attrs = &early;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, annotate_paint_kernel, a);
  if (err == cudaSuccess)
    err = cudaLaunchKernelEx(&config, annotate_colour_kernel, a, static_cast<const uint8_t*>(colours),
                             static_cast<uint8_t*>(out), pixel_bytes);
  if (err != cudaSuccess) {
    cudaGetLastError();  // a refused launch leaves its error behind for the next launch's check: take it
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
