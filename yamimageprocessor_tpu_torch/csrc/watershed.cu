// Level-synchronous marker watershed flood, one Jacobi sweep a launch.
//
// Replaces yamimageprocessor_tpu/ops/watershed_pallas.py:_build_flood (its
// pallas_call at line 233) and the level loop of flood_pallas.  The TPU
// kernel runs K sweeps per VMEM-resident row block with K-row halos and
// skips stable blocks; none of that is carried over.
//
// The rule (yamimageprocessor_tpu/ops/watershed.py:watershed_j), per frame:
//   for each pixel, over its 4 neighbours (out of frame: label 0):
//     trig_cost = min cost to a neighbour with label > 0
//     pos_min   = min label > 0,  pos_max = max(0, labels)
//   a pixel fires when its label is 0 and trig_cost <= level; it takes -1
//   when pos_min != pos_max (two basins meet), else pos_min.
//   The level holds while a sweep fired anything; otherwise it jumps to
//   max(min(frontier, 256), level + 1), where frontier is the min trig_cost
//   over pixels still 0.  The flood ends when the level reaches 256.
// The result depends on the order of updates, so every sweep reads one
// buffer and writes the other (Jacobi, never in place), as the reference.
//
// Design: flood_sweep reads the frame's state (level, which buffer is
// current), does one sweep over the frame in a grid-stride loop, and folds
// "anything fired" and the frontier minimum into the state with one
// atomic each per block.  flood_update (one thread a frame) then flips the
// current buffer, counts the sweep and moves the level.  A frame whose
// level reached 256 makes both kernels return at once, so the host can
// queue sweeps in batches and look at the state only between batches.
// yam_flood_sweeps queues `count` (sweep, update) pairs.
//
// Costs: dyc (n, h-1, w) and dxc (n, h, w-1) uint8, the max over channels
// of |difference| to the pixel below and to the right, computed once.
//
// Bound on the card: device memory per sweep (read 4 B of labels and about
// 2 B of costs a pixel, write 4 B), times the number of sweeps, which the
// data sets; the floor for a flood is one pass (image and markers in,
// labels out).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int BIG_COST = 0xFFFF;
constexpr int BIG_LABEL = 1 << 30;
constexpr int LEVELS = 256;

// per-frame state, int32
enum { LEVEL = 0, CUR = 1, CHANGED = 2, FRONTIER = 3, SWEEPS = 4, STATE = 5 };

__global__ void __launch_bounds__(THREADS)
    flood_sweep(int* __restrict__ buf0, int* __restrict__ buf1, const uint8_t* __restrict__ dyc,
                const uint8_t* __restrict__ dxc, int* __restrict__ state, int h, int w) {
  __shared__ int warp_min[THREADS / 32];
  int* st = state + blockIdx.y * STATE;
  const int level = st[LEVEL];
  if (level >= LEVELS) return;
  const long long hw = static_cast<long long>(h) * w;
  const long long frame = static_cast<long long>(blockIdx.y) * hw;
  const int* src = (st[CUR] == 0 ? buf0 : buf1) + frame;
  int* dst = (st[CUR] == 0 ? buf1 : buf0) + frame;
  const uint8_t* cy = dyc + static_cast<long long>(blockIdx.y) * (h - 1) * w;
  const uint8_t* cx = dxc + static_cast<long long>(blockIdx.y) * h * (w - 1);

  bool fired = false;
  int frontier = BIG_COST;
  const int hw32 = h * w;  // the wrapper keeps a frame below 2**30 pixels
  for (int p = blockIdx.x * THREADS + threadIdx.x; p < hw32; p += gridDim.x * THREADS) {
    const int y = p / w;
    const int x = p - y * w;
    const int lab = src[p];
    int tc = BIG_COST, pmin = BIG_LABEL, pmax = 0;
    if (y > 0) {
      const int nl = src[p - w];
      if (nl > 0) {
        tc = min(tc, static_cast<int>(cy[p - w]));
        pmin = min(pmin, nl);
      }
      pmax = max(pmax, nl);
    }
    if (y + 1 < h) {
      const int nl = src[p + w];
      if (nl > 0) {
        tc = min(tc, static_cast<int>(cy[p]));
        pmin = min(pmin, nl);
      }
      pmax = max(pmax, nl);
    }
    if (x > 0) {
      const int nl = src[p - 1];
      if (nl > 0) {
        tc = min(tc, static_cast<int>(cx[p - y - 1]));
        pmin = min(pmin, nl);
      }
      pmax = max(pmax, nl);
    }
    if (x + 1 < w) {
      const int nl = src[p + 1];
      if (nl > 0) {
        tc = min(tc, static_cast<int>(cx[p - y]));
        pmin = min(pmin, nl);
      }
      pmax = max(pmax, nl);
    }
    const bool unknown = lab == 0;
    const bool trig = unknown && tc <= level;
    dst[p] = trig ? (pmin != pmax ? -1 : pmin) : lab;
    fired |= trig;
    if (unknown && !trig) frontier = min(frontier, tc);
  }

  const bool block_fired = __syncthreads_or(fired);
  frontier = __reduce_min_sync(0xffffffffu, frontier);
  if ((threadIdx.x & 31) == 0) warp_min[threadIdx.x >> 5] = frontier;
  __syncthreads();
  if (threadIdx.x == 0) {
    int m = warp_min[0];
    for (int i = 1; i < THREADS / 32; ++i) m = min(m, warp_min[i]);
    if (block_fired) atomicOr(st + CHANGED, 1);
    if (m < BIG_COST) atomicMin(st + FRONTIER, m);
  }
}

__global__ void flood_update(int* __restrict__ state, int n) {
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= n) return;
  int* st = state + f * STATE;
  if (st[LEVEL] >= LEVELS) return;
  st[CUR] ^= 1;
  st[SWEEPS] += 1;
  if (!st[CHANGED]) st[LEVEL] = max(min(st[FRONTIER], LEVELS), st[LEVEL] + 1);
  st[CHANGED] = 0;
  st[FRONTIER] = BIG_COST;
}

}  // namespace

// buf0, buf1: (n, h, w) int32 label buffers, the current one named by each
// frame's state[CUR]; dyc: (n, h-1, w) uint8; dxc: (n, h, w-1) uint8;
// state: (n, 5) int32 {level, cur, changed, frontier, sweeps}, changed 0
// and frontier 0xFFFF between sweeps.  Queues `count` sweeps.
extern "C" int yam_flood_sweeps(void* buf0, void* buf1, const void* dyc, const void* dxc,
                                void* state, int n, int h, int w, int blocks_per_frame,
                                int count, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(blocks_per_frame, n);
  const int update_blocks = (n + THREADS - 1) / THREADS;
  for (int i = 0; i < count; ++i) {
    flood_sweep<<<grid, THREADS, 0, s>>>(static_cast<int*>(buf0), static_cast<int*>(buf1),
                                         static_cast<const uint8_t*>(dyc),
                                         static_cast<const uint8_t*>(dxc),
                                         static_cast<int*>(state), h, w);
    flood_update<<<update_blocks, THREADS, 0, s>>>(static_cast<int*>(state), n);
  }
  return static_cast<int>(cudaGetLastError());
}
