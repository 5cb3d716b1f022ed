// Level-synchronous marker watershed flood: every sweep of a call in one
// persistent cooperative launch, with stable tiles skipped.
//
// Replaces yamimageprocessor_tpu/ops/watershed_pallas.py:_build_flood (its
// pallas_call at line 233) and the level loop of flood_pallas around it.
// The TPU kernel's K sweeps per VMEM-resident row block (temporal blocking)
// are not carried over; its stable-block skipping is, as tiles.
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
// Design.  One cooperative launch (so that every block is resident) runs
// all the sweeps of all the frames, separated by cooperative groups' grid
// barrier; nothing goes back to the host.  The work items are (frame,
// tile) pairs, tiles of TILE_ROWS rows by 128 columns, one warp an item: the warps of the grid walk the items in a grid-stride loop every
// sweep, each on its own (no block barrier).  A sweep is bound by latency,
// not bytes (a row walked with its loads in registers waits a round trip
// to L2 a row), so a warp first copies its whole tile with its one-pixel
// halo into shared memory with cp.async (labels through L2, 16 bytes a
// lane), every load in flight at once, after one round of loads that
// decides whether the tile is active; then it computes the rows from
// shared memory, a lane owning 4 consecutive columns (the left and right
// neighbours from the adjacent lanes by shuffles), skipping rows with no
// unknown pixel, and stores a lane's 4 labels in one 16-byte store: every
// group of a tile that fired at the previous sweep (the other buffer is a
// sweep behind there), else only the groups in which a pixel fired (the
// other buffer already holds the rest).  Frames are 4-column aligned: the
// wrapper pads a frame's width to a multiple of 4 with boundary labels (-1,
// which neither fire nor count as a positive neighbour) and crops after.
//
// Stable-tile skipping, the TPU kernel's rule (watershed_pallas.py:251-289).
// A tile sweeps at sweep q + 1 when it or a 4-neighbour tile changed at q,
// or when the frame's level jumped at q and its stored frontier or a
// neighbour's is <= the new level; every tile sweeps at q = 0.  A skipped
// tile keeps its stored frontier, which still folds into the frame's
// minimum.  This is exact: a pixel can only fire if its neighbourhood
// changed or the level rose to its trig_cost.  And a tile that changed at
// q sweeps at q + 1, so once it is stable both buffers hold its labels:
// a skipped tile needs no copy, and after a frame's last sweep (a stall)
// the two buffers are equal.
//
// Per-frame state, so that one grid barrier a sweep is enough: the level
// is double-buffered by sweep parity, and the per-sweep "fired" flag, the
// frontier minimum (stored as 0xFFFF - min, so that zero means none) and
// the count of frames still flooding are triple-buffered by sweep mod 3:
// the slot a sweep accumulates into was last read two barriers before, and
// the sweep before resets it.  Every warp derives a frame's level at sweep
// q from the level and the flags of sweep q - 1, so all agree.  Per tile,
// the fired flag and the frontier are double-buffered by parity.  Anything
// another block wrote in an earlier sweep is read through L2 (__ldcg,
// cp.async.cg): L1 is not coherent across SMs within a launch.  A tile
// that fired posts no frontier (the level cannot jump in that sweep), so
// the same-address atomics are few.  The launch ends after a sweep in
// which no frame flooded.
//
// Costs: the "down" and "right" planes (n, h, w) of uint8 (uint8 images) or
// uint16 saturated at 256 (wider images): a cost >= 256 never fires, since
// levels stop at 255, and a frontier >= 256 jumps to 256 whatever it is.
// Row h - 1 of "down" and column w - 1 of "right" are padding, never used.
//
// Bound on the card: per sweep, the labels of the tiles swept in and out
// (8 B a pixel, plus the halo) and 2 or 4 B of costs, from L2 where the
// two label buffers and the costs fit (42 MB at 2048^2), times the sweeps,
// which the data sets, plus a grid barrier a sweep; the floor for a flood
// is one pass (image and markers in, labels out).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int TILE_COLS = 128;  // a warp, 4 columns a lane
// A tile's rows: 16 sweeps the segmentation chain's watershed input faster
// than 32 on an H100 (PERF.md).  ops/watershed.py mirrors the value.
constexpr int TILE_ROWS = 16;
constexpr int GROUPS = TILE_COLS / 4 + 2;  // 4-column groups a tile row holds, with the halo
constexpr unsigned FULL = 0xffffffffu;
constexpr int BIG_COST = 0xFFFF;
constexpr int BIG_LABEL = 1 << 30;
constexpr int LEVELS = 256;

// state (int32), for n frames of T tiles each:
//   level[2][n], fired[3][n], front[3][n] (0xFFFF - frontier min), then
//   stats[n][3] (sweeps, levels visited, tiles swept), running[3], then
//   per tile fired[2][n T] and frontier[2][n T]
struct State {
  int *level, *fired, *front, *stats, *running, *tile_fired, *tile_front;
  __device__ State(int* s, int n, long long items)
      : level(s),
        fired(s + 2 * n),
        front(s + 5 * n),
        stats(s + 8 * n),
        running(s + 11 * n),
        tile_fired(s + 11 * n + 3),
        tile_front(s + 11 * n + 3 + 2 * items) {}
};

// A warp's tile in shared memory: label rows y0 - 1 .. y0 + TILE_ROWS, each
// of GROUPS int4 (columns x0 - 4 .. x0 + 131); "down" cost rows y0 - 1 ..
// y0 + TILE_ROWS - 1 of 32 groups; "right" cost rows y0 .. y0 + TILE_ROWS -
// 1 of 33 groups (from x0 - 4).  A group of 4 costs is 4 * sizeof(CostT)
// bytes.
template <typename CostT>
struct Tile {
  using Costs = typename std::conditional<sizeof(CostT) == 1, uint32_t, uint2>::type;
  static constexpr size_t LAB_BYTES = (TILE_ROWS + 2) * GROUPS * sizeof(int4);
  static constexpr size_t DOWN_BYTES = (TILE_ROWS + 1) * 32 * sizeof(Costs);
  // rounded up to 16 bytes, so that the next warp's tile is aligned too
  static constexpr size_t BYTES = (LAB_BYTES + DOWN_BYTES + TILE_ROWS * 33 * sizeof(Costs) + 15) / 16 * 16;
  int4* lab;
  Costs *down, *right;
  __device__ explicit Tile(char* base)
      : lab(reinterpret_cast<int4*>(base)),
        down(reinterpret_cast<Costs*>(base + LAB_BYTES)),
        right(reinterpret_cast<Costs*>(base + LAB_BYTES + DOWN_BYTES)) {}
};

__device__ __forceinline__ void cp_async_cg16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

template <int BYTES>
__device__ __forceinline__ void cp_async_ca(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(src), "n"(BYTES) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

template <typename Costs>
__device__ __forceinline__ void unpack(int (&c)[4], Costs v) {
  if constexpr (sizeof(Costs) == 4) {
#pragma unroll
    for (int j = 0; j < 4; ++j) c[j] = (v >> (8 * j)) & 0xff;
  } else {
    c[0] = v.x & 0xffff, c[1] = v.x >> 16, c[2] = v.y & 0xffff, c[3] = v.y >> 16;
  }
}

// Starts the copies of a tile (origin y0, x0 of a frame h by w, frame-
// relative pointers) into shared memory; out-of-frame label groups are
// zeroed (label 0), out-of-frame costs are never read.
template <typename CostT>
__device__ __forceinline__ void fetch_tile(const Tile<CostT>& t, const int* src, const CostT* down,
                                           const CostT* right, int h, int w, int y0, int x0) {
  using Costs = typename Tile<CostT>::Costs;
  const int lane = threadIdx.x & 31;
  for (int r = 0; r < TILE_ROWS + 2; ++r) {
    const int y = y0 - 1 + r;
    for (int g = lane; g < GROUPS; g += 32) {
      const int x = x0 - 4 + 4 * g;
      int4* to = t.lab + r * GROUPS + g;
      if (y >= 0 && y < h && x >= 0 && x < w) {
        cp_async_cg16(to, src + static_cast<long long>(y) * w + x);
      } else {
        *to = make_int4(0, 0, 0, 0);
      }
    }
  }
  for (int r = 0; r < TILE_ROWS + 1; ++r) {
    const int y = y0 - 1 + r;
    const int x = x0 + 4 * lane;
    if (y >= 0 && y < h && x < w) {
      cp_async_ca<sizeof(Costs)>(t.down + r * 32 + lane, down + static_cast<long long>(y) * w + x);
    }
  }
  for (int r = 0; r < TILE_ROWS; ++r) {
    const int y = y0 + r;
    for (int g = lane; g < 33; g += 32) {
      const int x = x0 - 4 + 4 * g;
      if (y < h && x >= 0 && x < w) {
        cp_async_ca<sizeof(Costs)>(t.right + r * 33 + g, right + static_cast<long long>(y) * w + x);
      }
    }
  }
}

// A frame's level at a sweep from its level, fired flag and stored frontier
// at the previous sweep, with JUMPED set where the level jumped (the
// previous sweep was a stall; the level stays once it reached 256).
constexpr int JUMPED = 1 << 16;

__device__ __forceinline__ int next_level(int level, int fired, int front) {
  if (level >= LEVELS || fired) return level;
  return max(min(BIG_COST - front, LEVELS), level + 1) | JUMPED;
}

__device__ __forceinline__ void take(int nl, int cost, int& tc, int& pmin, int& pmax) {
  if (nl > 0) {
    tc = min(tc, cost);
    pmin = min(pmin, nl);
  }
  pmax = max(pmax, nl);
}

__device__ __forceinline__ void to_array(int (&a)[4], int4 v) { a[0] = v.x, a[1] = v.y, a[2] = v.z, a[3] = v.w; }

// One sweep of a tile from shared memory into dst (frame-relative): rows
// y0 .. y0 + TILE_ROWS - 1 (those in the frame), a lane owning columns x..x+3.
// A row with no unknown pixel in the warp skips the neighbour arithmetic.
// With `full`, every group of 4 labels is stored; otherwise dst already
// holds the tile's labels and only the groups in which a pixel fired are.
// fired: a pixel fired; fmin: min trig_cost over the pixels still unknown.
template <typename CostT>
__device__ __forceinline__ void sweep_tile(const Tile<CostT>& t, int* dst, int h, int w, int y0, int x0, int level,
                                           bool full, bool& fired, int& fmin) {
  const int lane = threadIdx.x & 31;
  const int x = x0 + 4 * lane;
  const int yb = min(TILE_ROWS, h - y0);
  for (int i = 0; i < yb; ++i) {
    int cen[4], out[4];
    to_array(cen, t.lab[(i + 1) * GROUPS + lane + 1]);
    const bool any_unknown = x < w && (cen[0] == 0 || cen[1] == 0 || cen[2] == 0 || cen[3] == 0);
    bool group_fired = false;
#pragma unroll
    for (int j = 0; j < 4; ++j) out[j] = cen[j];
    if (__any_sync(FULL, any_unknown)) {
      int up[4], dn[4], cu[4], cd[4], cr[4];
      to_array(up, t.lab[i * GROUPS + lane + 1]);
      to_array(dn, t.lab[(i + 2) * GROUPS + lane + 1]);
      unpack(cu, t.down[i * 32 + lane]);
      unpack(cd, t.down[(i + 1) * 32 + lane]);
      unpack(cr, t.right[i * 33 + lane + 1]);
      int left = __shfl_up_sync(FULL, cen[3], 1);
      int left_cost = __shfl_up_sync(FULL, cr[3], 1);
      int rgt = __shfl_down_sync(FULL, cen[0], 1);
      if (lane == 0) {  // the tile's left edge: the group before, in the halo
        left = t.lab[(i + 1) * GROUPS].w;
        int lc[4];
        unpack(lc, t.right[i * 33]);
        left_cost = lc[3];
      }
      if (lane == 31) rgt = t.lab[(i + 1) * GROUPS + 33].x;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (cen[j] != 0 || x >= w) continue;
        int tc = BIG_COST, pmin = BIG_LABEL, pmax = 0;
        take(up[j], cu[j], tc, pmin, pmax);
        take(dn[j], cd[j], tc, pmin, pmax);
        take(j ? cen[j - 1] : left, j ? cr[j - 1] : left_cost, tc, pmin, pmax);
        take(j < 3 ? cen[j + 1] : rgt, cr[j], tc, pmin, pmax);
        if (tc <= level) {
          out[j] = pmin != pmax ? -1 : pmin;
          group_fired = true;
        } else {
          fmin = min(fmin, tc);
        }
      }
    }
    fired |= group_fired;
    if (x < w && (full || group_fired)) {
      __stcg(reinterpret_cast<int4*>(dst + static_cast<long long>(y0 + i) * w + x),
             make_int4(out[0], out[1], out[2], out[3]));
    }
  }
}

// buf0 holds the initial labels, buf1 is scratch; after the launch both
// hold the result.  w is a multiple of 4 and the buffers 16-byte aligned.
// A warp sweeps a tile of TILE_ROWS rows by 128 columns, ty by tx tiles a
// frame; the warps of the grid walk the (frame, tile) items in a
// grid-stride loop every sweep.
template <typename CostT>
__global__ void __launch_bounds__(THREADS)
    flood_kernel(int* buf0, int* buf1, const CostT* __restrict__ down, const CostT* __restrict__ right, int* state,
                 int n, int h, int w, int ty, int tx) {
  extern __shared__ __align__(16) char smem[];
  const int tiles = ty * tx;
  const long long items = static_cast<long long>(n) * tiles;
  const State st(state, n, items);
  const long long hw = static_cast<long long>(h) * w;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const Tile<CostT> tile(smem + warp * Tile<CostT>::BYTES);
  const long long first_warp = static_cast<long long>(blockIdx.x) * WARPS + warp;
  const long long warps = static_cast<long long>(gridDim.x) * WARPS;
  cg::grid_group grid = cg::this_grid();
  int swept = 0, swept_frame = -1;  // tiles this warp swept, counted once a frame
  __shared__ int s_running;  // frames still flooding, read by one thread a block

  for (int q = 0;; ++q) {
    const int p = q & 1, prev_p = p ^ 1;
    const int* src = p ? buf1 : buf0;
    int* dst = p ? buf0 : buf1;
    const int slot = q % 3, prev_slot = (q + 2) % 3, next_slot = (q + 1) % 3;
    if (blockIdx.x == 0 && threadIdx.x == 0) st.running[next_slot] = 0;
    for (long long item = first_warp; item < items; item += warps) {
      const int f = static_cast<int>(item / tiles);
      const int t = static_cast<int>(item - static_cast<long long>(f) * tiles);
      const int tyi = t / tx, txi = t - tyi * tx;
      // One round of loads, a value a lane: lanes 0-4 the fired flags of
      // this tile and its 4 neighbours at the previous sweep, lanes 5-9
      // their frontiers, lanes 10-12 the frame's level, fired flag and
      // frontier at the previous sweep.
      const long long off = static_cast<long long>(f) * hw;
      const int y0 = tyi * TILE_ROWS, x0 = txi * TILE_COLS;
      int raw = 0;
      if (q > 0) {
        const int k = lane % 5;
        long long nb = -1;
        if (k == 0) nb = item;
        if (k == 1 && tyi > 0) nb = item - tx;
        if (k == 2 && tyi + 1 < ty) nb = item + tx;
        if (k == 3 && txi > 0) nb = item - 1;
        if (k == 4 && txi + 1 < tx) nb = item + 1;
        if (lane < 5 && nb >= 0) raw = __ldcg(st.tile_fired + prev_p * items + nb);
        if (lane >= 5 && lane < 10) raw = nb >= 0 ? __ldcg(st.tile_front + prev_p * items + nb) : BIG_COST;
        if (lane == 10) raw = __ldcg(st.level + prev_p * n + f);
        if (lane == 11) raw = __ldcg(st.fired + prev_slot * n + f);
        if (lane == 12) raw = __ldcg(st.front + prev_slot * n + f);
      }
      // the frame's level at this sweep (bit JUMPED: it jumped, a level left)
      int level = q > 0 ? next_level(__shfl_sync(FULL, raw, 10), __shfl_sync(FULL, raw, 11),
                                     __shfl_sync(FULL, raw, 12))
                        : 0;
      const bool jumped = level & JUMPED;
      level &= ~JUMPED;
      if (t == 0 && lane == 0) {  // one warp a frame keeps its state
        st.level[p * n + f] = level;
        st.fired[next_slot * n + f] = 0;
        st.front[next_slot * n + f] = 0;
        if (jumped) st.stats[3 * f + 1] += 1;  // a level was left
        if (level < LEVELS) {
          st.stats[3 * f] += 1;
          atomicAdd(st.running + slot, 1);
        }
      }
      if (level >= LEVELS) continue;
      // active: this tile or a 4-neighbour fired, or the level jumped to
      // its or a neighbour's frontier
      const bool wake = lane < 5 ? raw != 0 : (lane < 10 && jumped && raw <= level);
      const bool active = q == 0 || __any_sync(FULL, wake);
      const bool refired = __shfl_sync(FULL, raw, 0) != 0;  // this tile fired at the previous sweep
      bool fired = false;
      int fmin = __shfl_sync(FULL, raw, 5);  // a skipped tile keeps its frontier
      if (active) {
        fetch_tile(tile, src + off, down + off, right + off, h, w, y0, x0);
        cp_async_wait_all();
        __syncwarp();
        fmin = BIG_COST;
        // dst holds the tile's labels unless it fired at the previous sweep
        // (or nothing was written yet)
        sweep_tile(tile, dst + off, h, w, y0, x0, level, q == 0 || refired, fired, fmin);
        fired = __any_sync(FULL, fired);
        fmin = __reduce_min_sync(FULL, fmin);
        __syncwarp();  // the tile's shared memory is read before the next copy
        if (swept_frame != f) {
          if (lane == 0 && swept) atomicAdd(st.stats + 3 * swept_frame + 2, swept);
          swept = 0, swept_frame = f;
        }
        swept += 1;
      }
      if (lane == 0) {
        st.tile_fired[p * items + item] = fired;
        st.tile_front[p * items + item] = fmin;
        if (fired) {
          st.fired[slot * n + f] = 1;
        } else if (fmin < BIG_COST) {
          atomicMax(st.front + slot * n + f, BIG_COST - fmin);
        }
      }
    }
    grid.sync();  // this sweep's labels, flags, frontiers and counts are out
    if (threadIdx.x == 0) s_running = __ldcg(st.running + slot);
    __syncthreads();
    if (s_running == 0) break;  // no frame flooded this sweep
  }
  if (lane == 0 && swept) atomicAdd(st.stats + 3 * swept_frame + 2, swept);
}

// The dynamic shared memory of a block, allowed past 48 KB if needed.
template <typename CostT>
cudaError_t shared_bytes(size_t* smem) {
  *smem = WARPS * Tile<CostT>::BYTES;
  if (*smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(flood_kernel<CostT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(*smem));
}

template <typename CostT>
int resident_blocks(int* blocks) {
  size_t smem = 0;
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = shared_bytes<CostT>(&smem);
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, flood_kernel<CostT>, THREADS, smem);
  *blocks = per_sm * sms;
  return static_cast<int>(err);
}

template <typename CostT>
int launch(void* buf0, void* buf1, const void* down, const void* right, void* state, int n, int h, int w, int ty,
           int tx, int blocks, cudaStream_t stream) {
  size_t smem = 0;
  cudaError_t err = shared_bytes<CostT>(&smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int* b0 = static_cast<int*>(buf0);
  int* b1 = static_cast<int*>(buf1);
  const CostT* d = static_cast<const CostT*>(down);
  const CostT* r = static_cast<const CostT*>(right);
  int* s = static_cast<int*>(state);
  void* args[] = {&b0, &b1, &d, &r, &s, &n, &h, &w, &ty, &tx};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(flood_kernel<CostT>), dim3(blocks), dim3(THREADS),
                                    args, smem, stream);
  if (err != cudaSuccess) {
    cudaGetLastError();  // a refused launch leaves its error behind for the next launch's check: take it
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// blocks: how many blocks of the instance (wide: uint16 costs, else uint8)
// can be resident on the current device at once (what a cooperative launch
// allows).
extern "C" int yam_flood_resident_blocks(int wide, int* blocks) {
  return wide ? resident_blocks<uint16_t>(blocks) : resident_blocks<uint8_t>(blocks);
}

// buf0: (n, h, w) int32 initial labels, buf1 the same size scratch; after
// the launch both hold the flooded labels.  down, right: (n, h, w) costs,
// uint16 (wide) or uint8.  w a multiple of 4, every buffer 16-byte
// aligned.  state: 11 n + 3 + 4 n ty tx int32, zeroed; its ints [8 n, 11 n)
// receive each frame's (sweeps, levels visited, tiles swept).  Tiles of
// rows = TILE_ROWS rows (the caller's count, checked) by 128 columns, ty =
// ceil(h / rows) by tx = ceil(w / 128) a frame; one cooperative launch of
// `blocks` blocks of 4 warps, which must all be resident.
extern "C" int yam_flood(void* buf0, void* buf1, const void* down, const void* right, void* state, int n, int h, int w,
                         int rows, int blocks, int wide, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t align = reinterpret_cast<uintptr_t>(buf0) | reinterpret_cast<uintptr_t>(buf1) |
                          reinterpret_cast<uintptr_t>(down) | reinterpret_cast<uintptr_t>(right);
  if (n < 1 || h < 1 || w < 4 || w % 4 || align % 16 || rows != TILE_ROWS || blocks < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int ty = (h + TILE_ROWS - 1) / TILE_ROWS;
  const int tx = (w + TILE_COLS - 1) / TILE_COLS;
  if (wide) return launch<uint16_t>(buf0, buf1, down, right, state, n, h, w, ty, tx, blocks, s);
  return launch<uint8_t>(buf0, buf1, down, right, state, n, h, w, ty, tx, blocks, s);
}
