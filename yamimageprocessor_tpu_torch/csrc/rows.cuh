// What the register-window kernels of edges.cu and adaptive.cu share: the
// plan of a persistent grid of warps over units of rows, and a warp's ring of
// staged frame rows.
//
// A warp walking down a strip of rows would wait on each row's loads.  The
// ring keeps AHEAD rows in flight by cp.async into shared memory instead,
// without registers: row i of the walk lives in slot i % DEPTH, whose byte s
// holds frame column col0 + s, until row i + DEPTH - AHEAD is made ready.
// Only 16-byte chunks inside the frame are copied (rows 16-byte aligned, w %
// 16 == 0); the caller reads words inside the frame only.  A block of rows
// is made ready at once (one wait and two warp barriers a block), so the
// rows' arithmetic can overlap.
#pragma once

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

// The launch of a persistent grid of WARPS-warp blocks over units of `band`
// rows x `span` columns: one unit a warp of the grid where the frames allow,
// `per_warp` where they hold enough rows, at least MIN_BAND rows a unit;
// never a few units more than the grid's slots (a second round for them
// would take as long as the first).
struct UnitPlan {
  int col_bands, row_bands, band, blocks;
  long long units;
};

// False, with err set, if the kernel's residency cannot be read; `resident`
// caches the blocks the card holds at once, from the first call.
template <int WARPS, int MIN_BAND, class Kernel>
bool plan_units(Kernel kernel, int& resident, int n, int h, int w, int span, int per_warp, UnitPlan& plan,
                cudaError_t& err) {
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 32 * WARPS, 0);
    if (err != cudaSuccess) return false;
    resident = per_sm * sms;
  }
  plan.col_bands = (w + span - 1) / span;
  const long long slots = static_cast<long long>(resident) * WARPS * per_warp;
  const long long bands = std::max<long long>(1, slots / (static_cast<long long>(n) * plan.col_bands));
  plan.band = std::min(h, std::max(MIN_BAND, static_cast<int>((h + bands - 1) / bands)));
  plan.row_bands = (h + plan.band - 1) / plan.band;
  plan.units = static_cast<long long>(n) * plan.col_bands * plan.row_bands;
  plan.blocks = static_cast<int>(std::min<long long>(resident, (plan.units + WARPS - 1) / WARPS));
  return true;
}

// slots of a ring: the least power of two holding `rows`
__host__ __device__ constexpr int ring_slots(int rows) { return rows <= 8 ? 8 : (rows <= 16 ? 16 : 32); }

template <int SPAN, int DEPTH, int AHEAD>
struct StagedRows {
  static_assert(SPAN % 16 == 0 && (DEPTH & (DEPTH - 1)) == 0 && AHEAD < DEPTH, "16-byte chunks, a power-of-two ring");
  uint8_t* slots;  // this warp's DEPTH x SPAN bytes
  const uint8_t* frame;
  int w, col0;
  int issued = 0;  // rows started

  __device__ const uint8_t* slot(int i) const { return slots + (i & (DEPTH - 1)) * SPAN; }

  __device__ unsigned word(int i, int col) const {
    return *reinterpret_cast<const unsigned*>(slot(i) + (col - col0));
  }

  // the previous walk's copies land first: two copies to one slot could land
  // in either order
  __device__ void begin() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncwarp();
    issued = 0;
  }

  // rows i .. i + N - 1 in their slots, visible to the warp; rows up to i +
  // N - 1 + AHEAD started (each into the slot of a row before i: N + AHEAD
  // <= DEPTH).  y_of(r) gives row r's frame row.
  template <int N, class Y>
  __device__ void ready(int i, Y y_of) {
    static_assert(N + AHEAD <= DEPTH, "a row is copied over only once read");
    __syncwarp();  // every lane is done with the slots about to be reused
    for (; issued < i + N + AHEAD; ++issued) {
      const uint8_t* src = frame + static_cast<long long>(y_of(issued)) * w + col0;
      const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(slot(issued)));
      for (int c = static_cast<int>(threadIdx.x % 32); c < SPAN / 16; c += 32) {
        const int col = col0 + 16 * c;
        if (col >= 0 && col < w)
          asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst + 16 * c), "l"(src + 16 * c) : "memory");
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
    asm volatile("cp.async.wait_group %0;\n" ::"n"(AHEAD) : "memory");
    __syncwarp();
  }
};
