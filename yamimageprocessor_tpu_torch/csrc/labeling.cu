// 8-connected components of uint8 masks: the minimum flat index of each
// pixel's component (background: SENTINEL = 2**30), int32.
//
// Replaces yamimageprocessor_tpu/ops/labeling_pallas.py:_build_cc (its
// pallas_call at line 214), the block-local min-propagation pass that
// cc_pallas and propagate_pallas iterate to a fixed point.  The TPU kernel
// solves row blocks in VMEM with neighbour-min and segmented row/column
// min-scans, alternates the sweep direction and skips quiet blocks, because
// a TPU has no scatter and no atomics.  The fixed point, the minimum flat
// index of the component, is unique, so any schedule gives the same bits.
//
// Bound on the card: device memory.  The function reads 1 B and writes 4 B
// a pixel (0.0063 ms at 2048^2).  A union-find over the whole frame, one
// thread a pixel, re-reads the labels through L2 in long pointer chases
// and sends global atomicMins from thousands of threads to the few roots
// of a large component.  This design keeps almost all of that in shared
// memory, after Playne and Hawick (IEEE TPDS 29(6), 2018) and Allegretti,
// Bolelli and Grana (IEEE TPDS 31(2), 2020).  Three launches on the stream,
// each grid (tiles, frames), a tile TILE_ROWS x TILE_COLS pixels of one
// frame (ragged right and bottom tiles masked; tiles never cross frames):
//
//   cc_local     a block a tile.  The mask comes into shared memory with
//                16-byte loads where rows allow.  A warp labels each row's
//                runs with __ballot_sync and __clz, pointing every pixel at
//                its run's start, with no atomics.  Then each pixel unites
//                with the row above only where a contact starts (below),
//                union-find in shared memory with atomicMin on local
//                indices.  Then every pixel gets its local root, written
//                once as a global flat index.  A tile's local raster order
//                is the frame's raster order restricted to the tile (a
//                lower tile row is a lower frame row; in one row, a lower
//                column), so the local minimum is the global minimum among
//                the tile's pixels of that component.  The block also
//                clears its tile's dirty flag.
//   cc_border    one thread a pixel on a tile's first row (linking to the
//                row above) or first column (linking to the column to the
//                left), diagonals included, about 1/TILE_ROWS + 1/TILE_COLS
//                of the pixels.  Global union-find: find both roots,
//                atomicMin the larger under the smaller, retry from the
//                value atomicMin returns when another thread got there
//                first; the tile of every root it relinks is marked dirty.
//   cc_compress  a block a dirty tile (clean ones return at once): its
//                labels into shared memory, then the few local roots that
//                now point outside the tile find their global root, then
//                every pixel follows its pointers inside shared memory.  A
//                label is written only where it changed.
//
// Hot roots.  A union is made only where a contact starts.  Along a
// boundary row, a "piece" is a run of foreground pixels inside one tile's
// columns (so phase 1 has already connected it).  A piece R = [s, e] of the
// lower row touches the upper row at [s-1, e+1]; each upper piece P meets
// that range in an interval, and R unites with P only at the interval's
// first pixel: at u = s-1, at u in [s, e] whose left neighbour is not in P
// (background, or in another tile), and at u = e+1 likewise.  Every
// crossing edge (r, u) then follows: r ~ R ~ that first pixel ~ P ~ u.
// Columns the same way.  An all-foreground frame makes about 3 unions a
// tile and boundary instead of 3 a boundary pixel
// (tests/test_torch_segmentation.py models all three phases in numpy and
// counts them).
//
// Links only ever point to a smaller index (lab[x] <= x), so a root is the
// minimum index of its tree.  Global reads bypass L1 (__ldcg): a stale
// parent is still an ancestor, and atomicMin's return value catches every
// race.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int TILE_ROWS = 32;
constexpr int TILE_COLS = 64;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SEGMENTS = TILE_COLS / 32;  // 32-pixel segments a tile row
constexpr int PER_THREAD = TILE_ROWS * SEGMENTS / WARPS;
constexpr int SENTINEL = 1 << 30;
constexpr int MAX_FRAMES = 65535;  // gridDim.y

static_assert(TILE_COLS % 32 == 0 && TILE_ROWS % WARPS == 0, "a warp labels whole rows");
static_assert(TILE_COLS % 16 == 0, "16-byte loads cover whole tile rows");

// ---------------------------------------------------------------------------
// union-find, in shared memory (local indices) and in global memory

// Path halving on the way (each node visited is pointed at its
// grandparent; after Jaiganesh and Burtscher's ECL-CC): a concurrent
// union's atomicMin that such a store overwrites returned the old parent,
// and that union goes on from there, so no link is lost.
__device__ __forceinline__ int find_shared(volatile int* s, int x) {
  int cur = s[x];
  if (cur != x) {
    int prev = x, next;
    while (cur > (next = s[cur])) {
      s[prev] = next;
      prev = cur;
      cur = next;
    }
  }
  return cur;
}

// read-only: for the run starts' last finds, which run concurrently with
// the stores of roots (a halving store there could put a start that holds
// its root back to an older ancestor)
__device__ __forceinline__ int root_shared(const volatile int* s, int x) {
  int parent = s[x];
  while (parent != x) {
    x = parent;
    parent = s[x];
  }
  return x;
}

__device__ void unite_shared(int* s, int a, int b) {
  for (;;) {
    a = find_shared(s, a);
    b = find_shared(s, b);
    if (a == b) return;
    if (a > b) {
      const int t = a;
      a = b;
      b = t;
    }
    const int old = atomicMin(s + b, a);
    if (old == b) return;
    b = old;
  }
}

// read-only: cc_compress may not write a label it does not own
__device__ __forceinline__ int find_global(const int* lab, int x) {
  int parent = __ldcg(lab + x);
  while (parent != x) {
    x = parent;
    parent = __ldcg(lab + x);
  }
  return x;
}

// with path halving, as find_shared, for the unions of cc_border
__device__ __forceinline__ int find_global_halving(int* lab, int x) {
  int cur = __ldcg(lab + x);
  if (cur != x) {
    int prev = x, next;
    while (cur > (next = __ldcg(lab + cur))) {
      lab[prev] = next;
      prev = cur;
      cur = next;
    }
  }
  return cur;
}

struct Frame {
  const uint8_t* fg;
  int* lab;
  uint8_t* dirty;  // a flag a tile
  int h, w, tiles_x;

  __device__ __forceinline__ int tile_of(int p) const {
    const int y = p / w;
    return (y / TILE_ROWS) * tiles_x + (p - y * w) / TILE_COLS;
  }

  __device__ void unite(int a, int b) const {
    for (;;) {
      a = find_global_halving(lab, a);
      b = find_global_halving(lab, b);
      if (a == b) return;
      if (a > b) {
        const int t = a;
        a = b;
        b = t;
      }
      const int old = atomicMin(lab + b, a);
      if (old > a) dirty[tile_of(b)] = 1;
      if (old == b) return;
      b = old;
    }
  }
};

__device__ __forceinline__ Frame frame_at(const uint8_t* fg, int* lab, uint8_t* dirty, int h, int w,
                                          int tiles_x, int tiles, long long frame) {
  const long long hw = static_cast<long long>(h) * w;
  return Frame{fg + frame * hw, lab + frame * hw, dirty + frame * tiles, h, w, tiles_x};
}

// ---------------------------------------------------------------------------
// phase 1: a tile in shared memory

// grid (tiles, frames); vec16: every tile row starts on a 16-byte boundary
__global__ void __launch_bounds__(THREADS)
    cc_local(const uint8_t* __restrict__ fg_all, int* __restrict__ lab_all, uint8_t* dirty_all, int h,
             int w, int tiles_x, int tiles, bool vec16) {
  __shared__ __align__(16) uint8_t s_fg[TILE_ROWS][TILE_COLS];
  __shared__ int s_lab[TILE_ROWS * TILE_COLS];
  const Frame f = frame_at(fg_all, lab_all, dirty_all, h, w, tiles_x, tiles, blockIdx.y);
  const int tile = blockIdx.x;
  const int y0 = tile / tiles_x * TILE_ROWS;
  const int x0 = tile % tiles_x * TILE_COLS;
  const int rows = min(TILE_ROWS, h - y0);
  const int cols = min(TILE_COLS, w - x0);

  if (vec16 && cols == TILE_COLS) {
    constexpr int PER_ROW = TILE_COLS / 16;
    for (int i = threadIdx.x; i < TILE_ROWS * PER_ROW; i += THREADS) {
      const int r = i / PER_ROW;
      const int c = (i - r * PER_ROW) * 16;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (r < rows) v = __ldg(reinterpret_cast<const uint4*>(f.fg + static_cast<long long>(y0 + r) * w + x0 + c));
      *reinterpret_cast<uint4*>(&s_fg[r][c]) = v;
    }
  } else {
    for (int i = threadIdx.x; i < TILE_ROWS * TILE_COLS; i += THREADS) {
      const int r = i / TILE_COLS;
      const int c = i - r * TILE_COLS;
      s_fg[r][c] = (r < rows && c < cols) ? __ldg(f.fg + static_cast<long long>(y0 + r) * w + x0 + c) : 0;
    }
  }
  if (threadIdx.x == 0) f.dirty[tile] = 0;
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // each pixel points at the start of its run in the row: the highest
  // background bit below it, else the run carried in from the segment before
  for (int r = warp; r < TILE_ROWS; r += WARPS) {
    int carry = 0;
#pragma unroll
    for (int k = 0; k < SEGMENTS; ++k) {
      const int c = 32 * k + lane;
      const bool on = s_fg[r][c] != 0;
      const unsigned bg = ~__ballot_sync(0xffffffffu, on);
      const unsigned bg_below = bg & ((1u << lane) - 1u);
      const int start = bg_below ? 32 * k + 32 - __clz(bg_below) : carry;
      s_lab[r * TILE_COLS + c] = on ? r * TILE_COLS + start : -1;
      if (bg) carry = 32 * k + 32 - __clz(bg);
    }
  }
  __syncthreads();

  // the row above, only where a contact starts: its piece's first pixel in
  // [s-1, e+1] of this pixel's run [s, e]
  for (int r = warp + (warp == 0 ? WARPS : 0); r < TILE_ROWS; r += WARPS) {
#pragma unroll
    for (int k = 0; k < SEGMENTS; ++k) {
      const int c = 32 * k + lane;
      if (!s_fg[r][c]) continue;
      const bool left = c > 0 && s_fg[r][c - 1];
      const bool right = c + 1 < TILE_COLS && s_fg[r][c + 1];
      const bool up_left = c > 0 && s_fg[r - 1][c - 1];
      const bool up = s_fg[r - 1][c];
      const bool up_right = c + 1 < TILE_COLS && s_fg[r - 1][c + 1];
      const int p = r * TILE_COLS + c;
      if (!left && up_left) unite_shared(s_lab, p, p - TILE_COLS - 1);
      if (up && !up_left) unite_shared(s_lab, p, p - TILE_COLS);
      if (!right && up_right && !up) unite_shared(s_lab, p, p - TILE_COLS + 1);
    }
  }
  __syncthreads();

  // every run's start takes its root, one find a run; a union links roots,
  // which are run starts, so every pixel now points at a run start or a
  // root, two steps from its root
  for (int r = warp; r < TILE_ROWS; r += WARPS) {
#pragma unroll
    for (int k = 0; k < SEGMENTS; ++k) {
      const int c = 32 * k + lane;
      if (s_fg[r][c] && (c == 0 || !s_fg[r][c - 1]))
        s_lab[r * TILE_COLS + c] = root_shared(s_lab, r * TILE_COLS + c);
    }
  }
  __syncthreads();

  for (int r = warp; r < rows; r += WARPS) {
#pragma unroll
    for (int k = 0; k < SEGMENTS; ++k) {
      const int c = 32 * k + lane;
      if (c >= cols) continue;
      const int parent = s_lab[r * TILE_COLS + c];
      int out = SENTINEL;
      if (parent >= 0) {
        const int root = s_lab[parent];
        out = (y0 + root / TILE_COLS) * w + x0 + root % TILE_COLS;
      }
      f.lab[(y0 + r) * w + x0 + c] = out;
    }
  }
}

// ---------------------------------------------------------------------------
// phase 2: the tiles' borders

// grid (blocks, frames); threads [0, n_rows) take the tiles' first rows
// (y = TILE_ROWS, 2 * TILE_ROWS, ...; x = 0..w-1), the rest their first
// columns (x = TILE_COLS, ...; y = 0..h-1)
__global__ void __launch_bounds__(THREADS)
    cc_border(const uint8_t* __restrict__ fg_all, int* lab_all, uint8_t* dirty_all, int h, int w,
              int tiles_x, int tiles, int n_rows, int n_cols) {
  const int idx = blockIdx.x * THREADS + threadIdx.x;
  if (idx >= n_rows + n_cols) return;
  const Frame f = frame_at(fg_all, lab_all, dirty_all, h, w, tiles_x, tiles, blockIdx.y);
  const uint8_t* m = f.fg;
  if (idx < n_rows) {
    const int band = idx / w;
    const int x = idx - band * w;
    const int y = (band + 1) * TILE_ROWS;
    const int p = y * w + x;
    if (!m[p]) return;
    // this pixel's piece: its run inside the tile's columns
    const bool left = x % TILE_COLS != 0 && m[p - 1];
    const bool right = (x + 1) % TILE_COLS != 0 && x + 1 < w && m[p + 1];
    const bool up_left = x > 0 && m[p - w - 1];
    const bool up = m[p - w];
    const bool up_right = x + 1 < w && m[p - w + 1];
    if (!left && up_left) f.unite(p, p - w - 1);
    if (up && !(up_left && x % TILE_COLS != 0)) f.unite(p, p - w);
    if (!right && up_right && !(up && (x + 1) % TILE_COLS != 0)) f.unite(p, p - w + 1);
  } else {
    const int j = idx - n_rows;
    const int band = j / h;
    const int y = j - band * h;
    const int x = (band + 1) * TILE_COLS;
    const int p = y * w + x;
    if (!m[p]) return;
    const bool up = y % TILE_ROWS != 0 && m[p - w];
    const bool down = (y + 1) % TILE_ROWS != 0 && y + 1 < h && m[p + w];
    const bool left_up = y > 0 && m[p - w - 1];
    const bool left = m[p - 1];
    const bool left_down = y + 1 < h && m[p + w - 1];
    if (!up && left_up) f.unite(p, p - w - 1);
    if (left && !(left_up && y % TILE_ROWS != 0)) f.unite(p, p - 1);
    if (!down && left_down && !(left && (y + 1) % TILE_ROWS != 0)) f.unite(p, p + w - 1);
  }
}

// ---------------------------------------------------------------------------
// phase 3: every pixel of a dirty tile to its root

__global__ void __launch_bounds__(THREADS)
    cc_compress(int* lab_all, const uint8_t* __restrict__ dirty_all, int h, int w, int tiles_x, int tiles) {
  __shared__ int s_lab[TILE_ROWS * TILE_COLS];
  const long long hw = static_cast<long long>(h) * w;
  const int tile = blockIdx.x;
  if (!dirty_all[blockIdx.y * static_cast<long long>(tiles) + tile]) return;
  int* lab = lab_all + blockIdx.y * hw;
  const int y0 = tile / tiles_x * TILE_ROWS;
  const int x0 = tile % tiles_x * TILE_COLS;
  const int rows = min(TILE_ROWS, h - y0);
  const int cols = min(TILE_COLS, w - x0);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // the local index of a global one inside this tile, else -1
  auto local = [&](int v) {
    const int vy = v / w - y0;
    const int vx = v % w - x0;
    return (vy >= 0 && vy < TILE_ROWS && vx >= 0 && vx < TILE_COLS) ? vy * TILE_COLS + vx : -1;
  };

  int before[PER_THREAD];
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) {
    const int r = warp + WARPS * (j / SEGMENTS);
    const int c = 32 * (j % SEGMENTS) + lane;
    before[j] = (r < rows && c < cols) ? __ldcg(lab + (y0 + r) * w + x0 + c) : SENTINEL;
    s_lab[r * TILE_COLS + c] = before[j];
  }
  __syncthreads();
  // the local roots that phase 2 linked out of the tile: their global root
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) {
    if (before[j] != SENTINEL && local(before[j]) < 0) {
      const int r = warp + WARPS * (j / SEGMENTS);
      const int c = 32 * (j % SEGMENTS) + lane;
      s_lab[r * TILE_COLS + c] = find_global(lab, before[j]);
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) {
    if (before[j] == SENTINEL) continue;
    const int r = warp + WARPS * (j / SEGMENTS);
    const int c = 32 * (j % SEGMENTS) + lane;
    int q = s_lab[r * TILE_COLS + c];
    for (int i = local(q); i >= 0; i = local(q)) {
      const int next = s_lab[i];
      if (next == q) break;
      q = next;
    }
    if (q != before[j]) lab[(y0 + r) * w + x0 + c] = q;
  }
}

}  // namespace

// fg: (n, h, w) uint8, != 0 is foreground; lab: (n, h, w) int32 out;
// dirty: n * ceil(h / tile_rows) * ceil(w / tile_cols) bytes of scratch.
// h * w must be below SENTINEL; tile_rows and tile_cols must be this
// source's TILE_ROWS and TILE_COLS.  More than 65535 frames go in slices.
extern "C" int yam_cc_min_index(const void* fg, void* lab, void* dirty, int n, int h, int w, int tile_rows,
                                int tile_cols, void* stream) {
  if (tile_rows != TILE_ROWS || tile_cols != TILE_COLS || h <= 0 || w <= 0 ||
      static_cast<long long>(h) * w >= SENTINEL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles_x = (w + TILE_COLS - 1) / TILE_COLS;
  const int tiles = (h + TILE_ROWS - 1) / TILE_ROWS * tiles_x;
  const int n_rows = (h - 1) / TILE_ROWS * w;
  const int n_cols = (w - 1) / TILE_COLS * h;
  const long long hw = static_cast<long long>(h) * w;
  const bool vec16 = reinterpret_cast<uintptr_t>(fg) % 16 == 0 && w % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int first = 0; first < n; first += MAX_FRAMES) {
    const int frames = n - first < MAX_FRAMES ? n - first : MAX_FRAMES;
    const auto* f = static_cast<const uint8_t*>(fg) + first * hw;
    auto* l = static_cast<int*>(lab) + first * hw;
    auto* d = static_cast<uint8_t*>(dirty) + static_cast<long long>(first) * tiles;
    cc_local<<<dim3(tiles, frames), THREADS, 0, s>>>(f, l, d, h, w, tiles_x, tiles, vec16);
    if (n_rows + n_cols > 0)
      cc_border<<<dim3((n_rows + n_cols + THREADS - 1) / THREADS, frames), THREADS, 0, s>>>(
          f, l, d, h, w, tiles_x, tiles, n_rows, n_cols);
    cc_compress<<<dim3(tiles, frames), THREADS, 0, s>>>(l, d, h, w, tiles_x, tiles);
  }
  return static_cast<int>(cudaGetLastError());
}
