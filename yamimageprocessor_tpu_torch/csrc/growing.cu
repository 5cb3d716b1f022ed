// Region growing from a seed on uint8 gray frames: the seed's component of
// the graph whose 4-connected neighbours p, q are joined where
// |v_p - v_q| <= tol, painted 255 over the gray frame.
//
// Replaces yamimageprocessor_tpu/ops/growing.py:region_growing_j_dyn (:50),
// an XLA while_loop that grows the mask one pixel ring a sweep (not a
// pallas_call): a path of L pixels takes L sweeps of the whole frame.  The
// predicate is symmetric, so the region is a connected component, unique
// whatever the schedule.  This kernel finds every component of a tile in
// shared memory and joins tiles through a union-find whose nodes are only
// the tile pieces that touch a tile's perimeter, then paints the seed's.
//
// Bound on the card: device memory.  The function reads 1 B and writes 1 B
// a pixel.  No label a pixel goes to device memory: a tile's labels stay in
// shared memory, and the global nodes are one int32 a perimeter slot
// (PERIMETER = 188 of a tile's 2048 pixels).  Three launches on the stream;
// a tile is TILE_ROWS x TILE_COLS pixels of one frame (ragged right and
// bottom tiles masked), a thread the 16 bytes of a quarter tile row:
//
//   grow_local     a block a tile, 16 blocks an SM: each thread's 16 bytes
//                  come in (one 16-byte load where rows allow) and go out
//                  again unchanged as the output's gray copy.  A warp
//                  labels 8 rows; a row's joins to the left and up are bit
//                  masks, one __ballot_sync a 32-pixel segment, and each
//                  pixel points at the start of its run through __clz,
//                  with no atomics.  A vertical pair is united (shared-
//                  memory union-find, atomicMin on local indices; a lane
//                  loops over its own contacts only) only where a contact
//                  starts: the pair at column c between rows r-1 and r is
//                  redundant where the pair at c-1 joins and both
//                  horizontal pairs (c-1, c), in row r and in row r-1,
//                  join, since c is then joined through c-1 (bit
//                  operations on the masks).  Links point to smaller
//                  indices, so a local root is the least local index of
//                  its piece.  Only the perimeter slots (top row, bottom
//                  row, first and last column) and the seed chase their
//                  roots; each slot marks its root with its index
//                  (atomicMax, the least slot wins) and writes its global
//                  node: the least perimeter slot of its piece, which is
//                  that piece's node (it points at itself).  The seed's
//                  tile writes the seed's node, or -1 where its piece
//                  touches no perimeter.
//   grow_border    a thread a pair across a tile seam (a tile's first row
//                  with the row above; its first column with the column to
//                  the left): where the pair joins and a contact starts
//                  there (the same rule along the seam, for rows and for
//                  columns), a global union of the two slots' nodes (find
//                  with path halving, atomicMin to the smaller index).  An
//                  all-equal frame makes one union a tile boundary.
//   grow_paint     a block a tile.  Every thread finds the seed's global
//                  root; each perimeter slot finds its own, stores it over
//                  its node (a root, never an older ancestor) and is a hit
//                  where the two are equal.  A tile with no hit, and not
//                  the seed's tile with an interior seed piece, is done:
//                  its output is the gray copy already.  Any other tile
//                  is labelled again from the gray tile (every pixel
//                  chasing its root), flags the hit pieces' roots and
//                  writes 255 over the flagged pixels only (a 16-byte
//                  store where all 16 are).  Labelling again costs the
//                  painted tiles the local pass's arithmetic a second
//                  time; a byte a pixel written by the local pass and read
//                  back here was the slower on the denoise batch (PERF.md,
//                  section 6).
//
// tol and the seed are int32 scalars on the card.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int TILE_ROWS = 32;
constexpr int TILE_COLS = 64;
constexpr int THREADS = 128;  // a tile's block: 16 of them an SM keep 16 tiles' loads and arithmetic in flight
constexpr int WARPS = THREADS / 32;
constexpr int BAND = TILE_ROWS / WARPS;   // rows a warp labels
constexpr int SEGMENTS = TILE_COLS / 32;  // 32-pixel segments a tile row
constexpr int TILE_PIXELS = TILE_ROWS * TILE_COLS;
constexpr int PER_THREAD = TILE_PIXELS / THREADS;  // 16: a quarter row
constexpr int CHUNKS = TILE_COLS / PER_THREAD;     // threads a tile row
constexpr int PERIMETER = 2 * TILE_COLS + 2 * (TILE_ROWS - 2);
constexpr int SLOTS = (PERIMETER + THREADS - 1) / THREADS;  // perimeter slots a thread
constexpr int ROOT_BITS = 11;  // a local index; a root's entry keeps PERIMETER less its piece's least slot above them
constexpr int ROOT_MASK = (1 << ROOT_BITS) - 1;
constexpr int BORDER_THREADS = 256;
constexpr int MAX_FRAMES = 65535;  // gridDim.y

static_assert(TILE_COLS % 32 == 0 && TILE_ROWS % WARPS == 0 && BAND * SEGMENTS <= 32, "a warp labels whole rows");
static_assert(TILE_COLS % PER_THREAD == 0 && PER_THREAD == 16, "a thread 16 bytes of a tile row");
static_assert(TILE_PIXELS == 1 << ROOT_BITS, "a local index fits ROOT_BITS");

__device__ __forceinline__ bool joins(int a, int b, int tol) {
  // |a - b| in int32 (uint8 values: no wrap)
  const int d = a - b;
  return (d < 0 ? -d : d) <= tol;
}

// the perimeter slot of tile position (r, c), -1 inside: the top row, the
// bottom row, then the first and the last column between them
__device__ __forceinline__ int slot_of(int r, int c) {
  if (r == 0) return c;
  if (r == TILE_ROWS - 1) return TILE_COLS + c;
  if (c == 0) return 2 * TILE_COLS + r - 1;
  if (c == TILE_COLS - 1) return 2 * TILE_COLS + TILE_ROWS - 2 + r - 1;
  return -1;
}

__device__ __forceinline__ int slot_index(int s) {
  if (s < TILE_COLS) return s;
  if (s < 2 * TILE_COLS) return (TILE_ROWS - 1) * TILE_COLS + s - TILE_COLS;
  s -= 2 * TILE_COLS;
  const int r = s % (TILE_ROWS - 2) + 1;
  return r * TILE_COLS + (s < TILE_ROWS - 2 ? 0 : TILE_COLS - 1);
}

// Path halving on the way (each node visited is pointed at its
// grandparent): a concurrent union's atomicMin that such a store
// overwrites returned the old parent, and that union goes on from there.
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

// read-only: for the last finds, which run concurrently with the stores of
// roots and the atomicMax of a slot above a root's ROOT_BITS
__device__ __forceinline__ int root_shared(const volatile int* s, int x) {
  int parent = s[x] & ROOT_MASK;
  while (parent != x) {
    x = parent;
    parent = s[x] & ROOT_MASK;
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

__device__ __forceinline__ int find_global_halving(int* node, int x) {
  int cur = __ldcg(node + x);
  if (cur != x) {
    int prev = x, next;
    while (cur > (next = __ldcg(node + cur))) {
      node[prev] = next;
      prev = cur;
      cur = next;
    }
  }
  return cur;
}

// read-only: the paint pass's finds, after every union
__device__ __forceinline__ int find_global(const int* node, int x) {
  int parent = __ldcg(node + x);
  while (parent != x) {
    x = parent;
    parent = __ldcg(node + x);
  }
  return x;
}

struct Tile {
  int index, y0, x0, rows, cols;
};

__device__ __forceinline__ Tile tile_at(int index, int h, int w, int tiles_x) {
  Tile t;
  t.index = index;
  t.y0 = index / tiles_x * TILE_ROWS;
  t.x0 = index % tiles_x * TILE_COLS;
  t.rows = min(TILE_ROWS, h - t.y0);
  t.cols = min(TILE_COLS, w - t.x0);
  return t;
}

// This thread's 16 bytes of a tile (row, col: the quarter row it takes),
// zeros outside the frame: one 16-byte load where rows allow (vec16: w a
// multiple of 16, so a chunk lies wholly inside or outside a ragged tile).
__device__ __forceinline__ uint4 fetch16(const uint8_t* __restrict__ gray, int w, const Tile& t, int row, int col,
                                         bool vec16) {
  if (row >= t.rows || col >= t.cols) return make_uint4(0, 0, 0, 0);
  const uint8_t* src = gray + static_cast<long long>(t.y0 + row) * w + t.x0 + col;
  if (vec16) return __ldg(reinterpret_cast<const uint4*>(src));
  unsigned words[4] = {0, 0, 0, 0};
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j)
    if (col + j < t.cols) words[j / 4] |= static_cast<unsigned>(__ldg(src + j)) << (8 * (j % 4));
  return make_uint4(words[0], words[1], words[2], words[3]);
}

// the same 16 bytes of out, from a fetch16
__device__ __forceinline__ void put16(uint8_t* __restrict__ out, int w, const Tile& t, int row, int col, bool vec16,
                                      const uint4& q) {
  if (row >= t.rows || col >= t.cols) return;
  uint8_t* dst = out + static_cast<long long>(t.y0 + row) * w + t.x0 + col;
  if (vec16) {
    *reinterpret_cast<uint4*>(dst) = q;
    return;
  }
  const unsigned words[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j)
    if (col + j < t.cols) dst[j] = static_cast<uint8_t>(words[j / 4] >> (8 * (j % 4)));
}

// The tile's pieces in s_lab from its values in s_v (staged before a
// barrier): each pixel's entry leads to the least local index of its piece
// (invalid positions: themselves), a root's entry is itself; with ROOTS
// every pixel's entry is its root.  A warp takes a band of BAND consecutive
// rows; a row's 32-pixel segment is a lane a pixel, and its joins are bit
// masks (a ballot each).  Ends with a barrier.
template <bool ROOTS>
__device__ void label_tile(const Tile& t, int tol, const uint8_t (*s_v)[TILE_COLS], int* s_lab) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const unsigned upto = 0xffffffffu >> (31 - lane);  // bits 0..lane
  // Each pixel points at the start of its run: the last pixel at or before
  // it that does not join its left neighbour (J: the joins-left bits), else
  // the start carried in from the segment before.  A pixel unites with the
  // one above (V: the joins-up bits) only where a contact starts: not where
  // the pair to its left joins too and both rows join across (c - 1, c).
  unsigned unite_mine = 0;  // this lane's bit of each (row, segment)
  unsigned above[SEGMENTS];  // J of the row above
  int prev[SEGMENTS];  // the row above's values
#pragma unroll
  for (int k = 0; k < SEGMENTS; ++k) {
    const int r = warp * BAND, c = 32 * k + lane;
    prev[k] = r > 0 ? s_v[r - 1][c] : 0;
    above[k] = __ballot_sync(0xffffffffu, r > 0 && r - 1 < t.rows && c > 0 && c < t.cols &&
                                              joins(prev[k], s_v[r - 1][c - 1], tol));
  }
  for (int i = 0; i < BAND; ++i) {
    const int r = warp * BAND + i;
    int carry = 0;
    unsigned v_before = 0;  // V of the segment before
#pragma unroll
    for (int k = 0; k < SEGMENTS; ++k) {
      const int c = 32 * k + lane;
      const bool valid = r < t.rows && c < t.cols;
      const int v = s_v[r][c];
      const unsigned joined = __ballot_sync(0xffffffffu, valid && c > 0 && joins(v, s_v[r][c - 1], tol));
      const unsigned starts = ~joined;
      const unsigned mine = starts & upto;
      s_lab[r * TILE_COLS + c] = r * TILE_COLS + (mine ? 32 * k + 31 - __clz(mine) : carry);
      if (starts) carry = 32 * k + 31 - __clz(starts);
      const unsigned vert = __ballot_sync(0xffffffffu, r > 0 && valid && joins(v, prev[k], tol));
      const unsigned contact = vert & ~((vert << 1 | v_before >> 31) & joined & above[k]);
      unite_mine |= (contact >> lane & 1u) << (i * SEGMENTS + k);
      above[k] = joined;
      prev[k] = v;
      v_before = vert;
    }
  }
  __syncthreads();
  while (unite_mine) {  // a warp loops as often as its busiest lane has contacts
    const int j = __ffs(unite_mine) - 1;
    unite_mine &= unite_mine - 1;
    const int p = (warp * BAND + j / SEGMENTS) * TILE_COLS + 32 * (j % SEGMENTS) + lane;
    unite_shared(s_lab, p, p - TILE_COLS);
  }
  __syncthreads();
  if constexpr (ROOTS) {
    // Every pixel takes its root, chased from the run start or root its
    // entry holds (a union links roots, which are run starts; halving
    // stores ancestors), and stores it.  The stores race with other
    // pixels' chases but store roots only; a pixel's entry that is no run
    // start is read by no other thread.
#pragma unroll
    for (int j = 0; j < BAND * SEGMENTS; ++j) {
      const int p = (warp * BAND + j / SEGMENTS) * TILE_COLS + 32 * (j % SEGMENTS) + lane;
      s_lab[p] = root_shared(s_lab, s_lab[p]);
    }
    __syncthreads();
  }
}

struct Seed {
  int x, y, tile;
};

__device__ __forceinline__ Seed seed_at(const int* __restrict__ scalars, int h, int w, int tiles_x) {
  Seed s;
  s.x = min(max(__ldg(scalars), 0), w - 1);
  s.y = min(max(__ldg(scalars + 1), 0), h - 1);
  s.tile = s.y / TILE_ROWS * tiles_x + s.x / TILE_COLS;
  return s;
}

// grid (tiles, frames); out: the gray frames copied; node: frames x tiles x
// PERIMETER; seed_node: one a frame.  16 blocks an SM (32 registers a
// thread): the tile's phases are chains of shared-memory latency, which
// other tiles' warps cover.
__global__ void __launch_bounds__(THREADS, 16)
    grow_local(const uint8_t* __restrict__ gray_all, uint8_t* __restrict__ out_all, int* __restrict__ node_all,
               int* __restrict__ seed_node, const int* __restrict__ scalars, int h, int w, int tiles_x, int tiles,
               bool vec16) {
  __shared__ __align__(16) uint8_t s_v[TILE_ROWS][TILE_COLS];
  __shared__ __align__(16) int s_lab[TILE_PIXELS];
  const long long hw = static_cast<long long>(h) * w;
  const int frame = blockIdx.y;
  const Tile t = tile_at(blockIdx.x, h, w, tiles_x);
  const int row = threadIdx.x / CHUNKS, col = threadIdx.x % CHUNKS * PER_THREAD;
  const uint4 q = fetch16(gray_all + frame * hw, w, t, row, col, vec16);
  *reinterpret_cast<uint4*>(&s_v[row][col]) = q;
  put16(out_all + frame * hw, w, t, row, col, vec16, q);
  __syncthreads();
  label_tile<false>(t, __ldg(scalars + 2), s_v, s_lab);

  // Each perimeter slot chases its root and leaves PERIMETER - slot above
  // the root's ROOT_BITS (atomicMax: the piece's least slot wins; 0 above
  // them: a piece on no slot).  Then each writes its global node, the
  // node of its piece's least slot.
  int* node = node_all + static_cast<long long>(frame) * tiles * PERIMETER;
  int slot_root[SLOTS];
#pragma unroll
  for (int k = 0; k < SLOTS; ++k) {
    const int s = threadIdx.x + THREADS * k;
    slot_root[k] = -1;
    if (s < PERIMETER) {
      const int i = slot_index(s);
      if (i / TILE_COLS < t.rows && i % TILE_COLS < t.cols) {
        slot_root[k] = root_shared(s_lab, i);
        atomicMax(s_lab + slot_root[k], slot_root[k] | (PERIMETER - s) << ROOT_BITS);
      }
    }
  }
  const Seed seed = seed_at(scalars, h, w, tiles_x);
  const bool seed_here = seed.tile == t.index;
  const int seed_root = seed_here ? root_shared(s_lab, (seed.y - t.y0) * TILE_COLS + seed.x - t.x0) : -1;
  __syncthreads();
#pragma unroll
  for (int k = 0; k < SLOTS; ++k)
    if (slot_root[k] >= 0)
      node[t.index * PERIMETER + threadIdx.x + THREADS * k] =
          (t.index + 1) * PERIMETER - (s_lab[slot_root[k]] >> ROOT_BITS);
  if (seed_here && threadIdx.x == 0) {
    const int least = s_lab[seed_root] >> ROOT_BITS;
    seed_node[frame] = least ? (t.index + 1) * PERIMETER - least : -1;
  }
}

// grid (blocks, frames); threads [0, n_rows) take the pairs across the
// tiles' first rows (y = TILE_ROWS, 2 * TILE_ROWS, ...; x = 0..w-1), the
// rest those across their first columns (x = TILE_COLS, ...; y = 0..h-1)
__global__ void __launch_bounds__(BORDER_THREADS)
    grow_border(const uint8_t* __restrict__ gray_all, int* node_all, const int* __restrict__ scalars, int h, int w,
                int tiles_x, int tiles, int n_rows, int n_cols) {
  const int idx = blockIdx.x * BORDER_THREADS + threadIdx.x;
  if (idx >= n_rows + n_cols) return;
  const long long hw = static_cast<long long>(h) * w;
  const uint8_t* g = gray_all + blockIdx.y * hw;
  int* node = node_all + static_cast<long long>(blockIdx.y) * tiles * PERIMETER;
  const int tol = __ldg(scalars + 2);
  int a, b;
  if (idx < n_rows) {
    const int band = idx / w;
    const int x = idx - band * w;
    const int y = (band + 1) * TILE_ROWS;
    const long long p = static_cast<long long>(y) * w + x;
    const int v = __ldg(g + p), up = __ldg(g + p - w);
    if (!joins(v, up, tol)) return;
    const int c = x % TILE_COLS;
    if (c != 0) {
      const int left = __ldg(g + p - 1), up_left = __ldg(g + p - w - 1);
      if (joins(left, up_left, tol) && joins(v, left, tol) && joins(up, up_left, tol)) return;
    }
    const int tile = y / TILE_ROWS * tiles_x + x / TILE_COLS;
    a = tile * PERIMETER + slot_of(0, c);
    b = (tile - tiles_x) * PERIMETER + slot_of(TILE_ROWS - 1, c);
  } else {
    const int j = idx - n_rows;
    const int band = j / h;
    const int y = j - band * h;
    const int x = (band + 1) * TILE_COLS;
    const long long p = static_cast<long long>(y) * w + x;
    const int v = __ldg(g + p), left = __ldg(g + p - 1);
    if (!joins(v, left, tol)) return;
    const int r = y % TILE_ROWS;
    if (r != 0) {
      const int up = __ldg(g + p - w), up_left = __ldg(g + p - w - 1);
      if (joins(up, up_left, tol) && joins(v, up, tol) && joins(left, up_left, tol)) return;
    }
    const int tile = y / TILE_ROWS * tiles_x + x / TILE_COLS;
    a = tile * PERIMETER + slot_of(r, 0);
    b = (tile - 1) * PERIMETER + slot_of(r, TILE_COLS - 1);
  }
  for (;;) {
    a = find_global_halving(node, a);
    b = find_global_halving(node, b);
    if (a == b) return;
    if (a > b) {
      const int t = a;
      a = b;
      b = t;
    }
    const int old = atomicMin(node + b, a);
    if (old == b) return;
    b = old;
  }
}

// grid (tiles, frames); out holds the gray frames (grow_local's copy)
__global__ void __launch_bounds__(THREADS)
    grow_paint(const uint8_t* __restrict__ gray_all, uint8_t* __restrict__ out_all, int* node_all,
               const int* __restrict__ seed_node, const int* __restrict__ scalars, int h, int w, int tiles_x,
               int tiles, bool vec16) {
  __shared__ __align__(16) uint8_t s_v[TILE_ROWS][TILE_COLS];
  __shared__ __align__(16) int s_lab[TILE_PIXELS];
  __shared__ uint8_t s_flag[TILE_PIXELS];  // by local root
  const long long hw = static_cast<long long>(h) * w;
  const Tile t = tile_at(blockIdx.x, h, w, tiles_x);
  int* node = node_all + static_cast<long long>(blockIdx.y) * tiles * PERIMETER;
  for (int i = threadIdx.x; i < TILE_PIXELS; i += THREADS) s_flag[i] = 0;
  const int sn = __ldg(seed_node + blockIdx.y);
  const int seed_root = sn >= 0 ? find_global(node, sn) : -1;
  bool hit[SLOTS];
  bool any = false;
#pragma unroll
  for (int k = 0; k < SLOTS; ++k) {
    const int s = threadIdx.x + THREADS * k;
    hit[k] = false;
    if (s >= PERIMETER) continue;
    const int i = slot_index(s);
    if (i / TILE_COLS < t.rows && i % TILE_COLS < t.cols) {
      const int self = t.index * PERIMETER + s;
      const int root = find_global(node, self);
      if (root != self) node[self] = root;
      hit[k] = root == seed_root;
      any |= hit[k];
    }
  }
  const Seed seed = seed_at(scalars, h, w, tiles_x);
  const bool seed_alone = sn < 0 && seed.tile == t.index;  // the seed's piece touches no perimeter
  if (!__syncthreads_or(any || seed_alone)) return;  // nothing of the seed's here: out is gray already

  const int row = threadIdx.x / CHUNKS, col = threadIdx.x % CHUNKS * PER_THREAD;
  *reinterpret_cast<uint4*>(&s_v[row][col]) = fetch16(gray_all + blockIdx.y * hw, w, t, row, col, vec16);
  __syncthreads();
  label_tile<true>(t, __ldg(scalars + 2), s_v, s_lab);
#pragma unroll
  for (int k = 0; k < SLOTS; ++k)
    if (hit[k]) s_flag[s_lab[slot_index(threadIdx.x + THREADS * k)]] = 1;
  if (seed_alone && threadIdx.x == 0) s_flag[s_lab[(seed.y - t.y0) * TILE_COLS + seed.x - t.x0]] = 1;
  __syncthreads();

  if (row >= t.rows) return;
  unsigned mask = 0;  // the flagged of this thread's 16 pixels (positions outside the frame never are)
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) mask |= static_cast<unsigned>(s_flag[s_lab[row * TILE_COLS + col + j]]) << j;
  if (!mask) return;
  uint8_t* dst = out_all + blockIdx.y * hw + static_cast<long long>(t.y0 + row) * w + t.x0 + col;
  if (vec16 && mask == 0xffffu) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(0xffffffffu, 0xffffffffu, 0xffffffffu, 0xffffffffu);
  } else {
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j)
      if (mask >> j & 1u) dst[j] = 255;
  }
}

}  // namespace

// gray, out: (n, h, w) uint8; node: n * tiles * perimeter int32 scratch
// (tiles = ceil(h / tile_rows) * ceil(w / tile_cols)); seed_node: n int32
// scratch; scalars: int32 (seed_x, seed_y, tol) on the card.  h * w must
// be below 2^30; tile_rows, tile_cols and perimeter must be this source's.
// More than 65535 frames go in slices.
extern "C" int yam_region_grow_u8(const void* gray, void* out, void* node, void* seed_node, const void* scalars,
                                  int n, int h, int w, int tile_rows, int tile_cols, int perimeter, void* stream) {
  if (tile_rows != TILE_ROWS || tile_cols != TILE_COLS || perimeter != PERIMETER || h <= 0 || w <= 0 ||
      static_cast<long long>(h) * w >= (1LL << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles_x = (w + TILE_COLS - 1) / TILE_COLS;
  const int tiles = (h + TILE_ROWS - 1) / TILE_ROWS * tiles_x;
  const int n_rows = (h - 1) / TILE_ROWS * w;
  const int n_cols = (w - 1) / TILE_COLS * h;
  const long long hw = static_cast<long long>(h) * w;
  const bool vec16 = reinterpret_cast<uintptr_t>(gray) % 16 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                     w % 16 == 0;
  const int* sc = static_cast<const int*>(scalars);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int first = 0; first < n; first += MAX_FRAMES) {
    const int frames = n - first < MAX_FRAMES ? n - first : MAX_FRAMES;
    const auto* g = static_cast<const uint8_t*>(gray) + first * hw;
    auto* o = static_cast<uint8_t*>(out) + first * hw;
    auto* nd = static_cast<int*>(node) + static_cast<long long>(first) * tiles * PERIMETER;
    auto* sn = static_cast<int*>(seed_node) + first;
    grow_local<<<dim3(tiles, frames), THREADS, 0, s>>>(g, o, nd, sn, sc, h, w, tiles_x, tiles, vec16);
    if (n_rows + n_cols > 0)
      grow_border<<<dim3((n_rows + n_cols + BORDER_THREADS - 1) / BORDER_THREADS, frames), BORDER_THREADS, 0, s>>>(
          g, nd, sc, h, w, tiles_x, tiles, n_rows, n_cols);
    grow_paint<<<dim3(tiles, frames), THREADS, 0, s>>>(g, o, nd, sn, sc, h, w, tiles_x, tiles, vec16);
  }
  return static_cast<int>(cudaGetLastError());
}
