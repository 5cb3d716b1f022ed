// Region growing from a seed on uint8 gray frames: the seed's component of
// the graph whose 4-connected neighbours p, q are joined where
// |v_p - v_q| <= tol, painted 255 over the gray frame.
//
// Replaces yamimageprocessor_tpu/ops/growing.py:region_growing_j_dyn (:50),
// an XLA while_loop that grows the mask one pixel ring a sweep (not a
// pallas_call): a path of L pixels takes L sweeps of the whole frame.  The
// predicate is symmetric, so the region is a connected component, unique
// whatever the schedule; this kernel takes all the frame's components at
// once with labeling.cu's design (a tile's union-find in shared memory,
// global unions only across tile borders, then the relinked tiles
// compressed), under the pair predicate instead of a mask, and then paints
// the seed's.  Four launches on the stream, each grid (tiles, frames), a
// tile TILE_ROWS x TILE_COLS pixels of one frame:
//
//   grow_local     the tile's values into shared memory; each pixel unites
//                  with its left and upper neighbour inside the tile where
//                  they join (atomicMin on local indices, path halving);
//                  then each pixel's local root, written once as a global
//                  flat index.  A tile's local raster order is the frame's
//                  restricted to the tile, so a local root is the minimum
//                  index of its piece.  The tile's dirty flag is cleared.
//   grow_border    a thread a pixel on a tile's first row (its upper
//                  neighbour) or first column (its left one): a global union
//                  where they join; a relinked root marks its tile dirty.
//   grow_compress  a dirty tile's labels to their global roots, in shared
//                  memory (clean tiles return at once).
//   grow_paint     out = lab == lab[seed] ? 255 : gray, the seed clipped
//                  into the frame.
//
// Links only ever point to a smaller index, so a root is the minimum index
// of its tree and every label ends as its component's minimum index (the
// plain version's fixed point).  tol and the seed are int32 scalars on the
// card.
//
// Bound on the card: device memory.  The function reads 1 B and writes 1 B
// a pixel; the labels (4 B a pixel) are scratch in between.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int TILE_ROWS = 32;
constexpr int TILE_COLS = 64;
constexpr int THREADS = 256;
constexpr int TILE_PIXELS = TILE_ROWS * TILE_COLS;
constexpr int MAX_FRAMES = 65535;  // gridDim.y

__device__ __forceinline__ bool joins(int a, int b, int tol) {
  // |a - b| in int32 (uint8 values: no wrap)
  const int d = a - b;
  return (d < 0 ? -d : d) <= tol;
}

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

__device__ __forceinline__ int find_global(const int* lab, int x) {
  int parent = __ldcg(lab + x);
  while (parent != x) {
    x = parent;
    parent = __ldcg(lab + x);
  }
  return x;
}

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

__global__ void __launch_bounds__(THREADS)
    grow_local(const uint8_t* __restrict__ gray_all, int* __restrict__ lab_all, uint8_t* dirty_all,
               const int* __restrict__ scalars, int h, int w, int tiles_x, int tiles) {
  __shared__ uint8_t s_v[TILE_PIXELS];
  __shared__ int s_lab[TILE_PIXELS];
  const long long hw = static_cast<long long>(h) * w;
  const uint8_t* gray = gray_all + blockIdx.y * hw;
  int* lab = lab_all + blockIdx.y * hw;
  const int tile = blockIdx.x;
  const int y0 = tile / tiles_x * TILE_ROWS;
  const int x0 = tile % tiles_x * TILE_COLS;
  const int rows = min(TILE_ROWS, h - y0);
  const int cols = min(TILE_COLS, w - x0);
  const int tol = __ldg(scalars + 2);
  for (int i = threadIdx.x; i < TILE_PIXELS; i += THREADS) {
    const int r = i / TILE_COLS, c = i - r * TILE_COLS;
    s_v[i] = (r < rows && c < cols) ? __ldg(gray + static_cast<long long>(y0 + r) * w + x0 + c) : 0;
    s_lab[i] = i;
  }
  if (threadIdx.x == 0) dirty_all[blockIdx.y * static_cast<long long>(tiles) + tile] = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < TILE_PIXELS; i += THREADS) {
    const int r = i / TILE_COLS, c = i - r * TILE_COLS;
    if (r >= rows || c >= cols) continue;
    if (c > 0 && joins(s_v[i], s_v[i - 1], tol)) unite_shared(s_lab, i, i - 1);
    if (r > 0 && joins(s_v[i], s_v[i - TILE_COLS], tol)) unite_shared(s_lab, i, i - TILE_COLS);
  }
  __syncthreads();
  int roots[TILE_PIXELS / THREADS];
#pragma unroll
  for (int j = 0; j < TILE_PIXELS / THREADS; ++j) roots[j] = root_shared(s_lab, threadIdx.x + j * THREADS);
#pragma unroll
  for (int j = 0; j < TILE_PIXELS / THREADS; ++j) {
    const int i = threadIdx.x + j * THREADS;
    const int r = i / TILE_COLS, c = i - r * TILE_COLS;
    if (r >= rows || c >= cols) continue;
    const int root = roots[j];
    lab[(y0 + r) * w + x0 + c] = (y0 + root / TILE_COLS) * w + x0 + root % TILE_COLS;
  }
}

// grid (blocks, frames); threads [0, n_rows) take the tiles' first rows
// (y = TILE_ROWS, 2 * TILE_ROWS, ...), the rest their first columns
__global__ void __launch_bounds__(THREADS)
    grow_border(const uint8_t* __restrict__ gray_all, int* lab_all, uint8_t* dirty_all,
                const int* __restrict__ scalars, int h, int w, int tiles_x, int tiles, int n_rows, int n_cols) {
  const int idx = blockIdx.x * THREADS + threadIdx.x;
  if (idx >= n_rows + n_cols) return;
  const long long hw = static_cast<long long>(h) * w;
  const uint8_t* gray = gray_all + blockIdx.y * hw;
  int* lab = lab_all + blockIdx.y * hw;
  uint8_t* dirty = dirty_all + blockIdx.y * static_cast<long long>(tiles);
  const int tol = __ldg(scalars + 2);
  int p, q;
  if (idx < n_rows) {
    const int band = idx / w;
    const int x = idx - band * w;
    p = (band + 1) * TILE_ROWS * w + x;
    q = p - w;
  } else {
    const int j = idx - n_rows;
    const int band = j / h;
    const int y = j - band * h;
    p = y * w + (band + 1) * TILE_COLS;
    q = p - 1;
  }
  if (!joins(gray[p], gray[q], tol)) return;
  int a = p, b = q;
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
    if (old > a) {
      const int by = b / w;
      dirty[(by / TILE_ROWS) * tiles_x + (b - by * w) / TILE_COLS] = 1;
    }
    if (old == b) return;
    b = old;
  }
}

__global__ void __launch_bounds__(THREADS)
    grow_compress(int* lab_all, const uint8_t* __restrict__ dirty_all, int h, int w, int tiles_x, int tiles) {
  constexpr int PER_THREAD = TILE_PIXELS / THREADS;
  __shared__ int s_lab[TILE_PIXELS];
  const long long hw = static_cast<long long>(h) * w;
  const int tile = blockIdx.x;
  if (!dirty_all[blockIdx.y * static_cast<long long>(tiles) + tile]) return;
  int* lab = lab_all + blockIdx.y * hw;
  const int y0 = tile / tiles_x * TILE_ROWS;
  const int x0 = tile % tiles_x * TILE_COLS;
  const int rows = min(TILE_ROWS, h - y0);
  const int cols = min(TILE_COLS, w - x0);
  auto local = [&](int v) {
    const int vy = v / w - y0;
    const int vx = v % w - x0;
    return (vy >= 0 && vy < TILE_ROWS && vx >= 0 && vx < TILE_COLS) ? vy * TILE_COLS + vx : -1;
  };
  int before[PER_THREAD];
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) {
    const int i = threadIdx.x + j * THREADS;
    const int r = i / TILE_COLS, c = i - r * TILE_COLS;
    before[j] = (r < rows && c < cols) ? __ldcg(lab + (y0 + r) * w + x0 + c) : -1;
    s_lab[i] = before[j];
  }
  __syncthreads();
  // the local roots that the border unions linked out of the tile
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) {
    if (before[j] >= 0 && local(before[j]) < 0) s_lab[threadIdx.x + j * THREADS] = find_global(lab, before[j]);
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) {
    if (before[j] < 0) continue;
    const int i = threadIdx.x + j * THREADS;
    const int r = i / TILE_COLS, c = i - r * TILE_COLS;
    int q = s_lab[i];
    for (int l = local(q); l >= 0; l = local(q)) {
      const int next = s_lab[l];
      if (next == q) break;
      q = next;
    }
    if (q != before[j]) lab[(y0 + r) * w + x0 + c] = q;
  }
}

// a thread 4 pixels
__global__ void __launch_bounds__(THREADS)
    grow_paint(const uint8_t* __restrict__ gray_all, uint8_t* __restrict__ out_all, const int* __restrict__ lab_all,
               const int* __restrict__ scalars, int h, int w) {
  const long long hw = static_cast<long long>(h) * w;
  const uint8_t* gray = gray_all + blockIdx.y * hw;
  uint8_t* out = out_all + blockIdx.y * hw;
  const int* lab = lab_all + blockIdx.y * hw;
  const int sx = min(max(__ldg(scalars), 0), w - 1);
  const int sy = min(max(__ldg(scalars + 1), 0), h - 1);
  const int seed_root = __ldg(lab + static_cast<long long>(sy) * w + sx);
  const long long first = (static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x) * 4;
  for (long long p = first; p < first + 4 && p < hw; ++p) out[p] = __ldg(lab + p) == seed_root ? 255 : gray[p];
}

}  // namespace

// gray, out: (n, h, w) uint8; lab: (n, h, w) int32 scratch; dirty: n *
// ceil(h / tile_rows) * ceil(w / tile_cols) bytes of scratch; scalars: int32
// (seed_x, seed_y, tol) on the card.  h * w must be below 2^30; tile_rows
// and tile_cols must be this source's TILE_ROWS and TILE_COLS.  More than
// 65535 frames go in slices.
extern "C" int yam_region_grow_u8(const void* gray, void* out, void* lab, void* dirty, const void* scalars, int n,
                                  int h, int w, int tile_rows, int tile_cols, void* stream) {
  if (tile_rows != TILE_ROWS || tile_cols != TILE_COLS || h <= 0 || w <= 0 ||
      static_cast<long long>(h) * w >= (1LL << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles_x = (w + TILE_COLS - 1) / TILE_COLS;
  const int tiles = (h + TILE_ROWS - 1) / TILE_ROWS * tiles_x;
  const int n_rows = (h - 1) / TILE_ROWS * w;
  const int n_cols = (w - 1) / TILE_COLS * h;
  const long long hw = static_cast<long long>(h) * w;
  const int paint_blocks = static_cast<int>((hw + 4LL * THREADS - 1) / (4LL * THREADS));
  const int* sc = static_cast<const int*>(scalars);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int first = 0; first < n; first += MAX_FRAMES) {
    const int frames = n - first < MAX_FRAMES ? n - first : MAX_FRAMES;
    const auto* g = static_cast<const uint8_t*>(gray) + first * hw;
    auto* o = static_cast<uint8_t*>(out) + first * hw;
    auto* l = static_cast<int*>(lab) + first * hw;
    auto* d = static_cast<uint8_t*>(dirty) + static_cast<long long>(first) * tiles;
    grow_local<<<dim3(tiles, frames), THREADS, 0, s>>>(g, l, d, sc, h, w, tiles_x, tiles);
    if (n_rows + n_cols > 0)
      grow_border<<<dim3((n_rows + n_cols + THREADS - 1) / THREADS, frames), THREADS, 0, s>>>(
          g, l, d, sc, h, w, tiles_x, tiles, n_rows, n_cols);
    grow_compress<<<dim3(tiles, frames), THREADS, 0, s>>>(l, d, h, w, tiles_x, tiles);
    grow_paint<<<dim3(paint_blocks, frames), THREADS, 0, s>>>(g, o, l, sc, h, w);
  }
  return static_cast<int>(cudaGetLastError());
}
