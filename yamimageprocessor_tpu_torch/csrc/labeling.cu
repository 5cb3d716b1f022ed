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
// Design: union-find with atomicMin linking (Playne and Hawick), one thread
// a pixel, three launches on the stream:
//   init     lab[p] = p for foreground, SENTINEL for background;
//   merge    each foreground pixel unites with its foreground left, up-left,
//            up and up-right neighbours: find both roots; link the larger
//            root under the smaller with atomicMin, and retry from the
//            value atomicMin returns when another thread got there first;
//   compress lab[p] = root of p.
// Links only ever point to a smaller index (lab[x] <= x), so a root is the
// minimum index of its tree, and after the merge each component is one
// tree.  Reads during the merge bypass L1 (__ldcg): a stale parent is still
// an ancestor, and atomicMin's return value catches every race.
//
// Bound on the card: device memory and atomics.  The function reads 1 B
// and writes 4 B a pixel; the finds re-read lab through L2 (16 MB at
// 2048^2, inside the 50 MB L2).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int SENTINEL = 1 << 30;

__device__ __forceinline__ int find_root(const int* lab, int x) {
  int parent = __ldcg(lab + x);
  while (parent != x) {
    x = parent;
    parent = __ldcg(lab + x);
  }
  return x;
}

__device__ void unite(int* lab, int a, int b) {
  bool done;
  do {
    a = find_root(lab, a);
    b = find_root(lab, b);
    if (a < b) {
      const int old = atomicMin(lab + b, a);
      done = old == b;
      b = old;
    } else if (b < a) {
      const int old = atomicMin(lab + a, b);
      done = old == a;
      a = old;
    } else {
      done = true;
    }
  } while (!done);
}

__global__ void __launch_bounds__(THREADS)
    cc_init(const uint8_t* __restrict__ fg, int* __restrict__ lab, long long total, int hw) {
  const long long idx = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (idx >= total) return;
  lab[idx] = fg[idx] ? static_cast<int>(idx % hw) : SENTINEL;
}

__global__ void __launch_bounds__(THREADS)
    cc_merge(const uint8_t* __restrict__ fg, int* lab, long long total, int h, int w) {
  const long long idx = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (idx >= total || !fg[idx]) return;
  const long long hw = static_cast<long long>(h) * w;
  const long long base = idx / hw * hw;
  const int p = static_cast<int>(idx - base);
  const int y = p / w;
  const int x = p - y * w;
  const uint8_t* f = fg + base;
  int* l = lab + base;
  if (x > 0 && f[p - 1]) unite(l, p, p - 1);
  if (y > 0) {
    if (x > 0 && f[p - w - 1]) unite(l, p, p - w - 1);
    if (f[p - w]) unite(l, p, p - w);
    if (x + 1 < w && f[p - w + 1]) unite(l, p, p - w + 1);
  }
}

__global__ void __launch_bounds__(THREADS)
    cc_compress(const uint8_t* __restrict__ fg, int* lab, long long total, int hw) {
  const long long idx = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (idx >= total || !fg[idx]) return;
  const long long base = idx / hw * hw;
  lab[idx] = find_root(lab + base, static_cast<int>(idx - base));
}

}  // namespace

// fg: (n, h, w) uint8, != 0 is foreground; lab: (n, h, w) int32 out.
// h * w must be below SENTINEL.
extern "C" int yam_cc_min_index(const void* fg, void* lab, int n, int h, int w, void* stream) {
  const long long total = static_cast<long long>(n) * h * w;
  const int hw = h * w;
  const unsigned blocks = static_cast<unsigned>((total + THREADS - 1) / THREADS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* f = static_cast<const uint8_t*>(fg);
  int* l = static_cast<int*>(lab);
  cc_init<<<blocks, THREADS, 0, s>>>(f, l, total, hw);
  cc_merge<<<blocks, THREADS, 0, s>>>(f, l, total, h, w);
  cc_compress<<<blocks, THREADS, 0, s>>>(f, l, total, hw);
  return static_cast<int>(cudaGetLastError());
}
