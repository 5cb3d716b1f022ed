// Median filter of uint8 and uint16 frames over a k x k window with
// replicated borders (cv2.medianBlur).
//
// Replaces yamimageprocessor_tpu/ops/filters.py median_j (XLA, not a
// pallas_call): there the median is a network of jnp.minimum/maximum over
// whole shifted frames, about 200 XLA ops at ksize 5, which plain PyTorch
// would run as as many launches.  Here one launch filters every frame.
//
// Integers make the median exact by value, so any exact selection gives the
// reference's bits; the network the reference uses is kept where it is
// cheap (ksize 3 and 5) and a rank selection takes the larger windows.
//
// - Tile: a block owns TE consecutive elements of a row (an element is one
//   channel of one pixel of an interleaved (N, H, W, C) frame; a window
//   neighbour lies C elements away) and TH output rows.  It stages the tile
//   and its halo, r rows above and below and r * C elements each side, in
//   shared memory, with the replicated border resolved while staging.
// - ksize 3 and 5: every staged column is sorted once per output row (the
//   reference's shared-column construction): a window then reads k sorted
//   columns, and ksize 5 keeps only the 13 rank-feasible candidates of
//   them before a forgetful selection (filters.py:_MEDIAN25_CANDIDATES).
// - ksize 7 to 31: the median is the largest value v with fewer than
//   k * k / 2 + 1 window values below it; one pass over the window a bit
//   (8 for uint8, 16 for uint16) finds it from the top bit down.  A
//   961-value window does not fit in a thread's registers; the staged tile
//   does fit in shared memory.
//
// Bound on the card: the compare-exchanges (about 89 a pixel at ksize 5:
// 9 of a column sort shared by 5 windows, 32 for the candidates, 48 for
// the forgetful selection; k * k * bits compares at larger ksizes) at the
// integer rate, two pixels a min or max (sm_90's packed 16x2 forms take
// any uint8 or uint16 pair); the bytes (each pixel in once and out once)
// are far less.
// This first kernel aims at right, not at that bound.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int TE = 128;  // elements of a row a block owns (= threads)
constexpr int TH = 16;   // output rows a block owns
constexpr int MAX_K = 31;

struct Geometry {
  int h, w, c, rw;  // rows, pixels a row, channels, elements a row
  int bands, strips;
};

template <typename T>
__device__ __forceinline__ T lo(T a, T b) {
  return b < a ? b : a;
}

template <typename T>
__device__ __forceinline__ T hi(T a, T b) {
  return a < b ? b : a;
}

template <typename T>
__device__ __forceinline__ void cx(T& a, T& b) {
  const T smaller = lo(a, b);
  b = hi(a, b);
  a = smaller;
}

// Stage rows [y0 - r, y0 + TH + r) and elements [e0 - r c, e0 + TE + r c)
// of one frame into tile (rows x span), borders replicated.
template <typename T>
__device__ void stage(const T* __restrict__ frame, T* tile, const Geometry& g, int y0, int e0, int r, int span) {
  const int rows = TH + 2 * r;
  const int left = e0 - r * g.c;
  for (int i = threadIdx.x; i < rows * span; i += blockDim.x) {
    const int sy = i / span, sx = i - sy * span;
    const int y = min(max(y0 - r + sy, 0), g.h - 1);
    const int e = left + sx;
    // pixel and channel of element e, floor division for e < 0
    int x = e >= 0 ? e / g.c : -((-e + g.c - 1) / g.c);
    const int ch = e - x * g.c;
    x = min(max(x, 0), g.w - 1);
    tile[i] = frame[static_cast<long long>(y) * g.rw + x * g.c + ch];
  }
}

template <typename T>
__device__ __forceinline__ T mid3(T a, T b, T c) {
  return hi(lo(a, b), lo(hi(a, b), c));
}

// Sorted columns: sorted[rank][oy][sx] for every staged column sx.
template <typename T, int K>
__device__ void sort_columns(const T* tile, T* sorted, int span) {
  for (int i = threadIdx.x; i < TH * span; i += blockDim.x) {
    const int oy = i / span, sx = i - oy * span;
    T v[K];
#pragma unroll
    for (int j = 0; j < K; ++j) v[j] = tile[(oy + j) * span + sx];
    if constexpr (K == 3) {
      cx(v[0], v[1]);
      cx(v[1], v[2]);
      cx(v[0], v[1]);
    } else {
      // filters.py:_SORT5_PAIRS
      cx(v[0], v[1]);
      cx(v[3], v[4]);
      cx(v[2], v[4]);
      cx(v[2], v[3]);
      cx(v[0], v[3]);
      cx(v[0], v[2]);
      cx(v[1], v[4]);
      cx(v[1], v[3]);
      cx(v[1], v[2]);
    }
#pragma unroll
    for (int j = 0; j < K; ++j) sorted[(j * TH + oy) * span + sx] = v[j];
  }
}

// Median of 3 x 3 from three sorted columns (a: column 0, ...; [0] min).
template <typename T>
__device__ __forceinline__ T median9(const T (&m)[3][3]) {
  const T hi_of_mins = hi(hi(m[0][0], m[1][0]), m[2][0]);
  const T med_of_mids = mid3(m[0][1], m[1][1], m[2][1]);
  const T lo_of_maxs = lo(lo(m[0][2], m[1][2]), m[2][2]);
  return mid3(hi_of_mins, med_of_mids, lo_of_maxs);
}

// Forgetful selection: drop the min and the max of w[0..n).
template <typename T, int N>
__device__ __forceinline__ void drop_min_max(T (&w)[13]) {
#pragma unroll
  for (int i = 1; i < N; ++i) cx(w[0], w[i]);
#pragma unroll
  for (int i = 1; i < N - 1; ++i) cx(w[i], w[N - 1]);
}

// Median of 5 x 5 from five sorted columns: rows5[rank][column] (the
// rank-feasible candidates of filters.py:median25_candidates_partial, then
// a forgetful median of the 13).
template <typename T>
__device__ T median25(T (&p)[5][5]) {
  T c[13];
  {  // top2 of rank 0
    T a = p[0][0], b = p[0][1], cc = p[0][2], d = p[0][3], e = p[0][4];
    const T p1 = hi(a, b), p2 = lo(a, b), q1 = hi(cc, d), q2 = lo(cc, d);
    const T m4 = hi(p1, q1), t = lo(p1, q1);
    const T s4 = hi(t, hi(p2, q2));
    c[0] = hi(m4, e);
    c[1] = hi(s4, lo(m4, e));
  }
  {  // rank 1: drop the two smallest
    T v[5] = {p[1][0], p[1][1], p[1][2], p[1][3], p[1][4]};
#pragma unroll
    for (int i = 1; i < 5; ++i) cx(v[0], v[i]);
#pragma unroll
    for (int i = 2; i < 5; ++i) cx(v[1], v[i]);
    c[2] = v[2];
    c[3] = v[3];
    c[4] = v[4];
  }
  {  // rank 2: drop the smallest and the largest
    T v[5] = {p[2][0], p[2][1], p[2][2], p[2][3], p[2][4]};
#pragma unroll
    for (int i = 1; i < 5; ++i) cx(v[0], v[i]);
#pragma unroll
    for (int i = 1; i < 4; ++i) cx(v[i], v[4]);
    c[5] = v[1];
    c[6] = v[2];
    c[7] = v[3];
  }
  {  // rank 3: drop the two largest
    T v[5] = {p[3][0], p[3][1], p[3][2], p[3][3], p[3][4]};
#pragma unroll
    for (int i = 0; i < 4; ++i) cx(v[i], v[4]);
#pragma unroll
    for (int i = 0; i < 3; ++i) cx(v[i], v[3]);
    c[8] = v[0];
    c[9] = v[1];
    c[10] = v[2];
  }
  {  // bottom2 of rank 4
    T a = p[4][0], b = p[4][1], cc = p[4][2], d = p[4][3], e = p[4][4];
    const T p1 = lo(a, b), p2 = hi(a, b), q1 = lo(cc, d), q2 = hi(cc, d);
    const T m4 = lo(p1, q1), t = hi(p1, q1);
    const T s4 = lo(t, lo(p2, q2));
    c[11] = lo(m4, e);
    c[12] = lo(s4, hi(m4, e));
  }
  // forgetful median of 13: hold 8, drop min and max, take the next
  T w[13];
#pragma unroll
  for (int i = 0; i < 8; ++i) w[i] = c[i];
  drop_min_max<T, 8>(w);  // w[1..6] remain
#pragma unroll
  for (int i = 0; i < 6; ++i) w[i] = w[i + 1];
  w[6] = c[8];
  drop_min_max<T, 7>(w);
#pragma unroll
  for (int i = 0; i < 5; ++i) w[i] = w[i + 1];
  w[5] = c[9];
  drop_min_max<T, 6>(w);
#pragma unroll
  for (int i = 0; i < 4; ++i) w[i] = w[i + 1];
  w[4] = c[10];
  drop_min_max<T, 5>(w);
#pragma unroll
  for (int i = 0; i < 3; ++i) w[i] = w[i + 1];
  w[3] = c[11];
  drop_min_max<T, 4>(w);
#pragma unroll
  for (int i = 0; i < 2; ++i) w[i] = w[i + 1];
  w[2] = c[12];
  drop_min_max<T, 3>(w);
  return w[1];
}

__device__ __forceinline__ void block_origin(const Geometry& g, long long& frame, int& y0, int& e0) {
  const int b = blockIdx.x;
  const int band = b % g.bands;
  const int rest = b / g.bands;
  y0 = (rest % g.strips) * TH;
  frame = rest / g.strips;
  e0 = band * TE;
}

// ksize 3 and 5: shared-column networks.
template <typename T, int K>
__global__ void __launch_bounds__(TE) median_network_kernel(const T* __restrict__ in, T* __restrict__ out, Geometry g) {
  constexpr int R = K / 2;
  extern __shared__ __align__(16) unsigned char smem[];
  const int span = TE + 2 * R * g.c;
  T* tile = reinterpret_cast<T*>(smem);
  T* sorted = tile + (TH + 2 * R) * span;
  long long f;
  int y0, e0;
  block_origin(g, f, y0, e0);
  const long long base = f * static_cast<long long>(g.h) * g.rw;
  stage(in + base, tile, g, y0, e0, R, span);
  __syncthreads();
  sort_columns<T, K>(tile, sorted, span);
  __syncthreads();
  const int e = e0 + threadIdx.x;
  if (e >= g.rw) return;
  for (int oy = 0; oy < TH && y0 + oy < g.h; ++oy) {
    T res;
    if constexpr (K == 3) {
      T m[3][3];
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j) m[i][j] = sorted[(j * TH + oy) * span + threadIdx.x + i * g.c];
      res = median9(m);
    } else {
      T p[5][5];
#pragma unroll
      for (int j = 0; j < 5; ++j)
#pragma unroll
        for (int i = 0; i < 5; ++i) p[j][i] = sorted[(j * TH + oy) * span + threadIdx.x + i * g.c];
      res = median25(p);
    }
    out[base + static_cast<long long>(y0 + oy) * g.rw + e] = res;
  }
}

// ksize 7 to 31: bitwise rank selection over the staged window.
template <typename T>
__global__ void __launch_bounds__(TE) median_rank_kernel(const T* __restrict__ in, T* __restrict__ out, Geometry g, int k) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int r = k / 2;
  const int span = TE + 2 * r * g.c;
  T* tile = reinterpret_cast<T*>(smem);
  long long f;
  int y0, e0;
  block_origin(g, f, y0, e0);
  const long long base = f * static_cast<long long>(g.h) * g.rw;
  stage(in + base, tile, g, y0, e0, r, span);
  __syncthreads();
  const int e = e0 + threadIdx.x;
  if (e >= g.rw) return;
  const int rank = k * k / 2;  // 0-based rank of the median
  for (int oy = 0; oy < TH && y0 + oy < g.h; ++oy) {
    unsigned res = 0;
    for (int bit = 8 * static_cast<int>(sizeof(T)) - 1; bit >= 0; --bit) {
      const unsigned cand = res | (1u << bit);
      int below = 0;
      for (int j = 0; j < k; ++j) {
        const T* row = tile + (oy + j) * span + threadIdx.x;
        for (int i = 0; i < k; ++i) below += static_cast<unsigned>(row[i * g.c]) < cand;
      }
      if (below <= rank) res = cand;
    }
    out[base + static_cast<long long>(y0 + oy) * g.rw + e] = static_cast<T>(res);
  }
}

size_t shared_bytes(int k, int c, int elem) {
  const int r = k / 2;
  const long long span = TE + 2LL * r * c;
  long long cells = (TH + 2LL * r) * span;
  if (k == 3 || k == 5) cells += static_cast<long long>(k) * TH * span;
  return static_cast<size_t>(cells * elem);
}

template <typename T>
cudaError_t launch(const void* in, void* out, const Geometry& g, int k, int blocks, cudaStream_t s) {
  const size_t smem = shared_bytes(k, g.c, sizeof(T));
  const T* src = static_cast<const T*>(in);
  T* dst = static_cast<T*>(out);
  cudaError_t err;
  if (k == 3) {
    err = cudaFuncSetAttribute(median_network_kernel<T, 3>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err == cudaSuccess) median_network_kernel<T, 3><<<blocks, TE, smem, s>>>(src, dst, g);
  } else if (k == 5) {
    err = cudaFuncSetAttribute(median_network_kernel<T, 5>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err == cudaSuccess) median_network_kernel<T, 5><<<blocks, TE, smem, s>>>(src, dst, g);
  } else {
    err = cudaFuncSetAttribute(median_rank_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err == cudaSuccess) median_rank_kernel<T><<<blocks, TE, smem, s>>>(src, dst, g, k);
  }
  if (err == cudaSuccess) err = cudaGetLastError();
  return err;
}

}  // namespace

// in/out: n frames of h rows of w pixels of c interleaved channels,
// contiguous, uint8 (elem 1) or uint16 (elem 2); k odd, 3 <= k <= 31;
// w * c < 2^30.  Returns cudaGetLastError() after the launch.
extern "C" int yam_median(const void* in, void* out, int n, int h, int w, int c, int k, int elem, void* stream) {
  if (k < 3 || k > MAX_K || !(k & 1) || n < 1 || h < 1 || w < 1 || c < 1 || (elem != 1 && elem != 2) ||
      static_cast<long long>(w) * c >= (1 << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  Geometry g;
  g.h = h;
  g.w = w;
  g.c = c;
  g.rw = w * c;
  g.bands = (g.rw + TE - 1) / TE;
  g.strips = (h + TH - 1) / TH;
  const long long blocks = static_cast<long long>(n) * g.strips * g.bands;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = elem == 1 ? launch<uint8_t>(in, out, g, k, static_cast<int>(blocks), s)
                                    : launch<uint16_t>(in, out, g, k, static_cast<int>(blocks), s);
  if (err != cudaSuccess) cudaGetLastError();  // take it: the next launch's check must not see it
  return static_cast<int>(err);
}
