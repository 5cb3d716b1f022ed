// Median filter of uint8 and uint16 frames over a k x k window with
// replicated borders (cv2.medianBlur).
//
// Replaces yamimageprocessor_tpu/ops/filters.py median_j (XLA, not a
// pallas_call): there the median is a network of jnp.minimum/maximum over
// whole shifted frames, about 200 XLA ops at ksize 5, which plain PyTorch
// would run as as many launches.  Here one launch filters every frame.
//
// Integers make the median exact by value, so any exact selection gives the
// reference's bits.  An element is one channel of one pixel of an
// interleaved (N, H, W, C) frame; a window neighbour lies C elements away.
//
// What bounds it on the card: the min and max operations of the selection,
// not the bytes (each element in once and out once).  sm_90 runs a min or a
// max of two 16-bit lanes as one instruction (PTX min.u16x2 / max.u16x2,
// __vminu2 / __vmaxu2), so the first design's scalar min and max (one pixel
// an instruction, from sorted columns re-read from shared memory a byte at
// a time, the columns sorted again for every output row) did at most half
// the work an instruction can.
//
// ksize 3, 5, 7 and 9 (median_pair_kernel):
// - Packed pairs: a thread owns two neighbouring output elements (e, e+1),
//   the two 16-bit lanes of one word, and runs every min and max on both at
//   once.  The tile sits in shared memory as 16-bit elements, so an even
//   element pair is one word; window column i of the pair lies d = (i - r) C
//   elements away: a word when d is even, the halves of two words
//   (__byte_perm) when it is odd.
// - At ksize 3 and 5 a thread walks down its strip of PTH output rows with
//   its own word's column of the last k rows in registers, reading one new
//   row a step.  Each step it sorts that column (3 or 9 exchanges) and takes
//   its neighbours' sorted columns by warp shuffles, rank by rank (the
//   reference's shared-column construction: a column is sorted once for
//   all the windows that hold it), so the lanes a window reaches past at a
//   warp's ends (pair_halo / 2 each side) sort for their neighbours and
//   emit nothing.  Then ksize 3 takes median9 (12 ops) and ksize 5 the 13
//   rank-feasible candidates (filters.py:_MEDIAN25_CANDIDATES, 32
//   exchanges) and their forgetful median.
// - At ksize 7 and 9 a thread reads its k x k window's pair-columns from the
//   tile for every output row and runs median_j's forgetful selection over
//   them in registers.
// - Forgetful selection drops a window's min and max by pairs: n values take
//   n / 2 exchanges into lows and highs, then one chain over each, 3n/2 - 2
//   exchanges (3(n-1)/2 for odd n) where median_j takes 2n - 3: 39 for the
//   13 candidates (48), 480 for 49 taps (624), 1280 for 81 (1680).  Packed
//   min and max ops a thread's output row (counted by the numpy model in
//   tests/test_torch_median_schedule.py): 18 at ksize 3, 160 at 5, 960 at 7,
//   2560 at 9; at ksize 5 on gray frames 30 of a warp's 32 lanes emit, 85.3
//   ops a pixel.  A bitwise rank selection over the same registers needs 8
//   (uint8) or 16 passes over the k * k values, each value a subtraction, a
//   mask, a shift and an add a pass: 1568 (uint8) and 3136 (uint16) ops a
//   pixel pair at ksize 7, 2592 and 5184 at 9, never fewer.
// - Staging: a band's rows (pair_band elements and the halo) are read once, 16
//   bytes a load where the band and its halo lie inside the row, else an
//   element a load with the border replicated; the channel count is a
//   template parameter, so an element's pixel and channel need no runtime
//   division.
//
// ksize 11 to 31 (median_rank_kernel, the first design, slow): the median is
// the largest value v with fewer than k * k / 2 + 1 window values below it;
// one pass over the staged window a bit (8 for uint8, 16 for uint16) finds it
// from the top bit down.  A 961-value window does not fit in a thread's
// registers; the staged tile does fit in shared memory.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int MAX_K = 31;

struct Geometry {
  int h, w, c, rw;  // rows, pixels a row, channels, elements a row
  int bands, strips;
  int elem;         // bytes an element: 1 (uint8) or 2 (uint16)
};

// ---------------------------------------------------------------------------
// ksize 3 to 9: packed pairs

constexpr int PTHREADS = 128;  // threads a block
constexpr int PTH = 32;        // output rows a block owns
constexpr unsigned FULL = 0xFFFFFFFFu;

__device__ __forceinline__ unsigned vmin(unsigned a, unsigned b) { return __vminu2(a, b); }
__device__ __forceinline__ unsigned vmax(unsigned a, unsigned b) { return __vmaxu2(a, b); }
__device__ __forceinline__ void vcx(unsigned& a, unsigned& b) {
  const unsigned lo = vmin(a, b);
  b = vmax(a, b);
  a = lo;
}
// (high lane of x, low lane of y): the pair that starts one element past x's
__device__ __forceinline__ unsigned straddle(unsigned x, unsigned y) { return __byte_perm(x, y, 0x5432); }
__device__ __forceinline__ unsigned vmid3(unsigned a, unsigned b, unsigned c) {
  return vmax(vmin(a, b), vmin(vmax(a, b), c));
}

// Halo of a band in elements, rounded up to even so that the thread's pair
// starts a word.
__host__ __device__ constexpr int pair_halo(int k, int c) { return ((k / 2) * c + 1) / 2 * 2; }

// Elements of a row a block owns: at ksize 3 and 5 a warp's lanes that a
// window reaches past (pair_halo / 2 each side) sort columns for their
// neighbours and emit nothing; at 7 and 9 every thread emits a pair.
__host__ __device__ constexpr int pair_band(int k, int c) {
  return k <= 5 ? 2 * (PTHREADS / 32) * (32 - pair_halo(k, c)) : 2 * PTHREADS;
}

// Pair-column i (0 .. K-1) of a tile row of words, the thread's pair at word
// `own`: the pair d = (i - K/2) C elements away.
template <int K, int C>
__device__ __forceinline__ unsigned pair_at(const unsigned* row, int own, int i) {
  const int d = (i - K / 2) * C;
  if (d % 2 == 0) return row[own + d / 2];
  const int lo = own + (d - 1) / 2;  // exact: d - 1 is even
  return straddle(row[lo], row[lo + 1]);
}

// Sort k values in place (k = 3: 3 exchanges; k = 5: filters.py:_SORT5_PAIRS).
template <int K>
__device__ __forceinline__ void sort_column(unsigned (&v)[K]) {
  if constexpr (K == 3) {
    vcx(v[0], v[1]);
    vcx(v[1], v[2]);
    vcx(v[0], v[1]);
  } else {
    vcx(v[0], v[1]);
    vcx(v[3], v[4]);
    vcx(v[2], v[4]);
    vcx(v[2], v[3]);
    vcx(v[0], v[3]);
    vcx(v[0], v[2]);
    vcx(v[1], v[4]);
    vcx(v[1], v[3]);
    vcx(v[1], v[2]);
  }
}

// Drop one min and one max of w[S .. S + N) by pairs: the rest keeps its
// multiset in w[S + 2 .. S + N).
template <int S, int N, int W>
__device__ __forceinline__ void drop_min_max(unsigned (&w)[W]) {
#pragma unroll
  for (int i = 0; i + 1 < N; i += 2) vcx(w[S + i], w[S + i + 1]);  // lows even, highs odd
#pragma unroll
  for (int i = 2; i + 1 < N; i += 2) vcx(w[S], w[S + i]);  // the min into w[S]
  if constexpr (N % 2 == 1) vcx(w[S], w[S + N - 1]);
#pragma unroll
  for (int i = 3; i < N; i += 2) vcx(w[S + i], w[S + 1]);  // the max into w[S + 1]
  if constexpr (N % 2 == 1) vcx(w[S + N - 1], w[S + 1]);
}

// Forgetful selection over the N values of w (N odd), holding H = (N + 3) /
// 2: round J drops a min and a max of w[2J .. H + J) and so takes value H +
// J into the window; the median ends in w[2 (N - H) + 2].
template <int N, int H, int J>
__device__ __forceinline__ void forgetful_rounds(unsigned (&w)[N]) {
  if constexpr (J <= N - H) {
    drop_min_max<2 * J, H - J>(w);
    forgetful_rounds<N, H, J + 1>(w);
  }
}

template <int N>
__device__ __forceinline__ unsigned forgetful(unsigned (&w)[N]) {
  constexpr int H = (N + 3) / 2;
  forgetful_rounds<N, H, 0>(w);
  return w[2 * (N - H) + 2];
}

// Median of 3 x 3 from three sorted pair-columns (m[column][rank]).
__device__ __forceinline__ unsigned median9(const unsigned (&m)[3][3]) {
  const unsigned hi_of_mins = vmax(vmax(m[0][0], m[1][0]), m[2][0]);
  const unsigned med_of_mids = vmid3(m[0][1], m[1][1], m[2][1]);
  const unsigned lo_of_maxs = vmin(vmin(m[0][2], m[1][2]), m[2][2]);
  return vmid3(hi_of_mins, med_of_mids, lo_of_maxs);
}

// Median of 5 x 5 from five sorted pair-columns, p[rank][column]: the 13
// rank-feasible candidates as multisets (filters.py:
// median25_candidates_partial), then their forgetful median.
__device__ __forceinline__ unsigned median25(const unsigned (&p)[5][5]) {
  unsigned c[13];
  {  // top two of rank 0
    const unsigned p1 = vmax(p[0][0], p[0][1]), p2 = vmin(p[0][0], p[0][1]);
    const unsigned q1 = vmax(p[0][2], p[0][3]), q2 = vmin(p[0][2], p[0][3]);
    const unsigned m4 = vmax(p1, q1), t = vmin(p1, q1);
    const unsigned s4 = vmax(t, vmax(p2, q2));
    c[0] = vmax(m4, p[0][4]);
    c[1] = vmax(s4, vmin(m4, p[0][4]));
  }
  {  // rank 1: drop the two smallest
    unsigned v[5] = {p[1][0], p[1][1], p[1][2], p[1][3], p[1][4]};
#pragma unroll
    for (int i = 1; i < 5; ++i) vcx(v[0], v[i]);
#pragma unroll
    for (int i = 2; i < 5; ++i) vcx(v[1], v[i]);
    c[2] = v[2];
    c[3] = v[3];
    c[4] = v[4];
  }
  {  // rank 2: drop the smallest and the largest
    unsigned v[5] = {p[2][0], p[2][1], p[2][2], p[2][3], p[2][4]};
#pragma unroll
    for (int i = 1; i < 5; ++i) vcx(v[0], v[i]);
#pragma unroll
    for (int i = 1; i < 4; ++i) vcx(v[i], v[4]);
    c[5] = v[1];
    c[6] = v[2];
    c[7] = v[3];
  }
  {  // rank 3: drop the two largest
    unsigned v[5] = {p[3][0], p[3][1], p[3][2], p[3][3], p[3][4]};
#pragma unroll
    for (int i = 0; i < 4; ++i) vcx(v[i], v[4]);
#pragma unroll
    for (int i = 0; i < 3; ++i) vcx(v[i], v[3]);
    c[8] = v[0];
    c[9] = v[1];
    c[10] = v[2];
  }
  {  // bottom two of rank 4
    const unsigned p1 = vmin(p[4][0], p[4][1]), p2 = vmax(p[4][0], p[4][1]);
    const unsigned q1 = vmin(p[4][2], p[4][3]), q2 = vmax(p[4][2], p[4][3]);
    const unsigned m4 = vmin(p1, q1), t = vmax(p1, q1);
    const unsigned s4 = vmin(t, vmin(p2, q2));
    c[11] = vmin(m4, p[4][4]);
    c[12] = vmin(s4, vmax(m4, p[4][4]));
  }
  return forgetful(c);
}

// Stage tile rows [y0 - R, y0 + PTH + R) x elements [e0 - HP, e0 - HP + SPAN)
// of a frame as 16-bit elements, borders replicated.
template <typename T, int K, int C>
__device__ __forceinline__ void stage_pairs(const T* __restrict__ frame, uint16_t* tile, const Geometry& g, int y0,
                                            int e0) {
  constexpr int R = K / 2;
  constexpr int HP = pair_halo(K, C);
  constexpr int SPAN = pair_band(K, C) + 2 * HP;
  constexpr int ROWS = PTH + 2 * R;
  constexpr int PER = 16 / sizeof(T);  // elements a 16-byte load
  constexpr int CHUNKS = (SPAN + PER - 1) / PER + 1;  // 16-byte loads covering a row's span, any alignment
  const int left = e0 - HP;
  if (left >= PER && left + SPAN + PER <= g.rw) {
    // the band and its halo inside the row: aligned 16-byte loads covering it
    for (int i = threadIdx.x; i < ROWS * CHUNKS; i += PTHREADS) {
      const int sr = i / CHUNKS, chunk = i - sr * CHUNKS;
      const int y = min(max(y0 - R + sr, 0), g.h - 1);
      const T* want = frame + static_cast<long long>(y) * g.rw + left;  // the span's first element
      const T* aligned = reinterpret_cast<const T*>(reinterpret_cast<uintptr_t>(want) & ~static_cast<uintptr_t>(15));
      const int first = static_cast<int>(aligned - want) + chunk * PER;  // span index of the load's first element
      if (first >= SPAN) continue;
      const uint4 v = *reinterpret_cast<const uint4*>(aligned + chunk * PER);
      const unsigned part[4] = {v.x, v.y, v.z, v.w};
      uint16_t* dst = tile + sr * SPAN;
#pragma unroll
      for (int q = 0; q < PER; ++q) {
        constexpr int BITS = 8 * sizeof(T);
        const unsigned word = part[q * sizeof(T) / 4];
        const int shift = (q * BITS) % 32;
        if (first + q >= 0 && first + q < SPAN) dst[first + q] = static_cast<uint16_t>((word >> shift) & ((1u << BITS) - 1));
      }
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * SPAN; i += PTHREADS) {
      const int sr = i / SPAN, sx = i - sr * SPAN;
      const int y = min(max(y0 - R + sr, 0), g.h - 1);
      int e = left + sx;
      if (e < 0) {
        e = ((e % C) + C) % C;  // the first pixel's channel
      } else if (e >= g.rw) {
        e = g.rw - C + (e - g.rw) % C;  // the last pixel's
      }
      tile[i] = frame[static_cast<long long>(y) * g.rw + e];
    }
  }
}

template <typename T>
__device__ __forceinline__ void store_pair(T* __restrict__ row, int e, int rw, unsigned v) {
  if (e < rw) row[e] = static_cast<T>(v & 0xFFFF);
  if (e + 1 < rw) row[e + 1] = static_cast<T>(v >> 16);
}

template <int K, int C>
__global__ void __launch_bounds__(PTHREADS) median_pair_kernel(const void* __restrict__ in, void* __restrict__ out,
                                                               Geometry g) {
  constexpr int HP = pair_halo(K, C);
  constexpr int BAND = pair_band(K, C);
  constexpr int WORDS = BAND / 2 + HP;
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* tile = reinterpret_cast<uint16_t*>(smem);
  const unsigned* words = reinterpret_cast<const unsigned*>(smem);

  const int b = blockIdx.x;
  const int e0 = (b % g.bands) * BAND;
  const int rest = b / g.bands;
  const int y0 = (rest % g.strips) * PTH;
  const long long base = static_cast<long long>(rest / g.strips) * g.h * g.rw;
  if (g.elem == 1)
    stage_pairs<uint8_t, K, C>(static_cast<const uint8_t*>(in) + base, tile, g, y0, e0);
  else
    stage_pairs<uint16_t, K, C>(static_cast<const uint16_t*>(in) + base, tile, g, y0, e0);
  __syncthreads();

  const int rows = min(PTH, g.h - y0);
  uint8_t* out8 = static_cast<uint8_t*>(out) + base + static_cast<long long>(y0) * g.rw;
  uint16_t* out16 = static_cast<uint16_t*>(out) + base + static_cast<long long>(y0) * g.rw;
  auto emit = [&](int oy, int e, unsigned v) {
    if (g.elem == 1)
      store_pair(out8 + static_cast<long long>(oy) * g.rw, e, g.rw, v);
    else
      store_pair(out16 + static_cast<long long>(oy) * g.rw, e, g.rw, v);
  };

  if constexpr (K == 3 || K == 5) {
    // Each lane sorts the column of its own word (the pair e, e+1) and takes
    // its neighbours' sorted columns by shuffles: window column i lies d =
    // (i - K/2) C elements away, in lane + d/2's column, or for odd d in
    // the halves of two lanes' columns, rank by rank.
    constexpr int H = HP / 2;  // lanes a window reaches each side
    const int lane = threadIdx.x % 32;
    const int own = (threadIdx.x / 32) * (32 - 2 * H) + lane;  // word column in the tile
    const int e = e0 + 2 * (own - H);
    const bool emits = lane >= H && lane < 32 - H && e < g.rw;
    unsigned ring[K];  // the own column, tile rows oy .. oy + K - 1
#pragma unroll
    for (int j = 0; j < K; ++j) ring[j] = words[j * WORDS + own];
    for (int oy = 0; oy < rows; ++oy) {
      unsigned nb[2 * H + 1][K];  // nb[H + d][rank]: the sorted column d lanes right
#pragma unroll
      for (int j = 0; j < K; ++j) nb[H][j] = ring[j];
      sort_column<K>(nb[H]);
#pragma unroll
      for (int d = 1; d <= H; ++d)
#pragma unroll
        for (int j = 0; j < K; ++j) {
          nb[H - d][j] = __shfl_up_sync(FULL, nb[H][j], d);
          nb[H + d][j] = __shfl_down_sync(FULL, nb[H][j], d);
        }
      unsigned col[K][K];  // col[i][rank]: window column i
#pragma unroll
      for (int i = 0; i < K; ++i) {
        const int d = (i - K / 2) * C;
#pragma unroll
        for (int j = 0; j < K; ++j)
          col[i][j] = d % 2 == 0 ? nb[H + d / 2][j] : straddle(nb[H + (d - 1) / 2][j], nb[H + (d + 1) / 2][j]);
      }
      unsigned res;
      if constexpr (K == 3) {
        res = median9(col);
      } else {
        unsigned p[5][5];  // p[rank][column]
#pragma unroll
        for (int j = 0; j < 5; ++j)
#pragma unroll
          for (int i = 0; i < 5; ++i) p[j][i] = col[i][j];
        res = median25(p);
      }
      if (emits) emit(oy, e, res);
      // one row down: the ring moves up and reads the next tile row
#pragma unroll
      for (int j = 0; j + 1 < K; ++j) ring[j] = ring[j + 1];
      if (oy + 1 < rows) ring[K - 1] = words[(oy + K) * WORDS + own];
    }
  } else {
    const int own = HP / 2 + threadIdx.x;  // the thread's pair: elements e0 + 2 t, + 1
    const int e = e0 + 2 * threadIdx.x;
    if (e >= g.rw) return;
    for (int oy = 0; oy < rows; ++oy) {
      unsigned taps[K * K];
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const unsigned* row = words + (oy + j) * WORDS;
#pragma unroll
        for (int i = 0; i < K; ++i) taps[j * K + i] = pair_at<K, C>(row, own, i);
      }
      emit(oy, e, forgetful(taps));
    }
  }
}

size_t pair_shared_bytes(int k, int c) {
  return static_cast<size_t>(PTH + 2 * (k / 2)) * (pair_band(k, c) + 2 * pair_halo(k, c)) * sizeof(uint16_t);
}

template <int K, int C>
cudaError_t launch_pair(const void* in, void* out, Geometry g, int n, cudaStream_t s) {
  g.bands = (g.rw + pair_band(K, C) - 1) / pair_band(K, C);
  g.strips = (g.h + PTH - 1) / PTH;
  const long long blocks = static_cast<long long>(n) * g.bands * g.strips;
  if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  const size_t smem = pair_shared_bytes(K, C);
  cudaError_t err = cudaFuncSetAttribute(median_pair_kernel<K, C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  median_pair_kernel<K, C><<<static_cast<int>(blocks), PTHREADS, smem, s>>>(in, out, g);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_pair_channels(const void* in, void* out, const Geometry& g, int n, cudaStream_t s) {
  switch (g.c) {
    case 1: return launch_pair<K, 1>(in, out, g, n, s);
    case 2: return launch_pair<K, 2>(in, out, g, n, s);
    case 3: return launch_pair<K, 3>(in, out, g, n, s);
    default: return launch_pair<K, 4>(in, out, g, n, s);
  }
}

// ---------------------------------------------------------------------------
// ksize 11 to 31: bitwise rank selection over the staged window

constexpr int TE = 128;  // elements of a row a block owns (= threads)
constexpr int TH = 16;   // output rows a block owns

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
__global__ void __launch_bounds__(TE) median_rank_kernel(const T* __restrict__ in, T* __restrict__ out, Geometry g, int k) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int r = k / 2;
  const int span = TE + 2 * r * g.c;
  T* tile = reinterpret_cast<T*>(smem);
  const int b = blockIdx.x;
  const int e0 = (b % g.bands) * TE;
  const int rest = b / g.bands;
  const int y0 = (rest % g.strips) * TH;
  const long long base = static_cast<long long>(rest / g.strips) * g.h * g.rw;
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

size_t rank_shared_bytes(int k, int c, int elem) {
  return static_cast<size_t>((TH + 2LL * (k / 2)) * (TE + 2LL * (k / 2) * c) * elem);
}

template <typename T>
cudaError_t launch_rank(const void* in, void* out, Geometry g, int n, int k, cudaStream_t s) {
  g.bands = (g.rw + TE - 1) / TE;
  g.strips = (g.h + TH - 1) / TH;
  const long long blocks = static_cast<long long>(n) * g.bands * g.strips;
  if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  const size_t smem = rank_shared_bytes(k, g.c, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(median_rank_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  median_rank_kernel<T><<<static_cast<int>(blocks), TE, smem, s>>>(static_cast<const T*>(in), static_cast<T*>(out),
                                                                   g, k);
  return cudaGetLastError();
}

// The rate of packed min and max on the card: every thread runs `rounds`
// rounds of RATE_CHAINS independent compare-exchanges (2 RATE_CHAINS ops a
// round; the intrinsics are opaque to the compiler, so it folds no round)
// and writes one word, so nothing is dead code.
constexpr int RATE_CHAINS = 8;
__global__ void __launch_bounds__(256) vminmax_rate_kernel(unsigned* out, int rounds, unsigned seed) {
  unsigned a[RATE_CHAINS], b[RATE_CHAINS];
#pragma unroll
  for (int i = 0; i < RATE_CHAINS; ++i) {
    a[i] = seed * (threadIdx.x + 1) + i;
    b[i] = seed ^ (blockIdx.x * 977 + i);
  }
  for (int r = 0; r < rounds; ++r) {
#pragma unroll
    for (int i = 0; i < RATE_CHAINS; ++i) {
      vcx(a[i], b[i]);
    }
  }
  unsigned acc = 0;
#pragma unroll
  for (int i = 0; i < RATE_CHAINS; ++i) acc ^= a[i] ^ b[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = acc;
}

}  // namespace

// Packed 16x2 min and max ops a launch of yam_vminmax_rate runs, for the
// rate: blocks x 256 threads x rounds x 2 RATE_CHAINS.
extern "C" int yam_vminmax_rate(void* out, int blocks, int rounds, void* stream) {
  if (blocks < 1 || rounds < 1) return static_cast<int>(cudaErrorInvalidValue);
  vminmax_rate_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(static_cast<unsigned*>(out), rounds,
                                                                             0x9E3779B9u);
  return static_cast<int>(cudaGetLastError());
}

// in/out: n frames of h rows of w pixels of c interleaved channels (1 to 4),
// contiguous, uint8 (elem 1) or uint16 (elem 2); k odd, 3 <= k <= 31;
// w * c < 2^30.  Returns cudaGetLastError() after the launch.
extern "C" int yam_median(const void* in, void* out, int n, int h, int w, int c, int k, int elem, void* stream) {
  if (k < 3 || k > MAX_K || !(k & 1) || n < 1 || h < 1 || w < 1 || c < 1 || c > 4 || (elem != 1 && elem != 2) ||
      static_cast<long long>(w) * c >= (1 << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  Geometry g;
  g.h = h;
  g.w = w;
  g.c = c;
  g.rw = w * c;
  g.elem = elem;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (k) {
    case 3: err = launch_pair_channels<3>(in, out, g, n, s); break;
    case 5: err = launch_pair_channels<5>(in, out, g, n, s); break;
    case 7: err = launch_pair_channels<7>(in, out, g, n, s); break;
    case 9: err = launch_pair_channels<9>(in, out, g, n, s); break;
    default:
      err = elem == 1 ? launch_rank<uint8_t>(in, out, g, n, k, s) : launch_rank<uint16_t>(in, out, g, n, k, s);
  }
  if (err != cudaSuccess) cudaGetLastError();  // take it: the next launch's check must not see it
  return static_cast<int>(err);
}
