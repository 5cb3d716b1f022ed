// Shape kernels of the extraction stage: the kept Fourier lines of a
// contour with its truncated reconstruction, and the mean boundary errors
// of candidate polygons.  Neither replaces a pallas_call: they replace XLA
// code of yamimageprocessor_tpu/ops/extraction_device.py and its CPU
// golden in ops/shape.py.
//
// fourier_lines (for fourier_dft_j, extraction_device.py:254; golden
// np.fft.fft / ifft, shape.py:278): for each contour z_j = x_j + i y_j of n
// points and k = min(num_coeff, n), the 2k lines m in [0..k-1, n-k..n-1] of
// c_m = sum_j z_j e^{-2 pi i m j / n}, and recon_j = (1/n) sum over the
// distinct kept lines of c_m e^{+2 pi i m j / n} (a line in both halves,
// where n < 2k, is kept once), all in float64.  Every twiddle is w_r =
// e^{2 pi i r / n} of ops/fourier.py:twiddles: 4r = q n + s with |s| <= n / 2,
// sincospi(s / 2n) rotated by q quarter turns (exact where s is 0).
//
// Two routes, chosen a contour by ops/fourier.py:route from their cost
// each way: the direct sums (2k n complex multiply-adds) or a mixed-radix
// Stockham FFT over n's prime factors, the 2s paired into 4s (n sum(p_i),
// and a pass over the n outputs a stage, charged as STAGE_COST
// multiply-adds an output); no Bluestein, so a large prime factor makes the
// FFT dear and the direct route wins.  An FFT stage of radix R after stages of product Ns writes
// output o = (j / Ns) Ns R + j % Ns + q Ns, for j < n / R and q < R, as
// sum_r in[j + r n / R] w^{-+ r e mod n}, e = (j % Ns) n / (Ns R) + q n / R:
// the stage's twiddle and its R-point DFT in one table read a term.  The
// forward transform forms all n lines and keeps 2k; the inverse runs over
// the masked spectrum.  Bound on the card: the chosen route's FP64 work (4
// instructions a complex multiply-add) and the n sincospi of the table.
//
// Layout.  A contour whose route fits the block's opt-in shared memory
// (FFT: the table and two buffers, 48 n bytes; direct: the table, the
// points and the 2k lines, 24 n + 32 k) takes one block of the one launch
// fourier_block_kernel: the table, the forward, the mask and the inverse
// (or the direct sums, a warp a line, then a thread a point) in shared
// memory, coeffs and recon written once.  A longer contour goes through L2
// in launches over (contour, chunk), each a programmatic dependent launch
// (its blocks start while the launch before runs): on the FFT route its
// small factors grouped into radices up to 128 (ops/fourier.py:
// long_radices, 11312 = 112 x 101: a launch costs more than the grouped
// radix's extra multiply-adds), a launch a stage of butterflies staged in
// shared memory, forward then inverse (the first stage forms the table,
// the first inverse stage masks the spectrum and writes the lines, the last
// writes recon); on the direct route the table, then each chunk of points'
// partial sums of every line, then a launch that adds them and
// reconstructs its chunk's points.
//
// polygon_errors (for polygon_mean_errors_j, extraction_device.py:339, and
// the golden loop of _optimize_epsilon over point_polygon_distance,
// shape.py:218, averaged by np.mean): for each candidate polygon the mean
// over its contour's points of the distance to the nearest edge, bit for
// bit the reference's float64 scalar code: every operation an explicitly
// rounded intrinsic (__dmul_rn, __dadd_rn, __dsub_rn, __ddiv_rn: nothing is
// contracted into an FMA), the clamp max(0, min(1, t)) with Python's
// comparisons, the running minimum over the edges in order, the distance by
// glibc 2.36's hypot as the x86_64 library is built (no FMA: the corrected
// square root of Borges' MyHypot3, its scaling branches), and the sum in
// numpy's pairwise order (chunks of 8192 added in order, each summed
// pairwise down to leaves of at most 128 with 8 accumulators) divided by n.
// Bound on the card: about 20 FP64 operations and a hypot a (candidate,
// point, edge).  Design: two launches.  The distances over (candidate,
// chunk of points), a thread a point walking the edges (every lane reads
// the same vertex: one broadcast load), into a scratch row; then a block a
// candidate sums its row in numpy's order, the tree's leaves (at most 128
// elements each) by the block's threads at once and their combination in
// the tree's order by one thread.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BLOCK_THREADS = 256;  // a contour's block on the shared-memory route
constexpr int LONG_THREADS = 128;   // a chunk of a long contour's points; a stage block's butterflies' inputs
constexpr int STAGE_THREADS = 512;  // a stage block: several lanes an output where its butterflies are few
constexpr int PLAN = 34;            // a contour's plan: FFT or direct, the stage count, the radices
constexpr int MAX_LONG_RADIX = 1024;  // a long contour's stage radix at most (ops/fourier.py:route keeps it below)
constexpr int MAX_COEFF = 512;      // the schema's largest num_coeff
constexpr int POLY_THREADS = 128;
constexpr int PAIRWISE_BLOCK = 128;
constexpr int REDUCE_CHUNK = 8192;
constexpr int MAX_LEAVES = REDUCE_CHUNK / 64;  // a chunk's leaves hold at least 64 elements

// w_r = e^{2 pi i r / n}, r < n: 4r = q n + s, |s| <= n / 2, the angle
// (s / n)(pi / 2) rotated by q quarter turns
__device__ __forceinline__ double2 twiddle(int r, int n) {
  const long long t = 4LL * r;
  int q = static_cast<int>(t / n);
  long long s = t - static_cast<long long>(q) * n;
  if (2 * s > n) {
    ++q;
    s -= n;
  }
  double sn, cs;
  sincospi(static_cast<double>(s) / (2.0 * n), &sn, &cs);
  switch (q & 3) {
    case 0: return make_double2(cs, sn);
    case 1: return make_double2(-sn, cs);
    case 2: return make_double2(-cs, -sn);
    default: return make_double2(sn, -cs);
  }
}

// a += x * w (inverse) or x * conj(w) (forward)
__device__ __forceinline__ void mac(double2& a, double2 x, double2 w, bool inverse) {
  if (inverse) {
    a.x += x.x * w.x - x.y * w.y;
    a.y += x.x * w.y + x.y * w.x;
  } else {
    a.x += x.x * w.x + x.y * w.y;
    a.y += x.y * w.x - x.x * w.y;
  }
}

// line l of 2k: m in [0..k-1, n-k..n-1]
__device__ __forceinline__ int line_index(int l, int k, int n) { return l < k ? l : n - k + (l - k); }
__device__ __forceinline__ bool kept(int m, int k, int n) { return m < k || m >= n - k; }

// the points as complex doubles
struct PointLoad {
  const int2* z;
  __device__ double2 operator()(int i) const {
    const int2 p = z[i];
    return make_double2(p.x, p.y);
  }
};
// a buffer
struct BufferLoad {
  const double2* a;
  __device__ double2 operator()(int i) const { return a[i]; }
};
// the spectrum with the lines the truncation drops read as 0
struct MaskedLoad {
  const double2* a;
  int k, n;
  __device__ double2 operator()(int i) const { return kept(i, k, n) ? a[i] : make_double2(0.0, 0.0); }
};

// output o of a Stockham stage of radix R after stages of product Ns
template <class Load>
__device__ __forceinline__ double2 stage_output(const Load& in, const double2* __restrict__ table, int o, int n,
                                                int R, int Ns, bool inverse) {
  const int nr = n / R;
  const int jm = o % Ns, q = (o / Ns) % R;
  const int j = (o / (Ns * R)) * Ns + jm;
  const int e = jm * (n / (Ns * R)) + q * nr;
  double2 a = make_double2(0.0, 0.0);
  int idx = 0;
  for (int r = 0; r < R; ++r) {
    mac(a, in(j + r * nr), table[idx], inverse);
    idx += e;
    if (idx >= n) idx -= n;
  }
  return a;
}

// One block a contour that fits in shared memory: the table, then the FFT
// route (forward stages, the lines, the mask, inverse stages) or the direct
// route (a warp a line, a thread a point), coeffs and recon written once.
__global__ void __launch_bounds__(BLOCK_THREADS)
fourier_block_kernel(const int* __restrict__ points, const long long* __restrict__ offsets,
                     const long long* __restrict__ line_offsets, const int* __restrict__ plan,
                     const int* __restrict__ ids, double2* __restrict__ coeffs, double2* __restrict__ recon,
                     int num_coeff) {
  extern __shared__ double2 sh[];
  const int f = ids[blockIdx.x];
  const long long o = offsets[f];
  const int n = static_cast<int>(offsets[f + 1] - o);
  const int k = num_coeff < n ? num_coeff : n;
  const int* pl = plan + static_cast<long long>(f) * PLAN;
  const int tid = threadIdx.x, threads = blockDim.x;
  const int2* z = reinterpret_cast<const int2*>(points) + o;
  double2* out = coeffs + line_offsets[f];
  double2* table = sh;
  for (int r = tid; r < n; r += threads) table[r] = twiddle(r, n);
  if (pl[0]) {  // the FFT route
    double2* src = sh + n;
    double2* dst = src + n;
    for (int j = tid; j < n; j += threads) src[j] = PointLoad{z}(j);
    __syncthreads();
    for (int pass = 0; pass < 2; ++pass) {
      const bool inverse = pass == 1;
      int Ns = 1;
      for (int s = 0; s < pl[1]; ++s) {
        const int R = pl[2 + s];
        for (int i = tid; i < n; i += threads) dst[i] = stage_output(BufferLoad{src}, table, i, n, R, Ns, inverse);
        __syncthreads();
        double2* t = src;
        src = dst;
        dst = t;
        Ns *= R;
      }
      if (!inverse) {  // the lines, then the spectrum masked in place
        for (int l = tid; l < 2 * k; l += threads) out[l] = src[line_index(l, k, n)];
        __syncthreads();
        for (int i = tid; i < n; i += threads)
          if (!kept(i, k, n)) src[i] = make_double2(0.0, 0.0);
        __syncthreads();
      }
    }
    for (int j = tid; j < n; j += threads) recon[o + j] = make_double2(src[j].x / n, src[j].y / n);
    return;
  }
  // the direct route: the lines a warp each, lanes over the points
  double2* lines = sh + n;
  int2* zs = reinterpret_cast<int2*>(lines + 2 * k);
  for (int j = tid; j < n; j += threads) zs[j] = z[j];
  __syncthreads();
  const int lane = tid & 31;
  for (int l = tid >> 5; l < 2 * k; l += threads >> 5) {
    const int m = line_index(l, k, n);
    long long r = static_cast<long long>(m) * lane % n;
    const int step = static_cast<int>(static_cast<long long>(m) * 32 % n);
    double2 a = make_double2(0.0, 0.0);
    for (int j = lane; j < n; j += 32) {
      const int2 p = zs[j];
      mac(a, make_double2(p.x, p.y), table[r], false);
      r += step;
      if (r >= n) r -= n;
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      a.x += __shfl_down_sync(0xffffffffu, a.x, d);
      a.y += __shfl_down_sync(0xffffffffu, a.y, d);
    }
    if (lane == 0) {
      out[l] = a;
      lines[l] = l >= k && l - k < 2 * k - n ? make_double2(0.0, 0.0) : a;  // a line in both halves once
    }
  }
  __syncthreads();
  for (int j = tid; j < n; j += threads) {
    double2 a = make_double2(0.0, 0.0);
    long long r = 0;
    for (int l = 0; l < k; ++l) {
      mac(a, lines[l], table[r], true);
      r += j;
      if (r >= n) r -= n;
    }
    r = static_cast<long long>(n - k) * j % n;
    for (int l = k; l < 2 * k; ++l) {
      mac(a, lines[l], table[r], true);
      r += j;
      if (r >= n) r -= n;
    }
    recon[o + j] = make_double2(a.x / n, a.y / n);
  }
}

// the long contours' twiddles: grid (contours, chunks)
__global__ void __launch_bounds__(LONG_THREADS)
fourier_table_kernel(const long long* __restrict__ offsets, const int* __restrict__ ids,
                     double2* __restrict__ table) {
  asm volatile("griddepcontrol.launch_dependents;");  // the next launch's blocks may start and wait for this grid
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int f = ids[blockIdx.x];
  const long long o = offsets[f];
  const int n = static_cast<int>(offsets[f + 1] - o);
  for (int r = blockIdx.y * blockDim.x + threadIdx.x; r < n; r += gridDim.y * blockDim.x)
    table[o + r] = twiddle(r, n);
}

// Stage s of a long contour's FFT through L2, a block a few butterflies:
// grid (contours, blocks).  Butterfly j < n / R of a stage of radix R after
// stages of product Ns takes its R inputs in[j + r n / R], each times the
// stage's twiddle w^{-+ r (j % Ns) n / (Ns R)}, into shared memory; its R
// outputs o = (j / Ns) Ns R + j % Ns + q Ns are the sums over r of those
// times the R-th roots w^{-+ (q r mod R) n / R}, read from shared memory:
// each input and each twiddle read once from L2.  work holds two buffers
// of the P points; the forward's first stage reads the points, forms its
// roots itself (its twiddles are all 1) and writes the table for the
// stages after it; the inverse's first reads the spectrum masked and
// writes the lines, its last writes recon.
__global__ void __launch_bounds__(STAGE_THREADS)
fourier_long_stage_kernel(const int* __restrict__ points, const long long* __restrict__ offsets,
                          const long long* __restrict__ line_offsets, const int* __restrict__ plan,
                          const int* __restrict__ ids, double2* __restrict__ table, double2* __restrict__ work,
                          double2* __restrict__ coeffs, double2* __restrict__ recon, long long total, int num_coeff,
                          int s, int inverse) {
  extern __shared__ double2 stage_sh[];
  asm volatile("griddepcontrol.launch_dependents;");
  asm volatile("griddepcontrol.wait;" ::: "memory");  // the stage before is done and visible
  const int f = ids[blockIdx.x];
  const int* pl = plan + static_cast<long long>(f) * PLAN;
  const int stages = pl[1];
  if (s >= stages) return;
  const long long o = offsets[f];
  const int n = static_cast<int>(offsets[f + 1] - o);
  const int k = num_coeff < n ? num_coeff : n;
  int Ns = 1;
  for (int t = 0; t < s; ++t) Ns *= pl[2 + t];
  const int R = pl[2 + s];
  double2* w = table + o;
  const bool head = !inverse && s == 0;  // the first stage: the table is formed here
  if (head)
    for (int r = blockIdx.y * blockDim.x + threadIdx.x; r < n; r += gridDim.y * blockDim.x) w[r] = twiddle(r, n);
  const int at = (inverse ? stages : 0) + s;  // stages done before this one
  const double2* src = work + (at % 2) * total + o;
  double2* dst = work + ((at + 1) % 2) * total + o;
  if (inverse && s == 0 && blockIdx.y == 0)
    for (int l = threadIdx.x; l < 2 * k; l += blockDim.x) coeffs[line_offsets[f] + l] = src[line_index(l, k, n)];
  const int nr = n / R, per = R < LONG_THREADS ? LONG_THREADS / R : 1;
  const int j0 = blockIdx.y * per;
  if (j0 >= nr) return;
  const int cnt = nr - j0 < per ? nr - j0 : per;
  const int tw = n / (Ns * R);
  double2* roots = stage_sh;  // w^{(r) n / R}, r < R
  double2* v = stage_sh + R;  // the butterflies' twiddled inputs, butterfly-major
  const PointLoad first_in{reinterpret_cast<const int2*>(points) + o};
  const MaskedLoad spectrum{src, k, n};
  const BufferLoad buffer{src};
  for (int r = threadIdx.x; r < R; r += blockDim.x) roots[r] = head ? twiddle(r * nr, n) : w[r * nr];
  for (int e = threadIdx.x; e < cnt * R; e += blockDim.x) {
    const int b = e % cnt, r = e / cnt;  // neighbouring threads on neighbouring butterflies: coalesced inputs
    const int j = j0 + b;
    const int i = j + r * nr;
    if (head) {  // Ns = 1: every twiddle is w^0
      v[b * R + r] = first_in(i);
      continue;
    }
    const double2 x = s > 0 ? buffer(i) : spectrum(i);
    double2 a = make_double2(0.0, 0.0);
    mac(a, x, w[r * (j % Ns) * tw], inverse != 0);  // r (j % Ns) tw < n
    v[b * R + r] = a;
  }
  __syncthreads();
  // G lanes an output (a power of two, G | 32), each the terms r = g, g + G,
  // ..., added by shuffles; every lane of a warp goes round
  int G = 1;
  while (G < 32 && 2 * G * cnt * R <= static_cast<int>(blockDim.x)) G *= 2;
  const int g = threadIdx.x % G, span = blockDim.x / G;
  for (int e0 = 0; e0 < cnt * R; e0 += span) {
    const int e = e0 + static_cast<int>(threadIdx.x) / G;
    const int b = e / R, q = e % R;
    double2 a = make_double2(0.0, 0.0);
    if (e < cnt * R) {
      int idx = q * g % R;
      const int step = q * G % R;
      for (int r = g; r < R; r += G) {
        mac(a, v[b * R + r], roots[idx], inverse != 0);
        idx += step;
        if (idx >= R) idx -= R;
      }
    }
    for (int d = G >> 1; d > 0; d >>= 1) {
      a.x += __shfl_down_sync(0xffffffffu, a.x, d, G);
      a.y += __shfl_down_sync(0xffffffffu, a.y, d, G);
    }
    if (e >= cnt * R || g != 0) continue;
    const int j = j0 + b;
    const int out = (j / Ns) * Ns * R + j % Ns + q * Ns;
    if (inverse && s == stages - 1) recon[o + out] = make_double2(a.x / n, a.y / n);
    else dst[out] = a;
  }
}

// A long contour's direct lines, partly: grid (contours, chunks of
// LONG_THREADS points); a warp a line over the chunk's points (lanes
// striding), each chunk's partial sum of every line into partial (a row of
// 2 num_coeff a chunk, chunks rows a contour)
__global__ void __launch_bounds__(LONG_THREADS)
fourier_long_partial_kernel(const int* __restrict__ points, const long long* __restrict__ offsets,
                            const int* __restrict__ ids, const double2* __restrict__ table,
                            double2* __restrict__ partial, int num_coeff, int chunks) {
  asm volatile("griddepcontrol.launch_dependents;");
  asm volatile("griddepcontrol.wait;" ::: "memory");  // the table is done and visible
  const int f = ids[blockIdx.x];
  const long long o = offsets[f];
  const int n = static_cast<int>(offsets[f + 1] - o);
  const int k = num_coeff < n ? num_coeff : n;
  const int j0 = blockIdx.y * blockDim.x;
  if (j0 >= n) return;
  const int count = n - j0 < static_cast<int>(blockDim.x) ? n - j0 : static_cast<int>(blockDim.x);
  const int2* z = reinterpret_cast<const int2*>(points) + o + j0;
  const double2* w = table + o;
  double2* row = partial + (static_cast<long long>(blockIdx.x) * chunks + blockIdx.y) * 2 * num_coeff;
  const int lane = threadIdx.x & 31;
  for (int l = threadIdx.x >> 5; l < 2 * k; l += blockDim.x >> 5) {
    const int m = line_index(l, k, n);
    long long r = static_cast<long long>(m) * (j0 + lane) % n;
    const int step = static_cast<int>(static_cast<long long>(m) * 32 % n);
    double2 a = make_double2(0.0, 0.0);
    for (int j = lane; j < count; j += 32) {
      const int2 p = __ldg(z + j);
      mac(a, make_double2(p.x, p.y), w[r], false);
      r += step;
      if (r >= n) r -= n;
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      a.x += __shfl_down_sync(0xffffffffu, a.x, d);
      a.y += __shfl_down_sync(0xffffffffu, a.y, d);
    }
    if (lane == 0) row[l] = a;
  }
}

// A long contour's direct reconstruction: grid (contours, chunks of points);
// each block adds the chunks' partial sums into the lines (in chunk
// order), chunk 0 writes them, then a thread a point
__global__ void __launch_bounds__(LONG_THREADS)
fourier_long_inverse_kernel(const long long* __restrict__ offsets, const long long* __restrict__ line_offsets,
                            const int* __restrict__ ids, const double2* __restrict__ table,
                            const double2* __restrict__ partial, double2* __restrict__ coeffs,
                            double2* __restrict__ recon, int num_coeff, int chunks) {
  __shared__ double2 lines[2 * MAX_COEFF];
  asm volatile("griddepcontrol.wait;" ::: "memory");  // the partial sums are done and visible
  const int f = ids[blockIdx.x];
  const long long o = offsets[f];
  const int n = static_cast<int>(offsets[f + 1] - o);
  if (static_cast<int>(blockIdx.y * blockDim.x) >= n) return;  // the whole block
  const int k = num_coeff < n ? num_coeff : n;
  const int used = (n + blockDim.x - 1) / blockDim.x;
  const double2* rows = partial + static_cast<long long>(blockIdx.x) * chunks * 2 * num_coeff;
  for (int l = threadIdx.x; l < 2 * k; l += blockDim.x) {
    double2 a = rows[l];
    for (int c = 1; c < used; ++c) {
      const double2 p = rows[static_cast<long long>(c) * 2 * num_coeff + l];
      a.x += p.x;
      a.y += p.y;
    }
    if (blockIdx.y == 0) coeffs[line_offsets[f] + l] = a;
    lines[l] = l >= k && l - k < 2 * k - n ? make_double2(0.0, 0.0) : a;
  }
  __syncthreads();
  const int j = blockIdx.y * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const double2* w = table + o;
  double2 a = make_double2(0.0, 0.0);
  long long r = 0;
  for (int l = 0; l < k; ++l) {
    mac(a, lines[l], w[r], true);
    r += j;
    if (r >= n) r -= n;
  }
  r = static_cast<long long>(n - k) * j % n;
  for (int l = k; l < 2 * k; ++l) {
    mac(a, lines[l], w[r], true);
    r += j;
    if (r >= n) r -= n;
  }
  recon[o + j] = make_double2(a.x / n, a.y / n);
}

// glibc's hypot kernel without FMA: ax >= ay >= 0, their squares in range
__device__ __forceinline__ double hypot_kernel(double ax, double ay) {
  const double h = __dsqrt_rn(__dadd_rn(__dmul_rn(ax, ax), __dmul_rn(ay, ay)));
  double t1, t2;
  if (__dadd_rn(ay, ay) >= h) {
    const double delta = __dsub_rn(h, ay);
    t1 = __dmul_rn(__dsub_rn(__dadd_rn(delta, delta), ax), ax);
    const double twice = __dadd_rn(__dsub_rn(ax, ay), __dsub_rn(ax, ay));
    t2 = __dmul_rn(__dsub_rn(delta, twice), delta);
  } else {
    const double delta = __dsub_rn(h, ax);
    t1 = __dmul_rn(__dadd_rn(delta, delta), __dsub_rn(ax, __dadd_rn(ay, ay)));
    t2 = __dadd_rn(__dmul_rn(__dsub_rn(__dmul_rn(4.0, delta), ay), ay), __dmul_rn(delta, delta));
  }
  return __dsub_rn(h, __ddiv_rn(__dadd_rn(t1, t2), __dadd_rn(h, h)));
}

// glibc 2.36's double hypot (sysdeps/ieee754/dbl-64/e_hypot.c as built for
// x86_64): the branches and constants as the library runs them
__device__ __forceinline__ double glibc_hypot(double x, double y) {
  if (isinf(x) || isinf(y)) return __longlong_as_double(0x7ff0000000000000LL);
  if (isnan(x) || isnan(y)) return x + y;
  x = fabs(x);
  y = fabs(y);
  const double ax = x < y ? y : x, ay = x < y ? x : y;
  if (ax > 0x1p+511) {
    if (ay <= __dmul_rn(ax, 0x1p-54)) return __dadd_rn(ax, ay);
    return __dmul_rn(hypot_kernel(__dmul_rn(ax, 0x1p-600), __dmul_rn(ay, 0x1p-600)), 0x1p+600);
  }
  if (ay < 0x1p-459) {
    if (ax >= __dmul_rn(ay, 0x1p+54)) return __dadd_rn(ax, ay);
    return __dmul_rn(hypot_kernel(__dmul_rn(ax, 0x1p+600), __dmul_rn(ay, 0x1p+600)), 0x1p-600);
  }
  if (ay <= __dmul_rn(ax, 0x1p-54)) return __dadd_rn(ax, ay);
  return hypot_kernel(ax, ay);
}

// one leaf of numpy's pairwise_sum: below 8 elements a plain sum from -0.0;
// else 8 accumulators over whole 8-element rows, combined as a tree, then
// the rest one by one
__device__ double pairwise_leaf(const double* a, int m) {
  if (m < 8) {
    double res = -0.0;
    for (int i = 0; i < m; ++i) res = __dadd_rn(res, a[i]);
    return res;
  }
  double r[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) r[q] = a[q];
  int i = 8;
  for (; i < m - m % 8; i += 8) {
#pragma unroll
    for (int q = 0; q < 8; ++q) r[q] = __dadd_rn(r[q], a[i + q]);
  }
  double res = __dadd_rn(__dadd_rn(__dadd_rn(r[0], r[1]), __dadd_rn(r[2], r[3])),
                         __dadd_rn(__dadd_rn(r[4], r[5]), __dadd_rn(r[6], r[7])));
  for (; i < m; ++i) res = __dadd_rn(res, a[i]);
  return res;
}

// numpy's pairwise_sum of a[0..n), n <= REDUCE_CHUNK, by the whole block:
// the recursion halves a range at a multiple of 8 until it holds at most
// PAIRWISE_BLOCK elements (a leaf, at least 64 elements unless n is
// smaller, so at most MAX_LEAVES of them); thread 0 lists the leaves in
// order, the threads sum them, thread 0 combines them as the recursion
// does (an explicit stack, depth <= 7).  Every thread returns the sum.
__device__ double pairwise_sum(const double* a, int n) {
  __shared__ int leaf_start[MAX_LEAVES], leaf_len[MAX_LEAVES];
  __shared__ double leaf_sum[MAX_LEAVES];
  __shared__ int leaves;
  __shared__ double result;
  int start[32], len[32];
  bool open[32];
  if (threadIdx.x == 0) {  // the leaves, left to right
    int sp = 1, count = 0;
    start[0] = 0;
    len[0] = n;
    while (sp > 0) {
      --sp;
      const int s = start[sp], m = len[sp];
      if (m <= PAIRWISE_BLOCK) {
        leaf_start[count] = s;
        leaf_len[count] = m;
        ++count;
      } else {
        const int half = m / 2 - (m / 2) % 8;
        start[sp] = s + half;  // the right half under the left
        len[sp] = m - half;
        ++sp;
        start[sp] = s;
        len[sp] = half;
        ++sp;
      }
    }
    leaves = count;
  }
  __syncthreads();
  for (int l = threadIdx.x; l < leaves; l += blockDim.x) leaf_sum[l] = pairwise_leaf(a + leaf_start[l], leaf_len[l]);
  __syncthreads();
  if (threadIdx.x == 0) {  // the recursion again, the leaves' sums in order
    double value[16];
    int sp = 1, vp = 0, next = 0;
    start[0] = 0;
    len[0] = n;
    open[0] = false;
    while (sp > 0) {
      --sp;
      const int s = start[sp], m = len[sp];
      if (m <= PAIRWISE_BLOCK) {
        value[vp++] = leaf_sum[next++];
      } else if (open[sp]) {  // both halves done: left below right
        const double right = value[--vp];
        const double left = value[--vp];
        value[vp++] = __dadd_rn(left, right);
      } else {
        const int half = m / 2 - (m / 2) % 8;
        open[sp] = true;  // revisit after the halves
        ++sp;
        start[sp] = s + half;
        len[sp] = m - half;
        open[sp] = false;
        ++sp;
        start[sp] = s;
        len[sp] = half;
        open[sp] = false;
        ++sp;
      }
    }
    result = value[0];
  }
  __syncthreads();
  const double out = result;
  __syncthreads();  // result is read before the next call writes it
  return out;
}

// each point's distance to its candidate's nearest edge: grid (candidates,
// chunks of the longest contour), a thread a point walking the edges
// (every lane reads the same vertex: one broadcast load)
__global__ void __launch_bounds__(POLY_THREADS)
polygon_distances_kernel(const int* __restrict__ points, const long long* __restrict__ offsets,
                         const int* __restrict__ verts, const long long* __restrict__ vert_offsets,
                         const long long* __restrict__ owner, const long long* __restrict__ scratch_offsets,
                         double* __restrict__ scratch) {
  const int c = blockIdx.x;
  const long long r = owner[c];
  const long long p0 = offsets[r];
  const int n = static_cast<int>(offsets[r + 1] - p0);
  const int i = blockIdx.y * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long v0 = vert_offsets[c];
  const int nv = static_cast<int>(vert_offsets[c + 1] - v0);
  const int2* poly = reinterpret_cast<const int2*>(verts) + v0;
  const int2 p = reinterpret_cast<const int2*>(points)[p0 + i];
  const double px = p.x, py = p.y;
  double best = __longlong_as_double(0x7ff0000000000000LL);
  int2 a = __ldg(poly);
  for (int e = 0; e < nv; ++e) {
    const int2 b = __ldg(poly + (e + 1 == nv ? 0 : e + 1));
    const double x0 = a.x, y0 = a.y;
    const double dx = __dsub_rn(static_cast<double>(b.x), x0), dy = __dsub_rn(static_cast<double>(b.y), y0);
    const double denom = __dadd_rn(__dmul_rn(dx, dx), __dmul_rn(dy, dy));
    double t = 0.0;
    if (denom != 0.0) {
      const double v = __ddiv_rn(__dadd_rn(__dmul_rn(__dsub_rn(px, x0), dx), __dmul_rn(__dsub_rn(py, y0), dy)),
                                 denom);
      const double lo = v < 1.0 ? v : 1.0;  // min(1.0, v)
      t = lo > 0.0 ? lo : 0.0;              // max(0.0, lo)
    }
    const double qx = __dadd_rn(x0, __dmul_rn(t, dx)), qy = __dadd_rn(y0, __dmul_rn(t, dy));
    const double d = glibc_hypot(__dsub_rn(px, qx), __dsub_rn(py, qy));
    if (d < best) best = d;
    a = b;
  }
  scratch[scratch_offsets[c] + i] = best;
}

// each candidate's mean: a block a candidate, its distances summed in
// numpy's order (chunks of REDUCE_CHUNK added in order), divided by n
__global__ void __launch_bounds__(POLY_THREADS)
polygon_means_kernel(const long long* __restrict__ offsets, const long long* __restrict__ owner,
                     const long long* __restrict__ scratch_offsets, const double* __restrict__ scratch,
                     double* __restrict__ out) {
  const int c = blockIdx.x;
  const long long r = owner[c];
  const int n = static_cast<int>(offsets[r + 1] - offsets[r]);
  const double* dist = scratch + scratch_offsets[c];
  double total = 0.0;
  for (int s = 0; s < n; s += REDUCE_CHUNK) {
    const double part = pairwise_sum(dist + s, n - s < REDUCE_CHUNK ? n - s : REDUCE_CHUNK);
    total = s == 0 ? part : __dadd_rn(total, part);
  }
  if (threadIdx.x == 0) out[c] = __ddiv_rn(total, static_cast<double>(n));
}

}  // namespace

// bytes: the dynamic shared memory a block of the current device may opt
// into (what a contour's block route must fit).
extern "C" int yam_fourier_shared_limit(int* bytes) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return static_cast<int>(err);
}

// points: (P, 2) int32 (x, y); offsets: (F + 1) int64 of the F contours;
// line_offsets: (F + 1) int64, contour f's 2k lines at line_offsets[f];
// plan: (F, PLAN) int32, a contour's route (1 FFT), stage count and
// radices; block_ids: the nblock contours of the block route, which need
// shared bytes of dynamic shared memory at most; long_ids: the nfft long
// contours of the FFT route, then the ndirect of the direct route, the
// longest long_n points and max_stages stages (radices at most
// MAX_LONG_RADIX); table: (P, 2) float64 and
// work (2P, 2) float64 scratch; partial: (ndirect, chunks, 2 num_coeff, 2)
// float64 scratch, chunks = ceil(long_n / LONG_THREADS); coeffs:
// (line_offsets[F], 2) float64; recon: (P, 2) float64.  Launches: the
// block route's one; for long contours the table, then 2 max_stages
// stages, then the direct route's partial sums and reconstruction.
extern "C" int yam_fourier_lines(const void* points, const void* offsets, const void* line_offsets,
                                 const void* plan, const void* block_ids, int nblock, int shared,
                                 const void* long_ids, int nfft, int ndirect, int long_n, int max_stages,
                                 void* table, void* work, void* partial, void* coeffs, void* recon, long long total,
                                 int num_coeff, void* stream) {
  if (num_coeff < 1 || num_coeff > MAX_COEFF || nblock < 0 || nfft < 0 || ndirect < 0 || max_stages < 0 ||
      shared < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* pts = static_cast<const int*>(points);
  const long long* o = static_cast<const long long*>(offsets);
  const long long* lo = static_cast<const long long*>(line_offsets);
  const int* pl = static_cast<const int*>(plan);
  double2* c = static_cast<double2*>(coeffs);
  double2* rc = static_cast<double2*>(recon);
  if (nblock > 0) {
    cudaError_t err = cudaFuncSetAttribute(fourier_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
    if (err != cudaSuccess) return static_cast<int>(err);
    fourier_block_kernel<<<nblock, BLOCK_THREADS, shared, st>>>(pts, o, lo, pl, static_cast<const int*>(block_ids),
                                                                c, rc, num_coeff);
  }
  const int nlong = nfft + ndirect;
  if (nlong > 0) {
    const int chunks = (long_n + LONG_THREADS - 1) / LONG_THREADS;
    const int stage_blocks = (long_n + LONG_THREADS / 2 - 1) / (LONG_THREADS / 2);  // n / (R per) < n / 64
    if (long_n < 1 || stage_blocks > 65535) return static_cast<int>(cudaErrorInvalidValue);
    const int* ids = static_cast<const int*>(long_ids);
    const int* direct_ids = ids + nfft;
    double2* w = static_cast<double2*>(table);
    double2* wk = static_cast<double2*>(work);
    double2* part = static_cast<double2*>(partial);
    // each launch by programmatic dependent launch: its blocks start while
    // the launch before runs and wait (griddepcontrol.wait) for it to end
    cudaLaunchAttribute early;
    early.id = cudaLaunchAttributeProgrammaticStreamSerialization;
    early.val.programmaticStreamSerializationAllowed = 1;
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(nlong, chunks);
    config.blockDim = dim3(LONG_THREADS);
    config.stream = st;
    config.attrs = &early;
    config.numAttrs = 1;
    cudaError_t err = cudaSuccess;
    config.gridDim = dim3(nfft, stage_blocks);
    config.blockDim = dim3(STAGE_THREADS);
    config.dynamicSmemBytes = 2 * MAX_LONG_RADIX * sizeof(double2);
    for (int inverse = 0; err == cudaSuccess && nfft > 0 && inverse < 2; ++inverse)
      for (int s = 0; err == cudaSuccess && s < max_stages; ++s)
        err = cudaLaunchKernelEx(&config, fourier_long_stage_kernel, pts, o, lo, pl, ids, w, wk, c, rc, total,
                                 num_coeff, s, inverse);
    config.gridDim = dim3(ndirect, chunks);
    config.blockDim = dim3(LONG_THREADS);
    config.dynamicSmemBytes = 0;
    if (err == cudaSuccess && ndirect > 0) err = cudaLaunchKernelEx(&config, fourier_table_kernel, o, direct_ids, w);
    if (err == cudaSuccess && ndirect > 0)
      err = cudaLaunchKernelEx(&config, fourier_long_partial_kernel, pts, o, direct_ids,
                               static_cast<const double2*>(w), part, num_coeff, chunks);
    if (err == cudaSuccess && ndirect > 0)
      err = cudaLaunchKernelEx(&config, fourier_long_inverse_kernel, o, lo, direct_ids, static_cast<const double2*>(w),
                               static_cast<const double2*>(part), c, rc, num_coeff, chunks);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

// points: (P, 2) int32; offsets: (R + 1) int64, the longest contour max_n
// points; verts: (V, 2) int32; vert_offsets: (C + 1) int64; owner: (C)
// int64, each candidate's contour; scratch_offsets: (C + 1) int64, the
// candidates' contour lengths scanned; scratch: float64 of
// scratch_offsets[C]; out: (C) float64.  Two launches: the distances, the
// means.
extern "C" int yam_polygon_errors(const void* points, const void* offsets, const void* verts,
                                  const void* vert_offsets, const void* owner, const void* scratch_offsets,
                                  void* scratch, void* out, int candidates, int max_n, void* stream) {
  if (candidates < 1 || max_n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned chunks = static_cast<unsigned>((max_n + POLY_THREADS - 1) / POLY_THREADS);
  if (chunks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long* o = static_cast<const long long*>(offsets);
  const long long* ow = static_cast<const long long*>(owner);
  const long long* so = static_cast<const long long*>(scratch_offsets);
  double* d = static_cast<double*>(scratch);
  polygon_distances_kernel<<<dim3(candidates, chunks), POLY_THREADS, 0, st>>>(
      static_cast<const int*>(points), o, static_cast<const int*>(verts),
      static_cast<const long long*>(vert_offsets), ow, so, d);
  polygon_means_kernel<<<candidates, POLY_THREADS, 0, st>>>(o, ow, so, d, static_cast<double*>(out));
  return static_cast<int>(cudaGetLastError());
}
