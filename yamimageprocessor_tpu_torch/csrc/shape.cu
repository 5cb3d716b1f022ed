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
// comparisons, the minimum over the edges, the distance by glibc 2.36's
// hypot as the x86_64 library is built (no FMA: the corrected square root
// of Borges' MyHypot3, its scaling branches), and the sum in numpy's
// pairwise order (chunks of 8192 added in order, each summed pairwise down
// to leaves of at most 128 with 8 accumulators) divided by n.  Bound on the
// card (chip_smoke.py:polygon_bound): a compare and the numerator's
// operations a (candidate, point, edge) to rule an edge out, one division
// and hypot a (candidate, point).  Design: one launch of warps over
// (candidate, leaf) work; each candidate's edge constants staged once; a
// cheap pass over the edges picks the one edge whose exact distance is the
// minimum (a margin proven below), so the division and the hypot run once
// a point; the leaf summed where its distances are; no scratch in device
// memory.  Details above the kernels.

#include <cooperative_groups.h>
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int BLOCK_THREADS = 256;  // a contour's block on the shared-memory route
constexpr int LONG_THREADS = 128;   // a chunk of a long contour's points; a stage block's butterflies' inputs
constexpr int STAGE_THREADS = 512;  // a stage block: several lanes an output where its butterflies are few
constexpr int PLAN = 34;            // a contour's plan: FFT or direct, the stage count, the radices
constexpr int MAX_LONG_RADIX = 1024;  // a long contour's stage radix at most (ops/fourier.py:route keeps it below)
constexpr int MAX_COEFF = 512;      // the schema's largest num_coeff
constexpr int PAIRWISE_BLOCK = 128;
constexpr int REDUCE_CHUNK = 8192;
constexpr int MAX_LEAVES = REDUCE_CHUNK / 64;  // a chunk's leaves: each holds at least 64 elements

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

// ---------------------------------------------------------------------------
// The mean boundary errors.  Work: a warp takes a (candidate, leaf of
// numpy's pairwise tree), a leaf's 64-128 points in rounds of 32 (lane l the
// points l, l + 32, ...); the leaf's sum is formed where its distances are
// (a warp's buffer in shared memory), and the leaves' sums of a chunk are
// added level by level in the recursion's order (ops/polygon.py:leaf_plan,
// a table a distinct chunk length built on the host).  Block route
// (contours of at most ops/polygon.py:CLUSTER_POINTS points, one chunk): a
// block of BLOCK_WARPS warps holds a run of consecutive candidates of one
// leaf count, BLOCK_WARPS / L of them (ops/polygon.py:ErrorsLaunch), their
// edge constants and combine programs staged once in shared memory, a warp
// a leaf, then a warp a candidate's combine.
// Cluster route (longer contours): a cluster of CLUSTER_BLOCKS blocks a
// candidate, each staging the edges; chunk by chunk, every warp of the
// cluster takes leaves and writes their sums into the leader's shared
// memory (two buffers, alternate chunks), a cluster barrier, the leader's
// first warp combines the chunk and adds it to the total in order.
//
// The distance of a point to its nearest edge, bit for bit the reference's
// minimum over the edges of hypot(px - qx, py - qy): a cheap pass over the
// edges, then the reference's operations on the one feature that holds the
// minimum.  The cheap pass forms, for each edge, the reference's own
// classification of t (num <= 0: t = 0, the edge's first vertex; num >=
// denom: t = 1, its second; else the interior), a value q of the squared
// distance (a vertex's (px - x)^2 + (py - y)^2, exact; the interior's
// cross^2 * (1 / denom), three roundings) and a feature (2v for vertex v,
// 2e + 1 for edge e's interior: the two edges at a vertex clamped to it
// give one feature and one distance).  It keeps the least q (b1, feature
// f1) and the least q of any other feature (b2).  Where b2 > T = b1 (1 +
// 2^-18) + 2^-76 M^2 (M the largest coordinate magnitude of the point and
// the candidate's vertices) only f1 can hold the minimum, and its exact
// distance is the result; else (ties, such as a two-vertex polygon's two
// edges) every edge is evaluated exactly.  The pass runs in float32 where
// the candidate spans less than SPAN_LIMIT = 2^11 and each point of the
// warp's round lies within 2^11 of every vertex (differences below 2^11:
// the products below 2^22, num, cross, denom and the vertices' q below
// 2^23, all exact in float32; the inside's q three roundings of 2^-24), in
// float64 elsewhere.
//
// The margin, for |coordinates| <= M <= 2^24 (FILTER_LIMIT), u = 2^-53:
// px - x0, dx, num = (px - x0) dx + (py - y0) dy, cross, denom and the
// vertices' q are integers below 2^51, exact (FMAs or not), so the
// classification is the reference's.  With D_e the true distance to the
// segment, the reference's d_e is D_e (1 +- 2u) where t is clamped (hypot
// of exact integers, glibc within an ulp); inside, t = num / denom (1 +
// d1), qx = (x0 + t dx (1 + d2)) (1 + d3) is within 7.001 u M of x0 + (num
// / denom) dx (|x0| <= M, |dx| <= 2M), px - qx rounds once more and hypot
// once, so d_e lies in [D_e (1 - 3.0001u) - A, D_e (1 + 3.0001u) + A], A =
// sqrt(2) 7.001 u M (1 + 3.0001u) <= 10 u M; and q_e = D_e^2 (1 +-
// 3.0001u).  For e* with d_e* minimal and any edge f, d_e* <= d_f gives
// D_e* <= (D_f (1 + r) + 2A) / (1 - r), r = 3.0001u; with (a + b)^2 <= (1
// + g) a^2 + (1 + 1/g) b^2, g = 2^-20: q_e* <= (1 + 2^-19) q_f + 2^-77 M^2.
// T doubles both terms, which covers its own two roundings (M^2 and the
// power of two are exact), so q_e* <= T(q_f): the edge holding the minimum
// has q within T of b1, and if no other feature's does, it is f1's.  In
// float32 the inside's q is D_e^2 (1 +- 3.0001 2^-24), and the first
// factor becomes (1 + 2^-20)(1 + 6.0003 2^-24 + 13u) <= 1 + 2^-19 still;
// b1 and b2 convert to float64 exactly and T is formed as above.  A point
// or candidate past 2^24 takes the exact loop over every edge.
//
// The division is skipped where the clamp decides t exactly: num <= 0
// (denom == 0 included: then num is +-0) makes num / denom <= 0, so t =
// max(0, min(1, .)) = 0; num >= denom > 0 makes num / denom >= 1, and
// round-to-nearest is monotone with 1 representable, so the quotient
// rounds to >= 1 and t = 1.  Otherwise t = num / denom as the reference.

constexpr int BLOCK_WARPS = 4;  // a block route block's warps: ops/polygon.py:BLOCK_WARPS
constexpr int CLUSTER_WARPS = 8;  // a cluster route block's warps
constexpr int CLUSTER_BLOCKS = 8;  // ops/polygon.py:CLUSTER_BLOCKS
constexpr int CAND_FIELDS = 8;     // ops/polygon.py:CAND_FIELDS
// 64 registers a thread at most, so that an SM holds 32 warps of either route
constexpr int BLOCK_MIN_BLOCKS = 8, CLUSTER_MIN_BLOCKS = 4;
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned FILTER_LIMIT = 1u << 24;
constexpr int SPAN_LIMIT = 1 << 11;  // the float32 pass: coordinates this close to every vertex
constexpr double FILTER_REL = 1.0 + 0x1p-18;
constexpr double FILTER_ABS = 0x1p-76;

// an edge's constants, the reference's operations: 64 bytes (ops/polygon.py:EDGE_BYTES)
struct Edge {
  double dx, dy, den, inv, x0, y0;
  float fdx, fdy, fden, finv;  // the same in float32: exact on a small candidate (SPAN_LIMIT)
};

__device__ __forceinline__ unsigned uabs(int v) { return v < 0 ? 0u - static_cast<unsigned>(v) : v; }

// a candidate's record: the table holds the records field by field (field
// k of record j at k * stride + j, stride the candidates)
struct Rec {
  const long long* p;
  long long stride;
  __device__ __forceinline__ long long operator[](int k) const { return p[k * stride]; }
};

// edge e of a polygon of nv vertices, (x0, y0) -> the next vertex
__device__ __forceinline__ Edge form_edge(const int2* poly, int nv, int e) {
  const int2 a = __ldg(poly + e), b = __ldg(poly + (e + 1 == nv ? 0 : e + 1));
  Edge E;
  E.x0 = a.x;
  E.y0 = a.y;
  E.dx = __dsub_rn(static_cast<double>(b.x), E.x0);
  E.dy = __dsub_rn(static_cast<double>(b.y), E.y0);
  E.den = __dadd_rn(__dmul_rn(E.dx, E.dx), __dmul_rn(E.dy, E.dy));
  E.inv = __drcp_rn(E.den);
  E.fdx = static_cast<float>(static_cast<long long>(b.x) - a.x);
  E.fdy = static_cast<float>(static_cast<long long>(b.y) - a.y);
  E.fden = __fmaf_rn(E.fdx, E.fdx, __fmul_rn(E.fdy, E.fdy));
  E.finv = __frcp_rn(E.fden);
  return E;
}

// the reference's distance of (px, py) to one edge, the division skipped
// where the clamp decides t (the proof above)
__device__ __forceinline__ double edge_distance(double px, double py, const Edge& E) {
  const double num = __dadd_rn(__dmul_rn(__dsub_rn(px, E.x0), E.dx), __dmul_rn(__dsub_rn(py, E.y0), E.dy));
  const double t = num <= 0.0 ? 0.0 : num >= E.den ? 1.0 : __ddiv_rn(num, E.den);
  const double qx = __dadd_rn(E.x0, __dmul_rn(t, E.dx)), qy = __dadd_rn(E.y0, __dmul_rn(t, E.dy));
  return glibc_hypot(__dsub_rn(px, qx), __dsub_rn(py, qy));
}

// glibc's hypot where neither scaling branch can be taken: ax <= 2^511,
// and ay either 0 or at least 2^-459.  Both of the kernel's corrections are
// formed and one selected, and ax + ay where ay <= ax 2^-54 (glibc's tiny
// branch gives the same for ay == 0), so a warp's lanes never diverge.  The
// root and the division never see 0 (their slow paths): where ax + ay is
// the result the root takes 1, and a zero correction c leaves h (h - 0 /
// 2h), so the division takes 1 there; where neither, ay > 0 and the
// quotient is at least 2^-157 (ay >= 2^-104).
__device__ __forceinline__ double hypot_in_range(double x, double y) {
  x = fabs(x);
  y = fabs(y);
  const double ax = x < y ? y : x, ay = x < y ? x : y;
  const bool plain = ay <= __dmul_rn(ax, 0x1p-54);
  const double h = __dsqrt_rn(plain ? 1.0 : __dadd_rn(__dmul_rn(ax, ax), __dmul_rn(ay, ay)));
  const double d1 = __dsub_rn(h, ay), twice = __dadd_rn(__dsub_rn(ax, ay), __dsub_rn(ax, ay));
  const double near = __dadd_rn(__dmul_rn(__dsub_rn(__dadd_rn(d1, d1), ax), ax), __dmul_rn(__dsub_rn(d1, twice), d1));
  const double d2 = __dsub_rn(h, ax);
  const double far = __dadd_rn(__dmul_rn(__dadd_rn(d2, d2), __dsub_rn(ax, __dadd_rn(ay, ay))),
                               __dadd_rn(__dmul_rn(__dsub_rn(__dmul_rn(4.0, d2), ay), ay), __dmul_rn(d2, d2)));
  const double c = __dadd_rn(ay, ay) >= h ? near : far;
  const double r = c == 0.0 ? h : __dsub_rn(h, __ddiv_rn(c == 0.0 ? 1.0 : c, __dadd_rn(h, h)));
  return plain ? __dadd_rn(ax, ay) : r;
}

// The reference's distance for a feature of the cheap pass, within the
// filter's range and without a branch: the inside of edge E (0 < num <
// denom as the pass classified it, num exact there: t = num / denom), or
// the vertex E begins (t = 0: qx = x0, the same bits as t = 1 on the edge
// it ends, both exact integers; the quotient then formed from 1 / 2, so the
// division's slow path for a zero quotient never runs).  The differences
// px - qx are 0 or at least 2^-104 in magnitude (qx is x0 or x0 + t dx with
// t >= 2^-51, rounded, at most 2^25) and at most 2^26, so hypot_in_range is
// glibc's hypot on them.
__device__ __forceinline__ double feature_distance(double px, double py, const Edge& E, bool inside) {
  const double num = __dadd_rn(__dmul_rn(__dsub_rn(px, E.x0), E.dx), __dmul_rn(__dsub_rn(py, E.y0), E.dy));
  const double v = __ddiv_rn(inside ? num : 1.0, inside ? E.den : 2.0);
  const double t = inside ? v : 0.0;
  const double qx = __dadd_rn(E.x0, __dmul_rn(t, E.dx)), qy = __dadd_rn(E.y0, __dmul_rn(t, E.dy));
  return hypot_in_range(__dsub_rn(px, qx), __dsub_rn(py, qy));
}

// every edge in order, exactly (the running minimum): from the staged
// constants, or formed from the vertices where the candidate is not staged
__device__ double exact_distance(double px, double py, const Edge* edges, const int2* poly, int nv) {
  double best = __longlong_as_double(0x7ff0000000000000LL);
  for (int e = 0; e < nv; ++e) {
    const double d = edge_distance(px, py, edges != nullptr ? edges[e] : form_edge(poly, nv, e));
    if (d < best) best = d;
  }
  return best;
}

// The cheap pass over the edges for a lane's point, in T (float or
// double): (ex, ey) = P - the edge's first vertex, carried to the next edge
// exactly (ex - dx), and that vertex's q with it; each edge's
// classification of t, q and feature (2v a vertex, 2e + 1 an edge's
// inside); the least q (b1, feature f1) and the least q of any other
// feature (b2), their compares on the bits (the integer order is the
// floating order on values >= +0; num <= 0 is its sign or +0, and where
// num is -0 against denom +0 the first test already decides).  In double
// every value below is exact within FILTER_LIMIT but the inside's q; in
// float within SPAN_LIMIT of every vertex (the products below 2^22, the
// sums below 2^23), its q (3 roundings of 2^-24) within the same margin.
template <typename T>
struct Pass;
template <>
struct Pass<double> {
  using Bits = long long;
  static __device__ __forceinline__ double convert(double v) { return v; }
  static __device__ __forceinline__ Bits bits(double v) { return __double_as_longlong(v); }
  static __device__ __forceinline__ double value(Bits b) { return __longlong_as_double(b); }
  static __device__ __forceinline__ double2 d(const Edge& E) { return make_double2(E.dx, E.dy); }
  static __device__ __forceinline__ double2 r(const Edge& E) { return make_double2(E.den, E.inv); }
  static __device__ __forceinline__ double fma(double a, double b, double c) { return __fma_rn(a, b, c); }
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
};
template <>
struct Pass<float> {
  using Bits = int;
  static __device__ __forceinline__ float convert(double v) { return static_cast<float>(v); }
  static __device__ __forceinline__ Bits bits(float v) { return __float_as_int(v); }
  static __device__ __forceinline__ double value(Bits b) { return __int_as_float(b); }
  static __device__ __forceinline__ float2 d(const Edge& E) { return make_float2(E.fdx, E.fdy); }
  static __device__ __forceinline__ float2 r(const Edge& E) { return make_float2(E.fden, E.finv); }
  static __device__ __forceinline__ float fma(float a, float b, float c) { return __fmaf_rn(a, b, c); }
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
};

template <typename T>
__device__ __forceinline__ void cheap_pass(const Edge* edges, int nv, double px, double py, double& b1, double& b2,
                                           int& f1) {
  using P = Pass<T>;
  using Bits = typename P::Bits;
  T ex = P::convert(__dsub_rn(px, edges[0].x0)), ey = P::convert(__dsub_rn(py, edges[0].y0));
  T qv = P::fma(ex, ex, P::mul(ey, ey));
  Bits l1 = P::bits(P::convert(__longlong_as_double(0x7ff0000000000000LL))), l2 = l1;  // +inf
  f1 = -1;
  for (int e = 0; e < nv; ++e) {
    const auto d = P::d(edges[e]);  // dx, dy
    const auto r = P::r(edges[e]);  // denom, 1 / denom
    const int next = e + 1 == nv ? 0 : e + 1;
    const T num = P::fma(ex, d.x, P::mul(ey, d.y));
    const T cross = P::fma(ex, d.y, -P::mul(ey, d.x));
    const T exn = P::sub(ex, d.x), eyn = P::sub(ey, d.y);
    const T qn = P::fma(exn, exn, P::mul(eyn, eyn));
    const T qi = P::mul(P::mul(cross, cross), r.y);
    const Bits nb = P::bits(num);
    const bool first = nb <= 0, second = nb >= P::bits(r.x);
    const Bits q = P::bits(first ? qv : second ? qn : qi);
    const int f = first ? 2 * e : second ? 2 * next : 2 * e + 1;
    const bool other = f != f1, take = other && q < l1;
    l2 = take ? l1 : other ? min(l2, q) : l2;
    l1 = take ? q : l1;
    f1 = take ? f : f1;
    ex = exn;
    ey = eyn;
    qv = qn;
  }
  b1 = P::value(l1);
  b2 = P::value(l2);
}

// a warp: the distance of the leaf's point base + lane into buf (a round; m
// the leaf's length): the cheap pass over the edges (in float where the
// candidate spans less than SPAN_LIMIT and every point of the round lies
// within it of each vertex, else in double), then one exact feature.
// edges: the candidate's staged constants or nullptr; vmax: the largest
// magnitude of its vertices' coordinates; box: their least and largest x
// and y.
__device__ __forceinline__ void round_distance(const int2* pts, int m, int base, const Edge* edges,
                                               const int2* poly, int nv, unsigned vmax, int4 box, double* buf) {
  const int i = base + (threadIdx.x & 31);
  const int2 p = i < m ? __ldg(pts + i) : make_int2(0, 0);
  const double px = p.x, py = p.y;
  const bool filtered = i < m && edges != nullptr && max(max(uabs(p.x), uabs(p.y)), vmax) <= FILTER_LIMIT;
  const bool near = static_cast<long long>(box.z) - box.x < SPAN_LIMIT &&
                    static_cast<long long>(box.w) - box.y < SPAN_LIMIT &&
                    (!filtered || (abs(p.x - box.x) < SPAN_LIMIT && abs(p.x - box.z) < SPAN_LIMIT &&
                                   abs(p.y - box.y) < SPAN_LIMIT && abs(p.y - box.w) < SPAN_LIMIT));
  double b1 = __longlong_as_double(0x7ff0000000000000LL), b2 = b1;
  int f1 = -1;  // the least q's feature
  if (__any_sync(FULL, filtered)) {
    if (__all_sync(FULL, near))
      cheap_pass<float>(edges, nv, px, py, b1, b2, f1);
    else
      cheap_pass<double>(edges, nv, px, py, b1, b2, f1);
  }
  // the one feature the filter decides, without a branch; else every edge
  // exactly
  const double big = fmax(fmax(fabs(px), fabs(py)), static_cast<double>(vmax));
  const bool one = filtered && b2 > __dadd_rn(__dmul_rn(b1, FILTER_REL), __dmul_rn(FILTER_ABS, __dmul_rn(big, big)));
  double d = 0.0;
  if (edges != nullptr) d = feature_distance(px, py, edges[one ? f1 >> 1 : 0], one && (f1 & 1));
  if (i < m) buf[i] = one ? d : exact_distance(px, py, edges, poly, nv);
}

// a warp: the distances of a leaf's m <= PAIRWISE_BLOCK points into buf
// (rounds of round_distance), then the leaf's sum as numpy's pairwise_sum
// forms it: below 8 elements a plain sum from -0.0; else 8 accumulators
// r[q] = a[q] + a[q + 8] + ... over the whole 8-element rows (lanes 0-7
// each run one), combined ((r0 + r1) + (r2 + r3)) + ((r4 + r5) + (r6 +
// r7)) by shuffles, then the m % 8 rest in order.  Lane 0 returns the sum.
__device__ double leaf_sum(const int2* pts, int m, const Edge* edges, const int2* poly, int nv, unsigned vmax,
                           int4 box, double* buf) {
  const int lane = threadIdx.x & 31;
  for (int base = 0; base < m; base += 32) round_distance(pts, m, base, edges, poly, nv, vmax, box, buf);
  __syncwarp();
  double s;
  if (m < 8) {
    s = -0.0;
    if (lane == 0)
      for (int i = 0; i < m; ++i) s = __dadd_rn(s, buf[i]);
  } else {
    const int rows = m - m % 8;
    double r = 0.0;
    if (lane < 8) {
      r = buf[lane];
      for (int i = 8 + lane; i < rows; i += 8) r = __dadd_rn(r, buf[i]);
    }
    r = __dadd_rn(r, __shfl_down_sync(FULL, r, 1));  // lanes 0, 2, 4, 6: r[q] + r[q + 1]
    r = __dadd_rn(r, __shfl_down_sync(FULL, r, 2));  // lanes 0, 4
    s = __dadd_rn(r, __shfl_down_sync(FULL, r, 4));  // lane 0
    if (lane == 0)
      for (int i = rows; i < m; ++i) s = __dadd_rn(s, buf[i]);
  }
  __syncwarp();  // buf is read before the warp's next leaf writes it
  return s;
}

// a chunk's sum from its L leaves' sums, level by level as ops/polygon.py:
// leaf_plan lists them (bounds: the H + 1 level bounds, op: the L - 1
// sums; a height's sums at once, a lane each); node: the warp's scratch for
// the sums.  Every lane returns the root.
__device__ double combine(int L, int H, const long long* bounds, const long long* op, const double* leaf,
                          double* node) {
  const int lane = threadIdx.x & 31;
  for (int h = 0; h < H; ++h) {
    for (int k = static_cast<int>(bounds[h]) + lane; k < bounds[h + 1]; k += 32) {
      const int a = static_cast<int>(op[k] & 0xffff), b = static_cast<int>(op[k] >> 16);
      node[k] = __dadd_rn(a < L ? leaf[a] : node[a - L], b < L ? leaf[b] : node[b - L]);
    }
    __syncwarp();
  }
  return L == 1 ? leaf[0] : node[L - 2];
}

// leaf l of a chunk's plan: its start and length
__device__ __forceinline__ int2 leaf_bounds(const long long* plan, int l) {
  const int m = static_cast<int>(plan[0]), L = static_cast<int>(plan[1]), H = static_cast<int>(plan[2]);
  const long long* start = plan + 4 + H;
  const int s = static_cast<int>(start[l]);
  return make_int2(s, (l + 1 < L ? static_cast<int>(start[l + 1]) : m) - s);
}

// the block route: block b takes the records bounds[b] .. bounds[b + 1] - 1
// (at most BLOCK_WARPS), and their leaves in order: leaf t of the block is
// leaf t - base of the candidate whose leaves begin at base
__global__ void __launch_bounds__(32 * BLOCK_WARPS, BLOCK_MIN_BLOCKS)
polygon_block_kernel(const int2* __restrict__ points, const int2* __restrict__ verts,
                     const long long* __restrict__ recs, long long stride, const long long* __restrict__ bounds,
                     const long long* __restrict__ plans, double* __restrict__ out) {
  extern __shared__ double2 edge_sh[];
  Edge* staged = reinterpret_cast<Edge*>(edge_sh);
  __shared__ double leaf[MAX_LEAVES];
  __shared__ double buf[BLOCK_WARPS][PAIRWISE_BLOCK];
  __shared__ long long first_vertex[MAX_LEAVES];  // a block holds fewer candidates than leaves
  __shared__ int vertices[MAX_LEAVES], slot[MAX_LEAVES];
  __shared__ unsigned vmax[MAX_LEAVES];
  __shared__ int4 box[MAX_LEAVES];  // a candidate's vertices' least and largest x and y
  __shared__ long long program[BLOCK_WARPS][MAX_LEAVES + 8];  // a warp's candidate's level bounds and sums
  __shared__ int2 shape[BLOCK_WARPS];                          // and its leaves and height
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long rb = bounds[blockIdx.x], re = bounds[blockIdx.x + 1];
  // a block holds at most BLOCK_WARPS candidates (ops/polygon.py:ErrorsLaunch): a
  // warp stages one candidate's edges and program, and combines it
  for (long long j = rb + warp; j < re; j += BLOCK_WARPS) {
    const Rec rec{recs + j, stride};
    const int2* poly = verts + rec[3];
    const int nv = static_cast<int>(rec[4]), at = static_cast<int>(rec[5]);
    const long long* plan = plans + rec[6];
    const int L = static_cast<int>(plan[1]), H = static_cast<int>(plan[2]);
    for (int k = lane; k < H + L; k += 32) program[warp][k] = plan[k < H + 1 ? 3 + k : 3 + L + k];
    shape[warp] = make_int2(L, H);
    unsigned big = 0;
    int4 span = make_int4(INT_MAX, INT_MAX, INT_MIN, INT_MIN);
    for (int e = lane; e < nv; e += 32) {
      const int2 a = __ldg(poly + e);
      big = max(big, max(uabs(a.x), uabs(a.y)));
      span = make_int4(min(span.x, a.x), min(span.y, a.y), max(span.z, a.x), max(span.w, a.y));
      if (at >= 0) staged[at + e] = form_edge(poly, nv, e);
    }
    big = __reduce_max_sync(FULL, big);
    span = make_int4(__reduce_min_sync(FULL, span.x), __reduce_min_sync(FULL, span.y),
                     __reduce_max_sync(FULL, span.z), __reduce_max_sync(FULL, span.w));
    if (lane == 0) {
      vmax[j - rb] = big;
      box[j - rb] = span;
      first_vertex[j - rb] = rec[3];
      vertices[j - rb] = nv;
      slot[j - rb] = at;
    }
  }
  __syncthreads();
  const int cands = static_cast<int>(re - rb);
  int leaves = 0, mine = 0;  // the block's leaves; those before this warp's candidate
  for (int j = 0; j < cands; ++j) {
    mine = j == warp ? leaves : mine;
    leaves += shape[j].x;
  }
  for (int t = warp; t < leaves; t += BLOCK_WARPS) {  // a warp a leaf
    int j = 0, base = 0;
    while (t >= base + shape[j].x) base += shape[j++].x;
    const Rec rec{recs + rb + j, stride};
    const int2 range = leaf_bounds(plans + rec[6], t - base);
    const double sum = leaf_sum(points + rec[1] + range.x, range.y, slot[j] >= 0 ? staged + slot[j] : nullptr,
                                verts + first_vertex[j], vertices[j], vmax[j], box[j], buf[warp]);
    if (lane == 0) leaf[t] = sum;
  }
  __syncthreads();
  for (long long j = rb + warp; j < re; j += BLOCK_WARPS) {  // a warp a candidate's tree
    const Rec rec{recs + j, stride};
    const double total = combine(shape[warp].x, shape[warp].y, program[warp], program[warp] + shape[warp].y + 1,
                                 leaf + mine, buf[warp]);
    if (lane == 0) out[rec[0]] = __ddiv_rn(total, static_cast<double>(rec[2]));
  }
}

// the cluster route: cluster k takes the candidate of record k
__global__ void __launch_bounds__(32 * CLUSTER_WARPS, CLUSTER_MIN_BLOCKS)
polygon_cluster_kernel(const int2* __restrict__ points, const int2* __restrict__ verts,
                       const long long* __restrict__ recs, long long stride, const long long* __restrict__ plans,
                       double* __restrict__ out) {
  extern __shared__ double2 edge_sh[];
  Edge* staged = reinterpret_cast<Edge*>(edge_sh);
  __shared__ double leaf[2][MAX_LEAVES];  // the leader's: a chunk's leaf sums, alternate chunks
  __shared__ double buf[CLUSTER_WARPS][PAIRWISE_BLOCK];
  __shared__ unsigned vmax;
  __shared__ int4 box;
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Rec rec{recs + blockIdx.x / CLUSTER_BLOCKS, stride};
  const int2* poly = verts + rec[3];
  const int n = static_cast<int>(rec[2]), nv = static_cast<int>(rec[4]);
  if (threadIdx.x == 0) {
    vmax = 0;
    box = make_int4(INT_MAX, INT_MAX, INT_MIN, INT_MIN);
  }
  __syncthreads();
  unsigned big = 0;
  int4 span = make_int4(INT_MAX, INT_MAX, INT_MIN, INT_MIN);
  for (int e = threadIdx.x; e < nv; e += 32 * CLUSTER_WARPS) {
    const int2 a = __ldg(poly + e);
    big = max(big, max(uabs(a.x), uabs(a.y)));
    span = make_int4(min(span.x, a.x), min(span.y, a.y), max(span.z, a.x), max(span.w, a.y));
    if (rec[5] >= 0) staged[e] = form_edge(poly, nv, e);
  }
  big = __reduce_max_sync(FULL, big);
  span = make_int4(__reduce_min_sync(FULL, span.x), __reduce_min_sync(FULL, span.y),
                   __reduce_max_sync(FULL, span.z), __reduce_max_sync(FULL, span.w));
  if (lane == 0) {
    atomicMax(&vmax, big);
    atomicMin(&box.x, span.x);
    atomicMin(&box.y, span.y);
    atomicMax(&box.z, span.z);
    atomicMax(&box.w, span.w);
  }
  cluster.sync();  // the edges staged, and every block of the cluster running before the leader's memory is written
  const Edge* edges = rec[5] >= 0 ? staged : nullptr;
  double* lead = cluster.map_shared_rank(&leaf[0][0], 0);
  const int chunks = (n + REDUCE_CHUNK - 1) / REDUCE_CHUNK;
  double total = 0.0;
  for (int j = 0; j < chunks; ++j) {
    const long long* plan = plans + (j + 1 < chunks ? rec[6] : rec[7]);
    const int L = static_cast<int>(plan[1]);
    for (int l = static_cast<int>(rank) * CLUSTER_WARPS + warp; l < L; l += CLUSTER_BLOCKS * CLUSTER_WARPS) {
      const int2 range = leaf_bounds(plan, l);
      const double sum = leaf_sum(points + rec[1] + static_cast<long long>(j) * REDUCE_CHUNK + range.x, range.y,
                                  edges, poly, nv, vmax, box, buf[warp]);
      if (lane == 0) lead[(j & 1) * MAX_LEAVES + l] = sum;
    }
    // the chunk's sums in the leader; its first warp combines them before
    // the barrier after the next chunk, the earliest that buffer is reused
    cluster.sync();
    if (rank == 0 && warp == 0) {
      const int H = static_cast<int>(plan[2]);
      const double part = combine(L, H, plan + 3, plan + 4 + H + L, leaf[j & 1], buf[0]);
      total = j == 0 ? part : __dadd_rn(total, part);
    }
  }
  if (rank == 0 && threadIdx.x == 0) out[rec[0]] = __ddiv_rn(total, static_cast<double>(n));
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

// points: (P, 2) int32; verts: (V, 2) int32; table: int64, as
// ops/polygon.py:ErrorsLaunch lays it out: the candidates' records
// (CAND_FIELDS fields, field by field: a field's candidates in route
// order, the block route's nshort, then the cluster route's nlong), the
// block route's record bounds (nblocks + 1), then the chunk plans
// (ops/polygon.py:leaf_plan, a record's plan fields index them);
// block_shared / cluster_shared: the dynamic shared memory of a route's
// block (the edges it stages); out: (candidates) float64.  Launches: the
// block route's (nblocks blocks) and the cluster route's (nlong clusters of
// CLUSTER_BLOCKS), each where it has work.
extern "C" int yam_polygon_errors(const void* points, const void* verts, const void* table, int candidates,
                                  int nshort, int nlong, int nblocks, int block_shared, int cluster_shared,
                                  void* out, void* stream) {
  if (candidates < 1 || nshort < 0 || nlong < 0 || nshort + nlong != candidates || nblocks < 0 ||
      block_shared < 0 || cluster_shared < 0 || nlong > 0x7fffffff / CLUSTER_BLOCKS)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int2* pts = static_cast<const int2*>(points);
  const int2* vs = static_cast<const int2*>(verts);
  const long long* recs = static_cast<const long long*>(table);
  const long long* bounds = recs + static_cast<long long>(CAND_FIELDS) * candidates;
  const long long* plans = bounds + nblocks + 1;
  double* o = static_cast<double*>(out);
  cudaError_t err = cudaSuccess;
  if (nblocks > 0) {
    err = cudaFuncSetAttribute(polygon_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, block_shared);
    if (err != cudaSuccess) return static_cast<int>(err);
    polygon_block_kernel<<<nblocks, 32 * BLOCK_WARPS, block_shared, st>>>(pts, vs, recs, candidates, bounds,
                                                                            plans, o);
  }
  if (nlong > 0) {
    err = cudaFuncSetAttribute(polygon_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, cluster_shared);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaLaunchAttribute cluster;
    cluster.id = cudaLaunchAttributeClusterDimension;
    cluster.val.clusterDim.x = CLUSTER_BLOCKS;
    cluster.val.clusterDim.y = 1;
    cluster.val.clusterDim.z = 1;
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(nlong * CLUSTER_BLOCKS);
    config.blockDim = dim3(32 * CLUSTER_WARPS);
    config.dynamicSmemBytes = cluster_shared;
    config.stream = st;
    config.attrs = &cluster;
    config.numAttrs = 1;
    err = cudaLaunchKernelEx(&config, polygon_cluster_kernel, pts, vs,
                             recs + nshort, static_cast<long long>(candidates), plans, o);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
