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
// where n < 2k, is kept once), all in float64.  Bound on the card: the
// 2 x 2k x n complex multiply-adds in FP64 and the n sincospi of the
// table.  Design: three launches, each over (contour, chunk) so that a
// long contour spreads over the card: the twiddle table w_r = e^{2 pi i r /
// n} = sincospi(2r / n) (exact at quarter turns); a warp a line, its lanes
// striding over the points with r = (m j) mod n stepped by an integer add
// (no division in the loop), a shuffle reduction; a thread a point, the 2k
// kept lines staged in shared memory, r stepped by j.  Only the 2k lines
// are formed, never the n of a full transform.
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

constexpr int FOURIER_THREADS = 256;
constexpr int INVERSE_THREADS = 128;
constexpr int MAX_COEFF = 512;  // the schema's largest num_coeff
constexpr int POLY_THREADS = 128;
constexpr int PAIRWISE_BLOCK = 128;
constexpr int REDUCE_CHUNK = 8192;
constexpr int MAX_LEAVES = REDUCE_CHUNK / 64;  // a chunk's leaves hold at least 64 elements

// the twiddles w_r = e^{2 pi i r / n} of each contour, r < n: grid
// (contours, chunks of the longest contour)
__global__ void __launch_bounds__(FOURIER_THREADS)
fourier_table_kernel(const long long* __restrict__ offsets, double2* __restrict__ table) {
  const long long o = offsets[blockIdx.x];
  const int n = static_cast<int>(offsets[blockIdx.x + 1] - o);
  for (int r = blockIdx.y * blockDim.x + threadIdx.x; r < n; r += gridDim.y * blockDim.x) {
    double s, c;
    sincospi(2.0 * r / n, &s, &c);
    table[o + r] = make_double2(c, s);
  }
}

// the 2k lines, a warp a line: grid (contours, chunks of FOURIER_THREADS /
// 32 lines); c_m = sum_j z_j conj(w_{m j mod n}), r stepped by an integer
// add, a shuffle reduction
__global__ void __launch_bounds__(FOURIER_THREADS)
fourier_forward_kernel(const int* __restrict__ points, const long long* __restrict__ offsets,
                       const long long* __restrict__ line_offsets, const double2* __restrict__ table,
                       double2* __restrict__ coeffs, int num_coeff) {
  const int f = blockIdx.x;
  const long long o = offsets[f];
  const int n = static_cast<int>(offsets[f + 1] - o);
  const int k = num_coeff < n ? num_coeff : n;
  const int lane = threadIdx.x & 31;
  const int l = blockIdx.y * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (l >= 2 * k) return;  // a whole warp
  const int2* z = reinterpret_cast<const int2*>(points) + o;
  const double2* w = table + o;
  const int m = l < k ? l : n - k + (l - k);
  long long r = static_cast<long long>(m) * lane % n;
  const long long step = static_cast<long long>(m) * 32 % n;
  double re = 0.0, im = 0.0;
  for (int j = lane; j < n; j += 32) {
    const int2 p = z[j];
    const double2 t = w[r];
    re += p.x * t.x + p.y * t.y;
    im += p.y * t.x - p.x * t.y;
    r += step;
    if (r >= n) r -= n;
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    re += __shfl_down_sync(0xffffffffu, re, d);
    im += __shfl_down_sync(0xffffffffu, im, d);
  }
  if (lane == 0) coeffs[line_offsets[f] + l] = make_double2(re, im);
}

// the reconstruction, a thread a point: grid (contours, chunks of the
// longest contour); recon_j = (1/n) sum_l kept_l w_{m_l j mod n}, the kept
// lines staged in shared memory (a line in both halves, where n < 2k,
// once)
__global__ void __launch_bounds__(INVERSE_THREADS)
fourier_inverse_kernel(const long long* __restrict__ offsets, const long long* __restrict__ line_offsets,
                       const double2* __restrict__ table, const double2* __restrict__ coeffs,
                       double2* __restrict__ recon, int num_coeff) {
  __shared__ double2 kept[2 * MAX_COEFF];
  const int f = blockIdx.x;
  const long long o = offsets[f];
  const int n = static_cast<int>(offsets[f + 1] - o);
  if (static_cast<int>(blockIdx.y * blockDim.x) >= n) return;  // the whole block
  const int k = num_coeff < n ? num_coeff : n;
  for (int l = threadIdx.x; l < 2 * k; l += blockDim.x) {
    const bool twice = l >= k && l - k < 2 * k - n;  // already kept in the first half
    kept[l] = twice ? make_double2(0.0, 0.0) : coeffs[line_offsets[f] + l];
  }
  __syncthreads();
  const int j = blockIdx.y * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const double2* w = table + o;
  double re = 0.0, im = 0.0;
  long long r = 0;
  for (int l = 0; l < k; ++l) {
    const double2 c = kept[l], t = w[r];
    re += c.x * t.x - c.y * t.y;
    im += c.x * t.y + c.y * t.x;
    r += j;
    if (r >= n) r -= n;
  }
  r = static_cast<long long>(n - k) * j % n;
  for (int l = k; l < 2 * k; ++l) {
    const double2 c = kept[l], t = w[r];
    re += c.x * t.x - c.y * t.y;
    im += c.x * t.y + c.y * t.x;
    r += j;
    if (r >= n) r -= n;
  }
  recon[o + j] = make_double2(re / n, im / n);
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

// points: (P, 2) int32 (x, y); offsets: (F + 1) int64 of the F contours,
// the longest max_n points; line_offsets: (F + 1) int64, contour f's 2k
// lines at line_offsets[f]; table: (P, 2) float64 scratch; coeffs:
// (line_offsets[F], 2) float64; recon: (P, 2) float64.  Three launches:
// the twiddles, the lines, the reconstruction.
extern "C" int yam_fourier_lines(const void* points, const void* offsets, const void* line_offsets, void* table,
                                 void* coeffs, void* recon, int contours, int num_coeff, int max_n, void* stream) {
  if (contours < 1 || num_coeff < 1 || num_coeff > MAX_COEFF || max_n < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long* o = static_cast<const long long*>(offsets);
  const long long* lo = static_cast<const long long*>(line_offsets);
  double2* w = static_cast<double2*>(table);
  double2* c = static_cast<double2*>(coeffs);
  const int most = 2 * (num_coeff < max_n ? num_coeff : max_n);  // the most lines a contour has
  const unsigned point_chunks = static_cast<unsigned>((max_n + FOURIER_THREADS - 1) / FOURIER_THREADS);
  fourier_table_kernel<<<dim3(contours, point_chunks < 65535 ? point_chunks : 65535), FOURIER_THREADS, 0, st>>>(o, w);
  const unsigned line_chunks = static_cast<unsigned>((most + FOURIER_THREADS / 32 - 1) / (FOURIER_THREADS / 32));
  fourier_forward_kernel<<<dim3(contours, line_chunks), FOURIER_THREADS, 0, st>>>(
      static_cast<const int*>(points), o, lo, w, c, num_coeff);
  const unsigned inverse_chunks = static_cast<unsigned>((max_n + INVERSE_THREADS - 1) / INVERSE_THREADS);
  if (inverse_chunks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  fourier_inverse_kernel<<<dim3(contours, inverse_chunks), INVERSE_THREADS, 0, st>>>(
      o, lo, w, c, static_cast<double2*>(recon), num_coeff);
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
