// Chamfer distance transform (cv2 DIST_L2, mask 5) of uint8 masks to f32.
//
// Replaces yamimageprocessor_tpu/ops/distance_pallas.py: _dt_forward_pallas
// (pallas_call at line 90) and _dt_forward_chunked (line 219), the forward
// raster pass that distance_transform_pallas runs twice, the second time on
// the row-flipped result.  The TPU kernels stream row blocks through VMEM
// and, for frames 1024 wide or more, fold each row into an (8, w/8) layout
// to fill the sublanes; neither exists here.
//
// Design: one block of THREADS threads owns one frame and walks its rows,
// the forward pass top to bottom, then the backward pass bottom to top on
// the forward result (in place: row i is read just before it is
// overwritten).  Each thread owns a run of ceil(w / THREADS) consecutive
// columns.  For row i:
//   cand[j] = min(d0[i][j],  r1[j] + A, r1[j -+ 1] + B, r1[j -+ 2] + C,
//                            r2[j -+ 1] + C)
// with r1, r2 the two rows finished before (INF outside the frame and
// before the first row), then the two-sided in-row relaxation
//   min(cummin_left(cand - j) + j, cummin_right(cand + j) - j).
// The prefix and suffix minima are a sequential scan inside each thread's
// run plus a block scan of the run totals (warp shuffles, then one warp
// over the warp totals).  The rows r1, r2, cand and the left result sit in
// shared memory (4 w floats; 32 KB at w = 2048) and rotate by pointer.
//
// Bits: every add is the reference's f32 add on the same operands (INF +
// weight included: it rounds back to INF, as in the reference's INF-padded
// rows); a min is exact in any order, so the scan tree is free.  There is
// no multiply, so no FMA contraction can happen; the adds are __fadd_rn /
// __fsub_rn all the same.
//
// Bound on the card: latency, not bytes.  A frame is 2 h dependent rows on
// one SM, each a few shared-memory barriers long; the bytes (1 B in, 4 B
// out per pixel, plus the forward result read back) take microseconds.
// Frames of a batch run on separate SMs.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr float INF_D = 3.0e8f;  // the reference's INF
constexpr float WA = 1.0f, WB = 1.4f, WC = 2.1969f;

struct MinPair {
  float left, right;
};

// Exclusive prefix min (thread order) of `left` and exclusive suffix min
// of `right` over the block.  buf holds 2 * 32 floats.
__device__ __forceinline__ MinPair block_scan_min(float left, float right, float* buf) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float l = left, r = right;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float yl = __shfl_up_sync(FULL, l, off);
    const float yr = __shfl_down_sync(FULL, r, off);
    if (lane >= off) l = fminf(l, yl);
    if (lane + off < 32) r = fminf(r, yr);
  }
  if (lane == 31) buf[warp] = l;
  if (lane == 0) buf[32 + warp] = r;
  __syncthreads();
  if (warp == 0) {
    float a = lane < WARPS ? buf[lane] : INFINITY;
    float b = lane < WARPS ? buf[32 + lane] : INFINITY;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float ya = __shfl_up_sync(FULL, a, off);
      const float yb = __shfl_down_sync(FULL, b, off);
      if (lane >= off) a = fminf(a, ya);
      if (lane + off < 32) b = fminf(b, yb);
    }
    buf[lane] = a;
    buf[32 + lane] = b;
  }
  __syncthreads();
  float le = __shfl_up_sync(FULL, l, 1);
  float re = __shfl_down_sync(FULL, r, 1);
  if (lane == 0) le = INFINITY;
  if (lane == 31) re = INFINITY;
  const float lpre = warp > 0 ? buf[warp - 1] : INFINITY;
  const float rsuf = warp + 1 < WARPS ? buf[32 + warp + 1] : INFINITY;
  MinPair out{fminf(lpre, le), fminf(rsuf, re)};
  __syncthreads();  // buf is reused by the next row
  return out;
}

__device__ __forceinline__ float at(const float* row, int k, int w) {
  return (k >= 0 && k < w) ? row[k] : INF_D;
}

__device__ __forceinline__ float vertical(const float* r1, const float* r2, int j, int w) {
  float m = __fadd_rn(r1[j], WA);
  m = fminf(m, __fadd_rn(at(r1, j - 1, w), WB));
  m = fminf(m, __fadd_rn(at(r1, j + 1, w), WB));
  m = fminf(m, __fadd_rn(at(r1, j - 2, w), WC));
  m = fminf(m, __fadd_rn(at(r1, j + 2, w), WC));
  m = fminf(m, __fadd_rn(at(r2, j - 1, w), WC));
  m = fminf(m, __fadd_rn(at(r2, j + 1, w), WC));
  return m;
}

__global__ void __launch_bounds__(THREADS)
    chamfer_kernel(const uint8_t* __restrict__ mask, float* __restrict__ out, int h, int w) {
  extern __shared__ __align__(16) float rows[];
  __shared__ float buf[64];
  const long long frame = static_cast<long long>(blockIdx.x) * h * w;
  mask += frame;
  out += frame;

  const int per = (w + THREADS - 1) / THREADS;
  const int c0 = min(static_cast<int>(threadIdx.x) * per, w);
  const int c1 = min(c0 + per, w);

  for (int pass = 0; pass < 2; ++pass) {
    float* r1 = rows;
    float* r2 = rows + w;
    float* cand = rows + 2 * w;
    float* res = rows + 3 * w;
    for (int j = threadIdx.x; j < w; j += THREADS) r1[j] = r2[j] = INF_D;
    __syncthreads();
    for (int step = 0; step < h; ++step) {
      const int i = pass == 0 ? step : h - 1 - step;
      const uint8_t* mrow = mask + static_cast<long long>(i) * w;
      float* orow = out + static_cast<long long>(i) * w;
      float lmin = INFINITY, rmin = INFINITY;
      for (int j = c0; j < c1; ++j) {
        const float v = pass == 0 ? (mrow[j] ? INF_D : 0.0f) : orow[j];
        const float c = fminf(v, vertical(r1, r2, j, w));
        cand[j] = c;
        lmin = fminf(lmin, __fsub_rn(c, static_cast<float>(j)));
        rmin = fminf(rmin, __fadd_rn(c, static_cast<float>(j)));
      }
      const MinPair ex = block_scan_min(lmin, rmin, buf);
      float run = ex.left;
      for (int j = c0; j < c1; ++j) {
        run = fminf(run, __fsub_rn(cand[j], static_cast<float>(j)));
        res[j] = __fadd_rn(run, static_cast<float>(j));
      }
      run = ex.right;
      for (int j = c1 - 1; j >= c0; --j) {
        run = fminf(run, __fadd_rn(cand[j], static_cast<float>(j)));
        const float v = fminf(res[j], __fsub_rn(run, static_cast<float>(j)));
        res[j] = v;
        orow[j] = v;
      }
      __syncthreads();  // the new row is complete before it is read as r1
      float* spare = r2;
      r2 = r1;
      r1 = res;
      res = cand;
      cand = spare;
    }
  }
}

}  // namespace

// mask: (n, h, w) uint8, != 0 is foreground; out: (n, h, w) float32.  One
// block a frame; 4 * w floats of dynamic shared memory.
extern "C" int yam_chamfer_u8(const void* mask, void* out, int n, int h, int w, void* stream) {
  const size_t smem = 4 * static_cast<size_t>(w) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        chamfer_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  chamfer_kernel<<<n, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(mask), static_cast<float*>(out), h, w);
  return static_cast<int>(cudaGetLastError());
}
