// Separable correlation of uint8 frames with reflect-101 borders, rounded
// and saturated back to uint8.
//
// Replaces yamimageprocessor_tpu/ops/sepconv_pallas.py:sep_filter_u8_pallas
// (its pallas_call at line 118).  The TPU kernel pads every frame in device
// memory, DMAs row blocks with a 32-row halo into VMEM and runs the x taps
// as lane rolls.  Here one block owns a TILE_H x TILE_W output tile of one
// frame: it stages the tile and its halo in shared memory, computing the
// reflect-101 source index itself (no padded copy in device memory), writes
// the x-pass into a shared f32 buffer, then runs the y-pass and stores u8.
//
// Bound on the card: device memory.  Each output byte costs one input byte
// (plus the halo, re-read by the neighbouring tiles mostly from L2), so
// about 2 bytes a pixel; the arithmetic is kx + ky multiply-adds a pixel.
//
// Bits: the f32 x-pass and then the y-pass, taps ascending, the first term
// taps[0] * x, each product and each sum rounded on its own.  __fmul_rn and
// __fadd_rn keep nvcc from contracting them into an FMA (which flips the
// last bit once the taps stop being dyadic, ksize >= 11).  Then rintf (half
// to even), clamp to [0, 255], cast: the reference's clip(rint(x)).
//
// The taps are read from a device f32 pointer, so new values need no
// rebuild.  Sizes: ky, kx odd and <= MAX_TAPS (2 * radius <= 32, the
// reference kernel's bound).

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int TILE_W = 128;
constexpr int TILE_H = 32;
constexpr int THREADS = 256;
constexpr int MAX_TAPS = 33;

// cv2 BORDER_REFLECT_101 (numpy "reflect") for any i, with the periodic
// extension numpy uses when the pad is wider than the frame.
__device__ __forceinline__ int reflect101(int i, int n) {
  if (n == 1) return 0;
  const int period = 2 * (n - 1);
  i %= period;
  if (i < 0) i += period;
  return i < n ? i : period - i;
}

__global__ void __launch_bounds__(THREADS)
    sepconv_u8_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                      const float* __restrict__ taps_y,
                      const float* __restrict__ taps_x, int h, int w, int ky,
                      int kx) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float s_ty[MAX_TAPS];
  __shared__ float s_tx[MAX_TAPS];

  const int ry = ky / 2;
  const int rx = kx / 2;
  const int in_h = TILE_H + 2 * ry;
  const int in_w = TILE_W + 2 * rx;
  float* xs = reinterpret_cast<float*>(smem);                      // in_h x TILE_W
  uint8_t* px = smem + static_cast<size_t>(in_h) * TILE_W * sizeof(float);  // in_h x in_w

  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * TILE_W;
  const int y0 = blockIdx.y * TILE_H;
  const size_t frame = static_cast<size_t>(blockIdx.z) * h * w;
  const uint8_t* src = in + frame;

  if (tid < ky) s_ty[tid] = taps_y[tid];
  if (tid < kx) s_tx[tid] = taps_x[tid];
  for (int i = tid; i < in_h * in_w; i += THREADS) {
    const int r = i / in_w;
    const int c = i - r * in_w;
    const int gy = reflect101(y0 + r - ry, h);
    const int gx = reflect101(x0 + c - rx, w);
    px[i] = src[static_cast<size_t>(gy) * w + gx];
  }
  __syncthreads();

  // x-pass over every staged row (the y halo included)
  for (int i = tid; i < in_h * TILE_W; i += THREADS) {
    const int r = i / TILE_W;
    const int c = i - r * TILE_W;
    const uint8_t* row = px + r * in_w + c;
    float acc = __fmul_rn(s_tx[0], static_cast<float>(row[0]));
    for (int t = 1; t < kx; ++t)
      acc = __fadd_rn(acc, __fmul_rn(s_tx[t], static_cast<float>(row[t])));
    xs[i] = acc;
  }
  __syncthreads();

  // y-pass, round, saturate, store
  for (int i = tid; i < TILE_H * TILE_W; i += THREADS) {
    const int r = i / TILE_W;
    const int c = i - r * TILE_W;
    const int gy = y0 + r;
    const int gx = x0 + c;
    if (gy >= h || gx >= w) continue;
    const float* col = xs + r * TILE_W + c;
    float acc = __fmul_rn(s_ty[0], col[0]);
    for (int t = 1; t < ky; ++t)
      acc = __fadd_rn(acc, __fmul_rn(s_ty[t], col[t * TILE_W]));
    const float v = fminf(fmaxf(rintf(acc), 0.0f), 255.0f);
    out[frame + static_cast<size_t>(gy) * w + gx] = static_cast<uint8_t>(v);
  }
}

}  // namespace

// in/out: (n, h, w) uint8, contiguous; taps_y (ky,), taps_x (kx,) f32.
// Returns cudaGetLastError() after the launch (0 when it was accepted).
extern "C" int yam_sepconv_u8(const void* in, void* out, const void* taps_y,
                              const void* taps_x, int n, int h, int w, int ky,
                              int kx, void* stream) {
  if (ky < 1 || kx < 1 || ky > MAX_TAPS || kx > MAX_TAPS || !(ky & 1) ||
      !(kx & 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int ry = ky / 2;
  const int rx = kx / 2;
  const dim3 grid((w + TILE_W - 1) / TILE_W, (h + TILE_H - 1) / TILE_H, n);
  const size_t smem =
      static_cast<size_t>(TILE_H + 2 * ry) * TILE_W * sizeof(float) +
      static_cast<size_t>(TILE_H + 2 * ry) * (TILE_W + 2 * rx);
  sepconv_u8_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out),
      static_cast<const float*>(taps_y), static_cast<const float*>(taps_x), h,
      w, ky, kx);
  return static_cast<int>(cudaGetLastError());
}
