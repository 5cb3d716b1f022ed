// 256-level histograms and 256-entry table lookups on uint8 frames.
//
// histogram256: replaces yamimageprocessor_tpu/pallas_kernels.py
// histogram256 (pallas_call at line 512) and histogram256_batch (line 585).
// The TPU has no scatter, so the reference counts with carry-save bit-plane
// counters carried across its sequential grid.  Here the grid is
// (blocks_per_frame, n): each block counts its share of one frame into a
// 256-bin int32 histogram in shared memory with atomicAdd, reading 16 bytes
// a thread per load, then adds each bin to the zeroed (n, 256) output with
// one global atomicAdd.  Counts are exact integers, so the order in which
// the atomics land does not change the result.
//
// lut_apply: replaces pallas_kernels.py lut_apply (pallas_call at line 107)
// and lut_apply_batch (line 161).  The TPU has no per-lane table read, so
// the reference picks each byte through a 63-select tree over packed words.
// Here the frame's 256-byte table sits in shared memory and each byte is a
// direct read of it; loads and stores are 16-byte vectors.  A table shared
// by all frames is the same kernel with a table stride of 0.
//
// Bound on the card: device memory.  The histogram reads 1 byte a pixel,
// the lookup reads 1 and writes 1.
//
// Alignment: a frame starts at base + f * frame_len, which need not be a
// multiple of 16.  The bytes before the first 16-byte boundary and after the
// last full vector go through a scalar loop; when input and output differ
// in their offset from a 16-byte boundary the whole frame does.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;  // also the number of bins / table entries

__device__ __forceinline__ void count4(int* bins, uint32_t word) {
  atomicAdd(&bins[word & 255u], 1);
  atomicAdd(&bins[(word >> 8) & 255u], 1);
  atomicAdd(&bins[(word >> 16) & 255u], 1);
  atomicAdd(&bins[word >> 24], 1);
}

__device__ __forceinline__ uint32_t map4(const uint8_t* table, uint32_t word) {
  return static_cast<uint32_t>(table[word & 255u]) |
         (static_cast<uint32_t>(table[(word >> 8) & 255u]) << 8) |
         (static_cast<uint32_t>(table[(word >> 16) & 255u]) << 16) |
         (static_cast<uint32_t>(table[word >> 24]) << 24);
}

// Bytes [0, head) and [head + 16 * nvec, len) go scalar, the rest as
// 16-byte vectors starting at head.
struct Split {
  long long head;
  long long nvec;
};

__device__ __forceinline__ Split split_frame(uintptr_t addr, long long len) {
  long long head = static_cast<long long>((16u - (addr & 15u)) & 15u);
  if (head > len) head = len;
  return {head, (len - head) / 16};
}

__global__ void __launch_bounds__(THREADS)
    histogram256_kernel(const uint8_t* __restrict__ in, int* __restrict__ out,
                        long long frame_len) {
  __shared__ int bins[THREADS];
  bins[threadIdx.x] = 0;
  __syncthreads();

  const uint8_t* src = in + static_cast<long long>(blockIdx.y) * frame_len;
  const Split s = split_frame(reinterpret_cast<uintptr_t>(src), frame_len);
  const long long start =
      static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;

  const uint4* vec = reinterpret_cast<const uint4*>(src + s.head);
  for (long long i = start; i < s.nvec; i += stride) {
    const uint4 v = __ldg(vec + i);
    count4(bins, v.x);
    count4(bins, v.y);
    count4(bins, v.z);
    count4(bins, v.w);
  }
  for (long long i = start; i < s.head; i += stride) atomicAdd(&bins[src[i]], 1);
  for (long long i = s.head + 16 * s.nvec + start; i < frame_len; i += stride)
    atomicAdd(&bins[src[i]], 1);
  __syncthreads();

  const int c = bins[threadIdx.x];
  if (c) atomicAdd(&out[blockIdx.y * THREADS + threadIdx.x], c);
}

__global__ void __launch_bounds__(THREADS)
    lut_apply_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                     const uint8_t* __restrict__ luts, long long frame_len,
                     long long lut_stride) {
  __shared__ uint8_t table[THREADS];
  table[threadIdx.x] = luts[blockIdx.y * lut_stride + threadIdx.x];
  __syncthreads();

  const long long base = static_cast<long long>(blockIdx.y) * frame_len;
  const uint8_t* src = in + base;
  uint8_t* dst = out + base;
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  const uintptr_t b = reinterpret_cast<uintptr_t>(dst);
  Split s = split_frame(a, frame_len);
  if ((a ^ b) & 15u) s = {frame_len, 0};  // no common alignment: all scalar
  const long long start =
      static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;

  const uint4* vin = reinterpret_cast<const uint4*>(src + s.head);
  uint4* vout = reinterpret_cast<uint4*>(dst + s.head);
  for (long long i = start; i < s.nvec; i += stride) {
    const uint4 v = __ldg(vin + i);
    uint4 o;
    o.x = map4(table, v.x);
    o.y = map4(table, v.y);
    o.z = map4(table, v.z);
    o.w = map4(table, v.w);
    vout[i] = o;
  }
  for (long long i = start; i < s.head; i += stride) dst[i] = table[src[i]];
  for (long long i = s.head + 16 * s.nvec + start; i < frame_len; i += stride)
    dst[i] = table[src[i]];
}

}  // namespace

// in: (n, frame_len) uint8, contiguous; out: (n, 256) int32, zeroed.
extern "C" int yam_histogram256_u8(const void* in, void* out, long long frame_len,
                                   int n, int blocks_per_frame, void* stream) {
  const dim3 grid(blocks_per_frame, n);
  histogram256_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(in), static_cast<int*>(out), frame_len);
  return static_cast<int>(cudaGetLastError());
}

// in, out: (n, frame_len) uint8, contiguous; luts: n tables of 256 uint8
// lut_stride bytes apart (0: one table for every frame).
extern "C" int yam_lut_apply_u8(const void* in, void* out, const void* luts,
                                long long frame_len, long long lut_stride, int n,
                                int blocks_per_frame, void* stream) {
  const dim3 grid(blocks_per_frame, n);
  lut_apply_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out),
      static_cast<const uint8_t*>(luts), frame_len, lut_stride);
  return static_cast<int>(cudaGetLastError());
}

// Message for a code returned by the functions above.
extern "C" const char* yam_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
