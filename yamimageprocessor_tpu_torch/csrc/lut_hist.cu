// 256-level histograms and 256-entry table lookups on uint8 frames.
//
// histogram256: replaces yamimageprocessor_tpu/pallas_kernels.py
// histogram256 (pallas_call at line 512) and histogram256_batch (line 585).
// The TPU has no scatter, so the reference counts with carry-save bit-plane
// counters carried across its sequential grid and cuts a batch into pieces
// of 768 frames; none of that is carried over.
//
// Bound on the card: device memory, 1 byte a pixel in and 1 KB a frame out
// (one 2048^2 frame: 4 MiB, 1.25 us at 3.35 TB/s, less than the fixed cost
// of a launch).  What sets the pace is the shared-memory atomics, about one
// warp instruction every few cycles an SM whatever the banks, so the design
// keeps every SM counting, keeps loads in flight while it does, adds a run
// of one level once, and spends nothing on a call but one launch:
//
// - Grid: one dimension of work items (frame, chunk), `chunks` a frame, so
//   the number of frames has no cap.  The wrapper sizes `chunks` from the
//   blocks the card holds at once (cuda_kernels.py:plan), no chunk shorter
//   than one load of every thread (16 KiB): one 2048^2 frame spreads over
//   every SM, and a batch fills the card.  A chunk is a run of 16-byte
//   vectors of its frame; each thread loads UNROLL of them before it counts
//   any.
// - Table: one 256-bin table a block with a column a lane, bin b of lane l at
//   word 32 b + l, so every lane of a warp adds in its own bank, however hot
//   a level is.  A thread adds a 16-byte vector of one level as 16 once and a
//   4-byte word of one level as 4 once (the closed masks and flat
//   backgrounds of the segmentation chain are mostly such runs).
// - Output: a frame of one chunk stores its counts.  A frame of more chunks
//   adds them with global atomics into an output that is already zero: the
//   wrapper hands each such call the output the previous one zeroed, and
//   chunk 0 of every frame zeroes the next call's (cuda_kernels.py).  No
//   memset launch, and no block waits for another.  Counts are exact
//   integers, so the order in which the atomics land does not change them.
// - Alignment: a frame starts at base + f * frame_len, which need not be a
//   multiple of 16.  The bytes before its first 16-byte boundary go scalar
//   in chunk 0, those after its last whole vector in its last chunk.
//
// lut_apply: replaces pallas_kernels.py lut_apply (pallas_call at line 107)
// and lut_apply_batch (line 161).  The TPU has no per-lane table read, so
// the reference picks each byte through a 63-select tree over packed words.
// Here the frame's 256-byte table sits in shared memory and each byte is a
// direct read of it; loads and stores are 16-byte vectors.  A table shared
// by all frames is the same kernel with a table stride of 0.  Bound: device
// memory, 1 byte a pixel in and 1 out.  Bytes before the first 16-byte
// boundary and after the last full vector go through a scalar loop; when
// input and output differ in their offset from a 16-byte boundary the whole
// frame does.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;  // also the number of bins / table entries
constexpr int LANES = 32;
constexpr int UNROLL = 4;     // 16-byte loads a histogram thread issues before it counts
constexpr int TABLE_BYTES = THREADS * LANES * 4;

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

__device__ __forceinline__ uint32_t map4(const uint8_t* table, uint32_t word) {
  return static_cast<uint32_t>(table[word & 255u]) |
         (static_cast<uint32_t>(table[(word >> 8) & 255u]) << 8) |
         (static_cast<uint32_t>(table[(word >> 16) & 255u]) << 16) |
         (static_cast<uint32_t>(table[word >> 24]) << 24);
}

// A lane's column of the block's table: add(b, k) adds k to bin b.
struct Column {
  int* table;  // THREADS * LANES words, bin b of lane l at LANES * b + l
  int lane;

  __device__ __forceinline__ void add(uint32_t b, int k) const { atomicAdd(&table[b * LANES + lane], k); }

  __device__ __forceinline__ void word(uint32_t w) const {
    if (w == (w & 255u) * 0x01010101u) {
      add(w & 255u, 4);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) add(__byte_perm(w, 0, 0x4440 + j), 1);  // byte j
    }
  }

  __device__ __forceinline__ void vec(const uint4& v) const {
    const uint32_t rep = (v.x & 255u) * 0x01010101u;
    if (v.x == rep && v.y == rep && v.z == rep && v.w == rep) {
      add(v.x & 255u, 16);
    } else {
      word(v.x);
      word(v.y);
      word(v.z);
      word(v.w);
    }
  }
};

// Grid: n * chunks blocks; block b counts chunk b % chunks of frame
// b / chunks.  chunks == 1: out is written whole.  chunks > 1: out is zero
// and the blocks add into it; chunk 0 of each frame zeroes that frame's row
// of next.
__global__ void __launch_bounds__(THREADS)
    histogram256_kernel(const uint8_t* __restrict__ in, int* __restrict__ out, int* __restrict__ next,
                        long long frame_len, int chunks) {
  extern __shared__ uint4 smem[];
  const int tid = threadIdx.x;
  for (int i = tid; i < TABLE_BYTES / 16; i += THREADS) smem[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();

  const long long frame = blockIdx.x / chunks;
  const int chunk = static_cast<int>(blockIdx.x - frame * chunks);
  const uint8_t* src = in + frame * frame_len;
  const Split s = split_frame(reinterpret_cast<uintptr_t>(src), frame_len);
  const long long lo = s.nvec * chunk / chunks;
  const long long hi = s.nvec * (chunk + 1) / chunks;
  int* table = reinterpret_cast<int*>(smem);
  const Column column{table, tid % LANES};

  const uint4* vec = reinterpret_cast<const uint4*>(src + s.head);
  for (long long j0 = lo; j0 < hi; j0 += THREADS * UNROLL) {
    uint4 v[UNROLL];
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      const long long i = j0 + k * THREADS + tid;
      if (i < hi) v[k] = __ldg(vec + i);
    }
#pragma unroll
    for (int k = 0; k < UNROLL; ++k)
      if (j0 + k * THREADS + tid < hi) column.vec(v[k]);
  }
  if (chunk == 0 && tid < s.head) column.add(src[tid], 1);
  if (chunk == chunks - 1) {
    const long long i = s.head + 16 * s.nvec + tid;
    if (i < frame_len) column.add(src[i], 1);
  }
  __syncthreads();

  // bin tid: its 32 lane columns, lane (tid + l) % 32 at step l so that a
  // warp's threads read 32 banks
  int count = 0;
#pragma unroll 8
  for (int l = 0; l < LANES; ++l) count += table[tid * LANES + (tid + l) % LANES];
  int* dst = out + frame * THREADS + tid;
  if (chunks == 1) {
    *dst = count;
    return;
  }
  if (chunk == 0) next[frame * THREADS + tid] = 0;
  if (count) atomicAdd(dst, count);
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

__global__ void empty_kernel() {}

}  // namespace

// Blocks of the histogram kernel the current device holds at once.
extern "C" int yam_histogram256_resident_blocks(int* blocks) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, histogram256_kernel, THREADS, TABLE_BYTES);
  *blocks = per_sm * sms;
  return static_cast<int>(err);
}

// in: (n, frame_len) uint8, contiguous; out: (n, 256) int32.  chunks: blocks
// a frame.  chunks == 1: out is written whole and next is not read.
// chunks > 1: out must be zero, and next (n, 256) int32 is zeroed for the
// next call.
extern "C" int yam_histogram256_u8(const void* in, void* out, void* next, long long frame_len, int n,
                                   int chunks, void* stream) {
  const long long blocks = static_cast<long long>(n) * chunks;
  if (n < 1 || chunks < 1 || frame_len < 1 || blocks >= (1LL << 31) || (chunks > 1 && next == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  histogram256_kernel<<<static_cast<unsigned>(blocks), THREADS, TABLE_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(in), static_cast<int*>(out), static_cast<int*>(next), frame_len, chunks);
  return static_cast<int>(cudaGetLastError());
}

// in, out: (n, frame_len) uint8, contiguous; luts: n tables of 256 uint8
// lut_stride bytes apart (0: one table for every frame).  n is at most
// 65535 (gridDim.y): the wrapper slices larger batches.
extern "C" int yam_lut_apply_u8(const void* in, void* out, const void* luts,
                                long long frame_len, long long lut_stride, int n,
                                int blocks_per_frame, void* stream) {
  const dim3 grid(blocks_per_frame, n);
  lut_apply_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out),
      static_cast<const uint8_t*>(luts), frame_len, lut_stride);
  return static_cast<int>(cudaGetLastError());
}

// One empty kernel: the fixed cost of a launch through the same path.
extern "C" int yam_empty(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

// Message for a code returned by the functions above.
extern "C" const char* yam_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
