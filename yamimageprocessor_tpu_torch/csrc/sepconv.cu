// Separable correlation of uint8 frames with reflect-101 borders, rounded
// and saturated back to uint8, on gray frames and on interleaved channel
// frames in place.
//
// Replaces yamimageprocessor_tpu/ops/sepconv_pallas.py:sep_filter_u8_pallas
// (its pallas_call at line 118) and sep_filter_u8_planes (line 127).  The
// TPU kernel pads every frame in device memory, DMAs row blocks with a
// 32-row halo into VMEM, runs the x taps as lane rolls, and moves channel
// frames into planes and back with two transposes around the call.
//
// Bound on the card: device memory and float32 arithmetic alike.  Each
// output byte costs one input byte read and one written (2 bytes a pixel);
// the exact order below costs about 13 float32 operations a byte at ksize 5
// (kx + ky multiply-adds, the byte-to-float conversions, the rounding),
// which at the card's float32 rate takes as long as the bytes do.
//
// Design.  A frame row is W * C bytes (C = 1 for gray frames, 3 or 4 for
// interleaved channels: a tap's neighbour lies C bytes away, reflection
// works on the pixel index and keeps the channel).  One block of 128
// threads owns a band of 1024 output bytes of a row and a strip of up to 64
// output rows, and walks down the strip one input row at a time:
// - rows in: each input row of the band plus its halo goes into a ring of
//   16 row buffers in shared memory by 16-byte cp.async, 15 rows ahead of
//   the row in use, so loads overlap the arithmetic.  Reflect-101 costs one
//   scalar row index a row; columns are reflected only in the frame's first
//   and last band (16-byte chunks that leave the row take a byte path from
//   source columns computed once a block), and rows whose base or pitch is
//   not 16-byte aligned take that byte path throughout.  In the first and
//   last bands a thread loads its border byte K rows before it stores it,
//   so no warp waits on a global load inside the loop;
// - x-pass straight into registers: a thread owns 8 adjacent output bytes,
//   reads its window from the row buffer as 8-byte words, and pushes their
//   x-pass values into a ring of ky rows.  Once ky rows are in, it emits
//   one output row: the y-pass over the ring, rounding, clamping and one
//   8-byte store.  No float plane goes through shared memory, and the
//   vertical halo costs 2 * ry x-pass rows a strip;
// - instances: ky = kx = 3, 5, 7 with C = 1, 3, 4 are templates with the
//   taps and the ring in registers (the row loop unrolled by K fixes the
//   ring indices at compile time); every other case (1 tap, up to 33 taps,
//   ky != kx, other channel counts) runs one generic instance whose ring
//   lives in shared memory, beside a halo of kx / 2 * C bytes each side (at
//   ksize 33 that fits up to ~120 channels; yam_sepconv_u8_max_channels
//   says how many).
//
// Bits: each pass in the order XLA's CPU backend contracts the reference's
// sep_filter_j into: fma(t0, x0, t1 * x1), then fma(t_k, x_k, acc) for
// k = 2.. ascending (one tap: t0 * x0), written with __fmaf_rn and
// __fmul_rn so nvcc neither splits nor re-fuses them.  Bytes become floats
// exactly (0x4B000000 | b is 2^23 + b); the result is clamped to [0, 255]
// and rounded half to even by adding 1.5 * 2^23, which equals the
// reference's clip(rint(x)) and then the cast.

#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int THREADS = 128;
constexpr int PER = 8;                 // output bytes a thread: one 8-byte store
constexpr int BAND = THREADS * PER;    // output bytes of a row a block
constexpr int STRIP = 64;              // output rows a block
constexpr int SLOTS = 16;              // row buffers in the ring
constexpr int AHEAD = SLOTS - 1;       // rows loaded ahead of the row in use
// blocks an SM must hold: caps the registers of the templated instances
constexpr int MIN_BLOCKS = 4;
static_assert((SLOTS & (SLOTS - 1)) == 0, "a power of two: slot(i) masks");
constexpr int MAX_TAPS = 33;
constexpr int FAST_HALO = 16;          // staged bytes each side in the templated instances

struct Geometry {
  int h, w, c, rw;  // rw = w * c bytes a row
  int strips, bands;
  int in_aligned;   // base and row pitch 16-byte aligned: chunks inside the row load by cp.async
  int out_aligned;  // base and row pitch 8-byte aligned: a thread stores its 8 bytes at once
};

// cv2 BORDER_REFLECT_101 (numpy "reflect") for any i, with the periodic
// extension numpy uses when the pad is wider than the frame.
__device__ __forceinline__ int reflect101(int i, int n) {
  if (n == 1) return 0;
  const int period = 2 * (n - 1);
  i %= period;
  if (i < 0) i += period;
  return i < n ? i : period - i;
}

// the byte of a row that column col (any integer) reads: the reflected
// pixel, the same channel
__device__ __forceinline__ int source_column(int col, int w, int c) {
  const int px = col >= 0 ? col / c : -((c - 1 - col) / c);
  return reflect101(px, w) * c + (col - px * c);
}

// byte k of word as a float, exactly: 0x4B0000bb is 2^23 + b
__device__ __forceinline__ float byte_to_float(unsigned word, int k) {
  return __fsub_rn(__int_as_float(static_cast<int>(__byte_perm(word, 0x4B000000u, 0x7650u | k))), 8388608.0f);
}

// a word whose low byte is the clip(rint(x)) of the reference
__device__ __forceinline__ unsigned round_to_byte(float x) {
  return __float_as_uint(__fadd_rn(fminf(fmaxf(x, 0.0f), 255.0f), 12582912.0f));
}

__device__ __forceinline__ unsigned pack4(unsigned a, unsigned b, unsigned c, unsigned d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

// One block's band and strip, and its ring of row buffers.  Shared memory:
// the source-column table (span ints), then SLOTS row buffers of span bytes.
//
// The byte path (16-byte chunks that leave the row, or every byte of rows
// that are not 16-byte aligned) reads each byte from its reflected source
// column.  Where it holds at most one byte a thread (the first and last
// bands of aligned rows), a thread loads its byte some rows before it
// stores it (K rows in the templated instances, into a register named at
// compile time: a register move would wait for the load, and the block's
// next barrier for that warp; one row in the generic instance); otherwise
// the bytes are loaded and stored at once through the table.
struct Strip {
  const uint8_t* src;  // the frame's first row
  uint8_t* dst;
  int h, w, c, rw, out_aligned;
  int halo, span, col0;  // buffer byte s holds row byte col0 + s
  int kf, kl;            // 16-byte chunks [kf, kl) load by cp.async, the rest by the byte path
  int left, scalar;      // byte path: positions [0, left) and [16 kl, 16 kl + scalar - left)
  int y0, y_in, rows_out;
  int* cols;
  uint8_t* slots;
  bool piped;            // the byte path holds one byte a thread, loaded ahead of its store
  int s_off, s_col;      // this thread's byte there: buffer position (-1: none) and source column

  __device__ Strip(const Geometry& g, const uint8_t* in, uint8_t* out, int halo_bytes, int ry, bool pipe,
                   unsigned char* smem)
      : h(g.h), w(g.w), c(g.c), rw(g.rw), out_aligned(g.out_aligned), halo(halo_bytes) {
    int b = blockIdx.x;
    const int band = b % g.bands;
    b /= g.bands;
    const int strip = b % g.strips;
    const size_t plane = static_cast<size_t>(g.h) * g.rw * (b / g.strips);
    src = in + plane;
    dst = out + plane;
    span = BAND + 2 * halo;
    col0 = band * BAND - halo;
    y0 = strip * STRIP;
    y_in = y0 - ry;
    rows_out = min(STRIP, h - y0);
    kf = kl = 0;
    if (g.in_aligned) {
      kf = max(0, -col0 / 16);
      kl = max(kf, min(span / 16, (rw - col0) / 16));
    }
    left = 16 * kf;
    // bytes past rw + halo feed no output that is stored: not loaded
    scalar = left + max(0, min(span, rw + halo - col0) - 16 * kl);
    piped = pipe && scalar <= THREADS;
    cols = reinterpret_cast<int*>(smem);
    slots = smem + static_cast<size_t>(span) * sizeof(int);
  }

  __device__ int position(int q) const { return q < left ? q : 16 * kl + (q - left); }

  // this thread's byte (piped), else the table of source columns
  __device__ void columns() {
    s_off = -1;
    s_col = 0;
    if (piped) {
      if (static_cast<int>(threadIdx.x) < scalar) {
        s_off = position(threadIdx.x);
        s_col = source_column(col0 + s_off, w, c);
      }
      return;
    }
#pragma unroll 1
    for (int q = threadIdx.x; q < scalar; q += THREADS) cols[q] = source_column(col0 + position(q), w, c);
  }

  __device__ uint8_t* slot(int i) const { return slots + (i & (SLOTS - 1)) * span; }

  __device__ const uint8_t* source_row(int i) const {
    int y = y_in + i;
    if (static_cast<unsigned>(y) >= static_cast<unsigned>(h)) y = reflect101(y, h);
    return src + static_cast<size_t>(y) * rw;
  }

  // start loading input row i of the strip (frame row y_in + i, reflected) into its
  // slot; returns the piped byte (stored later by the caller), else stores
  // the byte path at once
  __device__ unsigned load(int i) {
    const uint8_t* row = source_row(i);
    uint8_t* buf = slot(i);
#pragma unroll 1
    for (int k = kf + threadIdx.x; k < kl; k += THREADS) cp_async16(buf + 16 * k, row + col0 + 16 * k);
    if (piped) return s_off >= 0 ? __ldg(row + s_col) : 0u;
#pragma unroll 1
    for (int q = threadIdx.x; q < scalar; q += THREADS) buf[position(q)] = __ldg(row + cols[q]);
    return 0u;
  }

  // rows 0 .. AHEAD - 1, one commit group each; the piped bytes' loads all
  // started before the first is stored
  __device__ void prologue(int rows_in) {
    unsigned early[AHEAD];
#pragma unroll
    for (int i = 0; i < AHEAD; ++i) {
      early[i] = i < rows_in ? load(i) : 0u;
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
    if (piped && s_off >= 0) {
#pragma unroll
      for (int i = 0; i < AHEAD; ++i)
        if (i < rows_in) slot(i)[s_off] = static_cast<uint8_t>(early[i]);
    }
  }

  // make row i visible to the block and start row i + AHEAD into the slot
  // row i - 1 used; one commit group a row, empty past the strip's end.
  // pend: the piped byte loaded `lag` rows ago (for row i - lag + AHEAD,
  // read at iteration i - lag + AHEAD > i), stored now; it then takes the
  // byte of row i + AHEAD.
  __device__ void advance(int i, int rows_in, unsigned& pend, int lag) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(AHEAD - 1) : "memory");
    __syncthreads();
    if (piped && s_off >= 0) {
      const int r = i - lag + AHEAD;
      if (i >= lag && r < rows_in) slot(r)[s_off] = static_cast<uint8_t>(pend);
    }
    if (i + AHEAD < rows_in) pend = load(i + AHEAD);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }

  // output row r of the strip: this thread's PER bytes
  __device__ void emit(int r, const float (&res)[PER]) const {
    uint8_t* row = dst + static_cast<size_t>(y0 + r) * rw;
    const int col = (col0 + halo) + PER * static_cast<int>(threadIdx.x);
    unsigned word[PER / 4];
#pragma unroll
    for (int q = 0; q < PER / 4; ++q)
      word[q] = pack4(round_to_byte(res[4 * q]), round_to_byte(res[4 * q + 1]), round_to_byte(res[4 * q + 2]),
                      round_to_byte(res[4 * q + 3]));
    if (out_aligned && col + PER <= rw) {
      *reinterpret_cast<uint2*>(row + col) = make_uint2(word[0], word[1]);
      return;
    }
#pragma unroll
    for (int q = 0; q < PER / 4; ++q) {
      unsigned v = word[q];
#pragma unroll 1
      for (int b = 4 * q; b < 4 * q + 4; ++b, v >>= 8)
        if (col + b < rw) row[col + b] = static_cast<uint8_t>(v);
    }
  }
};

size_t shared_bytes(int halo, int ring_rows) {
  const size_t span = BAND + 2 * halo;
  return span * sizeof(int) + SLOTS * span + static_cast<size_t>(ring_rows) * PER * THREADS * sizeof(float);
}

// this thread's window of a staged row: its PER bytes and E each side
template <int K, int C>
struct Window {
  static constexpr int R = K / 2;
  static constexpr int E = (R * C + 7) / 8 * 8;  // bytes each side of the thread's PER, whole words
  static constexpr int WORDS = (PER + 2 * E) / 8;
  static_assert(K >= 3 && E <= FAST_HALO, "the templated instances take 3 to 7 taps and up to 4 channels");
  uint2 word[WORDS];

  __device__ void read(const uint8_t* buf) {
    const uint8_t* win = buf + (FAST_HALO - E + PER * static_cast<int>(threadIdx.x));
#pragma unroll
    for (int q = 0; q < WORDS; ++q) word[q] = *reinterpret_cast<const uint2*>(win + 8 * q);
  }

  // the x-pass of the thread's PER bytes
  __device__ void x_pass(const float (&tx)[K], float (&x)[PER]) const {
    float v[8 * WORDS];
#pragma unroll
    for (int q = 0; q < WORDS; ++q) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        v[8 * q + k] = byte_to_float(word[q].x, k);
        v[8 * q + 4 + k] = byte_to_float(word[q].y, k);
      }
    }
#pragma unroll
    for (int o = 0; o < PER; ++o) {
      const float* p = v + E + o - R * C;
      float acc = __fmaf_rn(tx[0], p[0], __fmul_rn(tx[1], p[C]));
#pragma unroll
      for (int t = 2; t < K; ++t) acc = __fmaf_rn(tx[t], p[t * C], acc);
      x[o] = acc;
    }
  }
};

// the y-pass of output row r over the ring (ring[(j + 1 + t) % K] holds tap
// t's row), rounded and stored
template <int K>
__device__ __forceinline__ void y_pass_emit(const Strip& st, int r, const float (&ty)[K],
                                            const float (&ring)[K][PER], int j) {
  float res[PER];
#pragma unroll
  for (int o = 0; o < PER; ++o) {
    float acc = __fmaf_rn(ty[0], ring[(j + 1) % K][o], __fmul_rn(ty[1], ring[(j + 2) % K][o]));
#pragma unroll
    for (int t = 2; t < K; ++t) acc = __fmaf_rn(ty[t], ring[(j + 1 + t) % K][o], acc);
    res[o] = acc;
  }
  st.emit(r, res);
}

// ky = kx = K, C channels: taps and the ring of K x-pass rows in registers
template <int K, int C>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    sepconv_fast_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out, const float* __restrict__ taps_y,
                        const float* __restrict__ taps_x, Geometry g) {
  static_assert(K < AHEAD, "a piped byte loaded K rows ahead is stored before its row is read");
  extern __shared__ __align__(16) unsigned char smem[];
  Strip st(g, in, out, FAST_HALO, K / 2, true, smem);
  float tx[K], ty[K];
#pragma unroll
  for (int t = 0; t < K; ++t) {
    tx[t] = __ldg(taps_x + t);
    ty[t] = __ldg(taps_y + t);
  }
  st.columns();
  __syncthreads();
  const int rows_in = st.rows_out + K - 1;
  st.prologue(rows_in);

  float ring[K][PER];
  unsigned pend[K] = {};  // pend[j]: the piped byte loaded at the last iteration with i % K == j
  for (int base = 0; base < rows_in; base += K) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int i = base + j;  // input row i lands in ring[i % K] = ring[j]
      if (i < rows_in) {
        st.advance(i, rows_in, pend[j], K);
        Window<K, C> win;
        win.read(st.slot(i));
        win.x_pass(tx, ring[j]);
        // rows i - K + 1 .. i are in: ring[(j + 1 + t) % K] holds tap t's row
        if (i >= K - 1) y_pass_emit<K>(st, i - (K - 1), ty, ring, j);
      }
    }
  }
}

// any odd ky, kx <= MAX_TAPS and any c whose halo fits: the taps and the
// ring ([ky][PER][THREADS] floats, each thread's own) in shared memory
__global__ void __launch_bounds__(THREADS)
    sepconv_generic_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                           const float* __restrict__ taps_y, const float* __restrict__ taps_x, Geometry g, int ky,
                           int kx) {
  __shared__ float s_ty[MAX_TAPS];
  __shared__ float s_tx[MAX_TAPS];
  extern __shared__ __align__(16) unsigned char smem[];
  const int rx = kx / 2;
  const int c = g.c;
  const int halo = (rx * c + 15) / 16 * 16;
  Strip st(g, in, out, halo, ky / 2, true, smem);
  const int tid = threadIdx.x;
  float* ring = reinterpret_cast<float*>(st.slots + static_cast<size_t>(SLOTS) * st.span) + tid;
  if (tid < ky) s_ty[tid] = taps_y[tid];
  if (tid < kx) s_tx[tid] = taps_x[tid];
  st.columns();
  __syncthreads();
  const int rows_in = st.rows_out + ky - 1;
  st.prologue(rows_in);

  unsigned pend = 0u;  // the piped byte, stored a row after its load
  for (int i = 0; i < rows_in; ++i) {
    st.advance(i, rows_in, pend, 1);
    // taps outside, the thread's PER outputs inside: PER independent chains
    const uint8_t* win = st.slot(i) + (halo - rx * c + PER * tid);
    float acc[PER];
    if (kx == 1) {
#pragma unroll
      for (int o = 0; o < PER; ++o) acc[o] = __fmul_rn(s_tx[0], byte_to_float(win[o], 0));
    } else {
#pragma unroll
      for (int o = 0; o < PER; ++o)
        acc[o] = __fmaf_rn(s_tx[0], byte_to_float(win[o], 0), __fmul_rn(s_tx[1], byte_to_float(win[o + c], 0)));
    }
    for (int t = 2; t < kx; ++t) {
      const uint8_t* x = win + t * c;
      const float tap = s_tx[t];
#pragma unroll
      for (int o = 0; o < PER; ++o) acc[o] = __fmaf_rn(tap, byte_to_float(x[o], 0), acc[o]);
    }
    float* row = ring + (i % ky) * (PER * THREADS);
#pragma unroll
    for (int o = 0; o < PER; ++o) row[o * THREADS] = acc[o];
    if (i >= ky - 1) {  // tap t's row is ring row (i + 1 + t) % ky
      const int first = (i + 1) % ky;
      const int second = first + 1 == ky ? 0 : first + 1;
      const float* r0 = ring + first * (PER * THREADS);
      const float* r1 = ring + second * (PER * THREADS);
      if (ky == 1) {
#pragma unroll
        for (int o = 0; o < PER; ++o) acc[o] = __fmul_rn(s_ty[0], r0[o * THREADS]);
      } else {
#pragma unroll
        for (int o = 0; o < PER; ++o)
          acc[o] = __fmaf_rn(s_ty[0], r0[o * THREADS], __fmul_rn(s_ty[1], r1[o * THREADS]));
      }
      int r = second;
      for (int t = 2; t < ky; ++t) {
        r = r + 1 == ky ? 0 : r + 1;
        const float* rt = ring + r * (PER * THREADS);
        const float tap = s_ty[t];
#pragma unroll
        for (int o = 0; o < PER; ++o) acc[o] = __fmaf_rn(tap, rt[o * THREADS], acc[o]);
      }
      st.emit(i - (ky - 1), acc);
    }
  }
}

template <int K, int C>
cudaError_t launch_fast(const uint8_t* in, uint8_t* out, const float* ty, const float* tx, const Geometry& g,
                        int blocks, cudaStream_t stream) {
  sepconv_fast_kernel<K, C><<<blocks, THREADS, shared_bytes(FAST_HALO, 0), stream>>>(in, out, ty, tx, g);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_fast_k(const uint8_t* in, uint8_t* out, const float* ty, const float* tx, const Geometry& g,
                          int blocks, cudaStream_t stream) {
  switch (g.c) {
    case 1: return launch_fast<K, 1>(in, out, ty, tx, g, blocks, stream);
    case 3: return launch_fast<K, 3>(in, out, ty, tx, g, blocks, stream);
    default: return launch_fast<K, 4>(in, out, ty, tx, g, blocks, stream);
  }
}

}  // namespace

// *channels: the most interleaved channels yam_sepconv_u8 takes with these
// tap counts on the current device, where the generic instance's halo and
// ring fill the shared memory a block may opt into (INT_MAX for kx = 1).
extern "C" int yam_sepconv_u8_max_channels(int ky, int kx, int* channels) {
  if (ky < 1 || kx < 1 || ky > MAX_TAPS || kx > MAX_TAPS) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, optin = 0;
  cudaFuncAttributes attr;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, sepconv_generic_kernel);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(err);
  }
  // shared_bytes(halo, ky) <= optin - static: span = BAND + 2 halo, halo a multiple of 16
  constexpr long long per_span_byte = sizeof(int) + SLOTS;
  const long long room = static_cast<long long>(optin) - static_cast<long long>(attr.sharedSizeBytes) -
                         static_cast<long long>(shared_bytes(0, ky)) + BAND * per_span_byte;
  const long long spare = room / per_span_byte - BAND;
  const long long halo = spare / 32 * 16;
  const int rx = kx / 2;
  *channels = spare < 0 ? 0 : rx == 0 ? INT_MAX : static_cast<int>(std::min<long long>(INT_MAX, halo / rx));
  return 0;
}

// in/out: n frames of h rows of w pixels of c interleaved uint8 channels,
// contiguous; taps_y (ky,), taps_x (kx,) f32 on the device, ky and kx odd
// and <= 33; c >= 1 and at most yam_sepconv_u8_max_channels, w * c <=
// 2^30.  Returns cudaGetLastError() after the launch (0 when it was
// accepted; a refused launch's error is taken, not left behind).
extern "C" int yam_sepconv_u8(const void* in, void* out, const void* taps_y, const void* taps_x, int n, int h,
                              int w, int c, int ky, int kx, void* stream) {
  if (ky < 1 || kx < 1 || ky > MAX_TAPS || kx > MAX_TAPS || !(ky & 1) || !(kx & 1) || c < 1 || n < 1 || h < 1 ||
      w < 1 || static_cast<long long>(w) * c > (1 << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  Geometry g;
  g.h = h;
  g.w = w;
  g.c = c;
  g.rw = w * c;
  g.strips = (h + STRIP - 1) / STRIP;
  g.bands = (g.rw + BAND - 1) / BAND;
  g.in_aligned = reinterpret_cast<uintptr_t>(in) % 16 == 0 && g.rw % 16 == 0;
  g.out_aligned = reinterpret_cast<uintptr_t>(out) % PER == 0 && g.rw % PER == 0;
  const long long blocks = static_cast<long long>(n) * g.strips * g.bands;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  const uint8_t* src = static_cast<const uint8_t*>(in);
  uint8_t* dst = static_cast<uint8_t*>(out);
  const float* ty = static_cast<const float*>(taps_y);
  const float* tx = static_cast<const float*>(taps_x);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nb = static_cast<int>(blocks);
  cudaError_t err;
  if (ky == kx && (c == 1 || c == 3 || c == 4) && (ky == 3 || ky == 5 || ky == 7)) {
    err = ky == 3 ? launch_fast_k<3>(src, dst, ty, tx, g, nb, s)
        : ky == 5 ? launch_fast_k<5>(src, dst, ty, tx, g, nb, s)
                  : launch_fast_k<7>(src, dst, ty, tx, g, nb, s);
  } else {
    const long long halo = (static_cast<long long>(kx / 2) * c + 15) / 16 * 16;
    if (halo > (1 << 20)) return static_cast<int>(cudaErrorInvalidValue);  // far past any shared memory
    const size_t smem = shared_bytes(static_cast<int>(halo), ky);
    err = cudaFuncSetAttribute(sepconv_generic_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err == cudaSuccess) {
      sepconv_generic_kernel<<<nb, THREADS, smem, s>>>(src, dst, ty, tx, g, ky, kx);
      err = cudaGetLastError();
    }
  }
  if (err != cudaSuccess) cudaGetLastError();  // take it: the next launch's check must not see it
  return static_cast<int>(err);
}
