// Chamfer distance transform (cv2 DIST_L2, mask 5) of uint8 masks to f32.
//
// Replaces yamimageprocessor_tpu/ops/distance_pallas.py: _dt_forward_pallas
// (pallas_call at line 90) and _dt_forward_chunked (line 219), the forward
// raster pass that distance_transform_pallas runs twice, the second time on
// the row-flipped result.  The TPU kernels stream row blocks through VMEM
// and, for frames 1024 wide or more, fold each row into an (8, w/8) layout
// to fill the sublanes; neither exists here.
//
// The row recurrence.  For row i of a pass (top to bottom, then bottom to
// top on the forward result):
//   cand[j] = min(d0[i][j],  r1[j] + A, r1[j -+ 1] + B, r1[j -+ 2] + C,
//                            r2[j -+ 1] + C)
// with r1, r2 the two rows finished before (INF outside the frame and
// before the first row), then the two-sided in-row relaxation
//   min(cummin_left(cand - j) + j, cummin_right(cand + j) - j).
// A block of THREADS threads computes a row: each thread owns a run of PER
// consecutive columns (PER = 8 up to w = 2048, at most 64) and keeps its
// columns of the two rows before, of the candidates and of the result in
// registers.  The prefix and suffix minima are a sequential scan inside
// each run plus a block scan of the run totals (warp shuffles, then one
// warp over the warp totals).  Shared memory holds the two rows before, for
// the 2-column halos the neighbouring runs need, and the new row is written
// over the older of the two once every thread has read its halos.  A run
// takes PER + 1 words there, so the threads of a warp read and write
// distinct banks.
//
// Design: speculative row chunks with an exact fix-up, one cooperative
// launch.  The whole state of a pass after row i is the pair (row i,
// row i - 1): row i + 1 is a fixed function of that pair and of input row
// i + 1.  Each frame is split into K chunks of S rows, one block per
// (frame, chunk), all co-resident, and every pass runs so:
//   1. speculation: every chunk walks its rows from two INF rows, as the
//      first chunk does from the frame's edge, writes them, and publishes
//      its last two rows (the state at its end) as its carry;
//   2. fix-up rounds, a grid barrier before each: chunk k re-walks from its
//      first row only if chunk k - 1 (in walking order) published a new
//      carry in the previous round, starting from that carry.  After each
//      row the block votes (__syncthreads_and, folded into the barrier that
//      ends the row) on whether the new row equals the stored one bit for
//      bit; after two equal rows in a row its state equals the stored state
//      there, so every later stored row of the chunk is already right and
//      it stops.  A chunk that reaches its end first publishes its new last
//      rows and counts itself changed.  The rounds end after a round in
//      which no chunk changed (a device counter read after the barrier).
// The first chunk is exact after speculation and chunk k after round k at
// the latest, so a pass takes at most K - 1 rounds.  Nothing here
// reorders an add; a min is exact in any order, so the result equals the
// sequential walk bit for bit whatever S is.  Carries are double-buffered
// by round parity (carry[parity][block][2][w]): in a round a chunk reads
// only the previous round's carries, never rows another block is writing.
// The forward pass writes a scratch frame and the backward pass reads it,
// since a re-walk needs the forward rows after a speculative backward row
// has been written.  While a row is computed, the threads load the next
// row's inputs (mask bytes or forward values, and in a fix-up the stored
// row to compare with) into registers, so global-memory latency stays off
// the dependent chain.
//
// Worst case: a frame whose only zero pixel is in its first (last) row,
// foreground everywhere else, changes every chunk's carry in the forward
// (backward) pass and takes K - 1 rounds, each re-walking one chunk: about
// one sequential pass plus K grid barriers, bit-exact all the same.
// Frames of a batch share the grid.  The caller (ops/distance.py) plans S,
// K and the frames G a group from yam_chamfer_resident_blocks, so that the
// G K blocks are all resident: a batch with more chunks than fit gets
// fewer, longer chunks, down to K = 1 (one block a frame, the sequential
// walk), and a batch of more frames than fit is walked in groups of G.
//
// Bits: every add is the reference's f32 add on the same operands (INF +
// weight included: it rounds back to INF, as in the reference's INF-padded
// rows).  There is no multiply, so no FMA contraction can happen; the adds
// are __fadd_rn / __fsub_rn all the same.
//
// Bound on the card: latency, not bytes.  A frame is 2 h dependent rows,
// each a few shared-memory barriers long; chunks cut the chain to about
// 2 (S + fix-up depth) rows, plus a grid barrier per round.  The bytes (1 B
// in, 4 B out per pixel, plus the forward scratch written and read) take
// microseconds.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr float INF_D = 3.0e8f;  // the reference's INF
constexpr float WA = 1.0f, WB = 1.4f, WC = 2.1969f;
// ints: counters of changed chunks by round mod 3, fix-up rounds by pass,
// then flags[2][blocks]
constexpr int COUNTS = 0, ROUNDS = 3, FLAGS = 8;

// A row in shared memory: run t of PER columns at words [t (PER + 1), ...).
template <int PER>
struct Row {
  static constexpr int WORDS = THREADS * (PER + 1);
  __device__ __forceinline__ static int at(int j) { return (j / PER) * (PER + 1) + j % PER; }
  // column j of a row, INF outside the frame
  __device__ __forceinline__ static float halo(const float* row, int j, int w) {
    return (j >= 0 && j < w) ? row[at(j)] : INF_D;
  }
};

struct MinPair {
  float left, right;
};

// Exclusive prefix min (thread order) of `left` and exclusive suffix min
// of `right` over the block: warp scans, then every warp folds the totals
// of the warps before (after) it.  buf holds 2 * 32 floats; the caller's
// barrier at the end of the row comes before buf is written again.
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
  float lpre = INFINITY, rsuf = INFINITY;
#pragma unroll
  for (int u = 0; u < WARPS; ++u) {
    if (u < warp) lpre = fminf(lpre, buf[u]);
    if (u > warp) rsuf = fminf(rsuf, buf[32 + u]);
  }
  float le = __shfl_up_sync(FULL, l, 1);
  float re = __shfl_down_sync(FULL, r, 1);
  if (lane == 0) le = INFINITY;
  if (lane == 31) re = INFINITY;
  return {fminf(lpre, le), fminf(rsuf, re)};
}

// One thread's columns of a row: its inputs (in the forward pass the mask
// bytes, four to a word in in[q / 4]; in the backward pass the forward
// values' bits) and, in a fix-up, the bits of the row stored there before.
// Raw values, converted where they are used, so the loads stay in flight
// until then.  With `vec` (w a multiple of 4, aligned frames) each group of
// 4 columns is one 4- or 16-byte load.
template <int PER, int PASS>
__device__ __forceinline__ void load_row(uint32_t (&in)[PER], uint32_t (&old)[PER], const uint8_t* mrow,
                                         const float* frow, const float* drow, int c0, int w, bool compare,
                                         bool vec) {
  if (vec) {
#pragma unroll
    for (int v = 0; v < PER / 4; ++v) {
      const int j = c0 + 4 * v;
      if (j < w) {
        if (PASS == 0) {
          in[v] = *reinterpret_cast<const uint32_t*>(mrow + j);
        } else {
          const uint4 x = *reinterpret_cast<const uint4*>(frow + j);
          in[4 * v] = x.x, in[4 * v + 1] = x.y, in[4 * v + 2] = x.z, in[4 * v + 3] = x.w;
        }
        if (compare) {
          const uint4 y = *reinterpret_cast<const uint4*>(drow + j);
          old[4 * v] = y.x, old[4 * v + 1] = y.y, old[4 * v + 2] = y.z, old[4 * v + 3] = y.w;
        }
      }
    }
    return;
  }
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int j = c0 + q;
    if (j < w) {
      if (PASS == 0) {
        in[q / 4] = (q % 4 ? in[q / 4] : 0u) | static_cast<uint32_t>(mrow[j]) << (8 * (q % 4));
      } else {
        in[q] = __float_as_uint(frow[j]);
      }
      if (compare) old[q] = __float_as_uint(drow[j]);
    }
  }
}

// Walks `len` rows from row `first` (down in pass 0, up in pass 1), writing
// each row to dst.  The state before the first row is in r1, r2 (this
// thread's columns; INF past the frame's edge) and in rows (both rows,
// r1's first).  With `compare`, stops after two consecutive rows equal to
// the rows stored in dst and returns true; otherwise r1, r2 end as the
// state after the last row.
template <int PER, int PASS>
__device__ bool walk(const uint8_t* mask, const float* src, float* dst, float* rows, float* buf,
                     float (&r1)[PER], float (&r2)[PER], int first, int len, int w, int c0, bool compare,
                     bool vec) {
  using R = Row<PER>;
  constexpr int STEP = PASS == 0 ? 1 : -1;
  float* s1 = rows;  // the row before, in shared memory
  float* s2 = rows + R::WORDS;  // the row before that; the new row goes here
  // the inputs of row t + 1 are loaded while row t is computed
  uint32_t next_in[PER] = {}, next_old[PER] = {};
  const long long off0 = static_cast<long long>(first) * w;
  load_row<PER, PASS>(next_in, next_old, mask + off0, src + off0, dst + off0, c0, w, compare, vec);
  int equal_rows = 0;
  for (int t = 0; t < len; ++t) {
    const int i = first + STEP * t;
    uint32_t in[PER], old[PER];
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      in[q] = next_in[q];
      old[q] = next_old[q];
    }
    if (t + 1 < len) {
      const long long off = static_cast<long long>(i + STEP) * w;
      load_row<PER, PASS>(next_in, next_old, mask + off, src + off, dst + off, c0, w, compare, vec);
    }
    // the rows before around this run: r1 at j - 2 .. j + 2, r2 at j -+ 1
    float e1[PER + 4], e2[PER + 2];
    e1[0] = R::halo(s1, c0 - 2, w);
    e1[1] = R::halo(s1, c0 - 1, w);
    e1[PER + 2] = R::halo(s1, c0 + PER, w);
    e1[PER + 3] = R::halo(s1, c0 + PER + 1, w);
    e2[0] = R::halo(s2, c0 - 1, w);
    e2[PER + 1] = R::halo(s2, c0 + PER, w);
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      e1[q + 2] = r1[q];
      e2[q + 1] = r2[q];
    }
    float cand[PER], res[PER];
    float lmin = INFINITY, rmin = INFINITY;
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int j = c0 + q;
      float m = __fadd_rn(e1[q + 2], WA);
      m = fminf(m, __fadd_rn(e1[q + 1], WB));
      m = fminf(m, __fadd_rn(e1[q + 3], WB));
      m = fminf(m, __fadd_rn(e1[q], WC));
      m = fminf(m, __fadd_rn(e1[q + 4], WC));
      m = fminf(m, __fadd_rn(e2[q], WC));
      m = fminf(m, __fadd_rn(e2[q + 2], WC));
      const float v = PASS == 0 ? ((in[q / 4] >> (8 * (q % 4))) & 0xffu ? INF_D : 0.0f) : __uint_as_float(in[q]);
      cand[q] = fminf(v, m);
      if (j < w) {
        lmin = fminf(lmin, __fsub_rn(cand[q], static_cast<float>(j)));
        rmin = fminf(rmin, __fadd_rn(cand[q], static_cast<float>(j)));
      }
    }
    const MinPair ex = block_scan_min(lmin, rmin, buf);
    // every thread has read its halos of s2: the new row may go there
    float run = ex.left;
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int j = c0 + q;
      if (j < w) {
        run = fminf(run, __fsub_rn(cand[q], static_cast<float>(j)));
        res[q] = __fadd_rn(run, static_cast<float>(j));
      }
    }
    run = ex.right;
    bool same = true;
    float* orow = dst + static_cast<long long>(i) * w;
#pragma unroll
    for (int q = PER - 1; q >= 0; --q) {
      const int j = c0 + q;
      float v = INF_D;
      if (j < w) {
        run = fminf(run, __fadd_rn(cand[q], static_cast<float>(j)));
        v = fminf(res[q], __fsub_rn(run, static_cast<float>(j)));
        s2[R::at(j)] = v;
        same &= __float_as_uint(v) == old[q];
      }
      r2[q] = r1[q];
      r1[q] = v;
    }
#pragma unroll
    for (int v = 0; v < PER / 4; ++v) {
      const int j = c0 + 4 * v;
      if (vec && j < w) {
        *reinterpret_cast<float4*>(orow + j) = make_float4(r1[4 * v], r1[4 * v + 1], r1[4 * v + 2], r1[4 * v + 3]);
      } else if (!vec) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (j + e < w) orow[j + e] = r1[4 * v + e];
        }
      }
    }
    // the new row is complete before its halos are read; the vote rides on
    // the same barrier
    const bool all_same = __syncthreads_and(compare && same);
    float* spare = s2;
    s2 = s1;
    s1 = spare;
    equal_rows = all_same ? equal_rows + 1 : 0;
    if (equal_rows == 2) return true;
  }
  return false;
}

// mask (n, h, w) uint8; fwd, out (n, h, w) f32; carry (2, G * K, 2, w) f32;
// ints (FLAGS + 2 * G * K) int32.  Block b walks chunk b % K (rows
// [k S, min(h, k S + S))) of frame first + b / K, for each group of G
// frames starting at `first`.  At PER = 8 (frames up to 2048 wide) the
// registers are capped at 128 a thread, so two blocks share an SM: 264
// resident blocks on an H100 instead of 132, and no slower a row.
template <int PER>
__global__ void __launch_bounds__(THREADS, PER <= 8 ? 2 : 1)
    chamfer_kernel(const uint8_t* __restrict__ mask, float* fwd, float* out, float* carry, int* ints, int n,
                   int h, int w, int S, int K, int G) {
  using R = Row<PER>;
  extern __shared__ __align__(16) float rows[];
  __shared__ float buf[64];
  cg::grid_group grid = cg::this_grid();
  const int blocks = G * K;
  const int slot = blockIdx.x / K;
  const int k = blockIdx.x % K;
  int* counts = ints + COUNTS;
  int* flags = ints + FLAGS;
  const bool leader = blockIdx.x == 0 && threadIdx.x == 0;
  const int c0 = threadIdx.x * PER;
  // whole 4-column groups on 16-byte (float) and 4-byte (mask) boundaries
  const bool vec = w % 4 == 0 && reinterpret_cast<uintptr_t>(mask) % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(fwd) % 16 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int r0 = k * S;
  const int len = min(h, r0 + S) - r0;
  const size_t carry_size = 2 * static_cast<size_t>(w);
  float r1[PER], r2[PER];

  // the state before a walk: two INF rows, or a published carry
  auto start = [&](const float* from) {
    for (int j = threadIdx.x; j < w; j += THREADS) {
      rows[R::at(j)] = from ? __ldcg(from + j) : INF_D;
      rows[R::WORDS + R::at(j)] = from ? __ldcg(from + w + j) : INF_D;
    }
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int j = c0 + q;
      r1[q] = from && j < w ? __ldcg(from + j) : INF_D;
      r2[q] = from && j < w ? __ldcg(from + w + j) : INF_D;
    }
    __syncthreads();
  };
  auto publish = [&](int parity) {
    float* to = carry + (static_cast<size_t>(parity) * blocks + blockIdx.x) * carry_size;
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int j = c0 + q;
      if (j < w) {
        to[j] = r1[q];
        to[w + j] = r2[q];
      }
    }
  };

  if (leader) ints[ROUNDS] = ints[ROUNDS + 1] = 0;
  int round = 0;  // fix-up rounds so far, over passes and frame groups
  for (int first = 0; first < n; first += G) {
    const int frame = first + slot;
    const bool active = frame < n;
    const long long base = static_cast<long long>(frame) * h * w;
    for (int pass = 0; pass < 2; ++pass) {
      // pass 0 walks chunk 0 first and down, pass 1 chunk K - 1 first and up
      const bool has_prev = pass == 0 ? k > 0 : k < K - 1;
      const bool has_next = pass == 0 ? k < K - 1 : k > 0;
      const int prev = pass == 0 ? k - 1 : k + 1;
      const int top = pass == 0 ? r0 : r0 + len - 1;
      float* dst = (pass == 0 ? fwd : out) + base;
      const float* src = fwd + base;
      const uint8_t* msk = mask + base;
      auto run = [&](bool compare) {
        return pass == 0 ? walk<PER, 0>(msk, src, dst, rows, buf, r1, r2, top, len, w, c0, compare, vec)
                         : walk<PER, 1>(msk, src, dst, rows, buf, r1, r2, top, len, w, c0, compare, vec);
      };

      // the slot that the next round counts in was last read two rounds ago
      if (leader) counts[(round + 1) % 3] = 0;
      if (active) {
        start(nullptr);
        run(false);
        if (has_next) publish(round & 1);
        if (threadIdx.x == 0) flags[(round & 1) * blocks + blockIdx.x] = has_next;
      }
      bool more = K > 1;
      if (more) grid.sync();  // the speculative carries and flags are out
      while (more) {
        ++round;
        const int p = (round - 1) & 1;
        if (leader) {
          counts[(round + 1) % 3] = 0;
          ints[ROUNDS + pass] += 1;
        }
        bool changed = false;
        if (active && has_prev && __ldcg(&flags[p * blocks + slot * K + prev])) {
          start(carry + (static_cast<size_t>(p) * blocks + slot * K + prev) * carry_size);
          changed = !run(true) && has_next;
          if (changed) publish(round & 1);
        }
        if (active && threadIdx.x == 0) {
          flags[(round & 1) * blocks + blockIdx.x] = changed;
          if (changed) atomicAdd(&counts[round % 3], 1);
        }
        grid.sync();  // this round's carries, flags and count are out
        more = __ldcg(&counts[round % 3]) > 0;
      }
    }
  }
}

// The dynamic shared memory of the instance, allowed past 48 KB if needed.
template <int PER>
cudaError_t shared_bytes(size_t* smem) {
  *smem = 2 * static_cast<size_t>(Row<PER>::WORDS) * sizeof(float);
  if (*smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(chamfer_kernel<PER>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(*smem));
}

template <int PER>
int resident_blocks(int* blocks) {
  size_t smem = 0;
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = shared_bytes<PER>(&smem);
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, chamfer_kernel<PER>, THREADS, smem);
  *blocks = per_sm * sms;
  return static_cast<int>(err);
}

template <int PER>
int launch(const void* mask, void* out, void* fwd, void* carry, void* ints, int n, int h, int w, int S, int K, int G,
           cudaStream_t stream) {
  size_t smem = 0;
  cudaError_t err = shared_bytes<PER>(&smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  float* o = static_cast<float*>(out);
  float* f = static_cast<float*>(fwd);
  float* c = static_cast<float*>(carry);
  int* in = static_cast<int*>(ints);
  void* args[] = {&m, &f, &o, &c, &in, &n, &h, &w, &S, &K, &G};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(chamfer_kernel<PER>), dim3(G * K), dim3(THREADS),
                                    args, smem, stream);
  if (err != cudaSuccess) {
    cudaGetLastError();  // a refused launch leaves its error behind for the next launch's check: take it
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// blocks: how many blocks of the instance for frames w wide can be
// resident on the current device at once (what a cooperative launch
// allows).  w <= 64 * 256.
extern "C" int yam_chamfer_resident_blocks(int w, int* blocks) {
  const int per = (w + THREADS - 1) / THREADS;
  if (per <= 8) return resident_blocks<8>(blocks);
  if (per <= 16) return resident_blocks<16>(blocks);
  if (per <= 32) return resident_blocks<32>(blocks);
  if (per <= 64) return resident_blocks<64>(blocks);
  return static_cast<int>(cudaErrorInvalidValue);
}

// mask: (n, h, w) uint8, != 0 is foreground, w <= 64 * 256; out: (n, h, w)
// float32; fwd: (n, h, w) float32 scratch for the forward pass; carry:
// 4 * G * K * w float32; ints: 8 + 2 * G * K int32, of which ints[3],
// ints[4] receive the fix-up rounds of the forward and backward passes.
// Chunks of S rows, K = ceil(h / S) a frame, G frames a group: one
// cooperative launch of G * K blocks, which must all be resident.
extern "C" int yam_chamfer_u8(const void* mask, void* out, void* fwd, void* carry, void* ints, int n, int h, int w,
                              int S, int K, int G, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int per = (w + THREADS - 1) / THREADS;
  if (S < 1 || K != (h + S - 1) / S || G < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (per <= 8) return launch<8>(mask, out, fwd, carry, ints, n, h, w, S, K, G, s);
  if (per <= 16) return launch<16>(mask, out, fwd, carry, ints, n, h, w, S, K, G, s);
  if (per <= 32) return launch<32>(mask, out, fwd, carry, ints, n, h, w, S, K, G, s);
  if (per <= 64) return launch<64>(mask, out, fwd, carry, ints, n, h, w, S, K, G, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
