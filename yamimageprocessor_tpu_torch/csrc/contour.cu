// Contour tracing of the extraction stage: the outer boundary of every
// 8-connected region of a batch of compact raster-first label maps, in
// Moore order.  It replaces no pallas_call: the reference traces on the host
// (yamimageprocessor_tpu/ops/shape.py:107 trace_external_contours, a
// sequential walk in Python) and this kernel gives that walk's points
// exactly:
//
// - a region starts at its raster-first pixel; the first search starts with
//   backtrack direction 6 (entered from the left), and a region with no
//   neighbour of its own is one point;
// - at each step the next pixel is the first neighbour of the region
//   clockwise after the backtrack direction (directions 0..7: up, up-right,
//   right, down-right, down, down-left, left, up-left); a neighbour outside
//   the frame reads as background;
// - Jacob's stop: the walk ends on re-entering the start pixel with the same
//   next pixel as the first visit; passing through the start with another
//   next pixel appends the start again.
//
// The walk as moves.  A move (p, d) takes pixel p to q = p + M[d]; its
// successor is (q, d'), d' the first region direction of q clockwise after
// (d + 4) % 8: a function of q's neighbour byte (a foreground neighbour of a
// region's pixel is of that region).  The successor is a bijection on a
// region's moves (the predecessor of (q, d') leaves q + M[b], b the first
// region direction counterclockwise from d' - 1), so the orbit of the first
// move is a cycle and Jacob's stop is its return to the first move: the
// points are the cycle's source pixels in order, and the reference's bound
// of 8 * (pixels + 1) steps never cuts it.  The walk never enters a pixel
// whose eight neighbours are all of the region (an interior pixel), nor
// does it leave one, and its search at a pixel always passes a direction
// that is not the region's (d' != b + 1: the move's gap is not empty).  So
// a state is kept for a move out of a boundary pixel q, named by the
// direction b it enters q from (it leaves by d' = succ_S(b)), only where
// q + M[b] and q + M[d'] are boundary pixels too and d' != b + 1: moves on
// no outer walk, which zigzag between the rows of thin parts in short
// cycles, go.
// The states lie in raster order of their pixels, b rising.  A region's
// first move is the state (start, max S): the start's neighbours up and to
// its left are not of the region, so d0 = min S and its predecessor enters
// from max S.  tests/test_torch_trace_schedule.py models this schedule in
// numpy against the reference.
//
// Launches a call:
//
// 1. contour_init_kernel, contour_seed_kernel: each region's start (its
//    raster-first pixel, the first pixel of a row run: atomicMin of y * w +
//    x), reading the labels once with coalesced loads, and the foreground
//    packed as bits, a __ballot_sync a word;
// 2. contour_states_kernel: a thread a 32-pixel word of the packed mask,
//    its pixels as bit planes formed from five rows of three words: the
//    region's directions S and the interior neighbours, so the kept
//    states (plane b: bit j for pixel j's state entered from b) and the
//    word's state count; the words that keep a state listed in units of
//    four words;
// 3. (an inclusive scan of the words' counts: torch.cumsum; its total, the
//    state count, read once to size the states' arrays)
// 4. contour_moves_kernel: a thread a word of a listed unit of four: its
//    planes again, then each of its states' pixel and move, and its
//    successor's word and pixel; contour_links_kernel, a thread a state:
//    its successor's index (that word's base and the kept planes' states
//    before it), or END of its region where the successor is the
//    region's first state (read only at a local top: no region neighbour
//    above or left);
// 5. contour_rank_kernel, one cooperative launch: (A) each block ranks
//    chunks of RANK_CHUNK consecutive states in shared memory by pointer
//    jumping (Wyllie: link and distance double-buffered, rounds until no
//    link stays in the chunk, at most ceil(log2) of its states: a link still
//    in the chunk then is on a cycle that never reaches END, a hole's), each
//    state ending at an END, a dead end (a successor not kept, or such a
//    cycle: off the outer walk) or a state of another chunk, an entry; (B)
//    the entries jump among themselves, a grid.sync() a round, until every
//    entry reaches an END or a dead end (at most ceil(log2) of the entries'
//    count rounds, likewise); (C) each state's rank, its distance to END,
//    and its region, the END's, or -1 off the outer walks; each region's
//    point count (its largest rank + 1, 1 for an isolated pixel) and the
//    doubled shoelace area, the int64 sum of every outer state's cross
//    product x_p y_q - y_p x_q (any order: the sum is exact), |.|, 0 below
//    three points;
// 6. (an exclusive scan of the counts: torch.cumsum)
// 7. contour_write_kernel: each outer state writes its pixel at its
//    region's offset + count - 1 - rank; an isolated pixel writes itself
//    (the points are sized for every state and every region beforehand;
//    the point count is read once the work is done).
//
// Bound on the card: the label map read once, the points and areas written
// once.  With every successor formed at once, no chain of dependent steps
// is inherent; the design's chains are the ranking rounds, log2 of a chunk's
// longest list in shared memory and log2 of the entries a cycle crosses in
// global memory.

#include <cstdint>
#include <climits>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int SEED_THREADS = 256;
constexpr int WORD_THREADS = 128;
constexpr int WRITE_THREADS = 256;
constexpr int RANK_THREADS = 512;
constexpr int RANK_CHUNK = 4096;  // states a block ranks in shared memory: two int2 buffers, 64 KiB
constexpr int DEAD = -1;  // a link: a state index, DEAD, or the END of region s as -2 - s
// ctrl words: the entry count, the most rounds a chunk took, the entry
// rounds, three round counters, the ranking's phases' ends in ns from its
// start (%globaltimer, block 0: the chunks, the entries, the ranks and
// sums, the areas), the active units (four words that keep a state)
constexpr int CTRL_ENTRIES = 0, CTRL_LOCAL = 1, CTRL_GLOBAL = 2, CTRL_ROUND = 3, CTRL_TIMES = 6, CTRL_ACTIVE = 10,
              CTRL_WORDS = 11;

__device__ __forceinline__ long long now_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__global__ void contour_init_kernel(int* __restrict__ start, int* __restrict__ ctrl, long long slots) {
  if (blockIdx.x == 0 && threadIdx.x < CTRL_WORDS) ctrl[threadIdx.x] = 0;
  for (long long s = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; s < slots;
       s += static_cast<long long>(gridDim.x) * blockDim.x)
    start[s] = INT_MAX;
}

// A warp a chunk of 1024 pixels of one row (32 rounds of 32 consecutive
// pixels, coalesced): each round's foreground is one __ballot_sync, the
// chunk's 32 words of the packed mask written by the lanes at the end; a
// pixel whose left neighbour differs starts a run (atomicMin of its flat
// index into its region's start).
__global__ void contour_seed_kernel(const int* __restrict__ labels, int* __restrict__ start,
                                    unsigned* __restrict__ mask, int n, int h, int w, int wpr, int nseg) {
  const int lane = threadIdx.x & 31;
  const int chunks = (w + 1023) / 1024;
  const long long tasks = static_cast<long long>(n) * h * chunks;
  const long long warps = static_cast<long long>(gridDim.x) * (blockDim.x >> 5);
  for (long long t = static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + (threadIdx.x >> 5); t < tasks;
       t += warps) {
    const int chunk = static_cast<int>(t % chunks);
    const long long row = t / chunks;  // frame * h + y
    const int y = static_cast<int>(row % h);
    const long long frame = row / h;
    const int* lab = labels + row * w;
    const int x0 = chunk * 1024;
    int v[32];  // the chunk's 32 rounds loaded before any is used: 32 loads in flight a lane
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int x = x0 + 32 * i + lane;
      v[i] = x < w ? __ldg(lab + x) : 0;
    }
    int carry = x0 > 0 ? __ldg(lab + x0 - 1) : 0;  // the label left of a round's lane 0
    unsigned word = 0;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int x = x0 + 32 * i + lane;
      const unsigned bits = __ballot_sync(0xffffffffu, v[i] > 0);
      if (lane == i) word = bits;
      const int up = __shfl_up_sync(0xffffffffu, v[i], 1);
      const int left = lane == 0 ? carry : up;
      carry = __shfl_sync(0xffffffffu, v[i], 31);
      if (v[i] > 0 && left != v[i]) atomicMin(start + frame * nseg + v[i], y * w + x);
    }
    const int q = x0 / 32 + lane;
    if (q < wpr) mask[row * wpr + q] = word;
  }
}

// Row y's mask bits around word q as a 64-bit window: bit i is column 32 q
// - 16 + i (the left word's upper half, the word, the right word's lower
// half), 0 outside the frame.
__device__ __forceinline__ unsigned long long window(const unsigned* __restrict__ m, int h, int wpr, int y, int q) {
  if (y < 0 || y >= h) return 0ull;
  const unsigned* row = m + static_cast<long long>(y) * wpr;
  const unsigned long long left = q > 0 ? __ldg(row + q - 1) : 0u, mid = __ldg(row + q),
                           right = q + 1 < wpr ? __ldg(row + q + 1) : 0u;
  return (left >> 16) | (mid << 16) | ((right & 0xffffull) << 48);
}

// bit i of a window moved to column x + 1 (east) or x - 1 (west) of bit i
__device__ __forceinline__ unsigned long long east(unsigned long long v) { return v >> 1; }
__device__ __forceinline__ unsigned long long west(unsigned long long v) { return v << 1; }

// the interior pixels of the middle row (all eight neighbours foreground),
// right for bits 1..62
__device__ __forceinline__ unsigned long long interior(unsigned long long u, unsigned long long c,
                                                       unsigned long long d) {
  return c & east(c) & west(c) & u & east(u) & west(u) & d & east(d) & west(d);
}

// the first direction of m clockwise after prev (prev itself when it is
// the only one); m != 0
__device__ __forceinline__ int next_direction(unsigned m, int prev) {
  const int s = (prev + 1) & 7;
  const unsigned r = ((m >> s) | (m << (8 - s))) & 0xffu;
  return (s + __ffs(r) - 1) & 7;
}

// direction d's row and column steps, (dy + 1) and (dx + 1) packed two bits
// a direction
__device__ __forceinline__ int step_y(int d) { return static_cast<int>((0x1a90u >> (2 * d)) & 3u) - 1; }
__device__ __forceinline__ int step_x(int d) { return static_cast<int>((0x01a9u >> (2 * d)) & 3u) - 1; }

// Word `word` of the packed mask (its row frame * h + y and index q in the
// row), its 32 pixels at once as bit planes: P[d], the region's directions
// S (bit j: pixel j's neighbour d is of the region), and K[b], the kept
// states: pixel j keeps the state entered from b where b is in S and not
// interior, b + 1 is not in S (the search passes a direction that is not
// the region's) and succ_S(b) is not interior.  Returns the state count.
__device__ __forceinline__ int word_planes(const unsigned* __restrict__ mask, long long word, int h, int wpr,
                                           unsigned* P, unsigned* K) {
  const unsigned row = static_cast<unsigned>(word) / static_cast<unsigned>(wpr);
  const int q = static_cast<int>(static_cast<unsigned>(word) - row * static_cast<unsigned>(wpr));
  const int frame = static_cast<int>(row / static_cast<unsigned>(h));
  const int y = static_cast<int>(row) - frame * h;
  const unsigned* m = mask + static_cast<long long>(frame) * h * wpr;
  unsigned long long f[5];
#pragma unroll
  for (int r = 0; r < 5; ++r) f[r] = window(m, h, wpr, y - 2 + r, q);
  const unsigned long long iu = interior(f[0], f[1], f[2]), ic = interior(f[1], f[2], f[3]),
                           id = interior(f[2], f[3], f[4]);
  const unsigned long long pw[8] = {f[1], east(f[1]), east(f[2]), east(f[3]), f[3], west(f[3]), west(f[2]), west(f[1])};
  const unsigned long long nw[8] = {iu, east(iu), east(ic), east(id), id, west(id), west(ic), west(iu)};
  unsigned N[8];
#pragma unroll
  for (int d = 0; d < 8; ++d) {
    P[d] = static_cast<unsigned>(pw[d] >> 16);
    N[d] = static_cast<unsigned>(nw[d] >> 16);
    K[d] = 0;
  }
  const unsigned bnd = static_cast<unsigned>((f[2] & ~ic) >> 16);
  int count = 0;
  if (bnd) {
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      unsigned clear = ~0u, bad = 0;
#pragma unroll
      for (int k = 2; k <= 8; ++k) {  // succ_S(b) interior: the first d after b + 1 in S
        const int d = (b + k) & 7;
        bad |= clear & P[d] & N[d];
        clear &= ~P[d];
      }
      K[b] = P[b] & bnd & ~N[b] & ~P[(b + 1) & 7] & ~bad;
      count += __popc(K[b]);
    }
  }
  return count;
}

// A thread a word of the packed mask: its state count (word_planes); where
// a unit of four words keeps a state, the word's planes of kept states
// (keep: plane b, bit j for pixel j's state entered from b) and of S (nbr:
// plane d), and the unit appended to the active units (ctrl[CTRL_ACTIVE], a
// warp's units at once).
__global__ void __launch_bounds__(WORD_THREADS)
contour_states_kernel(const unsigned* __restrict__ mask, unsigned char* __restrict__ keep,
                      unsigned char* __restrict__ nbr, int* __restrict__ wordcount, int* __restrict__ active,
                      int* __restrict__ ctrl, long long words, int h, int wpr) {
  const long long gsize = static_cast<long long>(gridDim.x) * blockDim.x;
  const int lane = threadIdx.x & 31;
  for (long long w0 = static_cast<long long>(blockIdx.x) * blockDim.x; w0 < words; w0 += gsize) {
    const long long word = w0 + threadIdx.x;  // every lane of a warp goes round: the active units' ballot
    int count = 0;
    unsigned kp[8], sp[8];
    if (word < words) count = word_planes(mask, word, h, wpr, sp, kp);
    // units of four words (a warp's lanes 4u..4u + 3): a unit with a state is
    // listed once, and its words' bytes written (zero where a word keeps none)
    const unsigned found = __ballot_sync(0xffffffffu, count > 0);
    const bool lead = (lane & 3) == 0 && ((found >> lane) & 0xfu);
    const unsigned leaders = __ballot_sync(0xffffffffu, lead);
    int at = 0;
    if (lane == 0 && leaders) at = atomicAdd(ctrl + CTRL_ACTIVE, __popc(leaders));
    at = __shfl_sync(0xffffffffu, at, 0);
    if (word >= words) continue;
    wordcount[word] = count;
    if (!((found >> (lane & ~3)) & 0xfu)) continue;
    if (lead) active[at + __popc(leaders & ((1u << lane) - 1u))] = static_cast<int>(word / 4);
    if (!count)
#pragma unroll
      for (int d = 0; d < 8; ++d) kp[d] = sp[d] = 0;
    uint4* kq = reinterpret_cast<uint4*>(keep + 32 * word);
    uint4* sq = reinterpret_cast<uint4*>(nbr + 32 * word);
    kq[0] = make_uint4(kp[0], kp[1], kp[2], kp[3]);
    kq[1] = make_uint4(kp[4], kp[5], kp[6], kp[7]);
    sq[0] = make_uint4(sp[0], sp[1], sp[2], sp[3]);
    sq[1] = make_uint4(sp[4], sp[5], sp[6], sp[7]);
  }
}

// a word's eight planes (bit j of plane d: pixel j, direction d)
struct Planes {
  unsigned d[8];
};
__device__ __forceinline__ Planes load_planes(const unsigned char* __restrict__ p) {
  const uint4 a = __ldg(reinterpret_cast<const uint4*>(p)), b = __ldg(reinterpret_cast<const uint4*>(p) + 1);
  return {{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w}};
}
// pixel j's byte: bit d from plane d
__device__ __forceinline__ unsigned byte_of(const Planes& k, int j) {
  unsigned v = 0;
#pragma unroll
  for (int d = 0; d < 8; ++d) v |= ((k.d[d] >> j) & 1u) << d;
  return v;
}
// the states of the word's pixels before pixel j
__device__ __forceinline__ int states_before(const Planes& k, int j) {
  int c = 0;
#pragma unroll
  for (int d = 0; d < 8; ++d) c += __popc(k.d[d] & ((1u << j) - 1u));
  return c;
}

// one state's move and successor word
struct Move {
  int next, src;
  unsigned char succ, dir;
};

// The moves of the word's states, in order (pixels rising, b rising): each
// state's pixel (frame-local y * w + x) and move direction, and its
// successor's word and pixel in that word with the direction it is entered
// from (succ: j | back << 5), handed to put(x, move) from index x on.
template <class Put>
__device__ __forceinline__ void word_moves(const unsigned* P, const unsigned* K, long long word, int x, int h, int w,
                                           int wpr, Put put) {
  const unsigned row = static_cast<unsigned>(word) / static_cast<unsigned>(wpr);
  const int q = static_cast<int>(static_cast<unsigned>(word) - row * static_cast<unsigned>(wpr));
  const int y = static_cast<int>(row % static_cast<unsigned>(h));
  unsigned any = 0;
#pragma unroll
  for (int d = 0; d < 8; ++d) any |= K[d];
  for (; any; any &= any - 1) {
    const int j = __ffs(any) - 1;
    unsigned kb = 0, sb = 0;
#pragma unroll
    for (int d = 0; d < 8; ++d) {
      kb |= ((K[d] >> j) & 1u) << d;
      sb |= ((P[d] >> j) & 1u) << d;
    }
    const int px = 32 * q + j;
    for (; kb; kb &= kb - 1, ++x) {
      const int b = __ffs(kb) - 1;
      const int out = next_direction(sb, b);
      const int qx = px + step_x(out);
      put(x, Move{static_cast<int>((static_cast<long long>(row) + step_y(out)) * wpr + (qx >> 5)), y * w + px,
                  static_cast<unsigned char>((qx & 31) | ((out + 4) & 7) << 5), static_cast<unsigned char>(out)});
    }
  }
}

// A thread a word of an active unit (four words that keep a state): the
// word's planes again (word_planes) and its states' moves (word_moves)
// from its base (the scan of the counts).  STAGED, for frames of many
// small regions (the host takes it where the states are at least two a
// word): a warp's states, where their index range fits the STAGE states
// of its buffer, are staged in shared memory and written by the warp in
// order; else, and without STAGED, each thread writes its own.
template <bool STAGED>
__global__ void __launch_bounds__(WORD_THREADS)
contour_moves_kernel(const unsigned* __restrict__ mask, const int* __restrict__ wordcount,
                     const int* __restrict__ wordbase, const int* __restrict__ active, int* __restrict__ next0,
                     unsigned char* __restrict__ succ, int* __restrict__ src, unsigned char* __restrict__ dir,
                     int* __restrict__ entry_flag, const int* __restrict__ ctrl, long long words, int h, int w,
                     int wpr) {
  constexpr int STAGE = 512;  // a warp's staged states at most
  __shared__ Move s_move[STAGED ? WORD_THREADS / 32 : 1][STAGED ? STAGE : 1];
  __shared__ unsigned char s_here[STAGED ? WORD_THREADS / 32 : 1][STAGED ? STAGE : 1];
  const auto direct = [&](int x, const Move& m) {
    next0[x] = m.next;
    src[x] = m.src;
    succ[x] = m.succ;
    dir[x] = m.dir;
    entry_flag[x] = 0;
  };
  const long long lanes = 4LL * ctrl[CTRL_ACTIVE];
  const long long gsize = static_cast<long long>(gridDim.x) * blockDim.x;
  if constexpr (!STAGED) {
    for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; t < lanes; t += gsize) {
      const long long word = 4LL * active[t >> 2] + (t & 3);
      if (word >= words || wordcount[word] == 0) continue;
      unsigned P[8], K[8];
      word_planes(mask, word, h, wpr, P, K);
      word_moves(P, K, word, word == 0 ? 0 : wordbase[word - 1], h, w, wpr, direct);
    }
  } else {
    const int lane = threadIdx.x & 31, wib = threadIdx.x >> 5;
    for (int i = lane; i < STAGE; i += 32) s_here[wib][i] = 0;
    for (long long t0 = static_cast<long long>(blockIdx.x) * blockDim.x; t0 < lanes; t0 += gsize) {
      const long long t = t0 + threadIdx.x;  // every lane of a warp goes round: the warp's range
      const long long word = t < lanes ? 4LL * active[t >> 2] + (t & 3) : words;
      const bool here = word < words && wordcount[word] > 0;
      unsigned P[8], K[8];
      int x = INT_MAX, count = 0;
      if (here) {
        count = word_planes(mask, word, h, wpr, P, K);
        x = word == 0 ? 0 : wordbase[word - 1];
      }
      const int lo = __reduce_min_sync(0xffffffffu, static_cast<unsigned>(x));
      const int hi = static_cast<int>(__reduce_max_sync(0xffffffffu, here ? static_cast<unsigned>(x + count) : 0u));
      const bool staged = hi - lo <= STAGE;  // the range fits the warp's buffer
      if (here && staged)
        word_moves(P, K, word, x, h, w, wpr, [&](int i, const Move& m) {
          s_move[wib][i - lo] = m;
          s_here[wib][i - lo] = 1;
        });
      else if (here)
        word_moves(P, K, word, x, h, w, wpr, direct);
      __syncwarp();
      if (staged)
        for (int i = lane; i < hi - lo; i += 32) {
          if (!s_here[wib][i]) continue;  // another warp's state between this warp's words
          direct(lo + i, s_move[wib][i]);
          s_here[wib][i] = 0;
        }
      __syncwarp();
    }
  }
}

// A thread a state: its successor's index (that word's count, kept planes
// and base loaded together) over the word in
// next0, DEAD where the successor is not kept, or END of region s (-2 - s)
// where it is its region's first state (the successor's pixel is a local
// top, no region neighbour above or left, so its label and its region's
// start are read: it is that start, entered from max S).
__global__ void __launch_bounds__(WRITE_THREADS)
contour_links_kernel(const int* __restrict__ labels, const int* __restrict__ start,
                     const unsigned char* __restrict__ keep, const unsigned char* __restrict__ nbr,
                     const int* __restrict__ wordcount, const int* __restrict__ wordbase,
                     const unsigned char* __restrict__ succ, int* __restrict__ next0, int states, int h, int w,
                     int wpr, int nseg) {
  for (long long x = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; x < states;
       x += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long qword = next0[x];
    const int qj = succ[x] & 31, back = succ[x] >> 5;
    const int qcount = wordcount[qword];
    const int qbase = qword == 0 ? 0 : wordbase[qword - 1];
    const Planes kq = load_planes(keep + 32 * qword);  // stale where qcount is 0, then unused
    const unsigned kqb = byte_of(kq, qj);
    int nx = DEAD;
    if (qcount && ((kqb >> back) & 1u)) {
      nx = qbase + states_before(kq, qj) + __popc(kqb & ((1u << back) - 1u));
      // the start's first state is its highest kept (max S); then a local top?
      const unsigned sq = back == 31 - __clz(kqb) ? byte_of(load_planes(nbr + 32 * qword), qj) : 0xffu;
      if ((sq & 0xc3u) == 0 && back == 31 - __clz(sq)) {  // a local top, entered from max S
        const unsigned row = static_cast<unsigned>(qword / wpr);
        const int qx = 32 * static_cast<int>(qword - static_cast<long long>(row) * wpr) + qj;
        const int frame = static_cast<int>(row / static_cast<unsigned>(h));
        const int slot = frame * nseg + __ldg(labels + static_cast<long long>(row) * w + qx);
        if (__ldg(start + slot) == (static_cast<int>(row) - frame * h) * w + qx) nx = -2 - slot;  // the first state
      }
    }
    next0[x] = nx;
  }
}

// The ranking, one cooperative launch of resident blocks (see the file's
// head).  Links: a state index, DEAD, or END of region s as -2 - s; a
// chunk's (link, distance) pairs in shared memory, a link inside the chunk
// followed there.
__global__ void __launch_bounds__(RANK_THREADS)
contour_rank_kernel(const int* __restrict__ next0, const int* __restrict__ src, const unsigned char* __restrict__ dir,
                    const int* __restrict__ start, int* __restrict__ tgt, int* __restrict__ dist,
                    int* __restrict__ entry_flag, int* __restrict__ entries, int2* __restrict__ e0,
                    int2* __restrict__ e1, int* __restrict__ rank, int* __restrict__ region, int* __restrict__ counts,
                    long long* __restrict__ acc, long long* __restrict__ area2, int* ctrl, int states, int slots,
                    int w) {
  extern __shared__ int2 chunk_links[];
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x;
  const long long gtid = static_cast<long long>(blockIdx.x) * blockDim.x + tid;
  const long long gsize = static_cast<long long>(gridDim.x) * blockDim.x;
  volatile int* vctrl = ctrl;
  const long long t0 = now_ns();
  auto stamp = [&](int phase) {
    if (gtid == 0) ctrl[CTRL_TIMES + phase] = static_cast<int>(now_ns() - t0);
  };

  // (A) each chunk's pointers jumped in shared memory
  for (long long b0 = static_cast<long long>(blockIdx.x) * RANK_CHUNK; b0 < states;
       b0 += static_cast<long long>(gridDim.x) * RANK_CHUNK) {
    const int base = static_cast<int>(b0);
    const int cnt = states - base < RANK_CHUNK ? states - base : RANK_CHUNK;
    int2* cur = chunk_links;
    int2* nxt = chunk_links + RANK_CHUNK;
    int local = 0;
    for (int i = tid; i < cnt; i += blockDim.x) {
      const int nx = next0[base + i];
      cur[i] = make_int2(nx, nx >= 0 ? 1 : 0);
      local |= nx >= base && nx < base + cnt;
    }
    // a list in the chunk ends within ceil(log2 cnt) rounds; a link still
    // in the chunk then is on a cycle that never reaches END (a hole's)
    const int cap = cnt > 1 ? 32 - __clz(cnt - 1) : 0;
    int rounds = 0;
    while (__syncthreads_or(local) && rounds < cap) {
      local = 0;
      for (int i = tid; i < cnt; i += blockDim.x) {
        int2 v = cur[i];
        if (v.x >= base && v.x < base + cnt) {
          const int2 t = cur[v.x - base];
          v = make_int2(t.x, v.y + t.y);
          local |= v.x >= base && v.x < base + cnt;
        }
        nxt[i] = v;
      }
      int2* swap = cur;
      cur = nxt;
      nxt = swap;
      ++rounds;
    }
    for (int i0 = 0; i0 < cnt; i0 += blockDim.x) {  // every lane of a warp goes round: the entries' ballot
      const int i = i0 + tid;
      int t = DEAD;
      bool fresh = false;
      if (i < cnt) {
        const int2 v = cur[i];
        t = v.x >= base && v.x < base + cnt ? DEAD : v.x;
        tgt[base + i] = t;
        dist[base + i] = v.y;
        fresh = t >= 0 && atomicCAS(entry_flag + t, 0, 1) == 0;
      }
      const unsigned found = __ballot_sync(0xffffffffu, fresh);
      int at = 0;
      if ((tid & 31) == 0 && found) at = atomicAdd(ctrl + CTRL_ENTRIES, __popc(found));
      at = __shfl_sync(0xffffffffu, at, 0);
      if (fresh) entries[at + __popc(found & ((1u << (tid & 31)) - 1u))] = t;
    }
    if (tid == 0 && rounds) atomicMax(ctrl + CTRL_LOCAL, rounds);
    __syncthreads();  // the chunk's buffers are read before the next chunk's writes
  }
  for (long long s = gtid; s < slots; s += gsize) {
    acc[s] = 0;
    counts[s] = 0;
  }
  grid.sync();
  stamp(0);

  // (B) the entries jump among themselves, a grid-wide round at a time
  // (the first from their own links, tgt and dist); their lists end within
  // ceil(log2 ne) rounds, likewise
  const int ne = vctrl[CTRL_ENTRIES];
  const int cap = ne > 1 ? 32 - __clz(ne - 1) : 0;
  int2* cur = e0;
  int2* nxt = e1;
  int done = 0;  // rounds run
  for (; done < cap; ++done) {
    if (gtid == 0) ctrl[CTRL_ROUND + (done + 1) % 3] = 0;
    int active = 0;
    for (long long e = gtid; e < ne; e += gsize) {
      const int y = entries[e];
      int2 v = done ? cur[y] : make_int2(tgt[y], dist[y]);
      if (v.x >= 0) {
        const int2 t = done ? cur[v.x] : make_int2(tgt[v.x], dist[v.x]);
        v = make_int2(t.x, v.y + t.y);
        active += v.x >= 0;
      }
      nxt[y] = v;
    }
    if (__syncthreads_or(active) && tid == 0) atomicAdd(ctrl + CTRL_ROUND + done % 3, 1);
    grid.sync();
    int2* swap = cur;
    cur = nxt;
    nxt = swap;
    if (vctrl[CTRL_ROUND + done % 3] == 0) {
      ++done;
      break;
    }
  }
  if (gtid == 0) ctrl[CTRL_GLOBAL] = done;
  stamp(1);

  // (C) each state's rank and region (the END it reaches), or -1 off the
  // outer walks; each region's point count (its largest rank + 1) and
  // shoelace sum, added a warp's region at a time (one atomic each)
  for (long long x0 = static_cast<long long>(blockIdx.x) * blockDim.x; x0 < states; x0 += gsize) {
    const long long x = x0 + tid;  // every lane of a warp goes round: the regions' reductions
    int slot = -1, r = -1, cross = 0;
    if (x < states) {
      const int t = tgt[x];
      int code = t;
      r = dist[x];
      if (t >= 0) {
        const int2 e = done ? cur[t] : make_int2(tgt[t], dist[t]);
        code = e.x;
        r += e.y;
      }
      if (code < DEAD) {  // an END: else a dead end, or a state (a list that never ends, a cycle's)
        slot = -2 - code;
        const int p = src[x], d = dir[x];
        cross = (p % w) * step_y(d) - (p / w) * step_x(d);
        region[x] = slot;
      } else {
        r = -1;
      }
      rank[x] = r;
    }
    for (unsigned todo = __ballot_sync(0xffffffffu, slot >= 0); todo;) {
      const int lead = __ffs(todo) - 1;
      const int s = __shfl_sync(0xffffffffu, slot, lead);
      const bool mine = slot == s;
      const int sum = __reduce_add_sync(0xffffffffu, mine ? cross : 0);
      const unsigned most = __reduce_max_sync(0xffffffffu, mine ? static_cast<unsigned>(r + 1) : 0u);
      if ((tid & 31) == lead) {
        atomicAdd(reinterpret_cast<unsigned long long*>(acc + s), static_cast<unsigned long long>(
                                                                     static_cast<long long>(sum)));
        atomicMax(counts + s, static_cast<int>(most));
      }
      todo &= ~__ballot_sync(0xffffffffu, mine);
    }
  }
  grid.sync();
  stamp(2);
  // (D) an isolated pixel is one point; the doubled areas
  for (long long s = gtid; s < slots; s += gsize) {
    int c = counts[s];
    if (c == 0 && start[s] != INT_MAX) counts[s] = c = 1;
    const long long a = acc[s];
    area2[s] = c < 3 ? 0 : (a < 0 ? -a : a);
  }
  stamp(3);
}

// Each outer state's pixel at its region's offset + count - 1 - rank; an
// isolated pixel (a region of one point) at its offset.
__global__ void __launch_bounds__(WRITE_THREADS)
contour_write_kernel(const int* __restrict__ rank, const int* __restrict__ region, const int* __restrict__ src,
                     const int* __restrict__ start, const int* __restrict__ counts,
                     const long long* __restrict__ offsets, int* __restrict__ points, int states, int slots, int w) {
  const long long gtid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long gsize = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long x = gtid; x < states; x += gsize) {
    const int r = rank[x];
    if (r < 0) continue;
    const int slot = region[x], p = src[x];
    const long long at = offsets[slot] + counts[slot] - 1 - r;
    points[2 * at] = p % w;
    points[2 * at + 1] = p / w;
  }
  for (long long s = gtid; s < slots; s += gsize) {
    if (counts[s] != 1) continue;
    points[2 * offsets[s]] = start[s] % w;
    points[2 * offsets[s] + 1] = start[s] / w;
  }
}

bool valid(int n, int h, int w, int nseg) {
  return n >= 1 && n <= 65535 && h >= 1 && w >= 1 && nseg >= 1 && static_cast<long long>(h) * w <= INT_MAX / 2 &&
         static_cast<long long>(n) * h * ((w + 31) / 32) <= INT_MAX && static_cast<long long>(n) * nseg <= INT_MAX / 2;
}

unsigned word_blocks(long long words, int per_block) {
  const long long blocks = (words + per_block - 1) / per_block;
  return static_cast<unsigned>(blocks < 132 * 64 ? (blocks > 0 ? blocks : 1) : 132 * 64);
}

cudaError_t rank_shared(size_t* smem) {
  *smem = 2 * static_cast<size_t>(RANK_CHUNK) * sizeof(int2);
  return cudaFuncSetAttribute(contour_rank_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(*smem));
}

}  // namespace

// labels: (n, h, w) int32 compact labels; start: (n, nseg) int32; mask:
// (n, h, wpr) uint32, wpr = (w + 31) / 32; keep, nbr: (n, h, wpr, 32) uint8
// (written only for words that keep a state); wordcount and active: (n, h,
// wpr) int32, active receiving the units of four words that keep a state
// (ctrl[10] of them, in no order); ctrl: 11 int32, cleared here.  Three launches: the
// starts' fill, the seeds with the packed mask, the states.
extern "C" int yam_contour_seed(const void* labels, void* start, void* mask, void* keep, void* nbr, void* wordcount,
                                void* active, void* ctrl, int n, int h, int w, int nseg, void* stream) {
  if (!valid(n, h, w, nseg)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long slots = static_cast<long long>(n) * nseg;
  const int wpr = (w + 31) / 32, rows = n * h;
  long long init_blocks = (slots + 255) / 256;
  contour_init_kernel<<<static_cast<unsigned>(init_blocks < 1024 ? init_blocks : 1024), 256, 0, st>>>(
      static_cast<int*>(start), static_cast<int*>(ctrl), slots);
  const long long tasks = static_cast<long long>(n) * h * ((w + 1023) / 1024);
  long long blocks = (tasks + SEED_THREADS / 32 - 1) / (SEED_THREADS / 32);
  if (blocks > 132 * 16) blocks = 132 * 16;  // a grid-stride loop over the rows' chunks
  contour_seed_kernel<<<static_cast<unsigned>(blocks), SEED_THREADS, 0, st>>>(
      static_cast<const int*>(labels), static_cast<int*>(start), static_cast<unsigned*>(mask), n, h, w, wpr, nseg);
  const long long words = static_cast<long long>(rows) * wpr;
  contour_states_kernel<<<word_blocks(words, WORD_THREADS), WORD_THREADS, 0, st>>>(
      static_cast<const unsigned*>(mask), static_cast<unsigned char*>(keep), static_cast<unsigned char*>(nbr),
      static_cast<int*>(wordcount), static_cast<int*>(active), static_cast<int*>(ctrl), words, h, wpr);
  return static_cast<int>(cudaGetLastError());
}

// blocks: how many blocks of the ranking can be resident on the current
// device at once (what its cooperative launch takes).
extern "C" int yam_contour_rank_blocks(int* blocks) {
  size_t smem = 0;
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = rank_shared(&smem);
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, contour_rank_kernel, RANK_THREADS, smem);
  *blocks = per_sm * sms;
  return static_cast<int>(err);
}

// After the inclusive scan of wordcount into wordbase ((n, h, wpr) int32;
// states = its last value): the moves and links (states-long next0, src
// int32, succ and dir uint8, entry_flag int32) and the ranking (tgt, dist, entries, rank,
// region int32 and e0, e1 int2, states long; counts (n, nseg) int32, acc and
// area2 (n, nseg) int64; ctrl 11 int32: ctrl[0] receives the entries,
// ctrl[1] and ctrl[2] the most rounds a chunk took and the entry rounds,
// ctrl[6..9] the ranking's phases' ends in ns).  Three launches: the
// moves, the links, the ranking (cooperative, over `blocks` blocks).
extern "C" int yam_contour_rank(const void* labels, const void* start, const void* mask, const void* keep,
                                const void* nbr, const void* wordcount, const void* wordbase, const void* active,
                                void* next0,
                                void* succ, void* src, void* dir, void* entry_flag, void* tgt, void* dist,
                                void* entries, void* e0, void* e1, void* rank, void* region, void* counts, void* acc,
                                void* area2, void* ctrl, int states, int blocks, int n, int h, int w, int nseg,
                                void* stream) {
  if (!valid(n, h, w, nseg) || states < 0 || blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int wpr = (w + 31) / 32, rows = n * h;
  int slots = n * nseg;
  int* nx = static_cast<int*>(next0);
  int* sr = static_cast<int*>(src);
  unsigned char* dr = static_cast<unsigned char*>(dir);
  int* ef = static_cast<int*>(entry_flag);
  int* c = static_cast<int*>(ctrl);
  const long long words = static_cast<long long>(rows) * wpr;
  const unsigned char* kp = static_cast<const unsigned char*>(keep);
  const unsigned char* np = static_cast<const unsigned char*>(nbr);
  const int* wb = static_cast<const int*>(wordbase);
  unsigned char* sc = static_cast<unsigned char*>(succ);
  const unsigned* mk = static_cast<const unsigned*>(mask);
  const int* wc = static_cast<const int*>(wordcount);
  const int* ac_units = static_cast<const int*>(active);
  if (states >= 2 * words)  // many states a word: a frame of many small regions
    contour_moves_kernel<true><<<word_blocks(words, WORD_THREADS), WORD_THREADS, 0, st>>>(
        mk, wc, wb, ac_units, nx, sc, sr, dr, ef, c, words, h, w, wpr);
  else
    contour_moves_kernel<false><<<word_blocks(words, WORD_THREADS), WORD_THREADS, 0, st>>>(
        mk, wc, wb, ac_units, nx, sc, sr, dr, ef, c, words, h, w, wpr);
  if (states > 0) {
    long long link_blocks = (static_cast<long long>(states) + WRITE_THREADS - 1) / WRITE_THREADS;
    contour_links_kernel<<<static_cast<unsigned>(link_blocks < 132 * 64 ? link_blocks : 132 * 64), WRITE_THREADS, 0,
                           st>>>(static_cast<const int*>(labels), static_cast<const int*>(start), kp, np,
                                 static_cast<const int*>(wordcount), wb, sc, nx, states, h, w, wpr, nseg);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  size_t smem = 0;
  err = rank_shared(&smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int* cnx = nx;
  const int* csr = sr;
  const unsigned char* cdr = dr;
  const int* cst = static_cast<const int*>(start);
  int* tg = static_cast<int*>(tgt);
  int* ds = static_cast<int*>(dist);
  int* en = static_cast<int*>(entries);
  int2* a0 = static_cast<int2*>(e0);
  int2* a1 = static_cast<int2*>(e1);
  int* rk = static_cast<int*>(rank);
  int* rg = static_cast<int*>(region);
  int* ct = static_cast<int*>(counts);
  long long* ac = static_cast<long long*>(acc);
  long long* ar = static_cast<long long*>(area2);
  void* args[] = {&cnx, &csr, &cdr, &cst, &tg, &ds, &ef, &en, &a0, &a1, &rk, &rg, &ct, &ac, &ar, &c,
                  &states, &slots, &w};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(contour_rank_kernel), dim3(blocks),
                                    dim3(RANK_THREADS), args, smem, st);
  if (err != cudaSuccess) {
    cudaGetLastError();  // a refused launch leaves its error behind for the next launch's check: take it
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

// After the exclusive scan of counts into offsets ((n * nseg + 1) int64):
// the points (at least offsets[-1] rows of (x, y) int32).
extern "C" int yam_contour_write(const void* rank, const void* region, const void* src, const void* start,
                                 const void* counts, const void* offsets, void* points, int states, int n, int w,
                                 int nseg, void* stream) {
  if (n < 1 || w < 1 || nseg < 1 || states < 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long slots = static_cast<long long>(n) * nseg;
  const long long work = states > slots ? states : slots;
  long long blocks = (work + WRITE_THREADS - 1) / WRITE_THREADS;
  if (blocks > 132 * 8) blocks = 132 * 8;
  contour_write_kernel<<<static_cast<unsigned>(blocks), WRITE_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(rank), static_cast<const int*>(region), static_cast<const int*>(src),
      static_cast<const int*>(start), static_cast<const int*>(counts), static_cast<const long long*>(offsets),
      static_cast<int*>(points), states, static_cast<int>(slots), w);
  return static_cast<int>(cudaGetLastError());
}
