// The engine step of madsim_tpu_torch as one CUDA kernel for sm_90a.
//
// Replaces madsim_tpu/engine/pallas_step.py::make_pallas_step (:56), the JAX
// package's Pallas kernel (pallas_batched_step :65, body `kernel` :95, the
// pl.pallas_call at :132), whose body is the vmapped per-world step
// DeviceEngine._build_step (madsim_tpu/engine/core.py) with the Raft actor
// traced in. Its plain version is DeviceEngine.step_plain in
// madsim_tpu_torch/engine/core.py; the two agree bit for bit on every state
// leaf, and the port's tests hold the plain version to the JAX one. One
// launch is one step of every world, in place (the Pallas kernel's
// input_output_aliases).
//
// Bound: memory. A step does about a thousand integer operations per world,
// but it must read the queue's time lane whole (the pop scans every slot),
// the meta lane whole only where a node is paused (else the popped slot's
// word), the commit row, and the log entries over each node pair's
// committed prefix, besides one payload row and the rows the handler
// touches; chip_smoke.py's needed_bytes counts those bytes. This kernel
// stages the meta and log lanes whole for every active world, so it reads
// more than that count.
//
// Design. One thread per world, a block of B worlds; the tile plan (B, the
// padded strides, the shared-memory offsets, the access widths) comes from
// engine/step_kernel.py::tile_plan.
// - Coalesced world tiles. The lanes a step reads whole -- q_time, q_meta,
//   commit, log_term, log_cmd -- are staged through shared memory. The
//   block's worlds own a contiguous range of each lane; the block copies it
//   in with asynchronous copies (cp.async), neighbouring threads on
//   neighbouring addresses (16 B a thread for the queue lanes when
//   Q % 4 == 0), one padded row per world, while each thread reads its
//   world's scalars into registers; each thread then works on its own rows
//   there. Strides are padded against bank conflicts: a queue row is an odd
//   number of 16-byte chunks (Q=28 -> 7, unpadded; Q=64 -> 17), so the eight
//   threads of a quarter warp reading a chunk each, as the pop does, hit
//   all 32 banks; the int16 tiles' stride is 2 mod 4, an odd number of
//   words, so 32 threads reading an int16 each hit 32 banks.
// - Write-back of only what changed. The pop's clear and the inserts touch
//   a few slots; each world marks the 16-byte chunks of its queue rows that
//   it changed, and the block writes back those chunks of the tiles,
//   coalesced. The handler's changed int16s of commit and the log go
//   straight to device memory, and to the tile for the invariant. Every
//   other lane is written only where its value changes.
// - Only active worlds read tiles. Where more than half of a block is
//   active the block copies its whole range of each lane, coalesced; else
//   each active world copies its own rows. A block with no active world
//   copies no tile: a frozen world evaluates only the depth high-water mark
//   and the invariant, as the plain step does, and the invariant compares
//   no entry unless two of its nodes have committed (then it reads their
//   rows in device memory). Its flags, depth and commit row come in one
//   batch with its active flag.
// - No local memory. The outbox is never built: the insert gives the i-th
//   enabled entry the i-th lowest free slot, in entry order, so each entry
//   is generated from the handler's scalars and written into its slot in
//   turn. The popped payload row is read once into registers before the
//   first queue write (entry 0 may take its slot), together with the
//   handler's node row. The kernel is a template on the node count N,
//   instantiated for N = 1..8 and chosen at launch, so per-node rows are
//   register arrays indexed only by counters of fully unrolled loops; rows
//   indexed at run time are bit masks or packed int16s in registers.
// - Short dependency chains. The messages' latency draws (counters
//   ctr+2i) are taken two at a time together with the timer's election
//   delay, three interleaved Threefry chains; where loss > 0 their loss
//   draws (ctr+2i+1) come first. A draw whose value no sent event uses is
//   not computed (draws are pure functions of the counter; the cursor
//   still advances as the plain step's does).
// - The payload lane stays in device memory: one row read per active world,
//   one row written per insert, as 16-byte vectors when P is 8 or 16.
// - The write-only lanes stay in device memory too. With the metrics block
//   on (EngineConfig(metrics=True)), an active world adds each nonzero
//   increment to its counters, and one to the histogram bins it addresses;
//   with the flight recorder on (blackbox=K), a world that processed an
//   event, or whose bug flag rose, writes one record at slot pos % K. The
//   counts come from the step as it runs (the sends offered, clogged and
//   lost, the inserts refused for a saturated time or a full queue), so
//   nothing is rebuilt for them. Nothing reads these lanes, so turning
//   them on changes no other leaf; they are null pointers when off.
//
// Exactness rules kept here (each a place where a plain reading gives a
// different bit): int8/int16 lane writes saturate, except the generation
// lane, which wraps mod 256; gathers clamp their index, masked writes at an
// out-of-range index write nothing; signed arithmetic that may wrap is done
// in uint32; float work is round-to-nearest multiplies (built with
// --fmad=false, never fast math).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_N = 8;
constexpr int MAX_P = 16;
constexpr int MAX_Q = 256;
constexpr int MAX_L = 64;
constexpr int MAX_BLOCK = 1024;
constexpr int SMEM_MAX = 232448;
constexpr int WON = 4;
constexpr int32_t INF_TIME = 0x7FFFFFFF;

constexpr int FLAG_TIMER = 1;
constexpr int FLAG_FAULT = 2;

// Fault ops (event kind when FLAG_FAULT is set).
constexpr int FAULT_KILL = 0, FAULT_RESTART = 1, FAULT_CLOG_NODE = 2,
              FAULT_UNCLOG_NODE = 3, FAULT_CLOG_LINK = 4,
              FAULT_UNCLOG_LINK = 5, FAULT_SET_LATENCY = 6,
              FAULT_SET_LOSS = 7, FAULT_PAUSE = 8, FAULT_RESUME = 9;

// Raft event kinds and roles.
constexpr int K_ELECTION = 0, K_HEARTBEAT = 1, K_REQVOTE = 2,
              K_VOTEREPLY = 3, K_APPEND = 4, K_APPENDREPLY = 5,
              K_PROPOSE = 6, NUM_KINDS = 7;
constexpr int FOLLOWER = 0, CANDIDATE = 1, LEADER = 2;

// State leaves, in the order of madsim_tpu_torch.engine.core.tree_leaves.
struct State {
  int32_t* now;
  int32_t* q_time;
  int32_t* q_meta;
  int16_t* q_payload;
  uint32_t* k0;
  uint32_t* k1;
  uint32_t* counter;
  uint8_t* alive;
  int8_t* gen;
  uint8_t* paused;
  uint8_t* clog_node;
  uint8_t* clog_link;
  int16_t* term;
  int8_t* voted_for;
  int8_t* role;
  int32_t* votes;
  int16_t* commit;
  int16_t* log_len;
  int16_t* log_term;
  int16_t* log_cmd;
  int16_t* next_idx;
  int16_t* match_idx;
  int16_t* elect_epoch;
  int32_t* first_leader_time;
  int32_t* elections_won;
  int32_t* won_terms;
  uint8_t* active;
  int32_t* steps;
  int32_t* delivered;
  int32_t* dropped;
  uint8_t* overflow;
  int16_t* qdepth;
  int16_t* qmax;
  uint8_t* bug;
  int32_t* bug_time;
  int32_t* lat_min;
  int32_t* lat_max;
  float* loss;
  // The optional, write-only lanes, in device memory (never tiled): the
  // metrics block (EngineConfig(metrics=True)) and the flight-recorder
  // ring (EngineConfig(blackbox=K)); null when off.
  int32_t* m_msgs_sent;
  int32_t* m_msgs_delivered;
  int32_t* m_timer_fires;
  int32_t* m_drop_loss;
  int32_t* m_drop_stale;
  int32_t* m_drop_dead;
  int32_t* m_drop_out_of_time;
  int32_t* m_enqueued;
  int32_t* m_drop_overflow;
  int32_t* m_drop_inf;
  int32_t* m_vtime_us;
  int32_t* m_fault_hist;  // (W, NUM_FAULT_KINDS)
  int32_t* m_kind_hist;   // (W, num_kinds)
  int32_t* bb_pos;
  int16_t* bb_step_lo;    // (W, K) each
  int16_t* bb_t_lo;
  int16_t* bb_t_hi;
  int8_t* bb_kind;
  int8_t* bb_src;
  int8_t* bb_dst;
  int8_t* bb_flags;
};
constexpr int N_BASE_LEAVES = 38, N_METRICS = 13, N_RING = 8;
constexpr int N_PTRS = N_BASE_LEAVES + N_METRICS + N_RING;
constexpr int NUM_FAULT_KINDS = 10;

// Flag bits of a flight-recorder record (obs/blackbox.py BB_*).
constexpr int BB_TIMER = 1, BB_FAULT = 2, BB_DROP_STALE = 4, BB_DROP_DEAD = 8,
              BB_RAISE = 16, BB_MARKER = 32;

// The engine's parameters, then the tile plan (step_kernel.py TilePlan):
// row strides of the shared tiles, global access widths in bytes, and the
// byte offsets of the tiles in dynamic shared memory (q_time's is 0).
struct Params {
  int W, N, Q, P, L, won;
  int t_limit_us, stop_on_bug;
  int elect_min_us, elect_max_us, heartbeat_us, buggy_double_vote;
  int smem_bytes;
  int q_stride;       // int32 per world row of the q_time / q_meta tiles
  int commit_stride;  // int16 per world row of the commit tile
  int log_stride;     // int16 per world row of the log_term / log_cmd tiles
  int q_unit, commit_unit, log_unit, pay_unit;
  int off_qm, off_dirty, off_commit, off_lt, off_lc;
  // The optional lanes: metrics on (0/1), the kind histogram's width, and
  // the ring depth K (0: off). Uniform over the grid.
  int metrics, num_kinds, bb_k;
};
constexpr int N_PARAMS = 28;

__device__ __forceinline__ int clampi(int32_t x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}
__device__ __forceinline__ int16_t sat16(int32_t x) {
  return (int16_t)clampi(x, -32768, 32767);
}
__device__ __forceinline__ int8_t sat8(int32_t x) {
  return (int8_t)clampi(x, -128, 127);
}

// ---------------------------------------------------------------------------
// Threefry-2x32, 20 rounds (Random123), and the two draw mappings.
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t c0, uint32_t c1,
                                             uint32_t& o0, uint32_t& o1) {
  const int rot[8] = {13, 15, 26, 6, 17, 29, 16, 24};
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  uint32_t x0 = c0 + k0, x1 = c1 + k1;
#pragma unroll
  for (int i = 0; i < 5; i++) {
#pragma unroll
    for (int r = 0; r < 4; r++) {
      x0 += x1;
      x1 = rotl32(x1, rot[4 * (i % 2) + r]);
      x1 ^= x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
  o0 = x0;
  o1 = x1;
}

// Three draws: the first output word of Threefry-2x32/20 at three
// counters. The three calls share no value, so the compiler interleaves
// their rounds.
__device__ __forceinline__ void draw3(uint32_t k0, uint32_t k1, uint32_t ca,
                                      uint32_t cb, uint32_t cc, uint32_t& ra,
                                      uint32_t& rb, uint32_t& rc) {
  uint32_t unused;
  threefry2x32(k0, k1, ca, 0u, ra, unused);
  threefry2x32(k0, k1, cb, 0u, rb, unused);
  threefry2x32(k0, k1, cc, 0u, rc, unused);
}

// [low, high) by the unsigned modulo of uint32(high - low).
__device__ __forceinline__ int32_t u32_to_range(uint32_t x, int32_t low,
                                                int32_t high) {
  uint32_t width = (uint32_t)high - (uint32_t)low;
  return (int32_t)((uint32_t)low + x % width);
}

// [0, 1) from the top 24 bits: exact.
__device__ __forceinline__ float u32_to_unit(uint32_t x) {
  return __fmul_rn((float)(x >> 8), 5.9604644775390625e-08f);
}

__device__ __forceinline__ int32_t pack_meta(int32_t kind, int32_t flags,
                                             int32_t src, int32_t dst,
                                             int32_t gen) {
  uint32_t m = ((uint32_t)kind & 0x3Fu) | (((uint32_t)flags & 0x3u) << 6) |
               (((uint32_t)src & 0xFFu) << 8) |
               (((uint32_t)dst & 0xFFu) << 16) |
               (((uint32_t)gen & 0xFFu) << 24);
  return (int32_t)m;
}

__device__ __forceinline__ int32_t join_wide(int32_t lo, int32_t hi) {
  return (int32_t)(((uint32_t)lo & 0xFFFFu) | ((uint32_t)hi << 16));
}

// ---------------------------------------------------------------------------
// The write-only lanes: metrics counters and flight-recorder records.
// ---------------------------------------------------------------------------
// A counter's read-modify-write in device memory, skipped for a zero
// increment; int32 adds wrap.
__device__ __forceinline__ void count(int32_t* lane, size_t at, int32_t d) {
  if (d != 0) lane[at] = (int32_t)((uint32_t)lane[at] + (uint32_t)d);
}

// One ring record of world w at slot pos % K. steps is the pre-step count
// (wrapped to int16), t the event's time or, for a marker, the clock.
__device__ __forceinline__ void ring_record(const State& s, const Params& p,
                                            size_t w, int32_t steps,
                                            int32_t t, int kind, int src,
                                            int dst, int flags) {
  const int k = p.bb_k;
  const int32_t pos = s.bb_pos[w];
  int slot = pos % k;
  if (slot < 0) slot += k;
  const size_t at = w * (size_t)k + slot;
  s.bb_pos[w] = (int32_t)((uint32_t)pos + 1u);
  s.bb_step_lo[at] = (int16_t)(uint16_t)((uint32_t)steps & 0xFFFFu);
  s.bb_t_lo[at] = (int16_t)(uint16_t)((uint32_t)t & 0xFFFFu);
  s.bb_t_hi[at] = (int16_t)(t >> 16);
  s.bb_kind[at] = sat8(kind);
  s.bb_src[at] = sat8(src);
  s.bb_dst[at] = sat8(dst);
  s.bb_flags[at] = (int8_t)flags;
}

// ---------------------------------------------------------------------------
// Shared-memory world tiles.
// ---------------------------------------------------------------------------
// Asynchronous copies of 4, 8 or 16 bytes from device to shared memory
// (cp.async): each thread issues all of its copies back to back and the
// block waits for them once, so the load latency is paid once a step, not
// once an access.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
                 "l"(src), "n"(BYTES)
                 : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Copies rows [0, rows) of a range of a lane (row0 is its first world;
// row_bytes per world, contiguous) into a tile whose rows are stride_bytes
// apart, in accesses of BYTES: this thread takes accesses first,
// first+step, ... Over a block's range, thread t of B takes t, t+B, ..., so
// a warp reads 32 neighbouring accesses; over one world's own rows a thread
// takes them all (first 0, step 1). Accesses of 4 bytes or more are
// asynchronous; 2-byte ones go through registers, read on the read-only
// path (this step writes these rows only after the block's barrier).
template <int BYTES>
__device__ __forceinline__ void tile_in(char* tile, const void* lane,
                                        size_t row0, int rows, int row_bytes,
                                        int stride_bytes, int first,
                                        int step) {
  const int units = row_bytes / BYTES;
  const char* src = static_cast<const char*>(lane) + row0 * (size_t)row_bytes;
  int r = first / units, c = first - r * units;
  const int dr = step / units, dc = step - dr * units;
#pragma unroll 4
  for (int e = first; e < rows * units; e += step) {
    char* d = tile + r * stride_bytes + c * BYTES;
    const char* g = src + (size_t)e * BYTES;
    if constexpr (BYTES >= 4)
      cp_async<BYTES>(d, g);
    else
      *reinterpret_cast<short*>(d) = __ldg(reinterpret_cast<const short*>(g));
    r += dr;
    c += dc;
    if (c >= units) {
      c -= units;
      r++;
    }
  }
}

__device__ __forceinline__ void tile_in_any(int unit, char* tile,
                                            const void* lane, size_t row0,
                                            int rows, int row_bytes,
                                            int stride_bytes, int first,
                                            int step) {
  if (unit == 16)
    tile_in<16>(tile, lane, row0, rows, row_bytes, stride_bytes, first, step);
  else if (unit == 8)
    tile_in<8>(tile, lane, row0, rows, row_bytes, stride_bytes, first, step);
  else if (unit == 4)
    tile_in<4>(tile, lane, row0, rows, row_bytes, stride_bytes, first, step);
  else
    tile_in<2>(tile, lane, row0, rows, row_bytes, stride_bytes, first, step);
}

// Writes back the accesses of a queue tile (int32 slots) that lie in a
// 4-slot chunk marked in its world's dirty mask (dirty[r] for row r), the
// accesses shared out as tile_in shares them.
template <typename U>
__device__ __forceinline__ void tile_out(void* lane, const char* tile,
                                         size_t row0, int rows, int row_bytes,
                                         int stride_bytes,
                                         const uint64_t* dirty, int first,
                                         int step) {
  const int units = row_bytes / (int)sizeof(U);
  constexpr int SLOTS = (int)sizeof(U) / 4;
  U* dst = reinterpret_cast<U*>(static_cast<char*>(lane) +
                                row0 * (size_t)row_bytes);
  int r = first / units, c = first - r * units;
  const int dr = step / units, dc = step - dr * units;
  for (int e = first; e < rows * units; e += step) {
    if ((dirty[r] >> ((c * SLOTS) >> 2)) & 1u)
      dst[e] = *reinterpret_cast<const U*>(tile + r * stride_bytes +
                                           c * (int)sizeof(U));
    r += dr;
    c += dc;
    if (c >= units) {
      c -= units;
      r++;
    }
  }
}

__device__ __forceinline__ void tile_out_any(int unit, void* lane,
                                             const char* tile, size_t row0,
                                             int rows, int row_bytes,
                                             int stride_bytes,
                                             const uint64_t* dirty, int first,
                                             int step) {
  if (unit == 16)
    tile_out<int4>(lane, tile, row0, rows, row_bytes, stride_bytes, dirty,
                   first, step);
  else if (unit == 8)
    tile_out<int2>(lane, tile, row0, rows, row_bytes, stride_bytes, dirty,
                   first, step);
  else
    tile_out<int>(lane, tile, row0, rows, row_bytes, stride_bytes, dirty,
                  first, step);
}

// ---------------------------------------------------------------------------
// Per-world views of the state rows. The node count N is a template
// parameter throughout: every per-node loop has a constant trip count.
// ---------------------------------------------------------------------------
template <int N>
struct World {
  int L;
  int16_t* term;
  int8_t* voted_for;
  int8_t* role;
  int32_t* votes;
  int16_t* log_len;
  int16_t* elect_epoch;
  int16_t* next_idx;   // (N, N)
  int16_t* match_idx;  // (N, N)
  int32_t* won_terms;  // (N, WON)
  int32_t* first_leader_time;
  int32_t* elections_won;
  int16_t* commit;     // device memory, (N,)
  int16_t* log_term;   // device memory, (N, L)
  int16_t* log_cmd;
  int16_t* commit_s;   // this world's rows of the shared tiles
  int16_t* log_term_s;
  int16_t* log_cmd_s;

  __device__ __forceinline__ World(const State& s, size_t w, int l,
                                   int16_t* cs, int16_t* lts, int16_t* lcs)
      : L(l),
        term(s.term + w * N), voted_for(s.voted_for + w * N),
        role(s.role + w * N), votes(s.votes + w * N),
        log_len(s.log_len + w * N), elect_epoch(s.elect_epoch + w * N),
        next_idx(s.next_idx + w * N * N), match_idx(s.match_idx + w * N * N),
        won_terms(s.won_terms + w * N * WON),
        first_leader_time(s.first_leader_time + w),
        elections_won(s.elections_won + w),
        commit(s.commit + w * N), log_term(s.log_term + w * N * l),
        log_cmd(s.log_cmd + w * N * l),
        commit_s(cs), log_term_s(lts), log_cmd_s(lcs) {}

  __device__ __forceinline__ void set_commit(int i, int16_t x) const {
    if (commit_s[i] != x) {
      commit_s[i] = x;
      commit[i] = x;
    }
  }
  __device__ __forceinline__ void set_log(int i, int k, int16_t t,
                                          int16_t c) const {
    const int at = i * L + k;
    if (log_term_s[at] != t) {
      log_term_s[at] = t;
      log_term[at] = t;
    }
    if (log_cmd_s[at] != c) {
      log_cmd_s[at] = c;
      log_cmd[at] = c;
    }
  }
};

template <typename T>
__device__ __forceinline__ void store_if(T* p, int32_t old, T x) {
  if ((int32_t)x != old) *p = x;
}

// Raft invariant: log matching on the committed prefix of every node pair,
// over the shared tiles.
template <int N>
__device__ __forceinline__ bool raft_invariant(const World<N>& v) {
  const int L = v.L;
#pragma unroll
  for (int i = 0; i < N; i++) {
#pragma unroll
    for (int j = i + 1; j < N; j++) {
      int ci = v.commit_s[i], cj = v.commit_s[j];
      int lim = ci < cj ? ci : cj;
      if (lim > L) lim = L;
      const int16_t *ti = v.log_term_s + i * L, *tj = v.log_term_s + j * L;
      const int16_t *mi = v.log_cmd_s + i * L, *mj = v.log_cmd_s + j * L;
      for (int k = 0; k < lim; k++)
        if (ti[k] != tj[k] || mi[k] != mj[k]) return true;
    }
  }
  return false;
}

// The popped event's payload words 0..7, widened: eight scalars, passed by
// value. (An array of them passed by reference into the inlined handler
// was misread by nvcc 12.8's optimizer -- see PERF.md.)
struct Payload {
  int32_t w0, w1, w2, w3, w4, w5, w6, w7;
};

// Up to 8 int16 values packed in two words, read at a runtime index by
// shifts (an array would be indexed in local memory).
struct Packed16 {
  uint64_t lo, hi;
  __device__ __forceinline__ int32_t get(int i) const {
    const uint64_t x = i < 4 ? lo >> (16 * i) : hi >> (16 * (i - 4));
    return (int32_t)(int16_t)(uint16_t)(x & 0xFFFFu);
  }
};

// Node me's Raft row, read together with the popped payload.
struct RaftRow {
  int32_t term, voted_for, role, votes, log_len, elect_epoch;
  Packed16 next_idx, match_idx;
};

template <int N>
__device__ __forceinline__ RaftRow load_row(const World<N>& v, int me) {
  RaftRow r;
  r.term = v.term[me];
  r.voted_for = v.voted_for[me];
  r.role = v.role[me];
  r.votes = v.votes[me];
  r.log_len = v.log_len[me];
  r.elect_epoch = v.elect_epoch[me];
  r.next_idx.lo = r.next_idx.hi = r.match_idx.lo = r.match_idx.hi = 0ull;
#pragma unroll
  for (int i = 0; i < N; i++) {
    const uint64_t n = (uint16_t)v.next_idx[me * N + i];
    const uint64_t m = (uint16_t)v.match_idx[me * N + i];
    if (i < 4) {
      r.next_idx.lo |= n << (16 * i);
      r.match_idx.lo |= m << (16 * i);
    } else {
      r.next_idx.hi |= n << (16 * (i - 4));
      r.match_idx.hi |= m << (16 * (i - 4));
    }
  }
  return r;
}

// The outbox as scalars. Entry i < N is a message to node i, valid where
// bit i of msg_mask is set; its payload is either the append row built from
// next_idx[me][i] (byte i of `next`, clamped to [1, L+1]) and the log
// (bcast) or words w0..w3. Entry N is the timer.
struct Sends {
  uint32_t msg_mask;
  bool bcast;
  uint64_t next;
  int32_t msg_kind, me;
  int32_t w0, w1, w2, w3;
  int32_t term, llen, commit;
  bool t_valid;
  int32_t t_kind, t_dst, t_delay, t_pay0;
  // An election timer's delay is a draw in [elect_min, elect_max) at
  // counter t_ctr, taken with the messages' draws (t_delay holds it after).
  bool t_draw;
  uint32_t t_ctr;
};

__device__ __forceinline__ Sends no_sends() {
  Sends sd;
  sd.msg_mask = 0u;
  sd.bcast = false;
  sd.next = 0ull;
  sd.msg_kind = sd.me = 0;
  sd.w0 = sd.w1 = sd.w2 = sd.w3 = 0;
  sd.term = sd.llen = sd.commit = 0;
  sd.t_valid = false;
  sd.t_kind = sd.t_dst = sd.t_delay = sd.t_pay0 = 0;
  sd.t_draw = false;
  sd.t_ctr = 0u;
  return sd;
}

// RaftActor.on_restart: volatile state resets, a fresh election timer.
template <int N>
__device__ __forceinline__ void raft_on_restart(const World<N>& v, int node,
                                                uint32_t& ctr, Sends& sd) {
  const int me = clampi(node, 0, N - 1);
  const int32_t epoch_me = v.elect_epoch[me];
  const int32_t epoch2 = epoch_me + 1;
  store_if<int8_t>(v.role + me, v.role[me], FOLLOWER);
  store_if<int32_t>(v.votes + me, v.votes[me], 0);
  v.set_commit(me, 0);
#pragma unroll
  for (int j = 0; j < N; j++) {
    store_if<int16_t>(v.next_idx + me * N + j, v.next_idx[me * N + j], 1);
    store_if<int16_t>(v.match_idx + me * N + j, v.match_idx[me * N + j], 0);
  }
  store_if(v.elect_epoch + me, epoch_me, sat16(epoch2));
  sd.t_valid = true;
  sd.t_kind = K_ELECTION;
  sd.t_dst = me;
  sd.t_draw = true;
  sd.t_ctr = ctr;
  sd.t_pay0 = epoch2;
  ctr += 1u;
}

// A node's log term at 1-based index idx (0 before the log).
__device__ __forceinline__ int32_t row_term_at(const int16_t* row, int L,
                                               int32_t idx) {
  return idx <= 0 ? 0 : (int32_t)row[clampi(idx - 1, 0, L - 1)];
}

// RaftActor.handle: the merged handler of every event kind. Reads the
// popped payload from registers, writes row `me` in place, and leaves the
// sends in `sd`.
template <int N>
__device__ __forceinline__ void raft_handle(const Params& p, const World<N>& v,
                                            int ev_kind, int ev_dst,
                                            const Payload pay, const RaftRow row,
                                            int32_t now, uint32_t& ctr,
                                            Sends& sd, bool& hist_bug) {
  const int L = v.L;
  const int kind = clampi(ev_kind, 0, NUM_KINDS - 1);
  const int me = clampi(ev_dst, 0, N - 1);
  // Node tests in the loops over nodes are bit-mask tests: nvcc 12.8 at
  // -O3 miscompiled `i == follower` in the unrolled loop below (PERF.md).
  const uint32_t me_bit = 1u << me;
  const int32_t t = pay.w0;
  const bool is_elec = kind == K_ELECTION, is_hb = kind == K_HEARTBEAT,
             is_rv = kind == K_REQVOTE, is_vr = kind == K_VOTEREPLY,
             is_ap = kind == K_APPEND, is_ar = kind == K_APPENDREPLY,
             is_pr = kind == K_PROPOSE;

  // -- shared step-down; the views below are of the stepped-down row --
  const bool sd_kind = is_rv || is_vr || is_ap || is_ar;
  const int32_t term_pre = row.term;
  const int32_t role_pre = row.role;
  const int32_t voted_pre = row.voted_for;
  const bool higher = sd_kind && t > term_pre;
  const bool demote =
      higher || (is_ap && t == term_pre && role_pre == CANDIDATE);
  const int32_t term_me = sat16(higher ? t : term_pre);
  const int32_t voted_me = sat8(higher ? -1 : voted_pre);
  const int32_t role_me = sat8(demote ? FOLLOWER : role_pre);
  const int32_t votes_me = row.votes;
  const int32_t commit_me = v.commit_s[me];
  const int32_t llen_me = row.log_len;
  const int32_t epoch_me = row.elect_epoch;
  const int16_t* lt_row = v.log_term_s + me * L;
  const int16_t* lc_row = v.log_cmd_s + me * L;
  const int32_t my_last_term = row_term_at(lt_row, L, llen_me);
  const bool reject = t < term_me;

  // -- election fire --
  const bool fire = is_elec && pay.w0 == epoch_me && role_me != LEADER;
  const int32_t term2 = term_me + 1;

  // -- reqvote grant --
  const int cand = clampi(pay.w1, 0, N - 1);
  const bool up_to_date =
      pay.w3 > my_last_term || (pay.w3 == my_last_term && pay.w2 >= llen_me);
  const bool can_vote =
      p.buggy_double_vote || voted_me == -1 || voted_me == cand;
  const bool grant = is_rv && !reject && up_to_date && can_vote;
  const int32_t epoch2 = epoch_me + 1;

  // One election-delay draw, for the kinds that draw (the cursor advances
  // for each of them); its value times the election timer they send, so it
  // is taken with the sends' draws, and only where that timer is sent.
  sd.t_draw = (is_elec && pay.w0 == epoch_me) || grant || (is_ap && !reject);
  sd.t_ctr = ctr;
  if (is_elec || is_rv || is_ap) ctr += 1u;

  // -- votereply win + historical election safety --
  const int voter = clampi(pay.w2, 0, N - 1);
  const bool counted =
      is_vr && pay.w1 != 0 && role_me == CANDIDATE && t == term_me;
  const int32_t votes2 =
      counted ? (int32_t)((uint32_t)votes_me | (1u << voter)) : votes_me;
  const bool win = counted && __popc((uint32_t)votes2) > N / 2;
  const int bit_index = clampi(term_me, 0, 32 * WON - 1);
  const int word = bit_index / 32;
  const uint32_t bit = 1u << (bit_index % 32);
  bool other_won = false;
  if (win)
#pragma unroll
    for (int i = 0; i < N; i++)
      if (!((me_bit >> i) & 1u) &&
          ((uint32_t)v.won_terms[i * WON + word] & bit))
        other_won = true;
  hist_bug = win && other_won;

  // -- append --
  const int leader = clampi(pay.w1, 0, N - 1);
  const int32_t prev_idx = pay.w2, prev_term = pay.w3;
  const int32_t n_ent = pay.w4, e_term = pay.w5, e_cmd = pay.w6,
                l_commit = pay.w7;
  const bool prev_ok =
      prev_idx <= llen_me && row_term_at(lt_row, L, prev_idx) == prev_term;
  const bool success = is_ap && !reject && prev_ok;
  const int32_t idx = prev_idx + 1;
  const bool write = success && n_ent > 0 && idx <= L;
  const int pos_ap = clampi(idx - 1, 0, L - 1);
  const bool same = idx <= llen_me && lt_row[pos_ap] == e_term &&
                    lc_row[pos_ap] == e_cmd;
  const int32_t new_len_ap = write ? (same ? llen_me : idx) : llen_me;
  const int32_t match_ap = write ? idx : (success ? prev_idx : 0);
  const int32_t commit_ap =
      success ? max(commit_me, min(l_commit, new_len_ap)) : commit_me;

  // -- propose --
  const bool accept = is_pr && role_me == LEADER && llen_me < L;
  const int pos_pr = clampi(llen_me, 0, L - 1);
  const int32_t llen_pr = llen_me + (accept ? 1 : 0);

  // -- appendreply --
  const int follower = clampi(pay.w3, 0, N - 1);
  const bool live_ar = is_ar && role_me == LEADER && t == term_me;
  const bool ok_ar = live_ar && pay.w1 != 0;
  const bool fail_ar = live_ar && pay.w1 == 0;
  int16_t* match_me = v.match_idx + me * N;
  int16_t* next_me = v.next_idx + me * N;
  const int32_t cur_match = row.match_idx.get(follower);
  const int32_t cur_next = row.next_idx.get(follower);
  const int32_t match2 = max(cur_match, (int32_t)pay.w2);

  // -- one combined log write (append XOR propose position) --
  const int pos = is_ap ? pos_ap : pos_pr;
  const int32_t lt_new = write ? e_term : (accept ? term_me : lt_row[pos]);
  const int32_t lc_new = write ? e_cmd : (accept ? pay.w0 : lc_row[pos]);

  // -- per-row combines, written in place; the match row stays in
  // registers for the commit advance --
  const uint32_t ar_bit = is_ar ? 1u << follower : 0u;
  const uint32_t pr_bit = (is_pr && accept) ? me_bit : 0u;
  int32_t match_row[N];
#pragma unroll
  for (int i = 0; i < N; i++) {
    const int32_t m0 = row.match_idx.get(i), n0 = row.next_idx.get(i);
    const bool is_me = (me_bit >> i) & 1u, is_f = (ar_bit >> i) & 1u;
    int32_t mr, nr;
    if (win)
      mr = is_me ? llen_me : 0;
    else if (is_f)
      mr = ok_ar ? match2 : cur_match;
    else if ((pr_bit >> i) & 1u)
      mr = llen_pr;
    else
      mr = m0;
    if (win)
      nr = 1 + llen_me;
    else if (is_f)
      nr = ok_ar ? match2 + 1 : (fail_ar ? max(1, cur_next - 1) : cur_next);
    else
      nr = n0;
    match_row[i] = mr;
    store_if(match_me + i, m0, sat16(mr));
    store_if(next_me + i, n0, sat16(nr));
    sd.next |= (uint64_t)clampi(nr, 1, L + 1) << (8 * i);
  }

  // -- appendreply commit advance (over the updated match row and the
  // log row before this step's write, which an appendreply never makes) --
  int32_t best = 0;
  if (live_ar) {
    for (int n = 1; n <= L; n++) {
      if (n > llen_me || lt_row[n - 1] != term_me) continue;
      int cnt = 0;
#pragma unroll
      for (int i = 0; i < N; i++) cnt += match_row[i] >= n;
      if (cnt > N / 2) best = n;
    }
  }
  const int32_t commit_ar = live_ar ? max(commit_me, best) : commit_me;

  // -- the sends; their append rows read the log row after the write below,
  // which equals the pre-write row with the combined write applied --
  const int32_t llen_me2 = is_ap ? new_len_ap : (is_pr ? llen_pr : llen_me);
  const int32_t term_me2 = fire ? term2 : term_me;
  const int32_t commit_me2 =
      is_ap ? commit_ap : (is_ar ? commit_ar : commit_me);
  const bool live_hb = is_hb && role_me == LEADER && term_me == pay.w0;
  const bool use_am = live_hb || win || accept;
  const uint32_t not_me = ((1u << N) - 1u) & ~me_bit;
  sd.msg_mask = (use_am || fire)
                    ? not_me
                    : (is_rv ? 1u << cand : (is_ap ? 1u << leader : 0u));
  sd.bcast = use_am;
  sd.msg_kind = is_elec ? K_REQVOTE
                        : (is_rv ? K_VOTEREPLY
                                 : (is_ap ? K_APPENDREPLY : K_APPEND));
  sd.me = me;
  sd.w0 = is_elec ? term2 : term_me;
  sd.w1 = is_elec ? me : (is_rv ? (int32_t)grant : (int32_t)success);
  sd.w2 = is_elec ? llen_me : (is_rv ? me : match_ap);
  sd.w3 = is_elec ? my_last_term : (is_rv ? 0 : me);
  sd.term = term_me2;
  sd.llen = llen_me2;
  sd.commit = commit_me2;
  const bool hb_timer = is_hb || is_vr;
  sd.t_valid = (is_elec && pay.w0 == epoch_me) || live_hb || grant || win ||
               (is_ap && !reject);
  sd.t_kind = hb_timer ? K_HEARTBEAT : K_ELECTION;
  sd.t_dst = me;
  sd.t_delay = p.heartbeat_us;  // an election timer draws instead
  sd.t_pay0 = is_elec ? epoch_me
                      : ((is_rv || is_ap) ? epoch2
                                          : (is_hb ? pay.w0 : term_me));

  // -- final state of row `me`, each field written where it changes --
  store_if(v.term + me, term_pre, sat16(fire ? term2 : term_me));
  store_if(v.voted_for + me, voted_pre,
           sat8(fire ? me : (grant ? cand : voted_me)));
  store_if(v.role + me, role_pre,
           sat8(fire ? CANDIDATE : (win ? LEADER : role_me)));
  store_if<int32_t>(v.votes + me, votes_me,
                    fire ? (int32_t)(1u << me) : (is_vr ? votes2 : votes_me));
  if (win) {
    int32_t* wt = v.won_terms + me * WON + word;
    *wt = (int32_t)((uint32_t)*wt | bit);
  }
  store_if(v.elect_epoch + me, epoch_me,
           sat16((grant || (is_ap && !reject)) ? epoch2 : epoch_me));
  v.set_log(me, pos, sat16(lt_new), sat16(lc_new));
  store_if(v.log_len + me, llen_me, sat16(llen_me2));
  v.set_commit(me, sat16(commit_me2));
  if (win) {
    if (now < *v.first_leader_time) *v.first_leader_time = now;
    *v.elections_won += 1;
  }
}

// The popped payload row's first 8 words (Raft and the net-config faults
// read no more), widened.
__device__ __forceinline__ int32_t low16(int32_t x) {
  return (int32_t)(int16_t)(uint16_t)((uint32_t)x & 0xFFFFu);
}
__device__ __forceinline__ Payload load_payload(const int16_t* row,
                                                bool vec) {
  Payload p;
  if (vec) {
    const int4 x = *reinterpret_cast<const int4*>(row);
    p.w0 = low16(x.x);
    p.w1 = x.x >> 16;
    p.w2 = low16(x.y);
    p.w3 = x.y >> 16;
    p.w4 = low16(x.z);
    p.w5 = x.z >> 16;
    p.w6 = low16(x.w);
    p.w7 = x.w >> 16;
  } else {
    p.w0 = row[0];
    p.w1 = row[1];
    p.w2 = row[2];
    p.w3 = row[3];
    p.w4 = row[4];
    p.w5 = row[5];
    p.w6 = row[6];
    p.w7 = row[7];
  }
  return p;
}

__device__ __forceinline__ int32_t pack2(int32_t lo, int32_t hi) {
  return (int32_t)(((uint32_t)(uint16_t)sat16(lo)) |
                   ((uint32_t)(uint16_t)sat16(hi) << 16));
}

// An inserted event's payload row: words 0..7 saturated, the rest zero.
__device__ __forceinline__ void store_payload(int16_t* row, int P, bool vec,
                                              const Payload e) {
  if (vec) {
    int4* out = reinterpret_cast<int4*>(row);
    out[0] = make_int4(pack2(e.w0, e.w1), pack2(e.w2, e.w3),
                       pack2(e.w4, e.w5), pack2(e.w6, e.w7));
    if (P == 16) out[1] = make_int4(0, 0, 0, 0);
  } else {
    row[0] = sat16(e.w0);
    row[1] = sat16(e.w1);
    row[2] = sat16(e.w2);
    row[3] = sat16(e.w3);
    row[4] = sat16(e.w4);
    row[5] = sat16(e.w5);
    row[6] = sat16(e.w6);
    row[7] = sat16(e.w7);
    for (int k = 8; k < P; k++) row[k] = 0;
  }
}

// A world's scalar lanes and small per-node rows, in registers. The first
// batch (every world, with its active flag) holds what a frozen world needs;
// an active world's rest is read while the block's tile copies are in
// flight. Per-node byte rows are bit masks (alive, paused, clog_node) or
// packed bytes (gen), so that a runtime index needs no array.
struct Pre {
  int32_t now, lat_min, lat_max, steps, delivered, dropped;
  uint32_t k0, k1, ctr;
  float loss;
  int16_t qdepth, qmax;
  bool bug, overflow;
  int n_committed;  // nodes whose commit index is positive
  uint32_t alive, paused, clog_node;
  uint64_t gen;

  __device__ __forceinline__ int gen_of(int i) const {
    return (int)((gen >> (8 * i)) & 0xFFu);
  }
};

template <int N>
__device__ __forceinline__ Pre load_base(const State& s, size_t w) {
  Pre r = {};
  r.now = s.now[w];
  r.qdepth = s.qdepth[w];
  r.qmax = s.qmax[w];
  r.bug = s.bug[w];
#pragma unroll
  for (int i = 0; i < N; i++) r.n_committed += s.commit[w * N + i] > 0;
  return r;
}

template <int N>
__device__ __forceinline__ void load_rest(const State& s, size_t w, Pre& r) {
  r.lat_min = s.lat_min[w];
  r.lat_max = s.lat_max[w];
  r.steps = s.steps[w];
  r.delivered = s.delivered[w];
  r.dropped = s.dropped[w];
  r.k0 = s.k0[w];
  r.k1 = s.k1[w];
  r.ctr = s.counter[w];
  r.loss = s.loss[w];
  r.overflow = s.overflow[w];
#pragma unroll
  for (int i = 0; i < N; i++) {
    const size_t at = w * N + i;
    r.alive |= (uint32_t)(s.alive[at] != 0) << i;
    r.paused |= (uint32_t)(s.paused[at] != 0) << i;
    r.clog_node |= (uint32_t)(s.clog_node[at] != 0) << i;
    r.gen |= (uint64_t)(uint8_t)s.gen[at] << (8 * i);
  }
}

__device__ __forceinline__ uint32_t set_bit(uint32_t m, int i, bool on) {
  return on ? (m | (1u << i)) : (m & ~(1u << i));
}

// One step of an active world over its rows of the shared tiles. Returns
// the mask of the 4-slot chunks of its queue rows that it changed.
template <int N>
__device__ __forceinline__ uint64_t active_step(const State& s,
                                                const Params& p, size_t w,
                                                const World<N>& v, Pre& r,
                                                int32_t* qt, int32_t* qm) {
  constexpr int M = N + 1;
  const int Q = p.Q, P = p.P;
  int16_t* qp = s.q_payload + w * Q * P;
  const bool pay_vec = p.pay_unit == 16;

  // ---- pop: lowest slot holding the minimum time among eligible slots,
  // four slots to a shared-memory read. The row's padding up to a multiple
  // of 4 slots reads as free. With no node paused every slot is eligible
  // and the scan reads only the times. ----
  for (int q = Q; q < ((Q + 3) & ~3); q++) qt[q] = INF_TIME;
  int32_t tmin = INF_TIME;
  int slot = 0;
  if (r.paused == 0u) {
    for (int q4 = 0; q4 < Q; q4 += 4) {
      const int4 t4 = *reinterpret_cast<const int4*>(qt + q4);
      const int32_t ts[4] = {t4.x, t4.y, t4.z, t4.w};
#pragma unroll
      for (int k = 0; k < 4; k++) {
        if (ts[k] < tmin) {
          tmin = ts[k];
          slot = q4 + k;
        }
      }
    }
  } else {
    for (int q4 = 0; q4 < Q; q4 += 4) {
      const int4 m4 = *reinterpret_cast<const int4*>(qm + q4);
      const int4 t4 = *reinterpret_cast<const int4*>(qt + q4);
      const int32_t ms[4] = {m4.x, m4.y, m4.z, m4.w};
      const int32_t ts[4] = {t4.x, t4.y, t4.z, t4.w};
#pragma unroll
      for (int k = 0; k < 4; k++) {
        const int32_t m = ms[k];
        const bool is_fault_q = (m & (FLAG_FAULT << 6)) != 0;
        const int d = min((m >> 16) & 0xFF, N - 1);
        if ((is_fault_q || !((r.paused >> d) & 1u)) && ts[k] < tmin) {
          tmin = ts[k];
          slot = q4 + k;
        }
      }
    }
  }
  const bool found = tmin < INF_TIME;
  const int32_t meta = qm[slot];
  const int ev_kind = meta & 0x3F, ev_flags = (meta >> 6) & 0x3,
            ev_src = (meta >> 8) & 0xFF, ev_dst = (meta >> 16) & 0xFF,
            ev_gen = (meta >> 24) & 0xFF;
  // Every read of the popped payload happens here, before the first queue
  // write: entry 0 of the sends may take the popped slot.
  const Payload pay = load_payload(qp + slot * P, pay_vec);

  const int32_t now = found ? max(r.now, tmin) : r.now;
  const bool in_time = now < p.t_limit_us;
  const int dst = clampi(ev_dst, 0, N - 1);
  // The handler's node row, read now, in the same round trip as the
  // payload (its node is the event's clamped destination).
  const RaftRow row = load_row<N>(v, dst);
  const bool is_fault = (ev_flags & FLAG_FAULT) != 0;
  const bool is_timer = (ev_flags & FLAG_TIMER) != 0;
  const bool stale = is_timer && ev_gen != r.gen_of(dst);
  const bool dead = !((r.alive >> dst) & 1u);
  const bool deliver = found && in_time && !is_fault && !stale && !dead;
  const bool do_fault = found && in_time && is_fault;
  const int src = do_fault ? clampi(ev_src, 0, N - 1) : dst;
  // The sends' clogged links: row src of clog_link, as a bit mask.
  uint32_t links = 0u;
#pragma unroll
  for (int i = 0; i < N; i++)
    if (s.clog_link[(w * N + src) * N + i]) links |= 1u << i;

  const uint32_t k0 = r.k0, k1 = r.k1;
  uint32_t ctr = r.ctr;
  Sends sd = no_sends();
  bool hbug = false;

  if (do_fault) {
    // ---- apply_fault: a and b are the event's src and dst, unclamped ----
    const int op = ev_kind, a = ev_src, b = ev_dst;
    const bool is_kill = op == FAULT_KILL, is_restart = op == FAULT_RESTART;
    if (a < N) {
      const size_t at = w * N + a;
      const bool alive0 = (r.alive >> a) & 1u, paused0 = (r.paused >> a) & 1u,
                 clog0 = (r.clog_node >> a) & 1u;
      const bool alive1 = is_kill ? false : (is_restart || alive0);
      const bool paused1 =
          op == FAULT_PAUSE ||
          (!(op == FAULT_RESUME || is_kill || is_restart) && paused0);
      const bool clog1 =
          op == FAULT_CLOG_NODE || (op != FAULT_UNCLOG_NODE && clog0);
      if (alive1 != alive0) s.alive[at] = alive1;
      if (paused1 != paused0) s.paused[at] = paused1;
      if (clog1 != clog0) s.clog_node[at] = clog1;
      r.alive = set_bit(r.alive, a, alive1);
      r.paused = set_bit(r.paused, a, paused1);
      r.clog_node = set_bit(r.clog_node, a, clog1);
      if (is_kill || is_restart) {  // the generation wraps mod 256
        const int g1 = (r.gen_of(a) + 1) & 0xFF;
        s.gen[at] = (int8_t)(uint8_t)g1;
        r.gen = (r.gen & ~(0xFFull << (8 * a))) | ((uint64_t)g1 << (8 * a));
      }
      if (b < N) {  // a == src: the row of links the sends read
        const bool link0 = (links >> b) & 1u;
        const bool link1 =
            op == FAULT_CLOG_LINK || (op != FAULT_UNCLOG_LINK && link0);
        if (link1 != link0) {
          s.clog_link[(w * N + a) * N + b] = link1;
          links ^= 1u << b;
        }
      }
    }
    // Net-config params: join_wide of payload words 0-3 (packed profile;
    // the Raft actor has P >= 8).
    const int32_t pa = join_wide(pay.w0, pay.w1);
    const int32_t pb = join_wide(pay.w2, pay.w3);
    if (op == FAULT_SET_LATENCY) {
      r.lat_min = pa;
      r.lat_max = pb;
      s.lat_min[w] = pa;
      s.lat_max[w] = pb;
    }
    // float32(1e-6) written exactly: 0x358637bd.
    if (op == FAULT_SET_LOSS) {
      r.loss = __fmul_rn((float)pa, 0x1.0c6f7ap-20f);
      s.loss[w] = r.loss;
    }
    if (is_restart) raft_on_restart(v, a, ctr, sd);
  } else if (deliver) {
    raft_handle(p, v, ev_kind, ev_dst, pay, row, now, ctr, sd, hbug);
  }

  // ---- the sends, in entry order: the messages to nodes 0..N-1, then the
  // timer. A message from or to a clogged node or over a clogged link is
  // dropped without a draw; the others are taken two at a time, their
  // latency draws (counters ctr+2i) computed together with the timer's
  // election delay, three independent chains; where loss > 0 their loss
  // draws (ctr+2i+1) come first. Each kept event takes the next free slot
  // (the popped one counts as free). ----
  uint64_t dirty = 0;
  if (found) {
    qt[slot] = INF_TIME;
    dirty |= 1ull << (slot >> 2);
  }
  const int32_t room = INF_TIME - now;
  const int L = p.L;
  int cursor = 0, n_ins = 0;
  // Send-side metrics: inserts dropped for a saturated deadline, refused by
  // a full queue, and messages lost to the loss draw.
  int n_inf = 0, n_over = 0, n_lost = 0;
  bool ovf = false;
  const uint32_t nodes = (1u << N) - 1u;
  const uint32_t clogged =
      ((r.clog_node >> src) & 1u) ? nodes : (r.clog_node | links);
  uint32_t todo = sd.msg_mask & ~clogged & nodes;

  // One event into the next free slot, or overflow.
  auto insert = [&](int32_t delay, int kind, int flags, int d,
                    const Payload e) {
    const int32_t t_ev = now + (delay < room ? delay : room);
    if (t_ev >= INF_TIME) {
      n_inf++;
      return;
    }
    while (cursor < Q && qt[cursor] != INF_TIME) cursor++;
    if (cursor == Q) {
      ovf = true;
      n_over++;
      return;
    }
    qt[cursor] = t_ev;
    qm[cursor] = pack_meta(kind, flags, src, d, r.gen_of(d));
    store_payload(qp + cursor * P, P, pay_vec, e);
    dirty |= 1ull << (cursor >> 2);
    cursor++;
    n_ins++;
  };
  // Message i's payload words.
  auto message = [&](int i, int32_t delay) {
    Payload e = {sd.w0, sd.w1, sd.w2, sd.w3, 0, 0, 0, 0};
    if (sd.bcast) {
      const int32_t nxt = (int32_t)((sd.next >> (8 * i)) & 0xFFu);
      const int32_t prev = nxt - 1;
      const bool have = nxt <= sd.llen;
      const int16_t* lt_row = v.log_term_s + sd.me * L;
      const int16_t* lc_row = v.log_cmd_s + sd.me * L;
      const int pe = clampi(nxt - 1, 0, L - 1);
      e = {sd.term, sd.me, prev, row_term_at(lt_row, L, prev),
           have ? 1 : 0, have ? (int32_t)lt_row[pe] : 0,
           have ? (int32_t)lc_row[pe] : 0, sd.commit};
    }
    insert(delay, sd.msg_kind, 0, i, e);
  };
  bool t_draw = sd.t_draw;
  while (todo || t_draw) {
    int ia = -1, ib = -1;
    if (todo) {
      ia = __ffs(todo) - 1;
      todo &= todo - 1;
    }
    if (todo) {
      ib = __ffs(todo) - 1;
      todo &= todo - 1;
    }
    const uint32_t ca = ctr + 2u * (uint32_t)ia, cb = ctr + 2u * (uint32_t)ib;
    bool keep_a = ia >= 0, keep_b = ib >= 0;
    // u < loss never holds for loss <= 0 (or NaN): u is in [0, 1).
    if (r.loss > 0.0f && keep_a) {
      uint32_t ua, ub, unused;
      draw3(k0, k1, ca + 1u, cb + 1u, 0u, ua, ub, unused);
      keep_a = !(u32_to_unit(ua) < r.loss);
      keep_b = keep_b && !(u32_to_unit(ub) < r.loss);
      n_lost += (keep_a ? 0 : 1) + ((ib >= 0 && !keep_b) ? 1 : 0);
    }
    uint32_t la, lb, lt;
    draw3(k0, k1, ca, cb, sd.t_ctr, la, lb, lt);
    if (t_draw) {
      sd.t_delay = u32_to_range(lt, p.elect_min_us, p.elect_max_us);
      t_draw = false;
    }
    if (keep_a) message(ia, max(u32_to_range(la, r.lat_min, r.lat_max), 0));
    if (keep_b) message(ib, max(u32_to_range(lb, r.lat_min, r.lat_max), 0));
  }
  if (sd.t_valid) {
    insert(max(sd.t_delay, 0), sd.t_kind, FLAG_TIMER, sd.t_dst,
           Payload{sd.t_pay0, 0, 0, 0, 0, 0, 0, 0});
  }
  ctr += 2u * (uint32_t)M;

  if (ovf && !r.overflow) s.overflow[w] = 1;
  const int16_t qdepth = (int16_t)(r.qdepth - (found ? 1 : 0) + n_ins);
  if (qdepth != r.qdepth) s.qdepth[w] = qdepth;
  if (qdepth > r.qmax) s.qmax[w] = qdepth;

  // ---- invariant, bug flag and bookkeeping ----
  const bool bug = r.bug || (deliver && hbug) || raft_invariant(v);
  if (bug && !r.bug) {
    s.bug[w] = 1;
    s.bug_time[w] = now;
  }
  if (!(found && in_time && !(p.stop_on_bug && bug))) s.active[w] = 0;
  if (deliver) s.delivered[w] = r.delivered + 1;
  if (found && in_time && !deliver && !do_fault) s.dropped[w] = r.dropped + 1;
  if (now != r.now) s.now[w] = now;
  s.steps[w] = r.steps + 1;
  s.counter[w] = ctr;

  // ---- the write-only lanes (obs/metrics.py, obs/blackbox.py), in device
  // memory; nothing above reads them ----
  const bool valid = found && in_time;
  if (p.metrics) {
    // Messages offered: the outbox's valid message entries; dropped at
    // send: those to or from a clogged node or over a clogged link, and
    // those the loss draw took.
    count(s.m_msgs_sent, w, __popc(sd.msg_mask & nodes));
    count(s.m_drop_loss, w, __popc(sd.msg_mask & clogged & nodes) + n_lost);
    count(s.m_enqueued, w, n_ins);
    count(s.m_drop_overflow, w, n_over);
    count(s.m_drop_inf, w, n_inf);
    count(s.m_msgs_delivered, w, (deliver && !is_timer) ? 1 : 0);
    count(s.m_timer_fires, w, (deliver && is_timer) ? 1 : 0);
    count(s.m_drop_stale, w, (valid && !is_fault && stale) ? 1 : 0);
    count(s.m_drop_dead, w, (valid && !is_fault && !stale && dead) ? 1 : 0);
    count(s.m_drop_out_of_time, w, (found && !in_time) ? 1 : 0);
    count(s.m_vtime_us, w, (int32_t)((uint32_t)now - (uint32_t)r.now));
    // The histograms' bins by address; a kind out of range counts nowhere.
    if (do_fault && ev_kind < NUM_FAULT_KINDS)
      count(s.m_fault_hist, w * NUM_FAULT_KINDS + ev_kind, 1);
    if (deliver && ev_kind < p.num_kinds)
      count(s.m_kind_hist, w * (size_t)p.num_kinds + ev_kind, 1);
  }
  if (p.bb_k > 0) {
    const bool raised = bug && !r.bug;
    const bool marker = raised && !valid;
    if (valid || marker) {
      const int flags = (valid && is_timer ? BB_TIMER : 0) |
                        (valid && is_fault ? BB_FAULT : 0) |
                        (valid && !is_fault && stale ? BB_DROP_STALE : 0) |
                        (valid && !is_fault && !stale && dead ? BB_DROP_DEAD
                                                              : 0) |
                        (raised ? BB_RAISE : 0) | (marker ? BB_MARKER : 0);
      ring_record(s, p, w, r.steps, marker ? now : tmin,
                  valid ? ev_kind : 0, valid ? ev_src : -1,
                  valid ? ev_dst : -1, flags);
    }
  }
  return dirty;
}

template <int N>
__global__ void step_kernel(State s, Params p) {
  extern __shared__ __align__(16) char smem[];
  const int B = blockDim.x, tid = threadIdx.x;
  const size_t w0 = (size_t)blockIdx.x * B;
  const size_t w = w0 + tid;
  const int rows = (int)min((size_t)B, (size_t)p.W - w0);
  const bool mine = tid < rows;
  const int L = p.L;
  char* qt_tile = smem;
  char* qm_tile = smem + p.off_qm;
  uint64_t* dirty = reinterpret_cast<uint64_t*>(smem + p.off_dirty);
  char* commit_tile = smem + p.off_commit;
  char* lt_tile = smem + p.off_lt;
  char* lc_tile = smem + p.off_lc;
  const int q_row = p.Q * 4, q_stride = p.q_stride * 4;
  const int c_row = N * 2, c_stride = p.commit_stride * 2;
  const int l_row = N * L * 2, l_stride = p.log_stride * 2;

  // What every world needs, frozen or not, in one batch with its flag.
  const bool act = mine && s.active[w];
  Pre r = {};
  if (mine) r = load_base<N>(s, w);
  // Block-uniform: every __syncthreads below is reached by every thread.
  const int n_active = __syncthreads_count(act);
  // Only active worlds read tiles. Where most of the block is active, the
  // block copies its whole range of each lane; else each active world
  // copies its own rows.
  const bool dense = 2 * n_active > rows;
  if (dense || act) {
    // The block's range, shared out over its threads, or this world's rows.
    const size_t row0 = dense ? w0 : w;
    const int n = dense ? rows : 1, first = dense ? tid : 0,
              step = dense ? B : 1;
    const int at = dense ? 0 : tid;
    tile_in_any(p.q_unit, qt_tile + at * q_stride, s.q_time, row0, n, q_row,
                q_stride, first, step);
    tile_in_any(p.q_unit, qm_tile + at * q_stride, s.q_meta, row0, n, q_row,
                q_stride, first, step);
    tile_in_any(p.log_unit, lt_tile + at * l_stride, s.log_term, row0, n,
                l_row, l_stride, first, step);
    tile_in_any(p.log_unit, lc_tile + at * l_stride, s.log_cmd, row0, n,
                l_row, l_stride, first, step);
    tile_in_any(p.commit_unit, commit_tile + at * c_stride, s.commit, row0, n,
                c_row, c_stride, first, step);
  }
  if (act) load_rest<N>(s, w, r);
  cp_async_wait_all();
  __syncthreads();

  uint64_t changed = 0;
  if (act) {
    const World<N> v(s, w, L,
                     reinterpret_cast<int16_t*>(commit_tile + tid * c_stride),
                     reinterpret_cast<int16_t*>(lt_tile + tid * l_stride),
                     reinterpret_cast<int16_t*>(lc_tile + tid * l_stride));
    changed = active_step<N>(
        s, p, w, v, r, reinterpret_cast<int32_t*>(qt_tile + tid * q_stride),
        reinterpret_cast<int32_t*>(qm_tile + tid * q_stride));
  } else if (mine) {
    // A frozen world: the pop finds nothing, every write is gated off, and
    // the RNG cursor and step count are restored. Only the high-water mark
    // and the invariant's bug flag are evaluated, as in the plain step. The
    // invariant compares no entry unless two nodes have committed; then it
    // reads their rows in device memory.
    if (r.qdepth > r.qmax) s.qmax[w] = r.qdepth;
    if (!r.bug && r.n_committed >= 2 &&
        raft_invariant(World<N>(s, w, L, s.commit + w * N,
                                s.log_term + w * N * L,
                                s.log_cmd + w * N * L))) {
      s.bug[w] = 1;
      s.bug_time[w] = r.now;
      // The raise of a step that processed no event: the ring's marker.
      if (p.bb_k > 0)
        ring_record(s, p, w, s.steps[w], r.now, 0, -1, -1,
                    BB_RAISE | BB_MARKER);
    }
  }
  if (dense) {
    dirty[tid] = changed;
    __syncthreads();
    tile_out_any(p.q_unit, s.q_time, qt_tile, w0, rows, q_row, q_stride,
                 dirty, tid, B);
    tile_out_any(p.q_unit, s.q_meta, qm_tile, w0, rows, q_row, q_stride,
                 dirty, tid, B);
  } else if (act) {
    tile_out_any(p.q_unit, s.q_time, qt_tile + tid * q_stride, w, 1, q_row,
                 q_stride, &changed, 0, 1);
    tile_out_any(p.q_unit, s.q_meta, qm_tile + tid * q_stride, w, 1, q_row,
                 q_stride, &changed, 0, 1);
  }
}

__global__ void threefry_kernel(const uint32_t* k0, const uint32_t* k1,
                                const uint32_t* c0, const uint32_t* c1,
                                uint32_t* o0, uint32_t* o1, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  threefry2x32(k0[i], k1[i], c0[i], c1[i], o0[i], o1[i]);
}

bool unit_ok(int u, int lo) { return u >= lo && u <= 16 && (u & (u - 1)) == 0; }

// Launches step_kernel<N>. Above 48 KB a block's dynamic shared memory needs
// the function's limit raised, once per instantiation and device.
template <int N>
int launch_step(const State& s, const Params& p, int block, void* stream) {
  static int smem_limit[64] = {0};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device < 0 || device >= 64) return (int)cudaErrorInvalidDevice;
  if (p.smem_bytes > 48 * 1024 && p.smem_bytes > smem_limit[device]) {
    err = cudaFuncSetAttribute(step_kernel<N>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               p.smem_bytes);
    if (err != cudaSuccess) return (int)err;
    smem_limit[device] = p.smem_bytes;
  }
  const int grid = (p.W + block - 1) / block;
  step_kernel<N><<<grid, block, p.smem_bytes,
                   static_cast<cudaStream_t>(stream)>>>(s, p);
  return (int)cudaGetLastError();
}

}  // namespace

// One engine step of every world, in place. ptrs: the State's N_PTRS
// pointers in its order (the 38 base leaves, then the metrics block's 13
// and the ring's 8 lanes, null when off); params: W then the Params fields
// after it (the engine's parameters, the tile plan, the optional lanes);
// block: worlds per block. Returns the CUDA status of the launch.
extern "C" int madsim_step(void* const* ptrs, const int* params, int block,
                           void* stream) {
  State s;
  void** dst = reinterpret_cast<void**>(&s);
  static_assert(sizeof(State) == N_PTRS * sizeof(void*), "State layout");
  for (int i = 0; i < N_PTRS; i++) dst[i] = ptrs[i];
  for (int i = 0; i < N_BASE_LEAVES; i++)
    if (ptrs[i] == nullptr) return (int)cudaErrorInvalidValue;
  // The optional lanes: all present when on, none read when off.
  for (int i = 0; i < N_METRICS; i++)
    if ((ptrs[N_BASE_LEAVES + i] != nullptr) != (params[N_PARAMS - 3] != 0))
      return (int)cudaErrorInvalidValue;
  for (int i = 0; i < N_RING; i++)
    if ((ptrs[N_BASE_LEAVES + N_METRICS + i] != nullptr) !=
        (params[N_PARAMS - 1] > 0))
      return (int)cudaErrorInvalidValue;
  Params p;
  static_assert(sizeof(Params) == N_PARAMS * sizeof(int), "Params layout");
  int* pp = reinterpret_cast<int*>(&p);
  for (int i = 0; i < N_PARAMS; i++) pp[i] = params[i];
  if (p.W <= 0 || p.N < 1 || p.N > MAX_N || p.P < 8 || p.P > MAX_P ||
      p.L < 1 || p.L > MAX_L || p.Q < 1 || p.Q > MAX_Q || p.won != WON ||
      block <= 0 || block > MAX_BLOCK || p.smem_bytes <= 0 ||
      p.smem_bytes > SMEM_MAX || p.q_stride < p.Q || p.q_stride % 4 ||
      p.commit_stride < p.N || p.log_stride < p.N * p.L ||
      !unit_ok(p.q_unit, 4) || !unit_ok(p.commit_unit, 2) ||
      p.commit_unit > 4 || !unit_ok(p.log_unit, 2) || p.log_unit > 4 ||
      (p.pay_unit != 16 && p.pay_unit != 2) || (p.Q * 4) % p.q_unit ||
      (p.N * 2) % p.commit_unit || (p.N * p.L * 2) % p.log_unit ||
      (p.pay_unit == 16 && p.P % 8) || p.metrics < 0 || p.metrics > 1 ||
      p.num_kinds < 1 || p.num_kinds > 64 || p.bb_k < 0)
    return (int)cudaErrorInvalidValue;
  // The tiles: 16-byte aligned, in order, apart, within the block's bytes.
  const long b = block;
  if ((p.off_qm | p.off_dirty | p.off_commit | p.off_lt | p.off_lc) % 16 ||
      (p.commit_unit == 4 && p.commit_stride % 2) ||
      (p.log_unit == 4 && p.log_stride % 2) ||
      p.off_qm < b * p.q_stride * 4 ||
      p.off_dirty < p.off_qm + b * p.q_stride * 4 ||
      p.off_commit < p.off_dirty + b * 8 ||
      p.off_lt < p.off_commit + b * p.commit_stride * 2 ||
      p.off_lc < p.off_lt + b * p.log_stride * 2 ||
      p.smem_bytes < p.off_lc + b * p.log_stride * 2)
    return (int)cudaErrorInvalidValue;
  switch (p.N) {
    case 1: return launch_step<1>(s, p, block, stream);
    case 2: return launch_step<2>(s, p, block, stream);
    case 3: return launch_step<3>(s, p, block, stream);
    case 4: return launch_step<4>(s, p, block, stream);
    case 5: return launch_step<5>(s, p, block, stream);
    case 6: return launch_step<6>(s, p, block, stream);
    case 7: return launch_step<7>(s, p, block, stream);
    case 8: return launch_step<8>(s, p, block, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Threefry-2x32/20 of n (key, counter) pairs: the kernel's own device
// function, exported so the Random123 known answers can be checked on the
// card.
extern "C" int madsim_threefry(const void* k0, const void* k1,
                               const void* c0, const void* c1, void* o0,
                               void* o1, int n, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const int block = 256;
  threefry_kernel<<<(n + block - 1) / block, block, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(k0), static_cast<const uint32_t*>(k1),
      static_cast<const uint32_t*>(c0), static_cast<const uint32_t*>(c1),
      static_cast<uint32_t*>(o0), static_cast<uint32_t*>(o1), n);
  return (int)cudaGetLastError();
}
