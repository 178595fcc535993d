// Shared pieces of the engine's CUDA step kernel: constants, the State and
// Params structs the launch fills, Threefry, the shared-memory tile copies,
// the popped payload, the outbox as scalars (Sends), and the world's scalar
// lanes in registers (Pre). Included by the actor policies (actor_*.cuh)
// and the kernel skeleton (step_kernel.cuh); see step_kernel.cuh for the
// design and the exactness rules.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// The most nodes any policy takes (each policy declares its own
// MAX_NODES; only the pair policy goes past 8).
constexpr int MAX_N = 12;
constexpr int MAX_P = 16;
constexpr int MAX_Q = 256;
constexpr int MAX_BLOCK = 1024;
constexpr int SMEM_MAX = 232448;
constexpr int32_t INF_TIME = 0x7FFFFFFF;

constexpr int FLAG_TIMER = 1;
constexpr int FLAG_FAULT = 2;

// Fault ops (event kind when FLAG_FAULT is set).
constexpr int FAULT_KILL = 0, FAULT_RESTART = 1, FAULT_CLOG_NODE = 2,
              FAULT_UNCLOG_NODE = 3, FAULT_CLOG_LINK = 4,
              FAULT_UNCLOG_LINK = 5, FAULT_SET_LATENCY = 6,
              FAULT_SET_LOSS = 7, FAULT_PAUSE = 8, FAULT_RESUME = 9;

// The actor families the kernel has compiled in (Params::family).
constexpr int FAMILY_RAFT = 0, FAMILY_TPC = 1, FAMILY_PB = 2,
              FAMILY_PAXOS = 3, FAMILY_PAIR = 4;

// The lane profiles (engine/lanes.py PACKED and WIDE): the at-rest types
// of the narrow lane categories. Packed: node ids and codes int8, slots and
// payload words int16, every write saturating (narrow below); wide: every
// such lane int32, writes plain (the JAX narrow is a plain cast there).
// Time, counter and bitmask lanes are int32 in both.
struct PackedProfile {
  static constexpr bool WIDE = false;
  using node_t = int8_t;
  using code_t = int8_t;
  using slot_t = int16_t;
  using pay_t = int16_t;
};
struct WideProfile {
  static constexpr bool WIDE = true;
  using node_t = int32_t;
  using code_t = int32_t;
  using slot_t = int32_t;
  using pay_t = int32_t;
};

// State leaves, in the order of madsim_tpu_torch.engine.core.tree_leaves:
// the engine's lanes, with the actor's lanes (the family's Lanes struct of
// typed pointers, in its leaf order) between clog_link and active, then the
// optional write-only lanes. The narrow lanes' types are the profile's,
// Lanes::Profile.
template <class Lanes>
struct State {
  using Pf = typename Lanes::Profile;
  int32_t* now;
  int32_t* q_time;
  int32_t* q_meta;
  typename Pf::pay_t* q_payload;
  uint32_t* k0;
  uint32_t* k1;
  uint32_t* counter;
  uint8_t* alive;
  typename Pf::code_t* gen;
  uint8_t* paused;
  uint8_t* clog_node;
  uint8_t* clog_link;
  Lanes a;
  uint8_t* active;
  int32_t* steps;
  int32_t* delivered;
  int32_t* dropped;
  uint8_t* overflow;
  typename Pf::slot_t* qdepth;
  typename Pf::slot_t* qmax;
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
  typename Pf::slot_t* bb_step_lo;  // (W, K) each
  typename Pf::pay_t* bb_t_lo;
  typename Pf::pay_t* bb_t_hi;
  typename Pf::code_t* bb_kind;
  typename Pf::code_t* bb_src;
  typename Pf::code_t* bb_dst;
  typename Pf::code_t* bb_flags;
};
// Engine leaves before the actor's, after them, and the optional lanes.
constexpr int N_PRE_LEAVES = 12, N_POST_LEAVES = 12, N_METRICS = 13,
              N_RING = 8;
constexpr int NUM_FAULT_KINDS = 10;

// Flag bits of a flight-recorder record (obs/blackbox.py BB_*).
constexpr int BB_TIMER = 1, BB_FAULT = 2, BB_DROP_STALE = 4, BB_DROP_DEAD = 8,
              BB_RAISE = 16, BB_MARKER = 32;

// The engine's parameters, the family's static parameters f0..f7 (each
// family's policy names them; engine/step_kernel.py kernel_params fills
// them), then the tile plan (step_kernel.py TilePlan): row strides of the
// shared tiles, global access widths in bytes, and the byte offsets of the
// tiles in dynamic shared memory (q_time's is 0). The commit and log tiles
// are Raft's; the other families have none (strides and widths 0).
struct Params {
  int W, N, Q, P, family;
  int t_limit_us, stop_on_bug;
  int f0, f1, f2, f3, f4, f5, f6, f7;
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
constexpr int N_PARAMS = 31;

__device__ __forceinline__ int clampi(int32_t x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}
__device__ __forceinline__ int16_t sat16(int32_t x) {
  return (int16_t)clampi(x, -32768, 32767);
}
__device__ __forceinline__ int8_t sat8(int32_t x) {
  return (int8_t)clampi(x, -128, 127);
}
// A narrow lane's write (engine/lanes.py narrow): saturating into int8 or
// int16, plain into int32.
template <typename T>
__device__ __forceinline__ T narrow(int32_t x) {
  if constexpr (sizeof(T) == 1)
    return sat8(x);
  else if constexpr (sizeof(T) == 2)
    return sat16(x);
  else
    return (T)x;
}
// A write that wraps (engine/lanes.py narrow_wrap): the low bits.
template <typename T>
__device__ __forceinline__ T wrap(int32_t x) {
  if constexpr (sizeof(T) == 1)
    return (T)(int8_t)(uint8_t)((uint32_t)x & 0xFFu);
  else if constexpr (sizeof(T) == 2)
    return (T)(int16_t)(uint16_t)((uint32_t)x & 0xFFFFu);
  else
    return (T)x;
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
// (wrapped to the step lane's width), t the event's time or, for a marker,
// the clock, split into its sign-extended low 16 bits and its high bits
// (engine/lanes.py split_wide).
template <class Lanes>
__device__ __forceinline__ void ring_record(const State<Lanes>& s,
                                            const Params& p,
                                            size_t w, int32_t steps,
                                            int32_t t, int kind, int src,
                                            int dst, int flags) {
  using Pf = typename Lanes::Profile;
  const int k = p.bb_k;
  const int32_t pos = s.bb_pos[w];
  int slot = pos % k;
  if (slot < 0) slot += k;
  const size_t at = w * (size_t)k + slot;
  s.bb_pos[w] = (int32_t)((uint32_t)pos + 1u);
  s.bb_step_lo[at] = wrap<typename Pf::slot_t>(steps);
  s.bb_t_lo[at] = (typename Pf::pay_t)(int16_t)(uint16_t)((uint32_t)t &
                                                          0xFFFFu);
  s.bb_t_hi[at] = (typename Pf::pay_t)(t >> 16);
  s.bb_kind[at] = narrow<typename Pf::code_t>(kind);
  s.bb_src[at] = narrow<typename Pf::code_t>(src);
  s.bb_dst[at] = narrow<typename Pf::code_t>(dst);
  s.bb_flags[at] = (typename Pf::code_t)flags;
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
// The popped payload, the sends, and stores that skip unchanged values.
// ---------------------------------------------------------------------------
template <typename T>
__device__ __forceinline__ void store_if(T* p, int32_t old, T x) {
  if ((int32_t)x != old) *p = x;
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

// The outbox as scalars, for every family: entry i < N is a message to
// node i, valid where bit i of msg_mask is set, of kind msg_kind; its
// payload is words w0..w3 (the family's message() may build another, as
// Raft's append rows from next_idx[me][i] and the log when bcast). Entry N
// is the timer, of kind t_kind to t_dst with words t_pay0, t_pay1 after
// t_delay us; where t_draw is set its delay is the family's draw_delay()
// of the draw at counter t_ctr, taken with the messages' draws.
struct Sends {
  uint32_t msg_mask;
  bool bcast;
  uint64_t next;
  int32_t msg_kind, me;
  int32_t w0, w1, w2, w3;
  int32_t term, llen, commit;
  bool t_valid;
  int32_t t_kind, t_dst, t_delay, t_pay0, t_pay1;
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
  sd.t_kind = sd.t_dst = sd.t_delay = sd.t_pay0 = sd.t_pay1 = 0;
  sd.t_draw = false;
  sd.t_ctr = 0u;
  return sd;
}

// Message i's payload when it is words w0..w3.
__device__ __forceinline__ Payload plain_message(const Sends& sd) {
  return Payload{sd.w0, sd.w1, sd.w2, sd.w3, 0, 0, 0, 0};
}

// One Threefry draw (the first output word) at counter c.
__device__ __forceinline__ uint32_t draw1(uint32_t k0, uint32_t k1,
                                          uint32_t c) {
  uint32_t x, unused;
  threefry2x32(k0, k1, c, 0u, x, unused);
  return x;
}

// Floor modulo (Python's and jnp's % for a positive n).
__device__ __forceinline__ int32_t pmod(int32_t x, int n) {
  const int32_t r = x % n;
  return r < 0 ? r + n : r;
}

// The popped payload row's first 8 words (no family and no net-config
// fault reads more), widened. SHORT (a policy whose rows may hold fewer
// than 8 words, Paxos's 5) reads min(P, 8) words, the rest as 0; the other
// policies take P >= 8 and read 8 words unguarded.
__device__ __forceinline__ int32_t low16(int32_t x) {
  return (int32_t)(int16_t)(uint16_t)((uint32_t)x & 0xFFFFu);
}
template <bool SHORT>
__device__ __forceinline__ Payload load_payload(const int16_t* row, int P,
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
  } else if constexpr (!SHORT) {
    p.w0 = row[0];
    p.w1 = row[1];
    p.w2 = row[2];
    p.w3 = row[3];
    p.w4 = row[4];
    p.w5 = row[5];
    p.w6 = row[6];
    p.w7 = row[7];
  } else {
    p.w0 = row[0];
    p.w1 = P > 1 ? row[1] : 0;
    p.w2 = P > 2 ? row[2] : 0;
    p.w3 = P > 3 ? row[3] : 0;
    p.w4 = P > 4 ? row[4] : 0;
    p.w5 = P > 5 ? row[5] : 0;
    p.w6 = P > 6 ? row[6] : 0;
    p.w7 = P > 7 ? row[7] : 0;
  }
  return p;
}
// The wide profile's int32 rows: two 16-byte vectors where vec (P a
// multiple of 4, P >= 8).
template <bool SHORT>
__device__ __forceinline__ Payload load_payload(const int32_t* row, int P,
                                                bool vec) {
  Payload p;
  if (vec) {
    const int4 a = reinterpret_cast<const int4*>(row)[0];
    const int4 b = reinterpret_cast<const int4*>(row)[1];
    p = Payload{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  } else if constexpr (!SHORT) {
    p = Payload{row[0], row[1], row[2], row[3],
                row[4], row[5], row[6], row[7]};
  } else {
    p.w0 = row[0];
    p.w1 = P > 1 ? row[1] : 0;
    p.w2 = P > 2 ? row[2] : 0;
    p.w3 = P > 3 ? row[3] : 0;
    p.w4 = P > 4 ? row[4] : 0;
    p.w5 = P > 5 ? row[5] : 0;
    p.w6 = P > 6 ? row[6] : 0;
    p.w7 = P > 7 ? row[7] : 0;
  }
  return p;
}

__device__ __forceinline__ int32_t pack2(int32_t lo, int32_t hi) {
  return (int32_t)(((uint32_t)(uint16_t)sat16(lo)) |
                   ((uint32_t)(uint16_t)sat16(hi) << 16));
}

// An inserted event's payload row: words 0..7 saturated, the rest zero;
// SHORT (as for load_payload) writes words 0..min(P, 8)-1 only.
template <bool SHORT>
__device__ __forceinline__ void store_payload(int16_t* row, int P, bool vec,
                                              const Payload e) {
  if (vec) {
    int4* out = reinterpret_cast<int4*>(row);
    out[0] = make_int4(pack2(e.w0, e.w1), pack2(e.w2, e.w3),
                       pack2(e.w4, e.w5), pack2(e.w6, e.w7));
    if (P == 16) out[1] = make_int4(0, 0, 0, 0);
  } else if constexpr (!SHORT) {
    row[0] = sat16(e.w0);
    row[1] = sat16(e.w1);
    row[2] = sat16(e.w2);
    row[3] = sat16(e.w3);
    row[4] = sat16(e.w4);
    row[5] = sat16(e.w5);
    row[6] = sat16(e.w6);
    row[7] = sat16(e.w7);
    for (int k = 8; k < P; k++) row[k] = 0;
  } else {
    row[0] = sat16(e.w0);
    if (P > 1) row[1] = sat16(e.w1);
    if (P > 2) row[2] = sat16(e.w2);
    if (P > 3) row[3] = sat16(e.w3);
    if (P > 4) row[4] = sat16(e.w4);
    if (P > 5) row[5] = sat16(e.w5);
    if (P > 6) row[6] = sat16(e.w6);
    if (P > 7) row[7] = sat16(e.w7);
  }
}

// The wide profile's int32 rows: words 0..7 plain, the rest zero.
template <bool SHORT>
__device__ __forceinline__ void store_payload(int32_t* row, int P, bool vec,
                                              const Payload e) {
  if (vec) {
    int4* out = reinterpret_cast<int4*>(row);
    out[0] = make_int4(e.w0, e.w1, e.w2, e.w3);
    out[1] = make_int4(e.w4, e.w5, e.w6, e.w7);
    for (int k = 2; k < P / 4; k++) out[k] = make_int4(0, 0, 0, 0);
  } else if constexpr (!SHORT) {
    row[0] = e.w0;
    row[1] = e.w1;
    row[2] = e.w2;
    row[3] = e.w3;
    row[4] = e.w4;
    row[5] = e.w5;
    row[6] = e.w6;
    row[7] = e.w7;
    for (int k = 8; k < P; k++) row[k] = 0;
  } else {
    row[0] = e.w0;
    if (P > 1) row[1] = e.w1;
    if (P > 2) row[2] = e.w2;
    if (P > 3) row[3] = e.w3;
    if (P > 4) row[4] = e.w4;
    if (P > 5) row[5] = e.w5;
    if (P > 6) row[6] = e.w6;
    if (P > 7) row[7] = e.w7;
  }
}

// A world's scalar lanes and small per-node rows, in registers. The first
// batch (every world, with its active flag) holds what a frozen world needs;
// an active world's rest is read while the block's tile copies are in
// flight. Per-node byte rows are bit masks (alive, paused, clog_node) or
// packed bytes (gen: nodes 0..7 in gen, 8..11 in gen_hi, which only an
// instantiation with N > 8 touches), so that a runtime index needs no
// array.
template <class Pf>
struct Pre {
  int32_t now, lat_min, lat_max, steps, delivered, dropped;
  uint32_t k0, k1, ctr;
  float loss;
  typename Pf::slot_t qdepth, qmax;
  bool bug, overflow;
  int hint;  // the family's frozen-world hint (Raft: nodes with commit > 0)
  uint32_t alive, paused, clog_node;
  uint64_t gen;
  uint32_t gen_hi;

  template <int N>
  __device__ __forceinline__ int gen_of(int i) const {
    if constexpr (N <= 8) {
      return (int)((gen >> (8 * i)) & 0xFFu);
    } else {
      return i < 8 ? (int)((gen >> (8 * i)) & 0xFFu)
                   : (int)((gen_hi >> (8 * (i - 8))) & 0xFFu);
    }
  }
  template <int N>
  __device__ __forceinline__ void set_gen(int i, int g) {
    if constexpr (N > 8) {
      if (i >= 8) {
        gen_hi = (gen_hi & ~(0xFFu << (8 * (i - 8)))) |
                 ((uint32_t)g << (8 * (i - 8)));
        return;
      }
    }
    gen = (gen & ~(0xFFull << (8 * i))) | ((uint64_t)g << (8 * i));
  }
};

template <int N, class Lanes>
__device__ __forceinline__ void load_rest(const State<Lanes>& s, size_t w,
                                          Pre<typename Lanes::Profile>& r) {
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
    if (i < 8)
      r.gen |= (uint64_t)(uint8_t)s.gen[at] << (8 * i);
    else
      r.gen_hi |= (uint32_t)(uint8_t)s.gen[at] << (8 * (i - 8));
  }
}

__device__ __forceinline__ uint32_t set_bit(uint32_t m, int i, bool on) {
  return on ? (m | (1u << i)) : (m & ~(1u << i));
}

}  // namespace
