// The bridge's decision kernel: one lockstep round (bridge_step_kernel) and
// one pop-only drain round (bridge_drain_kernel) for every world, each one
// launch.
//
// Replaces: madsim_tpu/bridge/kernel.py `_step` (:127) and `_drain_step`
// (:236), two XLA programs of about thirty scatters and reductions each.
// The plain PyTorch version is madsim_tpu_torch/bridge/kernel.py
// (step_plain, drain_plain); the wrapper is madsim_tpu_torch/bridge/cuda.py,
// whose bridge_model is this file's order of work in numpy.
//
// A round, per world: (1) cancels set their lanes empty, (2) new timers
// write (deadline, seq), (3) each send draws its loss (counter ctr) and its
// latency (ctr + 1) from the world's NET Threefry stream, and a live send
// that survives writes its delivery (s_base + latency, wrapping, clamped at
// the wheel's horizon); (4) the clock advances to max(earliest + 50 ns,
// clock_in); (5) k pops at that clock, each m = min(dl), then the first
// index of the least (seq where dl == m, else INF); (6) more_due and the
// metrics. The phases run in that order, so a slot cancelled and reused in
// one batch holds the new timer and a slot written by a timer and a send
// holds the send. Masked writes are skipped (the plain version sends them
// to the dump column CAP, whose content is unspecified on both sides, so
// this kernel never writes it).
//
// Design. A world is a group of G lanes (32, 16 or 8), 32 / G worlds a
// warp, up to 8 warps a block, so that a wide round shares each warp's
// instructions among 2 or 4 worlds and the grid keeps one block per SM
// where W allows. The caller chooses G and the warps a block
// (bridge/cuda.py launch_shape, the rule's one statement); the entry points
// refuse a shape the kernels cannot take. The kernel has one load phase
// and then no device-memory read on its chain:
// - At the top, each warp starts the copy of its worlds' rows of lane_dl
//   and lane_seq into shared memory: one TMA bulk copy of each span
//   (cp.async.bulk, completing on the warp's mbarrier) where the span's
//   source and destination are 16-byte aligned and its length a multiple
//   of 16 bytes (2 or 4 worlds at CAP = 128), else 8-byte cp.async, each
//   group its row. While the copies fly,
//   each lane loads the world's scalars and one entry of each batch group
//   into registers (the entries past the G-th load in their phase) and
//   runs its send's two Threefry draws and the latency's modulo.
// - The batch phases write the staged rows (and through to device memory
//   only the slots they change), __syncwarp between phases.
// - A pop is one reduction (log2 G xor-shuffle levels) of a fused key:
//   each lane's partial is the least (dl, seq, index) of its slots, so the
//   reduction gives m, the least seq at m and its first index at once,
//   compared with bitwise logic and selects (no branch to diverge on).
//   JAX's argmin returns index 0 where every candidate's seq is INF (each
//   cand is INF then), and so does this kernel; the popped seq is the
//   reduction's, or the staged seq of slot 0 in that case. The advance's
//   min is the first pop's reduction; more_due comes out of the last pop's,
//   which also carries the least deadline of the slots other than the
//   popped one. Only the lane that owns the popped slot rescans its slots;
//   a world whose pop is not due stops (nothing changes after it), and the
//   warp stops when all its worlds have.
// - The outputs are written at the end: lane e of a group writes pop e's
//   slot, seq and validity (pops past the G-th go out from its lane 0 as
//   they happen), lane 0 the world's scalars, lanes 0-5 the metrics rows.
// u64 arithmetic is native uint64_t: the sums that XLA wraps are done
// unsigned (signed overflow is undefined in C++). Per-world values stay in
// scalars and structs passed by value (nvcc has miscompiled arrays passed
// by reference into inlined code).
//
// What bounds it: below about 1,000 worlds, the chain of one world (the
// batch's load, its draws and modulo, the k reductions) over the launch
// itself; from a few thousand worlds, the bytes staged (the deadline and
// seq rows, 8.5 MB at W = 4096, CAP = 128, against the 6.8 MB the round's
// data needs) and the warps' instructions. See PERF.md for the numbers.

#include <climits>
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#include "step_common.cuh"

namespace {

constexpr int64_t BR_INF = INT64_MAX;
constexpr int64_t BR_TIMER_MAX = (1LL << 62) - 1;
constexpr uint64_t BR_EPSILON = 50;
constexpr unsigned FULL_MASK = 0xFFFFFFFFu;
constexpr int BR_MAX_CAP = 1024;
// The kernels' launch bounds name one block an SM at least: with the
// default, ptxas held some instantiations to 64 registers and spilled.
constexpr int BR_MAX_WARPS = 8;
// Shared memory a block may use: it keeps several blocks on an SM, and no
// launch needs the opt-in attribute (one world at CAP = 1024 takes 16 KB).
constexpr int BR_SMEM_BUDGET = 48 * 1024;
// The warps' mbarriers at the head of the block's shared memory, padded so
// that the staged rows start 16-byte aligned.
constexpr int BR_BAR_BYTES = 8 * BR_MAX_WARPS;

// Pointer order of madsim_bridge_step's `ptrs` (bridge/cuda.py
// STEP_FIELDS): the state, the NET keys, the (6, W) metrics block (or
// null), the 18 HostBatch fields, the 7 StepOut fields.
struct StepPtrs {
  int64_t* clock;
  int64_t* lane_dl;
  int64_t* lane_seq;
  const int64_t* net_k0;
  const int64_t* net_k1;
  int64_t* mb;
  const int32_t* t_slot;
  const int64_t* t_dl;
  const int64_t* t_seq;
  const uint8_t* t_mask;
  const int32_t* c_slot;
  const uint8_t* c_mask;
  const uint64_t* s_ctr;
  const int64_t* s_base;
  const int32_t* s_slot;
  const int64_t* s_seq;
  const uint64_t* s_thr;
  const uint8_t* s_lossall;
  const int64_t* s_lat_lo;
  const int64_t* s_lat_w;
  const uint8_t* s_mask;
  const uint8_t* s_live;
  const int64_t* clock_in;
  const uint8_t* advance;
  int64_t* o_clock;
  uint8_t* o_deadlock;
  uint8_t* o_send_ok;
  int32_t* o_event_slot;
  int64_t* o_event_seq;
  uint8_t* o_event_valid;
  uint8_t* o_more_due;
};
constexpr int N_STEP_PTRS = sizeof(StepPtrs) / sizeof(void*);

// Pointer order of madsim_bridge_drain's `ptrs`.
struct DrainPtrs {
  const int64_t* clock;
  int64_t* lane_dl;
  const int64_t* lane_seq;
  int64_t* mb;
  int64_t* o_event_seq;
  uint8_t* o_event_valid;
  uint8_t* o_more_due;
};
constexpr int N_DRAIN_PTRS = sizeof(DrainPtrs) / sizeof(void*);

// ---- The lane copy: TMA bulk copies on an mbarrier, or cp.async ---------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar))
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar))
        : "memory");
  }
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The block's staged rows: one mbarrier a warp (BR_BAR_BYTES at the
// head), then the block's rows of deadlines, then its rows of seqs, each
// row CAP + 1 long (a bulk copy takes the dump column too; it is never
// read). The seq rows start at the first 16-byte boundary after the
// deadline rows, so that a warp's rows of both are aligned alike.
__host__ __device__ __forceinline__ size_t seq_rows_at(int worlds, int cap) {
  return ((size_t)worlds * (cap + 1) + 1) & ~(size_t)1;
}

struct Stage {
  uint64_t* bar;
  int64_t* dl;
  int64_t* sq;
  bool bulk;
};

// Starts the copy of the warp's worlds' rows of lane_dl and lane_seq into
// the block's staged rows (`nw` rows from world `w0`): one bulk copy of
// each span where its source and destination are 16-byte aligned and its
// length a multiple of 16 bytes (rows x (CAP + 1) even: a warp of 2 or 4
// worlds, or an odd CAP), issued
// by the warp's lane 0 on the warp's mbarrier; else 8-byte cp.async, each
// group of G lanes its world's row. Warp-uniform: no block barrier. BULK
// false (no warp of the launch could take the bulk copy) leaves its code
// out.
template <int G, bool BULK>
__device__ __forceinline__ Stage stage_start(unsigned char* smem,
                                             const int64_t* g_dl,
                                             const int64_t* g_sq, int w0,
                                             int nw, int cap, int row,
                                             int sub, bool live) {
  const int len = cap + 1;
  const int warp = threadIdx.x >> 5;
  const int first = warp * (32 / G);  // the warp's first row
  const int rows = nw - first < 32 / G ? nw - first : 32 / G;
  Stage s;
  s.bar = reinterpret_cast<uint64_t*>(smem) + warp;
  s.dl = reinterpret_cast<int64_t*>(smem + BR_BAR_BYTES);
  s.sq = s.dl + seq_rows_at(nw, cap);
  const size_t at = (size_t)first * len;
  const int64_t* src_dl = g_dl + (size_t)w0 * len + at;
  const int64_t* src_sq = g_sq + (size_t)w0 * len + at;
  const uint32_t bytes = rows > 0 ? (uint32_t)rows * len * 8 : 0;
  s.bulk = BULK && bytes > 0 &&
           (((uintptr_t)src_dl | (uintptr_t)src_sq | (uintptr_t)(s.dl + at) |
             (uintptr_t)(s.sq + at) | bytes) &
            15) == 0;
  if (s.bulk) {
    const bool lead = (threadIdx.x & 31) == 0;
    if (lead) mbar_init(s.bar);
    __syncwarp();
    if (lead) {
      mbar_expect(s.bar, 2 * bytes);
      bulk_load(s.dl + at, src_dl, bytes, s.bar);
      bulk_load(s.sq + at, src_sq, bytes, s.bar);
    }
  } else if (live) {
    const size_t mine = (size_t)row * len;
    for (int i = sub; i < cap; i += G) {
      cp_async8(s.dl + mine + i, g_dl + (size_t)w0 * len + mine + i);
      cp_async8(s.sq + mine + i, g_sq + (size_t)w0 * len + mine + i);
    }
  }
  return s;
}

// Waits for this warp's staged rows.
__device__ __forceinline__ void stage_wait(const Stage& s) {
  if (s.bulk) {
    mbar_wait(s.bar);
  } else {
    cp_async_wait();
    __syncwarp();
  }
}

// ---- The pops -----------------------------------------------------------

// A lane's part of the fused pop key: the least (dl, seq, index) of its
// slots, and `d2`, the least deadline of its other slots. A lane without
// slots holds (INF, INF, INT_MAX, INF), after every real slot.
struct Key {
  int64_t d;
  int64_t c;
  int i;
  int64_t d2;
};

// Whether (d, c, i) comes before `k`. Bitwise on bools and selects below,
// never branches: a short-circuit compare compiles to branches on which
// the lanes diverge at every shuffle level.
__device__ __forceinline__ bool key_less(int64_t d, int64_t c, int i,
                                         const Key& k) {
  const bool dl = d < k.d, de = d == k.d;
  const bool cl = c < k.c, ce = c == k.c;
  return dl | (de & (cl | (ce & (i < k.i))));
}

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

// The lane's Key over slots sub, sub + G, ... of its world's staged row.
template <int G>
__device__ __forceinline__ Key lane_key(const int64_t* dl, const int64_t* sq,
                                        int cap, int sub) {
  Key k{BR_INF, BR_INF, INT_MAX, BR_INF};
  for (int i = sub; i < cap; i += G) {
    const int64_t d = dl[i], c = sq[i];
    const bool take = key_less(d, c, i, k);
    k.d2 = min64(k.d2, take ? k.d : d);
    k.d = take ? d : k.d;
    k.c = take ? c : k.c;
    k.i = take ? i : k.i;
  }
  return k;
}

// The least Key of the lane's group of G, at each of its lanes (xor
// shuffles at offsets G/2 .. 1 stay inside the group; every lane of the
// warp runs them); with D2 also the least deadline of every slot but the
// least one.
template <int G, bool D2>
__device__ __forceinline__ Key group_key(Key k) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
    const int64_t od =
        (int64_t)__shfl_xor_sync(FULL_MASK, (long long)k.d, off);
    const int64_t oc =
        (int64_t)__shfl_xor_sync(FULL_MASK, (long long)k.c, off);
    const int oi = __shfl_xor_sync(FULL_MASK, k.i, off);
    const bool take = key_less(od, oc, oi, k);
    if (D2) {
      const int64_t o2 =
          (int64_t)__shfl_xor_sync(FULL_MASK, (long long)k.d2, off);
      k.d2 = min64(min64(k.d2, o2), take ? k.d : od);
    }
    k.d = take ? od : k.d;
    k.c = take ? oc : k.c;
    k.i = take ? oi : k.i;
  }
  return k;
}

template <int G>
__device__ __forceinline__ Key group_key_for(Key k, bool last) {
  return last ? group_key<G, true>(k) : group_key<G, false>(k);
}

template <int G>
__device__ __forceinline__ int group_sum(int v) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(FULL_MASK, v, off);
  return v;
}

// What the pops leave at a lane: pop `sub`'s slot, seq and validity (for
// sub < k), the pops that were due and whether an event is still due.
struct Popped {
  int slot;
  int64_t seq;
  bool valid;
  int fired;
  bool more;
};

// k pops at `clock` from the world's staged row (`dl`, `sq`; `g_dl` its
// row in device memory), starting from the group's least Key `r` (reduced
// with D2 where k == 1) and the lane's own `mine`. A group whose pop is not
// due stops (nothing changes after it); the warp goes on while any of its
// groups does, so that every shuffle runs on the whole warp. Pops past the
// G-th are written at once by the group's lane 0 at row `w` of the (W, k)
// outputs (o_slot may be null); the first G come back in Popped.
template <int G>
__device__ __forceinline__ Popped pop_events(Key r, Key mine, int64_t* dl,
                                             const int64_t* sq,
                                             int64_t* g_dl, int cap, int k,
                                             int64_t clock, int sub,
                                             bool live, int w,
                                             int32_t* o_slot, int64_t* o_seq,
                                             uint8_t* o_valid) {
  Popped out{0, 0, false, 0, false};
  bool going = live;
  for (int e = 0; e < k; e++) {
    if (e > 0) {
      if (!__any_sync(FULL_MASK, going)) break;
      r = group_key_for<G>(mine, e == k - 1);
    }
    if (!going) continue;
    // Every candidate's seq is INF: JAX's argmin takes index 0.
    const bool tie = r.c == BR_INF;
    const int j = tie ? 0 : r.i;
    const int64_t seq = tie ? sq[0] : r.c;
    const bool due = r.d <= clock;
    const int last = due ? e : k - 1;  // the pops this result fills
    if (sub >= e && sub <= last) {
      out.slot = j;
      out.seq = seq;
      out.valid = due;
    }
    if (sub == 0) {
      for (int f = e > G ? e : G; f <= last; f++) {
        const size_t o = (size_t)w * k + f;
        if (o_slot != nullptr) o_slot[o] = j;
        o_seq[o] = seq;
        o_valid[o] = due;
      }
    }
    going = due;
    if (!due) continue;
    out.fired++;
    if (sub == (j & (G - 1))) {
      dl[j] = BR_INF;
      g_dl[j] = BR_INF;
      mine = lane_key<G>(dl, sq, cap, sub);
    }
    // After the last pop: the least deadline left is r.d2 where the pop
    // took the least slot, else the least slot's own (the tie at index 0).
    if (e == k - 1) out.more = (j == r.i ? r.d2 : r.d) <= clock;
  }
  return out;
}

// ---- A round -------------------------------------------------------------

struct Send {
  bool ok;       // a send that passed the loss draw
  bool lost;     // a send that did not
  bool mask;
  int slot;      // the delivery's slot, or -1 where nothing is written
  int64_t when;  // the delivery's deadline
  int64_t seq;
};

// Send `at` (an index into the (W, S) fields): both draws and the delivery.
// Every field is read before any is used, so the loads issue together.
__device__ __forceinline__ Send load_send(const StepPtrs& p, size_t at,
                                          uint32_t k0, uint32_t k1,
                                          int cap) {
  const bool mask = p.s_mask[at] != 0;
  const uint64_t ctr = p.s_ctr[at];
  const uint64_t thr = p.s_thr[at];
  const bool lossall = p.s_lossall[at] != 0;
  const bool live = p.s_live[at] != 0;
  const int slot = p.s_slot[at];
  const uint64_t lat_lo = (uint64_t)p.s_lat_lo[at];
  const uint64_t lat_w = (uint64_t)p.s_lat_w[at];
  const uint64_t base = (uint64_t)p.s_base[at];
  const int64_t seq = p.s_seq[at];
  // The draws run whatever the mask says, so that no load waits behind
  // the mask's.
  const uint64_t ctr1 = ctr + 1;
  uint32_t a0, a1, b0, b1;
  threefry2x32(k0, k1, (uint32_t)ctr, (uint32_t)(ctr >> 32), a0, a1);
  threefry2x32(k0, k1, (uint32_t)ctr1, (uint32_t)(ctr1 >> 32), b0, b1);
  const uint64_t u_loss = ((uint64_t)a1 << 32) | a0;
  const uint64_t u_lat = ((uint64_t)b1 << 32) | b0;
  const bool lost = u_loss < thr || lossall;
  const bool deliver =
      mask && !lost && live && (unsigned)slot < (unsigned)cap;
  const int64_t when =
      (int64_t)(base + lat_lo + u_lat % (deliver ? lat_w : 1));
  return Send{mask && !lost, mask && lost, mask, deliver ? slot : -1,
              when < BR_TIMER_MAX ? when : BR_TIMER_MAX, seq};
}

__device__ __forceinline__ Send no_send() {
  return Send{false, false, false, -1, 0, 0};
}

struct Timer {
  bool mask;
  int slot;
  int64_t dl;
  int64_t seq;
};

__device__ __forceinline__ Timer load_timer(const StepPtrs& p, size_t at) {
  const bool mask = p.t_mask[at] != 0;
  const int slot = p.t_slot[at];
  const int64_t dl = p.t_dl[at];
  const int64_t seq = p.t_seq[at];
  return Timer{mask, mask ? slot : -1, dl, seq};
}

__device__ __forceinline__ Timer no_timer() {
  return Timer{false, -1, 0, 0};
}

// A cancel's slot, or INT_MIN where the entry is masked.
__device__ __forceinline__ int load_cancel(const StepPtrs& p, size_t at) {
  const bool mask = p.c_mask[at] != 0;
  const int slot = p.c_slot[at];
  return mask ? slot : INT_MIN;
}

// The world's staged row and its row in device memory.
struct Row {
  int64_t* dl;
  int64_t* sq;
  int64_t* g_dl;
  int64_t* g_sq;
};

__device__ __forceinline__ void apply_cancel(Row r, int slot, int cap) {
  if ((unsigned)slot < (unsigned)cap) r.dl[slot] = r.g_dl[slot] = BR_INF;
}

__device__ __forceinline__ void apply_write(Row r, int slot, int64_t dl,
                                            int64_t seq, int cap) {
  if ((unsigned)slot < (unsigned)cap) {
    r.dl[slot] = r.g_dl[slot] = dl;
    r.sq[slot] = r.g_sq[slot] = seq;
  }
}

// Where a lane's world sits: G lanes a world, 32 / G worlds a warp, the
// block's worlds in order. A group past W (the last block's tail) runs
// with the warp on world W - 1's inputs and writes nothing (`live` false).
template <int G>
struct Place {
  int sub;   // the lane's index in its group
  int row;   // the world's row among the block's
  int w0;    // the block's first world
  int nw;    // the block's worlds
  int w;     // the world (W - 1 for a group past W)
  bool live;
  __device__ __forceinline__ Place(int W) {
    const int lane = threadIdx.x & 31;
    const int per = (blockDim.x >> 5) * (32 / G);
    sub = lane & (G - 1);
    row = (threadIdx.x >> 5) * (32 / G) + lane / G;
    w0 = blockIdx.x * per;
    nw = W - w0 < per ? W - w0 : per;
    live = row < nw;
    w = live ? w0 + row : W - 1;
  }
};

template <int G, bool BULK>
__global__ void __launch_bounds__(BR_MAX_WARPS * 32, 1)
    bridge_step_kernel(StepPtrs p, int W, int cap, int k, int T, int C,
                       int S) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Place<G> at(W);
  const int sub = at.sub, w = at.w;
  const Stage stage = stage_start<G, BULK>(smem, p.lane_dl, p.lane_seq, at.w0,
                                     at.nw, cap, at.row, sub, at.live);
  if ((threadIdx.x >> 5) * (32 / G) >= at.nw) return;  // a warp past W

  // The load phase: the world's scalars and the first entry of each batch
  // group a lane, the send's draws, while the lanes fly.
  const int64_t clock_in = p.clock_in[w];
  const bool advance = p.advance[w] != 0;
  const int64_t old_clock = p.clock[w];
  const uint32_t k0 = (uint32_t)p.net_k0[w];
  const uint32_t k1 = (uint32_t)p.net_k1[w];
  const bool metrics = p.mb != nullptr;
  const int64_t mb_old = metrics && sub < 6 ? p.mb[(size_t)sub * W + w] : 0;
  const bool live = at.live;
  const int cancel0 =
      live && sub < C ? load_cancel(p, (size_t)w * C + sub) : INT_MIN;
  const Timer timer0 =
      live && sub < T ? load_timer(p, (size_t)w * T + sub) : no_timer();
  const Send send0 = live && sub < S
                         ? load_send(p, (size_t)w * S + sub, k0, k1, cap)
                         : no_send();
  stage_wait(stage);
  const size_t row = (size_t)w * (cap + 1);
  const size_t srow = (size_t)at.row * (cap + 1);
  const Row r{stage.dl + srow, stage.sq + srow, p.lane_dl + row,
              p.lane_seq + row};

  // 1. Cancels.
  int n_cancel = cancel0 != INT_MIN;
  apply_cancel(r, cancel0, cap);
  for (int c = sub + G; c < C; c += G) {
    const int slot = live ? load_cancel(p, (size_t)w * C + c) : INT_MIN;
    n_cancel += slot != INT_MIN;
    apply_cancel(r, slot, cap);
  }
  __syncwarp();

  // 2. New timers.
  int n_timer = timer0.mask;
  apply_write(r, timer0.slot, timer0.dl, timer0.seq, cap);
  for (int t = sub + G; t < T; t += G) {
    const Timer x = live ? load_timer(p, (size_t)w * T + t) : no_timer();
    n_timer += x.mask;
    apply_write(r, x.slot, x.dl, x.seq, cap);
  }
  __syncwarp();

  // 3. Sends.
  int n_sent = send0.mask, n_lost = send0.lost;
  apply_write(r, send0.slot, send0.when, send0.seq, cap);
  for (int s = sub + G; s < S; s += G) {
    const size_t e = (size_t)w * S + s;
    const Send x = live ? load_send(p, e, k0, k1, cap) : no_send();
    n_sent += x.mask;
    n_lost += x.lost;
    apply_write(r, x.slot, x.when, x.seq, cap);
    if (live) p.o_send_ok[e] = x.ok;
  }
  __syncwarp();

  // 4. Advance to the next event: the first pop's reduction is the min.
  const Key mine = lane_key<G>(r.dl, r.sq, cap, sub);
  const Key first = group_key_for<G>(mine, k == 1);
  const bool has_timer = first.d < BR_INF;
  int64_t clock = clock_in;
  if (advance && has_timer) {
    const int64_t next = (int64_t)((uint64_t)first.d + BR_EPSILON);
    clock = next > clock_in ? next : clock_in;
  }

  // 5. Pops.
  const Popped pop = pop_events<G>(
      first, mine, r.dl, r.sq, r.g_dl, cap, k, clock, sub, live, w,
      p.o_event_slot, p.o_event_seq, p.o_event_valid);

  // 6. The outputs and the metrics.
  if (metrics) {
    n_cancel = group_sum<G>(n_cancel);
    n_timer = group_sum<G>(n_timer);
    n_sent = group_sum<G>(n_sent);
    n_lost = group_sum<G>(n_lost);
  }
  if (!live) return;
  if (sub < k) {
    const size_t o = (size_t)w * k + sub;
    p.o_event_slot[o] = pop.slot;
    p.o_event_seq[o] = pop.seq;
    p.o_event_valid[o] = pop.valid;
  }
  if (sub < S) p.o_send_ok[(size_t)w * S + sub] = send0.ok;
  if (sub == 0) {
    p.clock[w] = clock;
    p.o_clock[w] = clock;
    p.o_deadlock[w] = advance && !has_timer;
    p.o_more_due[w] = pop.more;
  }
  if (metrics && sub < 6) {
    const uint64_t add =
        sub == 0   ? (uint64_t)n_timer
        : sub == 1 ? (uint64_t)n_cancel
        : sub == 2 ? (uint64_t)n_sent
        : sub == 3 ? (uint64_t)n_lost
        : sub == 4 ? (uint64_t)pop.fired
                   : (uint64_t)clock - (uint64_t)old_clock;
    p.mb[(size_t)sub * W + w] = (int64_t)((uint64_t)mb_old + add);
  }
}

template <int G, bool BULK>
__global__ void __launch_bounds__(BR_MAX_WARPS * 32, 1)
    bridge_drain_kernel(DrainPtrs p, int W, int cap, int k) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Place<G> at(W);
  const int sub = at.sub, w = at.w;
  const Stage stage = stage_start<G, BULK>(smem, p.lane_dl, p.lane_seq, at.w0,
                                     at.nw, cap, at.row, sub, at.live);
  if ((threadIdx.x >> 5) * (32 / G) >= at.nw) return;
  const int64_t clock = p.clock[w];
  const bool metrics = p.mb != nullptr;
  const int64_t fired_old =
      metrics && sub == 0 ? p.mb[4 * (size_t)W + w] : 0;
  stage_wait(stage);
  const size_t srow = (size_t)at.row * (cap + 1);
  int64_t* dl = stage.dl + srow;
  const int64_t* sq = stage.sq + srow;
  const Key mine = lane_key<G>(dl, sq, cap, sub);
  const Popped pop = pop_events<G>(
      group_key_for<G>(mine, k == 1), mine, dl, sq,
      p.lane_dl + (size_t)w * (cap + 1), cap, k, clock, sub, at.live, w,
      nullptr, p.o_event_seq, p.o_event_valid);
  if (!at.live) return;
  if (sub < k) {
    const size_t o = (size_t)w * k + sub;
    p.o_event_seq[o] = pop.seq;
    p.o_event_valid[o] = pop.valid;
  }
  if (sub == 0) {
    p.o_more_due[w] = pop.more;
    if (metrics) p.mb[4 * (size_t)W + w] = fired_old + pop.fired;
  }
}

// The launch floor's yardstick: nothing, on the kernels' grid.
__global__ void __launch_bounds__(BR_MAX_WARPS * 32) bridge_empty_kernel() {}

size_t smem_bytes(int worlds, int cap) {
  return BR_BAR_BYTES +
         (seq_rows_at(worlds, cap) + (size_t)worlds * (cap + 1)) *
             sizeof(int64_t);
}

// The launch's shape: `lanes` a world (8, 16 or 32), `warps` a block
// (1 to 8), and whether a whole warp's rows could come in one bulk copy
// (16-byte aligned lanes, an even rows x (CAP + 1)). `ok` false for a
// shape the kernels cannot take (its staged rows past BR_SMEM_BUDGET).
struct Shape {
  bool ok;
  int lanes;
  int warps;
  int blocks;
  size_t smem;
  bool bulk;
};

Shape shape(int W, int cap, int lanes, int warps, const void* dl,
            const void* sq) {
  Shape sh{false, lanes, warps, 0, 0, false};
  if (W < 1 || cap < 1 || cap > BR_MAX_CAP ||
      (lanes != 8 && lanes != 16 && lanes != 32) || warps < 1 ||
      warps > BR_MAX_WARPS)
    return sh;
  const int per = warps * (32 / lanes);
  sh.smem = smem_bytes(per, cap);
  sh.blocks = (W + per - 1) / per;
  sh.bulk = ((((uintptr_t)dl | (uintptr_t)sq) & 15) == 0) &&
            (32 / lanes) * (cap + 1) % 2 == 0;
  sh.ok = sh.smem <= (size_t)BR_SMEM_BUDGET;
  return sh;
}

template <int G, bool BULK>
int launch_step(const StepPtrs& p, Shape sh, int W, int cap, int k, int T,
                int C, int S, cudaStream_t stream) {
  bridge_step_kernel<G, BULK>
      <<<sh.blocks, sh.warps * 32, sh.smem, stream>>>(p, W, cap, k, T, C, S);
  return (int)cudaGetLastError();
}

template <int G, bool BULK>
int launch_drain(const DrainPtrs& p, Shape sh, int W, int cap, int k,
                 cudaStream_t stream) {
  bridge_drain_kernel<G, BULK>
      <<<sh.blocks, sh.warps * 32, sh.smem, stream>>>(p, W, cap, k);
  return (int)cudaGetLastError();
}

}  // namespace

// One lockstep round for W worlds: `ptrs` in StepPtrs order (only the
// metrics block may be null), k pops, batch widths T, C, S, on `lanes` a
// world and `warps` a block. Returns the launch's CUDA error code.
extern "C" int madsim_bridge_step(const void* const* ptrs, int n_ptrs, int W,
                                  int cap, int k, int T, int C, int S,
                                  int lanes, int warps, void* stream) {
  if (n_ptrs != N_STEP_PTRS || W < 0 || cap < 1 || cap > BR_MAX_CAP ||
      k < 1 || T < 0 || C < 0 || S < 0)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < N_STEP_PTRS; i++)
    if (ptrs[i] == nullptr && i != 5) return (int)cudaErrorInvalidValue;
  StepPtrs p;
  std::memcpy(&p, ptrs, sizeof(p));
  if (W == 0) return (int)cudaSuccess;
  const Shape sh = shape(W, cap, lanes, warps, p.lane_dl, p.lane_seq);
  if (!sh.ok) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (sh.lanes) {
    case 8: return launch_step<8, true>(p, sh, W, cap, k, T, C, S, st);
    case 16: return launch_step<16, true>(p, sh, W, cap, k, T, C, S, st);
    default:
      return sh.bulk ? launch_step<32, true>(p, sh, W, cap, k, T, C, S, st)
                     : launch_step<32, false>(p, sh, W, cap, k, T, C, S, st);
  }
}

// One pop-only drain round for W worlds: `ptrs` in DrainPtrs order (only
// the metrics block may be null), k pops at each world's clock, on `lanes`
// a world and `warps` a block.
extern "C" int madsim_bridge_drain(const void* const* ptrs, int n_ptrs, int W,
                                   int cap, int k, int lanes, int warps,
                                   void* stream) {
  if (n_ptrs != N_DRAIN_PTRS || W < 0 || cap < 1 || cap > BR_MAX_CAP || k < 1)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < N_DRAIN_PTRS; i++)
    if (ptrs[i] == nullptr && i != 3) return (int)cudaErrorInvalidValue;
  DrainPtrs p;
  std::memcpy(&p, ptrs, sizeof(p));
  if (W == 0) return (int)cudaSuccess;
  const Shape sh = shape(W, cap, lanes, warps, p.lane_dl, p.lane_seq);
  if (!sh.ok) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (sh.lanes) {
    case 8: return launch_drain<8, true>(p, sh, W, cap, k, st);
    case 16: return launch_drain<16, true>(p, sh, W, cap, k, st);
    default:
      return sh.bulk ? launch_drain<32, true>(p, sh, W, cap, k, st)
                     : launch_drain<32, false>(p, sh, W, cap, k, st);
  }
}

// An empty kernel on the round's grid for W worlds at `cap` on `lanes` a
// world and `warps` a block (blocks, threads and shared memory), for the
// launch floor.
extern "C" int madsim_bridge_empty(int W, int cap, int lanes, int warps,
                                   void* stream) {
  const Shape sh = shape(W, cap, lanes, warps, nullptr, nullptr);
  if (!sh.ok) return (int)cudaErrorInvalidValue;
  bridge_empty_kernel<<<sh.blocks, sh.warps * 32, sh.smem,
                        static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
