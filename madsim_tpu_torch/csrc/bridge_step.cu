// The bridge's decision kernel: one lockstep round (bridge_step_kernel) and
// one pop-only drain round (bridge_drain_kernel) for every world, each one
// launch.
//
// Replaces: madsim_tpu/bridge/kernel.py `_step` (:127) and `_drain_step`
// (:236), two XLA programs of about thirty scatters and reductions each.
// The plain PyTorch version is madsim_tpu_torch/bridge/kernel.py
// (step_plain, drain_plain); the wrapper is madsim_tpu_torch/bridge/cuda.py.
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
// this kernel never touches it).
//
// Design: one warp per world, the world's CAP deadlines staged in shared
// memory and strided over the 32 threads (any CAP up to 1024, any k), the
// scatter phases separated by __syncwarp, one thread per send for the two
// draws, each pop two warp reductions (min of dl, then the least (cand,
// index) pair). Every write goes to the staged deadlines and through to
// global memory at once, so a round writes only the slots it changes; the
// seqs are never staged: a pop reads them in global memory only where
// dl == m (__syncwarp orders the warp's global writes before those reads). u64 arithmetic is native uint64_t: the sums
// that XLA wraps are done unsigned (signed overflow is undefined in C++).
// Per-world values stay in scalars (nvcc has miscompiled arrays passed by
// reference into inlined code).
//
// What bounds it: bytes. A round must read the W x CAP x 8 bytes of
// deadlines once (4.2 MB at W = 4096, CAP = 128), plus the batch and the
// outputs, and write only the slots the batch and the pops touch; the
// draws are 40 Threefry rounds a send. At the widths the
// bridge runs, a round is far below a microsecond of device time per world
// block, so the launch and the host's copies decide its wall.

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
constexpr int BR_MAX_WARPS = 8;
// Shared memory a block may use without the opt-in attribute.
constexpr int BR_SMEM_BUDGET = 48 * 1024;

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

__device__ __forceinline__ int64_t warp_min(int64_t v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int64_t o = (int64_t)__shfl_xor_sync(FULL_MASK, (long long)v, off);
    v = o < v ? o : v;
  }
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
  return (int)__reduce_add_sync(FULL_MASK, (unsigned)v);
}

// The least deadline of the world's staged lanes (every thread gets it).
__device__ __forceinline__ int64_t lanes_min(const int64_t* dl, int cap,
                                             int lane) {
  int64_t m = BR_INF;
  for (int i = lane; i < cap; i += 32) m = dl[i] < m ? dl[i] : m;
  return warp_min(m);
}

struct Popped {
  int fired;   // pops that were due
  bool more;   // an event still due after the k pops
};

// k pops at `clock` from the staged deadlines `dl` (the world's row in
// global memory: g_dl, g_sq), as JAX's two reductions; lane 0 writes each
// pop's slot (where o_slot is not null), seq and validity at row `w` of the
// (W, k) outputs, and a due pop empties its lane in `dl` and in g_dl.
__device__ __forceinline__ Popped pop_events(int64_t* dl, int64_t* g_dl,
                                             const int64_t* g_sq, int cap,
                                             int k, int64_t clock,
                                             int lane, int w,
                                             int32_t* o_slot,
                                             int64_t* o_seq,
                                             uint8_t* o_valid) {
  int fired = 0;
  for (int e = 0; e < k; e++) {
    const int64_t m = lanes_min(dl, cap, lane);
    const bool due = m <= clock;
    // The first index of the least cand = (dl == m ? seq : INF).
    int64_t best = BR_INF;
    int at = INT_MAX;
    for (int i = lane; i < cap; i += 32) {
      const int64_t c = dl[i] == m ? g_sq[i] : BR_INF;
      if (at == INT_MAX || c < best) {
        best = c;
        at = i;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const int64_t ob =
          (int64_t)__shfl_xor_sync(FULL_MASK, (long long)best, off);
      const int oa = __shfl_xor_sync(FULL_MASK, at, off);
      if (ob < best || (ob == best && oa < at)) {
        best = ob;
        at = oa;
      }
    }
    if (lane == 0) {
      const size_t o = (size_t)w * k + e;
      if (o_slot != nullptr) o_slot[o] = at;
      o_seq[o] = g_sq[at];
      o_valid[o] = due;
      if (due) dl[at] = g_dl[at] = BR_INF;
    }
    fired += due;
    __syncwarp();
  }
  return Popped{fired, lanes_min(dl, cap, lane) <= clock};
}

__global__ void bridge_step_kernel(StepPtrs p, int W, int cap, int k, int T,
                                   int C, int S) {
  extern __shared__ int64_t lanes[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int w = blockIdx.x * (blockDim.x >> 5) + warp;
  if (w >= W) return;  // the whole warp: no block-wide barrier follows
  int64_t* dl = lanes + (size_t)warp * cap;
  const size_t row = (size_t)w * (cap + 1);
  int64_t* g_dl = p.lane_dl + row;
  int64_t* g_sq = p.lane_seq + row;
  for (int i = lane; i < cap; i += 32) dl[i] = g_dl[i];
  __syncwarp();

  // 1. Cancels.
  int n_cancel = 0;
  for (int c = lane; c < C; c += 32) {
    const size_t at = (size_t)w * C + c;
    if (p.c_mask[at]) {
      n_cancel++;
      const int s = p.c_slot[at];
      if ((unsigned)s < (unsigned)cap) dl[s] = g_dl[s] = BR_INF;
    }
  }
  __syncwarp();

  // 2. New timers.
  int n_timer = 0;
  for (int t = lane; t < T; t += 32) {
    const size_t at = (size_t)w * T + t;
    if (p.t_mask[at]) {
      n_timer++;
      const int s = p.t_slot[at];
      if ((unsigned)s < (unsigned)cap) {
        dl[s] = g_dl[s] = p.t_dl[at];
        g_sq[s] = p.t_seq[at];
      }
    }
  }
  __syncwarp();

  // 3. Sends: loss at ctr, latency at ctr + 1 (u64, wrapping).
  const uint32_t k0 = (uint32_t)p.net_k0[w];
  const uint32_t k1 = (uint32_t)p.net_k1[w];
  int n_sent = 0, n_lost = 0;
  for (int s = lane; s < S; s += 32) {
    const size_t at = (size_t)w * S + s;
    bool ok = false;
    if (p.s_mask[at]) {
      n_sent++;
      const uint64_t ctr = p.s_ctr[at];
      const uint64_t ctr1 = ctr + 1;
      uint32_t a0, a1, b0, b1;
      threefry2x32(k0, k1, (uint32_t)ctr, (uint32_t)(ctr >> 32), a0, a1);
      threefry2x32(k0, k1, (uint32_t)ctr1, (uint32_t)(ctr1 >> 32), b0, b1);
      const uint64_t u_loss = ((uint64_t)a1 << 32) | a0;
      const uint64_t u_lat = ((uint64_t)b1 << 32) | b0;
      const bool lost = u_loss < p.s_thr[at] || p.s_lossall[at] != 0;
      n_lost += lost;
      ok = !lost;
      const int slot = p.s_slot[at];
      if (ok && p.s_live[at] && (unsigned)slot < (unsigned)cap) {
        const uint64_t latency =
            (uint64_t)p.s_lat_lo[at] + u_lat % (uint64_t)p.s_lat_w[at];
        const int64_t when = (int64_t)((uint64_t)p.s_base[at] + latency);
        dl[slot] = g_dl[slot] = when < BR_TIMER_MAX ? when : BR_TIMER_MAX;
        g_sq[slot] = p.s_seq[at];
      }
    }
    p.o_send_ok[at] = ok;
  }
  __syncwarp();

  // 4. Advance to the next event.
  const int64_t min_dl = lanes_min(dl, cap, lane);
  const bool has_timer = min_dl < BR_INF;
  const bool advance = p.advance[w] != 0;
  const int64_t clock_in = p.clock_in[w];
  int64_t clock = clock_in;
  if (advance && has_timer) {
    const int64_t next = (int64_t)((uint64_t)min_dl + BR_EPSILON);
    clock = next > clock_in ? next : clock_in;
  }

  // 5. Pops.
  const Popped pop = pop_events(dl, g_dl, g_sq, cap, k, clock, lane, w,
                                p.o_event_slot, p.o_event_seq,
                                p.o_event_valid);
  const bool metrics = p.mb != nullptr;
  if (metrics) {
    n_cancel = warp_sum(n_cancel);
    n_timer = warp_sum(n_timer);
    n_sent = warp_sum(n_sent);
    n_lost = warp_sum(n_lost);
  }
  if (lane == 0) {
    const int64_t old_clock = p.clock[w];
    p.clock[w] = clock;
    p.o_clock[w] = clock;
    p.o_deadlock[w] = advance && !has_timer;
    p.o_more_due[w] = pop.more;
    if (metrics) {
      p.mb[0 * (size_t)W + w] += n_timer;
      p.mb[1 * (size_t)W + w] += n_cancel;
      p.mb[2 * (size_t)W + w] += n_sent;
      p.mb[3 * (size_t)W + w] += n_lost;
      p.mb[4 * (size_t)W + w] += pop.fired;
      int64_t* vt = p.mb + 5 * (size_t)W + w;
      *vt = (int64_t)((uint64_t)*vt + ((uint64_t)clock - (uint64_t)old_clock));
    }
  }
}

__global__ void bridge_drain_kernel(DrainPtrs p, int W, int cap, int k) {
  extern __shared__ int64_t lanes[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int w = blockIdx.x * (blockDim.x >> 5) + warp;
  if (w >= W) return;
  int64_t* dl = lanes + (size_t)warp * cap;
  const size_t row = (size_t)w * (cap + 1);
  int64_t* g_dl = p.lane_dl + row;
  for (int i = lane; i < cap; i += 32) dl[i] = g_dl[i];
  __syncwarp();
  const int64_t clock = p.clock[w];
  const Popped pop = pop_events(dl, g_dl, p.lane_seq + row, cap, k, clock,
                                lane, w, nullptr, p.o_event_seq,
                                p.o_event_valid);
  if (lane == 0) {
    p.o_more_due[w] = pop.more;
    if (p.mb != nullptr) p.mb[4 * (size_t)W + w] += pop.fired;
  }
}

}  // namespace

// Worlds (warps) per block for a lane capacity: as many as 48 KB of shared
// memory holds (cap int64 deadlines each), at most 8.
extern "C" int madsim_bridge_warps(int cap) {
  if (cap < 1 || cap > BR_MAX_CAP) return 0;
  const int n = BR_SMEM_BUDGET / (8 * cap);
  return n < 1 ? 1 : (n > BR_MAX_WARPS ? BR_MAX_WARPS : n);
}

// One lockstep round for W worlds: `ptrs` in StepPtrs order (only the
// metrics block may be null), k pops, batch widths T, C, S. Returns the
// launch's CUDA error code.
extern "C" int madsim_bridge_step(const void* const* ptrs, int n_ptrs, int W,
                                  int cap, int k, int T, int C, int S,
                                  void* stream) {
  if (n_ptrs != N_STEP_PTRS || W < 0 || cap < 1 || cap > BR_MAX_CAP ||
      k < 1 || T < 0 || C < 0 || S < 0)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < N_STEP_PTRS; i++)
    if (ptrs[i] == nullptr && i != 5) return (int)cudaErrorInvalidValue;
  StepPtrs p;
  std::memcpy(&p, ptrs, sizeof(p));
  if (W == 0) return (int)cudaSuccess;
  const int warps = madsim_bridge_warps(cap);
  const size_t smem = (size_t)warps * cap * sizeof(int64_t);
  bridge_step_kernel<<<(W + warps - 1) / warps, warps * 32, smem,
                       static_cast<cudaStream_t>(stream)>>>(p, W, cap, k, T,
                                                            C, S);
  return (int)cudaGetLastError();
}

// One pop-only drain round for W worlds: `ptrs` in DrainPtrs order (only
// the metrics block may be null), k pops at each world's clock.
extern "C" int madsim_bridge_drain(const void* const* ptrs, int n_ptrs, int W,
                                   int cap, int k, void* stream) {
  if (n_ptrs != N_DRAIN_PTRS || W < 0 || cap < 1 || cap > BR_MAX_CAP || k < 1)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < N_DRAIN_PTRS; i++)
    if (ptrs[i] == nullptr && i != 3) return (int)cudaErrorInvalidValue;
  DrainPtrs p;
  std::memcpy(&p, ptrs, sizeof(p));
  if (W == 0) return (int)cudaSuccess;
  const int warps = madsim_bridge_warps(cap);
  const size_t smem = (size_t)warps * cap * sizeof(int64_t);
  bridge_drain_kernel<<<(W + warps - 1) / warps, warps * 32, smem,
                        static_cast<cudaStream_t>(stream)>>>(p, W, cap, k);
  return (int)cudaGetLastError();
}
