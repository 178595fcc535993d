// The multi-decree Paxos policy of the engine's CUDA step kernel
// (step_kernel.cuh): madsim_tpu/actorc/families/paxos.py's spec as
// madsim_tpu/actorc/compile.py lowers it (CompiledActor.handle, on_restart,
// invariant), written by hand. Its plain version is the port's compiled
// actor (madsim_tpu_torch/actorc/compile.py) on step_plain.
//
// The rules of the lowering kept here, bit for bit:
// - every value a transition writes is computed from the state before the
//   step: the handler reads its lanes first and writes after;
// - one draw per step: CMD and RETRY consume the step's u32 (counter ctr;
//   the cursor then advances by one) whether or not their round starts;
//   the draw only ever times a Retry timer, so it is taken lazily with the
//   sends' draws (Sends::t_draw); no other kind draws;
// - the node-table lanes are (N, S) rows per world, written at the handling
//   node's row and the event's slot column (clipped into [0, S)); each
//   kind writes a lane at most once, so its one write is the last; the
//   int16 lanes saturate on write, the vote masks (promises, accepts) are
//   int32; the three counters add in int32;
// - one message kind and word set per step for every peer it goes to, and
//   one timer (row N). PROMISE carries five words: the fifth, the voter, is
//   the handling node, built by message();
// - under buggy_forgetful_acceptor the acceptor lanes (promised, acc_bal,
//   acc_val) are volatile: a restart zeroes the node's row (the node
//   clipped into range) before the (absent) restart hook; nothing else
//   happens on a restart, and it does not draw.
// The state stays in device memory: the handler reads and writes the
// handling node's slot column by address (a runtime index never indexes a
// local array), and the invariant reads the (N, S) chosen table.
#pragma once

#include "step_common.cuh"

namespace {

constexpr int PX_CMD = 0, PX_PREPARE = 1, PX_PROMISE = 2, PX_ACCEPT = 3,
              PX_ACCEPTED = 4, PX_CHOSEN = 5, PX_RETRY = 6,
              PX_NUM_KINDS = 7;

// The spec's lanes in leaf order (sorted names, as JAX flattens a dict),
// at their packed dtypes (lane_dtype: hi <= 32767 -> int16; bitmasks and
// counters int32). Node tables are (W, N, S), counters (W,).
template <class Pf>
struct PaxosLanes {
  using Profile = Pf;
  typename Pf::slot_t* acc_bal;
  typename Pf::slot_t* acc_val;
  int32_t* accepts;
  typename Pf::slot_t* chosen;
  int32_t* chosen_count;
  typename Pf::slot_t* promised;
  int32_t* promises;
  typename Pf::slot_t* prop_bal;
  typename Pf::slot_t* prop_val;
  int32_t* proposals;
  int32_t* retries;
  typename Pf::slot_t* seen_bal;
  typename Pf::slot_t* seen_val;
};

// Params::f0..f7 (step_kernel.py kernel_params): S = n_slots,
// retry_min_us, retry_max_us, the flags (bit 0 buggy_forgetful_acceptor,
// bit 1 contend_all), then (init only) cmd_start_us, cmd_interval_us,
// contend_slot, contend_gap_us.
__device__ __forceinline__ int px_S(const Params& p) { return p.f0; }
__device__ __forceinline__ bool px_forgetful(const Params& p) {
  return (p.f3 & 1) != 0;
}

// One world's lanes in device memory.
template <int N, class Pf>
struct PaxosView {
  int S;
  typename Pf::slot_t* acc_bal;
  typename Pf::slot_t* acc_val;
  int32_t* accepts;
  typename Pf::slot_t* chosen;
  int32_t* chosen_count;
  typename Pf::slot_t* promised;
  int32_t* promises;
  typename Pf::slot_t* prop_bal;
  typename Pf::slot_t* prop_val;
  int32_t* proposals;
  int32_t* retries;
  typename Pf::slot_t* seen_bal;
  typename Pf::slot_t* seen_val;

  __device__ __forceinline__ PaxosView(const PaxosLanes<Pf>& a, size_t w, int s)
      : S(s),
        acc_bal(a.acc_bal + w * N * s),
        acc_val(a.acc_val + w * N * s),
        accepts(a.accepts + w * N * s),
        chosen(a.chosen + w * N * s),
        chosen_count(a.chosen_count + w),
        promised(a.promised + w * N * s),
        promises(a.promises + w * N * s),
        prop_bal(a.prop_bal + w * N * s),
        prop_val(a.prop_val + w * N * s),
        proposals(a.proposals + w),
        retries(a.retries + w),
        seen_bal(a.seen_bal + w * N * s),
        seen_val(a.seen_val + w * N * s) {}
};

// Consistency: every nonzero learned value of a slot equals the slot's
// largest.
template <int N, class Pf>
__device__ __forceinline__ bool px_invariant(const PaxosView<N, Pf>& v) {
  for (int s = 0; s < v.S; s++) {
    int32_t mx = v.chosen[s];
#pragma unroll
    for (int i = 1; i < N; i++) mx = max(mx, (int32_t)v.chosen[i * v.S + s]);
    bool bad = false;
#pragma unroll
    for (int i = 0; i < N; i++) {
      const int32_t c = v.chosen[i * v.S + s];
      bad = bad || (c > 0 && c != mx);
    }
    if (bad) return true;
  }
  return false;
}

struct PaxosRow {};

template <class Pf>
struct PaxosP {
  using Lanes = PaxosLanes<Pf>;
  using slot_t = typename Pf::slot_t;
  using code_t = typename Pf::code_t;
  template <int N>
  using View = PaxosView<N, Pf>;
  using Row = PaxosRow;
  static constexpr int FAMILY = FAMILY_PAXOS;
  // Node counts up to 8; the outbox is a message per node and the timer.
  static constexpr int MAX_NODES = 8;
  __host__ __device__ static constexpr int m(int n) { return n + 1; }
  // Its rows hold 5 payload words (PROMISE's): loads and stores stop at P.
  static constexpr bool SHORT_PAYLOAD = true;

  template <int N>
  static __device__ __forceinline__ void tiles_in(const State<Lanes>&,
                                                  const Params&, char*,
                                                  size_t, int, int, int,
                                                  int) {}

  template <int N>
  static __device__ __forceinline__ PaxosView<N, Pf> view(const State<Lanes>& s,
                                                      const Params& p,
                                                      size_t w, char*, int) {
    return PaxosView<N, Pf>(s.a, w, px_S(p));
  }

  template <int N>
  static __device__ __forceinline__ int frozen_hint(const State<Lanes>&,
                                                    size_t) {
    return 0;
  }
  template <int N>
  static __device__ __forceinline__ bool frozen_bug(const State<Lanes>& s,
                                                    const Params& p, size_t w,
                                                    int) {
    return px_invariant(PaxosView<N, Pf>(s.a, w, px_S(p)));
  }

  template <int N>
  static __device__ __forceinline__ PaxosRow load_row(const PaxosView<N, Pf>&,
                                                      int) {
    return PaxosRow{};
  }

  // on_restart: with forgetful acceptors the acceptor row of the (clipped)
  // node resets to 0; no hook, no sends, no draw.
  template <int N>
  static __device__ __forceinline__ void on_restart(const Params& p,
                                                    const PaxosView<N, Pf>& v,
                                                    int node, uint32_t,
                                                    uint32_t, uint32_t&,
                                                    Sends&) {
    if (!px_forgetful(p)) return;
    const int me = clampi(node, 0, N - 1);
    for (int s = 0; s < v.S; s++) {
      const int at = me * v.S + s;
      store_if<slot_t>(v.promised + at, v.promised[at], 0);
      store_if<slot_t>(v.acc_bal + at, v.acc_bal[at], 0);
      store_if<slot_t>(v.acc_val + at, v.acc_val[at], 0);
    }
  }

  // The merged handler: every kind's transition, gated by the kind.
  template <int N>
  static __device__ __forceinline__ void handle(
      const Params& p, const PaxosView<N, Pf>& v, int ev_kind, int ev_dst,
      const Payload pay, const PaxosRow, int32_t, uint32_t, uint32_t,
      uint32_t& ctr, Sends& sd, bool& hbug) {
    const int S = v.S;
    const int kind = clampi(ev_kind, 0, PX_NUM_KINDS - 1);
    const int me = clampi(ev_dst, 0, N - 1);
    const uint32_t others = ((1u << N) - 1u) & ~(1u << me);
    constexpr int q = N / 2 + 1;
    hbug = false;
    sd.me = me;
    sd.t_dst = me;
    // The slot word: word 0 of CMD, CHOSEN and RETRY, word 1 of the rest.
    const bool slot_first =
        kind == PX_CMD || kind == PX_CHOSEN || kind == PX_RETRY;
    const int slot = clampi(slot_first ? pay.w0 : pay.w1, 0, S - 1);
    const int at = me * S + slot;
    // The pre-step reads of the handling node's slot column.
    const int32_t promised0 = v.promised[at];
    const int32_t acc_bal0 = v.acc_bal[at], acc_val0 = v.acc_val[at];
    const int32_t prop_bal0 = v.prop_bal[at], prop_val0 = v.prop_val[at];
    const int32_t chosen0 = v.chosen[at];

    // CMD and RETRY start a round (the spec's _start_round) at ballot bal
    // where go holds; both consume the step's draw either way.
    bool go = false;
    int32_t bal = 0;
    if (kind == PX_CMD) {
      go = prop_bal0 == 0 && chosen0 == 0;
      bal = me + 1;
      if (go) {
        store_if<slot_t>(v.prop_val + at, prop_val0, narrow<slot_t>(pay.w1));
        count(v.proposals, 0, 1);
      }
    } else if (kind == PX_RETRY) {
      go = prop_bal0 > 0 && chosen0 == 0;
      bal = prop_bal0 + N;
      if (go) count(v.retries, 0, 1);
    }
    if (kind == PX_CMD || kind == PX_RETRY) {
      if (go) {
        const bool self_ok = bal > promised0;
        if (self_ok)
          store_if<slot_t>(v.promised + at, promised0, narrow<slot_t>(bal));
        store_if<slot_t>(v.prop_bal + at, prop_bal0, narrow<slot_t>(bal));
        const int32_t pm1 = self_ok ? (int32_t)(1u << me) : 0;
        if (v.promises[at] != pm1) v.promises[at] = pm1;
        if (v.accepts[at] != 0) v.accepts[at] = 0;
        store_if<slot_t>(v.seen_bal + at, v.seen_bal[at],
                         (slot_t)(self_ok ? acc_bal0 : 0));
        store_if<slot_t>(v.seen_val + at, v.seen_val[at],
                         (slot_t)(self_ok ? acc_val0 : 0));
        sd.msg_mask = others;
        sd.msg_kind = PX_PREPARE;
        sd.w0 = bal;
        sd.w1 = slot;
        sd.t_valid = true;
        sd.t_kind = PX_RETRY;
        sd.t_draw = true;
        sd.t_ctr = ctr;
        sd.t_pay0 = slot;
      }
      ctr += 1u;
    } else if (kind == PX_PREPARE) {
      // Acceptor: promise a higher ballot, reporting what it accepted.
      const int32_t b = pay.w0;
      if (b > promised0) {
        store_if<slot_t>(v.promised + at, promised0, narrow<slot_t>(b));
        sd.msg_mask = 1u << clampi(pmod(b - 1, N), 0, N - 1);
        sd.msg_kind = PX_PROMISE;
        sd.w0 = b;
        sd.w1 = slot;
        sd.w2 = acc_bal0;
        sd.w3 = acc_val0;
      }
    } else if (kind == PX_PROMISE) {
      // Proposer: collect promises; on quorum ACCEPT the highest-ballot
      // reported value, or its own.
      const int32_t b = pay.w0;
      const bool live = b == prop_bal0 && chosen0 == 0;
      const int voter = clampi(pay.w4, 0, N - 1);
      const int32_t pm = v.promises[at];
      const int32_t pm2 = (int32_t)((uint32_t)pm | (live ? 1u << voter : 0u));
      const int32_t sb = v.seen_bal[at], sv = v.seen_val[at];
      const bool better = live && pay.w2 > sb;
      const int32_t sb2 = better ? pay.w2 : sb;
      const int32_t sv2 = better ? pay.w3 : sv;
      const bool cross = live && __popc((uint32_t)pm2) >= q &&
                         __popc((uint32_t)pm) < q;
      const int32_t val = sb2 > 0 ? sv2 : prop_val0;
      const bool sok = cross && b >= promised0;
      if (live) {
        if (pm2 != pm) v.promises[at] = pm2;
        store_if<slot_t>(v.seen_bal + at, sb, narrow<slot_t>(sb2));
        store_if<slot_t>(v.seen_val + at, sv, narrow<slot_t>(sv2));
      }
      if (cross) {
        store_if<slot_t>(v.prop_val + at, prop_val0, narrow<slot_t>(val));
        const int32_t am1 = sok ? (int32_t)(1u << me) : 0;
        if (v.accepts[at] != am1) v.accepts[at] = am1;
        sd.msg_mask = others;
        sd.msg_kind = PX_ACCEPT;
        sd.w0 = b;
        sd.w1 = slot;
        sd.w2 = val;
      }
      if (sok) {
        store_if<slot_t>(v.promised + at, promised0, narrow<slot_t>(b));
        store_if<slot_t>(v.acc_bal + at, acc_bal0, narrow<slot_t>(b));
        store_if<slot_t>(v.acc_val + at, acc_val0, narrow<slot_t>(val));
      }
    } else if (kind == PX_ACCEPT) {
      // Acceptor: accept a value at or above the promised ballot.
      const int32_t b = pay.w0;
      if (b >= promised0) {
        store_if<slot_t>(v.promised + at, promised0, narrow<slot_t>(b));
        store_if<slot_t>(v.acc_bal + at, acc_bal0, narrow<slot_t>(b));
        store_if<slot_t>(v.acc_val + at, acc_val0, narrow<slot_t>(pay.w2));
        sd.msg_mask = 1u << clampi(pmod(b - 1, N), 0, N - 1);
        sd.msg_kind = PX_ACCEPTED;
        sd.w0 = b;
        sd.w1 = slot;
        sd.w2 = me;
        sd.w3 = pay.w2;
      }
    } else if (kind == PX_ACCEPTED) {
      // Proposer: on accepted-quorum the value is chosen.
      const int32_t b = pay.w0;
      const bool live = b == prop_bal0 && chosen0 == 0;
      const int voter = clampi(pay.w2, 0, N - 1);
      const int32_t am = v.accepts[at];
      const int32_t am2 = (int32_t)((uint32_t)am | (live ? 1u << voter : 0u));
      const bool cross = live && __popc((uint32_t)am2) >= q &&
                         __popc((uint32_t)am) < q;
      if (live && am2 != am) v.accepts[at] = am2;
      if (cross) {
        store_if<slot_t>(v.chosen + at, chosen0, narrow<slot_t>(pay.w3));
        count(v.chosen_count, 0, 1);
        sd.msg_mask = others;
        sd.msg_kind = PX_CHOSEN;
        sd.w0 = slot;
        sd.w1 = pay.w3;
      }
    } else {  // PX_CHOSEN
      // Learner: adopt the chosen value; a conflicting choice is the bug.
      hbug = chosen0 > 0 && chosen0 != pay.w1;
      if (chosen0 == 0)
        store_if<slot_t>(v.chosen + at, 0, narrow<slot_t>(pay.w1));
    }
  }

  template <int N>
  static __device__ __forceinline__ bool invariant(const PaxosView<N, Pf>& v) {
    return px_invariant<N>(v);
  }

  // Words w0..w3, and PROMISE's fifth, the voter (the handling node).
  template <int N>
  static __device__ __forceinline__ Payload message(const Params&,
                                                    const PaxosView<N, Pf>&,
                                                    const Sends& sd, int) {
    return Payload{sd.w0, sd.w1, sd.w2, sd.w3,
                   sd.msg_kind == PX_PROMISE ? sd.me : 0, 0, 0, 0};
  }

  // A Retry timer's delay: the step's draw in [retry_min, retry_max).
  static __device__ __forceinline__ int32_t draw_delay(const Params& p,
                                                       uint32_t x) {
    return u32_to_range(x, p.f1, p.f2);
  }

  // No tiles of its own; S >= 1; the voter word needs P >= 5.
  static bool params_ok(const Params& p) {
    return p.N >= 1 && p.f0 >= 1 && p.P >= 5 && p.commit_stride == 0 &&
           p.log_stride == 0 && p.commit_unit == 0 && p.log_unit == 0;
  }
};

using Paxos = PaxosP<PackedProfile>;
using PaxosWide = PaxosP<WideProfile>;

}  // namespace
