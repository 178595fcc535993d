// The two-phase-commit policy of the engine's CUDA step kernel
// (step_kernel.cuh): madsim_tpu/actorc/families/tpc.py's spec as
// madsim_tpu/actorc/compile.py lowers it (CompiledActor.handle, on_restart,
// invariant), written by hand. Its plain version is the port's compiled
// actor (madsim_tpu_torch/actorc/compile.py) on step_plain.
//
// The rules of the lowering kept here, bit for bit:
// - every value a transition writes is computed from the state before the
//   step: the handler reads its lanes first and writes after;
// - one draw per step: PREPARE consumes the step's u32 (counter ctr, the
//   cursor then advances by one) whether or not its vote uses it; no other
//   kind draws;
// - node-table and vector writes saturate into int8 (decision, voted,
//   decided); counters add in int32;
// - one message kind and word set per step for every peer it goes to, and
//   one timer (row N), dst clipped.
// Node 0 coordinates. The state is small and read once a step, so it stays
// in device memory: the txn column of the handling node's decision and
// voted rows, decided[txn] and votes_yes[txn], read by address (a runtime
// index never indexes a local array), and the (N, T) decision table, which
// the invariant reads whole.
#pragma once

#include "step_common.cuh"

namespace {

constexpr int TPC_TXN = 0, TPC_PREPARE = 1, TPC_VOTE = 2, TPC_DECIDE = 3,
              TPC_TIMEOUT = 4, TPC_NUM_KINDS = 5;
constexpr int TPC_NONE = 0, TPC_COMMIT = 1, TPC_ABORT = 2;
constexpr int TPC_COORD = 0;

// The spec's lanes in leaf order (sorted names, as JAX flattens a dict),
// at their packed dtypes (lane_dtype: hi=2 -> int8; bitmasks and counters
// int32).
template <class Pf>
struct TpcLanes {
  using Profile = Pf;
  int32_t* aborts;     // (W,)
  int32_t* commits;    // (W,)
  typename Pf::code_t* decided;     // (W, T)
  typename Pf::code_t* decision;    // (W, N, T)
  int32_t* txns_seen;  // (W,)
  typename Pf::code_t* voted;       // (W, N, T)
  int32_t* votes_yes;  // (W, T)
};

// Params::f0..f5 (step_kernel.py kernel_params): T = n_txns, then
// txn_start_us, txn_interval_us (init only), vote_timeout_us, no_vote_num,
// buggy_presumed_commit.
__device__ __forceinline__ int tpc_T(const Params& p) { return p.f0; }
__device__ __forceinline__ int tpc_vote_timeout_us(const Params& p) {
  return p.f3;
}
__device__ __forceinline__ int tpc_no_vote_num(const Params& p) {
  return p.f4;
}
__device__ __forceinline__ int tpc_buggy_presumed_commit(const Params& p) {
  return p.f5;
}

// One world's lanes in device memory.
template <int N, class Pf>
struct TpcView {
  int T;
  typename Pf::code_t* decided;
  typename Pf::code_t* decision;
  typename Pf::code_t* voted;
  int32_t* votes_yes;
  int32_t* txns_seen;
  int32_t* commits;
  int32_t* aborts;

  __device__ __forceinline__ TpcView(const TpcLanes<Pf>& a, size_t w, int t)
      : T(t),
        decided(a.decided + w * t),
        decision(a.decision + w * N * t),
        voted(a.voted + w * N * t),
        votes_yes(a.votes_yes + w * t),
        txns_seen(a.txns_seen + w),
        commits(a.commits + w),
        aborts(a.aborts + w) {}
};

// Atomicity: no txn column holds both a COMMIT and an ABORT.
template <int N, class Pf>
__device__ __forceinline__ bool tpc_invariant(const TpcView<N, Pf>& v) {
  for (int t = 0; t < v.T; t++) {
    bool committed = false, aborted = false;
#pragma unroll
    for (int i = 0; i < N; i++) {
      const int d = v.decision[i * v.T + t];
      committed = committed || d == TPC_COMMIT;
      aborted = aborted || d == TPC_ABORT;
    }
    if (committed && aborted) return true;
  }
  return false;
}

struct TpcRow {};

template <class Pf>
struct TpcP {
  using Lanes = TpcLanes<Pf>;
  using slot_t = typename Pf::slot_t;
  using code_t = typename Pf::code_t;
  template <int N>
  using View = TpcView<N, Pf>;
  using Row = TpcRow;
  static constexpr int FAMILY = FAMILY_TPC;
  // Node counts up to 8; the outbox is a message per node and the timer.
  static constexpr int MAX_NODES = 8;
  __host__ __device__ static constexpr int m(int n) { return n + 1; }
  // Payload rows of at least 8 words.
  static constexpr bool SHORT_PAYLOAD = false;

  template <int N>
  static __device__ __forceinline__ void tiles_in(const State<Lanes>&,
                                                  const Params&, char*,
                                                  size_t, int, int, int,
                                                  int) {}

  template <int N>
  static __device__ __forceinline__ TpcView<N, Pf> view(const State<Lanes>& s,
                                                    const Params& p, size_t w,
                                                    char*, int) {
    return TpcView<N, Pf>(s.a, w, tpc_T(p));
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
    return tpc_invariant(TpcView<N, Pf>(s.a, w, tpc_T(p)));
  }

  template <int N>
  static __device__ __forceinline__ TpcRow load_row(const TpcView<N, Pf>&,
                                                    int) {
    return TpcRow{};
  }

  // on_restart: no volatile lane; the hook clears the coordinator's yes
  // bitmasks of the txns it has not decided. No sends, no draw.
  template <int N>
  static __device__ __forceinline__ void on_restart(const Params&,
                                                    const TpcView<N, Pf>& v,
                                                    int node, uint32_t,
                                                    uint32_t, uint32_t&,
                                                    Sends&) {
    if (clampi(node, 0, N - 1) != TPC_COORD) return;
    for (int t = 0; t < v.T; t++)
      if (v.decided[t] == TPC_NONE && v.votes_yes[t] != 0) v.votes_yes[t] = 0;
  }

  // The merged handler: every kind's transition, gated by the kind.
  template <int N>
  static __device__ __forceinline__ void handle(
      const Params& p, const TpcView<N, Pf>& v, int ev_kind, int ev_dst,
      const Payload pay, const TpcRow, int32_t, uint32_t k0, uint32_t k1,
      uint32_t& ctr, Sends& sd, bool& hbug) {
    const int T = v.T;
    const int kind = clampi(ev_kind, 0, TPC_NUM_KINDS - 1);
    const int me = clampi(ev_dst, 0, N - 1);
    // Every kind's word 0 is its txn.
    const int txn = clampi(pay.w0, 0, T - 1);
    const int at = me * T + txn;
    // The pre-step reads.
    const int32_t decided_t = v.decided[txn];
    const int32_t my_dec = v.decision[at];
    const int32_t my_vote = v.voted[at];
    const int32_t yes_t = v.votes_yes[txn];
    const uint32_t participants = ((1u << N) - 1u) & ~1u;  // arange != COORD
    const bool is_coord = me == TPC_COORD;
    const uint32_t ctr0 = ctr;
    hbug = false;
    sd.me = me;

    bool decide = false;
    int32_t val = 0;
    if (kind == TPC_TXN) {
      // Coordinator: start 2PC for a scheduled transaction.
      const bool start = is_coord && decided_t == TPC_NONE;
      count(v.txns_seen, 0, start ? 1 : 0);
      if (start) {
        sd.msg_mask = participants;
        sd.msg_kind = TPC_PREPARE;
        sd.w0 = txn;
        sd.t_valid = true;
        sd.t_kind = TPC_TIMEOUT;
        sd.t_dst = TPC_COORD;
        sd.t_delay = tpc_vote_timeout_us(p);
        sd.t_pay0 = txn;
      }
    } else if (kind == TPC_PREPARE) {
      // Participant: vote once; a no-voter aborts unilaterally. The kind
      // consumes the step's draw; its value is needed for a fresh vote.
      ctr += 1u;
      const bool fresh =
          !is_coord && my_vote == TPC_NONE && my_dec == TPC_NONE;
      if (fresh) {
        const uint32_t u = draw1(k0, k1, ctr0);
        const bool vote_no = (int32_t)(u % 256u) < tpc_no_vote_num(p);
        const int32_t vote_val = vote_no ? TPC_ABORT : TPC_COMMIT;
        v.voted[at] = (code_t)vote_val;
        if (vote_no) v.decision[at] = TPC_ABORT;
        sd.msg_mask = 1u << TPC_COORD;
        sd.msg_kind = TPC_VOTE;
        sd.w0 = txn;
        sd.w1 = vote_val == TPC_COMMIT ? 1 : 0;
        sd.w2 = me;
      }
    } else if (kind == TPC_VOTE) {
      // Coordinator: collect votes; all-yes => COMMIT, any-no => ABORT.
      const bool live = is_coord && decided_t == TPC_NONE;
      const int voter = clampi(pay.w2, 0, N - 1);
      const bool yes = pay.w1 == 1;
      const int32_t mask_all = (int32_t)((1u << N) - 2u);
      const int32_t yes2 =
          (int32_t)((uint32_t)yes_t | ((live && yes) ? 1u << voter : 0u));
      if (yes2 != yes_t) v.votes_yes[txn] = yes2;
      const bool all_yes = live && yes2 == mask_all;
      const bool any_no = live && !yes;
      decide = all_yes || any_no;
      val = all_yes ? TPC_COMMIT : TPC_ABORT;
    } else if (kind == TPC_DECIDE) {
      // Participant: apply the coordinator's decision unless it already
      // applied one.
      const bool apply_dec = !is_coord && my_dec == TPC_NONE;
      if (apply_dec) v.decision[at] = narrow<code_t>(pay.w1);
    } else {  // TPC_TIMEOUT
      // Coordinator: decide for the stragglers -- ABORT, or COMMIT under
      // the presumed-commit bug.
      decide = is_coord && decided_t == TPC_NONE;
      val = tpc_buggy_presumed_commit(p) ? TPC_COMMIT : TPC_ABORT;
    }
    if (decide) {
      // The shared decision tail: record, count, broadcast.
      v.decided[txn] = (code_t)val;
      v.decision[at] = (code_t)val;
      count(val == TPC_COMMIT ? v.commits : v.aborts, 0, 1);
      sd.msg_mask = participants;
      sd.msg_kind = TPC_DECIDE;
      sd.w0 = txn;
      sd.w1 = val;
    }
  }

  template <int N>
  static __device__ __forceinline__ bool invariant(const TpcView<N, Pf>& v) {
    return tpc_invariant<N>(v);
  }

  template <int N>
  static __device__ __forceinline__ Payload message(const Params&,
                                                    const TpcView<N, Pf>&,
                                                    const Sends& sd, int) {
    return plain_message(sd);
  }

  // No tpc timer draws its delay.
  static __device__ __forceinline__ int32_t draw_delay(const Params&,
                                                       uint32_t) {
    return 0;
  }

  // No tiles of its own; T >= 1.
  static bool params_ok(const Params& p) {
    return p.N >= 2 && p.f0 >= 1 && p.commit_stride == 0 &&
           p.log_stride == 0 && p.commit_unit == 0 && p.log_unit == 0;
  }
};

using Tpc = TpcP<PackedProfile>;
using TpcWide = TpcP<WideProfile>;

}  // namespace
