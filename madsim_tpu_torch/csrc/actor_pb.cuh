// The primary-backup policy of the engine's CUDA step kernel
// (step_kernel.cuh): madsim_tpu/actorc/families/pb.py's spec as
// madsim_tpu/actorc/compile.py lowers it (CompiledActor.handle, on_restart,
// invariant), written by hand. Its plain version is the port's compiled
// actor (madsim_tpu_torch/actorc/compile.py) on step_plain.
//
// The rules of the lowering kept here, bit for bit:
// - every value a transition writes is computed from the state before the
//   step: the handler reads its lanes first and writes after;
// - one draw per step: REPLICATE and WATCHDOG consume the step's u32
//   (counter ctr; the cursor then advances by one), which only ever times
//   a watchdog timer, so the draw is taken lazily with the sends' draws
//   (Sends::t_draw); the restart hook's draw advances the cursor too;
// - the node lanes (view, log_len, commit, wd_epoch), log_cmd,
//   committed_cmd and committed_max are int16 and saturate on write; acks
//   is an int32 bitmask lane, declared volatile: a restart clears the
//   node's row before the hook runs;
// - one message kind and word set per step for every peer it goes to, and
//   one timer (row N): the last true arm sets its kind, delay and words.
// The primary of view v is v % n (floor modulo). The state stays in device
// memory: the handling node's scalars, a runtime-indexed log column read
// and written by address, and what the invariant reads, which is
// committed_max alone until an entry has committed.
#pragma once

#include "step_common.cuh"

namespace {

constexpr int PB_WRITE = 0, PB_REPLICATE = 1, PB_ACK = 2, PB_COMMIT = 3,
              PB_HEARTBEAT = 4, PB_WATCHDOG = 5, PB_NUM_KINDS = 6;

// The spec's lanes in leaf order (sorted names, as JAX flattens a dict),
// at their packed dtypes (lane_dtype: hi <= 32767 -> int16; bitmasks and
// counters int32).
template <class Pf>
struct PbLanes {
  using Profile = Pf;
  int32_t* acks;           // (W, N, L)
  typename Pf::slot_t* commit;         // (W, N)
  typename Pf::slot_t* committed_cmd;  // (W, L)
  typename Pf::slot_t* committed_max;  // (W,)
  typename Pf::slot_t* log_cmd;        // (W, N, L)
  typename Pf::slot_t* log_len;        // (W, N)
  typename Pf::slot_t* view;           // (W, N)
  int32_t* views_changed;  // (W,)
  typename Pf::slot_t* wd_epoch;       // (W, N)
  int32_t* writes_done;    // (W,)
};

// Params::f0..f7 (step_kernel.py kernel_params): L = log_cap,
// heartbeat_us, watchdog_min_us, watchdog_max_us, then n_writes,
// write_start_us, write_interval_us (init only), buggy_commit_early.
__device__ __forceinline__ int pb_L(const Params& p) { return p.f0; }
__device__ __forceinline__ int pb_heartbeat_us(const Params& p) {
  return p.f1;
}
__device__ __forceinline__ int pb_buggy_commit_early(const Params& p) {
  return p.f7;
}

// One world's lanes in device memory.
template <int N, class Pf>
struct PbView {
  int L;
  int32_t* acks;
  typename Pf::slot_t* commit;
  typename Pf::slot_t* committed_cmd;
  typename Pf::slot_t* committed_max;
  typename Pf::slot_t* log_cmd;
  typename Pf::slot_t* log_len;
  typename Pf::slot_t* view;
  int32_t* views_changed;
  typename Pf::slot_t* wd_epoch;
  int32_t* writes_done;

  __device__ __forceinline__ PbView(const PbLanes<Pf>& a, size_t w, int l)
      : L(l),
        acks(a.acks + w * N * l),
        commit(a.commit + w * N),
        committed_cmd(a.committed_cmd + w * l),
        committed_max(a.committed_max + w),
        log_cmd(a.log_cmd + w * N * l),
        log_len(a.log_len + w * N),
        view(a.view + w * N),
        views_changed(a.views_changed + w),
        wd_epoch(a.wd_epoch + w * N),
        writes_done(a.writes_done + w) {}
};

// Durability: the current primary's log holds every entry ever reported
// committed, verbatim. Nothing to compare until committed_max > 0.
template <int N, class Pf>
__device__ __forceinline__ bool pb_invariant(const PbView<N, Pf>& v) {
  const int32_t cm = v.committed_max[0];
  if (cm <= 0) return false;
  int32_t vmax = v.view[0];
#pragma unroll
  for (int i = 1; i < N; i++) vmax = max(vmax, (int32_t)v.view[i]);
  const int primary = pmod(vmax, N);
  const int32_t plen = v.log_len[primary];
  const typename Pf::slot_t* plog = v.log_cmd + primary * v.L;
  const int lim = min(cm, (int32_t)v.L);
  for (int k = 0; k < lim; k++)
    if (k >= plen || plog[k] != v.committed_cmd[k]) return true;
  return false;
}

// The handling node's scalar lanes, read with the popped payload.
struct PbRow {
  int32_t view, log_len, commit, wd_epoch;
};

template <class Pf>
struct PbP {
  using Lanes = PbLanes<Pf>;
  using slot_t = typename Pf::slot_t;
  using code_t = typename Pf::code_t;
  template <int N>
  using View = PbView<N, Pf>;
  using Row = PbRow;
  static constexpr int FAMILY = FAMILY_PB;
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
  static __device__ __forceinline__ PbView<N, Pf> view(const State<Lanes>& s,
                                                   const Params& p, size_t w,
                                                   char*, int) {
    return PbView<N, Pf>(s.a, w, pb_L(p));
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
    return pb_invariant(PbView<N, Pf>(s.a, w, pb_L(p)));
  }

  template <int N>
  static __device__ __forceinline__ PbRow load_row(const PbView<N, Pf>& v,
                                                   int me) {
    return PbRow{v.view[me], v.log_len[me], v.commit[me], v.wd_epoch[me]};
  }

  // on_restart: the volatile acks row resets, then the hook bumps the
  // watchdog epoch and arms a watchdog with a fresh draw (the restart
  // context's draw advances the cursor unconditionally).
  template <int N>
  static __device__ __forceinline__ void on_restart(const Params&,
                                                    const PbView<N, Pf>& v,
                                                    int node, uint32_t,
                                                    uint32_t, uint32_t& ctr,
                                                    Sends& sd) {
    const int me = clampi(node, 0, N - 1);
    int32_t* acks_me = v.acks + me * v.L;
    for (int k = 0; k < v.L; k++)
      if (acks_me[k] != 0) acks_me[k] = 0;
    const int32_t epoch_me = v.wd_epoch[me];
    const int32_t epoch2 = epoch_me + 1;
    store_if<slot_t>(v.wd_epoch + me, epoch_me, narrow<slot_t>(epoch2));
    sd.me = me;
    sd.t_valid = true;
    sd.t_kind = PB_WATCHDOG;
    sd.t_dst = me;
    sd.t_draw = true;
    sd.t_ctr = ctr;
    sd.t_pay0 = v.view[me];
    sd.t_pay1 = epoch2;
    ctr += 1u;
  }

  // The merged handler: every kind's transition, gated by the kind.
  template <int N>
  static __device__ __forceinline__ void handle(
      const Params& p, const PbView<N, Pf>& v, int ev_kind, int ev_dst,
      const Payload pay, const PbRow row, int32_t, uint32_t, uint32_t,
      uint32_t& ctr, Sends& sd, bool& hbug) {
    const int L = v.L;
    const int kind = clampi(ev_kind, 0, PB_NUM_KINDS - 1);
    const int me = clampi(ev_dst, 0, N - 1);
    const uint32_t others = ((1u << N) - 1u) & ~(1u << me);
    const int32_t view_me = row.view, llen = row.log_len,
                  commit_me = row.commit, epoch_me = row.wd_epoch;
    const bool is_primary = me == pmod(view_me, N);
    hbug = false;
    sd.me = me;
    sd.t_dst = me;

    if (kind == PB_WRITE) {
      // Client write: the primary appends and replicates.
      const bool accept = is_primary && llen < L;
      if (accept) {
        const int pos_w = clampi(llen, 0, L - 1);
        const int32_t llen_w = llen + 1;
        const int32_t cmd = pay.w0;
        store_if<slot_t>(v.log_len + me, llen, narrow<slot_t>(llen_w));
        v.log_cmd[me * L + pos_w] = narrow<slot_t>(cmd);
        v.acks[me * L + pos_w] = (int32_t)(1u << me);
        count(v.writes_done, 0, 1);
        sd.msg_mask = others;
        sd.msg_kind = PB_REPLICATE;
        sd.w0 = view_me;
        sd.w1 = llen_w;
        sd.w2 = cmd;
      }
    } else if (kind == PB_REPLICATE) {
      // Backup: append in order, adopt the view, re-arm the watchdog.
      const int32_t v_rep = pay.w0, idx_rep = pay.w1, cmd_rep = pay.w2;
      const bool current = v_rep >= view_me;
      const int32_t view_rep = max(view_me, v_rep);
      const bool in_order = current && idx_rep == llen + 1 && idx_rep <= L;
      const int32_t epoch2 = epoch_me + (current ? 1 : 0);
      store_if<slot_t>(v.view + me, view_me, narrow<slot_t>(view_rep));
      if (in_order) {
        const int pos_r = clampi(idx_rep - 1, 0, L - 1);
        v.log_cmd[me * L + pos_r] = narrow<slot_t>(cmd_rep);
        store_if<slot_t>(v.log_len + me, llen, narrow<slot_t>(idx_rep));
        sd.msg_mask = 1u << clampi(pmod(view_rep, N), 0, N - 1);
        sd.msg_kind = PB_ACK;
        sd.w0 = view_rep;
        sd.w1 = idx_rep;
        sd.w2 = me;
      }
      store_if<slot_t>(v.wd_epoch + me, epoch_me, narrow<slot_t>(epoch2));
      if (current) {
        sd.t_valid = true;
        sd.t_kind = PB_WATCHDOG;
        sd.t_draw = true;
        sd.t_ctr = ctr;
        sd.t_pay0 = view_rep;
        sd.t_pay1 = epoch2;
      }
      ctr += 1u;
    } else if (kind == PB_ACK) {
      // Primary: count acks; commit on quorum (every replica, or under
      // the commit-early bug any two).
      const int32_t idx = pay.w1;
      const bool live = pay.w0 == view_me && is_primary && idx >= 1 &&
                        idx <= L;
      const int pos_a = clampi(idx - 1, 0, L - 1);
      const int backup = clampi(pay.w2, 0, N - 1);
      const int32_t acks0 = v.acks[me * L + pos_a];
      const int32_t acks2 =
          (int32_t)((uint32_t)acks0 | (live ? 1u << backup : 0u));
      const bool quorum = pb_buggy_commit_early(p)
                              ? __popc((uint32_t)acks2) >= 2
                              : acks2 == (int32_t)((1u << N) - 1u);
      const bool committed = live && quorum && idx > commit_me;
      const int32_t commit_a = committed ? idx : commit_me;
      const int32_t cm0 = v.committed_max[0];
      if (acks2 != acks0) v.acks[me * L + pos_a] = acks2;
      store_if<slot_t>(v.commit + me, commit_me, narrow<slot_t>(commit_a));
      if (committed) {
        // committed_cmd takes the pre-step log row over [commit_me, idx).
        const int lo = max(commit_me, 0), hi = min(idx, (int32_t)L);
        for (int k = lo; k < hi; k++)
          v.committed_cmd[k] = v.log_cmd[me * L + k];
        sd.msg_mask = others;
        sd.msg_kind = PB_COMMIT;
        sd.w0 = view_me;
        sd.w1 = commit_a;
      }
      store_if<slot_t>(v.committed_max, cm0,
                       narrow<slot_t>(max(cm0, committed ? idx : 0)));
    } else if (kind == PB_COMMIT) {
      // Backup: adopt the commit index, capped at its log length.
      const bool cm_current = pay.w0 >= view_me;
      const int32_t commit2 =
          cm_current ? max(commit_me, min(pay.w1, llen)) : commit_me;
      store_if<slot_t>(v.commit + me, commit_me, narrow<slot_t>(commit2));
    } else if (kind == PB_HEARTBEAT) {
      // The primary's liveness beacon: an idx-0 Replicate to every backup.
      const bool live = pay.w0 == view_me && is_primary;
      if (live) {
        sd.msg_mask = others;
        sd.msg_kind = PB_REPLICATE;
        sd.w0 = view_me;
        sd.t_valid = true;
        sd.t_kind = PB_HEARTBEAT;
        sd.t_delay = pb_heartbeat_us(p);
        sd.t_pay0 = view_me;
      }
    } else {  // PB_WATCHDOG
      // Primary-silence detector: a backup whose epoch is still current
      // starts the next view that makes it primary.
      const bool epoch_ok = pay.w1 == epoch_me;
      const int primary = pmod(view_me, N);
      const bool fire = epoch_ok && !(pay.w0 < view_me) && me != primary;
      const int32_t cand = view_me + pmod(me - primary, N);
      const int32_t view_wd = fire ? max(cand, view_me + 1) : view_me;
      const bool became_primary = fire && me == pmod(view_wd, N);
      const int32_t epoch2 = epoch_me + (fire ? 1 : 0);
      store_if<slot_t>(v.view + me, view_me, narrow<slot_t>(view_wd));
      store_if<slot_t>(v.wd_epoch + me, epoch_me, narrow<slot_t>(epoch2));
      count(v.views_changed, 0, fire ? 1 : 0);
      if (became_primary) {
        sd.msg_mask = others;
        sd.msg_kind = PB_REPLICATE;
        sd.w0 = view_wd;
        sd.t_valid = true;
        sd.t_kind = PB_HEARTBEAT;
        sd.t_delay = pb_heartbeat_us(p);
        sd.t_pay0 = view_wd;
        sd.t_pay1 = epoch2;
      } else if (epoch_ok) {
        sd.t_valid = true;
        sd.t_kind = PB_WATCHDOG;
        sd.t_draw = true;
        sd.t_ctr = ctr;
        sd.t_pay0 = view_wd;
        sd.t_pay1 = epoch2;
      }
      ctr += 1u;
    }
  }

  template <int N>
  static __device__ __forceinline__ bool invariant(const PbView<N, Pf>& v) {
    return pb_invariant<N>(v);
  }

  template <int N>
  static __device__ __forceinline__ Payload message(const Params&,
                                                    const PbView<N, Pf>&,
                                                    const Sends& sd, int) {
    return plain_message(sd);
  }

  // A watchdog's delay: the step's draw in [watchdog_min, watchdog_max).
  static __device__ __forceinline__ int32_t draw_delay(const Params& p,
                                                       uint32_t x) {
    return u32_to_range(x, p.f2, p.f3);
  }

  // No tiles of its own; L >= 1.
  static bool params_ok(const Params& p) {
    return p.N >= 1 && p.f0 >= 1 && p.commit_stride == 0 &&
           p.log_stride == 0 && p.commit_unit == 0 && p.log_unit == 0;
  }
};

using Pb = PbP<PackedProfile>;
using PbWide = PbP<WideProfile>;

}  // namespace
