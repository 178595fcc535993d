// The Raft policy of the engine's CUDA step kernel (step_kernel.cuh): the
// hand-written port of madsim_tpu/engine/raft_actor.py's RaftActor --
// its lanes, the merged handler of every event kind, the restart hook, the
// log-matching invariant -- and its shared-memory tiles (the commit row and
// the two log lanes, which the invariant reads whole every step). Its plain
// version is madsim_tpu_torch/engine/raft_actor.py on step_plain.
#pragma once

#include "step_common.cuh"

namespace {

// Raft event kinds and roles, and the won_terms words per node.
constexpr int K_ELECTION = 0, K_HEARTBEAT = 1, K_REQVOTE = 2,
              K_VOTEREPLY = 3, K_APPEND = 4, K_APPENDREPLY = 5,
              K_PROPOSE = 6, NUM_KINDS = 7;
constexpr int FOLLOWER = 0, CANDIDATE = 1, LEADER = 2;
constexpr int WON = 4;
constexpr int MAX_L = 64;

// RaftState's leaves, in their order, at the profile's types (slot lanes:
// terms, indices, epochs; node: voted_for; code: role; payload: log_cmd).
template <class Pf>
struct RaftLanes {
  using Profile = Pf;
  typename Pf::slot_t* term;
  typename Pf::node_t* voted_for;
  typename Pf::code_t* role;
  int32_t* votes;
  typename Pf::slot_t* commit;
  typename Pf::slot_t* log_len;
  typename Pf::slot_t* log_term;
  typename Pf::pay_t* log_cmd;
  typename Pf::slot_t* next_idx;
  typename Pf::slot_t* match_idx;
  typename Pf::slot_t* elect_epoch;
  int32_t* first_leader_time;
  int32_t* elections_won;
  int32_t* won_terms;
};

// Params::f0..f5 (step_kernel.py kernel_params).
__device__ __host__ __forceinline__ int raft_L(const Params& p) {
  return p.f0;
}
__device__ __forceinline__ int raft_elect_min_us(const Params& p) {
  return p.f2;
}
__device__ __forceinline__ int raft_elect_max_us(const Params& p) {
  return p.f3;
}
__device__ __forceinline__ int raft_heartbeat_us(const Params& p) {
  return p.f4;
}
__device__ __forceinline__ int raft_buggy_double_vote(const Params& p) {
  return p.f5;
}

// ---------------------------------------------------------------------------
// Per-world views of the state rows. The node count N is a template
// parameter throughout: every per-node loop has a constant trip count.
// ---------------------------------------------------------------------------
template <int N, class Pf>
struct World {
  using slot_t = typename Pf::slot_t;
  using pay_t = typename Pf::pay_t;
  int L;
  slot_t* term;
  typename Pf::node_t* voted_for;
  typename Pf::code_t* role;
  int32_t* votes;
  slot_t* log_len;
  slot_t* elect_epoch;
  slot_t* next_idx;    // (N, N)
  slot_t* match_idx;   // (N, N)
  int32_t* won_terms;  // (N, WON)
  int32_t* first_leader_time;
  int32_t* elections_won;
  slot_t* commit;      // device memory, (N,)
  slot_t* log_term;    // device memory, (N, L)
  pay_t* log_cmd;
  slot_t* commit_s;    // this world's rows of the shared tiles
  slot_t* log_term_s;
  pay_t* log_cmd_s;

  __device__ __forceinline__ World(const RaftLanes<Pf>& s, size_t w, int l,
                                   slot_t* cs, slot_t* lts, pay_t* lcs)
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

  __device__ __forceinline__ void set_commit(int i, slot_t x) const {
    if (commit_s[i] != x) {
      commit_s[i] = x;
      commit[i] = x;
    }
  }
  __device__ __forceinline__ void set_log(int i, int k, slot_t t,
                                          pay_t c) const {
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

// Raft invariant: log matching on the committed prefix of every node pair,
// over the shared tiles.
template <int N, class Pf>
__device__ __forceinline__ bool raft_invariant(const World<N, Pf>& v) {
  const int L = v.L;
#pragma unroll
  for (int i = 0; i < N; i++) {
#pragma unroll
    for (int j = i + 1; j < N; j++) {
      int ci = v.commit_s[i], cj = v.commit_s[j];
      int lim = ci < cj ? ci : cj;
      if (lim > L) lim = L;
      const typename Pf::slot_t *ti = v.log_term_s + i * L,
                                *tj = v.log_term_s + j * L;
      const typename Pf::pay_t *mi = v.log_cmd_s + i * L,
                               *mj = v.log_cmd_s + j * L;
      for (int k = 0; k < lim; k++)
        if (ti[k] != tj[k] || mi[k] != mj[k]) return true;
    }
  }
  return false;
}

// Node me's Raft row, read together with the popped payload.
struct RaftRow {
  int32_t term, voted_for, role, votes, log_len, elect_epoch;
  Packed16 next_idx, match_idx;
};

// The next and match rows hold indices in 1..L+1 in either profile, so they
// travel as packed int16s.
template <int N, class Pf>
__device__ __forceinline__ RaftRow raft_load_row(const World<N, Pf>& v,
                                                 int me) {
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

// RaftActor.on_restart: volatile state resets, a fresh election timer.
template <int N, class Pf>
__device__ __forceinline__ void raft_on_restart(const World<N, Pf>& v,
                                                int node, uint32_t& ctr,
                                                Sends& sd) {
  using slot_t = typename Pf::slot_t;
  const int me = clampi(node, 0, N - 1);
  const int32_t epoch_me = v.elect_epoch[me];
  const int32_t epoch2 = epoch_me + 1;
  store_if<typename Pf::code_t>(v.role + me, v.role[me], FOLLOWER);
  store_if<int32_t>(v.votes + me, v.votes[me], 0);
  v.set_commit(me, 0);
#pragma unroll
  for (int j = 0; j < N; j++) {
    store_if<slot_t>(v.next_idx + me * N + j, v.next_idx[me * N + j], 1);
    store_if<slot_t>(v.match_idx + me * N + j, v.match_idx[me * N + j], 0);
  }
  store_if(v.elect_epoch + me, epoch_me, narrow<slot_t>(epoch2));
  sd.t_valid = true;
  sd.t_kind = K_ELECTION;
  sd.t_dst = me;
  sd.t_draw = true;
  sd.t_ctr = ctr;
  sd.t_pay0 = epoch2;
  ctr += 1u;
}

// A node's log term at 1-based index idx (0 before the log).
template <typename T>
__device__ __forceinline__ int32_t row_term_at(const T* row, int L,
                                               int32_t idx) {
  return idx <= 0 ? 0 : (int32_t)row[clampi(idx - 1, 0, L - 1)];
}

// RaftActor.handle: the merged handler of every event kind. Reads the
// popped payload from registers, writes row `me` in place, and leaves the
// sends in `sd`.
template <int N, class Pf>
__device__ __forceinline__ void raft_handle(const Params& p,
                                            const World<N, Pf>& v,
                                            int ev_kind, int ev_dst,
                                            const Payload pay,
                                            const RaftRow row, int32_t now,
                                            uint32_t& ctr, Sends& sd,
                                            bool& hist_bug) {
  using slot_t = typename Pf::slot_t;
  using pay_t = typename Pf::pay_t;
  using node_t = typename Pf::node_t;
  using code_t = typename Pf::code_t;
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
  const int32_t term_me = narrow<slot_t>(higher ? t : term_pre);
  const int32_t voted_me = narrow<node_t>(higher ? -1 : voted_pre);
  const int32_t role_me = narrow<code_t>(demote ? FOLLOWER : role_pre);
  const int32_t votes_me = row.votes;
  const int32_t commit_me = v.commit_s[me];
  const int32_t llen_me = row.log_len;
  const int32_t epoch_me = row.elect_epoch;
  const slot_t* lt_row = v.log_term_s + me * L;
  const pay_t* lc_row = v.log_cmd_s + me * L;
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
      raft_buggy_double_vote(p) || voted_me == -1 || voted_me == cand;
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
  slot_t* match_me = v.match_idx + me * N;
  slot_t* next_me = v.next_idx + me * N;
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
    store_if(match_me + i, m0, narrow<slot_t>(mr));
    store_if(next_me + i, n0, narrow<slot_t>(nr));
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
  sd.t_delay = raft_heartbeat_us(p);  // an election timer draws instead
  sd.t_pay0 = is_elec ? epoch_me
                      : ((is_rv || is_ap) ? epoch2
                                          : (is_hb ? pay.w0 : term_me));

  // -- final state of row `me`, each field written where it changes --
  store_if(v.term + me, term_pre, narrow<slot_t>(fire ? term2 : term_me));
  store_if(v.voted_for + me, voted_pre,
           narrow<node_t>(fire ? me : (grant ? cand : voted_me)));
  store_if(v.role + me, role_pre,
           narrow<code_t>(fire ? CANDIDATE : (win ? LEADER : role_me)));
  store_if<int32_t>(v.votes + me, votes_me,
                    fire ? (int32_t)(1u << me) : (is_vr ? votes2 : votes_me));
  if (win) {
    int32_t* wt = v.won_terms + me * WON + word;
    *wt = (int32_t)((uint32_t)*wt | bit);
  }
  store_if(v.elect_epoch + me, epoch_me,
           narrow<slot_t>((grant || (is_ap && !reject)) ? epoch2 : epoch_me));
  v.set_log(me, pos, narrow<slot_t>(lt_new), narrow<pay_t>(lc_new));
  store_if(v.log_len + me, llen_me, narrow<slot_t>(llen_me2));
  v.set_commit(me, narrow<slot_t>(commit_me2));
  if (win) {
    if (now < *v.first_leader_time) *v.first_leader_time = now;
    *v.elections_won += 1;
  }
}

// The policy the kernel skeleton calls.
template <class Pf>
struct RaftP {
  using Lanes = RaftLanes<Pf>;
  template <int N>
  using View = World<N, Pf>;
  using slot_t = typename Pf::slot_t;
  using pay_t = typename Pf::pay_t;
  // The commit and log tiles' element: int16 packed, int32 wide.
  static constexpr int E = (int)sizeof(slot_t);
  static_assert(sizeof(slot_t) == sizeof(pay_t), "log tile elements");
  using Row = RaftRow;
  static constexpr int FAMILY = FAMILY_RAFT;
  // Node counts up to 8; the outbox is a message per node and the timer.
  static constexpr int MAX_NODES = 8;
  __host__ __device__ static constexpr int m(int n) { return n + 1; }
  // Payload rows of at least 8 words.
  static constexpr bool SHORT_PAYLOAD = false;

  // The commit and log tiles: the block's range of each lane (first, step
  // over the block), or this world's rows (at its tile row).
  template <int N>
  static __device__ __forceinline__ void tiles_in(const State<Lanes>& s,
                                                  const Params& p, char* smem,
                                                  size_t row0, int n,
                                                  int first, int step,
                                                  int at) {
    const int L = raft_L(p);
    const int c_row = N * E, c_stride = p.commit_stride * E;
    const int l_row = N * L * E, l_stride = p.log_stride * E;
    tile_in_any(p.log_unit, smem + p.off_lt + at * l_stride, s.a.log_term,
                row0, n, l_row, l_stride, first, step);
    tile_in_any(p.log_unit, smem + p.off_lc + at * l_stride, s.a.log_cmd,
                row0, n, l_row, l_stride, first, step);
    tile_in_any(p.commit_unit, smem + p.off_commit + at * c_stride,
                s.a.commit, row0, n, c_row, c_stride, first, step);
  }

  // An active world's view: its rows of the tiles.
  template <int N>
  static __device__ __forceinline__ World<N, Pf> view(const State<Lanes>& s,
                                                      const Params& p,
                                                      size_t w, char* smem,
                                                      int tid) {
    return World<N, Pf>(
        s.a, w, raft_L(p),
        reinterpret_cast<slot_t*>(smem + p.off_commit +
                                  tid * p.commit_stride * E),
        reinterpret_cast<slot_t*>(smem + p.off_lt + tid * p.log_stride * E),
        reinterpret_cast<pay_t*>(smem + p.off_lc + tid * p.log_stride * E));
  }

  // A frozen world's hint, read with its active flag: nodes that have
  // committed. The invariant compares no entry unless two have; then it
  // reads their rows in device memory.
  template <int N>
  static __device__ __forceinline__ int frozen_hint(const State<Lanes>& s,
                                                    size_t w) {
    int n = 0;
#pragma unroll
    for (int i = 0; i < N; i++) n += s.a.commit[w * N + i] > 0;
    return n;
  }
  template <int N>
  static __device__ __forceinline__ bool frozen_bug(const State<Lanes>& s,
                                                    const Params& p, size_t w,
                                                    int hint) {
    const int L = raft_L(p);
    return hint >= 2 &&
           raft_invariant(World<N, Pf>(s.a, w, L, s.a.commit + w * N,
                                       s.a.log_term + w * N * L,
                                       s.a.log_cmd + w * N * L));
  }

  template <int N>
  static __device__ __forceinline__ RaftRow load_row(const World<N, Pf>& v,
                                                     int me) {
    return raft_load_row<N>(v, me);
  }

  template <int N>
  static __device__ __forceinline__ void on_restart(const Params&,
                                                    const World<N, Pf>& v,
                                                    int node, uint32_t,
                                                    uint32_t, uint32_t& ctr,
                                                    Sends& sd) {
    raft_on_restart<N>(v, node, ctr, sd);
  }

  template <int N>
  static __device__ __forceinline__ void handle(
      const Params& p, const World<N, Pf>& v, int ev_kind, int ev_dst,
      const Payload pay, const RaftRow row, int32_t now, uint32_t, uint32_t,
      uint32_t& ctr, Sends& sd, bool& hbug) {
    raft_handle<N>(p, v, ev_kind, ev_dst, pay, row, now, ctr, sd, hbug);
  }

  template <int N>
  static __device__ __forceinline__ bool invariant(const World<N, Pf>& v) {
    return raft_invariant<N>(v);
  }

  // Message i's payload: the append row for node i (bcast), else w0..w3.
  template <int N>
  static __device__ __forceinline__ Payload message(const Params& p,
                                                    const World<N, Pf>& v,
                                                    const Sends& sd, int i) {
    Payload e = plain_message(sd);
    if (sd.bcast) {
      const int L = raft_L(p);
      const int32_t nxt = (int32_t)((sd.next >> (8 * i)) & 0xFFu);
      const int32_t prev = nxt - 1;
      const bool have = nxt <= sd.llen;
      const slot_t* lt_row = v.log_term_s + sd.me * L;
      const pay_t* lc_row = v.log_cmd_s + sd.me * L;
      const int pe = clampi(nxt - 1, 0, L - 1);
      e = {sd.term, sd.me, prev, row_term_at(lt_row, L, prev),
           have ? 1 : 0, have ? (int32_t)lt_row[pe] : 0,
           have ? (int32_t)lc_row[pe] : 0, sd.commit};
    }
    return e;
  }

  // An election timer's delay.
  static __device__ __forceinline__ int32_t draw_delay(const Params& p,
                                                       uint32_t x) {
    return u32_to_range(x, raft_elect_min_us(p), raft_elect_max_us(p));
  }

  // The family's parameters and tiles, checked at launch.
  static bool params_ok(const Params& p) {
    const int L = p.f0;
    return p.N >= 1 && L >= 1 && L <= MAX_L && p.f1 == WON &&
           p.commit_stride >= p.N && p.log_stride >= p.N * L &&
           (p.commit_unit == E || p.commit_unit == 4) &&
           (p.log_unit == E || p.log_unit == 4) &&
           (p.N * E) % p.commit_unit == 0 && (p.N * L * E) % p.log_unit == 0 &&
           (p.commit_stride * E) % p.commit_unit == 0 &&
           (p.log_stride * E) % p.log_unit == 0;
  }
};
using Raft = RaftP<PackedProfile>;
using RaftWide = RaftP<WideProfile>;

}  // namespace
