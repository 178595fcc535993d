// The engine step of madsim_tpu_torch as one CUDA kernel for sm_90a.
//
// Replaces madsim_tpu/engine/pallas_step.py::make_pallas_step, the JAX
// package's Pallas kernel, whose body is the vmapped per-world step
// DeviceEngine._build_step (madsim_tpu/engine/core.py) with the Raft actor
// traced in. Its plain version is DeviceEngine.step_plain in
// madsim_tpu_torch/engine/core.py; the two agree bit for bit on every
// state leaf, and the port's tests hold the plain version to the JAX one.
//
// Design: one thread per world. Each thread reads its world's rows in
// global memory, runs the whole step for that world -- pop, fault apply or
// the Raft handler, 2*M Threefry draws, insert, invariant, bookkeeping --
// and writes the state back in place (the Pallas kernel's
// input_output_aliases). Sizes are runtime ints under static maxima.
//
// Bound: memory. A step reads and writes each world's state once; see
// madsim_tpu_torch/engine/step_kernel.py for the numbers and for what this
// layout leaves on the table.
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
constexpr int MAX_M = MAX_N + 1;
constexpr int MAX_P = 16;
constexpr int MAX_L = 64;
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
};
constexpr int N_LEAVES = 38;

struct Params {
  int W, N, Q, P, L, won;
  int t_limit_us, stop_on_bug;
  int elect_min_us, elect_max_us, heartbeat_us, buggy_double_vote;
};
constexpr int N_PARAMS = 12;

struct Outbox {
  bool valid[MAX_M];
  bool is_timer[MAX_M];
  int32_t kind[MAX_M];
  int32_t dst[MAX_M];
  int32_t delay[MAX_M];
  int32_t pay[MAX_M][MAX_P];
};

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

__device__ __forceinline__ uint32_t draw(uint32_t k0, uint32_t k1,
                                         uint32_t ctr) {
  uint32_t x0, x1;
  threefry2x32(k0, k1, ctr, 0u, x0, x1);
  return x0;
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

__device__ __forceinline__ void empty_outbox(Outbox& ob, int M, int P) {
  for (int i = 0; i < M; i++) {
    ob.valid[i] = false;
    ob.is_timer[i] = false;
    ob.kind[i] = 0;
    ob.dst[i] = 0;
    ob.delay[i] = 0;
    for (int k = 0; k < P; k++) ob.pay[i][k] = 0;
  }
}

// ---------------------------------------------------------------------------
// Per-world views of the state rows.
// ---------------------------------------------------------------------------
struct World {
  int N, L, P;
  int16_t* term_;
  int8_t* voted_for_;
  int8_t* role_;
  int32_t* votes_;
  int16_t* commit_;
  int16_t* log_len_;
  int16_t* elect_epoch_;
  int16_t* log_term_;
  int16_t* log_cmd_;
  int16_t* next_idx_;
  int16_t* match_idx_;
  int32_t* won_terms_;
  int32_t* first_leader_time;
  int32_t* elections_won;

  __device__ __forceinline__ World(const State& s, size_t w, int n, int l,
                                   int p)
      : N(n), L(l), P(p),
        term_(s.term + w * n), voted_for_(s.voted_for + w * n),
        role_(s.role + w * n), votes_(s.votes + w * n),
        commit_(s.commit + w * n), log_len_(s.log_len + w * n),
        elect_epoch_(s.elect_epoch + w * n),
        log_term_(s.log_term + w * n * l), log_cmd_(s.log_cmd + w * n * l),
        next_idx_(s.next_idx + w * n * n), match_idx_(s.match_idx + w * n * n),
        won_terms_(s.won_terms + w * n * WON),
        first_leader_time(s.first_leader_time + w),
        elections_won(s.elections_won + w) {}
  __device__ __forceinline__ int16_t* term() const { return term_; }
  __device__ __forceinline__ int8_t* voted_for() const { return voted_for_; }
  __device__ __forceinline__ int8_t* role() const { return role_; }
  __device__ __forceinline__ int32_t* votes() const { return votes_; }
  __device__ __forceinline__ int16_t* commit() const { return commit_; }
  __device__ __forceinline__ int16_t* log_len() const { return log_len_; }
  __device__ __forceinline__ int16_t* elect_epoch() const {
    return elect_epoch_;
  }
  __device__ __forceinline__ int16_t* log_term(int i) const {
    return log_term_ + i * L;
  }
  __device__ __forceinline__ int16_t* log_cmd(int i) const {
    return log_cmd_ + i * L;
  }
  __device__ __forceinline__ int16_t* next_idx(int i) const {
    return next_idx_ + i * N;
  }
  __device__ __forceinline__ int16_t* match_idx(int i) const {
    return match_idx_ + i * N;
  }
  __device__ __forceinline__ int32_t* won_terms(int i) const {
    return won_terms_ + i * WON;
  }
};

// Raft invariant: log matching on the committed prefix of every node pair.
__device__ __forceinline__ bool raft_invariant(const World& v) {
  const int N = v.N, L = v.L;
  for (int i = 0; i < N; i++) {
    for (int j = i + 1; j < N; j++) {
      int ci = v.commit()[i], cj = v.commit()[j];
      int lim = ci < cj ? ci : cj;
      if (lim > L) lim = L;
      const int16_t *ti = v.log_term(i), *tj = v.log_term(j);
      const int16_t *mi = v.log_cmd(i), *mj = v.log_cmd(j);
      for (int k = 0; k < lim; k++)
        if (ti[k] != tj[k] || mi[k] != mj[k]) return true;
    }
  }
  return false;
}

// RaftActor.on_restart: volatile state resets, a fresh election timer.
__device__ __forceinline__ void raft_on_restart(const Params& p,
                                                const World& v, int node,
                                                uint32_t k0, uint32_t k1,
                                                uint32_t& ctr, Outbox& ob) {
  const int N = v.N;
  const int me = clampi(node, 0, N - 1);
  const int32_t epoch2 = (int32_t)v.elect_epoch()[me] + 1;
  v.role()[me] = FOLLOWER;
  v.votes()[me] = 0;
  v.commit()[me] = 0;
  for (int j = 0; j < N; j++) {
    v.next_idx(me)[j] = 1;
    v.match_idx(me)[j] = 0;
  }
  v.elect_epoch()[me] = sat16(epoch2);
  const int32_t delay =
      u32_to_range(draw(k0, k1, ctr), p.elect_min_us, p.elect_max_us);
  ctr += 1u;
  for (int i = 0; i < N; i++) ob.dst[i] = i;
  ob.valid[N] = true;
  ob.is_timer[N] = true;
  ob.kind[N] = K_ELECTION;
  ob.dst[N] = me;
  ob.delay[N] = delay;
  ob.pay[N][0] = epoch2;
}

// A node's log term at 1-based index idx (0 before the log).
__device__ __forceinline__ int32_t row_term_at(const int16_t* row, int L,
                                               int32_t idx) {
  return idx <= 0 ? 0 : (int32_t)row[clampi(idx - 1, 0, L - 1)];
}

// RaftActor.handle: the merged handler of every event kind.
__device__ __forceinline__ void raft_handle(const Params& p, const World& v,
                                            int ev_kind, int ev_dst,
                                            const int16_t* pay, int32_t now,
                                            uint32_t k0, uint32_t k1,
                                            uint32_t& ctr, Outbox& ob,
                                            bool& hist_bug) {
  const int N = v.N, L = v.L, P = v.P;
  const int kind = clampi(ev_kind, 0, NUM_KINDS - 1);
  const int me = clampi(ev_dst, 0, N - 1);
  const int32_t t = pay[0];
  const bool is_elec = kind == K_ELECTION, is_hb = kind == K_HEARTBEAT,
             is_rv = kind == K_REQVOTE, is_vr = kind == K_VOTEREPLY,
             is_ap = kind == K_APPEND, is_ar = kind == K_APPENDREPLY,
             is_pr = kind == K_PROPOSE;

  // -- shared step-down; the views below are of the stepped-down row --
  const bool sd = is_rv || is_vr || is_ap || is_ar;
  const int32_t term_pre = v.term()[me];
  const int32_t role_pre = v.role()[me];
  const bool higher = sd && t > term_pre;
  const bool demote =
      higher || (is_ap && t == term_pre && role_pre == CANDIDATE);
  const int32_t term_me = sat16(higher ? t : term_pre);
  const int32_t voted_me = sat8(higher ? -1 : (int32_t)v.voted_for()[me]);
  const int32_t role_me = sat8(demote ? FOLLOWER : role_pre);
  const int32_t votes_me = v.votes()[me];
  const int32_t commit_me = v.commit()[me];
  const int32_t llen_me = v.log_len()[me];
  const int32_t epoch_me = v.elect_epoch()[me];
  int16_t* lt_row = v.log_term(me);
  int16_t* lc_row = v.log_cmd(me);
  const int32_t my_last_term = row_term_at(lt_row, L, llen_me);
  const bool reject = t < term_me;

  // One election-delay draw serves every kind that draws; the cursor
  // advances only for those kinds.
  const int32_t delay =
      u32_to_range(draw(k0, k1, ctr), p.elect_min_us, p.elect_max_us);
  if (is_elec || is_rv || is_ap) ctr += 1u;

  // -- election fire --
  const bool fire = is_elec && pay[0] == epoch_me && role_me != LEADER;
  const int32_t term2 = term_me + 1;

  // -- reqvote grant --
  const int cand = clampi(pay[1], 0, N - 1);
  const bool up_to_date =
      pay[3] > my_last_term || (pay[3] == my_last_term && pay[2] >= llen_me);
  const bool can_vote =
      p.buggy_double_vote || voted_me == -1 || voted_me == cand;
  const bool grant = is_rv && !reject && up_to_date && can_vote;
  const int32_t epoch2 = epoch_me + 1;

  // -- votereply win + historical election safety --
  const int voter = clampi(pay[2], 0, N - 1);
  const bool counted =
      is_vr && pay[1] != 0 && role_me == CANDIDATE && t == term_me;
  const int32_t votes2 =
      counted ? (int32_t)((uint32_t)votes_me | (1u << voter)) : votes_me;
  const bool win = counted && __popc((uint32_t)votes2) > N / 2;
  const int bit_index = clampi(term_me, 0, 32 * WON - 1);
  const int word = bit_index / 32;
  const uint32_t bit = 1u << (bit_index % 32);
  bool other_won = false;
  for (int i = 0; i < N; i++)
    if (i != me && ((uint32_t)v.won_terms(i)[word] & bit)) other_won = true;
  hist_bug = win && other_won;

  // -- append --
  const int leader = clampi(pay[1], 0, N - 1);
  const int32_t prev_idx = pay[2], prev_term = pay[3];
  const int32_t n_ent = pay[4], e_term = pay[5], e_cmd = pay[6],
                l_commit = pay[7];
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
  const int follower = clampi(pay[3], 0, N - 1);
  const bool live_ar = is_ar && role_me == LEADER && t == term_me;
  const bool ok_ar = live_ar && pay[1] != 0;
  const bool fail_ar = live_ar && pay[1] == 0;
  const int32_t cur_match = v.match_idx(me)[follower];
  const int32_t cur_next = v.next_idx(me)[follower];
  const int32_t match2 = max(cur_match, (int32_t)pay[2]);

  // -- one combined log write (append XOR propose position) --
  const int pos = is_ap ? pos_ap : pos_pr;
  const int32_t lt_new = write ? e_term : (accept ? term_me : lt_row[pos]);
  const int32_t lc_new = write ? e_cmd : (accept ? pay[0] : lc_row[pos]);

  // -- per-row combines --
  int32_t match_row[MAX_N], next_row[MAX_N];
  for (int i = 0; i < N; i++) {
    const int32_t m0 = v.match_idx(me)[i], n0 = v.next_idx(me)[i];
    if (win)
      match_row[i] = i == me ? llen_me : 0;
    else if (is_ar && i == follower)
      match_row[i] = ok_ar ? match2 : cur_match;
    else if (is_pr && i == me && accept)
      match_row[i] = llen_pr;
    else
      match_row[i] = m0;
    if (win)
      next_row[i] = 1 + llen_me;
    else if (is_ar && i == follower)
      next_row[i] =
          ok_ar ? match2 + 1 : (fail_ar ? max(1, cur_next - 1) : cur_next);
    else
      next_row[i] = n0;
  }

  // -- appendreply commit advance (over the updated match row) --
  int32_t best = 0;
  for (int n = 1; n <= L; n++) {
    if (n > llen_me || lt_row[n - 1] != term_me) continue;
    int cnt = 0;
    for (int i = 0; i < N; i++) cnt += match_row[i] >= n;
    if (cnt > N / 2) best = n;
  }
  const int32_t commit_ar = live_ar ? max(commit_me, best) : commit_me;

  // -- the outbox, built before the state writes (it reads the pre-write
  // log row with the combined write applied) --
  const int32_t llen_me2 = is_ap ? new_len_ap : (is_pr ? llen_pr : llen_me);
  const int32_t term_me2 = fire ? term2 : term_me;
  const int32_t commit_me2 =
      is_ap ? commit_ap : (is_ar ? commit_ar : commit_me);
  const bool live_hb = is_hb && role_me == LEADER && term_me == pay[0];
  const bool use_am = live_hb || win || accept;
  const int32_t msg_kind =
      is_elec ? K_REQVOTE
              : (is_rv ? K_VOTEREPLY : (is_ap ? K_APPENDREPLY : K_APPEND));
  const int32_t w0 = is_elec ? term2 : term_me;
  const int32_t w1 = is_elec ? me : (is_rv ? (int32_t)grant : (int32_t)success);
  const int32_t w2 = is_elec ? llen_me : (is_rv ? me : match_ap);
  const int32_t w3 = is_elec ? my_last_term : (is_rv ? 0 : me);
  for (int i = 0; i < N; i++) {
    ob.is_timer[i] = false;
    ob.kind[i] = msg_kind;
    ob.dst[i] = i;
    ob.delay[i] = 0;
    for (int k = 0; k < P; k++) ob.pay[i][k] = 0;
    if (use_am) {
      const int32_t nxt = clampi(next_row[i], 1, L + 1);
      const int32_t prev = nxt - 1;
      const int pt = clampi(prev - 1, 0, L - 1);
      const int32_t prev_term_i =
          prev <= 0 ? 0 : (pt == pos ? lt_new : (int32_t)lt_row[pt]);
      const bool have = nxt <= llen_me2;
      const int pe = clampi(nxt - 1, 0, L - 1);
      const int32_t et = pe == pos ? lt_new : (int32_t)lt_row[pe];
      const int32_t ec = pe == pos ? lc_new : (int32_t)lc_row[pe];
      ob.valid[i] = i != me;
      ob.pay[i][0] = term_me2;
      ob.pay[i][1] = me;
      ob.pay[i][2] = prev;
      ob.pay[i][3] = prev_term_i;
      ob.pay[i][4] = have ? 1 : 0;
      ob.pay[i][5] = have ? et : 0;
      ob.pay[i][6] = have ? ec : 0;
      ob.pay[i][7] = commit_me2;
    } else {
      ob.valid[i] = fire ? i != me
                         : (is_rv ? i == cand : (is_ap ? i == leader : false));
      ob.pay[i][0] = w0;
      ob.pay[i][1] = w1;
      ob.pay[i][2] = w2;
      ob.pay[i][3] = w3;
    }
  }
  const bool hb_timer = is_hb || is_vr;
  ob.valid[N] = (is_elec && pay[0] == epoch_me) || live_hb || grant || win ||
                (is_ap && !reject);
  ob.is_timer[N] = true;
  ob.kind[N] = hb_timer ? K_HEARTBEAT : K_ELECTION;
  ob.dst[N] = me;
  ob.delay[N] = hb_timer ? p.heartbeat_us : delay;
  for (int k = 0; k < P; k++) ob.pay[N][k] = 0;
  ob.pay[N][0] = is_elec ? epoch_me
                         : ((is_rv || is_ap) ? epoch2
                                             : (is_hb ? pay[0] : term_me));

  // -- final state: one write per field of row `me` --
  v.term()[me] = sat16(fire ? term2 : term_me);
  v.voted_for()[me] = sat8(fire ? me : (grant ? cand : voted_me));
  v.role()[me] = sat8(fire ? CANDIDATE : (win ? LEADER : role_me));
  v.votes()[me] = fire ? (int32_t)(1u << me) : (is_vr ? votes2 : votes_me);
  if (win)
    v.won_terms(me)[word] = (int32_t)((uint32_t)v.won_terms(me)[word] | bit);
  v.elect_epoch()[me] =
      sat16((grant || (is_ap && !reject)) ? epoch2 : epoch_me);
  lt_row[pos] = sat16(lt_new);
  lc_row[pos] = sat16(lc_new);
  v.log_len()[me] = sat16(llen_me2);
  v.commit()[me] = sat16(commit_me2);
  for (int i = 0; i < N; i++) {
    v.match_idx(me)[i] = sat16(match_row[i]);
    v.next_idx(me)[i] = sat16(next_row[i]);
  }
  if (win) {
    if (now < *v.first_leader_time) *v.first_leader_time = now;
    *v.elections_won += 1;
  }
}

__global__ void step_kernel(State s, Params p) {
  const size_t w = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= (size_t)p.W) return;
  const int N = p.N, Q = p.Q, P = p.P, M = N + 1;
  const World v(s, w, N, p.L, P);
  int32_t* qt = s.q_time + w * Q;
  int32_t* qm = s.q_meta + w * Q;
  int16_t* qp = s.q_payload + w * Q * P;
  uint8_t* alive = s.alive + w * N;
  int8_t* gen = s.gen + w * N;
  uint8_t* paused = s.paused + w * N;
  uint8_t* clog_node = s.clog_node + w * N;
  uint8_t* clog_link = s.clog_link + w * N * N;

  if (!s.active[w]) {
    // A frozen world: the pop finds nothing, every write is gated off, and
    // the RNG cursor and step count are restored. Only the high-water mark
    // and the invariant's bug flag are evaluated, as in the plain step.
    if (s.qdepth[w] > s.qmax[w]) s.qmax[w] = s.qdepth[w];
    if (raft_invariant(v) && !s.bug[w]) {
      s.bug[w] = 1;
      s.bug_time[w] = s.now[w];
    }
    return;
  }

  // ---- pop: lowest slot holding the minimum time among eligible slots ----
  int32_t tmin = INF_TIME;
  int slot = 0;
  for (int q = 0; q < Q; q++) {
    const int32_t m = qm[q];
    const bool is_fault_q = (m & (FLAG_FAULT << 6)) != 0;
    const int d = min((m >> 16) & 0xFF, N - 1);
    const int32_t tq = (is_fault_q || !paused[d]) ? qt[q] : INF_TIME;
    if (tq < tmin) {
      tmin = tq;
      slot = q;
    }
  }
  const bool found = tmin < INF_TIME;
  const int32_t meta = qm[slot];
  const int ev_kind = meta & 0x3F, ev_flags = (meta >> 6) & 0x3,
            ev_src = (meta >> 8) & 0xFF, ev_dst = (meta >> 16) & 0xFF,
            ev_gen = (meta >> 24) & 0xFF;
  // The popped payload row is read in place (widened at each use): every
  // read happens before the insert below rewrites the queue. A local copy
  // of the row was mis-read inside the inlined handler by the optimized
  // nvcc 12.8 build for sm_90a; the plain-step comparison caught it.
  const int16_t* pay = qp + slot * P;

  const int32_t now0 = s.now[w];
  const int32_t now = found ? max(now0, tmin) : now0;
  const bool in_time = now < p.t_limit_us;
  const int dst = clampi(ev_dst, 0, N - 1);
  const bool is_fault = (ev_flags & FLAG_FAULT) != 0;
  const bool is_timer = (ev_flags & FLAG_TIMER) != 0;
  const bool stale = is_timer && ev_gen != ((int32_t)gen[dst] & 0xFF);
  const bool dead = !alive[dst];
  const bool deliver = found && in_time && !is_fault && !stale && !dead;
  const bool do_fault = found && in_time && is_fault;

  const uint32_t k0 = s.k0[w], k1 = s.k1[w];
  uint32_t ctr = s.counter[w];
  Outbox ob;
  empty_outbox(ob, M, P);
  bool hbug = false;

  if (do_fault) {
    // ---- apply_fault: a and b are the event's src and dst, unclamped ----
    const int op = ev_kind, a = ev_src, b = ev_dst;
    const bool is_kill = op == FAULT_KILL, is_restart = op == FAULT_RESTART;
    if (a < N) {
      alive[a] = is_kill ? 0 : (is_restart ? 1 : alive[a]);
      const int32_t g = (int32_t)gen[a] + ((is_kill || is_restart) ? 1 : 0);
      gen[a] = (int8_t)(((g + 128) & 0xFF) - 128);  // wraps mod 256
      paused[a] = op == FAULT_PAUSE
                      ? 1
                      : ((op == FAULT_RESUME || is_kill || is_restart)
                             ? 0
                             : paused[a]);
      clog_node[a] = op == FAULT_CLOG_NODE
                         ? 1
                         : (op == FAULT_UNCLOG_NODE ? 0 : clog_node[a]);
      if (b < N)
        clog_link[a * N + b] =
            op == FAULT_CLOG_LINK
                ? 1
                : (op == FAULT_UNCLOG_LINK ? 0 : clog_link[a * N + b]);
    }
    // Net-config params: join_wide of payload words 0-3 (packed profile).
    const int32_t pa = P >= 4 ? join_wide(pay[0], pay[1]) : 0;
    const int32_t pb = P >= 4 ? join_wide(pay[2], pay[3]) : 0;
    if (op == FAULT_SET_LATENCY) {
      s.lat_min[w] = pa;
      s.lat_max[w] = pb;
    }
    // float32(1e-6) written exactly: 0x358637bd.
    if (op == FAULT_SET_LOSS) s.loss[w] = __fmul_rn((float)pa, 0x1.0c6f7ap-20f);
    if (is_restart) raft_on_restart(p, v, a, k0, k1, ctr, ob);
  } else if (deliver) {
    raft_handle(p, v, ev_kind, ev_dst, pay, now, k0, k1, ctr, ob, hbug);
  }
  const int src = do_fault ? clampi(ev_src, 0, N - 1) : dst;

  // ---- push_outbox: 2*M draws, clog/loss drops, saturating send time ----
  const int32_t lat_min = s.lat_min[w], lat_max = s.lat_max[w];
  const float loss = s.loss[w];
  bool en[MAX_M];
  int32_t t_ev[MAX_M], meta_ev[MAX_M];
  for (int i = 0; i < M; i++) {
    const int32_t lat =
        u32_to_range(draw(k0, k1, ctr + 2u * i), lat_min, lat_max);
    const float u = u32_to_unit(draw(k0, k1, ctr + 2u * i + 1u));
    const int d = clampi(ob.dst[i], 0, N - 1);
    const bool clogged =
        clog_node[src] || clog_node[d] || clog_link[src * N + d];
    const bool dropped = !ob.is_timer[i] && (clogged || u < loss);
    const int32_t delay = max(ob.is_timer[i] ? ob.delay[i] : lat, 0);
    const int32_t room = INF_TIME - now;
    t_ev[i] = now + (delay < room ? delay : room);
    en[i] = ob.valid[i] && !dropped && t_ev[i] < INF_TIME;
    meta_ev[i] = pack_meta(ob.kind[i], ob.is_timer[i] ? FLAG_TIMER : 0, src,
                           d, (int32_t)gen[d]);
  }
  ctr += 2u * M;

  // ---- insert: the popped slot counts as free; the i-th enabled event
  // takes the i-th lowest free slot; past the last free slot, overflow ----
  if (found) qt[slot] = INF_TIME;
  int cursor = 0, n_ins = 0;
  bool ovf = false;
  for (int i = 0; i < M; i++) {
    if (!en[i]) continue;
    while (cursor < Q && qt[cursor] != INF_TIME) cursor++;
    if (cursor == Q) {
      ovf = true;
      continue;
    }
    qt[cursor] = t_ev[i];
    qm[cursor] = meta_ev[i];
    for (int k = 0; k < P; k++) qp[cursor * P + k] = sat16(ob.pay[i][k]);
    cursor++;
    n_ins++;
  }
  if (ovf) s.overflow[w] = 1;
  const int16_t qdepth =
      (int16_t)(s.qdepth[w] - (found ? 1 : 0) + n_ins);
  s.qdepth[w] = qdepth;
  if (qdepth > s.qmax[w]) s.qmax[w] = qdepth;

  // ---- invariant, bug flag and bookkeeping ----
  const bool bug_now = (deliver && hbug) || raft_invariant(v);
  const bool bug_old = s.bug[w];
  const bool bug = bug_old || bug_now;
  s.bug[w] = bug;
  if (bug && !bug_old) s.bug_time[w] = now;
  s.active[w] = found && in_time && !(p.stop_on_bug && bug);
  s.delivered[w] += deliver ? 1 : 0;
  s.dropped[w] += (found && in_time && !deliver && !do_fault) ? 1 : 0;
  s.now[w] = now;
  s.steps[w] += 1;
  s.counter[w] = ctr;
}

__global__ void threefry_kernel(const uint32_t* k0, const uint32_t* k1,
                                const uint32_t* c0, const uint32_t* c1,
                                uint32_t* o0, uint32_t* o1, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  threefry2x32(k0[i], k1[i], c0[i], c1[i], o0[i], o1[i]);
}

}  // namespace

// One engine step of every world, in place. ptrs: the 38 state leaves in
// leaf order; params: W then the Params fields after it. Returns the CUDA
// launch status.
extern "C" int madsim_step(void* const* ptrs, const int* params, int block,
                           void* stream) {
  State s;
  void** dst = reinterpret_cast<void**>(&s);
  static_assert(sizeof(State) == N_LEAVES * sizeof(void*), "State layout");
  for (int i = 0; i < N_LEAVES; i++) dst[i] = ptrs[i];
  Params p;
  static_assert(sizeof(Params) == N_PARAMS * sizeof(int), "Params layout");
  int* pp = reinterpret_cast<int*>(&p);
  for (int i = 0; i < N_PARAMS; i++) pp[i] = params[i];
  if (p.W <= 0 || p.N > MAX_N || p.P > MAX_P || p.L > MAX_L ||
      p.won != WON || block <= 0)
    return (int)cudaErrorInvalidValue;
  const int grid = (p.W + block - 1) / block;
  step_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(s, p);
  return (int)cudaGetLastError();
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
