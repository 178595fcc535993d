// The engine step of madsim_tpu_torch as one CUDA kernel for sm_90a: the
// skeleton, generic over the actor family.
//
// Replaces madsim_tpu/engine/pallas_step.py::make_pallas_step (:56), the JAX
// package's Pallas kernel (pallas_batched_step :65, body `kernel` :95, the
// pl.pallas_call at :132), whose body is the vmapped per-world step
// DeviceEngine._build_step (madsim_tpu/engine/core.py) with an actor traced
// in. Here the actor is a policy class A, written by hand in CUDA from the
// actor's source: Raft (actor_raft.cuh, from engine/raft_actor.py), and
// two-phase commit and primary-backup (actor_tpc.cuh, actor_pb.cuh, from
// the actorc specs actorc/families/{tpc,pb}.py as actorc/compile.py lowers
// them). step_raft.cu, step_tpc.cu and step_pb.cu each instantiate
// step_kernel<A, N> for the node counts the family takes and build into a
// library of their own, in parallel. The plain version is
// DeviceEngine.step_plain in madsim_tpu_torch/engine/core.py; the two agree
// bit for bit on every state leaf, and the port's tests hold the plain
// version to the JAX one. One launch is one step of every world, in place
// (the Pallas kernel's input_output_aliases).
//
// Bound: memory. A step does about a thousand integer operations per world,
// but it must read the queue's time lane whole (the pop scans every slot),
// the meta lane whole only where a node is paused (else the popped slot's
// word), one payload row, the rows the handler touches and what the
// invariant reads (Raft: the commit row and the log entries over each node
// pair's committed prefix; tpc: the decision table; pb: committed_max, and
// past it the views, the primary's log row and committed_cmd);
// chip_smoke.py's needed_bytes counts those bytes. This kernel stages the
// meta lane (and Raft's log lanes) whole for every active world, so it
// reads more than that count.
//
// Design. One thread per world, a block of B worlds; the tile plan (B, the
// padded strides, the shared-memory offsets, the access widths) comes from
// engine/step_kernel.py::tile_plan.
// - Coalesced world tiles. The lanes a step reads whole -- q_time, q_meta,
//   and Raft's commit, log_term, log_cmd -- are staged through shared
//   memory (the families' handler rows and invariant lanes are small and
//   read once a step, so they are read in device memory). The
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
//   handler's node row. The kernel is a template on the family's policy and
//   the node count N, instantiated for each N the family takes (Raft and pb
//   1..8, tpc 2..8) and chosen at launch, so per-node rows are register
//   arrays indexed only by counters of fully unrolled loops; rows indexed
//   at run time are bit masks or packed int16s in registers, and a family's
//   runtime-indexed column (tpc's txn, pb's log index) is read by address
//   in device memory.
// - Short dependency chains. The messages' latency draws (counters
//   ctr+2i) are taken two at a time together with the timer's drawn delay
//   (Raft's election timer, pb's watchdog), three interleaved Threefry
//   chains; where loss > 0 their loss draws (ctr+2i+1) come first. A draw
//   whose value no sent event uses is not computed (draws are pure
//   functions of the counter; the cursor still advances as the plain
//   step's does). tpc's vote draw is taken in its handler, where a fresh
//   vote needs it.
// - Reads see the pre-step state. Each family's handler reads every value
//   it needs before its first write (actorc's transitions all read the
//   state before the step), and folds its writes as actorc's merge pass
//   does: the last true write of a node lane wins, narrow writes saturate,
//   counters add in int32.
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

#pragma once

#include "step_common.cuh"

namespace {

// One step of an active world over its rows of the shared tiles. Returns
// the mask of the 4-slot chunks of its queue rows that it changed.
template <class A, int N>
__device__ __forceinline__ uint64_t active_step(
    const State<typename A::Lanes>& s, const Params& p, size_t w,
    const typename A::template View<N>& v, Pre<typename A::Lanes::Profile>& r,
    int32_t* qt, int32_t* qm) {
  using Pf = typename A::Lanes::Profile;
  // The outbox's entries (the family's: N messages and a timer, or the
  // pair family's two rows); the step draws 2 M times.
  constexpr int M = A::m(N);
  const int Q = p.Q, P = p.P;
  typename Pf::pay_t* qp = s.q_payload + w * Q * P;
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
  const Payload pay =
      load_payload<A::SHORT_PAYLOAD>(qp + slot * P, P, pay_vec);

  const int32_t now = found ? max(r.now, tmin) : r.now;
  const bool in_time = now < p.t_limit_us;
  const int dst = clampi(ev_dst, 0, N - 1);
  // The handler's node row, read now, in the same round trip as the
  // payload (its node is the event's clamped destination).
  const typename A::Row row = A::template load_row<N>(v, dst);
  const bool is_fault = (ev_flags & FLAG_FAULT) != 0;
  const bool is_timer = (ev_flags & FLAG_TIMER) != 0;
  const bool stale = is_timer && ev_gen != r.template gen_of<N>(dst);
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
      if (is_kill || is_restart) {
        // The generation lane wraps at its width (mod 256 packed, 2^32
        // wide); events carry and compare its low byte (GEN_MASK).
        const int g1 = (r.template gen_of<N>(a) + 1) & 0xFF;
        if constexpr (Pf::WIDE)
          s.gen[at] = (int32_t)((uint32_t)s.gen[at] + 1u);
        else
          s.gen[at] = (int8_t)(uint8_t)g1;
        r.template set_gen<N>(a, g1);
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
    // Net-config params: join_wide of payload words 0-3 in the packed
    // profile, words 0 and 1 whole in the wide one (the kernel takes
    // P >= 5).
    const int32_t pa = Pf::WIDE ? pay.w0 : join_wide(pay.w0, pay.w1);
    const int32_t pb = Pf::WIDE ? pay.w1 : join_wide(pay.w2, pay.w3);
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
    if (is_restart) A::template on_restart<N>(p, v, a, k0, k1, ctr, sd);
  } else if (deliver) {
    A::template handle<N>(p, v, ev_kind, ev_dst, pay, row, now, k0, k1, ctr,
                          sd, hbug);
  }

  // ---- the sends, in entry order: the messages to nodes 0..N-1, then the
  // timer. A message from or to a clogged node or over a clogged link is
  // dropped without a draw; the others are taken two at a time, their
  // latency draws (counters ctr+2i) computed together with the timer's
  // drawn delay (Raft's election timer, pb's watchdog), three independent
  // chains; where loss > 0 their loss draws (ctr+2i+1) come first. Each
  // kept event takes the next free slot (the popped one counts as free).
  // ----
  uint64_t dirty = 0;
  if (found) {
    qt[slot] = INF_TIME;
    dirty |= 1ull << (slot >> 2);
  }
  const int32_t room = INF_TIME - now;
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
    qm[cursor] = pack_meta(kind, flags, src, d, r.template gen_of<N>(d));
    store_payload<A::SHORT_PAYLOAD>(qp + cursor * P, P, pay_vec, e);
    dirty |= 1ull << (cursor >> 2);
    cursor++;
    n_ins++;
  };
  // Message i, its payload from the family.
  auto message = [&](int i, int32_t delay) {
    insert(delay, sd.msg_kind, 0, i, A::template message<N>(p, v, sd, i));
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
      sd.t_delay = A::draw_delay(p, lt);
      t_draw = false;
    }
    if (keep_a) message(ia, max(u32_to_range(la, r.lat_min, r.lat_max), 0));
    if (keep_b) message(ib, max(u32_to_range(lb, r.lat_min, r.lat_max), 0));
  }
  if (sd.t_valid) {
    insert(max(sd.t_delay, 0), sd.t_kind, FLAG_TIMER, sd.t_dst,
           Payload{sd.t_pay0, sd.t_pay1, 0, 0, 0, 0, 0, 0});
  }
  ctr += 2u * (uint32_t)M;

  if (ovf && !r.overflow) s.overflow[w] = 1;
  const typename Pf::slot_t qdepth =
      wrap<typename Pf::slot_t>(r.qdepth - (found ? 1 : 0) + n_ins);
  if (qdepth != r.qdepth) s.qdepth[w] = qdepth;
  if (qdepth > r.qmax) s.qmax[w] = qdepth;

  // ---- invariant, bug flag and bookkeeping ----
  const bool bug = r.bug || (deliver && hbug) || A::template invariant<N>(v);
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

// One step of every world of this block: the body of both kernels below.
template <class A, int N>
__device__ __forceinline__ void step_block(const State<typename A::Lanes>& s,
                                           const Params& p, const int* gate) {
  extern __shared__ __align__(16) char smem[];
  const int B = blockDim.x, tid = threadIdx.x;
  const size_t w0 = (size_t)blockIdx.x * B;
  const size_t w = w0 + tid;
  const int rows = (int)min((size_t)B, (size_t)p.W - w0);
  const bool mine = tid < rows;
  char* qt_tile = smem;
  char* qm_tile = smem + p.off_qm;
  uint64_t* dirty = reinterpret_cast<uint64_t*>(smem + p.off_dirty);
  const int q_row = p.Q * 4, q_stride = p.q_stride * 4;

  // What every world needs, frozen or not, in one batch with its flag.
  const bool act = mine && s.active[w];
  Pre<typename A::Lanes::Profile> r = {};
  if (mine) {
    r.now = s.now[w];
    r.qdepth = s.qdepth[w];
    r.qmax = s.qmax[w];
    r.bug = s.bug[w];
    r.hint = A::template frozen_hint<N>(s, w);
  }
  // A set gate: the launch changes nothing. Read beside the world's
  // scalars, so that its latency hides behind theirs; the same for every
  // thread, so the block returns whole, before its first barrier.
  if (__ldg(gate) != 0) return;
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
    A::template tiles_in<N>(s, p, smem, row0, n, first, step, at);
  }
  if (act) load_rest<N>(s, w, r);
  cp_async_wait_all();
  __syncthreads();

  uint64_t changed = 0;
  if (act) {
    const typename A::template View<N> v =
        A::template view<N>(s, p, w, smem, tid);
    changed = active_step<A, N>(
        s, p, w, v, r, reinterpret_cast<int32_t*>(qt_tile + tid * q_stride),
        reinterpret_cast<int32_t*>(qm_tile + tid * q_stride));
  } else if (mine) {
    // A frozen world: the pop finds nothing, every write is gated off, and
    // the RNG cursor and step count are restored. Only the high-water mark
    // and the invariant's bug flag are evaluated, as in the plain step, the
    // invariant over the world's lanes in device memory (where the
    // family's hint says it can hold, for Raft).
    if (r.qdepth > r.qmax) s.qmax[w] = r.qdepth;
    if (!r.bug && A::template frozen_bug<N>(s, p, w, r.hint)) {
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

// One engine step of every world, behind a gate word in device memory:
// where *gate is nonzero the launch reads each world's scalars, returns
// and changes nothing. The device-side loops (the pipelined superstep, the
// fused hunt) set the gate between launches, so that launches queued past
// their stop point are no-ops; every other launch points it at a zero word.
template <class A, int N>
__global__ void step_kernel(State<typename A::Lanes> s, Params p,
                            const int* gate) {
  step_block<A, N>(s, p, gate);
}

bool unit_ok(int u, int lo) { return u >= lo && u <= 16 && (u & (u - 1)) == 0; }

// Launches step_kernel<A, N>. Above 48 KB a block's dynamic shared memory
// needs the function's limit raised, once per instantiation and device.
template <class A, int N>
int launch_step(const State<typename A::Lanes>& s, const Params& p,
                int block, void* stream, const int* gate) {
  static int smem_limit[64] = {0};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device < 0 || device >= 64) return (int)cudaErrorInvalidDevice;
  if (p.smem_bytes > 48 * 1024 && p.smem_bytes > smem_limit[device]) {
    err = cudaFuncSetAttribute(step_kernel<A, N>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               p.smem_bytes);
    if (err != cudaSuccess) return (int)err;
    smem_limit[device] = p.smem_bytes;
  }
  const int grid = (p.W + block - 1) / block;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  step_kernel<A, N><<<grid, block, p.smem_bytes, st>>>(s, p, gate);
  return (int)cudaGetLastError();
}

// Instantiates and launches step_kernel<A, N> for N = N0..A::MAX_NODES (N0
// is the family's least node count; MAX_NODES is 8, or 12 for the pair
// family); other N are refused.
template <class A, int N0>
int launch_n(const State<typename A::Lanes>& s, const Params& p, int block,
             void* stream, const int* gate) {
  constexpr int NX = A::MAX_NODES;
  static_assert(NX >= 8 && NX <= MAX_N, "a policy's MAX_NODES");
  switch (p.N) {
    case 1:
      if constexpr (N0 <= 1)
        return launch_step<A, 1>(s, p, block, stream, gate);
      break;
    case 2:
      if constexpr (N0 <= 2)
        return launch_step<A, 2>(s, p, block, stream, gate);
      break;
    case 3: return launch_step<A, 3>(s, p, block, stream, gate);
    case 4: return launch_step<A, 4>(s, p, block, stream, gate);
    case 5: return launch_step<A, 5>(s, p, block, stream, gate);
    case 6: return launch_step<A, 6>(s, p, block, stream, gate);
    case 7: return launch_step<A, 7>(s, p, block, stream, gate);
    case 8: return launch_step<A, 8>(s, p, block, stream, gate);
    case 9:
      if constexpr (NX >= 9)
        return launch_step<A, 9>(s, p, block, stream, gate);
      break;
    case 10:
      if constexpr (NX >= 10)
        return launch_step<A, 10>(s, p, block, stream, gate);
      break;
    case 11:
      if constexpr (NX >= 11)
        return launch_step<A, 11>(s, p, block, stream, gate);
      break;
    case 12:
      if constexpr (NX >= 12)
        return launch_step<A, 12>(s, p, block, stream, gate);
      break;
    default: break;
  }
  return (int)cudaErrorInvalidValue;
}

// One engine step of every world, in place, for family A whose least node
// count is N0. ptrs: the State's pointers in its order (the engine's 12
// leaves, the family's lanes, the engine's 12 after them, then the metrics
// block's 13 and the ring's 8 lanes, null when off); n_ptrs their count;
// params: the Params fields (N_PARAMS ints); block: worlds per block; gate:
// the device int that gates the launch (see step_kernel). Returns the CUDA
// status of the launch.
template <class A, int N0>
int step_entry(void* const* ptrs, int n_ptrs, const int* params, int block,
               void* stream, const int* gate) {
  using S = State<typename A::Lanes>;
  constexpr int n_lanes = (int)(sizeof(typename A::Lanes) / sizeof(void*));
  constexpr int n_base = N_PRE_LEAVES + n_lanes + N_POST_LEAVES;
  static_assert(sizeof(S) ==
                    (size_t)(n_base + N_METRICS + N_RING) * sizeof(void*),
                "State layout");
  if (n_ptrs != n_base + N_METRICS + N_RING)
    return (int)cudaErrorInvalidValue;
  S s;
  void** dst = reinterpret_cast<void**>(&s);
  for (int i = 0; i < n_ptrs; i++) dst[i] = ptrs[i];
  for (int i = 0; i < n_base; i++)
    if (ptrs[i] == nullptr) return (int)cudaErrorInvalidValue;
  Params p;
  static_assert(sizeof(Params) == N_PARAMS * sizeof(int), "Params layout");
  int* pp = reinterpret_cast<int*>(&p);
  for (int i = 0; i < N_PARAMS; i++) pp[i] = params[i];
  // The optional lanes: all present when on, none read when off.
  for (int i = 0; i < N_METRICS; i++)
    if ((ptrs[n_base + i] != nullptr) != (p.metrics != 0))
      return (int)cudaErrorInvalidValue;
  for (int i = 0; i < N_RING; i++)
    if ((ptrs[n_base + N_METRICS + i] != nullptr) != (p.bb_k > 0))
      return (int)cudaErrorInvalidValue;
  if (gate == nullptr || p.family != A::FAMILY || !A::params_ok(p) ||
      p.W <= 0 || p.N < N0 ||
      p.N > A::MAX_NODES || p.P < (A::SHORT_PAYLOAD ? 1 : 8) ||
      p.P > MAX_P || p.Q < 1 || p.Q > MAX_Q ||
      block <= 0 || block > MAX_BLOCK || p.smem_bytes <= 0 ||
      p.smem_bytes > SMEM_MAX || p.q_stride < p.Q || p.q_stride % 4 ||
      !unit_ok(p.q_unit, 4) || (p.pay_unit != 16 && p.pay_unit != 2) ||
      (p.Q * 4) % p.q_unit ||
      (p.pay_unit == 16 &&
       (A::Lanes::Profile::WIDE ? (p.P % 4 || p.P < 8) : p.P % 8)) ||
      p.metrics < 0 || p.metrics > 1 || p.num_kinds < 1 ||
      p.num_kinds > 64 || p.bb_k < 0)
    return (int)cudaErrorInvalidValue;
  // The tiles: 16-byte aligned, in order, apart, within the block's bytes
  // (the commit and log tiles' elements are the profile's slot lane).
  const long b = block;
  constexpr long E = sizeof(typename A::Lanes::Profile::slot_t);
  if ((p.off_qm | p.off_dirty | p.off_commit | p.off_lt | p.off_lc) % 16 ||
      p.off_qm < b * p.q_stride * 4 ||
      p.off_dirty < p.off_qm + b * p.q_stride * 4 ||
      p.off_commit < p.off_dirty + b * 8 ||
      p.off_lt < p.off_commit + b * p.commit_stride * E ||
      p.off_lc < p.off_lt + b * p.log_stride * E ||
      p.smem_bytes < p.off_lc + b * p.log_stride * E)
    return (int)cudaErrorInvalidValue;
  return launch_n<A, N0>(s, p, block, stream, gate);
}

}  // namespace
