"""Raft actor for the batched engine, in PyTorch.

The counterpart of ``madsim_tpu/engine/raft_actor.py``: leader election and
single-entry-pipelined log replication, with the invariant (election safety
through the ``won_terms`` history, log matching on committed prefixes)
raising the per-world bug flag. Every function takes tensors with a
leading world axis. Node-indexed writes go through the masked
:func:`~madsim_tpu_torch.engine.lanes.upd` helpers (saturating into the
packed lanes), reads through the clamping
:func:`~madsim_tpu_torch.engine.lanes.take_small`, exactly as in the JAX
actor, so the two agree bit for bit.

The CUDA step kernel's Raft policy (``csrc/actor_raft.cuh``) carries its
own C++ copy of :meth:`RaftActor.handle`, :meth:`RaftActor.on_restart`
and :meth:`RaftActor.invariant`; this module is the plain version it is
held to.
"""
from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Tuple

import torch

from .actor_util import bcast_payload, make_outbox, pad_payload
from .core import EngineConfig, Outbox
from .lanes import on_device, popcount32, take_small, upd, upd2, widen
from .queue import FLAG_TIMER, INF_TIME, Event, _wrap_i32
from .rng import DevRng, uniform_u32

FOLLOWER, CANDIDATE, LEADER = 0, 1, 2

# Words in the per-node won-terms bitset.
WON_WORDS = 4

# Event kinds.
K_ELECTION = 0      # timer [epoch]
K_HEARTBEAT = 1     # timer [term]
K_REQVOTE = 2       # msg [term, candidate, last_idx, last_term]
K_VOTEREPLY = 3     # msg [term, granted, voter]
K_APPEND = 4        # msg [term, leader, prev_idx, prev_term, n, e_term, e_cmd, l_commit]
K_APPENDREPLY = 5   # msg [term, success, match_idx, follower]
K_PROPOSE = 6       # scheduled client proposal [cmd]
NUM_KINDS = 7


@dataclasses.dataclass(frozen=True)
class RaftDeviceConfig:
    """Static Raft parameters (same fields and defaults as the JAX one)."""

    n: int = 3
    log_cap: int = 16
    elect_min_us: int = 150_000
    elect_max_us: int = 300_000
    heartbeat_us: int = 50_000
    n_proposals: int = 0
    propose_start_us: int = 800_000
    propose_interval_us: int = 100_000
    buggy_double_vote: bool = False


class RaftState(NamedTuple):
    """Per-world Raft state; lane dtypes follow ``EngineConfig.lanes``."""

    term: torch.Tensor        # (W, N) slot lane
    voted_for: torch.Tensor   # (W, N) node lane, -1 = none
    role: torch.Tensor        # (W, N) code lane
    votes: torch.Tensor       # (W, N) i32 bitmask of granted votes
    commit: torch.Tensor      # (W, N) slot lane
    log_len: torch.Tensor     # (W, N) slot lane
    log_term: torch.Tensor    # (W, N, L) slot lane
    log_cmd: torch.Tensor     # (W, N, L) payload lane
    next_idx: torch.Tensor    # (W, N, N) slot lane [leader, peer]
    match_idx: torch.Tensor   # (W, N, N) slot lane [leader, peer]
    elect_epoch: torch.Tensor  # (W, N) slot lane
    first_leader_time: torch.Tensor  # (W,) i32 µs, INF if never
    elections_won: torch.Tensor      # (W,) i32
    won_terms: torch.Tensor          # (W, N, WON_WORDS) i32 bitmask


def _event(time, kind, cfg: EngineConfig, w: int, device, flags=0, src=0,
           dst=0, gen=0, word0=0) -> Event:
    """A batch of one event per world (payload [word0, 0, ...])."""
    def i32(x):
        return on_device(x, device, torch.int32).expand(w)

    payload = torch.zeros((w, cfg.payload_words), dtype=torch.int32,
                          device=device)
    payload[:, 0] = i32(word0)
    return Event(time=i32(time), kind=i32(kind), flags=i32(flags),
                 src=i32(src), dst=i32(dst), gen=i32(gen), payload=payload)


class RaftActor:
    """Actor implementing the engine protocol for a Raft cluster."""

    num_kinds = NUM_KINDS
    kind_names = ["Election", "Heartbeat", "RequestVote", "VoteReply",
                  "AppendEntries", "AppendReply", "Propose"]
    state_type = RaftState

    def __init__(self, rcfg: RaftDeviceConfig):
        self.rcfg = rcfg

    # ------------------------------------------------------------------
    def init(self, cfg: EngineConfig, rng: DevRng
             ) -> Tuple[RaftState, List[Event], DevRng]:
        r = self.rcfg
        n, L = r.n, r.log_cap
        if cfg.n_nodes != n:
            raise ValueError("EngineConfig.n_nodes must match RaftDeviceConfig.n")
        if cfg.m != n + 1:
            raise ValueError("RaftActor needs outbox_cap == n + 1 "
                             "(n-1 peer messages + 1 timer per handler)")
        if cfg.payload_words < 8:
            raise ValueError("RaftActor needs payload_words >= 8")
        lt = cfg.lanes
        w = rng.k0.shape[0]
        dev = rng.k0.device

        def full(shape, v, dtype):
            return torch.full((w,) + shape, v, dtype=dtype, device=dev)

        s = RaftState(
            term=full((n,), 0, lt.slot),
            voted_for=full((n,), -1, lt.node),
            role=full((n,), 0, lt.code),
            votes=full((n,), 0, torch.int32),
            commit=full((n,), 0, lt.slot),
            log_len=full((n,), 0, lt.slot),
            log_term=full((n, L), 0, lt.slot),
            log_cmd=full((n, L), 0, lt.payload),
            next_idx=full((n, n), 1, lt.slot),
            match_idx=full((n, n), 0, lt.slot),
            elect_epoch=full((n,), 0, lt.slot),
            first_leader_time=full((), INF_TIME, torch.int32),
            elections_won=full((), 0, torch.int32),
            won_terms=full((n, WON_WORDS), 0, torch.int32),
        )
        events: List[Event] = []
        for i in range(n):
            delay, rng = uniform_u32(rng, r.elect_min_us, r.elect_max_us)
            events.append(_event(delay, K_ELECTION, cfg, w, dev,
                                 flags=FLAG_TIMER, src=i, dst=i))
        for p in range(r.n_proposals):
            t = r.propose_start_us + p * r.propose_interval_us
            for i in range(n):
                events.append(_event(t, K_PROPOSE, cfg, w, dev, src=i,
                                     dst=i, word0=p + 1))
        return s, events, rng

    # ------------------------------------------------------------------
    def on_restart(self, cfg: EngineConfig, s: RaftState, node, now,
                   rng: DevRng) -> Tuple[RaftState, Outbox, DevRng]:
        """Restart hook: persistent state (term, vote, log) survives,
        volatile state resets, and a fresh election timer is drawn."""
        r = self.rcfg
        n = r.n
        w = node.shape[0]
        dev = node.device
        me = node.clamp(0, n - 1)
        epoch2 = widen(take_small(s.elect_epoch, me)) + 1
        s = s._replace(
            role=upd(s.role, me, FOLLOWER),
            votes=upd(s.votes, me, 0),
            commit=upd(s.commit, me, 0),
            next_idx=upd(s.next_idx, me, torch.ones(
                (w, n), dtype=torch.int32, device=dev)),
            match_idx=upd(s.match_idx, me, torch.zeros(
                (w, n), dtype=torch.int32, device=dev)),
            elect_epoch=upd(s.elect_epoch, me, epoch2),
        )
        delay, rng = uniform_u32(rng, r.elect_min_us, r.elect_max_us)
        ob = make_outbox(
            cfg, n,
            msg_valid=torch.zeros((w, n), dtype=torch.bool, device=dev),
            msg_kind=torch.zeros((w, n), dtype=torch.int32, device=dev),
            msg_payload=torch.zeros((w, n, cfg.payload_words),
                                    dtype=torch.int32, device=dev),
            timer_valid=True, timer_kind=K_ELECTION, timer_dst=me,
            timer_delay=delay, timer_payload=pad_payload(cfg, [epoch2]),
        )
        return s, ob, rng

    # ------------------------------------------------------------------
    def handle(self, cfg: EngineConfig, s: RaftState, ev: Event, now,
               rng: DevRng) -> Tuple[RaftState, Outbox, DevRng, torch.Tensor]:
        """The merged handler of every event kind (see the JAX docstring):
        each shared piece is computed once and combined per kind with
        masked writes. Returns ``(state, outbox, rng, hist_bug)``."""
        r = self.rcfg
        n, L = r.n, r.log_cap
        dev = ev.kind.device
        i32 = torch.int32
        kind = ev.kind.clamp(0, NUM_KINDS - 1)
        me = ev.dst.clamp(0, n - 1)
        p = ev.payload
        t = p[:, 0]

        is_elec = kind == K_ELECTION
        is_hb = kind == K_HEARTBEAT
        is_rv = kind == K_REQVOTE
        is_vr = kind == K_VOTEREPLY
        is_ap = kind == K_APPEND
        is_ar = kind == K_APPENDREPLY
        is_pr = kind == K_PROPOSE

        # -- shared step-down (the four message kinds carrying a term) --
        sd = is_rv | is_vr | is_ap | is_ar
        term_pre = widen(take_small(s.term, me))
        role_pre = widen(take_small(s.role, me))
        higher = sd & (t > term_pre)
        demote = higher | (is_ap & (t == term_pre) & (role_pre == CANDIDATE))
        s = s._replace(
            term=upd(s.term, me, torch.where(higher, t, term_pre)),
            voted_for=upd(s.voted_for, me, torch.where(
                higher, -1, widen(take_small(s.voted_for, me)))),
            role=upd(s.role, me, torch.where(demote, FOLLOWER, role_pre)),
        )

        # -- shared views of the post-step-down row --
        term_me = widen(take_small(s.term, me))
        role_me = widen(take_small(s.role, me))
        voted_me = widen(take_small(s.voted_for, me))
        votes_me = take_small(s.votes, me)
        commit_me = widen(take_small(s.commit, me))
        llen_me = widen(take_small(s.log_len, me))
        epoch_me = widen(take_small(s.elect_epoch, me))
        log_term_row = widen(take_small(s.log_term, me))   # (W, L)
        log_cmd_row = widen(take_small(s.log_cmd, me))     # (W, L)
        my_last_term = self._row_term_at(log_term_row, llen_me)
        reject = t < term_me

        # One election-delay draw serves every kind that draws; the cursor
        # advances only for those kinds.
        delay, rng_drawn = uniform_u32(rng, r.elect_min_us, r.elect_max_us)
        draws = is_elec | is_rv | is_ap
        rng = rng._replace(counter=torch.where(
            draws, rng_drawn.counter.to(torch.int64),
            rng.counter.to(torch.int64)).to(torch.uint32))

        # -- election fire --
        fire = is_elec & (p[:, 0] == epoch_me) & (role_me != LEADER)
        term2 = term_me + 1

        # -- reqvote grant --
        cand = p[:, 1].clamp(0, n - 1)
        up_to_date = (p[:, 3] > my_last_term) | \
            ((p[:, 3] == my_last_term) & (p[:, 2] >= llen_me))
        if r.buggy_double_vote:
            can_vote = torch.ones_like(is_rv)
        else:
            can_vote = (voted_me == -1) | (voted_me == cand)
        grant = is_rv & ~reject & up_to_date & can_vote
        epoch2 = epoch_me + 1

        # -- votereply win + historical election safety --
        voter = p[:, 2].clamp(0, n - 1)
        counted = is_vr & (p[:, 1] != 0) & (role_me == CANDIDATE) \
            & (t == term_me)
        votes2 = torch.where(counted, votes_me | (torch.ones_like(voter)
                                                  << voter), votes_me)
        win = counted & (popcount32(votes2) > n // 2)
        bit_index = term_me.clamp(0, 32 * WON_WORDS - 1)
        word = bit_index // 32
        bit = _wrap_i32(torch.ones_like(bit_index, dtype=torch.int64)
                        << (bit_index % 32).to(torch.int64))
        term_mask = torch.where(
            torch.arange(WON_WORDS, device=dev)[None, :] == word[:, None],
            bit[:, None], 0)                                      # (W, 4)
        node_won_term = ((s.won_terms & term_mask[:, None, :]) != 0) \
            .any(dim=2)                                           # (W, N)
        arange_n = torch.arange(n, device=dev)[None, :]
        hist_bug = win & ((arange_n != me[:, None]) & node_won_term).any(dim=1)
        my_won = take_small(s.won_terms, me)                      # (W, 4)

        # -- append --
        leader = p[:, 1].clamp(0, n - 1)
        prev_idx, prev_term = p[:, 2], p[:, 3]
        n_ent, e_term, e_cmd, l_commit = p[:, 4], p[:, 5], p[:, 6], p[:, 7]
        prev_ok = (prev_idx <= llen_me) & \
            (self._row_term_at(log_term_row, prev_idx) == prev_term)
        success = is_ap & ~reject & prev_ok
        idx = prev_idx + 1
        write = success & (n_ent > 0) & (idx <= L)
        pos_ap = (idx - 1).clamp(0, L - 1)
        same = (idx <= llen_me) & \
            (take_small(log_term_row, pos_ap) == e_term) & \
            (take_small(log_cmd_row, pos_ap) == e_cmd)
        new_len_ap = torch.where(write, torch.where(same, llen_me, idx),
                                 llen_me)
        match_ap = torch.where(write, idx, torch.where(success, prev_idx, 0))
        commit_ap = torch.where(
            success, torch.maximum(commit_me,
                                   torch.minimum(l_commit, new_len_ap)),
            commit_me)

        # -- propose --
        accept = is_pr & (role_me == LEADER) & (llen_me < L)
        pos_pr = llen_me.clamp(0, L - 1)
        llen_pr = llen_me + accept.to(i32)

        # -- appendreply --
        follower = p[:, 3].clamp(0, n - 1)
        live_ar = is_ar & (role_me == LEADER) & (t == term_me)
        ok_ar = live_ar & (p[:, 1] != 0)
        fail_ar = live_ar & (p[:, 1] == 0)
        cur_match = widen(take_small(take_small(s.match_idx, me), follower))
        cur_next = widen(take_small(take_small(s.next_idx, me), follower))
        match2 = torch.maximum(cur_match, p[:, 2])

        # -- one combined log write (append XOR propose position) --
        pos = torch.where(is_ap, pos_ap, pos_pr)
        lt_at = take_small(log_term_row, pos)
        lc_at = take_small(log_cmd_row, pos)
        lt_new = torch.where(write, e_term, torch.where(accept, term_me, lt_at))
        lc_new = torch.where(write, e_cmd, torch.where(accept, p[:, 0], lc_at))

        # -- per-row combines --
        c = lambda x: x[:, None]  # noqa: E731  (W,) → (W, 1)
        oh_follower = arange_n == c(follower)
        is_me = arange_n == c(me)
        match_row0 = widen(take_small(s.match_idx, me))           # (W, N)
        next_row0 = widen(take_small(s.next_idx, me))
        match_row = torch.where(
            c(win), torch.where(is_me, c(llen_me), 0),
            torch.where(c(is_ar) & oh_follower,
                        c(torch.where(ok_ar, match2, cur_match)),
                        torch.where(c(is_pr) & is_me & c(accept),
                                    c(llen_pr), match_row0)))
        next_row = torch.where(
            c(win), c(1 + llen_me),
            torch.where(c(is_ar) & oh_follower,
                        c(torch.where(ok_ar, match2 + 1,
                                      torch.where(fail_ar,
                                                  torch.clamp(cur_next - 1,
                                                              min=1),
                                                  cur_next))),
                        next_row0))

        # -- appendreply commit advance (over the updated match row) --
        ns = torch.arange(1, L + 1, dtype=i32, device=dev)
        counts = (match_row[:, :, None] >= ns[None, None, :]).sum(dim=1)
        okn = (ns[None, :] <= c(llen_me)) & (counts > n // 2) \
            & (log_term_row == c(term_me))
        best = torch.where(okn, ns[None, :], 0).max(dim=1).values
        commit_ar = torch.where(live_ar, torch.maximum(commit_me, best),
                                commit_me)

        # -- final state: one masked write per field --
        s2 = s._replace(
            term=upd(s.term, me, torch.where(fire, term2, term_me)),
            voted_for=upd(s.voted_for, me, torch.where(
                fire, me, torch.where(grant, cand, voted_me))),
            role=upd(s.role, me, torch.where(
                fire, CANDIDATE, torch.where(win, LEADER, role_me))),
            votes=upd(s.votes, me, torch.where(
                fire, torch.ones_like(me) << me,
                torch.where(is_vr, votes2, votes_me))),
            won_terms=upd(s.won_terms, me, torch.where(
                c(win), my_won | term_mask, my_won)),
            elect_epoch=upd(s.elect_epoch, me, torch.where(
                grant | (is_ap & ~reject), epoch2, epoch_me)),
            log_term=upd2(s.log_term, me, pos, lt_new),
            log_cmd=upd2(s.log_cmd, me, pos, lc_new),
            log_len=upd(s.log_len, me, torch.where(
                is_ap, new_len_ap, torch.where(is_pr, llen_pr, llen_me))),
            commit=upd(s.commit, me, torch.where(
                is_ap, commit_ap, torch.where(is_ar, commit_ar, commit_me))),
            match_idx=upd(s.match_idx, me, match_row),
            next_idx=upd(s.next_idx, me, next_row),
            first_leader_time=torch.where(
                win, torch.minimum(s.first_leader_time, now.to(i32)),
                s.first_leader_time),
            elections_won=s.elections_won + win.to(i32),
        )

        # -- one AppendEntries construction for heartbeat/win/propose --
        oh_pos = torch.arange(L, device=dev)[None, :] == c(pos)
        log_term_row2 = torch.where(oh_pos, c(lt_new), log_term_row)
        log_cmd_row2 = torch.where(oh_pos, c(lc_new), log_cmd_row)
        llen_me2 = torch.where(is_ap, new_len_ap,
                               torch.where(is_pr, llen_pr, llen_me))
        term_me2 = torch.where(fire, term2, term_me)
        commit_me2 = torch.where(is_ap, commit_ap,
                                 torch.where(is_ar, commit_ar, commit_me))
        am_valid, am_payload = self._append_msgs(
            cfg, me, llen_me2, log_term_row2, log_cmd_row2, next_row,
            term_me2, commit_me2)
        live_hb = is_hb & (role_me == LEADER) & (term_me == p[:, 0])

        # -- outbox: one combined build --
        use_am = live_hb | win | accept
        no_msg = torch.zeros_like(is_me)
        msg_valid = torch.where(
            c(use_am), am_valid,
            torch.where(c(fire), ~is_me,
                        torch.where(c(is_rv), arange_n == c(cand),
                                    torch.where(c(is_ap),
                                                arange_n == c(leader),
                                                no_msg))))
        msg_kind = c(torch.where(
            is_elec, K_REQVOTE,
            torch.where(is_rv, K_VOTEREPLY,
                        torch.where(is_ap, K_APPENDREPLY, K_APPEND)))
        ).to(i32).expand(-1, n)
        w0 = torch.where(is_elec, term2, term_me)
        w1 = torch.where(is_elec, me,
                         torch.where(is_rv, grant.to(i32), success.to(i32)))
        w2 = torch.where(is_elec, llen_me, torch.where(is_rv, me, match_ap))
        w3 = torch.where(is_elec, my_last_term,
                         torch.where(is_rv, 0, me))
        small = bcast_payload(cfg, n, [w0, w1, w2, w3])
        msg_payload = torch.where(use_am[:, None, None], am_payload, small)

        timer_valid = (is_elec & (p[:, 0] == epoch_me)) | live_hb | grant \
            | win | (is_ap & ~reject)
        hb_timer = is_hb | is_vr
        timer_kind = torch.where(hb_timer, K_HEARTBEAT, K_ELECTION).to(i32)
        timer_delay = torch.where(hb_timer, r.heartbeat_us, delay)
        tp = torch.where(is_elec, epoch_me,
                         torch.where(is_rv | is_ap, epoch2,
                                     torch.where(is_hb, p[:, 0], term_me)))
        ob = make_outbox(
            cfg, n, msg_valid=msg_valid, msg_kind=msg_kind,
            msg_payload=msg_payload, timer_valid=timer_valid,
            timer_kind=timer_kind, timer_dst=me, timer_delay=timer_delay,
            timer_payload=pad_payload(cfg, [tp]),
        )
        return s2, ob, rng, hist_bug

    # ------------------------------------------------------------------
    def invariant(self, cfg: EngineConfig, s: RaftState) -> torch.Tensor:
        """(W,) bool: log matching violated on a committed prefix of some
        ordered node pair i < j. (Election safety is checked at win time
        in :meth:`handle`, through ``won_terms``.)"""
        n = self.rcfg.n
        k = torch.arange(self.rcfg.log_cap, device=s.commit.device)[None, :]
        bad = torch.zeros(s.commit.shape[:1], dtype=torch.bool,
                          device=s.commit.device)
        for i in range(n):
            for j in range(i + 1, n):
                lim = widen(torch.minimum(s.commit[:, i], s.commit[:, j]))
                diff = (s.log_term[:, i] != s.log_term[:, j]) | \
                    (s.log_cmd[:, i] != s.log_cmd[:, j])
                bad = bad | ((k < lim[:, None]) & diff).any(dim=1)
        return bad

    # ------------------------------------------------------------------
    def observe(self, cfg: EngineConfig, s: RaftState) -> dict:
        return {
            "leader_elected": s.first_leader_time < INF_TIME,
            "first_leader_time_us": s.first_leader_time,
            "elections_won": s.elections_won,
            "max_commit": s.commit.max(dim=-1).values,
            "max_term": s.term.max(dim=-1).values,
        }

    # ==================================================================
    def _row_term_at(self, log_term_row, idx):
        L = self.rcfg.log_cap
        pos = (idx - 1).clamp(0, L - 1)
        return torch.where(idx <= 0, 0, take_small(log_term_row, pos))

    def _append_msgs(self, cfg, me, llen_me, log_term_row, log_cmd_row,
                     next_row, term_me, commit_me):
        """Per-peer AppendEntries payloads (W, N, P) from the leader's
        post-update next_idx row and log row views."""
        r = self.rcfg
        n, L = r.n, r.log_cap
        i32 = torch.int32
        nxt = next_row.clamp(1, L + 1)                     # (W, N)
        prev = nxt - 1
        prev_term = torch.where(
            prev <= 0, 0,
            take_small(log_term_row, (prev - 1).clamp(0, L - 1)))
        have = nxt <= llen_me[:, None]
        pos = (nxt - 1).clamp(0, L - 1)
        e_term = torch.where(have, take_small(log_term_row, pos), 0)
        e_cmd = torch.where(have, take_small(log_cmd_row, pos), 0)
        full = lambda x: x[:, None].to(i32).expand(-1, n)  # noqa: E731
        payload = torch.stack([
            full(term_me), full(me), prev, prev_term, have.to(i32), e_term,
            e_cmd, full(commit_me)], dim=2)
        pad = torch.zeros(payload.shape[:2] + (cfg.payload_words - 8,),
                          dtype=i32, device=payload.device)
        valid = torch.arange(n, device=me.device)[None, :] != me[:, None]
        return valid, torch.cat([payload, pad], dim=2)
