"""Multi-decree Paxos — the first DSL-only protocol family.

The port's copy of ``madsim_tpu/actorc/families/paxos.py``: the same
spec text, with the observations in torch. It runs on the plain step;
the CUDA kernel does not take it yet (ROADMAP). The JAX module's
docstring follows.

No hand-written twin exists or ever will: this spec is the proof that
the actor compiler makes new scenario families cheap (ROADMAP item 3).
Every node is proposer, acceptor and learner; decrees (slots) are
pre-assigned to proposers by the command schedule, with one *contended*
slot proposed by two different nodes at close times — the ballot race
classic Paxos resolves safely through promise/adoption, and the race
the guided hunt weaponizes.

Protocol (per slot): a command starts ballot ``round*n + me + 1`` —
PREPARE broadcast, acceptors PROMISE (reporting any accepted
(ballot, value)), on promise quorum the proposer ACCEPTs the
highest-ballot reported value (or its own), acceptors ACCEPTED, on
accepted quorum the value is CHOSEN and broadcast to the learners. A
retry timer re-prepares with a higher ballot while the slot is
undecided.

Invariant: **consistency** — no two nodes may learn different values
for the same slot (event-time check in the Chosen handler + a
state-scan over the learned table). The injected bug,
``buggy_forgetful_acceptor``, marks the acceptor lanes
(``promised``/``acc_bal``/``acc_val``) volatile across restart — the
textbook "Paxos requires stable storage" violation, expressed as ONE
flipped ``durable`` annotation. A restart of the right acceptor in the
window between one proposer's accept-quorum and the rival's re-prepare
erases the only memory forcing value adoption, and the rival drives a
second value to quorum: both values chosen, the hunt's target.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ...engine.core import EngineConfig, FAULT_RESTART
from ..compile import CompiledActor
from ..spec import ActorSpec, Lane, Message, Word

I16 = 32767

# Kind codes (spec declaration order).
K_CMD, K_PREPARE, K_PROMISE, K_ACCEPT, K_ACCEPTED, K_CHOSEN, K_RETRY = \
    range(7)


@dataclasses.dataclass(frozen=True)
class PaxosConfig:
    """Static multi-decree Paxos parameters."""

    n: int = 5                    # nodes (proposer+acceptor+learner each)
    n_slots: int = 3              # decrees
    cmd_start_us: int = 40_000
    cmd_interval_us: int = 30_000
    # The contended decree: proposed by BOTH node (slot % n) and node
    # ((slot + 2) % n), the second ``contend_gap_us`` later.
    contend_slot: int = 1
    contend_gap_us: int = 5_000
    # Contend EVERY decree instead of just one — the guided-hunt shape:
    # each slot's ballot race opens its own amnesia window, so the
    # violating restart band spans the whole command schedule instead
    # of one ~20 ms notch.
    contend_all: bool = False
    retry_min_us: int = 150_000
    retry_max_us: int = 400_000
    # Injected bug: acceptor state on memory instead of disk — restarts
    # forget promises and accepted values (see module docstring).
    buggy_forgetful_acceptor: bool = False


def paxos_spec(xcfg: PaxosConfig) -> ActorSpec:
    """Build the multi-decree Paxos spec from a :class:`PaxosConfig`."""
    x = xcfg
    n, S = x.n, x.n_slots
    q = n // 2 + 1
    durable_acc = not x.buggy_forgetful_acceptor

    lanes = (
        # Acceptor lanes — THE disk-vs-memory decision of Paxos: the
        # protocol is only safe if these survive restarts.
        Lane("promised", hi=I16, scope="node_table", cols=S,
             durable=durable_acc),
        Lane("acc_bal", hi=I16, scope="node_table", cols=S,
             durable=durable_acc),
        Lane("acc_val", hi=I16, scope="node_table", cols=S,
             durable=durable_acc),
        # Proposer lanes. prop_bal stops short of the int16 rail: the
        # retry path bids prop_bal + n, and speclint's capacity proof
        # (SPC030) demands the bumped ballot still fit the packed lane.
        Lane("prop_bal", hi=32000, scope="node_table", cols=S),
        Lane("prop_val", hi=I16, scope="node_table", cols=S),
        Lane("promises", hi=(1 << 31) - 1, scope="node_table", cols=S,
             kind="bitmask"),
        Lane("accepts", hi=(1 << 31) - 1, scope="node_table", cols=S,
             kind="bitmask"),
        Lane("seen_bal", hi=I16, scope="node_table", cols=S),
        Lane("seen_val", hi=I16, scope="node_table", cols=S),
        # Learner lane: 0 = undecided, else the chosen value.
        Lane("chosen", hi=I16, scope="node_table", cols=S),
        Lane("proposals", hi=(1 << 31) - 1, scope="world",
             kind="counter"),
        Lane("retries", hi=(1 << 31) - 1, scope="world", kind="counter"),
        Lane("chosen_count", hi=(1 << 31) - 1, scope="world",
             kind="counter"),
    )

    messages = (
        Message("Cmd", (Word("slot", 0, S - 1), Word("val", 1, I16))),
        Message("Prepare", (Word("bal", 1, I16), Word("slot", 0, S - 1))),
        Message("Promise", (Word("bal", 1, I16), Word("slot", 0, S - 1),
                            Word("abal", 0, I16), Word("aval", 0, I16),
                            Word("voter", 0, n - 1))),
        # val words admit 0 here: the adopted value is where(seen, seen,
        # own) whose static lower bound is the lanes' 0 floor, and the
        # payload-bound proof (SPC031) holds sends to declared ranges.
        Message("Accept", (Word("bal", 1, I16), Word("slot", 0, S - 1),
                           Word("val", 0, I16))),
        Message("Accepted", (Word("bal", 1, I16), Word("slot", 0, S - 1),
                             Word("voter", 0, n - 1),
                             Word("val", 0, I16))),
        Message("Chosen", (Word("slot", 0, S - 1), Word("val", 0, I16))),
        Message("Retry", (Word("slot", 0, S - 1),), timer=True),
    )

    def proposer_of(bal):
        return (bal - 1) % n

    def _start_round(c, slot, bal, when):
        """Shared proposer round start: self-promise (when still
        allowed), fresh vote books, PREPARE broadcast."""
        promised_me = c.read_at("promised", slot)
        self_ok = bal > promised_me
        c.write_at("promised", slot, bal, when=when & self_ok)
        c.write_at("prop_bal", slot, bal, when=when)
        c.write_at("promises", slot, c.where(self_ok, 1 << c.me, 0),
                   when=when)
        c.write_at("accepts", slot, 0, when=when)
        # The proposer's own promise reports its own accepted state.
        c.write_at("seen_bal", slot,
                   c.where(self_ok, c.read_at("acc_bal", slot), 0),
                   when=when)
        c.write_at("seen_val", slot,
                   c.where(self_ok, c.read_at("acc_val", slot), 0),
                   when=when)
        c.broadcast("Prepare", [bal, slot], when=when)
        c.arm("Retry", delay=c.uniform(x.retry_min_us, x.retry_max_us),
              words=[slot], when=when)

    # -- transitions ---------------------------------------------------
    def h_cmd(c):
        """A scheduled client command reaches its proposer: start
        ballot me+1 (round 0) for the assigned slot."""
        slot = c.clip(c.arg("slot"), 0, S - 1)
        go = (c.read_at("prop_bal", slot) == 0) & \
            (c.read_at("chosen", slot) == 0)
        c.write_at("prop_val", slot, c.arg("val"), when=go)
        c.count("proposals", when=go)
        _start_round(c, slot, c.me + 1, go)

    def h_prepare(c):
        """Acceptor: promise a higher ballot, reporting any accepted
        (ballot, value) — the memory that forces value adoption."""
        slot = c.clip(c.arg("slot"), 0, S - 1)
        bal = c.arg("bal")
        ok = bal > c.read_at("promised", slot)
        c.write_at("promised", slot, bal, when=ok)
        c.send("Promise", dst=proposer_of(bal),
               words=[bal, slot, c.read_at("acc_bal", slot),
                      c.read_at("acc_val", slot), c.me], when=ok)

    def h_promise(c):
        """Proposer: collect promises; on quorum, ACCEPT the
        highest-ballot reported value (or our own)."""
        slot = c.clip(c.arg("slot"), 0, S - 1)
        bal = c.arg("bal")
        live = (bal == c.read_at("prop_bal", slot)) & \
            (c.read_at("chosen", slot) == 0)
        voter = c.clip(c.arg("voter"), 0, n - 1)
        pm = c.read_at("promises", slot)
        pm2 = pm | c.where(live, 1 << voter, 0)
        sb, sv = c.read_at("seen_bal", slot), c.read_at("seen_val", slot)
        better = live & (c.arg("abal") > sb)
        sb2 = c.where(better, c.arg("abal"), sb)
        sv2 = c.where(better, c.arg("aval"), sv)
        cross = live & (c.popcount(pm2) >= q) & (c.popcount(pm) < q)
        val = c.where(sb2 > 0, sv2, c.read_at("prop_val", slot))
        c.write_at("promises", slot, pm2, when=live)
        c.write_at("seen_bal", slot, sb2, when=live)
        c.write_at("seen_val", slot, sv2, when=live)
        c.write_at("prop_val", slot, val, when=cross)
        # Self-accept (the proposer is an acceptor too), if no higher
        # prepare has arrived in the meantime.
        sok = cross & (bal >= c.read_at("promised", slot))
        c.write_at("promised", slot, bal, when=sok)
        c.write_at("acc_bal", slot, bal, when=sok)
        c.write_at("acc_val", slot, val, when=sok)
        c.write_at("accepts", slot, c.where(sok, 1 << c.me, 0),
                   when=cross)
        c.broadcast("Accept", [bal, slot, val], when=cross)

    def h_accept(c):
        """Acceptor: accept a value at or above the promised ballot."""
        slot = c.clip(c.arg("slot"), 0, S - 1)
        bal = c.arg("bal")
        ok = bal >= c.read_at("promised", slot)
        c.write_at("promised", slot, bal, when=ok)
        c.write_at("acc_bal", slot, bal, when=ok)
        c.write_at("acc_val", slot, c.arg("val"), when=ok)
        c.send("Accepted", dst=proposer_of(bal),
               words=[bal, slot, c.me, c.arg("val")], when=ok)

    def h_accepted(c):
        """Proposer: on accepted-quorum the value is chosen — learn it
        and tell everyone."""
        slot = c.clip(c.arg("slot"), 0, S - 1)
        bal = c.arg("bal")
        live = (bal == c.read_at("prop_bal", slot)) & \
            (c.read_at("chosen", slot) == 0)
        voter = c.clip(c.arg("voter"), 0, n - 1)
        am = c.read_at("accepts", slot)
        am2 = am | c.where(live, 1 << voter, 0)
        cross = live & (c.popcount(am2) >= q) & (c.popcount(am) < q)
        c.write_at("accepts", slot, am2, when=live)
        c.write_at("chosen", slot, c.arg("val"), when=cross)
        c.count("chosen_count", when=cross)
        c.broadcast("Chosen", [slot, c.arg("val")], when=cross)

    def h_chosen(c):
        """Learner: adopt the chosen value — and flag the consistency
        violation the moment a CONFLICTING choice arrives (the
        event-time invariant form)."""
        slot = c.clip(c.arg("slot"), 0, S - 1)
        cur = c.read_at("chosen", slot)
        c.bug((cur > 0) & (cur != c.arg("val")))
        c.write_at("chosen", slot, c.arg("val"), when=cur == 0)

    def h_retry(c):
        """Proposer liveness: while the slot is undecided, re-prepare
        with the next ballot in our residue class."""
        slot = c.clip(c.arg("slot"), 0, S - 1)
        started = c.read_at("prop_bal", slot) > 0
        go = started & (c.read_at("chosen", slot) == 0)
        c.count("retries", when=go)
        _start_round(c, slot, c.read_at("prop_bal", slot) + n, go)

    # -- init / invariant / observe ------------------------------------
    def init(c):
        for s in range(S):
            p = s % n
            c.event("Cmd", time=x.cmd_start_us + s * x.cmd_interval_us,
                    dst=p, words=[s, s * 8 + p + 1])
        # The contended decree(s): a second proposer, a beat later,
        # with a different value — the ballot race.
        contended = range(S) if x.contend_all else [x.contend_slot % S]
        for s in contended:
            p2 = (s + 2) % n
            c.event("Cmd",
                    time=x.cmd_start_us + s * x.cmd_interval_us
                    + x.contend_gap_us,
                    dst=p2, words=[s, s * 8 + p2 + 1])

    def invariant(v):
        """Consistency: all nonzero learned values per slot agree."""
        ch = v.lane("chosen")                    # (N, S)
        mx = v.np.max(ch, axis=0)                # (S,)
        return v.np.any((ch > 0) & (ch != mx[None, :]))

    def obs_slots_decided(o):
        import torch

        return torch.sum(torch.any(o.raw("chosen") > 0, dim=-2)
                         .to(torch.int32), dim=-1, dtype=torch.int32)

    def obs_max_ballot(o):
        import torch

        return torch.amax(o.raw("prop_bal"), dim=(-2, -1))

    return ActorSpec(
        name="paxos",
        n_nodes=n,
        lanes=lanes,
        messages=messages,
        handlers={"Cmd": h_cmd, "Prepare": h_prepare,
                  "Promise": h_promise, "Accept": h_accept,
                  "Accepted": h_accepted, "Chosen": h_chosen,
                  "Retry": h_retry},
        init=init,
        on_restart=None,
        invariant=invariant,
        observe={"slots_decided": obs_slots_decided,
                 "max_ballot": obs_max_ballot},
        invariant_id="paxos_chosen_conflict",
        terminal=("Chosen",),
        # The forgetful-acceptor variant deliberately trips speclint's
        # durability rule — the amnesia IS the experiment (the lanes go
        # volatile with nothing to reconstruct them).
        lint_allow=("SPC050",) if x.buggy_forgetful_acceptor else (),
    )


class PaxosActor(CompiledActor):
    """Multi-decree Paxos, compiled from its actorc spec — registered
    in the obs replay registry and the actor-family registry like any
    hand-written family."""

    def __init__(self, xcfg: PaxosConfig = PaxosConfig()):
        super().__init__(paxos_spec(xcfg))
        self.xcfg = xcfg

    def __reduce__(self):
        # The spec's handlers are closures: pickle the config and
        # compile again (a spawned fleet worker receives the actor).
        return type(self), (self.xcfg,)


def engine_config(xcfg: PaxosConfig = PaxosConfig(),
                  metrics: bool = False) -> EngineConfig:
    """The canonical engine shape for this family (PROMISE carries five
    payload words)."""
    return EngineConfig(n_nodes=xcfg.n, outbox_cap=xcfg.n + 1,
                        queue_cap=128, payload_words=5,
                        t_limit_us=2_000_000, metrics=metrics)


def hunt_template(xcfg: PaxosConfig = PaxosConfig(),
                  n_rows: int = 6) -> np.ndarray:
    """The benign fault-schedule template of the guided Paxos hunt:
    restarts at EARLY times — all before ``cmd_start_us``, when no
    acceptor state exists yet — so no subset of the template can
    trigger the forgetful-acceptor bug. The violation needs TWO
    restarts jittered forward into the ~20 ms amnesia window between
    the first proposer's accept-quorum and the rival's promise-quorum
    on the contended decree (measured: one in-window restart violates
    ~1% of seeds, two violate up to ~7%). One in-window restart is
    behaviorally visible (perturbed rounds, retries), so the guided
    corpus keeps it as a parent and the second hop — another jitter or
    a splice of two one-hit parents — reaches the conjunction; a
    random single-pass mutation of this template must land both rows
    at once (docs/search.md "when guided beats random")."""
    rows = np.zeros((n_rows, 4), np.int32)
    rows[:, 0] = 4_000 * (1 + np.arange(n_rows))
    rows[:, 1] = FAULT_RESTART
    rows[:, 2] = [(i * 2) % xcfg.n for i in range(n_rows)]
    return rows
