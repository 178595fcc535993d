"""Two-phase commit as an actorc spec — the migrated third family.

The port's copy of ``madsim_tpu/actorc/families/tpc.py``: the same spec
text, with the ``blocked`` observation in torch. The JAX module's
docstring follows.

A 1:1 transliteration of the formerly hand-written
:mod:`madsim_tpu.engine.tpc_actor` merged handler into the DSL: same
lanes (at the same packed dtypes, now derived from declared ranges
instead of hand-picked), same message payload words, same single
RNG draw consumed only by PREPARE, same coordinator-volatile restart
semantics — so trajectories are bit-identical to the hand-written
actor and the original test suite (tests/test_tpc_actor.py) passes
unchanged against the compiled build. See the module docstring of the
old implementation (now in the spec comments below) for the protocol
itself: node 0 coordinates textbook 2PC over ``n_txns`` scheduled
transactions; the atomicity invariant is the bug flag, and
``buggy_presumed_commit`` decides COMMIT on vote timeout — the unsound
shortcut seed sweeps catch at apply time.
"""
from __future__ import annotations

from ..spec import ActorSpec, Lane, Message, Word

# Decision codes.
NONE, COMMIT, ABORT = 0, 1, 2

COORD = 0  # node 0 coordinates; 1..n-1 participate


def tpc_spec(tcfg) -> ActorSpec:
    """Build the 2PC spec from a
    :class:`~madsim_tpu_torch.engine.tpc_actor.TPCDeviceConfig`."""
    t = tcfg
    n, T = t.n, t.n_txns
    if n < 2 or n > 31:
        from ..spec import SpecError

        raise SpecError("tpc spec needs 2..31 nodes (int32 vote bitmask)")

    lanes = (
        # Applied outcome per (node, txn) — the 2PC write-ahead record.
        Lane("decision", hi=2, scope="node_table", cols=T),
        # Participant's sent vote (NONE / COMMIT=yes / ABORT=no).
        Lane("voted", hi=2, scope="node_table", cols=T),
        # Coordinator's yes bitmask per txn: volatile in PRINCIPLE but
        # world-scoped (only the coordinator writes it), so the
        # conditional reset lives in the on_restart hook below.
        Lane("votes_yes", hi=(1 << 31) - 1, scope="world_vec", cols=T,
             kind="bitmask"),
        # Coordinator's decision record (durable).
        Lane("decided", hi=2, scope="world_vec", cols=T),
        Lane("txns_seen", hi=(1 << 31) - 1, scope="world", kind="counter"),
        Lane("commits", hi=(1 << 31) - 1, scope="world", kind="counter"),
        Lane("aborts", hi=(1 << 31) - 1, scope="world", kind="counter"),
    )

    messages = (
        Message("Txn", (Word("txn", 0, T - 1),)),
        Message("Prepare", (Word("txn", 0, T - 1),)),
        Message("Vote", (Word("txn", 0, T - 1), Word("yes", 0, 1),
                         Word("voter", 0, n - 1))),
        Message("Decide", (Word("txn", 0, T - 1),
                           Word("decision", 0, 2))),
        Message("Timeout", (Word("txn", 0, T - 1),), timer=True),
    )

    # -- transitions ---------------------------------------------------
    def h_txn(c):
        """Coordinator: start 2PC for a scheduled transaction."""
        txn = c.clip(c.arg("txn"), 0, T - 1)
        start = (c.me == COORD) & (c.read_vec_at("decided", txn) == NONE)
        c.count("txns_seen", when=start)
        c.broadcast("Prepare", [txn], when=start,
                    to=c.arange(n) != COORD)
        c.arm("Timeout", delay=t.vote_timeout_us, words=[txn],
              when=start, dst=COORD)

    def h_prepare(c):
        """Participant: vote once; a no-voter aborts unilaterally (it
        holds no locks for a transaction it rejected)."""
        txn = c.clip(c.arg("txn"), 0, T - 1)
        my_vote = c.read_at("voted", txn)
        fresh = (c.me != COORD) & (my_vote == NONE) & \
            (c.read_at("decision", txn) == NONE)
        vote_no = (c.u32() % 256) < t.no_vote_num
        vote_val = c.where(vote_no, ABORT, COMMIT)  # ABORT code == "no"
        c.write_at("voted", txn, vote_val, when=fresh)
        c.write_at("decision", txn, ABORT, when=fresh & vote_no)
        c.send("Vote", dst=COORD,
               words=[txn, c.where(vote_val == COMMIT, 1, 0), c.me],
               when=fresh)

    def h_vote(c):
        """Coordinator: collect votes; all-yes => COMMIT, any-no =>
        ABORT, immediately."""
        txn = c.clip(c.arg("txn"), 0, T - 1)
        decided_t = c.read_vec_at("decided", txn)
        live = (c.me == COORD) & (decided_t == NONE)
        voter = c.clip(c.arg("voter"), 0, n - 1)
        yes = c.arg("yes") == 1
        mask_all = (1 << n) - 2  # bits 1..n-1
        yes2 = c.read_vec_at("votes_yes", txn) | \
            c.where(live & yes, 1 << voter, 0)
        c.write_vec_at("votes_yes", txn, yes2)
        all_yes = live & (yes2 == mask_all)
        any_no = live & ~yes
        decide = all_yes | any_no
        val = c.where(all_yes, COMMIT, ABORT)
        _decide(c, txn, decide, val)

    def h_timeout(c):
        """Coordinator: decide for the stragglers on vote timeout —
        ABORT, or COMMIT under the injected presumed-commit bug."""
        txn = c.clip(c.arg("txn"), 0, T - 1)
        fire = (c.me == COORD) & (c.read_vec_at("decided", txn) == NONE)
        val = COMMIT if t.buggy_presumed_commit else ABORT
        _decide(c, txn, fire, val)

    def _decide(c, txn, decide, val):
        """Shared coordinator decision tail: record, count, broadcast."""
        c.write_vec_at("decided", txn, val, when=decide)
        c.write_at("decision", txn, val, when=decide)
        c.count("commits", when=decide & (val == COMMIT))
        c.count("aborts", when=decide & (val == ABORT))
        c.broadcast("Decide", [txn, val], when=decide,
                    to=c.arange(n) != COORD)

    def h_decide(c):
        """Participant: apply the coordinator's decision — unless it
        aborted unilaterally and the coordinator says COMMIT; that
        conflict IS the apply-time state the invariant reads."""
        txn = c.clip(c.arg("txn"), 0, T - 1)
        applied = c.read_at("decision", txn)
        apply_dec = (c.me != COORD) & (applied == NONE)
        c.write_at("decision", txn, c.arg("decision"), when=apply_dec)

    # -- init / restart / invariant ------------------------------------
    def init(c):
        for i in range(t.n_txns):
            c.event("Txn", time=t.txn_start_us + i * t.txn_interval_us,
                    dst=COORD, words=[i])

    def on_restart(c):
        """Decisions, votes and the decision log are durable (the 2PC
        write-ahead records); the coordinator's in-flight yes bitmasks
        for UNdecided txns are volatile — those txns stay pending until
        their timeout fires (or forever: the blocking window)."""
        volatile = c.read_vec("decided") == NONE
        c.write_vec("votes_yes",
                    c.where((c.me == COORD) & volatile, 0,
                            c.read_vec("votes_yes")))

    def invariant(v):
        """Atomicity: no txn both committed and aborted across nodes."""
        dec = v.lane("decision")
        committed = v.np.any(dec == COMMIT, axis=0)  # (T,)
        aborted = v.np.any(dec == ABORT, axis=0)
        return v.np.any(committed & aborted)

    def obs_blocked(o):
        # Batched state: node axis is -2, txn axis is -1. Yes-voters
        # still waiting for a decision — 2PC's blocking window.
        import torch

        applied = o.raw("decision")[..., 1:, :]  # participants only
        return torch.sum(
            torch.any((o.raw("voted")[..., 1:, :] == COMMIT)
                      & (applied == NONE), dim=-2).to(torch.int32),
            dim=-1, dtype=torch.int32)

    return ActorSpec(
        name="tpc",
        n_nodes=n,
        lanes=lanes,
        messages=messages,
        handlers={"Txn": h_txn, "Prepare": h_prepare, "Vote": h_vote,
                  "Decide": h_decide, "Timeout": h_timeout},
        init=init,
        on_restart=on_restart,
        invariant=invariant,
        observe={"blocked": obs_blocked},
        invariant_id="tpc_atomicity",
        terminal=("Decide",),
    )
