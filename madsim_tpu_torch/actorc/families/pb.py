"""Primary-backup replication as an actorc spec — the migrated second
family.

The port's copy of ``madsim_tpu/actorc/families/pb.py``: the same spec
text, with the observations in torch. The JAX module's docstring follows.

A 1:1 transliteration of the formerly hand-written
:mod:`madsim_tpu.engine.pb_actor` merged handler: a view-based
primary-backup log (VR/chain-replication style) — the primary of view v
is node ``v % n``; the primary replicates client writes to every backup
and commits an entry once EVERY replica acked it. Backups that miss the
primary's heartbeat long enough start a view change. There is
deliberately no retransmission or log repair: safety is the subject
under test, not liveness. The durability invariant (every entry ever
reported committed must exist in the current primary's log) is the bug
flag; ``buggy_commit_early`` commits after the FIRST ack — a fault
schedule that kills the primary mid-window then loses a committed write
at failover.

Restart semantics exercise the DSL's disk-vs-memory annotations: log,
commit index, view and epoch are durable; the ack bookkeeping is
``durable=False`` (auto-reset), and the ``on_restart`` hook bumps the
watchdog epoch and re-arms the watchdog timer with a fresh random
delay. Trajectories are bit-identical to the retired hand-written
actor; tests/test_pb_actor.py runs unchanged against this build.
"""
from __future__ import annotations

from ..spec import ActorSpec, Lane, Message, Word

I16 = 32767


def pb_spec(pcfg) -> ActorSpec:
    """Build the primary-backup spec from a
    :class:`~madsim_tpu_torch.engine.pb_actor.PBDeviceConfig`."""
    p = pcfg
    n, L = p.n, p.log_cap

    lanes = (
        # view/log_len/wd_epoch stop short of the int16 rail: their
        # transitions bump by +1 (or +n for the view-change candidate),
        # and speclint's capacity proof (SPC030) demands the bumped
        # value still fit the packed lane the declaration selects.
        Lane("view", hi=32000),                    # current view per node
        Lane("log_len", hi=32000),
        Lane("log_cmd", hi=I16, scope="node_table", cols=L),
        Lane("commit", hi=I16),                    # known-committed index
        Lane("acks", hi=(1 << 31) - 1, scope="node_table", cols=L,
             kind="bitmask", durable=False),       # volatile bookkeeping
        Lane("wd_epoch", hi=32000),                # stale-watchdog guard
        Lane("committed_cmd", hi=I16, scope="world_vec", cols=L),
        Lane("committed_max", hi=I16, scope="world"),
        Lane("views_changed", hi=(1 << 31) - 1, scope="world",
             kind="counter"),
        Lane("writes_done", hi=(1 << 31) - 1, scope="world",
             kind="counter"),
    )

    messages = (
        Message("Write", (Word("cmd", 0, I16),)),
        Message("Replicate", (Word("view", 0, I16), Word("idx", 0, I16),
                              Word("cmd", 0, I16))),
        Message("Ack", (Word("view", 0, I16), Word("idx", 0, I16),
                        Word("backup", 0, n - 1))),
        Message("Commit", (Word("view", 0, I16),
                           Word("commit_idx", 0, I16))),
        Message("Heartbeat", (Word("view", 0, I16),
                              Word("epoch", 0, I16)), timer=True),
        Message("Watchdog", (Word("view", 0, I16),
                             Word("epoch", 0, I16)), timer=True),
    )

    def primary_of(view):
        return view % n

    # -- transitions ---------------------------------------------------
    def h_write(c):
        """Client write (broadcast-scheduled; only the primary acts):
        append and replicate."""
        view_me = c.read("view")
        llen = c.read("log_len")
        accept = (c.me == primary_of(view_me)) & (llen < L)
        pos_w = c.clip(llen, 0, L - 1)
        llen_w = llen + c.where(accept, 1, 0)
        cmd = c.arg("cmd")
        c.write("log_len", llen_w, when=accept)
        c.write_at("log_cmd", pos_w, cmd, when=accept)
        c.write_at("acks", pos_w, 1 << c.me, when=accept)
        c.count("writes_done", when=accept)
        c.broadcast("Replicate", [view_me, llen_w, cmd], when=accept)

    def h_replicate(c):
        """Backup appends in order, adopts the view, re-arms the
        watchdog (Replicate doubles as the heartbeat carrier)."""
        view_me = c.read("view")
        llen = c.read("log_len")
        epoch_me = c.read("wd_epoch")
        v_rep, idx_rep, cmd_rep = c.arg("view"), c.arg("idx"), c.arg("cmd")
        current = v_rep >= view_me
        view_rep = c.maximum(view_me, v_rep)
        in_order = current & (idx_rep == llen + 1) & (idx_rep <= L)
        pos_r = c.clip(idx_rep - 1, 0, L - 1)
        epoch2 = epoch_me + c.where(current, 1, 0)
        c.write("view", view_rep)
        c.write_at("log_cmd", pos_r, cmd_rep, when=in_order)
        c.write("log_len", idx_rep, when=in_order)
        c.write("wd_epoch", epoch2)
        c.send("Ack", dst=primary_of(view_rep),
               words=[view_rep, idx_rep, c.me], when=in_order)
        c.arm("Watchdog", delay=c.uniform(p.watchdog_min_us,
                                          p.watchdog_max_us),
              words=[view_rep, epoch2], when=current)

    def h_ack(c):
        """Primary counts acks; commit on quorum (ALL replicas — or,
        under the injected bug, any two)."""
        view_me = c.read("view")
        commit_me = c.read("commit")
        live = (c.arg("view") == view_me) & \
            (c.me == primary_of(view_me)) & \
            (c.arg("idx") >= 1) & (c.arg("idx") <= L)
        pos_a = c.clip(c.arg("idx") - 1, 0, L - 1)
        backup = c.clip(c.arg("backup"), 0, n - 1)
        acks2 = c.read_at("acks", pos_a) | c.where(live, 1 << backup, 0)
        if p.buggy_commit_early:
            # THE BUG: one ack is "enough". A fault schedule that kills
            # the primary before the rest replicate loses the entry.
            quorum = c.popcount(acks2) >= 2
        else:
            quorum = acks2 == (1 << n) - 1
        committed = live & quorum & (c.arg("idx") > commit_me)
        commit_a = c.where(committed, c.arg("idx"), commit_me)
        krange = c.arange(L)
        fill = committed & (krange >= commit_me) & (krange < c.arg("idx"))
        c.write_at("acks", pos_a, acks2)
        c.write("commit", commit_a)
        c.write_vec("committed_cmd", c.read_row("log_cmd"), when=fill)
        c.write_scalar("committed_max",
                       c.maximum(c.read_scalar("committed_max"),
                                 c.where(committed, c.arg("idx"), 0)))
        c.broadcast("Commit", [view_me, commit_a], when=committed)

    def h_commit(c):
        """Backup adopts the commit index (capped at its log length)."""
        view_me = c.read("view")
        llen = c.read("log_len")
        commit_me = c.read("commit")
        cm_current = c.arg("view") >= view_me
        c.write("commit", c.where(
            cm_current,
            c.maximum(commit_me, c.minimum(c.arg("commit_idx"), llen)),
            commit_me))

    def h_heartbeat(c):
        """Primary's liveness beacon: an idx-0 Replicate every
        heartbeat interval (backups adopt the view + re-arm watchdogs
        through h_replicate)."""
        view_me = c.read("view")
        live = (c.arg("view") == view_me) & (c.me == primary_of(view_me))
        c.broadcast("Replicate", [view_me, 0, 0], when=live)
        c.arm("Heartbeat", delay=p.heartbeat_us, words=[view_me, 0],
              when=live)

    def h_watchdog(c):
        """Primary-silence detector: a backup whose watchdog epoch is
        still current starts the next view that makes IT primary."""
        view_me = c.read("view")
        epoch_me = c.read("wd_epoch")
        epoch_ok = c.arg("epoch") == epoch_me
        fire = epoch_ok & ~(c.arg("view") < view_me) & \
            ~(c.me == primary_of(view_me))
        cand = view_me + ((c.me - primary_of(view_me)) % n + n) % n
        view_wd = c.where(fire, c.maximum(cand, view_me + 1), view_me)
        became_primary = fire & (c.me == primary_of(view_wd))
        epoch2 = epoch_me + c.where(fire, 1, 0)
        delay = c.uniform(p.watchdog_min_us, p.watchdog_max_us)
        c.write("view", view_wd)
        c.write("wd_epoch", epoch2)
        c.count("views_changed", when=fire)
        c.broadcast("Replicate", [view_wd, 0, 0], when=became_primary)
        c.arm("Watchdog", delay=delay, words=[view_wd, epoch2],
              when=epoch_ok & ~became_primary)
        c.arm("Heartbeat", delay=p.heartbeat_us, words=[view_wd, epoch2],
              when=became_primary)

    # -- init / restart / invariant / observe --------------------------
    def init(c):
        # Primary of view 0 (node 0) heartbeats; backups watch.
        c.event("Heartbeat", time=p.heartbeat_us, dst=0, words=[0, 0])
        for i in range(1, n):
            c.event("Watchdog", time=c.uniform(p.watchdog_min_us,
                                               p.watchdog_max_us),
                    dst=i, words=[0, 0])
        for w in range(p.n_writes):
            t = p.write_start_us + w * p.write_interval_us
            for i in range(n):  # broadcast; only the current primary acts
                c.event("Write", time=t, dst=i, words=[w + 1])

    def on_restart(c):
        """Log, commit and view are persistent (disk); the ack
        bookkeeping lane is declared volatile (auto-reset before this
        hook). Bump the epoch so pending watchdogs go stale, re-arm."""
        epoch2 = c.read("wd_epoch") + 1
        c.write("wd_epoch", epoch2)
        c.arm("Watchdog", delay=c.uniform(p.watchdog_min_us,
                                          p.watchdog_max_us),
              words=[c.read("view"), epoch2])

    def invariant(v):
        """Durability: the current primary's log must contain every
        entry ever reported committed, verbatim."""
        view = v.lane("view")
        primary = v.np.max(view) % n
        k = v.np.arange(L)
        mask = k < v.lane("committed_max")
        plog = v.sel("log_cmd", primary)
        plen = v.sel("log_len", primary)
        return v.np.any(mask & ((k >= plen)
                                | (plog != v.lane("committed_cmd"))))

    def obs(name, red):
        def fn(o):
            import torch

            return getattr(torch, red)(o.raw(name), dim=-1) if red \
                else o.raw(name)
        return fn

    return ActorSpec(
        name="pb",
        n_nodes=n,
        lanes=lanes,
        messages=messages,
        handlers={"Write": h_write, "Replicate": h_replicate,
                  "Ack": h_ack, "Commit": h_commit,
                  "Heartbeat": h_heartbeat, "Watchdog": h_watchdog},
        init=init,
        on_restart=on_restart,
        invariant=invariant,
        observe={"max_view": obs("view", "amax"),
                 "committed_max": obs("committed_max", None),
                 "min_commit": obs("commit", "amin")},
        invariant_id="pb_durability",
        terminal=("Commit",),
    )
