"""The fleet worker: acquire leases, sweep them, heartbeat, report.

A worker is a thin loop around the pipelined ``sweep()``: one lease =
one sweep over the leased seed slice, run to completion with the same
engine, mesh, and sweep knobs every other worker uses (that uniformity
is what the merge layer's bitwise contract rides on). Heartbeats piggy-
back on the sweep's own telemetry cadence — the ``observe=`` callback
fires once per host scalar read, so lease liveness costs ZERO extra
device syncs — and the heartbeat boundary doubles as the fabric's
preemption point: chaos kills, SIGTERM preemption, and lease-lost
aborts all land there, between supersteps, where the sweep's own
exception path already flushes the async checkpoint writer.

Fabric cost model (docs/fleet.md): three disciplines keep the per-lease
fabric tax ~O(1) instead of O(fresh sweep):

- **Persistent sweep session** — the worker holds ONE
  :class:`~madsim_tpu_torch.parallel.sweep.SweepSession` across leases,
  so per-lease device init and host setup are paid once per worker, not
  once per lease.
- **Lease prefetch** — ``prefetch=k`` acquires up to ``1+k`` leases in
  a single RPC turn (the coordinator's acquire-ahead path, barrier-
  checked at install time). Prefetched plain leases of the same
  schedule run GROUPED through ``SweepSession.run_group`` — one
  standing device batch at the width the engine is efficient at, split
  back into per-range results that are bit-identical to solo sweeps.
  Checkpointed / exchange / search leases always run solo (their
  per-lease machinery is the contract), sequentially within the same
  quantum.
- **Coalesced control plane** — the corpus publish and the completion
  ride one batched RPC turn; grouped completions batch likewise. Chaos
  interposition stays per LOGICAL message (fleet/rpc.py), so kill /
  torn-publish / duplicate-completion schedules are unchanged.

Failure handling:

- **kill** (crash): the sweep aborts mid-flight, nothing is released;
  every held lease expires at the coordinator and re-issues. If the
  dead worker had checkpointed, the re-issued lease carries the path
  and the next holder resumes bit-exactly (crash recovery == resume).
- **SIGTERM preemption**: ``request_preemption()`` (wired to the signal
  by :func:`install_sigterm_handler`) makes the next heartbeat raise;
  the worker releases EVERY held lease — the running one with its
  checkpoint — and exits its quantum cleanly.
- **corrupt checkpoint** (torn file from a crashed writer): the
  hardened loader (engine/checkpoint.py) raises ``CheckpointError``;
  the worker deletes the file and re-runs the range fresh — losing only
  time, never correctness, because re-execution is deterministic.
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

import numpy as np

from ..engine.checkpoint import CheckpointError
from .chaos import DELAY, DROP, KILL, PREEMPT
from .rpc import RetryExhausted, RetryPolicy, call_with_retry


class WorkerKilled(BaseException):
    """Chaos crash: aborts the in-flight sweep at a heartbeat boundary.
    BaseException so no recovery handler inside the sweep path can
    accidentally swallow the 'crash'. (Python ``finally`` blocks still
    run — so an async checkpoint writer flushes its last COMPLETED
    snapshot, equivalent to dying just after a finished write; the
    torn-file crash is injected separately via
    ``ChaosConfig.tear_checkpoint_on_kill``.)"""


class LeasePreempted(Exception):
    """SIGTERM-style preemption: stop at the next heartbeat, release
    every held lease (the running one with its checkpoint), survive."""


class LeaseLost(Exception):
    """The coordinator declared a lease expired/superseded: abandon
    the range (someone else owns it now; determinism makes any late
    completion of ours a harmless crosschecked duplicate)."""


class Worker:
    """One fleet worker. ``run_once()`` is the scheduling quantum the
    fabric drives: acquire ``1 + prefetch`` leases, sweep them (grouped
    when the session can), report them.

    ``sweep_kwargs`` are the uniform per-lease sweep knobs
    (chunk_steps, superstep_max, recycle/batch_worlds, ...);
    ``checkpoint_dir`` enables per-lease checkpointing (preemption
    survival + crash recovery); ``checkpoint_every_chunks`` its cadence;
    ``prefetch`` the acquire-ahead depth (0 = one lease per quantum,
    the pre-session fabric behavior).
    """

    def __init__(self, worker_id: str, engine, seeds, transport, clock,
                 faults: Optional[np.ndarray] = None, mesh=None,
                 retry: Optional[RetryPolicy] = None,
                 chaos=None, emit=None,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every_chunks: int = 4,
                 sweep_kwargs: Optional[Dict[str, Any]] = None,
                 prefetch: int = 0):
        self.worker_id = worker_id
        self.engine = engine
        self.seeds = np.asarray(seeds, np.uint64)
        self.faults = faults
        self.mesh = mesh
        self.transport = transport
        self.clock = clock
        self.retry = retry or RetryPolicy()
        self.chaos = chaos
        self._emit = emit
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every_chunks = checkpoint_every_chunks
        self.sweep_kwargs = dict(sweep_kwargs or {})
        self.prefetch = max(0, int(prefetch))
        self.dead = False
        self.died_at: float = 0.0
        self.preempted = False
        self._preempt_requested = False
        self._lease: Optional[Dict[str, Any]] = None
        self._held: List[Dict[str, Any]] = []
        self._group_mode = False
        self._session = None
        self._delayed_progress: Optional[Dict[str, Any]] = None
        self._hb_count = 0
        self.stats = {"leases_run": 0, "completions": 0, "kills": 0,
                      "preemptions": 0, "leases_lost": 0,
                      "heartbeats_sent": 0, "heartbeats_dropped": 0,
                      "heartbeats_delayed": 0, "rpc_retries": 0,
                      "checkpoints_recovered": 0,
                      "checkpoints_discarded": 0,
                      "corpus_published": 0, "corpus_resent": 0,
                      "corpus_seeded": 0,
                      "leases_prefetched": 0, "grouped_leases": 0,
                      "acquire_s": 0.0, "sweep_s": 0.0}

    @staticmethod
    def _wall() -> float:
        # Phase-timing telemetry only (the fleet stats' acquire_s and
        # sweep_s);
        # never feeds a lease or sim decision.
        from time import perf_counter
        return perf_counter()  # detlint: allow[DET001]

    # -- preemption ------------------------------------------------------
    def request_preemption(self) -> None:
        """Ask the worker to stop at the next heartbeat, checkpoint, and
        release its leases (the SIGTERM handler's body; also callable
        directly, which is how the inline chaos harness models
        preemption)."""
        self._preempt_requested = True

    def install_sigterm_handler(self) -> None:
        """Route SIGTERM to :meth:`request_preemption` — for worker
        processes under a preempting scheduler (k8s, borg, spot VMs).
        Must run on the main thread of the worker process."""
        import signal

        signal.signal(signal.SIGTERM,
                      lambda _sig, _frm: self.request_preemption())

    def restart(self) -> None:
        """Revive after a kill/preemption (the fabric's restart path).
        All lease state was lost with the 'process'; the engine and its
        loaded kernel libraries survive because inline workers share the
        host process — a real restart would load them again, changing
        nothing about results. The sweep session's standing batch was
        already dropped when the dying sweep unwound."""
        self.dead = False
        self.preempted = False
        self._preempt_requested = False
        self._lease = None
        self._held = []
        self._group_mode = False
        self._delayed_progress = None

    # -- telemetry -------------------------------------------------------
    def emit(self, event: str, **fields) -> None:
        if self._emit is None:
            return
        rec = {"schema": "madsim.fleet.telemetry/1", "event": event,
               "t": self.clock.now(), "worker": self.worker_id}
        rec.update(fields)
        self._emit(rec)

    # -- RPC helpers (all retried with deterministic backoff) ------------
    def _call(self, method: str, **kw):
        def on_retry(attempt, delay, exc):
            self.stats["rpc_retries"] += 1
            self.emit("rpc_retry", method=method, attempt=attempt,
                      delay=round(float(delay), 3), error=str(exc))

        return call_with_retry(
            lambda: self.transport.call(method, self.worker_id, **kw),
            self.retry, self.clock, tag=f"{self.worker_id}:{method}",
            on_retry=on_retry)

    # -- the persistent sweep session ------------------------------------
    def session(self):
        """The worker's persistent :class:`SweepSession` (created on
        first use, held across leases — the point of the thing)."""
        if self._session is None:
            from ..parallel.sweep import SweepSession

            kw = {k: self.sweep_kwargs[k]
                  for k in SweepSession.GROUPABLE_KW
                  if k in self.sweep_kwargs}
            self._session = SweepSession(engine=self.engine,
                                         mesh=self.mesh, **kw)
        return self._session

    def _groupable(self, leases: List[Dict[str, Any]]) -> bool:
        """May these leases advance as ONE grouped device batch?
        Checkpointing, corpus exchange, and any sweep mode outside the
        session's grouped whitelist keep their per-lease machinery —
        those leases run solo, sequentially, within the quantum."""
        from ..parallel.sweep import SweepSession

        if len(leases) < 2 or self.checkpoint_dir is not None:
            return False
        if any(l.get("exchange_epoch") is not None for l in leases):
            return False
        return all(k in SweepSession.GROUPABLE_KW
                   for k in self.sweep_kwargs)

    # -- the scheduling quantum ------------------------------------------
    def run_once(self) -> bool:
        """Acquire + run + report up to ``1 + prefetch`` leases. Returns
        True if any work happened (False: idle — nothing pending, or
        acquire failed and will be retried next round)."""
        if self.dead:
            return False
        want = 1 + self.prefetch
        t0 = self._wall()
        try:
            if want == 1:
                lease = self._call("acquire")
                leases = [] if lease is None else [lease]
            else:
                resp = self._call("acquire", count=want)
                leases = list(resp.get("leases") or [])
        except RetryExhausted as exc:
            self.emit("acquire_abandoned", error=str(exc))
            return False
        finally:
            self.stats["acquire_s"] += self._wall() - t0
        if not leases:
            return False
        self.stats["leases_run"] += len(leases)
        self.stats["leases_prefetched"] += len(leases) - 1
        self._held = list(leases)
        try:
            if self._groupable(leases):
                self._run_group_quantum(leases)
            else:
                self._run_solo_quantum(leases)
        except WorkerKilled:
            self.dead = True
            self.died_at = self.clock.now()
            self.stats["kills"] += 1
            for lease in self._held:
                self.emit("worker_killed", lease_id=lease["lease_id"],
                          range_id=lease["range_id"])
                self._maybe_tear_checkpoint(lease)
            return True
        except LeasePreempted:
            for lease in self._held:
                ck = None
                if self._lease is not None and \
                        lease["lease_id"] == self._lease["lease_id"]:
                    ck = self._lease_checkpoint(lease)
                    ck = ck if ck and os.path.exists(ck) else None
                try:
                    self._call("release", lease_id=lease["lease_id"],
                               checkpoint=ck)
                except RetryExhausted:
                    pass  # expiry re-queues the range; ck rides the table
                self.emit("worker_preempted", lease_id=lease["lease_id"],
                          range_id=lease["range_id"], checkpoint=ck)
            self.dead = True
            self.preempted = True
            self.died_at = self.clock.now()
            self.stats["preemptions"] += 1
            return True
        finally:
            self._lease = None
            self._held = []
            self._group_mode = False
        return True

    def _run_group_quantum(self, leases: List[Dict[str, Any]]) -> None:
        """All held leases through ONE SweepSession.run_group batch,
        then one batched completion turn."""
        parts = []
        for lease in leases:
            lo, hi = lease["lo"], lease["hi"]
            faults = self.faults
            if faults is not None and np.asarray(faults).ndim == 3:
                faults = np.asarray(faults)[lo:hi]
            parts.append({"seeds": self.seeds[lo:hi], "faults": faults})
        self._group_mode = True
        self._lease = leases[0]
        self._hb_count = 0
        self.stats["grouped_leases"] += len(leases)
        t0 = self._wall()
        try:
            results = self.session().run_group(parts,
                                               observe=self._heartbeat)
        except LeaseLost:
            # Every lease in the group was declared lost mid-flight
            # (each already accounted by the heartbeat path): abandon
            # the batch; re-execution elsewhere reproduces the results.
            return
        finally:
            self.stats["sweep_s"] += self._wall() - t0
        self._lease = None
        # Complete EVERY range we computed — including any lease lost
        # mid-group: determinism makes a late completion a harmless
        # first-or-crosschecked duplicate, and it may beat the re-issue.
        msgs = [{"method": "complete", "lease_id": l["lease_id"],
                 "range_id": l["range_id"], "result": r}
                for l, r in zip(leases, results)]
        try:
            resps = self._call("batch", msgs=msgs)
            self.stats["completions"] += len(resps)
        except RetryExhausted as exc:
            for lease in leases:
                self.emit("complete_abandoned",
                          lease_id=lease["lease_id"],
                          range_id=lease["range_id"], error=str(exc))

    def _run_solo_quantum(self, leases: List[Dict[str, Any]]) -> None:
        """Each held lease through the full per-lease sweep (checkpoint
        / exchange / search machinery intact), sequentially."""
        for lease in leases:
            if not any(l["lease_id"] == lease["lease_id"]
                       for l in self._held):
                continue  # declared lost by an earlier heartbeat
            self._lease = lease
            t0 = self._wall()
            try:
                result = self._run_lease(lease)
            except LeaseLost:
                self.stats["leases_lost"] += 1
                self.emit("lease_lost", lease_id=lease["lease_id"],
                          range_id=lease["range_id"])
                self._drop_held(lease["lease_id"])
                self._lease = None
                continue
            finally:
                # NB: self._lease stays set on kill/preempt unwind —
                # run_once's handlers need to know WHICH lease was
                # running (its checkpoint rides the release).
                self.stats["sweep_s"] += self._wall() - t0
            self._lease = None
            self._report_lease(lease, result)
            self._drop_held(lease["lease_id"])

    def _drop_held(self, lease_id: int) -> None:
        self._held = [l for l in self._held
                      if l["lease_id"] != lease_id]

    # -- reporting (publish + complete, one coalesced turn) --------------
    def _report_lease(self, lease, result) -> None:
        """Report one solo lease: the corpus publish (exchange leases)
        and the completion ride ONE batched RPC turn — ordered publish
        first so the exchange barrier lifts with the quantum, with the
        coordinator's complete-time backstop unchanged behind it. A
        torn publish falls back to the solo re-send loop."""
        corpus = None
        msgs = []
        if lease.get("exchange_epoch") is not None and \
                getattr(result, "search", None) is not None:
            from .exchange import corpus_payload

            corpus = self._result_corpus(result)
            msgs.append({"method": "publish",
                         "range_id": lease["range_id"],
                         "snapshot": corpus_payload(corpus)})
        msgs.append({"method": "complete", "lease_id": lease["lease_id"],
                     "range_id": lease["range_id"], "result": result})
        try:
            resps = self._call("batch", msgs=msgs)
        except RetryExhausted as exc:
            # Abandon: the lease expires, the range re-issues, and the
            # re-execution (or our own retry on a later lease of the
            # same range) reproduces the identical result.
            self.emit("complete_abandoned", lease_id=lease["lease_id"],
                      range_id=lease["range_id"], error=str(exc))
            return
        if corpus is not None:
            presp = resps[0]
            if presp.get("torn"):
                self.stats["corpus_resent"] += 1
                self._publish_corpus(lease, corpus, first_attempt=1)
            else:
                self.stats["corpus_published"] += 1
                self.emit("corpus_published", range_id=lease["range_id"],
                          epoch=lease.get("exchange_epoch"),
                          duplicate=bool(presp.get("duplicate")),
                          resent=0)
        self.stats["completions"] += 1

    # -- lease execution -------------------------------------------------
    def _lease_checkpoint(self, lease) -> Optional[str]:
        if self.checkpoint_dir is None:
            return None
        return os.path.join(self.checkpoint_dir,
                            f"range_{lease['range_id']:05d}.npz")

    def _maybe_tear_checkpoint(self, lease) -> None:
        """Chaos follow-up to a kill: tear the dead worker's lease
        checkpoint, simulating a crash that corrupted the file (the
        pre-fsync failure mode) so the next holder exercises the
        corrupt-checkpoint recovery path."""
        if self.chaos is None or \
                not self.chaos.config.tear_checkpoint_on_kill:
            return
        ck = self._lease_checkpoint(lease)
        if ck and os.path.exists(ck):
            from .chaos import tear_file

            tear_file(ck)
            self.emit("checkpoint_torn", range_id=lease["range_id"],
                      path=ck)

    def _result_corpus(self, result):
        """The finished range's corpus snapshot (deterministic host
        data — every serialization of it is bitwise identical)."""
        from ..search.corpus import HostCorpus

        rep = result.search
        return HostCorpus(sched=rep.corpus_sched, sig=rep.corpus_sig,
                          score=rep.corpus_score,
                          filled=rep.corpus_filled,
                          entry=rep.corpus_entry,
                          depth=rep.corpus_depth)

    def _publish_corpus(self, lease, corpus, first_attempt: int = 0) -> None:
        """Solo re-send loop for a corpus publish whose coalesced first
        attempt came back TORN (payload failed the coordinator's
        checksum — chaos, or a real transport tearing bytes): re-send a
        fresh serialization; the dedupe layer absorbs any accidental
        double delivery."""
        from .exchange import corpus_payload

        for attempt in range(first_attempt, 4):
            try:
                resp = self._call("publish", range_id=lease["range_id"],
                                  snapshot=corpus_payload(corpus))
            except RetryExhausted as exc:
                # Abandon: the coordinator backstops from the completion
                # payload (or the range re-runs after expiry).
                self.emit("publish_abandoned",
                          range_id=lease["range_id"], error=str(exc))
                return
            if not resp.get("torn"):
                self.stats["corpus_published"] += 1
                self.emit("corpus_published", range_id=lease["range_id"],
                          epoch=lease.get("exchange_epoch"),
                          duplicate=bool(resp.get("duplicate")),
                          resent=attempt)
                return
            self.stats["corpus_resent"] += 1
        self.emit("publish_abandoned", range_id=lease["range_id"],
                  error="torn on every attempt")

    def _run_lease(self, lease) -> Any:
        lo, hi = lease["lo"], lease["hi"]
        seeds = self.seeds[lo:hi]
        faults = self.faults
        if faults is not None and np.asarray(faults).ndim == 3:
            faults = np.asarray(faults)[lo:hi]
        kwargs = dict(self.sweep_kwargs)
        if kwargs.get("search") is not None:
            # Lineage entry-id base (obs/lineage.py): this range's
            # corpus inserts are recorded under globally-unique entry
            # ids lo + position + 1, so the fleet-merged report
            # resolves cross-range ancestry — a pure id shift,
            # chaos-invariant like every other per-range input.
            kwargs["search_lin_base"] = lo
        if lease.get("exchange_gen0"):
            # Epoch stream offset: this range's sweep mutates on a
            # fresh generation-key family (exchange.GEN_STRIDE) so a
            # seeded epoch explores NEW children instead of redrawing
            # the mutations its seed corpus's epoch already tried.
            kwargs["search_gen0"] = lease["exchange_gen0"]
        if lease.get("corpus") is not None:
            # Exchange seeding: the lease carries the merged previous-
            # epoch corpus; verify the checksum (a torn broadcast must
            # not silently skew the hunt) and install it as the sweep's
            # seed corpus. Deterministic per range — a re-issued lease
            # carries the identical payload.
            from .exchange import payload_corpus

            kwargs["search_corpus"] = payload_corpus(lease["corpus"])
            self.stats["corpus_seeded"] += 1
        ck = self._lease_checkpoint(lease)
        if ck is not None:
            # resume=True: if a previous holder (crashed or preempted)
            # left a checkpoint at this range's path, continue from it
            # bit-exactly; otherwise start fresh and write our own.
            kwargs.update(checkpoint_path=lease.get("checkpoint") or ck,
                          checkpoint_every_chunks=self.checkpoint_every_chunks,
                          resume=True)
            if lease.get("checkpoint") and os.path.exists(lease["checkpoint"]):
                self.stats["checkpoints_recovered"] += 1
                self.emit("lease_resumed", range_id=lease["range_id"],
                          checkpoint=lease["checkpoint"])
        self._hb_count = 0
        run = lambda: self.session().run(  # noqa: E731
            seeds, faults=faults, observe=self._heartbeat, **kwargs)
        try:
            return run()
        except CheckpointError as exc:
            # Torn/corrupt resume artifact: discard and re-run fresh —
            # the loader's message names the path and this exact
            # recovery option. Deterministic re-execution means the
            # retry costs time, never correctness.
            self.stats["checkpoints_discarded"] += 1
            path = kwargs.get("checkpoint_path", ck)
            self.emit("checkpoint_corrupt", range_id=lease["range_id"],
                      path=path, error=str(exc).splitlines()[0])
            if path and os.path.exists(path):
                os.remove(path)
            return run()

    # -- the heartbeat boundary ------------------------------------------
    def _heartbeat(self, record: Dict[str, Any]) -> None:
        """sweep(observe=...) callback: one call per host scalar read.
        This is the fabric's preemption point — chaos and SIGTERM land
        here, between supersteps, where the sweep's exception path
        flushes the checkpoint writer before unwinding. One beat covers
        EVERY held lease (the running one and any prefetched behind it):
        liveness is a worker property, so the coalesced extension is the
        semantics, not an approximation."""
        if record.get("event") == "summary":
            return  # final sweep record, not a liveness beat
        if record.get("schema") not in (None, "madsim.sweep.telemetry/1"):
            # Search-telemetry records (obs/lineage.py) ride the same
            # observe sink but are refill-grain accounting, not scalar-
            # read beats: counting them would shift the heartbeat
            # numbering chaos kill/preempt schedules key on.
            return
        self._hb_count += 1
        self.clock.advance(1)
        action = (self.chaos.heartbeat_action(self.worker_id)
                  if self.chaos is not None else "ok")
        if action == KILL:
            raise WorkerKilled(self.worker_id)
        if action == PREEMPT or self._preempt_requested:
            raise LeasePreempted(self.worker_id)
        progress = {"seeds_done": record.get("seeds_done"),
                    "chunks": record.get("chunks"),
                    "n_active": record.get("n_active")}
        if action == DROP:
            self.stats["heartbeats_dropped"] += 1
            self.emit("heartbeat_dropped", lease_id=self._lease["lease_id"])
            return
        if action == DELAY:
            # Deferred, not lost: delivered before the NEXT beat — the
            # lease sees a late extension instead of a gap.
            self.stats["heartbeats_delayed"] += 1
            self._delayed_progress = progress
            return
        if self._delayed_progress is not None:
            self._send_heartbeat(self._delayed_progress)
            self._delayed_progress = None
        self._send_heartbeat(progress)

    def _send_heartbeat(self, progress: Dict[str, Any]) -> None:
        held = self._held if self._held else (
            [self._lease] if self._lease is not None else [])
        if not held:
            return
        ids = [l["lease_id"] for l in held]
        kw = ({"lease_id": ids[0]} if len(ids) == 1
              else {"lease_ids": ids})
        try:
            resp = self._call("heartbeat", progress=progress, **kw)
        except RetryExhausted:
            # Transport down: keep sweeping — the lease may expire, in
            # which case a later beat (or the completion) learns it.
            return
        self.stats["heartbeats_sent"] += 1
        lost = resp.get("lost")
        if lost is None:
            lost = [] if resp.get("ok") else ids
        if not lost:
            return
        lost = set(lost)
        running_id = (self._lease["lease_id"]
                      if self._lease is not None else None)
        for lease in list(self._held):
            if lease["lease_id"] not in lost:
                continue
            if lease["lease_id"] == running_id and not self._group_mode:
                continue  # raised below — the solo queue accounts it
            self.stats["leases_lost"] += 1
            self.emit("lease_lost", lease_id=lease["lease_id"],
                      range_id=lease["range_id"])
            self._drop_held(lease["lease_id"])
        if running_id in lost and not self._group_mode:
            raise LeaseLost(running_id)
        if self._group_mode and not self._held:
            # Every lease of the group is gone: abandon the batch.
            raise LeaseLost(tuple(sorted(lost)))
