"""The fleet coordinator: lease issue/expiry/re-issue, completion dedup,
and per-worker fabric telemetry.

One coordinator owns one hunt: the global seed vector, the range split,
the lease table, and the accumulating per-range results. Its public
surface is the four ``rpc_*`` methods workers reach through a transport
(inline dispatch or a process pipe) — everything else is local state.
The coordinator never touches a device: results arrive as host-side
``SweepResult`` payloads, and the only "validation" it ever performs is
the one determinism makes possible — bitwise equality of independent
executions (fleet/merge.py).

Telemetry: every protocol event emits one
``madsim.fleet.telemetry/1`` record into the same observe-sink shape
the sweep observatory uses (callable or JSONL path; docs/fleet.md lists
the event vocabulary), so ``python -m madsim_tpu_torch.obs watch`` machinery
and operators get per-worker lease/retry/re-lease visibility without a
second pipeline.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from ..parallel.sweep import SweepResult
from .lease import LeaseTable, SeedRange, split_ranges
from .merge import crosscheck_duplicate, merge_range_results

FLEET_SCHEMA = "madsim.fleet.telemetry/1"


class Coordinator:
    """Lease-table owner + result accumulator for one fleet sweep.

    ``clock`` follows fleet/rpc.py (virtual ticks inline, monotonic
    seconds under processes); ``lease_ttl`` is in clock units. ``emit``
    is an optional telemetry callable (one dict per protocol event).
    """

    def __init__(self, seeds, range_size: int, lease_ttl: float, clock,
                 emit=None, n_devices: int = 1, exchange=None):
        self.seeds = np.asarray(seeds, np.uint64)
        self.ranges: List[SeedRange] = split_ranges(
            self.seeds.shape[0], range_size)
        self.table = LeaseTable(self.ranges, ttl=lease_ttl)
        self.clock = clock
        self.n_devices = n_devices
        self._emit = emit
        # Cross-range corpus exchange (fleet/exchange.py CorpusExchange,
        # or None): gates lease issue on the epoch barrier, delivers
        # seed corpora with leases, and accepts/dedupes snapshot
        # publishes.
        self.exchange = exchange
        self.results: Dict[int, SweepResult] = {}
        # worker_id -> why that worker's last acquire-ahead stopped
        # short of its requested count (exchange epoch barrier) — the
        # stall report's "prefetch blocked" line.
        self._prefetch_blocked: Dict[str, str] = {}
        self.merge_s = 0.0
        self.stats: Dict[str, int] = {
            "ranges": len(self.ranges),
            "leases_issued": 0,
            "leases_reissued": 0,
            "leases_expired": 0,
            "leases_released": 0,
            "heartbeats": 0,
            "heartbeats_lost": 0,
            "completions": 0,
            "duplicate_completions": 0,
            "duplicates_crosschecked": 0,
        }

    # -- telemetry -------------------------------------------------------
    def emit(self, event: str, **fields) -> None:
        if self._emit is None:
            return
        rec = {"schema": FLEET_SCHEMA, "event": event,
               "t": self.clock.now()}
        rec.update(fields)
        self._emit(rec)

    # -- the RPC surface -------------------------------------------------
    def rpc_acquire(self, worker_id: str, count: int = 1
                    ) -> Optional[Dict[str, Any]]:
        """Hand the next pending range(s) to ``worker_id``.

        ``count=1`` (the legacy wire shape): one lease dict, or None —
        nothing pending (all ranges leased out or done, or every pending
        range held back by the exchange's epoch barrier; idle and retry).

        ``count>1`` is the acquire-ahead path (lease prefetch): up to
        ``count`` leases issue in ONE control turn, returned as
        ``{"leases": [...]}``; every lease beyond the first is marked
        ``prefetched``. The exchange epoch barrier is enforced at
        INSTALL time — issuing stops at the first ineligible range, so a
        prefetched lease's seed corpus is always its epoch's final
        merged corpus, exactly as if it had been acquired after the
        barrier lifted; the barrier reason is remembered per worker for
        ``stall_report()``.

        Under an exchange each lease additionally carries the range's
        deterministic seed corpus (the merged previous-epoch corpus;
        None for epoch 0) — a re-issued lease for a killed worker's
        range gets the SAME corpus its first holder did, which is the
        bounded-loss contract."""
        self._reap()
        eligible = (self.exchange.eligible
                    if self.exchange is not None else None)
        now = self.clock.now()
        out_leases: List[Dict[str, Any]] = []
        for i in range(max(1, int(count))):
            lease = self.table.issue(worker_id, now, eligible=eligible)
            if lease is None:
                break
            lease.prefetched = i > 0
            self.stats["leases_issued"] += 1
            if lease.generation > 0:
                self.stats["leases_reissued"] += 1
            self.emit("lease_issued", worker=worker_id,
                      lease_id=lease.lease_id,
                      range_id=lease.range.range_id,
                      lo=lease.range.lo, hi=lease.range.hi,
                      generation=lease.generation,
                      reissued=lease.generation > 0,
                      prefetched=lease.prefetched,
                      resume_checkpoint=lease.checkpoint)
            out = {
                "lease_id": lease.lease_id,
                "range_id": lease.range.range_id,
                "lo": lease.range.lo,
                "hi": lease.range.hi,
                "generation": lease.generation,
                "expires_at": lease.expires_at,
                "checkpoint": lease.checkpoint,
                "prefetched": lease.prefetched,
            }
            if self.exchange is not None:
                rid = lease.range.range_id
                out["exchange_epoch"] = self.exchange.epoch_of(rid)
                out["exchange_gen0"] = self.exchange.gen0_of(rid)
                out["corpus"] = self.exchange.seed_payload(rid,
                                                          worker=worker_id)
            out_leases.append(out)
        # Remember why the acquire-ahead stopped short (stall_report's
        # "barrier reason" line): only meaningful under an exchange —
        # a plain fleet's short acquire just means the queue ran dry.
        self._prefetch_blocked.pop(worker_id, None)
        if (len(out_leases) < max(1, int(count))
                and self.exchange is not None):
            for rid in sorted(self.table.outstanding()):
                if self.table.lease_for_range(rid) is not None:
                    continue
                reason = self.exchange.blocked_reason(rid)
                if reason:
                    self._prefetch_blocked[worker_id] = (
                        f"range {rid}: {reason}")
                    break
        if count == 1:
            return out_leases[0] if out_leases else None
        return {"leases": out_leases}

    def rpc_heartbeat(self, worker_id: str, lease_id: Optional[int] = None,
                      progress: Optional[Dict[str, Any]] = None,
                      lease_ids: Optional[List[int]] = None
                      ) -> Dict[str, Any]:
        """Extend lease(s). One beat covers every lease the worker holds
        (``lease_ids`` — the coalesced control plane; ``lease_id`` is
        the legacy single-lease wire shape). ``ok`` is the conjunction;
        ``lost`` names the leases that are LOST (expired and possibly
        re-issued): the worker must abandon those ranges — the fabric
        guarantees someone (re-)runs them, and if the worker's own run
        completes anyway the dedup layer absorbs it."""
        self._reap()
        ids = list(lease_ids) if lease_ids is not None else [lease_id]
        now = self.clock.now()
        lost = [i for i in ids
                if not self.table.heartbeat(i, worker_id, now, progress)]
        ok = not lost
        self.stats["heartbeats" if ok else "heartbeats_lost"] += 1
        self.emit("heartbeat", worker=worker_id, lease_id=ids[0],
                  ok=ok, leases=len(ids), **(progress or {}))
        return {"ok": ok, "lost": lost}

    def rpc_batch(self, worker_id: str, msgs: List[Dict[str, Any]]
                  ) -> List[Dict[str, Any]]:
        """Server side of one coalesced control turn (the process
        transport delivers batches whole; the inline transport unpacks
        them itself so chaos can interpose per logical message).
        Messages dispatch in order — publish-before-complete keeps the
        exchange backstop semantics."""
        out = []
        for m in msgs:
            m = dict(m)
            method = m.pop("method")
            out.append(getattr(self, f"rpc_{method}")(
                worker_id=worker_id, **m))
        return out

    def rpc_release(self, worker_id: str, lease_id: int,
                    checkpoint: Optional[str] = None) -> Dict[str, Any]:
        """SIGTERM-preemption give-back: the range re-queues immediately,
        carrying the released checkpoint so its next holder resumes
        bit-exactly instead of replaying from step zero."""
        ok = self.table.release(lease_id, worker_id, checkpoint)
        if ok:
            self.stats["leases_released"] += 1
        self.emit("lease_released", worker=worker_id, lease_id=lease_id,
                  ok=ok, checkpoint=checkpoint)
        return {"ok": ok}

    def rpc_complete(self, worker_id: str, lease_id: int, range_id: int,
                     result: SweepResult) -> Dict[str, Any]:
        """Accept a range result. Duplicates (an expired lease's two
        holders both finishing, retransmitted completions) resolve by
        bitwise crosscheck against
        the accepted result — a mismatch raises FleetIntegrityError
        rather than silently picking a winner."""
        self._reap()
        first, _was_live = self.table.complete(range_id, lease_id)
        if first:
            self.results[range_id] = result
            self.stats["completions"] += 1
            if self.exchange is not None and \
                    not self.exchange.has(range_id):
                # Backstop publish: a worker that completed but whose
                # explicit publish was lost (crash between the two
                # RPCs, retry exhaustion) must not stall the epoch
                # barrier — the completion payload carries the same
                # final corpus, so the coordinator publishes it through
                # the identical dedupe/crosscheck path.
                self._publish_from_result(worker_id, range_id, result)
        else:
            self.stats["duplicate_completions"] += 1
            crosscheck_duplicate(range_id, self.results[range_id], result)
            self.stats["duplicates_crosschecked"] += 1
        self.emit("completion", worker=worker_id, lease_id=lease_id,
                  range_id=range_id, duplicate=not first,
                  crosschecked=not first,
                  n_seeds=int(np.asarray(result.seeds).shape[0]),
                  failing=len(result.failing_seeds))
        return {"accepted": True, "duplicate": not first}

    def rpc_publish(self, worker_id: str, range_id: int,
                    snapshot: Any) -> Dict[str, Any]:
        """Accept a range's corpus snapshot (cross-range exchange,
        fleet/exchange.py). Torn payloads are discarded and re-requested
        (``torn=True`` tells the sender to re-send); duplicates resolve
        by bitwise crosscheck — mismatch raises FleetIntegrityError."""
        if self.exchange is None:
            return {"accepted": False, "torn": False, "disabled": True}
        return self.exchange.publish(range_id, snapshot, worker=worker_id)

    def _publish_from_result(self, worker_id: str, range_id: int,
                             result: SweepResult) -> None:
        from ..search.corpus import HostCorpus
        from .exchange import corpus_payload

        rep = getattr(result, "search", None)
        if rep is None:
            return
        payload = corpus_payload(HostCorpus(
            sched=rep.corpus_sched, sig=rep.corpus_sig,
            score=rep.corpus_score, filled=rep.corpus_filled,
            entry=rep.corpus_entry, depth=rep.corpus_depth))
        self.exchange.publish(range_id, payload, worker=worker_id)

    def rpc_poll_done(self, worker_id: str) -> Dict[str, Any]:
        """Is the hunt over? Idle workers (acquire returned None because
        every pending range is leased to someone else) poll this to
        decide between waiting for a possible re-issue and exiting."""
        del worker_id
        return {"done": self.done()}

    # -- scheduler-side --------------------------------------------------
    def _reap(self) -> None:
        for lease in self.table.expire(self.clock.now()):
            self.stats["leases_expired"] += 1
            self.emit("lease_expired", worker=lease.worker_id,
                      lease_id=lease.lease_id,
                      range_id=lease.range.range_id,
                      generation=lease.generation,
                      had_checkpoint=lease.checkpoint is not None)

    def tick(self) -> None:
        """One scheduling round: reap expired leases even when no RPC
        arrives (a fleet whose only live worker is mid-sweep must still
        notice a dead peer's lease)."""
        self._reap()

    def done(self) -> bool:
        return len(self.results) == len(self.ranges)

    def stall_report(self) -> str:
        """One line per outstanding range, naming the holder, its lease
        generation, last accepted heartbeat, and deadline — or why a
        pending range cannot issue (exchange barrier). This is what
        FleetStalledError carries instead of a bare range count, so the
        post-mortem starts at the sick range, not at a grep."""
        now = self.clock.now()
        # A worker's RUNNING lease is its lowest live lease id; anything
        # above it marked prefetched is queued behind that run.
        running: Dict[str, int] = {}
        for lease in self.table.live_leases():
            cur = running.get(lease.worker_id)
            if cur is None or lease.lease_id < cur:
                running[lease.worker_id] = lease.lease_id
        lines: List[str] = []
        for rid in sorted(self.table.outstanding()):
            lease = self.table.lease_for_range(rid)
            if lease is not None:
                beat = ("never" if lease.last_heartbeat < 0
                        else f"t={lease.last_heartbeat:g}")
                role = ""
                if lease.prefetched and \
                        running.get(lease.worker_id) != lease.lease_id:
                    role = (f", prefetched behind lease "
                            f"{running[lease.worker_id]}")
                lines.append(
                    f"range {rid}: held by {lease.worker_id} (lease "
                    f"{lease.lease_id}, generation {lease.generation}, "
                    f"heartbeats {lease.heartbeats}, last heartbeat "
                    f"{beat}, expires t={lease.expires_at:g}{role})")
                continue
            blocked = (self.exchange.blocked_reason(rid)
                       if self.exchange is not None else None)
            lines.append(f"range {rid}: pending"
                         + (f", {blocked}" if blocked else " re-issue"))
        for wid in sorted(self._prefetch_blocked):
            lines.append(f"worker {wid}: prefetch blocked at epoch "
                         f"barrier ({self._prefetch_blocked[wid]})")
        return (f"outstanding ranges at t={now:g}:\n  "
                + "\n  ".join(lines)) if lines else "no outstanding ranges"

    def finalize(self, fleet_stats: Optional[Dict[str, Any]] = None
                 ) -> SweepResult:
        """Merge all range results into the fleet SweepResult and emit
        the summary telemetry record. Under an exchange the result also
        carries the fleet-level ``search`` report: the final merged
        corpus plus the per-seed materialized schedules."""
        import time as _walltime

        stats = dict(self.stats)
        if self.exchange is not None:
            stats.update(self.exchange.stats)
        stats.update(fleet_stats or {})
        # Merge-phase wall timing for the fabric's cost breakdown; it never
        # feeds a simulation decision.
        t0 = _walltime.perf_counter()
        result = merge_range_results(self.seeds, self.ranges, self.results,
                                     self.n_devices, fleet_stats=stats)
        self.merge_s = _walltime.perf_counter() - t0
        stats["merge_s"] = round(self.merge_s, 6)
        result.loop_stats["fleet"]["merge_s"] = stats["merge_s"]
        if self.exchange is not None:
            result.search = self.exchange.fleet_report(
                int(self.seeds.shape[0]), self.ranges, self.results)
        self.emit("fleet_summary", seeds_total=int(self.seeds.shape[0]),
                  failing=len(result.failing_seeds), **stats)
        return result
