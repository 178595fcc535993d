"""Seed-range leases: the unit of work distribution in the fleet fabric.

The coordinator splits the seed vector into contiguous ranges and hands
them to workers as *leases with expiry*: a worker must heartbeat a lease
to keep it, and a lease whose expiry passes (worker crashed, heartbeats
dropped, host preempted without a release) silently returns to the
pending queue for re-issue to a surviving worker. Because every range's
sweep is bit-deterministic from its seeds (PAPER.md; the engine's core
contract), re-issuing a lease whose original holder is secretly still
running is *harmless*: whichever completion arrives second is resolved
by asserting bitwise equality against the first (fleet/merge.py), which
turns accidental redundancy into a free cross-execution determinism
check — the FoundationDB move of making recovery a replay, not a repair.

Time here is the *fabric clock* (fleet/rpc.py): integer ticks under the
deterministic inline fabric, monotonic seconds under real processes.
Nothing in this module reads a clock itself — callers pass ``now`` — so
the lease state machine is a pure, directly testable object.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple


class LeaseError(RuntimeError):
    """Protocol violation at the lease table (not a transport failure)."""


@dataclasses.dataclass(frozen=True)
class SeedRange:
    """A contiguous slice [lo, hi) of the fleet's global seed vector.

    ``lo``/``hi`` are *positions* in the seed vector (the same ids the
    sweep's slot→seed index and the coverage ledger's ``first_seen_seed``
    use), not seed values — so range-local results re-base into the
    global result by adding ``lo``.
    """

    range_id: int
    lo: int
    hi: int

    @property
    def n_seeds(self) -> int:
        return self.hi - self.lo


@dataclasses.dataclass
class Lease:
    """One issued lease: a range, its current holder, and its deadline.

    ``generation`` counts issues of the range (0 = first issue); a
    heartbeat or completion carrying a stale generation belongs to a
    holder the table already declared dead — it is refused (heartbeat)
    or resolved as a duplicate (completion), never allowed to extend a
    lease it no longer owns. ``checkpoint`` is the resume artifact a
    preempted holder released (or a crashed holder left on shared
    storage): it rides the lease so the NEXT holder continues from it
    instead of replaying the range from step zero.
    """

    lease_id: int
    range: SeedRange
    worker_id: str
    generation: int
    issued_at: float
    expires_at: float
    checkpoint: Optional[str] = None
    progress: Dict[str, object] = dataclasses.field(default_factory=dict)
    # Liveness bookkeeping for stall diagnostics (FleetStalledError
    # names the holder and its last beat): count + clock time of the
    # most recent accepted heartbeat (-1.0 = never beat).
    heartbeats: int = 0
    last_heartbeat: float = -1.0
    # Acquire-ahead marker: True when this lease was issued beyond the
    # first slot of a multi-lease acquire (lease prefetch) — the holder
    # is NOT running it yet, it is queued behind the holder's running
    # lease. Stall diagnostics must say so, or a prefetched lease reads
    # as a hung sweep.
    prefetched: bool = False


def split_ranges(n_seeds: int, range_size: int) -> List[SeedRange]:
    """Cut the seed vector into contiguous ranges of ``range_size``.

    The split depends ONLY on (n_seeds, range_size) — never on worker
    count, chaos, or timing — so the set of per-range sweeps (and
    therefore the merged result) is the same for every fabric shape.
    """
    if range_size < 1:
        raise ValueError("range_size must be >= 1")
    return [SeedRange(i, lo, min(lo + range_size, n_seeds))
            for i, lo in enumerate(range(0, n_seeds, range_size))]


class LeaseTable:
    """The coordinator's lease bookkeeping: pending queue + live leases.

    Deterministic by construction: ranges issue in range-id order, an
    expired range re-queues at the back, and every mutation is driven by
    an explicit ``now`` from the caller. The table never touches results
    — completion bookkeeping lives in the coordinator, which also owns
    the duplicate crosscheck.
    """

    def __init__(self, ranges: List[SeedRange], ttl: float):
        if ttl <= 0:
            raise ValueError("lease ttl must be > 0")
        self.ttl = ttl
        self._ranges = {r.range_id: r for r in ranges}
        self._pending: List[int] = [r.range_id for r in ranges]
        self._live: Dict[int, Lease] = {}          # lease_id -> Lease
        self._by_range: Dict[int, int] = {}        # range_id -> lease_id
        self._generation: Dict[int, int] = {r.range_id: -1 for r in ranges}
        self._checkpoint: Dict[int, str] = {}      # range_id -> resume path
        self._next_lease_id = 0
        self._done: Dict[int, bool] = {r.range_id: False for r in ranges}

    # -- queries ---------------------------------------------------------
    @property
    def n_pending(self) -> int:
        return len(self._pending)

    @property
    def n_live(self) -> int:
        return len(self._live)

    def outstanding(self) -> List[int]:
        """Range ids not yet completed (pending or leased)."""
        return [rid for rid, done in self._done.items() if not done]

    def live_leases(self) -> List[Lease]:
        return list(self._live.values())

    # -- mutations (all take explicit ``now``) ---------------------------
    def expire(self, now: float) -> List[Lease]:
        """Reap leases whose deadline passed; their ranges re-queue.

        Returns the reaped leases so the coordinator can emit telemetry
        (lease_expired + re-lease records) — the table itself stays
        silent.
        """
        reaped = []
        for lease_id in sorted(self._live):
            lease = self._live[lease_id]
            if lease.expires_at <= now:
                reaped.append(lease)
        for lease in reaped:
            del self._live[lease.lease_id]
            del self._by_range[lease.range.range_id]
            if lease.checkpoint is not None:
                self._checkpoint[lease.range.range_id] = lease.checkpoint
            if not self._done[lease.range.range_id]:
                self._pending.append(lease.range.range_id)
        return reaped

    def issue(self, worker_id: str, now: float,
              eligible=None) -> Optional[Lease]:
        """Issue the next pending range to ``worker_id`` (None if all
        ranges are leased or done). ``eligible`` (optional predicate on
        range ids) gates which pending ranges may issue — the corpus
        exchange's epoch barrier (fleet/exchange.py) holds back ranges
        whose seed corpus has not merged yet; the FIRST eligible pending
        range issues, preserving range-id-major order within an epoch."""
        if not self._pending:
            return None
        pos = 0
        if eligible is not None:
            pos = next((i for i, rid in enumerate(self._pending)
                        if eligible(rid)), None)
            if pos is None:
                return None
        rid = self._pending.pop(pos)
        self._generation[rid] += 1
        lease = Lease(
            lease_id=self._next_lease_id,
            range=self._ranges[rid],
            worker_id=worker_id,
            generation=self._generation[rid],
            issued_at=now,
            expires_at=now + self.ttl,
            checkpoint=self._checkpoint.get(rid),
        )
        self._next_lease_id += 1
        self._live[lease.lease_id] = lease
        self._by_range[rid] = lease.lease_id
        return lease

    def heartbeat(self, lease_id: int, worker_id: str, now: float,
                  progress: Optional[Dict[str, object]] = None) -> bool:
        """Extend a lease's deadline. False = the lease is lost (expired
        and reaped, superseded by a re-issue, or never existed) — the
        caller must stop working on it."""
        lease = self._live.get(lease_id)
        if lease is None or lease.worker_id != worker_id:
            return False
        lease.expires_at = now + self.ttl
        lease.heartbeats += 1
        lease.last_heartbeat = now
        if progress:
            lease.progress.update(progress)
        return True

    def release(self, lease_id: int, worker_id: str,
                checkpoint: Optional[str] = None) -> bool:
        """Voluntary give-back (SIGTERM preemption): the range re-queues
        immediately — no expiry wait — carrying ``checkpoint`` so the
        next holder resumes instead of replaying."""
        lease = self._live.get(lease_id)
        if lease is None or lease.worker_id != worker_id:
            return False
        del self._live[lease_id]
        del self._by_range[lease.range.range_id]
        if checkpoint is not None:
            self._checkpoint[lease.range.range_id] = checkpoint
        if not self._done[lease.range.range_id]:
            self._pending.append(lease.range.range_id)
        return True

    def complete(self, range_id: int,
                 lease_id: Optional[int] = None) -> Tuple[bool, bool]:
        """Mark a range done. Returns ``(first, was_live)``: ``first`` is
        False for a duplicate completion (range already done — the
        coordinator crosschecks the payloads), ``was_live`` True when a
        live lease was retired by this completion.

        Completions are accepted even from expired/superseded leases:
        the data is valid regardless of who computed it — determinism is
        the authenticator, and the crosscheck enforces it.
        """
        first = not self._done[range_id]
        self._done[range_id] = True
        was_live = False
        live_id = self._by_range.get(range_id)
        if live_id is not None:
            # Any completion retires the range's live lease — including a
            # completion from the ORIGINAL holder of a re-issued range
            # (the new holder's eventual completion resolves as a
            # crosschecked duplicate).
            del self._live[live_id]
            del self._by_range[range_id]
            was_live = True
        if first and range_id in self._pending:
            # Completed by a holder the table had given up on while the
            # range sat re-queued: drop the stale queue entry so nobody
            # re-runs work that is already done.
            self._pending.remove(range_id)
        self._checkpoint.pop(range_id, None)
        return first, was_live

    def checkpoint_for(self, range_id: int) -> Optional[str]:
        return self._checkpoint.get(range_id)

    def lease_for_range(self, range_id: int) -> Optional[Lease]:
        """The live lease currently holding ``range_id`` (None when the
        range is pending or done) — stall diagnostics."""
        lease_id = self._by_range.get(range_id)
        return None if lease_id is None else self._live.get(lease_id)
