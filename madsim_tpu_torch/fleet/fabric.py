"""The fleet fabric: deterministic scheduling of coordinator + workers.

``fleet_sweep()`` is the one-call entry point — the fleet counterpart
of ``parallel.sweep.sweep()`` — and :class:`LocalFabric` is the engine
behind its default ``spawn="inline"`` mode: a single-threaded, round-
robin scheduler that runs every worker's quantum in a fixed order on a
virtual tick clock. No threads, no wall clock, no OS scheduler — which
is exactly why the chaos matrix can be tier-1: a fabric execution is a
pure function of (seeds, config, ChaosConfig), replayable like a seed.

The inline fabric is not a toy: workers run REAL pipelined device
sweeps over their leases (sharing one engine and one mesh, the 2-D
``multihost_mesh`` included: on CUDA every lease launches the
hand-written step kernel, once per block of the split batch, and every
guided refill the corpus fold kernel once), the coordinator runs the REAL
lease
protocol, and every failure mode (kill, expiry, re-issue, duplicate,
preemption, torn checkpoint, RPC retry) takes the same code path a
multiprocess fleet takes. ``spawn="process"`` (fleet/process.py) swaps
the scheduler for real OS processes + pipes + signals, changing the
clock and the transport but not one line of protocol.
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

import numpy as np

from ..obs import observatory as _obsy
from ..parallel.sweep import SweepResult
from .chaos import ChaosConfig, ChaosPolicy
from .coordinator import Coordinator
from .lease import split_ranges
from .rpc import InlineTransport, RetryPolicy, VirtualClock
from .worker import Worker


class FleetStalledError(RuntimeError):
    """The fabric cannot make progress: every worker is permanently dead
    (restarts disabled) or the scheduling round budget ran out with
    ranges still outstanding. The message carries the coordinator's
    per-range stall report — each stuck range with its holding worker,
    lease generation, last accepted heartbeat, and deadline (or the
    exchange-barrier reason a pending range cannot issue) — plus the
    fleet stats, so the post-mortem starts at the sick range."""


class LocalFabric:
    """Deterministic in-process fabric: round-robin worker quanta on a
    shared virtual clock, one tick per scheduling round (plus one per
    heartbeat inside the sweeps)."""

    def __init__(self, coordinator: Coordinator, workers: List[Worker],
                 clock: VirtualClock, chaos: Optional[ChaosPolicy] = None,
                 max_rounds: int = 100_000):
        self.coordinator = coordinator
        self.workers = workers
        self.clock = clock
        self.chaos = chaos
        self.max_rounds = max_rounds

    def run(self) -> SweepResult:
        rounds = 0
        while not self.coordinator.done():
            rounds += 1
            if rounds > self.max_rounds:
                raise FleetStalledError(
                    f"no convergence after {self.max_rounds} scheduling "
                    f"rounds; {self.coordinator.stall_report()}\n"
                    f"stats: {self.coordinator.stats}")
            alive = 0
            for w in self.workers:
                if w.dead:
                    if self.chaos is not None and self.chaos.restart_due(
                            w.died_at, self.clock.now()):
                        w.restart()
                        self.coordinator.emit(
                            "worker_restarted", worker=w.worker_id,
                            after_preemption=w.preempted)
                    continue
                alive += 1
                w.run_once()
            if alive == 0 and not (self.chaos is not None
                                   and self.chaos.restarts_enabled):
                raise FleetStalledError(
                    "all workers dead with restarts disabled; "
                    f"{self.coordinator.stall_report()}")
            # The scheduler's own tick: even an all-idle round moves
            # fabric time, so a dead worker's lease always expires and a
            # downed worker's restart timer always fires.
            self.clock.advance(1)
            self.coordinator.tick()
        stats = self._fleet_stats()
        return self.coordinator.finalize(fleet_stats=stats)

    def _fleet_stats(self) -> Dict[str, Any]:
        agg: Dict[str, Any] = {"n_workers": len(self.workers),
                               "fabric_ticks": int(self.clock.now()),
                               "spawn": "inline"}
        per_worker = {}
        for w in self.workers:
            per_worker[w.worker_id] = dict(w.stats)
        agg["workers"] = per_worker
        for key in ("kills", "preemptions", "rpc_retries",
                    "heartbeats_dropped", "checkpoints_recovered",
                    "checkpoints_discarded", "leases_prefetched",
                    "grouped_leases", "leases_lost"):
            agg[key] = sum(w.stats[key] for w in self.workers)
        for key in ("acquire_s", "sweep_s"):
            agg[key] = round(sum(w.stats[key] for w in self.workers), 6)
        # Session reuse: leases that rode an already-open SweepSession's
        # standing device slots instead of paying a fresh install.
        agg["session_reuse_hits"] = sum(
            w._session.reuse_hits for w in self.workers
            if w._session is not None)
        # Counted discipline (fleet/rpc.py MAX_CONTROL_RPCS_PER_LEASE):
        # transport turns per issued lease, heartbeats split out — the
        # coalesced control plane's "small constant" gate, measured.
        transport = self.workers[0].transport if self.workers else None
        if transport is not None and hasattr(transport, "calls"):
            calls = dict(transport.calls)
            agg["rpc_turns"] = calls
            total = sum(calls.values())
            control = total - calls.get("heartbeat", 0)
            issued = max(1, self.coordinator.stats["leases_issued"])
            agg["rpcs_per_lease"] = round(total / issued, 3)
            agg["control_rpcs_per_lease"] = round(control / issued, 3)
        return agg


def fleet_sweep(actor: Any, cfg, seeds, *,
                n_workers: int = 2,
                range_size: Optional[int] = None,
                faults: Optional[np.ndarray] = None,
                mesh=None,
                engine=None,
                lease_ttl: float = 8.0,
                chaos: Optional[ChaosConfig] = None,
                observe: Any = None,
                checkpoint_dir: Optional[str] = None,
                checkpoint_every_chunks: int = 4,
                retry: Optional[RetryPolicy] = None,
                max_rounds: int = 100_000,
                spawn: str = "inline",
                exchange: Any = None,
                prefetch: Optional[int] = None,
                device: Any = None,
                **sweep_kwargs) -> SweepResult:
    """Distribute a seed sweep over a resilient coordinator/worker fleet.

    The fleet analog of :func:`madsim_tpu_torch.parallel.sweep.sweep`: the
    seed vector splits into contiguous ranges (``range_size``; default
    two ranges per worker), a coordinator leases ranges to ``n_workers``
    workers with expiry ``lease_ttl`` (fabric clock units), each worker
    runs the leased slice through the pipelined ``sweep()`` (all
    ``sweep_kwargs`` — chunk_steps, recycle/batch_worlds, superstep_max
    — pass through uniformly), and completed ranges merge into one
    ``SweepResult``.

    The resilience contract (tests/test_torch_fleet.py): with ANY
    ``chaos`` mix of worker kills, lease expiries, duplicated
    completions, preemptions, and torn checkpoints, the merged result's
    seed ids, bug flags, per-seed observations/metrics, and coverage
    ledger are bitwise identical to a crash-free fleet's AND to a
    single-host ``sweep()`` over the same seeds — crashes cost wall
    time, never results. Double-reported ranges are resolved by
    asserting bitwise equality (:mod:`madsim_tpu_torch.fleet.merge`), so
    redundancy doubles as a cross-execution determinism check.

    ``checkpoint_dir`` enables per-lease checkpointing: preempted
    workers (SIGTERM → checkpoint + lease release) and crashed workers
    leave resumable snapshots the range's next holder continues from
    bit-exactly. ``observe`` receives the fleet telemetry stream
    (``madsim.fleet.telemetry/1`` records — lease/heartbeat/retry/
    re-lease/completion events; a path writes JSONL beside the sweep
    observatory's format, docs/fleet.md).

    ``spawn="inline"`` (default): deterministic single-threaded fabric,
    workers sharing ``engine`` (built as ``DeviceEngine(actor, cfg,
    device=device)`` when not given: CUDA unless ``device`` says
    otherwise). ``spawn="process"`` runs workers as OS processes started
    with ``spawn`` (CUDA needs it), each building its own engine on
    ``device`` (default CUDA) and loading the kernel libraries the parent
    built, with pipe transports and real SIGTERM preemption
    (fleet/process.py) — the deployment shape, minus the determinism of
    the scheduler (results are still bitwise identical; schedules are
    not). ``mesh`` (``parallel/mesh.py``) splits every worker's sweeps
    over its devices, as ``sweep(mesh=...)`` does; by default they run on
    the engine's device. The process fabric runs each worker on one
    device, as in the JAX package.

    ``exchange``: an :class:`~madsim_tpu_torch.fleet.exchange.ExchangeConfig`
    — cross-range corpus exchange for guided fleets (requires
    ``search=SearchConfig(...)`` in the sweep kwargs; docs/fleet.md
    "Corpus exchange"). Ranges partition into exchange epochs by range
    id (``exchange.every`` per epoch; default one epoch per worker
    round); each epoch's ranges seed their sweeps from the merged
    corpus of the previous epoch, published snapshots dedupe by range
    with bitwise crosscheck, torn publishes are discarded and re-sent,
    and the merged corpus persists at ``exchange.state_path`` (default
    ``<checkpoint_dir>/exchange_state.npz`` when checkpointing) for
    coordinator crash→resume. Results are bitwise deterministic per
    (seeds, partitioning, exchange cadence, SearchConfig) — chaos
    cannot move them — and the merged result's ``search`` carries the
    final fleet corpus plus the per-seed materialized schedules.
    Inline fabric only.

    ``prefetch``: acquire-ahead depth — each worker acquires up to
    ``1 + prefetch`` leases per control turn, overlapping the next
    lease's acquisition with the current sweep. Default (None): each
    worker's fair share of the range count, so a whole fleet costs ONE
    acquire turn per worker. Prefetched plain leases of one schedule
    run grouped through the worker's persistent ``SweepSession`` (one
    standing device batch, split back into bit-identical per-range
    results); checkpointed / exchange / search leases run solo within
    the quantum. ``prefetch=0`` restores one-lease-per-quantum.
    """
    from ..engine.core import DeviceEngine

    seeds = np.asarray(seeds, np.uint64)
    n = int(seeds.shape[0])
    if n == 0:
        raise ValueError("fleet_sweep needs a non-empty seed vector")
    if n_workers < 1:
        raise ValueError("n_workers must be >= 1")
    if range_size is None:
        range_size = max(1, -(-n // (2 * n_workers)))
    if prefetch is None:
        # Acquire-ahead depth: enough for each worker's fair share of
        # ranges in ONE control turn (the lease-prefetch default). 0
        # restores one-lease-per-quantum (the pre-session fabric).
        n_ranges = -(-n // range_size)
        prefetch = max(0, -(-n_ranges // n_workers) - 1)
    prefetch = max(0, int(prefetch))
    if exchange is not None:
        scfg = sweep_kwargs.get("search")
        if scfg is None:
            raise ValueError(
                "exchange= needs search=SearchConfig(...): the corpus "
                "exchange shares guided-search progress across ranges — "
                "a plain fleet sweep has no corpus to exchange")
        if faults is None:
            raise ValueError(
                "exchange= needs the fault-schedule template (faults=): "
                "the merged corpora evolve within its fault vocabulary")
        if spawn != "inline":
            raise ValueError(
                "exchange= currently requires spawn='inline': the "
                "process fabric does not pipe corpus snapshots yet")
    if spawn == "process":
        from .process import process_fleet_sweep

        return process_fleet_sweep(
            actor, cfg, seeds, n_workers=n_workers, range_size=range_size,
            faults=faults, lease_ttl=lease_ttl, observe=observe,
            checkpoint_dir=checkpoint_dir,
            checkpoint_every_chunks=checkpoint_every_chunks,
            retry=retry, device=device, **sweep_kwargs)
    if spawn != "inline":
        raise ValueError(f"spawn must be 'inline' or 'process', "
                         f"got {spawn!r}")

    eng = (engine if engine is not None
           else DeviceEngine(actor, cfg, device=device))
    clock = VirtualClock()
    emit, close = _obsy.make_observer(observe)
    policy = ChaosPolicy(chaos) if chaos is not None else None
    exch = None
    if exchange is not None:
        from ..triage.shrink import normalize as _normalize_sched
        from .exchange import CorpusExchange

        scfg = sweep_kwargs["search"]
        faults_a = np.asarray(faults, np.int32)
        template = _normalize_sched(
            faults_a[0] if faults_a.ndim == 3 else faults_a)
        state_path = exchange.state_path
        if state_path is None and checkpoint_dir is not None:
            state_path = os.path.join(checkpoint_dir,
                                      "exchange_state.npz")
            os.makedirs(checkpoint_dir, exist_ok=True)
        exch = CorpusExchange(
            ranges=split_ranges(n, range_size),
            every=exchange.every if exchange.every is not None
            else n_workers,
            template=template, corpus_k=int(scfg.corpus),
            min_novelty=int(scfg.min_novelty), emit=emit, clock=clock,
            state_path=state_path)
        if state_path is not None and os.path.exists(state_path):
            # Coordinator crash→resume: reload the accepted snapshots
            # and re-derive the merged-epoch chain bit-exactly (the
            # merge is a deterministic fold of the persisted inputs).
            exch.resume(state_path)
    coordinator = Coordinator(seeds, range_size=range_size,
                              lease_ttl=lease_ttl, clock=clock, emit=emit,
                              n_devices=(1 if mesh is None
                                         else int(mesh.devices.size)),
                              exchange=exch)
    transport = InlineTransport(coordinator, chaos=policy)
    if checkpoint_dir is not None:
        os.makedirs(checkpoint_dir, exist_ok=True)
    retry = retry or RetryPolicy()
    workers = [
        Worker(f"w{i}", eng, seeds, transport, clock, faults=faults,
               mesh=mesh, retry=retry, chaos=policy, emit=emit,
               checkpoint_dir=checkpoint_dir,
               checkpoint_every_chunks=checkpoint_every_chunks,
               sweep_kwargs=sweep_kwargs, prefetch=prefetch)
        for i in range(n_workers)]
    fabric = LocalFabric(coordinator, workers, clock, chaos=policy,
                         max_rounds=max_rounds)
    try:
        return fabric.run()
    finally:
        if close is not None:
            close()


__all__ = ["LocalFabric", "FleetStalledError", "fleet_sweep",
           "split_ranges"]
