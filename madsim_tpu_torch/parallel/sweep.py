"""Seed sweeps: the bug hunt's three loops, on one device or split over a
mesh of them.

The PyTorch counterpart of ``madsim_tpu/parallel/sweep.py``. ``sweep``
initialises one world per seed and steps the batch in chunks of
``chunk_steps`` launches. Between chunks it decides whether to stop, to
recycle retired slots with the next seeds (``recycle=True``) or to shrink
the batch to the active worlds (``compact=True``, and the dry-cursor
fallback of a recycled sweep). The batch is a fixed set of world *slots*;
a device-resident slot→seed index keeps attribution straight through every
permutation, and the retiring tail's observations are gathered on the
device and pulled alone. Three loops make those decisions:

- ``pipeline=True`` (the default): supersteps of up to ``superstep_max``
  chunks (:meth:`DeviceEngine.superstep`) whose early exits (the
  occupancy threshold, a bug under ``stop_on_first_bug``) close a gate
  word on the device; superstep k+1 is queued before superstep k's
  scalars are read, and is a pass-through where they call for a stop or
  a refill. One ``_fetch`` per superstep, plus the retire pulls.
- ``pipeline=False``: the serial loop, one ``_fetch`` of two scalars per
  chunk.
- ``fused=True``: the whole hunt on the device between scalar reads
  (:func:`_fused_hunt`): after each chunk a device-side trigger decides
  the epoch (compaction, the retiring tail's harvest into per-seed device
  buffers, the search's fold and children, the refill), whose writes are
  masked by it; one ``_fetch`` per mega-dispatch and one pull of the
  buffers at the end. The host still learns of each trigger from a device
  flag it reads a chunk late (there is no conditional-node capture to
  branch on the device), so it waits on the device about once a chunk.

With ``mesh=`` (``parallel/mesh.py``) the batch's world axis is split
into one contiguous block per mesh device, as the JAX sweep shards it.
Each block is stepped by launches of its own on its own device; after
each chunk the active count and the bug flag are reduced over the blocks
onto the mesh's lead device, where the loop's one pull reads them, so the
pulls and flag reads do not grow with the mesh. The coverage fold runs per
block and reduces its terms there too. What the JAX package keeps
replicated, and the slot→seed index and per-slot schedules, the port keeps
whole on the lead device: the refill and shrink epochs (compaction, the
retiring tail's gathers, the search, the refill) gather the batch there,
work on the whole world axis, and split it again. The mesh shapes the
results as in the JAX package: the seeds are padded to a multiple of the
mesh size (the padded worlds run repeats of the first seed and are sliced
off), ``batch_worlds`` rounds up to one, and compaction halves only to
mesh multiples. Without ``mesh`` the sweep runs on the engine's device.

Results are bitwise those of the JAX package's sweep on the same mesh
size (``mesh=seed_mesh(n_devices=k)``) in the same loop, and every loop's
results equal the serial loop's (a fused sweep's ``world_utilization``
aside: it never shrinks). Worlds are position-independent, so a recycled
or compacted sweep gives every seed the trajectory of an independent
``init`` + ``run``.

Every device→host read of the loops' results goes through :func:`_fetch`,
the one patchable pull seam (tests count its calls). The device-side
loops' stop and trigger flags are read apart (:class:`Lookahead`) and
counted in ``loop_stats["flag_reads"]``.

With ``search=SearchConfig(...)`` the loop is the guided schedule search
(madsim_tpu_torch/search): each refill folds the retiring worlds into a
corpus of parent schedules on the device (on CUDA the hand-written fold
kernel ``csrc/corpus_fold.cu``) and refills the slots with mutated
children generated there.

With ``checkpoint_path`` the serial and the pipelined loop write the
sweep to an npz file as they go (:class:`_AsyncCheckpointer`, a writer
thread), and ``resume=True`` continues from it bitwise where it stopped,
in a new engine and a new process; the file's format is the JAX
package's, so a Raft sweep's checkpoint resumes in either package. The
fused loop refuses checkpoints, as in JAX.

With ``observe=`` each host read of the loop's scalars emits one
telemetry record (obs/observatory.py; a guided sweep also one search
record per refill, or per mega-dispatch in the fused loop) and the sweep
ends with a summary record; every record is built from values the loop
already pulled, so the ``_fetch`` calls, the flag reads and the launches
are those of the same sweep without it. ``profile_dir=`` captures a
window of dispatches with ``torch.profiler``. ``SweepResult.minimize``
shrinks a failing seed's schedule (madsim_tpu_torch/triage).

:class:`SweepSession` is a fleet worker's persistent session
(madsim_tpu_torch/fleet): ``run`` is a sweep with its engine bound, and
``run_group`` advances several seed ranges as one standing batch whose
slots later groups recycle.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
from time import perf_counter
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..engine import checkpoint as ckpt
from ..engine.convert import from_numpy, to_numpy
from ..engine.core import (
    DeviceEngine,
    EngineConfig,
    Lookahead,
    block_totals,
    run_blocks,
    split_like,
    tree_map,
    world_blocks,
)
from ..engine.queue import _wrap_i32
from ..obs.blackbox import decode_ring, ring_depth, rings_from_observations
from ..obs.coverage import (
    DEFAULT_BUCKETS,
    coverage_from_device,
    distinct_count,
    fold_shards,
    ledger_zeros,
)
from ..obs.metrics import aggregate_metrics, metrics_from_observations
from ..search.corpus import (
    HostCorpus,
    corpus_to_device,
    host_corpus_init,
    normalize_schedule,
)
from ..search.generate import searcher
from .mesh import Mesh, seed_mesh, shard_worlds


def _to_host(tree):
    """A tree of tensors (dicts, tuples, lists, None) as the same tree of
    numpy arrays, each dict in sorted key order."""
    if isinstance(tree, torch.Tensor):
        return tree.cpu().numpy()
    if isinstance(tree, dict):
        # Sorted by key, as ``jax.device_get`` rebuilds a dict.
        return {k: _to_host(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        items = [_to_host(v) for v in tree]
        return (type(tree)(*items) if hasattr(tree, "_fields")
                else type(tree)(items))
    return tree


def _fetch(tree):
    """The sweep loop's one device→host pull (:func:`_to_host`)."""
    return _to_host(tree)


# ---------------------------------------------------------------------------
# Device helpers: the chunk and superstep runners, the coverage folds,
# compaction and the retiring tail's observation gathers.
# ---------------------------------------------------------------------------

def _engine_mesh(eng: DeviceEngine, mesh: Optional[Mesh]) -> Mesh:
    """``mesh``, or the one-device mesh of the engine's device."""
    return mesh if mesh is not None else seed_mesh([eng.device])


def _fold_blocks(blocks, masks, hits, first, idx, n_real):
    """Fold into the ledger each block's worlds that its mask selects and
    that hold a real seed id (:func:`fold_shards`); ``idx`` is whole, on
    the lead device."""
    return fold_shards(hits, first, [
        (b.metrics, m & (ib >= 0) & (ib < n_real), ib)
        for b, m, ib in zip(blocks, masks, split_like(idx, blocks))])


def sharded_engine(eng: DeviceEngine, mesh: Mesh, chunk_steps: int = 512,
                   donate: bool = False, coverage: Optional[int] = None):
    """The serial loop's chunk runner over a split batch (the JAX
    ``sharded_engine``): ``state → (state, any_bug, n_active)``, every
    block stepped ``chunk_steps`` times in place by its own launches on
    its own device, and the two scalars reduced over the blocks onto the
    mesh's lead device.

    With ``coverage`` (a bucket count) the runner is ``(state, hits,
    first_seen, idx, n_real) → (state, any_bug, n_active, hits,
    first_seen, distinct)``: after the chunk, the worlds whose active flag
    fell during it, and that hold a real seed id, fold their behavior
    signatures into the ledger, block by block. ``mesh`` and ``donate``
    are the JAX signature's and change nothing: the blocks are the
    state's own, and the port always steps in place.
    """
    if coverage is None:
        def chunk(state):
            blocks = world_blocks(state)
            run_blocks(eng, blocks, chunk_steps)
            return (state,) + block_totals(blocks)
    else:
        def chunk(state, hits, first, idx, n_real):
            blocks = world_blocks(state)
            act0 = [b.active.clone() for b in blocks]
            run_blocks(eng, blocks, chunk_steps)
            hits, first = _fold_blocks(
                blocks, [a & ~b.active for a, b in zip(act0, blocks)],
                hits, first, idx, n_real)
            return ((state,) + block_totals(blocks)
                    + (hits, first, distinct_count(hits)))
    return chunk


def sharded_superstep(eng: DeviceEngine, mesh: Mesh, chunk_steps: int,
                      k_max: int, donate: bool = False,
                      min_one: bool = False,
                      coverage: Optional[int] = None):
    """The superstep runner over a split batch (the JAX
    ``sharded_superstep``): ``(state, stop_threshold, stop_on_bug,
    k_chunks) → (state, any_bug, n_active, k_done, hist)``, or with
    ``coverage`` ``(state, hits, first_seen, idx, n_real, stop_threshold,
    stop_on_bug, k_chunks) → (state, any_bug, n_active, k_done, hist,
    hits, first_seen, cov_hist)``. :meth:`DeviceEngine.superstep` runs
    it: the blocks step apart, and the gate is decided on the lead device
    from the reduced scalars, a copy of it gating each block's launches.
    ``mesh`` and ``donate`` change nothing, as in
    :func:`sharded_engine`."""
    if coverage is None:
        def sstep(state, stop_threshold, stop_on_bug, k_chunks):
            return eng.superstep(state, stop_threshold, stop_on_bug,
                                 k_chunks, chunk_steps=chunk_steps,
                                 k_max=k_max, min_one=min_one)
    else:
        def sstep(state, hits, first, idx, n_real, stop_threshold,
                  stop_on_bug, k_chunks):
            (state, any_bug, n_active, k_done, hist, (hits, first),
             cov_hist) = eng.superstep(
                state, stop_threshold, stop_on_bug, k_chunks,
                chunk_steps=chunk_steps, k_max=k_max, min_one=min_one,
                cov=(hits, first, idx, n_real))
            return (state, any_bug, n_active, k_done, hist, hits, first,
                    cov_hist)
    return sstep


def _fold_end(state, hits, first, idx, n_real, fold_active):
    """The boundary coverage fold: the worlds whose active flag equals
    ``fold_active`` fold into the ledger (False on resume: the worlds
    frozen before the snapshot; True at sweep end: the worlds still live
    at exit), block by block. Returns ``(hits, first)``."""
    blocks = world_blocks(state)
    return _fold_blocks(blocks, [b.active == fold_active for b in blocks],
                        hits, first, idx, n_real)


def _compact_bucket(n_active: int, w_cur: int, n_dev: int) -> int:
    """Largest power-of-two shrink of ``w_cur`` that still holds every
    active world and stays a multiple of the mesh; ``w_cur`` when no
    halving is possible."""
    w = w_cur
    # w//2 % n_dev == 0 already implies the w//2 >= n_dev floor.
    while w % 2 == 0 and w // 2 >= max(n_active, 1) and w // 2 % n_dev == 0:
        w //= 2
    return w


def _pow2_at_least(n: int) -> int:
    """Smallest power of two >= n (>= 1): the retiring tail's gather
    widths."""
    b = 1
    while b < n:
        b <<= 1
    return b


def _take(x: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``x[rows]`` along the world axis; uint32 storage is gathered as its
    int32 bits (torch has few uint32 kernels)."""
    if x.dtype == torch.uint32:
        return x.view(torch.int32).index_select(0, rows).view(torch.uint32)
    return x.index_select(0, rows)


def _permute_worlds(tree, perm: torch.Tensor):
    """Reorder the world axis of every leaf of ``tree``."""
    return tree_map(lambda x: _take(x, perm), tree)


def _compactor(state, idx, new_w: Optional[int] = None, extra=()):
    """Compaction of a batch held whole (an epoch gathers a split batch
    first): the stable active-first permutation
    (``torch.sort(stable=True)`` of the frozen flag) applied to the state,
    the slot→seed index and the ``extra`` per-slot trees (a guided sweep's
    schedules and lineage lanes); with ``new_w`` also the split into the
    live head of ``new_w`` worlds and the frozen tail. Returns ``(state,
    idx, *extra)``, or a ``(live, frozen)`` pair of such tuples."""
    order = torch.sort((~state.active).to(torch.int32), stable=True).indices
    group = [_permute_worlds(t, order) for t in (state, idx) + tuple(extra)]
    if new_w is None:
        return tuple(group)
    return (tuple(tree_map(lambda x: x[:new_w], t) for t in group),
            tuple(tree_map(lambda x: x[new_w:], t) for t in group))


def _rows_from(x: torch.Tensor, start: int, rows: int) -> torch.Tensor:
    """``rows`` rows of ``x`` from ``start`` on, clamped to the batch (the
    caller slices the pull to the true tail)."""
    w = x.shape[0]
    take = (start + torch.arange(rows, device=x.device)).clamp(0, w - 1)
    return _take(x, take)


def _tail_observer(eng: DeviceEngine, state, idx, start: int, rows: int):
    """The retiring tail's gather: ``rows`` observation rows from ``start``
    on (clamped to the batch; the caller slices to the true tail), with
    the slot→seed index, so that retirement pulls only those rows."""
    obs = {k: _rows_from(v, start, rows)
           for k, v in eng.observe_device(state).items()}
    return obs, _rows_from(idx, start, rows)


def _observer(eng: DeviceEngine, state, idx):
    """Observations of an already split frozen batch (the shrink's tail),
    with its slot→seed index."""
    return eng.observe_device(state), idx


# ---------------------------------------------------------------------------
# The checkpoint writer
# ---------------------------------------------------------------------------

def _copy_tree(tree):
    """A copy of every tensor of ``tree`` (dicts, tuples, lists; other
    leaves kept), queued on the current stream: the step kernel and the
    refills write state, ledger and search tensors in place, so the writer
    reads copies taken at the submit point in stream order. A list is
    copied too, as the loop appends to its own."""
    if isinstance(tree, torch.Tensor):
        if tree.dtype == torch.uint32:
            return tree.view(torch.int32).clone().view(torch.uint32)
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _copy_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_copy_tree(v) for v in tree]
    if isinstance(tree, tuple):
        items = [_copy_tree(v) for v in tree]
        return (type(tree)(*items) if hasattr(tree, "_fields")
                else type(tree)(items))
    return tree


class _Snapshot(NamedTuple):
    """A state copied on the device at one point of a loop (see
    :func:`_copy_tree`), for the writer to take later."""

    state: Any


class _AsyncCheckpointer:
    """The background checkpoint writer: the pull to the host and the npz
    write overlap the sweep's next chunks.

    :meth:`submit` queues device copies of the state and of every tensor
    of the aux dict on the current stream, records an event behind them,
    and hands them to the writer thread; the loop never waits. The thread
    pulls the copies to the host on a stream of its own after that event
    (so it neither waits for later chunks nor sees their writes), drops
    them, and writes the file atomically (``engine/checkpoint.py``).

    Latest-wins coalescing: a snapshot not yet started is replaced by the
    next, since only the newest durable state matters and the write must
    not hold the sweep back. A failed write is raised at the next
    :meth:`submit`, or at :meth:`flush_and_close`.
    """

    def __init__(self, eng, path, extra_meta):
        import threading

        self._eng = eng
        self._path = path
        self._meta = extra_meta
        self._cond = threading.Condition()
        self._pending = None
        self._busy = False
        self._stop = False
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(
            target=self._run, name="madsim-checkpointer", daemon=True)
        self._thread.start()

    @staticmethod
    def snapshot(state) -> _Snapshot:
        """Copy ``state`` now, in stream order, for a later :meth:`submit`
        (the pipelined loop: the next superstep is queued before the host
        knows whether this one crossed a checkpoint mark)."""
        return _Snapshot(_copy_tree(state))

    def submit(self, state, aux=None) -> None:
        """Queue a snapshot of ``state`` (or a :meth:`snapshot` of it) and
        of ``aux``, a dict of tensors, host arrays and lists of host arrays
        (the writer concatenates a list)."""
        with self._cond:
            if self._error is not None:
                err, self._error = self._error, None
                raise err
        snap = (state.state if isinstance(state, _Snapshot)
                else _copy_tree(state))
        aux = _copy_tree(aux)
        ev = None
        if snap.now.device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record()
        with self._cond:
            self._pending = (snap, aux, ev)
            self._cond.notify_all()

    def _run(self) -> None:
        stream = None
        while True:
            with self._cond:
                while self._pending is None and not self._stop:
                    self._cond.wait()
                if self._pending is None:
                    return
                (state, aux, ev), self._pending = self._pending, None
                self._busy = True
            try:
                # Pull to the host first and drop the device copies, so a
                # snapshot holds no device memory through the disk write.
                if ev is not None:
                    if stream is None:
                        stream = torch.cuda.Stream(
                            device=state.now.device)
                    with torch.cuda.stream(stream):
                        stream.wait_event(ev)
                        host_state = tree_map(to_numpy, state)
                        host_aux = _to_host_aux(aux)
                else:
                    host_state = tree_map(to_numpy, state)
                    host_aux = _to_host_aux(aux)
                state = aux = None
                ckpt.save(self._eng, host_state, self._path,
                          extra_meta=self._meta, extra_arrays=host_aux)
                exc = None
            except BaseException as e:  # noqa: BLE001 — raised later
                exc = e
            with self._cond:
                self._busy = False
                if exc is not None:
                    self._error = exc
                self._cond.notify_all()

    def flush_and_close(self, suppress_errors: bool = False) -> None:
        """Wait until every submitted snapshot is durable, then stop.

        ``suppress_errors`` logs a deferred write failure instead of
        raising it, for a ``finally`` block that must not mask the
        exception in flight."""
        with self._cond:
            while self._pending is not None or self._busy:
                self._cond.wait()
            self._stop = True
            self._cond.notify_all()
        self._thread.join()
        if self._error is not None:
            if suppress_errors:
                import logging

                logging.getLogger("madsim_tpu_torch.sweep").warning(
                    "checkpoint write failed during sweep teardown: %r",
                    self._error)
            else:
                raise self._error


def _to_host_aux(aux):
    """The writer's aux dict as host arrays: tensors pulled, lists of
    arrays concatenated."""
    if aux is None:
        return None
    return {k: (np.concatenate([to_numpy(a) for a in v], axis=0)
                if isinstance(v, list) else to_numpy(v))
            for k, v in aux.items()}


# ---------------------------------------------------------------------------
# The result
# ---------------------------------------------------------------------------

class TriageContext(NamedTuple):
    """What :meth:`SweepResult.minimize` and ``triage.triage`` need to
    re-execute a sweep's worlds: the engine, the ``faults=`` argument (or
    under ``search=`` the materialized per-seed ``(n, F, 4)`` schedules
    each world ran) and the mesh. None on a reconstructed result."""

    engine: Any
    faults: Optional[np.ndarray]
    mesh: Any = None


@dataclasses.dataclass
class SweepResult:
    """Outcome of a seed sweep: the JAX ``SweepResult``'s fields.

    ``n_active_history[i]`` is the active world count after chunk
    ``n_active_chunks[i]``; ``world_utilization`` is live-world steps over
    issued slot-steps; ``loop_stats`` counts chunks, dispatches and device
    pulls and times the loop on the host (the port's own times).
    ``search`` is the guided sweep's
    :class:`~madsim_tpu_torch.search.SearchReport` (None otherwise).
    """

    seeds: np.ndarray
    bug: np.ndarray
    observations: Dict[str, np.ndarray]
    steps_run: int
    n_devices: int
    n_active_history: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int64))
    world_utilization: float = 0.0
    n_active_chunks: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int64))
    loop_stats: Dict[str, Any] = dataclasses.field(default_factory=dict)
    faults_sha256: Optional[str] = None
    coverage: Optional[Any] = None
    search: Optional[Any] = None
    triage_ctx: Optional[TriageContext] = dataclasses.field(
        default=None, repr=False)

    @property
    def failing_seeds(self) -> List[int]:
        return [int(s) for s in self.seeds[self.bug]]

    def minimize(self, seed: Optional[int] = None, **kw):
        """Minimize a failing seed's fault schedule (triage/minimize.py).

        ``seed`` defaults to the first failing seed; ``kw`` forwards to
        :func:`madsim_tpu_torch.triage.minimize` (``pipeline``,
        ``weaken``, ``tighten``, ``chunk_steps``, ``max_steps``, ...).
        Re-uses this sweep's engine and mesh, and the schedule the seed
        ran: the shared one, its own row of per-world schedules, or
        the child a guided sweep made for it. Returns a
        :class:`~madsim_tpu_torch.triage.MinimizeResult`."""
        from ..triage import TriageError
        from ..triage import minimize as _minimize

        if self.triage_ctx is None:
            raise TriageError(
                "this SweepResult carries no triage context (merged or "
                "reconstructed result): re-run the sweep locally, or "
                "call triage.minimize(actor, cfg, seed, faults) with "
                "the original inputs")
        if seed is None:
            if not self.failing_seeds:
                raise TriageError("no failing seeds to minimize")
            seed = self.failing_seeds[0]
        rows = np.flatnonzero(np.asarray(self.seeds) == np.uint64(seed))
        if rows.size == 0:
            raise TriageError(f"seed {seed} was not part of this sweep")
        faults = self.triage_ctx.faults
        if faults is not None:
            faults = np.asarray(faults, np.int32)
            if faults.ndim == 3:  # per-world schedules: this seed's rows
                faults = faults[int(rows[0])]
        eng = self.triage_ctx.engine
        return _minimize(eng.actor, eng.cfg, int(seed), faults,
                         engine=eng, mesh=self.triage_ctx.mesh, **kw)

    @property
    def metrics(self) -> Optional[Dict[str, Any]]:
        """``{"per_seed": {field: (n, ...)}, "aggregate": {field: int or
        [int]}}``, or ``None`` when the sweep ran metrics-off."""
        per_seed = metrics_from_observations(self.observations)
        if per_seed is None:
            return None
        return {"per_seed": per_seed, "aggregate": aggregate_metrics(per_seed)}

    def blackbox(self, seed: Optional[int] = None) -> List[Dict[str, Any]]:
        """One seed's flight-recorder ring decoded into trace-shaped
        records, oldest first (``seed`` defaults to the first failing one).
        Raises ``ValueError`` on a blackbox-off sweep or an unknown seed."""
        rings = rings_from_observations(self.observations)
        if rings is None:
            raise ValueError(
                "this sweep ran blackbox-off: enable the flight recorder "
                "with EngineConfig(blackbox=K)")
        if seed is None:
            if not self.failing_seeds:
                raise ValueError("no failing seeds — pass an explicit "
                                 "seed= to decode a passing world's ring")
            seed = self.failing_seeds[0]
        rows = np.flatnonzero(np.asarray(self.seeds) == np.uint64(seed))
        if rows.size == 0:
            raise ValueError(f"seed {seed} was not part of this sweep")
        row = int(rows[0])
        actor = getattr(getattr(self.triage_ctx, "engine", None),
                        "actor", None)
        return decode_ring({k: v[row] for k, v in rings.items()},
                           kind_names=getattr(actor, "kind_names", None))

    def summary(self) -> str:
        """One paragraph of what the sweep did: seeds, bugs, utilization,
        coverage, the guided search, the top drop causes and the
        recorder's depth."""
        n = len(self.seeds)
        n_bug = len(self.failing_seeds)
        parts = [f"swept {n} seed{'s' if n != 1 else ''} on "
                 f"{self.n_devices} device(s) in {self.steps_run} issued "
                 f"steps: {n_bug} failing"]
        if self.n_active_history.size:
            parts.append(f"world utilization "
                         f"{self.world_utilization:.0%} over "
                         f"{self.n_active_history.size} chunks")
        if self.coverage is not None:
            cov = self.coverage
            curve = cov.novelty_curve
            tail = (f" (novelty {int(curve[0])}→{int(curve[-1])} "
                    f"across the run)" if curve.size else "")
            parts.append(f"{cov.distinct_behaviors} distinct behaviors "
                         f"in {cov.n_buckets} buckets{tail}")
        if self.search is not None:
            s = self.search
            line = (f"guided search: corpus {s.corpus_size}/"
                    f"{s.corpus_capacity}, {s.inserted} inserted over "
                    f"{s.generations} generations")
            if s.operator_stats:
                from ..obs.lineage import top_operator

                top = top_operator(s.operator_stats)
                if top:
                    line += f", top operator {top}"
            parts.append(line)
        m = self.metrics
        if m is not None:
            agg = m["aggregate"]
            drops = sorted(((k, v) for k, v in agg.items()
                            if k.startswith("drop_") and isinstance(v, int)
                            and v > 0), key=lambda kv: -kv[1])
            if drops:
                parts.append("top drop causes: " + ", ".join(
                    f"{k[5:]}={v}" for k, v in drops[:3]))
        k_ring = ring_depth(self.observations)
        parts.append(f"black box: last {k_ring} events/world recorded"
                     if k_ring is not None else "black box: off")
        return "; ".join(parts) + "."

    def repro_banner(self) -> Optional[str]:
        """The failing-seed reproduction hint, after :meth:`summary`."""
        if not self.failing_seeds:
            return None
        banner = self.summary() + "\n"
        banner += ("note: run with environment variable "
                   f"MADSIM_TEST_SEED={self.failing_seeds[0]} to reproduce "
                   f"this failure ({len(self.failing_seeds)} failing seeds "
                   "total)")
        if self.faults_sha256 is not None:
            banner += (f"\nnote: fault-schedule sha256: "
                       f"{self.faults_sha256[:16]} (replay must use the "
                       "same schedule)")
        k_ring = ring_depth(self.observations)
        banner += ("\nnote: flight recorder "
                   + (f"K={k_ring} (SweepResult.blackbox(seed) decodes "
                      "the failing world's last events)" if k_ring
                      else "off (enable with EngineConfig(blackbox=K))"))
        return banner


# ---------------------------------------------------------------------------
# The sweep
# ---------------------------------------------------------------------------

def sweep(actor: Any, cfg: EngineConfig, seeds,
          faults: Optional[np.ndarray] = None,
          mesh: Optional[Any] = None, chunk_steps: int = 512,
          max_steps: int = 1_000_000, stop_on_first_bug: bool = False,
          engine: Optional[DeviceEngine] = None,
          checkpoint_path: Optional[str] = None,
          checkpoint_every_chunks: int = 0,
          resume: bool = False,
          compact: bool = False,
          recycle: bool = False,
          batch_worlds: Optional[int] = None,
          pipeline: bool = True,
          superstep_max: int = 16,
          fused: bool = False,
          observe: Any = None,
          profile_dir: Optional[str] = None,
          profile_window: Tuple[int, int] = (0, 4),
          coverage_buckets: Optional[int] = None,
          search: Optional[Any] = None,
          search_corpus: Optional[Any] = None,
          search_gen0: int = 0,
          search_lin_base: int = 0) -> SweepResult:
    """Run one simulation per seed to completion, on the engine's device.

    The JAX ``sweep``'s signature and loops. Between chunks the loop reads
    the active count and the bug flag and decides:

    - stop when no world is active and no seed is left, or on a bug with
      ``stop_on_first_bug``;
    - ``recycle`` + ``batch_worlds``: hold ``batch_worlds`` slots and, once
      at most half are active, compact the batch active-first, retire the
      frozen tail and refill it with the next seeds (each refilled world is
      an independent ``init`` of its seed); with the seed cursor dry, fall
      back to shrinking;
    - ``compact``: once the active worlds fit in half the batch, shrink it
      to the smallest power-of-two share that holds them, retiring the
      frozen tail.

    ``pipeline=True`` (the default) makes those decisions once per
    superstep of up to ``superstep_max`` chunks, whose early exits run on
    the device; ``pipeline=False`` once per chunk; ``fused=True`` on the
    device, the host reading one scalar batch per mega-dispatch (it
    refuses ``compact``, and has no dry-cursor shrink). All three give the
    same results (the module docstring).

    ``faults``: a shared ``(F, 4)`` schedule or one ``(F, 4)`` block per
    seed, ``(n_seeds, F, 4)``. With ``EngineConfig(metrics=True)`` the
    behavior-coverage ledger (``coverage_buckets`` buckets, default
    :data:`DEFAULT_BUCKETS`) folds each retiring world and lands on
    ``SweepResult.coverage``. ``max_steps`` bounds the steps issued
    (whole chunks).

    ``search=SearchConfig(...)`` (with ``recycle=True``, metrics on and a
    ``faults`` template) makes each refill a generation of the guided
    schedule search; ``search_corpus`` (a :class:`HostCorpus`) seeds its
    corpus, ``search_gen0`` offsets its mutation streams and
    ``search_lin_base`` its lineage entry ids, as in the JAX package.

    Preemption survival, as in the JAX package: with ``checkpoint_path``
    the serial and the pipelined loop write the sweep every
    ``checkpoint_every_chunks`` chunks (the pipelined loop at the first
    superstep that crosses each mark) and at the end, through a writer
    thread; ``resume=True`` loads an existing file in place of the first
    ``init`` and continues bitwise where it stopped. A recycled sweep's
    file carries the slot→seed index, the cursor, the retired rows, the
    coverage ledger and a guided sweep's schedules, corpus, lineage lanes
    and operator table; a resume needs the same seeds, schedule,
    ``batch_worlds`` and search settings. While a writer is attached the
    batch never shrinks (``compact`` and the dry-cursor fallback are off),
    so every file written resumes into the full-shape contract.
    ``max_steps`` counts the steps of this call. ``fused=True`` refuses a
    ``checkpoint_path``.

    ``observe``: a live telemetry sink — a callable receiving one dict
    per host read of the loop's scalars, or a JSONL path (``python -m
    madsim_tpu_torch.obs watch`` reads it) — ending with a summary
    record; the records are the JAX package's (obs/observatory.py).
    ``profile_dir``: capture dispatches ``profile_window=(start, stop)``
    with ``torch.profiler`` and write a Chrome trace there. Neither
    changes the results, the ``_fetch`` calls, the flag reads or the
    launches.

    ``mesh`` (``parallel/mesh.py``: :func:`seed_mesh`,
    :func:`multihost_mesh`) splits the world axis over its devices (the
    module docstring); by default the sweep runs on the engine's device.
    ``SweepResult.n_devices`` is the mesh size.
    """
    if superstep_max < 1:
        raise ValueError("superstep_max must be >= 1")
    if fused and checkpoint_path is not None:
        raise ValueError(
            "fused=True cannot checkpoint: the whole-hunt program "
            "retires and refills worlds inside one device dispatch, so "
            "no host-visible boundary exists mid-hunt where state, "
            "cursor, and retired observations are simultaneously "
            "consistent for a snapshot — run the pipelined path "
            "(fused=False) when checkpoint_path is set")
    if fused and compact:
        raise ValueError(
            "fused=True has no shrink path: compact=True saves flops "
            "by narrowing a mostly-frozen batch, but the fused loop "
            "already avoids the host round trips that made the "
            "straggler tail expensive, and every result surface is "
            "shrink-invariant — drop compact (or run fused=False)")
    eng = engine if engine is not None else DeviceEngine(actor, cfg)
    mesh = _engine_mesh(eng, mesh)
    n_dev = mesh.size
    dev = mesh.lead                    # where the sweep keeps whole tensors
    seeds = np.asarray(seeds, np.uint64)
    n = seeds.shape[0]

    cov_on = bool(eng.cfg.metrics)
    if coverage_buckets is not None and not cov_on:
        raise ValueError(
            "coverage_buckets requires EngineConfig(metrics=True): the "
            "behavior ledger hashes the MetricsBlock histograms of "
            "retiring worlds")
    cov_k = int(coverage_buckets) if coverage_buckets else DEFAULT_BUCKETS
    if cov_on and cov_k < 1:
        raise ValueError("coverage_buckets must be >= 1")

    # The guided schedule search: validated here, wired in at the refills.
    search_on = search is not None
    if search_on:
        if not recycle:
            raise ValueError(
                "search= needs recycle=True (and batch_worlds): guided "
                "children stream into recycled refill slots — a "
                "non-recycled sweep has no refill edge to feed")
        if not cov_on:
            raise ValueError(
                "search= requires EngineConfig(metrics=True): the "
                "novelty signal hashes the MetricsBlock histograms of "
                "retiring worlds (obs/coverage.py)")
        if faults is None:
            raise ValueError(
                "search= needs a fault-schedule template (faults=): the "
                "mutation operators perturb within the template's fault "
                "vocabulary — an empty schedule has nothing to evolve")
    if search_corpus is not None and not search_on:
        raise ValueError(
            "search_corpus= seeds the guided-search parent corpus and "
            "needs search=SearchConfig(...) — a plain sweep has no "
            "corpus to seed")
    if search_gen0 and not search_on:
        raise ValueError("search_gen0= offsets the guided mutation "
                         "streams and needs search=SearchConfig(...)")
    if search_gen0 < 0:
        raise ValueError("search_gen0 must be >= 0")
    if search_lin_base and not search_on:
        raise ValueError("search_lin_base= offsets the lineage entry-id "
                         "space and needs search=SearchConfig(...)")
    if search_lin_base < 0:
        raise ValueError("search_lin_base must be >= 0")
    lineage_on = bool(search_on and getattr(search, "lineage", False))

    # Batch width: a multiple of the mesh. Plain sweeps hold every seed at
    # once; recycled sweeps hold batch_worlds slots and stream the rest.
    full_w = n + ((-n) % n_dev)
    if recycle and batch_worlds is not None:
        w0 = min(max(1, int(batch_worlds)), max(n, 1))
        w0 += (-w0) % n_dev
        w0 = min(w0, full_w)
    else:
        w0 = full_w
    # The seed-id space padded to the batch width: the padded worlds run
    # repeats of the first seed, and their results are sliced off.
    n_ids = max(n, w0)
    seeds_p = (np.concatenate([seeds, seeds[:1].repeat(n_ids - n)])
               if n_ids > n else seeds)

    faults_p = faults
    per_world_faults = False
    if faults is not None:
        faults_p = np.asarray(faults, np.int32)
        if faults_p.ndim == 2:
            if faults_p.shape[-1] != 4:
                raise ValueError(
                    f"shared fault schedule must be (F, 4) rows of "
                    f"[time_us, op, a, b]; got shape {faults_p.shape}")
        elif faults_p.ndim == 3:
            if faults_p.shape[-1] != 4:
                raise ValueError(
                    f"per-world fault schedules must be (n_seeds, F, 4) "
                    f"rows of [time_us, op, a, b]; got shape "
                    f"{faults_p.shape}")
            if faults_p.shape[0] != n:
                raise ValueError(
                    f"per-world fault schedules carry one (F, 4) block "
                    f"per seed: got leading dim {faults_p.shape[0]} but "
                    f"len(seeds)={n}")
            per_world_faults = True
            if n_ids > n:
                faults_p = np.concatenate(
                    [faults_p, faults_p[:1].repeat(n_ids - n, axis=0)],
                    axis=0)
        else:
            raise ValueError(
                f"faults must be (F, 4) or (n_seeds, F, 4); got "
                f"{faults_p.ndim}-D shape {faults_p.shape}")

    def batch_faults(ids: np.ndarray):
        """Fault rows for the worlds holding the given seed ids."""
        if faults_p is None:
            return None
        return faults_p[ids] if per_world_faults else faults_p

    # The schedule's fingerprint rides the result: a seed alone does not
    # pin a trajectory when schedules vary. Both hashes are of the padded
    # inputs, as in the JAX package.
    faults_key = (np.ascontiguousarray(faults_p).tobytes()
                  if faults_p is not None else b"none")
    faults_sha256 = hashlib.sha256(faults_key).hexdigest()
    # The seeds and the schedule ride a checkpoint: a resume under others
    # would attribute results to inputs that never produced them.
    seeds_meta = {
        "seeds_sha256": hashlib.sha256(seeds_p.tobytes()).hexdigest(),
        "faults_sha256": faults_sha256}

    resumed = False
    resume_aux: Dict[str, np.ndarray] = {}
    if resume and checkpoint_path and os.path.exists(checkpoint_path):
        state, resume_aux = ckpt.load(eng, checkpoint_path,
                                      expect_extra=seeds_meta, with_aux=True)
        w_file = int(state.now.shape[0])
        if recycle:
            # A recycled file carries the slot→seed index and the cursor;
            # without them its worlds cannot be attributed.
            if "cursor" not in resume_aux:
                raise ckpt.CheckpointError(
                    f"checkpoint {checkpoint_path!r} was written by a "
                    "non-recycled sweep (no slot->seed aux): resume it "
                    "with recycle=False, or delete it to start the "
                    "recycled hunt fresh")
            if w_file != w0:
                raise ValueError(
                    f"cannot resume recycled sweep: checkpoint holds "
                    f"{w_file} world slots but batch_worlds implies {w0} "
                    "— a shrunk-compacted or differently-batched state "
                    "cannot resume into the full-shape contract; rerun "
                    "with the original batch_worlds")
        elif "cursor" in resume_aux:
            raise ckpt.CheckpointError(
                f"checkpoint {checkpoint_path!r} was written by a "
                "recycled sweep: pass recycle=True (and the original "
                "batch_worlds) to resume it")
        elif w_file != n_ids:
            raise ckpt.CheckpointError(
                f"checkpoint holds {w_file} worlds, "
                f"sweep expects {n_ids} (seeds + mesh padding)")
        state = shard_worlds(state, mesh)
        resumed = True
    else:
        state = shard_worlds(
            eng.init(seeds_p[:w0], faults=batch_faults(np.arange(w0))), mesh)
    # A shrunken batch could not resume into the full-shape contract.
    compact = compact and checkpoint_path is None
    submitted_chunks = -1              # chunks at the writer's last submit
    c_max = -(-max_steps // chunk_steps)   # the serial loop's chunk budget
    steps = 0
    chunks = 0                         # executed chunk bodies
    w_cur = w0                         # current batch width (slots)
    cursor = w0                        # next seed id the stream admits
    # Slot→seed id, on the device: compaction permutes it with the state.
    # -1 marks a dead slot (a retired world still riding in the batch).
    idx = torch.arange(w_cur, dtype=torch.int32, device=dev)
    reordered = False                  # batch rows still in seed order?
    retired: Dict[str, list] = {}      # field → retired observation rows
    retired_rows: List[np.ndarray] = []
    n_active_hist: List[int] = []
    n_active_chunk: List[int] = []     # chunk index of each entry
    issued_slot_steps = 0              # sum over chunks of width*chunk_steps
    live_world_steps = 0               # steps that advanced a live world
    perf = {"device_wait_s": 0.0, "host_decision_s": 0.0, "dispatch_s": 0.0,
            "retire_wait_s": 0.0, "scalar_fetches": 0, "retire_fetches": 0,
            "dispatches": 0, "dispatch_depth": 0}
    t_loop0 = perf_counter()
    flag_reads0 = Lookahead.host_reads
    # The observatory: host-side observation only, every record built from
    # values the loop already pulled.
    from ..obs import observatory as _obsy

    emit_telemetry, close_telemetry = _obsy.make_observer(observe)
    prof = _obsy.ProfilerWindow(profile_dir, profile_window)
    # Host mirrors of the corpus scalars, refreshed by the pulls that
    # carry them.
    search_host = {"corpus_size": 1, "inserted": 0, "gen": 0,
                   "refill_novel": 0, "refill_inserted": 0}
    novelty_hist: List[int] = []       # cumulative distinct, per chunk
    cov_hits = cov_first = None
    if cov_on:
        cov_hits, cov_first = ledger_zeros(cov_k, dev)
    # -- the guided search's state, all on the device ------------------
    # slot_sched: the (W, F, 4) schedule each slot runs, permuted and
    # refilled with the state; slot_lin its lineage lanes; corpus the
    # parent pool; op_tab the operator table's produced/novel/survived
    # rows. Each refill runs the searcher (search/generate.py: the fold,
    # then the children) on the device.
    slot_sched = slot_lin = corpus = op_tab = None
    retired_sched: List[np.ndarray] = []
    retired_lin: List[tuple] = []
    f_rows = 0
    if search_on:
        from ..obs.lineage import lanes_origin, table_zeros

        f_rows = int(faults_p.shape[-2])
        base0 = (faults_p[:w0] if per_world_faults
                 else np.broadcast_to(faults_p, (w0,) + faults_p.shape))
        slot_sched = torch.from_numpy(np.ascontiguousarray(base0)).to(dev)
        k = int(search.corpus)
        if search_corpus is not None:
            if np.asarray(search_corpus.sched).shape != (k, f_rows, 4):
                raise ValueError(
                    f"search_corpus.sched must be (K, F, 4) = "
                    f"({k}, {f_rows}, 4) for SearchConfig.corpus={k} and "
                    f"the {f_rows}-row template; got "
                    f"{np.asarray(search_corpus.sched).shape}")
            for name in ("sig", "score", "filled", "entry", "depth"):
                shp = np.asarray(getattr(search_corpus, name)).shape
                if shp != (k,):
                    raise ValueError(
                        f"search_corpus.{name} must be ({k},) for "
                        f"SearchConfig.corpus={k}; got {shp}")
            corpus_h0 = HostCorpus(*(np.array(x, copy=True)
                                     for x in search_corpus))
        else:
            corpus_h0 = host_corpus_init(k, normalize_schedule(
                faults_p[0] if per_world_faults else faults_p))
        # gen starts at the stream offset; inserted counts this sweep's.
        corpus = corpus_to_device(corpus_h0, int(search_gen0), 0, dev)
        if lineage_on:
            # The first batch runs the template itself: generation 0.
            slot_lin = lanes_origin(w0, dev)
            op_tab = table_zeros(dev)
    if resumed and recycle:
        # The sweep's bookkeeping from the file: the slot→seed index, the
        # cursor, the rows retired before the snapshot, and a guided
        # sweep's schedules, corpus, lineage lanes and operator table.
        cursor = int(np.asarray(resume_aux["cursor"]))
        idx = from_numpy(np.asarray(resume_aux["idx"], np.int32), dev)
        reordered = True
        if "ret_rows" in resume_aux:
            retired_rows.append(np.asarray(resume_aux["ret_rows"]))
            for key in resume_aux:
                if key.startswith("ret_") and key != "ret_rows":
                    retired[key[4:]] = [np.asarray(resume_aux[key])]
        if search_on != ("srch_sched" in resume_aux):
            raise ckpt.CheckpointError(
                f"checkpoint {checkpoint_path!r} was written by a "
                f"{'guided' if 'srch_sched' in resume_aux else 'plain'} "
                f"sweep but this resume is "
                f"{'guided (search=...)' if search_on else 'plain'}: "
                "the per-slot schedules and search corpus cannot be "
                "reconciled — resume with the original search setting")
        if search_on:
            from ..obs.lineage import LineageLanes, OperatorTable
            from ..search.corpus import CorpusState

            if lineage_on != ("srch_lin_p1" in resume_aux):
                raise ckpt.CheckpointError(
                    f"checkpoint {checkpoint_path!r} was written with "
                    f"lineage "
                    f"{'on' if 'srch_lin_p1' in resume_aux else 'off'} "
                    f"but this resume runs SearchConfig(lineage="
                    f"{lineage_on}): the provenance lanes cannot be "
                    "reconciled — resume with the original lineage "
                    "setting")

            def aux_t(name, dtype):
                return from_numpy(
                    np.asarray(resume_aux[name], dtype), dev)

            slot_sched = aux_t("srch_sched", np.int32)
            corpus = CorpusState(
                sched=aux_t("srch_c_sched", np.int32),
                # The port carries the u32 signatures in int64.
                sig=from_numpy(np.asarray(
                    resume_aux["srch_c_sig"], np.uint32).astype(np.int64),
                    dev),
                score=aux_t("srch_c_score", np.int32),
                filled=aux_t("srch_c_filled", bool),
                gen=aux_t("srch_c_gen", np.int32).reshape(()),
                inserted=aux_t("srch_c_inserted", np.int32).reshape(()),
                entry=aux_t("srch_c_entry", np.int32),
                depth=aux_t("srch_c_depth", np.int32))
            if "srch_ret" in resume_aux:
                retired_sched.append(
                    np.asarray(resume_aux["srch_ret"], np.int32))
            if lineage_on:
                slot_lin = LineageLanes(
                    p1=aux_t("srch_lin_p1", np.int32),
                    p2=aux_t("srch_lin_p2", np.int32),
                    ops=aux_t("srch_lin_ops", np.int8),
                    depth=aux_t("srch_lin_depth", np.int32))
                op_tab = OperatorTable(
                    produced=aux_t("srch_op_produced", np.int32),
                    novel=aux_t("srch_op_novel", np.int32),
                    survived=aux_t("srch_op_survived", np.int32))
                if "srch_ret_lin_p1" in resume_aux:
                    retired_lin.append(tuple(
                        np.asarray(resume_aux[f"srch_ret_lin_{k}"])
                        for k in ("p1", "p2", "ops", "depth")))
    if cov_on and resumed:
        if "cov_hits" in resume_aux:
            # A recycled file holds the ledger itself (its refilled slots
            # no longer carry the retired worlds' histograms).
            cov_hits = from_numpy(
                np.asarray(resume_aux["cov_hits"], np.int32), dev)
            cov_first = from_numpy(
                np.asarray(resume_aux["cov_first"], np.int32), dev)
        else:
            # The worlds frozen before the snapshot never fall inactive in
            # this call: fold them now. The ledger (counts and minima) is
            # fold-order invariant, so it ends as an unbroken run's.
            cov_hits, cov_first = _fold_end(state, cov_hits, cov_first,
                                            idx, n, False)

    def emit_point(n_act: int, bug_seen: bool, depth: int) -> None:
        """One ``madsim.sweep.telemetry/1`` record per host read of the
        loop scalars (host data only — never a device pull)."""
        if emit_telemetry is None:
            return
        elapsed = perf_counter() - t_loop0
        done = int(min(max(cursor - n_act, 0), n))
        rate = done / elapsed if elapsed > 0 else 0.0
        remaining = n - done
        rec = {
            "schema": "madsim.sweep.telemetry/1",
            "elapsed_s": round(elapsed, 6),
            "chunks": int(chunks),
            "steps": int(steps),
            "batch_worlds": int(w_cur),
            "n_active": int(n_act),
            "occupancy": round(n_act / w_cur, 4) if w_cur else 0.0,
            "seeds_total": int(n),
            "seeds_admitted": int(min(cursor, n)),
            "seeds_done": done,
            "seeds_per_s": round(rate, 2),
            # Running lower bound: a retiring tail is attributed at its
            # pull, so mid-loop utilization trails the final one.
            "world_utilization": (round(
                live_world_steps / issued_slot_steps, 4)
                if issued_slot_steps else 0.0),
            "dispatch_depth": int(depth),
            "bug_seen": bool(bug_seen),
            "eta_s": (round(remaining / rate, 3) if rate > 0
                      and remaining > 0 else
                      (0.0 if remaining == 0 else None)),
        }
        if cov_on:
            rec["coverage_distinct"] = (int(novelty_hist[-1])
                                        if novelty_hist else 0)
            rec["coverage_buckets"] = cov_k
        if search_on:
            rec["search_corpus"] = search_host["corpus_size"]
            rec["search_inserted"] = search_host["inserted"]
        emit_telemetry(rec)

    def emit_search_point(op_h) -> None:
        """One ``madsim.search.telemetry/1`` record per guided refill (per
        mega-dispatch in the fused loop), from the values its pull already
        fetched. ``op_h`` is the pulled operator table (None with lineage
        off, and in the fused loop, which pulls it only at the end)."""
        if emit_telemetry is None or not search_on:
            return
        from ..obs.lineage import OP_NAMES, SEARCH_TELEMETRY_SCHEMA

        rec = {
            "schema": SEARCH_TELEMETRY_SCHEMA,
            "event": "refill",
            "elapsed_s": round(perf_counter() - t_loop0, 6),
            "generation": search_host["gen"],
            "corpus_size": search_host["corpus_size"],
            "corpus_inserted": search_host["inserted"],
            "refill_novel": search_host["refill_novel"],
            "refill_inserted": search_host["refill_inserted"],
        }
        if "epochs_on_device" in search_host:
            # Fused loop: the rollup of the mega-dispatch's last refill.
            rec["epochs_on_device"] = search_host["epochs_on_device"]
        if op_h is not None:
            for row, vals in zip(("produced", "novel", "survived"), op_h):
                arr = np.asarray(vals)
                for i, name in enumerate(OP_NAMES):
                    rec[f"op_{row}_{name}"] = int(arr[i])
        emit_telemetry(rec)

    def mirror_search_stats(stats_h) -> None:
        """Refresh the corpus mirrors from a pulled stats tuple (corpus
        size and inserts; with lineage also generation and the refill's
        novel and inserted counts)."""
        search_host["corpus_size"] = int(stats_h[0])
        search_host["inserted"] = int(stats_h[1])
        if len(stats_h) > 2:
            search_host["gen"] = int(stats_h[2])
            search_host["refill_novel"] = int(stats_h[3])
            search_host["refill_inserted"] = int(stats_h[4])

    def retire(obs_slice: Dict[str, np.ndarray], rows: np.ndarray,
               sched_slice: Optional[np.ndarray] = None,
               lin_slice: Optional[tuple] = None) -> None:
        """Record the final observations of rows leaving the batch (dead
        slots, retired earlier, are filtered out by their -1 id), and on a
        guided sweep their schedules and lineage lanes."""
        nonlocal live_world_steps
        keep = rows >= 0
        if not keep.all():
            rows = rows[keep]
            obs_slice = {k: np.asarray(v)[keep] for k, v in obs_slice.items()}
            if sched_slice is not None:
                sched_slice = np.asarray(sched_slice)[keep]
            if lin_slice is not None:
                lin_slice = tuple(np.asarray(a)[keep] for a in lin_slice)
        if rows.size == 0:
            return
        live_world_steps += int(np.asarray(obs_slice["steps"]).sum())
        retired_rows.append(rows)
        for k, v in obs_slice.items():
            retired.setdefault(k, []).append(np.asarray(v))
        if sched_slice is not None:
            retired_sched.append(np.asarray(sched_slice, np.int32))
        if lin_slice is not None:
            retired_lin.append(tuple(np.asarray(a) for a in lin_slice))

    def fetch_retire(handles) -> None:
        """Pull a retiring tail's gathered rows (one ``_fetch``, with a
        guided refill's schedules, lineage lanes, corpus scalars and
        operator table) and record them."""
        obs_t, idx_t, tail_len, sched_t, stats_t, lin_t, op_t = handles
        t0 = perf_counter()
        obs_h, idx_h, sched_h, stats_h, lin_h, op_h = _fetch(
            (obs_t, idx_t, sched_t, stats_t, lin_t, op_t))
        perf["retire_wait_s"] += perf_counter() - t0
        perf["retire_fetches"] += 1
        if stats_h is not None:
            mirror_search_stats(stats_h)
            emit_search_point(op_h)
        retire({k: np.asarray(v)[:tail_len] for k, v in obs_h.items()},
               np.asarray(idx_h)[:tail_len],
               (np.asarray(sched_h)[:tail_len]
                if sched_h is not None else None),
               (tuple(np.asarray(a)[:tail_len] for a in lin_h)
                if lin_h is not None else None))

    def do_refill(n_act: int):
        """Recycling: compact active-first on the device, gather the frozen
        tail's observations, refill the tail with the next seeds from the
        cursor. Only the n_act scalar shapes the refill mask; the tail's
        rows are returned as handles, not pulled.

        A guided refill also gathers the tail's schedules and lineage
        lanes, runs the searcher on the device (the fold of the retiring
        worlds into the corpus, then one child schedule per slot) and
        refills the slots with the children (``DeviceEngine.refill``'s
        device-schedule path)."""
        nonlocal state, idx, cursor, reordered, slot_sched, slot_lin, \
            corpus, op_tab
        extra = ((slot_sched,) + (tuple(slot_lin) if lineage_on else ())
                 if search_on else ())
        # The epoch works on the whole world axis, gathered on the lead
        # device, and splits the batch again at its end.
        whole, idx, *extra = _compactor(state.gather(), idx, extra=extra)
        reordered = True
        tail_len = w_cur - n_act
        rows = min(_pow2_at_least(tail_len), _pow2_at_least(w_cur))
        obs_t, idx_t = _tail_observer(eng, whole, idx, n_act, rows)
        take = min(tail_len, n_ids - cursor)
        repl = np.full(w_cur, -1, np.int32)
        repl[n_act:n_act + take] = np.arange(
            cursor, cursor + take, dtype=np.int32)
        cursor += take
        mask = np.zeros(w_cur, bool)
        mask[n_act:n_act + take] = True
        fill_ids = np.maximum(repl, 0)
        sched_t = stats_t = lin_t = op_t = None
        if search_on:
            slot_sched = extra[0]
            tail_g = [_rows_from(x, n_act, rows) for x in extra]
            sched_t = tail_g[0]
            mask_d = torch.from_numpy(mask).to(dev)
            new_ids = torch.from_numpy(fill_ids.astype(np.int32)).to(dev)
            gen_fn = searcher(eng, search, w_cur, f_rows)
            if lineage_on:
                slot_lin = type(slot_lin)(*extra[1:])
                lin_t = tuple(tail_g[1:])
                children, child_lin, corpus, op_tab, stats_t = gen_fn(
                    whole, slot_sched, idx, corpus, n_act, new_ids, mask_d,
                    slot_lin, op_tab, search_lin_base)
                op_t = op_tab
                slot_lin = type(slot_lin)(*(
                    torch.where(mask_d, c, s)
                    for c, s in zip(child_lin, slot_lin)))
            else:
                children, corpus, stats_t = gen_fn(
                    whole, slot_sched, idx, corpus, n_act, new_ids)
            whole = eng.refill(whole, mask, seeds_p[fill_ids],
                               faults=children)
            slot_sched = torch.where(mask_d[:, None, None], children,
                                     slot_sched)
        else:
            whole = eng.refill(whole, mask, seeds_p[fill_ids],
                               faults=batch_faults(fill_ids))
        state = shard_worlds(whole, mesh)
        tail = torch.from_numpy(np.arange(w_cur) >= n_act).to(dev)
        idx = torch.where(tail, torch.from_numpy(repl).to(dev), idx)
        return obs_t, idx_t, tail_len, sched_t, stats_t, lin_t, op_t

    def do_shrink(new_w: int):
        """Shrink compaction: permute active-first, split off the frozen
        tail and keep the head (a guided sweep's schedules and lanes
        split with it); returns the tail's observation handles."""
        nonlocal state, idx, reordered, w_cur, slot_sched, slot_lin
        extra = ((slot_sched,) + (tuple(slot_lin) if lineage_on else ())
                 if search_on else ())
        (live, idx, *live_x), (frozen, fidx, *frozen_x) = _compactor(
            state.gather(), idx, new_w, extra=extra)
        state = shard_worlds(live, mesh)
        reordered = True
        tail_len = w_cur - new_w
        w_cur = new_w
        obs_t, idx_t = _observer(eng, frozen, fidx)
        fsched = flin = None
        if search_on:
            slot_sched, fsched = live_x[0], frozen_x[0]
            if lineage_on:
                slot_lin = type(slot_lin)(*live_x[1:])
                flin = tuple(frozen_x[1:])
        return obs_t, idx_t, tail_len, fsched, None, flin, None

    def ckpt_aux(cov_pair):
        """A recycled checkpoint's sweep-level aux, taken at the submit
        point, where the host's cursor, index and retired rows agree with
        the submitted state (the pending retires drained; the pipelined
        loop's submits gated on the epoch). The device values ride as
        tensors the writer copies at submit and pulls itself; the retired
        rows as lists it concatenates. The names are the JAX package's."""
        if not recycle:
            return None
        aux: Dict[str, Any] = {"cursor": np.int64(cursor), "idx": idx}
        if cov_pair is not None:
            aux["cov_hits"], aux["cov_first"] = cov_pair
        if retired_rows:
            aux["ret_rows"] = list(retired_rows)
            for k, v in retired.items():
                aux[f"ret_{k}"] = list(v)
        if search_on:
            # The search's state changes only at an epoch's refill.
            aux["srch_sched"] = slot_sched
            for f in corpus._fields:
                aux[f"srch_c_{f}"] = getattr(corpus, f)
            # The port carries the u32 signatures in int64; the file holds
            # JAX's uint32.
            aux["srch_c_sig"] = _wrap_i32(corpus.sig).view(torch.uint32)
            if retired_sched:
                aux["srch_ret"] = list(retired_sched)
            if lineage_on:
                for k, v in zip(("p1", "p2", "ops", "depth"), slot_lin):
                    aux[f"srch_lin_{k}"] = v
                for k, v in zip(("produced", "novel", "survived"),
                                op_tab):
                    aux[f"srch_op_{k}"] = v
                if retired_lin:
                    for i, k in enumerate(("p1", "p2", "ops", "depth")):
                        aux[f"srch_ret_lin_{k}"] = [t[i]
                                                    for t in retired_lin]
        return aux

    fused_epochs = 0                   # refill epochs run on the device
    fused_k_bucket = 0                 # chunk window per mega-dispatch
    fused_out = None

    def fused_read(k_done: int, n_act: int, bug: bool, cur: int, ep: int,
                   stats_h, cov_all: List[int]) -> None:
        """The fused loop's host mirrors after each mega-dispatch's read,
        and its telemetry: the search record when a refill ran on the
        device since the last read, then the progress record."""
        nonlocal chunks, steps, issued_slot_steps, cursor, novelty_hist, \
            fused_epochs
        chunks += k_done
        steps = chunks * chunk_steps
        issued_slot_steps += w_cur * chunk_steps * k_done
        cursor = cur
        novelty_hist = cov_all
        if search_on and ep > fused_epochs:
            mirror_search_stats(stats_h)
            search_host["epochs_on_device"] = ep
            emit_search_point(None)
        fused_epochs = ep
        emit_point(n_act, bug, 0)

    if fused:
        try:
            fused_out = _fused_hunt(
                eng, mesh, state, idx, seeds_p, n, faults_p,
                per_world_faults, search,
                lineage_on, cov_k if cov_on else None, cov_hits, cov_first,
                slot_sched, corpus, slot_lin, op_tab, recycle=recycle,
                chunk_steps=chunk_steps, c_max=c_max,
                stop_on_first_bug=stop_on_first_bug,
                lin_base=search_lin_base, perf=perf, prof=prof,
                on_read=fused_read)
        finally:
            prof.close()   # idempotent; stops a capture an error left open
        state = fused_out["state"]
        fused_k_bucket = fused_out["k_bucket"]
        n_active_hist = fused_out["hist"]
        n_active_chunk = list(range(chunks))
        cov_hits, cov_first = fused_out["cov"]
        idx = fused_out["idx"]
    else:
        writer = (_AsyncCheckpointer(eng, checkpoint_path, seeds_meta)
                  if checkpoint_path else None)
        try:
            if pipeline:
                # -- the pipelined superstep loop (JAX's pipelined branch)
                k_cur = 1  # adaptive superstep size (chunks)
                epoch = 0  # bumps on every refill/shrink
                epoch_fresh = True  # next dispatch is its epoch's first
                ckpt_mark = 0  # checkpoint periods covered
                inflight: Optional[_Flight] = None
                pending_retires: list = []
                stop = False

                def threshold() -> int:
                    """The on-device early-exit occupancy for the next
                    dispatch: half the batch where a refill or shrink could
                    fire, else 0 (run until every world retired). A writer
                    turns the dry-cursor shrink off (a shrunken snapshot
                    could not resume), so the tail then runs at full
                    width."""
                    if recycle and cursor < n_ids:
                        return w_cur // 2
                    if (compact or (recycle and writer is None)) \
                            and w_cur % 2 == 0 \
                            and (w_cur // 2) % n_dev == 0:
                        return w_cur // 2
                    return 0

                def dispatch(reserve: int = 0) -> None:
                    """Queue one superstep on the current state (never waits
                    on the device). ``reserve``: the planned chunks of a
                    superstep queued but not yet read, counted as spent so
                    that a binding ``max_steps`` cannot overrun the serial
                    loop's chunk budget."""
                    nonlocal state, inflight, epoch_fresh, cov_hits, cov_first
                    budget = c_max - chunks - reserve
                    k = max(1, min(k_cur, budget, superstep_max))
                    if writer is not None and checkpoint_every_chunks:
                        k = min(k, checkpoint_every_chunks)
                    # The first dispatch of an occupancy epoch runs exactly one
                    # chunk, whatever the occupancy (the serial cadence after
                    # a refill or shrink); the dispatches ahead of a read
                    # keep the entry test, so a stale one is a pass-through.
                    if epoch_fresh:
                        k = 1
                    min_one = epoch_fresh
                    epoch_fresh = False
                    runner = sharded_superstep(
                        eng, mesh, chunk_steps, superstep_max,
                        min_one=min_one,
                        coverage=cov_k if cov_on else None)
                    t0 = perf_counter()
                    prof.before_dispatch()
                    with prof.annotate("madsim:superstep"):
                        if cov_on:
                            (state, any_bug, n_active, k_done, hist,
                             cov_hits, cov_first, cov_h) = runner(
                                state, cov_hits, cov_first, idx, n,
                                threshold(), bool(stop_on_first_bug), k)
                        else:
                            state, any_bug, n_active, k_done, hist = runner(
                                state, threshold(), bool(stop_on_first_bug),
                                k)
                            cov_h = None
                    # The state changes in place and the next superstep is
                    # queued before this one is read: where this one could
                    # cross a checkpoint mark, copy its output (and the
                    # ledger beside it) now, in stream order. It can bring
                    # the count to chunks + reserve + k at most, so no mark
                    # that the read finds lacks its copy.
                    snap = snap_cov = None
                    if writer is not None and checkpoint_every_chunks and \
                            (chunks + reserve + k) \
                            // checkpoint_every_chunks > ckpt_mark:
                        snap = writer.snapshot(state.gather())
                        if cov_on:
                            snap_cov = _copy_tree((cov_hits, cov_first))
                    perf["dispatch_s"] += perf_counter() - t0
                    perf["dispatches"] += 1
                    inflight = _Flight(any_bug, n_active, k_done, hist, k,
                                       w_cur, epoch, cov_h, snap, snap_cov)

                # max_steps <= 0 is a zero-chunk budget: nothing is dispatched.
                if c_max > 0:
                    dispatch()
                while inflight is not None:
                    prev, inflight = inflight, None
                    # Dispatch-ahead: superstep k+1 is queued before
                    # superstep k's scalars are read; if they call for a stop
                    # or a refill, k+1 is a pass-through (its entry
                    # condition is already false).
                    if not stop and chunks + prev.planned < c_max:
                        dispatch(reserve=prev.planned)
                    t0 = perf_counter()
                    bug_h, n_act_h, k_done_h, hist_h, cov_h = _fetch(
                        (prev.any_bug, prev.n_active, prev.k_done, prev.hist,
                         prev.cov_hist))
                    perf["device_wait_s"] += perf_counter() - t0
                    perf["scalar_fetches"] += 1
                    prof.after_read()
                    perf["dispatch_depth"] = max(
                        perf["dispatch_depth"],
                        1 if inflight is not None else 0)
                    # Retirement pulls deferred from earlier refills and
                    # shrinks.
                    while pending_retires:
                        fetch_retire(pending_retires.pop(0))
                    t0 = perf_counter()
                    k_done = int(k_done_h)
                    n_act = int(n_act_h)
                    hist_np = np.asarray(hist_h)
                    for j in range(k_done):
                        n_active_hist.append(int(hist_np[j]))
                        n_active_chunk.append(chunks + j)
                        if cov_on:
                            novelty_hist.append(int(np.asarray(cov_h)[j]))
                    chunks += k_done
                    steps = chunks * chunk_steps
                    issued_slot_steps += prev.w * chunk_steps * k_done
                    if prev.epoch == epoch:
                        # Adaptive K: double while supersteps run to plan, and
                        # after an early exit settle on the chunks it ran.
                        if k_done == prev.planned:
                            k_cur = min(k_cur * 2, superstep_max)
                        else:
                            k_cur = max(k_done, 1)
                    if writer is not None and checkpoint_every_chunks and \
                            prev.epoch == epoch and \
                            chunks // checkpoint_every_chunks > ckpt_mark:
                        # Only a superstep of the current epoch: a stale
                        # pass-through's state predates the refill that the
                        # host's index and cursor already reflect (the
                        # current epoch's next superstep submits).
                        if prev.out_state is None:
                            raise RuntimeError(
                                "internal: a superstep crossed a "
                                "checkpoint mark without a snapshot")
                        writer.submit(prev.out_state,
                                      ckpt_aux(prev.out_cov))
                        submitted_chunks = chunks
                        ckpt_mark = chunks // checkpoint_every_chunks
                    if prev.epoch == epoch and not stop:
                        more_seeds = cursor < n_ids
                        if n_act == 0 and not more_seeds:
                            stop = True
                        elif stop_on_first_bug and bool(bug_h):
                            stop = True
                        elif recycle and more_seeds and n_act <= w_cur // 2:
                            pending_retires.append(do_refill(n_act))
                            epoch += 1
                            epoch_fresh = True
                        else:
                            new_w = _compact_bucket(n_act, w_cur, n_dev)
                            # The dry-cursor shrink only without a writer.
                            if (compact or (recycle and not more_seeds
                                            and writer is None)) \
                                    and new_w < w_cur:
                                pending_retires.append(do_shrink(new_w))
                                epoch += 1
                                epoch_fresh = True
                    perf["host_decision_s"] += perf_counter() - t0
                    emit_point(n_act, bool(bug_h),
                               1 if inflight is not None else 0)
                    if stop:
                        break
                    if inflight is None and chunks < c_max:
                        dispatch()
                while pending_retires:
                    fetch_retire(pending_retires.pop(0))
            else:
                # -- the serial per-chunk loop -----------------------------
                runner = sharded_engine(eng, mesh, chunk_steps,
                                        coverage=cov_k if cov_on else None)
                while steps < max_steps:
                    t0 = perf_counter()
                    prof.before_dispatch()
                    with prof.annotate("madsim:chunk"):
                        if cov_on:
                            (state, any_bug, n_active, cov_hits, cov_first,
                             distinct) = runner(state, cov_hits, cov_first,
                                                idx, n)
                        else:
                            distinct = None
                            state, any_bug, n_active = runner(state)
                    perf["dispatch_s"] += perf_counter() - t0
                    perf["dispatches"] += 1
                    steps += chunk_steps
                    chunks += 1
                    issued_slot_steps += w_cur * chunk_steps
                    if writer is not None and checkpoint_every_chunks and \
                            chunks % checkpoint_every_chunks == 0:
                        # The copy is queued now; the pull and the write
                        # overlap the next chunks.
                        writer.submit(state.gather(), ckpt_aux(
                            (cov_hits, cov_first) if cov_on else None))
                        submitted_chunks = chunks
                    t0 = perf_counter()
                    if cov_on:
                        n_act_h, bug_h, dist_h = _fetch((n_active, any_bug,
                                                         distinct))
                    else:
                        n_act_h, bug_h = _fetch((n_active, any_bug))
                    perf["device_wait_s"] += perf_counter() - t0
                    perf["scalar_fetches"] += 1
                    prof.after_read()
                    n_act = int(n_act_h)
                    if cov_on:
                        novelty_hist.append(int(dist_h))
                    emit_point(n_act, bool(bug_h), 0)
                    t0 = perf_counter()
                    n_active_hist.append(n_act)
                    n_active_chunk.append(chunks - 1)
                    more_seeds = cursor < n_ids
                    if n_act == 0 and not more_seeds:
                        perf["host_decision_s"] += perf_counter() - t0
                        break
                    if stop_on_first_bug and bool(bug_h):
                        perf["host_decision_s"] += perf_counter() - t0
                        break
                    if recycle and more_seeds and n_act <= w_cur // 2:
                        handles = do_refill(n_act)
                        perf["host_decision_s"] += perf_counter() - t0
                        fetch_retire(handles)
                        continue
                    new_w = _compact_bucket(n_act, w_cur, n_dev)
                    if (compact or (recycle and not more_seeds
                                    and writer is None)) and new_w < w_cur:
                        handles = do_shrink(new_w)
                        perf["host_decision_s"] += perf_counter() - t0
                        fetch_retire(handles)
                    else:
                        perf["host_decision_s"] += perf_counter() - t0
            if writer is not None and submitted_chunks != chunks:
                # The final state is always durable.
                writer.submit(state.gather(), ckpt_aux(
                    (cov_hits, cov_first) if cov_on else None))
            if writer is not None:
                writer.flush_and_close()
                writer = None
        finally:
            prof.close()
            if writer is not None:     # an exception in flight: keep it
                writer.flush_and_close(suppress_errors=True)

    if cov_on:
        # End-of-sweep fold: worlds still live at exit count too.
        cov_hits, cov_first = _fold_end(state, cov_hits, cov_first, idx,
                                        n, True)

    sched_per_seed = lin_per_seed = corpus_h = op_tab_h = None
    cov_hits_h = cov_first_h = None
    if fused:
        # The fused hunt's one pull at the end: retired and live rows
        # already sit in the per-seed device buffers.
        t0 = perf_counter()
        (bufs_h, cov_pack_h, sched_b_h, corpus_h, lin_b_h,
         op_tab_h) = _fetch(
            (fused_out["bufs"], (cov_hits, cov_first) if cov_on else None,
             fused_out["sched_buf"], fused_out["corpus"],
             fused_out["lin_buf"], fused_out["op_tab"]))
        perf["retire_wait_s"] += perf_counter() - t0
        perf["retire_fetches"] += 1
        if cov_on:
            cov_hits_h, cov_first_h = (np.asarray(x) for x in cov_pack_h)
        obs = {k: np.asarray(v)[:n_ids] for k, v in bufs_h.items()}
        live_world_steps += int(np.asarray(obs["steps"]).sum())
        if search_on:
            sched_per_seed = np.asarray(sched_b_h, np.int32)[:n_ids]
        if lineage_on:
            lin_per_seed = tuple(np.asarray(a, np.int32)[:n_ids]
                                 for a in lin_b_h)
    else:
        obs_live = eng.observe(state.gather())
        sched_live_h = lin_live_h = None
        if cov_on and search_on:
            # The search's per-slot state rides the final ledger pull.
            (idx_h, cov_hits_h, cov_first_h, sched_live_h, corpus_h,
             lin_live_h, op_tab_h) = _fetch(
                (idx, cov_hits, cov_first, slot_sched, corpus, slot_lin,
                 op_tab))
            idx_h, cov_hits_h, cov_first_h = (
                np.asarray(x) for x in (idx_h, cov_hits_h, cov_first_h))
            sched_live_h = np.asarray(sched_live_h, np.int32)
        elif cov_on:
            idx_h, cov_hits_h, cov_first_h = (
                np.asarray(x) for x in _fetch((idx, cov_hits, cov_first)))
        else:
            idx_h = np.asarray(_fetch(idx))
        live_keep = idx_h >= 0
        live_world_steps += int(
            np.asarray(obs_live["steps"])[live_keep].sum())
        # Scatter whenever the live batch does not cover the id space in
        # seed order: after a reorder or retirement, or when a recycled
        # sweep stopped before its first refill (seeds never admitted read
        # zero).
        if reordered or retired_rows or w0 < n_ids:
            rows = np.concatenate(retired_rows + [idx_h[live_keep]])
            obs = {}
            for k, v_live in obs_live.items():
                v_live = np.asarray(v_live)[live_keep]
                merged = np.concatenate(retired.get(k, []) + [v_live],
                                        axis=0)
                out = np.zeros((n_ids,) + merged.shape[1:], merged.dtype)
                out[rows] = merged
                obs[k] = out
            if search_on:
                merged_s = np.concatenate(
                    retired_sched + [sched_live_h[live_keep]], axis=0)
                sched_per_seed = np.full((n_ids,) + merged_s.shape[1:], -1,
                                         np.int32)
                sched_per_seed[:, :, 1:] = 0     # canonical disabled rows
                sched_per_seed[rows] = merged_s
            if lin_live_h is not None:
                # Never-admitted seeds read as generation 0.
                lanes_out = []
                for i, dflt in enumerate((-1, -1, 0, 0)):
                    merged_l = np.concatenate(
                        [t[i] for t in retired_lin]
                        + [np.asarray(lin_live_h[i])[live_keep]], axis=0)
                    out = np.full((n_ids,), dflt, np.int32)
                    out[rows] = np.asarray(merged_l, np.int32)
                    lanes_out.append(out)
                lin_per_seed = tuple(lanes_out)
        else:
            obs = obs_live
            if search_on:
                sched_per_seed = sched_live_h
            if lin_live_h is not None:
                lin_per_seed = tuple(np.asarray(a, np.int32)
                                     for a in lin_live_h)
    # The padded worlds' rows go.
    obs = {k: v[:n] for k, v in obs.items()}
    if sched_per_seed is not None:
        sched_per_seed = sched_per_seed[:n]
    if lin_per_seed is not None:
        lin_per_seed = tuple(a[:n] for a in lin_per_seed)
    util = (live_world_steps / issued_slot_steps if issued_slot_steps
            else 0.0)
    loop_stats = {
        "pipelined": bool(pipeline) and not fused,
        "fused": bool(fused),
        "superstep_max": (int(fused_k_bucket) if fused
                          else int(superstep_max) if pipeline else 1),
        "chunk_steps": int(chunk_steps),
        "chunks": int(chunks),
        "dispatches": int(perf["dispatches"]),
        "chunks_per_dispatch": round(
            chunks / max(perf["dispatches"], 1), 3),
        "dispatches_per_seed": round(perf["dispatches"] / max(n, 1), 6),
        "seeds_per_dispatch": round(n / max(perf["dispatches"], 1), 3),
        "epochs_on_device": int(fused_epochs),
        "dispatch_depth": int(perf["dispatch_depth"]),
        "device_wait_s": round(perf["device_wait_s"], 6),
        "host_decision_s": round(perf["host_decision_s"], 6),
        "dispatch_s": round(perf["dispatch_s"], 6),
        "retire_wait_s": round(perf["retire_wait_s"], 6),
        "scalar_fetches": int(perf["scalar_fetches"]),
        "retire_fetches": int(perf["retire_fetches"]),
        # The device flags the host read (Lookahead), each a wait on the
        # device that _fetch does not count: 0 in the serial loop.
        "flag_reads": int(Lookahead.host_reads - flag_reads0),
        "loop_wall_s": round(perf_counter() - t_loop0, 6),
    }
    coverage = (coverage_from_device(cov_k, cov_hits_h, cov_first_h,
                                     novelty_hist) if cov_on else None)
    search_report = None
    triage_faults = faults
    if search_on:
        search_report = _search_report(corpus_h, sched_per_seed,
                                       lin_per_seed, op_tab_h, obs["bug"],
                                       search_gen0, search_lin_base)
        # Triage replays the schedule each world actually ran.
        triage_faults = sched_per_seed
    result = SweepResult(
        seeds=seeds, bug=obs["bug"], observations=obs, steps_run=steps,
        n_devices=n_dev,
        n_active_history=np.asarray(n_active_hist, np.int64),
        world_utilization=util,
        n_active_chunks=np.asarray(n_active_chunk, np.int64),
        loop_stats=loop_stats,
        faults_sha256=faults_sha256 if faults is not None else None,
        coverage=coverage, search=search_report,
        triage_ctx=TriageContext(engine=eng, faults=triage_faults,
                                 mesh=mesh))
    if emit_telemetry is not None:
        final = {
            "schema": "madsim.sweep.telemetry/2",
            "event": "summary",
            "elapsed_s": loop_stats["loop_wall_s"],
            "seeds_total": int(n),
            "failing_seeds": len(result.failing_seeds),
            "world_utilization": round(util, 4),
            # The dispatch economics, top-level for the Prometheus
            # renderer (it exports top-level numerics only).
            "seeds_per_dispatch": loop_stats["seeds_per_dispatch"],
            "epochs_on_device": loop_stats["epochs_on_device"],
            "loop_stats": loop_stats,
        }
        if coverage is not None:
            final["coverage"] = coverage.to_json()
        if search_report is not None:
            final["search"] = search_report.to_json()
            if search_report.lineage is not None and result.failing_seeds:
                # The first finds' derivations, so `obs lineage <stream>`
                # renders ancestry without the SweepResult.
                from ..obs.lineage import lineage_block

                rows = np.flatnonzero(np.asarray(result.bug))[:8]
                final["search"]["finds"] = [
                    lineage_block(search_report.lineage, int(r),
                                  seeds=np.asarray(result.seeds))
                    for r in rows]
        emit_telemetry(final)
    if close_telemetry is not None:
        close_telemetry()
    return result


def _search_report(corpus_h, sched_per_seed, lin_per_seed, op_tab_h,
                   bug, search_gen0: int, search_lin_base: int):
    """The guided sweep's :class:`~madsim_tpu_torch.search.SearchReport`:
    the pulled corpus, the per-seed schedules and lanes, and the operator
    table with its bug row folded from the lanes."""
    from ..search import SearchReport

    lineage_rep = op_stats = None
    if lin_per_seed is not None:
        from ..obs.lineage import (
            N_OPS,
            SearchLineage,
            host_credit,
            operator_stats,
        )

        lineage_rep = SearchLineage(
            parent1=lin_per_seed[0], parent2=lin_per_seed[1],
            ops=lin_per_seed[2], depth=lin_per_seed[3],
            entry_base=int(search_lin_base))
        # A find that stopped the sweep, or sat live at its end, never
        # crossed a harvest: the bug row folds over the per-seed lanes.
        op_bug = host_credit(np.zeros(N_OPS, np.int32), lineage_rep.ops,
                             np.asarray(bug, bool))
        op_stats = operator_stats(*(tuple(np.asarray(a) for a in op_tab_h)
                                    + (op_bug,)))
    c_filled = np.asarray(corpus_h.filled, bool)
    return SearchReport(
        # Generations this sweep ran: search_gen0 shifts the key space.
        generations=int(np.asarray(corpus_h.gen)) - int(search_gen0),
        inserted=int(np.asarray(corpus_h.inserted)),
        corpus_size=int(c_filled.sum()),
        corpus_capacity=int(c_filled.shape[0]),
        corpus_sched=np.asarray(corpus_h.sched, np.int32),
        corpus_sig=np.asarray(corpus_h.sig).astype(np.uint32),
        corpus_score=np.asarray(corpus_h.score, np.int32),
        corpus_filled=c_filled,
        schedules=sched_per_seed,
        corpus_entry=np.asarray(corpus_h.entry, np.int32),
        corpus_depth=np.asarray(corpus_h.depth, np.int32),
        lineage=lineage_rep,
        operator_stats=op_stats)



class _Flight(NamedTuple):
    """One queued but unread superstep: its device scalars and the host
    facts (plan, width, epoch) needed to read them."""

    any_bug: Any
    n_active: Any
    k_done: Any
    hist: Any
    planned: int          # chunks this dispatch may run (its K)
    w: int                # batch width at dispatch time
    epoch: int            # occupancy epoch at dispatch time
    cov_hist: Any = None  # per-chunk novelty curve (coverage on)
    # The checkpoint writer's copy of the superstep's output state, and of
    # the ledger beside it, where it could cross a checkpoint mark.
    out_state: Any = None
    out_cov: Any = None


# The most chunks one fused mega-dispatch runs (its history's width), as in
# the JAX package.
_FUSED_K_CAP = 4096


def _put_rows(buf: torch.Tensor, rows: torch.Tensor,
              vals: torch.Tensor) -> torch.Tensor:
    """``buf[rows] = vals`` along the world axis, in place (uint32 as its
    int32 bits)."""
    if buf.dtype == torch.uint32:
        buf.view(torch.int32).index_put_((rows,), vals.view(torch.int32))
    else:
        buf.index_put_((rows,), vals.to(buf.dtype))
    return buf


def _upload(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host array on ``dev``; to a CUDA device through pinned memory,
    so the copy does not wait for the stream to drain."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dev.type != "cuda":
        return t.clone()
    return t.pin_memory().to(dev, non_blocking=True)


def _fused_hunt(eng: DeviceEngine, mesh: Mesh, state, idx,
                seeds: np.ndarray, n_real: int, faults_p,
                per_world_faults: bool, scfg, lineage_on: bool,
                cov_k: Optional[int], cov_hits, cov_first, sched, corpus,
                lin, op_tab, *, recycle: bool, chunk_steps: int, c_max: int,
                stop_on_first_bug: bool, lin_base: int, perf: dict,
                prof, on_read):
    """The whole-hunt loop on the device: the counterpart of the JAX
    ``_fused_hunt`` and the fused branch of its ``sweep``.

    Each mega-dispatch runs up to ``k_bucket`` chunks behind one host
    decision. After every chunk, device ops measure the batch, fold the
    coverage of the worlds that retired in it and decide, in the serial
    loop's order, the hunt's stop (which never refills) and the epoch
    trigger. Both are gate words: a set stop, or a pending epoch, makes
    every later chunk a gated no-op. The epoch body is queued once per
    trigger, every write masked by it: the stable active-first compaction
    of the state, the slot→seed index and the search lanes; the retiring
    tail's observations (and schedules and lineage lanes) scattered by seed
    id into per-seed device buffers, with a dump row; the cursor's
    take/fill arithmetic; under search the fold kernel and the children
    (the searcher behind the same gate); the in-loop refill
    (:meth:`DeviceEngine.refill_traced`); the index, cursor and epoch count
    advanced; and it clears the pending word, so the next chunk runs after
    it in stream order. The host learns of a trigger from the flags the
    device leaves a chunk behind (:class:`Lookahead`): it reads no result
    from them, only when to queue the epoch body and when to stop queuing,
    so the chunk queued meanwhile is a no-op and every result is decided
    on the device; each such read waits on the device (the
    sweep's ``loop_stats["flag_reads"]``). The host reads one scalar batch
    per mega-dispatch (``_fetch``) and pulls the per-seed buffers once, at
    the end (the caller's pull).

    On a mesh the chunks step each block of the split batch by its own
    launches, gated by a copy of the gate word on its device, and the
    scalars and the coverage fold reduce over the blocks onto the lead
    device; the epoch body gathers the batch there, works on the whole
    world axis and splits it again (the JAX program is one GSPMD program
    over the whole axis). ``seeds`` is the seed-id space padded to the
    mesh; ``n_real`` of them are real (the coverage fold takes only
    those).

    There is no dry-cursor shrink: the tail runs at full width, so
    ``world_utilization`` is the one result that differs from the serial
    loop's. ``prof`` (obs/observatory.py ``ProfilerWindow``) wraps each
    mega-dispatch; ``on_read(k_done, n_act, bug, cursor, epochs, stats,
    novelty)`` gets each read's host values (the chunks it ran, the
    scalars, the search's stats tuple and the novelty curve so far).
    Returns a dict of the loop's device and host results; the engine's
    ``last_fused_stats`` counts the chunks queued and the host's time
    queuing epoch bodies.
    """
    from ..obs.lineage import LineageLanes, lanes_buffer

    dev = mesh.lead
    cuda = dev.type == "cuda"
    w = state.n_worlds
    n = int(seeds.shape[0])
    search_on = scfg is not None
    cov_on = cov_k is not None
    n_ids_b = _pow2_at_least(n)
    k_bucket = _pow2_at_least(max(min(c_max, _FUSED_K_CAP), 1))
    i32 = torch.int32
    # Seed and schedule tables the in-loop refill gathers from; rows past
    # n are never gathered (the cursor stops at n).
    lo = np.zeros(n_ids_b, np.uint32)
    hi = np.zeros(n_ids_b, np.uint32)
    lo[:n] = (seeds & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi[:n] = (seeds >> np.uint64(32)).astype(np.uint32)
    lo_d, hi_d = _upload(lo, dev), _upload(hi, dev)
    ftab = None
    if not search_on and faults_p is not None:
        f = np.asarray(faults_p, np.int32)
        if per_world_faults and n_ids_b > n:
            f = np.concatenate([f, f[:1].repeat(n_ids_b - n, axis=0)])
        ftab = _upload(f, dev)
    dump = n_ids_b                     # the buffers' trailing dump row
    obs0 = eng.observe_device(state.shards[0])
    bufs = {k: torch.zeros((n_ids_b + 1,) + tuple(v.shape[1:]),
                           dtype=v.dtype, device=dev)
            for k, v in obs0.items()}
    sched_buf = lin_buf = None
    f_rows = 0
    if search_on:
        f_rows = int(sched.shape[1])
        sb = np.full((n_ids_b + 1, f_rows, 4), -1, np.int32)
        sb[:, :, 1:] = 0               # canonical disabled rows
        sched_buf = _upload(sb, dev)
        gen_fn = searcher(eng, scfg, w, f_rows)
        stats = tuple(torch.zeros((), dtype=i32, device=dev)
                      for _ in range(5 if lineage_on else 2))
    if lineage_on:
        lin_buf = lanes_buffer(n_ids_b, dev)
    rows_r = torch.arange(w, dtype=i32, device=dev)
    cursor = torch.full((), w, dtype=i32, device=dev)
    epochs = torch.zeros((), dtype=i32, device=dev)
    n_t = torch.full((), n, dtype=i32, device=dev)
    n_real_t = torch.full((), n_real, dtype=i32, device=dev)
    no_more = torch.zeros((), dtype=torch.bool, device=dev)

    def more_seeds():
        return cursor < n_t if recycle else no_more

    def epoch(trigger, n_act):
        """The epoch body, every write masked by ``trigger``, over the
        whole world axis (the batch gathered on the lead device and split
        again at the end)."""
        nonlocal state, idx, cursor, epochs, sched, lin, corpus, op_tab, \
            stats
        whole = state.gather()
        order = torch.sort((~whole.active).to(i32), stable=True).indices
        perm = torch.where(trigger, order, rows_r.to(order.dtype))
        group = [whole, idx] + ([sched] if search_on else []) \
            + ([lin] if lineage_on else [])
        group = [_permute_worlds(t, perm) for t in group]
        whole, idx = group[0], group[1]
        if search_on:
            sched = group[2]
        if lineage_on:
            lin = group[3]
        tail = (rows_r >= n_act) & (idx >= 0) & trigger
        tgt = torch.where(tail, idx, dump).to(torch.int64)
        obs = eng.observe_device(whole)
        for key, buf in bufs.items():
            _put_rows(buf, tgt, obs[key])
        take = torch.minimum(w - n_act, n_t - cursor)
        fill = trigger & (rows_r >= n_act) & (rows_r < n_act + take)
        repl = torch.where(fill, cursor + rows_r - n_act, -1).to(i32)
        fill_ids = repl.clamp(min=0)
        if search_on:
            # The retiring schedules and lanes are parked before the
            # children overwrite them.
            _put_rows(sched_buf, tgt, sched)
            if lineage_on:
                for b, v in zip(lin_buf, lin):
                    _put_rows(b, tgt, v)
                children, child_lin, corpus, op_tab, new_stats = gen_fn(
                    whole, sched, idx, corpus, n_act, fill_ids, fill, lin,
                    op_tab, lin_base, gate=trigger)
                lin = LineageLanes(*(torch.where(fill, c, o)
                                     for c, o in zip(child_lin, lin)))
            else:
                children, corpus, new_stats = gen_fn(
                    whole, sched, idx, corpus, n_act, fill_ids,
                    gate=trigger)
            stats = tuple(torch.where(trigger, a, b)
                          for a, b in zip(new_stats, stats))
            f_new = children
            sched = torch.where(fill[:, None, None], children, sched)
        elif ftab is None:
            f_new = torch.zeros((w, 0, 4), dtype=i32, device=dev)
        elif per_world_faults:
            f_new = ftab.index_select(0, fill_ids)
        else:
            f_new = ftab.expand((w,) + tuple(ftab.shape))
        eng.refill_traced(whole, fill, _take(lo_d, fill_ids),
                          _take(hi_d, fill_ids), f_new)
        state = shard_worlds(whole, mesh)
        idx = torch.where(trigger & (rows_r >= n_act), repl, idx)
        cursor = cursor + torch.where(trigger, take, 0).to(i32)
        epochs = epochs + trigger.to(i32)

    chunks = epochs_h = queued = 0
    epoch_s = 0.0                      # host time queuing epoch bodies
    hist_all: List[int] = []
    cov_all: List[int] = []
    stop = False
    first = True
    # ``first`` forces one dispatch even at a zero-chunk budget: it parks
    # the live (init) observations in the buffers.
    while first or (chunks < c_max and not stop):
        first = False
        k = max(0, min(k_bucket, c_max - chunks))
        t0 = perf_counter()
        prof.before_dispatch()
        with prof.annotate("madsim:fused_hunt"):
            any_bug, n_act = block_totals(state.shards)
            # The pass-through property: a dispatch against a finished hunt
            # runs no chunk. ``done`` closes the gate for good (the hunt's
            # stop, or k chunks run); ``pending`` is an epoch the trigger
            # asked for and the host has not queued yet: no chunk runs while
            # it is set.
            done = ((any_bug & bool(stop_on_first_bug))
                    | ((n_act == 0) & ~more_seeds()))
            pending = torch.zeros((), dtype=torch.bool, device=dev)
            hist = torch.full((k_bucket,), -1, dtype=i32, device=dev)
            cov_hist = (torch.full((k_bucket,), -1, dtype=i32, device=dev)
                        if cov_on else None)
            k_done = torch.zeros((), dtype=i32, device=dev)
            # The scalars of the last chunk run, measured before its epoch.
            last_bug, last_n = any_bug, n_act
            ahead = Lookahead(cuda)
            epoch_at = -1                  # the flag index an epoch answered
            finished = k == 0
            while not finished:
                ran = ~(done | pending)
                blocks = state.shards
                act0 = ([b.active.clone() for b in blocks] if cov_on
                        else None)
                run_blocks(eng, blocks, chunk_steps, (~ran).to(i32))
                any_bug, n_act = block_totals(blocks)
                last_bug = torch.where(ran, any_bug, last_bug)
                last_n = torch.where(ran, n_act, last_n)
                pos = k_done.clamp(max=k_bucket - 1).reshape(1).to(torch.int64)
                hist.index_put_((pos,), torch.where(ran, n_act, hist[pos]))
                if cov_on:
                    cov_hits, cov_first = _fold_blocks(
                        blocks, [a & ~b.active for a, b in zip(act0, blocks)],
                        cov_hits, cov_first, idx, n_real_t)
                    cov_hist.index_put_((pos,), torch.where(
                        ran, distinct_count(cov_hits), cov_hist[pos]))
                k_done = k_done + ran.to(i32)
                stop_now = ((n_act == 0) & ~more_seeds()) \
                    | (any_bug & bool(stop_on_first_bug))
                if recycle:
                    pending = pending | (ran & ~stop_now & more_seeds()
                                         & (n_act <= w // 2))
                done = done | (ran & stop_now) | (k_done >= k)
                queued += 1
                # The host learns a chunk's flags a chunk later on CUDA: the
                # chunk queued meanwhile is a gated no-op. An epoch body is
                # queued once per trigger, masked by ``pending``, which it
                # clears; the next chunk runs after it in stream order.
                ahead.push(done.to(i32) | (pending.to(i32) << 1))
                for flag_at, flags in ahead.read():
                    if flags & 2 and flag_at > epoch_at:
                        t_ep = perf_counter()
                        epoch(pending, block_totals(state.shards)[1])
                        pending = torch.zeros_like(pending)
                        epoch_at = ahead.pushed - 1
                        epoch_s += perf_counter() - t_ep
                    finished = finished or bool(flags & 1)
            any_bug, n_act = last_bug, last_n
            # The live slots' rows are parked at the end of each dispatch; a
            # later dispatch overwrites them.
            live_tgt = torch.where(idx >= 0, idx, dump).to(torch.int64)
            obs = eng.observe_device(state.gather())
            for key, buf in bufs.items():
                _put_rows(buf, live_tgt, obs[key])
            if search_on:
                _put_rows(sched_buf, live_tgt, sched)
            if lineage_on:
                for b, v in zip(lin_buf, lin):
                    _put_rows(b, live_tgt, v)
        perf["dispatch_s"] += perf_counter() - t0
        perf["dispatches"] += 1
        t0 = perf_counter()
        # One scalar batch per mega-dispatch.
        bug_h, n_act_h, k_done_h, hist_h, cur_h, ep_h, cov_h, st_h = \
            _fetch((any_bug, n_act, k_done, hist, cursor, epochs,
                    cov_hist, stats if search_on else None))
        perf["device_wait_s"] += perf_counter() - t0
        perf["scalar_fetches"] += 1
        prof.after_read()
        t0 = perf_counter()
        k_done_i = int(k_done_h)
        hist_all.extend(int(x) for x in np.asarray(hist_h)[:k_done_i])
        if cov_on:
            cov_all.extend(int(x) for x in np.asarray(cov_h)[:k_done_i])
        chunks += k_done_i
        epochs_h = int(ep_h)
        more = recycle and int(cur_h) < n
        if (int(n_act_h) == 0 and not more) or \
                (stop_on_first_bug and bool(bug_h)) or k_done_i < k:
            stop = True
        perf["host_decision_s"] += perf_counter() - t0
        on_read(k_done_i, int(n_act_h), bool(bug_h), int(cur_h), epochs_h,
                st_h, cov_all)
    # What the loop queued, for its cost: chunks queued (past the stop
    # too) and the host's time queuing epoch bodies.
    eng.last_fused_stats = {"chunks_queued": queued, "epoch_s": epoch_s}
    return {"state": state, "idx": idx, "k_bucket": k_bucket,
            "epochs": epochs_h, "chunks": chunks, "hist": hist_all,
            "cov_hist": cov_all, "cov": (cov_hits, cov_first),
            "bufs": bufs, "sched_buf": sched_buf, "corpus": corpus,
            "lin_buf": lin_buf, "op_tab": op_tab}


# ---------------------------------------------------------------------------
# The persistent session of a fleet worker
# ---------------------------------------------------------------------------

class SweepSession:
    """A persistent sweep session: the JAX ``SweepSession``.

    A fleet worker holds one session across its leases, so the engine, the
    chunk and superstep geometry and the standing batch are set up once:

    * :meth:`run` is ``sweep()`` with the session's engine and geometry
      bound (checkpoint/resume, ``search=`` and every other sweep mode per
      lease).
    * :meth:`run_group` advances SEVERAL seed ranges as one standing batch
      and returns one ``SweepResult`` per range whose contract fields (ids,
      bug flags, observations, coverage ledger, schedule fingerprint) are
      bitwise those of a fresh ``sweep()`` of that range: worlds are
      position-independent and every range installs at chunk 0, and the
      chunks past a range's retirement are gated no-ops of frozen worlds.
      The standing slots are recycled between groups: the next group's
      worlds enter through :meth:`DeviceEngine.refill` with an all-slots
      mask, in place, when its width equals the last group's.

    The grouped loop is the solo pipelined loop's (supersteps queued a
    superstep ahead of the read, one ``_fetch`` per superstep, each
    superstep's gate word on the device), and at the end ONE ``_fetch`` of
    every range's coverage ledger and one ``observe`` pull. Any exception
    out of the loop (a fleet worker's kill or preemption is raised from
    the ``observe`` callback) drops the standing batch: launches may still
    be queued on it, and the next group installs fresh.

    ``mesh`` splits the standing batch as :func:`sweep` splits its own
    (by default the engine's device alone); each group is padded to a
    multiple of the mesh size with repeats of its first seed, as the JAX
    session pads it. Not thread-safe: one session per worker.
    """

    #: sweep() keyword arguments run_group understands; a lease whose sweep
    #: arguments leave this set runs solo through :meth:`run`.
    GROUPABLE_KW = frozenset(
        {"chunk_steps", "max_steps", "superstep_max", "coverage_buckets"})

    def __init__(self, actor: Any = None, cfg: Optional[EngineConfig] = None,
                 *, engine: Optional[DeviceEngine] = None,
                 mesh: Optional[Any] = None, chunk_steps: int = 512,
                 max_steps: int = 1_000_000, superstep_max: int = 16,
                 coverage_buckets: Optional[int] = None):
        if engine is None:
            if cfg is None:
                raise ValueError(
                    "SweepSession needs engine=DeviceEngine(...) or "
                    "(actor, cfg) to build one")
            engine = DeviceEngine(actor, cfg)
        if superstep_max < 1:
            raise ValueError("superstep_max must be >= 1")
        self.engine = engine
        self.mesh = _engine_mesh(engine, mesh)
        self.chunk_steps = int(chunk_steps)
        self.max_steps = int(max_steps)
        self.superstep_max = int(superstep_max)
        self.coverage_buckets = coverage_buckets
        #: Ranges served without a fresh per-lease setup.
        self.reuse_hits = 0
        self._runs = 0
        self._k_warm = 1          # adaptive K, carried across groups
        self._slot_state = None   # the standing batch between groups
        self._slot_w = 0

    def run(self, seeds, faults: Optional[np.ndarray] = None,
            **kw) -> SweepResult:
        """One range through the full ``sweep()`` with the session's engine
        and geometry (every per-lease mode available)."""
        kw.setdefault("chunk_steps", self.chunk_steps)
        kw.setdefault("max_steps", self.max_steps)
        kw.setdefault("superstep_max", self.superstep_max)
        if self.coverage_buckets is not None:
            kw.setdefault("coverage_buckets", self.coverage_buckets)
        # A solo sweep leaves the standing batch in no known state.
        self._slot_state = None
        first = self._runs == 0
        self._runs += 1
        if not first:
            self.reuse_hits += 1
        return sweep(None, self.engine.cfg, seeds, faults=faults,
                     engine=self.engine, mesh=self.mesh, **kw)

    def _part_sha256(self, faults: Optional[np.ndarray]) -> Optional[str]:
        """The solo sweep's ``faults_sha256`` of one range: per-world
        schedules padded to the mesh with repeats of row 0, as
        :func:`sweep` pads them."""
        if faults is None:
            return None
        fp = np.asarray(faults, np.int32)
        if fp.ndim == 3:
            pad = (-fp.shape[0]) % self.mesh.size
            if pad:
                fp = np.concatenate([fp, fp[:1].repeat(pad, axis=0)], axis=0)
        return hashlib.sha256(np.ascontiguousarray(fp).tobytes()).hexdigest()

    def run_group(self, parts: List[Dict[str, Any]],
                  observe: Any = None) -> List[SweepResult]:
        """Advance several seed ranges as one standing batch; one
        ``SweepResult`` per range, its contract fields bitwise a fresh
        ``sweep()`` of the range.

        ``parts``: ``[{"seeds": (n_i,) uint64, "faults": None | (F, 4)
        shared | (n_i, F, 4) per-world}, ...]``, all of one faults form.
        ``observe``: the solo sweep's sink, one ``madsim.sweep.telemetry/1``
        record per superstep read (the fleet worker's heartbeat)."""
        from ..obs import observatory as _obsy

        if not parts:
            raise ValueError("run_group needs at least one range")
        eng, mesh = self.engine, self.mesh
        n_dev = mesh.size
        dev = mesh.lead
        chunk_steps, superstep_max = self.chunk_steps, self.superstep_max
        cov_on = bool(eng.cfg.metrics)
        cov_k = (int(self.coverage_buckets) if self.coverage_buckets
                 else DEFAULT_BUCKETS)

        # -- the ranges as one batch --------------------------------------
        seeds_list: List[np.ndarray] = []
        faults_list: List[Optional[np.ndarray]] = []
        for p in parts:
            s = np.asarray(p["seeds"], np.uint64)
            if s.shape[0] == 0:
                raise ValueError("run_group ranges must be non-empty")
            f = p.get("faults")
            if f is not None:
                f = np.asarray(f, np.int32)
                if f.ndim not in (2, 3) or f.shape[-1] != 4:
                    raise ValueError(
                        f"range fault schedules must be (F, 4) or "
                        f"(n_i, F, 4); got shape {f.shape}")
                if f.ndim == 3 and f.shape[0] != s.shape[0]:
                    raise ValueError(
                        f"per-world schedules carry one (F, 4) block per "
                        f"seed: got leading dim {f.shape[0]} for "
                        f"{s.shape[0]} seeds")
            seeds_list.append(s)
            faults_list.append(f)
        forms = {(None if f is None else f.ndim) for f in faults_list}
        if len(forms) > 1:
            raise ValueError(
                "run_group ranges must agree on the faults form "
                "(all None, all shared (F, 4), or all per-world)")
        form = forms.pop()
        n_list = [int(s.shape[0]) for s in seeds_list]
        offs = np.concatenate([[0], np.cumsum(n_list)]).astype(int)
        n_tot = int(offs[-1])
        w = n_tot + ((-n_tot) % n_dev)
        seeds_c = np.concatenate(seeds_list)
        if w > n_tot:  # the mesh's padding: dummy worlds, sliced off
            seeds_c = np.concatenate([seeds_c, seeds_c[:1].repeat(w - n_tot)])
        if form is None:
            faults_init = None
        elif form == 2:
            faults_init = faults_list[0]
            for f in faults_list[1:]:
                if not np.array_equal(f, faults_init):
                    raise ValueError(
                        "shared (F, 4) templates must be identical "
                        "across grouped ranges")
        else:
            faults_init = np.concatenate(faults_list, axis=0)
            if w > n_tot:
                faults_init = np.concatenate(
                    [faults_init, faults_init[:1].repeat(w - n_tot, axis=0)],
                    axis=0)

        # -- install: recycle the standing slots, else a fresh init --------
        reused = self._slot_state is not None and self._slot_w == w
        if reused:
            prev, self._slot_state = self._slot_state, None
            state = shard_worlds(
                eng.refill(prev.gather(), np.ones(w, bool), seeds_c,
                           faults=faults_init), mesh)
        else:
            self._slot_state = None
            state = shard_worlds(eng.init(seeds_c, faults=faults_init),
                                 mesh)
        first = self._runs == 0
        self._runs += 1
        self.reuse_hits += len(parts) - (1 if first else 0)

        emit_telemetry, close_telemetry = _obsy.make_observer(observe)
        t_loop0 = perf_counter()
        flag_reads0 = Lookahead.host_reads
        perf = {"dispatches": 0, "scalar_fetches": 0, "device_wait_s": 0.0,
                "dispatch_s": 0.0, "dispatch_depth": 0}

        # -- the solo pipelined loop, without its refill and shrink edges --
        c_max = -(-self.max_steps // chunk_steps)
        chunks = 0
        k_cur = max(1, min(self._k_warm, superstep_max))
        epoch_fresh = True
        inflight: Optional[_Flight] = None
        stop = False

        def dispatch(reserve: int = 0) -> None:
            nonlocal state, inflight, epoch_fresh
            k = max(1, min(k_cur, c_max - chunks - reserve, superstep_max))
            if epoch_fresh:
                k = 1
            min_one = epoch_fresh
            epoch_fresh = False
            runner = sharded_superstep(eng, mesh, chunk_steps,
                                       superstep_max, min_one=min_one)
            t0 = perf_counter()
            state, any_bug, n_active, k_done, hist = runner(
                state, 0, False, k)
            perf["dispatch_s"] += perf_counter() - t0
            perf["dispatches"] += 1
            inflight = _Flight(any_bug, n_active, k_done, hist, k, w, 0)

        try:
            if c_max > 0:
                dispatch()
            while inflight is not None:
                prev, inflight = inflight, None
                if not stop and chunks + prev.planned < c_max:
                    dispatch(reserve=prev.planned)
                t0 = perf_counter()
                bug_h, n_act_h, k_done_h, _hist_h = _fetch(
                    (prev.any_bug, prev.n_active, prev.k_done, prev.hist))
                perf["device_wait_s"] += perf_counter() - t0
                perf["scalar_fetches"] += 1
                perf["dispatch_depth"] = max(
                    perf["dispatch_depth"], 1 if inflight is not None else 0)
                k_done = int(k_done_h)
                n_act = int(n_act_h)
                chunks += k_done
                if k_done == prev.planned:
                    k_cur = min(k_cur * 2, superstep_max)
                else:
                    k_cur = max(k_done, 1)
                if not stop and n_act == 0:
                    stop = True
                if emit_telemetry is not None:
                    emit_telemetry({
                        "schema": "madsim.sweep.telemetry/1",
                        "elapsed_s": round(perf_counter() - t_loop0, 6),
                        "chunks": int(chunks),
                        "steps": int(chunks * chunk_steps),
                        "batch_worlds": int(w),
                        "n_active": int(n_act),
                        "occupancy": round(n_act / w, 4) if w else 0.0,
                        "seeds_total": int(n_tot),
                        "seeds_done": int(max(n_tot - n_act, 0)),
                        "bug_seen": bool(bug_h),
                        "session_group": len(parts),
                        "dispatch_depth": 1 if inflight is not None else 0,
                    })
                if stop:
                    break
                if inflight is None and chunks < c_max:
                    dispatch()
        except BaseException:
            # A kill or preemption mid-group: launches may still be queued
            # on the standing batch, which changes in place. Drop it; the
            # next group installs fresh.
            self._slot_state = None
            self._slot_w = 0
            if close_telemetry is not None:
                close_telemetry()
            raise

        # -- per-range extraction: two boundary folds per range (the worlds
        # that retired during the group, then those still live; the ledger
        # is fold-order invariant, so the pair equals the solo sweep's
        # mid-loop and end folds), every ledger in ONE _fetch, and one
        # observe pull.
        ledgers_h = None
        if cov_on:
            ledgers = []
            for i, n_i in enumerate(n_list):
                idx_np = np.full(w, -1, np.int32)
                idx_np[offs[i]:offs[i + 1]] = np.arange(n_i, dtype=np.int32)
                idx_r = torch.from_numpy(idx_np).to(dev)
                hits, first_seen = ledger_zeros(cov_k, dev)
                for fold_active in (False, True):
                    hits, first_seen = _fold_end(state, hits, first_seen,
                                                 idx_r, n_i, fold_active)
                ledgers.append((hits, first_seen))
            ledgers_h = _fetch(ledgers)
        obs_all = eng.observe(state.gather())

        self._slot_state = state
        self._slot_w = w
        self._k_warm = k_cur

        issued = w * chunk_steps * chunks
        live_steps = int(np.asarray(obs_all["steps"])[:n_tot].sum())
        loop_stats_base = {
            "pipelined": True,
            "session": True,
            "session_group": len(parts),
            "session_reused_slots": bool(reused),
            "superstep_max": int(superstep_max),
            "chunk_steps": int(chunk_steps),
            "chunks": int(chunks),
            "dispatches": int(perf["dispatches"]),
            "chunks_per_dispatch": round(
                chunks / max(perf["dispatches"], 1), 3),
            "dispatch_depth": int(perf["dispatch_depth"]),
            "device_wait_s": round(perf["device_wait_s"], 6),
            "dispatch_s": round(perf["dispatch_s"], 6),
            "scalar_fetches": int(perf["scalar_fetches"]),
            "flag_reads": int(Lookahead.host_reads - flag_reads0),
            "loop_wall_s": round(perf_counter() - t_loop0, 6),
        }
        results: List[SweepResult] = []
        for i, (s, f) in enumerate(zip(seeds_list, faults_list)):
            lo, hi = int(offs[i]), int(offs[i + 1])
            # Copies: on the CPU ``observe`` shares the standing batch's
            # memory, which the next group refills in place.
            obs = {k: np.array(v[lo:hi]) for k, v in obs_all.items()}
            coverage = None
            if cov_on:
                hits_h, first_h = ledgers_h[i]
                coverage = coverage_from_device(cov_k, hits_h, first_h, [])
            results.append(SweepResult(
                seeds=s, bug=obs["bug"], observations=obs,
                steps_run=chunks * chunk_steps, n_devices=n_dev,
                world_utilization=live_steps / issued if issued else 0.0,
                loop_stats=dict(loop_stats_base),
                faults_sha256=self._part_sha256(f), coverage=coverage,
                triage_ctx=TriageContext(engine=eng, faults=f,
                                         mesh=mesh)))
        if close_telemetry is not None:
            close_telemetry()
        return results
