"""Seed sweeps on one device: the serial chunk loop of the bug hunt.

The PyTorch counterpart of ``madsim_tpu/parallel/sweep.py``'s serial
(``pipeline=False``) path. ``sweep`` initialises one world per seed, steps
the batch in chunks of ``chunk_steps`` launches, and after each chunk reads
two scalars — "any bug?" and "how many worlds are active?" — to decide
whether to stop, to recycle retired slots with the next seeds
(``recycle=True``) or to shrink the batch to the active worlds
(``compact=True``, and the dry-cursor fallback of a recycled sweep). The
batch is a fixed set of world *slots*; a device-resident slot→seed index
keeps attribution straight through every permutation, and the retiring
tail's observations are gathered on the device and pulled alone.

Results are bitwise those of the JAX package's serial sweep on one device
(``mesh=seed_mesh(n_devices=1), pipeline=False``): the same seeds, bug
flags, observations, occupancy history, coverage ledger and loop counts.
Worlds are position-independent, so a recycled or compacted sweep gives
every seed the trajectory of an independent ``init`` + ``run``.

Every device→host read of the loop goes through :func:`_fetch`, the one
patchable pull seam (tests count its calls).

With ``search=SearchConfig(...)`` the loop is the guided schedule search
(madsim_tpu_torch/search): each refill harvests the retiring worlds into a
corpus of parent schedules and refills the slots with mutated children.
The fold runs on the host over the retiring rows the refill's one pull
brings back; the children are generated on the device.

Not ported here, each raising ``NotImplementedError`` naming its ROADMAP
item: the pipelined and fused loops, checkpoints, the observatory hooks,
multi-device meshes and ``SweepResult.minimize``.
"""
from __future__ import annotations

import dataclasses
import hashlib
from time import perf_counter
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..engine.core import DeviceEngine, EngineConfig, tree_map
from ..obs.blackbox import decode_ring, ring_depth, rings_from_observations
from ..obs.coverage import (
    DEFAULT_BUCKETS,
    coverage_from_device,
    distinct_count,
    fold_retired,
    ledger_zeros,
)
from ..obs.metrics import aggregate_metrics, metrics_from_observations
from ..search.corpus import (
    HostCorpus,
    corpus_to_device,
    host_corpus_init,
    host_harvest_fold,
    normalize_schedule,
)
from ..search.generate import generate_children


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


def _unported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to madsim_tpu_torch yet (ROADMAP Queue A "
        f"item {item})")


# ---------------------------------------------------------------------------
# Device helpers: the chunk runner, the coverage folds, compaction and the
# retiring tail's observation gathers.
# ---------------------------------------------------------------------------

def chunk_runner(eng: DeviceEngine, chunk_steps: int = 512,
                 coverage: Optional[int] = None):
    """The chunk body of the serial loop, the one-device analogue of the
    JAX ``sharded_engine``: ``state → (state, any_bug, n_active)``, the
    state stepped ``chunk_steps`` times in place and the two scalars left
    on the device.

    With ``coverage`` (a bucket count) the runner is ``(state, hits,
    first_seen, idx, n_real) → (state, any_bug, n_active, hits,
    first_seen, distinct)``: after the chunk, the worlds whose active flag
    fell during it, and that hold a real seed id, fold their behavior
    signatures into the ledger.
    """
    if coverage is None:
        def chunk(state):
            state = eng.run_steps(state, chunk_steps)
            return (state, state.bug.any(),
                    state.active.sum(dtype=torch.int32))

        return chunk

    def chunk_cov(state, hits, first, idx, n_real):
        act0 = state.active.clone()
        state = eng.run_steps(state, chunk_steps)
        mask = act0 & ~state.active & (idx >= 0) & (idx < n_real)
        hits, first = fold_retired(hits, first, state.metrics, mask, idx)
        return (state, state.bug.any(), state.active.sum(dtype=torch.int32),
                hits, first, distinct_count(hits))

    return chunk_cov


def _cov_endfolder(state, hits, first, idx, n_real: int,
                   fold_active: bool):
    """The boundary coverage fold: the worlds whose active flag equals
    ``fold_active`` (True at sweep end: the worlds still live at exit)
    fold into the ledger."""
    mask = (state.active == fold_active) & (idx >= 0) & (idx < n_real)
    return fold_retired(hits, first, state.metrics, mask, idx)


def _compact_bucket(n_active: int, w_cur: int) -> int:
    """Largest power-of-two shrink of ``w_cur`` that still holds every
    active world; ``w_cur`` when no halving is possible."""
    w = w_cur
    while w % 2 == 0 and w // 2 >= max(n_active, 1):
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
    """Compaction: the stable active-first permutation
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
# The result
# ---------------------------------------------------------------------------

class TriageContext(NamedTuple):
    """What re-executing a sweep's worlds needs: the engine and the fault
    schedule."""

    engine: Any
    faults: Optional[np.ndarray]


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
        """Schedule minimisation of a failing seed: not ported."""
        raise _unported("SweepResult.minimize (triage)", "11")

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

    The JAX ``sweep``'s signature and its serial per-chunk loop: call it
    with ``pipeline=False``. Per chunk the host reads the active count and
    the bug flag and decides:

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

    The pipelined and fused loops (``pipeline=True``, ``fused=True``),
    checkpoints, the observatory hooks (``observe``, ``profile_dir``) and
    a ``mesh`` raise ``NotImplementedError`` naming their ROADMAP item:
    nothing runs the serial loop in their place.
    """
    if mesh is not None:
        raise _unported("sweep(mesh=...) over several devices", "12")
    if pipeline:
        raise _unported("sweep(pipeline=True), the pipelined superstep "
                        "loop (pass pipeline=False for the serial loop)",
                        "7")
    if fused:
        raise _unported("sweep(fused=True), the whole-hunt fused loop", "7")
    if checkpoint_path is not None or resume:
        raise _unported("sweep checkpoints (checkpoint_path=, resume=)",
                        "6")
    if observe is not None or profile_dir is not None:
        raise _unported("the sweep observatory (observe=, profile_dir=)",
                        "11")
    if superstep_max < 1:
        raise ValueError("superstep_max must be >= 1")

    eng = engine if engine is not None else DeviceEngine(actor, cfg)
    dev = eng.device
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

    # Batch width: plain sweeps hold every seed at once; recycled sweeps
    # hold batch_worlds slots and stream the rest. (On one device no
    # padding of the seed-id space is needed: the width never exceeds n.)
    if recycle and batch_worlds is not None:
        w0 = min(max(1, int(batch_worlds)), n)
    else:
        w0 = n

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
    # pin a trajectory when schedules vary.
    faults_key = (np.ascontiguousarray(faults_p).tobytes()
                  if faults_p is not None else b"none")
    faults_sha256 = hashlib.sha256(faults_key).hexdigest()

    state = eng.init(seeds[:w0], faults=batch_faults(np.arange(w0)))
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
            "dispatches": 0}
    t_loop0 = perf_counter()
    novelty_hist: List[int] = []       # cumulative distinct, per chunk
    cov_hits = cov_first = None
    if cov_on:
        cov_hits, cov_first = ledger_zeros(cov_k, dev)
    # -- the guided search's state -------------------------------------
    # slot_sched: the (W, F, 4) schedule each slot runs, on the device,
    # permuted and refilled with the state; slot_lin its lineage lanes.
    # The corpus lives on the host (the fold runs there); op_produced, the
    # operator table's produced row, on the device with the children it
    # counts; novel and survived are credited on the host with the fold.
    slot_sched = slot_lin = op_produced = None
    retired_sched: List[np.ndarray] = []
    retired_lin: List[tuple] = []
    srch = {}
    if search_on:
        from ..obs.lineage import N_OPS, lanes_origin

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
            corpus_h = HostCorpus(*(np.array(x, copy=True)
                                    for x in search_corpus))
        else:
            corpus_h = host_corpus_init(k, normalize_schedule(
                faults_p[0] if per_world_faults else faults_p))
        srch = {"corpus": corpus_h, "gen": int(search_gen0), "inserted": 0,
                "novel": np.zeros(N_OPS, np.int32),
                "survived": np.zeros(N_OPS, np.int32)}
        if lineage_on:
            # The first batch runs the template itself: generation 0.
            slot_lin = lanes_origin(w0, dev)
            op_produced = torch.zeros((N_OPS,), dtype=torch.int32,
                                      device=dev)

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

    def pull_tail(handles):
        """The retiring tail's one pull (``_fetch``): its gathered rows on
        the host, cut to the tail's length."""
        tree, tail_len = handles
        t0 = perf_counter()
        obs_h, idx_h, sched_h, lin_h = _fetch(tree)
        perf["retire_wait_s"] += perf_counter() - t0
        perf["retire_fetches"] += 1
        return ({k: np.asarray(v)[:tail_len] for k, v in obs_h.items()},
                np.asarray(idx_h)[:tail_len],
                None if sched_h is None else np.asarray(sched_h)[:tail_len],
                None if lin_h is None else tuple(np.asarray(a)[:tail_len]
                                                 for a in lin_h))

    def fetch_retire(handles) -> None:
        """Record a retiring tail: pull its gathered rows unless the refill
        already did."""
        retire(*(handles if isinstance(handles[0], dict)
                 else pull_tail(handles)))

    def harvest(pulled):
        """The guided fold of one refill, on the host: the retiring rows
        that hold a seed and finished are scored against the corpus and
        the novel ones inserted, in slot order; the operator table's
        novel and survived rows are credited from their lineage lanes."""
        obs_h, idx_h, sched_h, lin_h = pulled
        if not search.guided:
            return
        from ..obs.lineage import host_credit

        mask = (idx_h >= 0) & ~np.asarray(obs_h["active"], bool)
        sigs = _host_signatures(obs_h)
        entries = depths = None
        if lineage_on:
            entries = np.where(idx_h >= 0, search_lin_base + idx_h + 1,
                               -1).astype(np.int32)
            depths = lin_h[3]
        srch["corpus"], n_ins, nov_m, ins_m = host_harvest_fold(
            srch["corpus"], sched_h, sigs, mask, search.min_novelty,
            entries=entries, depths=depths, with_masks=True)
        srch["inserted"] += n_ins
        if lineage_on:
            srch["novel"] = host_credit(srch["novel"], lin_h[2], nov_m)
            srch["survived"] = host_credit(srch["survived"], lin_h[2],
                                           ins_m)

    def do_refill(n_act: int):
        """Recycling: compact active-first on the device, gather the frozen
        tail's observations, refill the tail with the next seeds from the
        cursor. Only the n_act scalar shapes the refill mask.

        A guided refill pulls the tail (its one ``_fetch``) before the
        refill, with the tail's schedules and lineage lanes, folds it into
        the corpus on the host, and refills the slots with children
        generated on the device (``DeviceEngine.refill``'s device-schedule
        path)."""
        nonlocal state, idx, cursor, reordered, slot_sched, slot_lin, \
            op_produced
        extra = ((slot_sched,) + (tuple(slot_lin) if lineage_on else ())
                 if search_on else ())
        state, idx, *extra = _compactor(state, idx, extra=extra)
        reordered = True
        tail_len = w_cur - n_act
        rows = min(_pow2_at_least(tail_len), _pow2_at_least(w_cur))
        obs_t, idx_t = _tail_observer(eng, state, idx, n_act, rows)
        take = min(tail_len, n - cursor)
        repl = np.full(w_cur, -1, np.int32)
        repl[n_act:n_act + take] = np.arange(
            cursor, cursor + take, dtype=np.int32)
        cursor += take
        mask = np.zeros(w_cur, bool)
        mask[n_act:n_act + take] = True
        fill_ids = np.maximum(repl, 0)
        handles = ((obs_t, idx_t, None, None), tail_len)
        if search_on:
            slot_sched = extra[0]
            tail_g = [_rows_from(x, n_act, rows) for x in extra]
            lin_t = None
            if lineage_on:
                slot_lin = type(slot_lin)(*extra[1:])
                lin_t = tuple(tail_g[1:])
            handles = pull_tail(((obs_t, idx_t, tail_g[0], lin_t),
                                 tail_len))
            harvest(handles)
            mask_d = torch.from_numpy(mask).to(dev)
            corpus_d = corpus_to_device(srch["corpus"], srch["gen"],
                                        srch["inserted"], dev)
            children = generate_children(
                eng.cfg, search, corpus_d,
                torch.from_numpy(fill_ids.astype(np.int32)).to(dev),
                lineage_on)
            srch["gen"] += 1
            if lineage_on:
                from ..obs.lineage import credit, ops_bits

                children, child_lin = children
                op_produced = credit(op_produced, ops_bits(child_lin.ops),
                                     mask_d)
                slot_lin = type(slot_lin)(*(
                    torch.where(mask_d, c, s)
                    for c, s in zip(child_lin, slot_lin)))
            state = eng.refill(state, mask, seeds[fill_ids],
                               faults=children)
            slot_sched = torch.where(mask_d[:, None, None], children,
                                     slot_sched)
        else:
            state = eng.refill(state, mask, seeds[fill_ids],
                               faults=batch_faults(fill_ids))
        tail = torch.from_numpy(np.arange(w_cur) >= n_act).to(dev)
        idx = torch.where(tail, torch.from_numpy(repl).to(dev), idx)
        return handles

    def do_shrink(new_w: int):
        """Shrink compaction: permute active-first, split off the frozen
        tail and keep the head (a guided sweep's schedules and lanes
        split with it); returns the tail's observation handles."""
        nonlocal state, idx, reordered, w_cur, slot_sched, slot_lin
        extra = ((slot_sched,) + (tuple(slot_lin) if lineage_on else ())
                 if search_on else ())
        (state, idx, *live_x), (frozen, fidx, *frozen_x) = _compactor(
            state, idx, new_w, extra=extra)
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
        return (obs_t, idx_t, fsched, flin), tail_len

    runner = chunk_runner(eng, chunk_steps, cov_k if cov_on else None)
    while steps < max_steps:
        t0 = perf_counter()
        if cov_on:
            (state, any_bug, n_active, cov_hits, cov_first,
             distinct) = runner(state, cov_hits, cov_first, idx, n)
        else:
            distinct = None
            state, any_bug, n_active = runner(state)
        perf["dispatch_s"] += perf_counter() - t0
        perf["dispatches"] += 1
        steps += chunk_steps
        chunks += 1
        issued_slot_steps += w_cur * chunk_steps
        t0 = perf_counter()
        if cov_on:
            n_act_h, bug_h, dist_h = _fetch((n_active, any_bug, distinct))
        else:
            n_act_h, bug_h = _fetch((n_active, any_bug))
        perf["device_wait_s"] += perf_counter() - t0
        perf["scalar_fetches"] += 1
        n_act = int(n_act_h)
        if cov_on:
            novelty_hist.append(int(dist_h))
        t0 = perf_counter()
        n_active_hist.append(n_act)
        n_active_chunk.append(chunks - 1)
        more_seeds = cursor < n
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
        new_w = _compact_bucket(n_act, w_cur)
        if (compact or (recycle and not more_seeds)) and new_w < w_cur:
            handles = do_shrink(new_w)
            perf["host_decision_s"] += perf_counter() - t0
            fetch_retire(handles)
        else:
            perf["host_decision_s"] += perf_counter() - t0

    if cov_on:
        # End-of-sweep fold: worlds still live at exit count too.
        cov_hits, cov_first = _cov_endfolder(state, cov_hits, cov_first,
                                             idx, n, True)

    obs_live = eng.observe(state)
    sched_live_h = lin_live_h = op_produced_h = None
    if cov_on and search_on:
        # The search's per-slot state rides the final ledger pull.
        (idx_h, cov_hits_h, cov_first_h, sched_live_h, lin_live_h,
         op_produced_h) = _fetch((idx, cov_hits, cov_first, slot_sched,
                                  slot_lin, op_produced))
        idx_h, cov_hits_h, cov_first_h = (
            np.asarray(x) for x in (idx_h, cov_hits_h, cov_first_h))
        sched_live_h = np.asarray(sched_live_h, np.int32)
    elif cov_on:
        idx_h, cov_hits_h, cov_first_h = (
            np.asarray(x) for x in _fetch((idx, cov_hits, cov_first)))
    else:
        idx_h = np.asarray(_fetch(idx))
    sched_per_seed = lin_per_seed = None
    live_keep = idx_h >= 0
    live_world_steps += int(np.asarray(obs_live["steps"])[live_keep].sum())
    # Scatter whenever the live batch does not cover the id space in seed
    # order: after a reorder or retirement, or when a recycled sweep
    # stopped before its first refill (seeds never admitted read zero).
    if reordered or retired_rows or w0 < n:
        rows = np.concatenate(retired_rows + [idx_h[live_keep]])
        obs = {}
        for k, v_live in obs_live.items():
            v_live = np.asarray(v_live)[live_keep]
            merged = np.concatenate(retired.get(k, []) + [v_live], axis=0)
            out = np.zeros((n,) + merged.shape[1:], merged.dtype)
            out[rows] = merged
            obs[k] = out
        if search_on:
            merged_s = np.concatenate(
                retired_sched + [sched_live_h[live_keep]], axis=0)
            sched_per_seed = np.full((n,) + merged_s.shape[1:], -1, np.int32)
            sched_per_seed[:, :, 1:] = 0     # canonical disabled rows
            sched_per_seed[rows] = merged_s
        if lin_live_h is not None:
            # Never-admitted seeds read as generation 0.
            lanes_out = []
            for i, dflt in enumerate((-1, -1, 0, 0)):
                merged_l = np.concatenate(
                    [t[i] for t in retired_lin]
                    + [np.asarray(lin_live_h[i])[live_keep]], axis=0)
                out = np.full((n,), dflt, np.int32)
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
    util = (live_world_steps / issued_slot_steps if issued_slot_steps
            else 0.0)
    loop_stats = {
        "pipelined": False,
        "fused": False,
        "superstep_max": 1,
        "chunk_steps": int(chunk_steps),
        "chunks": int(chunks),
        "dispatches": int(perf["dispatches"]),
        "chunks_per_dispatch": round(
            chunks / max(perf["dispatches"], 1), 3),
        "dispatches_per_seed": round(perf["dispatches"] / max(n, 1), 6),
        "seeds_per_dispatch": round(n / max(perf["dispatches"], 1), 3),
        "epochs_on_device": 0,
        "dispatch_depth": 0,
        "device_wait_s": round(perf["device_wait_s"], 6),
        "host_decision_s": round(perf["host_decision_s"], 6),
        "dispatch_s": round(perf["dispatch_s"], 6),
        "retire_wait_s": round(perf["retire_wait_s"], 6),
        "scalar_fetches": int(perf["scalar_fetches"]),
        "retire_fetches": int(perf["retire_fetches"]),
        "loop_wall_s": round(perf_counter() - t_loop0, 6),
    }
    coverage = (coverage_from_device(cov_k, cov_hits_h, cov_first_h,
                                     novelty_hist) if cov_on else None)
    search_report = None
    triage_faults = faults
    if search_on:
        search_report = _search_report(srch, sched_per_seed, lin_per_seed,
                                       op_produced_h, obs["bug"],
                                       search_gen0, search_lin_base)
        # Triage replays the schedule each world actually ran.
        triage_faults = sched_per_seed
    return SweepResult(seeds=seeds, bug=obs["bug"], observations=obs,
                       steps_run=steps, n_devices=1,
                       n_active_history=np.asarray(n_active_hist, np.int64),
                       world_utilization=util,
                       n_active_chunks=np.asarray(n_active_chunk, np.int64),
                       loop_stats=loop_stats,
                       faults_sha256=(faults_sha256 if faults is not None
                                      else None),
                       coverage=coverage,
                       search=search_report,
                       triage_ctx=TriageContext(engine=eng,
                                                faults=triage_faults))


def _host_signatures(obs: Dict[str, np.ndarray]) -> np.ndarray:
    """The behavior signatures (uint32) of observation rows, from their
    metrics block (``m_*``), as ``obs/coverage.behavior_signature``
    computes them on the device."""
    from types import SimpleNamespace

    from ..obs.coverage import behavior_signature

    mb = SimpleNamespace(**{
        k[2:]: torch.from_numpy(np.ascontiguousarray(v))
        for k, v in obs.items() if k.startswith("m_")})
    return behavior_signature(mb).numpy().astype(np.uint32)


def _search_report(srch, sched_per_seed, lin_per_seed, op_produced,
                   bug, search_gen0: int, search_lin_base: int):
    """The guided sweep's :class:`~madsim_tpu_torch.search.SearchReport`:
    the host corpus, the per-seed schedules and lanes, and the operator
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
        op_stats = operator_stats(np.asarray(op_produced), srch["novel"],
                                  srch["survived"], op_bug)
    c = srch["corpus"]
    c_filled = np.asarray(c.filled, bool)
    return SearchReport(
        # Generations this sweep ran: search_gen0 shifts the key space.
        generations=int(srch["gen"]) - int(search_gen0),
        inserted=int(srch["inserted"]),
        corpus_size=int(c_filled.sum()),
        corpus_capacity=int(c_filled.shape[0]),
        corpus_sched=np.asarray(c.sched, np.int32),
        corpus_sig=np.asarray(c.sig, np.uint32),
        corpus_score=np.asarray(c.score, np.int32),
        corpus_filled=c_filled,
        schedules=sched_per_seed,
        corpus_entry=np.asarray(c.entry, np.int32),
        corpus_depth=np.asarray(c.depth, np.int32),
        lineage=lineage_rep,
        operator_stats=op_stats)
