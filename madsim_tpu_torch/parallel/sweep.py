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

Not ported here, each raising ``NotImplementedError`` naming its ROADMAP
item: the pipelined and fused loops, checkpoints, guided search, the
observatory hooks, multi-device meshes and ``SweepResult.minimize``.
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


def _to_host(tree):
    """A tree of tensors (dicts, tuples, lists, None) as the same tree of
    numpy arrays."""
    if isinstance(tree, torch.Tensor):
        return tree.cpu().numpy()
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
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


def _compactor(state, idx, new_w: Optional[int] = None):
    """Compaction: the stable active-first permutation
    (``torch.sort(stable=True)`` of the frozen flag) applied to the state
    and the slot→seed index; with ``new_w`` also the split into the live
    head of ``new_w`` worlds and the frozen tail."""
    order = torch.sort((~state.active).to(torch.int32), stable=True).indices
    state, idx = _permute_worlds(state, order), _take(idx, order)
    if new_w is None:
        return state, idx
    return ((tree_map(lambda x: x[:new_w], state), idx[:new_w]),
            (tree_map(lambda x: x[new_w:], state), idx[new_w:]))


def _tail_observer(eng: DeviceEngine, state, idx, start: int, rows: int):
    """The retiring tail's gather: ``rows`` observation rows from ``start``
    on (clamped to the batch; the caller slices to the true tail), with
    the slot→seed index, so that retirement pulls only those rows."""
    w = idx.shape[0]
    take = (start + torch.arange(rows, device=idx.device)).clamp(0, w - 1)
    obs = {k: _take(v, take) for k, v in eng.observe_device(state).items()}
    return obs, _take(idx, take)


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
        coverage, the top drop causes and the recorder's depth."""
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

    The pipelined and fused loops (``pipeline=True``, ``fused=True``),
    checkpoints, guided search, the observatory hooks (``observe``,
    ``profile_dir``) and a ``mesh`` raise ``NotImplementedError`` naming
    their ROADMAP item: nothing runs the serial loop in their place.
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
    if (search is not None or search_corpus is not None or search_gen0
            or search_lin_base):
        raise _unported("guided schedule search (search=...)", "8")
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

    def retire(obs_slice: Dict[str, np.ndarray], rows: np.ndarray) -> None:
        """Record the final observations of rows leaving the batch (dead
        slots, retired earlier, are filtered out by their -1 id)."""
        nonlocal live_world_steps
        keep = rows >= 0
        if not keep.all():
            rows = rows[keep]
            obs_slice = {k: np.asarray(v)[keep] for k, v in obs_slice.items()}
        if rows.size == 0:
            return
        live_world_steps += int(np.asarray(obs_slice["steps"]).sum())
        retired_rows.append(rows)
        for k, v in obs_slice.items():
            retired.setdefault(k, []).append(np.asarray(v))

    def fetch_retire(handles) -> None:
        """Pull a retiring tail's gathered rows (one ``_fetch``) and record
        them."""
        obs_t, idx_t, tail_len = handles
        t0 = perf_counter()
        obs_h, idx_h = _fetch((obs_t, idx_t))
        perf["retire_wait_s"] += perf_counter() - t0
        perf["retire_fetches"] += 1
        retire({k: np.asarray(v)[:tail_len] for k, v in obs_h.items()},
               np.asarray(idx_h)[:tail_len])

    def do_refill(n_act: int):
        """Recycling: compact active-first on the device, gather the frozen
        tail's observations, refill the tail with the next seeds from the
        cursor. Only the n_act scalar shapes the refill mask."""
        nonlocal state, idx, cursor, reordered
        state, idx = _compactor(state, idx)
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
        state = eng.refill(state, mask, seeds[fill_ids],
                           faults=batch_faults(fill_ids))
        tail = torch.from_numpy(np.arange(w_cur) >= n_act).to(dev)
        idx = torch.where(tail, torch.from_numpy(repl).to(dev), idx)
        return obs_t, idx_t, tail_len

    def do_shrink(new_w: int):
        """Shrink compaction: permute active-first, split off the frozen
        tail and keep the head; returns the tail's observation handles."""
        nonlocal state, idx, reordered, w_cur
        (state, idx), (frozen, fidx) = _compactor(state, idx, new_w)
        reordered = True
        tail_len = w_cur - new_w
        w_cur = new_w
        obs_t, idx_t = _observer(eng, frozen, fidx)
        return obs_t, idx_t, tail_len

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
    if cov_on:
        idx_h, cov_hits_h, cov_first_h = (
            np.asarray(x) for x in _fetch((idx, cov_hits, cov_first)))
    else:
        idx_h = np.asarray(_fetch(idx))
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
    else:
        obs = obs_live
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
    return SweepResult(seeds=seeds, bug=obs["bug"], observations=obs,
                       steps_run=steps, n_devices=1,
                       n_active_history=np.asarray(n_active_hist, np.int64),
                       world_utilization=util,
                       n_active_chunks=np.asarray(n_active_chunk, np.int64),
                       loop_stats=loop_stats,
                       faults_sha256=(faults_sha256 if faults is not None
                                      else None),
                       coverage=coverage,
                       triage_ctx=TriageContext(engine=eng, faults=faults))
