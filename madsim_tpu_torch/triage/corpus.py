"""Deduplicated bug corpus: failure classes + minimized repro bundles.

The port of ``madsim_tpu/triage/corpus.py``. A raw stream of failing
seeds is useless until it is deduplicated and attributed. This module
buckets a sweep's failures into failure classes keyed by the behavior
signature (obs/coverage.py — the same bucketed-histogram FNV hash the
device's coverage ledger folds, recomputed here bit-identically from the
per-seed metrics frames) plus the actor's invariant id, minimizes ONE
representative per class (triage/minimize.py — not one per failing
seed), and emits each as an obs/bundle.py repro bundle with a
``minimization`` provenance block that the replay CLI verifies end to
end. The bundles are the JAX package's, byte for byte.

Requires ``EngineConfig(metrics=True)``: the behavior signature is a
hash of the MetricsBlock histograms, so a metrics-off sweep has no
class key to bucket by (the same precondition as ``SweepResult.coverage``).

A compiled family's bundle (tpc, pb, Paxos) also carries its protocol
card: the speclint profile of its spec
(:func:`~madsim_tpu_torch.analysis.speclint.protocol_card`), as in the
JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np

from ..obs.coverage import _FNV_PRIME, _FNV_SEED
from .minimize import MinimizeResult, TriageError


def _np_bit_length(col: np.ndarray) -> np.ndarray:
    """Per-element ``int.bit_length`` over a non-negative int column —
    the numpy twin of obs/coverage.py ``_bit_length_u32`` (same binary
    shift loop, so signatures match the device fold bit for bit)."""
    x = np.asarray(col, np.uint32).copy()
    n = np.zeros(x.shape, np.uint32)
    for s in (16, 8, 4, 2, 1):
        hi = x >> np.uint32(s)
        move = hi > 0
        n[move] += np.uint32(s)
        x[move] = hi[move]
    return n + (x > 0).astype(np.uint32)


def behavior_signatures(per_seed: Dict[str, np.ndarray]) -> np.ndarray:
    """u32 behavior signature per seed from the per-seed metrics frames
    (``SweepResult.metrics["per_seed"]``).

    Column order and bucketing mirror obs/coverage.py
    ``behavior_signature`` EXACTLY — kind_hist columns, fault_hist
    columns, then the six drop causes, each quantized to its power-of-
    two bucket and FNV-1a-folded — so the host-side corpus key equals
    the device-side coverage-bucket preimage.
    """
    kind = np.asarray(per_seed["kind_hist"])
    fault = np.asarray(per_seed["fault_hist"])
    cols = [kind[:, j] for j in range(kind.shape[1])]
    cols += [fault[:, j] for j in range(fault.shape[1])]
    cols += [np.asarray(per_seed[k]) for k in
             ("drop_loss", "drop_stale", "drop_dead",
              "drop_out_of_time", "drop_overflow", "drop_inf")]
    h = np.full(cols[0].shape, _FNV_SEED, np.uint32)
    for c in cols:
        h = (h ^ _np_bit_length(c)) * np.uint32(_FNV_PRIME)
    return h


@dataclasses.dataclass
class FailureClass:
    """One distinct failure class of a sweep."""

    signature: int               # u32 behavior signature (the bucket key)
    invariant_id: str            # which invariant raised (actor-declared)
    seeds: np.ndarray            # failing seed ids in this class, ascending

    @property
    def representative(self) -> int:
        """Lowest failing seed — deterministic, and the cheapest banner
        line (matches the coverage ledger's lowest-seed attribution)."""
        return int(self.seeds[0])

    @property
    def count(self) -> int:
        return int(self.seeds.size)

    @property
    def key(self) -> str:
        return f"{self.invariant_id}:{self.signature:08x}"


def _invariant_id(result) -> str:
    ctx = getattr(result, "triage_ctx", None)
    actor = getattr(getattr(ctx, "engine", None), "actor", None)
    if actor is None:
        return "unknown"
    return getattr(actor, "invariant_id", type(actor).__name__)


def failure_classes(result) -> List[FailureClass]:
    """Bucket a sweep's failing seeds into distinct failure classes.

    Classes are keyed by (behavior signature, invariant id) and returned
    sorted by representative seed — deterministic for a deterministic
    sweep. Raises ``ValueError`` on a metrics-off sweep (no signature to
    bucket by; run with ``EngineConfig(metrics=True)``).
    """
    m = result.metrics
    if m is None:
        raise ValueError(
            "failure triage needs EngineConfig(metrics=True): failure "
            "classes bucket by the behavior signature of the per-seed "
            "MetricsBlock histograms")
    failing = np.flatnonzero(np.asarray(result.bug))
    if failing.size == 0:
        return []
    sigs = behavior_signatures(m["per_seed"])[failing]
    seeds = np.asarray(result.seeds)[failing].astype(np.int64)
    inv = _invariant_id(result)
    classes = []
    for sig in np.unique(sigs):
        mine = np.sort(seeds[sigs == sig])
        classes.append(FailureClass(signature=int(sig), invariant_id=inv,
                                    seeds=mine))
    classes.sort(key=lambda c: c.representative)
    return classes


def _actor_bundle_info(actor) -> Optional[Dict[str, Any]]:
    """Replay-registry name + config for a bundle, or None when the
    actor type is not registered (the bundle would not replay)."""
    from ..obs.cli import _actor_registry

    for name, (cls, cfg_cls) in _actor_registry().items():
        if type(actor) is cls:
            acfg = next((v for v in vars(actor).values()
                         if isinstance(v, cfg_cls)), None)
            return {"actor": name, "actor_config": acfg}
    return None


@dataclasses.dataclass
class TriageReport:
    """Outcome of :func:`triage`: the deduplicated, minimized corpus."""

    classes: List[FailureClass]
    minimized: Dict[str, MinimizeResult]   # class key → minimization
    bundles: Dict[str, str]                # class key → bundle path

    def summary(self) -> str:
        if not self.classes:
            return "triage: no failing seeds."
        lines = [f"triage: {sum(c.count for c in self.classes)} failing "
                 f"seed(s) in {len(self.classes)} distinct failure "
                 f"class(es)"]
        for c in self.classes:
            line = (f"  class {c.key}: {c.count} seed(s), "
                    f"representative {c.representative}")
            mr = self.minimized.get(c.key)
            if mr is not None:
                line += (f", schedule {mr.original_rows} -> "
                         f"{mr.final_rows} rows")
            if c.key in self.bundles:
                line += f", bundle {self.bundles[c.key]}"
            lines.append(line)
        return "\n".join(lines)


def triage(result, out_dir: Optional[str] = None, *,
           minimize: bool = True, max_steps: int = 20_000,
           **minimize_kw) -> TriageReport:
    """Triage a sweep: dedupe failures into classes, minimize one
    representative per class, optionally emit repro bundles.

    ``result`` is a :class:`~madsim_tpu_torch.parallel.sweep.SweepResult` from
    a metrics-on sweep. With ``minimize=True`` (default) each class's
    representative (lowest failing seed) runs the batched ddmin loop
    against its own fault schedule via ``result.minimize`` — requiring
    the sweep's triage context (engine + schedule refs); pass
    ``minimize=False`` to only bucket. With ``out_dir`` set, one
    ``device_sweep`` repro bundle per class is written there, carrying
    the MINIMIZED schedule rows and the ``minimization`` provenance
    block, replayable via ``python -m madsim_tpu_torch.obs replay
    --bundle`` (a compiled family's with its protocol card).
    ``minimize_kw`` forwards to :func:`~.minimize.minimize`
    (``pipeline``, ``weaken``, ``tighten``, ``chunk_steps``, ...).
    """
    classes = failure_classes(result)
    minimized: Dict[str, MinimizeResult] = {}
    bundles: Dict[str, str] = {}
    ctx = getattr(result, "triage_ctx", None)
    if minimize and classes and ctx is None:
        raise TriageError(
            "this SweepResult carries no triage context (it was merged "
            "or reconstructed): re-run the sweep, or call "
            "triage(result, minimize=False) to only bucket failures")
    for fc in classes:
        mr = None
        if minimize:
            mr = result.minimize(seed=fc.representative,
                                 max_steps=max_steps, **minimize_kw)
            minimized[fc.key] = mr
        if out_dir is None:
            continue
        from ..obs.bundle import write_sweep_bundle

        info = (_actor_bundle_info(ctx.engine.actor)
                if ctx is not None else None) or \
            {"actor": _invariant_id(result), "actor_config": None}
        ecfg = ctx.engine.cfg if ctx is not None else None
        frows = (mr.schedule if mr is not None
                 else _class_schedule(result, fc))
        extra: Dict[str, Any] = {
            "failure_class": fc.key, "n_seeds": fc.count,
            "seeds_sample": [int(s) for s in fc.seeds[:16]]}
        spec = (getattr(ctx.engine.actor, "spec", None)
                if ctx is not None else None)
        if spec is not None:
            # Spec-backed (actorc) actor: the bundle carries its
            # protocol card — the speclint static profile (kinds x
            # handlers, timer graph, lane budgets) — so a minimized
            # bug documents the protocol shape it was found against.
            from ..analysis.speclint import protocol_card

            extra["protocol_card"] = protocol_card(spec)
        bb = _class_blackbox(result, fc)
        if bb is not None:
            # Blackbox-on sweep: attach the representative's decoded
            # flight-recorder ring (madsim.blackbox/1). The block
            # carries its OWN replay recipe — the ORIGINAL schedule
            # rows the ring was recorded under plus the world's final
            # step count — because the bundle's top-level rows are the
            # MINIMIZED schedule, which replays the bug but not the
            # recorded execution. `obs replay --crosscheck` uses the
            # block's recipe to verify ring == trace suffix, bitwise.
            extra["blackbox"] = bb
        bundles[fc.key] = write_sweep_bundle(
            out_dir, seed=fc.representative, actor=info["actor"],
            actor_config=info["actor_config"], engine_config=ecfg,
            faults=frows if frows is not None and len(frows) else None,
            max_steps=max_steps,
            error=(f"invariant violation: {fc.invariant_id} "
                   f"(failure class {fc.key})"),
            minimization=(mr.provenance() if mr is not None else None),
            lineage=_class_lineage(result, fc),
            extra=extra)
    return TriageReport(classes=classes, minimized=minimized,
                        bundles=bundles)


def _class_lineage(result, fc: FailureClass) -> Optional[Dict[str, Any]]:
    """The ``madsim.search.lineage/1`` provenance block for a guided
    find (obs/lineage.py): the representative's ancestry chain plus the
    hunt's operator outcome table, so a minimized bundle documents its
    own derivation. None on non-guided sweeps or lineage-off hunts."""
    from ..obs.lineage import lineage_block

    rep = getattr(result, "search", None)
    lin = getattr(rep, "lineage", None) if rep is not None else None
    if lin is None:
        return None
    rows = np.flatnonzero(
        np.asarray(result.seeds) == np.uint64(fc.representative))
    if rows.size == 0:
        return None
    return lineage_block(lin, int(rows[0]), seeds=np.asarray(result.seeds),
                         stats=rep.operator_stats)


def _class_blackbox(result, fc: FailureClass) -> Optional[Dict[str, Any]]:
    """The representative's ``madsim.blackbox/1`` block (obs/blackbox.py)
    for a blackbox-on sweep: the decoded in-situ event ring plus the
    self-contained replay recipe (RAW original schedule rows — NOT
    compacted/normalized, which could reorder equal-time pushes and
    break the bitwise ring == trace-suffix contract — and the world's
    final step count). None when the sweep ran blackbox-off."""
    from ..obs.blackbox import blackbox_block, ring_depth

    obs = result.observations
    k = ring_depth(obs)
    if k is None:
        return None
    rows = np.flatnonzero(
        np.asarray(result.seeds) == np.uint64(fc.representative))
    if rows.size == 0:
        return None
    row = int(rows[0])
    ctx = getattr(result, "triage_ctx", None)
    frows = None
    if ctx is not None and ctx.faults is not None:
        frows = np.asarray(ctx.faults, np.int32)
        if frows.ndim == 3:
            frows = frows[row]
    entries = result.blackbox(seed=fc.representative)
    return blackbox_block(
        entries, seed=fc.representative, k=k,
        pos=int(np.asarray(obs["bb_pos"])[row]),
        steps=int(np.asarray(obs["steps"])[row]), faults=frows)


def _class_schedule(result, fc: FailureClass) -> Optional[np.ndarray]:
    """The representative's ORIGINAL schedule rows, compacted to the
    live rows (minimize=False path)."""
    from .shrink import compact, normalize

    ctx = getattr(result, "triage_ctx", None)
    if ctx is None or ctx.faults is None:
        return None
    faults = np.asarray(ctx.faults, np.int32)
    if faults.ndim == 3:
        row = int(np.flatnonzero(
            np.asarray(result.seeds) == fc.representative)[0])
        faults = faults[row]
    return compact(normalize(faults))
