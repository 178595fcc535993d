"""Merge per-range SweepResults into one fleet SweepResult.

The crash-identical contract lives here. Per-range sweeps are bit-
deterministic functions of (seeds, config, faults) — worlds are
position-independent and each range runs to retirement — so the
CONTRACT fields of the merged result (seed ids, per-seed observations
incl. the ``m_*`` metrics frames, bug flags, and the coverage ledger's
hits/first-seen) depend only on the *set* of completed ranges, never on
which worker ran a range, how many times it ran, whether it resumed
from a preemption checkpoint, or in what order completions arrived.
That is what makes the three-way tier-1 equality possible: chaotic
fleet == clean fleet == single-host ``sweep()``.

Orchestration fields (``n_active_history``, ``loop_stats``,
``novelty_curve``, ``world_utilization``) are *fabric telemetry*: they
describe how this particular fleet execution unfolded and legitimately
differ run to run. They are merged best-effort (range-major order,
chunk indices re-based) and excluded from the crosscheck.

The same contract powers duplicate resolution: a double-reported range
(lease expired but the old holder finished anyway; a network-duplicated
completion) is resolved by asserting the two payloads bitwise equal on
the contract fields — redundancy becomes a free cross-execution
determinism check, and any mismatch is a loud
:class:`FleetIntegrityError`, never a silent pick-one.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..parallel.sweep import SweepResult
from .lease import SeedRange


class FleetIntegrityError(RuntimeError):
    """Two executions of the same seed range disagreed bitwise — the
    determinism contract is broken (nondeterministic actor/engine code,
    mixed engine versions in one fleet, or corrupted transport)."""


def contract_mismatches(a: SweepResult, b: SweepResult) -> List[str]:
    """Field names where two results for the SAME range disagree on the
    contract surface (empty list = bitwise interchangeable)."""
    bad: List[str] = []
    if not np.array_equal(a.seeds, b.seeds):
        bad.append("seeds")
    if not np.array_equal(a.bug, b.bug):
        bad.append("bug")
    if set(a.observations) != set(b.observations):
        bad.append("observations.keys")
    else:
        bad.extend(f"observations.{k}" for k in sorted(a.observations)
                   if not np.array_equal(a.observations[k],
                                         b.observations[k]))
    if (a.coverage is None) != (b.coverage is None):
        bad.append("coverage")
    elif a.coverage is not None:
        if not np.array_equal(a.coverage.hits, b.coverage.hits):
            bad.append("coverage.hits")
        if not np.array_equal(a.coverage.first_seen_seed,
                              b.coverage.first_seen_seed):
            bad.append("coverage.first_seen_seed")
    if a.faults_sha256 != b.faults_sha256:
        bad.append("faults_sha256")
    sa = getattr(a, "search", None)
    sb = getattr(b, "search", None)
    if (sa is None) != (sb is None):
        bad.append("search")
    elif sa is not None:
        # Guided sweeps: the materialized per-seed schedules and the
        # final corpus are contract surface too — two executions of one
        # range must evolve identical corpora and run identical
        # children (docs/search.md determinism contract).
        if not np.array_equal(sa.schedules, sb.schedules):
            bad.append("search.schedules")
        for f in ("corpus_sched", "corpus_sig", "corpus_score",
                  "corpus_filled", "corpus_entry", "corpus_depth"):
            if not np.array_equal(getattr(sa, f), getattr(sb, f)):
                bad.append(f"search.{f}")
        la = getattr(sa, "lineage", None)
        lb = getattr(sb, "lineage", None)
        if (la is None) != (lb is None):
            bad.append("search.lineage")
        elif la is not None:
            # The provenance lanes (obs/lineage.py) are contract
            # surface: ancestry attribution must not depend on which
            # worker ran the range.
            for f in ("parent1", "parent2", "ops", "depth"):
                if not np.array_equal(getattr(la, f), getattr(lb, f)):
                    bad.append(f"search.lineage.{f}")
    return bad


def crosscheck_duplicate(range_id: int, first: SweepResult,
                         second: SweepResult) -> None:
    """Raise FleetIntegrityError unless the double-reported range's two
    executions agree bitwise on the contract fields."""
    bad = contract_mismatches(first, second)
    if bad:
        raise FleetIntegrityError(
            f"duplicate completion of range {range_id} disagrees with the "
            f"accepted result on: {', '.join(bad)} — two executions of "
            "the same seeds must be bitwise identical; this fleet is "
            "mixing engine versions or running nondeterministic code")


def _merge_coverage(ranges: Sequence[SeedRange],
                    parts: Dict[int, SweepResult]):
    """Fold per-range ledgers into the global ledger.

    ``hits`` are counts and ``first_seen`` minima (obs/coverage.py's
    order-invariance contract), and every range folds each of its seeds
    exactly once — so sum-of-hits and min-of-(first_seen + range.lo)
    reproduce the single-host ledger bit for bit. Returns the merged
    SweepCoverage, or None when the sweeps ran metrics-off.
    """
    from ..obs.coverage import SweepCoverage

    first_part = parts[ranges[0].range_id]
    if first_part.coverage is None:
        return None
    k = first_part.coverage.n_buckets
    hits = np.zeros(k, np.int64)
    first_seen = np.full(k, np.iinfo(np.int64).max, np.int64)
    novelty: List[int] = []
    for r in ranges:
        cov = parts[r.range_id].coverage
        if cov is None or cov.n_buckets != k:
            raise FleetIntegrityError(
                f"range {r.range_id} reported an incompatible coverage "
                f"ledger (buckets: {None if cov is None else cov.n_buckets}"
                f" vs {k}) — all workers must run the same engine config")
        hits += np.asarray(cov.hits, np.int64)
        fs = np.asarray(cov.first_seen_seed, np.int64)
        seen = fs >= 0
        # Range-local seed positions re-base to global by +lo; the
        # global first_seen is the min over ranges of the re-based ids.
        first_seen = np.where(seen, np.minimum(first_seen, fs + r.lo),
                              first_seen)
        novelty.append(int(np.count_nonzero(hits)))
    first_seen = np.where(first_seen == np.iinfo(np.int64).max,
                          np.int64(-1), first_seen)
    return SweepCoverage(
        n_buckets=k, hits=hits, first_seen_seed=first_seen,
        # Fleet novelty is sampled at RANGE grain (cumulative distinct
        # after merging each range in range-id order) — fabric
        # telemetry, deterministic for a given range split but not the
        # single-host per-chunk curve.
        novelty_curve=np.asarray(novelty, np.int64))


def merge_range_results(seeds: np.ndarray, ranges: Sequence[SeedRange],
                        parts: Dict[int, SweepResult], n_devices: int,
                        fleet_stats: Optional[Dict[str, Any]] = None
                        ) -> SweepResult:
    """Assemble the fleet SweepResult from one completed result per range.

    Requires every range completed exactly once in ``parts`` (the
    coordinator resolves duplicates before this point). Contract fields
    scatter per-seed into global position; telemetry fields concatenate
    in range-id order with chunk indices re-based.
    """
    ranges = sorted(ranges, key=lambda r: r.range_id)
    missing = [r.range_id for r in ranges if r.range_id not in parts]
    if missing:
        raise ValueError(f"cannot merge: ranges {missing} not completed")
    n = int(np.asarray(seeds).shape[0])
    if ranges[-1].hi != n or ranges[0].lo != 0:
        raise ValueError("ranges do not tile the seed vector")

    first = parts[ranges[0].range_id]
    obs: Dict[str, np.ndarray] = {}
    for key, proto in first.observations.items():
        proto = np.asarray(proto)
        obs[key] = np.zeros((n,) + proto.shape[1:], proto.dtype)
    steps_run = 0
    hist: List[np.ndarray] = []
    hist_chunks: List[np.ndarray] = []
    chunk_base = 0
    util_num = 0.0
    util_den = 0
    faults_sha = first.faults_sha256
    for r in ranges:
        p = parts[r.range_id]
        if p.faults_sha256 != faults_sha:
            raise FleetIntegrityError(
                f"range {r.range_id} swept a different fault schedule "
                f"({p.faults_sha256} vs {faults_sha})")
        for key in obs:
            obs[key][r.lo:r.hi] = np.asarray(p.observations[key])[:r.n_seeds]
        steps_run += p.steps_run
        hist.append(np.asarray(p.n_active_history, np.int64))
        hist_chunks.append(np.asarray(p.n_active_chunks, np.int64)
                           + chunk_base)
        chunk_base += int(p.loop_stats.get("chunks", 0))
        # Utilization weighted by issued steps (steps_run ~ chunk count;
        # an estimate — the exact issued-slot-step sums stay per range).
        util_num += p.world_utilization * max(p.steps_run, 1)
        util_den += max(p.steps_run, 1)

    loop_stats: Dict[str, Any] = {
        "fleet": dict(fleet_stats or {}),
        "ranges": {r.range_id: parts[r.range_id].loop_stats
                   for r in ranges},
    }
    return SweepResult(
        seeds=np.asarray(seeds),
        bug=obs["bug"],
        observations=obs,
        steps_run=steps_run,
        n_devices=n_devices,
        n_active_history=(np.concatenate(hist) if hist
                          else np.zeros(0, np.int64)),
        world_utilization=(util_num / util_den if util_den else 0.0),
        n_active_chunks=(np.concatenate(hist_chunks) if hist_chunks
                         else np.zeros(0, np.int64)),
        loop_stats=loop_stats,
        faults_sha256=faults_sha,
        coverage=_merge_coverage(ranges, parts),
    )
