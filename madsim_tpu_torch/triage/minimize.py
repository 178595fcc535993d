"""Batched delta-debugging: minimize a failing fault schedule.

The port of ``madsim_tpu/triage/minimize.py``. The hunt ends with a seed
and a fault schedule that *fail*; this module turns that into the
smallest still-failing schedule, found by running every candidate shrink
of a ddmin round as ONE sweep on the engine's device (through the CUDA
step kernel when the engine is on the card): map the oracle over a
``(C, F, 4)`` per-world candidate batch, reduce the per-world bug flags.

Deterministic re-execution makes the "does it still fail?" oracle exact,
and the batched engine makes evaluating a round's candidates cost one
sweep, not one run per candidate.

- :func:`minimize_rows` — the oracle-agnostic ddmin fixpoint loop over
  ``(F, 4)`` schedules (triage/shrink.py generates candidates, the
  caller supplies ``evaluate(candidates) -> still_fails`` over a whole
  round's batch).
- :func:`minimize` — the device entry: pins (actor, config, seed),
  builds the one-sweep-per-round oracle (candidate batches padded to
  power-of-two world counts, the pad rows copies of candidate 0), and
  runs the loop to a 1-minimal fixpoint.

The same ``(seed, schedule)`` minimizes to a bitwise-identical schedule,
round history and candidate count across runs, across
``pipeline=True/False`` and across the two packages: candidate
generation is a pure function of the current schedule, the winner
tie-break is total (shrink.schedule_cost), and the sweep is bitwise the
JAX package's.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from .shrink import (
    as_schedule,
    compact,
    n_live,
    normalize,
    schedule_cost,
    single_drop_candidates,
    subset_candidates,
    tighten_candidates,
    weaken_candidates,
)

MINIMIZATION_SCHEMA = "madsim.triage.minimization/1"


class TriageError(RuntimeError):
    """Raised when the minimizer's preconditions fail: the original
    schedule does not fail, or the loop exceeds ``max_rounds``."""


@dataclasses.dataclass
class MinimizeResult:
    """Outcome of one schedule minimization.

    ``schedule`` is the compacted ``(L, 4)`` minimized rows (the array a
    repro bundle records); ``full`` keeps the original ``(F, 4)`` shape
    with dropped rows as DISABLED_ROW sentinels (row positions intact,
    so "which original rows survived" is readable). ``one_minimal``
    certifies the final verification round: dropping any single
    remaining row made the failure disappear.
    """

    seed: int
    original: np.ndarray          # (F, 4) normalized input schedule
    full: np.ndarray              # (F, 4) minimized, positions preserved
    schedule: np.ndarray          # (L, 4) compacted minimized rows
    rounds: int                   # candidate-batch evaluations (sweeps)
    candidates_evaluated: int     # total candidates across all rounds
    weakenings: List[str]         # severity/tightening labels applied
    one_minimal: bool
    history: List[Dict[str, Any]]  # per-round {phase, candidates, ...}
    params: Dict[str, Any]        # oracle knobs (chunk_steps, ...)

    @property
    def original_rows(self) -> int:
        return n_live(self.original)

    @property
    def final_rows(self) -> int:
        return int(self.schedule.shape[0])

    def provenance(self) -> Dict[str, Any]:
        """The ``minimization`` block a repro bundle embeds
        (obs/bundle.py), schema ``madsim.triage.minimization/1``."""
        return {
            "schema": MINIMIZATION_SCHEMA,
            "seed": int(self.seed),
            "rounds": int(self.rounds),
            "candidates_evaluated": int(self.candidates_evaluated),
            "original_rows": self.original_rows,
            "final_rows": self.final_rows,
            "weakenings": list(self.weakenings),
            "one_minimal": bool(self.one_minimal),
            "params": dict(self.params),
        }

    def summary(self) -> str:
        w = (f", {len(self.weakenings)} weakening(s)"
             if self.weakenings else "")
        return (f"minimized seed {self.seed}: {self.original_rows} -> "
                f"{self.final_rows} fault rows in {self.rounds} rounds "
                f"({self.candidates_evaluated} candidates{w}; "
                f"1-minimal={'yes' if self.one_minimal else 'no'})")


def minimize_rows(sched0: np.ndarray,
                  evaluate: Callable[[List[np.ndarray]], np.ndarray],
                  *, weaken: bool = True, tighten: bool = False,
                  max_rounds: int = 128
                  ) -> Tuple[np.ndarray, Dict[str, Any]]:
    """The oracle-agnostic batched-ddmin fixpoint loop.

    ``evaluate`` receives one ROUND's candidate schedules (a list of
    ``(F, 4)`` arrays) and returns a bool vector — True where the
    candidate STILL FAILS. It is called once per round; how a round is
    executed (one device sweep, sequential host re-runs) is entirely the
    caller's. Returns ``(minimized_full_schedule, stats)`` where stats
    carries rounds / candidates / history / weakenings / one_minimal.

    Phases: (1) verify the input fails (and try the empty schedule — a
    schedule-independent failure short-circuits to zero rows); (2) ddmin
    row reduction to a fixpoint where no subset/complement at any
    granularity still fails; (3) optional severity weakening (and
    opt-in fire-time tightening), greedily adopting the cheapest
    still-failing candidate per round; (4) 1-minimality verification —
    the final schedule must fail and every single-row drop must not;
    a drop that still fails (weakening can shift dynamics) is adopted
    and the loop re-verifies, so the result is a true fixpoint.
    """
    cur = normalize(np.asarray(sched0, np.int32))
    rounds = 0
    cands_total = 0
    history: List[Dict[str, Any]] = []
    weakenings: List[str] = []

    def run_round(phase: str, pairs: List[Tuple[str, np.ndarray]]
                  ) -> np.ndarray:
        nonlocal rounds, cands_total
        if rounds >= max_rounds:
            raise TriageError(
                f"minimization did not converge in {max_rounds} rounds "
                f"({cands_total} candidates evaluated) — raise max_rounds")
        fails = np.asarray(evaluate([p[1] for p in pairs]), bool)
        assert fails.shape == (len(pairs),), \
            f"oracle returned {fails.shape} for {len(pairs)} candidates"
        rounds += 1
        cands_total += len(pairs)
        history.append({"phase": phase, "candidates": len(pairs),
                        "failing": int(fails.sum())})
        return fails

    def pick_winner(pairs, fails) -> Optional[int]:
        """Deterministic round winner: the cheapest still-failing
        candidate under shrink.schedule_cost (a total order)."""
        win = [i for i in range(len(pairs)) if fails[i]]
        if not win:
            return None
        return min(win, key=lambda i: schedule_cost(pairs[i][1]))

    # -- phase 1: verify the failure (and the empty short-circuit) -------
    empty = np.broadcast_to(np.array([-1, 0, 0, 0], np.int32),
                            cur.shape).copy()
    pairs0: List[Tuple[str, np.ndarray]] = [("original", cur)]
    if n_live(cur):
        pairs0.append(("empty", empty))
    fails = run_round("verify-original", pairs0)
    if not fails[0]:
        raise TriageError(
            "the seed does not fail under the original schedule — "
            "nothing to minimize (check seed/config/schedule drift)")
    if len(pairs0) > 1 and fails[1]:
        # Failure is schedule-independent: the minimal schedule is empty.
        cur = empty

    # -- phase 2: ddmin row reduction ------------------------------------
    k = 2
    while n_live(cur):
        pairs = subset_candidates(cur, k)
        fails = run_round(f"ddmin:k={min(k, n_live(cur))}", pairs)
        best = pick_winner(pairs, fails)
        if best is not None:
            label = pairs[best][0]
            history[-1]["adopted"] = label
            cur = normalize(pairs[best][1])
            # Classic ddmin schedule: reduce-to-subset restarts at the
            # coarsest granularity; reduce-to-complement refines by one.
            k = 2 if label.startswith(("subset", "drop")) else max(k - 1, 2)
        else:
            if k >= n_live(cur):
                break  # tested every single-row drop: row-phase fixpoint
            k = min(2 * k, n_live(cur))

    # -- phase 3: severity weakening / fire-time tightening --------------
    while weaken or tighten:
        pairs = ((weaken_candidates(cur) if weaken else [])
                 + (tighten_candidates(cur) if tighten else []))
        if not pairs:
            break
        fails = run_round("weaken", pairs)
        best = pick_winner(pairs, fails)
        if best is None:
            break
        history[-1]["adopted"] = pairs[best][0]
        weakenings.append(pairs[best][0])
        cur = normalize(pairs[best][1])

    # -- phase 4: 1-minimality verification (a true fixpoint) ------------
    one_minimal = False
    while True:
        pairs = [("final", cur)] + single_drop_candidates(cur)
        fails = run_round("verify-1min", pairs)
        if not fails[0]:
            raise TriageError(
                "the minimized schedule stopped failing at verification "
                "— the oracle is not deterministic?")
        best = pick_winner(pairs[1:], fails[1:])
        if best is None:
            one_minimal = True
            break
        # A single-row drop still fails (weakening shifted the dynamics):
        # adopt it — the verify round doubles as a reduction round — and
        # go around again until the drop set is clean.
        history[-1]["adopted"] = pairs[1 + best][0]
        cur = normalize(pairs[1 + best][1])

    stats = {"rounds": rounds, "candidates_evaluated": cands_total,
             "history": history, "weakenings": weakenings,
             "one_minimal": one_minimal}
    return cur, stats


def minimize(actor: Any, cfg: Any, seed: int, faults,
             *, engine: Any = None, mesh: Any = None,
             chunk_steps: int = 64, max_steps: int = 20_000,
             pipeline: bool = True, weaken: bool = True,
             tighten: bool = False, max_rounds: int = 128
             ) -> MinimizeResult:
    """Minimize a failing ``(seed, fault schedule)`` on the device engine.

    Each round's candidates are stacked into ONE per-world ``(C, F, 4)``
    faults array and evaluated as a single sweep against the pinned seed
    (every world simulates the same seed under a different candidate
    schedule), in the pipelined loop or, with ``pipeline=False``, the
    serial one; the round's winner is the cheapest still-failing
    candidate under the deterministic :func:`~.shrink.schedule_cost`
    order. Candidate batches are padded to power-of-two world counts, and
    to at least the mesh size (replicating candidate 0, whose verdict is
    sliced off), as in the JAX package.

    ``engine`` (optional) reuses an existing ``DeviceEngine`` for
    ``(actor, cfg)``; without it a new engine runs on the card. ``mesh``
    (``parallel/mesh.py``) splits each round's sweep over its devices; by
    default the sweeps run on the engine's device. ``pipeline`` selects the sweep loop and does
    not change the result. ``weaken`` enables the severity-weakening
    phase; ``tighten`` opts into fire-time halving (it rewrites row
    times, so the minimized rows are no longer a subset of the
    originals — off by default). Raises :class:`TriageError` if the seed
    does not fail under the original schedule or the loop exceeds
    ``max_rounds``.
    """
    from ..engine.core import DeviceEngine
    from ..parallel.sweep import _pow2_at_least, sweep

    eng = engine if engine is not None else DeviceEngine(actor, cfg)
    n_dev = 1 if mesh is None else int(mesh.devices.size)
    sched0 = as_schedule(faults)

    def evaluate(cands: List[np.ndarray]) -> np.ndarray:
        c = len(cands)
        w = max(_pow2_at_least(c), n_dev)
        arr = np.stack(list(cands) + [cands[0]] * (w - c)) \
            .astype(np.int32, copy=False)
        res = sweep(None, eng.cfg, np.full(w, seed, np.uint64),
                    faults=arr, engine=eng, mesh=mesh,
                    chunk_steps=chunk_steps, max_steps=max_steps,
                    pipeline=pipeline)
        return np.asarray(res.bug[:c], bool)

    final, stats = minimize_rows(sched0, evaluate, weaken=weaken,
                                 tighten=tighten, max_rounds=max_rounds)
    return MinimizeResult(
        seed=int(seed), original=sched0, full=final,
        schedule=compact(final),
        rounds=stats["rounds"],
        candidates_evaluated=stats["candidates_evaluated"],
        weakenings=stats["weakenings"],
        one_minimal=stats["one_minimal"],
        history=stats["history"],
        params={"chunk_steps": int(chunk_steps),
                "max_steps": int(max_steps),
                "pipeline": bool(pipeline), "weaken": bool(weaken),
                "tighten": bool(tighten)},
    )
