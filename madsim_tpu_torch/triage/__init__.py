"""Failure triage: batched schedule minimization + deduplicated corpus.

The port of ``madsim_tpu/triage``. The sweep hands back failing seeds and
fault schedules; this package turns them into artifacts a human can act
on —

- :mod:`.shrink` — the schedule algebra: deterministic candidate
  generators over ``(F, 4)`` fault schedules (ddmin row subsets,
  severity weakening, fire-time tightening) and the total
  ``schedule_cost`` order that makes every round's winner unique.
- :mod:`.minimize` — the batched delta-debugging loop: each round's
  candidates run as ONE per-world ``(C, F, 4)`` sweep against the pinned
  seed (the exact deterministic oracle), to a 1-minimal fixpoint.
  ``minimize(actor, cfg, seed, faults)`` is the entry;
  ``SweepResult.minimize(seed)`` wraps it with the sweep's own context.
- :mod:`.corpus` — the deduplicated bug corpus: failures bucketed into
  classes by behavior signature (obs/coverage.py) + invariant id, one
  representative minimized per class, each emitted as an obs/bundle.py
  repro bundle with a ``minimization`` provenance block.
  ``triage(result)`` is the entry.
- :mod:`.synthetic` — the known-minimal-repro fixture actor
  (``PairRestartActor``).

The same inputs give the JAX package's results bit for bit: the
minimized schedule, the round history and the bundle files.
"""
from .corpus import (
    FailureClass,
    TriageReport,
    behavior_signatures,
    failure_classes,
    triage,
)
from .minimize import (
    MINIMIZATION_SCHEMA,
    MinimizeResult,
    TriageError,
    minimize,
    minimize_rows,
)
from .shrink import as_schedule, compact, n_live, schedule_cost
from .synthetic import PairRestartActor, PairRestartConfig, pair_schedule

__all__ = [
    "minimize", "minimize_rows", "MinimizeResult", "TriageError",
    "MINIMIZATION_SCHEMA",
    "triage", "failure_classes", "FailureClass", "TriageReport",
    "behavior_signatures",
    "as_schedule", "compact", "n_live", "schedule_cost",
    "PairRestartActor", "PairRestartConfig", "pair_schedule",
]
