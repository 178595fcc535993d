"""Synthetic guided-hunt family: a conjunction bug with observable progress.

The PyTorch counterpart of ``madsim_tpu/search/family.py``.
``GuidedPairActor`` fails iff both target nodes have been restarted at least
once, like triage's ``PairRestartActor``, and makes partial progress
visible: the first restart of each target sends a "progress beacon" (kind
1 to node 0), so a world that restarted one target delivers another
``kind_hist`` than one that restarted none, lands in another behavior
signature, and the guided corpus keeps its schedule as a parent. The
template (:func:`family_schedule`) restarts filler nodes only: the bug is
reachable only through the search's node rotation.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..engine.core import FAULT_RESTART, EngineConfig
from ..triage.synthetic import PairActorBase


@dataclasses.dataclass(frozen=True)
class GuidedPairConfig:
    """Static parameters of the guided pair-restart family."""

    n: int = 8        # nodes per world (engine n_nodes must match)
    node_a: int = 1   # the invariant fires when BOTH targets have
    node_b: int = 2   # been restarted at least once


class GuidedPairActor(PairActorBase):
    """Pair-restart conjunction with progress beacons. Event kinds: 0 the
    seed message, 1 a progress beacon (sent once per target, on its first
    restart; an ordinary message, latency-sampled and subject to loss,
    clogs and a dead destination)."""

    num_kinds = 2
    kind_names = ["seed", "progress"]
    invariant_id = "guided_pair_conjunction"
    beacon = True

    def __init__(self, acfg: GuidedPairConfig = GuidedPairConfig()):
        super().__init__(acfg)


def family_schedule(n_rows: int = 8,
                    acfg: GuidedPairConfig = GuidedPairConfig(),
                    t0_us: int = 20_000, dt_us: int = 20_000) -> np.ndarray:
    """The ``(n_rows, 4)`` template: restarts of filler nodes only, at
    strictly increasing times."""
    fillers = [i for i in range(acfg.n)
               if i not in (acfg.node_a, acfg.node_b)]
    if not fillers:
        raise ValueError("GuidedPairConfig needs at least one filler node")
    rows = np.zeros((n_rows, 4), np.int32)
    rows[:, 0] = t0_us + dt_us * np.arange(n_rows)
    rows[:, 1] = FAULT_RESTART
    rows[:, 2] = [fillers[i % len(fillers)] for i in range(n_rows)]
    return rows


def engine_config(acfg: GuidedPairConfig = GuidedPairConfig()
                  ) -> EngineConfig:
    """The canonical metrics-on engine config for this family (the novelty
    signal hashes the metrics block)."""
    return EngineConfig(n_nodes=acfg.n, outbox_cap=2, queue_cap=64,
                        t_limit_us=2_000_000, metrics=True)


# The canonical guided-hunt shape: 12 nodes (10 fillers) and a 6-row
# template.
HUNT_NODES = 12
HUNT_ROWS = 6


def hunt_search_config(guided: bool = True, corpus: int = 32):
    """The :class:`~madsim_tpu_torch.search.SearchConfig` of the canonical
    family hunt; ``guided=False`` is the matched random-mutation baseline
    (same operators and rates, no feedback)."""
    from .config import SearchConfig

    return SearchConfig(corpus=corpus, guided=guided, splice_pct=20,
                        disable_pct=5, time_pct=20, node_pct=15, op_pct=5)
