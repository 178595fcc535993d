"""The three canonical guided hunts, each against its matched
random-mutation baseline (``SearchConfig(guided=False)``: the same
operators, rates and budget, no feedback).

The PyTorch counterpart of ``madsim_tpu/search/hunts.py``; the same
actors, configs, templates and search knobs.

- **pair**: the synthetic conjunction family (search/family.py): the bug
  needs two node restarts the template never performs, and partial
  progress is behaviorally visible;
- **raft**: the seeded double-vote bug (``buggy_double_vote``) made
  schedule-gated: a wide election window and narrow latency make natural
  candidate collisions rare, while overlapping long pauses flush buffered
  election timers together on resume; the template's short, disjoint
  pauses are benign, and the search must grow overlap;
- **paxos**: multi-decree Paxos with forgetful acceptors
  (``PaxosConfig(buggy_forgetful_acceptor=True)``): every decree is
  contended, and the consistency violation needs two restarts jittered
  from the benign early template into an amnesia window.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from .config import SearchConfig
from .family import (
    HUNT_NODES,
    HUNT_ROWS,
    GuidedPairActor,
    GuidedPairConfig,
    engine_config,
    family_schedule,
    hunt_search_config,
)


class Hunt(NamedTuple):
    """One bench/demo hunt setup: build engines with
    ``DeviceEngine(actor, cfg)`` and sweep with ``template`` +
    ``search(guided=...)``."""

    name: str
    actor: object
    cfg: object
    template: np.ndarray
    search: object            # callable(guided: bool) -> SearchConfig
    sweep_kw: dict            # canonical sweep knobs (batch, chunks, ...)


def pair_hunt() -> Hunt:
    """The conjunction family at the canonical shape."""
    acfg = GuidedPairConfig(n=HUNT_NODES)
    return Hunt(
        name="pair_restart_family",
        actor=GuidedPairActor(acfg),
        cfg=engine_config(acfg),
        template=family_schedule(HUNT_ROWS, acfg),
        search=hunt_search_config,
        sweep_kw=dict(recycle=True, batch_worlds=32, chunk_steps=32,
                      max_steps=50_000_000),
    )


def raft_hunt() -> Hunt:
    """The seeded raft double-vote bug, schedule-gated (see module
    docstring for why each constant is what it is)."""
    from ..engine import EngineConfig, RaftActor, RaftDeviceConfig
    from ..engine.core import FAULT_PAUSE, FAULT_RESUME

    rcfg = RaftDeviceConfig(n=5, buggy_double_vote=True,
                            elect_min_us=150_000, elect_max_us=1_300_000,
                            heartbeat_us=40_000)
    cfg = EngineConfig(n_nodes=5, outbox_cap=6, queue_cap=64,
                       t_limit_us=1_600_000, latency_min_us=1_000,
                       latency_max_us=3_000, metrics=True)
    # Benign template: three short, disjoint single-node pauses.
    template = np.array([
        [200_000, FAULT_PAUSE, 4, 0],
        [240_000, FAULT_RESUME, 4, 0],
        [500_000, FAULT_PAUSE, 3, 0],
        [540_000, FAULT_RESUME, 3, 0],
        [800_000, FAULT_PAUSE, 4, 0],
        [840_000, FAULT_RESUME, 4, 0]], np.int32)

    def search(guided: bool = True) -> SearchConfig:
        return SearchConfig(corpus=16, guided=guided, splice_pct=20,
                            disable_pct=5, time_pct=40, node_pct=15,
                            op_pct=5, time_jitter_us=400_000)

    return Hunt(
        name="seeded_raft_double_vote",
        actor=RaftActor(rcfg),
        cfg=cfg,
        template=template,
        search=search,
        sweep_kw=dict(recycle=True, batch_worlds=32, chunk_steps=64,
                      max_steps=50_000_000),
    )


def paxos_hunt() -> Hunt:
    """The multi-decree Paxos forgetful-acceptor hunt — the first
    DSL-only family leg (see module docstring for the staircase
    shape; tuning measured in actorc/families/paxos.py)."""
    from ..actorc.families.paxos import (PaxosActor, PaxosConfig,
                                         engine_config, hunt_template)

    xcfg = PaxosConfig(buggy_forgetful_acceptor=True, contend_all=True)

    def search(guided: bool = True) -> SearchConfig:
        return SearchConfig(corpus=32, guided=guided, splice_pct=20,
                            disable_pct=5, time_pct=40, node_pct=15,
                            op_pct=5, time_jitter_us=60_000)

    return Hunt(
        name="paxos_forgetful_acceptor",
        actor=PaxosActor(xcfg),
        cfg=engine_config(xcfg, metrics=True),
        template=hunt_template(xcfg),
        search=search,
        sweep_kw=dict(recycle=True, batch_worlds=32, chunk_steps=32,
                      max_steps=50_000_000),
    )
