"""The actor-family registry: every workload family the port ships, with
its canonical conformance shape.

The port of ``madsim_tpu/engine/families.py``: raft, pb, tpc, paxos and
the guided search's synthetic families ``pair_restart`` and
``guided_pair``, with the JAX registry's ``conformance()`` shapes and
``compiled`` and ``divergent`` flags. Three consumers read it: the replay
CLI resolves ``name -> (actor class, config class)`` here (``python -m
madsim_tpu_torch.obs replay --actor <name>`` and bundle replay), triage
names the family inside repro bundles, and the conformance check
(:func:`~madsim_tpu_torch.engine.conformance.check_actor`) runs over every
entry's canonical ``conformance()`` shape. Imports are lazy per entry.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class Family:
    """One registered actor family."""

    name: str
    load: Callable[[], Tuple[type, type]]   # -> (actor_cls, config_cls)
    # Canonical (actor, EngineConfig) for the conformance check — the
    # clean (bug switches off) shape check_actor validates.
    conformance: Callable[[], Tuple[Any, Any]]
    compiled: bool = False                   # actorc-spec family?
    # Synthetic fixture families are deliberately schedule-driven: the
    # fault-free trajectory is seed-invariant, so check_actor's
    # distinct-seeds-diverge requirement is waived for them.
    divergent: bool = True

    @property
    def actor_cls(self) -> type:
        return self.load()[0]

    @property
    def config_cls(self) -> type:
        return self.load()[1]


def _raft() -> Family:
    def load():
        from .raft_actor import RaftActor, RaftDeviceConfig

        return RaftActor, RaftDeviceConfig

    def conf():
        from .core import EngineConfig

        cls, cfg = load()
        return cls(cfg(n=3, n_proposals=2)), EngineConfig(
            n_nodes=3, outbox_cap=4, queue_cap=64, t_limit_us=2_000_000)
    return Family("raft", load, conf)


def _pb() -> Family:
    def load():
        from .pb_actor import PBActor, PBDeviceConfig

        return PBActor, PBDeviceConfig

    def conf():
        from .core import EngineConfig

        cls, cfg = load()
        return cls(cfg(n=3, n_writes=3)), EngineConfig(
            n_nodes=3, outbox_cap=4, queue_cap=64, t_limit_us=2_000_000)
    return Family("pb", load, conf, compiled=True)


def _tpc() -> Family:
    def load():
        from .tpc_actor import TPCActor, TPCDeviceConfig

        return TPCActor, TPCDeviceConfig

    def conf():
        from .core import EngineConfig

        cls, cfg = load()
        return cls(cfg(n=4, n_txns=4)), EngineConfig(
            n_nodes=4, outbox_cap=5, queue_cap=64, t_limit_us=2_000_000)
    return Family("tpc", load, conf, compiled=True)


def _paxos() -> Family:
    def load():
        from ..actorc.families.paxos import PaxosActor, PaxosConfig

        return PaxosActor, PaxosConfig

    def conf():
        from ..actorc.families.paxos import engine_config

        cls, cfg = load()
        acfg = cfg()
        return cls(acfg), engine_config(acfg)
    return Family("paxos", load, conf, compiled=True)


def _pair_restart() -> Family:
    def load():
        from ..triage.synthetic import PairRestartActor, PairRestartConfig

        return PairRestartActor, PairRestartConfig

    def conf():
        from ..triage.synthetic import engine_config

        cls, cfg = load()
        acfg = cfg()
        return cls(acfg), engine_config(acfg)
    return Family("pair_restart", load, conf, divergent=False)


def _guided_pair() -> Family:
    def load():
        from ..search.family import GuidedPairActor, GuidedPairConfig

        return GuidedPairActor, GuidedPairConfig

    def conf():
        from ..search.family import engine_config

        cls, cfg = load()
        acfg = cfg()
        return cls(acfg), engine_config(acfg)
    return Family("guided_pair", load, conf, divergent=False)


def actor_families() -> Dict[str, Family]:
    """name -> :class:`Family`, for every family the port ships."""
    fams = [_raft(), _pb(), _tpc(), _paxos(), _pair_restart(),
            _guided_pair()]
    return {f.name: f for f in fams}


def family(name: str) -> Optional[Family]:
    return actor_families().get(name)
