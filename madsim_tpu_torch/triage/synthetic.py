"""Synthetic minimal-repro actor: a bug with a known minimal schedule.

The PyTorch counterpart of ``madsim_tpu/triage/synthetic.py``, batched over
a leading world axis. ``PairRestartActor`` raises its invariant iff both of
two designated nodes (``node_a``, ``node_b``) have been restarted at least
once, so a schedule's minimal failing subset is exactly the row restarting
``node_a`` and the row restarting ``node_b`` when every other row restarts
filler nodes. Its state is a dict, ``{"restarts": (W, N) int32}``.

:class:`PairActorBase` holds the body both pair families share: the guided
search's ``GuidedPairActor`` (search/family.py) differs only in the
progress beacon it sends on a target's first restart.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..engine.core import FAULT_RESTART, EngineConfig, Outbox
from ..engine.lanes import take_small, upd
from ..engine.queue import Event


@dataclasses.dataclass(frozen=True)
class PairRestartConfig:
    """Static parameters of the synthetic pair-restart bug."""

    n: int = 4        # nodes per world (engine n_nodes must match)
    node_a: int = 1   # the invariant fires when BOTH of these nodes
    node_b: int = 2   # have been restarted at least once


class PairActorBase:
    """A per-node restart counter; the bug is ``restarts[a] &
    restarts[b]``. One seed message (kind 0, time 1) keeps an
    empty-schedule world alive for a first delivered step; the handler
    does nothing. With :attr:`beacon`, a target's first restart sends one
    message of kind 1 to node 0 (outbox row 0)."""

    num_kinds = 1
    beacon = False

    def __init__(self, acfg):
        self.acfg = acfg

    def init(self, cfg: EngineConfig, rng):
        w = rng.k0.shape[0]
        dev = rng.k0.device

        def i32(v):
            return torch.full((w,), v, dtype=torch.int32, device=dev)

        s = {"restarts": torch.zeros((w, cfg.n_nodes), dtype=torch.int32,
                                     device=dev)}
        seed = Event(time=i32(1), kind=i32(0), flags=i32(0), src=i32(0),
                     dst=i32(0), gen=i32(0),
                     payload=torch.zeros((w, cfg.payload_words),
                                         dtype=torch.int32, device=dev))
        return s, [seed], rng

    def handle(self, cfg, s, ev, now, rng):
        w = ev.kind.shape[0]
        return (s, Outbox.empty(cfg, w, ev.kind.device), rng,
                torch.zeros((w,), dtype=torch.bool, device=ev.kind.device))

    def on_restart(self, cfg, s, node, now, rng):
        prev = take_small(s["restarts"], node)
        restarts = upd(s["restarts"], node, prev + 1)
        ob = Outbox.empty(cfg, node.shape[0], node.device)
        if self.beacon:
            a, b = self.acfg.node_a, self.acfg.node_b
            # A target's first restart beacons once: the observable
            # progress the novelty signal keys on.
            fire = ((node == a) | (node == b)) & (prev == 0)
            valid = ob.valid.clone()
            kind = ob.kind.clone()
            valid[:, 0] = fire
            kind[:, 0] = 1
            ob = ob._replace(valid=valid, kind=kind)
        return {"restarts": restarts}, ob, rng

    def invariant(self, cfg, s):
        a, b = self.acfg.node_a, self.acfg.node_b
        return (s["restarts"][..., a] > 0) & (s["restarts"][..., b] > 0)

    def observe(self, cfg, s):
        a, b = self.acfg.node_a, self.acfg.node_b
        return {
            "restarts_a": s["restarts"][..., a],
            "restarts_b": s["restarts"][..., b],
            "restarts_total": torch.sum(s["restarts"], dim=-1,
                                        dtype=torch.int32),
        }


class PairRestartActor(PairActorBase):
    """Counts per-node restarts; the bug is ``restarts[a] & restarts[b]``.
    No timing and no randomness: whether a world fails depends only on
    which schedule rows are enabled."""

    invariant_id = "pair_restart_conjunction"

    def __init__(self, acfg: PairRestartConfig = PairRestartConfig()):
        super().__init__(acfg)


def pair_schedule(n_rows: int = 32, need: Tuple[int, int] = (5, 20),
                  acfg: PairRestartConfig = PairRestartConfig(),
                  filler_node: int = 0, t0_us: int = 10_000,
                  dt_us: int = 10_000) -> np.ndarray:
    """A ``(n_rows, 4)`` restart schedule whose minimal failing subset is
    exactly rows ``need``: row ``need[0]`` restarts ``node_a``, row
    ``need[1]`` restarts ``node_b``, every other row ``filler_node``
    (times strictly increasing)."""
    i, j = need
    if not (0 <= i < n_rows and 0 <= j < n_rows and i != j):
        raise ValueError(f"need rows must be two distinct indices in "
                         f"[0, {n_rows}); got {need}")
    rows = np.zeros((n_rows, 4), np.int32)
    rows[:, 0] = t0_us + dt_us * np.arange(n_rows)
    rows[:, 1] = FAULT_RESTART
    rows[:, 2] = filler_node
    rows[i, 2] = acfg.node_a
    rows[j, 2] = acfg.node_b
    return rows


def engine_config(acfg: PairRestartConfig = PairRestartConfig(),
                  metrics: bool = False) -> EngineConfig:
    """The canonical engine config for this actor."""
    return EngineConfig(n_nodes=acfg.n, outbox_cap=2, queue_cap=64,
                        t_limit_us=2_000_000, metrics=metrics)
