"""Carrying world state between the JAX package and the port.

The simulator has no weights: its parameters are the configs, and its data
is the world state. A JAX ``WorldState`` pulled to the host as numpy arrays
in ``jax.tree.leaves`` order becomes the port's state with
:func:`state_from_numpy`, and :func:`state_to_numpy` turns it back — so a
state made by either package can be stepped by the other.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from .core import EngineConfig, WorldState, tree_leaves, tree_unflatten


def state_template(actor, cfg: EngineConfig) -> WorldState:
    """A one-world :class:`WorldState` of ``actor`` under ``cfg``, built on
    the CPU — the structure :func:`state_from_numpy` fills (NamedTuple
    actor states and the dict states of compiled actors alike)."""
    from .core import DeviceEngine

    return DeviceEngine(actor, cfg, device="cpu").init(np.zeros(1, np.uint64))


def state_from_numpy(leaves: List[np.ndarray], cfg: EngineConfig, actor,
                     device) -> WorldState:
    """Build the port's state from numpy leaves in ``jax.tree.leaves``
    order (38 for Raft; a compiled actor's lanes in sorted name order).
    Dtypes are kept, so a packed JAX state stays packed; ``cfg`` is checked
    against the queue's shape."""
    tpl = state_template(actor, cfg)
    n_expected = len(tree_leaves(tpl))
    if len(leaves) != n_expected:
        raise ValueError(f"expected {n_expected} leaves, got {len(leaves)}")
    state = tree_unflatten(tpl, [
        torch.from_numpy(np.array(x, order="C", copy=True)).to(device)
        for x in leaves])
    qshape = tuple(state.queue.payload.shape[1:])
    if qshape != (cfg.queue_cap, cfg.payload_words):
        raise ValueError(f"queue payload shape {qshape} does not match "
                         f"EngineConfig (queue_cap={cfg.queue_cap}, "
                         f"payload_words={cfg.payload_words})")
    if state.queue.payload.dtype != cfg.lanes.payload:
        raise ValueError(f"payload dtype {state.queue.payload.dtype} does "
                         f"not match EngineConfig(packed={cfg.packed})")
    return state


def state_to_numpy(state: WorldState) -> List[np.ndarray]:
    """The state's leaves as host numpy arrays, in leaf order."""
    return [x.cpu().numpy() for x in tree_leaves(state)]
