"""Observation digests of the JAX package, for checking the port where JAX
is not installed.

The GPU machine has no JAX, so the port cannot be compared with the JAX
package there directly. Instead, :data:`GOLDEN` holds the SHA-256 of the
JAX engine's ``observe()`` for seeds 0..63 of two deployments, and
``chip_smoke.py`` checks that the port, stepping through the CUDA kernel,
reproduces them. ``tests/test_torch_engine.py`` recomputes every digest
from the JAX package on the CPU, so the constants cannot drift from it.
"""
from __future__ import annotations

import hashlib
from typing import Dict

import numpy as np

from .core import FAULT_KILL, FAULT_RESTART

SEEDS = np.arange(64)

#: name -> (RaftDeviceConfig kwargs, EngineConfig kwargs, fault rows,
#: max_steps). The headline is bench.py's device_seed_rate deployment; the
#: hunt is bench_time_to_first_bug's, with a kill/restart schedule added.
CONFIGS = {
    "headline": (
        dict(n=3, log_cap=4),
        dict(n_nodes=3, outbox_cap=4, queue_cap=28, t_limit_us=1_000_000),
        None, 2_000),
    "hunt_faults": (
        dict(n=3, buggy_double_vote=True),
        dict(n_nodes=3, outbox_cap=4, queue_cap=64, t_limit_us=2_000_000,
             stop_on_bug=False),
        [[400_000, FAULT_KILL, 0, 0], [900_000, FAULT_RESTART, 0, 0]],
        4_000),
}

#: SHA-256 of observe() for SEEDS under each config (see observe_digest).
GOLDEN = {
    "headline":
        "2108f4f2e26feab0d9abab203cd086e84e32d20c9952d41306d0aafec6991f5c",
    "hunt_faults":
        "9d49b9d3f36ed613c1de05fccbc06de8513d14167753d6fce987cdf62dfb98a0",
}


def observe_digest(obs: Dict[str, np.ndarray]) -> str:
    """SHA-256 over an observation dict: every key in sorted order with
    its array's dtype, shape and bytes."""
    h = hashlib.sha256()
    for key in sorted(obs):
        a = np.ascontiguousarray(np.asarray(obs[key]))
        h.update(key.encode())
        h.update(a.dtype.str.encode())
        h.update(repr(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()
