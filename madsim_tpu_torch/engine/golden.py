"""Observation digests of the JAX package, for checking the port where JAX
is not installed.

The GPU machine has no JAX, so the port cannot be compared with the JAX
package there directly. Instead, :data:`GOLDEN` holds the SHA-256 of the
JAX engine's ``observe()`` for seeds 0..63 of two deployments, and
:data:`GOLDEN_OBS` / :data:`GOLDEN_SWEEP` those of the hunt with the
metrics block and the flight recorder on: its ``observe()``, and the
result of a small recycled sweep (:data:`SWEEP`); :data:`GOLDEN_FAMILIES`
those of the compiled families' deployments (:data:`FAMILY_CONFIGS`).
``chip_smoke.py`` checks that the port, stepping through the CUDA kernel,
reproduces them. ``tests/test_torch_engine.py``, ``tests/test_torch_sweep.py``
and ``tests/test_torch_families.py`` recompute every digest from the JAX
package on the CPU, so the constants cannot drift from it.
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


#: The hunt with kill/restart (CONFIGS["hunt_faults"]) with these
#: EngineConfig fields added: the metrics block and a 64-deep ring.
OBS_ON = dict(metrics=True, blackbox=64)

#: A recycled sweep of the hunt with kill/restart, metrics on and a 16-deep
#: ring: the seeds and the sweep's keyword arguments (pipeline=False).
SWEEP = dict(seeds=np.arange(256), over=dict(metrics=True, blackbox=16),
             kwargs=dict(chunk_steps=64, max_steps=4_000, recycle=True,
                         batch_worlds=64))

#: SHA-256 of observe() for SEEDS under CONFIGS["hunt_faults"] + OBS_ON.
GOLDEN_OBS = (
    "317e110980ba730937aa0591e9111933cac2d520e7ca10f56caad1522c13dbb5")

#: sweep_digest of the SWEEP over CONFIGS["hunt_faults"] + SWEEP["over"].
GOLDEN_SWEEP = (
    "c723302d23f7261e764bcc23a0bdf6b8a91c8c6f00254b5d63944ea4bd6037c4")


#: The compiled families' deployments on the card: name -> (family in
#: ``engine/families.py``, its config kwargs, EngineConfig kwargs, fault
#: rows, max_steps). tpc_crosscheck and pb_crosscheck are bench.py's
#: bench_crosscheck legs (bench.py:980-990); pb_hunt is
#: tests/test_pb_actor.py's bug hunt (commit after the first ack, loss 0.3,
#: the primary killed at 130 ms).
FAMILY_CONFIGS = {
    "tpc_crosscheck": (
        "tpc", dict(n=4, n_txns=4, buggy_presumed_commit=True),
        dict(n_nodes=4, outbox_cap=5, queue_cap=64, t_limit_us=1_500_000,
             loss_rate=0.1),
        None, 5_000),
    "pb_crosscheck": (
        "pb", dict(n=3, n_writes=4),
        dict(n_nodes=3, outbox_cap=4, queue_cap=64, t_limit_us=1_500_000,
             loss_rate=0.05),
        None, 5_000),
    "pb_hunt": (
        "pb", dict(n=3, n_writes=4, buggy_commit_early=True),
        dict(n_nodes=3, outbox_cap=4, queue_cap=48, t_limit_us=2_000_000,
             loss_rate=0.3),
        [[130_000, FAULT_KILL, 0, 0]], 8_000),
}

#: SHA-256 of observe() for SEEDS under each of FAMILY_CONFIGS.
GOLDEN_FAMILIES = {
    "tpc_crosscheck":
        "8abbbff1adf8bdbab32c72ae149dcccf2fd135674c3db3d71850099baea3f50e",
    "pb_crosscheck":
        "7543f4af3011166516227ffddc8801951181ae153052443c7e0ed01c0827dc45",
    "pb_hunt":
        "18bb10c188dea992e33571d9fff19ca1270902e7c5673505abed9c63f370fda3",
}


def observe_digest(obs: Dict[str, np.ndarray]) -> str:
    """SHA-256 over an observation dict: every key in sorted order with
    its array's dtype, shape and bytes."""
    h = hashlib.sha256()
    _update(h, obs)
    return h.hexdigest()


def _update(h, arrays: Dict[str, np.ndarray]):
    for key in sorted(arrays):
        a = np.ascontiguousarray(np.asarray(arrays[key]))
        h.update(key.encode())
        h.update(a.dtype.str.encode())
        h.update(repr(a.shape).encode())
        h.update(a.tobytes())


def sweep_digest(res) -> str:
    """SHA-256 over a SweepResult: its seeds and bug flags, every
    observation, the occupancy history and its chunk indices, the coverage
    ledger (hits, first seen seeds, novelty curve) and ``summary()``."""
    h = hashlib.sha256()
    cov = res.coverage
    _update(h, {"seeds": res.seeds, "bug": res.bug,
                "n_active_history": res.n_active_history,
                "n_active_chunks": res.n_active_chunks,
                "cov_hits": cov.hits, "cov_first_seen": cov.first_seen_seed,
                "cov_novelty": cov.novelty_curve})
    _update(h, res.observations)
    h.update(res.summary().encode())
    return h.hexdigest()
