"""Backend bit-exactness check: the same seeds must run identically on
every device.

The PyTorch counterpart of ``madsim_tpu/engine/crosscheck.py``. The engine's
contract is that (seed, config) gives the same trajectory wherever it runs:
every step is integer or exactly rounded float32 arithmetic, so the CUDA
kernel and the CPU's plain step must agree to the last bit, and any
difference is an engine bug, not noise.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .convert import to_numpy
from .core import DeviceEngine, tree_leaves, tree_map, tree_paths


def _run(eng: DeviceEngine, device, seeds, faults, max_steps: int):
    """init + run of a seed batch in a twin of ``eng`` on ``device``;
    returns the twin and the state, on the device."""
    twin = DeviceEngine(eng.actor, eng.cfg, device=device)
    state = twin.run(twin.init(np.asarray(seeds), faults=faults), max_steps)
    if twin.device.type == "cuda":
        torch.cuda.synchronize(twin.device)
    return twin, state


def run_on(eng: DeviceEngine, device, seeds, faults=None,
           max_steps: int = 100_000):
    """init + run a seed batch on ``device`` (a twin engine of ``eng``
    there: the port's engine owns its device); returns the final state's
    leaves as host numpy arrays, in the state's structure."""
    _twin, state = _run(eng, device, seeds, faults, max_steps)
    return tree_map(to_numpy, state)


def crosscheck_backends(eng: DeviceEngine, seeds, faults=None,
                        max_steps: int = 100_000,
                        device_a=None, device_b=None) -> Dict[str, int]:
    """Run the same batch on two devices and assert leafwise bit-equality
    (dtype, shape and bits) and equal ``observe()`` dicts.

    Defaults: ``device_a`` the engine's device (CUDA), ``device_b`` the
    CPU. Returns a small summary dict; raises AssertionError naming the
    first differing leaves on any mismatch.
    """
    device_a = torch.device(device_a if device_a is not None
                            else eng.device)
    device_b = torch.device(device_b if device_b is not None else "cpu")
    twin_a, sa = _run(eng, device_a, seeds, faults, max_steps)
    twin_b, sb = _run(eng, device_b, seeds, faults, max_steps)
    paths = tree_paths(sa)
    leaves_a = [to_numpy(x) for x in tree_leaves(sa)]
    leaves_b = [to_numpy(x) for x in tree_leaves(sb)]
    mismatched = []
    for path, a, b in zip(paths, leaves_a, leaves_b):
        if a.dtype != b.dtype or a.shape != b.shape or not np.array_equal(a, b):
            diffs = int(np.sum(a != b)) if a.shape == b.shape else -1
            mismatched.append(f"{path}: {diffs} differing elements "
                              f"({a.dtype}{list(a.shape)})")
    if mismatched:
        raise AssertionError(
            f"{device_a.type} vs {device_b.type} trajectories diverged on "
            f"{len(mismatched)} leaves:\n  " + "\n  ".join(mismatched[:10]))
    obs_a, obs_b = twin_a.observe(sa), twin_b.observe(sb)
    for k in obs_a:
        if not np.array_equal(obs_a[k], obs_b[k]):
            raise AssertionError(f"observe[{k}] diverged")
    return {
        "n_worlds": int(np.asarray(seeds).shape[0]),
        "n_leaves": len(leaves_a),
        "platform_a": device_a.type,
        "platform_b": device_b.type,
        "bitwise_equal": 1,
    }
