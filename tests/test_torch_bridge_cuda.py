"""The bridge's CUDA round and drain against the plain version, on a card.

Imports no JAX, so it runs where the card is (``python -m pytest
--noconftest tests/test_torch_bridge_cuda.py``: the suite's conftest
imports JAX); it skips where ``torch.cuda.is_available()`` is False.
``chip_smoke.py`` phase 13 holds the kernels to the plain version at full
width and to the JAX-derived digests.
"""
import numpy as np
import pytest
import torch

from madsim_tpu_torch.bridge import cuda as bcuda
from madsim_tpu_torch.bridge import golden
from madsim_tpu_torch.bridge.kernel import BridgeKernel
from madsim_tpu_torch.bridge.synthetic import SyntheticStream, drive
from madsim_tpu_torch.engine.convert import bridge_state_to_numpy


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["realistic", "edge"])
def test_cuda_round_and_drain_match_plain(mode):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: torch.cuda.is_available() is "
                    "False")
    seeds = np.arange(256)
    gk = BridgeKernel(seeds, cap=64, k_events=3, device="cuda",
                      metrics=True)
    ck = BridgeKernel(seeds, cap=64, k_events=3, device="cpu", metrics=True)
    stream = SyntheticStream(seeds, cap=64, mode=mode, seed=8)
    bcuda.reset_counts()
    for op, outs in drive(stream, [ck, gk], 20):
        if op != "reset":
            assert not golden.outputs_differ(outs[1], outs[0]), op
    assert bcuda.step_launches == 20
    a, b = bridge_state_to_numpy(ck), bridge_state_to_numpy(gk)
    for name in a:
        x, y = (a[name][:, :64], b[name][:, :64]) if name.startswith(
            "lane_") else (a[name], b[name])
        assert np.array_equal(x, y), name
