"""The bridge's CUDA round and drain against the plain version, on a card.

Imports no JAX, so it runs where the card is (``python -m pytest
--noconftest tests/test_torch_bridge_cuda.py``: the suite's conftest
imports JAX); the ``cuda``-marked tests skip where
``torch.cuda.is_available()`` is False. ``chip_smoke.py`` phase 13 holds
the kernels to the plain version at full width and to the JAX-derived
digests. The launch shapes: W of 1, 7, 130 and 512 at ``cap`` 40, 128 and
1,024, and seven more (1,001 at 128; 2,049 at 40 and 4,097 at 128, whose
last warp holds one world; 2,051 at 40, 3,003 and 4,101 at 128, whose last
block holds an odd number of worlds, 3 or more, with bulk copies after
them; 513 at 127), run every lanes-a-world choice (32, 16, 8), worlds a
block of 1, 2, 4, 8 and 16, and both lane copies (the TMA bulk copy and
per-lane ``cp.async``), in one launch too.
"""
import numpy as np
import pytest
import torch

from madsim_tpu_torch.bridge import cuda as bcuda
from madsim_tpu_torch.bridge import golden
from madsim_tpu_torch.bridge.kernel import BridgeKernel
from madsim_tpu_torch.bridge.synthetic import SyntheticStream, drive
from madsim_tpu_torch.engine.convert import bridge_state_to_numpy

SHAPES = [(w, cap) for w in (1, 7, 130, 512) for cap in (40, 128, 1024)]
SHAPES += [(1001, 128), (2049, 40), (4097, 128), (513, 127), (2051, 40),
           (3003, 128), (4101, 128)]


def need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: torch.cuda.is_available() is "
                    "False")


def assert_same_state(ck, gk, cap):
    a, b = bridge_state_to_numpy(ck), bridge_state_to_numpy(gk)
    for name in a:
        x, y = (a[name][:, :cap], b[name][:, :cap]) if name.startswith(
            "lane_") else (a[name], b[name])
        assert np.array_equal(x, y), name


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["realistic", "edge"])
def test_cuda_round_and_drain_match_plain(mode):
    need_cuda()
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
    assert_same_state(ck, gk, 64)


@pytest.mark.cuda
@pytest.mark.parametrize("w,cap", SHAPES)
def test_every_launch_shape_matches_plain(w, cap):
    """Both streams at each launch shape, every round's and drain's outputs
    and the state held to the plain version's."""
    need_cuda()
    seeds = np.arange(w)
    for mode, k in (("realistic", 4), ("edge", 2)):
        gk = BridgeKernel(seeds, cap=cap, k_events=k, device="cuda",
                          metrics=True)
        ck = BridgeKernel(seeds, cap=cap, k_events=k, device="cpu",
                          metrics=True)
        stream = SyntheticStream(seeds, cap=cap, mode=mode, seed=w + cap)
        for op, outs in drive(stream, [ck, gk], 8):
            if op != "reset":
                bad = golden.outputs_differ(outs[1], outs[0])
                assert not bad, f"{mode} {op}: {bad} differ"
        assert_same_state(ck, gk, cap)


@pytest.mark.cuda
def test_a_shape_past_the_shared_memory_budget_is_refused():
    """The entry points refuse a launch shape whose staged rows pass 48 KB
    (8 worlds at CAP = 1,024) or whose lanes a world are not 8, 16 or 32,
    and the wrapper raises on the code."""
    need_cuda()
    lib, stream = bcuda._lib(), torch.cuda.current_stream().cuda_stream
    for lanes, warps in ((32, 8), (12, 1), (32, 9)):
        status = lib.madsim_bridge_empty(64, 1024, lanes, warps, stream)
        assert status != 0, (lanes, warps)
        with pytest.raises(RuntimeError, match="launch failed"):
            bcuda._launch_status("empty", status)
    assert lib.madsim_bridge_empty(64, 1024, 32, 2, stream) == 0
    torch.cuda.synchronize()


def test_the_launch_shapes_cover_each_choice():
    """The shapes above give 32, 16 and 8 lanes a world, 1 to 16 worlds a
    block and both lane copies, W = 4,097 both in one launch, and a last
    block of an odd number of worlds (3 or more) whose full warps take the
    bulk copy."""
    shapes = [bcuda.launch_shape(w, cap) for w, cap in SHAPES]
    paths = {p for w, cap in SHAPES for p in bcuda.lane_copy_paths(w, cap)}
    assert {s[0] for s in shapes} == {8, 16, 32}
    assert {s[2] for s in shapes} == {1, 2, 4, 8, 16}
    assert paths == {"bulk", "async"}
    assert set(bcuda.lane_copy_paths(4097, 128)) == {"bulk", "async"}
    for w, cap in ((2051, 40), (3003, 128), (4101, 128)):
        lanes, _, per = bcuda.launch_shape(w, cap)
        last = w % per
        assert last >= 3 and last % 2 == 1 and (cap + 1) % 2 == 1
        warps = -(-last * lanes // 32)
        tail = bcuda.lane_copy_paths(w, cap)[-warps:]
        assert len(tail) == warps
        assert tail[0] == "bulk" and tail[-1] == "async", (w, tail)
