"""``crosscheck_backends`` and ``run_on`` of the port
(madsim_tpu_torch.engine.crosscheck) against the JAX package's on the CPU,
bitwise (tolerance 0): the CPU against the CPU (the sandbox has no GPU;
``chip_smoke.py`` runs CUDA against the CPU), the same summary as JAX's,
the final leaves of ``run_on`` equal to JAX's for the same seeds, and a
divergence reported with the leaf that differs.
"""
import jax
import numpy as np
import pytest

import madsim_tpu.engine as J
from madsim_tpu.engine import crosscheck as jcross
import madsim_tpu_torch.engine as T
from madsim_tpu_torch.engine import crosscheck as tcross
from madsim_tpu_torch.engine.core import tree_leaves, tree_paths

RK = dict(n=3, n_proposals=2, buggy_double_vote=True)
CK = dict(n_nodes=3, outbox_cap=4, queue_cap=64, t_limit_us=1_500_000)
FAULTS = np.array([[300_000, J.FAULT_KILL, 0, 0],
                   [700_000, J.FAULT_RESTART, 0, 0]], np.int32)
SEEDS = np.arange(16)
STEPS = 200


@pytest.fixture(scope="module")
def engines():
    return (J.DeviceEngine(J.RaftActor(J.RaftDeviceConfig(**RK)),
                           J.EngineConfig(**CK)),
            T.DeviceEngine(T.RaftActor(T.RaftDeviceConfig(**RK)),
                           T.EngineConfig(**CK), device="cpu"))


def test_crosscheck_cpu_against_cpu_matches_jax(engines):
    je, te = engines
    got = tcross.crosscheck_backends(te, SEEDS, faults=FAULTS,
                                     max_steps=STEPS)
    want = jcross.crosscheck_backends(je, SEEDS, faults=FAULTS,
                                      max_steps=STEPS)
    assert got == want
    assert got["n_leaves"] == len(te.state_layout())


def test_run_on_leaves_match_jax(engines):
    je, te = engines
    t_state = tcross.run_on(te, "cpu", SEEDS, faults=FAULTS,
                            max_steps=STEPS)
    j_state = jcross.run_on(je, jax.devices("cpu")[0], SEEDS, faults=FAULTS,
                            max_steps=STEPS)
    jl = jax.tree.leaves(j_state)
    assert len(tree_leaves(t_state)) == len(jl)
    for path, a, b in zip(tree_paths(t_state), tree_leaves(t_state), jl):
        assert isinstance(a, np.ndarray), path
        assert a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)


def test_crosscheck_names_the_diverged_leaf(engines, monkeypatch):
    """A twin whose run differs in one leaf fails the check, naming it."""
    _je, te = engines
    real = tcross._run
    calls = []

    def run(eng, device, seeds, faults, max_steps):
        twin, state = real(eng, device, seeds, faults, max_steps)
        calls.append(device)
        if len(calls) == 2:
            state.delivered[3] += 1
        return twin, state

    monkeypatch.setattr(tcross, "_run", run)
    with pytest.raises(AssertionError, match=r"delivered: 1 differing"):
        tcross.crosscheck_backends(te, SEEDS[:8], faults=FAULTS,
                                   max_steps=32)
