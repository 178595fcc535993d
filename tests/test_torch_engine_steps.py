"""The port's engine against the JAX package's on the longest trajectories,
bitwise on every WorldState leaf: the bug hunt with a kill/restart
schedule, ``run_steps`` mid-run and the Pallas kernel itself (interpret
mode), and a JAX-made state stepped by the port. The other engine cases are
in tests/test_torch_engine.py; the two files run in parallel workers.

Configurations are those of tests/test_queue_insert.py and
tests/test_pallas_step.py at small W. Tolerance: none — every operation is
integer, or an exactly rounded float32 product.
"""
import dataclasses

import jax
import numpy as np
import pytest

import madsim_tpu.engine as J
import madsim_tpu_torch.engine as T
from test_torch_engine import (BUG, KILL_RESTART, SEEDS,
                               assert_observe_equal, engines, mismatches)


def test_bug_hunt_with_kill_restart_matches_jax():
    """buggy_double_vote with a kill/restart schedule (the config of
    tests/test_pallas_step.py): bugs found, every leaf equal."""
    rk, ck = BUG
    je, te = engines(rk, ck)
    js = je.run(je.init(SEEDS, faults=KILL_RESTART), 2_000)
    ts = te.run(te.init(SEEDS, faults=KILL_RESTART), 2_000)
    assert not mismatches(js, ts)
    obs = assert_observe_equal(je, js, te, ts)
    assert obs["bug"].any() and not obs["active"].any()


def test_run_steps_mid_run_and_the_pallas_kernel_in_interpret_mode():
    """run_steps 3 x 150 against the lax step; the first 150 also against
    the Pallas kernel itself (EngineConfig(pallas=True), interpret mode on
    the CPU) — so the port is held to the TPU kernel, not only its body."""
    rk, ck = BUG
    je, te = engines(rk, ck)
    jp = J.DeviceEngine(J.RaftActor(J.RaftDeviceConfig(**rk)),
                        J.EngineConfig(**ck, pallas=True))
    js, ts = je.init(SEEDS), te.init(SEEDS)
    jps = jp.run_steps(jp.init(SEEDS), 150)
    for chunk in range(3):
        js = je.run_steps(js, 150)
        ts = te.run_steps(ts, 150)
        assert not mismatches(js, ts), f"chunk {chunk}"
        if chunk == 0:
            assert not mismatches(jps, ts), "port vs the Pallas kernel"


def test_state_crosses_packages_both_ways():
    """A JAX-made state stepped in the port: the INF-saturated-latency run
    (sends near 2^31 µs saturate and drop) starts from JAX's init, is run
    by the port, and equals the JAX run; state_to_numpy inverts
    state_from_numpy."""
    rk = dict(n=3)
    ck = dict(n_nodes=3, outbox_cap=4, queue_cap=64, t_limit_us=2**31 - 2,
              stop_on_bug=False)
    slow = np.array([[0, J.FAULT_SET_LATENCY, 2_000_000_000, 2_147_483_646]],
                    np.int32)
    je, te = engines(rk, ck)
    j0 = je.init(SEEDS, faults=slow)
    leaves = [np.asarray(x) for x in jax.tree.leaves(j0)]
    ts = T.state_from_numpy(leaves, te.cfg, te.actor, "cpu")
    for a, b in zip(T.state_to_numpy(ts), leaves):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    js = je.run(j0, 2_000)
    ts = te.run(ts, 2_000)
    assert not mismatches(js, ts)
    obs = te.observe(ts)
    assert (obs["now_us"] > 2_000_000_000).all() and obs["overflow"].any()
    with pytest.raises(ValueError, match="leaves"):
        T.state_from_numpy(leaves[:-1], te.cfg, te.actor, "cpu")
    with pytest.raises(ValueError, match="queue"):
        T.state_from_numpy(leaves, dataclasses.replace(te.cfg, queue_cap=8),
                           te.actor, "cpu")
