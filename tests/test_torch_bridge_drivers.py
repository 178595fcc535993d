"""JAX's bridge drivers over the port's kernel, on the CPU.

The drivers that run user task bodies (``madsim_tpu/bridge/runtime.py``
and ``bridge/pool.py``) belong to the host runtime and stay outside the
port. Here a test-side adapter over ``madsim_tpu_torch.bridge.BridgeKernel``
(on the CPU) stands in for JAX's kernel in both modules, and copies of
``tests/test_bridge.py``'s worlds run under each: per-seed outcomes,
``sweep_traced`` poll traces, ``sweep_profiled``'s ``sim_metrics`` and
``coverage`` must equal those under JAX's own kernel, serial, recycled
(``batch=``) and through ``sweep_pooled`` (``jobs=2``, forked with torch
loaded in the parent; the workers never touch torch).
"""
import numpy as np
import pytest

import madsim_tpu as ms
from madsim_tpu import time as vtime
from madsim_tpu.bridge import pool as jpool
from madsim_tpu.bridge import runtime as jruntime
from madsim_tpu.obs.coverage import coverage_of_counters as j_coverage
from madsim_tpu_torch.bridge import kernel as tkernel
from madsim_tpu_torch.obs import coverage_of_counters as t_coverage

from test_torch_bridge import (_await, chaos_config, chaos_world,
                               drain_world, pingpong_world)


class PortKernel(tkernel.BridgeKernel):
    """The port's kernel under JAX's constructor signature, on the CPU."""

    made = 0

    def __init__(self, seeds, *, cap=128, k_events=4, device=None,
                 metrics=False):
        PortKernel.made += 1
        super().__init__(seeds, cap=cap, k_events=k_events, device="cpu",
                         metrics=metrics)


@pytest.fixture
def port(monkeypatch):
    """Runs a driver call under the port's kernel."""
    def run(fn, *args, **kw):
        with monkeypatch.context() as m:
            m.setattr(jruntime, "BridgeKernel", PortKernel)
            m.setattr(jpool, "BridgeKernel", PortKernel)
            before = PortKernel.made
            out = fn(*args, **kw)
            assert PortKernel.made > before, "the port's kernel was not used"
            return out
    return run


def same_outcomes(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.seed == y.seed
        assert x.value == y.value, (x.seed, x.value, y.value)
        assert type(x.error) is type(y.error), (x.seed, x.error, y.error)
        assert str(x.error) == str(y.error)


def check_traced(port, world_fn, seeds, **kw):
    want = jruntime.sweep_traced(world_fn, seeds, **kw)
    got = port(jruntime.sweep_traced, world_fn, seeds, **kw)
    same_outcomes(got[0], want[0])
    assert got[1] == want[1]
    return got


def sleep_world():
    async def world():
        t0 = vtime.monotonic()
        await vtime.sleep(0.5)
        await vtime.sleep(0.25)
        return round(vtime.monotonic() - t0, 9)

    return world


def test_sleep_and_pingpong(port):
    check_traced(port, sleep_world(), list(range(6)))
    outs, _ = check_traced(port, pingpong_world(), list(range(6)))
    assert all(o.error is None for o in outs)


def test_chaos(port):
    check_traced(port, chaos_world(), list(range(4)), config=chaos_config())


def test_config_grid(port):
    seeds, cfgs = [], []
    for s in range(3):
        for p in (0.0, 0.15):
            c = ms.Config()
            c.net.packet_loss_rate = p
            seeds.append(s)
            cfgs.append(c)
    _, traces = check_traced(port, pingpong_world(rounds=5), seeds,
                             configs=cfgs)
    assert any(traces[2 * i] != traces[2 * i + 1] for i in range(3))


@pytest.mark.parametrize("k_events", [1, 2])
def test_drain_rounds(port, k_events):
    check_traced(port, drain_world(), list(range(3)), k_events=k_events)
    check_traced(port, chaos_world(), list(range(3)), config=chaos_config(),
                 k_events=k_events)


@pytest.mark.parametrize("batch", [2, 3])
def test_recycled_slots(port, batch):
    check_traced(port, pingpong_world(rounds=4), list(range(6)),
                 batch=batch)

    async def world(seed):
        await vtime.sleep(0.1)
        if seed % 2:
            raise ValueError(f"boom {seed}")
        return seed * 10

    want = jruntime.sweep(world, list(range(9)), batch=batch)
    same_outcomes(port(jruntime.sweep, world, list(range(9)), batch=batch),
                  want)


def test_deadlock_time_limit_and_capacity(port):
    async def deadlocked():
        await _await(ms.sync.SimFuture())

    async def forever():
        while True:
            await vtime.sleep(1.0)

    async def many_sleepers():
        async def sleeper():
            await vtime.sleep(1.0)

        for _ in range(40):
            ms.task.spawn(sleeper())
        await vtime.sleep(2.0)

    for fn, kw in ((deadlocked, {}), (forever, dict(time_limit=5.0)),
                   (many_sleepers, dict(cap=8))):
        want = jruntime.sweep(fn, [1, 2], **kw)
        same_outcomes(port(jruntime.sweep, fn, [1, 2], **kw), want)


@pytest.mark.parametrize("batch", [None, 3])
def test_profiled_metrics_and_coverage(port, batch):
    """``sweep_profiled`` runs the kernel with its metrics block: the
    fleet aggregate and the per-slot coverage equal JAX's, and so do the
    traces (the block is invisible to them)."""
    seeds = list(range(8))
    kw = dict(config=chaos_config(), trace=True, k_events=1, batch=batch)
    want = jruntime.sweep_profiled(chaos_world(), seeds, **kw)
    got = port(jruntime.sweep_profiled, chaos_world(), seeds, **kw)
    same_outcomes(got[0], want[0])
    for key in ("sim_metrics", "coverage", "rounds", "drain_rounds",
                "events", "sends", "timers"):
        assert got[1][key] == want[1][key], key
    assert got[1]["sim_metrics"]["msgs_lost"] > 0
    traced = port(jruntime.sweep_traced, chaos_world(), seeds,
                  config=chaos_config(), k_events=1, batch=batch)
    same_outcomes(traced[0], want[0])


def test_sweep_pooled_jobs_2(port):
    """Two forked workers behind the port's kernel in the parent, with
    torch loaded there: outcomes and traces equal JAX's serial sweep's."""
    seeds = list(range(6))
    want = jruntime.sweep_traced(pingpong_world(rounds=4), seeds)
    for batch in (None, 3):
        got = port(jpool.sweep_pooled, pingpong_world(rounds=4), seeds,
                   jobs=2, trace=True, batch=batch)
        same_outcomes(got[0], want[0])
        assert got[1] == want[1]
    outs = port(jruntime.sweep, chaos_world(), list(range(4)), jobs=2,
                config=chaos_config(), k_events=1)
    same_outcomes(outs, jruntime.sweep(chaos_world(), list(range(4)),
                                       config=chaos_config(), k_events=1))


def test_coverage_of_counters_on_kernel_metrics():
    seeds = np.arange(12)
    k = tkernel.BridgeKernel(seeds, cap=16, k_events=2, device="cpu",
                             metrics=True)
    from madsim_tpu_torch.bridge.synthetic import SyntheticStream, drive

    for _ in drive(SyntheticStream(seeds, cap=16, mode="edge", seed=1), [k],
                   10):
        pass
    mb = k.metrics()
    assert t_coverage(mb) == j_coverage(mb)
    assert t_coverage(mb)["worlds_folded"] == 12
