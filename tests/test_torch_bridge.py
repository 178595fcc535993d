"""The bridge decision kernel of the port against JAX's, on the CPU.

``madsim_tpu_torch.bridge.BridgeKernel`` (the plain round and drain here;
one CUDA launch each on the card) must produce exactly what
``madsim_tpu.bridge.kernel.BridgeKernel`` produces, with tolerance 0: every
StepOut and DrainOut field, the clock, the lanes ``[:, :cap]`` (the dump
column's content is unspecified on both sides) and the metrics. Inputs:
the synthetic closed-loop streams in both modes, the two recorded JAX
sweeps, a mid-stream JAX state carried across with the converters, and a
batch of u64 extremes. The JAX-derived goldens and recordings are
recomputed from JAX.
"""
import os

import numpy as np
import pytest
import torch

import madsim_tpu as ms
from madsim_tpu import time as vtime
from madsim_tpu.bridge import kernel as jkernel
from madsim_tpu.bridge import runtime as jruntime
from madsim_tpu.net import Endpoint, NetSim, rpc
from madsim_tpu.obs.coverage import coverage_of_counters as j_coverage
from madsim_tpu_torch.bridge import cuda as bcuda
from madsim_tpu_torch.bridge import golden
from madsim_tpu_torch.bridge import kernel as tkernel
from madsim_tpu_torch.bridge.synthetic import SyntheticStream, drive
from madsim_tpu_torch.engine.convert import (bridge_state_from_numpy,
                                             bridge_state_to_numpy)
from madsim_tpu_torch.obs import coverage_of_counters as t_coverage

W = 48
ROUNDS = 24


def jax_kernel(seeds, **kw):
    return jkernel.BridgeKernel(seeds, device="cpu", **kw)


def port_kernel(seeds, **kw):
    return tkernel.BridgeKernel(seeds, device="cpu", **kw)


def assert_outputs_equal(got, want, where=""):
    bad = golden.outputs_differ(got, want)
    assert not bad, f"{where}: {bad} differ"


def assert_state_equal(jk, tk, where=""):
    ja, ta = bridge_state_to_numpy(jk), bridge_state_to_numpy(tk)
    cap = tk.cap
    assert sorted(ja) == sorted(ta)
    for name in ja:
        a, b = ja[name], ta[name]
        if name.startswith("lane_"):
            a, b = a[:, :cap], b[:, :cap]
        assert np.array_equal(a, b), f"{where}: {name} differs"


def run_lockstep(jk, tk, stream, rounds):
    counts = {"step": 0, "drain": 0, "reset": 0}
    for op, outs in drive(stream, [jk, tk], rounds):
        counts[op] += 1
        if op != "reset":
            assert_outputs_equal(outs[1], outs[0], f"{op} {counts[op]}")
    assert_state_equal(jk, tk, "end")
    return counts


# ---------------------------------------------------------------------------
# (a) Kernel level.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("metrics", [False, True], ids=["off", "on"])
@pytest.mark.parametrize("cap,k_events", [(16, 1), (16, 4), (128, 1),
                                          (128, 4)])
@pytest.mark.parametrize("mode", ["realistic", "edge"])
def test_synthetic_stream_matches_jax(mode, cap, k_events, metrics):
    seeds = np.arange(W)
    jk = jax_kernel(seeds, cap=cap, k_events=k_events, metrics=metrics)
    tk = port_kernel(seeds, cap=cap, k_events=k_events, metrics=metrics)
    stream = SyntheticStream(seeds, cap=cap, mode=mode, seed=cap + k_events)
    counts = run_lockstep(jk, tk, stream, ROUNDS)
    assert counts["step"] == ROUNDS
    if mode == "edge":
        assert counts["reset"] > 0 and counts["drain"] > 0


def test_metrics_are_invisible_and_count():
    seeds = np.arange(W)
    on = port_kernel(seeds, cap=64, k_events=2, metrics=True)
    off = port_kernel(seeds, cap=64, k_events=2)
    stream = SyntheticStream(seeds, cap=64, mode="edge", seed=5)
    fired = 0
    for op, outs in drive(stream, [off, on], 30):
        if op != "reset":
            assert_outputs_equal(outs[1], outs[0], op)
            fired += int(outs[0].event_valid.sum())
    assert off.metrics() is None
    m = on.metrics()
    assert int(m["events_fired"].sum()) == fired
    assert int(m["msgs_lost"].sum()) > 0 and int(m["cancels"].sum()) > 0


def test_extreme_batch_matches_jax():
    """One round of u64 and wrap extremes: counters at 2^32 - 1 and
    2^64 - 1, thresholds at and above 2^63, latency widths past 2^31,
    2^62 and 2^63 (a negative int64 width is a u64 past 2^63 to JAX),
    delivery sums that wrap, deadlines within 50 ns of INF_NS, a slot
    cancelled and reused, a slot written by a timer and a send."""
    w, t, c, s = 8, 2, 2, 6
    seeds = np.arange(w) * 7919
    rng = np.random.default_rng(0)
    inf, tmax = tkernel.INF_NS, tkernel.TIMER_MAX_NS
    b = jkernel.HostBatch(
        t_slot=np.tile(np.array([[0, 1]], np.int32), (w, 1)),
        t_dl=np.tile(np.array([[inf - 10, tmax + 5]], np.int64), (w, 1)),
        t_seq=np.tile(np.array([[1, 2]], np.int64), (w, 1)),
        t_mask=np.tile(np.array([[True, True]]), (w, 1)),
        c_slot=np.tile(np.array([[0, 5]], np.int32), (w, 1)),
        c_mask=np.tile(np.array([[True, False]]), (w, 1)),
        s_ctr=np.tile(np.array([[2**32 - 1, 2**64 - 1, 2**64 - 2, 0, 5,
                                 2**63]], np.uint64), (w, 1)),
        s_base=np.tile(np.array([[inf - 3, 10, -5, tmax, 0, inf]],
                                np.int64), (w, 1)),
        s_slot=np.tile(np.array([[1, 2, 3, 4, 5, 6]], np.int32), (w, 1)),
        s_seq=np.tile(np.array([[3, 4, 5, 6, 7, 8]], np.int64), (w, 1)),
        s_thr=np.tile(np.array([[2**63, 2**64 - 1, 0, 2**63 + 1, 1, 0]],
                               np.uint64), (w, 1)),
        s_lossall=np.zeros((w, s), bool),
        s_lat_lo=np.tile(np.array([[0, inf, 7, -9, 2**40, 1]], np.int64),
                         (w, 1)),
        s_lat_w=np.tile(np.array([[2**31 + 1, 2**62 + 3, -1, -(2**62),
                                   2**40, 1]], np.int64), (w, 1)),
        s_mask=np.ones((w, s), bool),
        s_live=np.ones((w, s), bool),
        clock=rng.integers(0, 1000, size=w).astype(np.int64),
        advance=np.array([True, False] * (w // 2)))
    for metrics in (False, True):
        jk = jax_kernel(seeds, cap=8, k_events=3, metrics=metrics)
        tk = port_kernel(seeds, cap=8, k_events=3, metrics=metrics)
        for r in range(3):
            assert_outputs_equal(tk.step(b), jk.step(b), f"step {r}")
            assert_outputs_equal(tk.drain(), jax_out(jk.drain()),
                                 f"drain {r}")
            assert_state_equal(jk, tk, f"round {r}")


def jax_out(out):
    return type(out)(*[np.asarray(x) for x in out])


@pytest.mark.parametrize("name", sorted(golden.RECORDINGS))
def test_recorded_stream_replays(name):
    """The port replays a recorded JAX sweep to JAX's outputs at its full
    width; JAX's own kernel and the port replay its first W worlds (the
    worlds are independent, so the rows of a round are a round) alike."""
    rec = golden.load_recording(name)
    seeds, kw = golden.recording_kernel_args(rec)
    tk = port_kernel(seeds, **kw)
    n = 0
    for i, op, got, want in golden.replay(rec, tk):
        assert_outputs_equal(got, want, f"{name} op {i} ({op})")
        n += op == "drain"
    assert (n > 0) == (name == "drains")
    cap = kw["cap"]
    for f in ("clock", "lane_dl", "lane_seq"):
        have = golden.to_host(getattr(tk.state, f))
        have = have if f == "clock" else have[:, :cap]
        assert np.array_equal(have, rec[f"final.{f}"]), f

    rows = tuple(f".{f}" for f in jkernel.HostBatch._fields
                 + jkernel.StepOut._fields)
    sub = {k: (v[:W] if k.endswith(rows) else v) for k, v in rec.items()}
    sub["seeds"] = rec["seeds"][:W]
    jk, tk = jax_kernel(sub["seeds"], **kw), port_kernel(sub["seeds"], **kw)
    for (i, op, jgot, want), (_, _, tgot, _) in zip(
            golden.replay(sub, jk), golden.replay(sub, tk)):
        assert_outputs_equal(jgot, want, f"{name} JAX op {i}")
        assert_outputs_equal(tgot, jgot, f"{name} port op {i}")
    assert_state_equal(jk, tk, name)


@pytest.mark.parametrize("metrics", [False, True], ids=["off", "on"])
def test_mid_stream_state_carried_across(metrics):
    """A JAX kernel runs half an edge stream; its state, NET keys and
    metrics cross to a fresh port kernel (and back to a fresh JAX one);
    all three then run the rest in lockstep."""
    import jax.numpy as jnp

    seeds = np.arange(W)
    kw = dict(cap=32, k_events=2, metrics=metrics)
    jk = jax_kernel(seeds, **kw)
    stream = SyntheticStream(seeds, cap=32, mode="edge", seed=21)
    for _ in drive(stream, [jk], 12):
        pass
    arrays = bridge_state_to_numpy(jk)
    assert arrays["net_k0"].dtype == np.uint32
    # Other seeds: every array must come from the JAX kernel.
    tk = port_kernel(seeds + 1000, **kw)
    bridge_state_from_numpy(tk, arrays)
    back = bridge_state_to_numpy(tk)
    for name in arrays:
        assert back[name].dtype == arrays[name].dtype
        assert np.array_equal(back[name], arrays[name]), name
    jk2 = jax_kernel(seeds + 2000, **kw)
    with jk2._enable_x64():
        jk2.state = jkernel.BridgeState(
            *[jnp.asarray(back[n]) for n in ("clock", "lane_dl",
                                             "lane_seq")])
        jk2._net_k0 = jnp.asarray(back["net_k0"])
        jk2._net_k1 = jnp.asarray(back["net_k1"])
        if metrics:
            jk2._mb = jkernel.BridgeMetrics(
                *[jnp.asarray(back[n]) for n in jkernel.BridgeMetrics._fields])
    for op, outs in drive(stream, [jk, tk, jk2], 12):
        if op != "reset":
            assert_outputs_equal(outs[1], outs[0], op)
            assert_outputs_equal(outs[2], outs[0], op)
    assert_state_equal(jk, tk, "end")
    assert_state_equal(jk2, tk, "end (back)")
    with pytest.raises(ValueError):
        bridge_state_from_numpy(port_kernel(seeds[:3], **kw), arrays)


def test_limb_arithmetic_matches_python_ints():
    rng = np.random.default_rng(1)
    edges = [0, 1, 2**31 - 1, 2**31, 2**32 - 1, 2**32, 2**62 - 1, 2**62,
             2**63 - 1, 2**63, 2**63 + 1, 2**64 - 2, 2**64 - 1]
    u = edges + [int(x) for x in rng.integers(0, 2**64, 200,
                                              dtype=np.uint64)]
    v = edges[1:] + [int(x) for x in rng.integers(1, 2**64, 200,
                                                  dtype=np.uint64)]
    uu = np.array([a for a in u for _ in v], np.uint64)
    vv = np.array([b for _ in u for b in v], np.uint64)
    ut = torch.from_numpy(uu.view(np.int64))
    vt = torch.from_numpy(vv.view(np.int64))
    uh, ul = tkernel._limbs(ut)
    got = tkernel._u64_mod(uh, ul, vt).numpy().view(np.uint64)
    assert np.array_equal(got, uu % vv)
    with np.errstate(over="ignore"):
        assert np.array_equal(tkernel._add_wrap(ut, vt).numpy(),
                              (uu + vv).view(np.int64))
        assert np.array_equal(tkernel._sub_wrap(ut, vt).numpy(),
                              (uu - vv).view(np.int64))
    assert np.array_equal(tkernel._join(uh, ul).numpy(), uu.view(np.int64))


def test_no_cuda_no_device_raises(monkeypatch):
    monkeypatch.delenv("MADSIM_BRIDGE_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tkernel.BridgeKernel(np.arange(4))
    monkeypatch.setenv("MADSIM_BRIDGE_DEVICE", "cpu")
    assert tkernel.BridgeKernel(np.arange(4)).device.type == "cpu"
    with pytest.raises(ValueError):
        port_kernel(np.arange(4), k_events=0)


def test_port_exports_and_types_mirror_jax():
    import madsim_tpu_torch.bridge as tb

    assert tb.__all__ == ["BridgeKernel", "HostBatch", "StepOut"]
    for name in ("BridgeState", "BridgeMetrics", "StepOut", "HostBatch",
                 "DrainOut"):
        assert getattr(tkernel, name)._fields == \
            getattr(jkernel, name)._fields, name
    for name in ("INF_NS", "_EPSILON_NS"):
        assert getattr(tkernel, name) == getattr(jkernel, name)
    from madsim_tpu.core.rng import STREAM_NET
    from madsim_tpu.core.timewheel import TIMER_MAX_NS
    assert tkernel.STREAM_NET == STREAM_NET
    assert tkernel.TIMER_MAX_NS == TIMER_MAX_NS
    for n in (0, 1, 3, 4, 5, 17, 64, 65):
        assert tkernel.bucket(n) == jkernel.bucket(n)
        assert tkernel.bucket(n, 1) == jkernel.bucket(n, 1)


def test_reset_slots_match_jax():
    seeds = np.arange(16)
    jk = jax_kernel(seeds, cap=16, k_events=2, metrics=True)
    tk = port_kernel(seeds, cap=16, k_events=2, metrics=True)
    stream = SyntheticStream(seeds, cap=16, mode="realistic", seed=2)
    for _ in drive(stream, [jk, tk], 6):
        pass
    for k in (jk, tk):
        k.reset_slot(3, 2**40 + 7)
        k.reset_slots([(5, 99), (0, 2**64 - 1), (11, 12)])
        k.reset_slots([])
        k.reset_slots([(7, 8)])
    assert_state_equal(jk, tk, "after resets")
    run_lockstep(jk, tk, stream, 6)


def test_staging_layout_round_trips_a_batch():
    """The CUDA wrapper's staging (offsets, views, casts) on the CPU: a
    batch packed into one buffer reads back field for field."""
    stream = SyntheticStream(np.arange(6), cap=32, mode="edge", seed=3)
    b = stream.batch()
    t, c, s = bcuda._batch_widths(b, 6)
    assert (t, c, s) == (8, 4, 8)
    fields = [(dt, np.shape(x)) for dt, x in zip(tkernel.BATCH_DTYPES, b)]
    offs, n = bcuda._layout(fields)
    assert all(o % 8 == 0 for o in offs)
    buf = np.zeros(n, np.uint8)
    views = bcuda._views(buf, fields, offs)
    for v, x in zip(views, b):
        np.copyto(v, x, casting="unsafe")
    for v, x in zip(bcuda._views(buf, fields, offs), b):
        assert np.array_equal(v, x)
    bad = b._replace(s_seq=b.s_seq[:, :3])
    with pytest.raises(ValueError, match="s_seq"):
        bcuda._batch_widths(bad, 6)


def test_lazy_drain_field_waits_for_its_copy():
    class Event:
        waited = 0

        def synchronize(self):
            Event.waited += 1

    a = np.arange(6, dtype=np.int64).reshape(2, 3)
    lazy = bcuda.LazyArray(a, Event())
    assert Event.waited == 0
    assert np.asarray(lazy) is a and Event.waited == 1
    assert np.asarray(lazy, dtype=np.int32).dtype == np.int32
    got = np.array(lazy, copy=True)
    assert got is not a and np.array_equal(got, a)


def test_coverage_of_counters_matches_jax():
    rng = np.random.default_rng(4)
    for w in (1, 7, 64):
        counters = {k: rng.integers(0, 2**40, size=w) * (rng.random(w) < .7)
                    for k in tkernel.BridgeMetrics._fields}
        counters["huge"] = np.full(w, 2**63 - 1, np.int64)
        assert t_coverage(counters) == j_coverage(counters)
        assert t_coverage(counters, 16) == j_coverage(counters, 16)
    assert t_coverage({}) == j_coverage({})


# ---------------------------------------------------------------------------
# (c) The JAX-derived goldens and recordings, recomputed from JAX.
# ---------------------------------------------------------------------------

def synthetic_cases(widths):
    return [(m, w, on) for m in ("realistic", "edge") for w in widths
            for on in (False, True)]


@pytest.mark.parametrize("mode,w,metrics", synthetic_cases((512, 4096)))
def test_golden_bridge_from_jax(mode, w, metrics):
    kw = dict(cap=golden.SYNTHETIC["cap"],
              k_events=golden.SYNTHETIC["k_events"], metrics=metrics)
    key = golden.golden_key(mode, w, metrics)
    assert sorted(golden.GOLDEN_BRIDGE) == sorted(
        golden.golden_key(*c) for c in synthetic_cases(
            golden.SYNTHETIC["widths"]))
    jd = golden.synthetic_digest(jax_kernel(np.arange(w), **kw), mode)
    assert jd == golden.GOLDEN_BRIDGE[key], key
    if w <= 512:  # the port at W=4096: chip_smoke.py, on the CPU and CUDA
        assert golden.synthetic_digest(port_kernel(np.arange(w), **kw),
                                       mode) == jd


# -- the recorded sweeps ------------------------------------------------------

class Ping:
    __slots__ = ("n",)

    def __init__(self, n):
        self.n = n


async def _await(f):
    return await f


def pingpong_world(rounds=8, timeout=0.3, payload=b"x" * 32):
    """tests/test_bridge.py's RPC ping-pong world (bench config 1)."""
    async def world():
        h = ms.Handle.current()

        async def server_init():
            ep = await Endpoint.bind("10.0.0.1:9000")

            async def handle(req, data):
                return Ping(req.n + 1), data

            rpc.add_rpc_handler_with_data(ep, Ping, handle)
            await vtime.sleep(1e6)

        h.create_node(name="server", ip="10.0.0.1", init=server_init)
        client = h.create_node(name="client", ip="10.0.0.2")
        done = ms.sync.SimFuture()

        async def client_body():
            ep = await Endpoint.bind("10.0.0.2:0")
            got = 0
            for i in range(rounds):
                while True:
                    try:
                        r, _ = await rpc.call_with_data(
                            ep, "10.0.0.1:9000", Ping(i), payload,
                            timeout=timeout)
                        got += r.n
                        break
                    except TimeoutError:
                        pass
            done.set_result(got)

        client.spawn(client_body())
        return await vtime.timeout(600, _await(done))

    return world


def chaos_world():
    """tests/test_bridge.py's chaos world: loss, a partition, a restart."""
    async def world():
        h = ms.Handle.current()

        async def server_init():
            ep = await Endpoint.bind("10.0.0.1:9000")

            async def handle(req):
                return req.n * 2

            rpc.add_rpc_handler(ep, Ping, handle)
            await vtime.sleep(1e6)

        server = h.create_node(name="server", ip="10.0.0.1",
                               init=server_init)
        client = h.create_node(name="client", ip="10.0.0.2")
        done = ms.sync.SimFuture()

        async def client_body():
            ep = await Endpoint.bind("10.0.0.2:0")
            got = 0
            for i in range(10):
                while True:
                    try:
                        got += await rpc.call(ep, "10.0.0.1:9000", Ping(i),
                                              timeout=0.3)
                        break
                    except TimeoutError:
                        pass
            done.set_result(got)

        client.spawn(client_body())

        async def chaos():
            sim = ms.simulator(NetSim)
            for k in range(3):
                await vtime.sleep(0.5)
                if k % 2 == 0:
                    sim.disconnect2(server.id, client.id)
                    await vtime.sleep(0.2)
                    sim.connect2(server.id, client.id)
                else:
                    h.restart(server.id)

        ms.task.spawn(chaos())
        return await vtime.timeout(600, _await(done))

    return world


def drain_world():
    """tests/test_bridge.py's drain world: 11 sleepers, most on one
    deadline, a cluster wider than k_events."""
    async def world():
        order = []

        async def sleeper(i):
            await vtime.sleep(0.5 if i % 3 else 0.5 + 0.001 * i)
            order.append(i)

        for i in range(11):
            ms.task.spawn(sleeper(i))
        await vtime.sleep(2.0)
        return tuple(order)

    return world


def chaos_config():
    c = ms.Config()
    c.net.packet_loss_rate = 0.08
    return c


#: How each recording is swept: world, sweep keywords.
RECORDED_SWEEPS = {
    "pingpong": (pingpong_world, {}),
    "chaos": (chaos_world, dict(config_fn=chaos_config, k_events=1)),
    "drains": (drain_world, dict(k_events=2)),
}


class Recorder:
    """JAX's BridgeKernel, recording every operation the driver makes on
    it, with JAX's outputs."""

    made = []

    def __init__(self, seeds, **kw):
        self.kernel = jax_kernel(seeds, **{k: v for k, v in kw.items()
                                           if k != "device"})
        self.seeds = np.asarray(seeds, np.int64)
        self.kw = kw
        self.ops = []
        Recorder.made.append(self)

    def reset_slot(self, slot, seed):
        self.ops.append(("reset", [(int(slot), int(seed))]))
        self.kernel.reset_slot(slot, seed)

    def reset_slots(self, pairs):
        if pairs:
            self.ops.append(("reset", [(int(s), int(x)) for s, x in pairs]))
        self.kernel.reset_slots(pairs)

    def step(self, batch, out=None):
        copied = jkernel.HostBatch(*[np.array(x, copy=True) for x in batch])
        res = self.kernel.step(batch, out=out)
        self.ops.append(("step", copied, res))
        return res

    def drain(self):
        res = jax_out(self.kernel.drain())
        self.ops.append(("drain", res))
        return res

    def metrics(self):
        return self.kernel.metrics()

    @property
    def state(self):
        return self.kernel.state


def clear_padding(batch):
    """``batch`` with every value behind a false mask set to 0 (a latency
    width to 1). No output reads those values, and the host driver leaves
    whatever an earlier round or sweep wrote there."""
    out = {}
    for name in tkernel.HostBatch._fields:
        x = np.array(getattr(batch, name), copy=True)
        group = name[0] if name[1] == "_" else None
        if group is not None and not name.endswith("_mask"):
            x[~np.asarray(getattr(batch, f"{group}_mask"), bool)] = \
                1 if name == "s_lat_w" else 0
        out[name] = x
    return tkernel.HostBatch(**out)


def write_recording(path, seeds, cap, k_events, ops, kernel):
    """Writes a recorded stream in the layout of
    ``golden.load_recording``: ``ops`` a list of ``("step", HostBatch,
    StepOut)``, ``("drain", DrainOut)`` and ``("reset", pairs)``, in the
    order they were made (each batch is written through
    :func:`clear_padding`); ``kernel`` the recorded kernel after the
    last."""
    arrays = {"seeds": np.asarray(seeds, np.int64),
              "cap": np.asarray(cap, np.int64),
              "k_events": np.asarray(k_events, np.int64),
              "ops": np.asarray([golden.OPS.index(o[0]) for o in ops],
                                np.int8)}
    for i, op in enumerate(ops):
        if op[0] == "reset":
            arrays[f"{i}.r"] = np.asarray(op[1], np.int64).reshape(-1, 2)
            continue
        if op[0] == "step":
            for name, x in zip(tkernel.HostBatch._fields,
                               clear_padding(op[1])):
                arrays[f"{i}.b.{name}"] = x
        out = op[-1]
        for name in out._fields:
            arrays[f"{i}.o.{name}"] = np.asarray(getattr(out, name),
                                                 golden.OUT_DTYPES[name])
    st = kernel.state
    arrays["final.clock"] = golden.to_host(st.clock)
    arrays["final.lane_dl"] = golden.to_host(st.lane_dl)[:, :cap]
    arrays["final.lane_seq"] = golden.to_host(st.lane_seq)[:, :cap]
    np.savez_compressed(path, **arrays)


def record_sweep(name, path):
    """Runs JAX's ``bridge.sweep`` of recording ``name`` over seeds
    0..511 with a recording kernel and writes the recording to
    ``path``."""
    world_fn, kw = RECORDED_SWEEPS[name]
    kw = dict(kw)
    cfg = kw.pop("config_fn", None)
    saved = jruntime.BridgeKernel
    Recorder.made.clear()
    jruntime.BridgeKernel = Recorder
    try:
        outs = jruntime.sweep(world_fn(), list(range(512)),
                              config=cfg() if cfg else None, **kw)
    finally:
        jruntime.BridgeKernel = saved
    assert all(o.error is None for o in outs)
    (rec,) = Recorder.made
    write_recording(path, rec.seeds, rec.kernel.cap,
                           rec.kernel.k_events, rec.ops, rec.kernel)


@pytest.mark.parametrize("name", sorted(golden.RECORDINGS))
def test_recordings_rerecorded_from_jax(name, tmp_path):
    path = tmp_path / "rec.npz"
    record_sweep(name, path)
    with np.load(path) as f:
        fresh = {k: f[k] for k in f.files}
    rec = golden.load_recording(name)
    assert sorted(fresh) == sorted(rec)
    for k in rec:
        assert np.array_equal(fresh[k], rec[k]), k
    assert os.path.getsize(golden.DATA / golden.RECORDINGS[name][0]) < 2**20
