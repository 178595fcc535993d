"""The single push and ``EngineConfig(sequential_insert=True)`` in the port
against the JAX package on the CPU, bitwise (tolerance 0).

- ``queue.push`` against JAX's ``push`` on randomized queues (pre-filled
  and holey, full ones among them), with events at ``INF_TIME``, masked
  pushes and payloads beyond the packed lane's range, in both payload
  dtypes; and the chain of pushes against one ``push_many``;
- whole ``sequential_insert=True`` trajectories against the default flag
  and against JAX's sequential run, on the cases of
  tests/test_queue_insert.py:169-239 (Raft with kill/restart, overflow
  mid-batch, INF-saturated sends, every node paused, pb and tpc), at a
  reduced depth and width.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import madsim_tpu.engine as J
import madsim_tpu.engine.queue as jq
import madsim_tpu_torch.engine as T
import madsim_tpu_torch.engine.queue as tq
from madsim_tpu_torch.engine.convert import to_numpy
from madsim_tpu_torch.engine.core import tree_leaves, tree_paths

INF = tq.INF_TIME


def random_queues(rng, w, cap, p, dtype, full_share=0.2):
    """(W, Q) queues as numpy lanes: random fill with holes, some worlds
    full, payloads in the lane dtype."""
    time = rng.integers(0, 1_000, (w, cap)).astype(np.int32)
    holes = rng.random((w, cap)) < 0.4
    holes[rng.random(w) < full_share] = False
    time[holes] = INF
    meta = rng.integers(-2**31, 2**31 - 1, (w, cap), dtype=np.int64) \
        .astype(np.int32)
    info = np.iinfo(dtype)
    payload = rng.integers(info.min, info.max, (w, cap, p)).astype(dtype)
    return time, meta, payload


def random_events(rng, w, p):
    times = rng.integers(0, 500, w)
    times = np.where(rng.random(w) < 0.2, INF, times).astype(np.int32)
    return (times, rng.integers(0, 64, w).astype(np.int32),
            rng.integers(0, 4, w).astype(np.int32),
            rng.integers(0, 256, w).astype(np.int32),
            rng.integers(0, 256, w).astype(np.int32),
            rng.integers(0, 256, w).astype(np.int32),
            rng.integers(-70_000, 70_000, (w, p)).astype(np.int32))


@jax.jit
def _jax_push(time, meta, payload, ev, enable):
    def one(t, m, pl, e, en):
        q, ok = jq.push(jq.EventQueue(t, m, pl), jq.Event(*e), enable=en)
        return q.time, q.meta, q.payload, ok

    return jax.vmap(one)(time, meta, payload, ev, enable)


@pytest.mark.parametrize("dtype", [np.int16, np.int32])
def test_push_matches_jax_randomized(dtype):
    rng = np.random.default_rng(7)
    w, cap, p = 48, 12, 3
    time, meta, payload = random_queues(rng, w, cap, p, dtype)
    tqueue = tq.EventQueue(*(torch.from_numpy(x.copy())
                             for x in (time, meta, payload)))
    jt, jm, jp = (jnp.asarray(x) for x in (time, meta, payload))
    refused = 0
    for _ in range(10):
        ev = random_events(rng, w, p)
        enable = rng.random(w) < 0.8
        tqueue, t_ok = tq.push(tqueue, tq.Event(*(torch.from_numpy(x)
                                                  for x in ev)),
                               enable=torch.from_numpy(enable))
        jt, jm, jp, j_ok = _jax_push(jt, jm, jp, tuple(jnp.asarray(x)
                                                       for x in ev),
                                     jnp.asarray(enable))
        for a, b in zip(tqueue, (jt, jm, jp)):
            assert a.numpy().dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(t_ok.numpy(), np.asarray(j_ok))
        refused += int((~t_ok).sum())
    assert refused > 0, "no push met a full queue"
    # A Python bool mask and a masked-out push.
    same, ok = tq.push(tqueue, tq.Event(*(torch.from_numpy(x) for x in ev)),
                       enable=False)
    assert ok.all() and all(torch.equal(a, b) for a, b in zip(same, tqueue))


def test_push_chain_equals_push_many():
    rng = np.random.default_rng(11)
    for trial in range(8):
        w, cap, p, m = 32, int(rng.integers(2, 20)), 2, int(
            rng.integers(1, 9))
        lanes = random_queues(rng, w, cap, p, np.int16)
        q = tq.EventQueue(*(torch.from_numpy(x.copy()) for x in lanes))
        evs = [random_events(rng, w, p) for _ in range(m)]
        enable = rng.random((w, m)) < 0.8
        chain, oks = q, []
        for i, ev in enumerate(evs):
            chain, ok = tq.push(chain, tq.Event(*(torch.from_numpy(x)
                                                  for x in ev)),
                                enable=torch.from_numpy(enable[:, i]))
            oks.append(ok)
        batch = tq.Event(*(torch.from_numpy(np.stack(xs, axis=1))
                           for xs in zip(*evs)))
        fused, ok_f, n_ins = tq.push_many(q, batch, torch.from_numpy(enable))
        for a, b in zip(chain, fused):
            assert torch.equal(a, b), f"trial {trial}"
        assert torch.equal(torch.stack(oks, dim=1), ok_f), f"trial {trial}"
        assert torch.equal(tq.depth(fused) - tq.depth(q), n_ins)


# ---------------------------------------------------------------------------
# Whole trajectories: sequential_insert=True == the default == JAX's chain
# ---------------------------------------------------------------------------

def _cases():
    raft = dict(n_nodes=3, outbox_cap=4, queue_cap=64)
    return {
        "raft_faults": (
            "RaftActor", dict(n=3, n_proposals=2, buggy_double_vote=True),
            dict(raft, t_limit_us=2_500_000, stop_on_bug=False),
            np.array([[400_000, J.FAULT_KILL, 0, 0],
                      [900_000, J.FAULT_RESTART, 0, 0]], np.int32), 16, 250),
        "raft_overflow": (
            "RaftActor", dict(n=3, n_proposals=2),
            dict(raft, queue_cap=8, t_limit_us=2_000_000, stop_on_bug=False),
            None, 16, 150),
        "raft_inf_saturated": (
            "RaftActor", dict(n=3),
            dict(raft, t_limit_us=2**31 - 2, stop_on_bug=False),
            np.array([[0, J.FAULT_SET_LATENCY, 2_000_000_000,
                       2_147_483_646]], np.int32), 16, 100),
        "raft_pause_all": (
            "RaftActor", dict(n=3), dict(raft, t_limit_us=2_000_000),
            np.array([[0, J.FAULT_PAUSE, 0, 0], [0, J.FAULT_PAUSE, 1, 0],
                      [0, J.FAULT_PAUSE, 2, 0]], np.int32), 8, 40),
        "pb": ("PBActor", dict(n=3, n_writes=4),
               dict(raft, t_limit_us=1_500_000, loss_rate=0.05),
               None, 16, 150),
        "tpc": ("TPCActor", dict(n=4, n_txns=4, buggy_presumed_commit=True),
                dict(n_nodes=4, outbox_cap=5, queue_cap=64,
                     t_limit_us=1_500_000, loss_rate=0.1), None, 16, 100),
    }


CASES = _cases()


def _actor(pkg, name, kw):
    conf = {"RaftActor": "RaftDeviceConfig", "PBActor": "PBDeviceConfig",
            "TPCActor": "TPCDeviceConfig"}[name]
    return getattr(pkg, name)(getattr(pkg, conf)(**kw))


@pytest.mark.parametrize("case", sorted(CASES))
def test_sequential_insert_trajectories(case):
    name, akw, ckw, faults, w, steps = CASES[case]
    seeds = np.arange(w)
    seq_cfg = dict(ckw, sequential_insert=True)
    ts = T.DeviceEngine(_actor(T, name, akw), T.EngineConfig(**seq_cfg),
                        device="cpu")
    td = T.DeviceEngine(_actor(T, name, akw), T.EngineConfig(**ckw),
                        device="cpu")
    je = J.DeviceEngine(_actor(J, name, akw), J.EngineConfig(**seq_cfg))
    a = ts.run_steps(ts.init(seeds, faults=faults), steps)
    b = td.run_steps(td.init(seeds, faults=faults), steps)
    c = je.run_steps(je.init(seeds, faults=faults), steps)
    jl = [np.asarray(x) for x in jax.tree.leaves(c)]
    for path, x, y, z in zip(tree_paths(a), tree_leaves(a), tree_leaves(b),
                             jl):
        x, y = to_numpy(x), to_numpy(y)
        assert x.dtype == y.dtype == z.dtype, path
        np.testing.assert_array_equal(x, y, err_msg=f"{path} vs default")
        np.testing.assert_array_equal(x, z, err_msg=f"{path} vs JAX")
    obs = ts.observe(a)
    if case == "raft_overflow":
        assert obs["overflow"].any(), "no world overflowed"
    if case == "raft_pause_all":
        assert not obs["active"].any() and not obs["bug"].any()
        assert (obs["queue_depth"] > 0).all()
    # The config's repr carries the flag: a checkpoint never crosses it.
    assert dataclasses.replace(td.cfg, sequential_insert=True) == ts.cfg
