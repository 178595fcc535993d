"""The port's observability (madsim_tpu_torch.obs and the metrics and ring
writes of the plain step) against the JAX package, bitwise, on the CPU:
every WorldState leaf after ``run`` with the metrics block and the flight
recorder on, in the packed lane profile, and their invisibility to every
other leaf; ``insert_metrics``; the metrics frames; and the coverage
ledger's hash and fold. The wide profile, ``trace()`` and the ring's host
decode are in tests/test_torch_obs_trace.py; the two files run in parallel
workers.

Tolerance: none — every operation is integer, or an exactly rounded
float32 product.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import madsim_tpu.engine as J
import madsim_tpu_torch.engine as T
from madsim_tpu.engine import queue as jq
from madsim_tpu.obs import blackbox as jbb
from madsim_tpu.obs import coverage as jcov
from madsim_tpu.obs.metrics import MetricsBlock as JMetricsBlock
from madsim_tpu_torch.engine import golden
from madsim_tpu_torch.engine import queue as tq
from madsim_tpu_torch.engine.core import tree_leaves, tree_paths
from madsim_tpu_torch.obs import blackbox as tbb
from madsim_tpu_torch.obs import coverage as tcov
from madsim_tpu_torch.obs import metrics as tm
from test_torch_engine import ALL_OPS, HEADLINE

SEEDS = np.arange(8)
HUNT_RK, HUNT_CK, HUNT_FAULTS, _ = golden.CONFIGS["hunt_faults"]
HUNT_FAULTS = np.asarray(HUNT_FAULTS, np.int32)
# Sends saturate at INF_TIME and drop (the metrics block's drop_inf).
INF_LATENCY = np.array([[0, J.FAULT_SET_LATENCY, 2_000_000_000,
                         2_147_483_646]], np.int32)

# name: (raft kwargs, engine kwargs, faults, max_steps, a counter the case
# exists for).
CASES = {
    "headline": (*HEADLINE, None, 2_000, "m_msgs_delivered"),
    "hunt_faults": (HUNT_RK, HUNT_CK, HUNT_FAULTS, 4_000, "m_drop_dead"),
    "fault_mix": (dict(n=3, n_proposals=3),
                  dict(n_nodes=3, outbox_cap=4, queue_cap=64,
                       t_limit_us=1_000_000, stop_on_bug=False),
                  ALL_OPS, 2_000, "m_drop_loss"),
    "overflow_q8": (dict(n=3, n_proposals=2),
                    dict(n_nodes=3, outbox_cap=4, queue_cap=8,
                         t_limit_us=2_000_000, stop_on_bug=False),
                    None, 3_000, "m_drop_overflow"),
    "inf_latency": (HUNT_RK, HUNT_CK, INF_LATENCY, 4_000, "m_drop_inf"),
}


def engines(rk, ck, **over):
    ck = dict(ck, **over)
    return (J.DeviceEngine(J.RaftActor(J.RaftDeviceConfig(**rk)),
                           J.EngineConfig(**ck)),
            T.DeviceEngine(T.RaftActor(T.RaftDeviceConfig(**rk)),
                           T.EngineConfig(**ck), device="cpu"))


def leaf_mismatches(jstate, tstate):
    """Names of the leaves whose value or dtype differ."""
    jl = [np.asarray(x) for x in jax.tree.leaves(jstate)]
    tl = [x.numpy() for x in tree_leaves(tstate)]
    assert len(jl) == len(tl)
    return [name for name, a, b in zip(tree_paths(tstate), jl, tl)
            if a.dtype != b.dtype or not np.array_equal(a, b)]


def check_leaves_and_invisibility(name, packed, k):
    """Every leaf, the metrics block and the ring (``k`` deep) included,
    equals JAX's after ``run``; then the same port run with both off
    leaves every other leaf as it was."""
    rk, ck, faults, max_steps, counter = CASES[name]
    je, te = engines(rk, ck, packed=packed, metrics=True, blackbox=k)
    js = je.run(je.init(SEEDS, faults=faults), max_steps)
    ts = te.run(te.init(SEEDS, faults=faults), max_steps)
    assert not leaf_mismatches(js, ts), name
    obs = te.observe(ts)
    jobs = je.observe(js)
    assert sorted(obs) == sorted(jobs)
    assert obs[counter].any(), f"{name}: {counter} never counted"
    assert (obs["bb_pos"] > k).any(), f"{name}: no ring wrapped"
    # Bitwise invisibility: metrics and ring off, the same trajectory.
    _, off = engines(rk, ck, packed=packed)
    os_ = off.run(off.init(SEEDS, faults=faults), max_steps)
    on_leaves = dict(zip(tree_paths(ts), tree_leaves(ts)))
    for path, x in zip(tree_paths(os_), tree_leaves(os_)):
        assert torch.equal(x, on_leaves[path]), path
    assert {p for p in on_leaves if p not in tree_paths(os_)} == (
        {"metrics." + f for f in tm.BLOCK_FIELDS}
        | {"blackbox." + f for f in tbb.RING_FIELDS})


@pytest.mark.parametrize("name", sorted(CASES))
def test_metrics_and_ring_leaves_match_jax_and_are_invisible(name):
    """The packed profile, with a 16-deep ring."""
    check_leaves_and_invisibility(name, packed=True, k=16)


def test_metrics_constants_and_frames_match_jax():
    from madsim_tpu.obs import metrics as jm

    assert tm.NUM_FAULT_KINDS == jm.NUM_FAULT_KINDS == J.FAULT_RESUME + 1
    assert tm.BLOCK_FIELDS == jm.BLOCK_FIELDS
    assert tm.OBS_PREFIX == jm.OBS_PREFIX
    assert tbb.RING_FIELDS == jbb.RING_FIELDS
    assert tbb.FAULT_NAMES == jbb.FAULT_NAMES
    assert [tbb.BB_TIMER, tbb.BB_FAULT, tbb.BB_DROP_STALE, tbb.BB_DROP_DEAD,
            tbb.BB_RAISE, tbb.BB_MARKER] == [
        jbb.BB_TIMER, jbb.BB_FAULT, jbb.BB_DROP_STALE, jbb.BB_DROP_DEAD,
        jbb.BB_RAISE, jbb.BB_MARKER]
    rng = np.random.default_rng(3)
    obs = {"m_a": rng.integers(0, 9, 6).astype(np.int32),
           "m_h": rng.integers(0, 9, (6, 4)).astype(np.int32),
           "steps": np.arange(6)}
    assert tm.aggregate_metrics(tm.metrics_from_observations(obs)) == \
        jm.aggregate_metrics(jm.metrics_from_observations(obs))
    assert tm.metrics_from_observations({"steps": obs["steps"]}) is None
    ring = {"bb_step_lo": np.zeros((6, 5), np.int16)}
    assert tbb.ring_depth(ring) == jbb.ring_depth(ring) == 5
    assert tbb.ring_depth(obs) is None


def test_insert_metrics_matches_jax():
    """Requested, INF-dropped and overflowed inserts of push_many batches
    into nearly full queues."""
    rng = np.random.default_rng(7)
    w, cap, m, p = 32, 8, 5, 4
    times = rng.integers(0, 200, (w, cap)).astype(np.int32)
    times[rng.random((w, cap)) > 0.7] = jq.INF_TIME
    ev_t = rng.integers(0, 300, (w, m)).astype(np.int32)
    ev_t[rng.random((w, m)) < 0.25] = jq.INF_TIME
    enable = rng.random((w, m)) < 0.8
    zeros = np.zeros((w, m), np.int32)
    q = tq.EventQueue(torch.from_numpy(times), torch.zeros((w, cap),
                                                           dtype=torch.int32),
                      torch.zeros((w, cap, p), dtype=torch.int32))
    evs = tq.Event(*[torch.from_numpy(a) for a in
                     (ev_t, zeros, zeros, zeros, zeros, zeros)],
                   payload=torch.zeros((w, m, p), dtype=torch.int32))
    _q, _ok, n_ins = tq.push_many(q, evs, torch.from_numpy(enable))
    got = tq.insert_metrics(torch.from_numpy(ev_t), torch.from_numpy(enable),
                            n_ins)
    want = jax.vmap(jq.insert_metrics)(jnp.asarray(ev_t), jnp.asarray(enable),
                                       jnp.asarray(n_ins.numpy()))
    for g, v in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(v))
    assert (got[1] > 0).any() and (got[2] > 0).any()


def random_blocks(seed, w=64, nk=7):
    """A batch of random metrics blocks, counts spread over powers of two,
    as (port block, JAX block)."""
    rng = np.random.default_rng(seed)

    def col(*shape):
        return (rng.integers(0, 2**31 - 1, (w,) + shape)
                >> rng.integers(0, 31, (w,) + shape)).astype(np.int32)

    arrays = {f: col() for f in tm.BLOCK_FIELDS[:11]}
    arrays["fault_hist"] = col(tm.NUM_FAULT_KINDS)
    arrays["kind_hist"] = col(nk)
    arrays["drop_stale"][:8] = 0
    return (tm.MetricsBlock(**{k: torch.from_numpy(v)
                               for k, v in arrays.items()}),
            JMetricsBlock(**{k: jnp.asarray(v) for k, v in arrays.items()}))


def test_behavior_signature_fold_and_distinct_count_match_jax():
    tb, jb = random_blocks(11)
    sig = tcov.behavior_signature(tb)
    np.testing.assert_array_equal(
        sig.numpy(), np.asarray(jcov.behavior_signature(jb)).astype(np.int64))
    rng = np.random.default_rng(5)
    for k in (1, 7, 256):
        th, tf = tcov.ledger_zeros(k)
        jh, jf = jcov.ledger_zeros(k)
        for fold in range(3):
            tb, jb = random_blocks(20 + fold)
            mask = rng.random(64) < 0.6
            idx = rng.permutation(1_000)[:64].astype(np.int32)
            idx[::9] = -1
            th, tf = tcov.fold_retired(th, tf, tb, torch.from_numpy(mask),
                                       torch.from_numpy(idx))
            jh, jf = jcov.fold_retired_local(jh, jf, jb, jnp.asarray(mask),
                                             jnp.asarray(idx))
            np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
            np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
            assert int(tcov.distinct_count(th)) == int(jcov.distinct_count(jh))
    assert th.dtype == tf.dtype == torch.int32
    cov = tcov.coverage_from_device(256, th.numpy(), tf.numpy(), [3, 5, 5])
    assert cov.to_json() == jcov.coverage_from_device(
        256, np.asarray(jh), np.asarray(jf), [3, 5, 5]).to_json()
    np.testing.assert_array_equal(cov.new_behaviors_per_chunk, [3, 2, 0])
