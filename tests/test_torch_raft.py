"""The port's Raft actor (madsim_tpu_torch.engine.raft_actor) against the JAX
actor, bitwise: ``handle`` on random in-range states and events of all 7
kinds, ``on_restart`` and ``invariant``, batched against ``jax.vmap`` of
the JAX methods.

Inputs are made from numpy seeds. Tolerance: none (integer-only).
"""
import jax
import numpy as np
import pytest
import torch

from madsim_tpu.engine import core as jcore
from madsim_tpu.engine import queue as jq
from madsim_tpu.engine import raft_actor as jra
from madsim_tpu.engine import rng as jrng
from madsim_tpu_torch.engine import core as tcore
from madsim_tpu_torch.engine import queue as tq
from madsim_tpu_torch.engine import raft_actor as tra
from madsim_tpu_torch.engine import rng as trng

W = 1024
INF = int(jq.INF_TIME)

CASES = [  # (n, log_cap, buggy_double_vote)
    (3, 4, False),
    (3, 16, True),
    (5, 8, False),
]


def t(a) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        return torch.from_numpy(a.astype(np.int64)).to(torch.uint32)
    return torch.from_numpy(a)


def as_np(x: torch.Tensor) -> np.ndarray:
    return x.to(torch.int64).numpy().astype(np.uint32) \
        if x.dtype == torch.uint32 else x.numpy()


def random_state(rng, n, L):
    """Random in-range Raft rows in the packed lane dtypes."""
    def r(lo, hi, shape, dt):
        return rng.integers(lo, hi + 1, (W,) + shape).astype(dt)

    flt = r(0, 1_000_000, (), np.int32)
    flt[rng.random(W) < 0.5] = INF
    won = r(0, 63, (n, 4), np.int32)
    won[..., 1:] = 0
    won[rng.random(W) < 0.05, :, 3] = np.int32(-2**31)  # top bit set
    return dict(
        term=r(0, 5, (n,), np.int16), voted_for=r(-1, n - 1, (n,), np.int8),
        role=r(0, 2, (n,), np.int8), votes=r(0, 2**n - 1, (n,), np.int32),
        commit=r(0, L, (n,), np.int16), log_len=r(0, L, (n,), np.int16),
        log_term=r(0, 5, (n, L), np.int16), log_cmd=r(0, 4, (n, L), np.int16),
        next_idx=r(1, L + 1, (n, n), np.int16),
        match_idx=r(0, L, (n, n), np.int16),
        elect_epoch=r(0, 3, (n,), np.int16), first_leader_time=flt,
        elections_won=r(0, 3, (), np.int32), won_terms=won)


def random_event(rng, n, L, p=8):
    pay = np.stack([
        rng.integers(0, 6, W), rng.integers(0, n + 1, W),
        rng.integers(-1, L + 2, W), rng.integers(0, 6, W),
        rng.integers(0, 2, W), rng.integers(0, 6, W),
        rng.integers(0, 5, W), rng.integers(0, L + 2, W)], axis=1)
    # A few extreme words: saturation and clamping paths.
    pay[rng.random(W) < 0.03, 0] = 40_000
    return dict(
        time=rng.integers(0, 1_000_000, W).astype(np.int32),
        kind=rng.integers(0, 7, W).astype(np.int32),
        flags=np.zeros(W, np.int32),
        src=rng.integers(0, n, W).astype(np.int32),
        dst=rng.integers(-1, n + 1, W).astype(np.int32),
        gen=np.zeros(W, np.int32),
        payload=np.concatenate([pay, np.zeros((W, p - 8), np.int64)],
                               axis=1).astype(np.int32))


def random_rng(rng):
    return [rng.integers(0, 2**32, W, dtype=np.uint32) for _ in range(3)]


def actors(n, L, buggy):
    kw = dict(n=n, log_cap=L, buggy_double_vote=buggy, n_proposals=1)
    ck = dict(n_nodes=n, outbox_cap=n + 1)
    return (jra.RaftActor(jra.RaftDeviceConfig(**kw)), jcore.EngineConfig(**ck),
            tra.RaftActor(tra.RaftDeviceConfig(**kw)), tcore.EngineConfig(**ck))


def assert_tree_equal(jtree, ttree, what):
    jl = jax.tree.leaves(jtree)
    tl_ = tcore.tree_leaves(ttree)
    assert len(jl) == len(tl_), what
    fields = getattr(type(ttree), "_fields", range(len(tl_)))
    for name, a, b in zip(fields, jl, tl_):
        a = np.asarray(a)
        b = as_np(b)
        assert a.dtype == b.dtype, f"{what}.{name}: {a.dtype} vs {b.dtype}"
        np.testing.assert_array_equal(b, a, err_msg=f"{what}.{name}")


@pytest.mark.parametrize("n,L,buggy", CASES)
def test_handle_matches_jax(n, L, buggy):
    rng = np.random.default_rng(n * 100 + L)
    ja, jcfg, ta, tcfg = actors(n, L, buggy)
    st = random_state(rng, n, L)
    ev = random_event(rng, n, L)
    now = rng.integers(0, 2_000_000, W).astype(np.int32)
    k0, k1, ctr = random_rng(rng)

    def jhandle(s, e, nw, r):
        return ja.handle(jcfg, s, jq.Event(**e), nw, r)

    js2, job, jr2, jbug = jax.jit(jax.vmap(jhandle))(
        jra.RaftState(**st), ev, now, jrng.DevRng(k0, k1, ctr))
    ts2, tob, tr2, tbug = ta.handle(
        tcfg, tra.RaftState(**{k: t(v) for k, v in st.items()}),
        tq.Event(**{k: t(v) for k, v in ev.items()}), t(now),
        trng.DevRng(t(k0), t(k1), t(ctr)))
    assert_tree_equal(js2, ts2, "state")
    assert_tree_equal(job, tob, "outbox")
    assert_tree_equal(jr2, tr2, "rng")
    np.testing.assert_array_equal(tbug.numpy(), np.asarray(jbug))
    # The random batch reached the handler's interesting branches.
    kinds = ev["kind"]
    assert set(kinds.tolist()) == set(range(7))
    assert np.asarray(js2.elections_won > st["elections_won"]).any()  # wins
    assert (np.asarray(js2.log_len) != st["log_len"]).any()  # log writes
    assert (np.asarray(js2.commit) != st["commit"]).any()    # commits
    assert tbug.any()                                        # hist_bug


@pytest.mark.parametrize("n,L,buggy", CASES)
def test_on_restart_matches_jax(n, L, buggy):
    rng = np.random.default_rng(n * 1000 + L)
    ja, jcfg, ta, tcfg = actors(n, L, buggy)
    st = random_state(rng, n, L)
    st["elect_epoch"][:8] = 32767  # epoch + 1 saturates at rest
    node = rng.integers(-1, n + 1, W).astype(np.int32)
    now = rng.integers(0, 2_000_000, W).astype(np.int32)
    k0, k1, ctr = random_rng(rng)

    def jrestart(s, nd, nw, r):
        return ja.on_restart(jcfg, s, nd, nw, r)

    js2, job, jr2 = jax.jit(jax.vmap(jrestart))(
        jra.RaftState(**st), node, now, jrng.DevRng(k0, k1, ctr))
    ts2, tob, tr2 = ta.on_restart(
        tcfg, tra.RaftState(**{k: t(v) for k, v in st.items()}), t(node),
        t(now), trng.DevRng(t(k0), t(k1), t(ctr)))
    assert_tree_equal(js2, ts2, "state")
    assert_tree_equal(job, tob, "outbox")
    assert_tree_equal(jr2, tr2, "rng")


@pytest.mark.parametrize("n,L,buggy", CASES)
def test_invariant_and_observe_match_jax(n, L, buggy):
    rng = np.random.default_rng(n * 7 + L)
    ja, jcfg, ta, tcfg = actors(n, L, buggy)
    st = random_state(rng, n, L)
    # Half the worlds get matching logs, so both outcomes occur.
    same = rng.random(W) < 0.5
    st["log_term"][same] = st["log_term"][same][:, :1]
    st["log_cmd"][same] = st["log_cmd"][same][:, :1]
    jbad = jax.vmap(lambda s: ja.invariant(jcfg, s))(jra.RaftState(**st))
    tstate = tra.RaftState(**{k: t(v) for k, v in st.items()})
    tbad = ta.invariant(tcfg, tstate)
    np.testing.assert_array_equal(tbad.numpy(), np.asarray(jbad))
    assert 0 < int(tbad.sum()) < W
    jobs = jax.vmap(lambda s: ja.observe(jcfg, s))(jra.RaftState(**st))
    tobs = ta.observe(tcfg, tstate)
    assert sorted(jobs) == sorted(tobs)
    for k in jobs:
        np.testing.assert_array_equal(tobs[k].numpy(), np.asarray(jobs[k]),
                                      err_msg=k)
        assert tobs[k].numpy().dtype == np.asarray(jobs[k]).dtype, k


def test_init_events_and_config_checks_match_jax():
    """The actor's init: one election draw per node in order, then the
    proposal events; and the same config errors as the JAX actor."""
    rng = np.random.default_rng(0)
    ja, jcfg, ta, tcfg = actors(3, 4, False)
    k0, k1, ctr = random_rng(rng)
    js, jevs, jr = jax.vmap(lambda r: ja.init(jcfg, r))(
        jrng.DevRng(k0, k1, ctr))
    ts, tevs, tr = ta.init(tcfg, trng.DevRng(t(k0), t(k1), t(ctr)))
    assert_tree_equal(js, ts, "state")
    assert_tree_equal(jr, tr, "rng")
    assert len(jevs) == len(tevs) == 3 + 3
    for je, te in zip(jevs, tevs):
        assert_tree_equal(je, te, "event")
    for bad in (dict(n_nodes=4), dict(n_nodes=3, outbox_cap=3),
                dict(n_nodes=3, payload_words=4)):
        with pytest.raises(ValueError):
            ta.init(tcore.EngineConfig(**bad), trng.DevRng(t(k0), t(k1),
                                                           t(ctr)))
