"""The port's event queue and lane primitives (madsim_tpu_torch.engine.queue,
.lanes) against the JAX package, bitwise.

The JAX functions work on one world and are batched here with
``jax.vmap``; the port's take a leading world axis. Inputs are made from
numpy seeds. Tolerance: none (integer-only functions).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madsim_tpu.engine import lanes as jl
from madsim_tpu.engine import queue as jq
from madsim_tpu_torch.engine import lanes as tl
from madsim_tpu_torch.engine import queue as tq

INF = int(jq.INF_TIME)
TORCH_OF = {np.int8: torch.int8, np.int16: torch.int16, np.int32: torch.int32}


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def random_queue(rng, w, cap, p, pay_dtype, fill=0.6):
    times = rng.integers(0, 200, (w, cap)).astype(np.int32)
    times[rng.random((w, cap)) > fill] = INF
    meta = np.asarray(jq.pack_meta(
        rng.integers(0, 64, (w, cap)), rng.integers(0, 4, (w, cap)),
        rng.integers(0, 4, (w, cap)), rng.integers(0, 4, (w, cap)),
        rng.integers(0, 256, (w, cap))))
    info = np.iinfo(pay_dtype)
    payload = rng.integers(info.min, info.max, (w, cap, p)).astype(pay_dtype)
    return times, meta, payload


def random_events(rng, w, m, p):
    times = rng.integers(0, 300, (w, m)).astype(np.int32)
    times[rng.random((w, m)) < 0.2] = INF   # dropped without a slot
    times[rng.random((w, m)) < 0.05] = INF - 1
    return dict(
        time=times,
        kind=rng.integers(0, 64, (w, m)).astype(np.int32),
        flags=rng.integers(0, 4, (w, m)).astype(np.int32),
        src=rng.integers(0, 8, (w, m)).astype(np.int32),
        dst=rng.integers(0, 8, (w, m)).astype(np.int32),
        gen=rng.integers(-128, 256, (w, m)).astype(np.int32),
        # Out-of-range words exercise the saturating payload narrow.
        payload=rng.integers(-70_000, 70_000, (w, m, p)).astype(np.int32),
    )


def jax_push_many(q, evs, enable, clear):
    def one(qt, qm, qp, ev, en, cs, cf):
        qq = jq.EventQueue(qt, qm, qp)
        e = jq.Event(**ev)
        return jq.push_many(qq, e, en, clear=None if cs is None else (cs, cf))
    if clear is None:
        fn = jax.vmap(lambda a, b, c, d, e: one(a, b, c, d, e, None, None))
        return fn(*q, evs, enable)
    return jax.vmap(one)(*q, evs, enable, *clear)


def torch_push_many(q, evs, enable, clear):
    tqq = tq.EventQueue(*[t(x) for x in q])
    ev = tq.Event(**{k: t(v) for k, v in evs.items()})
    cl = None if clear is None else (t(clear[0]).to(torch.int64),
                                      t(clear[1]))
    return tq.push_many(tqq, ev, t(enable), clear=cl)


def assert_queue_equal(jqueue, tqueue):
    for name in ("time", "meta", "payload"):
        a = np.asarray(getattr(jqueue, name))
        b = getattr(tqueue, name).numpy()
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(b, a, err_msg=name)


@pytest.mark.parametrize("cap,m,p,pay_dtype,use_clear", [
    (8, 4, 8, np.int16, True),
    (28, 4, 8, np.int16, True),
    (64, 9, 3, np.int32, False),
    (40, 6, 2, np.int16, False),
])
def test_push_many_matches_jax_randomized(cap, m, p, pay_dtype, use_clear):
    """Holey queues x event batches (INF times, disabled events, overflow),
    with and without the pop's fused clear."""
    rng = np.random.default_rng(cap * 100 + m)
    w = 48
    q = random_queue(rng, w, cap, p, pay_dtype, fill=rng.random())
    q[0][:8] = np.where(rng.random((8, cap)) < 0.9, 5, q[0][:8])  # ~full
    evs = random_events(rng, w, m, p)
    enable = rng.random((w, m)) < 0.8
    clear = None
    if use_clear:
        clear = (rng.integers(0, cap, w).astype(np.int32),
                 rng.random(w) < 0.7)
    jqq, jok, jn = jax_push_many(q, evs, enable, clear)
    tqq, tok, tn = torch_push_many(q, evs, enable, clear)
    assert_queue_equal(jqq, tqq)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    assert tn.dtype == torch.int32


def test_push_many_overflow_mid_batch():
    """More enabled events than free slots: the first n_free land, the
    rest report ok=False and write nothing (mirrors test_queue_insert)."""
    times = np.full((1, 4), INF, np.int32)
    times[0, :2] = [5, 6]
    q = (times, np.zeros((1, 4), np.int32), np.zeros((1, 4, 2), np.int32))
    evs = dict(time=np.array([[10, 11, 12, 13]], np.int32),
               kind=np.array([[7, 8, 9, 10]], np.int32),
               **{k: np.zeros((1, 4), np.int32)
                  for k in ("flags", "src", "dst", "gen")},
               payload=np.zeros((1, 4, 2), np.int32))
    enable = np.ones((1, 4), bool)
    tqq, tok, tn = torch_push_many(q, evs, enable, None)
    assert tok.tolist() == [[True, True, False, False]]
    assert tn.tolist() == [2]
    assert int(tq.depth(tqq)[0]) == 4
    jqq, jok, jn = jax_push_many(q, evs, enable, None)
    assert_queue_equal(jqq, tqq)


def test_push_many_inf_time_dropped_without_slot():
    q = (np.full((1, 2), INF, np.int32), np.zeros((1, 2), np.int32),
         np.zeros((1, 2, 2), np.int32))
    evs = dict(time=np.array([[INF, 7, 8]], np.int32),
               kind=np.array([[1, 2, 3]], np.int32),
               **{k: np.zeros((1, 3), np.int32)
                  for k in ("flags", "src", "dst", "gen")},
               payload=np.zeros((1, 3, 2), np.int32))
    tqq, tok, tn = torch_push_many(q, evs, np.ones((1, 3), bool), None)
    assert tok.tolist() == [[True, True, True]] and tn.tolist() == [2]
    _, ev, found = tq.pop(tqq)
    assert bool(found[0]) and int(ev.kind[0]) == 2


def test_push_many_clear_equals_pop_then_push():
    """push_many(q, ..., clear=(slot, found)) == pop first, then push."""
    rng = np.random.default_rng(11)
    w, cap, m, p = 40, 16, 5, 3
    q = tq.EventQueue(*[t(x) for x in random_queue(rng, w, cap, p, np.int16)])
    ev = tq.Event(**{k: t(v) for k, v in random_events(rng, w, m, p).items()})
    en = t(rng.random((w, m)) < 0.8)
    q_pop, _ev, found, slot = tq.pop_indexed(q)
    a, ok_a, n_a = tq.push_many(q_pop, ev, en)
    b, ok_b, n_b = tq.push_many(q, ev, en, clear=(slot, found))
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert torch.equal(ok_a, ok_b) and torch.equal(n_a, n_b)


@pytest.mark.parametrize("cap,paused_frac", [(8, 0.0), (28, 0.5), (64, 1.0)])
def test_pop_indexed_and_eligibility_match_jax(cap, paused_frac):
    """The eligible first-min pop: lowest slot among equal minimum times,
    fault events always eligible, found=False when nothing is eligible."""
    rng = np.random.default_rng(cap)
    w, n, p = 64, 3, 8
    times, meta, payload = random_queue(rng, w, cap, p, np.int16)
    times = np.where(times < INF, times % 7, INF).astype(np.int32)  # ties
    paused = rng.random((w, n)) < paused_frac
    jq_b = jq.EventQueue(jnp.asarray(times), jnp.asarray(meta),
                         jnp.asarray(payload))
    jel = jax.vmap(lambda q, pz: jq.eligible_mask(q, pz, n))(jq_b, paused)
    active = rng.random(w) < 0.9
    jel = jel & active[:, None]
    jres = jax.vmap(jq.pop_indexed)(jq_b, jel)
    tq_b = tq.EventQueue(t(times), t(meta), t(payload))
    tel = tq.eligible_mask(tq_b, t(paused)) & t(active)[:, None]
    np.testing.assert_array_equal(tel.numpy(), np.asarray(jel))
    tqq, tev, tfound, tslot = tq.pop_indexed(tq_b, tel)
    jqq, jev, jfound, jslot = jres
    assert_queue_equal(jqq, tqq)
    np.testing.assert_array_equal(tfound.numpy(), np.asarray(jfound))
    np.testing.assert_array_equal(tslot.numpy(), np.asarray(jslot))
    for name in jq.Event._fields:
        np.testing.assert_array_equal(getattr(tev, name).numpy(),
                                      np.asarray(getattr(jev, name)),
                                      err_msg=name)


def test_pack_unpack_meta_and_depth():
    rng = np.random.default_rng(2)
    f = [rng.integers(-300, 300, 256) for _ in range(5)]
    want = np.asarray(jq.pack_meta(*[jnp.asarray(x, jnp.int32) for x in f]))
    got = tq.pack_meta(*[t(x) for x in f])
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    for a, b in zip(tq.unpack_meta(got), jq.unpack_meta(jnp.asarray(want))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    times, _, _ = random_queue(rng, 16, 20, 1, np.int16)
    np.testing.assert_array_equal(
        tq.depth(tq.empty_queue(16, 20, 1)._replace(time=t(times))).numpy(),
        (times != INF).sum(1))


# ---------------------------------------------------------------------------
# Lane rules: saturate, wrap, clamp, drop
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.int8, np.int16, np.int32])
def test_narrow_saturates_and_narrow_wrap_wraps(dtype):
    x = np.array([-70_000, -129, -128, -1, 0, 127, 128, 255, 256, 40_000,
                  2**31 - 1], np.int32)
    np.testing.assert_array_equal(
        tl.narrow(t(x), TORCH_OF[dtype]).numpy(),
        np.asarray(jl.narrow(jnp.asarray(x), dtype)))
    np.testing.assert_array_equal(
        tl.narrow_wrap(t(x), TORCH_OF[dtype]).numpy(),
        np.asarray(jl.narrow_wrap(jnp.asarray(x), dtype)))
    assert tl.widen(tl.narrow(t(x), TORCH_OF[dtype])).dtype == torch.int32


def test_split_join_wide_roundtrip():
    v = np.array([0, 1, -1, 32767, 32768, -32769, 1_000_000, 2**31 - 1,
                  -2**31, 2_000_000_000], np.int32)
    lo, hi = tl.split_wide(t(v))
    jlo, jhi = jl.split_wide(jnp.asarray(v))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
    assert lo.abs().max() <= 32768 and hi.abs().max() <= 32768
    np.testing.assert_array_equal(tl.join_wide(lo, hi).numpy(), v)


def test_take_small_clamps_and_upd_drops_out_of_range():
    rng = np.random.default_rng(9)
    w, n, L = 32, 3, 5
    x = rng.integers(-100, 100, (w, n, L)).astype(np.int16)
    idx = rng.integers(-3, n + 3, w).astype(np.int32)
    j = rng.integers(-2, L + 2, w).astype(np.int32)
    v = rng.integers(-70_000, 70_000, (w, L)).astype(np.int32)
    s = rng.integers(-70_000, 70_000, w).astype(np.int32)
    np.testing.assert_array_equal(
        tl.take_small(t(x), t(idx)).numpy(),
        np.asarray(jax.vmap(jl.take_small)(x, idx[:, None]))[:, 0])
    idx2 = rng.integers(-3, n + 3, (w, 4)).astype(np.int32)
    np.testing.assert_array_equal(
        tl.take_small(t(x), t(idx2)).numpy(),
        np.asarray(jax.vmap(jl.take_small)(x, idx2)))
    np.testing.assert_array_equal(
        tl.upd(t(x), t(idx), t(v)).numpy(),
        np.asarray(jax.vmap(jl.upd)(x, idx, v)))
    np.testing.assert_array_equal(
        tl.upd2(t(x), t(idx), t(j), t(s)).numpy(),
        np.asarray(jax.vmap(jl.upd2)(x, idx, j, s)))
    np.testing.assert_array_equal(
        tl.onehot(t(idx), n).numpy(),
        np.asarray(jax.vmap(lambda i: jl.onehot(i, n))(idx)))
    out_of_range = (idx < 0) | (idx >= n)
    assert out_of_range.any()
    np.testing.assert_array_equal(
        tl.upd(t(x), t(idx), t(v)).numpy()[out_of_range], x[out_of_range])


def test_prefix_count_and_popcount():
    rng = np.random.default_rng(10)
    for n in (1, 5, 32, 33, 64, 70):
        mask = rng.random((16, n)) < 0.5
        np.testing.assert_array_equal(
            tl.prefix_count(t(mask)).numpy(),
            np.asarray(jax.vmap(jl.prefix_count)(mask)))
    x = rng.integers(-2**31, 2**31, 1000).astype(np.int32)
    np.testing.assert_array_equal(
        tl.popcount32(t(x)).numpy(),
        np.asarray(jax.lax.population_count(jnp.asarray(x))))
