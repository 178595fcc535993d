"""The actor-protocol conformance checker (madsim_tpu_torch/engine/
conformance.py) against the JAX package on the CPU:

- ``check_actor`` over every registered family (the registry's canonical
  ``conformance()`` config, ``require_divergence`` from its ``divergent``
  flag) at 16 worlds and ``max_steps=150``: the report equals JAX's at
  the same arguments, key for key. The JAX-derived reports at
  tests/test_conformance.py's own shape (32 worlds, 3,000 steps,
  ``golden.GOLDEN_CHECK_ACTOR``, which ``chip_smoke.py`` holds the card
  to) are recomputed from JAX by the test marked ``slow``;
- tests/test_conformance.py's four negative cases, written against the
  port's batched actor protocol: an impure handler, a float state lane,
  a handler that changes a lane's dtype mid-run and a seed-insensitive
  actor each raise ``ConformanceError`` with JAX's message. The dtype
  change's message is JAX's up to its detail: JAX appends its tracer's
  ``while_loop`` carry error, the port names the method, the leaf and
  the two layouts;
- the registry's ``divergent`` flags are JAX's.

The port's engine runs on ``device="cpu"`` (the plain step). Tolerance:
none — reports and messages are compared as exact values.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import madsim_tpu.engine as J
import madsim_tpu_torch.engine as T
from madsim_tpu.engine.families import actor_families as j_families
from madsim_tpu_torch.engine import golden
from madsim_tpu_torch.engine.families import actor_families as t_families

RAFT_CFG = dict(n_nodes=3, outbox_cap=4, queue_cap=64, t_limit_us=2_000_000)


@pytest.mark.parametrize("name", sorted(t_families()))
def test_every_registered_family_conforms_as_in_jax(name):
    tf, jf = t_families()[name], j_families()[name]
    assert tf.divergent == jf.divergent
    kw = dict(n_worlds=16, max_steps=150, require_divergence=tf.divergent)
    ta, tcfg = tf.conformance()
    rep = T.check_actor(ta, tcfg, device="cpu", **kw)
    ja, jcfg = jf.conformance()
    assert rep == J.check_actor(ja, jcfg, **kw)
    assert list(rep) == ["n_worlds", "steps_mean", "draws_per_kind",
                         "bug_rate", "qmax"]
    assert rep["bug_rate"] == 0.0 and rep["steps_mean"] > 1
    assert all(0 <= d <= 8 for d in rep["draws_per_kind"])


def test_divergent_flags_equal_jax():
    t, j = t_families(), j_families()
    assert {n: f.divergent for n, f in t.items()} == \
        {n: f.divergent for n, f in j.items()}
    assert sorted(n for n in t if not t[n].divergent) == [
        "guided_pair", "pair_restart"]


def _errors(t_call, j_call):
    with pytest.raises(T.ConformanceError) as te:
        t_call()
    with pytest.raises(J.ConformanceError) as je:
        j_call()
    return str(te.value), str(je.value)


def test_impure_handler_is_caught():
    tc, jc = itertools.count(), itertools.count()

    class TImpure(T.RaftActor):
        def handle(self, cfg, s, ev, now, rng):
            s2, ob, rng2, bug = super().handle(cfg, s, ev, now, rng)
            # Host-side mutable state leaks into each call's result.
            leak = torch.tensor(next(tc), dtype=torch.int32)
            return s2._replace(elections_won=s2.elections_won + 0 * leak
                               + leak), ob, rng2, bug

    class JImpure(J.RaftActor):
        def handle(self, cfg, s, ev, now, rng):
            s2, ob, rng2, bug = super().handle(cfg, s, ev, now, rng)
            leak = jnp.int32(next(jc))
            return s2._replace(elections_won=s2.elections_won + 0 * leak
                               + leak), ob, rng2, bug

    t, j = _errors(
        lambda: T.check_actor(TImpure(T.RaftDeviceConfig(n=3)),
                              T.EngineConfig(**RAFT_CFG), n_worlds=16,
                              max_steps=300, device="cpu"),
        lambda: J.check_actor(JImpure(J.RaftDeviceConfig(n=3)),
                              J.EngineConfig(**RAFT_CFG), n_worlds=16,
                              max_steps=300))
    assert t == j and "impure" in t


def test_float_state_is_rejected():
    class TFloat(T.RaftActor):
        def init(self, cfg, rng):
            s, evs, rng = super().init(cfg, rng)
            return s._replace(first_leader_time=s.first_leader_time.to(
                torch.float32)), evs, rng

    class JFloat(J.RaftActor):
        def init(self, cfg, rng):
            s, evs, rng = super().init(cfg, rng)
            return s._replace(first_leader_time=jnp.float32(
                s.first_leader_time)), evs, rng

    t, j = _errors(
        lambda: T.check_actor(TFloat(T.RaftDeviceConfig(n=3)),
                              T.EngineConfig(**RAFT_CFG), n_worlds=16,
                              max_steps=500, device="cpu"),
        lambda: J.check_actor(JFloat(J.RaftDeviceConfig(n=3)),
                              J.EngineConfig(**RAFT_CFG), n_worlds=16,
                              max_steps=500))
    assert t == j and "dtype float32" in t


def test_handler_dtype_drift_is_caught():
    class TDrift(T.RaftActor):
        def handle(self, cfg, s, ev, now, rng):
            s2, ob, rng2, bug = super().handle(cfg, s, ev, now, rng)
            return s2._replace(elections_won=s2.elections_won * torch.tensor(
                1.0, dtype=torch.float32)), ob, rng2, bug

    class JDrift(J.RaftActor):
        def handle(self, cfg, s, ev, now, rng):
            s2, ob, rng2, bug = super().handle(cfg, s, ev, now, rng)
            return s2._replace(
                elections_won=s2.elections_won * jnp.float32(1.0)), \
                ob, rng2, bug

    t, j = _errors(
        lambda: T.check_actor(TDrift(T.RaftDeviceConfig(n=3)),
                              T.EngineConfig(**RAFT_CFG), n_worlds=16,
                              max_steps=500, device="cpu"),
        lambda: J.check_actor(JDrift(J.RaftDeviceConfig(n=3)),
                              J.EngineConfig(**RAFT_CFG), n_worlds=16,
                              max_steps=500))
    head = ("handle()/on_restart() changed the state pytree's structure, "
            "shapes, or dtypes (jit carry mismatch): ")
    assert t.startswith(head) and j.startswith(head)
    # JAX's detail is its tracer's; the port names the leaf it changed.
    assert t[len(head):] == ("handle() returned astate leaf 12 as float32 "
                             "(16,), given int32 (16,)")
    assert "elections_won" in j


def test_seed_insensitive_actor_is_caught():
    class TFrozen:
        num_kinds = 1

        def init(self, cfg, rng):
            w, dev = rng.k0.shape[0], rng.k0.device

            def i32(v):
                return torch.full((w,), v, dtype=torch.int32, device=dev)

            s = {"x": torch.zeros((w, cfg.n_nodes), dtype=torch.int32,
                                  device=dev)}
            evs = [T.Event(time=i32(10), kind=i32(0), flags=i32(0),
                           src=i32(0), dst=i32(0), gen=i32(0),
                           payload=torch.zeros((w, cfg.payload_words),
                                               dtype=torch.int32,
                                               device=dev))]
            return s, evs, rng

        def handle(self, cfg, s, ev, now, rng):
            w = now.shape[0]
            return (s, T.Outbox.empty(cfg, w, now.device), rng,
                    torch.zeros((w,), dtype=torch.bool, device=now.device))

        def on_restart(self, cfg, s, node, now, rng):
            return s, T.Outbox.empty(cfg, now.shape[0], now.device), rng

        def invariant(self, cfg, s):
            return torch.zeros(s["x"].shape[:1], dtype=torch.bool,
                               device=s["x"].device)

        def observe(self, cfg, s):
            return {"x0": s["x"][..., 0]}

    class JFrozen:
        num_kinds = 1

        def init(self, cfg, rng):
            from madsim_tpu.engine.queue import Event

            s = {"x": jnp.zeros((cfg.n_nodes,), jnp.int32)}
            evs = [Event.make(time=10, kind=0,
                              payload_words=cfg.payload_words)]
            return s, evs, rng

        def handle(self, cfg, s, ev, now, rng):
            return s, J.Outbox.empty(cfg), rng, jnp.asarray(False)

        def on_restart(self, cfg, s, node, now, rng):
            return s, J.Outbox.empty(cfg), rng

        def invariant(self, cfg, s):
            return jnp.asarray(False)

        def observe(self, cfg, s):
            return {"x0": s["x"][..., 0]}

    ck = dict(n_nodes=2, outbox_cap=3, queue_cap=8, t_limit_us=1_000_000)
    t, j = _errors(
        lambda: T.check_actor(TFrozen(), T.EngineConfig(**ck), n_worlds=16,
                              max_steps=100, device="cpu"),
        lambda: J.check_actor(JFrozen(), J.EngineConfig(**ck), n_worlds=16,
                              max_steps=100))
    assert t == j and "randomness" in t


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(golden.GOLDEN_CHECK_ACTOR))
def test_golden_check_actor_reports_recomputed_from_jax(name):
    jf = j_families()[name]
    actor, cfg = jf.conformance()
    assert J.check_actor(actor, cfg, require_divergence=jf.divergent,
                         **golden.CHECK_ACTOR_SHAPE) \
        == golden.GOLDEN_CHECK_ACTOR[name]
