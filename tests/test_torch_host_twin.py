"""The generated host twin (madsim_tpu_torch/actorc/host.py) and its
lockstep crosscheck (actorc/conformance.py) against the JAX package on
the CPU:

- ``HostActor``: the port's and JAX's twins of the tpc, pb and Paxos
  specs fed the same stream of events, restarts and entropy (made from a
  seed with numpy): every state lane (values and dtypes), every outbox
  field, every bug flag and invariant verdict equal, event by event;
- ``crosscheck``: the reports at tests/test_actorc.py's seeds, faults
  and ``max_steps=250`` equal JAX's and the JAX-derived
  ``golden.GOLDEN_CROSSCHECK`` that ``chip_smoke.py`` holds the card to
  (the 64-seed, 400-step reports are recomputed from JAX by the test
  marked ``slow``);
- a planted handler that branches on the backend (``c.np``) is caught
  with ``HostTwinMismatch`` naming the lane, the text JAX's.

The port's engine runs on ``device="cpu"`` (the plain step; the kernel
leg of the crosscheck runs only on CUDA, in ``chip_smoke.py``).
Tolerance: none, every comparison is bitwise.
"""
import dataclasses

import numpy as np
import pytest

import madsim_tpu.actorc as JA
import madsim_tpu.engine as J
import madsim_tpu_torch.actorc as TA
import madsim_tpu_torch.engine as T
from madsim_tpu.actorc.families.paxos import PaxosConfig as JPaxosConfig
from madsim_tpu.actorc.families.paxos import engine_config as j_paxos_cfg
from madsim_tpu.actorc.families.paxos import paxos_spec as j_paxos_spec
from madsim_tpu.actorc.families.pb import pb_spec as j_pb_spec
from madsim_tpu.actorc.families.tpc import tpc_spec as j_tpc_spec
from madsim_tpu_torch.engine import golden

J_SPECS = {"tpc": lambda kw: j_tpc_spec(J.TPCDeviceConfig(**kw)),
           "pb": lambda kw: j_pb_spec(J.PBDeviceConfig(**kw)),
           "paxos": lambda kw: j_paxos_spec(JPaxosConfig(**kw))}


def j_spec(name):
    fam, kw = golden.CARD_SPECS[name]
    return J_SPECS[fam](kw)


def j_case(name):
    """golden.crosscheck_case(name) in the JAX package."""
    spec_name, ck, seeds, faults, steps = golden.CROSSCHECK_CASES[name]
    if ck is None:
        cfg = j_paxos_cfg(JPaxosConfig(**golden.CARD_SPECS[spec_name][1]))
    else:
        cfg = J.EngineConfig(**ck)
    return (j_spec(spec_name), cfg, list(seeds),
            np.asarray(faults, np.int32), steps)


def _same_state(where, a, b):
    assert sorted(a) == sorted(b), where
    for k in a:
        assert a[k].dtype == b[k].dtype, (where, k)
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{where} {k}")


def _same_outbox(where, a, b):
    for f in a._fields:
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype, (where, f)
        np.testing.assert_array_equal(x, y, err_msg=f"{where} {f}")


@pytest.mark.parametrize("name", ["tpc_crosscheck", "pb_hunt",
                                  "paxos_hunt"])
@pytest.mark.parametrize("packed", [True, False], ids=["packed", "wide"])
def test_host_actor_matches_jax_event_by_event(name, packed):
    """600 events (and a restart every 40th) drawn with numpy: kinds
    uniform, payload words near the bottom of their declared ranges (so
    the protocol's guards take both arms), destinations and sources
    uniform, the clock rising, four random entropy words each."""
    ts, js = golden.card_spec(name), j_spec(name)
    th = TA.HostActor(ts, packed=packed, payload_words=8)
    jh = JA.HostActor(js, packed=packed, payload_words=8)
    rng = np.random.default_rng(20_261)
    n = ts.n_nodes
    tst, jst = th.init_state(), jh.init_state()
    _same_state("init", tst, jst)
    now = 0
    for i in range(600):
        now += int(rng.integers(0, 5_000))
        ent = [int(x) for x in rng.integers(0, 1 << 32, 4)]
        if i % 40 == 39:
            node = int(rng.integers(0, n))
            tst, tob = th.on_restart(tst, node=node, now=now, entropy=ent)
            jst, job = jh.on_restart(jst, node=node, now=now, entropy=ent)
            where = f"event {i} (restart node {node})"
            tbug = jbug = None
        else:
            kind = int(rng.integers(0, len(ts.messages)))
            words = [int(rng.integers(w.lo, min(w.hi, w.lo + 6) + 1))
                     for w in ts.messages[kind].words]
            ev = dict(kind=kind, dst=int(rng.integers(0, n)),
                      src=int(rng.integers(0, n)),
                      payload=words + [0] * (8 - len(words)), now=now,
                      entropy=ent)
            tst, tob, tbug = th.handle(tst, **ev)
            jst, job, jbug = jh.handle(jst, **ev)
            where = f"event {i} ({ts.messages[kind].name})"
        _same_state(where, tst, jst)
        _same_outbox(where, tob, job)
        assert tbug == jbug, where
        assert th.invariant(tst) == jh.invariant(jst), where


@pytest.mark.parametrize("name", ["tpc", "pb", "paxos"])
def test_crosscheck_report_equals_jax(name):
    actor, cfg, seeds, faults, steps = golden.crosscheck_case(name)
    rep = TA.crosscheck(actor.spec, cfg, seeds=seeds, faults=faults,
                        max_steps=steps, device="cpu")
    js, jcfg, jseeds, jfaults, jsteps = j_case(name)
    assert rep == JA.crosscheck(js, jcfg, seeds=jseeds, faults=jfaults,
                                max_steps=jsteps)
    assert rep == golden.GOLDEN_CROSSCHECK[name]
    assert rep["events_delivered"] > 20
    if name != "paxos":
        assert rep["restarts"] >= 1


def _ping_spec(pkg, evil_np):
    """tests/test_actorc.py's ping spec with its planted handler: it
    writes 1 under the device backend and 2 under the twin's numpy."""
    n = 3

    def evil(c):
        val = 2 if c.np is evil_np else 1
        c.write("count", c.read("count") + val)

    def init(c):
        c.event("Ping", time=10, dst=0, words=[1])

    return pkg.ActorSpec(
        name="ping", n_nodes=n, lanes=(pkg.Lane("count", hi=100),),
        messages=(pkg.Message("Ping", (pkg.Word("x", 0, 100),)),),
        handlers={"Ping": evil}, init=init,
        invariant=lambda v: v.np.any(v.lane("count") > 1_000_000))


def test_host_twin_catches_backend_divergence():
    ck = dict(n_nodes=3, outbox_cap=4, queue_cap=16, t_limit_us=1_000_000)
    with pytest.raises(TA.HostTwinMismatch, match="count") as te:
        TA.crosscheck(_ping_spec(TA, np), T.EngineConfig(**ck), seeds=[0],
                      max_steps=10, device="cpu")
    with pytest.raises(JA.HostTwinMismatch) as je:
        JA.crosscheck(_ping_spec(JA, np), J.EngineConfig(**ck), seeds=[0],
                      max_steps=10)
    assert str(te.value) == str(je.value)
    assert "lane 'count' diverged" in str(te.value)


def test_crosscheck_takes_an_engine_and_names_the_step():
    """A given engine is used as it is; a twin whose transition is one
    off from the lowering's is caught at its first event."""
    actor, cfg, seeds, faults, _steps = golden.crosscheck_case("tpc")
    spec = actor.spec
    eng = T.DeviceEngine(actor, cfg, device="cpu")
    rep = TA.crosscheck(spec, cfg, seeds=seeds[:1], faults=faults,
                        max_steps=60, engine=eng)
    assert rep["n_seeds"] == 1 and rep["steps_checked"] == 60

    def h_txn(c, real=spec.handlers["Txn"]):
        real(c)
        c.count("txns_seen")   # the host twin counts one more

    twisted = dataclasses.replace(spec, handlers=dict(spec.handlers,
                                                      Txn=h_txn))
    with pytest.raises(TA.HostTwinMismatch,
                       match=r"seed 0 step \d+: lane 'txns_seen'"):
        TA.crosscheck(twisted, cfg, seeds=seeds[:1], faults=faults,
                      max_steps=60, engine=eng)


@pytest.mark.slow
@pytest.mark.parametrize("name", ["tpc:64", "pb:64", "paxos:64"])
def test_golden_crosscheck_64_seeds_recomputed_from_jax(name):
    js, jcfg, jseeds, jfaults, jsteps = j_case(name)
    assert JA.crosscheck(js, jcfg, seeds=jseeds, faults=jfaults,
                         max_steps=jsteps) == golden.GOLDEN_CROSSCHECK[name]
