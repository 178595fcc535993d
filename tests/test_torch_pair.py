"""The guided search's families in the port — ``PairRestartActor``
(madsim_tpu_torch/triage/synthetic.py), ``GuidedPairActor``
(madsim_tpu_torch/search/family.py) — and Paxos, under per-slot fault
schedules, against the JAX package on the CPU, bitwise:

- ``init`` + ``run`` on every WorldState leaf under per-slot ``(W, F, 4)``
  schedules made by the port's ``make_children`` from the template (the
  schedules the CUDA kernel meets in a guided sweep), with the metrics
  block and the flight recorder off and on, and ``observe()``;
- ``DeviceEngine.refill`` with a device-tensor per-slot schedule: equal to
  JAX's refill with a device array, and each refilled slot bitwise an
  independent ``init`` of its seed under its own schedule;
- the port's Paxos and guided-pair steps against the JAX package's Pallas
  kernel itself (``EngineConfig(pallas=True)``, interpret mode on the CPU,
  as tests/test_pallas_step.py runs it), at W = 8;
- the kernel's records for the three families (``engine/step_kernel.py``)
  and the family registry.

W = 16 or 24, seeds ``np.arange``. Tolerance: none, every operation is
integer.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import madsim_tpu.engine as J
import madsim_tpu_torch.engine as T
from madsim_tpu.actorc.families import paxos as jpaxos
from madsim_tpu.engine.families import actor_families as j_families
from madsim_tpu.search import family as jfamily
from madsim_tpu.triage import synthetic as jsyn
from madsim_tpu_torch.actorc.families import paxos as tpaxos
from madsim_tpu_torch.engine import families as tfamilies
from madsim_tpu_torch.engine import step_kernel
from madsim_tpu_torch.engine.core import tree_leaves, tree_paths
from madsim_tpu_torch.search import family as tfamily
from madsim_tpu_torch.search.corpus import corpus_init
from madsim_tpu_torch.search.hunts import paxos_hunt
from madsim_tpu_torch.search.mutate import make_children
from madsim_tpu_torch.triage import synthetic as tsyn

W = 24
PAXOS_X = dict(buggy_forgetful_acceptor=True, contend_all=True)

# family: (JAX actor, port actor, EngineConfig, template, max_steps).
CASES = {
    "pair_restart": (
        lambda: jsyn.PairRestartActor(jsyn.PairRestartConfig()),
        lambda: tsyn.PairRestartActor(tsyn.PairRestartConfig()),
        dict(vars(tsyn.engine_config(tsyn.PairRestartConfig(),
                                     metrics=True)), stop_on_bug=False),
        tsyn.pair_schedule(32, acfg=tsyn.PairRestartConfig()), 400),
    "guided_pair": (
        lambda: jfamily.GuidedPairActor(jfamily.GuidedPairConfig(n=12)),
        lambda: tfamily.GuidedPairActor(tfamily.GuidedPairConfig(n=12)),
        dict(vars(tfamily.engine_config(tfamily.GuidedPairConfig(n=12))),
             loss_rate=0.2),
        tfamily.family_schedule(6, tfamily.GuidedPairConfig(n=12)), 400),
    "paxos": (
        lambda: jpaxos.PaxosActor(jpaxos.PaxosConfig(**PAXOS_X)),
        lambda: tpaxos.PaxosActor(tpaxos.PaxosConfig(**PAXOS_X)),
        dict(vars(tpaxos.engine_config(tpaxos.PaxosConfig(**PAXOS_X),
                                       metrics=True)), stop_on_bug=False),
        tpaxos.hunt_template(tpaxos.PaxosConfig(**PAXOS_X)), 3_000),
}
LANES = {"off": dict(metrics=False), "on": dict(metrics=True, blackbox=16)}


def per_slot_schedules(family, w=W):
    """Children of the template under the search's operators, generation
    3 (jitter wide enough that Paxos restarts land in its rounds), plus
    both targets restarted in some guided-pair worlds."""
    _ja, _ta, ck, tmpl, _steps = CASES[family]
    cfg = T.EngineConfig(**ck)
    scfg = paxos_hunt().search(True)
    kids = make_children(scfg, cfg, corpus_init(8, tmpl),
                         torch.arange(w, dtype=torch.int32), 3).numpy()
    if family == "guided_pair":
        kids[::3, 0, 2] = 1
        kids[::3, 2, 2] = 2
    if family == "paxos":
        # Two restarts inside an amnesia window of the seed's ballot
        # race, so a forgetful acceptor splits a decree.
        for seed, (t1, n1, t2, n2) in {
                11: (77_541, 3, 71_024, 4), 15: (46_785, 4, 55_200, 2),
                17: (83_109, 0, 82_977, 4)}.items():
            if seed < w:
                kids[seed, 4] = [t1, T.FAULT_RESTART, n1, 0]
                kids[seed, 5] = [t2, T.FAULT_RESTART, n2, 0]
    return kids


def engines(family, **over):
    ja, ta, ck, _t, _s = CASES[family]
    ck = dict(ck, **over)
    return (J.DeviceEngine(ja(), J.EngineConfig(**ck)),
            T.DeviceEngine(ta(), T.EngineConfig(**ck), device="cpu"))


def mismatches(jstate, tstate):
    jl = [np.asarray(x) for x in jax.tree.leaves(jstate)]
    tl = T.state_to_numpy(tstate)
    assert len(jl) == len(tl)
    return [p for p, a, b in zip(tree_paths(tstate), jl, tl)
            if a.dtype != b.dtype or not np.array_equal(a, b)]


@pytest.mark.parametrize("lanes", sorted(LANES))
@pytest.mark.parametrize("family", sorted(CASES))
def test_run_under_per_slot_schedules_matches_jax(family, lanes):
    je, te = engines(family, **LANES[lanes])
    faults = per_slot_schedules(family)
    steps = CASES[family][4]
    seeds = np.arange(W)
    js = je.init(seeds, faults=faults)
    ts = te.init(seeds, faults=faults)
    assert not mismatches(js, ts)
    js = je.run(js, steps)
    te.run(ts, steps)
    assert not mismatches(js, ts)
    jo, to = je.observe(js), te.observe(ts)
    assert list(to) == list(jo)
    for k, v in jo.items():
        np.testing.assert_array_equal(to[k], v, err_msg=k)
    assert not to["active"].any()
    assert to["bug"].any(), "no world reached the family's bug"


@pytest.mark.parametrize("family", ["guided_pair", "paxos"])
def test_refill_with_a_device_schedule_matches_jax_and_independent_inits(
        family):
    """The guided sweep's refill: a (W, F, 4) device tensor of children.
    Each refilled slot is bitwise an independent init of its seed under
    its own schedule (tests/test_search.py's gate), and the whole state
    equals JAX's refill with a device array."""
    je, te = engines(family)
    tmpl = CASES[family][3]
    w = 16
    js = je.run_steps(je.init(np.arange(w), faults=tmpl), 30)
    ts = te.run_steps(te.init(np.arange(w), faults=tmpl), 30)
    kids = per_slot_schedules(family, w)
    mask = np.arange(w) % 3 != 1
    new = np.arange(500, 500 + w)
    js = je.refill(js, mask, new, faults=jnp.asarray(kids))
    ts = te.refill(ts, mask, new, faults=torch.from_numpy(kids))
    assert not mismatches(js, ts)
    fresh = te.init(new, faults=kids)
    for name, a, b in zip(tree_paths(ts), tree_leaves(ts),
                          tree_leaves(fresh)):
        np.testing.assert_array_equal(a.numpy()[mask], b.numpy()[mask],
                                      err_msg=name)
    js = je.run_steps(js, 40)
    te.run_steps(ts, 40)
    assert not mismatches(js, ts)
    with pytest.raises(ValueError, match="per-slot"):
        te.refill(ts, mask, new, faults=torch.from_numpy(tmpl))
    with pytest.raises(ValueError, match=r"leading dim 5.*16 slots"):
        te.refill(ts, mask, new, faults=torch.from_numpy(kids[:5]))


@pytest.mark.parametrize("family", ["guided_pair", "paxos"])
def test_step_matches_the_pallas_kernel(family):
    """The port's steps against the JAX package's Pallas kernel
    (``EngineConfig(pallas=True)`` in interpret mode), at W = 8 under
    per-slot schedules: every leaf after each chunk of steps."""
    ja, ta, ck, _tmpl, _s = CASES[family]
    ck = dict(ck, stop_on_bug=False)
    je = J.DeviceEngine(ja(), J.EngineConfig(**dict(ck, pallas=True)))
    te = T.DeviceEngine(ta(), T.EngineConfig(**ck), device="cpu")
    seeds = np.arange(8)
    faults = per_slot_schedules(family, 8)
    js = je.init(seeds, faults=faults)
    ts = te.init(seeds, faults=faults)
    chunks = 3 if family == "paxos" else 1
    for _ in range(chunks):
        js = je.run_steps(js, 50)
        te.run_steps(ts, 50)
        assert not mismatches(js, ts)
    # The whole run is covered: every world ran to its end.
    assert not np.asarray(js.active).any()
    assert int(np.asarray(js.steps).min()) >= (100 if family == "paxos"
                                               else 8)


def test_kernel_records_of_the_new_families():
    """One record per family: Paxos's lanes in JAX's sorted order and its
    static parameters; the two pair families on one policy, up to 12
    nodes with a two-row outbox, told apart by the beacon flag."""
    for family, fid, params in (
            ("paxos", 3, [3, 150_000, 400_000, 3, 40_000, 30_000, 1,
                          5_000]),
            ("guided_pair", 4, [1, 2, 1] + [0] * 5),
            ("pair_restart", 4, [1, 2, 0] + [0] * 5)):
        _je, te = engines(family)
        fam = step_kernel.family_of(te.actor)
        assert fam.name == family and fam.id == fid
        assert fam.lanes == tuple(
            (name[len("astate."):], dtype) for name, dtype, _
            in te.state_layout() if name.startswith("astate."))
        p = step_kernel.kernel_params(te)
        cfg = te.cfg
        assert p[:6] == [cfg.n_nodes, cfg.queue_cap, cfg.payload_words,
                         fid, cfg.t_limit_us, int(cfg.stop_on_bug)]
        assert p[6:] == params
    _je, te = engines("guided_pair")
    assert step_kernel.family_of(te.actor).max_n == 12
    assert step_kernel.engine_plan(te).block == 128
    for over, err in ((dict(outbox_cap=3), "outbox_cap == 2"),):
        bad = T.DeviceEngine(te.actor, dataclasses.replace(te.cfg, **over),
                             device="cpu")
        with pytest.raises((ValueError, NotImplementedError), match=err):
            step_kernel.kernel_params(bad)
    # The wide lane profile: the same parameters, int32 lanes.
    wide = T.DeviceEngine(te.actor, dataclasses.replace(te.cfg,
                                                        packed=False),
                          device="cpu")
    assert step_kernel.kernel_params(wide) == step_kernel.kernel_params(te)
    assert step_kernel.family_lanes(step_kernel.family_of(te.actor),
                                    False) == (("restarts", torch.int32),)
    # Paxos's five-word payload: element-wise payload rows.
    _je, te = engines("paxos")
    assert step_kernel.engine_plan(te).pay_unit == 2


def test_family_registry_has_the_pair_families_of_jax():
    tf, jf = tfamilies.actor_families(), j_families()
    for name in ("pair_restart", "guided_pair"):
        assert [c.__name__ for c in tf[name].load()] == \
            [c.__name__ for c in jf[name].load()]
        (ta, tcfg), (ja, jcfg) = tf[name].conformance(), \
            jf[name].conformance()
        assert vars(tcfg) == vars(jcfg)
        assert ta.num_kinds == ja.num_kinds
        assert getattr(ta, "kind_names", None) == \
            getattr(ja, "kind_names", None)
        assert ta.invariant_id == ja.invariant_id
    np.testing.assert_array_equal(
        tfamily.family_schedule(6, tfamily.GuidedPairConfig(n=12)),
        jfamily.family_schedule(6, jfamily.GuidedPairConfig(n=12)))
    np.testing.assert_array_equal(tsyn.pair_schedule(), jsyn.pair_schedule())
    with pytest.raises(ValueError, match="distinct"):
        tsyn.pair_schedule(4, need=(1, 1))
