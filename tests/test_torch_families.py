"""The compiled protocol families in the port — two-phase commit,
primary-backup and Paxos (madsim_tpu_torch.actorc.families,
madsim_tpu_torch.engine.{tpc,pb}_actor) — against the JAX package, on the
CPU, bitwise:

- ``init`` and ``run`` on every WorldState leaf, with faults and loss, with
  the metrics block and the flight recorder off and on; ``observe()``
  with its derived entries; ``trace()``;
- a recycled tpc sweep against JAX's serial sweep, every SweepResult
  field;
- the port's tpc step against the JAX package's Pallas kernel itself
  (``EngineConfig(pallas=True)``, interpret mode on the CPU);
- the JAX-derived digests ``chip_smoke.py`` holds the card to
  (``engine/golden.py`` GOLDEN_FAMILIES), recomputed from JAX;
- the family registry.

Configurations: the families' own bug hunts (tests/test_tpc_actor.py,
tests/test_pb_actor.py, the Paxos hunt template of actorc/families) at
W = 16 and bench.py's crosscheck legs for the digests. Tolerance: none —
every operation is integer, or an exactly rounded float32 product.
"""
import importlib

import jax
import numpy as np
import pytest

import madsim_tpu.engine as J
import madsim_tpu_torch.engine as T
from madsim_tpu.actorc.families import paxos as jpaxos
from madsim_tpu.engine.families import actor_families as j_families
from madsim_tpu.parallel.mesh import seed_mesh
from madsim_tpu_torch.actorc.families import paxos as tpaxos
from madsim_tpu_torch.engine import families as tfamilies
from madsim_tpu_torch.engine import golden
from madsim_tpu_torch.engine.core import tree_paths
tsweep_mod = importlib.import_module("madsim_tpu_torch.parallel.sweep")
from test_torch_sweep import assert_results_equal

jsweep_mod = importlib.import_module("madsim_tpu.parallel.sweep")
SEEDS = np.arange(16)


def _paxos_faults():
    """The guided hunt's template, plus two restarts inside the amnesia
    window of the contended decree (tests/test_actorc.py), so the
    forgetful acceptor splits a decree in some worlds."""
    extra = np.array([[80_000, J.FAULT_RESTART, 0, 0],
                      [83_000, J.FAULT_RESTART, 2, 0]], np.int32)
    return np.concatenate([jpaxos.hunt_template(jpaxos.PaxosConfig()),
                           extra])


# family: (JAX actor, port actor, EngineConfig kwargs, fault rows,
# max_steps). stop_on_bug is off so the worlds run on past their bug.
CASES = {
    "tpc": (lambda: J.TPCActor(J.TPCDeviceConfig(
                n=4, n_txns=4, buggy_presumed_commit=True)),
            lambda: T.TPCActor(T.TPCDeviceConfig(
                n=4, n_txns=4, buggy_presumed_commit=True)),
            dict(n_nodes=4, outbox_cap=5, queue_cap=64,
                 t_limit_us=1_500_000, loss_rate=0.1, stop_on_bug=False),
            np.array([[200_000, J.FAULT_KILL, 0, 0],
                      [500_000, J.FAULT_RESTART, 0, 0],
                      [100_000, J.FAULT_CLOG_LINK, 0, 2],
                      [300_000, J.FAULT_UNCLOG_LINK, 0, 2],
                      [150_000, J.FAULT_PAUSE, 3, 0],
                      [260_000, J.FAULT_RESUME, 3, 0]], np.int32),
            3_000),
    "pb": (lambda: J.PBActor(J.PBDeviceConfig(
               n=3, n_writes=4, buggy_commit_early=True)),
           lambda: T.PBActor(T.PBDeviceConfig(
               n=3, n_writes=4, buggy_commit_early=True)),
           dict(n_nodes=3, outbox_cap=4, queue_cap=48,
                t_limit_us=2_000_000, loss_rate=0.3, stop_on_bug=False),
           np.array([[130_000, J.FAULT_KILL, 0, 0],
                     [400_000, J.FAULT_RESTART, 0, 0],
                     [600_000, J.FAULT_SET_LOSS, 50_000, 0]], np.int32),
           3_000),
    "paxos": (lambda: jpaxos.PaxosActor(jpaxos.PaxosConfig(
                  buggy_forgetful_acceptor=True)),
              lambda: tpaxos.PaxosActor(tpaxos.PaxosConfig(
                  buggy_forgetful_acceptor=True)),
              dict(vars(jpaxos.engine_config(jpaxos.PaxosConfig())),
                   stop_on_bug=False),
              _paxos_faults(), 3_000),
}
#: The derived observe() entries of each family, beside its counters.
DERIVED = {"tpc": {"blocked"},
           "pb": {"max_view", "committed_max", "min_commit"},
           "paxos": {"slots_decided", "max_ballot"}}
LANES = {"off": {}, "on": dict(metrics=True, blackbox=16)}


def engines(family, **over):
    ja, ta, ck, _faults, _steps = CASES[family]
    ck = dict(ck, **over)
    return (J.DeviceEngine(ja(), J.EngineConfig(**ck)),
            T.DeviceEngine(ta(), T.EngineConfig(**ck), device="cpu"))


def mismatches(jstate, tstate):
    """Names of the leaves that differ (value or dtype)."""
    jl = [np.asarray(x) for x in jax.tree.leaves(jstate)]
    tl = T.state_to_numpy(tstate)
    assert len(jl) == len(tl)
    return [p for p, a, b in zip(tree_paths(tstate), jl, tl)
            if a.dtype != b.dtype or not np.array_equal(a, b)]


@pytest.fixture(scope="module")
def runs():
    """Each family's run in both packages, lanes off and on (the JAX
    compiles dominate this file's time, so each runs once)."""
    out = {}

    def get(family, lanes):
        if (family, lanes) not in out:
            je, te = engines(family, **LANES[lanes])
            faults, steps = CASES[family][3], CASES[family][4]
            js = je.run(je.init(SEEDS, faults=faults), steps)
            ts0 = te.init(SEEDS, faults=faults)
            ts = te.run(ts0, steps)
            assert ts is ts0  # run updates the state in place
            out[family, lanes] = (je, js, te, ts)
        return out[family, lanes]
    return get


@pytest.mark.parametrize("family", sorted(CASES))
def test_init_matches_jax(family):
    je, te = engines(family, **LANES["on"])
    faults = CASES[family][3]
    seeds = SEEDS + 2**33  # wider than 32 bits
    assert not mismatches(je.init(seeds, faults=faults),
                          te.init(seeds, faults=faults))


@pytest.mark.parametrize("lanes", sorted(LANES))
@pytest.mark.parametrize("family", sorted(CASES))
def test_run_and_observe_match_jax(runs, family, lanes):
    """Every leaf after init + run, and observe() with its derived
    entries (and the m_*/bb_* ones with the lanes on)."""
    je, js, te, ts = runs(family, lanes)
    assert not mismatches(js, ts)
    jo, to = je.observe(js), te.observe(ts)
    assert sorted(jo) == sorted(to)
    assert DERIVED[family] <= set(to)
    for k in jo:
        assert jo[k].dtype == to[k].dtype, k
        np.testing.assert_array_equal(to[k], jo[k], err_msg=k)
    assert not to["active"].any()
    # The paths the configuration exists for ran: bugs, drops, restarts.
    assert to["bug"].any() and not to["bug"].all()
    assert to["dropped"].any()
    if lanes == "on":
        assert to["m_fault_hist"][:, J.FAULT_RESTART].any()
        assert to["m_kind_hist"].shape[1] == te.actor.num_kinds


@pytest.mark.parametrize("family", sorted(CASES))
def test_lanes_leave_every_other_leaf_alone(runs, family):
    """The metrics block and the ring change no other leaf of the port's
    run."""
    *_, off = runs(family, "off")
    *_, on = runs(family, "on")
    on_leaves = dict(zip(tree_paths(on), T.state_to_numpy(on)))
    for path, x in zip(tree_paths(off), T.state_to_numpy(off)):
        np.testing.assert_array_equal(on_leaves[path], x, err_msg=path)


@pytest.mark.parametrize("family", sorted(CASES))
def test_trace_matches_jax(runs, family):
    """trace() of a failing seed: the same records, kind names included."""
    je, js, te, _ts = runs(family, "off")
    seed = int(SEEDS[np.flatnonzero(np.asarray(js.bug))[0]])
    faults, steps = CASES[family][3], CASES[family][4]
    jt = je.trace(seed, max_steps=steps, faults=faults)
    tt = te.trace(seed, max_steps=steps, faults=faults)
    assert tt == jt
    assert any(e.get("bug_raised") for e in tt)
    assert {e["kind"] for e in tt} & set(te.actor.kind_names)


def test_tpc_sweep_matches_jax_serial_sweep():
    """A recycled tpc sweep with the metrics block and the ring: every
    SweepResult field equal to JAX's serial sweep."""
    je, te = engines("tpc", **LANES["on"])
    kw = dict(chunk_steps=64, max_steps=3_000, recycle=True, batch_worlds=8,
              faults=CASES["tpc"][3])
    jr = jsweep_mod.sweep(None, je.cfg, SEEDS, engine=je,
                          mesh=seed_mesh(n_devices=1), pipeline=False, **kw)
    tr = tsweep_mod.sweep(None, te.cfg, SEEDS, engine=te, pipeline=False,
                          **kw)
    assert_results_equal(jr, tr)
    assert tr.failing_seeds and tr.loop_stats["chunks"] > 1
    for seed in tr.failing_seeds[:2]:
        assert tr.blackbox(seed) == jr.blackbox(seed)


def test_tpc_step_matches_the_pallas_kernel():
    """The port's tpc steps against the JAX package's Pallas kernel
    (``EngineConfig(pallas=True)``, run in interpret mode on the CPU as
    tests/test_pallas_step.py runs it), at W=8: every leaf after each
    chunk of steps."""
    tcfg = dict(n=4, n_txns=8, buggy_presumed_commit=True)
    ck = dict(CASES["tpc"][2], t_limit_us=2_000_000)
    faults = CASES["tpc"][3][2:]  # the clogged link and the paused node
    je = J.DeviceEngine(J.TPCActor(J.TPCDeviceConfig(**tcfg)),
                        J.EngineConfig(**ck, pallas=True))
    te = T.DeviceEngine(T.TPCActor(T.TPCDeviceConfig(**tcfg)),
                        T.EngineConfig(**ck), device="cpu")
    seeds = np.arange(8)
    js = je.init(seeds, faults=faults)
    ts = te.init(seeds, faults=faults)
    for _ in range(4):
        js = je.run_steps(js, 50)
        te.run_steps(ts, 50)
        assert not mismatches(js, ts)
    assert int(np.asarray(js.steps).min()) >= 60


@pytest.mark.parametrize("name", sorted(golden.FAMILY_CONFIGS))
def test_family_golden_digests_recomputed_from_jax(name):
    """The constants in golden.GOLDEN_FAMILIES are the JAX package's."""
    fam, ak, ck, faults, max_steps = golden.FAMILY_CONFIGS[name]
    acls, ccls = j_families()[fam].load()
    je = J.DeviceEngine(acls(ccls(**ak)), J.EngineConfig(**ck))
    fa = None if faults is None else np.asarray(faults, np.int32)
    obs = je.observe(je.run(je.init(golden.SEEDS, faults=fa), max_steps))
    assert not obs["active"].any() and not obs["overflow"].any()
    assert obs["bug"].any() == (name != "pb_crosscheck")
    assert golden.observe_digest(obs) == golden.GOLDEN_FAMILIES[name]


def test_family_registry_matches_jax():
    """The port's registry holds every family of the JAX registry — raft,
    pb, tpc, paxos and the guided search's pair_restart and guided_pair —
    with its conformance shapes."""
    tf = tfamilies.actor_families()
    jf = j_families()
    assert sorted(tf) == sorted(jf) == ["guided_pair", "pair_restart",
                                        "paxos", "pb", "raft", "tpc"]
    for name, fam in tf.items():
        assert [c.__name__ for c in fam.load()] == \
            [c.__name__ for c in jf[name].load()]
        (ta, tcfg), (ja, jcfg) = fam.conformance(), jf[name].conformance()
        assert vars(tcfg) == vars(jcfg)
        assert ta.num_kinds == ja.num_kinds
        assert getattr(ta, "kind_names", None) == \
            getattr(ja, "kind_names", None)
    assert tfamilies.family("no_such_family") is None
