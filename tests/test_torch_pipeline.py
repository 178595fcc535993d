"""The port's pipelined sweep (``sweep(pipeline=True)``, the default) and
its device-side pieces against the JAX package on the CPU, bitwise.

The counterpart of tests/test_sweep_pipeline.py: the port's superstep loop
(``DeviceEngine.superstep``, dispatch-ahead, the adaptive K, the epoch
guard, the deferred retire pulls) returns every ``SweepResult`` field of
JAX's ``sweep(..., mesh=seed_mesh(n_devices=1), pipeline=True)``: raft in
plain, compacted, recycled, stop-on-first-bug and ``max_steps``-bound
modes, with metrics, coverage and the ring, tpc, pb and Paxos, and the
guided pair hunt with its ``SearchReport``; the same counted ``_fetch``
calls; the binding ``max_steps`` budget and the zero-step budget; the
``loop_stats`` schema of both host loops. Then the device pieces: a
superstep whose entry condition is false changes no bit, ``min_one`` runs
exactly one chunk, and ``DeviceEngine.run`` stops at exactly
``max_steps`` with its gated launches counted.

Tolerance: none — every operation is integer, or an exactly rounded
float32 product.
"""
import importlib

import numpy as np
import pytest
import torch

import madsim_tpu.engine as J
import madsim_tpu_torch.engine as T
from madsim_tpu.engine.families import actor_families as j_families
from madsim_tpu.parallel.mesh import seed_mesh
from madsim_tpu_torch.engine import golden
from madsim_tpu_torch.engine.core import RUN_WINDOWS, tree_leaves
from madsim_tpu_torch.engine.families import family
tsweep = importlib.import_module("madsim_tpu_torch.parallel.sweep")
from test_torch_sweep import FAULTS, SEEDS, assert_results_equal, engines

jsweep = importlib.import_module("madsim_tpu.parallel.sweep")
MESH1 = seed_mesh(n_devices=1)

# name: sweep keyword arguments (with chunk_steps=64 and the schedule).
MODES = {
    "plain": dict(max_steps=3_000),
    "compact": dict(max_steps=3_000, compact=True),
    "recycled": dict(max_steps=3_000, recycle=True, batch_worlds=8),
    "recycled_first_bug": dict(max_steps=3_000, recycle=True,
                               batch_worlds=8, stop_on_first_bug=True),
    "max_steps_bound": dict(max_steps=320, recycle=True, batch_worlds=8),
}


@pytest.fixture(scope="module")
def off_engines():
    return engines()


@pytest.fixture(scope="module")
def on_engines():
    return engines(metrics=True, blackbox=16)


def both(je, te, seeds=SEEDS, count=False, **kw):
    """JAX's and the port's pipelined sweep, and each one's ``_fetch``
    count."""
    counts = {"jax": 0, "torch": 0}
    with pytest.MonkeyPatch.context() as mp:
        for mod, name in ((jsweep, "jax"), (tsweep, "torch")):
            def fetch(tree, real=mod._fetch, name=name):
                counts[name] += 1
                return real(tree)

            mp.setattr(mod, "_fetch", fetch)
        jr = jsweep.sweep(None, je.cfg, seeds, engine=je, mesh=MESH1,
                          pipeline=True, **kw)
        tr = tsweep.sweep(None, te.cfg, seeds, engine=te, pipeline=True,
                          **kw)
    return jr, tr, counts


@pytest.mark.parametrize("mode", sorted(MODES))
def test_pipelined_sweep_matches_jax(off_engines, mode):
    jr, tr, counts = both(*off_engines, chunk_steps=64, faults=FAULTS,
                          **MODES[mode])
    assert_results_equal(jr, tr)
    assert tr.loop_stats["pipelined"] and not tr.loop_stats["fused"]
    # One _fetch per superstep read, one per retiring tail, the final one.
    assert counts["torch"] == counts["jax"] == (
        tr.loop_stats["scalar_fetches"] + tr.loop_stats["retire_fetches"]
        + 1)
    if mode != "max_steps_bound":
        assert tr.failing_seeds, "the hunt found no bug"


def test_pipelined_sweep_with_coverage_and_ring_matches_jax(on_engines):
    jr, tr, counts = both(*on_engines, chunk_steps=64, faults=FAULTS,
                          max_steps=3_000, recycle=True, batch_worlds=8,
                          coverage_buckets=64)
    assert_results_equal(jr, tr)
    assert counts["torch"] == counts["jax"]
    assert tr.coverage.novelty_curve.size == tr.n_active_history.size


def family_engines(name, **over):
    fam, ak, ck, faults, _ms = (golden.FAMILY_CONFIGS.get(name)
                                or golden.SEARCH_CONFIGS[name])
    ck = dict(ck, **over)
    (jcls, jccls), (tcls, tccls) = (j_families()[fam].load(),
                                    family(fam).load())
    return (J.DeviceEngine(jcls(jccls(**ak)), J.EngineConfig(**ck)),
            T.DeviceEngine(tcls(tccls(**ak)), T.EngineConfig(**ck),
                           device="cpu"),
            None if faults is None else np.asarray(faults, np.int32))


@pytest.mark.parametrize("name", ["tpc_crosscheck", "pb_hunt",
                                  "paxos_hunt"])
def test_pipelined_family_sweeps_match_jax(name):
    je, te, faults = family_engines(name)
    jr, tr, counts = both(je, te, seeds=np.arange(16), faults=faults,
                          chunk_steps=64, max_steps=2_000, recycle=True,
                          batch_worlds=8)
    assert_results_equal(jr, tr)
    assert counts["torch"] == counts["jax"]


def test_pipelined_guided_pair_hunt_matches_jax():
    from madsim_tpu.search import SearchConfig as JSearchConfig
    from madsim_tpu.search import hunts as jhunts
    from madsim_tpu_torch.search import hunts as thunts
    from test_torch_search import assert_search_results_equal

    jh, th = jhunts.pair_hunt(), thunts.pair_hunt()
    je, te = J.DeviceEngine(jh.actor, jh.cfg), T.DeviceEngine(
        th.actor, th.cfg, device="cpu")
    scfg = th.search(True)
    jscfg = JSearchConfig(**{f: getattr(scfg, f)
                             for f in scfg.__dataclass_fields__})
    kw = dict(th.sweep_kw, faults=th.template)
    jr = jsweep.sweep(None, je.cfg, np.arange(80), engine=je, mesh=MESH1,
                      pipeline=True, search=jscfg, **kw)
    tr = tsweep.sweep(None, te.cfg, np.arange(80), engine=te,
                      pipeline=True, search=scfg, **kw)
    assert_search_results_equal(jr, tr)
    assert tr.failing_seeds == [72]


@pytest.fixture(scope="module")
def clean_engines():
    """Non-retiring raft (no bug, long horizon): occupancy stays full, so
    a max_steps budget binds."""
    rk = dict(n=3, n_proposals=1)
    ck = dict(n_nodes=3, outbox_cap=4, t_limit_us=3_000_000)
    return (J.DeviceEngine(J.RaftActor(J.RaftDeviceConfig(**rk)),
                           J.EngineConfig(**ck)),
            T.DeviceEngine(T.RaftActor(T.RaftDeviceConfig(**rk)),
                           T.EngineConfig(**ck), device="cpu"))


@pytest.mark.parametrize("c_max", [5])
def test_binding_max_steps_respects_chunk_budget(clean_engines, c_max):
    """The dispatch-ahead budget reserves the planned chunks of the
    superstep in flight: the pipelined loop runs exactly the serial
    loop's chunk budget, as JAX's does."""
    je, te = clean_engines
    seeds = np.arange(12)
    jr, tr, _ = both(je, te, seeds=seeds, chunk_steps=64,
                     max_steps=64 * c_max)
    assert_results_equal(jr, tr)
    assert tr.loop_stats["chunks"] == c_max
    assert tr.steps_run == 64 * c_max
    assert (tr.n_active_history == 12).all()


def test_zero_step_budget_runs_no_chunks(clean_engines):
    je, te = clean_engines
    jr, tr, _ = both(je, te, seeds=np.arange(8), chunk_steps=64,
                     max_steps=0)
    assert_results_equal(jr, tr)
    assert tr.steps_run == 0 and tr.loop_stats["chunks"] == 0
    assert tr.loop_stats["dispatches"] == 0
    assert tr.n_active_history.size == 0


@pytest.mark.parametrize("pipeline", [True, False])
def test_loop_stats_schema_both_paths(off_engines, pipeline):
    te = off_engines[1]
    res = tsweep.sweep(None, te.cfg, SEEDS, engine=te, chunk_steps=64,
                       max_steps=1_024, pipeline=pipeline)
    ls = res.loop_stats
    documented = {"device_wait_s", "host_decision_s", "scalar_fetches",
                  "retire_fetches", "dispatch_depth", "dispatches_per_seed",
                  "seeds_per_dispatch", "epochs_on_device", "fused",
                  "pipelined", "superstep_max", "chunk_steps", "chunks",
                  "dispatches", "chunks_per_dispatch", "dispatch_s",
                  "retire_wait_s", "loop_wall_s", "flag_reads"}
    assert documented == set(ls), sorted(ls)
    assert ls["pipelined"] is pipeline and ls["fused"] is False
    assert ls["epochs_on_device"] == 0
    assert ls["superstep_max"] == (16 if pipeline else 1)
    assert ls["dispatch_depth"] == (1 if pipeline else 0)
    for key in ("device_wait_s", "host_decision_s", "dispatch_s",
                "retire_wait_s", "loop_wall_s"):
        assert isinstance(ls[key], float) and ls[key] >= 0.0, key
    for key in ("scalar_fetches", "retire_fetches", "chunks",
                "dispatches"):
        assert isinstance(ls[key], int) and ls[key] >= 1 - (
            key == "retire_fetches"), key
    # Each superstep's chunks push a stop flag that the host reads; the
    # serial loop reads none.
    assert (ls["flag_reads"] >= ls["dispatches"] if pipeline
            else ls["flag_reads"] == 0)
    if pipeline:
        # Supersteps fold several chunks into one host decision.
        assert ls["chunks_per_dispatch"] >= 1


def _family_engine(name):
    fam, ak, ck, faults, _ms = (golden.FAMILY_CONFIGS.get(name)
                                or golden.SEARCH_CONFIGS.get(name)
                                or golden.wide_config(name))
    if fam == "raft":
        actor = T.RaftActor(T.RaftDeviceConfig(**ak))
    else:
        cls, ccls = family(fam).load()
        actor = cls(ccls(**ak))
    return (T.DeviceEngine(actor, T.EngineConfig(**ck), device="cpu"),
            None if faults is None else np.asarray(faults, np.int32))


@pytest.mark.parametrize("name", ["hunt_faults", "tpc_crosscheck",
                                  "pb_hunt", "paxos_hunt", "guided_pair"])
def test_superstep_gates_each_family(name):
    """Per family: a superstep with a threshold at the active count runs
    no chunk and changes no bit; under ``min_one`` it runs one chunk,
    bitwise ``run_steps`` of a chunk; with no threshold it runs every
    chunk it may, its history the active counts."""
    eng, faults = _family_engine(name)
    seeds = np.arange(8)
    state = eng.init(seeds, faults=faults)
    n = int(state.active.sum())
    before = [x.clone() for x in tree_leaves(state)]
    out = eng.superstep(state, n, False, 3, chunk_steps=8, k_max=4)
    assert int(out[3]) == 0 and (out[4].numpy() == -1).all()
    assert all(torch.equal(a, b) for a, b in zip(before, tree_leaves(state)))
    out = eng.superstep(state, n, False, 3, chunk_steps=8, k_max=4,
                        min_one=True)
    assert int(out[3]) == 1
    ref = eng.init(seeds, faults=faults)
    eng.run_steps(ref, 8)
    assert all(torch.equal(a, b)
               for a, b in zip(tree_leaves(ref), tree_leaves(state)))
    out = eng.superstep(state, -1, False, 3, chunk_steps=8, k_max=4)
    eng.run_steps(ref, 24)
    assert int(out[3]) == 3 and int(out[4][3]) == -1
    assert int(out[4][2]) == int(ref.active.sum())
    assert all(torch.equal(a, b)
               for a, b in zip(tree_leaves(ref), tree_leaves(state)))


def test_superstep_pass_through_and_min_one(off_engines):
    """A superstep whose entry condition is false changes no bit (the
    property dispatch-ahead rests on); ``min_one`` runs exactly one chunk
    whatever the condition."""
    te = off_engines[1]
    state = te.init(SEEDS, faults=FAULTS)
    te.run_steps(state, 64)
    before = [x.clone() for x in tree_leaves(state)]
    n = int(state.active.sum())
    _s, _b, n_act, k_done, hist = te.superstep(
        state, n, False, 4, chunk_steps=64, k_max=16)
    assert int(k_done) == 0 and int(n_act) == n
    assert (hist.numpy() == -1).all()
    assert all(torch.equal(a, b) for a, b in zip(before, tree_leaves(state)))
    _s, _b, _n, k_done, hist = te.superstep(
        state, n, False, 4, chunk_steps=64, k_max=16, min_one=True)
    assert int(k_done) == 1 and int(hist[0]) == int(state.active.sum())
    assert (hist.numpy()[1:] == -1).all()
    ref = te.init(SEEDS, faults=FAULTS)
    te.run_steps(ref, 128)
    assert all(torch.equal(a, b)
               for a, b in zip(tree_leaves(ref), tree_leaves(state)))


def test_run_stops_at_max_steps_and_counts_gated_launches():
    """``DeviceEngine.run`` equals JAX's ``run`` at a budget that binds
    mid-window and at one past the last freeze; every launch is counted,
    the ones past the last freeze as no-ops."""
    rk, ck, _faults, max_steps = golden.CONFIGS["headline"]
    je = J.DeviceEngine(J.RaftActor(J.RaftDeviceConfig(**rk)),
                        J.EngineConfig(**ck))
    te = T.DeviceEngine(T.RaftActor(T.RaftDeviceConfig(**rk)),
                        T.EngineConfig(**ck), device="cpu")
    seeds = np.arange(16)
    for budget in (37, max_steps):
        js = je.run(je.init(seeds), budget)
        ts = te.run(te.init(seeds), budget)
        for k, v in je.observe(js).items():
            np.testing.assert_array_equal(te.observe(ts)[k], v, err_msg=k)
        stats = te.last_run_stats()
        assert stats["launches"] <= budget
        if budget == 37:
            assert stats == {"launches": 37, "noops": 0}
    # The batch froze before the budget: the run stopped after the window
    # of the last freeze, and every launch after that freeze was a no-op.
    assert not te.observe(ts)["active"].any()
    assert stats["launches"] - stats["noops"] == int(
        te.observe(ts)["steps"].max())
    assert 0 <= stats["noops"] < RUN_WINDOWS[0]
    assert stats["launches"] < max_steps
