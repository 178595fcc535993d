"""The port's serial sweep (madsim_tpu_torch.parallel.sweep) and
``DeviceEngine.refill`` against the JAX package on the CPU, bitwise: every
``SweepResult`` field of plain, compacted, recycled (with and without
``stop_on_first_bug``, and stopped before its first refill) and metrics-on
sweeps with coverage and the flight recorder, against JAX's
``sweep(..., mesh=seed_mesh(n_devices=1), pipeline=False)``; the count of
device pulls; the knobs not ported; and the JAX-derived sweep digest that
``chip_smoke.py`` holds the GPU to.

The configuration is tests/test_obs.py's Raft hunt (kill/restart
schedule). Tolerance: none — every operation is integer, or an exactly
rounded float32 product.
"""
import importlib

import jax
import numpy as np
import pytest
import torch

import madsim_tpu.engine as J
import madsim_tpu_torch.engine as T
from madsim_tpu.parallel.mesh import seed_mesh
from madsim_tpu_torch.engine import golden
from madsim_tpu_torch.engine.core import tree_leaves, tree_paths
tsweep_mod = importlib.import_module("madsim_tpu_torch.parallel.sweep")
from madsim_tpu_torch.triage import TriageError

# The module (madsim_tpu.parallel exports a function of the same name).
jsweep_mod = importlib.import_module("madsim_tpu.parallel.sweep")
RK = dict(n=3, n_proposals=2, buggy_double_vote=True)
CK = dict(n_nodes=3, outbox_cap=4, queue_cap=64, t_limit_us=1_500_000)
FAULTS = np.array([[300_000, J.FAULT_KILL, 0, 0],
                   [700_000, J.FAULT_RESTART, 0, 0]], np.int32)
SEEDS = np.arange(16)
MESH1 = seed_mesh(n_devices=1)

# name: sweep keyword arguments (with chunk_steps=64 and the schedule).
MODES = {
    "plain": dict(max_steps=3_000),
    "compact": dict(max_steps=3_000, compact=True),
    "recycled": dict(max_steps=3_000, recycle=True, batch_worlds=8),
    "recycled_first_bug": dict(max_steps=3_000, recycle=True,
                               batch_worlds=8, stop_on_first_bug=True),
    "recycled_early_exit": dict(max_steps=64, recycle=True, batch_worlds=8),
}
LOOP_COUNTS = ("chunks", "dispatches", "scalar_fetches", "retire_fetches",
               "pipelined", "fused", "superstep_max", "chunk_steps",
               "epochs_on_device", "dispatch_depth")


def engines(**over):
    ck = dict(CK, **over)
    return (J.DeviceEngine(J.RaftActor(J.RaftDeviceConfig(**RK)),
                           J.EngineConfig(**ck)),
            T.DeviceEngine(T.RaftActor(T.RaftDeviceConfig(**RK)),
                           T.EngineConfig(**ck), device="cpu"))


@pytest.fixture(scope="module")
def off_engines():
    return engines()


@pytest.fixture(scope="module")
def on_engines():
    """Metrics on (so coverage too) and a 16-deep ring."""
    return engines(metrics=True, blackbox=16)


@pytest.fixture(scope="module")
def on_sweeps(on_engines):
    """The recycled metrics-on sweep of both packages with a 64-bucket
    ledger, and how often each called its ``_fetch``."""
    counts = {"jax": 0, "torch": 0}
    with pytest.MonkeyPatch.context() as mp:
        for mod, name in ((jsweep_mod, "jax"), (tsweep_mod, "torch")):
            def fetch(tree, real=mod._fetch, name=name):
                counts[name] += 1
                return real(tree)

            mp.setattr(mod, "_fetch", fetch)
        jr, tr = both(*on_engines, max_steps=3_000, recycle=True,
                      batch_worlds=8, coverage_buckets=64)
    return jr, tr, counts


def both(je, te, **kw):
    kw = dict(chunk_steps=64, faults=FAULTS, **kw)
    jr = jsweep_mod.sweep(None, je.cfg, SEEDS, engine=je, mesh=MESH1,
                          pipeline=False, **kw)
    tr = tsweep_mod.sweep(None, te.cfg, SEEDS, engine=te, pipeline=False,
                          **kw)
    return jr, tr


def assert_results_equal(jr, tr):
    np.testing.assert_array_equal(tr.seeds, jr.seeds)
    np.testing.assert_array_equal(tr.bug, jr.bug)
    # The same keys in the same order (jax.device_get sorts a dict): the
    # order decides ties in summary()'s drop-cause ranking.
    assert list(tr.observations) == list(jr.observations)
    for k, v in jr.observations.items():
        assert tr.observations[k].dtype == v.dtype, k
        np.testing.assert_array_equal(tr.observations[k], v, err_msg=k)
    assert tr.steps_run == jr.steps_run
    assert tr.n_devices == jr.n_devices
    for f in ("n_active_history", "n_active_chunks"):
        a, b = getattr(tr, f), getattr(jr, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert tr.world_utilization == jr.world_utilization
    assert tr.failing_seeds == jr.failing_seeds
    assert tr.faults_sha256 == jr.faults_sha256
    assert tr.summary() == jr.summary()
    assert tr.repro_banner() == jr.repro_banner()
    assert (tr.metrics is None) == (jr.metrics is None)
    if tr.metrics is not None:
        assert list(tr.metrics["aggregate"].items()) == \
            list(jr.metrics["aggregate"].items())
    # The port's loop_stats are JAX's and the device flags its host read.
    assert sorted(tr.loop_stats) == sorted([*jr.loop_stats, "flag_reads"])
    for k in LOOP_COUNTS:
        assert tr.loop_stats[k] == jr.loop_stats[k], k
    assert (tr.coverage is None) == (jr.coverage is None)
    if tr.coverage is not None:
        assert tr.coverage.n_buckets == jr.coverage.n_buckets
        for f in ("hits", "first_seen_seed", "novelty_curve"):
            np.testing.assert_array_equal(getattr(tr.coverage, f),
                                          getattr(jr.coverage, f),
                                          err_msg=f)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_sweep_matches_jax_serial_sweep(off_engines, mode):
    jr, tr = both(*off_engines, **MODES[mode])
    assert_results_equal(jr, tr)
    assert tr.failing_seeds, "the hunt found no bug"
    if mode == "recycled_early_exit":
        # Seeds never admitted read zero.
        assert not tr.observations["steps"][8:].any()
    if mode in ("compact", "recycled"):
        assert tr.loop_stats["retire_fetches"] > 0
    if mode == "recycled_first_bug":
        # The bug stopped the sweep with worlds still active.
        assert tr.n_active_history[-1] > 0


def test_metrics_coverage_and_ring_sweep_matches_jax(on_sweeps):
    """Recycled, metrics on with a 64-bucket coverage ledger and the
    16-deep ring: every field, the decoded rings of failing and passing
    seeds, and the per-seed metrics frames."""
    jr, tr, _counts = on_sweeps
    assert_results_equal(jr, tr)
    assert tr.coverage.n_buckets == 64 and tr.coverage.distinct_behaviors
    for k, v in jr.metrics["per_seed"].items():
        np.testing.assert_array_equal(tr.metrics["per_seed"][k], v,
                                      err_msg=k)
    passing = int(np.flatnonzero(~tr.bug)[0])
    for seed in (None, tr.failing_seeds[-1], passing):
        assert tr.blackbox(seed) == jr.blackbox(seed)
    assert tr.blackbox()[-1].get("bug_raised")
    with pytest.raises(ValueError, match="not part of this sweep"):
        tr.blackbox(10_000)


def test_fetch_count_matches_jax(on_sweeps):
    """Every device pull of the loop goes through _fetch: one per chunk,
    one per retirement and one at the end, as in the JAX loop."""
    _jr, tr, counts = on_sweeps
    ls = tr.loop_stats
    assert ls["retire_fetches"] > 0
    assert counts["torch"] == counts["jax"] == (
        ls["scalar_fetches"] + ls["retire_fetches"] + 1)


def test_refill_matches_jax_shared_and_per_slot(off_engines):
    """refill with the shared (F, 4) schedule and the per-slot (W, F, 4)
    form: every leaf equal to JAX's, and a refilled slot bitwise an
    independent init of its seed."""
    je, te = off_engines
    w = 8
    js = je.run_steps(je.init(np.arange(w), faults=FAULTS), 40)
    ts = te.run_steps(te.init(np.arange(w), faults=FAULTS), 40)
    mask = np.arange(w) % 3 == 1
    new = np.arange(100, 100 + w)
    per_slot = np.broadcast_to(FAULTS, (w,) + FAULTS.shape).copy()
    per_slot[::2, :, 0] += 50_000
    for faults in (FAULTS, per_slot):
        js = je.refill(js, mask, new, faults=faults)
        ts = te.refill(ts, mask, new, faults=faults)
        jl = [np.asarray(x) for x in jax.tree.leaves(js)]
        for name, a, b in zip(tree_paths(ts), jl, tree_leaves(ts)):
            np.testing.assert_array_equal(b.numpy(), a, err_msg=name)
        fresh = te.init(new, faults=faults)
        for name, a, b in zip(tree_paths(ts), tree_leaves(ts),
                              tree_leaves(fresh)):
            np.testing.assert_array_equal(a.numpy()[mask], b.numpy()[mask],
                                          err_msg=name)
        ts = te.run_steps(ts, 10)
        js = je.run_steps(js, 10)
    # The same validation messages as JAX's.
    for bad in (per_slot[:5], per_slot[..., :3]):
        msgs = []
        for eng, st in ((je, js), (te, ts)):
            with pytest.raises(ValueError) as err:
                eng.refill(st, mask, new, faults=bad)
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1]
    # The per-slot schedule as a device tensor (the guided search's
    # refill): equal to JAX's refill with a device array, and a refilled
    # slot bitwise an independent init of its seed under its schedule.
    per_slot[1::2, 1, 0] -= 100_000
    js = je.refill(js, mask, new, faults=jax.numpy.asarray(per_slot))
    ts = te.refill(ts, mask, new, faults=torch.from_numpy(per_slot))
    jl = [np.asarray(x) for x in jax.tree.leaves(js)]
    for name, a, b in zip(tree_paths(ts), jl, tree_leaves(ts)):
        np.testing.assert_array_equal(b.numpy(), a, err_msg=name)
    fresh = te.init(new, faults=per_slot)
    for name, a, b in zip(tree_paths(ts), tree_leaves(ts),
                          tree_leaves(fresh)):
        np.testing.assert_array_equal(a.numpy()[mask], b.numpy()[mask],
                                      err_msg=name)


def test_unported_knobs_raise_naming_their_roadmap_item(off_engines):
    _je, te = off_engines
    # The pipelined and fused loops are ported (tests/test_torch_pipeline.py
    # and tests/test_torch_fused.py), checkpoints
    # (tests/test_torch_sweep_resume.py), the observatory
    # (tests/test_torch_observatory.py) and meshes (tests/
    # test_torch_mesh.py): a one-device mesh of the engine's device is the
    # default, in every loop, and the default mesh needs a CUDA device.
    from madsim_tpu_torch.parallel import mesh as tmesh

    one = tmesh.seed_mesh([torch.device("cpu")])
    for loop in (dict(pipeline=False), dict(pipeline=True),
                 dict(fused=True)):
        kw = dict(chunk_steps=64, max_steps=128, faults=FAULTS, **loop)
        a = tsweep_mod.sweep(None, te.cfg, SEEDS, engine=te, mesh=one, **kw)
        b = tsweep_mod.sweep(None, te.cfg, SEEDS, engine=te, **kw)
        assert a.n_devices == b.n_devices == 1
        for k, v in b.observations.items():
            np.testing.assert_array_equal(a.observations[k], v, err_msg=k)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match=r"devices=\[torch.device"):
            tmesh.seed_mesh()
    # The fused loop refuses a checkpoint with JAX's error.
    with pytest.raises(ValueError, match="fused=True cannot checkpoint"):
        tsweep_mod.sweep(None, te.cfg, SEEDS, engine=te, fused=True,
                         checkpoint_path="ckpt.npz")
    # The fused loop refuses compact=True with JAX's error.
    with pytest.raises(ValueError, match="no shrink path"):
        tsweep_mod.sweep(None, te.cfg, SEEDS, engine=te, fused=True,
                         compact=True)
    # SweepResult.minimize is ported (tests/test_torch_triage.py): a seed
    # that fails with no schedule minimizes to the empty one.
    res = tsweep_mod.sweep(None, te.cfg, SEEDS[:4], engine=te,
                           pipeline=False, chunk_steps=64, max_steps=64)
    mr = res.minimize(chunk_steps=64, max_steps=64)
    assert (mr.seed, mr.final_rows, mr.rounds) == (res.failing_seeds[0], 0,
                                                   2)
    with pytest.raises(TriageError, match="not part of this sweep"):
        res.minimize(seed=99)
    # The JAX package's own argument errors.
    with pytest.raises(ValueError, match="per seed"):
        tsweep_mod.sweep(None, te.cfg, SEEDS, engine=te, pipeline=False,
                         faults=np.zeros((3, 2, 4), np.int32))
    with pytest.raises(ValueError, match="metrics=True"):
        tsweep_mod.sweep(None, te.cfg, SEEDS, engine=te, pipeline=False,
                         coverage_buckets=8)
    # The guided search is ported: its knobs raise the JAX package's
    # argument errors.
    with pytest.raises(ValueError, match="search_gen0"):
        tsweep_mod.sweep(None, te.cfg, SEEDS, engine=te, pipeline=False,
                         search_gen0=1)
    with pytest.raises(ValueError, match="recycle=True"):
        tsweep_mod.sweep(None, te.cfg, SEEDS, engine=te, pipeline=False,
                         search=object())


def test_summary_breaks_drop_cause_ties_as_jax():
    """The tie case of the observation key order: pb with the metrics
    block and a 16-deep ring over seeds 0..23, where two drop causes count
    24 each. JAX ranks them in sorted key order (jax.device_get sorts a
    dict), and so must the port: the same summary() string."""
    ck = dict(n_nodes=3, outbox_cap=4, queue_cap=48, t_limit_us=2_000_000,
              loss_rate=0.3, stop_on_bug=False, metrics=True, blackbox=16)
    faults = np.array([[130_000, J.FAULT_KILL, 0, 0],
                       [400_000, J.FAULT_RESTART, 0, 0],
                       [600_000, J.FAULT_SET_LOSS, 50_000, 0]], np.int32)
    pcfg = dict(n=3, n_writes=4, buggy_commit_early=True)
    je = J.DeviceEngine(J.PBActor(J.PBDeviceConfig(**pcfg)),
                        J.EngineConfig(**ck))
    te = T.DeviceEngine(T.PBActor(T.PBDeviceConfig(**pcfg)),
                        T.EngineConfig(**ck), device="cpu")
    kw = dict(faults=faults, chunk_steps=64, max_steps=2_000,
              pipeline=False)
    jr = jsweep_mod.sweep(None, je.cfg, np.arange(24), engine=je,
                          mesh=MESH1, **kw)
    tr = tsweep_mod.sweep(None, te.cfg, np.arange(24), engine=te, **kw)
    assert_results_equal(jr, tr)
    agg = tr.metrics["aggregate"]
    assert agg["drop_out_of_time"] == agg["drop_stale"] == 24
    assert tr.summary().endswith(
        "top drop causes: loss=277, dead=74, out_of_time=24; black box: "
        "last 16 events/world recorded.")


def test_golden_digests_recomputed_from_jax():
    """The JAX package's metrics-and-ring observe() and its recycled
    sweep reproduce the constants chip_smoke.py holds the GPU to."""
    rk, ck, faults, max_steps = golden.CONFIGS["hunt_faults"]
    faults = np.asarray(faults, np.int32)
    je = J.DeviceEngine(J.RaftActor(J.RaftDeviceConfig(**rk)),
                        J.EngineConfig(**ck, **golden.OBS_ON))
    obs = je.observe(je.run(je.init(golden.SEEDS, faults=faults), max_steps))
    assert golden.observe_digest(obs) == golden.GOLDEN_OBS
    sp = golden.SWEEP
    je = J.DeviceEngine(J.RaftActor(J.RaftDeviceConfig(**rk)),
                        J.EngineConfig(**ck, **sp["over"]))
    res = jsweep_mod.sweep(None, je.cfg, sp["seeds"], faults=faults,
                           engine=je, mesh=MESH1, pipeline=False,
                           **sp["kwargs"])
    assert res.failing_seeds and res.loop_stats["retire_fetches"] > 0
    assert golden.sweep_digest(res) == golden.GOLDEN_SWEEP
