"""The port's batched engine (madsim_tpu_torch.engine) against the JAX
package's, bitwise, on the CPU: ``init``, ``run``, ``run_steps`` and
``observe`` on every WorldState leaf, the Pallas kernel itself (interpret
mode), carrying state across packages, and the JAX-derived golden digests
that ``chip_smoke.py`` checks on the GPU.

Configurations are those of tests/test_queue_insert.py and
tests/test_pallas_step.py at small W. Tolerance: none — every operation is
integer, or an exactly rounded float32 product.
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import madsim_tpu.engine as J
import madsim_tpu_torch.engine as T
from madsim_tpu_torch.engine import golden, step_kernel
from madsim_tpu_torch.engine.core import tree_leaves, tree_paths

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEEDS = np.arange(16)

HEADLINE = (dict(n=3, log_cap=4),
            dict(n_nodes=3, outbox_cap=4, queue_cap=28, t_limit_us=1_000_000))
BUG = (dict(n=3, n_proposals=2, buggy_double_vote=True),
       dict(n_nodes=3, outbox_cap=4, queue_cap=64, t_limit_us=1_500_000,
            stop_on_bug=False))
KILL_RESTART = np.array([[300_000, J.FAULT_KILL, 0, 0],
                         [700_000, J.FAULT_RESTART, 0, 0]], np.int32)
# Every fault op; the last row is disabled (time < 0).
ALL_OPS = np.array([
    [100_000, J.FAULT_PAUSE, 1, 0], [250_000, J.FAULT_RESUME, 1, 0],
    [120_000, J.FAULT_CLOG_NODE, 2, 0], [400_000, J.FAULT_UNCLOG_NODE, 2, 0],
    [150_000, J.FAULT_CLOG_LINK, 0, 1], [600_000, J.FAULT_UNCLOG_LINK, 0, 1],
    [200_000, J.FAULT_SET_LATENCY, 500, 20_000],
    [300_000, J.FAULT_SET_LOSS, 200_000, 0], [800_000, J.FAULT_SET_LOSS, 0, 0],
    [500_000, J.FAULT_KILL, 1, 0], [650_000, J.FAULT_RESTART, 1, 0],
    [-1, J.FAULT_KILL, 2, 0],
], np.int32)


def engines(rk, ck, **over):
    ck = dict(ck, **over)
    return (J.DeviceEngine(J.RaftActor(J.RaftDeviceConfig(**rk)),
                           J.EngineConfig(**ck)),
            T.DeviceEngine(T.RaftActor(T.RaftDeviceConfig(**rk)),
                           T.EngineConfig(**ck), device="cpu"))


def mismatches(jstate, tstate):
    """Paths of the leaves that differ (value or dtype)."""
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(jstate)[0]]
    jl = [np.asarray(x) for x in jax.tree.leaves(jstate)]
    tl = T.state_to_numpy(tstate)
    assert len(jl) == len(tl) == 38
    return [p for p, a, b in zip(paths, jl, tl)
            if a.dtype != b.dtype or not np.array_equal(a, b)]


def assert_observe_equal(jeng, jstate, teng, tstate):
    jo, to = jeng.observe(jstate), teng.observe(tstate)
    assert sorted(jo) == sorted(to)
    for k in jo:
        assert jo[k].dtype == to[k].dtype, k
        np.testing.assert_array_equal(to[k], jo[k], err_msg=k)
    return to


@pytest.mark.parametrize("name", ["headline", "bug"])
def test_init_matches_jax_all_fault_ops_and_configs_grid(name):
    """Both deployments' init, with fault rows of all ten ops (ragged
    per-world schedules, disabled rows) and a per-world net-config grid."""
    rk, ck = HEADLINE if name == "headline" else BUG
    je, te = engines(rk, ck)
    w = 12
    rng = np.random.default_rng(0)
    configs = np.stack([rng.integers(0, 5_000, w),
                        rng.integers(5_000, 50_000, w),
                        rng.choice([0.0, 0.05, 0.3, 1.0], w)], axis=1)
    per_world = np.broadcast_to(ALL_OPS, (w,) + ALL_OPS.shape).copy()
    per_world[::3, :, 0] = -1  # ragged schedules: some worlds have none
    seeds = np.arange(w) + 2**33  # seeds wider than 32 bits
    js = je.init(seeds, faults=per_world, configs=configs)
    ts = te.init(seeds, faults=per_world, configs=configs)
    assert not mismatches(js, ts)


# name: (raft kwargs, engine kwargs, seeds, faults, max_steps, expect). The
# shapes and step limits are those of tests/test_pallas_step.py and
# tests/test_queue_insert.py, so the JAX programs are shared with them.
RUNS = {
    "overflow_q8": (dict(n=3, n_proposals=2),
                    dict(n_nodes=3, outbox_cap=4, queue_cap=8,
                         t_limit_us=2_000_000, stop_on_bug=False),
                    SEEDS, None, 3_000, "overflow"),
    "all_paused": (dict(n=3), dict(n_nodes=3, outbox_cap=4, queue_cap=64,
                                   t_limit_us=2_000_000),
                   np.arange(8),
                   np.array([[0, J.FAULT_PAUSE, 0, 0], [0, J.FAULT_PAUSE, 1, 0],
                             [0, J.FAULT_PAUSE, 2, 0]], np.int32), 2_000, None),
    "fault_mix": (dict(n=3, n_proposals=3),
                  dict(n_nodes=3, outbox_cap=4, queue_cap=64,
                       t_limit_us=1_000_000, stop_on_bug=False),
                  np.arange(8), ALL_OPS, 2_000, "leader_elected"),
    "wide_profile": (*HEADLINE, np.arange(8), None, 2_000, "leader_elected"),
}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_run_matches_jax(name):
    rk, ck, seeds, faults, max_steps, expect = RUNS[name]
    je, te = engines(rk, ck, **({"packed": False}
                                if name == "wide_profile" else {}))
    js = je.run(je.init(seeds, faults=faults), max_steps)
    ts0 = te.init(seeds, faults=faults)
    ts = te.run(ts0, max_steps)
    assert ts is ts0  # run updates the state in place and returns it
    assert not mismatches(js, ts), name
    obs = assert_observe_equal(je, js, te, ts)
    assert not obs["active"].any()
    assert obs[expect].any() if expect else True, \
        f"{name}: the path it exists for ({expect}) went unexercised"
    if name == "all_paused":
        assert (obs["queue_depth"] > 0).all()  # frozen with buffered events


def test_headline_run_matches_jax_and_its_golden_digest():
    """The headline deployment at W=64: every leaf and observe() equal to
    JAX, and the JAX observe() digest equal to the constant chip_smoke.py
    holds the GPU run to."""
    rk, ck, faults, max_steps = golden.CONFIGS["headline"]
    je, te = engines(rk, ck)
    js = je.run(je.init(golden.SEEDS), max_steps)
    ts = te.run(te.init(golden.SEEDS), max_steps)
    assert not mismatches(js, ts)
    obs = assert_observe_equal(je, js, te, ts)
    assert obs["leader_elected"].all() and not obs["overflow"].any()
    assert golden.observe_digest(je.observe(js)) == golden.GOLDEN["headline"]


def test_hunt_golden_digest_recomputed_from_jax():
    """The hunt-with-faults constant in golden.py is the JAX package's."""
    rk, ck, faults, max_steps = golden.CONFIGS["hunt_faults"]
    je = J.DeviceEngine(J.RaftActor(J.RaftDeviceConfig(**rk)),
                        J.EngineConfig(**ck))
    obs = je.observe(je.run(je.init(golden.SEEDS,
                                    faults=np.asarray(faults, np.int32)),
                            max_steps))
    assert obs["bug"].any()
    assert golden.observe_digest(obs) == golden.GOLDEN["hunt_faults"]


def test_default_device_is_the_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rk, ck = HEADLINE
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.DeviceEngine(T.RaftActor(T.RaftDeviceConfig(**rk)),
                       T.EngineConfig(**ck))


def test_kernel_wrapper_refuses_what_the_kernel_does_not_take():
    rk, ck = HEADLINE
    _, te = engines(rk, ck)
    state = te.init(np.arange(4))
    # The wrapper checks leaves against the engine's own state layout.
    assert te.state_layout() == [
        (name, x.dtype, tuple(x.shape[1:]))
        for name, x in zip(tree_paths(state), tree_leaves(state))]
    # A CPU tensor never reaches the kernel: launch() raises, run_steps()
    # takes the plain step.
    with pytest.raises(ValueError, match="CUDA"):
        step_kernel.launch(te, tree_leaves(state))
    before = step_kernel.launches
    te.run_steps(state, 2)
    assert step_kernel.launches == before
    for over, err in ((dict(queue_cap=300), ValueError),
                      (dict(payload_words=17), ValueError),
                      (dict(pallas_block=2048), ValueError)):
        _, eng = engines(rk, ck, **over)
        with pytest.raises(err):
            step_kernel.kernel_params(eng)
    # The wide lane profile has its instantiations: the same parameters,
    # and a tile plan of int32 commit and log rows (odd strides) with
    # payload rows moved as two 16-byte vectors.
    _, wide = engines(rk, ck, packed=False)
    assert step_kernel.kernel_params(wide) == step_kernel.kernel_params(te)
    plan = step_kernel.engine_plan(wide)
    assert plan.commit_stride % 2 == 1 and plan.log_stride % 2 == 1
    assert plan.commit_unit == plan.log_unit == 4 and plan.pay_unit == 16
    assert step_kernel.engine_plan(te).pay_unit == 16
    _, eng = engines(dict(rk, log_cap=65), ck)
    with pytest.raises(ValueError, match="log_cap"):
        step_kernel.kernel_params(eng)
    # Two-phase commit, primary-backup, Paxos and both pair families have
    # policies in the kernel, in both lane profiles: packed=False takes the
    # same parameters and every actor lane int32.
    from madsim_tpu_torch.actorc.families.paxos import (PaxosActor,
                                                        PaxosConfig,
                                                        engine_config)
    from madsim_tpu_torch.search.family import (GuidedPairActor,
                                                GuidedPairConfig)
    from madsim_tpu_torch.triage.synthetic import (PairRestartActor,
                                                   PairRestartConfig)
    tck = dict(n_nodes=4, outbox_cap=5, queue_cap=64)
    pck = dict(n_nodes=3, outbox_cap=4, queue_cap=48)
    xck = vars(engine_config(PaxosConfig()))
    gck = dict(n_nodes=12, outbox_cap=2, queue_cap=64, metrics=True)
    rck = dict(n_nodes=4, outbox_cap=2, queue_cap=64)
    for actor, ck2 in ((T.TPCActor(T.TPCDeviceConfig(n=4)), tck),
                       (T.PBActor(T.PBDeviceConfig(n=3)), pck),
                       (PaxosActor(PaxosConfig()), xck),
                       (GuidedPairActor(GuidedPairConfig(n=12)), gck),
                       (PairRestartActor(PairRestartConfig()), rck)):
        eng = T.DeviceEngine(actor, T.EngineConfig(**ck2), device="cpu")
        assert step_kernel.kernel_params(eng)[3] == \
            step_kernel.family_of(actor).id
        wide = T.DeviceEngine(actor,
                              T.EngineConfig(**dict(ck2, packed=False)),
                              device="cpu")
        assert step_kernel.kernel_params(wide) == \
            step_kernel.kernel_params(eng)
        fam = step_kernel.family_of(actor)
        assert step_kernel.family_lanes(fam, False) == tuple(
            (name[len("astate."):], dtype) for name, dtype, _
            in wide.state_layout() if name.startswith("astate."))
        assert all(dtype == torch.int32 for _n, dtype
                   in step_kernel.family_lanes(fam, False))
    # An actor the kernel has no policy for raises, naming the routes.
    with pytest.raises(NotImplementedError, match="paxos, pair_restart"):
        step_kernel.family_of(object())


def test_config_and_init_validation_match_jax():
    for bad in (dict(n_nodes=200), dict(n_nodes=3, queue_cap=40_000),
                dict(n_nodes=3, pallas_block=0), dict(n_nodes=3, blackbox=-1)):
        with pytest.raises(ValueError):
            J.EngineConfig(**bad)
        with pytest.raises(ValueError):
            T.EngineConfig(**bad)
    # sequential_insert is ported (tests/test_torch_queue_insert.py); the
    # config's repr, a checkpoint's fingerprint, is JAX's.
    assert repr(T.EngineConfig(n_nodes=3, sequential_insert=True)) == \
        repr(J.EngineConfig(n_nodes=3, sequential_insert=True))
    # The metrics block and the flight recorder are ported.
    assert T.EngineConfig(n_nodes=3, metrics=True, blackbox=8).blackbox == 8
    rk, ck = HEADLINE
    je, te = engines(rk, ck)
    bad_rows = [
        np.array([[0, 10, 0, 0]], np.int32),                      # op
        np.array([[0, J.FAULT_KILL, 3, 0]], np.int32),            # node id
        np.array([[0, J.FAULT_SET_LATENCY, 10, 10]], np.int32),   # min < max
        np.array([[0, J.FAULT_SET_LOSS, 2_000_000, 0]], np.int32),  # ppm
    ]
    for rows in bad_rows:
        for eng in (je, te):
            with pytest.raises(ValueError):
                eng.init(np.arange(2), faults=rows)
    for cfgs in (np.array([10.0, 5.0, 0.0]), np.array([1.0, 10.0, 1.5])):
        for eng in (je, te):
            with pytest.raises(ValueError):
                eng.init(np.arange(2), configs=cfgs)


def test_port_imports_neither_jax_nor_the_jax_package():
    code = ("import sys, madsim_tpu_torch.engine, madsim_tpu_torch._build, "
            "madsim_tpu_torch.obs.metrics, madsim_tpu_torch.obs.blackbox, "
            "madsim_tpu_torch.obs.coverage, "
            "madsim_tpu_torch.parallel, madsim_tpu_torch.parallel.sweep, "
            "madsim_tpu_torch.parallel.mesh, "
            "madsim_tpu_torch.actorc, "
            "madsim_tpu_torch.actorc.families.tpc, "
            "madsim_tpu_torch.actorc.families.pb, "
            "madsim_tpu_torch.actorc.families.paxos, "
            "madsim_tpu_torch.engine.tpc_actor, "
            "madsim_tpu_torch.engine.pb_actor, "
            "madsim_tpu_torch.engine.families, "
            "madsim_tpu_torch.engine.step_kernel, "
            "madsim_tpu_torch.engine.checkpoint, "
            "madsim_tpu_torch.engine.crosscheck, "
            "madsim_tpu_torch.search, madsim_tpu_torch.search.hunts, "
            "madsim_tpu_torch.search.generate, "
            "madsim_tpu_torch.obs.lineage, "
            "madsim_tpu_torch.triage.synthetic, "
            "madsim_tpu_torch.triage, madsim_tpu_torch.triage.corpus, "
            "madsim_tpu_torch.obs, madsim_tpu_torch.obs.cli, "
            "madsim_tpu_torch.obs.observatory, "
            "madsim_tpu_torch.obs.bundle, madsim_tpu_torch.obs.timeline, "
            "madsim_tpu_torch.analysis, madsim_tpu_torch.analysis.speclint, "
            "madsim_tpu_torch.analysis.tracelint, "
            "madsim_tpu_torch.analysis.budgets, "
            "madsim_tpu_torch.actorc.host, "
            "madsim_tpu_torch.actorc.conformance, "
            "madsim_tpu_torch.engine.conformance, "
            "madsim_tpu_torch.fleet, madsim_tpu_torch.fleet.lease, "
            "madsim_tpu_torch.fleet.rpc, madsim_tpu_torch.fleet.chaos, "
            "madsim_tpu_torch.fleet.merge, "
            "madsim_tpu_torch.fleet.coordinator, "
            "madsim_tpu_torch.fleet.worker, madsim_tpu_torch.fleet.exchange, "
            "madsim_tpu_torch.fleet.fabric, madsim_tpu_torch.fleet.process, "
            "madsim_tpu_torch.bridge, madsim_tpu_torch.bridge.kernel, "
            "madsim_tpu_torch.bridge.cuda, madsim_tpu_torch.bridge.synthetic, "
            "madsim_tpu_torch.bridge.golden, "
            "madsim_tpu_torch.kernel_ab; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'madsim_tpu' or "
            "m.startswith('madsim_tpu.')]; "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


# JAX's exports that the port does not have yet, by subpackage: each name
# with the ROADMAP Queue A item that brings it, or "host runtime" where the
# name belongs to what stays outside the port (ROADMAP, Queue A's preface:
# analysis passes 1-2, host-test bundles).
UNPORTED_EXPORTS = {
    "obs": {"write_test_bundle": "host runtime"},
    "bridge": {name: "host runtime" for name in (
        "sweep", "sweep_traced", "sweep_pooled", "Outcome", "BridgeRuntime",
        "BridgeNetSim", "BridgeTime", "BridgePoolError", "SliceDriver")},
    "analysis": {"run_lint": "host runtime",
                 "run_escape_pass": "host runtime",
                 "run_parity_pass": "host runtime",
                 "scan_source": "host runtime"},
}
PORT_SUBPACKAGES = ("actorc", "analysis", "bridge", "engine", "fleet", "obs",
                    "ops", "parallel", "search", "triage")


def test_port_subpackages_are_the_parity_list():
    import pkgutil

    import madsim_tpu_torch

    subs = sorted(m.name for m in pkgutil.iter_modules(
        madsim_tpu_torch.__path__) if m.ispkg)
    assert tuple(subs) == PORT_SUBPACKAGES


@pytest.mark.parametrize("sub", PORT_SUBPACKAGES)
def test_port_exports_jax_names(sub):
    """Every name in the JAX subpackage's ``__all__`` is exported by the
    port's (an attribute and in its ``__all__``), or waits on the explicit
    list above, and a listed name is not exported yet."""
    import importlib

    jmod = importlib.import_module(f"madsim_tpu.{sub}")
    tmod = importlib.import_module(f"madsim_tpu_torch.{sub}")
    waiting = UNPORTED_EXPORTS.get(sub, {})
    jall = getattr(jmod, "__all__", None)
    if jall is None:  # ops has no __all__: its modules instead
        import pkgutil

        for m in pkgutil.iter_modules(jmod.__path__):
            importlib.import_module(f"madsim_tpu_torch.{sub}.{m.name}")
        return
    tall = getattr(tmod, "__all__", ())
    assert set(waiting) <= set(jall), sorted(set(waiting) - set(jall))
    for name in jall:
        if name in waiting:
            assert name not in tall and not hasattr(tmod, name), \
                f"{sub}.{name} is exported: take it off the waiting list"
            assert waiting[name].startswith(("item ", "host runtime"))
        else:
            assert name in tall and hasattr(tmod, name), f"{sub}.{name}"


def test_tree_select_worlds_matches_jax():
    rk, ck = BUG
    je, te = engines(rk, ck)
    seeds = np.arange(8)
    ja, jb = je.init(seeds), je.run(je.init(seeds + 100), 40)
    ta, tb = te.init(seeds), te.run(te.init(seeds + 100), 40)
    mask = np.array([1, 0, 0, 1, 1, 0, 1, 0], bool)
    js = J.tree_select_worlds(jax.numpy.asarray(mask), ja, jb)
    ts = T.tree_select_worlds(torch.from_numpy(mask), ta, tb)
    assert not mismatches(js, ts)
    from madsim_tpu_torch.parallel import SweepResult, sweep
    from madsim_tpu_torch.parallel.sweep import SweepResult as R
    from madsim_tpu_torch.parallel.sweep import sweep as s
    assert sweep is s and SweepResult is R
