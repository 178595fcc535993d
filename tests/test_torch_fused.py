"""The port's whole-hunt loop (``sweep(fused=True)``) against the JAX
package on the CPU, bitwise.

The counterpart of tests/test_fused.py: the port's fused loop (the gated
chunks, and the epoch body behind the device's epoch trigger, its writes
masked by it: compaction, the retiring tail scattered into per-seed
device buffers, the cursor arithmetic, the searcher, the in-loop refill
``DeviceEngine.refill_traced``) returns every ``SweepResult`` field of
JAX's ``sweep(..., mesh=seed_mesh(n_devices=1), fused=True)`` but
``world_utilization`` (neither fused loop shrinks; that field is the one
the fused loops may take apart from the serial ones, so it is held to
JAX's fused run too): raft's modes, tpc, pb and Paxos, and the guided and
random pair and Paxos hunts with their ``SearchReport``. Also the
refusals, one ``_fetch`` per mega-dispatch and one pull of the per-seed
buffers at the end, the zero-step budget, the ``loop_stats`` schema, and
``refill_traced`` against ``refill``.

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
from madsim_tpu_torch.engine.core import tree_leaves, tree_paths
from madsim_tpu_torch.engine.families import family
tsweep = importlib.import_module("madsim_tpu_torch.parallel.sweep")
from test_torch_sweep import FAULTS, SEEDS, assert_results_equal, engines

jsweep = importlib.import_module("madsim_tpu.parallel.sweep")
MESH1 = seed_mesh(n_devices=1)

# name: sweep keyword arguments (with chunk_steps=64 and the schedule).
MODES = {
    "plain": dict(max_steps=3_000),
    "recycled": dict(max_steps=3_000, recycle=True, batch_worlds=8),
    "recycled_first_bug": dict(max_steps=3_000, recycle=True,
                               batch_worlds=8, stop_on_first_bug=True),
    "max_steps_bound": dict(max_steps=320, recycle=True, batch_worlds=8),
    "early_exit": dict(max_steps=64, recycle=True, batch_worlds=8),
}


@pytest.fixture(scope="module")
def off_engines():
    return engines()


@pytest.fixture(scope="module")
def on_engines():
    return engines(metrics=True, blackbox=16)


def both(je, te, seeds=SEEDS, **kw):
    """JAX's and the port's fused sweep, and each one's ``_fetch``
    count."""
    counts = {"jax": 0, "torch": 0}
    with pytest.MonkeyPatch.context() as mp:
        for mod, name in ((jsweep, "jax"), (tsweep, "torch")):
            def fetch(tree, real=mod._fetch, name=name):
                counts[name] += 1
                return real(tree)

            mp.setattr(mod, "_fetch", fetch)
        jr = jsweep.sweep(None, je.cfg, seeds, engine=je, mesh=MESH1,
                          fused=True, **kw)
        tr = tsweep.sweep(None, te.cfg, seeds, engine=te, fused=True, **kw)
    return jr, tr, counts


def assert_fused_fetches(tr, counts):
    """One scalar batch per mega-dispatch and one pull of the per-seed
    buffers at the end are the loop's only ``_fetch`` calls. The host also
    reads a device flag after each chunk, a chunk late (``flag_reads``):
    without conditional graph nodes the trigger of an epoch body is seen
    there."""
    st = tr.loop_stats
    assert st["fused"] and not st["pipelined"]
    assert st["scalar_fetches"] == st["dispatches"]
    assert st["retire_fetches"] == 1
    assert counts["torch"] == counts["jax"] == st["dispatches"] + 1


@pytest.mark.parametrize("mode", sorted(MODES))
def test_fused_sweep_matches_jax(off_engines, mode):
    jr, tr, counts = both(*off_engines, chunk_steps=64, faults=FAULTS,
                          **MODES[mode])
    assert_results_equal(jr, tr)
    assert_fused_fetches(tr, counts)
    if mode in ("recycled", "max_steps_bound"):
        assert tr.loop_stats["epochs_on_device"] >= 1


def test_fused_sweep_with_coverage_and_ring_matches_jax(on_engines):
    jr, tr, counts = both(*on_engines, chunk_steps=64, faults=FAULTS,
                          max_steps=3_000, recycle=True, batch_worlds=8,
                          coverage_buckets=64)
    assert_results_equal(jr, tr)
    assert_fused_fetches(tr, counts)


@pytest.mark.parametrize("name", ["tpc_crosscheck", "pb_hunt",
                                  "paxos_hunt"])
def test_fused_family_sweeps_match_jax(name):
    fam, ak, ck, faults, _ms = (golden.FAMILY_CONFIGS.get(name)
                                or golden.SEARCH_CONFIGS[name])
    (jcls, jccls), (tcls, tccls) = (j_families()[fam].load(),
                                    family(fam).load())
    je = J.DeviceEngine(jcls(jccls(**ak)), J.EngineConfig(**ck))
    te = T.DeviceEngine(tcls(tccls(**ak)), T.EngineConfig(**ck),
                        device="cpu")
    jr, tr, counts = both(
        je, te, seeds=np.arange(16), chunk_steps=64, max_steps=2_000,
        recycle=True, batch_worlds=8,
        faults=None if faults is None else np.asarray(faults, np.int32))
    assert_results_equal(jr, tr)
    assert_fused_fetches(tr, counts)


@pytest.mark.parametrize("hunt,guided", [("pair", True), ("pair", False),
                                         ("paxos", True)])
def test_fused_guided_hunts_match_jax(hunt, guided):
    """The guided and random hunts: the fold (on CUDA the corpus fold
    kernel) and the children run in the device loop behind the epoch
    trigger; the SearchReport is JAX's."""
    from madsim_tpu.search import SearchConfig as JSearchConfig
    from madsim_tpu.search import hunts as jhunts
    from madsim_tpu_torch.search import hunts as thunts
    from test_torch_search import assert_search_results_equal

    jh, th = (getattr(m, hunt + "_hunt")() for m in (jhunts, thunts))
    je, te = J.DeviceEngine(jh.actor, jh.cfg), T.DeviceEngine(
        th.actor, th.cfg, device="cpu")
    scfg = th.search(guided)
    jscfg = JSearchConfig(**{f: getattr(scfg, f)
                             for f in scfg.__dataclass_fields__})
    kw = dict(th.sweep_kw, faults=th.template)
    n = 80 if hunt == "pair" else 64
    jr = jsweep.sweep(None, je.cfg, np.arange(n), engine=je, mesh=MESH1,
                      fused=True, search=jscfg, **kw)
    tr = tsweep.sweep(None, te.cfg, np.arange(n), engine=te, fused=True,
                      search=scfg, **kw)
    assert_search_results_equal(jr, tr)
    assert tr.loop_stats["epochs_on_device"] == tr.search.generations
    if hunt == "pair":
        assert tr.failing_seeds == ([72] if guided else [])


def test_fused_refusals(off_engines):
    te = off_engines[1]
    with pytest.raises(ValueError, match="fused=True has no shrink path"):
        tsweep.sweep(None, te.cfg, SEEDS, engine=te, fused=True,
                     compact=True)
    with pytest.raises(ValueError, match="fused=True cannot checkpoint"):
        tsweep.sweep(None, te.cfg, SEEDS, engine=te, fused=True,
                     checkpoint_path="x.npz")
    # The observatory runs in the fused loop
    # (tests/test_torch_observatory.py), and so does a mesh (tests/
    # test_torch_mesh.py holds it to JAX's): a 2-way split of the CPU.
    from madsim_tpu_torch.parallel import seed_mesh as tseed_mesh

    res = tsweep.sweep(None, te.cfg, SEEDS, engine=te, fused=True,
                       chunk_steps=64, max_steps=64,
                       mesh=tseed_mesh([torch.device("cpu")] * 2))
    assert res.n_devices == 2 and res.loop_stats["chunks"] == 1


def test_fused_zero_step_budget_runs_no_chunks(off_engines):
    """max_steps <= 0: no chunk runs, and the live (init) observations
    still land through the one pass-through mega-dispatch."""
    jr, tr, counts = both(*off_engines, chunk_steps=64, faults=FAULTS,
                          max_steps=0, recycle=True, batch_worlds=8)
    assert_results_equal(jr, tr)
    assert tr.steps_run == 0 and tr.loop_stats["chunks"] == 0
    assert tr.loop_stats["dispatches"] == 1
    assert_fused_fetches(tr, counts)


def test_fused_loop_stats_schema(off_engines):
    te = off_engines[1]
    res = tsweep.sweep(None, te.cfg, SEEDS, engine=te, fused=True,
                       chunk_steps=64, max_steps=1_024, recycle=True,
                       batch_worlds=8)
    ls = res.loop_stats
    assert ls["fused"] is True and ls["pipelined"] is False
    # k_bucket: the chunk budget (16 chunks) to a power of two.
    assert ls["superstep_max"] == 16
    assert ls["epochs_on_device"] >= 1
    # A flag read per chunk queued (the trigger and the stop word).
    assert ls["flag_reads"] >= ls["epochs_on_device"]
    assert ls["seeds_per_dispatch"] == pytest.approx(
        len(SEEDS) / ls["dispatches"], abs=1e-3)
    for key in ("device_wait_s", "host_decision_s", "dispatch_s",
                "retire_wait_s", "loop_wall_s"):
        assert isinstance(ls[key], float) and ls[key] >= 0.0, key


def test_refill_traced_is_refill(off_engines):
    """The in-loop refill from device tensors equals ``refill`` with host
    seeds and a device schedule block, and re-keys only the masked
    slots."""
    te = off_engines[1]
    a = te.init(SEEDS, faults=FAULTS)
    te.run_steps(a, 40)
    b = te.init(SEEDS, faults=FAULTS)
    te.run_steps(b, 40)
    mask = np.arange(16) % 3 == 0
    new = np.arange(100, 116, dtype=np.uint64) + (np.uint64(7) << 33)
    sched = np.broadcast_to(FAULTS, (16,) + FAULTS.shape).copy()
    sched[::2, 0, 0] += 50_000
    te.refill(a, mask, new, faults=torch.from_numpy(sched))
    lo = torch.from_numpy((new & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    hi = torch.from_numpy((new >> np.uint64(32)).astype(np.uint32))
    te.refill_traced(b, torch.from_numpy(mask), lo, hi,
                     torch.from_numpy(sched))
    for name, x, y in zip(tree_paths(a), tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y), name
