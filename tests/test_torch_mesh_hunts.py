"""What rides the world-axis split besides the plain loops, against the JAX
package's 4-device CPU mesh, bitwise: the guided pair hunt in the three
loops (the corpus fold once a refill, on the lead device, whatever the
mesh), ``SweepSession.run_group`` (each group padded to the mesh),
``minimize(mesh=...)`` (each round padded to at least the mesh), and
checkpoints written on a 4-way split: a cut sweep resumed on a new engine
equals the unbroken one, and the Raft files interchange with JAX's
4-device ones both ways.

The port splits over ``seed_mesh([torch.device("cpu")] * 4)``, JAX over
``seed_mesh(n_devices=4)`` (tests/conftest.py forces 8 CPU devices).
Tolerance: none.
"""
import dataclasses
import importlib

import numpy as np
import pytest
import torch

import madsim_tpu.engine as J
import madsim_tpu_torch.engine as T
from madsim_tpu.engine import DeviceEngine as JEngine
from madsim_tpu.parallel import mesh as jmesh
from madsim_tpu.parallel.sweep import SweepSession as JSweepSession
from madsim_tpu.search import hunts as jhunts
from madsim_tpu.search.config import SearchConfig as JSearchConfig
from madsim_tpu.triage import minimize as j_minimize
from madsim_tpu.triage import synthetic as jsyn
from madsim_tpu_torch.fleet.merge import contract_mismatches
from madsim_tpu_torch.parallel import SweepSession
from madsim_tpu_torch.parallel import mesh as tmesh
from madsim_tpu_torch.search import hunts as thunts
from madsim_tpu_torch.triage import minimize
from madsim_tpu_torch.triage import synthetic as tsyn
from test_torch_search import assert_search_results_equal
from test_torch_sweep_resume import assert_resumed_equal

jsweep = importlib.import_module("madsim_tpu.parallel.sweep")
tsweep = importlib.import_module("madsim_tpu_torch.parallel.sweep")

CPU = torch.device("cpu")
JM4 = jmesh.seed_mesh(n_devices=4)
TM4 = tmesh.seed_mesh([CPU] * 4)
LOOPS = {"serial": dict(pipeline=False), "pipelined": dict(pipeline=True),
         "fused": dict(fused=True)}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# The guided hunt
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pair_hunts():
    jh, th = jhunts.pair_hunt(), thunts.pair_hunt()
    return (JEngine(jh.actor, jh.cfg),
            T.DeviceEngine(th.actor, th.cfg, device="cpu"), th)


@pytest.mark.parametrize("loop", sorted(LOOPS))
def test_guided_pair_hunt_matches_jax_on_four_devices(pair_hunts, loop):
    """The guided pair hunt, 30 seeds (padded to 32) through 6 slots
    (rounded to 8): every field and the SearchReport (corpus, schedules,
    lineage, operator table) equal JAX's on its 4-device mesh. The fold
    runs once a refill, over the whole world axis."""
    je, te, hunt = pair_hunts
    scfg = hunt.search(True)
    jscfg = JSearchConfig(**dataclasses.asdict(scfg))
    kw = dict(hunt.sweep_kw, faults=hunt.template, batch_worlds=6,
              max_steps=4_096, **LOOPS[loop])
    jr = jsweep.sweep(None, je.cfg, np.arange(30), engine=je, mesh=JM4,
                      search=jscfg, **kw)
    folds = []
    from madsim_tpu_torch.search import generate

    real = generate.harvest_fold

    def counting(*a, **k):
        folds.append(1)
        return real(*a, **k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(generate, "harvest_fold", counting)
        tr = tsweep.sweep(None, te.cfg, np.arange(30), engine=te, mesh=TM4,
                          search=scfg, **kw)
    assert_search_results_equal(jr, tr)
    assert tr.n_devices == jr.n_devices == 4
    assert tr.search.generations > 1
    refills = (tr.loop_stats["epochs_on_device"] if loop == "fused"
               else tr.search.generations)
    assert len(folds) == refills


# ---------------------------------------------------------------------------
# The session
# ---------------------------------------------------------------------------

RK = dict(n=3, n_proposals=2, buggy_double_vote=True)
CK = dict(n_nodes=3, outbox_cap=4, queue_cap=64, t_limit_us=400_000,
          metrics=True)
FAULTS = np.array([[150_000, J.FAULT_KILL, 0, 0],
                   [300_000, J.FAULT_RESTART, 0, 0]], np.int32)
SESSION_KW = dict(chunk_steps=16, max_steps=2_000, coverage_buckets=64)


def raft_engines(**over):
    ck = dict(CK, **over)
    return (J.DeviceEngine(J.RaftActor(J.RaftDeviceConfig(**RK)),
                           J.EngineConfig(**ck)),
            T.DeviceEngine(T.RaftActor(T.RaftDeviceConfig(**RK)),
                           T.EngineConfig(**ck), device="cpu"))


def parts_of(seeds, sizes):
    """Ranges of ``seeds`` of the given sizes, per-world schedules (each
    range's rows shifted by its first seed, so that the padded rows, a
    repeat of row 0, are told apart)."""
    out, at = [], 0
    for n in sizes:
        s = np.asarray(seeds[at:at + n], np.uint64)
        f = np.broadcast_to(FAULTS, (n,) + FAULTS.shape).copy()
        f[:, :, 0] += (np.arange(n) * 1_000)[:, None]
        out.append({"seeds": s, "faults": f})
        at += n
    return out


def test_session_run_group_matches_jax_on_four_devices():
    """Two groups through one session on a 4-way split (5 + 6 seeds,
    padded to 12; the second group reuses the standing slots): each
    range's result equals JAX's session on its 4-device mesh and a solo
    sweep of the range on the same split, ``faults_sha256`` (the padded
    schedule's) included."""
    je, te = raft_engines()
    tsess = SweepSession(engine=te, mesh=TM4, **SESSION_KW)
    jsess = JSweepSession(engine=je, mesh=JM4, **SESSION_KW)
    for g, seeds in enumerate((np.arange(11), np.arange(40, 51))):
        parts = parts_of(seeds, (5, 6))
        tres = tsess.run_group(parts)
        jres = jsess.run_group(parts)
        for p, t, j in zip(parts, tres, jres):
            assert contract_mismatches(j, t) == []
            assert t.faults_sha256 == j.faults_sha256
            assert t.n_devices == j.n_devices == 4
            for key in ("chunks", "dispatches", "scalar_fetches",
                        "session_reused_slots"):
                assert t.loop_stats[key] == j.loop_stats[key], key
            solo = tsweep.sweep(None, te.cfg, p["seeds"], faults=p["faults"],
                                engine=te, mesh=TM4, **SESSION_KW)
            assert contract_mismatches(solo, t) == []
            assert solo.faults_sha256 == t.faults_sha256
        assert tres[0].loop_stats["session_reused_slots"] == (g > 0)
    assert tsess.reuse_hits == jsess.reuse_hits


# ---------------------------------------------------------------------------
# minimize
# ---------------------------------------------------------------------------

def test_minimize_on_four_devices_matches_jax():
    """The known-minimal pair bug (rows {1, 5} of 8) minimized on a 4-way
    split: each round pads to at least the mesh, and the result, history
    and provenance equal JAX's on its 4-device mesh;
    ``SweepResult.minimize`` passes its sweep's mesh on."""
    acfg = tsyn.PairRestartConfig()
    je = JEngine(jsyn.PairRestartActor(jsyn.PairRestartConfig()),
                 jsyn.engine_config(jsyn.PairRestartConfig()))
    te = T.DeviceEngine(tsyn.PairRestartActor(acfg),
                        tsyn.engine_config(acfg), device="cpu")
    rows = tsyn.pair_schedule(n_rows=8, need=(1, 5), acfg=acfg)
    kw = dict(chunk_steps=32, max_steps=4_000)
    widths = []
    real = tsweep.sweep

    def counting_sweep(actor, cfg, seeds, **k):
        widths.append(len(np.asarray(seeds)))
        assert k["mesh"] is TM4
        return real(actor, cfg, seeds, **k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsweep, "sweep", counting_sweep)
        tr = minimize(None, te.cfg, 7, rows, engine=te, mesh=TM4, **kw)
    jr = j_minimize(None, je.cfg, 7, rows, engine=je, mesh=JM4, **kw)
    for f in ("original", "full", "schedule"):
        np.testing.assert_array_equal(getattr(tr, f), getattr(jr, f),
                                      err_msg=f)
    assert (tr.schedule == rows[[1, 5]]).all() and tr.one_minimal
    assert tr.history == jr.history
    assert tr.provenance() == jr.provenance()
    assert min(widths) >= 4 and all(w & (w - 1) == 0 for w in widths)
    res = tsweep.sweep(None, te.cfg, np.full(4, 7, np.uint64),
                       faults=np.broadcast_to(rows, (4,) + rows.shape),
                       engine=te, mesh=TM4, **kw)
    assert res.triage_ctx.mesh is TM4
    assert res.minimize(**kw).history == tr.history


# ---------------------------------------------------------------------------
# Checkpoints on a split
# ---------------------------------------------------------------------------

CKPT_KW = dict(chunk_steps=16, faults=FAULTS, coverage_buckets=64,
               recycle=True, batch_worlds=5, pipeline=False)
CKPT_SEEDS = np.arange(14)


def test_checkpoint_on_four_devices_resumes_and_interchanges(tmp_path):
    """A recycled sweep on a 4-way split (14 seeds padded to 16, 5 slots
    rounded to 8), cut after 3 chunks with a file a chunk: resumed on a
    new engine it equals the unbroken sweep; JAX's file of the same cut
    on its 4-device mesh resumes in the port, and the port's in JAX, each
    to the unbroken result; the file holds the gathered batch and JAX's
    hashes of the inputs."""
    je, te = raft_engines()
    jfull = jsweep.sweep(None, je.cfg, CKPT_SEEDS, engine=je, mesh=JM4,
                         max_steps=2_000, **CKPT_KW)
    cut = dict(max_steps=48, checkpoint_every_chunks=1)
    tpath, jpath = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    partial = tsweep.sweep(None, te.cfg, CKPT_SEEDS, engine=te, mesh=TM4,
                           checkpoint_path=tpath, **cut, **CKPT_KW)
    assert partial.observations["active"].any(), "the cut ended the sweep"
    jsweep.sweep(None, je.cfg, CKPT_SEEDS, engine=je, mesh=JM4,
                 checkpoint_path=jpath, **cut, **CKPT_KW)
    from madsim_tpu_torch.engine import checkpoint as ckpt

    meta = ckpt.read_meta(tpath)
    assert meta["n_worlds"] == 8
    assert meta["extra"] == ckpt.read_meta(jpath)["extra"]
    for path in (tpath, jpath):
        _je, te2 = raft_engines()
        resumed = tsweep.sweep(None, te2.cfg, CKPT_SEEDS, engine=te2,
                               mesh=TM4, max_steps=2_000,
                               checkpoint_path=path, resume=True, **CKPT_KW)
        assert_resumed_equal(jfull, resumed)
    je2, _te = raft_engines()
    jres = jsweep.sweep(None, je2.cfg, CKPT_SEEDS, engine=je2, mesh=JM4,
                        max_steps=2_000, checkpoint_path=tpath, resume=True,
                        **CKPT_KW)
    assert_resumed_equal(jfull, jres)
    # A split state is saved gathered.
    from madsim_tpu_torch.engine.convert import state_to_numpy

    state = te.init(CKPT_SEEDS[:8], faults=FAULTS)
    ckpt.save(te, tmesh.shard_worlds(state, TM4), str(tmp_path / "s.npz"))
    for a, b in zip(state_to_numpy(state),
                    state_to_numpy(ckpt.load(te, str(tmp_path / "s.npz")))):
        np.testing.assert_array_equal(a, b)
    # The same mesh size is needed: on 2 devices the batch is 6 slots.
    with pytest.raises(ValueError, match="full-shape"):
        tsweep.sweep(None, te.cfg, CKPT_SEEDS, engine=te,
                     mesh=tmesh.seed_mesh([CPU] * 2), max_steps=2_000,
                     checkpoint_path=tpath, resume=True, **CKPT_KW)
