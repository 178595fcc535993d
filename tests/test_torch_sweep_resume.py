"""Sweep checkpoints and resume in the port (madsim_tpu_torch.parallel.sweep)
against the JAX package on the CPU, bitwise (tolerance 0: every operation
is integer, or an exactly rounded float32 product).

The port's counterparts of the JAX suite's resume tests:
tests/test_parallel.py:265 (a recycled sweep, and the refusals of another
batch width and of a recycled file resumed plain), tests/test_obs.py:213
and :674 (the metrics block and the coverage ledger; the flight recorder
and its mixup refusal), tests/test_search.py:249 and :273 (the guided
search; the guided/plain mixups), tests/test_lineage.py:184 (the lineage
lanes and the operator table), tests/test_sweep_pipeline.py:118 (the
pipelined loop with a writer) and tests/test_fused.py:227 (the fused
loop's refusal). Each interrupted sweep checkpoints as it goes, and a
fresh engine resumes it; the result must equal JAX's unbroken sweep
(serial loop, one device) on every field the JAX tests compare.

The configuration is tests/test_torch_sweep.py's Raft hunt (kill/restart
schedule, metrics on, a 16-deep ring) and tests/test_torch_search.py's
guided pair hunt, so the JAX programs are the ones those files compile.
"""
import importlib

import numpy as np
import pytest

import madsim_tpu.engine as J
import madsim_tpu_torch.engine as T
from madsim_tpu.parallel.mesh import seed_mesh
from madsim_tpu.search import hunts as jhunts
from madsim_tpu.search.config import SearchConfig as JSearchConfig
from madsim_tpu_torch.engine.checkpoint import CheckpointError
tsweep = importlib.import_module("madsim_tpu_torch.parallel.sweep")
from madsim_tpu_torch.search import hunts as thunts

jsweep = importlib.import_module("madsim_tpu.parallel.sweep")
MESH1 = seed_mesh(n_devices=1)
RK = dict(n=3, n_proposals=2, buggy_double_vote=True)
CK = dict(n_nodes=3, outbox_cap=4, queue_cap=64, t_limit_us=1_500_000,
          metrics=True, blackbox=16)
FAULTS = np.array([[300_000, J.FAULT_KILL, 0, 0],
                   [700_000, J.FAULT_RESTART, 0, 0]], np.int32)
SEEDS = np.arange(16)
# name: sweep keyword arguments, and the chunks after which the
# interrupted sweep stops (the plain batch runs 4 chunks; the recycled one
# has refilled by its 4th).
MODES = {
    "plain": (dict(), 2),
    "recycled": (dict(recycle=True, batch_worlds=8), 4),
}
KW = dict(chunk_steps=64, faults=FAULTS, coverage_buckets=64)


def t_engine(**over):
    return T.DeviceEngine(T.RaftActor(T.RaftDeviceConfig(**RK)),
                          T.EngineConfig(**dict(CK, **over)), device="cpu")


@pytest.fixture(scope="module")
def jax_results():
    """JAX's unbroken serial sweep of each mode."""
    je = J.DeviceEngine(J.RaftActor(J.RaftDeviceConfig(**RK)),
                        J.EngineConfig(**CK))
    return {name: jsweep.sweep(None, je.cfg, SEEDS, engine=je, mesh=MESH1,
                               pipeline=False, max_steps=3_000, **KW, **kw)
            for name, (kw, _) in MODES.items()}


def assert_resumed_equal(jr, tr):
    """The fields the JAX resume tests compare: every observation (the
    metrics block and the ring among them), the bug flags and failing
    seeds, the metrics frames and the coverage ledger's hits and
    first-seen seeds (its novelty curve is the calling run's history)."""
    assert list(tr.observations) == list(jr.observations)
    for k, v in jr.observations.items():
        assert tr.observations[k].dtype == v.dtype, k
        np.testing.assert_array_equal(tr.observations[k], v, err_msg=k)
    np.testing.assert_array_equal(tr.bug, jr.bug)
    assert tr.failing_seeds == jr.failing_seeds
    mj, mt = jr.metrics["per_seed"], tr.metrics["per_seed"]
    assert list(mt) == list(mj)
    for k in mj:
        np.testing.assert_array_equal(mt[k], mj[k], err_msg=f"m_{k}")
    np.testing.assert_array_equal(tr.coverage.hits, jr.coverage.hits)
    np.testing.assert_array_equal(tr.coverage.first_seen_seed,
                                  jr.coverage.first_seen_seed)
    assert tr.coverage.distinct_behaviors == jr.coverage.distinct_behaviors


@pytest.mark.parametrize("pipeline", [False, True])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_interrupted_sweep_resumes_to_jax_unbroken(jax_results, tmp_path,
                                                   mode, pipeline):
    kw, cut = MODES[mode]
    path = str(tmp_path / "sweep.npz")
    eng = t_engine()
    partial = tsweep.sweep(None, eng.cfg, SEEDS, engine=eng,
                           pipeline=pipeline, max_steps=64 * cut,
                           checkpoint_path=path, checkpoint_every_chunks=1,
                           **KW, **kw)
    assert partial.steps_run == 64 * cut
    assert partial.observations["active"].any(), "the cut ended the sweep"
    # "Process restart": a fresh engine, resumed from the file alone.
    resumed = tsweep.sweep(None, eng.cfg, SEEDS, engine=t_engine(),
                           pipeline=pipeline, max_steps=3_000,
                           checkpoint_path=path, resume=True, **KW, **kw)
    assert_resumed_equal(jax_results[mode], resumed)


def test_pipelined_sweep_with_a_writer_equals_the_unbroken(jax_results,
                                                           tmp_path):
    """A writer attached to the whole pipelined sweep changes no result
    (supersteps capped at the cadence; the dry-cursor shrink off, so the
    occupancy history may differ), and its last file is the sweep's end:
    a resume from it runs no chunk and gives the same result."""
    kw, _ = MODES["recycled"]
    path = str(tmp_path / "pipe.npz")
    eng = t_engine()
    res = tsweep.sweep(None, eng.cfg, SEEDS, engine=eng, pipeline=True,
                       max_steps=3_000, checkpoint_path=path,
                       checkpoint_every_chunks=3, **KW, **kw)
    assert res.loop_stats["chunks"] > 1
    assert_resumed_equal(jax_results["recycled"], res)
    again = tsweep.sweep(None, eng.cfg, SEEDS, engine=eng, pipeline=True,
                         max_steps=3_000, checkpoint_path=path, resume=True,
                         **KW, **kw)
    assert again.loop_stats["chunks"] == 1
    assert_resumed_equal(jax_results["recycled"], again)


def test_resume_refusals(tmp_path):
    """Another batch width (full-shape contract), a recycled file resumed
    plain, and a blackbox-on file under a blackbox-off engine."""
    path = str(tmp_path / "hunt.npz")
    eng = t_engine()
    tsweep.sweep(None, eng.cfg, SEEDS, engine=eng, pipeline=False,
                 max_steps=64, checkpoint_path=path,
                 checkpoint_every_chunks=1, recycle=True, batch_worlds=8,
                 **KW)
    with pytest.raises(ValueError, match="full-shape"):
        tsweep.sweep(None, eng.cfg, SEEDS, engine=eng, max_steps=3_000,
                     checkpoint_path=path, resume=True, recycle=True,
                     batch_worlds=4, **KW)
    with pytest.raises(CheckpointError, match="recycled"):
        tsweep.sweep(None, eng.cfg, SEEDS, engine=eng, max_steps=3_000,
                     checkpoint_path=path, resume=True, **KW)
    plain = str(tmp_path / "plain.npz")
    tsweep.sweep(None, eng.cfg, SEEDS, engine=eng, max_steps=64,
                 checkpoint_path=plain, **KW)
    with pytest.raises(CheckpointError, match="non-recycled"):
        tsweep.sweep(None, eng.cfg, SEEDS, engine=eng, max_steps=3_000,
                     checkpoint_path=plain, resume=True, recycle=True,
                     batch_worlds=8, **KW)
    off = t_engine(blackbox=0)
    with pytest.raises(CheckpointError, match="different engine config"):
        tsweep.sweep(None, off.cfg, SEEDS, engine=off, max_steps=3_000,
                     checkpoint_path=plain, resume=True, **KW)


def test_fused_refuses_checkpoint_as_jax_does(tmp_path):
    eng = t_engine()
    je = J.DeviceEngine(J.RaftActor(J.RaftDeviceConfig(**RK)),
                        J.EngineConfig(**CK))
    msgs = []
    for mod, e, extra in ((tsweep, eng, {}), (jsweep, je, {"mesh": MESH1})):
        with pytest.raises(ValueError,
                           match="fused=True cannot checkpoint") as exc:
            mod.sweep(None, e.cfg, np.arange(8), engine=e, fused=True,
                      checkpoint_path=str(tmp_path / "x.npz"), **extra)
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]


# ---------------------------------------------------------------------------
# The guided search: the corpus, the per-slot schedules, the lineage lanes
# and the operator table ride the file (test_search.py, test_lineage.py).
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    th = thunts.pair_hunt()
    jh = jhunts.pair_hunt()
    je = J.DeviceEngine(jh.actor, jh.cfg)
    return th, je


def guided(th, eng, n, **kw):
    return tsweep.sweep(None, th.cfg, np.arange(n), engine=eng,
                        faults=th.template, search=th.search(True),
                        **dict(th.sweep_kw, **kw))


@pytest.mark.parametrize("pipeline", [False, True])
def test_guided_sweep_resumes_to_jax_unbroken(pair, tmp_path, pipeline):
    """The pair hunt at 96 seeds through 32 slots, interrupted after its
    second refill (chunk 2 of 3) and resumed in a fresh engine, equals
    JAX's unbroken hunt: observations, the SearchReport (schedules,
    corpus, generations, inserts, lineage, operator table) and the
    coverage ledger."""
    th, je = pair
    jr = jsweep.sweep(None, je.cfg, np.arange(96), engine=je, mesh=MESH1,
                      pipeline=False, faults=th.template,
                      search=JSearchConfig(**vars(th.search(True))),
                      **th.sweep_kw)
    path = str(tmp_path / "guided.npz")
    part = guided(th, T.DeviceEngine(th.actor, th.cfg, device="cpu"), 96,
                  pipeline=pipeline, max_steps=64, checkpoint_path=path,
                  checkpoint_every_chunks=1)
    assert part.search.generations == 2
    tr = guided(th, T.DeviceEngine(th.actor, th.cfg, device="cpu"), 96,
                pipeline=pipeline, checkpoint_path=path, resume=True)
    for k, v in jr.observations.items():
        np.testing.assert_array_equal(tr.observations[k], v, err_msg=k)
    np.testing.assert_array_equal(tr.bug, jr.bug)
    np.testing.assert_array_equal(tr.coverage.hits, jr.coverage.hits)
    a, b = jr.search, tr.search
    for f in ("generations", "inserted", "corpus_size"):
        assert getattr(b, f) == getattr(a, f), f
    for f in ("corpus_sched", "corpus_sig", "corpus_score", "corpus_filled",
              "schedules", "corpus_entry", "corpus_depth"):
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(y, x, err_msg=f)
    for f in ("parent1", "parent2", "ops", "depth"):
        np.testing.assert_array_equal(getattr(b.lineage, f),
                                      getattr(a.lineage, f), err_msg=f)
    assert b.operator_stats == a.operator_stats


def test_guided_plain_and_lineage_mixups_refused(pair, tmp_path):
    th, _je = pair
    eng = T.DeviceEngine(th.actor, th.cfg, device="cpu")
    path = str(tmp_path / "guided.npz")
    guided(th, eng, 96, pipeline=False, max_steps=64, checkpoint_path=path,
           checkpoint_every_chunks=1)
    # A guided file resumed plain, and with lineage off.
    with pytest.raises(CheckpointError, match="guided"):
        tsweep.sweep(None, th.cfg, np.arange(96), engine=eng,
                     faults=th.template, checkpoint_path=path, resume=True,
                     **th.sweep_kw)
    import dataclasses

    with pytest.raises(CheckpointError, match="lineage"):
        tsweep.sweep(None, th.cfg, np.arange(96), engine=eng,
                     faults=th.template, checkpoint_path=path, resume=True,
                     search=dataclasses.replace(th.search(True),
                                                lineage=False),
                     **th.sweep_kw)
    # A plain file resumed guided.
    plain = str(tmp_path / "plain.npz")
    tsweep.sweep(None, th.cfg, np.arange(96), engine=eng,
                 faults=th.template, checkpoint_path=plain,
                 checkpoint_every_chunks=1, **dict(th.sweep_kw,
                                                   max_steps=64))
    with pytest.raises(CheckpointError, match="plain"):
        guided(th, eng, 96, checkpoint_path=plain, resume=True)


# ---------------------------------------------------------------------------
# The writer thread
# ---------------------------------------------------------------------------

def test_writer_failure_stops_the_sweep(tmp_path, monkeypatch):
    """A failed write is raised at the next submit or at the end: the
    sweep never goes on as if its checkpoint were durable."""
    from madsim_tpu_torch.engine import checkpoint as ckpt

    def broken(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt, "save", broken)
    eng = t_engine()
    for pipeline in (False, True):
        with pytest.raises(OSError, match="disk full"):
            tsweep.sweep(None, eng.cfg, SEEDS, engine=eng,
                         pipeline=pipeline, max_steps=64 * 2,
                         checkpoint_path=str(tmp_path / "x.npz"),
                         checkpoint_every_chunks=1, **KW)


def test_writer_latest_wins_under_contention(tmp_path, monkeypatch):
    """Many snapshots submitted faster than a slow disk takes them: the
    files land in submit order, none older after a newer one, and the
    last one submitted is the one on disk once the writer is flushed."""
    import sys
    import threading
    import time

    from madsim_tpu_torch.engine import checkpoint as ckpt

    written = []
    real = ckpt.save

    def slow(engine, state, path, extra_meta=None, extra_arrays=None):
        time.sleep(0.002)
        written.append(int(extra_arrays["cursor"]))
        real(engine, state, path, extra_meta=extra_meta,
             extra_arrays=extra_arrays)

    monkeypatch.setattr(ckpt, "save", slow)
    eng = t_engine()
    state = eng.init(np.arange(4))
    path = str(tmp_path / "w.npz")
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        writer = tsweep._AsyncCheckpointer(eng, path, {"k": "v"})
        submitters = []

        def submit_many(base):
            for i in range(25):
                writer.submit(state, {"cursor": np.int64(base + i)})

        # Submits come from one thread in the sweep; a second thread here
        # only presses on the writer's lock.
        for base in (0, 1000):
            t = threading.Thread(target=submit_many, args=(base,))
            submitters.append(t)
            t.start()
        for t in submitters:
            t.join(timeout=60)
            assert not t.is_alive()
        writer.flush_and_close()
        assert not writer._thread.is_alive()
    finally:
        sys.setswitchinterval(old)
    last = int(ckpt.load(eng, path, with_aux=True)[1]["cursor"])
    assert last == written[-1]
    assert last in (24, 1024)
    assert len(written) < 50
    for base in (0, 1000):
        mine = [c for c in written if base <= c < base + 25]
        assert mine == sorted(mine)
