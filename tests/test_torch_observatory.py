"""The sweep observatory of the port (madsim_tpu_torch/obs/observatory.py
and the hooks of ``parallel/sweep.py``) against the JAX package on the
CPU:

- an ``observe=``-on sweep, in the serial, the pipelined and the fused
  loop, is bitwise the same sweep without it, with the same ``_fetch``
  calls, device-flag reads (``loop_stats["flag_reads"]``) and steps, and
  its records equal the JAX package's apart from the monotonic-time
  fields (:data:`CLOCK`: ``elapsed_s``, ``seeds_per_s``, ``eta_s``, and
  the summary's ``loop_stats`` times) and the port's ``flag_reads``;
- the same for the ``madsim.search.telemetry/1`` records of a guided
  sweep (the pair hunt);
- the JSONL stream, ``watch`` (summary and follow, with fleet, exchange
  and search records interleaved) and the Prometheus text and snapshot
  render as JAX's do;
- ``profile_dir=`` writes a ``torch.profiler`` Chrome trace naming the
  loop's dispatches and changes nothing; the window's validation.

JAX runs on a one-device mesh. W <= 128 seeds through <= 32 slots.
Tolerance: none.
"""
import importlib
import io
import json
import os
from contextlib import redirect_stdout

import numpy as np
import pytest

import madsim_tpu.engine as J
import madsim_tpu_torch.engine as T
from madsim_tpu.obs import observatory as jobs
from madsim_tpu.parallel.mesh import seed_mesh
from madsim_tpu.search import hunts as jhunts
from madsim_tpu_torch.engine import golden
from madsim_tpu_torch.obs import cli as tcli
from madsim_tpu_torch.obs import observatory as tobs
tsweep = importlib.import_module("madsim_tpu_torch.parallel.sweep")
from madsim_tpu_torch.search import hunts as thunts

jsweep = importlib.import_module("madsim_tpu.parallel.sweep")
MESH1 = seed_mesh(n_devices=1)
RK = dict(n=3, n_proposals=2, buggy_double_vote=True)
CK = dict(n_nodes=3, outbox_cap=4, queue_cap=64, t_limit_us=1_500_000,
          metrics=True)
FAULTS = np.array([[300_000, J.FAULT_KILL, 0, 0],
                   [700_000, J.FAULT_RESTART, 0, 0]], np.int32)
SEEDS = np.arange(8)
RAFT_KW = dict(faults=FAULTS, chunk_steps=32, max_steps=192, recycle=True,
               batch_worlds=4)
LOOPS = {"serial": dict(pipeline=False), "pipeline": dict(pipeline=True),
         "fused": dict(fused=True)}
#: The fields read off the host's monotonic clock, which no two runs share.
CLOCK = ("elapsed_s", "seeds_per_s", "eta_s")
LOOP_CLOCK = ("device_wait_s", "host_decision_s", "dispatch_s",
              "retire_wait_s", "loop_wall_s")


def timeless(rec):
    """A record without its clock fields (and the summary's loop_stats
    without its times and the port's flag_reads)."""
    out = {k: v for k, v in rec.items() if k not in CLOCK}
    if "loop_stats" in out:
        out["loop_stats"] = {k: v for k, v in out["loop_stats"].items()
                             if k not in LOOP_CLOCK + ("flag_reads",)}
    return out


@pytest.fixture(scope="module")
def raft_engines():
    return (J.DeviceEngine(J.RaftActor(J.RaftDeviceConfig(**RK)),
                           J.EngineConfig(**CK)),
            T.DeviceEngine(T.RaftActor(T.RaftDeviceConfig(**RK)),
                           T.EngineConfig(**CK), device="cpu"))


@pytest.fixture(scope="module")
def pair_hunt_engines():
    jh, th = jhunts.pair_hunt(), thunts.pair_hunt()
    return (J.DeviceEngine(jh.actor, jh.cfg), jh,
            T.DeviceEngine(th.actor, th.cfg, device="cpu"), th)


def counted(te, monkeypatch, **kw):
    """A port sweep with its ``_fetch`` calls and plain steps counted."""
    n = {"fetch": 0, "steps": 0}
    real_fetch, real_step = tsweep._fetch, te.step_plain

    def fetch(tree):
        n["fetch"] += 1
        return real_fetch(tree)

    def step_plain(state):
        n["steps"] += 1
        return real_step(state)

    with monkeypatch.context() as mp:
        mp.setattr(tsweep, "_fetch", fetch)
        mp.setattr(te, "step_plain", step_plain)
        res = tsweep.sweep(None, te.cfg, kw.pop("seeds"), engine=te, **kw)
    return res, n


def assert_same_sweep(a, b):
    """Two port sweeps agree on every result and every loop count."""
    assert a.failing_seeds == b.failing_seeds
    assert list(a.observations) == list(b.observations)
    for k, v in a.observations.items():
        np.testing.assert_array_equal(b.observations[k], v, err_msg=k)
    for f in ("n_active_history", "n_active_chunks"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert (a.steps_run, a.world_utilization) == \
        (b.steps_run, b.world_utilization)
    assert a.summary() == b.summary()
    if a.coverage is not None:
        assert a.coverage.to_json() == b.coverage.to_json()
        np.testing.assert_array_equal(a.coverage.hits, b.coverage.hits)
    if a.search is not None:
        assert golden.search_digest(a.search) == \
            golden.search_digest(b.search)
        assert a.search.operator_stats == b.search.operator_stats
    assert {k: v for k, v in a.loop_stats.items() if k not in LOOP_CLOCK} \
        == {k: v for k, v in b.loop_stats.items() if k not in LOOP_CLOCK}


@pytest.mark.parametrize("loop", sorted(LOOPS))
def test_observe_is_invisible_and_its_records_are_jax_s(raft_engines, loop,
                                                        monkeypatch):
    je, te = raft_engines
    kw = dict(RAFT_KW, **LOOPS[loop])
    plain, n_plain = counted(te, monkeypatch, seeds=SEEDS, **kw)
    recs = []
    seen, n_seen = counted(te, monkeypatch, seeds=SEEDS,
                           observe=recs.append, **kw)
    assert_same_sweep(plain, seen)
    assert n_seen == n_plain
    assert seen.loop_stats["flag_reads"] == plain.loop_stats["flag_reads"]
    j_recs = []
    jsweep.sweep(None, je.cfg, SEEDS, engine=je, mesh=MESH1,
                 observe=j_recs.append, **kw)
    assert [timeless(r) for r in recs] == [timeless(r) for r in j_recs]
    progress, summary = recs[:-1], recs[-1]
    assert progress and all(r["schema"] == "madsim.sweep.telemetry/1"
                            for r in progress)
    # One record per host read of the loop's scalars.
    assert len(progress) == seen.loop_stats["scalar_fetches"]
    assert summary["schema"] == "madsim.sweep.telemetry/2"
    assert summary["event"] == "summary"
    assert summary["loop_stats"] == seen.loop_stats
    assert summary["coverage"] == seen.coverage.to_json()
    # The novelty curve, before the end-of-sweep fold of the live worlds.
    assert progress[-1]["coverage_distinct"] == \
        int(seen.coverage.novelty_curve[-1])


@pytest.mark.parametrize("loop", sorted(LOOPS))
def test_search_records_of_a_guided_sweep_are_jax_s(pair_hunt_engines,
                                                    loop, monkeypatch):
    je, jh, te, th = pair_hunt_engines
    kw = dict(faults=th.template, stop_on_first_bug=True, **LOOPS[loop],
              **th.sweep_kw)
    seeds = np.arange(128)
    plain, n_plain = counted(te, monkeypatch, seeds=seeds,
                             search=th.search(True), **kw)
    recs = []
    seen, n_seen = counted(te, monkeypatch, seeds=seeds,
                           search=th.search(True), observe=recs.append,
                           **kw)
    assert_same_sweep(plain, seen)
    assert n_seen == n_plain
    j_recs = []
    jsweep.sweep(None, jh.cfg, seeds, engine=je, mesh=MESH1,
                 search=jh.search(True), observe=j_recs.append, **kw)
    assert [timeless(r) for r in recs] == [timeless(r) for r in j_recs]
    search = [r for r in recs if r["schema"] == "madsim.search.telemetry/1"]
    assert search and all(r["event"] == "refill" for r in search)
    if loop == "fused":
        assert all("epochs_on_device" in r for r in search)
    else:
        assert len(search) == seen.search.generations
        assert "op_survived_splice" in search[-1]
    finds = recs[-1]["search"]["finds"]
    assert [f["seed"] for f in finds] == seen.failing_seeds == [72]


@pytest.fixture(scope="module")
def stream(raft_engines, tmp_path_factory):
    """A JSONL stream of a port sweep (observe=<path>)."""
    _je, te = raft_engines
    path = str(tmp_path_factory.mktemp("tele") / "tele.jsonl")
    res = tsweep.sweep(None, te.cfg, SEEDS, engine=te, observe=path,
                       **dict(RAFT_KW, pipeline=False))
    return path, res


def test_jsonl_stream_watch_and_prometheus_render_as_jax(stream, tmp_path):
    path, res = stream
    records = tobs._load_records(path)
    assert records[-1]["event"] == "summary"
    assert records[-1]["failing_seeds"] == len(res.failing_seeds)
    shown = {}
    for follow in (False, True):
        outs = []
        for mod in (tobs, jobs):
            buf = io.StringIO()
            prom = str(tmp_path / f"{mod.__name__}.{follow}.prom")
            assert mod.watch(path, follow=follow, prom=prom,
                             interval=0.01, out=buf) == 0
            outs.append((buf.getvalue(), open(prom).read()))
        assert outs[0] == outs[1]
        shown[follow] = outs[0]
    assert "final:" in shown[False][0]
    assert "madsim_records_sweep" in shown[False][1]
    for rec in records:
        assert tobs.prometheus_text(rec) == jobs.prometheus_text(rec)
    assert tobs.prometheus_snapshot(records) == \
        jobs.prometheus_snapshot(records)
    # The CLI's watch subcommand.
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert tcli.main(["watch", path]) == 0
    assert buf.getvalue() == shown[False][0]
    assert tcli.main(["watch", str(tmp_path / "missing.jsonl")]) == 2


def test_watch_renders_fleet_exchange_and_search_records_as_jax(tmp_path):
    """The renderers of the streams other producers write (the fleet,
    its corpus exchange, a fused guided hunt) are JAX's."""
    records = [
        {"schema": "madsim.sweep.telemetry/1", "elapsed_s": 0.5,
         "chunks": 3, "n_active": 8, "batch_worlds": 16, "occupancy": 0.5,
         "seeds_total": 32, "seeds_done": 4, "seeds_per_s": 8.0,
         "coverage_distinct": 3, "eta_s": 2.0, "bug_seen": True},
        {"schema": "madsim.fleet.telemetry/1", "event": "lease_issued",
         "t": 1, "worker": "w0", "range_id": 0, "lease_id": 0,
         "generation": 0},
        {"schema": "madsim.fleet.exchange/1", "event": "publish", "t": 2,
         "worker": "w0", "range_id": 0, "epoch": 0, "bytes": 3360,
         "duplicate": True, "corpus_size": 2},
        {"schema": "madsim.fleet.exchange/1", "event": "merge", "t": 3,
         "epoch": 0, "ranges_merged": 2, "corpus_inserted": 5,
         "corpus_size": 6, "corpus_gen": 1, "epochs_merged": 1},
        {"schema": "madsim.search.telemetry/1", "event": "refill",
         "elapsed_s": 1.25, "generation": 3, "corpus_size": 17,
         "corpus_inserted": 16, "refill_novel": 2, "refill_inserted": 2,
         "epochs_on_device": 5, "op_survived_splice": 4},
        {"schema": "madsim.fleet.telemetry/1", "event": "fleet_summary",
         "t": 9, "completions": 4, "leases_expired": 1},
        {"schema": "madsim.sweep.telemetry/2", "event": "summary",
         "elapsed_s": 1.0, "seeds_total": 32, "failing_seeds": 0,
         "world_utilization": 0.9, "seeds_per_dispatch": 2.0,
         "epochs_on_device": 5,
         "loop_stats": {"chunks": 6, "dispatches": 3, "fused": True}},
    ]
    path = tmp_path / "mixed.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in records))
    for follow in (False, True):
        outs = []
        for mod in (tobs, jobs):
            buf = io.StringIO()
            assert mod.watch(str(path), follow=follow, interval=0.01,
                             out=buf) == 0
            outs.append(buf.getvalue())
        assert outs[0] == outs[1]
    assert "exchange:" in outs[0] and "fleet summary" in outs[0]
    assert tobs.prometheus_snapshot(records) == \
        jobs.prometheus_snapshot(records)


def test_make_observer_contract(tmp_path):
    assert tobs.make_observer(None) == (None, None)
    sink = []
    emit, close = tobs.make_observer(sink.append)
    emit({"x": 1})
    assert sink == [{"x": 1}] and close is None
    with pytest.raises(TypeError, match="observe"):
        tobs.make_observer(42)
    path = tmp_path / "s.jsonl"
    emit, close = tobs.make_observer(str(path))
    emit({"a": True})
    close()
    emit({"b": 1})                    # after close: dropped
    assert json.loads(path.read_text()) == {"a": True}


@pytest.mark.parametrize("loop,window", [("serial", (1, 3)),
                                         ("fused", (0, 1))])
def test_profile_dir_writes_a_torch_profiler_trace(pair_hunt_engines,
                                                   tmp_path, loop, window,
                                                   monkeypatch):
    """On the pair hunt's template, recycled (no search)."""
    _je, _jh, te, th = pair_hunt_engines
    kw = dict(th.sweep_kw, faults=th.template, **LOOPS[loop])
    seeds = np.arange(64)
    plain, n_plain = counted(te, monkeypatch, seeds=seeds, **kw)
    pdir = tmp_path / "prof"
    prof, n_prof = counted(te, monkeypatch, seeds=seeds,
                           profile_dir=str(pdir), profile_window=window,
                           **kw)
    assert_same_sweep(plain, prof)
    assert n_prof == n_plain
    files = sorted(os.listdir(pdir))
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    events = json.loads((pdir / files[0]).read_text())["traceEvents"]
    label = "madsim:chunk" if loop == "serial" else "madsim:fused_hunt"
    assert sum(e.get("name") == label for e in events) >= 1
    with pytest.raises(ValueError, match="profile_window"):
        tsweep.sweep(None, te.cfg, seeds, engine=te, profile_dir=str(pdir),
                     profile_window=(3, 3), **kw)
    # Without profile_dir the window is never opened.
    win = tobs.ProfilerWindow(None, (5, 1))
    win.before_dispatch()
    win.after_read()
    win.close()
    assert win.path is None and win.error is None
