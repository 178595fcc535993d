"""The fleet worker's session and the fleet's recovery paths in the port
(madsim_tpu_torch/parallel/sweep.py::SweepSession, madsim_tpu_torch/fleet)
on the CPU, bitwise (tolerance 0).

The port's counterparts of the rest of tests/test_fleet.py:

- ``SweepSession.run_group``: every per-range result's contract fields
  equal a fresh solo ``sweep()`` of the range, the second group riding
  the recycled standing slots; each group equals JAX's
  ``SweepSession(mesh=seed_mesh(n_devices=1)).run_group`` range by range,
  with the same superstep reads; the grouped quantum pulls through
  ``_fetch`` no more often than the solo sweeps; an exception out of the
  grouped loop drops the standing batch;
- preemption (the lease released with its checkpoint, resumed by the
  next holder) and the torn checkpoint (discarded, the range re-run),
  each equal to the single-host sweep;
- the fleet telemetry's JSONL stream and ``watch``;
- the stall reports of a fleet whose only worker died (with and without
  lease prefetch).

The configuration is tests/test_fleet.py's (Raft ``buggy_double_vote``,
metrics on, chunks of 64). Engines are built with ``device="cpu"``; the
CPU's plain step runs one thread here (a module fixture).
"""
import importlib
import io
import json

import numpy as np
import pytest
import torch

import madsim_tpu.engine as J
import madsim_tpu_torch.engine as T
from madsim_tpu.parallel import SweepSession as JSweepSession
from madsim_tpu.parallel.mesh import seed_mesh
from madsim_tpu_torch.fleet import ChaosConfig, FleetStalledError, fleet_sweep
from madsim_tpu_torch.fleet.merge import contract_mismatches
from madsim_tpu_torch.parallel import SweepSession

tsweep = importlib.import_module("madsim_tpu_torch.parallel.sweep")
MESH1 = seed_mesh(n_devices=1)

RK = dict(n=3, buggy_double_vote=True)
CK = dict(n_nodes=3, outbox_cap=4, queue_cap=64, t_limit_us=1_500_000,
          stop_on_bug=True, metrics=True)
SWEEP_KW = dict(chunk_steps=64, max_steps=20_000)
# tests/test_fleet.py's two groups of three 16-seed ranges.
GROUPS = [np.arange(48, dtype=np.uint64),
          np.arange(100, 148, dtype=np.uint64)]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def raft_eng():
    return T.DeviceEngine(T.RaftActor(T.RaftDeviceConfig(**RK)),
                          T.EngineConfig(**CK), device="cpu")


def parts_of(seeds):
    return [{"seeds": seeds[lo:lo + 16], "faults": None}
            for lo in range(0, 48, 16)]


def counting_fetch(monkeypatch):
    """Patch the port's ``_fetch`` to count its calls."""
    counter = {"n": 0}
    real = tsweep._fetch

    def fetch(x):
        counter["n"] += 1
        return real(x)

    monkeypatch.setattr(tsweep, "_fetch", fetch)
    return counter


@pytest.fixture(scope="module")
def session_runs(raft_eng):
    """Both groups through one port session (their telemetry and
    ``_fetch`` calls), each range solo (its ``_fetch`` calls), and JAX's
    session on one device."""
    mp = pytest.MonkeyPatch()
    try:
        counter = counting_fetch(mp)
        sess = SweepSession(engine=raft_eng, **SWEEP_KW)
        grouped, solo = [], []
        for seeds in GROUPS:
            recs = []
            counter["n"] = 0
            res = sess.run_group(parts_of(seeds), observe=recs.append)
            grouped.append((res, recs, counter["n"]))
            runs = []
            for part in parts_of(seeds):
                counter["n"] = 0
                runs.append((tsweep.sweep(None, raft_eng.cfg, part["seeds"],
                                          engine=raft_eng, **SWEEP_KW),
                             counter["n"]))
            solo.append(runs)
    finally:
        mp.undo()
    jeng = J.DeviceEngine(J.RaftActor(J.RaftDeviceConfig(**RK)),
                          J.EngineConfig(**CK))
    jsess = JSweepSession(engine=jeng, mesh=MESH1, **SWEEP_KW)
    jgrouped = []
    for seeds in GROUPS:
        recs = []
        jgrouped.append((jsess.run_group(parts_of(seeds),
                                         observe=recs.append), recs))
    return sess, grouped, solo, jsess, jgrouped


def test_session_run_group_bitwise_equals_solo_sweeps(session_runs):
    """Every per-range result of run_group is interchangeable with a
    fresh solo sweep of the range, the second group (the refill path of
    the recycled standing slots) included; only the first range paid an
    install."""
    sess, grouped, solo, _, _ = session_runs
    for gi, ((results, _, _), runs) in enumerate(zip(grouped, solo)):
        assert len(results) == 3
        for res, (single, _) in zip(results, runs):
            assert contract_mismatches(single, res) == []
            assert res.loop_stats["session_group"] == 3
            assert res.loop_stats["session_reused_slots"] == (gi > 0)
    assert sess.reuse_hits == 5


def test_session_run_group_equals_jax(session_runs):
    """Group by group, the port's session equals JAX's on one device: the
    contract fields of each range, the superstep reads (one telemetry
    record each, equal less the wall clock) and the reuse count."""
    sess, grouped, _, jsess, jgrouped = session_runs
    for (tres, trecs, _), (jres, jrecs) in zip(grouped, jgrouped):
        for t, j in zip(tres, jres):
            assert contract_mismatches(j, t) == []
            assert t.faults_sha256 == j.faults_sha256
            for key in ("chunks", "dispatches", "scalar_fetches",
                        "session_group", "session_reused_slots"):
                assert t.loop_stats[key] == j.loop_stats[key], key
        assert [{k: v for k, v in r.items() if k != "elapsed_s"}
                for r in trecs] == \
            [{k: v for k, v in r.items() if k != "elapsed_s"}
             for r in jrecs]
    assert sess.reuse_hits == jsess.reuse_hits


def test_session_grouped_adds_no_device_fetches(session_runs):
    """A grouped quantum pulls through ``_fetch`` no more often than the
    same ranges swept solo (one scalar read per superstep and one ledger
    pull for the whole group)."""
    _, grouped, solo, _, _ = session_runs
    for (_, _, n_grouped), runs in zip(grouped, solo):
        n_solo = sum(n for _, n in runs)
        assert n_grouped <= n_solo, (n_grouped, n_solo)


def test_session_drops_the_standing_batch_on_an_exception(raft_eng,
                                                          raft_single):
    """A kill raised from the observe callback mid-group (a BaseException,
    as the worker's WorkerKilled) propagates, and the next group installs
    fresh instead of refilling the dropped batch; its worlds are those of
    the single-host sweep (position independence)."""
    from madsim_tpu_torch.fleet import WorkerKilled

    sess = SweepSession(engine=raft_eng, **SWEEP_KW)
    seeds = np.arange(16, dtype=np.uint64)

    def kill(_rec):
        raise WorkerKilled("w0")

    with pytest.raises(WorkerKilled):
        sess.run_group([{"seeds": seeds, "faults": None}], observe=kill)
    assert sess._slot_state is None
    res = sess.run_group([{"seeds": seeds, "faults": None}])[0]
    assert res.loop_stats["session_reused_slots"] is False
    for k, v in raft_single.observations.items():
        np.testing.assert_array_equal(res.observations[k], v[:16],
                                      err_msg=k)


# ---------------------------------------------------------------------------
# Preemption and checkpoint recovery
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def raft_single(raft_eng):
    return tsweep.sweep(None, raft_eng.cfg, np.arange(64), engine=raft_eng,
                        **SWEEP_KW)


def test_preemption_releases_lease_and_resumes_checkpoint(raft_eng,
                                                          raft_single,
                                                          tmp_path):
    """The preempted worker's lease re-queues at once with its checkpoint;
    the next holder resumes it, and the result is still the single-host
    sweep's."""
    recs = []
    fleet = fleet_sweep(
        None, raft_eng.cfg, np.arange(64), engine=raft_eng, n_workers=2,
        range_size=32, observe=recs.append,
        checkpoint_dir=str(tmp_path / "ck"), checkpoint_every_chunks=1,
        chaos=ChaosConfig(seed=2, preempt_at=(("w0", 2),),
                          restart_after=2),
        **SWEEP_KW)
    assert contract_mismatches(raft_single, fleet) == []
    stats = fleet.loop_stats["fleet"]
    assert stats["preemptions"] >= 1
    assert stats["checkpoints_recovered"] >= 1
    events = [r["event"] for r in recs]
    assert "worker_preempted" in events
    assert "lease_released" in events
    assert "lease_resumed" in events
    rel = next(r for r in recs if r["event"] == "worker_preempted")
    assert rel["checkpoint"], "preemption must release WITH a checkpoint"


def test_torn_checkpoint_recovers_by_rerun(raft_eng, raft_single, tmp_path):
    """The killed worker's checkpoint is torn; the next holder's resume
    meets the loader's CheckpointError, discards the file and re-runs the
    range fresh, to the same result."""
    recs = []
    fleet = fleet_sweep(
        None, raft_eng.cfg, np.arange(64), engine=raft_eng, n_workers=2,
        range_size=32, observe=recs.append,
        checkpoint_dir=str(tmp_path / "ck"), checkpoint_every_chunks=1,
        chaos=ChaosConfig(seed=4, kill_at=(("w0", 3),),
                          tear_checkpoint_on_kill=True, restart_after=2),
        **SWEEP_KW)
    assert contract_mismatches(raft_single, fleet) == []
    stats = fleet.loop_stats["fleet"]
    assert stats["kills"] >= 1
    assert stats["checkpoints_discarded"] >= 1
    events = [r["event"] for r in recs]
    assert "checkpoint_torn" in events
    assert "checkpoint_corrupt" in events


# ---------------------------------------------------------------------------
# The telemetry stream
# ---------------------------------------------------------------------------

def test_fleet_telemetry_jsonl_and_watch(raft_eng, tmp_path):
    """The fleet's records land in a JSONL stream, schema'd, and the
    port's ``watch`` renders the fleet summary."""
    from madsim_tpu_torch.obs.observatory import watch

    path = str(tmp_path / "fleet.jsonl")
    fleet_sweep(None, raft_eng.cfg, np.arange(32), engine=raft_eng,
                n_workers=2, range_size=8, observe=path,
                chaos=ChaosConfig(seed=9, kill_at=(("w1", 2),),
                                  drop_rpc_rate=0.3, restart_after=1),
                **SWEEP_KW)
    with open(path) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    assert recs, "stream must not be empty"
    assert all(r["schema"] == "madsim.fleet.telemetry/1" for r in recs)
    events = {r["event"] for r in recs}
    assert {"lease_issued", "heartbeat", "completion",
            "fleet_summary"} <= events
    assert "worker_killed" in events and "lease_expired" in events
    assert "rpc_retry" in events
    reissues = [r for r in recs
                if r["event"] == "lease_issued" and r.get("reissued")]
    assert reissues and all(r["generation"] >= 1 for r in reissues)
    out = io.StringIO()
    assert watch(path, out=out) == 0
    text = out.getvalue()
    assert "fleet:" in text and "crosschecked" in text


# ---------------------------------------------------------------------------
# Stall reports
# ---------------------------------------------------------------------------

DEAD = ChaosConfig(seed=1, kill_at=(("w0", 1),), restart_after=-1)


@pytest.mark.parametrize("prefetch", [None, 0])
def test_fleet_stall_report(raft_eng, prefetch):
    """All workers dead with restarts off raises FleetStalledError naming
    each stuck range's holder, generation and heartbeat bookkeeping. With
    the default lease prefetch both of the dead worker's leases are named,
    the second as queued behind the running one; with ``prefetch=0`` the
    other range is pending re-issue."""
    with pytest.raises(FleetStalledError, match="dead") as exc:
        fleet_sweep(None, raft_eng.cfg, np.arange(16), engine=raft_eng,
                    n_workers=1, range_size=8, prefetch=prefetch,
                    chaos=DEAD, **SWEEP_KW)
    msg = str(exc.value)
    assert "range 0: held by w0" in msg
    assert "last heartbeat" in msg and "heartbeats" in msg
    assert "expires t=" in msg
    if prefetch is None:
        assert "range 1: held by w0" in msg
        assert "prefetched behind lease 0" in msg
    else:
        assert "prefetched" not in msg
        assert "range 1: pending" in msg
