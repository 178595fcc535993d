"""The fleet in the port (madsim_tpu_torch/fleet) against the JAX package
on the CPU, bitwise (tolerance 0: the fleet moves whole results; every
comparison is array equality).

The port's counterparts of tests/test_fleet.py's protocol units and
chaos matrix: a fleet sweep with injected worker kills, lease expiries,
duplicated completions, preemptions and dropped RPCs returns seed ids,
bug flags, per-seed observations (the ``m_*`` metrics frames among them)
and a coverage ledger bitwise those of a crash-free fleet and of the
port's single-host ``sweep()``; the port's clean and chaotic Raft
fleets equal JAX's ``fleet_sweep(..., mesh=seed_mesh(n_devices=1))`` on
those fields and on ``faults_sha256``, and their fleet
telemetry streams equal JAX's less the host's wall-clock fields (the
heartbeat numbering that chaos keys on is the sweep's telemetry cadence,
one record per scalar read, the same in both packages); the chaotic
fleet's digest is ``golden.GOLDEN_FLEET_RAFT``; the coalesced control
plane's RPC bound; the fleet on a 2-D mesh. The pb and tpc matrices are in
tests/test_torch_fleet_families.py; the session, preemption, torn
checkpoint, telemetry and stall cases in
tests/test_torch_fleet_session.py; the multiprocess leg (marked slow,
as JAX's) runs here with ``device="cpu"`` passed through.

The configuration is tests/test_fleet.py's: Raft ``buggy_double_vote``,
metrics on, 64 seeds in ranges of 16, chunks of 64. Each engine is built
with ``device="cpu"``. The CPU's plain step runs one thread here (a
module fixture), as its small ops gain nothing from more.
"""
import dataclasses
import importlib

import numpy as np
import pytest
import torch

import madsim_tpu.engine as J
import madsim_tpu.fleet as jfleet
import madsim_tpu_torch.engine as T
from madsim_tpu.parallel.mesh import seed_mesh
from madsim_tpu_torch.engine import golden
from madsim_tpu_torch.fleet import (
    ChaosConfig,
    Coordinator,
    FleetIntegrityError,
    LeaseTable,
    RetryPolicy,
    SeedRange,
    VirtualClock,
    fleet_sweep,
    split_ranges,
)

jsweep = importlib.import_module("madsim_tpu.parallel.sweep")
tsweep = importlib.import_module("madsim_tpu_torch.parallel.sweep")
MESH1 = seed_mesh(n_devices=1)

# tests/test_fleet.py's deployment and its full failure mix in one
# config (golden.FLEET_RAFT, which chip_smoke.py runs on the card).
RK = golden.FLEET_RAFT["raft"]
CK = golden.FLEET_RAFT["engine"]
SWEEP_KW = golden.FLEET_RAFT["sweep_kw"]
RAFT_SEEDS = np.arange(golden.FLEET_RAFT["n_seeds"])
CHAOS = ChaosConfig(**golden.FLEET_RAFT["chaos"])


def jchaos(c):
    """The JAX package's ChaosConfig with the same fields."""
    return jfleet.ChaosConfig(**dataclasses.asdict(c))


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


@pytest.fixture(scope="module")
def raft_single(raft_eng):
    """The port's single-host sweep of RAFT_SEEDS."""
    return tsweep.sweep(None, raft_eng.cfg, RAFT_SEEDS, engine=raft_eng,
                        **SWEEP_KW)


@pytest.fixture(scope="module")
def raft_fleets(raft_eng, tmp_path_factory):
    """The port's clean and chaotic Raft fleets, with their telemetry and
    the chaotic fleet's checkpoint directory."""
    out = {}
    for name, chaos in (("clean", None), ("chaotic", CHAOS)):
        recs = []
        ck = (str(tmp_path_factory.mktemp("tck")) if chaos is not None
              else None)
        res = fleet_sweep(None, raft_eng.cfg, RAFT_SEEDS, engine=raft_eng,
                          n_workers=2, range_size=16, chaos=chaos,
                          checkpoint_dir=ck, observe=recs.append,
                          **SWEEP_KW)
        out[name] = (res, recs, ck)
    return out


@pytest.fixture(scope="module")
def jax_fleets(tmp_path_factory):
    """JAX's clean and chaotic Raft fleets on a one-device mesh."""
    eng = J.DeviceEngine(J.RaftActor(J.RaftDeviceConfig(**RK)),
                         J.EngineConfig(**CK))
    out = {}
    for name, chaos in (("clean", None), ("chaotic", jchaos(CHAOS))):
        recs = []
        ck = (str(tmp_path_factory.mktemp("jck")) if chaos is not None
              else None)
        res = jfleet.fleet_sweep(None, eng.cfg, RAFT_SEEDS, engine=eng,
                                 mesh=MESH1, n_workers=2, range_size=16,
                                 chaos=chaos, checkpoint_dir=ck,
                                 observe=recs.append, **SWEEP_KW)
        out[name] = (res, recs, ck)
    return out


def assert_contract_equal(a, b):
    """The crash-identical contract: ids, bug flags, observations
    (metrics frames included), coverage ledger."""
    np.testing.assert_array_equal(a.seeds, b.seeds)
    np.testing.assert_array_equal(a.bug, b.bug)
    assert set(a.observations) == set(b.observations)
    for k in a.observations:
        assert a.observations[k].dtype == b.observations[k].dtype, k
        np.testing.assert_array_equal(a.observations[k], b.observations[k],
                                      err_msg=k)
    assert a.failing_seeds == b.failing_seeds
    assert (a.coverage is None) == (b.coverage is None)
    if a.coverage is not None:
        np.testing.assert_array_equal(a.coverage.hits, b.coverage.hits)
        np.testing.assert_array_equal(a.coverage.first_seen_seed,
                                      b.coverage.first_seen_seed)
        assert a.coverage.distinct_behaviors == b.coverage.distinct_behaviors


def timeless(rec, root=None):
    """A fleet record without the host's wall-clock fields (any key
    ending ``_s``), its checkpoint paths relative to ``root``."""
    if isinstance(rec, dict):
        return {k: timeless(v, root) for k, v in rec.items()
                if not k.endswith("_s")}
    if isinstance(rec, str) and root and rec.startswith(root):
        return "<ck>" + rec[len(root):]
    return rec


# ---------------------------------------------------------------------------
# Protocol units (no device work)
# ---------------------------------------------------------------------------

def test_split_ranges_tiles_and_is_deterministic():
    rs = split_ranges(100, 32)
    assert [r.range_id for r in rs] == [0, 1, 2, 3]
    assert rs[0].lo == 0 and rs[-1].hi == 100
    assert sum(r.n_seeds for r in rs) == 100
    assert split_ranges(100, 32) == rs  # pure function of the inputs
    assert [(r.lo, r.hi) for r in rs] == [
        (r.lo, r.hi) for r in jfleet.split_ranges(100, 32)]
    with pytest.raises(ValueError):
        split_ranges(10, 0)


def test_lease_table_expiry_reissue_and_dedup():
    table = LeaseTable(split_ranges(8, 4), ttl=5)
    a = table.issue("w0", now=0)
    b = table.issue("w1", now=0)
    assert a.range.range_id == 0 and b.range.range_id == 1
    assert table.issue("w0", now=0) is None  # nothing pending
    assert table.heartbeat(a.lease_id, "w0", now=3)
    assert not table.heartbeat(999, "w0", now=3)
    assert not table.heartbeat(a.lease_id, "w1", now=3)  # wrong holder
    reaped = table.expire(now=6)
    assert [l.range.range_id for l in reaped] == [1]
    c = table.issue("w0", now=6)
    assert c.range.range_id == 1 and c.generation == 1
    first, _ = table.complete(1, b.lease_id)
    assert first
    dup, _ = table.complete(1, c.lease_id)
    assert not dup
    assert table.release(a.lease_id, "w0", checkpoint="/tmp/ck.npz")
    d = table.issue("w1", now=7)
    assert d.range.range_id == 0 and d.checkpoint == "/tmp/ck.npz"


def test_retry_backoff_is_deterministic_and_jittered():
    p = RetryPolicy(seed=3, base_delay=1.0, jitter=0.5)
    q = RetryPolicy(seed=3, base_delay=1.0, jitter=0.5)
    d = [p.delay("w0:acquire", a) for a in range(4)]
    assert d == [q.delay("w0:acquire", a) for a in range(4)]  # replayable
    assert d[1] > d[0] and d[2] > d[1]
    assert d != [p.delay("w1:acquire", a) for a in range(4)]  # desynced
    # The jitter is JAX's splitmix64 draw, bit for bit.
    jp = jfleet.RetryPolicy(seed=3, base_delay=1.0, jitter=0.5)
    assert d == [jp.delay("w0:acquire", a) for a in range(4)]


def test_call_with_retry_exhaustion_and_success():
    from madsim_tpu_torch.fleet import (RetryExhausted, RpcError,
                                        call_with_retry)

    clock = VirtualClock()
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise RpcError("boom")
        return "ok"

    assert call_with_retry(flaky, RetryPolicy(max_attempts=5), clock,
                           "t") == "ok"
    assert calls["n"] == 3
    assert clock.now() > 0  # backoff advanced the fabric clock
    with pytest.raises(RetryExhausted):
        call_with_retry(lambda: (_ for _ in ()).throw(RpcError("x")),
                        RetryPolicy(max_attempts=2), clock, "t2")


def _fake_result(seeds, bug_at=()):
    obs = {"bug": np.isin(np.arange(len(seeds)), bug_at),
           "steps": np.ones(len(seeds), np.int32)}
    return tsweep.SweepResult(seeds=np.asarray(seeds, np.uint64),
                              bug=obs["bug"], observations=obs, steps_run=1,
                              n_devices=1)


def test_duplicate_mismatch_raises_integrity_error():
    clock = VirtualClock()
    coord = Coordinator(np.arange(8), range_size=8, lease_ttl=10,
                        clock=clock)
    lease = coord.rpc_acquire(worker_id="w0")
    coord.rpc_complete(worker_id="w0", lease_id=lease["lease_id"],
                       range_id=0, result=_fake_result(np.arange(8)))
    out = coord.rpc_complete(worker_id="w1", lease_id=lease["lease_id"],
                             range_id=0, result=_fake_result(np.arange(8)))
    assert out["duplicate"]
    assert coord.stats["duplicates_crosschecked"] == 1
    with pytest.raises(FleetIntegrityError, match="bitwise"):
        coord.rpc_complete(worker_id="w1", lease_id=lease["lease_id"],
                           range_id=0,
                           result=_fake_result(np.arange(8), bug_at=(3,)))


def test_merge_requires_tiling_ranges():
    from madsim_tpu_torch.fleet import merge_range_results

    with pytest.raises(ValueError, match="not completed"):
        merge_range_results(np.arange(8), [SeedRange(0, 0, 8)], {}, 1)


# ---------------------------------------------------------------------------
# The chaos matrix, and the port held to JAX
# ---------------------------------------------------------------------------

def test_chaos_matrix_raft(raft_single, raft_fleets):
    """Raft with coverage and metrics: single-host == clean fleet ==
    chaotic fleet, and every failure mode fired."""
    clean, chaotic = raft_fleets["clean"][0], raft_fleets["chaotic"][0]
    assert_contract_equal(raft_single, clean)
    assert_contract_equal(raft_single, chaotic)
    assert raft_single.failing_seeds, "matrix must exercise failing seeds"
    st = chaotic.loop_stats["fleet"]
    assert st["kills"] >= 1
    assert st["preemptions"] >= 1
    assert st["leases_expired"] >= 1
    assert st["leases_reissued"] >= 1
    assert st["duplicate_completions"] >= 1
    assert st["duplicates_crosschecked"] == st["duplicate_completions"]
    assert st["rpc_retries"] >= 1


@pytest.mark.parametrize("name", ["clean", "chaotic"])
def test_fleet_equals_jax_fleet(raft_fleets, jax_fleets, name):
    """The port's fleet equals JAX's on one device: the contract fields,
    ``faults_sha256``, the fleet counters, and the whole fleet telemetry
    stream less its wall-clock fields (so the chaos landed on the same
    heartbeats: each package's worker counts one beat per sweep
    telemetry record)."""
    tres, trecs, tck = raft_fleets[name]
    jres, jrecs, jck = jax_fleets[name]
    assert_contract_equal(jres, tres)
    assert tres.faults_sha256 == jres.faults_sha256
    assert [timeless(r, tck) for r in trecs] == \
        [timeless(r, jck) for r in jrecs]
    tst, jst = tres.loop_stats["fleet"], jres.loop_stats["fleet"]
    for key in ("leases_issued", "leases_reissued", "leases_expired",
                "leases_released", "heartbeats", "heartbeats_lost",
                "completions", "duplicate_completions", "kills",
                "preemptions", "rpc_retries", "fabric_ticks", "rpc_turns",
                "control_rpcs_per_lease", "grouped_leases",
                "session_reuse_hits"):
        assert tst[key] == jst[key], key


def test_chaotic_fleet_digest_is_the_jax_golden(raft_fleets, jax_fleets):
    """``golden.GOLDEN_FLEET_RAFT`` (phase 12 (f) of chip_smoke.py holds
    the card's fleet to it) is JAX's chaotic fleet, and the port's."""
    assert golden.fleet_digest(jax_fleets["chaotic"][0]) == \
        golden.GOLDEN_FLEET_RAFT
    assert golden.fleet_digest(raft_fleets["chaotic"][0]) == \
        golden.GOLDEN_FLEET_RAFT


def test_merged_result_refuses_minimize(raft_fleets):
    """A merged fleet result carries no triage context (its ranges ran
    on workers whose engines it does not hold): ``minimize`` refuses it
    with the TriageError that names the way out."""
    from madsim_tpu_torch.triage import TriageError

    res = raft_fleets["clean"][0]
    assert res.triage_ctx is None and res.failing_seeds
    with pytest.raises(TriageError, match="no triage context"):
        res.minimize()


def test_fleet_composes_with_multihost_mesh(raft_eng, raft_single):
    """The DCN×ICI leg (JAX's test of the same name): every worker sweeps
    its leases on a 2-D multihost mesh (here 2 hosts × 2 blocks of the
    CPU: each block is stepped apart, so the CPU pays per block) under
    chaos, and the merged result equals the single-host reference and
    JAX's fleet on its own (2, 2) mesh under the same chaos,
    ``faults_sha256`` included."""
    import jax

    from madsim_tpu.parallel.mesh import multihost_mesh as jmultihost
    from madsim_tpu_torch.parallel.mesh import multihost_mesh

    mesh2d = multihost_mesh([torch.device("cpu")] * 4, n_hosts=2)
    assert mesh2d.devices.shape == (2, 2)
    assert mesh2d.axis_names == ("dcn", "worlds")
    chaos = ChaosConfig(seed=5, kill_at=(("w1", 3),), restart_after=1)
    fleet = fleet_sweep(None, raft_eng.cfg, RAFT_SEEDS, engine=raft_eng,
                        mesh=mesh2d, n_workers=2, range_size=16,
                        chaos=chaos, **SWEEP_KW)
    assert_contract_equal(raft_single, fleet)
    assert fleet.loop_stats["fleet"]["kills"] == 1
    assert fleet.n_devices == 4
    je = J.DeviceEngine(J.RaftActor(J.RaftDeviceConfig(**RK)),
                        J.EngineConfig(**CK))
    jmesh = jmultihost(jax.devices()[:4], n_hosts=2)
    assert jmesh.devices.shape == (2, 2)
    jres = jfleet.fleet_sweep(None, je.cfg, RAFT_SEEDS, engine=je,
                              mesh=jmesh, n_workers=2, range_size=16,
                              chaos=jchaos(chaos), **SWEEP_KW)
    assert_contract_equal(jres, fleet)
    assert fleet.faults_sha256 == jres.faults_sha256
    assert fleet.n_devices == jres.n_devices


def test_fleet_control_rpcs_bounded_per_lease(raft_single, raft_fleets):
    """The coalesced control plane's gate: a clean fleet's non-heartbeat
    transport turns per issued lease stay within
    MAX_CONTROL_RPCS_PER_LEASE."""
    from madsim_tpu_torch.fleet import MAX_CONTROL_RPCS_PER_LEASE

    fleet = raft_fleets["clean"][0]
    assert_contract_equal(raft_single, fleet)
    stats = fleet.loop_stats["fleet"]
    assert stats["leases_prefetched"] >= 1
    assert stats["grouped_leases"] >= 2
    assert stats["session_reuse_hits"] >= 1
    assert stats["control_rpcs_per_lease"] <= MAX_CONTROL_RPCS_PER_LEASE
    turns = stats["rpc_turns"]
    assert turns["acquire"] <= 2 * MAX_CONTROL_RPCS_PER_LEASE
    assert turns.get("batch", 0) >= 2
    assert turns.get("complete", 0) == 0  # completions only ride batches
    assert stats["acquire_s"] >= 0.0 and stats["sweep_s"] > 0.0
    assert "merge_s" in stats


# ---------------------------------------------------------------------------
# Multiprocess leg (real processes + signals), marked slow as JAX's
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_process_fleet_smoke(tmp_path):
    """Two spawned worker processes on the CPU (``device="cpu"`` passed
    through; the default is CUDA), one SIGKILLed mid-lease: the merged
    result equals the single-host sweep (recovery via lease TTL and
    respawn), and each worker reported its start."""
    cfg = T.EngineConfig(**dict(CK, metrics=False))
    eng = T.DeviceEngine(T.RaftActor(T.RaftDeviceConfig(**RK)), cfg,
                         device="cpu")
    seeds = np.arange(24)
    single = tsweep.sweep(None, cfg, seeds, engine=eng, **SWEEP_KW)
    fleet = fleet_sweep(T.RaftActor(T.RaftDeviceConfig(**RK)), cfg, seeds,
                        n_workers=2, range_size=8, spawn="process",
                        lease_ttl=5.0, device="cpu",
                        checkpoint_dir=str(tmp_path / "ck"),
                        kill_after_heartbeats={"w0": 1},
                        serve_timeout_s=300.0, **SWEEP_KW)
    np.testing.assert_array_equal(single.bug, fleet.bug)
    for k in single.observations:
        np.testing.assert_array_equal(single.observations[k],
                                      fleet.observations[k], err_msg=k)
    reports = fleet.loop_stats["fleet"]["worker_reports"]
    assert set(reports) == {"w0", "w1"}
    assert all(life["device"] == "cpu" for r in reports.values()
               for life in r["lives"])
