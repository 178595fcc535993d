"""Repro bundles, timelines and the replay CLI of the port
(madsim_tpu_torch/obs/{bundle,timeline,cli}.py) against the JAX package
on the CPU:

- ``trace_to_chrome``, ``ring_to_chrome``, ``polls_to_chrome``,
  ``render_text`` and ``dump_chrome``: byte-equal to JAX's for the same
  trace and ring;
- ``write_sweep_bundle`` and ``config_digest``: the same file, byte for
  byte, for the same inputs;
- ``triage(result, out_dir)`` of a Raft hunt (metrics and a 16-deep ring
  on, so the bundle carries the ``madsim.blackbox/1`` block): the
  bundles byte-equal to JAX's, the minimizations equal (the pair
  families' bundles are in tests/test_torch_triage_bundles.py);
- a port bundle replays in a subprocess through ``python -m
  madsim_tpu_torch.obs replay --device cpu`` (rc 0, the trace ending in
  ``invariant:raise``), ``--crosscheck`` holds the Raft bundle's ring to
  the replayed trace, each package's bundle replays in the other's CLI,
  and a host-test bundle exits 2.

JAX runs on a one-device mesh. W <= 32. Tolerance: none, every operation
is integer.
"""
import filecmp
import importlib
import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stderr, redirect_stdout

import numpy as np
import pytest

import madsim_tpu.engine as J
import madsim_tpu_torch.engine as T
from madsim_tpu.obs import blackbox as jbb
from madsim_tpu.obs import bundle as jbundle
from madsim_tpu.obs import cli as jcli
from madsim_tpu.obs import timeline as jtl
from madsim_tpu.parallel.mesh import seed_mesh
from madsim_tpu.triage import triage as j_triage
from madsim_tpu_torch.obs import blackbox as tbb
from madsim_tpu_torch.obs import bundle as tbundle
from madsim_tpu_torch.obs import cli as tcli
from madsim_tpu_torch.obs import timeline as ttl
tsweep = importlib.import_module("madsim_tpu_torch.parallel.sweep")
from madsim_tpu_torch.triage import triage

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
jsweep = importlib.import_module("madsim_tpu.parallel.sweep")
MESH1 = seed_mesh(n_devices=1)
RK = dict(n=3, n_proposals=2, buggy_double_vote=True)
CK = dict(n_nodes=3, outbox_cap=4, queue_cap=64, t_limit_us=1_500_000,
          metrics=True, blackbox=16)
FAULTS = np.array([[300_000, J.FAULT_KILL, 0, 0],
                   [700_000, J.FAULT_RESTART, 0, 0]], np.int32)
RAFT_KW = dict(chunk_steps=64, max_steps=3_000)


@pytest.fixture(scope="module")
def raft_engines():
    return (J.DeviceEngine(J.RaftActor(J.RaftDeviceConfig(**RK)),
                           J.EngineConfig(**CK)),
            T.DeviceEngine(T.RaftActor(T.RaftDeviceConfig(**RK)),
                           T.EngineConfig(**CK), device="cpu"))


@pytest.fixture(scope="module")
def raft_triage(raft_engines, tmp_path_factory):
    """Both packages' sweep of the Raft hunt (16 seeds, kill/restart) and
    their triage into bundles."""
    je, te = raft_engines
    seeds = np.arange(16)
    jr = jsweep.sweep(None, je.cfg, seeds, engine=je, mesh=MESH1,
                      faults=FAULTS, **RAFT_KW)
    tr = tsweep.sweep(None, te.cfg, seeds, engine=te, faults=FAULTS,
                      **RAFT_KW)
    assert tr.failing_seeds == jr.failing_seeds and tr.failing_seeds
    jdir = tmp_path_factory.mktemp("jax_raft")
    tdir = tmp_path_factory.mktemp("torch_raft")
    return (jr, tr, j_triage(jr, str(jdir), **RAFT_KW),
            triage(tr, str(tdir), **RAFT_KW))


def same_dirs(jrep, trep):
    """The two reports name the same bundles, byte-equal."""
    assert list(trep.bundles) == list(jrep.bundles)
    for key, path in trep.bundles.items():
        assert os.path.basename(path) == os.path.basename(jrep.bundles[key])
        assert filecmp.cmp(path, jrep.bundles[key], shallow=False), key
    for key, mr in trep.minimized.items():
        jm = jrep.minimized[key]
        np.testing.assert_array_equal(mr.full, jm.full)
        assert mr.history == jm.history
        assert mr.provenance() == jm.provenance()
    assert trep.summary().replace(os.path.dirname(
        next(iter(trep.bundles.values()), "")), "") == \
        jrep.summary().replace(os.path.dirname(
            next(iter(jrep.bundles.values()), "")), "")


def test_timelines_are_byte_equal_to_jax(raft_engines, tmp_path):
    je, te = raft_engines
    trace = te.trace(2, max_steps=4_000, faults=FAULTS)
    assert trace == je.trace(2, max_steps=4_000, faults=FAULTS)
    assert trace[-1].get("bug_raised")
    for kw in (dict(), dict(seed=2), dict(seed=2, label="x")):
        doc = ttl.trace_to_chrome(trace, **kw)
        assert json.dumps(doc) == json.dumps(jtl.trace_to_chrome(trace, **kw))
    assert doc["traceEvents"][-1]["name"] == "invariant:raise"
    assert ttl.render_text(trace) == jtl.render_text(trace)
    obs = te.observe(te.run(te.init(np.arange(4), faults=FAULTS), 4_000))
    rings = tbb.rings_from_observations(obs)
    j_rings = jbb.rings_from_observations(obs)
    for row in range(4):
        entries = tbb.decode_ring({k: v[row] for k, v in rings.items()},
                                  kind_names=te.actor.kind_names)
        j_entries = jbb.decode_ring({k: v[row] for k, v in j_rings.items()},
                                    kind_names=je.actor.kind_names)
        assert entries == j_entries
        assert json.dumps(ttl.ring_to_chrome(entries, seed=row, k=16)) == \
            json.dumps(jtl.ring_to_chrome(entries, seed=row, k=16))
    polls = [(0, 0), (1, 1_500), (0, 2_000_000)]
    assert json.dumps(ttl.polls_to_chrome(polls, seed=3)) == \
        json.dumps(jtl.polls_to_chrome(polls, seed=3))
    ttl.dump_chrome(doc, str(tmp_path / "t.json"))
    jtl.dump_chrome(doc, str(tmp_path / "j.json"))
    assert filecmp.cmp(tmp_path / "t.json", tmp_path / "j.json",
                       shallow=False)


def test_sweep_bundle_writer_is_byte_equal_to_jax(tmp_path):
    kw = dict(seed=17, actor="raft", actor_config=T.RaftDeviceConfig(**RK),
              engine_config=T.EngineConfig(**CK), faults=FAULTS,
              max_steps=3_000, error="invariant violation: x",
              minimization={"schema": "madsim.triage.minimization/1",
                            "rounds": 3},
              lineage={"schema": "madsim.search.lineage/1", "chain": []},
              extra={"failure_class": "x:0000beef", "n": np.int64(3)})
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    tp = tbundle.write_sweep_bundle(str(tmp_path / "t"), **kw)
    jp = jbundle.write_sweep_bundle(
        str(tmp_path / "j"), **dict(
            kw, actor_config=J.RaftDeviceConfig(**RK),
            engine_config=J.EngineConfig(**CK)))
    assert os.path.basename(tp) == os.path.basename(jp)
    assert filecmp.cmp(tp, jp, shallow=False)
    assert tbundle.load_bundle(tp) == jbundle.load_bundle(jp)
    cfg = {"a": [1, 2], "b": None}
    assert tbundle.config_digest(cfg) == jbundle.config_digest(cfg)
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"version": 2, "kind": "device_sweep"}))
    with pytest.raises(ValueError, match="version"):
        tbundle.load_bundle(str(bad))


def test_raft_triage_bundles_are_byte_equal_to_jax(raft_triage):
    _jr, tr, jrep, trep = raft_triage
    assert [c.key for c in trep.classes] == [c.key for c in jrep.classes]
    assert trep.bundles and set(trep.bundles) == set(trep.minimized)
    same_dirs(jrep, trep)
    b = tbundle.load_bundle(next(iter(trep.bundles.values())))
    assert b["actor"] == "raft" and b["extra"]["blackbox"]["schema"] == \
        tbb.SCHEMA


def run_cli(*args):
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.run([sys.executable, "-m", "madsim_tpu_torch.obs",
                           *args], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=300)


def test_port_bundle_replays_in_a_fresh_process(raft_triage, tmp_path):
    """The replay CLI in a subprocess on the CPU: the bundle's minimized
    schedule reproduces the failure, the trace ends in the raise, and the
    ring the sweep recorded is bitwise the replayed trace's suffix."""
    _jr, _tr, _jrep, trep = raft_triage
    path = next(iter(trep.bundles.values()))
    out = tmp_path / "trace.json"
    proc = run_cli("replay", "--bundle", path, "--device", "cpu",
                   "--out", str(out), "--crosscheck")
    assert proc.returncode == 0, proc.stderr
    assert "invariant RAISED" in proc.stderr
    assert "bitwise the suffix" in proc.stderr
    doc = json.loads(out.read_text())
    assert doc["traceEvents"][-1]["name"] == "invariant:raise"
    # Without a bundle: --seed/--actor, text format.
    b = tbundle.load_bundle(path)
    proc = run_cli("replay", "--seed", str(b["seed"]), "--actor", "raft",
                   "--actor-config", json.dumps(b["actor_config"]),
                   "--engine-config", json.dumps(b["engine_config"]),
                   "--device", "cpu", "--format", "text")
    assert proc.returncode == 0, proc.stderr
    assert "INVARIANT VIOLATION RAISED HERE" in proc.stdout


def quiet(main, argv):
    with redirect_stdout(io.StringIO()), redirect_stderr(io.StringIO()) \
            as err:
        rc = main(argv)
    return rc, err.getvalue()


def test_each_package_replays_the_others_bundle(raft_triage, tmp_path):
    _jr, _tr, jrep, trep = raft_triage
    jpath = next(iter(jrep.bundles.values()))
    tpath = next(iter(trep.bundles.values()))
    out = str(tmp_path / "o.json")
    rc, err = quiet(tcli.main, ["replay", "--bundle", jpath, "--device",
                                "cpu", "--out", out])
    assert rc == 0 and "invariant RAISED" in err, err
    rc, err = quiet(jcli.main, ["replay", "--bundle", tpath, "--out", out,
                                "--crosscheck"])
    assert rc == 0 and "bitwise the suffix" in err, err
    # A schedule that no longer fails: rc 1.
    b = json.loads(open(tpath).read())
    b["faults"] = None
    b["engine_config"]["t_limit_us"] = 1_000
    drift = tmp_path / "drift.json"
    drift.write_text(json.dumps(b))
    rc, err = quiet(tcli.main, ["replay", "--bundle", str(drift),
                                "--device", "cpu", "--out", out])
    assert rc == 1 and "drift" in err, err


def test_host_test_bundle_and_usage_errors_exit_2(tmp_path):
    path = jbundle.write_test_bundle(str(tmp_path), seed=3,
                                     test_id="mod:test_x",
                                     error="AssertionError: boom")
    assert tbundle.load_bundle(path)["kind"] == "host_test"
    rc, err = quiet(tcli.main, ["replay", "--bundle", path, "--device",
                                "cpu"])
    assert rc == 2 and "host runtime" in err and "not part of the port" \
        in err
    rc, err = quiet(tcli.main, ["replay", "--seed", "1", "--actor", "nope",
                                "--device", "cpu"])
    assert rc == 2 and "unknown actor" in err
    rc, err = quiet(tcli.main, ["lineage", str(tmp_path / "none.json")])
    assert rc == 2
    with pytest.raises(SystemExit) as exc:
        quiet(tcli.main, ["replay", "--seed", "1"])
    assert exc.value.code == 2
