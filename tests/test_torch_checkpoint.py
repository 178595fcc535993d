"""Engine checkpoints in the port (madsim_tpu_torch.engine.checkpoint)
against the JAX package on the CPU, bitwise (tolerance 0).

- tests/test_checkpoint.py's ten tests, held to the port: the split run;
  the wrong config, seeds and world count; the crash between write and
  rename; fsync before rename; the corrupt file, and its resume through a
  sweep; the aux round trip; the sweep resume;
- the file format across the packages: a Raft state saved by JAX mid-run
  loads in the port and the other way round, in both lane profiles, and
  both continue to equal leaves; a recycled Raft sweep interrupted and
  checkpointed by one package's serial loop is resumed by the other's,
  and equals JAX's unbroken sweep;
- the fingerprint fault of the JAX reference (ROADMAP Queue C 2): JAX's
  fingerprints of two identical compiled-family engines differ, the
  port's agree, and the port's checkpoints of tpc, pb and Paxos load in a
  second engine and in a second process.
"""
import importlib
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

import madsim_tpu.engine as J
import madsim_tpu_torch.engine as T
from madsim_tpu.parallel.mesh import seed_mesh
from madsim_tpu_torch.engine import (
    CheckpointError,
    load_checkpoint,
    save_checkpoint,
)
from madsim_tpu_torch.engine import checkpoint as ckpt_mod
from madsim_tpu_torch.engine.core import tree_paths
tsweep = importlib.import_module("madsim_tpu_torch.parallel.sweep")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
jsweep = importlib.import_module("madsim_tpu.parallel.sweep")
MESH1 = seed_mesh(n_devices=1)
RCFG = dict(n=3, n_proposals=2)
ECFG = dict(n_nodes=3, outbox_cap=4, t_limit_us=2_000_000)


def t_engine(rcfg=RCFG, ecfg=ECFG):
    return T.DeviceEngine(T.RaftActor(T.RaftDeviceConfig(**rcfg)),
                          T.EngineConfig(**ecfg), device="cpu")


def _np_leaves(state):
    return T.state_to_numpy(state)


def _leaves_equal(a, b) -> bool:
    la, lb = _np_leaves(a), _np_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and np.array_equal(x, y) for x, y in zip(la, lb))


# ---------------------------------------------------------------------------
# tests/test_checkpoint.py, held to the port
# ---------------------------------------------------------------------------

def test_split_run_bit_identical(tmp_path):
    path = tmp_path / "ckpt.npz"
    eng = t_engine()
    unbroken = eng.run_steps(eng.init(np.arange(16)), 300)
    half = eng.run_steps(eng.init(np.arange(16)), 150)
    save_checkpoint(eng, half, path)
    # A fresh engine: nothing survives but the file.
    eng2 = t_engine()
    resumed = load_checkpoint(eng2, path)
    assert _leaves_equal(half, resumed), "load must restore state bitwise"
    finished = eng2.run_steps(resumed, 150)
    assert _leaves_equal(unbroken, finished), \
        "a split run must be bit-identical to an unbroken run"


def test_checkpoint_rejects_wrong_config(tmp_path):
    path = tmp_path / "ckpt.npz"
    eng = t_engine()
    save_checkpoint(eng, eng.init(np.arange(4)), path)
    other = t_engine(dict(n=5, log_cap=16), dict(n_nodes=5, outbox_cap=6))
    with pytest.raises(CheckpointError, match="different engine config"):
        load_checkpoint(other, path)
    # The same EngineConfig under another actor config: only the
    # fingerprint can tell them apart.
    tweaked = t_engine(dict(RCFG, heartbeat_us=10_000))
    with pytest.raises(CheckpointError, match="different engine config"):
        load_checkpoint(tweaked, path)


def test_sweep_resume_rejects_different_seeds(tmp_path):
    path = str(tmp_path / "sweep.npz")
    eng = t_engine()
    tsweep.sweep(None, eng.cfg, np.arange(100, 124), engine=eng,
                 chunk_steps=64, max_steps=64, checkpoint_path=path)
    with pytest.raises(CheckpointError, match="seeds_sha256"):
        tsweep.sweep(None, eng.cfg, np.arange(24), engine=eng,
                     chunk_steps=64, max_steps=64, checkpoint_path=path,
                     resume=True)


def test_sweep_resume_rejects_wrong_world_count(tmp_path):
    """A file whose metadata matches but whose state holds another world
    count (only a forged or corrupted file can be so) is refused."""
    import hashlib

    path = str(tmp_path / "sweep.npz")
    seeds = np.arange(24)
    eng = t_engine()
    meta = {
        "seeds_sha256": hashlib.sha256(
            seeds.astype(np.uint64).tobytes()).hexdigest(),
        "faults_sha256": hashlib.sha256(b"none").hexdigest(),
    }
    save_checkpoint(eng, eng.init(np.arange(16)), path, extra_meta=meta)
    with pytest.raises(CheckpointError, match="16 worlds"):
        tsweep.sweep(None, eng.cfg, seeds, engine=eng, chunk_steps=64,
                     max_steps=64, checkpoint_path=path, resume=True)


@pytest.fixture(scope="module")
def heng():
    """One engine for the file-level tests below."""
    return t_engine()


def test_crash_between_write_and_rename_keeps_previous(tmp_path,
                                                       monkeypatch, heng):
    """A writer dying between the temporary file and the rename leaves the
    previous checkpoint whole and loadable."""
    path = tmp_path / "ckpt.npz"
    eng = heng
    half = eng.run_steps(eng.init(np.arange(8)), 100)
    save_checkpoint(eng, half, path)
    later = eng.run_steps(eng.init(np.arange(8)), 200)

    def dying_replace(src, dst):
        raise OSError("simulated crash between write and rename")

    monkeypatch.setattr(ckpt_mod.os, "replace", dying_replace)
    with pytest.raises(OSError, match="simulated crash"):
        save_checkpoint(eng, later, path)
    monkeypatch.undo()
    recovered = load_checkpoint(eng, path)
    assert _leaves_equal(half, recovered), \
        "a crashed re-save must not touch the previous checkpoint"
    assert _leaves_equal(later, eng.run_steps(recovered, 100))


def test_save_fsyncs_before_rename(tmp_path, monkeypatch, heng):
    order = []
    real_fsync, real_replace = ckpt_mod.os.fsync, ckpt_mod.os.replace
    monkeypatch.setattr(ckpt_mod.os, "fsync",
                        lambda fd: (order.append("fsync"), real_fsync(fd)))
    monkeypatch.setattr(
        ckpt_mod.os, "replace",
        lambda a, b: (order.append("replace"), real_replace(a, b)))
    save_checkpoint(heng, heng.init(np.arange(8)), tmp_path / "c.npz")
    assert "fsync" in order and "replace" in order
    assert order.index("fsync") < order.index("replace")


def test_corrupt_checkpoint_reports_path_and_recovery(tmp_path, heng):
    path = tmp_path / "ckpt.npz"
    save_checkpoint(heng, heng.init(np.arange(8)), path)
    good = path.read_bytes()
    for bad in (good[:137], b"not an npz at all"):
        path.write_bytes(bad)
        with pytest.raises(CheckpointError) as exc_info:
            load_checkpoint(heng, path)
        msg = str(exc_info.value)
        assert str(path) in msg, "must name the corrupt file"
        assert "recovery options" in msg
        assert "zipfile" not in msg.lower().replace("badzipfile", "")
        with pytest.raises(CheckpointError, match="recovery options"):
            ckpt_mod.read_meta(path)


def test_sweep_resume_on_corrupt_checkpoint_reports(tmp_path, heng):
    path = tmp_path / "sweep.npz"
    tsweep.sweep(None, heng.cfg, np.arange(8), engine=heng, chunk_steps=64,
                 max_steps=64, checkpoint_path=str(path))
    path.write_bytes(path.read_bytes()[:100])
    with pytest.raises(CheckpointError, match="recovery options"):
        tsweep.sweep(None, heng.cfg, np.arange(8), engine=heng,
                     chunk_steps=64, max_steps=64,
                     checkpoint_path=str(path), resume=True)


def test_checkpoint_extra_arrays_round_trip(tmp_path, heng):
    path = tmp_path / "aux.npz"
    state = heng.init(np.arange(8))
    aux_in = {"cursor": np.int64(17),
              "idx": np.arange(8, dtype=np.int32),
              "ret_steps": np.asarray([5, 9], np.int32)}
    save_checkpoint(heng, state, path, extra_arrays=aux_in)
    loaded, aux = load_checkpoint(heng, path, with_aux=True)
    assert _leaves_equal(state, loaded)
    assert set(aux) == set(aux_in)
    for k in aux_in:
        np.testing.assert_array_equal(aux[k], aux_in[k])
        assert aux[k].dtype == np.asarray(aux_in[k]).dtype
    assert _leaves_equal(state, load_checkpoint(heng, path))
    meta = ckpt_mod.read_meta(path)
    assert meta["aux"] == sorted(aux_in) and meta["n_worlds"] == 8
    assert meta["version"] == ckpt_mod.FORMAT_VERSION == 1


def test_sweep_resumes_from_checkpoint(tmp_path):
    path = str(tmp_path / "sweep.npz")
    seeds = np.arange(24)
    eng = t_engine()
    full = tsweep.sweep(None, eng.cfg, seeds, engine=eng, chunk_steps=128,
                        max_steps=4_000)
    partial = tsweep.sweep(None, eng.cfg, seeds, engine=t_engine(),
                           chunk_steps=128, max_steps=256,
                           checkpoint_path=path, checkpoint_every_chunks=1)
    assert partial.steps_run == 256
    resumed = tsweep.sweep(None, eng.cfg, seeds, engine=t_engine(),
                           chunk_steps=128, max_steps=4_000,
                           checkpoint_path=path, resume=True)
    for key in full.observations:
        assert np.array_equal(full.observations[key],
                              resumed.observations[key]), key
    assert np.array_equal(full.bug, resumed.bug)


# ---------------------------------------------------------------------------
# The file format across the two packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("packed", [True, False])
def test_raft_state_files_interchange(tmp_path, packed):
    """A state saved by JAX mid-run loads in the port bitwise, and the two
    continue to equal leaves; a state saved by the port loads in JAX the
    same way."""
    rcfg = dict(n=3, n_proposals=2, buggy_double_vote=True)
    ecfg = dict(n_nodes=3, outbox_cap=4, queue_cap=64,
                t_limit_us=1_500_000, packed=packed, metrics=True,
                blackbox=8)
    faults = np.array([[300_000, J.FAULT_KILL, 0, 0],
                       [700_000, J.FAULT_RESTART, 0, 0]], np.int32)
    je = J.DeviceEngine(J.RaftActor(J.RaftDeviceConfig(**rcfg)),
                        J.EngineConfig(**ecfg))
    te = t_engine(rcfg, ecfg)
    seeds = np.arange(16)
    js = je.run_steps(je.init(seeds, faults=faults), 100)
    j_path, t_path = tmp_path / "jax.npz", tmp_path / "torch.npz"
    J.save_checkpoint(je, js, j_path)
    ts = load_checkpoint(te, j_path)
    jl = [np.asarray(x) for x in jax.tree.leaves(js)]
    assert [x.dtype for x in jl] == [x.dtype for x in _np_leaves(ts)]
    assert all(np.array_equal(a, b) for a, b in zip(jl, _np_leaves(ts)))
    # The port saves its state; JAX loads it. Both go on 100 steps.
    save_checkpoint(te, ts, t_path)
    assert ckpt_mod.read_meta(t_path)["config"] == \
        J.checkpoint.read_meta(j_path)["config"]
    js2 = J.load_checkpoint(je, t_path)
    ts = te.run_steps(ts, 100)
    js2 = je.run_steps(js2, 100)
    bad = [p for p, a, b in zip(tree_paths(ts), _np_leaves(ts),
                                [np.asarray(x) for x in jax.tree.leaves(js2)])
           if a.dtype != b.dtype or not np.array_equal(a, b)]
    assert not bad, bad


RK = dict(n=3, n_proposals=2, buggy_double_vote=True)
CK = dict(n_nodes=3, outbox_cap=4, queue_cap=64, t_limit_us=1_500_000,
          metrics=True, blackbox=16)
FAULTS = np.array([[300_000, J.FAULT_KILL, 0, 0],
                   [700_000, J.FAULT_RESTART, 0, 0]], np.int32)
SWEEP_KW = dict(chunk_steps=64, faults=FAULTS, coverage_buckets=64,
                recycle=True, batch_worlds=8)


@pytest.fixture(scope="module")
def jax_recycled():
    """JAX's engine and its unbroken recycled serial sweep (the
    configuration of tests/test_torch_sweep_resume.py)."""
    je = J.DeviceEngine(J.RaftActor(J.RaftDeviceConfig(**RK)),
                        J.EngineConfig(**CK))
    return je, jsweep.sweep(None, je.cfg, np.arange(16), engine=je,
                            mesh=MESH1, pipeline=False, max_steps=3_000,
                            **SWEEP_KW)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_recycled_sweep_checkpoint_resumes_across_packages(
        tmp_path, jax_recycled, writer):
    """A recycled sweep interrupted after a refill and checkpointed by one
    package's serial loop, resumed by the other's: the result equals JAX's
    unbroken sweep (observations, bugs, the coverage ledger)."""
    je, jr = jax_recycled
    path = str(tmp_path / "hunt.npz")
    te = t_engine(RK, CK)
    part = dict(max_steps=64 * 4, checkpoint_path=path,
                checkpoint_every_chunks=1, pipeline=False, **SWEEP_KW)
    rest = dict(max_steps=3_000, checkpoint_path=path, resume=True,
                pipeline=False, **SWEEP_KW)
    if writer == "jax":
        jsweep.sweep(None, je.cfg, np.arange(16), engine=je, mesh=MESH1,
                     **part)
        res = tsweep.sweep(None, te.cfg, np.arange(16), engine=te, **rest)
    else:
        tsweep.sweep(None, te.cfg, np.arange(16), engine=te, **part)
        res = jsweep.sweep(None, je.cfg, np.arange(16), engine=je,
                           mesh=MESH1, **rest)
    assert "ret_rows" in ckpt_mod.load(te, path, with_aux=True)[1]
    assert list(res.observations) == list(jr.observations)
    for k, v in jr.observations.items():
        np.testing.assert_array_equal(np.asarray(res.observations[k]), v,
                                      err_msg=k)
    assert res.failing_seeds == jr.failing_seeds
    np.testing.assert_array_equal(res.coverage.hits, jr.coverage.hits)
    np.testing.assert_array_equal(res.coverage.first_seen_seed,
                                  jr.coverage.first_seen_seed)


# ---------------------------------------------------------------------------
# The fingerprint fault of the JAX reference (ROADMAP Queue C 2)
# ---------------------------------------------------------------------------

def _port_families():
    """(name, actor factory, EngineConfig) of the port's compiled
    families."""
    from madsim_tpu_torch.actorc.families import paxos

    return [("tpc", T.TPCActor, T.EngineConfig(n_nodes=4, queue_cap=64)),
            ("pb", T.PBActor, T.EngineConfig(n_nodes=3, queue_cap=64)),
            ("paxos", paxos.PaxosActor, paxos.engine_config())]


def test_compiled_family_fingerprints_and_checkpoints(tmp_path):
    """JAX's fingerprint of a compiled family holds its handlers'
    addresses, so two identical engines disagree and a file of one does
    not load in the other. The port's fingerprints agree, and its
    checkpoint of tpc, pb and Paxos loads in a second engine, and in a
    second process."""
    from madsim_tpu.engine.checkpoint import _config_fingerprint as j_fp

    a = J.DeviceEngine(J.TPCActor(), J.EngineConfig(n_nodes=4, queue_cap=64))
    b = J.DeviceEngine(J.TPCActor(), J.EngineConfig(n_nodes=4, queue_cap=64))
    assert j_fp(a) != j_fp(b)
    J.save_checkpoint(a, a.init(np.arange(2)), tmp_path / "jax_tpc.npz")
    with pytest.raises(J.CheckpointError, match="different engine config"):
        J.load_checkpoint(b, tmp_path / "jax_tpc.npz")
    for name, make, cfg in _port_families():
        e1 = T.DeviceEngine(make(), cfg, device="cpu")
        e2 = T.DeviceEngine(make(), cfg, device="cpu")
        fp = ckpt_mod._config_fingerprint(e1)
        assert fp == ckpt_mod._config_fingerprint(e2), name
        assert " at 0x" not in fp, name
        state = e1.run_steps(e1.init(np.arange(4)), 20)
        path = tmp_path / f"{name}.npz"
        save_checkpoint(e1, state, path)
        assert _leaves_equal(state, load_checkpoint(e2, path)), name
    # A second process loads the tpc file and steps it like this one.
    e1 = T.DeviceEngine(T.TPCActor(), T.EngineConfig(n_nodes=4,
                                                     queue_cap=64),
                        device="cpu")
    want = e1.run_steps(load_checkpoint(e1, tmp_path / "tpc.npz"), 20)
    code = ("import sys, numpy as np\n"
            "import madsim_tpu_torch.engine as T\n"
            "e = T.DeviceEngine(T.TPCActor(), T.EngineConfig(n_nodes=4, "
            "queue_cap=64), device='cpu')\n"
            "s = e.run_steps(T.load_checkpoint(e, sys.argv[1]), 20)\n"
            "T.save_checkpoint(e, s, sys.argv[2])\n")
    out = tmp_path / "tpc_child.npz"
    proc = subprocess.run(
        [sys.executable, "-c", code, str(tmp_path / "tpc.npz"), str(out)],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert _leaves_equal(want, load_checkpoint(e1, out))
