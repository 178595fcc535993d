"""Repro bundles of the pair families' triage in the port against the
JAX package on the CPU, byte for byte: ``triage(result, out_dir)`` of
the three pair-restart failure classes (minimized and not), and of a
guided pair hunt's find (its bundle carries the ``madsim.search.lineage/1``
block, which ``python -m madsim_tpu_torch.obs lineage`` renders as JAX's
CLI does). The Raft hunt's bundles, the timelines and the replay CLI are
in tests/test_torch_bundle.py.

JAX runs on a one-device mesh. W <= 128 seeds through 32 slots.
Tolerance: none, every operation is integer.
"""
import importlib
import io
from contextlib import redirect_stdout

import numpy as np

import madsim_tpu.engine as J
import madsim_tpu_torch.engine as T
from madsim_tpu.obs import cli as jcli
from madsim_tpu.parallel.mesh import seed_mesh
from madsim_tpu.search import hunts as jhunts
from madsim_tpu.triage import triage as j_triage
from madsim_tpu_torch.obs import bundle as tbundle
from madsim_tpu_torch.obs import cli as tcli
tsweep = importlib.import_module("madsim_tpu_torch.parallel.sweep")
from madsim_tpu_torch.search import hunts as thunts
from madsim_tpu_torch.triage import triage
from test_torch_bundle import same_dirs
from test_torch_triage import (MIN_KW, k_class_faults,  # noqa: F401
                               pair_engines_m)

jsweep = importlib.import_module("madsim_tpu.parallel.sweep")
MESH1 = seed_mesh(n_devices=1)


def test_pair_triage_bundles_are_byte_equal_to_jax(pair_engines_m,
                                                   tmp_path):
    je, te = pair_engines_m
    faults = k_class_faults()
    kw = dict(faults=faults, **MIN_KW)
    jr = jsweep.sweep(None, je.cfg, np.arange(24), engine=je, mesh=MESH1,
                      **kw)
    tr = tsweep.sweep(None, te.cfg, np.arange(24), engine=te, **kw)
    for minimize in (True, False):
        jdir, tdir = (tmp_path / f"j{minimize}", tmp_path / f"t{minimize}")
        jdir.mkdir()
        tdir.mkdir()
        jrep = j_triage(jr, str(jdir), minimize=minimize, **MIN_KW)
        trep = triage(tr, str(tdir), minimize=minimize, **MIN_KW)
        assert len(trep.bundles) == 3
        same_dirs(jrep, trep)
    for mr in trep.minimized.values():
        assert mr.final_rows == 2 and mr.one_minimal


def test_guided_pair_triage_bundle_carries_lineage_as_jax(tmp_path):
    jh, th = jhunts.pair_hunt(), thunts.pair_hunt()
    je = J.DeviceEngine(jh.actor, jh.cfg)
    te = T.DeviceEngine(th.actor, th.cfg, device="cpu")
    seeds = np.arange(128)
    jr = jsweep.sweep(None, jh.cfg, seeds, engine=je, mesh=MESH1,
                      faults=jh.template, search=jh.search(True),
                      stop_on_first_bug=True, pipeline=False, **jh.sweep_kw)
    tr = tsweep.sweep(None, th.cfg, seeds, engine=te, faults=th.template,
                      search=th.search(True), stop_on_first_bug=True,
                      pipeline=False, **th.sweep_kw)
    assert tr.failing_seeds == jr.failing_seeds == [72]
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    kw = dict(chunk_steps=32, max_steps=4_000)
    jrep = j_triage(jr, str(tmp_path / "j"), **kw)
    trep = triage(tr, str(tmp_path / "t"), **kw)
    same_dirs(jrep, trep)
    path = next(iter(trep.bundles.values()))
    b = tbundle.load_bundle(path)
    assert b["actor"] == "guided_pair" and b["lineage"]["chain"]
    # `obs lineage` renders the bundle as JAX's does.
    outs = []
    for main in (tcli.main, jcli.main):
        buf = io.StringIO()
        with redirect_stdout(buf):
            assert main(["lineage", path]) == 0
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] and "find: seed 72" in outs[0]
