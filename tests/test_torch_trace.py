"""The port's tracelint (madsim_tpu_torch/analysis/tracelint.py, budgets.py
and ``python -m madsim_tpu_torch.analysis trace``) on the CPU.

The whole gate exits 0 on this tree; the CLI's exit codes are the JAX
CLI's (0 clean, 1 findings, 2 usage/config error); the registry keeps the
JAX registry's names, ledger and in-place (donation) flags; and each
seeded fault gives its rule: a fixture program that pulls mid-program
through the sweep's ``_fetch`` without declaring it (TRC001), one that
gives its state new storage while declaring it in place (TRC004), a
tightened ceiling (BUD001), and a ledger that lacks a program (BUD002).
On the CPU the CUDA checks (the sync check, deterministic algorithms) do
not run; ``chip_smoke.py`` phase 14 runs the gate on the card.
"""
import importlib
import json
import os
import subprocess
import sys

import numpy as np
import torch

from madsim_tpu_torch.analysis import budgets as B
from madsim_tpu_torch.analysis import main_trace
from madsim_tpu_torch.analysis import tracelint as TL

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
tsweep = importlib.import_module("madsim_tpu_torch.parallel.sweep")


def test_the_whole_gate_is_clean_on_the_cpu():
    """``python -m madsim_tpu_torch.analysis trace --device cpu``: one line
    per program, every budget program within its ledger, exit 0."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-m", "madsim_tpu_torch.analysis", "trace",
         "--device", "cpu"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "tracelint: clean" in proc.stderr
    lines = [ln for ln in proc.stdout.splitlines() if "host_syncs=" in ln]
    assert len(lines) == len(TL.registry())


def test_cli_exit_codes(tmp_path, capsys):
    one = ["--device", "cpu", "--programs", "engine.pallas_step"]
    assert main_trace(one) == 0
    out = capsys.readouterr()
    assert "engine.pallas_step" in out.out and "in_place=yes" in out.out
    assert main_trace(["--list-programs"]) == 0
    assert main_trace(["--list-rules"]) == 0
    assert "TRC003  not carried over" in capsys.readouterr().out
    # Usage and configuration errors: 2.
    assert main_trace(["--device", "cpu", "--programs", "no.such"]) == 2
    assert main_trace(one + ["--budgets", str(tmp_path / "none.json")]) == 2
    assert main_trace(one + ["--allowlist", str(tmp_path / "none.txt")]) \
        == 2
    if not torch.cuda.is_available():
        assert main_trace(["--programs", "engine.pallas_step"]) == 2
        assert "--device cpu" in capsys.readouterr().err
    # A finding: 1, and an allowlist entry for it clears it.
    doc = B.load_ledger()
    doc["programs"]["engine.pallas_step"]["cpu/packed"][
        "state_bytes_per_world"]["budget"] = 1.0
    ledger = tmp_path / "tight.json"
    ledger.write_text(json.dumps(doc))
    assert main_trace(one + ["--budgets", str(ledger)]) == 1
    assert main_trace(one + ["--budgets", str(ledger), "--json"]) == 1
    found = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [f["rule"] for f in found] == ["BUD001"]
    allow = tmp_path / "allow.txt"
    allow.write_text("trace/engine.pallas_step:BUD001\n")
    assert main_trace(one + ["--budgets", str(ledger), "--allowlist",
                             str(allow)]) == 0


def test_registry_keeps_the_jax_names_and_flags():
    """JAX's registry, name for name; the ledger programs and the in-place
    ones are JAX's budget and donating ones; each has a counterpart, and
    the checked-in ledger holds every budget program on the CPU."""
    from madsim_tpu.analysis.tracelint import registry as jax_registry

    jregs, tregs = jax_registry(), TL.registry()
    assert sorted(tregs) == sorted(jregs)
    for name, jp in jregs.items():
        tp = tregs[name]
        assert tp.budget == jp.budget, name
        assert tp.in_place == jp.donates, name
        assert tp.build is not None, name
    ledger = B.load_ledger()
    assert sorted(ledger["programs"]) == sorted(
        n for n, p in tregs.items() if p.budget)
    for name, entry in ledger["programs"].items():
        assert set(entry) >= {"note", f"cpu/{tregs[name].profile}"}, name


def _fixture_registry(call, in_place=False, reads=()):
    def build(dev):
        eng = TL._bug_engine(dev)
        state = eng.init(np.arange(4))
        return TL.Built(lambda: call(eng, state), state)

    return {"fixture.program": TL.TraceProgram(
        "fixture.program", "a seeded fault", build, in_place=in_place,
        reads=reads)}


def _rules(regs):
    findings, _lines = TL.run_trace(budget_check=False, device="cpu",
                                    regs=regs)
    return [f.rule for f in findings]


def test_a_mid_program_pull_is_trc001():
    def pulls(eng, state):
        eng.run_steps(state, 2)
        tsweep._fetch(state.active)      # the host reads mid-program
        eng.run_steps(state, 2)

    assert _rules(_fixture_registry(pulls)) == ["TRC001"]
    # Declared, the same read is the program's own: counted, no finding.
    findings, lines = TL.run_trace(
        budget_check=False, device="cpu",
        regs=_fixture_registry(pulls, reads=("fetch",)))
    assert findings == [] and lines["fixture.program"]["host_syncs"] == 1


def test_a_fresh_state_is_trc004():
    def fresh(eng, state):
        for x in TL._leaves(state):
            x.set_(x.clone())            # new storage under every leaf

    assert _rules(_fixture_registry(fresh, in_place=True)) == ["TRC004"]
    assert _rules(_fixture_registry(
        lambda eng, state: eng.run_steps(state, 2), in_place=True)) == []


def test_a_tightened_ceiling_is_bud001(tmp_path):
    doc = B.load_ledger()
    doc["programs"]["engine.refill_select"]["cpu/packed"]["host_syncs"][
        "budget"] = -1.0
    path = tmp_path / "tight.json"
    path.write_text(json.dumps(doc))
    findings, _ = TL.run_trace(programs=["engine.refill_select"],
                               device="cpu", ledger_path=str(path))
    assert [f.rule for f in findings] == ["BUD001"]
    assert "host_syncs on cpu/packed measured 0" in findings[0].message


def test_a_missing_program_is_bud002(tmp_path):
    doc = B.load_ledger()
    del doc["programs"]["engine.refill_select"]
    doc["programs"]["engine.retired"] = doc["programs"]["sweep.compactor"]
    path = tmp_path / "short.json"
    path.write_text(json.dumps(doc))
    findings, _ = TL.run_trace(programs=["engine.refill_select"],
                               device="cpu", ledger_path=str(path))
    assert [(f.path, f.rule) for f in findings] == [
        ("trace/engine.refill_select", "BUD002")]

    def broken(dev):
        raise ValueError("no such engine")

    regs = dict(TL.registry())
    regs["sweep.compactor"] = TL.TraceProgram(
        "sweep.compactor", "broken", broken, budget=True)
    findings, _ = TL.run_trace(programs=["sweep.compactor"], device="cpu",
                               ledger_path=str(path), regs=regs)
    assert [f.rule for f in findings] == ["BUD002"]
    assert "failed to build" in findings[0].message
    # A ledger entry no registered program backs.
    findings, _ = TL.run_trace(programs=None, device="cpu",
                               ledger_path=str(path),
                               regs={"sweep.compactor": TL.registry()[
                                   "sweep.compactor"]})
    assert ("trace/engine.retired", "BUD002") in [(f.path, f.rule)
                                                  for f in findings]
