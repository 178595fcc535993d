"""speclint (pass 4) in the port (madsim_tpu_torch/analysis) against the
JAX package on the CPU:

- each golden fixture (tests/fixtures/speclint/*.py) gives the port the
  JAX package's findings: rule, path, line, message and rendered text.
  The fixtures import ``madsim_tpu.actorc.spec``; the port loads them
  with ``golden.speclint_fixture`` (that one import line rewritten, the
  text compiled under the fixture's own file name), so the handlers'
  lines and the file's pragmas are the ones JAX reads;
- the findings name their offender (tests/test_speclint.py's POINTED
  substrings), and the JAX-derived digests ``golden.GOLDEN_SPECLINT``
  that ``chip_smoke.py`` holds the card to are recomputed here;
- the compile gate: ``CompiledActor`` refuses the DSL-gap specs with
  the JAX gate's ``SpecError`` text and accepts the clean spec and the
  shipped families' bug variants;
- the shipped specs and their variants lint clean, and their protocol
  cards are byte-equal to JAX's (and to ``golden.GOLDEN_CARDS``);
- suppression: a pragma, a stale pragma (DET900, owned by pass 4),
  ``lint_allow`` per code and ``("*",)``, a stale ``lint_allow``
  (SPC900), ``ignore`` and ``terminal`` (tests/test_speclint.py's
  cases), each held to JAX's findings;
- the CLI: ``python -m madsim_tpu_torch.analysis spec --card paxos`` in
  a fresh process prints byte for byte what ``python -m
  madsim_tpu.analysis spec --card paxos`` prints, and the two CLIs'
  ``main`` give the same standard output, standard error and exit code
  for the other ``spec`` options.

Tolerance: none — findings and cards are compared as exact strings.
"""
import dataclasses
import importlib.util
import os
import subprocess
import sys

import pytest

from madsim_tpu.actorc.compile import CompiledActor as JCompiledActor
from madsim_tpu.actorc.families.paxos import PaxosConfig as JPaxosConfig
from madsim_tpu.actorc.families.paxos import paxos_spec as j_paxos_spec
from madsim_tpu.actorc.families.pb import pb_spec as j_pb_spec
from madsim_tpu.actorc.families.tpc import tpc_spec as j_tpc_spec
from madsim_tpu.actorc.spec import SpecError as JSpecError
from madsim_tpu.analysis import speclint as jlint
from madsim_tpu.engine.pb_actor import PBDeviceConfig as JPBConfig
from madsim_tpu.engine.tpc_actor import TPCDeviceConfig as JTPCConfig
from madsim_tpu_torch.actorc.compile import CompiledActor
from madsim_tpu_torch.actorc.spec import SpecError
from madsim_tpu_torch.analysis import speclint as tlint
from madsim_tpu_torch.engine import golden

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, golden.SPECLINT_DIR)

# tests/test_speclint.py's (fixture, rule) -> substrings the finding names.
POINTED = {
    ("bad_unreachable", "SPC010"): ("'Lost'", "unreachable"),
    ("bad_unhandled", "SPC011"): ("'Drop'", "no handler"),
    ("bad_noop", "SPC012"): ("'Pong'", "no effects"),
    ("bad_timer", "SPC020"): ("'Dead'", "never armed"),
    ("bad_timer", "SPC021"): ("'Tick'", "disjoint"),
    ("bad_capacity", "SPC030"): ("'small'", "[100, 200]"),
    ("bad_capacity", "SPC031"): ("'x'", "[50, 150]"),
    ("bad_effects", "SPC040"): ("'Pong'", "disjoint"),
    ("bad_effects", "SPC041"): ("at most once", "'Pong'"),
    ("bad_durability", "SPC050"): ("'mem'", "on_restart"),
    ("stale_pragma", "DET900"): ("SPC030",),
}


def _jload(name, path=None):
    """The JAX test's loader: import the fixture fresh."""
    path = path or os.path.join(FIXTURES, name + ".py")
    mspec = importlib.util.spec_from_file_location(
        f"speclint_fixture_{name}", path)
    mod = importlib.util.module_from_spec(mspec)
    mspec.loader.exec_module(mod)
    return mod


def _tload(name, path=None):
    return golden.speclint_fixture(
        path or os.path.join(FIXTURES, name + ".py"))


def _both(name, edit=lambda s: s, root=REPO, path=None):
    """(JAX findings, port findings) of fixture ``name`` after ``edit``."""
    js = edit(_jload(name, path).build())
    ts = edit(_tload(name, path).build())
    return jlint.lint_spec(js, root=root), tlint.lint_spec(ts, root=root)


def _same(jf, tf):
    assert [tuple(f) for f in tf] == [tuple(f) for f in jf], \
        "\n".join(["JAX:"] + [f.render() for f in jf]
                  + ["port:"] + [f.render() for f in tf])
    assert [f.render() for f in tf] == [f.render() for f in jf]


@pytest.mark.parametrize("fixture", sorted(golden.GOLDEN_SPECLINT))
def test_fixture_findings_equal_jax_and_the_golden(fixture):
    jf, tf = _both(fixture)
    _same(jf, tf)
    rel = f"{golden.SPECLINT_DIR}/{fixture}.py"
    assert all(f.path == rel and f.line > 0 for f in tf)
    assert (tuple(f.rule for f in jf), golden.findings_digest(jf)) \
        == golden.GOLDEN_SPECLINT[fixture]


def test_findings_name_the_offender():
    for (fixture, rule), needles in sorted(POINTED.items()):
        found = [f for f in tlint.lint_spec(_tload(fixture).build(),
                                            root=REPO) if f.rule == rule]
        assert found, f"{fixture} produced no {rule}"
        for needle in needles:
            assert any(needle in f.message for f in found), (fixture, rule,
                                                             needle)


@pytest.mark.parametrize("fixture,code", [
    ("bad_effects", "SPC040"), ("bad_effects", "SPC041"),
    ("bad_timer", "SPC021"), ("bad_capacity", "SPC030")])
def test_compile_gate_refuses_dsl_gap_specs_with_jax_text(fixture, code):
    with pytest.raises(JSpecError) as je:
        JCompiledActor(_jload(fixture).build())
    with pytest.raises(SpecError) as te:
        CompiledActor(_tload(fixture).build())
    assert "speclint" in str(te.value) and code in str(te.value)
    assert str(te.value) == str(je.value)


def _variant_specs():
    j = {"tpc": lambda kw: j_tpc_spec(JTPCConfig(**kw)),
         "pb": lambda kw: j_pb_spec(JPBConfig(**kw)),
         "paxos": lambda kw: j_paxos_spec(JPaxosConfig(**kw))}
    return {name: (j[fam](kw), golden.card_spec(name))
            for name, (fam, kw) in golden.CARD_SPECS.items()}


def test_compile_gate_passes_clean_spec_and_shipped_variants():
    CompiledActor(_tload("clean").build())
    for name, (_js, ts) in _variant_specs().items():
        CompiledActor(ts)


def test_shipped_specs_and_variants_lint_clean_with_jax_cards():
    assert tlint.run_spec_pass(root=REPO) == []
    assert sorted(tlint.shipped_specs()) == sorted(jlint.shipped_specs())
    for name in tlint.shipped_specs():
        assert tlint.protocol_card(tlint.shipped_specs()[name]) == \
            jlint.protocol_card(jlint.shipped_specs()[name]), name
    for name, (js, ts) in _variant_specs().items():
        assert tlint.lint_spec(ts, root=REPO) == [], name
        assert jlint.lint_spec(js, root=REPO) == [], name
        card = tlint.protocol_card(ts)
        assert card == jlint.protocol_card(js), name
        assert golden.card_digest(card) == golden.GOLDEN_CARDS[name], name
    assert sorted(golden.GOLDEN_CARDS) == sorted(golden.CARD_SPECS)


def test_protocol_cards_surface_the_fixture_shapes():
    for fixture in ("bad_unhandled", "clean", "bad_timer"):
        assert tlint.protocol_card(_tload(fixture).build()) == \
            jlint.protocol_card(_jload(fixture).build()), fixture
    card = tlint.protocol_card(_tload("clean").build())
    assert "[0, 100]" in card and "i8" in card and "UNHANDLED" not in card


def test_pragma_suppresses_spc_finding_on_its_line(tmp_path):
    src = open(os.path.join(FIXTURES, "bad_capacity.py"),
               encoding="utf-8").read()
    anchor = 'c.write("small", c.read("small") + 100, when=live)'
    assert anchor in src
    p = tmp_path / "pragma_capacity.py"
    p.write_text(src.replace(anchor, anchor + "  # detlint: allow[SPC030]"))
    jf, tf = _both("pragma_capacity", root=str(tmp_path), path=str(p))
    _same(jf, tf)
    assert [f.rule for f in tf] == ["SPC031"]


def test_stale_spc_pragma_is_det900():
    jf, tf = _both("stale_pragma")
    _same(jf, tf)
    assert [f.rule for f in tf] == ["DET900"] and "SPC030" in tf[0].message


@pytest.mark.parametrize("fixture,edit,rules", [
    ("bad_durability", dict(lint_allow=("SPC050",)), []),
    ("bad_timer", dict(lint_allow=("*",)), []),
    ("clean", dict(lint_allow=("SPC030",)), ["SPC900"]),
    ("bad_unhandled", dict(ignore=("Drop",)), []),
    ("bad_unhandled", dict(ignore=("Drop", "Nope")), ["SPC013"]),
    ("clean", dict(ignore=("Pong",)), ["SPC013"]),
    ("clean", dict(terminal=("Ping",)), ["SPC013"]),
], ids=["lint_allow", "star", "stale_allow", "ignore", "ignore_unknown",
        "handled_and_ignored", "terminal_emits"])
def test_suppression_and_declaration_hygiene(fixture, edit, rules):
    jf, tf = _both(fixture, lambda s: dataclasses.replace(s, **edit))
    _same(jf, tf)
    assert [f.rule for f in tf] == rules


def _cli(module, args):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-m", module, *args], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    return proc.returncode, proc.stdout, proc.stderr


def test_cli_card_in_a_fresh_process_equals_jax():
    out = _cli("madsim_tpu_torch.analysis", ["spec", "--card", "paxos"])
    assert out == _cli("madsim_tpu.analysis", ["spec", "--card", "paxos"])
    assert out[0] == 0 and out[1].startswith("protocol card: paxos")


@pytest.mark.parametrize("args", [
    ["spec", "--card", "pb"], ["spec", "--card", "tpc"], ["spec"],
    ["spec", "--list-families"], ["spec", "--card", "nope"],
    ["spec", "--families", "tpc,nope"], ["spec", "--families", "pb"],
    ["spec", "--json"], ["spec", "--format", "github"]],
    ids=lambda a: "_".join(a).replace("-", ""))
def test_cli_output_and_exit_code_equal_jax(args, capsys):
    from madsim_tpu.analysis.cli import main as jmain
    from madsim_tpu_torch.analysis.cli import main as tmain

    outs = []
    for main in (jmain, tmain):
        rc = main(list(args))
        outs.append((rc,) + tuple(capsys.readouterr()))
    assert outs[1] == outs[0]
