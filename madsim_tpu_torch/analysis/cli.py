"""The analysis CLI: ``python -m madsim_tpu_torch.analysis spec|trace``.

The port's copy of the parts of ``madsim_tpu/analysis/cli.py`` that
passes 3 and 4 need: :func:`render_findings` and the
``--json``/``--format`` options, with the JAX CLI's exit-code contract (0
clean, 1 findings, 2 usage/config error):

- ``python -m madsim_tpu_torch.analysis spec`` lints the shipped actorc
  specs (``--families`` a subset); ``... spec --card FAMILY`` prints that
  family's protocol card; ``... spec --list-families`` lists them;
- ``python -m madsim_tpu_torch.analysis trace`` runs tracelint
  (:mod:`.tracelint`) on CUDA, or with ``--device cpu`` on the CPU: one
  line per program (host syncs, state bytes per world, in place,
  deterministic), then the findings; ``--list-programs``,
  ``--list-rules``, ``--programs``, ``--no-budgets``, ``--budgets``,
  ``--allowlist`` as in the JAX CLI.

The default entry (passes 1–2, the AST passes) is not ported, and exits 2
naming why: it checks the JAX package's host runtime and its sim/real
trees, which are outside the port.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from .pragmas import Finding


def render_findings(findings: List[Finding], fmt: str,
                    label: str = "detlint") -> None:
    """Print findings in the chosen format; the summary line goes to
    stderr so stdout stays machine-parseable."""
    if fmt == "json":
        print(json.dumps([f._asdict() for f in findings]))
        return
    for f in findings:
        if fmt == "github":
            # GitHub workflow-annotation command: renders as an inline
            # file annotation on the PR diff.
            msg = f.message.replace("%", "%25").replace("\r", "%0D") \
                .replace("\n", "%0A")
            print(f"::error file={f.path},line={max(f.line, 1)},"
                  f"title={f.rule}::{msg}")
        else:
            print(f.render())
    n = len(findings)
    print(f"{label}: {n} finding{'s' if n != 1 else ''}"
          if n else f"{label}: clean", file=sys.stderr)


def _add_format_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--json", action="store_true",
                    help="machine-readable findings on stdout "
                         "(alias for --format=json)")
    ap.add_argument("--format", choices=("text", "json", "github"),
                    default="text",
                    help="output format; `github` emits workflow-"
                         "annotation lines for inline CI annotations")


def _fmt(args) -> str:
    return "json" if args.json else args.format


def _program_line(name: str, line: dict) -> str:
    def yn(v):
        return "n/a" if v is None else ("yes" if v else "NO")

    sb = line.get("state_bytes_per_world")
    return (f"{name:28s} host_syncs={line['host_syncs']} "
            f"state_bytes_per_world={'n/a' if sb is None else sb} "
            f"in_place={yn(line.get('in_place'))} "
            f"deterministic={yn(line.get('deterministic'))}")


def main_trace(argv: Optional[List[str]] = None) -> int:
    """``trace``: tracelint over the registered programs (pass 3)."""
    import os

    ap = argparse.ArgumentParser(
        prog="detlint trace",
        description="tracelint: the sweep's hot-path programs run once "
                    "each — host re-entry (TRC001), nondeterministic ops "
                    "(TRC002), in-place state (TRC004), and the checked-in "
                    "budget ledger (BUD001/BUD002)")
    ap.add_argument("--programs", default=None,
                    help="comma-separated subset of registered programs")
    ap.add_argument("--list-programs", action="store_true")
    ap.add_argument("--list-rules", action="store_true",
                    help="the rules this pass checks, and the JAX pass's "
                         "that do not carry over")
    ap.add_argument("--no-budgets", action="store_true",
                    help="rules only: skip the ledger diff")
    ap.add_argument("--budgets", default=None, metavar="PATH",
                    help="ledger file (default: analysis/budgets.json "
                         "inside the package)")
    ap.add_argument("--allowlist", default=None,
                    help="allowlist file applied to trace/<program> "
                         "pseudo-paths (default: none)")
    ap.add_argument("--device", default=None,
                    help="the device the programs run on (default: cuda)")
    _add_format_args(ap)
    args = ap.parse_args(argv)

    from .pragmas import Allowlist
    from .rules import NOT_CARRIED, RULES
    from .tracelint import registry, run_trace

    if args.list_rules:
        for code in ("TRC001", "TRC002", "TRC004", "BUD001", "BUD002"):
            rule = RULES[code]
            print(f"{rule.code}  {rule.title}\n        fix: "
                  f"{rule.suggestion}")
        for what, why in NOT_CARRIED.items():
            print(f"{what}  not carried over: {why}")
        return 0
    if args.list_programs:
        for name, prog in sorted(registry().items()):
            tags = [t for t, on in (("budget", prog.budget),
                                    ("in-place", prog.in_place)) if on]
            tags += list(prog.reads)
            if prog.build is None:
                tags = ["no counterpart"]
            tag = f" [{','.join(tags)}]" if tags else ""
            print(f"{name:28s} {prog.title}{tag}")
        return 0
    programs = ([p.strip() for p in args.programs.split(",") if p.strip()]
                if args.programs else None)
    try:
        findings, lines = run_trace(
            programs=programs, budget_check=not args.no_budgets,
            ledger_path=args.budgets, device=args.device)
    except (KeyError, FileNotFoundError, ValueError, RuntimeError) as exc:
        print(f"tracelint: {exc}", file=sys.stderr)
        return 2
    if args.allowlist is not None:
        if not os.path.isfile(args.allowlist):
            print(f"tracelint: allowlist not found: {args.allowlist}",
                  file=sys.stderr)
            return 2
        findings = Allowlist.load(args.allowlist).filter(findings)
    fmt = _fmt(args)
    out = sys.stdout if fmt == "text" else sys.stderr
    for name in sorted(lines):
        print(_program_line(name, lines[name]), file=out)
    render_findings(findings, fmt, label="tracelint")
    return 1 if findings else 0


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "spec":
        from .speclint import main_spec

        return main_spec(argv[1:])
    if argv and argv[0] == "trace":
        return main_trace(argv[1:])
    print("detlint: passes 1-2 (nondeterminism escapes, sim/real parity) "
          "check the JAX package's host runtime, which is outside "
          "madsim_tpu_torch; run `python -m madsim_tpu_torch.analysis "
          "trace` for pass 3 (tracelint) or `spec` for pass 4 (speclint)",
          file=sys.stderr)
    return 2
