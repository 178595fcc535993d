"""speclint CLI: ``python -m madsim_tpu_torch.analysis spec [...]``.

The port's copy of the part of ``madsim_tpu/analysis/cli.py`` that pass 4
needs: :func:`render_findings` and the ``--json``/``--format`` options,
with the JAX CLI's exit-code contract (0 clean, 1 findings, 2
usage/config error):

- ``python -m madsim_tpu_torch.analysis spec`` lints the shipped actorc
  specs (``--families`` a subset);
- ``... spec --card FAMILY`` prints that family's protocol card;
- ``... spec --list-families`` lists them.

The JAX CLI's other entries are not ported, and exit 2 naming why: the
AST passes (1–2, the default entry) check the JAX package's host runtime
and its sim/real trees, which are outside the port, and ``trace`` (pass
3, tracelint and the budget ledger) is ROADMAP item 12.
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


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "spec":
        from .speclint import main_spec

        return main_spec(argv[1:])
    if argv and argv[0] == "trace":
        print("detlint trace: pass 3 (tracelint and the budget ledger) is "
              "not ported to madsim_tpu_torch (ROADMAP Queue A item 12); "
              "`spec` runs pass 4", file=sys.stderr)
        return 2
    print("detlint: passes 1-2 (nondeterminism escapes, sim/real parity) "
          "check the JAX package's host runtime, which is outside "
          "madsim_tpu_torch; run `python -m madsim_tpu_torch.analysis "
          "spec` for pass 4 (speclint)", file=sys.stderr)
    return 2
