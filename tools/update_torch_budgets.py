#!/usr/bin/env python
"""Regenerate (or verify) the port's tracelint budget ledger.

Usage::

    python tools/update_torch_budgets.py --device cpu --reason "why"
    python tools/update_torch_budgets.py --reason "why"     # on CUDA
    python tools/update_torch_budgets.py --check [--device cpu]

Regeneration runs every budget program of
``madsim_tpu_torch.analysis.tracelint`` on the device and rewrites that
device type's entries of ``madsim_tpu_torch/analysis/budgets.json``,
keeping the other device types' (the CPU's entries are written here, the
CUDA ones on a machine with a card). Ceilings RATCHET: an existing one
survives while the fresh measurement fits under it; raising one needs the
``--reason`` line, recorded in the ledger. Regeneration refuses a run
with findings other than the ledger's own (fix the program first).

``--check`` runs the whole tracelint gate instead (``python -m
madsim_tpu_torch.analysis trace``) and exits nonzero on any finding.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true",
                    help="verify instead of regenerate: the whole gate")
    ap.add_argument("--reason", default=None,
                    help="justification recorded in the ledger (required "
                         "to regenerate)")
    ap.add_argument("--budgets", default=None, metavar="PATH",
                    help="ledger path (default: the in-package "
                         "analysis/budgets.json)")
    ap.add_argument("--device", default=None,
                    help="the device the programs run on (default: cuda)")
    args = ap.parse_args(argv)

    if args.check:
        from madsim_tpu_torch.analysis.cli import main_trace

        extra = ["--budgets", args.budgets] if args.budgets else []
        extra += ["--device", args.device] if args.device else []
        return main_trace(extra)
    if not args.reason:
        ap.error("--reason is required to regenerate the ledger")

    from madsim_tpu_torch.analysis import budgets as B
    from madsim_tpu_torch.analysis.tracelint import (ledger_key, registry,
                                                     run_trace)

    findings, lines = run_trace(budget_check=False, device=args.device)
    if findings:
        for f in findings:
            print(f.render(), file=sys.stderr)
        print("update_torch_budgets: fix the findings first",
              file=sys.stderr)
        return 1
    path = args.budgets or B.DEFAULT_LEDGER
    doc = (B.load_ledger(path) if os.path.exists(path)
           else {"programs": {}})
    regs = registry()
    import torch

    dev = torch.device(args.device or "cuda")
    programs = {k: v for k, v in doc.get("programs", {}).items()
                if k in regs and regs[k].budget}
    for name, prog in regs.items():
        if not prog.budget or name not in lines:
            continue
        key = ledger_key(dev, prog)
        entry = dict(programs.get(name, {}))
        entry["note"] = prog.title
        entry[key] = B.make_entry(lines[name], entry.get(key))
        programs[name] = entry
    B.write_ledger({"justification": args.reason, "programs": programs},
                   path)
    print(f"wrote {path}: {len(programs)} programs")
    return 0


if __name__ == "__main__":
    sys.exit(main())
