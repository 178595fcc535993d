"""The port's checked-in budget ledger (``analysis/budgets.json``).

The counterpart of ``madsim_tpu/analysis/budgets.py`` for what carries
over without XLA. Per registered program (:mod:`.tracelint`) and per
device type and lane profile (a key such as ``cuda/packed``), the ledger
records two measurements, each beside its ceiling:

- ``host_syncs``: the device-to-host reads one call makes through the
  port's declared reads (the sweep's ``_fetch``/``_to_host`` pulls, the
  device loops' flag reads, a bridge round's copy out). A count, so the
  ceiling is the measurement itself: one more read trips BUD001.
- ``state_bytes_per_world``: the bytes of world state a world takes,
  from the state's leaves. A pure function of shapes and dtypes, so the
  ceiling sits 2% above it: one narrow lane widened to int32 trips it.

Ceilings RATCHET as in the JAX package: regeneration
(``tools/update_torch_budgets.py``) keeps a ceiling while the fresh
measurement fits under it, and a raised one needs ``--reason``, recorded
in the ledger's ``justification``. The schema is the port's own; the JAX
ledger's XLA metrics (flops, bytes accessed, temp and peak sizes, the
donation fraction) have no counterpart here.
"""
from __future__ import annotations

import json
import math
import os
from typing import Any, Dict, List, Optional

from .pragmas import Finding
from .rules import RULES

DEFAULT_LEDGER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "budgets.json")
LEDGER_SCHEMA = "madsim_tpu_torch.tracelint.budgets/1"

#: Metrics gated as ceilings (measured must stay <= budget).
CEILING_METRICS = ("host_syncs", "state_bytes_per_world")


def load_ledger(path: Optional[str] = None) -> Dict[str, Any]:
    path = path or DEFAULT_LEDGER
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    if doc.get("schema") != LEDGER_SCHEMA:
        raise ValueError(f"{path}: not a {LEDGER_SCHEMA} ledger "
                         f"(schema={doc.get('schema')!r})")
    return doc


def budget_for(ledger: Dict[str, Any], program: str, key: str,
               metric: str) -> Optional[float]:
    """One ceiling from the ledger (``key`` is ``device/profile``); None
    when absent."""
    field = ledger.get("programs", {}).get(program, {}).get(key, {}) \
        .get(metric)
    return field.get("budget") if isinstance(field, dict) else None


def _finding(program: str, rule: str, msg: str) -> Finding:
    r = RULES[rule]
    return Finding(f"trace/{program}", 0, rule,
                   f"{r.title}: {msg} — {r.suggestion}")


def diff_ledger(measured: Dict[str, Dict[str, Any]], key: str,
                ledger: Dict[str, Any],
                registered: Optional[List[str]] = None) -> List[Finding]:
    """Compare fresh measurements (program → metrics, on ``key``) against
    the ledger: BUD001 where a metric exceeds its ceiling, BUD002 where a
    measured program has no entry for ``key`` or (given ``registered``)
    an entry names a program the registry does not hold."""
    findings: List[Finding] = []
    programs = ledger.get("programs", {})
    for name, m in sorted(measured.items()):
        entry = programs.get(name, {}).get(key)
        if entry is None:
            findings.append(_finding(
                name, "BUD002", f"program has no {key} entry in "
                "madsim_tpu_torch/analysis/budgets.json"))
            continue
        for metric in CEILING_METRICS:
            budget = budget_for(ledger, name, key, metric)
            if budget is None or m.get(metric) is None:
                continue
            if float(m[metric]) > float(budget):
                findings.append(_finding(
                    name, "BUD001",
                    f"{metric} on {key} measured {m[metric]} > budget "
                    f"{budget} (ledger measured "
                    f"{entry[metric].get('measured')})"))
    if registered is not None:
        for name in sorted(programs):
            if name not in registered:
                findings.append(_finding(
                    name, "BUD002", "ledger entry names a program the "
                    "registry no longer registers"))
    return findings


def make_entry(m: Dict[str, Any],
               prev: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """One ``device/profile`` entry from a measurement, ratcheting: a
    ceiling survives while the fresh measurement fits under it."""
    prev = prev or {}
    entry: Dict[str, Any] = {}
    for metric in CEILING_METRICS:
        if m.get(metric) is None:
            continue
        val = float(m[metric])
        old = prev.get(metric, {}).get("budget") if isinstance(
            prev.get(metric), dict) else None
        if old is not None and val <= float(old):
            budget = float(old)
        elif metric == "host_syncs":
            budget = val
        else:
            budget = float(math.ceil(val * 1.02))
        entry[metric] = {"measured": val, "budget": budget}
    return entry


def write_ledger(doc: Dict[str, Any], path: Optional[str] = None) -> str:
    path = path or DEFAULT_LEDGER
    doc = dict(doc, schema=LEDGER_SCHEMA,
               programs={k: doc["programs"][k]
                         for k in sorted(doc["programs"])})
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=2)
        f.write("\n")
    os.replace(tmp, path)
    return path
