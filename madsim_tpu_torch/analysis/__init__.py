"""speclint — static verification of actorc specs, ported.

The PyTorch package's counterpart of ``madsim_tpu.analysis``, pass 4
only (:mod:`.speclint`): reachability and exhaustiveness over the kind
graph, timer discipline, interval proofs that written values fit their
packed lane dtypes and emitted payload words their declared ranges,
per-transition RNG/send/arm budgets against what the lowering supports,
and the durability-flow check (SPC0xx). ``CompiledActor`` runs it as a
hard compile gate, and triage bundles of a compiled family carry its
protocol card.

The JAX package's other passes are not ported:

- passes 1–2 (``escape.py``, ``parity.py``) scan the source of the JAX
  package's host runtime and its sim/real trees, which are outside the
  port;
- pass 3 (``tracelint.py``, ``budgets.py``) checks compiled XLA programs
  against a budget ledger; what carries over to the port (host syncs,
  state bytes per world) is ROADMAP Queue A item 12.

CLI: ``python -m madsim_tpu_torch.analysis spec [--card FAMILY]``.
Suppression: ``# detlint: allow[SPC...]`` pragmas (stale ones are DET900)
and the spec-level ``lint_allow`` tuple (stale entries are SPC900).
"""
from .cli import main
from .pragmas import Finding
from .rules import RULES, Rule
from .speclint import (gate_spec, lint_spec, main_spec, protocol_card,
                       run_spec_pass, shipped_specs)

__all__ = [
    "main", "main_spec", "lint_spec", "gate_spec", "protocol_card",
    "run_spec_pass", "shipped_specs", "Finding", "RULES", "Rule",
]
