"""Program analysis, ported: tracelint (pass 3) and speclint (pass 4).

The PyTorch package's counterpart of ``madsim_tpu.analysis``:

- pass 3 (:mod:`.tracelint`, :mod:`.budgets`): the sweep's hot-path
  programs, at the JAX registry's names and shapes, each run once on the
  device: host re-entry outside a program's declared reads (TRC001),
  nondeterministic ops on CUDA (TRC002), in-place state where the JAX
  program donates (TRC004), and the checked-in ledger of host syncs per
  call and state bytes per world (BUD001/BUD002). What needs XLA (x64
  numerics, jaxpr dtype discipline, cost and memory analysis) does not
  carry over (:data:`.rules.NOT_CARRIED`);
- pass 4 (:mod:`.speclint`): reachability and exhaustiveness over the
  kind graph, timer discipline, interval proofs that written values fit
  their packed lane dtypes and emitted payload words their declared
  ranges, per-transition RNG/send/arm budgets against what the lowering
  supports, and the durability-flow check (SPC0xx). ``CompiledActor``
  runs it as a hard compile gate, and triage bundles of a compiled family
  carry its protocol card.

Passes 1–2 (``escape.py``, ``parity.py``) scan the source of the JAX
package's host runtime and its sim/real trees, which are outside the
port.

CLI: ``python -m madsim_tpu_torch.analysis trace [--device cpu]`` and
``... spec [--card FAMILY]``. Suppression: ``# detlint: allow[SPC...]``
pragmas (stale ones are DET900), the spec-level ``lint_allow`` tuple
(stale entries are SPC900), and the entries of an allowlist file given
to ``trace --allowlist`` for ``trace/<program>`` pseudo-paths.
"""
from .cli import main, main_trace
from .pragmas import Allowlist, Finding
from .rules import RULES, Rule
from .speclint import (gate_spec, lint_spec, main_spec, protocol_card,
                       run_spec_pass, shipped_specs)

__all__ = [
    "main", "main_trace", "main_spec", "lint_spec", "gate_spec",
    "protocol_card", "run_spec_pass", "shipped_specs", "Allowlist",
    "Finding", "RULES", "Rule",
]
