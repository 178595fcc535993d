"""The speclint rule catalog (pass 4's SPC codes).

The port's copy of the rows of ``madsim_tpu/analysis/rules.py`` that
pass 4 emits: the ``SPC`` rules, which fire on *protocol state
machines* — the ``actorc.spec`` declarations — before the compiler
lowers them to packed lanes (unreachable kinds, unhandled deliveries,
unarmed timers, counters whose static bound escapes their packed dtype,
transitions leaning on DSL features the lowering flattens, volatile
state read with no restart reconstruction), plus the two hygiene codes:
DET900 (a stale ``# detlint: allow[...]`` pragma) and SPC900 (a stale
``lint_allow`` entry). The rows' text is the JAX package's, so a
finding renders byte for byte the same in both packages.

Pass 3 (tracelint, :mod:`.tracelint`) keeps the rules that mean something
without XLA, with rows of the port's own: TRC001 (a program's device part
reads back to the host outside its declared reads), TRC002 (an op with no
deterministic implementation), TRC004 (a program that declares it writes
its state in place allocates a new one) and the ledger's BUD001/BUD002.
:data:`NOT_CARRIED` names the JAX rules that do not carry over. Passes 1
and 2 (DET0xx, PAR) check the JAX package's host runtime, which is
outside the port.
"""
from __future__ import annotations

from typing import Dict, NamedTuple


class Rule(NamedTuple):
    code: str
    title: str
    suggestion: str


RULES: Dict[str, Rule] = {r.code: r for r in [
    Rule("DET900", "stale pragma: allow[...] names a rule with no finding",
         "delete the pragma (or the code that made it necessary came back)"),
    Rule("SPC001", "spec fails validation or abstract evaluation",
         "fix the declaration/handler the message names — the spec cannot "
         "lower until its own model is well-formed"),
    Rule("SPC010", "unreachable message kind",
         "seed it from init, emit it from a reachable transition, or delete "
         "the dead kind (and its handler)"),
    Rule("SPC011", "message kind delivered but not handled",
         "add a handler, or declare the drop deliberate via ignore=(...) on "
         "the spec — implicit drops are how real protocol bugs hide"),
    Rule("SPC012", "transition with no effects (dead no-op handler)",
         "implement it, delete it, or declare the kind in terminal=(...) if "
         "absorbing is the point"),
    Rule("SPC013", "spec declaration hygiene (ignore/terminal misuse)",
         "ignore/terminal must name declared kinds, an ignored kind cannot "
         "also be handled, and a terminal kind's handler must not emit"),
    Rule("SPC020", "timer handled but never armed on any path",
         "arm it from a transition, the on_restart hook or an init event — "
         "or delete the dead timer"),
    Rule("SPC021", "multiple timer arms without provably-disjoint conditions",
         "the lowering's single merged timer row is last-write-wins; make "
         "the arm conditions disjoint (when=cond / when=~cond) or split the "
         "transition"),
    Rule("SPC030", "written value can exceed the packed lane dtype",
         "the static bound escapes the rail lane_dtype() chose from the "
         "declared range — widen the declared range (costs a wider lane), "
         "clip the expression, or tighten the inputs"),
    Rule("SPC031", "emitted payload word can escape its declared range",
         "the receiver's arg() read assumes the declared word range; widen "
         "the Word declaration or narrow the sent expression"),
    Rule("SPC040", "multiple sends without provably-disjoint conditions",
         "the single merged message row broadcasts ONE payload per step — "
         "per-destination payloads/concurrent sends are a known DSL gap; "
         "make the send conditions disjoint or split across kinds"),
    Rule("SPC041", "more than one RNG draw in a single transition",
         "the static-draw-shape rule allows one draw per event; combine "
         "draws into one mapped value or move a draw to another kind"),
    Rule("SPC050", "volatile lane read with no on_restart reconstruction",
         "a post-restart read sees the reset value; mark the lane durable, "
         "or add an on_restart hook that rebuilds it"),
    Rule("SPC900", "stale lint_allow entry: its code suppressed nothing",
         "delete the code from the spec's lint_allow tuple (or the defect "
         "it excused came back)"),
    Rule("TRC001", "host re-entry: a device-to-host read inside a program",
         "a read that is not one of the program's declared reads (the "
         "sweep's _fetch/_to_host pulls, the device loops' flag reads) "
         "stalls the queue the loops keep ahead of the host: keep the value "
         "on the device, or route a deliberate pull through _fetch"),
    Rule("TRC002", "op without a deterministic implementation",
         "the program raised under torch.use_deterministic_algorithms(True)"
         ": use an exact formulation (integer scatters, stable sorts)"),
    Rule("TRC004", "a program that declares in-place state allocated new "
         "state",
         "a state leaf's storage changed across the call: write the state "
         "in place (copy_ into the leaves), as the step kernel does"),
    Rule("BUD001", "program exceeds its checked-in budget",
         "if intentional, re-measure and regenerate "
         "madsim_tpu_torch/analysis/budgets.json via "
         "tools/update_torch_budgets.py --reason '...' in the same PR"),
    Rule("BUD002", "budget ledger out of sync with the program registry",
         "run tools/update_torch_budgets.py to add/remove the program "
         "entry (or fix the program that failed to build)"),
]}

#: The JAX package's pass-3 rules and metrics that do not carry over to
#: PyTorch and CUDA, and why (``analysis trace --list-rules``).
NOT_CARRIED = {
    "TRC003": "numerics under jax_enable_x64: torch has no x64 flag; every "
              "dtype of the port is explicit",
    "TRC005": "narrow-lane widenings in a jaxpr: the port's programs are "
              "not traced; the packed lanes are the step kernel's and "
              "state_bytes_per_world budgets their width",
    "flops, bytes_accessed, temp_bytes, peak_over_arg": "XLA's "
              "cost_analysis and memory_analysis: there is no compiled "
              "XLA program to ask",
}
