"""actorc — the actor compiler, ported (docs/actorc.md).

The PyTorch counterpart of ``madsim_tpu.actorc``:

- :mod:`~madsim_tpu_torch.actorc.spec` — the spec model (lanes with
  declared value ranges, typed messages/timers, guarded transitions,
  invariants, disk-vs-memory restart annotations) and its pointed
  validation;
- :mod:`~madsim_tpu_torch.actorc.compile` — the compiler: packed lane
  layout from declared ranges, widen/narrow boundaries by construction,
  merged-handler dispatch, one ``make_outbox`` assembly, the bounded-draw
  RNG discipline, generated ``kind_names`` and counter-derived
  ``observe()``, behind the speclint gate
  (:mod:`madsim_tpu_torch.analysis.speclint`);
- :mod:`~madsim_tpu_torch.actorc.host` — the generated host reference
  interpreter (same spec, same transition callables, numpy backend);
- :mod:`~madsim_tpu_torch.actorc.conformance` — the lockstep per-event
  state/outbox/bug crosscheck between the two (and, on CUDA, the step
  kernel against the plain step at every recorded step);
- :mod:`~madsim_tpu_torch.actorc.families` — the shipped spec-defined
  families: tpc, pb and multi-decree Paxos.
"""
from .compile import CompiledActor, Ctx, compile_actor
from .conformance import HostTwinMismatch, crosscheck
from .host import HostActor, HostOutbox
from .spec import ActorSpec, Lane, Message, SpecError, Word, validate_spec

__all__ = [
    "ActorSpec", "Lane", "Message", "Word", "SpecError", "validate_spec",
    "CompiledActor", "Ctx", "compile_actor",
    "HostActor", "HostOutbox",
    "crosscheck", "HostTwinMismatch",
]
