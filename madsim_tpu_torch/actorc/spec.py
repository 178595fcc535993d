"""The actor-compiler spec model: protocol state machines as data.

The PyTorch counterpart of ``madsim_tpu/actorc/spec.py``: the same
declarations, validation and messages; only :func:`lane_dtype` picks torch
dtypes. The rest of this docstring is the JAX module's.

A :class:`ActorSpec` names everything the device engine needs to know
about a protocol family — per-node state lanes with *declared value
ranges*, messages and timers with *typed payload words*, guarded
transitions as restricted pure expressions, invariants, and
restart (disk-vs-memory) annotations — and everything it deliberately
does NOT let you say: no Python control flow on traced values, no raw
``x[i]`` indexing, no unbounded RNG draws. The compiler
(:mod:`madsim_tpu_torch.actorc.compile`) lowers a validated spec to a
DeviceEngine actor with the packed-lane layout, a single
``actor_util.make_outbox`` assembly and ``widen``-on-read /
saturating-``narrow``-on-write boundaries placed by construction
(docs/actorc.md).

Validation happens at two points, both BEFORE any deep trace-time
failure could occur:

- spec-internal checks (:func:`validate_spec` with no config): duplicate
  names, inverted ranges, unknown handler names, kind-count limits;
- config-facing checks (:func:`validate_spec` with an ``EngineConfig``):
  the packed-width guards — ``n_nodes`` vs the int8 node lane, declared
  payload-word ranges vs the int16 at-rest payload lane, outbox
  capacity vs the (N peers + 1 timer) layout — re-raised as
  :class:`SpecError` with pointed spec-line messages naming the lane /
  message / word that violates, instead of an opaque XLA shape error.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, Optional, Tuple

import torch

__all__ = [
    "ActorSpec", "Lane", "Message", "Word", "SpecError", "validate_spec",
    "lane_dtype",
]


class SpecError(ValueError):
    """A spec that cannot compile, with the offending declaration named."""


# Lane scopes: the array shape a lane lowers to (N = spec.n_nodes,
# K = Lane.cols, leading world axis added by the engine's vmap).
SCOPE_NODE = "node"              # (N,)   one value per node
SCOPE_NODE_TABLE = "node_table"  # (N, K) one row per node
SCOPE_WORLD_VEC = "world_vec"    # (K,)   one world-global vector
SCOPE_WORLD = "world"            # ()     one world-global scalar
_SCOPES = (SCOPE_NODE, SCOPE_NODE_TABLE, SCOPE_WORLD_VEC, SCOPE_WORLD)

# Lane kinds: how the declared range maps to a dtype.
KIND_VALUE = "value"      # range-narrowed (i8/i16/i32 from [lo, hi])
KIND_BITMASK = "bitmask"  # always int32: width is bit capacity, not range
KIND_COUNTER = "counter"  # always int32 world scalar; auto-observed
_KINDS = (KIND_VALUE, KIND_BITMASK, KIND_COUNTER)


@dataclasses.dataclass(frozen=True)
class Lane:
    """One state lane: a named, range-declared array of the actor state.

    ``lo``/``hi`` are the *inclusive* declared value range; the compiler
    selects the at-rest dtype from it (:func:`lane_dtype`) — the
    packed-lane discipline applied by construction rather than by
    hand. ``durable=False`` marks the lane volatile across a node
    restart (the disk-vs-memory annotation): the restarting node's row
    resets to ``reset`` before the spec's ``on_restart`` hook runs.
    World-scoped lanes must stay durable — a single node's restart has
    no business wiping world-global state; express partial resets in
    the ``on_restart`` hook instead (the tpc spec does).
    """

    name: str
    hi: int
    lo: int = 0
    scope: str = SCOPE_NODE
    cols: int = 0                # required for *_TABLE / *_VEC scopes
    kind: str = KIND_VALUE
    durable: bool = True
    reset: int = 0
    init: int = 0


@dataclasses.dataclass(frozen=True)
class Word:
    """One typed payload word of a message/timer, with its declared
    (inclusive) value range — the packed int16 at-rest payload guard
    reads these."""

    name: str
    lo: int
    hi: int


@dataclasses.dataclass(frozen=True)
class Message:
    """One event kind. Kind codes are positional: ``spec.messages[k]``
    is kind ``k``, and ``kind_names`` falls out for free — generated
    families always render readably in ``DeviceEngine.trace()`` and the
    timeline export."""

    name: str
    words: Tuple[Word, ...] = ()
    timer: bool = False


@dataclasses.dataclass(frozen=True)
class ActorSpec:
    """A complete protocol-state-machine description (module docstring).

    ``handlers`` maps message names to transition callables ``fn(t)``
    written against the restricted
    :class:`~madsim_tpu_torch.actorc.compile.Ctx` expression surface,
    evaluated per world by the compiler (under ``torch.func.vmap``) and
    by the host twin (:mod:`~madsim_tpu_torch.actorc.host`, on numpy
    values). ``init`` seeds the world's events;
    ``on_restart`` (optional) runs after the volatile-lane resets;
    ``invariant`` is the per-step bug predicate over full lane views;
    ``observe`` adds derived metrics beyond the auto-exported counters.

    The last three fields feed speclint
    (:mod:`madsim_tpu_torch.analysis.speclint`), which gates compilation:
    ``ignore`` lists message kinds a node may legitimately receive and
    drop (exhaustiveness rule SPC011 demands every other kind be
    handled); ``terminal`` lists kinds whose handlers absorb without
    emitting (declared dead ends — an undeclared no-op transition is
    SPC012, a terminal kind that still emits is SPC013); ``lint_allow``
    names SPC codes this spec deliberately trips (the intentionally
    buggy experiment variants), with ``("*",)`` as the fixture escape
    hatch that waives the pass entirely. A ``lint_allow`` code that
    suppresses nothing is itself a finding (SPC900), so allowances
    cannot go stale.
    """

    name: str
    n_nodes: int
    lanes: Tuple[Lane, ...]
    messages: Tuple[Message, ...]
    handlers: Mapping[str, Callable[[Any], None]]
    init: Callable[[Any], None]
    invariant: Callable[[Any], Any]
    on_restart: Optional[Callable[[Any], None]] = None
    observe: Mapping[str, Callable[[Any], Any]] = \
        dataclasses.field(default_factory=dict)
    invariant_id: str = ""
    ignore: Tuple[str, ...] = ()
    terminal: Tuple[str, ...] = ()
    lint_allow: Tuple[str, ...] = ()

    def lane(self, name: str) -> Lane:
        for ln in self.lanes:
            if ln.name == name:
                return ln
        raise SpecError(f"spec {self.name!r}: unknown lane {name!r} "
                        f"(declared: {[x.name for x in self.lanes]})")

    def kind_of(self, msg_name: str) -> int:
        for k, m in enumerate(self.messages):
            if m.name == msg_name:
                return k
        raise SpecError(f"spec {self.name!r}: unknown message "
                        f"{msg_name!r} (declared: "
                        f"{[m.name for m in self.messages]})")

    def message(self, msg_name: str) -> Message:
        return self.messages[self.kind_of(msg_name)]


def _fits(lo: int, hi: int, bits: int) -> bool:
    return lo >= -(1 << (bits - 1)) and hi <= (1 << (bits - 1)) - 1


def lane_dtype(lane: Lane, lanes) -> Any:
    """The at-rest dtype of ``lane`` under a
    :class:`~madsim_tpu_torch.engine.lanes.Lanes` profile: the narrowest
    registry category the declared range fits — i8 via the code lane,
    i16 via the slot lane, else wide — so packing decisions are a pure
    function of the declaration (under the WIDE profile every category
    is int32 and this degrades to the reference layout for free).
    Bitmask and counter lanes stay int32 in both profiles, exactly like
    the hand-written actors' vote/ack masks and counters."""
    if lane.kind in (KIND_BITMASK, KIND_COUNTER):
        return torch.int32
    if _fits(lane.lo, lane.hi, 8):
        return lanes.code
    if _fits(lane.lo, lane.hi, 16):
        return lanes.slot
    return torch.int32


def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise SpecError(msg)


def validate_spec(spec: ActorSpec, cfg=None) -> None:
    """Validate ``spec`` — alone, or against an ``EngineConfig``.

    Raises :class:`SpecError` with a message naming the offending
    declaration. The config-facing half re-raises the engine's packed
    width limits at the *spec* level: by the time a bad spec would have
    failed deep inside a trace (an int8 node id aliasing, a payload
    word saturating silently), the error here has already named the
    exact lane or message word to fix.
    """
    who = f"spec {spec.name!r}"
    _check(bool(spec.messages), f"{who}: declares no messages")
    _check(len(spec.messages) <= 64,
           f"{who}: declares {len(spec.messages)} event kinds; the packed "
           "event queue carries kinds in 6 bits (max 64)")
    names = [m.name for m in spec.messages]
    _check(len(set(names)) == len(names),
           f"{who}: duplicate message names {sorted(names)}")
    lnames = [x.name for x in spec.lanes]
    _check(len(set(lnames)) == len(lnames),
           f"{who}: duplicate lane names {sorted(lnames)}")
    _check(spec.n_nodes >= 1, f"{who}: n_nodes must be >= 1")
    for h in spec.handlers:
        _check(h in names,
               f"{who}: handler for unknown message {h!r} "
               f"(declared: {names})")
    for ln in spec.lanes:
        w = f"{who}: lane {ln.name!r}"
        _check(ln.scope in _SCOPES, f"{w}: unknown scope {ln.scope!r}")
        _check(ln.kind in _KINDS, f"{w}: unknown kind {ln.kind!r}")
        _check(ln.lo <= ln.hi,
               f"{w}: declared range [{ln.lo}, {ln.hi}] is inverted")
        if ln.scope in (SCOPE_NODE_TABLE, SCOPE_WORLD_VEC):
            _check(ln.cols >= 1, f"{w}: scope {ln.scope!r} needs cols >= 1")
        if ln.kind == KIND_COUNTER:
            _check(ln.scope == SCOPE_WORLD,
                   f"{w}: counters are world scalars (scope='world')")
        if ln.kind == KIND_BITMASK:
            _check(spec.n_nodes <= 31,
                   f"{w}: int32 bitmask lanes hold at most 31 node bits "
                   f"(n_nodes={spec.n_nodes})")
        if not ln.durable:
            _check(ln.scope in (SCOPE_NODE, SCOPE_NODE_TABLE),
                   f"{w}: durable=False (volatile across restart) is "
                   "only meaningful for per-node lanes; reset "
                   "world-scoped state in the on_restart hook instead")
            _check(ln.lo <= ln.reset <= ln.hi,
                   f"{w}: restart reset value {ln.reset} is outside the "
                   f"declared range [{ln.lo}, {ln.hi}]")
        _check(ln.lo <= ln.init <= ln.hi,
               f"{w}: init value {ln.init} is outside the declared "
               f"range [{ln.lo}, {ln.hi}]")
    for m in spec.messages:
        wnames = [x.name for x in m.words]
        _check(len(set(wnames)) == len(wnames),
               f"{who}: message {m.name!r} has duplicate word names "
               f"{sorted(wnames)}")
        for wd in m.words:
            _check(wd.lo <= wd.hi,
                   f"{who}: message {m.name!r} word {wd.name!r} declares "
                   f"an inverted range [{wd.lo}, {wd.hi}]")

    if cfg is None:
        return
    _check(cfg.n_nodes == spec.n_nodes,
           f"{who}: declares n_nodes={spec.n_nodes} but "
           f"EngineConfig.n_nodes={cfg.n_nodes}")
    if cfg.packed and spec.n_nodes > 127:
        raise SpecError(
            f"{who}: n_nodes={spec.n_nodes} exceeds the packed int8 node "
            "lane (max 127). Compile against EngineConfig(packed=False) "
            "— the int32 reference profile — or shrink the cluster.")
    _check(cfg.m == spec.n_nodes + 1,
           f"{who}: compiled actors use the (N peers + 1 timer) "
           f"actor_util.make_outbox layout — EngineConfig outbox "
           f"capacity must be n_nodes + 1 = {spec.n_nodes + 1}, got "
           f"{cfg.m}")
    need_words = max((len(m.words) for m in spec.messages), default=0)
    _check(cfg.payload_words >= need_words,
           f"{who}: message payloads declare up to {need_words} words "
           f"but EngineConfig.payload_words={cfg.payload_words}")
    if cfg.packed:
        for m in spec.messages:
            for wd in m.words:
                if not _fits(wd.lo, wd.hi, 16):
                    raise SpecError(
                        f"{who}: message {m.name!r} word {wd.name!r} "
                        f"declares range [{wd.lo}, {wd.hi}], which "
                        "overflows the packed int16 at-rest payload "
                        "lane — a value past +-32767 would saturate "
                        "silently in the queue. Narrow the declared "
                        "range, split the value across two words, or "
                        "compile with packed=False.")
