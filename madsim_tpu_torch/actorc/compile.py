"""The actor compiler: lower an
:class:`~madsim_tpu_torch.actorc.spec.ActorSpec` to a DeviceEngine actor.

The PyTorch counterpart of ``madsim_tpu/actorc/compile.py``, bit for bit.
A spec's transitions, restart hook and invariant are written for ONE world
(the JAX package ``vmap``s them); here they run under ``torch.func.vmap``
over the world axis, so the spec bodies stay the JAX package's text and
every per-world value is a 0-d tensor. The merge passes, the outbox
assembly and the RNG rules are the JAX module's:

- **Lane layout**: at-rest dtypes from the declared value ranges
  (:func:`~madsim_tpu_torch.actorc.spec.lane_dtype`); every lane read
  widens to int32 and every write saturates into the lane's dtype.
- **Reads see the pre-step state**: every transition reads the state
  before the step; the writes it records are folded afterwards
  (:meth:`CompiledActor._merge_writes`), one lane at a time.
- **Merged dispatch**: every kind's transition is evaluated on every step,
  gated by its kind predicate; the outbox is one (N peers + 1 timer)
  ``make_outbox`` assembly.
- **One draw per step**: a transition that draws consumes the step's one
  u32, and the cursor advances only where the handled kind drew. A
  restart hook's draws advance the cursor unconditionally.
- **Restart**: volatile lanes reset for the restarting node before the
  spec's ``on_restart`` hook runs.
- **The speclint gate**: :class:`CompiledActor` runs
  :func:`~madsim_tpu_torch.analysis.speclint.gate_spec` (pass 4) right
  after :func:`validate_spec`, as the JAX compiler does, so a spec with
  findings does not lower.

The same spec feeds :mod:`madsim_tpu_torch.actorc.host`, the plain-Python
reference interpreter, which :mod:`madsim_tpu_torch.actorc.conformance`
holds this lowering to, event by event. (speclint's frame walk skips this
file by its name, ``compile.py``, to report the spec's own lines.)
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Tuple

import torch
from torch.func import vmap

from ..engine.actor_util import make_outbox
from ..engine.core import EngineConfig, Outbox
from ..engine.lanes import narrow, on_device, popcount32, widen
from ..engine.queue import Event, FLAG_TIMER
from ..engine.rng import DevRng, _u32_to_range, next_u32, uniform_u32
from ..ops.threefry import i64_to_u32, threefry2x32_i64, u32_to_i64
from .spec import (
    ActorSpec,
    KIND_COUNTER,
    Lane,
    SCOPE_NODE,
    SCOPE_NODE_TABLE,
    SCOPE_WORLD,
    SCOPE_WORLD_VEC,
    SpecError,
    lane_dtype,
    validate_spec,
)

__all__ = ["CompiledActor", "Ctx", "compile_actor"]


# ---------------------------------------------------------------------------
# Per-world values (0-d tensors under vmap) and the one-world lane helpers.
# ---------------------------------------------------------------------------

def _t(x, dev) -> torch.Tensor:
    """A spec value as a tensor: Python bools become bool, Python ints
    int32 (JAX's weak int), tensors stay as they are."""
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, bool):
        return on_device(x, dev)
    return on_device(x, dev, torch.int32)


def _sel(x: torch.Tensor, i) -> torch.Tensor:
    """``x[i]`` over axis 0; an out-of-range index selects zeros (the JAX
    ``lanes.sel``)."""
    n = x.shape[0]
    i = _t(i, x.device)
    row = x[i.clamp(0, n - 1)]
    return torch.where((i >= 0) & (i < n), row, torch.zeros_like(row))


def _take(x: torch.Tensor, i) -> torch.Tensor:
    """``x[i]`` over axis 0 for an index already clipped into range (where
    :func:`_sel` gives the same)."""
    return x[_t(i, x.device)]


def _onehot(i, n: int, dev) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=dev) == _t(i, dev)


def _upd(x: torch.Tensor, i, v) -> torch.Tensor:
    """``x[i] = v`` as a masked select, saturating into ``x``'s dtype
    (no-op for an out-of-range index)."""
    m = _onehot(i, x.shape[0], x.device)
    m = m.reshape(m.shape + (1,) * (x.dim() - 1))
    return torch.where(m, narrow(_t(v, x.device), x.dtype), x)


def _upd2(x: torch.Tensor, i, j, v) -> torch.Tensor:
    """``x[i, j] = v`` over the two leading axes (saturating)."""
    m = (_onehot(i, x.shape[0], x.device)[:, None]
         & _onehot(j, x.shape[1], x.device)[None, :])
    return torch.where(m, narrow(_t(v, x.device), x.dtype), x)


class _TorchNP:
    """The ``np`` of a spec body: the numpy-style reductions the specs use,
    on torch tensors (``axis`` as numpy names it)."""

    def __init__(self, dev):
        self._dev = dev

    def arange(self, k: int):
        return torch.arange(k, dtype=torch.int32, device=self._dev)

    @staticmethod
    def any(x, axis=None):
        return torch.any(x) if axis is None else torch.any(x, dim=axis)

    @staticmethod
    def max(x, axis=None):
        return torch.amax(x) if axis is None else torch.amax(x, dim=axis)


@dataclasses.dataclass
class _Send:
    msg: str
    dst: Any          # None => broadcast
    to: Any           # broadcast target mask override (None => others)
    words: Tuple[Any, ...]
    when: Any


@dataclasses.dataclass
class _Arm:
    msg: str
    delay: Any
    words: Tuple[Any, ...]
    when: Any
    dst: Any          # None => the handling node


class Ctx:
    """The restricted expression surface a spec transition writes against.

    One instance is passed to each transition callable, whose values are
    one world's (0-d tensors under ``vmap``). A transition body restricts
    itself to:

    - arithmetic / comparison / bitwise Python operators on ctx values;
    - the ctx helpers (``where``, ``maximum``, ``minimum``, ``clip``,
      ``popcount``, ``arange``, and ``np`` for vector expressions);
    - reads (``read*``), guarded writes (``write*``, ``count``),
      message/timer emission (``send``/``broadcast``/``arm``), the
      ``bug`` predicate, and at most ONE RNG draw (``u32``/``uniform``).

    No Python ``if`` on ctx values, no raw indexing, no other imports.
    """

    def __init__(self, spec: ActorSpec, cfg_payload_words: int,
                 me, now, src, msg=None):
        self._spec = spec
        self._pw = cfg_payload_words
        self.me = me
        self.now = now
        self.src = src
        self._msg = msg
        self._writes: List[Tuple[str, str, Any, Any, Any]] = []
        self._sends: List[_Send] = []
        self._arms: List[_Arm] = []
        self._bugs: List[Any] = []
        self._drew = False

    # -- payload words -------------------------------------------------
    def arg(self, name: str):
        """The named payload word of the event being handled (wide)."""
        if self._msg is None:
            raise SpecError(f"spec {self._spec.name!r}: arg({name!r}) is "
                            "only available inside a message handler")
        for i, wd in enumerate(self._msg.words):
            if wd.name == name:
                return self._payload_word(i)
        raise SpecError(
            f"spec {self._spec.name!r}: message {self._msg.name!r} has no "
            f"word {name!r} (declared: "
            f"{[w.name for w in self._msg.words]})")

    # -- guarded writes ------------------------------------------------
    def write(self, lane: str, value, when=True) -> None:
        """Write the handling node's value of a per-node lane."""
        self._record(SCOPE_NODE, lane, None, value, when)

    def write_at(self, lane: str, col, value, when=True) -> None:
        """Write the handling node's row of a node-table lane at ``col``
        (clipped into range, like every ctx column index)."""
        self._record(SCOPE_NODE_TABLE, lane, col, value, when)

    def write_vec_at(self, lane: str, idx, value, when=True) -> None:
        self._record(SCOPE_WORLD_VEC, lane, idx, value, when)

    def write_vec(self, lane: str, value, when=True) -> None:
        """Full-vector write of a world-vector lane; ``when`` may be a
        per-element mask."""
        self._record("world_vec_full", lane, None, value, when)

    def write_scalar(self, lane: str, value, when=True) -> None:
        self._record(SCOPE_WORLD, lane, None, value, when)

    def count(self, lane: str, amount=1, when=True) -> None:
        """Increment a counter lane (auto-exported by ``observe()``)."""
        if self._spec.lane(lane).kind != KIND_COUNTER:
            raise SpecError(f"spec {self._spec.name!r}: count() targets "
                            f"counter lanes; {lane!r} is not one")
        self._record("count", lane, None, amount, when)

    def _record(self, op: str, lane: str, idx, value, when) -> None:
        ln = self._spec.lane(lane)
        expect = {SCOPE_NODE: SCOPE_NODE, SCOPE_NODE_TABLE: SCOPE_NODE_TABLE,
                  SCOPE_WORLD_VEC: SCOPE_WORLD_VEC,
                  "world_vec_full": SCOPE_WORLD_VEC,
                  SCOPE_WORLD: SCOPE_WORLD, "count": SCOPE_WORLD}[op]
        if ln.scope != expect:
            raise SpecError(
                f"spec {self._spec.name!r}: lane {lane!r} has scope "
                f"{ln.scope!r}; this write form needs {expect!r}")
        self._writes.append((op, lane, idx, value, when))

    # -- messages / timers --------------------------------------------
    def send(self, msg: str, dst, words=(), when=True) -> None:
        """Send one message to node ``dst``."""
        self._emit_msg(msg, timer=False)
        self._sends.append(_Send(msg, dst, None, tuple(words), when))

    def broadcast(self, msg: str, words=(), when=True, to=None) -> None:
        """Send one message to every other node (or the ``to`` mask)."""
        self._emit_msg(msg, timer=False)
        self._sends.append(_Send(msg, None, to, tuple(words), when))

    def arm(self, timer: str, delay, words=(), when=True, dst=None) -> None:
        """Arm one timer: delivered to ``dst`` (default: this node)
        after ``delay`` µs, generation-checked like every timer."""
        self._emit_msg(timer, timer=True)
        self._arms.append(_Arm(timer, delay, tuple(words), when, dst))

    def _emit_msg(self, name: str, timer: bool) -> None:
        m = self._spec.message(name)
        if m.timer != timer:
            kindw = "a timer" if m.timer else "a message"
            raise SpecError(f"spec {self._spec.name!r}: {name!r} is "
                            f"declared {kindw}; use "
                            f"{'arm' if m.timer else 'send/broadcast'}()")

    def _check_words(self, msg: str, words) -> None:
        m = self._spec.message(msg)
        if len(words) != len(m.words):
            raise SpecError(
                f"spec {self._spec.name!r}: {msg!r} declares "
                f"{len(m.words)} payload words "
                f"({[w.name for w in m.words]}); got {len(words)}")

    # -- the bug flag --------------------------------------------------
    def bug(self, when) -> None:
        """Latch the world's bug flag when ``when`` holds."""
        self._bugs.append(when)

    # -- RNG (at most one draw per transition) -------------------------
    def u32(self):
        """The step's raw u32 draw; marks it consumed."""
        self._mark_draw()
        return self._raw_u32()

    def uniform(self, lo: int, hi: int):
        """The step's draw mapped to [lo, hi) — engine ``uniform_u32``
        parity."""
        self._mark_draw()
        return self._uniform(lo, hi)

    def _mark_draw(self) -> None:
        if self._drew:
            raise SpecError(
                f"spec {self._spec.name!r}: a transition may draw at most "
                "once per event (the static-draw-shape rule, "
                "docs/ACTORS.md); combine draws into one mapped value")
        self._drew = True


class _DeviceCtx(Ctx):
    """One world's transition context: reads widen, helpers are torch ops,
    writes and sends are recorded for the compiler's merge pass."""

    def __init__(self, spec, cfg: EngineConfig, state, me, now, src,
                 msg=None, payload=None, u=None):
        super().__init__(spec, cfg.payload_words, me, now, src, msg)
        self._cfg = cfg
        self._state = state
        self._payload = payload
        self._u = u
        self._dev = me.device
        self.np = _TorchNP(self._dev)

    # reads (widen-on-read)
    # (``me`` and every index are clipped into range, so a take is the
    # JAX package's one-hot select.)
    def read(self, lane: str):
        return widen(_take(self._state[self._lane(lane, SCOPE_NODE)],
                           self.me))

    def read_node(self, lane: str, node):
        ln = self._lane(lane, SCOPE_NODE)
        return widen(_take(self._state[ln],
                           self.clip(node, 0, self._spec.n_nodes - 1)))

    def read_at(self, lane: str, col):
        ln = self._spec.lane(lane)
        self._lane(lane, SCOPE_NODE_TABLE)
        return widen(_take(_take(self._state[lane], self.me),
                           self.clip(col, 0, ln.cols - 1)))

    def read_row(self, lane: str):
        self._lane(lane, SCOPE_NODE_TABLE)
        return widen(_take(self._state[lane], self.me))

    def read_vec_at(self, lane: str, idx):
        ln = self._spec.lane(lane)
        self._lane(lane, SCOPE_WORLD_VEC)
        return widen(_take(self._state[lane],
                           self.clip(idx, 0, ln.cols - 1)))

    def read_vec(self, lane: str):
        self._lane(lane, SCOPE_WORLD_VEC)
        return widen(self._state[lane])

    def read_scalar(self, lane: str):
        self._lane(lane, SCOPE_WORLD)
        return widen(self._state[lane])

    def _lane(self, lane: str, scope: str) -> str:
        ln = self._spec.lane(lane)
        if ln.scope != scope:
            raise SpecError(f"spec {self._spec.name!r}: lane {lane!r} has "
                            f"scope {ln.scope!r}; this read form needs "
                            f"{scope!r}")
        return lane

    # expression helpers
    def where(self, c, a, b):
        return torch.where(_t(c, self._dev), _t(a, self._dev),
                           _t(b, self._dev))

    def maximum(self, a, b):
        return torch.maximum(_t(a, self._dev), _t(b, self._dev))

    def minimum(self, a, b):
        return torch.minimum(_t(a, self._dev), _t(b, self._dev))

    def clip(self, x, lo, hi):
        return torch.clamp(_t(x, self._dev), lo, hi)

    def popcount(self, x):
        return popcount32(_t(x, self._dev))

    def arange(self, k: int):
        return torch.arange(k, dtype=torch.int32, device=self._dev)

    def others(self):
        """(N,) bool: every node but the handling one."""
        return self.arange(self._spec.n_nodes) != self.me

    def _payload_word(self, i: int):
        return self._payload[i]

    def _raw_u32(self):
        return self._u

    def _uniform(self, lo, hi):
        return _u32_to_range(self._u, lo, hi)


class _DeviceRestartCtx(_DeviceCtx):
    """on_restart hook backend: draws advance the carried cursor
    unconditionally (a restart is one concrete event, not a merged
    kind). ``k0``/``k1``/``counter`` are the world's key and cursor as
    int64 values in [0, 2^32)."""

    def __init__(self, spec, cfg, state, node, now, k0, k1, counter):
        super().__init__(spec, cfg, state, me=node, now=now, src=node)
        self._k0, self._k1, self._ctr = k0, k1, counter

    def _mark_draw(self) -> None:
        pass  # unconditional draws; each call advances the cursor

    def _raw_u32(self):
        x, _ = threefry2x32_i64(self._k0, self._k1, self._ctr,
                                torch.zeros_like(self._ctr))
        self._ctr = (self._ctr + 1) & 0xFFFFFFFF
        return x

    def _uniform(self, lo, hi):
        return _u32_to_range(self._raw_u32(), lo, hi)


class _InitCtx:
    """Spec ``init`` backend, over the world axis: schedules the world's
    seed events. Draw order is the contract: ``uniform``/``u32`` advance
    the world RNG cursor in call order."""

    def __init__(self, spec: ActorSpec, cfg: EngineConfig, rng: DevRng):
        self._spec = spec
        self._cfg = cfg
        self._rng = rng
        self._w = rng.k0.shape[0]
        self._dev = rng.k0.device
        self.np = _TorchNP(self._dev)
        self._events: List[Event] = []

    def _i32(self, x) -> torch.Tensor:
        return on_device(x, self._dev).to(torch.int32).expand(self._w)

    def event(self, msg: str, time, dst=0, src=None, words=()) -> None:
        """Schedule one seed event (a timer when ``msg`` is declared one —
        timers are generation-checked from the start)."""
        m = self._spec.message(msg)
        if len(words) != len(m.words):
            raise SpecError(
                f"spec {self._spec.name!r}: init event {msg!r} needs "
                f"{len(m.words)} words ({[w.name for w in m.words]}); "
                f"got {len(words)}")
        payload = torch.zeros((self._w, self._cfg.payload_words),
                              dtype=torch.int32, device=self._dev)
        for i, wd in enumerate(words):
            payload[:, i] = self._i32(wd)
        self._events.append(Event(
            time=self._i32(time), kind=self._i32(self._spec.kind_of(msg)),
            flags=self._i32(FLAG_TIMER if m.timer else 0),
            src=self._i32(dst if src is None else src), dst=self._i32(dst),
            gen=self._i32(0), payload=payload))

    def uniform(self, lo: int, hi: int):
        x, self._rng = uniform_u32(self._rng, lo, hi)
        return x

    def u32(self):
        x, self._rng = next_u32(self._rng)
        return x


class _VecReader:
    """Full-lane views of one world for ``invariant`` bodies: every lane
    widened, vector helpers through ``np``."""

    def __init__(self, spec: ActorSpec, state, dev):
        self._spec = spec
        self._state = state
        self.np = _TorchNP(dev)

    def lane(self, name: str):
        self._spec.lane(name)
        return widen(self._state[name])

    def sel(self, name: str, i):
        """Row ``i`` of a lane, by a per-world index (zeros out of
        range)."""
        self._spec.lane(name)
        return widen(_sel(self._state[name], i))

    def n_nodes(self) -> int:
        return self._spec.n_nodes


class _ObsReader:
    """Raw batched lane views (world axis first) for derived ``observe``
    entries; bodies reduce node axes with ``dim=-1`` / ``dim=-2``."""

    def __init__(self, spec: ActorSpec, state):
        self._spec = spec
        self._state = state

    def raw(self, name: str):
        self._spec.lane(name)
        return self._state[name]


class CompiledActor:
    """An :class:`~madsim_tpu_torch.actorc.spec.ActorSpec` lowered to the
    DeviceEngine actor protocol. Use exactly like a hand-written actor::

        eng = DeviceEngine(CompiledActor(my_spec), EngineConfig(...))

    The state is a dict of lanes, one tensor per declared lane with a
    leading world axis (leaves in sorted name order, as JAX flattens a
    dict). Construction runs :func:`validate_spec`, then speclint's
    :func:`~madsim_tpu_torch.analysis.speclint.gate_spec`: a spec with
    findings raises :class:`SpecError` with the JAX gate's text (escape
    hatch: ``spec.lint_allow``, per code or ``("*",)``).
    """

    def __init__(self, spec: ActorSpec):
        validate_spec(spec)  # spec-internal checks at construction
        # Pass 4: protocol-level verification before any lowering.
        from ..analysis.speclint import gate_spec
        gate_spec(spec)
        self.spec = spec
        self.num_kinds = len(spec.messages)
        # The declaration order IS the kind code table.
        self.kind_names = [m.name for m in spec.messages]
        self.invariant_id = spec.invariant_id or spec.name

    # ------------------------------------------------------------------
    def init(self, cfg: EngineConfig, rng: DevRng):
        validate_spec(self.spec, cfg)  # packed-width guards, pointed
        lt = cfg.lanes
        w = rng.k0.shape[0]
        state = {}
        for ln in self.spec.lanes:
            state[ln.name] = torch.full((w,) + self._shape(ln), ln.init,
                                        dtype=lane_dtype(ln, lt),
                                        device=rng.k0.device)
        ictx = _InitCtx(self.spec, cfg, rng)
        self.spec.init(ictx)
        return state, ictx._events, ictx._rng

    def _shape(self, ln: Lane) -> Tuple[int, ...]:
        n = self.spec.n_nodes
        return {SCOPE_NODE: (n,), SCOPE_NODE_TABLE: (n, ln.cols),
                SCOPE_WORLD_VEC: (ln.cols,), SCOPE_WORLD: ()}[ln.scope]

    # ------------------------------------------------------------------
    def handle(self, cfg: EngineConfig, s, ev: Event, now, rng: DevRng):
        spec = self.spec
        n = spec.n_nodes
        kind = ev.kind.clamp(0, self.num_kinds - 1)
        me = ev.dst.clamp(0, n - 1)
        src = ev.src.clamp(0, n - 1)
        # ONE draw per step; transitions that consume it advance the
        # counter conditionally.
        u, rng_drawn = next_u32(rng)

        def one(s, kind, me, src, payload, now, u):
            gated: List[Tuple[Any, _DeviceCtx]] = []
            for k, msg in enumerate(spec.messages):
                fn = spec.handlers.get(msg.name)
                if fn is None:
                    continue
                t = _DeviceCtx(spec, cfg, s, me=me, now=now, src=src,
                               msg=msg, payload=payload, u=u)
                fn(t)
                gated.append((kind == k, t))
            s2 = self._merge_writes(s, me, gated)
            ob = self._merge_outbox(cfg, me, gated)
            drew = torch.zeros((), dtype=torch.bool, device=me.device)
            bug = drew
            for pred, t in gated:
                if t._drew:
                    drew = drew | pred
                for b in t._bugs:
                    bug = bug | (pred & _t(b, me.device))
            return s2, ob, drew, bug

        s2, ob, drew, bug = vmap(one)(s, kind, me, src, ev.payload, now, u)
        rng_out = rng._replace(counter=i64_to_u32(torch.where(
            drew, u32_to_i64(rng_drawn.counter), u32_to_i64(rng.counter))))
        return s2, self._outbox(cfg, me, *ob), rng_out, bug

    # ------------------------------------------------------------------
    def on_restart(self, cfg: EngineConfig, s, node, now, rng: DevRng):
        spec = self.spec

        def one(s, node, now, k0, k1, ctr):
            node = node.clamp(0, spec.n_nodes - 1)
            s2 = dict(s)
            # The disk-vs-memory annotations: volatile lanes lose the
            # restarting node's row BEFORE the hook runs.
            for ln in spec.lanes:
                if not ln.durable:
                    s2[ln.name] = _upd(s2[ln.name], node,
                                       _t(ln.reset, node.device))
            if spec.on_restart is None:
                # An empty outbox in the SAME (N peers + 1 timer) layout
                # the merge pass builds.
                return s2, self._merge_outbox(cfg, node, []), ctr
            t = _DeviceRestartCtx(spec, cfg, s2, node, now, k0, k1, ctr)
            spec.on_restart(t)
            yes = torch.ones((), dtype=torch.bool, device=node.device)
            s3 = self._merge_writes(s2, node, [(yes, t)])
            ob = self._merge_outbox(cfg, node, [(yes, t)])
            return s3, ob, t._ctr

        s2, ob, ctr = vmap(one)(s, node, now, u32_to_i64(rng.k0),
                                u32_to_i64(rng.k1), u32_to_i64(rng.counter))
        me = node.clamp(0, spec.n_nodes - 1)
        return (s2, self._outbox(cfg, me, *ob),
                rng._replace(counter=i64_to_u32(ctr)))

    # ------------------------------------------------------------------
    def invariant(self, cfg: EngineConfig, s):
        def one(s):
            dev = next(iter(s.values())).device
            return _t(self.spec.invariant(_VecReader(self.spec, s, dev)),
                      dev).to(torch.bool)

        return vmap(one)(s)

    # ------------------------------------------------------------------
    def observe(self, cfg: EngineConfig, s) -> dict:
        out = {}
        for ln in self.spec.lanes:
            if ln.kind == KIND_COUNTER:
                out[ln.name] = s[ln.name]
        o = _ObsReader(self.spec, s)
        for name, fn in self.spec.observe.items():
            out[name] = fn(o)
        return out

    # ==================================================================
    # Merge passes (one world, under vmap)
    # ==================================================================
    def _merge_writes(self, s, me, gated):
        """Fold every transition's recorded writes into one state update
        per lane, gated on (kind predicate & write condition): node-scope
        lanes take the last true write; table and vector-entry writes
        apply in turn, each against the row as the previous one left it;
        a full-vector write takes a per-element mask; counters sum their
        increments in int32. Every narrow write saturates."""
        spec = self.spec
        dev = me.device
        s2 = dict(s)
        for ln in spec.lanes:
            writes = [(pred, w) for pred, t in gated for w in t._writes
                      if w[1] == ln.name]
            if not writes:
                continue
            arr = s2[ln.name]
            if ln.scope == SCOPE_NODE:
                val = widen(_take(arr, me))
                for pred, (_op, _l, _i, v, when) in writes:
                    val = torch.where(pred & _t(when, dev), _t(v, dev), val)
                arr = _upd(arr, me, val)
            elif ln.scope == SCOPE_NODE_TABLE:
                for pred, (_op, _l, col, v, when) in writes:
                    c = torch.clamp(_t(col, dev), 0, ln.cols - 1)
                    cur = widen(_take(_take(arr, me), c))
                    arr = _upd2(arr, me, c, torch.where(
                        pred & _t(when, dev), _t(v, dev), cur))
            elif ln.scope == SCOPE_WORLD_VEC:
                for pred, (op, _l, idx, v, when) in writes:
                    if op == "world_vec_full":
                        g = pred & _t(when, dev)  # ``when`` may be a mask
                        arr = torch.where(g, narrow(_t(v, dev), arr.dtype),
                                          arr)
                    else:
                        i = torch.clamp(_t(idx, dev), 0, ln.cols - 1)
                        cur = widen(_take(arr, i))
                        arr = _upd(arr, i, torch.where(
                            pred & _t(when, dev), _t(v, dev), cur))
            else:  # SCOPE_WORLD (scalars and counters)
                if ln.kind == KIND_COUNTER:
                    total = torch.zeros((), dtype=torch.int32, device=dev)
                    zero = torch.zeros((), dtype=torch.int32, device=dev)
                    for pred, (_op, _l, _i, amount, when) in writes:
                        total = total + torch.where(
                            pred & _t(when, dev),
                            _t(amount, dev).to(torch.int32), zero)
                    arr = arr + total
                else:
                    for pred, (_op, _l, _i, v, when) in writes:
                        arr = torch.where(pred & _t(when, dev),
                                          narrow(_t(v, dev), arr.dtype), arr)
            s2[ln.name] = arr
        return s2

    def _merge_outbox(self, cfg: EngineConfig, me, gated):
        """The outbox's fields for one world, merged across kinds by
        predicate chains: the message mask (N,), its kind and words (P,),
        the timer's valid flag, kind, destination, delay and words (P,).
        The last true send sets the mask, kind and the words it carries;
        the timer is valid if any arm holds, and the last true arm sets
        its kind, destination, delay and words."""
        spec = self.spec
        n = spec.n_nodes
        dev = me.device
        i32 = torch.int32
        arange = torch.arange(n, dtype=i32, device=dev)
        zero = torch.zeros((), dtype=i32, device=dev)
        m_valid = torch.zeros((n,), dtype=torch.bool, device=dev)
        m_kind = zero
        m_words = [zero] * cfg.payload_words
        t_valid = torch.zeros((), dtype=torch.bool, device=dev)
        t_kind = zero
        t_dst = widen(me)
        t_delay = zero
        t_words = [zero] * cfg.payload_words

        for pred, t in gated:
            for snd in t._sends:
                t._check_words(snd.msg, snd.words)
                g = pred & _t(snd.when, dev)
                if snd.dst is not None:
                    mask = arange == torch.clamp(_t(snd.dst, dev), 0, n - 1)
                elif snd.to is not None:
                    mask = _t(snd.to, dev)
                else:
                    mask = arange != me
                m_valid = torch.where(g, mask, m_valid)
                m_kind = torch.where(g, _t(spec.kind_of(snd.msg), dev),
                                     m_kind)
                for i, w in enumerate(snd.words):
                    m_words[i] = torch.where(g, _t(w, dev).to(i32),
                                             m_words[i])
            for a in t._arms:
                t._check_words(a.msg, a.words)
                g = pred & _t(a.when, dev)
                t_valid = t_valid | g
                t_kind = torch.where(g, _t(spec.kind_of(a.msg), dev), t_kind)
                t_dst = torch.where(
                    g, widen(me) if a.dst is None
                    else torch.clamp(_t(a.dst, dev), 0, n - 1).to(i32),
                    t_dst)
                t_delay = torch.where(g, _t(a.delay, dev).to(i32), t_delay)
                for i, w in enumerate(a.words):
                    t_words[i] = torch.where(g, _t(w, dev).to(i32),
                                             t_words[i])
        return (m_valid, m_kind, torch.stack(m_words), t_valid, t_kind,
                t_dst, t_delay, torch.stack(t_words))

    def _outbox(self, cfg: EngineConfig, me, m_valid, m_kind, m_words,
                t_valid, t_kind, t_dst, t_delay, t_words) -> Outbox:
        """The batched (N peers + 1 timer) outbox from the merged fields:
        one kind and one word set for every peer."""
        n = self.spec.n_nodes
        w = m_valid.shape[0]
        return make_outbox(
            cfg, n,
            msg_valid=m_valid,
            msg_kind=m_kind[:, None].expand(w, n),
            msg_payload=m_words[:, None, :].expand(w, n, cfg.payload_words),
            timer_valid=t_valid, timer_kind=t_kind, timer_dst=t_dst,
            timer_delay=t_delay, timer_payload=t_words)


def compile_actor(spec: ActorSpec) -> CompiledActor:
    """Compile ``spec`` to a DeviceEngine actor (docs/actorc.md)."""
    return CompiledActor(spec)
