"""The generated host twin: a plain-Python reference interpreter of an
:class:`~madsim_tpu_torch.actorc.spec.ActorSpec`.

The port's copy of ``madsim_tpu/actorc/host.py``. Same spec, second
backend: where the compiler (:mod:`madsim_tpu_torch.actorc.compile`)
evaluates transition callables on one world's 0-d tensors under
``torch.func.vmap`` and merges writes across kinds, the host interpreter
evaluates exactly ONE transition per event — the active kind's — on numpy
scalars and arrays, applies its guarded writes in call order, and
assembles the same (N peers + 1 timer) outbox layout as host-side numpy
rows. Because the transition *callables are shared*, the twin is a
generated artifact, not a second implementation: any divergence between
the two is a compiler bug, a spec stepping outside the restricted
expression surface, or a saturation boundary firing — precisely the
things the lockstep crosscheck (:mod:`madsim_tpu_torch.actorc.conformance`)
exists to catch.

Entropy is *injected*, not generated: the crosscheck records the
device's raw u32 draws per event and feeds them here, so the twin checks
transition logic, not Threefry (whose parity with the JAX package is
tested on its own).
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from .compile import Ctx
from .spec import (
    ActorSpec,
    KIND_COUNTER,
    SCOPE_NODE,
    SCOPE_NODE_TABLE,
    SCOPE_WORLD,
    SCOPE_WORLD_VEC,
    lane_dtype,
    validate_spec,
)

__all__ = ["HostActor", "HostOutbox"]


class HostOutbox(NamedTuple):
    """Host mirror of the device ``Outbox`` rows ``make_outbox`` builds:
    slots 0..n-1 are the peer messages (dst = slot index), slot n the
    timer. All int32 numpy (wide in flight, like the device)."""

    valid: np.ndarray
    is_timer: np.ndarray
    kind: np.ndarray
    dst: np.ndarray
    delay_us: np.ndarray
    payload: np.ndarray


def _u32_to_range_host(u: int, lo: int, hi: int) -> int:
    """Bit-exact host mirror of ``engine.rng._u32_to_range``: int32
    width, u32 modulo, int32 result."""
    width = (int(hi) - int(lo)) & 0xFFFFFFFF
    r = (int(u) & 0xFFFFFFFF) % width
    if r >= 1 << 31:
        r -= 1 << 32
    return int(lo) + r


class _HostCtx(Ctx):
    """Host backend of the shared :class:`~madsim_tpu_torch.actorc.compile.Ctx`
    surface: values are numpy scalars (int64 reads, so i32-range
    arithmetic never wraps mid-expression), helpers are numpy, and a
    recorded entropy stream stands in for the RNG. Numpy scalars — not
    Python ints — so comparisons yield ``np.bool_`` and the shared
    transition bodies' ``~pred`` / ``&`` / ``|`` keep their elementwise
    meaning on both backends (Python's ``~True`` is ``-2``)."""

    np = np

    def __init__(self, actor: "HostActor", state, me: int, now: int,
                 src: int, msg=None, payload: Sequence[int] = (),
                 entropy: Sequence[int] = ()):
        super().__init__(actor.spec, actor.payload_words,
                         np.int64(int(me)), np.int64(int(now)),
                         np.int64(int(src)), msg)
        self._actor = actor
        self._state = state
        self._payload = [np.int64(int(x)) for x in payload]
        self._entropy = list(entropy)
        self._cursor = 0

    # reads
    def read(self, lane: str):
        return self._state[lane][int(self.me)].astype(np.int64)

    def read_node(self, lane: str, node):
        n = self._spec.n_nodes
        return self._state[lane][min(max(int(node), 0),
                                     n - 1)].astype(np.int64)

    def read_at(self, lane: str, col):
        ln = self._spec.lane(lane)
        return self._state[lane][int(self.me),
                                 min(max(int(col), 0),
                                     ln.cols - 1)].astype(np.int64)

    def read_row(self, lane: str) -> np.ndarray:
        return self._state[lane][int(self.me)].astype(np.int64)

    def read_vec_at(self, lane: str, idx):
        ln = self._spec.lane(lane)
        return self._state[lane][min(max(int(idx), 0),
                                     ln.cols - 1)].astype(np.int64)

    def read_vec(self, lane: str) -> np.ndarray:
        return self._state[lane].astype(np.int64)

    def read_scalar(self, lane: str):
        return np.asarray(self._state[lane]).astype(np.int64)[()]

    # expression helpers (numpy in, numpy out — see class docstring)
    @staticmethod
    def where(c, a, b):
        return np.where(c, a, b)

    @staticmethod
    def maximum(a, b):
        return np.maximum(a, b)

    @staticmethod
    def minimum(a, b):
        return np.minimum(a, b)

    @staticmethod
    def clip(x, lo, hi):
        return np.clip(x, lo, hi)

    @staticmethod
    def popcount(x) -> int:
        return bin(int(x) & 0xFFFFFFFF).count("1")

    @staticmethod
    def arange(k: int) -> np.ndarray:
        return np.arange(k)

    def others(self) -> np.ndarray:
        return np.arange(self._spec.n_nodes) != self.me

    def _payload_word(self, i: int):
        return self._payload[i] if i < len(self._payload) else np.int64(0)

    def _raw_u32(self):
        if self._cursor >= len(self._entropy):
            raise ValueError(
                f"host twin of spec {self._spec.name!r}: transition drew "
                f"more entropy than recorded ({len(self._entropy)} words)")
        x = np.uint32(int(self._entropy[self._cursor]) & 0xFFFFFFFF)
        self._cursor += 1
        return x

    def _uniform(self, lo, hi):
        return np.int64(_u32_to_range_host(self._raw_u32(), lo, hi))


class _HostRestartCtx(_HostCtx):
    def _mark_draw(self) -> None:
        pass  # restart hooks draw unconditionally, like the device side


#: numpy dtype of each torch at-rest lane dtype.
_NP_DTYPES = {torch.int8: np.int8, torch.int16: np.int16,
              torch.int32: np.int32}


class _HostVecReader:
    """Full-lane views of one world's numpy state for ``invariant``
    bodies (the compiler's ``_VecReader`` over numpy): every lane widened
    to int64, vector helpers through ``np``."""

    np = np

    def __init__(self, spec: ActorSpec, state):
        self._spec = spec
        self._state = state

    def lane(self, name: str):
        self._spec.lane(name)
        return np.asarray(self._state[name], np.int64)

    def sel(self, name: str, i):
        """Row ``i`` of a lane, by plain indexing."""
        self._spec.lane(name)
        return np.asarray(self._state[name][int(i)], np.int64)

    def n_nodes(self) -> int:
        return self._spec.n_nodes


class HostActor:
    """Single-world plain-Python interpreter of ``spec``.

    State is a dict of numpy arrays at the *device at-rest dtypes*
    (packed or wide), so the saturating-write boundaries land in the
    same places: a value that would pin at an int16 rail on device pins
    here too, and the crosscheck stays bitwise.
    """

    def __init__(self, spec: ActorSpec, packed: bool = True,
                 payload_words: int = 8):
        from ..engine.lanes import PACKED, WIDE

        validate_spec(spec)
        self.spec = spec
        self.payload_words = payload_words
        profile = PACKED if packed else WIDE
        self._dtypes = {ln.name: np.dtype(_NP_DTYPES[lane_dtype(ln,
                                                                 profile)])
                        for ln in spec.lanes}

    # ------------------------------------------------------------------
    def init_state(self) -> Dict[str, np.ndarray]:
        n = self.spec.n_nodes
        shapes = {SCOPE_NODE: lambda ln: (n,),
                  SCOPE_NODE_TABLE: lambda ln: (n, ln.cols),
                  SCOPE_WORLD_VEC: lambda ln: (ln.cols,),
                  SCOPE_WORLD: lambda ln: ()}
        return {ln.name: np.full(shapes[ln.scope](ln), ln.init,
                                 self._dtypes[ln.name])
                for ln in self.spec.lanes}

    # ------------------------------------------------------------------
    def handle(self, state: Dict[str, np.ndarray], *, kind: int, dst: int,
               payload: Sequence[int], now: int, src: int = 0,
               entropy: Sequence[int] = ()
               ) -> Tuple[Dict[str, np.ndarray], HostOutbox, bool]:
        """Apply ONE delivered event; returns (state', outbox, bug)."""
        spec = self.spec
        n = spec.n_nodes
        kind = min(max(int(kind), 0), len(spec.messages) - 1)
        me = min(max(int(dst), 0), n - 1)
        src = min(max(int(src), 0), n - 1)
        msg = spec.messages[kind]
        fn = spec.handlers.get(msg.name)
        state2 = {k: v.copy() for k, v in state.items()}
        if fn is None:
            return state2, self._outbox([], [], me), False
        t = _HostCtx(self, state2, me, now, src, msg=msg,
                     payload=payload, entropy=entropy)
        fn(t)
        self._apply_writes(state2, t, me)
        bug = any(bool(b) for b in t._bugs)
        return state2, self._outbox(t._sends, t._arms, me, t), bug

    # ------------------------------------------------------------------
    def on_restart(self, state: Dict[str, np.ndarray], node: int, now: int,
                   entropy: Sequence[int] = ()
                   ) -> Tuple[Dict[str, np.ndarray], HostOutbox]:
        spec = self.spec
        node = min(max(int(node), 0), spec.n_nodes - 1)
        state2 = {k: v.copy() for k, v in state.items()}
        for ln in spec.lanes:
            if ln.durable:
                continue
            state2[ln.name][node] = ln.reset  # row or scalar, both index
        if spec.on_restart is None:
            return state2, self._outbox([], [], node)
        t = _HostRestartCtx(self, state2, node, now, node, entropy=entropy)
        spec.on_restart(t)
        self._apply_writes(state2, t, node)
        return state2, self._outbox(t._sends, t._arms, node, t)

    # ------------------------------------------------------------------
    def invariant(self, state: Dict[str, np.ndarray]) -> bool:
        return bool(self.spec.invariant(_HostVecReader(self.spec, state)))

    # ==================================================================
    def _sat(self, lane: str, v):
        dt = self._dtypes[lane]
        info = np.iinfo(dt)
        return np.clip(v, info.min, info.max).astype(dt)

    def _apply_writes(self, state, t: _HostCtx, me: int) -> None:
        for op, lane, idx, v, when in t._writes:
            ln = self.spec.lane(lane)
            if op == "world_vec_full":
                mask = np.broadcast_to(np.asarray(when, bool),
                                       state[lane].shape)
                state[lane] = np.where(mask, self._sat(lane, v),
                                       state[lane]).astype(
                                           self._dtypes[lane])
                continue
            if not bool(when):
                continue
            if ln.scope == SCOPE_NODE:
                state[lane][me] = self._sat(lane, v)
            elif ln.scope == SCOPE_NODE_TABLE:
                c = min(max(int(idx), 0), ln.cols - 1)
                state[lane][me, c] = self._sat(lane, v)
            elif ln.scope == SCOPE_WORLD_VEC:
                i = min(max(int(idx), 0), ln.cols - 1)
                state[lane][i] = self._sat(lane, v)
            elif ln.kind == KIND_COUNTER:
                state[lane] = (state[lane]
                               + np.int32(int(v))).astype(np.int32)
            else:
                state[lane] = np.asarray(self._sat(lane, v))

    def _outbox(self, sends: List, arms: List, me: int,
                t: _HostCtx = None) -> HostOutbox:
        """Host mirror of the compiler's single-``make_outbox`` merge:
        active sends/arms applied in call order (last write wins, the
        same semantics as the device ``where`` chain)."""
        spec = self.spec
        n = spec.n_nodes
        pw = self.payload_words
        valid = np.zeros((n,), bool)
        kindv = 0
        words = [0] * pw
        t_valid, t_kind, t_dst, t_delay = False, 0, me, 0
        t_words = [0] * pw
        for snd in sends:
            t._check_words(snd.msg, snd.words)
            if not bool(snd.when):
                continue
            if snd.dst is not None:
                mask = np.arange(n) == min(max(int(snd.dst), 0), n - 1)
            elif snd.to is not None:
                mask = np.asarray(snd.to, bool)
            else:
                mask = np.arange(n) != me
            valid = mask.copy()
            kindv = spec.kind_of(snd.msg)
            words = [int(w) for w in snd.words] + [0] * (pw - len(snd.words))
        for a in arms:
            t._check_words(a.msg, a.words)
            if not bool(a.when):
                continue
            t_valid = True
            t_kind = spec.kind_of(a.msg)
            t_dst = me if a.dst is None else min(max(int(a.dst), 0), n - 1)
            t_delay = int(a.delay)
            t_words = [int(w) for w in a.words] + [0] * (pw - len(a.words))
        row = np.asarray(words, np.int32)
        return HostOutbox(
            valid=np.concatenate([valid, np.asarray([t_valid])]),
            is_timer=np.concatenate([np.zeros((n,), bool),
                                     np.asarray([True])]),
            kind=np.concatenate([np.full((n,), kindv, np.int32),
                                 np.asarray([t_kind], np.int32)]),
            dst=np.concatenate([np.arange(n, dtype=np.int32),
                                np.asarray([t_dst], np.int32)]),
            delay_us=np.concatenate([np.zeros((n,), np.int32),
                                     np.asarray([t_delay], np.int32)]),
            payload=np.concatenate([np.broadcast_to(row, (n, pw)),
                                    np.asarray([t_words], np.int32)],
                                   axis=0),
        )
