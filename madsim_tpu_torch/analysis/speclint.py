"""speclint — pass 4: a protocol verifier over actorc specs (SPC0xx).

The port's copy of ``madsim_tpu/analysis/speclint.py``, whole: the same
abstract domain, rules, suppression and protocol cards, so a finding and
a card render byte for byte as the JAX package's do. The module polices
the protocol state machine an
:class:`~madsim_tpu_torch.actorc.spec.ActorSpec` declares, BEFORE
:mod:`~madsim_tpu_torch.actorc.compile` lowers it to packed lanes: an
unhandled message kind, a counter that overflows its packed lane, or a
transition leaning on a DSL feature the lowering silently flattens are
all *spec* bugs — no fault schedule needs to find them, and no seed
sweep should have to.

How it works
------------
The compiler's craft is that the SAME transition callable runs under a
torch backend (device, under ``torch.func.vmap``) and a numpy backend
(the host twin, :mod:`~madsim_tpu_torch.actorc.host`). speclint adds a
third backend: :class:`_LintCtx` executes every handler ONCE under an
*interval abstract domain* — reads return the lane's declared ``[lo,
hi]`` range, payload words return their declared word range, and
arithmetic propagates bounds — while recording the transition's writes,
sends, timer arms, RNG draws and lane reads, each tagged with the real
source line of the ctx call (the first frame outside this module and
the compiler's ``compile.py``). The recorded effects feed the rule
families:

- **reachability** (SPC010/SPC012): kinds nobody seeds or emits;
  transitions with no effects at all;
- **exhaustiveness** (SPC011): every declared kind handled or
  explicitly listed in ``ActorSpec.ignore``;
- **timer discipline** (SPC020/SPC021): timers handled but never armed;
  multiple arms in one transition without a static disjointness proof
  (the single-timer-row lowering is last-write-wins);
- **lane-capacity proofs** (SPC030): a written value's static bound
  exceeds the packed at-rest dtype rail chosen by
  :func:`~madsim_tpu_torch.actorc.spec.lane_dtype`;
- **payload-bound proofs** (SPC031): a sent/armed/init word's static
  bound escapes the receiver's declared word range (which is exactly
  what the receiving handler's ``arg()`` read assumes);
- **RNG/effect budgets** (SPC040/SPC041): more than one send per
  transition without disjoint conditions (the single message row
  broadcasts ONE payload — per-destination payloads are a known DSL
  gap), and more than one RNG draw per event;
- **durability flow** (SPC050): a ``durable=False`` lane read by a
  handler in a spec with no ``on_restart`` hook — post-restart reads
  see the reset value with nothing to reconstruct it.

Disjointness is proved, not guessed: every abstract boolean carries the
set of literals it implies (itself, both operands of ``&``, the negated
operand of ``~``); two conditions are disjoint iff one implies a
literal the other implies negated. That is enough to accept the pb
family's watchdog/heartbeat re-arm split and reject everything the
lowering would silently last-write-wins.

Suppression: ``# detlint: allow[SPC...]`` pragmas on the offending
handler line (stale ones are DET900), plus a spec-level ``lint_allow``
tuple for intentionally-buggy variants (the forgetful-acceptor Paxos
config allows SPC050 — the amnesia IS the experiment); a ``lint_allow``
code that suppresses nothing is SPC900. ``("*",)`` waives the whole
pass.

``CompiledActor`` calls :func:`gate_spec` right after ``validate_spec``
— a spec with findings does not lower. The CLI entry (``python -m
madsim_tpu_torch.analysis spec``) lints the shipped families and prints
per-spec *protocol cards* (:func:`protocol_card`): the kinds × handlers
matrix, the timer graph and the lane budget table, rendered byte-stably
so two runs diff clean and repro bundles can carry their protocol's
static profile.
"""
from __future__ import annotations

import itertools
import os
import sys
from typing import Any, Dict, List, Optional, Tuple

from .pragmas import Finding, apply_pragmas, extract_pragmas
from .rules import RULES

__all__ = [
    "lint_spec", "gate_spec", "protocol_card", "run_spec_pass",
    "shipped_specs", "main_spec",
]

# int32 timer-delay / payload rails of the lowering (engine/lanes.py).
_I32 = (1 << 31) - 1

_IDS = itertools.count(1)


def _rail(dtype) -> Tuple[int, int]:
    """Inclusive saturation rails of a packed at-rest (torch) dtype."""
    import torch

    info = torch.iinfo(dtype)
    return int(info.min), int(info.max)


# ---------------------------------------------------------------------------
# The abstract domain
# ---------------------------------------------------------------------------

class _Abs:
    """An integer interval ``[lo, hi]`` (scalars and vectors alike —
    a vector is the interval of its elements)."""

    __slots__ = ("lo", "hi")

    def __init__(self, lo: int, hi: int):
        self.lo, self.hi = int(lo), int(hi)

    def __repr__(self):
        return f"[{self.lo}, {self.hi}]"

    def __bool__(self):
        from ..actorc.spec import SpecError

        raise SpecError(
            "Python control flow on a traced spec value (if/while/and/or "
            "on a ctx read) — use c.where()/when= instead; the compiler "
            "cannot lower a host branch")

    # -- arithmetic ---------------------------------------------------
    def __add__(self, o):
        o = _lift(o)
        return _Abs(self.lo + o.lo, self.hi + o.hi)

    __radd__ = __add__

    def __sub__(self, o):
        o = _lift(o)
        return _Abs(self.lo - o.hi, self.hi - o.lo)

    def __rsub__(self, o):
        return _lift(o).__sub__(self)

    def __mul__(self, o):
        o = _lift(o)
        ps = (self.lo * o.lo, self.lo * o.hi, self.hi * o.lo,
              self.hi * o.hi)
        return _Abs(min(ps), max(ps))

    __rmul__ = __mul__

    def __neg__(self):
        return _Abs(-self.hi, -self.lo)

    def __floordiv__(self, o):
        o = _lift(o)
        if o.lo <= 0:
            return _TOP
        return _Abs(self.lo // o.lo if self.lo < 0 else self.lo // o.hi,
                    self.hi // o.lo if self.hi > 0 else self.hi // o.hi)

    def __mod__(self, o):
        o = _lift(o)
        if o.lo <= 0:
            return _TOP
        # Python/device semantics: result in [0, divisor-1] for a
        # positive divisor, regardless of the dividend's sign.
        return _Abs(0, o.hi - 1)

    def __rmod__(self, o):
        return _lift(o).__mod__(self)

    def __rfloordiv__(self, o):
        return _lift(o).__floordiv__(self)

    # -- bitwise (non-negative operands; mixed signs widen) -----------
    def _bits_join(self, o):
        if self.lo < 0 or o.lo < 0:
            return _TOP
        hi = max(self.hi, o.hi)
        return _Abs(0, (1 << hi.bit_length()) - 1)

    def __or__(self, o):
        return self._bits_join(_lift(o))

    __ror__ = __or__
    __xor__ = __or__
    __rxor__ = __or__

    def __and__(self, o):
        o = _lift(o)
        if self.lo < 0 or o.lo < 0:
            return _TOP
        return _Abs(0, min(self.hi, o.hi))

    __rand__ = __and__

    def __invert__(self):
        return _Abs(-self.hi - 1, -self.lo - 1)

    def __lshift__(self, o):
        o = _lift(o)
        if self.lo < 0 or o.lo < 0 or o.hi > 63:
            return _TOP
        return _Abs(self.lo << o.lo, self.hi << o.hi)

    def __rlshift__(self, o):
        return _lift(o).__lshift__(self)

    def __rshift__(self, o):
        o = _lift(o)
        if self.lo < 0 or o.lo < 0 or o.hi > 63:
            return _TOP
        return _Abs(self.lo >> o.hi, self.hi >> o.lo)

    def __rrshift__(self, o):
        return _lift(o).__rshift__(self)

    # -- comparisons: fresh condition literals ------------------------
    def _cmp(self, _o):
        return _Cond()

    __lt__ = __le__ = __gt__ = __ge__ = __eq__ = __ne__ = _cmp
    __hash__ = None


_TOP = _Abs(-(1 << 31), (1 << 31) - 1)


def _lift(v) -> _Abs:
    if isinstance(v, _Abs):
        return v
    if isinstance(v, _Cond):
        return _Abs(0, 1)
    if isinstance(v, bool):
        return _Abs(int(v), int(v))
    if isinstance(v, int):
        return _Abs(v, v)
    from ..actorc.spec import SpecError

    raise SpecError(f"value {v!r} is outside the spec expression surface "
                    "(ints and ctx values only)")


class _Cond:
    """An abstract boolean, carrying the set of literals it *implies*:
    itself, both conjuncts of ``&``, the negated operand of ``~`` — the
    minimal machinery needed to PROVE two emission conditions disjoint
    (one implies a literal the other implies negated)."""

    __slots__ = ("id", "lits", "false")

    def __init__(self, lits=(), false: bool = False):
        self.id = next(_IDS)
        self.false = false
        self.lits = frozenset(lits) | {(self.id, True)}

    def __bool__(self):
        from ..actorc.spec import SpecError

        raise SpecError(
            "Python control flow on a traced spec condition — use "
            "c.where()/when= instead; the compiler cannot lower a host "
            "branch")

    def __and__(self, o):
        if o is True:
            return self
        if o is False:
            return _Cond(false=True)
        if isinstance(o, _Abs):
            return _Cond(self.lits)
        return _Cond(self.lits | o.lits, false=self.false or o.false)

    __rand__ = __and__

    def __or__(self, o):
        if o is True or isinstance(o, _Abs):
            return _Cond()
        if o is False:
            return _Cond(self.lits, false=self.false)
        return _Cond(self.lits & o.lits, false=self.false and o.false)

    __ror__ = __or__

    def __xor__(self, o):
        return _Cond()

    __rxor__ = __xor__

    def __invert__(self):
        return _Cond({(self.id, False)})

    def _cmp(self, _o):
        return _Cond()

    __lt__ = __le__ = __gt__ = __ge__ = __eq__ = __ne__ = _cmp
    __hash__ = None


def _disjoint(a, b) -> bool:
    """True iff conditions ``a`` and ``b`` provably never hold together."""
    if a is False or b is False:
        return True
    if a is True or b is True or not isinstance(a, _Cond) \
            or not isinstance(b, _Cond):
        return False
    if a.false or b.false:
        return True
    neg_b = {(i, not p) for i, p in b.lits}
    return bool(a.lits & neg_b)


# ---------------------------------------------------------------------------
# The lint backend (third Ctx implementation: abstract evaluation)
# ---------------------------------------------------------------------------

def _callsite() -> Tuple[str, int]:
    """(filename, line) of the spec code that invoked the ctx method:
    the first frame outside this module and the compiler."""
    f = sys._getframe(1)
    skip = (os.path.abspath(__file__),)
    while f is not None:
        fn = os.path.abspath(f.f_code.co_filename)
        if fn not in skip and not fn.endswith(os.sep + "compile.py"):
            return f.f_code.co_filename, f.f_lineno
        f = f.f_back
    return "<spec>", 0


class _LintNp:
    """Placeholder ``c.np`` backend tag: identical to neither the
    device's nor numpy, so backend-branching handlers take a
    deterministic arm."""


def _make_lint_ctx(spec, me_hi: int, msg=None):
    from ..actorc.compile import Ctx
    from ..actorc.spec import SCOPE_NODE, SCOPE_NODE_TABLE, SCOPE_WORLD, \
        SCOPE_WORLD_VEC, SpecError

    class _LintCtx(Ctx):
        np = _LintNp()

        def __init__(self):
            n = spec.n_nodes
            super().__init__(spec, 8, me=_Abs(0, me_hi), now=_Abs(0, _I32),
                             src=_Abs(0, n - 1), msg=msg)
            self._draws = 0
            self._reads: Dict[str, Tuple[str, int]] = {}
            self._sites: Dict[int, Tuple[str, int]] = {}

        # -- reads: the declared range IS the abstraction --------------
        def _read(self, lane: str, scope: str) -> _Abs:
            ln = self._spec.lane(lane)
            if ln.scope != scope:
                raise SpecError(
                    f"spec {self._spec.name!r}: lane {lane!r} has scope "
                    f"{ln.scope!r}; this read form needs {scope!r}")
            self._reads.setdefault(ln.name, _callsite())
            return _Abs(ln.lo, ln.hi)

        def read(self, lane):
            return self._read(lane, SCOPE_NODE)

        def read_node(self, lane, node):
            return self._read(lane, SCOPE_NODE)

        def read_at(self, lane, col):
            return self._read(lane, SCOPE_NODE_TABLE)

        def read_row(self, lane):
            return self._read(lane, SCOPE_NODE_TABLE)

        def read_vec_at(self, lane, idx):
            return self._read(lane, SCOPE_WORLD_VEC)

        def read_vec(self, lane):
            return self._read(lane, SCOPE_WORLD_VEC)

        def read_scalar(self, lane):
            return self._read(lane, SCOPE_WORLD)

        # -- expression helpers ----------------------------------------
        @staticmethod
        def where(c, a, b):
            if isinstance(a, _Cond) or isinstance(b, _Cond):
                return _Cond()
            a, b = _lift(a), _lift(b)
            return _Abs(min(a.lo, b.lo), max(a.hi, b.hi))

        @staticmethod
        def maximum(a, b):
            a, b = _lift(a), _lift(b)
            return _Abs(max(a.lo, b.lo), max(a.hi, b.hi))

        @staticmethod
        def minimum(a, b):
            a, b = _lift(a), _lift(b)
            return _Abs(min(a.lo, b.lo), min(a.hi, b.hi))

        @staticmethod
        def clip(x, lo, hi):
            x, lo, hi = _lift(x), _lift(lo), _lift(hi)
            return _Abs(min(max(x.lo, lo.lo), hi.hi),
                        min(max(x.hi, lo.lo), hi.hi))

        @staticmethod
        def popcount(_x):
            return _Abs(0, 32)

        @staticmethod
        def arange(k: int):
            return _Abs(0, max(int(k) - 1, 0))

        def others(self):
            return _Cond()

        # -- effect recording (call sites remembered per record) -------
        def _record(self, op, lane, idx, value, when):
            super()._record(op, lane, idx, value, when)
            self._sites[len(self._writes) - 1] = _callsite()

        def send(self, msg_name, dst, words=(), when=True):
            super().send(msg_name, dst, words, when)
            self._check_words(msg_name, tuple(words))
            self._sites[-len(self._sends)] = _callsite()

        def broadcast(self, msg_name, words=(), when=True, to=None):
            super().broadcast(msg_name, words, when, to)
            self._check_words(msg_name, tuple(words))
            self._sites[-len(self._sends)] = _callsite()

        def arm(self, timer, delay, words=(), when=True, dst=None):
            super().arm(timer, delay, words, when, dst)
            self._check_words(timer, tuple(words))
            self._sites[1_000_000 + len(self._arms)] = _callsite()

        # -- payload words / RNG ---------------------------------------
        def _payload_word(self, i: int):
            wd = self._msg.words[i]
            return _Abs(wd.lo, wd.hi)

        def _mark_draw(self):
            self._draws += 1
            self._sites[2_000_000 + self._draws] = _callsite()

        def _raw_u32(self):
            return _Abs(0, (1 << 32) - 1)

        def _uniform(self, lo, hi):
            return _Abs(int(lo), int(hi) - 1)  # engine parity: [lo, hi)

    return _LintCtx()


class _LintInitCtx:
    """Abstract ``init`` backend: records the world's seed events."""

    np = _LintNp()

    def __init__(self, spec):
        self._spec = spec
        self.events: List[Tuple[str, Tuple[Any, ...], Tuple[str, int]]] = []

    def event(self, msg: str, time, dst=0, src=None, words=()):
        from ..actorc.spec import SpecError

        m = self._spec.message(msg)
        if len(words) != len(m.words):
            raise SpecError(
                f"spec {self._spec.name!r}: init event {msg!r} needs "
                f"{len(m.words)} words ({[w.name for w in m.words]}); "
                f"got {len(words)}")
        self.events.append((msg, tuple(words), _callsite()))

    def uniform(self, lo: int, hi: int):
        return _Abs(int(lo), int(hi) - 1)

    def u32(self):
        return _Abs(0, (1 << 32) - 1)


# ---------------------------------------------------------------------------
# The pass
# ---------------------------------------------------------------------------

def _f(path: str, line: int, rule: str, msg: str) -> Finding:
    r = RULES[rule]
    return Finding(path, line, rule, f"{r.title}: {msg} — {r.suggestion}")


def _src(fn) -> Tuple[str, int]:
    code = getattr(fn, "__code__", None)
    if code is None:  # functools.partial / callables: best effort
        return "<spec>", 0
    return code.co_filename, code.co_firstlineno


def _word_bound_findings(spec, msg_name: str, words, site,
                         where: str) -> List[Finding]:
    """SPC031: each sent/armed/seeded word's interval must stay inside
    the declared word range — the receiving ``arg()`` read assumes it."""
    out = []
    m = spec.message(msg_name)
    for wd, val in zip(m.words, words):
        try:
            v = _lift(val)
        except Exception:
            continue
        if v.lo < wd.lo or v.hi > wd.hi:
            out.append(_f(site[0], site[1], "SPC031",
                          f"spec {spec.name!r}: {where} sends "
                          f"{msg_name!r} word {wd.name!r} with static "
                          f"bound [{v.lo}, {v.hi}], outside its declared "
                          f"range [{wd.lo}, {wd.hi}]"))
    return out


def _capacity_findings(spec, ctx, who: str) -> List[Finding]:
    """SPC030 over one transition's recorded writes: value interval vs
    the packed at-rest rail of the target lane's dtype."""
    from ..actorc.spec import lane_dtype
    from ..engine.lanes import PACKED

    out = []
    for i, (op, lane, _idx, value, _when) in enumerate(ctx._writes):
        ln = spec.lane(lane)
        lo, hi = _rail(lane_dtype(ln, PACKED))
        try:
            v = _lift(value)
        except Exception:
            continue
        if v.lo < lo or v.hi > hi:
            site = ctx._sites.get(i, ("<spec>", 0))
            out.append(_f(site[0], site[1], "SPC030",
                          f"spec {spec.name!r}: {who} writes lane "
                          f"{ln.name!r} with static bound "
                          f"[{v.lo}, {v.hi}], past the packed "
                          f"{'int8' if hi == 127 else 'int16' if hi == 32767 else 'int32'} "
                          f"rail [{lo}, {hi}] its declared range "
                          f"[{ln.lo}, {ln.hi}] selected"))
    for j, a in enumerate(ctx._arms, start=1):
        try:
            d = _lift(a.delay)
        except Exception:
            continue
        if d.lo < 0 or d.hi > _I32:
            site = ctx._sites.get(1_000_000 + j, ("<spec>", 0))
            out.append(_f(site[0], site[1], "SPC030",
                          f"spec {spec.name!r}: {who} arms {a.msg!r} "
                          f"with delay bound [{d.lo}, {d.hi}], outside "
                          f"the int32 timer-delay lane [0, {_I32}]"))
    return out


def _emission_findings(spec, ctx, who: str) -> List[Finding]:
    """SPC040/SPC021: >1 send (or arm) in one transition needs a static
    disjointness proof — the lowering has ONE message row and ONE timer
    row per step (last-write-wins ``where`` chains), and the message
    row broadcasts ONE payload to every destination."""
    out = []
    for kind, items, rule, gap in (
            ("send", ctx._sends, "SPC040",
             "the single merged message row broadcasts one payload — "
             "per-destination payloads and concurrent sends are a known "
             "DSL gap (docs/actorc.md)"),
            ("arm", ctx._arms, "SPC021",
             "the single merged timer row is last-write-wins — "
             "multi-timer arms are a known DSL gap (docs/actorc.md)")):
        for a in range(len(items)):
            for b in range(a + 1, len(items)):
                if _disjoint(items[a].when, items[b].when):
                    continue
                key = -(b + 1) if kind == "send" else 1_000_000 + b + 1
                site = ctx._sites.get(key, ("<spec>", 0))
                out.append(_f(site[0], site[1], rule,
                              f"spec {spec.name!r}: {who} {kind}s both "
                              f"{items[a].msg!r} and {items[b].msg!r} "
                              f"without provably-disjoint conditions; "
                              f"{gap}"))
    return out


def lint_spec(spec, root: Optional[str] = None) -> List[Finding]:
    """Run every SPC rule over ``spec``; returns pragma-filtered,
    allowance-filtered findings (the library entry — the compile gate,
    the CLI and the tests are shells over this).

    ``root``: paths in findings are rendered relative to it (default:
    cwd), matching the pass-1 convention.
    """
    from ..actorc.spec import SpecError, validate_spec

    root = os.path.abspath(root or os.getcwd())

    def rel(path: str) -> str:
        ap = os.path.abspath(path)
        if ap.startswith(root + os.sep):
            return os.path.relpath(ap, root).replace(os.sep, "/")
        return path.replace(os.sep, "/")

    findings: List[Finding] = []
    try:
        validate_spec(spec)
    except SpecError as exc:
        path, line = _src(spec.init)
        return [_f(rel(path), line, "SPC001", str(exc))]

    names = [m.name for m in spec.messages]
    spec_path, spec_line = _src(spec.init)
    ignore = tuple(getattr(spec, "ignore", ()))
    terminal = tuple(getattr(spec, "terminal", ()))
    for field, vals in (("ignore", ignore), ("terminal", terminal)):
        for nm in vals:
            if nm not in names:
                findings.append(_f(rel(spec_path), spec_line, "SPC013",
                                   f"spec {spec.name!r}: {field}=(...) "
                                   f"names unknown message {nm!r} "
                                   f"(declared: {names})"))

    # -- abstract init: the seed kinds --------------------------------
    seeded: Dict[str, Tuple[str, int]] = {}
    ictx = _LintInitCtx(spec)
    try:
        spec.init(ictx)
    except SpecError as exc:
        findings.append(_f(rel(spec_path), spec_line, "SPC001", str(exc)))
    except Exception as exc:  # abstract-eval escape: still pointed
        findings.append(_f(rel(spec_path), spec_line, "SPC001",
                           f"spec {spec.name!r}: init raised "
                           f"{type(exc).__name__} under abstract "
                           f"evaluation: {exc}"))
    for msg_name, words, site in ictx.events:
        seeded.setdefault(msg_name, site)
        for ff in _word_bound_findings(spec, msg_name, words, site,
                                       "init"):
            findings.append(ff._replace(path=rel(ff.path)))

    # -- abstract handlers ---------------------------------------------
    ctxs: Dict[str, Any] = {}
    for m in spec.messages:
        fn = spec.handlers.get(m.name)
        if fn is None:
            continue
        ctx = _make_lint_ctx(spec, spec.n_nodes - 1, msg=m)
        hpath, hline = _src(fn)
        try:
            fn(ctx)
        except SpecError as exc:
            findings.append(_f(rel(hpath), hline, "SPC001", str(exc)))
            continue
        except Exception as exc:
            findings.append(_f(rel(hpath), hline, "SPC001",
                               f"spec {spec.name!r}: handler for "
                               f"{m.name!r} raised {type(exc).__name__} "
                               f"under abstract evaluation: {exc}"))
            continue
        ctxs[m.name] = ctx

    rctx = None
    if spec.on_restart is not None:
        rctx = _make_lint_ctx(spec, spec.n_nodes - 1)
        rpath, rline = _src(spec.on_restart)
        try:
            spec.on_restart(rctx)
        except SpecError as exc:
            findings.append(_f(rel(rpath), rline, "SPC001", str(exc)))
            rctx = None
        except Exception as exc:
            findings.append(_f(rel(rpath), rline, "SPC001",
                               f"spec {spec.name!r}: on_restart raised "
                               f"{type(exc).__name__} under abstract "
                               f"evaluation: {exc}"))
            rctx = None

    # -- per-transition rules ------------------------------------------
    for m in spec.messages:
        ctx = ctxs.get(m.name)
        if ctx is None:
            continue
        hpath, hline = _src(spec.handlers[m.name])
        who = f"the {m.name!r} transition"
        for ff in _capacity_findings(spec, ctx, who) \
                + _emission_findings(spec, ctx, who):
            findings.append(ff._replace(path=rel(ff.path)))
        for k, snd in enumerate(ctx._sends):
            site = ctx._sites.get(-(k + 1), (hpath, hline))
            for ff in _word_bound_findings(spec, snd.msg, snd.words,
                                           site, who):
                findings.append(ff._replace(path=rel(ff.path)))
        for j, a in enumerate(ctx._arms, start=1):
            site = ctx._sites.get(1_000_000 + j, (hpath, hline))
            for ff in _word_bound_findings(spec, a.msg, a.words,
                                           site, who):
                findings.append(ff._replace(path=rel(ff.path)))
        if ctx._draws > 1:
            site = ctx._sites.get(2_000_000 + 2, (hpath, hline))
            findings.append(_f(
                rel(site[0]), site[1], "SPC041",
                f"spec {spec.name!r}: {who} draws {ctx._draws} times, "
                "but a transition may draw at most once per event (the "
                "static-draw-shape rule, docs/ACTORS.md); combine draws "
                "into one mapped value"))
        empty = not (ctx._writes or ctx._sends or ctx._arms
                     or ctx._bugs or ctx._draws)
        if empty and m.name not in terminal and m.name not in ignore:
            findings.append(_f(
                rel(hpath), hline, "SPC012",
                f"spec {spec.name!r}: the handler for {m.name!r} has no "
                "effects at all (no writes, sends, arms, bug flags or "
                "draws) — a dead transition; delete it, implement it, "
                "or declare the kind in terminal=(...)"))
        if m.name in terminal and (ctx._sends or ctx._arms):
            findings.append(_f(
                rel(hpath), hline, "SPC013",
                f"spec {spec.name!r}: {m.name!r} is declared terminal "
                "but its handler emits messages/timers — drop it from "
                "terminal=(...) or stop emitting"))

    if rctx is not None:
        rpath, rline = _src(spec.on_restart)
        who = "the on_restart hook"
        for ff in _capacity_findings(spec, rctx, who) \
                + _emission_findings(spec, rctx, who):
            findings.append(ff._replace(path=rel(ff.path)))
        for snd in rctx._sends:
            for ff in _word_bound_findings(spec, snd.msg, snd.words,
                                           (rpath, rline), who):
                findings.append(ff._replace(path=rel(ff.path)))
        for a in rctx._arms:
            for ff in _word_bound_findings(spec, a.msg, a.words,
                                           (rpath, rline), who):
                findings.append(ff._replace(path=rel(ff.path)))

    # -- exhaustiveness / reachability / timers ------------------------
    armed: Dict[str, str] = {}     # timer kind -> first armer
    for src_name, ctx in list(ctxs.items()) + \
            ([("on_restart", rctx)] if rctx is not None else []):
        for a in ctx._arms:
            armed.setdefault(a.msg, src_name)

    for m in spec.messages:
        handled = m.name in spec.handlers
        if not handled and m.name not in ignore:
            findings.append(_f(
                rel(spec_path), spec_line, "SPC011",
                f"spec {spec.name!r}: message {m.name!r} has no handler "
                "and is not listed in ignore=(...) — a delivered "
                f"{m.name!r} would be silently dropped (how real "
                "protocol bugs hide)"))
        if handled and m.name in ignore:
            findings.append(_f(
                rel(spec_path), spec_line, "SPC013",
                f"spec {spec.name!r}: {m.name!r} is both handled and "
                "listed in ignore=(...) — pick one"))

    # BFS over the kind graph from the seed events (+ restart arms).
    edges: Dict[str, List[str]] = {}
    for src_name, ctx in ctxs.items():
        outs = sorted({s.msg for s in ctx._sends}
                      | {a.msg for a in ctx._arms})
        edges[src_name] = outs
    roots = sorted(seeded)
    if rctx is not None:
        roots += sorted({s.msg for s in rctx._sends}
                        | {a.msg for a in rctx._arms})
    reach = set()
    frontier = [r for r in roots if r not in reach]
    while frontier:
        k = frontier.pop()
        if k in reach:
            continue
        reach.add(k)
        frontier.extend(edges.get(k, ()))
    for m in spec.messages:
        if m.name in reach or m.name in ignore:
            continue
        findings.append(_f(
            rel(spec_path), spec_line, "SPC010",
            f"spec {spec.name!r}: message {m.name!r} is unreachable — "
            "no init event seeds it and no reachable transition emits "
            "it; its handler is dead protocol"))
        # A timer is reachable only via arm()/init seeding (send to a
        # timer kind is a SpecError), so an unreachable handled timer
        # gets the sharper diagnosis too: the firing path is dead.
        if m.timer and m.name in spec.handlers and m.name not in armed \
                and m.name not in seeded:
            findings.append(_f(
                rel(spec_path), spec_line, "SPC020",
                f"spec {spec.name!r}: timer {m.name!r} is handled but "
                "never armed (no transition, on_restart hook or init "
                "event arms it) — the firing path is dead"))

    # -- durability flow -----------------------------------------------
    if spec.on_restart is None:
        volatile = {ln.name for ln in spec.lanes if not ln.durable}
        for m in spec.messages:
            ctx = ctxs.get(m.name)
            if ctx is None:
                continue
            for lane, site in sorted(ctx._reads.items()):
                if lane not in volatile:
                    continue
                findings.append(_f(
                    rel(site[0]), site[1], "SPC050",
                    f"spec {spec.name!r}: lane {lane!r} is volatile "
                    f"(durable=False) and read by the {m.name!r} "
                    "transition, but the spec has no on_restart hook — "
                    "a post-restart read sees the reset value with "
                    "nothing to reconstruct it (the classic "
                    "stable-storage violation)"))

    findings.sort(key=lambda f: (f.path, f.line, f.rule, f.message))

    # -- suppression: source pragmas, then the spec-level allowance ----
    sources = {rel(p) for fn in list(spec.handlers.values())
               + [spec.init, spec.on_restart] if fn is not None
               for p in [_src(fn)[0]] if p != "<spec>"}
    out: List[Finding] = []
    by_path: Dict[str, List[Finding]] = {}
    for ff in findings:
        by_path.setdefault(ff.path, []).append(ff)
    for path in sorted(sources | set(by_path)):
        ap = os.path.join(root, path) if not os.path.isabs(path) else path
        try:
            with open(ap, encoding="utf-8") as fh:
                pragmas = extract_pragmas(fh.read())
        except OSError:
            pragmas = {}
        out.extend(apply_pragmas(by_path.get(path, []), pragmas, path,
                                 owned_prefixes=("SPC",)))

    allow = tuple(getattr(spec, "lint_allow", ()))
    if "*" in allow:  # the fixture escape hatch: waive the whole pass
        return []
    kept, used = [], {c: False for c in allow}
    for ff in out:
        if ff.rule in used:
            used[ff.rule] = True
            continue
        kept.append(ff)
    for code in sorted(c for c, u in used.items() if not u):
        kept.append(_f(rel(spec_path), spec_line, "SPC900",
                       f"spec {spec.name!r}: lint_allow names {code} "
                       "but the pass found nothing to suppress"))
    kept.sort(key=lambda f: (f.path, f.line, f.rule, f.message))
    return kept


def gate_spec(spec) -> None:
    """The compile gate: raise :class:`SpecError` when ``spec`` has any
    speclint finding. ``CompiledActor`` calls this right after
    ``validate_spec`` — a spec with findings does not lower (escape
    hatch: ``lint_allow`` on the spec, per code or ``("*",)``)."""
    findings = lint_spec(spec)
    if not findings:
        return
    from ..actorc.spec import SpecError

    lines = "\n".join(f"  {f.render()}" for f in findings)
    raise SpecError(
        f"spec {spec.name!r} fails speclint (pass 4) with "
        f"{len(findings)} finding{'s' if len(findings) != 1 else ''} — "
        "fix the spec, suppress a deliberate site with `# detlint: "
        "allow[SPC...]`, or allow the code spec-wide via "
        f"lint_allow=(...):\n{lines}")


# ---------------------------------------------------------------------------
# Protocol cards
# ---------------------------------------------------------------------------

def protocol_card(spec) -> str:
    """A byte-stable static profile of ``spec``: the kinds × handlers
    matrix, the timer graph and the lane budget table. Printed by
    ``python -m madsim_tpu_torch.analysis spec --card`` and attached to triage repro bundles so a minimized
    bug carries its protocol's shape."""
    from ..actorc.spec import lane_dtype
    from ..engine.lanes import PACKED

    ignore = set(getattr(spec, "ignore", ()))
    terminal = set(getattr(spec, "terminal", ()))

    ictx = _LintInitCtx(spec)
    try:
        spec.init(ictx)
    except Exception:
        pass
    seeded = sorted({m for m, _w, _s in ictx.events})

    ctxs: Dict[str, Any] = {}
    write_bounds: Dict[str, Tuple[int, int]] = {}
    runs = [(m.name, spec.handlers[m.name], m)
            for m in spec.messages if m.name in spec.handlers]
    if spec.on_restart is not None:
        runs.append(("on_restart", spec.on_restart, None))
    for name, fn, m in runs:
        ctx = _make_lint_ctx(spec, spec.n_nodes - 1, msg=m)
        try:
            fn(ctx)
        except Exception:
            continue
        ctxs[name] = ctx
        for _op, lane, _idx, value, _when in ctx._writes:
            try:
                v = _lift(value)
            except Exception:
                continue
            lo, hi = write_bounds.get(lane, (v.lo, v.hi))
            write_bounds[lane] = (min(lo, v.lo), max(hi, v.hi))

    lines = [f"protocol card: {spec.name} "
             f"(n_nodes={spec.n_nodes}, {len(spec.messages)} kinds, "
             f"{len(spec.lanes)} lanes)", ""]

    lines.append("kinds x handlers")
    lines.append(f"  {'kind':<12} {'role':<9} {'status':<9} "
                 f"{'emits':<28} draws")
    for m in spec.messages:
        role = "timer" if m.timer else "message"
        if m.name in ignore:
            status = "ignored"
        elif m.name in terminal:
            status = "terminal"
        elif m.name in spec.handlers:
            status = "handled"
        else:
            status = "UNHANDLED"
        ctx = ctxs.get(m.name)
        emits = "-"
        draws = 0
        if ctx is not None:
            outs = sorted({s.msg for s in ctx._sends}
                          | {a.msg for a in ctx._arms})
            emits = ",".join(outs) if outs else "-"
            draws = ctx._draws
        lines.append(f"  {m.name:<12} {role:<9} {status:<9} "
                     f"{emits:<28} {draws}")

    lines += ["", "timer graph"]
    any_timer = False
    for m in spec.messages:
        if not m.timer:
            continue
        any_timer = True
        armers = sorted(name for name, ctx in ctxs.items()
                        if any(a.msg == m.name for a in ctx._arms))
        seed = "yes" if m.name in seeded else "no"
        lines.append(f"  {m.name}: armed by "
                     f"{','.join(armers) if armers else '-'}; "
                     f"init-seeded: {seed}")
    if not any_timer:
        lines.append("  (no timers)")

    lines += ["", "lane budgets"]
    lines.append(f"  {'lane':<14} {'scope':<11} {'kind':<8} "
                 f"{'declared':<16} {'dtype':<6} {'durable':<8} "
                 "max-write")
    import torch

    for ln in spec.lanes:
        dt = {8: "i8", 16: "i16", 32: "i32"}[
            torch.iinfo(lane_dtype(ln, PACKED)).bits]
        wb = write_bounds.get(ln.name)
        wtxt = f"[{wb[0]}, {wb[1]}]" if wb else "-"
        declared = f"[{ln.lo}, {ln.hi}]"
        lines.append(f"  {ln.name:<14} {ln.scope:<11} {ln.kind:<8} "
                     f"{declared:<16} {dt:<6} "
                     f"{str(ln.durable).lower():<8} {wtxt}")

    lines += ["", f"init seeds: {', '.join(seeded) if seeded else '-'}"]
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# The shipped families + CLI entry
# ---------------------------------------------------------------------------

def shipped_specs() -> Dict[str, Any]:
    """Name -> spec for every shipped actorc family (clean configs) —
    the surface the pass keeps clean."""
    from ..actorc.families.paxos import PaxosConfig, paxos_spec
    from ..actorc.families.pb import pb_spec
    from ..actorc.families.tpc import tpc_spec
    from ..engine.pb_actor import PBDeviceConfig
    from ..engine.tpc_actor import TPCDeviceConfig

    return {
        "paxos": paxos_spec(PaxosConfig()),
        "pb": pb_spec(PBDeviceConfig()),
        "tpc": tpc_spec(TPCDeviceConfig()),
    }


def run_spec_pass(root: Optional[str] = None,
                  specs: Optional[Dict[str, Any]] = None) -> List[Finding]:
    """Pass 4 over a set of specs (default: the shipped families)."""
    specs = shipped_specs() if specs is None else specs
    findings: List[Finding] = []
    for _name in sorted(specs):
        findings.extend(lint_spec(specs[_name], root=root))
    return findings


def main_spec(argv: Optional[List[str]] = None) -> int:
    import argparse

    from .cli import _add_format_args, _fmt, render_findings

    ap = argparse.ArgumentParser(
        prog="detlint spec",
        description="speclint: pass 4 — protocol-level static "
                    "verification of actorc specs (reachability, "
                    "exhaustiveness, timer discipline, lane-capacity "
                    "proofs, RNG/effect budgets, durability flow)")
    ap.add_argument("--families", default=None,
                    help="comma-separated subset of the shipped "
                         "families (default: all)")
    ap.add_argument("--card", default=None, metavar="FAMILY",
                    help="print FAMILY's protocol card and exit")
    ap.add_argument("--list-families", action="store_true")
    _add_format_args(ap)
    args = ap.parse_args(argv)

    specs = shipped_specs()
    if args.list_families:
        for name in sorted(specs):
            print(name)
        return 0
    if args.card is not None:
        if args.card not in specs:
            print(f"speclint: unknown family {args.card!r} "
                  f"(shipped: {sorted(specs)})", file=sys.stderr)
            return 2
        sys.stdout.write(protocol_card(specs[args.card]))
        return 0
    if args.families:
        sel = [f.strip() for f in args.families.split(",") if f.strip()]
        unknown = [f for f in sel if f not in specs]
        if unknown:
            print(f"speclint: unknown families {unknown} "
                  f"(shipped: {sorted(specs)})", file=sys.stderr)
            return 2
        specs = {k: specs[k] for k in sel}

    findings = run_spec_pass(specs=specs)
    render_findings(findings, _fmt(args), label="speclint")
    return 1 if findings else 0
