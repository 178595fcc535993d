"""The device decision kernel of the host↔device bridge.

The PyTorch counterpart of ``madsim_tpu/bridge/kernel.py``. One lockstep
round advances W independent simulation worlds at once: it writes the
timers, cancels and sends the host recorded while it ran task bodies into
per-world timer lanes, draws every send's loss and latency from the
world's NET Threefry stream by *counter* (the bits the host engine's own
``Network.test_link`` would draw), advances each world's clock to its next
event, and pops the due events in the ``(deadline, seq)`` order of the
host timer wheel. A drain round pops more due events without any of the
rest.

On CUDA, :class:`BridgeKernel` runs a round as one launch of the
hand-written kernel ``csrc/bridge_step.cu`` (wrapper
:mod:`madsim_tpu_torch.bridge.cuda`), and a drain as one launch of its
twin. On the CPU it runs the plain versions here, :func:`step_plain` and
:func:`drain_plain`, torch ops that compute exactly what JAX's ``_step``
and ``_drain_step`` compute, bit for bit. The drivers that run user task
bodies (JAX's ``bridge/runtime.py`` and ``bridge/pool.py``) belong to the
host runtime and stay outside the port; they call this class through
JAX's signatures.

State layout (leading W axis; every lane int64):

- ``clock``    i64[W]        virtual ns
- ``lane_dl``  i64[W, CAP+1] timer deadlines (INF_NS = empty; the last
                             column is the plain version's scatter dump,
                             whose content is unspecified, as in JAX)
- ``lane_seq`` i64[W, CAP+1] creation order, the pop's tie-breaker

The u64 quantities (the NET counters ``s_ctr`` and loss thresholds
``s_thr``) ride int64 by bit view. ``torch.uint64`` has no comparison,
remainder, addition or shift on the CPU, so the plain version works in
32-bit limbs held in int64, and every sum that XLA wraps is wrapped here
without an int64 overflow (:func:`_add_wrap`).
"""
from __future__ import annotations

import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops.threefry import derive_stream_np, seed_to_key, threefry2x32_i64

#: Empty-lane sentinel: i64 max, far above any reachable clock (JAX's
#: ``INF_NS``).
INF_NS = (1 << 63) - 1
#: The clock's step past the earliest deadline (the host wheel's
#: ``ADVANCE_EPSILON_NS``).
_EPSILON_NS = 50
#: The host timer wheel's horizon (``madsim_tpu/core/timewheel.py``).
TIMER_MAX_NS = (1 << 62) - 1
#: The network's Threefry stream id (``madsim_tpu/core/rng.py``).
STREAM_NET = 3

_M32 = 0xFFFFFFFF
_TWO32 = 1 << 32


class BridgeState(NamedTuple):
    clock: torch.Tensor     # i64[W]
    lane_dl: torch.Tensor   # i64[W, CAP+1]
    lane_seq: torch.Tensor  # i64[W, CAP+1]


class BridgeMetrics(NamedTuple):
    """Per-slot observability counters, i64[W] each, accumulated inside
    the round (JAX's ``BridgeMetrics``): cumulative across recycled seeds
    (``reset_slot`` leaves them running) and write-only, so a metrics-on
    round's outputs are bit-identical to a metrics-off one's."""

    timers_set: torch.Tensor
    cancels: torch.Tensor
    msgs_sent: torch.Tensor
    msgs_lost: torch.Tensor
    events_fired: torch.Tensor
    vtime_ns: torch.Tensor


class StepOut(NamedTuple):
    clock: object        # i64[W] — after advance
    deadlock: object     # bool[W] — advance requested but no timers pending
    send_ok: object      # bool[W, S] — send passed the loss draw
    event_slot: object   # i32[W, K] — popped lane slots (host frees them)
    event_seq: object    # i64[W, K] — popped seqs (host dispatch key)
    event_valid: object  # bool[W, K]
    more_due: object     # bool[W] — >K events were due; drain before polls


class HostBatch(NamedTuple):
    """One lockstep round of recorded host activity, padded to bucketed
    shapes (numpy; converted at the device boundary)."""

    t_slot: np.ndarray   # i32[W, T] new-timer lane slots
    t_dl: np.ndarray     # i64[W, T] absolute deadlines
    t_seq: np.ndarray    # i64[W, T]
    t_mask: np.ndarray   # bool[W, T]
    c_slot: np.ndarray   # i32[W, C] cancelled lane slots
    c_mask: np.ndarray   # bool[W, C]
    s_ctr: np.ndarray    # u64[W, S] NET-stream counter of the loss draw
    s_base: np.ndarray   # i64[W, S] elapsed_ns at the send
    s_slot: np.ndarray   # i32[W, S] delivery lane slot (live sends)
    s_seq: np.ndarray    # i64[W, S]
    s_thr: np.ndarray    # u64[W, S] loss threshold (per-send config)
    s_lossall: np.ndarray  # bool[W, S] loss rate >= 1.0
    s_lat_lo: np.ndarray   # i64[W, S] latency lower bound (ns)
    s_lat_w: np.ndarray    # i64[W, S] latency width (ns, >= 1)
    s_mask: np.ndarray   # bool[W, S]
    s_live: np.ndarray   # bool[W, S] has a destination socket (schedule it)
    clock: np.ndarray    # i64[W]
    advance: np.ndarray  # bool[W] advance to next event (False = drain only)


class DrainOut(NamedTuple):
    """Outputs of a pop-only drain round, lazy: ``np.asarray`` of a field
    materializes it, and the driver may enqueue the next drain first."""

    event_seq: object    # i64[W, K] — popped seqs (host dispatch key)
    event_valid: object  # bool[W, K]
    more_due: object     # bool[W] — still >K events due


#: HostBatch's fields as the round reads them.
BATCH_DTYPES = (np.int32, np.int64, np.int64, np.bool_, np.int32, np.bool_,
                np.uint64, np.int64, np.int32, np.int64, np.uint64,
                np.bool_, np.int64, np.int64, np.bool_, np.bool_, np.int64,
                np.bool_)


def bucket(n: int, minimum: int = 4) -> int:
    """Round a per-step count up to a power of two so batch shapes
    repeat."""
    b = minimum
    while b < n:
        b <<= 1
    return b


# ---------------------------------------------------------------------------
# Wrapping int64 arithmetic and u64 values in 32-bit limbs.
# ---------------------------------------------------------------------------

def _limbs(x: torch.Tensor):
    """(hi, lo) u32 limbs, each in int64, of int64 ``x``'s 64 bits."""
    return (x >> 32) & _M32, x & _M32


def _join(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """The int64 whose bits are ``hi:lo`` (u32 limbs), without an int64
    overflow: the high limb is made signed first."""
    return (hi - ((hi >> 31) << 32)) * _TWO32 + lo


def _add_wrap(a: torch.Tensor, b) -> torch.Tensor:
    """``a + b`` wrapped modulo 2^64 (XLA's int64 addition)."""
    b = torch.as_tensor(b, dtype=torch.int64, device=a.device)
    ah, al = _limbs(a)
    bh, bl = _limbs(b)
    lo = al + bl
    return _join((ah + bh + (lo >> 32)) & _M32, lo & _M32)


def _sub_wrap(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a - b`` wrapped modulo 2^64."""
    bh, bl = _limbs(b)
    return _add_wrap(_add_wrap(a, _join(bh ^ _M32, bl ^ _M32)), 1)


def _u64_lt(ah, al, bh, bl) -> torch.Tensor:
    """Unsigned ``a < b`` on limbs."""
    return (ah < bh) | ((ah == bh) & (al < bl))


def _u64_mod(uh: torch.Tensor, ul: torch.Tensor,
             w: torch.Tensor) -> torch.Tensor:
    """``u % w`` unsigned, for u given as limbs and ``w`` the int64 bits of
    a u64 divisor (>= 1). Returns the remainder's int64 bits."""
    top = (uh >> 31).bool()                       # bit 63 of u
    low63 = (uh & 0x7FFFFFFF) * _TWO32 + ul       # u mod 2^63, >= 0
    big = w < 0                                   # w >= 2^63 unsigned
    ws = torch.where(big, torch.ones_like(w), w)  # a safe divisor for % below
    # w < 2^63: u = top * 2^63 + low63, so u % w is the sum of
    # 2^63 % w = ((2^63 - 1) % w + 1) % w and low63 % w, reduced once
    # more without letting the sum pass 2^63.
    r63 = (INF_NS % ws + 1) % ws
    a = torch.where(top, r63, torch.zeros_like(r63))
    b = low63 % ws
    rest = ws - b
    small = torch.where(a >= rest, a - rest, a + b)
    # w >= 2^63: u % w is u - w where u >= w, else u.
    u = _join(uh, ul)
    wh, wl = _limbs(w)
    ge = ~_u64_lt(uh, ul, wh, wl)
    large = torch.where(ge, _sub_wrap(u, w), u)
    return torch.where(big, large, small)


def _u64_draw(k0, k1, hi, lo):
    """Threefry block at the u64 counter ``hi:lo``: the u64 draw's limbs
    (GlobalRng.next_u64: ``(x1 << 32) | x0``)."""
    x0, x1 = threefry2x32_i64(k0, k1, lo, hi)
    return x1, x0


def _pop(lane_dl, lane_seq, clock, cap: int, k_events: int):
    """``k_events`` pops at ``clock`` in (deadline, seq) order, as JAX's
    two reductions: ``m = min(dl)``, then the FIRST index of the least
    ``seq where dl == m, else INF_NS``. The first index is found by a min
    over indices, so the result is the same on every device. Returns
    the new deadlines and the (slot, seq, valid) columns."""
    w = lane_dl.shape[0]
    row = torch.arange(w, device=lane_dl.device)
    idx = torch.arange(cap, device=lane_dl.device).expand(w, cap)
    lane_dl = lane_dl.clone()
    seq_live = lane_seq[:, :cap]
    slots, seqs, valid = [], [], []
    for _ in range(k_events):
        live = lane_dl[:, :cap]
        m = live.min(dim=1).values
        is_due = m <= clock
        cand = torch.where(live == m[:, None], seq_live, INF_NS)
        least = cand.min(dim=1).values
        j = torch.where(cand == least[:, None], idx, cap).min(dim=1).values
        slots.append(j)
        seqs.append(seq_live[row, j])
        valid.append(is_due)
        lane_dl[row, torch.where(is_due, j, cap)] = INF_NS
    return (lane_dl, torch.stack(slots, 1), torch.stack(seqs, 1),
            torch.stack(valid, 1))


def batch_tensors(batch: HostBatch, device) -> HostBatch:
    """HostBatch's numpy fields as tensors on ``device``: masks bool, every
    other field int64 (u64 fields by bit view)."""
    out = []
    for name, dt in zip(HostBatch._fields, BATCH_DTYPES):
        a = np.asarray(getattr(batch, name))
        if a.dtype == np.uint64:
            a = np.ascontiguousarray(a).view(np.int64)
        want = torch.bool if dt == np.bool_ else torch.int64
        out.append(torch.as_tensor(a, device=device).to(want))
    return HostBatch(*out)


def step_plain(state: BridgeState, mb: Optional[BridgeMetrics], net_k0,
               net_k1, batch: HostBatch, *, cap: int, k_events: int):
    """One lockstep round in torch ops, bit-identical to JAX's ``_step``
    (``madsim_tpu/bridge/kernel.py:127``). ``batch`` holds tensors (see
    :func:`batch_tensors`); ``net_k0``/``net_k1`` are int64 u32 keys.
    Returns ``(state', mb', StepOut)`` of tensors; ``mb`` None skips the
    metrics. The inputs are not modified."""
    b = batch
    w = state.clock.shape[0]
    rows = torch.arange(w, device=state.clock.device)[:, None]
    lane_dl = state.lane_dl.clone()
    lane_seq = state.lane_seq.clone()

    # 1. Cancels first: a slot cancelled and reused within one batch ends
    #    up holding the new timer.
    c_slot = torch.where(b.c_mask, b.c_slot, cap)
    lane_dl[rows, c_slot] = INF_NS
    # 2. New timers.
    t_slot = torch.where(b.t_mask, b.t_slot, cap)
    lane_dl[rows, t_slot] = b.t_dl
    lane_seq[rows, t_slot] = b.t_seq

    # 3. Sends: loss draw at ctr, latency draw at ctr + 1 (wrapping).
    k0, k1 = net_k0[:, None], net_k1[:, None]
    ch, cl = _limbs(b.s_ctr)
    lh, ll = _u64_draw(k0, k1, ch, cl)
    cl1 = (cl + 1) & _M32
    ch1 = (ch + (cl1 == 0).long()) & _M32
    ph, pl = _u64_draw(k0, k1, ch1, cl1)
    th, tl = _limbs(b.s_thr)
    lost = _u64_lt(lh, ll, th, tl) | b.s_lossall
    ok = b.s_mask & ~lost
    latency = _add_wrap(b.s_lat_lo, _u64_mod(ph, pl, b.s_lat_w))
    deliver = ok & b.s_live
    s_slot = torch.where(deliver, b.s_slot, cap)
    # The host wheel's horizon clamp, after XLA's wrapping sum.
    send_dl = torch.clamp(_add_wrap(b.s_base, latency), max=TIMER_MAX_NS)
    lane_dl[rows, s_slot] = send_dl
    lane_seq[rows, s_slot] = b.s_seq

    # 4. Advance each world's clock to its next event: max(earliest + ε,
    #    now).
    min_dl = lane_dl[:, :cap].min(dim=1).values
    has_timer = min_dl < INF_NS
    do_adv = b.advance & has_timer
    new_clock = torch.where(
        do_adv, torch.maximum(b.clock, _add_wrap(min_dl, _EPSILON_NS)),
        b.clock)
    deadlock = b.advance & ~has_timer

    # 5. Pop the due entries in (deadline, seq) order.
    lane_dl, ev_slot, ev_seq, ev_valid = _pop(lane_dl, lane_seq, new_clock,
                                              cap, k_events)
    more_due = lane_dl[:, :cap].min(dim=1).values <= new_clock

    new_state = BridgeState(clock=new_clock, lane_dl=lane_dl,
                            lane_seq=lane_seq)
    if mb is not None:
        mb = BridgeMetrics(
            timers_set=mb.timers_set + b.t_mask.sum(dim=1),
            cancels=mb.cancels + b.c_mask.sum(dim=1),
            msgs_sent=mb.msgs_sent + b.s_mask.sum(dim=1),
            msgs_lost=mb.msgs_lost + (b.s_mask & lost).sum(dim=1),
            events_fired=mb.events_fired + ev_valid.sum(dim=1),
            vtime_ns=_add_wrap(mb.vtime_ns,
                               _sub_wrap(new_clock, state.clock)),
        )
    return new_state, mb, StepOut(
        clock=new_clock.clone(), deadlock=deadlock, send_ok=ok,
        event_slot=ev_slot.to(torch.int32), event_seq=ev_seq,
        event_valid=ev_valid, more_due=more_due)


def drain_plain(state: BridgeState, mb: Optional[BridgeMetrics], *,
                cap: int, k_events: int):
    """One pop-only drain round in torch ops, bit-identical to JAX's
    ``_drain_step`` (``madsim_tpu/bridge/kernel.py:236``): ``k_events``
    pops at the current clock, nothing else. Returns ``(state', mb',
    DrainOut)`` of tensors."""
    lane_dl, _, ev_seq, ev_valid = _pop(state.lane_dl, state.lane_seq,
                                        state.clock, cap, k_events)
    more_due = lane_dl[:, :cap].min(dim=1).values <= state.clock
    if mb is not None:
        mb = mb._replace(events_fired=mb.events_fired + ev_valid.sum(dim=1))
    return (BridgeState(clock=state.clock, lane_dl=lane_dl,
                        lane_seq=state.lane_seq), mb,
            DrainOut(event_seq=ev_seq, event_valid=ev_valid,
                     more_due=more_due))


def net_keys(seeds) -> tuple:
    """The NET-stream Threefry keys of u64 ``seeds``: two int64 arrays of
    u32 values."""
    seeds = np.asarray(seeds, dtype=np.uint64)
    k0 = (seeds & np.uint64(_M32)).astype(np.uint32)
    k1 = (seeds >> np.uint64(32)).astype(np.uint32)
    nk0, nk1 = derive_stream_np(k0, k1, STREAM_NET)
    return (np.atleast_1d(nk0).astype(np.int64),
            np.atleast_1d(nk1).astype(np.int64))


def resolve_device(device) -> torch.device:
    """``device``, else ``MADSIM_BRIDGE_DEVICE``, else CUDA; raises where
    no CUDA device is found and none was named."""
    name = device or os.environ.get("MADSIM_BRIDGE_DEVICE")
    if name is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                'BridgeKernel runs on the GPU by default, and no CUDA device '
                'was found: pass device="cpu" (or set MADSIM_BRIDGE_DEVICE='
                'cpu) to run the plain PyTorch round on the CPU')
        return torch.device("cuda")
    return torch.device("cuda" if name == "gpu" else name)


class BridgeKernel:
    """The device half of the bridge: owns the batched decision state.

    The host driver calls :meth:`step` once per lockstep round with padded
    numpy batches, and :meth:`drain` for pop-only rounds. On CUDA each is
    one launch of ``csrc/bridge_step.cu``; on the CPU the plain version
    runs. ``device=None`` reads ``MADSIM_BRIDGE_DEVICE``, else takes CUDA
    (and raises where there is none).
    """

    def __init__(self, seeds, *, cap: int = 128, k_events: int = 4,
                 device: str = None, metrics: bool = False):
        self.device = resolve_device(device)
        self.W = len(seeds)
        self.cap = int(cap)
        self.k_events = int(k_events)
        self.metrics_enabled = bool(metrics)
        if self.k_events < 1 or self.cap < 1:
            raise ValueError(f"BridgeKernel takes cap >= 1 and k_events >= "
                             f"1; got cap={cap}, k_events={k_events}")
        dev = self.device
        nk0, nk1 = net_keys(seeds)
        self._net_k0 = torch.as_tensor(nk0, device=dev)
        self._net_k1 = torch.as_tensor(nk1, device=dev)
        self.state = BridgeState(
            clock=torch.zeros((self.W,), dtype=torch.int64, device=dev),
            lane_dl=torch.full((self.W, self.cap + 1), INF_NS,
                               dtype=torch.int64, device=dev),
            lane_seq=torch.zeros((self.W, self.cap + 1), dtype=torch.int64,
                                 device=dev))
        self._mb = self._mb_block = None
        if self.metrics_enabled:
            # One (6, W) block whose rows are the counters: the CUDA kernel
            # takes it as one pointer.
            self._mb_block = torch.zeros(
                (len(BridgeMetrics._fields), self.W), dtype=torch.int64,
                device=dev)
            self._mb = BridgeMetrics(*self._mb_block.unbind(0))
        self._stages: dict = {}

    @property
    def _cuda(self) -> bool:
        return self.device.type == "cuda"

    def reset_slot(self, slot: int, seed: int) -> None:
        """Recycle one world slot for a fresh seed: re-derive its NET key
        and clear its rows (clock zero, every lane empty), so the slot is
        row ``slot`` of a fresh kernel keyed on ``seed``. The metrics keep
        running."""
        nk0, nk1 = derive_stream_np(*seed_to_key(int(seed)), STREAM_NET)
        self._net_k0[slot] = int(nk0)
        self._net_k1[slot] = int(nk1)
        self.state.clock[slot] = 0
        self.state.lane_dl[slot] = INF_NS
        self.state.lane_seq[slot] = 0

    def reset_slots(self, pairs) -> None:
        """Batched :meth:`reset_slot` over distinct slots: one write per
        lane array."""
        if not pairs:
            return
        if len(pairs) == 1:
            self.reset_slot(*pairs[0])
            return
        slots = torch.as_tensor([int(s) for s, _ in pairs], device=self.device)
        nk0, nk1 = net_keys([int(x) for _, x in pairs])
        self._net_k0[slots] = torch.as_tensor(nk0, device=self.device)
        self._net_k1[slots] = torch.as_tensor(nk1, device=self.device)
        self.state.clock[slots] = 0
        self.state.lane_dl[slots] = INF_NS
        self.state.lane_seq[slots] = 0

    def step(self, batch: HostBatch, out: Optional[StepOut] = None
             ) -> StepOut:
        """One lockstep round; returns a StepOut of numpy arrays. ``batch``
        fields may be any numpy buffers (shared-memory views included).
        ``out``, when given, is a StepOut of caller-owned arrays (``None``
        fields skipped) that the results are copied into."""
        if self._cuda:
            from . import cuda

            res = cuda.step(self, batch)
        else:
            self.state, mb, res = step_plain(
                self.state, self._mb, self._net_k0, self._net_k1,
                batch_tensors(batch, self.device), cap=self.cap,
                k_events=self.k_events)
            self._keep_metrics(mb)
            res = StepOut(*[x.numpy() for x in res])
        if out is not None:
            for dst, src in zip(out, res):
                if dst is not None:
                    np.copyto(dst, src)
        return res

    def drain(self) -> DrainOut:
        """One pop-only drain round. Its outputs are lazy: ``np.asarray``
        of a field waits for that round's copy to land, so the driver can
        enqueue the next drain before it reads this one. A drain that
        finds nothing due pops nothing."""
        if self._cuda:
            from . import cuda

            return cuda.drain(self)
        self.state, mb, res = drain_plain(
            self.state, self._mb, cap=self.cap, k_events=self.k_events)
        self._keep_metrics(mb)
        return DrainOut(*[x.numpy() for x in res])

    def _keep_metrics(self, mb: Optional[BridgeMetrics]) -> None:
        # The plain round returns new counters: copy them into the block,
        # whose rows stay the counters on every device.
        if mb is not None:
            for dst, src in zip(self._mb, mb):
                dst.copy_(src)

    def metrics(self):
        """Host copy of the per-slot :class:`BridgeMetrics` (dict of i64[W]
        numpy arrays), or ``None`` when metrics are off."""
        if self._mb is None:
            return None
        return {k: v.cpu().numpy().copy()
                for k, v in self._mb._asdict().items()}
