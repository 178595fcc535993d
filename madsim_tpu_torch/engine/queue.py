"""Fixed-capacity masked event queue, batched over a leading world axis.

The PyTorch counterpart of ``madsim_tpu/engine/queue.py`` (see its
docstring for the design). Storage per world is the time lane
(``INF_TIME`` ⇔ slot free), a packed meta lane (kind/flags/src/dst/gen in
one int32) and a ``(Q, P)`` payload lane. The semantics are the JAX
module's, bit for bit:

- pop takes the lowest slot holding the minimum time among eligible slots;
  with no eligible slot ``found`` is False even on a non-empty queue;
- push puts an enabled event into the lowest free slot; push_many puts
  the i-th enabled event into the i-th lowest free slot, as the chain of
  pushes would. Both drop an event at ``INF_TIME`` with ok=True, report
  ok=False for every enabled event past the last free slot, and saturate
  the payload into the at-rest lane dtype.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .lanes import narrow, on_device, onehot, prefix_count, take_small, widen

INF_TIME = 2**31 - 1

# Event flag bits.
FLAG_TIMER = 1  # gen-checked against the destination node's generation
FLAG_FAULT = 2  # engine-handled fault-injection event (kind = fault op)

# Generation comparisons wrap at this mask (8 packed bits).
GEN_MASK = 0xFF


def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 → int32 keeping the low 32 bits (two's complement)."""
    x = x & 0xFFFFFFFF
    return (x - ((x >> 31) << 32)).to(torch.int32)


def pack_meta(kind, flags, src, dst, gen) -> torch.Tensor:
    """kind[0:6] | flags[6:8] | src[8:16] | dst[16:24] | gen[24:32]."""
    def f(x):
        return torch.as_tensor(x).to(torch.int64)

    return _wrap_i32((f(kind) & 0x3F) | ((f(flags) & 0x3) << 6)
                     | ((f(src) & 0xFF) << 8) | ((f(dst) & 0xFF) << 16)
                     | ((f(gen) & 0xFF) << 24))


def unpack_meta(meta: torch.Tensor):
    """→ (kind, flags, src, dst, gen), each int32."""
    return (meta & 0x3F, (meta >> 6) & 0x3, (meta >> 8) & 0xFF,
            (meta >> 16) & 0xFF, (meta >> 24) & 0xFF)


class Event(NamedTuple):
    """Scheduled occurrences: int32 fields of shape (W,) — or (W, M) for a
    batch of M per world — and a payload of shape (..., P)."""

    time: torch.Tensor
    kind: torch.Tensor
    flags: torch.Tensor
    src: torch.Tensor
    dst: torch.Tensor
    gen: torch.Tensor
    payload: torch.Tensor


class EventQueue(NamedTuple):
    """Struct-of-arrays event store: time/meta are (W, Q) int32, payload is
    (W, Q, P) in the at-rest payload dtype."""

    time: torch.Tensor
    meta: torch.Tensor
    payload: torch.Tensor


def empty_queue(n_worlds: int, capacity: int, payload_words: int,
                payload_dtype=torch.int32, device=None) -> EventQueue:
    return EventQueue(
        time=torch.full((n_worlds, capacity), INF_TIME, dtype=torch.int32,
                        device=device),
        meta=torch.zeros((n_worlds, capacity), dtype=torch.int32,
                         device=device),
        payload=torch.zeros((n_worlds, capacity, payload_words),
                            dtype=payload_dtype, device=device),
    )


def valid_mask(q: EventQueue) -> torch.Tensor:
    """(W, Q) bool: which slots hold a pending event."""
    return q.time != INF_TIME


def depth(q: EventQueue) -> torch.Tensor:
    """(W,) int32 number of pending events."""
    return valid_mask(q).sum(dim=1, dtype=torch.int32)


def push(q: EventQueue, ev: Event, enable=True
         ) -> Tuple[EventQueue, torch.Tensor]:
    """Insert one event per world into its first free slot.

    ``ev`` fields are (W,) (payload (W, P)); ``enable`` a (W,) bool mask
    or a Python bool. Returns ``(queue, ok)`` with ``ok`` (W,) bool:
    False only where an enabled event found the queue full. A masked-out
    push, and an event at ``INF_TIME`` (it could never fire, and would
    alias the free-slot sentinel), change nothing and report ok=True. The
    payload saturates into the at-rest lane dtype. Bitwise the JAX
    ``push``; a chain of pushes equals one :func:`push_many`.
    """
    w = q.time.shape[0]
    dev = q.time.device

    def lane(x):
        return on_device(x, dev).to(torch.int32).expand(w)

    t = lane(ev.time)
    en = on_device(enable, dev).to(torch.bool).expand(w) & (t < INF_TIME)
    free = q.time == INF_TIME
    free_any = free.any(dim=1)
    # The first free slot: the free one with no free slot before it.
    do = free & (prefix_count(free) == 0) & en[:, None]
    meta = pack_meta(lane(ev.kind), lane(ev.flags), lane(ev.src),
                     lane(ev.dst), lane(ev.gen))
    pay = narrow(on_device(ev.payload, dev).to(torch.int32),
                 q.payload.dtype).expand(w, -1)
    out = EventQueue(
        time=torch.where(do, t[:, None], q.time),
        meta=torch.where(do, meta[:, None], q.meta),
        payload=torch.where(do[:, :, None], pay[:, None, :], q.payload),
    )
    return out, ~en | free_any


def push_many(q: EventQueue, evs: Event, enable: Optional[torch.Tensor] = None,
              clear: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
              ) -> Tuple[EventQueue, torch.Tensor, torch.Tensor]:
    """Insert up to M events per world in one pass.

    ``evs`` fields are (W, M) (payload (W, M, P)); ``enable`` an optional
    (W, M) bool mask; ``clear`` an optional ``(slot, found)`` pair of (W,)
    tensors from :func:`pop_indexed` over THIS ``q``: that slot counts as
    freed, and its time lane becomes ``INF_TIME`` unless refilled.

    Returns ``(queue, ok, n_inserted)`` with ``ok`` (W, M) bool and
    ``n_inserted`` (W,) int32 = ``min(n_enabled, n_free)``. Bitwise equal
    to the JAX ``push_many`` (and so to the sequential push chain).
    """
    w, qcap = q.time.shape
    dev = q.time.device
    t = evs.time.to(torch.int32)
    en = t < INF_TIME
    if enable is not None:
        en = en & enable
    rank = prefix_count(en).to(torch.int64)                     # (W, M)
    base_time = q.time
    free = base_time == INF_TIME
    if clear is not None:
        cslot, cfound = clear
        cm = onehot(cslot, qcap) & cfound[:, None]
        free = free | cm
        base_time = torch.where(cm, INF_TIME, base_time)
    n_free = free.sum(dim=1)                                    # (W,) i64
    n_en = en.sum(dim=1)
    ok = ~en | (rank < n_free[:, None])
    # slot_of_rank[w, r]: the r-th lowest free slot of world w. Column Q
    # collects the non-free slots and is the "no slot" sentinel.
    free_rank = torch.where(free, prefix_count(free).to(torch.int64), qcap)
    slot_of_rank = torch.full((w, qcap + 1), qcap, dtype=torch.int64,
                              device=dev)
    slot_of_rank.scatter_(1, free_rank,
                          torch.arange(qcap, device=dev).expand(w, qcap))
    slot_of_rank[:, qcap] = qcap
    place = en & (rank < n_free[:, None])
    target = torch.where(place,
                         torch.gather(slot_of_rank, 1, rank.clamp(max=qcap)),
                         qcap)                                  # (W, M)

    def scatter(lane, vals):
        ext = torch.cat([lane, lane[:, :1]], dim=1)
        idx = target
        if lane.dim() == 3:
            idx = target[:, :, None].expand(-1, -1, lane.shape[2])
        ext.scatter_(1, idx, vals.to(lane.dtype))
        return ext[:, :qcap].contiguous()

    meta = pack_meta(evs.kind, evs.flags, evs.src, evs.dst, evs.gen)
    out = EventQueue(
        time=scatter(base_time, t),
        meta=scatter(q.meta, meta),
        payload=scatter(q.payload, narrow(evs.payload, q.payload.dtype)),
    )
    return out, ok, torch.minimum(n_en, n_free).to(torch.int32)


def pop_indexed(q: EventQueue, eligible: Optional[torch.Tensor] = None
                ) -> Tuple[EventQueue, Event, torch.Tensor, torch.Tensor]:
    """Remove the earliest eligible event of each world.

    Returns ``(queue, ev, found, slot)``: ``ev`` fields are (W,) int32
    (payload (W, P) widened to int32), ``found`` (W,) bool, ``slot`` (W,)
    int64. Where ``found`` is False the event is arbitrary (time
    ``INF_TIME``) and the queue is unchanged.
    """
    times = q.time if eligible is None else torch.where(eligible, q.time,
                                                        INF_TIME)
    n = q.time.shape[1]
    tmin = times.min(dim=1).values
    found = tmin < INF_TIME
    rev = (n - 1) - torch.arange(n, device=times.device)
    slot = (n - 1) - torch.where(times == tmin[:, None], rev, -1) \
        .max(dim=1).values
    kind, flags, src, dst, gen = unpack_meta(take_small(q.meta, slot))
    ev = Event(time=tmin, kind=kind, flags=flags, src=src, dst=dst, gen=gen,
               payload=widen(take_small(q.payload, slot)))
    mask = onehot(slot, n) & found[:, None]
    q = q._replace(time=torch.where(mask, INF_TIME, q.time))
    return q, ev, found, slot


def pop(q: EventQueue, eligible: Optional[torch.Tensor] = None
        ) -> Tuple[EventQueue, Event, torch.Tensor]:
    """:func:`pop_indexed` without the slot."""
    q, ev, found, _slot = pop_indexed(q, eligible)
    return q, ev, found


def eligible_mask(q: EventQueue, paused: torch.Tensor) -> torch.Tensor:
    """(W, Q) pop-eligibility under node pause: fault events always fire;
    other events are eligible unless their (clamped) destination node is
    paused."""
    is_fault_q = (q.meta & (FLAG_FAULT << 6)) != 0
    dst_q = (q.meta >> 16) & 0xFF  # take_small clamps to [0, n_nodes)
    return is_fault_q | ~take_small(paused, dst_q)


def insert_metrics(times: torch.Tensor, enable: torch.Tensor,
                   n_inserted: torch.Tensor):
    """Insert-path counters of the metrics block: given an insert batch's
    (W, M) ``times`` and ``enable`` and the (W,) count :func:`push_many`
    inserted, return ``(n_requested, n_inf_dropped, n_overflow)``, each
    (W,) int32 — the enabled events, those dropped for a saturated
    deadline (``INF_TIME``), and those refused by a full queue."""
    en = enable.to(torch.bool)
    n_req = en.sum(dim=1, dtype=torch.int32)
    n_inf = (en & (times.to(torch.int32) >= INF_TIME)).sum(
        dim=1, dtype=torch.int32)
    return n_req, n_inf, n_req - n_inf - n_inserted.to(torch.int32)
