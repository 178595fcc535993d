"""The batched device engine core: world state, the plain step, and the run
loop.

The PyTorch counterpart of ``madsim_tpu/engine/core.py`` (see its
docstring for the design). One *world* is one seeded simulation of a whole
cluster; every leaf of :class:`WorldState` carries a leading world axis
``W``, and one step advances every world by one event. The JAX package
writes the step for one world and ``vmap``s it; here the world axis is
written out.

Two implementations of the step exist and are bitwise equal:

- :meth:`DeviceEngine.step_plain`, plain PyTorch ops on any device — the
  reference the kernel is held to, and the step the CPU runs;
- the hand-written CUDA kernel (``csrc/step_kernel.cuh``, launched by
  :mod:`madsim_tpu_torch.engine.step_kernel`), which is always the step
  on a CUDA device. It replaces the JAX package's one Pallas kernel.

The contract with the JAX package is bitwise equality on every
``WorldState`` leaf for the same seeds, faults and configs.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from ..ops.threefry import i64_to_u32, u32_to_i64
from .lanes import (
    PACKED,
    WIDE,
    Lanes,
    join_wide,
    narrow,
    narrow_wrap,
    onehot,
    split_wide,
    take_small,
    upd,
    upd2,
    widen,
)
from .queue import (
    FLAG_FAULT,
    FLAG_TIMER,
    GEN_MASK,
    INF_TIME,
    Event,
    EventQueue,
    depth as queue_depth,
    eligible_mask,
    empty_queue,
    insert_metrics,
    pop_indexed,
    push,
    push_many,
)
from .rng import DevRng, _u32_to_range, _u32_to_unit_f32, make_rng, next_u32_vec
from ..obs.blackbox import (
    BB_DROP_DEAD,
    BB_DROP_STALE,
    BB_FAULT,
    BB_MARKER,
    BB_RAISE,
    BB_TIMER,
    FAULT_NAMES,
    BlackboxRing,
)
from ..obs.metrics import NUM_FAULT_KINDS, MetricsBlock

# Device-engine RNG stream id (host streams occupy 0..3).
STREAM_DEVICE = 16

# Fault-injection ops (event kind when FLAG_FAULT is set); see the JAX
# module for the reference analogs.
FAULT_KILL = 0
FAULT_RESTART = 1
FAULT_CLOG_NODE = 2
FAULT_UNCLOG_NODE = 3
FAULT_CLOG_LINK = 4
FAULT_UNCLOG_LINK = 5
# FAULT_SET_LATENCY: a = new min µs, b = new max µs.
# FAULT_SET_LOSS:    a = new loss rate in parts-per-million, b unused.
FAULT_SET_LATENCY = 6
FAULT_SET_LOSS = 7
FAULT_PAUSE = 8
FAULT_RESUME = 9

#: Worlds per CUDA block when ``EngineConfig.pallas_block`` is None (the
#: tile plan lowers it where a block's tiles do not fit). Chosen from
#: ``chip_smoke.py``'s block sweep on an H100: 64, 128 and 256 within 2% of
#: each other on both main-path deployments; 128 the fastest on the
#: headline, 64 faster by under 1% on the hunt (PERF.md §5).
DEFAULT_BLOCK = 128


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static engine parameters: the JAX ``EngineConfig``'s fields, defaults
    and validation.

    ``pallas`` and ``pallas_interpret`` are accepted for parity and have no
    effect: on a CUDA device the step is always the hand-written kernel, on
    the CPU always the plain step. ``pallas_block`` is the number of worlds
    per CUDA block (default :data:`DEFAULT_BLOCK`).

    ``sequential_insert=True`` makes the plain step and ``init`` insert
    with the chain of single pushes (``queue.push``) in place of the one
    pass of ``queue.push_many``, as in the JAX package, where it pins the
    contract that the two are bitwise equal. The kernel's rank insert is
    ``push_many``'s function, so on CUDA the flag changes only ``init``.
    """

    n_nodes: int
    queue_cap: int = 128
    payload_words: int = 8
    outbox_cap: Optional[int] = None  # default n_nodes + 1
    latency_min_us: int = 1_000
    latency_max_us: int = 10_000
    loss_rate: float = 0.0
    t_limit_us: int = 10_000_000
    stop_on_bug: bool = True
    sequential_insert: bool = False
    metrics: bool = False
    blackbox: int = 0
    packed: bool = True
    pallas: bool = False
    pallas_block: Optional[int] = None
    pallas_interpret: Optional[bool] = None

    def __post_init__(self):
        if self.packed:
            if self.n_nodes > 127:
                raise ValueError(
                    f"EngineConfig(packed=True) stores node ids in int8: "
                    f"n_nodes={self.n_nodes} exceeds 127. Use "
                    f"packed=False (the int32 reference profile) for "
                    f"wider clusters.")
            if self.queue_cap > 32767:
                raise ValueError(
                    f"EngineConfig(packed=True) carries queue depths in "
                    f"int16: queue_cap={self.queue_cap} exceeds 32767. "
                    f"Use packed=False for deeper queues.")
        if self.pallas_block is not None and self.pallas_block <= 0:
            raise ValueError("pallas_block must be a positive world count")
        if self.blackbox < 0:
            raise ValueError("blackbox must be 0 (off) or a positive ring "
                             "depth K (events/world)")

    @property
    def lanes(self) -> Lanes:
        return PACKED if self.packed else WIDE

    @property
    def m(self) -> int:
        return self.outbox_cap if self.outbox_cap is not None else self.n_nodes + 1

    @property
    def block(self) -> int:
        """Worlds per CUDA block."""
        return self.pallas_block or DEFAULT_BLOCK


class Outbox(NamedTuple):
    """Per-world send buffers an actor returns from a handler: (W, M)
    fields, payload (W, M, P) int32."""

    valid: torch.Tensor     # bool
    is_timer: torch.Tensor  # bool
    kind: torch.Tensor      # int32
    dst: torch.Tensor       # int32
    delay_us: torch.Tensor  # int32 — timers only
    payload: torch.Tensor   # int32

    @staticmethod
    def empty(cfg: EngineConfig, n_worlds: int, device) -> "Outbox":
        m = cfg.m
        z = torch.zeros((n_worlds, m), dtype=torch.int32, device=device)
        f = torch.zeros((n_worlds, m), dtype=torch.bool, device=device)
        return Outbox(valid=f, is_timer=f, kind=z, dst=z, delay_us=z,
                      payload=torch.zeros((n_worlds, m, cfg.payload_words),
                                          dtype=torch.int32, device=device))


class WorldState(NamedTuple):
    """All state of W worlds; field order (and so leaf order) is the JAX
    package's. ``metrics`` is a :class:`MetricsBlock` with
    ``EngineConfig(metrics=True)`` and ``blackbox`` a :class:`BlackboxRing`
    with ``EngineConfig(blackbox=K)``, else None (no leaves). The step
    writes both and reads neither."""

    now: torch.Tensor          # (W,) int32 µs
    queue: EventQueue
    rng: DevRng
    alive: torch.Tensor        # (W, N) bool
    gen: torch.Tensor          # (W, N) code lane, compared mod 256
    paused: torch.Tensor       # (W, N) bool
    clog_node: torch.Tensor    # (W, N) bool
    clog_link: torch.Tensor    # (W, N, N) bool, [src, dst]
    astate: Any                # actor state (NamedTuple or dict of tensors)
    active: torch.Tensor       # (W,) bool — False ⇒ frozen
    steps: torch.Tensor        # (W,) int32
    delivered: torch.Tensor    # (W,) int32
    dropped: torch.Tensor      # (W,) int32
    overflow: torch.Tensor     # (W,) bool
    qdepth: torch.Tensor       # (W,) slot lane — carried queue depth
    qmax: torch.Tensor         # (W,) slot lane — depth high-water mark
    bug: torch.Tensor          # (W,) bool
    bug_time: torch.Tensor     # (W,) int32 µs of first bug, INF if none
    lat_min: torch.Tensor      # (W,) int32 µs
    lat_max: torch.Tensor      # (W,) int32 µs
    loss: torch.Tensor         # (W,) float32
    metrics: Any = None
    blackbox: Any = None


# ---------------------------------------------------------------------------
# The port's pytrees: NamedTuples (fields in order), dicts (keys in sorted
# order, as ``jax.tree.leaves`` flattens a dict — a compiled actor's state
# is a dict of lanes), and None, an empty subtree.
# ---------------------------------------------------------------------------

def tree_leaves(tree) -> list:
    """Leaves in ``jax.tree.leaves`` order."""
    if tree is None:
        return []
    if isinstance(tree, (tuple, dict)):
        out = []
        for x in (tree if isinstance(tree, tuple)
                  else (tree[k] for k in sorted(tree))):
            out.extend(tree_leaves(x))
        return out
    return [tree]


def tree_paths(tree, prefix: str = "") -> list:
    """Dotted field or key names of :func:`tree_leaves` (``queue.time``,
    ``astate.decision``, ...), in the same order."""
    if tree is None:
        return []
    if isinstance(tree, (tuple, dict)):
        items = (zip(tree._fields, tree) if isinstance(tree, tuple)
                 else ((k, tree[k]) for k in sorted(tree)))
        out = []
        for name, x in items:
            out.extend(tree_paths(x, prefix + name + "."))
        return out
    return [prefix[:-1]]


def tree_unflatten(template, leaves):
    """Rebuild ``template``'s structure from ``leaves`` (an iterator or
    list in :func:`tree_leaves` order)."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, tuple):
            return type(t)(*[build(x) for x in t])
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template has")
    return out


def tree_map(fn, *trees):
    """Apply ``fn`` leaf-wise over identically structured trees."""
    t0 = trees[0]
    if t0 is None:
        return None
    if isinstance(t0, tuple):
        return type(t0)(*[tree_map(fn, *xs) for xs in zip(*trees)])
    if isinstance(t0, dict):
        return {k: tree_map(fn, *[t[k] for t in trees]) for k in sorted(t0)}
    return fn(*trees)


def where_worlds(pred: torch.Tensor, a: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Per-world select: ``pred`` is (W,), ``a``/``b`` (W, ...)."""
    p = pred.reshape(pred.shape + (1,) * (a.dim() - 1))
    if a.dtype == torch.uint32:
        return i64_to_u32(torch.where(p, u32_to_i64(a), u32_to_i64(b)))
    return torch.where(p, a, b)


def tree_select_worlds(mask, a, b):
    """Slot-wise select over two identically batched trees: whole worlds
    from ``a`` where the (W,) bool ``mask`` is True, from ``b`` where it is
    False (``madsim_tpu.engine.tree_select_worlds``)."""
    return tree_map(lambda x, y: where_worlds(mask, x, y), a, b)


#: WorldState leaves (besides astate and rng) that a fault event writes.
_FAULT_FIELDS = ("alive", "gen", "paused", "clog_node", "clog_link",
                 "lat_min", "lat_max", "loss")


def _resolve_device(device) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "DeviceEngine runs on the GPU by default, and no CUDA device "
                "was found: pass device='cpu' to run the plain PyTorch step "
                "on the CPU")
        return torch.device("cuda")
    return torch.device(device)


#: :meth:`DeviceEngine.run`'s launch windows on CUDA: the first two of
#: 16 launches, every later one of 32. The host reads one window's flag
#: while the next window runs, so up to two windows of no-ops are queued
#: past the last freeze.
RUN_WINDOWS = (16, 16, 32)


class Lookahead:
    """The host's view of device flags, some units of work behind.

    The device-side loops queue work ahead of the host's knowledge: after
    each unit of work (a window, a chunk) they :meth:`push` an int32 or
    bool scalar computed on the device (a stop flag, a pending epoch),
    which is copied to pinned host memory behind the work. :meth:`read`
    returns the flags of all but the last ``depth`` units, waiting for the
    oldest where needed, so the device has ``depth`` units queued while the
    host waits and does not idle on the read. Work queued past a stop is a
    gated no-op, so reading late changes no result; the reads only bound
    how many no-ops are queued. On the CPU every flag is read at once.
    """

    #: Pinned host slots the flags land in, reused in turn (at most
    #: ``depth + 1`` are unread at a time).
    SLOTS = 8
    #: Flags the host has read so far, over every instance: on CUDA each
    #: read waits on the device (an event) and reads pinned memory, so
    #: this counts the host's waits that ``_fetch`` does not.
    host_reads = 0

    def __init__(self, cuda: bool, depth: int = 1):
        self.cuda = cuda
        self.depth = depth if cuda else 0
        self.pending: list = []
        self.pushed = 0
        self.host = (torch.empty((self.SLOTS,), dtype=torch.int32,
                                 pin_memory=True) if cuda else None)

    def push(self, flag: torch.Tensor) -> None:
        idx = self.pushed
        self.pushed += 1
        if not self.cuda:
            self.pending.append((idx, int(flag), None))
            return
        slot = self.host[idx % self.SLOTS]
        slot.copy_(flag.to(torch.int32), non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        self.pending.append((idx, slot, ev))

    def read(self, every: bool = False) -> list:
        """``(index, value)`` of each flag now readable, oldest first;
        with ``every``, of every flag pushed (waiting for the last)."""
        out = []
        while len(self.pending) > (0 if every else self.depth):
            idx, host, ev = self.pending.pop(0)
            Lookahead.host_reads += 1
            if ev is not None:
                ev.synchronize()
                host = int(host)
            out.append((idx, host))
        return out

    def stopped(self, every: bool = False) -> bool:
        """Whether a flag read now is set (see :meth:`read`)."""
        return any(v for _i, v in self.read(every))


def world_blocks(state) -> tuple:
    """The world blocks of ``state``: a split state's blocks
    (``parallel/mesh.py`` ``Sharded``), else the state itself."""
    shards = getattr(state, "shards", None)
    return tuple(shards) if shards is not None else (state,)


def split_like(x: torch.Tensor, blocks) -> list:
    """A whole-axis tensor cut into ``blocks``' widths, each piece on its
    block's device (a view where that is ``x``'s)."""
    out, at = [], 0
    for b in blocks:
        w = b.active.shape[0]
        out.append(x[at:at + w].to(b.active.device))
        at += w
    return out


def block_totals(blocks):
    """``(any_bug, n_active)`` over every block, on the first block's
    device."""
    dev = blocks[0].active.device
    any_bug = blocks[0].bug.any()
    n_act = blocks[0].active.sum(dtype=torch.int32)
    for b in blocks[1:]:
        any_bug = any_bug | b.bug.any().to(dev)
        n_act = n_act + b.active.sum(dtype=torch.int32).to(dev)
    return any_bug, n_act


def run_blocks(eng, blocks, k: int,
               gate: Optional[torch.Tensor] = None) -> None:
    """``k`` steps of every block, each by its own launches on its own
    device, gated (where ``gate``, an int32 scalar, is given) by a copy of
    it there."""
    at = {} if gate is None else {gate.device: gate}
    for b in blocks:
        d = b.active.device
        if gate is not None and d not in at:
            at[d] = gate.to(d)
        eng.run_steps(b, k, gate=at.get(d))


class DeviceEngine:
    """Batched simulation of W worlds of one actor under one config.

    Usage::

        eng = DeviceEngine(RaftActor(rcfg), EngineConfig(n_nodes=3))
        state = eng.init(np.arange(10_000))     # one world per seed
        state = eng.run(state, max_steps=5_000)  # updated in place
        out = eng.observe(state)                 # host-side dict

    ``device`` defaults to ``cuda``; pass ``device="cpu"`` to run the plain
    step on the CPU.
    """

    def __init__(self, actor, cfg: EngineConfig, device=None):
        if cfg.n_nodes > 256:
            raise ValueError("DeviceEngine supports at most 256 nodes/world")
        num_kinds = getattr(actor, "num_kinds", None)
        if num_kinds is None:
            raise ValueError("actor must declare num_kinds (its event-kind "
                             "count; packed event kinds are 6 bits)")
        if num_kinds > 64:
            raise ValueError("actor.num_kinds must be <= 64")
        self.actor = actor
        self.cfg = cfg
        self.device = _resolve_device(device)
        self._layout = None

    def state_layout(self) -> list:
        """``(name, dtype, per-world shape)`` of each state leaf, in leaf
        order, read off a one-world state built on the CPU."""
        if self._layout is None:
            one = self._init_batched(
                torch.zeros((1,), dtype=torch.uint32),
                torch.zeros((1,), dtype=torch.uint32),
                torch.zeros((1, 0, 4), dtype=torch.int32),
                torch.zeros((1,), dtype=torch.int32),
                torch.ones((1,), dtype=torch.int32),
                torch.zeros((1,), dtype=torch.float32))
            self._layout = [(name, x.dtype, tuple(x.shape[1:])) for name, x
                            in zip(tree_paths(one), tree_leaves(one))]
        return self._layout

    # ------------------------------------------------------------------
    # Initialization
    # ------------------------------------------------------------------
    def init(self, seeds, faults: Optional[np.ndarray] = None,
             configs: Optional[np.ndarray] = None, *,
             device=None) -> WorldState:
        """Build W worlds from a vector of u64 seeds, on ``device`` (default
        the engine's).

        ``faults``: optional int32 rows ``[time_us, op, a, b]``, shape
        (F, 4) (every world) or (W, F, 4); rows with time < 0 are
        disabled. ``configs``: optional ``[latency_min_us, latency_max_us,
        loss_rate]``, shape (3,) or (W, 3). Validation is the JAX
        package's.
        """
        seeds = np.asarray(seeds, dtype=np.uint64)
        if seeds.ndim != 1:
            raise ValueError("seeds must be a 1-D vector (one world per seed)")
        w = seeds.shape[0]
        if faults is None:
            faults = np.zeros((w, 0, 4), np.int32)
        else:
            faults = np.asarray(faults, np.int32)
            if faults.ndim == 2:
                faults = np.broadcast_to(faults, (w,) + faults.shape)
            live = faults[..., 0] >= 0
            ops = faults[..., 1]
            a, b = faults[..., 2], faults[..., 3]
            node_op = (ops <= FAULT_UNCLOG_LINK) | (ops >= FAULT_PAUSE)
            if np.any(live & ((ops < FAULT_KILL) | (ops > FAULT_RESUME))):
                raise ValueError("fault op must be one of FAULT_KILL.."
                                 "FAULT_RESUME")
            node_params = np.stack([a, b], axis=-1)
            if np.any((live & node_op)[..., None]
                      & ((node_params < 0)
                         | (node_params >= self.cfg.n_nodes))):
                raise ValueError(
                    f"fault-row node ids must be in [0, {self.cfg.n_nodes})")
            set_lat = live & (ops == FAULT_SET_LATENCY)
            if np.any(set_lat & ((a < 0) | (b <= a))):
                raise ValueError("FAULT_SET_LATENCY needs 0 <= min < max µs")
            set_loss = live & (ops == FAULT_SET_LOSS)
            if np.any(set_loss & ((a < 0) | (a > 1_000_000))):
                raise ValueError("FAULT_SET_LOSS rate must be 0..1e6 ppm")
            need_words = 4 if self.cfg.packed else 2
            if np.any(set_lat | set_loss) and \
                    self.cfg.payload_words < need_words:
                raise ValueError("net-config fault rows carry their params "
                                 f"in the payload: payload_words must be "
                                 f">= {need_words} (packed={self.cfg.packed})")

        return self._init_host(seeds, faults, configs, device)

    def _init_host(self, seeds: np.ndarray, faults, configs,
                   device=None) -> WorldState:
        """:meth:`init` after the fault rows' validation: ``faults`` is a
        (W, F, 4) host array, or a device tensor the caller vouches for
        (:meth:`refill`). The worlds are built on ``device`` (default the
        engine's)."""
        device = self.device if device is None else device
        w = seeds.shape[0]
        lo = (seeds & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        hi = (seeds >> np.uint64(32)).astype(np.uint32)
        if configs is None:
            configs = np.array([self.cfg.latency_min_us,
                                self.cfg.latency_max_us,
                                self.cfg.loss_rate], np.float64)
        configs = np.asarray(configs, np.float64)
        configs = np.broadcast_to(configs, (w, 3))
        lat_min = configs[:, 0].astype(np.int32)
        lat_max = configs[:, 1].astype(np.int32)
        loss = configs[:, 2].astype(np.float32)
        if np.any(lat_min < 0) or np.any(lat_max <= lat_min):
            raise ValueError("configs need 0 <= latency_min < latency_max µs")
        if np.any((loss < 0.0) | (loss > 1.0)):
            raise ValueError("configs loss_rate must be in [0, 1]")

        def dev(x):
            if isinstance(x, torch.Tensor):
                return x.to(device=device, dtype=torch.int32)
            return torch.from_numpy(np.array(x, order="C")).to(device)

        return self._init_batched(dev(lo), dev(hi), dev(faults), dev(lat_min),
                                  dev(lat_max), dev(loss))

    def _net_fault_payload_batch(self, rows: torch.Tensor):
        """(W, F, P) int32 payload table for fault rows (W, F, 4):
        net-config params ride the payload, split across two int16-range
        words each in the packed profile."""
        cfg = self.cfg
        is_net = (rows[..., 1] == FAULT_SET_LATENCY) \
            | (rows[..., 1] == FAULT_SET_LOSS)
        a = torch.where(is_net, rows[..., 2], 0)
        b = torch.where(is_net, rows[..., 3], 0)
        pay = torch.zeros(rows.shape[:2] + (cfg.payload_words,),
                          dtype=torch.int32, device=rows.device)
        if cfg.packed:
            a_lo, a_hi = split_wide(a)
            pay[..., 0] = a_lo
            if cfg.payload_words >= 2:
                pay[..., 1] = a_hi
            if cfg.payload_words >= 4:
                b_lo, b_hi = split_wide(b)
                pay[..., 2] = b_lo
                pay[..., 3] = b_hi
        else:
            pay[..., 0] = a
            if cfg.payload_words >= 2:
                pay[..., 1] = b
        return is_net, pay

    def _init_batched(self, seed_lo, seed_hi, fault_rows, lat_min, lat_max,
                      loss) -> WorldState:
        """The JAX ``_init_one``, written over the world axis."""
        cfg = self.cfg
        dev = seed_lo.device
        w = seed_lo.shape[0]
        n_faults = fault_rows.shape[1]
        rng = make_rng(seed_lo, seed_hi, STREAM_DEVICE)
        q = empty_queue(w, cfg.queue_cap, cfg.payload_words,
                        payload_dtype=cfg.lanes.payload, device=dev)
        astate, events, rng = self.actor.init(cfg, rng)
        overflow = torch.zeros((w,), dtype=torch.bool, device=dev)
        if cfg.sequential_insert:
            for ev in events:
                q, ok = push(q, ev)
                overflow = overflow | ~ok
        elif events:
            evs = Event(*[torch.stack(xs, dim=1) for xs in zip(*events)])
            q, oks, _ = push_many(q, evs)
            overflow = overflow | ~oks.all(dim=1)
        if n_faults:
            rows = fault_rows
            is_net, pay = self._net_fault_payload_batch(rows)
            zeros = torch.zeros_like(rows[..., 0])
            fevs = Event(time=rows[..., 0], kind=rows[..., 1],
                         flags=torch.full_like(zeros, FLAG_FAULT),
                         src=torch.where(is_net, zeros, rows[..., 2]),
                         dst=torch.where(is_net, zeros, rows[..., 3]),
                         gen=zeros, payload=pay)
            if cfg.sequential_insert:
                for f in range(n_faults):
                    q, ok = push(q, Event(*[x[:, f] for x in fevs]),
                                 enable=rows[:, f, 0] >= 0)
                    overflow = overflow | ~ok
            else:
                q, oks, _ = push_many(q, fevs, enable=rows[..., 0] >= 0)
                overflow = overflow | ~oks.all(dim=1)
        n = cfg.n_nodes
        qd32 = queue_depth(q)
        qd = narrow(qd32, cfg.lanes.slot)
        # The metrics block starts from the init-time queue: the actor's
        # seed events and the fault rows count as enqueued.
        mb = (MetricsBlock.zeros(w, self.actor.num_kinds, dev)
              ._replace(enqueued=qd32.clone()) if cfg.metrics else None)
        bb = (BlackboxRing.zeros(w, cfg.blackbox, cfg.lanes, dev)
              if cfg.blackbox else None)

        def zeros_(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=dev)

        return WorldState(
            now=zeros_((w,), torch.int32),
            queue=q,
            rng=rng,
            alive=torch.ones((w, n), dtype=torch.bool, device=dev),
            gen=zeros_((w, n), cfg.lanes.code),
            paused=zeros_((w, n), torch.bool),
            clog_node=zeros_((w, n), torch.bool),
            clog_link=zeros_((w, n, n), torch.bool),
            astate=astate,
            active=torch.ones((w,), dtype=torch.bool, device=dev),
            steps=zeros_((w,), torch.int32),
            delivered=zeros_((w,), torch.int32),
            dropped=zeros_((w,), torch.int32),
            overflow=overflow,
            qdepth=qd,
            qmax=qd.clone(),
            bug=zeros_((w,), torch.bool),
            bug_time=torch.full((w,), INF_TIME, dtype=torch.int32, device=dev),
            lat_min=lat_min,
            lat_max=lat_max,
            loss=loss,
            metrics=mb,
            blackbox=bb,
        )

    def refill(self, state: WorldState, slot_mask, new_seeds,
               faults=None, configs=None) -> WorldState:
        """Recycle batch slots: the worlds where ``slot_mask`` (W,) is True
        become fresh worlds of the matching rows of ``new_seeds`` (length
        W; rows outside the mask are initialised and discarded, so any
        placeholder seed works there).

        ``faults``/``configs`` follow :meth:`init`, plus a per-slot
        ``(W, F, 4)`` schedule, one block per slot. A per-slot schedule may
        be a **device tensor** (the guided search's children): that path
        skips the host-side validation of the row values, so the refill
        never waits on the device, under the contract that such schedules
        are valid by construction (the mutation operators keep validity;
        the template was validated by :meth:`init`). A refilled slot is
        bitwise an independent :meth:`init` of its seed under its own
        schedule. ``state`` is updated in place and returned.
        """
        w = int(np.asarray(new_seeds).shape[0])
        if isinstance(faults, torch.Tensor) and faults.dim() != 3:
            raise ValueError(
                f"a device-tensor fault override must be per-slot "
                f"(n_slots, F, 4); got {faults.dim()}-D shape "
                f"{tuple(faults.shape)}: pass host arrays for the "
                "shared-schedule form")
        if faults is not None and getattr(faults, "ndim", 0) == 3:
            if faults.shape[-1] != 4:
                raise ValueError(
                    f"per-slot fault schedules must be (n_slots, F, 4) "
                    f"rows of [time_us, op, a, b]; got shape "
                    f"{tuple(faults.shape)}")
            if faults.shape[0] != w:
                raise ValueError(
                    f"per-slot fault schedules carry one (F, 4) block "
                    f"per batch slot: got leading dim {faults.shape[0]} "
                    f"but the refill batch holds {w} slots")
        # The fresh worlds are built where the batch lies (a block of a
        # split batch may lie on another device than the engine's).
        dev = state.now.device
        if isinstance(faults, torch.Tensor):
            fresh = self._init_host(np.asarray(new_seeds, dtype=np.uint64),
                                    faults, configs, dev)
        else:
            fresh = self.init(new_seeds, faults=faults, configs=configs,
                              device=dev)
        mask = torch.from_numpy(np.asarray(slot_mask, bool).copy()).to(dev)
        return self._refill_select(mask, fresh, state)

    @staticmethod
    def _refill_select(mask: torch.Tensor, fresh, state):
        """The recycle-slot select (the JAX ``_refill_select``): the worlds
        where the (W,) bool ``mask`` is True take ``fresh``'s leaves, written
        into ``state`` in place."""
        for dst, src in zip(tree_leaves(state), tree_leaves(fresh)):
            dst.copy_(where_worlds(mask, src, dst))
        return state

    def refill_traced(self, state: WorldState, slot_mask: torch.Tensor,
                      seeds_lo: torch.Tensor, seeds_hi: torch.Tensor,
                      faults: torch.Tensor) -> WorldState:
        """:meth:`refill` from device tensors alone, the in-loop form (the
        JAX ``refill_traced``): ``slot_mask`` (W,) bool, the seeds' uint32
        halves ``seeds_lo``/``seeds_hi`` (W,), a per-slot ``(W, F, 4)``
        int32 schedule block. No host validation and no host read;
        latency and loss come from the engine config. A refilled slot is
        bitwise an independent :meth:`init` of its seed under its
        schedule. ``state`` is updated in place and returned."""
        w = slot_mask.shape[0]
        dev = slot_mask.device
        cfg = self.cfg
        fresh = self._init_batched(
            seeds_lo, seeds_hi, faults.to(torch.int32),
            torch.full((w,), int(cfg.latency_min_us), dtype=torch.int32,
                       device=dev),
            torch.full((w,), int(cfg.latency_max_us), dtype=torch.int32,
                       device=dev),
            torch.full((w,), float(np.float32(cfg.loss_rate)),
                       dtype=torch.float32, device=dev))
        return self._refill_select(slot_mask, fresh, state)

    # ------------------------------------------------------------------
    # The plain step (JAX _build_step, batched over the world axis)
    # ------------------------------------------------------------------
    def _net_params(self, payload: torch.Tensor):
        """Net-config fault params from (W, P) event payloads."""
        cfg = self.cfg
        zero = torch.zeros_like(payload[:, 0])
        if cfg.packed:
            if cfg.payload_words >= 4:
                return (join_wide(payload[:, 0], payload[:, 1]),
                        join_wide(payload[:, 2], payload[:, 3]))
            return zero, zero
        if cfg.payload_words >= 2:
            return payload[:, 0], payload[:, 1]
        return payload[:, 0], zero

    def _apply_fault(self, ws: WorldState, ev: Event):
        cfg, actor = self.cfg, self.actor
        op, a, b = ev.kind, ev.src, ev.dst
        is_kill = op == FAULT_KILL
        is_restart = op == FAULT_RESTART
        alive = upd(ws.alive, a, ~is_kill & (is_restart
                                             | take_small(ws.alive, a)))
        gen = upd(ws.gen, a, narrow_wrap(
            widen(take_small(ws.gen, a)) + (is_kill | is_restart).to(torch.int32),
            ws.gen.dtype))
        paused = upd(ws.paused, a, (op == FAULT_PAUSE) | (
            ~((op == FAULT_RESUME) | is_kill | is_restart)
            & take_small(ws.paused, a)))
        clog_node = upd(ws.clog_node, a, (op == FAULT_CLOG_NODE) | (
            (op != FAULT_UNCLOG_NODE) & take_small(ws.clog_node, a)))
        clog_link = upd2(ws.clog_link, a, b, (op == FAULT_CLOG_LINK) | (
            (op != FAULT_UNCLOG_LINK)
            & take_small(take_small(ws.clog_link, a), b)))
        set_lat = op == FAULT_SET_LATENCY
        set_loss = op == FAULT_SET_LOSS
        pa, pb = self._net_params(ev.payload)
        lat_min = torch.where(set_lat, pa, ws.lat_min)
        lat_max = torch.where(set_lat, pb, ws.lat_max)
        loss = torch.where(set_loss,
                           pa.to(torch.float32) * torch.tensor(
                               1e-6, dtype=torch.float32, device=pa.device),
                           ws.loss)
        astate_r, ob_r, rng_r = actor.on_restart(cfg, ws.astate, a, ws.now,
                                                 ws.rng)
        w = ws.now.shape[0]
        astate = tree_select_worlds(is_restart, astate_r, ws.astate)
        rng = tree_select_worlds(is_restart, rng_r, ws.rng)
        ob = tree_select_worlds(is_restart, ob_r,
                                Outbox.empty(cfg, w, a.device))
        return ws._replace(alive=alive, gen=gen, paused=paused,
                           clog_node=clog_node, clog_link=clog_link,
                           astate=astate, rng=rng, lat_min=lat_min,
                           lat_max=lat_max, loss=loss), ob

    def _push_outbox(self, ws: WorldState, src: torch.Tensor, ob: Outbox,
                     pre_q: EventQueue, clear) -> WorldState:
        cfg = self.cfg
        m = cfg.m
        # 2·M draws per world every step, valid or not: even counters give
        # latency, odd counters loss.
        xs, rng = next_u32_vec(ws.rng, 2 * m)
        lat = _u32_to_range(xs[:, 0::2], ws.lat_min[:, None],
                            ws.lat_max[:, None])                  # (W, M)
        u = _u32_to_unit_f32(xs[:, 1::2])                          # (W, M)
        dst = ob.dst.clamp(0, cfg.n_nodes - 1)                     # (W, M)
        clogged = take_small(ws.clog_node, src)[:, None] \
            | take_small(ws.clog_node, dst) \
            | take_small(take_small(ws.clog_link, src), dst)
        dropped = ~ob.is_timer & (clogged | (u < ws.loss[:, None]))
        delay = torch.where(ob.is_timer, ob.delay_us, lat).clamp(min=0)
        now = ws.now[:, None]
        t = now + torch.minimum(delay, INF_TIME - now)
        flags = ob.is_timer.to(torch.int32) * FLAG_TIMER
        gen_dst = widen(take_small(ws.gen, dst))
        enable = ob.valid & ~dropped & ws.active[:, None]
        evs = Event(time=t, kind=ob.kind, flags=flags,
                    src=src.to(torch.int32)[:, None].expand(-1, m), dst=dst,
                    gen=gen_dst, payload=ob.payload)
        if cfg.sequential_insert:
            # The chain of M pushes into the popped queue (the JAX
            # reference's equivalence path); the inserted count comes from
            # the carried-depth invariant.
            q, overflow = ws.queue, ws.overflow
            for i in range(m):
                q, ok = push(q, Event(*[x[:, i] for x in evs]),
                             enable=enable[:, i])
                overflow = overflow | ~ok
            qd32 = queue_depth(q)
            n_ins = qd32 - widen(ws.qdepth)
            qdepth = narrow(qd32, ws.qdepth.dtype)
        else:
            q, oks, n_ins = push_many(pre_q, evs, enable, clear=clear)
            overflow = ws.overflow | ~oks.all(dim=1)
            qdepth = ws.qdepth + narrow(n_ins, ws.qdepth.dtype)
        qmax = torch.maximum(ws.qmax, qdepth)
        mb = ws.metrics
        if cfg.metrics:
            # Send-side counters; write-only, gated on the pre-step active
            # flag like the inserts.
            i32 = torch.int32
            _n_req, n_inf, n_over = insert_metrics(t, enable, n_ins)
            live = ob.valid & ws.active[:, None]
            mb = mb._replace(
                msgs_sent=mb.msgs_sent + (live & ~ob.is_timer).sum(
                    dim=1, dtype=i32),
                drop_loss=mb.drop_loss + (live & dropped).sum(
                    dim=1, dtype=i32),
                enqueued=mb.enqueued + n_ins,
                drop_overflow=mb.drop_overflow + n_over,
                drop_inf=mb.drop_inf + n_inf)
        return ws._replace(queue=q, rng=rng, overflow=overflow,
                           qdepth=qdepth, qmax=qmax, metrics=mb)

    @torch.no_grad()
    def step_plain(self, ws: WorldState) -> WorldState:
        """One engine step of every world in plain PyTorch ops (returns a
        new state). The plain version of the CUDA step kernel."""
        cfg, actor = self.cfg, self.actor
        n = cfg.n_nodes
        w = ws.now.shape[0]
        q, ev, found, slot = pop_indexed(
            ws.queue, eligible_mask(ws.queue, ws.paused) & ws.active[:, None])
        now = torch.where(found, torch.maximum(ws.now, ev.time), ws.now)
        in_time = now < cfg.t_limit_us
        ws1 = ws._replace(queue=q, now=now, steps=ws.steps + 1,
                          qdepth=ws.qdepth - found.to(ws.qdepth.dtype))

        dst = ev.dst.clamp(0, n - 1)
        is_fault = (ev.flags & FLAG_FAULT) != 0
        is_timer = (ev.flags & FLAG_TIMER) != 0
        stale = is_timer & (ev.gen != (widen(take_small(ws1.gen, dst))
                                       & GEN_MASK))
        dead = ~take_small(ws1.alive, dst)
        deliver = found & in_time & ~is_fault & ~stale & ~dead
        do_fault = found & in_time & is_fault

        # A branch that no world takes in this step is not computed: the
        # selects below would discard its result.
        empty_ob = Outbox.empty(cfg, w, now.device)
        fault_ws, fault_ob = ws1, empty_ob
        if bool(do_fault.any()):
            fault_ws, fault_ob = self._apply_fault(ws1, ev)
        act_ws, act_ob, hbug = ws1, empty_ob, torch.zeros_like(deliver)
        if bool(deliver.any()):
            astate2, act_ob, rng2, hbug = actor.handle(cfg, ws1.astate, ev,
                                                       now, ws1.rng)
            act_ws = ws1._replace(astate=astate2, rng=rng2)

        # tree_select_worlds(do_fault, fault_ws,
        #                    tree_select_worlds(deliver, act_ws, ws1)),
        # over only the leaves that fault apply or the handler write.
        ws2 = ws1._replace(
            astate=tree_select_worlds(
                do_fault, fault_ws.astate,
                tree_select_worlds(deliver, act_ws.astate, ws1.astate)),
            rng=tree_select_worlds(
                do_fault, fault_ws.rng,
                tree_select_worlds(deliver, act_ws.rng, ws1.rng)),
            **{name: where_worlds(do_fault, getattr(fault_ws, name),
                                  getattr(ws1, name))
               for name in _FAULT_FIELDS})
        ob = tree_select_worlds(do_fault, fault_ob,
                                tree_select_worlds(deliver, act_ob, empty_ob))
        src = torch.where(do_fault, ev.src.clamp(0, n - 1), dst)
        ws3 = self._push_outbox(ws2, src, ob, ws.queue, (slot, found))

        bug_now = (deliver & hbug) | actor.invariant(cfg, ws3.astate)
        bug = ws3.bug | bug_now
        bug_time = torch.where(bug & ~ws3.bug, now, ws3.bug_time)
        active = found & in_time
        if cfg.stop_on_bug:
            active = active & ~bug
        ws4 = ws3._replace(
            bug=bug, bug_time=bug_time, active=active,
            delivered=ws3.delivered + deliver.to(torch.int32),
            dropped=ws3.dropped
            + (found & in_time & ~deliver & ~do_fault).to(torch.int32),
        )
        i32 = torch.int32
        if cfg.metrics:
            # Pop-side counters. Every increment is gated on ``found``,
            # which the pop gates on the active flag, so a frozen world's
            # block never moves. An out-of-range kind increments no bin.
            mb = ws3.metrics
            mb = mb._replace(
                msgs_delivered=mb.msgs_delivered
                + (deliver & ~is_timer).to(i32),
                timer_fires=mb.timer_fires + (deliver & is_timer).to(i32),
                drop_stale=mb.drop_stale
                + (found & in_time & ~is_fault & stale).to(i32),
                drop_dead=mb.drop_dead
                + (found & in_time & ~is_fault & ~stale & dead).to(i32),
                drop_out_of_time=mb.drop_out_of_time
                + (found & ~in_time).to(i32),
                vtime_us=mb.vtime_us + (now - ws.now),
                fault_hist=mb.fault_hist
                + (onehot(ev.kind, NUM_FAULT_KINDS)
                   & do_fault[:, None]).to(i32),
                kind_hist=mb.kind_hist
                + (onehot(ev.kind, mb.kind_hist.shape[1])
                   & deliver[:, None]).to(i32))
            ws4 = ws4._replace(metrics=mb)
        if cfg.blackbox:
            # The flight recorder: one record per step trace() records —
            # a valid processed event, or the ``invariant`` marker for a
            # raise on a step that processed none — at slot pos % K. A
            # disabled write aims at slot K, where upd writes nothing.
            k = cfg.blackbox
            rb = ws3.blackbox
            valid = found & in_time
            raised = bug & ~ws3.bug
            marker = raised & ~valid
            rec = valid | marker
            cur = torch.where(rec, torch.remainder(rb.pos, k), k)
            # A valid record keeps the event's time, a marker the clock.
            t_lo, t_hi = split_wide(torch.where(marker, now, ev.time))
            fl = ((valid & is_timer).to(i32) * BB_TIMER
                  + (valid & is_fault).to(i32) * BB_FAULT
                  + (valid & ~is_fault & stale).to(i32) * BB_DROP_STALE
                  + (valid & ~is_fault & ~stale & dead).to(i32)
                  * BB_DROP_DEAD
                  + raised.to(i32) * BB_RAISE
                  + marker.to(i32) * BB_MARKER)
            rb = rb._replace(
                pos=rb.pos + rec.to(i32),
                # The step index wraps to the lane's width (pos gives the
                # high bits back); pre-wrapped, so upd's saturating write
                # passes it through.
                step_lo=upd(rb.step_lo, cur,
                            narrow_wrap(ws.steps, rb.step_lo.dtype)),
                t_lo=upd(rb.t_lo, cur, t_lo),
                t_hi=upd(rb.t_hi, cur, t_hi),
                kind=upd(rb.kind, cur, torch.where(valid, ev.kind, 0)),
                src=upd(rb.src, cur, torch.where(valid, ev.src, -1)),
                dst=upd(rb.dst, cur, torch.where(valid, ev.dst, -1)),
                flags=upd(rb.flags, cur, fl))
            ws4 = ws4._replace(blackbox=rb)
        # Frozen worlds pass through untouched: every write above is gated
        # on ws.active except the RNG cursor and the step counter. (The
        # ring's marker needs a rising bug flag, which a frozen world's
        # unchanged state raises only where no step has checked it.)
        return ws4._replace(
            rng=tree_select_worlds(ws.active, ws4.rng, ws.rng),
            steps=torch.where(ws.active, ws4.steps, ws.steps))

    # ------------------------------------------------------------------
    # Run loops
    # ------------------------------------------------------------------
    def step(self, state: WorldState) -> WorldState:
        """One step of every world, in place (see :meth:`run_steps`)."""
        return self.run_steps(state, 1)

    def run_steps(self, state: WorldState, k: int,
                  gate: Optional[torch.Tensor] = None) -> WorldState:
        """Advance every world by exactly ``k`` masked steps.

        On a CUDA device each step is one launch of the hand-written
        kernel (:mod:`.step_kernel`); on the CPU it is :meth:`step_plain`.
        ``gate``: an int32 scalar tensor on the state's device; where it
        is nonzero when a step runs, the step changes nothing (the
        kernel reads it; on the CPU the steps are skipped). ``state`` is updated in
        place and returned — the port's analogue of the JAX run loops
        donating their input buffers.
        """
        from . import step_kernel

        return step_kernel.run_steps(self, state, k, gate=gate)

    #: How many steps :meth:`trace` takes between its tests of whether its
    #: world froze.
    check_every = 16

    def run(self, state: WorldState, max_steps: int = 100_000) -> WorldState:
        """Step until every world is inactive, or ``max_steps`` steps.

        A host loop of step launches that stops at exactly ``max_steps``.
        The launches go out in windows (:data:`RUN_WINDOWS`); after each
        window a device flag says whether every world is frozen. The host
        reads the first window's flag at once (the loop's one sync) and
        every later window's only after it has queued the next window
        (:class:`Lookahead`), so the device does not wait on the host, and
        stops once a flag it reads is set. A step of a frozen world
        changes no leaf, so the launches queued past the last freeze are
        no-ops: :meth:`last_run_stats` counts them. ``state`` is updated
        in place and returned (the analogue of the JAX loop's buffer
        donation). On the CPU every window is the first window's size and
        every flag is read at once (there is no device to wait on).
        """
        cuda = state.active.device.type == "cuda"
        steps0 = state.steps.clone()
        ahead = Lookahead(cuda)
        i = n = 0
        while i < max_steps:
            window = RUN_WINDOWS[min(n, len(RUN_WINDOWS) - 1) if cuda else 0]
            k = min(window, max_steps - i)
            self.run_steps(state, k)
            i += k
            n += 1
            # "Every world frozen" after this window, read once the next
            # window is queued (on the CPU at once); the first window's at
            # once, so that a run that ends in it queues no second one.
            ahead.push(~state.active.any())
            if ahead.stopped(every=n == 1):
                break
        # The steps the longest-lived world took: a world steps while it
        # is active, and none turns active during a run.
        stepped = ((state.steps - steps0).max() if steps0.numel()
                   else torch.zeros((), dtype=torch.int32))
        self.last_run = {"launches": i, "stepped": stepped}
        return state

    def superstep(self, state, stop_threshold: int,
                  stop_on_bug: bool, k_chunks: int, *, chunk_steps: int,
                  k_max: int, min_one: bool = False, cov=None):
        """Up to ``k_chunks`` chunks of ``chunk_steps`` steps behind one host
        decision: the counterpart of the JAX ``_superstep_impl``.

        The early exits run on the device: after each chunk a device op
        closes the gate of every later chunk once the active count is at
        most ``stop_threshold``, or, with ``stop_on_bug``, once a bug is
        seen. The condition is tested before the first chunk too, so a
        superstep whose entry condition is false changes no bit: every one
        of its launches is a gated no-op. ``min_one`` runs the first chunk
        whatever the condition (the first dispatch of an occupancy
        epoch). Up to ``min(k_chunks, k_max)`` chunks are queued: the host
        reads each chunk's gate a chunk later (:class:`Lookahead`), so it
        stops queuing a chunk after the gate closes without the device
        waiting on it; on the CPU it stops at the first closed gate.

        ``state`` may be split over devices (``parallel/mesh.py``
        ``Sharded``): each block is stepped by launches of its own on its
        own device, gated by a copy of the gate word there, and the
        active count and bug flag are reduced over the blocks onto the
        first block's device, where the gate is decided (the JAX
        superstep's psum over the mesh). The scalars returned live there.

        ``cov``: ``(hits, first_seen, idx, n_real)``, the coverage ledger,
        the slot→seed index (whole, on the first block's device) and the
        real seed count: after each chunk the worlds whose active flag fell
        in it, holding a real seed id, fold into the ledger (a chunk
        behind a closed gate changes no flag, so it folds nothing).

        Returns ``(state, any_bug, n_active, k_done, hist)`` as device
        tensors, ``hist[j]`` the active count after chunk ``j`` (-1 for a
        chunk that did not run), and with ``cov`` also ``((hits,
        first_seen), cov_hist)``, the cumulative distinct count after each
        chunk run. ``state`` is updated in place.
        """
        from ..obs.coverage import distinct_count, fold_shards

        blocks = world_blocks(state)
        dev = blocks[0].active.device
        cuda = dev.type == "cuda"
        any_bug, n_act = block_totals(blocks)
        hist = torch.full((k_max,), -1, dtype=torch.int32, device=dev)
        k_done = torch.zeros((), dtype=torch.int32, device=dev)
        running = torch.ones((), dtype=torch.bool, device=dev)
        cov_hist = None
        if cov is not None:
            hits, first, idx, n_real = cov
            idx_b = split_like(idx, blocks)
            cov_hist = torch.full((k_max,), -1, dtype=torch.int32,
                                  device=dev)
        ahead = Lookahead(cuda)
        for i in range(min(int(k_chunks), int(k_max))):
            if not (min_one and i == 0):
                go = n_act > stop_threshold
                if stop_on_bug:
                    go = go & ~any_bug
                running = running & go
            # Past a stop every chunk is a gated no-op: stop queuing them
            # once the host sees it (a chunk behind on CUDA).
            ahead.push(~running)
            if ahead.stopped():
                break
            act0 = ([b.active.clone() for b in blocks] if cov is not None
                    else None)
            run_blocks(self, blocks, chunk_steps, (~running).to(torch.int32))
            any_bug, n_act = block_totals(blocks)
            hist[i] = torch.where(running, n_act, -1)
            k_done = k_done + running.to(torch.int32)
            if cov is not None:
                hits, first = fold_shards(hits, first, [
                    (b.metrics, a0 & ~b.active & (ib >= 0) & (ib < n_real),
                     ib) for b, a0, ib in zip(blocks, act0, idx_b)])
                cov_hist[i] = torch.where(running, distinct_count(hits), -1)
        if cov is not None:
            return state, any_bug, n_act, k_done, hist, (hits, first), \
                cov_hist
        return state, any_bug, n_act, k_done, hist

    def last_run_stats(self) -> Dict[str, int]:
        """What the last :meth:`run` did: its launches, and of them the
        no-ops queued past the last world's freeze (one device read, made
        here and not in the run)."""
        r = getattr(self, "last_run", None)
        if r is None:
            return {"launches": 0, "noops": 0}
        return {"launches": int(r["launches"]),
                "noops": int(r["launches"]) - int(r["stepped"])}

    # ------------------------------------------------------------------
    # Single-seed tracing (repro tooling)
    # ------------------------------------------------------------------
    @torch.no_grad()
    def trace(self, seed: int, max_steps: int = 2_000,
              faults: Optional[np.ndarray] = None) -> List[Dict[str, Any]]:
        """Replay ONE seed on this engine's device and return its event
        trace: per processed step its virtual time, kind, src→dst, timer
        flag and payload, ``dropped`` for a stale timer or a dead
        destination, ``bug_raised`` where the bug flag first rose (an
        ``invariant`` marker when that step processed no event), and a
        ``truncated`` entry, with a RuntimeWarning if no bug was seen, when
        ``max_steps`` ends the replay of a world still live.

        Each step peeks at the event the step will pop (the same eligible
        first-min pop), then steps the one world with :meth:`run_steps`
        (on CUDA, the kernel at W=1). The records stay on the device and
        are pulled once at the end. Steps after the world froze record
        nothing, so the replay stops there (tested every
        :attr:`check_every` steps).
        """
        cfg = self.cfg
        n = cfg.n_nodes
        state = self.init(np.asarray([seed], np.uint64), faults=faults)
        rows = []
        i = 0
        while i < max_steps:
            _q, ev, found, _slot = pop_indexed(
                state.queue, eligible_mask(state.queue, state.paused))
            in_time = torch.maximum(state.now, ev.time) < cfg.t_limit_us
            valid = found & state.active & in_time
            self.run_steps(state, 1)
            # The step's own drop tests, on the stepped world.
            dst_c = ev.dst.clamp(0, n - 1)
            is_fault = (ev.flags & FLAG_FAULT) != 0
            stale = ((ev.flags & FLAG_TIMER) != 0) & (
                ev.gen != (widen(take_small(state.gen, dst_c)) & GEN_MASK))
            dead = ~take_small(state.alive, dst_c)
            delivered = ~is_fault & ~stale & ~dead
            rows.append(torch.cat([
                torch.stack([valid.to(torch.int32), ev.time, ev.kind,
                             ev.flags, ev.src, ev.dst,
                             delivered.to(torch.int32),
                             state.bug.to(torch.int32), state.now.clone()],
                            dim=1),
                ev.payload], dim=1))
            i += 1
            if i % self.check_every == 0 and not bool(state.active[0]):
                break
        recs = (torch.cat(rows).cpu().numpy() if rows
                else np.zeros((0, 9 + cfg.payload_words), np.int32))
        final_active = bool(state.active[0])
        final_now = int(state.now[0])
        kind_names = getattr(self.actor, "kind_names", None)
        out: List[Dict[str, Any]] = []
        bug_seen = False
        for i, r in enumerate(recs):
            (valid, time_us, kind, flags, src, dst, delivered, bug,
             now_us) = (int(x) for x in r[:9])
            raised_here = bool(bug) and not bug_seen
            if not valid:
                if raised_here:
                    # The invariant rose on a step that processed no event.
                    out.append({"step": i, "t_us": now_us,
                                "kind": "invariant", "timer": False,
                                "src": -1, "dst": -1, "payload": [],
                                "bug_raised": True})
                    bug_seen = True
                continue
            is_fault = bool(flags & FLAG_FAULT)
            if is_fault:
                name = f"fault:{FAULT_NAMES.get(kind, kind)}"
            elif kind_names is not None and 0 <= kind < len(kind_names):
                name = kind_names[kind]
            else:
                name = str(kind)
            entry = {
                "step": i,
                "t_us": time_us,
                "kind": name,
                "timer": bool(flags & FLAG_TIMER),
                "src": src,
                "dst": dst,
                "payload": r[9:].tolist(),
            }
            if not is_fault and not delivered:
                entry["dropped"] = True
            if raised_here:
                entry["bug_raised"] = True
                bug_seen = True
            out.append(entry)
        if final_active:
            out.append({"step": max_steps, "t_us": final_now,
                        "kind": "truncated", "timer": False, "src": -1,
                        "dst": -1, "payload": [], "bug_seen": bug_seen})
            if not bug_seen:
                warnings.warn(
                    f"trace(seed={seed}) truncated at max_steps={max_steps} "
                    "before any bug_raised event — raise max_steps if you "
                    "expected the invariant violation in this window",
                    RuntimeWarning, stacklevel=2)
        return out

    # ------------------------------------------------------------------
    # Observation
    # ------------------------------------------------------------------
    def observe_device(self, state: WorldState) -> Dict[str, torch.Tensor]:
        """The observation dict as device tensors, in sorted key order."""
        out = {
            "now_us": state.now,
            "active": state.active,
            "steps": state.steps,
            "delivered": state.delivered,
            "dropped": state.dropped,
            "overflow": state.overflow,
            "qmax": state.qmax,
            "bug": state.bug,
            "bug_time_us": state.bug_time,
            "queue_depth": state.qdepth,
        }
        if self.cfg.metrics and state.metrics is not None:
            # One m_<field> entry per counter, one bb_<field> per ring
            # lane: the sweep attributes them per seed like any other
            # observation.
            out.update({f"m_{name}": val for name, val
                        in state.metrics._asdict().items()})
        if self.cfg.blackbox and state.blackbox is not None:
            out.update({f"bb_{name}": val for name, val
                        in state.blackbox._asdict().items()})
        out.update(self.actor.observe(self.cfg, state.astate))
        # Sorted by key, as ``jax.device_get`` rebuilds a dict: the order
        # is visible where equal counts tie (SweepResult.summary()).
        return dict(sorted(out.items()))

    def observe(self, state: WorldState) -> Dict[str, np.ndarray]:
        """Engine and actor observations as host numpy arrays, in sorted
        key order (as the JAX package returns them)."""
        return {k: v.cpu().numpy()
                for k, v in self.observe_device(state).items()}
