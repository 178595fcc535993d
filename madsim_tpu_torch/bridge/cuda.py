"""The bridge's round and drain as hand-written CUDA launches
(``csrc/bridge_step.cu``).

:class:`~madsim_tpu_torch.bridge.kernel.BridgeKernel` calls :func:`step` and
:func:`drain` when its state lies on a CUDA device; on the CPU it runs the
plain versions instead. A round costs one host-to-device copy (the padded
HostBatch, staged field by field into one pinned buffer), one launch and
one device-to-host copy (the StepOut, from one device buffer into one pinned
buffer), then a wait for that copy. A drain costs one launch and one
device-to-host copy that is not waited for: its DrainOut's fields wait for
their own copy when ``np.asarray`` reads them.

:func:`bridge_model` is the kernels' order of work in numpy: the worlds in
blocks and warps as the launch groups them (:func:`launch_shape`), each
warp's rows staged by one bulk copy or per-thread copies
(:func:`lane_copy_paths`), and each pop one reduction of a fused key with
the partials of the world's lanes merged in the shuffles' order.
"""
from __future__ import annotations

import ctypes
import functools
import time

import numpy as np
import torch

from .. import _build
from ..ops.threefry import threefry2x32_np
from .kernel import (_EPSILON_NS, BATCH_DTYPES, INF_NS, TIMER_MAX_NS, DrainOut,
                     HostBatch, StepOut)

SOURCE = "bridge_step"

#: Launches of the round kernel and of the drain kernel so far.
step_launches = 0
drain_launches = 0
#: Host-to-device and device-to-host copies the wrapper has queued.
h2d_copies = 0
d2h_copies = 0

_N_STEP_PTRS = 31
_N_DRAIN_PTRS = 7


def _lib():
    lib = _build.load(SOURCE)
    if not getattr(lib, "_madsim_typed", False):
        lib.madsim_bridge_step.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.madsim_bridge_step.restype = ctypes.c_int
        lib.madsim_bridge_drain.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.madsim_bridge_drain.restype = ctypes.c_int
        lib.madsim_bridge_empty.argtypes = [ctypes.c_int, ctypes.c_int,
                                            ctypes.c_int, ctypes.c_int,
                                            ctypes.c_void_p]
        lib.madsim_bridge_empty.restype = ctypes.c_int
        lib._madsim_typed = True
    return lib


def launch_empty(w: int, cap: int, stream) -> None:
    """One launch of an empty kernel on the round's grid for ``w`` worlds
    at ``cap`` (the launch floor's yardstick; counts nothing)."""
    lanes, warps, _ = launch_shape(w, cap)
    _launch_status("empty", _lib().madsim_bridge_empty(
        int(w), int(cap), lanes, warps, stream.cuda_stream))


def _layout(fields):
    """Byte offsets of ``(dtype, shape)`` fields packed in one buffer, each
    8-byte aligned; returns ``(offsets, total bytes)``."""
    offs, at = [], 0
    for dt, shape in fields:
        offs.append(at)
        at += (np.dtype(dt).itemsize * int(np.prod(shape)) + 7) // 8 * 8
    return offs, max(at, 8)


def _views(buf: np.ndarray, fields, offs):
    return [buf[o:o + np.dtype(dt).itemsize * int(np.prod(shape))]
            .view(dt).reshape(shape)
            for (dt, shape), o in zip(fields, offs)]


_OUT_DTYPES = (np.int64, np.bool_, np.bool_, np.int32, np.int64, np.bool_,
               np.bool_)


class _Stage:
    """The buffers of one round shape (W, T, C, S, K): the pinned batch and
    its device copy, the device StepOut and its pinned copy."""

    def __init__(self, dev, w, t, c, s, k):
        self.t, self.c, self.s = t, c, s
        widths = (t, t, t, t, c, c) + (s,) * 10
        self.in_fields = [(dt, (w, n)) for dt, n in
                          zip(BATCH_DTYPES[:16], widths)]
        self.in_fields += [(np.int64, (w,)), (np.bool_, (w,))]
        self.out_fields = list(zip(_OUT_DTYPES, [
            (w,), (w,), (w, s), (w, k), (w, k), (w, k), (w,)]))
        self.in_offs, n_in = _layout(self.in_fields)
        self.out_offs, n_out = _layout(self.out_fields)
        self.host_in = torch.empty(n_in, dtype=torch.uint8, pin_memory=True)
        self.dev_in = torch.empty(n_in, dtype=torch.uint8, device=dev)
        self.dev_out = torch.empty(n_out, dtype=torch.uint8, device=dev)
        self.host_out = torch.empty(n_out, dtype=torch.uint8,
                                    pin_memory=True)
        self.in_views = _views(self.host_in.numpy(), self.in_fields,
                               self.in_offs)
        base_in, base_out = self.dev_in.data_ptr(), self.dev_out.data_ptr()
        self.in_ptrs = [base_in + o for o in self.in_offs]
        self.out_ptrs = [base_out + o for o in self.out_offs]


def _check_state(kernel) -> None:
    st, cap = kernel.state, kernel.cap
    w = kernel.W
    want = [("clock", st.clock, (w,)), ("lane_dl", st.lane_dl, (w, cap + 1)),
            ("lane_seq", st.lane_seq, (w, cap + 1)),
            ("net_k0", kernel._net_k0, (w,)),
            ("net_k1", kernel._net_k1, (w,))]
    if kernel._mb_block is not None:
        want.append(("metrics", kernel._mb_block, (6, w)))
    for name, x, shape in want:
        if x.device.type != "cuda" or x.dtype != torch.int64 \
                or tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"the bridge kernel takes {name} as a "
                             f"contiguous CUDA int64 tensor of shape {shape}; "
                             f"got {x.dtype} {tuple(x.shape)} on {x.device}")


def _batch_widths(batch: HostBatch, w: int):
    """The batch's widths (T, C, S); raises unless every field is (W,) or
    (W, its group's width)."""
    widths = {}
    for name in HostBatch._fields:
        shape = np.shape(getattr(batch, name))
        if name in ("clock", "advance"):
            ok = shape == (w,)
        else:
            ok = (len(shape) == 2 and shape[0] == w
                  and widths.setdefault(name[0], shape[1]) == shape[1])
        if not ok:
            raise ValueError(f"HostBatch.{name} has shape {shape}; the round "
                             f"takes (W,) or (W, its group's width) with "
                             f"W = {w}")
    return widths["t"], widths["c"], widths["s"]


def _launch_status(what: str, status: int) -> None:
    if status != 0:
        raise RuntimeError(f"bridge {what} kernel: CUDA launch failed with "
                           f"error {status}")


def stage_batch(kernel, batch: HostBatch) -> _Stage:
    """The kernel's buffers for the batch's shape, with the batch copied
    into the pinned one (each field cast to the kernel's type)."""
    _check_state(kernel)
    t, c, s = _batch_widths(batch, kernel.W)
    stage = kernel._stages.get((t, c, s))
    if stage is None:
        stage = kernel._stages[(t, c, s)] = _Stage(
            kernel.device, kernel.W, t, c, s, kernel.k_events)
    for view, x in zip(stage.in_views, batch):
        np.copyto(view, x, casting="unsafe")
    return stage


def launch_step(kernel, stage: _Stage, stream) -> None:
    """One launch of the round kernel on ``stream`` over the state and the
    stage's device buffers (counts nothing)."""
    st, mb = kernel.state, kernel._mb_block
    ptrs = (ctypes.c_void_p * _N_STEP_PTRS)(
        st.clock.data_ptr(), st.lane_dl.data_ptr(), st.lane_seq.data_ptr(),
        kernel._net_k0.data_ptr(), kernel._net_k1.data_ptr(),
        None if mb is None else mb.data_ptr(),
        *stage.in_ptrs, *stage.out_ptrs)
    lanes, warps, _ = launch_shape(kernel.W, kernel.cap)
    _launch_status("step", _lib().madsim_bridge_step(
        ptrs, _N_STEP_PTRS, kernel.W, kernel.cap, kernel.k_events, stage.t,
        stage.c, stage.s, lanes, warps, stream.cuda_stream))


def _stamp(split) -> None:
    if split is not None:
        split.append(time.perf_counter())


#: The pieces of a round's wall that :func:`step` stamps, in order.
STEP_SPLIT = ("staging", "h2d_enqueue", "launch", "d2h_enqueue", "wait",
              "output_copy")
#: The pieces of a drain's wall that :func:`drain` stamps; the wait and
#: the output copy happen where its fields are read.
DRAIN_SPLIT = ("setup", "launch", "d2h_enqueue", "event")


def step(kernel, batch: HostBatch, split=None) -> StepOut:
    """One lockstep round of ``kernel`` on its CUDA device: stage the
    batch, one copy in, one launch, one copy out, the StepOut back as
    fresh numpy arrays. ``split``, where given, is a list that gets a
    ``time.perf_counter()`` stamp before the round and after each piece of
    :data:`STEP_SPLIT`."""
    global step_launches, h2d_copies, d2h_copies
    _stamp(split)
    stage = stage_batch(kernel, batch)
    _stamp(split)
    with torch.cuda.device(kernel.device):
        stream = torch.cuda.current_stream(kernel.device)
        stage.dev_in.copy_(stage.host_in, non_blocking=True)
        h2d_copies += 1
        _stamp(split)
        launch_step(kernel, stage, stream)
        step_launches += 1
        _stamp(split)
        stage.host_out.copy_(stage.dev_out, non_blocking=True)
        d2h_copies += 1
        _stamp(split)
        stream.synchronize()
    _stamp(split)
    raw = stage.host_out.numpy().copy()
    out = StepOut(*_views(raw, stage.out_fields, stage.out_offs))
    _stamp(split)
    return out


class LazyArray:
    """One field of a CUDA drain's DrainOut: a view of the drain's pinned
    buffer that ``np.asarray`` returns once the drain's copy has landed
    (``event``); reading the buffer before would race the copy."""

    __slots__ = ("_array", "_event")

    def __init__(self, array: np.ndarray, event):
        self._array, self._event = array, event

    def __array__(self, dtype=None, copy=None):
        self._event.synchronize()
        a = self._array
        if dtype is not None and np.dtype(dtype) != a.dtype:
            return a.astype(dtype)
        return a.copy() if copy else a


def drain_fields(w: int, k: int):
    """The DrainOut's fields (dtype, shape) in its device buffer."""
    return [(np.int64, (w, k)), (np.bool_, (w, k)), (np.bool_, (w,))]


def launch_drain(kernel, dev_out: torch.Tensor, stream) -> None:
    """One launch of the drain kernel on ``stream``, its outputs into
    ``dev_out`` laid out as :func:`drain_fields` (counts nothing)."""
    st, mb = kernel.state, kernel._mb_block
    offs, _ = _layout(drain_fields(kernel.W, kernel.k_events))
    base = dev_out.data_ptr()
    ptrs = (ctypes.c_void_p * _N_DRAIN_PTRS)(
        st.clock.data_ptr(), st.lane_dl.data_ptr(), st.lane_seq.data_ptr(),
        None if mb is None else mb.data_ptr(), *[base + o for o in offs])
    lanes, warps, _ = launch_shape(kernel.W, kernel.cap)
    _launch_status("drain", _lib().madsim_bridge_drain(
        ptrs, _N_DRAIN_PTRS, kernel.W, kernel.cap, kernel.k_events, lanes,
        warps, stream.cuda_stream))


def drain(kernel, split=None) -> DrainOut:
    """One pop-only drain round of ``kernel`` on its CUDA device: one launch
    and one asynchronous copy of its outputs into a pinned buffer of its
    own; nothing is waited for here. ``split``, where given, gets a
    ``time.perf_counter()`` stamp before the drain and after each piece of
    :data:`DRAIN_SPLIT`."""
    global drain_launches, d2h_copies
    _stamp(split)
    _check_state(kernel)
    fields = drain_fields(kernel.W, kernel.k_events)
    offs, n = _layout(fields)
    dev_out = torch.empty(n, dtype=torch.uint8, device=kernel.device)
    host = torch.empty(n, dtype=torch.uint8, pin_memory=True)
    _stamp(split)
    with torch.cuda.device(kernel.device):
        stream = torch.cuda.current_stream(kernel.device)
        launch_drain(kernel, dev_out, stream)
        drain_launches += 1
        _stamp(split)
        host.copy_(dev_out, non_blocking=True)
        d2h_copies += 1
        _stamp(split)
        event = torch.cuda.Event()
        event.record(stream)
    out = DrainOut(*[LazyArray(a, event)
                     for a in _views(host.numpy(), fields, offs)])
    _stamp(split)
    return out


def reset_counts() -> None:
    """Sets the launch and copy counts to 0."""
    global step_launches, drain_launches, h2d_copies, d2h_copies
    step_launches = drain_launches = h2d_copies = d2h_copies = 0


# ---------------------------------------------------------------------------
# The launch's shape, and the kernels' order of work in numpy.
# ---------------------------------------------------------------------------

#: The launch's rule: the most warps a block (the kernels' launch bounds),
#: the blocks the grid aims at (the H100's SMs), the shared memory a block
#: may use (``csrc/bridge_step.cu`` refuses more) and the warps' mbarriers
#: at its head; the fewest lanes a world, the most slots a lane scans and
#: the fewest warps a grid keeps when it gives a world fewer lanes.
MAX_WARPS_PER_BLOCK = 8
TARGET_BLOCKS = 132
SMEM_BUDGET = 48 * 1024
_BAR_BYTES = 8 * MAX_WARPS_PER_BLOCK
MIN_LANES = 8
SLOTS_PER_LANE = 16
MIN_WARPS = 1024
_INT_MAX = (1 << 31) - 1
_U64 = np.uint64


def _seq_rows_at(worlds: int, cap: int) -> int:
    """Where a block's staged seq rows start, in 8-byte words after its
    deadline rows: the first 16-byte boundary (``seq_rows_at``)."""
    return (worlds * (cap + 1) + 1) // 2 * 2


def _smem_bytes(worlds: int, cap: int) -> int:
    return _BAR_BYTES + (_seq_rows_at(worlds, cap) + worlds * (cap + 1)) * 8


@functools.lru_cache(maxsize=None)
def launch_shape(w: int, cap: int):
    """Both kernels' launch shape for ``w`` worlds at ``cap``: ``(lanes a
    world, warps a block, worlds a block)``, passed to each launch. A world
    takes 32 lanes, halved (to 16, then 8) while each lane scans at most
    :data:`SLOTS_PER_LANE` slots and the grid keeps :data:`MIN_WARPS`
    warps; a block 8 warps, halved while the grid would have fewer than
    :data:`TARGET_BLOCKS` blocks or the staged rows would pass
    :data:`SMEM_BUDGET`."""
    g = 32
    while (g > MIN_LANES and cap <= (g // 2) * SLOTS_PER_LANE
           and (w * (g // 2) + 31) // 32 >= MIN_WARPS):
        g //= 2
    n = MAX_WARPS_PER_BLOCK
    while n > 1 and (_smem_bytes(n * (32 // g), cap) > SMEM_BUDGET
                     or -(-w // (n * (32 // g))) < TARGET_BLOCKS):
        n >>= 1
    return g, n, n * (32 // g)


def lane_copy_paths(w: int, cap: int) -> list:
    """Each warp's lane copy, in launch order: ``"bulk"`` (one TMA copy per
    lane array of its worlds' rows: the span's source and its two staged
    destinations start on 16 bytes and its length is a multiple of 16
    bytes; torch's allocations are 16-byte aligned) or ``"async"`` (8-byte
    copies, each world's group of lanes its row). Warps without a world
    have none."""
    g, _, per = launch_shape(w, cap)
    wpw, row = 32 // g, cap + 1
    paths = []
    for b0 in range(0, w, per):
        nw = min(per, w - b0)
        for first in range(0, nw, wpw):
            rows = min(wpw, nw - first)
            words = ((b0 + first) * row, first * row,
                     _seq_rows_at(nw, cap) + first * row, rows * row)
            paths.append("bulk" if all(x % 2 == 0 for x in words)
                         else "async")
    return paths


def _key_less(d, c, i, k):
    kd, kc, ki = k[0], k[1], k[2]
    return (d < kd) | ((d == kd) & ((c < kc) | ((c == kc) & (i < ki))))


def _lane_keys(dl, sq, cap, g):
    """Each of a world's ``g`` lanes' (d, c, i, d2) over its slots sub,
    sub + g, ... of the staged rows ``dl``/``sq`` (W, cap), in the kernel's
    scan order; arrays of shape (W, g)."""
    w = dl.shape[0]
    k = [np.full((w, g), INF_NS, np.int64),
         np.full((w, g), INF_NS, np.int64),
         np.full((w, g), _INT_MAX, np.int64),
         np.full((w, g), INF_NS, np.int64)]
    for base in range(0, cap, g):
        idx = base + np.arange(g)
        has = idx < cap
        at = np.minimum(idx, cap - 1)
        d = np.where(has, dl[:, at], INF_NS)
        c = np.where(has, sq[:, at], INF_NS)
        i = np.where(has, idx, _INT_MAX)[None, :]
        take = _key_less(d, c, i, k) & has
        k[3] = np.where(take, np.minimum(k[3], k[0]),
                        np.where(has, np.minimum(k[3], d), k[3]))
        k[0] = np.where(take, d, k[0])
        k[1] = np.where(take, c, k[1])
        k[2] = np.where(take, i, k[2])
    return k


def _group_key(k):
    """The xor-shuffle reduction of a world's lanes' keys (offsets g/2 to
    1), d2 included; every lane ends with the group's least key. Returns
    lane 0's (d, c, i, d2), arrays of shape (W,)."""
    d, c, i, d2 = [x.copy() for x in k]
    g = d.shape[1]
    lane = np.arange(g)
    off = g // 2
    while off:
        o = lane ^ off
        off //= 2
        od, oc, oi, o2 = d[:, o], c[:, o], i[:, o], d2[:, o]
        take = _key_less(od, oc, oi, (d, c, i))
        d2 = np.minimum(np.minimum(d2, o2), np.where(take, d, od))
        d, c, i = (np.where(take, od, d), np.where(take, oc, c),
                   np.where(take, oi, i))
    return d[:, 0], c[:, 0], i[:, 0], d2[:, 0]


def _pops(dl, sq, clock, first, mine, cap, k):
    """The kernels' pops on the staged rows (changed in place): returns
    the (W, k) slots, seqs and validity, the pops fired and more_due."""
    w = dl.shape[0]
    rows = np.arange(w)
    slot = np.zeros((w, k), np.int32)
    seq = np.zeros((w, k), np.int64)
    valid = np.zeros((w, k), bool)
    fired = np.zeros((w,), np.int64)
    more = np.zeros((w,), bool)
    going = np.ones((w,), bool)      # every pop so far was due
    r = first
    for e in range(k):
        if e > 0:
            r = _group_key(mine)
        d, c, i, d2 = r
        tie = c == INF_NS
        j = np.where(tie, 0, i)
        s = np.where(tie, sq[:, 0], c)
        due = d <= clock
        fill = going[:, None] & (np.arange(k)[None, :] >= e) & (
            (np.arange(k)[None, :] == e) | ~due[:, None])
        slot = np.where(fill, j[:, None], slot)
        seq = np.where(fill, s[:, None], seq)
        valid = np.where(fill, due[:, None], valid)
        going &= due
        fired += going
        hit = rows[going]
        dl[hit, j[going]] = INF_NS
        if e == k - 1:
            more = going & (np.where(j == i, d2, d) <= clock)
        # Only the lane that owns the popped slot rescans its slots.
        g = mine[0].shape[1]
        fresh = _lane_keys(dl[hit], sq[hit], cap, g)
        owner = (np.arange(g)[None, :] == (j[going] % g)[:, None])
        for x, y in zip(mine, fresh):
            x[hit] = np.where(owner, y, x[hit])
    return slot, seq, valid, fired, more


def _sends(batch, k0, k1, cap):
    """Each send's draws and delivery: (ok, lost, slot or -1, when)."""
    mask = np.asarray(batch.s_mask, bool)
    ctr = np.asarray(batch.s_ctr).astype(_U64)
    ctr1 = ctr + _U64(1)
    m32 = _U64(0xFFFFFFFF)
    kk0 = np.asarray(k0)[:, None].astype(np.uint32)
    kk1 = np.asarray(k1)[:, None].astype(np.uint32)
    a0, a1 = threefry2x32_np(kk0, kk1, (ctr & m32).astype(np.uint32),
                             (ctr >> _U64(32)).astype(np.uint32))
    b0, b1 = threefry2x32_np(kk0, kk1, (ctr1 & m32).astype(np.uint32),
                             (ctr1 >> _U64(32)).astype(np.uint32))
    u_loss = (a1.astype(_U64) << _U64(32)) | a0.astype(_U64)
    u_lat = (b1.astype(_U64) << _U64(32)) | b0.astype(_U64)
    lost_raw = (u_loss < np.asarray(batch.s_thr).astype(_U64)) | np.asarray(
        batch.s_lossall, bool)
    ok = mask & ~lost_raw
    lost = mask & lost_raw
    s_slot = np.asarray(batch.s_slot).astype(np.int64)
    deliver = ok & np.asarray(batch.s_live, bool) & (s_slot >= 0) & (
        s_slot < cap)
    lat_w = np.asarray(batch.s_lat_w).astype(np.int64).view(_U64)
    lat_w = np.where(deliver, lat_w, _U64(1))
    when = (np.asarray(batch.s_base).astype(np.int64).view(_U64)
            + np.asarray(batch.s_lat_lo).astype(np.int64).view(_U64)
            + u_lat % lat_w).view(np.int64)
    when = np.minimum(when, TIMER_MAX_NS)
    return ok, lost, np.where(deliver, s_slot, -1), when


def bridge_model(clock, lane_dl, lane_seq, net_k0, net_k1, batch=None, *,
                 cap: int, k_events: int, mb=None):
    """One round (``batch`` a HostBatch) or one drain (``batch`` None) in
    the kernels' order of work, on numpy copies: the worlds grouped into
    blocks and warps as the launch groups them (:func:`launch_shape`),
    their rows of ``lane_dl`` and ``lane_seq`` staged, the batch's cancels,
    timers and sends written to the staged rows in that order, then the
    pops, each one reduction of the fused keys ``(dl, seq, index)`` of the
    world's lanes, merged in the shuffles' order, the advance's min from
    the first and more_due from the last (which carries the least deadline
    of the other slots). Returns ``(clock', lane_dl', lane_seq', mb', out,
    stats)``: ``out`` a StepOut or DrainOut of numpy arrays, ``mb`` the
    (6, W) metrics block or None, the dump column of the lanes untouched;
    ``stats`` the grid (lanes a world, worlds a block, blocks, the warps
    of each lane copy). Equal to
    :func:`~madsim_tpu_torch.bridge.kernel.step_plain` and
    :func:`~madsim_tpu_torch.bridge.kernel.drain_plain`."""
    w, k = len(clock), int(k_events)
    g, _, per = launch_shape(w, cap)
    paths = lane_copy_paths(w, cap)
    stats = dict(lanes_per_world=g, worlds_per_block=per,
                 blocks=-(-w // per), bulk_warps=paths.count("bulk"),
                 async_warps=paths.count("async"))
    lane_dl = np.array(lane_dl, np.int64, copy=True)
    lane_seq = np.array(lane_seq, np.int64, copy=True)
    old_clock = np.asarray(clock, np.int64)
    mb = None if mb is None else np.array(mb, np.int64, copy=True)
    # The staged rows (the dump column is staged and never read).
    dl, sq = lane_dl[:, :cap], lane_seq[:, :cap]
    rows = np.arange(w)[:, None]
    if batch is None:
        clock = old_clock.copy()
    else:
        b = batch
        c_mask = np.asarray(b.c_mask, bool)
        c_slot = np.asarray(b.c_slot).astype(np.int64)
        hit = c_mask & (c_slot >= 0) & (c_slot < cap)
        dl[np.broadcast_to(rows, hit.shape)[hit], c_slot[hit]] = INF_NS
        t_mask = np.asarray(b.t_mask, bool)
        t_slot = np.asarray(b.t_slot).astype(np.int64)
        hit = t_mask & (t_slot >= 0) & (t_slot < cap)
        r = np.broadcast_to(rows, hit.shape)[hit]
        dl[r, t_slot[hit]] = np.asarray(b.t_dl, np.int64)[hit]
        sq[r, t_slot[hit]] = np.asarray(b.t_seq, np.int64)[hit]
        ok, lost, s_slot, when = _sends(b, net_k0, net_k1, cap)
        hit = s_slot >= 0
        r = np.broadcast_to(rows, hit.shape)[hit]
        dl[r, s_slot[hit]] = when[hit]
        sq[r, s_slot[hit]] = np.asarray(b.s_seq, np.int64)[hit]
    mine = _lane_keys(dl, sq, cap, g)
    first = _group_key(mine)
    if batch is not None:
        has_timer = first[0] < INF_NS
        advance = np.asarray(b.advance, bool)
        clock_in = np.asarray(b.clock, np.int64)
        nxt = (first[0].view(_U64) + _U64(_EPSILON_NS)).view(np.int64)
        clock = np.where(advance & has_timer, np.maximum(nxt, clock_in),
                         clock_in)
    slot, seq, valid, fired, more = _pops(dl, sq, clock, first, mine, cap,
                                          k)
    if mb is not None:
        mb[4] += fired
        if batch is not None:
            mb[0] += t_mask.sum(1)
            mb[1] += c_mask.sum(1)
            mb[2] += np.asarray(b.s_mask, bool).sum(1)
            mb[3] += lost.sum(1)
            mb[5] = (mb[5].view(_U64) + (clock.view(_U64)
                                         - old_clock.view(_U64))).view(
                np.int64)
    if batch is None:
        out = DrainOut(event_seq=seq, event_valid=valid, more_due=more)
    else:
        out = StepOut(clock=clock.copy(), deadlock=advance & ~has_timer,
                      send_ok=ok, event_slot=slot, event_seq=seq,
                      event_valid=valid, more_due=more)
    return clock, lane_dl, lane_seq, mb, out, stats
