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
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from .kernel import BATCH_DTYPES, DrainOut, HostBatch, StepOut

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
            ctypes.c_void_p]
        lib.madsim_bridge_step.restype = ctypes.c_int
        lib.madsim_bridge_drain.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p]
        lib.madsim_bridge_drain.restype = ctypes.c_int
        lib.madsim_bridge_warps.argtypes = [ctypes.c_int]
        lib.madsim_bridge_warps.restype = ctypes.c_int
        lib._madsim_typed = True
    return lib


def warps_per_block(cap: int) -> int:
    """Worlds (one warp each) per block of both kernels at ``cap``."""
    return int(_lib().madsim_bridge_warps(int(cap)))


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
    _launch_status("step", _lib().madsim_bridge_step(
        ptrs, _N_STEP_PTRS, kernel.W, kernel.cap, kernel.k_events, stage.t,
        stage.c, stage.s, stream.cuda_stream))


def step(kernel, batch: HostBatch) -> StepOut:
    """One lockstep round of ``kernel`` on its CUDA device: stage the
    batch, one copy in, one launch, one copy out, the StepOut back as
    fresh numpy arrays."""
    global step_launches, h2d_copies, d2h_copies
    stage = stage_batch(kernel, batch)
    with torch.cuda.device(kernel.device):
        stream = torch.cuda.current_stream(kernel.device)
        stage.dev_in.copy_(stage.host_in, non_blocking=True)
        h2d_copies += 1
        launch_step(kernel, stage, stream)
        step_launches += 1
        stage.host_out.copy_(stage.dev_out, non_blocking=True)
        d2h_copies += 1
        stream.synchronize()
    raw = stage.host_out.numpy().copy()
    return StepOut(*_views(raw, stage.out_fields, stage.out_offs))


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
    _launch_status("drain", _lib().madsim_bridge_drain(
        ptrs, _N_DRAIN_PTRS, kernel.W, kernel.cap, kernel.k_events,
        stream.cuda_stream))


def drain(kernel) -> DrainOut:
    """One pop-only drain round of ``kernel`` on its CUDA device: one launch
    and one asynchronous copy of its outputs into a pinned buffer of its
    own; nothing is waited for here."""
    global drain_launches, d2h_copies
    _check_state(kernel)
    fields = drain_fields(kernel.W, kernel.k_events)
    offs, n = _layout(fields)
    dev_out = torch.empty(n, dtype=torch.uint8, device=kernel.device)
    host = torch.empty(n, dtype=torch.uint8, pin_memory=True)
    with torch.cuda.device(kernel.device):
        stream = torch.cuda.current_stream(kernel.device)
        launch_drain(kernel, dev_out, stream)
        drain_launches += 1
        host.copy_(dev_out, non_blocking=True)
        d2h_copies += 1
        event = torch.cuda.Event()
        event.record(stream)
    return DrainOut(*[LazyArray(a, event)
                      for a in _views(host.numpy(), fields, offs)])


def reset_counts() -> None:
    """Sets the launch and copy counts to 0."""
    global step_launches, drain_launches, h2d_copies, d2h_copies
    step_launches = drain_launches = h2d_copies = d2h_copies = 0
