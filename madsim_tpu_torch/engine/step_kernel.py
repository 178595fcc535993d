"""The engine step as one hand-written CUDA kernel (``csrc/step_kernel.cu``).

Replaces ``madsim_tpu/engine/pallas_step.py::make_pallas_step``, the JAX
package's one Pallas kernel: one whole engine step for every world per
launch — the eligible first-min pop, fault apply or the Raft merged
handler, the 2·M Threefry draws for latency and loss, the rank-ordered
insert with the pop's clear fused in, the invariant and the step's
bookkeeping. Like the Pallas kernel (``input_output_aliases``), it
**updates the state tensors in place**: :func:`run_steps` returns the
state it was given.

Design: one thread per world, ``EngineConfig.block`` worlds per block.
Each thread reads its world's rows in global memory, runs the whole step
for that world with Raft compiled in, and writes back in place. Sizes are
runtime ints under the static maxima below; the wrapper raises beyond them.

Bound: memory. Reading and writing the whole world state once per step
would take 2 × state bytes / 3.35 TB/s — for the headline deployment
(926 B/world, W = 524,288: 486 MB) about 0.29 ms on an H100 — but a step
touches only part of each world: the queue's time and meta lanes, one
payload row, the destination's rows and the invariant's log lanes, about
360 B of a headline world's 926 B. ``chip_smoke.py`` counts those bytes
for its bound. What one thread per world leaves on the table: a world's
rows are contiguous, so neighbouring threads read addresses a whole row
apart (uncoalesced); the per-thread outbox lives in local memory (ptxas
reports a ~0.8 KB stack frame), zeroed and read back every step; and a
frozen world still costs a thread every step. A world-minor layout, a warp
per world, an outbox that never materializes, and many steps per launch
are the later fixes.

On CPU tensors :func:`run_steps` runs the plain step
(:meth:`DeviceEngine.step_plain`) instead; on CUDA tensors it always
launches the kernel, or raises.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..ops.threefry import threefry2x32_torch
from .core import tree_leaves
from .raft_actor import WON_WORDS, RaftActor

#: Kernel launches so far (the step kernel); a plain integer.
launches = 0

# Static maxima of the kernel's per-thread arrays (csrc/step_kernel.cu).
MAX_N, MAX_Q, MAX_L, MAX_P = 8, 256, 64, 16
MAX_M = MAX_N + 1


def _lib():
    lib = _build.load("step_kernel")
    if not getattr(lib, "_madsim_typed", False):
        lib.madsim_step.argtypes = [ctypes.POINTER(ctypes.c_void_p),
                                    ctypes.POINTER(ctypes.c_int),
                                    ctypes.c_int, ctypes.c_void_p]
        lib.madsim_step.restype = ctypes.c_int
        lib.madsim_threefry.argtypes = [ctypes.c_void_p] * 6 + [
            ctypes.c_int, ctypes.c_void_p]
        lib.madsim_threefry.restype = ctypes.c_int
        lib._madsim_typed = True
    return lib


def _check_status(status: int, what: str):
    if status != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error "
                           f"{status}")


def kernel_params(eng):
    """The kernel's int parameter vector for this engine (raises on a
    configuration the kernel does not take)."""
    cfg, actor = eng.cfg, eng.actor
    if not isinstance(actor, RaftActor):
        raise NotImplementedError(
            "the CUDA step kernel has Raft compiled in; other actor "
            "families are ROADMAP Queue B g")
    if not cfg.packed:
        raise NotImplementedError(
            "the CUDA step kernel covers the packed lane profile only; "
            "packed=False on CUDA is ROADMAP Queue B f")
    r = actor.rcfg
    n, q, p, L = cfg.n_nodes, cfg.queue_cap, cfg.payload_words, r.log_cap
    if not (n <= MAX_N and q <= MAX_Q and p <= MAX_P and L <= MAX_L):
        raise ValueError(
            f"the CUDA step kernel takes n_nodes <= {MAX_N}, queue_cap <= "
            f"{MAX_Q}, payload_words <= {MAX_P}, log_cap <= {MAX_L}; got "
            f"{n}, {q}, {p}, {L}")
    if cfg.m != n + 1 or cfg.m > MAX_M:
        raise ValueError("the CUDA step kernel needs outbox_cap == n + 1")
    if not 0 < cfg.block <= 1024:
        raise ValueError("pallas_block (worlds per CUDA block) must be in "
                         "[1, 1024]")
    return [n, q, p, L, WON_WORDS, int(cfg.t_limit_us), int(cfg.stop_on_bug),
            r.elect_min_us, r.elect_max_us, r.heartbeat_us,
            int(r.buggy_double_vote)]


def check_leaves(eng, leaves):
    """Raise unless ``leaves`` are contiguous CUDA tensors on one device,
    with the dtypes and shapes of the engine's state layout
    (:meth:`DeviceEngine.state_layout`), which the kernel's ``State``
    struct mirrors."""
    layout = eng.state_layout()
    if len(leaves) != len(layout):
        raise ValueError(f"the step kernel takes {len(layout)} state "
                         f"leaves, got {len(leaves)}")
    w = leaves[0].shape[0]
    dev = leaves[0].device
    for (name, dtype, shape), x in zip(layout, leaves):
        if x.device != dev or x.device.type != "cuda":
            raise ValueError(f"leaf {name} is on {x.device}; the kernel "
                             f"takes CUDA tensors on one device")
        if x.dtype != dtype or tuple(x.shape) != (w,) + shape:
            raise ValueError(f"leaf {name}: expected {dtype} "
                             f"{(w,) + shape}, got {x.dtype} "
                             f"{tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"leaf {name} is not contiguous")


def launch(eng, leaves, k: int = 1):
    """Launch the step kernel ``k`` times over ``leaves`` (checked once),
    in place, on the current stream. Each launch is one step."""
    global launches
    params = kernel_params(eng)
    check_leaves(eng, leaves)
    w = leaves[0].shape[0]
    if w == 0:
        return
    lib = _lib()
    ptrs = (ctypes.c_void_p * len(leaves))(*[x.data_ptr() for x in leaves])
    ints = (ctypes.c_int * (len(params) + 1))(w, *params)
    stream = torch.cuda.current_stream(leaves[0].device).cuda_stream
    with torch.cuda.device(leaves[0].device):
        for _ in range(k):
            _check_status(lib.madsim_step(ptrs, ints, eng.cfg.block, stream),
                          "step kernel")
            launches += 1


def run_steps(eng, state, k: int):
    """``k`` engine steps of every world, updating ``state`` in place and
    returning it. CUDA tensors: ``k`` kernel launches. CPU tensors: the
    plain step (:meth:`DeviceEngine.step_plain`), copied back into
    ``state``."""
    leaves = tree_leaves(state)
    if leaves[0].device.type != "cpu":
        launch(eng, leaves, k)
        return state
    cur = state
    for _ in range(k):
        cur = eng.step_plain(cur)
    if k:
        for dst, src in zip(leaves, tree_leaves(cur)):
            dst.copy_(src)
    return state


def threefry2x32(k0, k1, c0, c1):
    """Threefry-2x32/20 of u32 tensors (same shape, 1-D). CUDA: the test
    kernel exported by ``step_kernel.cu``; CPU: the plain torch version."""
    if k0.device.type == "cpu":
        return threefry2x32_torch(k0, k1, c0, c1)
    xs = [k0, k1, c0, c1]
    n = k0.numel()
    for x in xs:
        if (x.dtype != torch.uint32 or x.dim() != 1 or x.numel() != n
                or not x.is_contiguous() or x.device != k0.device):
            raise ValueError("threefry2x32 takes four contiguous 1-D uint32 "
                             "tensors of one length on one device")
    o0 = torch.empty_like(k0)
    o1 = torch.empty_like(k0)
    if n == 0:
        return o0, o1
    stream = torch.cuda.current_stream(k0.device).cuda_stream
    with torch.cuda.device(k0.device):
        status = _lib().madsim_threefry(*[x.data_ptr() for x in xs],
                                        o0.data_ptr(), o1.data_ptr(), n,
                                        stream)
    _check_status(status, "threefry kernel")
    return o0, o1
