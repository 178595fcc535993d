"""The engine step as one hand-written CUDA kernel (``csrc/step_kernel.cuh``).

Replaces ``madsim_tpu/engine/pallas_step.py::make_pallas_step``, the JAX
package's one Pallas kernel: one whole engine step for every world per
launch — the eligible first-min pop, fault apply or the actor's merged
handler, the Threefry draws for latency and loss, the rank-ordered insert
with the pop's clear fused in, the invariant and the step's bookkeeping.
The kernel's skeleton is a template on the actor family's policy, written
by hand per family: Raft (``csrc/actor_raft.cuh``), two-phase commit
(``actor_tpc.cuh``), primary-backup (``actor_pb.cuh``), multi-decree Paxos
(``actor_paxos.cuh``) and the two pair-restart families of the guided
search (``actor_pair.cuh``, one policy with the beacon as a parameter),
each built from its own source (``csrc/step_{raft,tpc,pb,paxos,pair}.cu``)
into a library of its own. :data:`FAMILIES` holds one record per family.
Every policy is instantiated in both lane profiles (``EngineConfig.packed``):
packed (int8 node ids and codes, int16 slots and payload words, saturating
writes) and wide (every such lane int32, plain writes); the skeleton and
the policies are templates on the profile.

Every launch reads a gate word (an int32 on the device) and returns at
once, changing nothing, where it is set: the device-side loops
(:meth:`DeviceEngine.superstep`, the fused hunt) set the gate between
launches so that launches queued past their stop point change nothing;
every other launch points it at a zero word of its device.
Like the Pallas kernel (``input_output_aliases``), it **updates the state
tensors in place**: :func:`run_steps` returns the state it was given.

Design: one thread per world, a block of B worlds. The lanes a step reads
whole — the queue's time and meta lanes (the pop scans every slot) and
Raft's invariant lanes, commit and log — are staged through shared memory
(the other families' lanes are small and read once a step, in device
memory): the
block copies its contiguous range of each lane in with coalesced
asynchronous copies (``cp.async``), one padded row per world, while each
thread reads its world's scalars into registers; each thread then steps
its world over its rows there, and the block writes back, coalesced, only
the 16-byte chunks of the queue rows that changed. A block with no active
world copies no queue tile. The outbox is never built: each send is
generated, drawn for and inserted in turn, so the kernel uses no local
memory. :func:`tile_plan` sizes the tiles: B, the padded row strides (the
queue tiles' rows an odd number of 16-byte chunks, so that the eight
threads of a quarter warp reading 16 bytes each hit all 32 banks; an int16
stride of 2 mod 4 for the others, so that 32 threads reading one int16
each hit 32 banks), the access widths and the shared-memory offsets. It
raises :class:`ValueError` where no block of :data:`MIN_BLOCK` worlds fits
in :data:`SMEM_MAX` bytes.

Bound: memory. A step must read the queue's time lane of every world it
steps, its meta lane where a node is paused, what the invariant reads
(Raft: the commit row and the log entries over each node pair's committed
prefix), besides one payload row and the handler's rows;
``chip_smoke.py`` (``needed_bytes``) counts those bytes for its bound.
Sizes are runtime ints under the static maxima below; the wrapper raises
beyond them.

With ``EngineConfig(metrics=True)`` and ``EngineConfig(blackbox=K)`` the
kernel also writes what the plain step writes into the metrics block and
the flight-recorder ring: a few int32 read-modify-writes and one ring
record per active world and step, straight to device memory (the lanes are
written only, so they take no tile). Their pointers follow the base leaves
in the kernel's ``State``, looked up by leaf name (:func:`kernel_pointers`)
and null when off.

On CPU tensors :func:`run_steps` runs the plain step
(:meth:`DeviceEngine.step_plain`) instead; on CUDA tensors it always
launches the kernel, or raises.
"""
from __future__ import annotations

import ctypes
from typing import Any, Callable, NamedTuple, Optional

import torch

from .. import _build
from ..obs.blackbox import RING_FIELDS
from ..obs.metrics import BLOCK_FIELDS
from ..ops.threefry import threefry2x32_torch
from .core import DEFAULT_BLOCK, tree_leaves
from .pb_actor import PBActor
from .raft_actor import WON_WORDS, RaftActor
from .tpc_actor import TPCActor

#: Kernel launches so far (the step kernel); a plain integer.
launches = 0
#: One int32 zero per device: the gate of a launch that is never gated.
_open_gates: dict = {}

# Static maxima of the kernel (csrc/step_common.cuh; MAX_L is Raft's log,
# csrc/actor_raft.cuh). Each family takes up to its record's max_n nodes.
MAX_N, MAX_Q, MAX_L, MAX_P = 12, 256, 64, 16
#: The optional leaves the kernel writes, in its State's order after the
#: base leaves: the metrics block, then the flight-recorder ring (null
#: pointers when off).
OPTIONAL_LEAVES = (tuple("metrics." + f for f in BLOCK_FIELDS)
                   + tuple("blackbox." + f for f in RING_FIELDS))
#: Shared memory one block may use on sm_90 (227 KB).
SMEM_MAX = 232_448
#: The fewest worlds per block a tile plan accepts: one warp.
MIN_BLOCK = 32


class TilePlan(NamedTuple):
    """How a block of worlds lays out its shared-memory tiles.

    Strides are per world row, in elements: ``q_stride`` int32 of the
    q_time and q_meta tiles (an odd number of 16-byte chunks, which the pop
    reads four slots at a time), ``commit_stride`` of the commit tile and
    ``log_stride`` of each of the log_term and log_cmd tiles in the
    profile's slot elements: int16 packed (2 mod 4, an odd number of
    4-byte words), int32 wide (odd). The ``*_unit`` fields are
    the widest global access, in bytes, that a lane's rows allow (the
    launch narrows them to the tensors' alignment); a ``pay_unit`` of 16
    moves payload rows as 16-byte vectors. ``off_*`` are byte offsets in
    dynamic shared memory (the q_time tile is at 0; ``dirty`` holds each
    world's mask of changed queue chunks). The commit and log tiles are
    Raft's; a plan for another family has none (their strides and widths
    0).
    """

    block: int
    smem_bytes: int
    q_stride: int
    commit_stride: int
    log_stride: int
    q_unit: int
    commit_unit: int
    log_unit: int
    pay_unit: int
    off_qm: int
    off_dirty: int
    off_commit: int
    off_lt: int
    off_lc: int


def _i16_stride(row: int) -> int:
    """The least int16 row stride >= ``row`` that is 2 mod 4: rows start on
    4-byte words an odd number of words apart."""
    return row + (2 - row) % 4


def _i32_stride(row: int) -> int:
    """The least odd int32 row stride >= ``row``: rows an odd number of
    4-byte words apart."""
    return row | 1


def _layout(block, q_stride, commit_stride, log_stride, e=2):
    """Byte offsets of the six tiles and the bytes they take, each tile
    starting on 16 bytes (``e`` bytes per commit and log element)."""
    sizes = (block * q_stride * 4, block * q_stride * 4, block * 8,
             block * commit_stride * e, block * log_stride * e,
             block * log_stride * e)
    offs, at = [], 0
    for size in sizes:
        offs.append(at)
        at += -(-size // 16) * 16
    return offs, at


def tile_plan(cfg, log_cap: Optional[int]) -> TilePlan:
    """The tile plan for an engine config and the Raft log capacity (None
    for a family without Raft's commit and log tiles).

    ``cfg.pallas_block`` worlds per block where it is set (raises if they
    do not fit); else :data:`DEFAULT_BLOCK`, lowered by warps to what fits.
    """
    n, q, p = cfg.n_nodes, cfg.queue_cap, cfg.payload_words
    L = log_cap or 0
    # The commit and log tiles' elements: int16 packed, int32 wide.
    e = 2 if cfg.packed else 4
    stride = _i16_stride if cfg.packed else _i32_stride
    q_stride = 4 * (-(-q // 4) | 1)
    commit_stride = stride(n) if log_cap else 0
    log_stride = stride(n * L) if log_cap else 0

    def smem(b):
        return _layout(b, q_stride, commit_stride, log_stride, e)[1]

    what = (f"n_nodes={n}, queue_cap={q}"
            + (f", log_cap={L}" if log_cap else ""))
    if cfg.pallas_block is not None:
        block = cfg.pallas_block
        if smem(block) > SMEM_MAX:
            raise ValueError(
                f"pallas_block={block}: a block's tiles for {what} take "
                f"{smem(block)} bytes of shared memory, more than "
                f"{SMEM_MAX}")
    else:
        block = DEFAULT_BLOCK
        while block > MIN_BLOCK and smem(block) > SMEM_MAX:
            block = max(MIN_BLOCK, (block - 1) // 32 * 32)
        if smem(block) > SMEM_MAX:
            raise ValueError(
                f"no block of {MIN_BLOCK} worlds fits in {SMEM_MAX} bytes of "
                f"shared memory for {what}: it needs {smem(block)}")
    offs, total = _layout(block, q_stride, commit_stride, log_stride, e)
    if cfg.packed:
        commit_unit = 4 if n % 2 == 0 else 2
        log_unit = 4 if (n * L) % 2 == 0 else 2
        # Eight int16 words a 16-byte vector.
        pay_unit = 16 if p % 8 == 0 else 2
    else:
        commit_unit = log_unit = 4
        # Two 16-byte vectors of four int32 words each.
        pay_unit = 16 if p % 4 == 0 and p >= 8 else 2
    return TilePlan(
        block=block, smem_bytes=total, q_stride=q_stride,
        commit_stride=commit_stride, log_stride=log_stride,
        q_unit=16 if q % 4 == 0 else 4,
        commit_unit=commit_unit if log_cap else 0,
        log_unit=log_unit if log_cap else 0,
        pay_unit=pay_unit,
        off_qm=offs[1], off_dirty=offs[2], off_commit=offs[3],
        off_lt=offs[4], off_lc=offs[5])


class KernelFamily(NamedTuple):
    """One actor family's route through the kernel: its record, as its
    policy (``csrc/actor_<route>.cuh``) declares it."""

    name: str
    #: The policy: csrc/actor_<route>.cuh (two families may share one).
    route: str
    #: Params::family (``csrc/step_common.cuh``).
    id: int
    #: ``csrc/<source>.cu`` instantiates ``step_kernel<Policy, N>``.
    source: str
    #: The node counts it takes: ``step_entry<Policy, least_n>`` in the
    #: source, up to the policy's MAX_NODES.
    least_n: int
    max_n: int
    #: The actor's class, imported when a kernel call needs it.
    actor: Callable[[], type]
    #: actor -> its static parameters, Params::f0.. (the policy names them).
    params: Callable[[Any], tuple]
    #: Its policy's Lanes struct, (name, dtype) in JAX's leaf order (sorted
    #: names) and the packed profile's dtypes; None where the actor's state
    #: type fixes them (Raft).
    lanes: Optional[tuple]
    #: The log capacity that sizes Raft's commit and log tiles; None for a
    #: family without them.
    log_cap: Callable[[Any], Optional[int]] = lambda actor: None
    #: The outbox rows the policy sends from, for n nodes (its ``m(N)``):
    #: a message per node and the timer, or the pair families' two rows.
    outbox: Callable[[int], int] = lambda n: n + 1
    #: The fewest payload words it takes: 8, or Paxos's 5 (the policy's
    #: SHORT_PAYLOAD, whose rows are read and written only up to P).
    min_p: int = 8


def _paxos_actor():
    from ..actorc.families.paxos import PaxosActor

    return PaxosActor


def _pair_restart_actor():
    from ..triage.synthetic import PairRestartActor

    return PairRestartActor


def _guided_pair_actor():
    from ..search.family import GuidedPairActor

    return GuidedPairActor


_I16, _I32 = torch.int16, torch.int32
_PAXOS_TABLE = ("acc_bal", "acc_val", "chosen", "promised", "prop_bal",
                "prop_val", "seen_bal", "seen_val")

#: The kernel's routes, one record per actor family.
FAMILIES = (
    KernelFamily(
        "raft", "raft", 0, "step_raft", 1, 8, lambda: RaftActor,
        lambda a: (a.rcfg.log_cap, WON_WORDS, a.rcfg.elect_min_us,
                   a.rcfg.elect_max_us, a.rcfg.heartbeat_us,
                   a.rcfg.buggy_double_vote),
        None, lambda a: a.rcfg.log_cap),
    KernelFamily(
        "tpc", "tpc", 1, "step_tpc", 2, 8, lambda: TPCActor,
        lambda a: (a.tcfg.n_txns, a.tcfg.txn_start_us,
                   a.tcfg.txn_interval_us, a.tcfg.vote_timeout_us,
                   a.tcfg.no_vote_num, a.tcfg.buggy_presumed_commit),
        (("aborts", _I32), ("commits", _I32), ("decided", torch.int8),
         ("decision", torch.int8), ("txns_seen", _I32),
         ("voted", torch.int8), ("votes_yes", _I32))),
    KernelFamily(
        "pb", "pb", 2, "step_pb", 1, 8, lambda: PBActor,
        lambda a: (a.pcfg.log_cap, a.pcfg.heartbeat_us,
                   a.pcfg.watchdog_min_us, a.pcfg.watchdog_max_us,
                   a.pcfg.n_writes, a.pcfg.write_start_us,
                   a.pcfg.write_interval_us, a.pcfg.buggy_commit_early),
        (("acks", _I32), ("commit", _I16), ("committed_cmd", _I16),
         ("committed_max", _I16), ("log_cmd", _I16), ("log_len", _I16),
         ("view", _I16), ("views_changed", _I32), ("wd_epoch", _I16),
         ("writes_done", _I32))),
    KernelFamily(
        "paxos", "paxos", 3, "step_paxos", 1, 8, _paxos_actor,
        lambda a: (a.xcfg.n_slots, a.xcfg.retry_min_us,
                   a.xcfg.retry_max_us,
                   int(a.xcfg.buggy_forgetful_acceptor)
                   | int(a.xcfg.contend_all) << 1,
                   a.xcfg.cmd_start_us, a.xcfg.cmd_interval_us,
                   a.xcfg.contend_slot, a.xcfg.contend_gap_us),
        tuple(sorted([(k, _I16) for k in _PAXOS_TABLE]
                     + [(k, _I32) for k in ("accepts", "chosen_count",
                                            "promises", "proposals",
                                            "retries")])), min_p=5),
    KernelFamily(
        "pair_restart", "pair", 4, "step_pair", 1, 12, _pair_restart_actor,
        lambda a: (a.acfg.node_a, a.acfg.node_b, 0),
        (("restarts", _I32),), outbox=lambda n: 2),
    KernelFamily(
        "guided_pair", "pair", 4, "step_pair", 1, 12, _guided_pair_actor,
        lambda a: (a.acfg.node_a, a.acfg.node_b, 1),
        (("restarts", _I32),), outbox=lambda n: 2),
)

#: Family parameters per launch: Params::f0..f7. (Twelve, in any order,
#: made the Raft and pb instantiations 2-4% slower on an H100: PERF.md.)
N_FAMILY_PARAMS = 8


def family_of(actor) -> KernelFamily:
    """The kernel's record for ``actor`` (one of :data:`FAMILIES`), or
    NotImplementedError for an actor it has no policy for."""
    for fam in FAMILIES:
        if isinstance(actor, fam.actor()):
            return fam
    name = getattr(getattr(actor, "spec", None), "name", type(actor).__name__)
    raise NotImplementedError(
        f"the CUDA step kernel has no policy for the {name!r} family: it "
        f"has {', '.join(f.name for f in FAMILIES)} compiled in. The plain "
        f"step runs it with device='cpu'")


def engine_plan(eng) -> TilePlan:
    """The tile plan of ``eng``'s family (Raft's tiles sized by its log)."""
    return tile_plan(eng.cfg, family_of(eng.actor).log_cap(eng.actor))


def _lib(source: str):
    """The built library of ``csrc/<source>.cu``, its ``madsim_step_ex``
    typed."""
    lib = _build.load(source)
    if not getattr(lib, "_madsim_typed", False):
        lib.madsim_step_ex.argtypes = [ctypes.POINTER(ctypes.c_void_p),
                                       ctypes.c_int,
                                       ctypes.POINTER(ctypes.c_int),
                                       ctypes.c_int, ctypes.c_void_p,
                                       ctypes.c_void_p, ctypes.c_int]
        lib.madsim_step_ex.restype = ctypes.c_int
        lib._madsim_typed = True
    return lib


def _check_status(status: int, what: str):
    if status != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error "
                           f"{status}")


def family_params(actor) -> list:
    """The family's static parameters, Params::f0..f7 (each policy in
    ``csrc/actor_*.cuh`` names them)."""
    vals = family_of(actor).params(actor)
    return [int(v) for v in vals] + [0] * (N_FAMILY_PARAMS - len(vals))


def family_lanes(fam: KernelFamily, packed: bool) -> Optional[tuple]:
    """The family policy's lanes, ``(name, dtype)``, in a lane profile:
    :attr:`KernelFamily.lanes` packed, every lane int32 wide."""
    if fam.lanes is None or packed:
        return fam.lanes
    return tuple((name, _I32) for name, _ in fam.lanes)


def kernel_params(eng):
    """The kernel's int parameters for this engine after W (N, Q, P, the
    family, t_limit_us, stop_on_bug, :func:`family_params`); raises on a
    configuration the kernel does not take."""
    cfg, actor = eng.cfg, eng.actor
    fam = family_of(actor)
    n, q, p = cfg.n_nodes, cfg.queue_cap, cfg.payload_words
    if not (fam.least_n <= n <= fam.max_n and q <= MAX_Q
            and fam.min_p <= p <= MAX_P):
        raise ValueError(
            f"the CUDA step kernel takes {fam.least_n} <= n_nodes <= "
            f"{fam.max_n} for {fam.name}, queue_cap <= {MAX_Q}, "
            f"{fam.min_p} <= payload_words <= {MAX_P}; got {n}, {q}, {p}")
    log_cap = fam.log_cap(actor)
    if log_cap is not None and log_cap > MAX_L:
        raise ValueError(f"the CUDA step kernel takes log_cap <= {MAX_L}; "
                         f"got {log_cap}")
    if cfg.m != fam.outbox(n):
        raise ValueError(f"the CUDA step kernel's {fam.name} policy sends "
                         f"from outbox_cap == {fam.outbox(n)} rows; got "
                         f"{cfg.m}")
    if fam.lanes is not None:
        lanes = tuple((name[len("astate."):], dtype) for name, dtype, _
                      in eng.state_layout() if name.startswith("astate."))
        want = family_lanes(fam, cfg.packed)
        if lanes != want:
            raise ValueError(f"the {fam.name} actor's lanes {lanes} are not "
                             f"the kernel's {want}")
    if not 0 < cfg.block <= 1024:
        raise ValueError("pallas_block (worlds per CUDA block) must be in "
                         "[1, 1024]")
    return [n, q, p, fam.id, int(cfg.t_limit_us), int(cfg.stop_on_bug),
            *family_params(actor)]


def kernel_pointers(eng, leaves):
    """The kernel's State pointers: the base leaves in leaf order (the
    actor's lanes among them, in JAX's order: a compiled actor's sorted by
    name), then each of :data:`OPTIONAL_LEAVES`, looked up by name in
    :meth:`DeviceEngine.state_layout` (0 where the lane is off)."""
    names = [name for name, _, _ in eng.state_layout()]
    lane = dict(zip(names, leaves))
    base = [lane[name].data_ptr() for name in names
            if name not in OPTIONAL_LEAVES]
    return base + [lane[name].data_ptr() if name in lane else 0
                   for name in OPTIONAL_LEAVES]


def _aligned(unit: int, *tensors) -> int:
    """``unit`` halved until every tensor's address is a multiple of it."""
    while any(x.data_ptr() % unit for x in tensors):
        unit //= 2
    return unit


def launch_ints(eng, leaves):
    """``(block, ints)`` for ``madsim_step_ex``: the plan's worlds per block,
    and W, :func:`kernel_params`, the :func:`tile_plan` with its access
    widths narrowed to the leaves' alignment, then the optional lanes
    (metrics on, the kind histogram's width, the ring depth K)."""
    params = kernel_params(eng)
    plan = engine_plan(eng)
    lane = dict(zip((name for name, _, _ in eng.state_layout()), leaves))
    pay_unit = 16 if _aligned(plan.pay_unit,
                              lane["queue.payload"]) == 16 else 2
    if plan.commit_stride:
        commit_unit = _aligned(plan.commit_unit, lane["astate.commit"])
        log_unit = _aligned(plan.log_unit, lane["astate.log_term"],
                            lane["astate.log_cmd"])
    else:
        commit_unit = log_unit = 0
    return plan.block, [
        leaves[0].shape[0], *params, plan.smem_bytes, plan.q_stride,
        plan.commit_stride, plan.log_stride,
        _aligned(plan.q_unit, lane["queue.time"], lane["queue.meta"]),
        commit_unit, log_unit, pay_unit, plan.off_qm, plan.off_dirty,
        plan.off_commit, plan.off_lt, plan.off_lc, int(eng.cfg.metrics),
        int(eng.actor.num_kinds), int(eng.cfg.blackbox)]


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


def launch(eng, leaves, k: int = 1, gate: Optional[torch.Tensor] = None):
    """Launch the step kernel ``k`` times over ``leaves`` (checked once),
    in place, on the current stream. Each launch is one step.

    ``gate``: None, or a CUDA int32 scalar tensor; each launch returns at
    once, changing nothing, where the gate is nonzero when it runs (None
    is a zero word). Either way every launch counts in :data:`launches`."""
    global launches
    check_leaves(eng, leaves)
    block, params = launch_ints(eng, leaves)
    if leaves[0].shape[0] == 0:
        return
    dev = leaves[0].device
    if gate is None:
        gate = _open_gates.get(dev)
        if gate is None:
            gate = _open_gates[dev] = torch.zeros((), dtype=torch.int32,
                                                  device=dev)
    elif (gate.dtype != torch.int32 or gate.numel() != 1
            or gate.device != dev):
        raise ValueError("the step kernel's gate is one int32 on the "
                         "state's device")
    gate_ptr = gate.data_ptr()
    lib = _lib(family_of(eng.actor).source)
    addrs = kernel_pointers(eng, leaves)
    ptrs = (ctypes.c_void_p * len(addrs))(*addrs)
    ints = (ctypes.c_int * len(params))(*params)
    stream = torch.cuda.current_stream(leaves[0].device).cuda_stream
    wide = int(not eng.cfg.packed)
    with torch.cuda.device(leaves[0].device):
        for _ in range(k):
            _check_status(lib.madsim_step_ex(ptrs, len(addrs), ints, block,
                                             stream, gate_ptr, wide),
                          "step kernel")
            launches += 1


def run_steps(eng, state, k: int, gate: Optional[torch.Tensor] = None):
    """``k`` engine steps of every world, updating ``state`` in place and
    returning it. CUDA tensors: ``k`` kernel launches (gated by ``gate``,
    see :func:`launch`). CPU tensors: the plain step
    (:meth:`DeviceEngine.step_plain`), copied back into ``state``, or
    nothing where ``gate`` is nonzero."""
    leaves = tree_leaves(state)
    if leaves[0].device.type != "cpu":
        launch(eng, leaves, k, gate)
        return state
    if gate is not None and int(gate) != 0:
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
    kernel exported by ``step_raft.cu``; CPU: the plain torch version."""
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
    lib = _build.load("step_raft")
    lib.madsim_threefry.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_int, ctypes.c_void_p]
    lib.madsim_threefry.restype = ctypes.c_int
    with torch.cuda.device(k0.device):
        status = lib.madsim_threefry(*[x.data_ptr() for x in xs],
                                        o0.data_ptr(), o1.data_ptr(), n,
                                        stream)
    _check_status(status, "threefry kernel")
    return o0, o1
