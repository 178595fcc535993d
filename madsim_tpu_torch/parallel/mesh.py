"""World-axis splits over torch devices: the port of
``madsim_tpu/parallel/mesh.py``.

Worlds are independent, so a sweep's batch splits along its world axis
into contiguous blocks, one per device of a :class:`Mesh`, and each block
is stepped by launches of its own on its own device. Two topologies, one
rule, as in the JAX package:

- :func:`seed_mesh` — 1-D ``(worlds,)``: every device on one host;
- :func:`multihost_mesh` — 2-D ``(dcn, worlds)``: hosts × devices a host.
  One process splits its device list into host groups, so the cross-host
  reductions run without several machines.

The world axis flattens over every mesh axis either way. A device may
appear more than once: ``seed_mesh(devices=[torch.device("cpu")] * 4)``
splits a batch four ways on the CPU, and ``[torch.device("cuda")] * 4``
four ways on one card. Those blocks are stepped apart, one launch each, as
they would be on four devices; that is how the split runs where there is
one device, as the JAX package's tests force eight CPU devices.

A split batch is a :class:`Sharded`: block ``i`` of every leaf lives on
``mesh.devices.flat[i]``. What the JAX package keeps replicated (the
coverage ledger, the search corpus, the slot→seed index and the per-slot
schedules, which only the refill epochs read whole) the port keeps once,
on the mesh's first device (:attr:`Mesh.lead`).
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..engine.core import tree_map

WORLD_AXIS = "worlds"
DCN_AXIS = "dcn"


def _device(d) -> torch.device:
    """``d`` as a ``torch.device``, a CUDA device with its index (so that
    it compares equal to a tensor's ``.device``)."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """A grid of torch devices with named axes: ``devices`` is a numpy
    object array of ``torch.device``, shaped ``(n,)`` or ``(hosts,
    per_host)``, and ``axis_names`` names its axes. Hashable, so that
    compiled-program caches can key on it as the JAX package's do."""

    def __init__(self, devices, axis_names: Sequence[str]):
        two_d = len(axis_names) == 2
        grid = [list(g) for g in devices] if two_d else [list(devices)]
        if len(axis_names) not in (1, 2) or not grid or not grid[0] \
                or len({len(g) for g in grid}) != 1:
            raise ValueError("a mesh is a non-empty (n,) or (hosts, "
                             "per_host) grid of devices")
        shape = (len(grid), len(grid[0])) if two_d else (len(grid[0]),)
        self.devices = np.empty(shape, dtype=object)
        for i, d in enumerate(x for g in grid for x in g):
            self.devices.flat[i] = _device(d)
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict:
        """Axis name → size."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def lead(self) -> torch.device:
        """The device that holds what the sweep keeps once (the first)."""
        return self.devices.flat[0]

    def _key(self):
        return (self.axis_names, self.devices.shape,
                tuple(str(d) for d in self.devices.flat))

    def __eq__(self, other):
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):
        return (f"Mesh({dict(self.shape)}, devices="
                f"{[str(d) for d in self.devices.flat]})")


def seed_mesh(devices: Optional[Sequence[Any]] = None,
              n_devices: Optional[int] = None) -> Mesh:
    """A 1-D ``(worlds,)`` mesh over ``devices``: by default every CUDA
    device. Without one it raises (there is no CPU fallback): a split on
    the CPU names its devices, ``devices=[torch.device("cpu")] * k``.
    ``n_devices`` keeps the first ``n_devices`` of them."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "seed_mesh() takes every CUDA device by default, and no "
                "CUDA device was found: pass devices=[torch.device('cpu')]"
                " * k to split the world axis k ways on the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(devices, (WORLD_AXIS,))


def multihost_mesh(devices: Optional[Sequence[Any]] = None,
                   n_hosts: Optional[int] = None) -> Mesh:
    """A 2-D ``(dcn, worlds)`` mesh: hosts × devices a host. One process
    splits ``devices`` (by default every CUDA device, as
    :func:`seed_mesh`) evenly into ``n_hosts`` groups (default 2), with
    the JAX package's errors."""
    devices = list(seed_mesh(devices).devices.flat)
    n_hosts = n_hosts or 2
    if len(devices) % n_hosts != 0:
        raise ValueError(
            f"{len(devices)} devices do not split over {n_hosts} hosts")
    per = len(devices) // n_hosts
    groups = [devices[i * per:(i + 1) * per] for i in range(n_hosts)]
    return Mesh(groups, (DCN_AXIS, WORLD_AXIS))


class PartitionSpec(NamedTuple):
    """How an array's leading axis lies on a mesh: split over ``axes``
    (the world axis), or replicated where ``axes`` is empty."""

    axes: tuple


class Sharding(NamedTuple):
    """A :class:`PartitionSpec` on a mesh."""

    mesh: Mesh
    spec: PartitionSpec


def world_spec(mesh: Mesh) -> PartitionSpec:
    """The world axis split over every mesh axis."""
    return PartitionSpec(tuple(mesh.axis_names))


def scalar_spec() -> PartitionSpec:
    """A replicated value (the sweep's control scalars and ledgers: in the
    port, one copy on the mesh's lead device)."""
    return PartitionSpec(())


def world_sharding(mesh: Mesh) -> Sharding:
    """The sharding that splits the leading world axis over the mesh: the
    placement :func:`shard_worlds` gives every leaf of a batched state."""
    return Sharding(mesh, world_spec(mesh))


def _copy_to(x: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """A copy of ``x`` on ``dev`` (uint32 as its int32 bits)."""
    if x.dtype == torch.uint32:
        return x.view(torch.int32).to(dev, copy=True).view(torch.uint32)
    return x.to(dev, copy=True)


def _cat(xs, dev: torch.device) -> torch.Tensor:
    """``xs`` concatenated along the world axis on ``dev``."""
    if xs[0].dtype == torch.uint32:
        return torch.cat([x.view(torch.int32).to(dev) for x in xs]) \
            .view(torch.uint32)
    return torch.cat([x.to(dev) for x in xs])


class Sharded:
    """A batched tree split along its world axis: ``shards[i]`` is the
    ``i``-th contiguous block of worlds, every leaf on
    ``mesh.devices.flat[i]``. Each block owns its memory; on a one-device
    mesh the one block is the batch itself."""

    __slots__ = ("shards", "mesh")

    def __init__(self, shards, mesh: Mesh):
        self.shards = tuple(shards)
        self.mesh = mesh

    @property
    def n_worlds(self) -> int:
        return sum(_width(s) for s in self.shards)

    def gather(self):
        """The whole batch on the lead device: the one block itself on a
        one-device mesh, else a new tree."""
        if len(self.shards) == 1:
            return self.shards[0]
        return tree_map(lambda *xs: _cat(xs, self.mesh.lead), *self.shards)


def _leaf(tree) -> torch.Tensor:
    from ..engine.core import tree_leaves

    return tree_leaves(tree)[0]


def _width(tree) -> int:
    return int(_leaf(tree).shape[0])


def shard_worlds(state, mesh: Mesh) -> Sharded:
    """Split a batched tree (a ``WorldState`` or any tree of ``(W, ...)``
    tensors) into contiguous world blocks, block ``i`` on
    ``mesh.devices.flat[i]``. Raises unless W is a multiple of the mesh
    size. A :class:`Sharded` is gathered first. On a one-device mesh the
    batch becomes the one block as it is where it already lies there."""
    if isinstance(state, Sharded):
        if state.mesh == mesh:
            return state
        state = state.gather()
    n_dev = mesh.size
    w = _width(state)
    if w % n_dev:
        raise ValueError(
            f"{w} worlds do not split over {n_dev} devices: the world "
            "axis must be a multiple of the mesh size")
    if n_dev == 1:
        dev = mesh.lead
        return Sharded([state if _leaf(state).device == dev else
                        tree_map(lambda x: _copy_to(x, dev), state)], mesh)
    b = w // n_dev
    return Sharded([tree_map(lambda x, i=i, d=d: _copy_to(x[i * b:(i + 1) * b],
                                                          d), state)
                    for i, d in enumerate(mesh.devices.flat)], mesh)
