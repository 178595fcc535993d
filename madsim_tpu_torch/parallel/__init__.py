"""Seed sweeps over the port's batched engine, on one device or split over
a mesh of devices.

The port of ``madsim_tpu.parallel``: :func:`sweep`, its
:class:`SweepResult` and the fleet worker's :class:`SweepSession`, and
the world-axis split (:func:`seed_mesh`, :func:`multihost_mesh`,
:func:`shard_worlds`, :func:`world_spec`, :func:`world_sharding`,
:func:`sharded_engine`). The module itself is
``madsim_tpu_torch.parallel.sweep`` (import it with
``importlib.import_module``: this package's ``sweep`` is the function, as
in the JAX package).
"""
from .mesh import (multihost_mesh, seed_mesh, shard_worlds, world_sharding,
                   world_spec)
from .sweep import SweepResult, SweepSession, sharded_engine, sweep

__all__ = ["seed_mesh", "multihost_mesh", "shard_worlds", "world_spec",
           "world_sharding", "sharded_engine", "sweep", "SweepResult",
           "SweepSession"]
