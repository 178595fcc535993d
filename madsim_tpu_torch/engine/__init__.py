"""Batched device engine in PyTorch, with the step as a hand-written CUDA
kernel on the GPU.

The port of ``madsim_tpu.engine``: the discrete-event core — next-event
selection, virtual-clock advance, Threefry draws, network latency, loss and
partition sampling, fault schedules — over tensors with a leading world
(seed) axis. Each module mirrors the JAX module of the same name and agrees
with it bit for bit on every ``WorldState`` leaf.
"""
from .core import (
    DeviceEngine,
    EngineConfig,
    Outbox,
    WorldState,
    tree_select_worlds,
    FAULT_KILL,
    FAULT_RESTART,
    FAULT_CLOG_NODE,
    FAULT_UNCLOG_NODE,
    FAULT_CLOG_LINK,
    FAULT_UNCLOG_LINK,
    FAULT_SET_LATENCY,
    FAULT_SET_LOSS,
    FAULT_PAUSE,
    FAULT_RESUME,
)
from .checkpoint import CheckpointError
from .checkpoint import load as load_checkpoint
from .checkpoint import save as save_checkpoint
from .conformance import ConformanceError, check_actor
from .convert import state_from_numpy, state_to_numpy
from .lanes import PACKED, WIDE, Lanes
from .queue import INF_TIME, Event
from .raft_actor import RaftActor, RaftDeviceConfig

# The compiled families (tpc, pb) resolve lazily, as in the JAX package:
# their modules import the actor compiler (madsim_tpu_torch.actorc), which
# builds on the engine's submodules, so eager imports here would close an
# import cycle whenever actorc is imported first.
_LAZY = {"TPCActor": ".tpc_actor", "TPCDeviceConfig": ".tpc_actor",
         "PBActor": ".pb_actor", "PBDeviceConfig": ".pb_actor"}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name], __name__),
                       name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "DeviceEngine", "EngineConfig", "Event", "Outbox", "WorldState",
    "tree_select_worlds",
    "RaftActor", "RaftDeviceConfig", "PBActor", "PBDeviceConfig",
    "TPCActor", "TPCDeviceConfig",
    "Lanes", "PACKED", "WIDE",
    "state_from_numpy", "state_to_numpy",
    "save_checkpoint", "load_checkpoint", "CheckpointError",
    "check_actor", "ConformanceError",
    "FAULT_KILL", "FAULT_RESTART", "FAULT_CLOG_NODE", "FAULT_UNCLOG_NODE",
    "FAULT_CLOG_LINK", "FAULT_UNCLOG_LINK", "FAULT_SET_LATENCY",
    "FAULT_SET_LOSS", "FAULT_PAUSE", "FAULT_RESUME", "INF_TIME",
]
