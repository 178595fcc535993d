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
from .convert import state_from_numpy, state_to_numpy
from .lanes import PACKED, WIDE, Lanes
from .queue import INF_TIME, Event
from .raft_actor import RaftActor, RaftDeviceConfig

__all__ = [
    "DeviceEngine", "EngineConfig", "Event", "Outbox", "WorldState",
    "RaftActor", "RaftDeviceConfig",
    "Lanes", "PACKED", "WIDE",
    "state_from_numpy", "state_to_numpy",
    "FAULT_KILL", "FAULT_RESTART", "FAULT_CLOG_NODE", "FAULT_UNCLOG_NODE",
    "FAULT_CLOG_LINK", "FAULT_UNCLOG_LINK", "FAULT_SET_LATENCY",
    "FAULT_SET_LOSS", "FAULT_PAUSE", "FAULT_RESUME", "INF_TIME",
]
