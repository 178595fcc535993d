"""Primary-backup replication actor: the config dataclass, the kind
constants and a thin :class:`~madsim_tpu_torch.actorc.compile.CompiledActor`
wrapper over the spec in :mod:`madsim_tpu_torch.actorc.families.pb` — the
port of ``madsim_tpu/engine/pb_actor.py``, bit for bit
(tests/test_torch_families.py).
On a CUDA device the step is the hand-written kernel's pb policy
(``csrc/actor_pb.cuh``).
"""
from __future__ import annotations

import dataclasses

from ..actorc.compile import CompiledActor

# Event kinds (spec declaration order — kept for callers and tests).
K_WRITE = 0        # scheduled client write [cmd]
K_REPLICATE = 1    # primary -> backup [view, idx, cmd]
K_ACK = 2          # backup -> primary [view, idx, backup]
K_COMMIT = 3       # primary -> backup [view, commit_idx]
K_HEARTBEAT = 4    # timer on primary [view, epoch]
K_WATCHDOG = 5     # timer on backup [view, epoch]
NUM_KINDS = 6


@dataclasses.dataclass(frozen=True)
class PBDeviceConfig:
    """Static primary-backup parameters."""

    n: int = 3
    log_cap: int = 16
    heartbeat_us: int = 50_000
    # A backup that hears nothing from the primary for this long starts the
    # next view (randomized per node to avoid symmetric races).
    watchdog_min_us: int = 200_000
    watchdog_max_us: int = 400_000
    n_writes: int = 4
    write_start_us: int = 100_000
    write_interval_us: int = 150_000
    # Injected bug: commit after the first ack instead of all acks.
    buggy_commit_early: bool = False


class PBActor(CompiledActor):
    """Primary-backup replication, compiled from its actorc spec."""

    def __init__(self, pcfg: PBDeviceConfig = PBDeviceConfig()):
        from ..actorc.families.pb import pb_spec

        super().__init__(pb_spec(pcfg))
        self.pcfg = pcfg

    def __reduce__(self):
        # The spec's handlers are closures: pickle the config and
        # compile again (a spawned fleet worker receives the actor).
        return type(self), (self.pcfg,)
