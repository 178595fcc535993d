"""Two-phase-commit actor: the config dataclass, the kind constants and a thin
:class:`~madsim_tpu_torch.actorc.compile.CompiledActor` wrapper over the
spec in :mod:`madsim_tpu_torch.actorc.families.tpc` — the port of
``madsim_tpu/engine/tpc_actor.py``, bit for bit
(tests/test_torch_families.py).
On a CUDA device the step is the hand-written kernel's tpc policy
(``csrc/actor_tpc.cuh``).
"""
from __future__ import annotations

import dataclasses

from ..actorc.compile import CompiledActor

# Event kinds (spec declaration order — kept for callers and tests).
K_TXN = 0       # scheduled at the coordinator [txn]
K_PREPARE = 1   # coord -> participant [txn]
K_VOTE = 2      # participant -> coord [txn, yes, voter]
K_DECIDE = 3    # coord -> participant [txn, decision]
K_TIMEOUT = 4   # coord timer [txn]
NUM_KINDS = 5

# Decision codes.
NONE, COMMIT, ABORT = 0, 1, 2

COORD = 0  # node 0 coordinates; 1..n-1 participate


@dataclasses.dataclass(frozen=True)
class TPCDeviceConfig:
    """Static two-phase-commit parameters."""

    n: int = 4                     # 1 coordinator + n-1 participants
    n_txns: int = 8
    txn_start_us: int = 50_000
    txn_interval_us: int = 120_000
    vote_timeout_us: int = 60_000
    # Each participant votes no on a txn with probability ~ no_vote_num/256
    # (drawn from the world's RNG stream at PREPARE time).
    no_vote_num: int = 32
    # Injected bug: decide COMMIT on vote timeout instead of ABORT.
    buggy_presumed_commit: bool = False


class TPCActor(CompiledActor):
    """Two-phase commit, compiled from its actorc spec."""

    def __init__(self, tcfg: TPCDeviceConfig = TPCDeviceConfig()):
        from ..actorc.families.tpc import tpc_spec

        super().__init__(tpc_spec(tcfg))
        self.tcfg = tcfg

    def __reduce__(self):
        # The spec's handlers are closures: pickle the config and
        # compile again (a spawned fleet worker receives the actor).
        return type(self), (self.tcfg,)
