"""The fleet's failure machinery: a chaos harness for the fabric itself.

The simulator injects faults into the *simulated* cluster; this module
injects faults into the *fleet that runs the simulator* — worker kills
and restarts, dropped/delayed heartbeats, duplicated completions,
SIGTERM-style preemptions, torn checkpoint files, transient RPC
failures. The resilience contract under test
(tests/test_torch_fleet.py): a sweep that survives any mix of these
produces a ``SweepResult`` bitwise identical to one that never saw them.

Every decision is deterministic: rate-based decisions hash
(seed, worker, event counter) through splitmix64, and explicit
``*_at`` schedules fire on exact per-worker heartbeat counts — so a
failing chaos combination replays exactly from its ChaosConfig, the
same way a failing seed replays through MADSIM_TEST_SEED.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from .rpc import unit_hash

# Heartbeat-time actions a chaos policy can order (worker.py executes
# them at the heartbeat boundary — the fabric's preemption point).
OK = "ok"
DROP = "drop"          # heartbeat lost in flight (expiry pressure)
DELAY = "delay"        # heartbeat deferred to the next beat
KILL = "kill"          # worker dies NOW: no release, no checkpoint flush
PREEMPT = "preempt"    # SIGTERM: checkpoint + lease release, then exit


@dataclasses.dataclass(frozen=True)
class ChaosConfig:
    """Declarative failure mix. All rates are per-event probabilities
    decided by deterministic hash; all ``*_at`` entries are
    ``(worker_id, nth_heartbeat)`` pairs (1-based, per worker, counted
    across that worker's whole life — kills don't reset the count).

    ``restart_after``: fabric ticks a dead worker stays down before the
    scheduler revives it (< 0 = never — the fleet must finish on the
    survivors). ``max_kills_per_worker`` bounds rate-based kills so a
    hostile rate cannot livelock the fleet; explicit ``kill_at`` entries
    are exempt (you asked for exactly those).
    ``tear_checkpoint_on_kill`` truncates the dead worker's in-progress
    lease checkpoint — the torn-file crash the hardened loader
    (engine/checkpoint.py) must refuse cleanly and the worker must
    recover from by discarding and re-running.
    """

    seed: int = 0
    kill_at: Tuple[Tuple[str, int], ...] = ()
    preempt_at: Tuple[Tuple[str, int], ...] = ()
    kill_rate: float = 0.0
    preempt_rate: float = 0.0
    drop_heartbeat_rate: float = 0.0
    delay_heartbeat_rate: float = 0.0
    drop_rpc_rate: float = 0.0
    duplicate_completion_rate: float = 0.0
    duplicate_all_completions: bool = False
    tear_checkpoint_on_kill: bool = False
    # Corpus-exchange publish tearing (fleet/exchange.py): flip a byte
    # of the snapshot in flight so the coordinator's checksum rejects it
    # and the worker must re-send. ``tear_publish_at`` entries are
    # (worker_id, nth-publish-attempt) pairs (1-based, per worker);
    # ``tear_publish_rate`` rolls per attempt — re-sends re-roll, so
    # convergence is guaranteed for rates < 1.
    tear_publish_at: Tuple[Tuple[str, int], ...] = ()
    tear_publish_rate: float = 0.0
    restart_after: int = 2
    max_kills_per_worker: int = 2


class ChaosPolicy:
    """Stateful executor of a ChaosConfig: per-worker event counters +
    the deterministic decisions derived from them."""

    def __init__(self, config: Optional[ChaosConfig] = None):
        self.config = config or ChaosConfig()
        self._beats: Dict[str, int] = {}
        self._kills: Dict[str, int] = {}
        self._rpc_seq: Dict[str, int] = {}
        self._kill_at = set(self.config.kill_at)
        self._preempt_at = set(self.config.preempt_at)

    # -- heartbeat-boundary decisions -----------------------------------
    def heartbeat_action(self, worker_id: str) -> str:
        """One action per heartbeat, evaluated most-destructive first so
        an explicit kill schedule cannot be shadowed by a drop roll."""
        c = self.config
        n = self._beats.get(worker_id, 0) + 1
        self._beats[worker_id] = n
        if (worker_id, n) in self._kill_at:
            self._kills[worker_id] = self._kills.get(worker_id, 0) + 1
            return KILL
        if (worker_id, n) in self._preempt_at:
            return PREEMPT
        budget = self._kills.get(worker_id, 0) < c.max_kills_per_worker
        if c.kill_rate > 0 and budget and \
                unit_hash(c.seed, worker_id, n, "kill") < c.kill_rate:
            self._kills[worker_id] = self._kills.get(worker_id, 0) + 1
            return KILL
        if c.preempt_rate > 0 and \
                unit_hash(c.seed, worker_id, n, "preempt") < c.preempt_rate:
            return PREEMPT
        if c.drop_heartbeat_rate > 0 and \
                unit_hash(c.seed, worker_id, n, "drop") < c.drop_heartbeat_rate:
            return DROP
        if c.delay_heartbeat_rate > 0 and \
                unit_hash(c.seed, worker_id, n, "delay") < c.delay_heartbeat_rate:
            return DELAY
        return OK

    # -- transport decisions --------------------------------------------
    def rpc_fail(self, method: str, worker_id: str) -> bool:
        """Fail this RPC attempt? Each attempt re-rolls on its own
        (worker, method, sequence) counter, so bursts of consecutive
        failures are possible — deliberately: retry exhaustion makes the
        worker ABANDON the operation, and the fabric's expiry + re-issue
        + duplicate-crosscheck machinery is what must (and does)
        converge the fleet anyway."""
        c = self.config
        if c.drop_rpc_rate <= 0:
            return False
        key = f"{worker_id}:{method}"
        seq = self._rpc_seq.get(key, 0)
        self._rpc_seq[key] = seq + 1
        return unit_hash(c.seed, worker_id, method, seq, "rpc") \
            < c.drop_rpc_rate

    def tear_publish(self, worker_id: str) -> bool:
        """Corrupt this corpus publish in flight? Counted per worker
        publish ATTEMPT, so an explicit ``tear_publish_at`` entry tears
        exactly once and the re-send goes through clean."""
        c = self.config
        if not c.tear_publish_at and c.tear_publish_rate <= 0:
            return False
        key = f"{worker_id}:pub"
        n = self._rpc_seq.get(key, 0) + 1
        self._rpc_seq[key] = n
        if (worker_id, n) in set(c.tear_publish_at):
            return True
        return c.tear_publish_rate > 0 and \
            unit_hash(c.seed, worker_id, n, "tearpub") < c.tear_publish_rate

    def duplicate_completion(self, worker_id: str) -> bool:
        c = self.config
        if c.duplicate_all_completions:
            return True
        if c.duplicate_completion_rate <= 0:
            return False
        key = f"{worker_id}:dup"
        seq = self._rpc_seq.get(key, 0)
        self._rpc_seq[key] = seq + 1
        return unit_hash(c.seed, worker_id, seq, "dup") \
            < c.duplicate_completion_rate

    # -- scheduler decisions --------------------------------------------
    def restart_due(self, died_at: float, now: float) -> bool:
        return (self.config.restart_after >= 0
                and now - died_at >= self.config.restart_after)

    @property
    def restarts_enabled(self) -> bool:
        return self.config.restart_after >= 0


def tear_file(path: str, keep_bytes: int = 128) -> None:
    """Truncate ``path`` to its first ``keep_bytes`` bytes — the torn
    npz a crash between write and publish would have left before the
    fsync fix, kept as an injectable fault so the corrupt-checkpoint
    recovery path stays exercised forever."""
    import os

    if not os.path.exists(path):
        return
    with open(path, "rb+") as f:
        f.truncate(min(keep_bytes, os.path.getsize(path)))
