"""The fleet on one machine: leased seed ranges and crash-identical recovery
— the port of ``madsim_tpu/fleet`` (docs/fleet.md).

A coordinator splits the seed vector into contiguous ranges and leases them
(with expiry) to workers; each worker sweeps its leases through a
persistent :class:`~madsim_tpu_torch.parallel.sweep.SweepSession` on the
engine's device or the fleet's mesh (on CUDA, the hand-written step kernel,
and under ``search=`` the corpus fold kernel) and heartbeats progress; expired or
released leases re-issue to surviving workers. Every range sweep is
bit-deterministic from its seeds, so recovery is *replay*: a crashed
worker's range re-executes identically elsewhere, a preempted worker's
checkpoint resumes bit-exactly, and a double-completed range is resolved by
asserting bitwise equality.

The contract (tests/test_torch_fleet.py, tests/test_torch_exchange.py): a
fleet sweep under injected worker kills, lease expiries, duplicate
completions, preemptions and torn checkpoints returns seed ids, bug flags,
per-seed observations and metrics, and a coverage ledger bitwise those of
a crash-free fleet, of a single-host ``sweep()`` over the same seeds, and of
the JAX package's ``fleet_sweep`` on a mesh of the same size. The host protocol modules
(lease, rpc, chaos, merge, coordinator, exchange) are copies of the JAX
package's; the port imports nothing of it.

Entry point: :func:`fleet_sweep` (inline deterministic fabric by default;
``spawn="process"`` for worker processes with pipes and signals).
"""
from .chaos import ChaosConfig, ChaosPolicy
from .coordinator import Coordinator, FLEET_SCHEMA
from .exchange import (
    EXCHANGE_SCHEMA,
    CorpusExchange,
    ExchangeConfig,
    TornPayloadError,
)
from .fabric import FleetStalledError, LocalFabric, fleet_sweep
from .lease import Lease, LeaseTable, SeedRange, split_ranges
from .merge import (
    FleetIntegrityError,
    contract_mismatches,
    merge_range_results,
)
from .rpc import (
    MAX_CONTROL_RPCS_PER_LEASE,
    InlineTransport,
    RealClock,
    RetryExhausted,
    RetryPolicy,
    RpcError,
    VirtualClock,
    call_with_retry,
)
from .worker import LeaseLost, LeasePreempted, Worker, WorkerKilled

__all__ = [
    "ChaosConfig", "ChaosPolicy", "Coordinator", "CorpusExchange",
    "EXCHANGE_SCHEMA", "ExchangeConfig", "FLEET_SCHEMA",
    "FleetIntegrityError", "FleetStalledError", "InlineTransport",
    "TornPayloadError",
    "Lease", "LeaseLost", "LeasePreempted", "LeaseTable", "LocalFabric",
    "MAX_CONTROL_RPCS_PER_LEASE",
    "RealClock", "RetryExhausted", "RetryPolicy", "RpcError",
    "SeedRange", "VirtualClock", "Worker", "WorkerKilled",
    "call_with_retry", "contract_mismatches", "fleet_sweep",
    "merge_range_results", "split_ranges",
]
