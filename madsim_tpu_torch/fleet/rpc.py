"""Fleet RPC plumbing: clocks, retry-with-backoff, inline transport.

Everything in this module is HOST-side orchestration of the fabric — it
never feeds a simulation decision (the merge contract makes the final
``SweepResult`` independent of any timing here), but the fabric itself
must still be *testable deterministically*: the chaos matrix asserts a
crashed fleet's result bitwise against a crash-free one, and flaky
orchestration would make those tests flaky. Hence two clocks behind one
interface (a virtual tick clock for the inline fabric, the monotonic
clock for real processes) and backoff jitter drawn from splitmix64 —
a counter-based generator like the engine's Threefry, so a retry
schedule is a pure function of (seed, call site, attempt).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional


class RpcError(RuntimeError):
    """Transient transport failure: the call may be retried."""


class RetryExhausted(RpcError):
    """All retry attempts failed; the caller must abandon the operation
    (for a worker: drop the lease and let expiry re-issue it — the
    deterministic replay makes abandonment safe)."""


# -- clocks ------------------------------------------------------------------

class VirtualClock:
    """Integer fabric ticks for the inline (deterministic) fabric.

    Ticks advance on worker heartbeats and fabric scheduling rounds —
    never from the wall — so lease expiry, backoff, and restart timing
    are replayable facts of the schedule, not of host load.
    """

    def __init__(self) -> None:
        self._t = 0

    def now(self) -> float:
        return float(self._t)

    def advance(self, n: int = 1) -> None:
        self._t += int(n)

    def sleep(self, dt: float) -> None:
        # Sleeping IS advancing: a backoff of d ticks moves the fabric
        # forward, which is what lets a retry loop outlive a lease TTL
        # in tests exactly as it would on the wall clock.
        self._t += max(1, int(-(-dt // 1)))


class RealClock:
    """Monotonic wall time for multiprocess/production fabrics.

    The fabric is host-side orchestration beside the device sweep, like
    the observatory and the async checkpoint writer: its clock reads are
    sanctioned here, at one site, and never reach simulation code — the
    merged result is bitwise independent of them (tier-1 chaos matrix).
    """

    def now(self) -> float:
        import time as _walltime

        return _walltime.monotonic()  # detlint: allow[DET001]

    def advance(self, n: int = 1) -> None:
        pass  # the wall advances itself

    def sleep(self, dt: float) -> None:
        import time as _walltime

        _walltime.sleep(dt)  # detlint: allow[DET001]


# -- deterministic jitter ----------------------------------------------------

_MASK64 = (1 << 64) - 1


def splitmix64(x: int) -> int:
    """One splitmix64 step: the fabric's counter-based hash/PRNG.

    Pure integer math (no `random`, no OS entropy), so every jitter and
    chaos decision is a function of its inputs alone — the same property
    the engine gets from Threefry, at host-bookkeeping price.
    """
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (x ^ (x >> 31)) & _MASK64


def unit_hash(*parts: object) -> float:
    """Deterministic uniform in [0, 1) from arbitrary hashable parts.

    Strings fold in via their UTF-8 bytes (``hash()`` is per-process
    salted — DET006's lesson applies to the fabric too).
    """
    acc = 0x243F6A8885A308D3
    for p in parts:
        if isinstance(p, str):
            for b in p.encode():
                acc = splitmix64(acc ^ b)
        else:
            acc = splitmix64(acc ^ (int(p) & _MASK64))
    return splitmix64(acc) / float(1 << 64)


# -- retry with backoff ------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff with deterministic jitter.

    Delays are in CLOCK units: fabric ticks under the inline fabric
    (keep ``base_delay`` at 1.0 so a retry visibly advances the fabric),
    seconds under real processes. ``jitter`` is the uniform fraction
    added on top of the exponential term — drawn via splitmix64 from
    (seed, tag, attempt), so two runs of the same fabric schedule
    identical retries.
    """

    max_attempts: int = 5
    base_delay: float = 1.0
    max_delay: float = 16.0
    jitter: float = 0.5
    seed: int = 0

    def delay(self, tag: str, attempt: int) -> float:
        exp = min(self.base_delay * (2 ** attempt), self.max_delay)
        return exp * (1.0 + self.jitter * unit_hash(self.seed, tag, attempt))


def call_with_retry(fn: Callable[[], Any], policy: RetryPolicy, clock,
                    tag: str,
                    on_retry: Optional[Callable[[int, float, BaseException],
                                                None]] = None) -> Any:
    """Run ``fn`` retrying RpcError with backoff; other exceptions pass
    through untouched (they are bugs, not weather). ``on_retry`` sees
    (attempt, delay, error) before each sleep — the fleet telemetry
    hook."""
    last: Optional[BaseException] = None
    for attempt in range(policy.max_attempts):
        try:
            return fn()
        except RpcError as exc:
            last = exc
            if attempt + 1 >= policy.max_attempts:
                break
            d = policy.delay(tag, attempt)
            if on_retry is not None:
                on_retry(attempt, d, exc)
            clock.sleep(d)
    raise RetryExhausted(
        f"{tag}: {policy.max_attempts} attempts failed; last error: {last}")


# -- inline transport --------------------------------------------------------

#: Counted-discipline bound (tests/test_torch_fleet.py): non-heartbeat
#: control turns (acquire / batch / release / publish-resend / ...) a
#: fleet run may spend per issued lease. The coalesced control plane holds the
#: real number well under this — one acquire turn and one batched
#: publish+complete turn cover a whole prefetched quantum — but idle
#: acquire polls and chaos-forced re-sends ride the same budget, hence
#: the slack. This is the "RPC count per lease drops to a small
#: constant" gate, as a named constant.
MAX_CONTROL_RPCS_PER_LEASE = 3


class InlineTransport:
    """Worker→coordinator calls as plain method dispatch, with the chaos
    policy interposed exactly where a network would sit.

    The RPC surface is the coordinator's ``rpc_*`` methods. Chaos can
    fail a call before it reaches the coordinator (the worker retries
    with backoff on every coordinator RPC) and can DUPLICATE a completion
    after it succeeds (the at-least-once delivery failure mode the merge
    layer's bitwise crosscheck exists for).
    """

    def __init__(self, coordinator, chaos=None):
        self.coordinator = coordinator
        self.chaos = chaos
        self.calls: Dict[str, int] = {}
        self.injected_failures = 0
        self.injected_duplicates = 0
        self.injected_torn_publishes = 0

    def call(self, method: str, worker_id: str, **kw):
        self.calls[method] = self.calls.get(method, 0) + 1
        if method == "batch":
            return self._call_batch(worker_id, kw["msgs"])
        if self.chaos is not None and self.chaos.rpc_fail(method, worker_id):
            self.injected_failures += 1
            raise RpcError(
                f"injected transport failure: {method} from {worker_id}")
        return self._deliver(method, worker_id, kw)

    def _call_batch(self, worker_id: str, msgs):
        """One batched control turn: several logical messages, one
        transport round trip (the coalesced control plane). Chaos
        interposition stays per LOGICAL message — each message draws
        its rpc_fail / tear-publish / duplicate-completion decisions
        under its own method name, so chaos schedules keyed on logical
        traffic are invariant to the coalescing — but failure is
        atomic: every message's fail draw lands BEFORE any delivery,
        and one failure fails the whole turn (the worker's retry
        re-sends all of it; the publish dedupe and completion
        crosscheck absorb the replays)."""
        prepared = []
        failed = None
        for m in msgs:
            m = dict(m)
            lm = m.pop("method")
            if self.chaos is not None and self.chaos.rpc_fail(lm, worker_id):
                self.injected_failures += 1
                if failed is None:
                    failed = lm
            prepared.append((lm, m))
        if failed is not None:
            raise RpcError(f"injected transport failure: {failed} "
                           f"(batched) from {worker_id}")
        return [self._deliver(lm, worker_id, m) for lm, m in prepared]

    def _deliver(self, method: str, worker_id: str, kw: Dict[str, Any]):
        """Deliver one logical message (tear/duplicate chaos included)."""
        if (method == "publish" and self.chaos is not None
                and self.chaos.tear_publish(worker_id)):
            # Tear the snapshot IN FLIGHT (flip one byte of the payload)
            # so the coordinator's checksum rejects it — the torn-
            # publish failure mode of a real network, exercised
            # deterministically. The worker re-sends a fresh (clean)
            # serialization.
            import numpy as _np

            self.injected_torn_publishes += 1
            kw = dict(kw)
            snap = dict(kw["snapshot"])
            sched = _np.array(snap["sched"], copy=True)
            sched.flat[0] ^= 1
            snap["sched"] = sched
            kw["snapshot"] = snap
        fn = getattr(self.coordinator, f"rpc_{method}")
        out = fn(worker_id=worker_id, **kw)
        if (method == "complete" and self.chaos is not None
                and self.chaos.duplicate_completion(worker_id)):
            # At-least-once delivery: the network "retransmits" an
            # already-delivered completion. The coordinator must resolve
            # it as a bitwise-checked duplicate, not double-merge it.
            self.injected_duplicates += 1
            fn(worker_id=worker_id, **kw)
        return out
