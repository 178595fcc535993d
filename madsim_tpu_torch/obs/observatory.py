"""The sweep observatory: live telemetry, Prometheus snapshots, profiler
hooks, and the ``watch`` CLI.

The port of ``madsim_tpu/obs/observatory.py``. The sweep loop
(parallel/sweep.py) learns a handful of scalars per host read anyway —
occupancy, bug flag, chunk count, the coverage ledger's distinct count.
This module turns that already-fetched stream into operator-facing
telemetry **without adding a single device→host sync**: a callback or
JSONL emitter per host read, a Prometheus text-format snapshot writer,
and ``python -m madsim_tpu_torch.obs watch`` to tail or summarize the
stream. The profiler window captures a span of the loop's dispatches with
``torch.profiler`` (CUDA kernels included on the card) and writes a
Chrome trace into ``profile_dir``.

Everything here is *host-side* observation of the orchestration loop;
nothing in it feeds a simulation decision, so telemetry-on sweeps are
bitwise identical to telemetry-off ones. The record schemas are the JAX
package's, with the same names, so ``watch`` reads a stream of either.

Record schema (``madsim.sweep.telemetry/1``): progress records carry
``elapsed_s`` (monotonic seconds since loop start — never a wall-clock
date), ``chunks``, ``steps``, ``batch_worlds``, ``n_active``,
``occupancy``, ``seeds_total`` / ``seeds_admitted`` / ``seeds_done``,
``seeds_per_s``, ``world_utilization`` (running lower bound),
``dispatch_depth``, ``bug_seen``, ``eta_s`` (None while the rate is
still 0), and — when the engine runs metrics — ``coverage_distinct`` /
``coverage_buckets``. The final record has ``event: "summary"`` with
``loop_stats`` and the coverage ledger rollup.
"""
from __future__ import annotations

import json
import os
import sys
import tempfile
from typing import Any, Callable, List, Optional, Tuple

# Every duration in the telemetry schema is MONOTONIC seconds (the
# sweep's time.perf_counter), never a wall-clock date: two runs of one
# seed must render identical *virtual* timelines, and host clocks must
# never leak into them.
_SCHEMA = "madsim.sweep.telemetry/1"

# The summary record alone is versioned /2 since the whole-hunt fused
# sweep: it carries ``seeds_per_dispatch`` and ``epochs_on_device`` as
# TOP-LEVEL numerics (the Prometheus renderer exports only top-level
# fields). Additive — every /1 consumer reads a /2 summary unchanged;
# progress records stay /1.
_SCHEMA_V2 = "madsim.sweep.telemetry/2"

# The fleet fabric (the JAX package's madsim_tpu.fleet) emits its protocol
# events — lease_issued/expired/released, heartbeats, rpc_retry,
# completions (with duplicate-crosscheck flags), worker
# kill/restart/preemption — into the SAME observe sink as one-line
# records under this schema, so one JSONL stream carries both the
# sweep's progress and the fabric's lease churn and ``watch`` can
# summarize either.
_FLEET_SCHEMA = "madsim.fleet.telemetry/1"

# The fleet's cross-range corpus exchange rides the same sink with its
# own schema: publish
# (range/epoch/bytes, duplicate + torn flags), merge (epoch, ranges
# merged, corpus inserted/size), broadcast (seed corpus delivered with
# a lease), resume (coordinator crash→resume snapshot count).
_EXCHANGE_SCHEMA = "madsim.fleet.exchange/1"

# The evolution observatory (obs/lineage.py): guided sweeps emit one
# record per refill — corpus size/insert pressure, per-refill novelty,
# and the per-operator produced/novel/survived scalars — built from
# values the retire pull already fetched (zero extra device syncs).
_SEARCH_SCHEMA = "madsim.search.telemetry/1"

# Schema → short key, for the per-schema Prometheus counters and the
# snapshot's namespacing.
_SCHEMA_KEYS = {
    _SCHEMA: "sweep",
    _SCHEMA_V2: "sweep",
    _FLEET_SCHEMA: "fleet",
    _EXCHANGE_SCHEMA: "exchange",
    _SEARCH_SCHEMA: "search",
}


class JsonlEmitter:
    """Append one JSON line per telemetry record; flush per line so a
    killed sweep leaves a readable stream (and ``watch --follow`` sees
    records as they land)."""

    def __init__(self, path: str):
        self.path = os.fspath(path)
        self._f = open(self.path, "w", encoding="utf-8")

    def emit(self, record: dict) -> None:
        if self._f is None:
            return
        json.dump(record, self._f, separators=(",", ":"))
        self._f.write("\n")
        self._f.flush()

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


def make_observer(observe: Any
                  ) -> Tuple[Optional[Callable[[dict], None]],
                             Optional[Callable[[], None]]]:
    """Normalize ``sweep(observe=...)`` into ``(emit, close)``.

    ``None`` → no-op; a callable is used as-is (no close); a path string
    becomes a :class:`JsonlEmitter` stream the ``watch`` CLI consumes.
    """
    if observe is None:
        return None, None
    if callable(observe):
        return observe, None
    if isinstance(observe, (str, os.PathLike)):
        em = JsonlEmitter(observe)
        return em.emit, em.close
    raise TypeError(
        f"observe must be a callable or a JSONL file path, got "
        f"{type(observe).__name__}")


# ---------------------------------------------------------------------------
# Prometheus text-format snapshots
# ---------------------------------------------------------------------------

def prometheus_text(record: dict, prefix: str = "madsim_sweep") -> str:
    """Render one telemetry record's numeric fields as Prometheus text
    exposition gauges (booleans as 0/1; nested/None/str fields skipped).
    """
    lines: List[str] = []
    for k in sorted(record):
        v = record[k]
        if isinstance(v, bool):
            v = int(v)
        if not isinstance(v, (int, float)):
            continue
        name = f"{prefix}_{k}"
        lines.append(f"# TYPE {name} gauge")
        lines.append(f"{name} {v}")
    return "\n".join(lines) + "\n"


def _atomic_write(text: str, path: str) -> None:
    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    with os.fdopen(fd, "w", encoding="utf-8") as f:
        f.write(text)
    os.replace(tmp, path)


def write_prometheus(record: dict, path: str,
                     prefix: str = "madsim_sweep") -> None:
    """Atomically (tmp+rename) write a Prometheus snapshot of one record
    — the node-exporter-textfile-collector handoff shape, so a scraper
    never reads a half-written file."""
    _atomic_write(prometheus_text(record, prefix=prefix), path)


def _prom_name(s: str) -> str:
    """Sanitize an event/schema key into a metric-name fragment."""
    return "".join(c if c.isalnum() else "_" for c in str(s))


def prometheus_snapshot(records: List[dict]) -> str:
    """Whole-stream Prometheus snapshot: per-schema record counters,
    per-event fleet/exchange counters, and the latest sweep + search
    records' gauges.

    A stream from a fleet interleaves four schemas; rendering only the
    newest record used to let a fleet/exchange record carry no sweep
    gauges at all (and fleet activity never surfaced as metrics). The
    snapshot keeps the newest record of EACH numeric schema as gauges
    (``madsim_sweep_*`` / ``madsim_search_*``) and counts every record
    and fleet/exchange event (``madsim_records_<schema>``,
    ``madsim_fleet_events_<event>``, ``madsim_exchange_events_<event>``)
    so node-exporter dashboards see fleet + search activity, not just
    sweep progress.
    """
    parts: List[str] = []
    counts: dict = {}
    events: dict = {}
    latest: dict = {}
    for r in records:
        key = _SCHEMA_KEYS.get(r.get("schema"), "other")
        counts[key] = counts.get(key, 0) + 1
        if key in ("sweep", "search"):
            latest[key] = r
        if key in ("fleet", "exchange") and r.get("event"):
            name = f"madsim_{key}_events_{_prom_name(r['event'])}"
            events[name] = events.get(name, 0) + 1
    for key in sorted(counts):
        name = f"madsim_records_{_prom_name(key)}"
        parts.append(f"# TYPE {name} counter\n{name} {counts[key]}")
    for name in sorted(events):
        parts.append(f"# TYPE {name} counter\n{name} {events[name]}")
    out = "\n".join(parts) + ("\n" if parts else "")
    if "sweep" in latest:
        out += prometheus_text(latest["sweep"], prefix="madsim_sweep")
    if "search" in latest:
        out += prometheus_text(latest["search"], prefix="madsim_search")
    return out


def write_prometheus_snapshot(records: List[dict], path: str) -> None:
    """Atomic write of :func:`prometheus_snapshot` (tmp+rename)."""
    _atomic_write(prometheus_snapshot(records), path)


# ---------------------------------------------------------------------------
# Profiler capture window
# ---------------------------------------------------------------------------

class ProfilerWindow:
    """Wrap a window of sweep dispatches in a ``torch.profiler`` capture.

    ``window=(start, stop)`` counts loop dispatches: the capture starts
    right before dispatch ``start`` and stops at the first blocking
    scalar read at/after dispatch ``stop`` (so the device execution of
    every in-window dispatch has completed inside the capture), or at
    loop end. The capture records the host (CPU) and, where the card is
    there, its kernels (CUDA), and lands under ``trace_dir`` as a Chrome
    trace (``sweep-<pid>-<n>.pt.trace.json``): beside the *virtual-time*
    timelines of obs/timeline.py, the wall-clock view of the same sweep.
    With ``trace_dir=None`` every method is a no-op. Capture failures
    are recorded on ``self.error`` and never propagate into the sweep.
    """

    _captures = 0                       # per process, names the files

    def __init__(self, trace_dir: Optional[str],
                 window: Tuple[int, int] = (0, 4)):
        self.trace_dir = os.fspath(trace_dir) if trace_dir else None
        start, stop = int(window[0]), int(window[1])
        if self.trace_dir is not None and not 0 <= start < stop:
            raise ValueError(
                f"profile_window must be (start, stop) dispatch indices "
                f"with 0 <= start < stop; got {window!r}")
        self.start, self.stop = start, stop
        self.error: Optional[str] = None
        self.path: Optional[str] = None  # the trace written, once closed
        self._prof = None
        self._dispatches = 0
        self._reads = 0
        self._done = self.trace_dir is None

    @property
    def _active(self) -> bool:
        return self._prof is not None

    def before_dispatch(self) -> None:
        if not self._done and not self._active \
                and self._dispatches >= self.start:
            try:
                import torch
                from torch.profiler import ProfilerActivity, profile

                os.makedirs(self.trace_dir, exist_ok=True)
                acts = [ProfilerActivity.CPU]
                if torch.cuda.is_available():
                    acts.append(ProfilerActivity.CUDA)
                prof = profile(activities=acts)
                prof.start()
                self._prof = prof
            except Exception as exc:  # pragma: no cover — backend-specific
                self.error = f"{type(exc).__name__}: {exc}"
                self._done = True
        self._dispatches += 1

    def annotate(self, label: str):
        """Context manager naming the enclosed dispatch on the captured
        timeline; a null context while no capture is active."""
        if self._active:
            from torch.profiler import record_function

            return record_function(label)
        import contextlib

        return contextlib.nullcontext()

    def after_read(self) -> None:
        """One blocking scalar read happened: device work up to the read
        superstep is complete. Stop once the window is covered."""
        self._reads += 1
        if self._active and self._reads >= self.stop:
            self.close()

    def close(self) -> None:
        """Idempotent; also the error-path stop (sweep's finally): stops
        the capture and writes its Chrome trace."""
        if self._active:
            prof, self._prof = self._prof, None
            try:
                prof.stop()
                ProfilerWindow._captures += 1
                path = os.path.join(
                    self.trace_dir, f"sweep-{os.getpid()}-"
                    f"{ProfilerWindow._captures}.pt.trace.json")
                prof.export_chrome_trace(path)
                self.path = path
            except Exception as exc:  # pragma: no cover — backend-specific
                self.error = f"{type(exc).__name__}: {exc}"
        self._done = True


# ---------------------------------------------------------------------------
# `python -m madsim_tpu_torch.obs watch` — tail/summarize a telemetry stream
# ---------------------------------------------------------------------------

def _load_records(path: str) -> List[dict]:
    out: List[dict] = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except ValueError:
                continue  # half-written tail of a live stream
    return out


def render_progress(rec: dict) -> str:
    """One terminal line per progress record."""
    occ = rec.get("occupancy")
    cov = rec.get("coverage_distinct")
    eta = rec.get("eta_s")
    bits = [
        f"t={rec.get('elapsed_s', 0):8.2f}s",
        f"chunks={rec.get('chunks', 0):<5}",
        f"active={rec.get('n_active', 0)}/{rec.get('batch_worlds', 0)}"
        + (f" ({occ:.0%})" if isinstance(occ, (int, float)) else ""),
        f"seeds {rec.get('seeds_done', 0)}/{rec.get('seeds_total', 0)}"
        f" @ {rec.get('seeds_per_s', 0)}/s",
    ]
    if cov is not None:
        bits.append(f"behaviors={cov}")
    bits.append("eta=" + (f"{eta:.1f}s" if isinstance(eta, (int, float))
                          else "?"))
    if rec.get("bug_seen"):
        bits.append("BUG")
    return "  ".join(bits)


def render_fleet_event(rec: dict) -> str:
    """One terminal line per fleet-fabric record (lease churn, worker
    life cycle, retries) — keyed by worker so an operator can eyeball a
    sick host in the stream."""
    bits = [f"t={rec.get('t', 0):>6}", f"[{rec.get('worker', '?')}]",
            rec.get("event", "?")]
    for k in ("range_id", "lease_id", "generation", "reissued",
              "duplicate", "crosschecked", "attempt", "exitcode"):
        if k in rec and rec[k] not in (None, False):
            bits.append(f"{k}={rec[k]}")
    if rec.get("error"):
        bits.append(f"error={rec['error']}")
    return "  ".join(str(b) for b in bits)


def render_exchange_event(rec: dict) -> str:
    """One terminal line per corpus-exchange record — epochs, ranges
    merged, corpus growth, bytes on the wire — so an operator can watch
    the fleet's shared search progress next to its lease churn."""
    bits = [f"t={rec.get('t', 0):>6}", "[exchange]", rec.get("event", "?")]
    for k in ("epoch", "from_epoch", "range_id", "worker",
              "ranges_merged", "corpus_inserted", "corpus_size",
              "corpus_gen", "epochs_merged", "bytes", "snapshots"):
        if k in rec and rec[k] is not None:
            bits.append(f"{k}={rec[k]}")
    for k in ("duplicate", "torn"):
        if rec.get(k):
            bits.append(k.upper())
    if rec.get("error"):
        bits.append(f"error={rec['error']}")
    return "  ".join(str(b) for b in bits)


def render_exchange_summary(exchange: List[dict]) -> List[str]:
    """Aggregate line for the exchange records in a stream: epochs
    merged, corpus inserts, publish/broadcast traffic."""
    if not exchange:
        return []
    merges = [r for r in exchange if r.get("event") == "merge"]
    pubs = [r for r in exchange if r.get("event") == "publish"]
    line = (f"exchange: {len(merges)} epoch(s) merged, "
            f"{sum(r.get('corpus_inserted', 0) for r in merges)} corpus "
            f"insert(s), {len(pubs)} publish(es) "
            f"({sum(r.get('bytes', 0) for r in pubs)} B published)")
    dup = sum(1 for r in pubs if r.get("duplicate"))
    torn = sum(1 for r in exchange if r.get("event") == "publish_torn")
    if dup or torn:
        line += (f" [{dup} duplicate(s) crosschecked, {torn} torn "
                 "publish(es) discarded]")
    if merges:
        last = merges[-1]
        line += (f"; merged corpus: {last.get('corpus_size', '?')} "
                 f"entries after epoch {last.get('epoch', '?')}")
    return [line]


def render_search_event(rec: dict) -> str:
    """One terminal line per search-telemetry record (obs/lineage.py):
    refill-grain corpus growth and the per-operator survival scalars, so
    an operator can watch which mutation operators are earning their
    keep while the hunt runs."""
    bits = [f"t={rec.get('elapsed_s', 0):8.2f}s", "[search]",
            rec.get("event", "?"),
            f"gen={rec.get('generation', '?')}",
            f"corpus={rec.get('corpus_size', '?')}",
            f"inserted={rec.get('corpus_inserted', '?')}"]
    if rec.get("refill_novel") is not None:
        bits.append(f"novel+={rec['refill_novel']}")
    if rec.get("refill_inserted") is not None:
        bits.append(f"ins+={rec['refill_inserted']}")
    if rec.get("epochs_on_device") is not None:
        # Fused-hunt cadence: refills run on device, so each record is
        # a per-MEGA-DISPATCH rollup — render that explicitly so an
        # operator reading a sparse stream knows the hunt is not stuck.
        bits.append(f"epochs_on_device={rec['epochs_on_device']} "
                    "(per-mega-dispatch rollup)")
    surv = [(k[len("op_survived_"):], v) for k, v in rec.items()
            if k.startswith("op_survived_") and v]
    if surv:
        bits.append("survived[" + " ".join(f"{k}={v}"
                                           for k, v in sorted(surv)) + "]")
    return "  ".join(str(b) for b in bits)


def render_search_summary(search: List[dict]) -> List[str]:
    """Aggregate line for the search records in a stream: generations,
    corpus growth, and the top surviving operator."""
    if not search:
        return []
    last = search[-1]
    fused = last.get("epochs_on_device") is not None
    line = (f"search: {len(search)} "
            f"{'mega-dispatch rollup(s)' if fused else 'refill(s)'}, "
            f"generation {last.get('generation', '?')}, corpus "
            f"{last.get('corpus_size', '?')} "
            f"({last.get('corpus_inserted', '?')} inserted)")
    if fused:
        line += (f"; fused=true — {last['epochs_on_device']} refill "
                 "epoch(s) ran on device between pulls")
    surv = [(k[len("op_survived_"):], v) for k, v in last.items()
            if k.startswith("op_survived_")]
    if surv:
        top = max(surv, key=lambda kv: kv[1])
        if top[1]:
            line += f"; top operator {top[0]} ({top[1]} survived)"
    return [line]


def render_fleet_summary(fleet: List[dict]) -> List[str]:
    """Aggregate lines for the fleet records in a stream: event counts
    plus the resilience headline (expiries, re-leases, crosschecked
    duplicates)."""
    if not fleet:
        return []
    counts: dict = {}
    for r in fleet:
        counts[r.get("event", "?")] = counts.get(r.get("event", "?"), 0) + 1
    lines = ["fleet: " + ", ".join(f"{k}={v}"
                                   for k, v in sorted(counts.items()))]
    summary = next((r for r in fleet if r.get("event") == "fleet_summary"),
                   None)
    if summary is not None:
        lines.append(
            f"fleet summary: {summary.get('completions', '?')} ranges "
            f"completed ({summary.get('leases_expired', 0)} leases "
            f"expired, {summary.get('leases_reissued', 0)} re-issued, "
            f"{summary.get('duplicates_crosschecked', 0)} duplicate "
            "completions crosschecked bitwise)")
    return lines


def render_summary(records: List[dict]) -> str:
    """Human summary of a whole stream (the non-follow ``watch`` mode)."""
    if not records:
        return "watch: empty telemetry stream"
    fleet = [r for r in records if r.get("schema") == _FLEET_SCHEMA]
    exchange = [r for r in records if r.get("schema") == _EXCHANGE_SCHEMA]
    search = [r for r in records if r.get("schema") == _SEARCH_SCHEMA]
    records = [r for r in records
               if r.get("schema") not in (_FLEET_SCHEMA, _EXCHANGE_SCHEMA,
                                          _SEARCH_SCHEMA)]
    progress = [r for r in records if r.get("event") != "summary"]
    summary = next((r for r in records if r.get("event") == "summary"),
                   None)
    lines: List[str] = render_fleet_summary(fleet)
    lines.extend(render_exchange_summary(exchange))
    lines.extend(render_search_summary(search))
    if progress:
        lines.append(f"{len(progress)} progress records; last:")
        lines.append("  " + render_progress(progress[-1]))
        covs = [r["coverage_distinct"] for r in progress
                if "coverage_distinct" in r]
        if covs:
            lines.append(
                f"novelty curve: {covs[0]} -> {covs[-1]} distinct "
                f"behaviors over {len(covs)} reads"
                + (" (still growing at exit — the hunt had not "
                   "saturated)" if len(covs) >= 2 and covs[-1] > covs[-2]
                   else ""))
    if summary is not None:
        ls = summary.get("loop_stats") or {}
        lines.append(
            f"final: {summary.get('failing_seeds', '?')} failing of "
            f"{summary.get('seeds_total', '?')} seeds in "
            f"{summary.get('elapsed_s', '?')}s "
            f"(utilization {summary.get('world_utilization', '?')}, "
            f"{ls.get('chunks', '?')} chunks / "
            f"{ls.get('dispatches', '?')} dispatches)")
        if "seeds_per_dispatch" in summary:
            # /2 summaries: the dispatch-economics gauges, top-level.
            fused = " (fused hunt)" if ls.get("fused") else ""
            lines.append(
                f"dispatch economics: {summary['seeds_per_dispatch']} "
                f"seeds/dispatch, {summary.get('epochs_on_device', 0)} "
                f"refill epochs on device{fused}")
        cov = summary.get("coverage")
        if cov:
            lines.append(
                f"coverage: {cov.get('distinct_behaviors')} distinct "
                f"behaviors in {cov.get('n_buckets')} buckets "
                f"({cov.get('worlds_folded')} worlds folded, novelty "
                f"{cov.get('novelty_first')}->{cov.get('novelty_last')})")
        srch = summary.get("search")
        if srch:
            line = (f"search: corpus {srch.get('corpus_size')}/"
                    f"{srch.get('corpus_capacity')} after "
                    f"{srch.get('generations')} generation(s), "
                    f"{srch.get('inserted')} inserted")
            ops = srch.get("operator_stats") or {}
            best = max(ops.items(),
                       key=lambda kv: kv[1].get("survived", 0),
                       default=None)
            if best and best[1].get("survived", 0):
                line += (f"; top operator {best[0]} "
                         f"({best[1]['survived']} survived, "
                         f"{best[1].get('survival_pct', 0)}% of "
                         f"{best[1].get('produced', 0)} produced)")
            lines.append(line)
    elif not fleet and not exchange:
        lines.append("no summary record yet (sweep still running?)")
    return "\n".join(lines)


def watch(path: str, follow: bool = False, prom: Optional[str] = None,
          interval: float = 1.0, out=None) -> int:
    """The ``watch`` subcommand body. Summarizes the stream (default) or
    tails it (``follow=True``) until the summary record arrives; with
    ``prom`` set, each new record refreshes a Prometheus snapshot file.
    """
    out = out or sys.stdout
    if not os.path.exists(path):
        print(f"watch: no such file: {path}", file=sys.stderr)
        return 2
    if not follow:
        records = _load_records(path)
        print(render_summary(records), file=out)
        if prom and records:
            write_prometheus_snapshot(records, prom)
        return 0
    # Follow mode: host-side tail of a host-side stream — the one place
    # a real sleep belongs (this process never runs simulation code).
    import time as _walltime

    seen = 0
    done = False
    while not done:
        records = _load_records(path)
        for i, rec in enumerate(records[seen:], start=seen):
            if rec.get("event") == "summary" \
                    and rec.get("schema") != _SEARCH_SCHEMA:
                print(render_summary(records), file=out)
                done = True
            elif rec.get("schema") == _SEARCH_SCHEMA:
                print(render_search_event(rec), file=out)
            elif rec.get("schema") == _EXCHANGE_SCHEMA:
                print(render_exchange_event(rec), file=out)
            elif rec.get("schema") == _FLEET_SCHEMA:
                print(render_fleet_event(rec), file=out)
            else:
                print(render_progress(rec), file=out)
            if prom:
                # Snapshot over everything seen so far: a fleet or
                # search record must ADD counters, never clobber the
                # sweep gauges (the per-schema counters).
                write_prometheus_snapshot(records[:i + 1], prom)
        seen = len(records)
        if not done:
            _walltime.sleep(interval)
    return 0
