"""Timeline export: device/host traces → Chrome trace-event JSON or text.

The port of ``madsim_tpu/obs/timeline.py``: the same documents, byte for
byte, for the same trace. Converts the ordered event list of
``DeviceEngine.trace()`` (one dict per processed step — see
engine/core.py), a decoded flight-recorder ring, and host poll traces
(``(task_id, elapsed_ns)`` tuples) into the Chrome trace-event format,
loadable in ``chrome://tracing`` / Perfetto, plus a human text renderer
for terminals.

Every timestamp is **virtual time** (the simulation's microsecond clock),
never the wall clock — two replays of one seed produce byte-identical
timelines, which is the property that makes a timeline a repro artifact
rather than a log. The documents name their generator
``madsim_tpu.obs.timeline``, the format's name in both packages.
"""
from __future__ import annotations

import json
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

# Chrome trace-event phase codes used here: M = metadata, i = instant.
# (https://docs.google.com/document/d/1CvAClvFfyA5R-PhYUmn5OOQtYMH4h6I0nSsKchNAySU)
_SCOPE_THREAD = "t"


def _category(entry: Dict[str, Any]) -> str:
    kind = str(entry.get("kind", ""))
    if kind.startswith("fault:"):
        return "fault"
    if kind in ("invariant", "truncated"):
        return kind
    if entry.get("dropped"):
        return "drop"
    return "timer" if entry.get("timer") else "msg"


def trace_to_chrome(trace: Sequence[Dict[str, Any]], *,
                    seed: Optional[int] = None,
                    label: Optional[str] = None) -> Dict[str, Any]:
    """Render a ``DeviceEngine.trace()`` event list as a Chrome
    trace-event document (a plain dict; ``json.dump`` it).

    Layout: one process (the world), one thread lane per destination
    node (faults land on their target node's lane; engine-level markers
    — invariant raise, truncation — on lane -1). Events are instants at
    their virtual-time microsecond; an entry carrying ``bug_raised``
    additionally emits an ``invariant:raise`` instant immediately after
    it, so under ``stop_on_bug`` (the default) the raise is the
    document's final event — the acceptance contract the repro CLI
    checks.
    """
    pid = 0
    name = label or (f"madsim seed {seed}" if seed is not None else "madsim")
    events: List[Dict[str, Any]] = [{
        "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
        "args": {"name": name},
    }]
    for e in trace:
        kind = str(e.get("kind", "?"))
        cat = _category(e)
        if cat in ("invariant", "truncated"):
            tid = -1
        else:
            tid = int(e.get("dst", -1))
        ev: Dict[str, Any] = {
            "name": kind, "cat": cat, "ph": "i", "s": _SCOPE_THREAD,
            "ts": float(e.get("t_us", 0)), "pid": pid, "tid": tid,
            "args": {k: v for k, v in e.items()
                     if k in ("step", "src", "dst", "timer", "payload",
                              "dropped", "drop_cause", "bug_seen")},
        }
        events.append(ev)
        if e.get("bug_raised") and kind != "invariant":
            events.append({
                "name": "invariant:raise", "cat": "invariant", "ph": "i",
                "s": _SCOPE_THREAD, "ts": float(e.get("t_us", 0)),
                "pid": pid, "tid": -1, "args": {"step": e.get("step")},
            })
        elif kind == "invariant":
            # The no-event raise marker IS the raise; normalize its name
            # so consumers match one event name either way.
            ev["name"] = "invariant:raise"
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {"generator": "madsim_tpu.obs.timeline",
                      "clock": "virtual_us",
                      **({"seed": int(seed)} if seed is not None else {})},
    }


def ring_to_chrome(entries: Sequence[Dict[str, Any]], *,
                   seed: Optional[int] = None,
                   label: Optional[str] = None,
                   k: Optional[int] = None) -> Dict[str, Any]:
    """Render a decoded flight-recorder ring (obs/blackbox.py
    ``decode_ring`` / ``SweepResult.blackbox(seed)`` / a bundle's
    ``madsim.blackbox/1`` ``events``) as a Chrome trace document.

    Ring entries are trace-shaped, so the layout is exactly
    :func:`trace_to_chrome`'s — one thread lane per destination node,
    instants at virtual-time microseconds, the ``invariant:raise``
    instant at the bug — plus the recorder provenance in ``otherData``
    (``source: "blackbox"`` and the ring depth ``k``), so a timeline
    reconstructed from K in-situ records is never mistaken for a full
    replay trace.
    """
    name = label or (f"madsim blackbox seed {seed}" if seed is not None
                     else "madsim blackbox")
    doc = trace_to_chrome(entries, seed=seed, label=name)
    doc["otherData"]["source"] = "blackbox"
    if k is not None:
        doc["otherData"]["blackbox_k"] = int(k)
    return doc


def polls_to_chrome(polls: Iterable[Tuple[int, int]], *,
                    seed: Optional[int] = None,
                    label: Optional[str] = None) -> Dict[str, Any]:
    """Render a host-engine poll trace (``Runtime``'s ``task.trace`` /
    ``bridge.sweep_traced`` entries: ``(task_id, elapsed_ns)`` per poll)
    as a Chrome trace document — one thread lane per task, one instant
    per poll, timestamped in virtual microseconds."""
    pid = 0
    name = label or (f"madsim seed {seed}" if seed is not None else "madsim")
    events: List[Dict[str, Any]] = [{
        "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
        "args": {"name": name},
    }]
    for i, (task_id, elapsed_ns) in enumerate(polls):
        events.append({
            "name": "poll", "cat": "poll", "ph": "i", "s": _SCOPE_THREAD,
            "ts": elapsed_ns / 1_000.0, "pid": pid, "tid": int(task_id),
            "args": {"poll": i},
        })
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {"generator": "madsim_tpu.obs.timeline",
                      "clock": "virtual_us",
                      **({"seed": int(seed)} if seed is not None else {})},
    }


def render_text(trace: Sequence[Dict[str, Any]]) -> str:
    """Human-readable timeline: one line per processed event, virtual
    time left-aligned, with drop/bug annotations."""
    lines: List[str] = []
    for e in trace:
        kind = str(e.get("kind", "?"))
        if kind == "truncated":
            lines.append(f"{e.get('t_us', 0):>12,} µs  -- trace truncated at "
                         f"step {e.get('step')} (world still active"
                         f"{'' if e.get('bug_seen') else ', bug never seen'})")
            continue
        src, dst = e.get("src", -1), e.get("dst", -1)
        route = f"{src}->{dst}" if src >= 0 else f"->{dst}" if dst >= 0 else ""
        flags = []
        if e.get("timer"):
            flags.append("timer")
        if e.get("dropped"):
            flags.append("DROPPED")
        note = f" [{','.join(flags)}]" if flags else ""
        payload = e.get("payload") or []
        pay = f" {payload}" if any(payload) else ""
        lines.append(f"{e.get('t_us', 0):>12,} µs  step {e.get('step'):>6}  "
                     f"{route:<7} {kind}{note}{pay}")
        if e.get("bug_raised"):
            lines.append(f"{e.get('t_us', 0):>12,} µs  "
                         f"*** INVARIANT VIOLATION RAISED HERE ***")
    return "\n".join(lines)


def dump_chrome(doc: Dict[str, Any], path: str) -> None:
    """Write a trace document to ``path`` as JSON."""
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")
