"""The flight recorder: a per-world ring of the last K step events.

The PyTorch counterpart of ``madsim_tpu/obs/blackbox.py``. With
``EngineConfig(blackbox=K)`` every world carries a :class:`BlackboxRing` in
``WorldState.blackbox``, written by the step (the plain step and the CUDA
kernel alike) and never read for a simulation decision.

The ring records exactly the steps ``DeviceEngine.trace`` records: each
valid processed event (popped, in time, the world active; stale and dead
drops and fault injections included) and the ``invariant`` marker for a bug
that rises on a step that processed no event. A live world records every
step, so record ``r`` is step ``r``: ``pos`` (records written) alone gives
every record's absolute step, and the decoded ring is the suffix of a fresh
``trace()`` of the same seed and schedule (:func:`ring_matches_trace`).

Packing: kind, src, dst and flags ride the code lane (int8 packed), the
wrapped step index the slot lane (int16), and the event time splits over
two payload-lane words (``lanes.split_wide``): 4 + 10·K bytes per world in
the packed profile.

The host half (:func:`decode_ring`, :func:`ring_matches_trace`,
:func:`blackbox_block`) works on numpy arrays. Like the JAX module, this
one imports nothing of the engine; ``trace()`` shares :data:`FAULT_NAMES`.
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch

#: Bundle-block schema id.
SCHEMA = "madsim.blackbox/1"

#: Observation-dict prefix of the ring fields.
OBS_PREFIX = "bb_"

# Flag bits of a record. TIMER/FAULT mirror the event's flags; STALE/DEAD
# are the two popped-but-dropped causes (STALE wins, as in the step); RAISE
# marks the step the bug flag first rose; MARKER the synthetic
# ``invariant`` record of a raise on a step that processed no event.
BB_TIMER = 1
BB_FAULT = 2
BB_DROP_STALE = 4
BB_DROP_DEAD = 8
BB_RAISE = 16
BB_MARKER = 32

#: Fault-op names by op code, shared by ``trace()`` and :func:`decode_ring`.
FAULT_NAMES = {0: "kill", 1: "restart", 2: "clog_node", 3: "unclog_node",
               4: "clog_link", 5: "unclog_link", 6: "set_latency",
               7: "set_loss", 8: "pause", 9: "resume"}


class BlackboxRing(NamedTuple):
    """Per-world event ring, leading world axis W.

    ``pos`` (W,) int32 is the number of records written; record ``r`` lives
    at slot ``r % K`` of the (W, K) lanes.
    """

    pos: torch.Tensor       # (W,) int32
    step_lo: torch.Tensor   # (W, K) slot lane — step index, wrapped
    t_lo: torch.Tensor      # (W, K) payload lane — event time, low half
    t_hi: torch.Tensor      # (W, K) payload lane — event time, high half
    kind: torch.Tensor      # (W, K) code lane — event kind or fault op
    src: torch.Tensor       # (W, K) code lane — source node (-1 marker)
    dst: torch.Tensor       # (W, K) code lane — destination (-1 marker)
    flags: torch.Tensor     # (W, K) code lane — BB_* bits

    @staticmethod
    def zeros(n_worlds: int, k: int, lanes, device=None) -> "BlackboxRing":
        """A fresh ring of depth ``k`` on the config's lane dtypes
        (``lanes`` is an ``engine.lanes.Lanes``)."""
        def z(dtype):
            return torch.zeros((n_worlds, k), dtype=dtype, device=device)

        return BlackboxRing(
            pos=torch.zeros((n_worlds,), dtype=torch.int32, device=device),
            step_lo=z(lanes.slot), t_lo=z(lanes.payload),
            t_hi=z(lanes.payload), kind=z(lanes.code), src=z(lanes.code),
            dst=z(lanes.code), flags=z(lanes.code))


RING_FIELDS = BlackboxRing._fields


def rings_from_observations(obs: Dict[str, np.ndarray]
                            ) -> Optional[Dict[str, np.ndarray]]:
    """The per-seed ring arrays of an observation dict (its ``bb_``
    entries), or ``None`` when the run was blackbox-off."""
    per_seed = {k[len(OBS_PREFIX):]: np.asarray(v)
                for k, v in obs.items() if k.startswith(OBS_PREFIX)}
    return per_seed or None


def ring_depth(obs: Dict[str, np.ndarray]) -> Optional[int]:
    """The ring depth K of a run's observations, or ``None`` when off."""
    v = obs.get(OBS_PREFIX + "step_lo")
    return None if v is None else int(np.asarray(v).shape[-1])


def _join_t(lo: int, hi: int) -> int:
    """Reassemble the split virtual time."""
    return int(np.int32((int(lo) & 0xFFFF) | (int(hi) << 16)))


def decode_ring(ring: Dict[str, np.ndarray], *,
                kind_names: Optional[List[str]] = None
                ) -> List[Dict[str, Any]]:
    """Decode ONE world's ring into trace-shaped records, oldest first.

    ``ring`` is one seed's row of :func:`rings_from_observations` (scalar
    ``pos``, (K,) lanes). Records mirror ``trace()``'s entries without the
    ``payload`` (not recorded) and with an extra ``drop_cause`` ("stale" or
    "dead"). Raises ``ValueError`` when a record's wrapped step index
    contradicts its reconstructed step: a torn ring.
    """
    pos = int(np.asarray(ring["pos"]))
    step_lo = np.asarray(ring["step_lo"])
    k = int(step_lo.shape[-1])
    n = min(pos, k)
    t_lo, t_hi = np.asarray(ring["t_lo"]), np.asarray(ring["t_hi"])
    kind, flags = np.asarray(ring["kind"]), np.asarray(ring["flags"])
    src, dst = np.asarray(ring["src"]), np.asarray(ring["dst"])
    out: List[Dict[str, Any]] = []
    for j in range(n):
        step = pos - n + j          # record r is step r
        idx = step % k
        expect = np.asarray(step).astype(step_lo.dtype)
        if int(step_lo[idx]) != int(expect):
            raise ValueError(
                f"blackbox ring is torn: slot {idx} records wrapped step "
                f"{int(step_lo[idx])} but reconstruction expects step "
                f"{step} (pos={pos}, k={k})")
        fl = int(flags[idx])
        t = _join_t(int(t_lo[idx]), int(t_hi[idx]))
        if fl & BB_MARKER:
            out.append({"step": step, "t_us": t, "kind": "invariant",
                        "timer": False, "src": -1, "dst": -1,
                        "bug_raised": True})
            continue
        kd = int(kind[idx])
        if fl & BB_FAULT:
            name = f"fault:{FAULT_NAMES.get(kd, kd)}"
        elif kind_names is not None and 0 <= kd < len(kind_names):
            name = kind_names[kd]
        else:
            name = str(kd)
        entry: Dict[str, Any] = {
            "step": step, "t_us": t, "kind": name,
            "timer": bool(fl & BB_TIMER),
            "src": int(src[idx]), "dst": int(dst[idx]),
        }
        if fl & (BB_DROP_STALE | BB_DROP_DEAD):
            entry["dropped"] = True
            entry["drop_cause"] = "stale" if fl & BB_DROP_STALE else "dead"
        if fl & BB_RAISE:
            entry["bug_raised"] = True
        out.append(entry)
    return out


def _project_trace(trace: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """``trace()`` entries as ring-comparable records: no payload, no
    ``truncated`` end marker."""
    out = []
    for e in trace:
        if e.get("kind") == "truncated":
            continue
        out.append({k: v for k, v in e.items() if k != "payload"})
    return out


def ring_matches_trace(entries: List[Dict[str, Any]],
                       trace: List[Dict[str, Any]], *,
                       total: Optional[int] = None) -> Optional[str]:
    """Check that a decoded ring is exactly the suffix of a replayed trace.

    ``total`` (the ring's ``pos``) also pins the trace's number of recorded
    events. Returns ``None`` on a match, else a description of the first
    mismatch.
    """
    ref = _project_trace(trace)
    got = [{k: v for k, v in e.items() if k != "drop_cause"}
           for e in entries]
    if total is not None and len(ref) != int(total):
        return (f"replayed trace recorded {len(ref)} events but the ring "
                f"wrote {int(total)} in total — schedule/config drift?")
    if len(got) > len(ref):
        return (f"ring holds {len(got)} events but the replayed trace "
                f"has only {len(ref)}")
    tail = ref[len(ref) - len(got):] if got else []
    for i, (g, r) in enumerate(zip(got, tail)):
        if g != r:
            return (f"ring event {i} (step {g.get('step')}) diverges from "
                    f"the replayed trace: ring {g!r} != trace {r!r}")
    return None


def blackbox_block(entries: List[Dict[str, Any]], *, seed: int, k: int,
                   pos: int, steps: int,
                   faults: Optional[Any] = None) -> Dict[str, Any]:
    """The ``madsim.blackbox/1`` block of one world's ring: the decoded
    records plus what a replay needs (the fault rows the ring was recorded
    under and the world's final step count)."""
    rows = None if faults is None \
        else np.asarray(faults, np.int32).tolist()
    return {
        "schema": SCHEMA,
        "seed": int(seed),
        "k": int(k),
        "n_records": len(entries),
        "n_total": int(pos),
        "steps": int(steps),
        "faults": rows,
        "events": entries,
    }
