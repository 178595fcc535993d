"""Schedule algebra: the candidate generators of the failure minimizer.

The port of ``madsim_tpu/triage/shrink.py``: host-side numpy, the same
functions with the same results.

A fault schedule is an ``(F, 4)`` int32 array of rows ``[time_us, op, a,
b]`` (engine/core.py ``DeviceEngine.init``); rows with ``time_us < 0``
are disabled — which is the representation trick the whole batched
minimizer rests on: every candidate shrink of a schedule keeps the SAME
static ``(F, 4)`` shape (dropping a row means disabling it), so hundreds
of candidates stack into one ``(C, F, 4)`` per-world faults array and
evaluate as ONE sweep (triage/minimize.py).

Three candidate families (the ddmin / delta-debugging algebra):

- **Row subsets** (:func:`subset_candidates`): ddmin-style chunk
  subsets and complements over the live rows at a granularity ``k`` —
  "keep only chunk i" and "drop chunk i".
- **Fire-time tightening** (:func:`tighten_candidates`): per live row,
  halve its fire time (monotone toward 0, so the phase terminates).
- **Severity weakening** (:func:`weaken_candidates`): per live row,
  replace the fault with a strictly weaker one — ``KILL`` → ``PAUSE``,
  ``SET_LOSS ppm`` → 0, ``SET_LATENCY [a, b]`` → the narrowest legal
  window ``[a, a+1]``.

Everything here is host-side numpy and PURE: candidate generation is a
deterministic function of the current schedule alone (canonical chunk
split, canonical emission order, canonical disabled-row sentinel), which
is half of the minimizer's bitwise-reproducibility contract — the other
half is the sweep oracle's own determinism.

"Smaller" is a total order, :func:`schedule_cost`: fewest live rows
first, then the summed severity weight (kills cost more than pauses;
loss/latency rows carry their parameter magnitude), then the summed
fire time, then the lexicographic row tuple as the final tie-break — so
a round's winner among still-failing candidates is unique.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..engine.core import (
    FAULT_CLOG_LINK,
    FAULT_CLOG_NODE,
    FAULT_KILL,
    FAULT_PAUSE,
    FAULT_RESTART,
    FAULT_RESUME,
    FAULT_SET_LATENCY,
    FAULT_SET_LOSS,
    FAULT_UNCLOG_LINK,
    FAULT_UNCLOG_NODE,
)

# The canonical disabled row: every dropped row is rewritten to exactly
# this, so two schedules with the same live rows are bitwise equal no
# matter which candidate path produced them (the lexicographic tie-break
# and the "re-run yields the identical array" gate both rely on it).
DISABLED_ROW = np.array([-1, 0, 0, 0], np.int32)

# Relative severity of a fault op (the weakening partial order's weight):
# a kill is worse than a clog is worse than a net-model change is worse
# than a pause/restart is worse than an un-fault. Scaled by 1e6 so the
# per-row parameter magnitude (loss ppm, latency window width) breaks
# ties WITHIN an op without ever outranking an op change.
_SEVERITY_BASE = {
    FAULT_KILL: 40,
    FAULT_CLOG_LINK: 30,
    FAULT_CLOG_NODE: 30,
    FAULT_SET_LOSS: 20,
    FAULT_SET_LATENCY: 20,
    FAULT_PAUSE: 10,
    FAULT_RESTART: 10,
    FAULT_UNCLOG_LINK: 5,
    FAULT_UNCLOG_NODE: 5,
    FAULT_RESUME: 5,
}


def as_schedule(rows) -> np.ndarray:
    """Coerce to a normalized ``(F, 4)`` int32 schedule (``None`` and
    ``(0, 4)`` both mean "no faults")."""
    if rows is None:
        return np.zeros((0, 4), np.int32)
    arr = np.asarray(rows, np.int32)
    if arr.ndim != 2 or arr.shape[-1] != 4:
        raise ValueError(
            f"a fault schedule is (F, 4) rows of [time_us, op, a, b]; "
            f"got shape {arr.shape}")
    return normalize(arr)


def normalize(sched: np.ndarray) -> np.ndarray:
    """Rewrite every disabled row (time < 0) to :data:`DISABLED_ROW`."""
    out = np.array(sched, np.int32, copy=True)
    out[out[:, 0] < 0] = DISABLED_ROW
    return out


def live_indices(sched: np.ndarray) -> np.ndarray:
    """Indices of the enabled rows, ascending."""
    return np.flatnonzero(sched[:, 0] >= 0)


def n_live(sched: np.ndarray) -> int:
    return int((sched[:, 0] >= 0).sum())


def keep_rows(sched: np.ndarray, keep: np.ndarray) -> np.ndarray:
    """The candidate with ONLY the given (live) row indices enabled."""
    out = np.broadcast_to(DISABLED_ROW, sched.shape).copy()
    keep = np.asarray(keep, np.int64)
    out[keep] = sched[keep]
    return out


def compact(sched: np.ndarray) -> np.ndarray:
    """The live rows alone, original order — the ``(L, 4)`` array a
    repro bundle records."""
    return np.array(sched[sched[:, 0] >= 0], np.int32, copy=True)


def row_severity(row: np.ndarray) -> int:
    """Severity weight of one enabled row (see ``_SEVERITY_BASE``)."""
    op = int(row[1])
    base = _SEVERITY_BASE.get(op, 50)  # unknown ops sort worst
    extra = 0
    if op == FAULT_SET_LOSS:
        extra = int(row[2])                     # ppm
    elif op == FAULT_SET_LATENCY:
        extra = int(row[3]) - int(row[2])       # window width, µs
    return base * 1_000_000 + extra


def schedule_cost(sched: np.ndarray) -> Tuple:
    """The total "smaller-than" order of the minimizer.

    ``(n_live_rows, severity_sum, time_sum, row_tuple)`` — compared
    left to right, so fewest rows always wins, then weakest, then
    earliest-firing, then the unique lexicographic tie-break over the
    normalized array (DISABLED_ROW canonicalization makes it total).
    """
    live = sched[sched[:, 0] >= 0]
    return (
        int(live.shape[0]),
        int(sum(row_severity(r) for r in live)),
        int(live[:, 0].sum()) if live.size else 0,
        tuple(int(x) for x in sched.reshape(-1)),
    )


def split_chunks(live: np.ndarray, k: int) -> List[np.ndarray]:
    """Canonical ddmin chunking: ``k`` nearly-equal contiguous slices of
    the live-row index vector (numpy's array_split order)."""
    k = max(1, min(int(k), live.size))
    return [c for c in np.array_split(live, k) if c.size]


def subset_candidates(sched: np.ndarray, k: int
                      ) -> List[Tuple[str, np.ndarray]]:
    """ddmin row-subset candidates at granularity ``k``.

    Emission order is canonical: every "keep only chunk i" subset first
    (i ascending), then — for ``k > 2``, where they differ from the
    subsets — every "drop chunk i" complement. At ``k == L`` the
    complements are exactly the single-row drops, which is why the row
    phase's no-progress fixpoint certifies 1-minimality.
    """
    live = live_indices(sched)
    if live.size <= 1:
        # Terminal granularity: the only strictly smaller candidate is
        # the empty schedule.
        return ([("drop:all", keep_rows(sched, np.zeros(0, np.int64)))]
                if live.size else [])
    chunks = split_chunks(live, k)
    out: List[Tuple[str, np.ndarray]] = []
    for i, c in enumerate(chunks):
        out.append((f"subset:{i}/{len(chunks)}", keep_rows(sched, c)))
    if len(chunks) > 2:
        for i, c in enumerate(chunks):
            keep = np.setdiff1d(live, c, assume_unique=True)
            out.append((f"complement:{i}/{len(chunks)}",
                        keep_rows(sched, keep)))
    return out


def single_drop_candidates(sched: np.ndarray
                           ) -> List[Tuple[str, np.ndarray]]:
    """One candidate per live row, that row disabled — the 1-minimality
    verification set (every one must STOP failing)."""
    live = live_indices(sched)
    return [(f"drop:{int(i)}",
             keep_rows(sched, np.setdiff1d(live, [i], assume_unique=True)))
            for i in live]


def weaken_candidates(sched: np.ndarray) -> List[Tuple[str, np.ndarray]]:
    """Per-row severity weakenings, canonical order (row index ascending,
    one candidate per applicable weakening). Each is strictly cheaper
    under :func:`schedule_cost`, so the weakening phase terminates."""
    out: List[Tuple[str, np.ndarray]] = []
    for i in live_indices(sched):
        row = sched[i]
        op = int(row[1])
        if op == FAULT_KILL:
            cand = np.array(sched, np.int32, copy=True)
            cand[i, 1] = FAULT_PAUSE
            cand[i, 3] = 0
            out.append((f"weaken:{int(i)}:kill->pause", cand))
        elif op == FAULT_SET_LOSS and int(row[2]) > 0:
            cand = np.array(sched, np.int32, copy=True)
            cand[i, 2] = 0
            out.append((f"weaken:{int(i)}:loss->0", cand))
        elif op == FAULT_SET_LATENCY and int(row[3]) > int(row[2]) + 1:
            cand = np.array(sched, np.int32, copy=True)
            cand[i, 3] = cand[i, 2] + 1  # narrowest legal window
            out.append((f"weaken:{int(i)}:latency-narrow", cand))
    return out


def tighten_candidates(sched: np.ndarray) -> List[Tuple[str, np.ndarray]]:
    """Per-row fire-time tightening: halve the row's time (toward 0).
    Strictly reduces the cost tuple's time_sum, so repeated tightening
    converges; opt-in in the minimizer (it rewrites row values, which
    trades row identity for an earlier, denser repro)."""
    out: List[Tuple[str, np.ndarray]] = []
    for i in live_indices(sched):
        t = int(sched[i, 0])
        if t > 0:
            cand = np.array(sched, np.int32, copy=True)
            cand[i, 0] = t // 2
            out.append((f"tighten:{int(i)}:t{t}->{t // 2}", cand))
    return out
