"""The behavior-coverage ledger: the sweep's novelty signal.

The PyTorch counterpart of ``madsim_tpu/obs/coverage.py``. Each retiring
world's :class:`~madsim_tpu_torch.obs.metrics.MetricsBlock` histograms are
hashed into one u32 *behavior signature* — every count quantized to its
power-of-two bucket (``bit_length``), the bucketed columns folded with
FNV-1a — and the signatures are folded into a K-bucket sketch on the
device: ``hits`` (worlds per bucket) and ``first_seen`` (the lowest seed id
per bucket, -1 when empty). Both depend only on the set of folded worlds,
not on the order of the folds.

torch has no u32 arithmetic: signatures are int64 tensors holding u32
values, every multiply masked back to 32 bits.

Read-only over the simulation state: nothing here feeds a step.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

#: Default sketch width (buckets).
DEFAULT_BUCKETS = 256

# FNV-1a 32-bit constants (the signature hash).
_FNV_SEED = 0x811C9DC5
_FNV_PRIME = 0x01000193
_U32 = 0xFFFFFFFF

# "No seed folded into this bucket yet" inside the fold (-1 on the host).
_NO_SEED = 2**31 - 1


def _bit_length_u32(x: torch.Tensor) -> torch.Tensor:
    """Per-element ``int.bit_length`` of the u32 reading of ``x`` (int64):
    0→0, 1→1, 2..3→2, 4..7→3, ..."""
    x = x.to(torch.int64) & _U32
    n = torch.zeros_like(x)
    for s in (16, 8, 4, 2, 1):
        hi = x >> s
        move = hi > 0
        n = n + move.to(torch.int64) * s
        x = torch.where(move, hi, x)
    return n + (x > 0).to(torch.int64)


def behavior_signature(mb) -> torch.Tensor:
    """(W,) u32 behavior signature (int64) of a batched MetricsBlock: the
    per-kind histogram, the fault histogram and the drop-cause counters,
    bucketed to powers of two, FNV-1a-folded in a fixed column order.

    The columns are bucketed together, as one (W, C) tensor, and only the
    fold runs column by column: a few ops a column, not a bucketing each
    (the sweep loops sign every chunk)."""
    cols = torch.cat([mb.kind_hist, mb.fault_hist, torch.stack(
        [mb.drop_loss, mb.drop_stale, mb.drop_dead, mb.drop_out_of_time,
         mb.drop_overflow, mb.drop_inf], dim=-1)], dim=-1)
    bits = _bit_length_u32(cols)
    h = torch.full(cols.shape[:-1], _FNV_SEED, dtype=torch.int64,
                   device=cols.device)
    for j in range(cols.shape[-1]):
        h = ((h ^ bits[..., j]) * _FNV_PRIME) & _U32
    return h


def ledger_zeros(n_buckets: int, device=None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A fresh ``(hits, first_seen)`` ledger on ``device``."""
    return (torch.zeros((n_buckets,), dtype=torch.int32, device=device),
            torch.full((n_buckets,), -1, dtype=torch.int32, device=device))


def fold_terms(n_buckets: int, mb, fold_mask, idx):
    """One shard's share of a fold: ``(add, cand)``, the (K,) count of its
    masked worlds a bucket and the least seed id a bucket (``_NO_SEED``
    where none fell there), on the shard's device. Masked-out worlds
    scatter into a dump row past the K buckets, so the fold has no
    branch."""
    bucket = behavior_signature(mb) % n_buckets
    slot = torch.where(fold_mask, bucket, torch.full_like(bucket, n_buckets))
    add = torch.zeros((n_buckets + 1,), dtype=torch.int32,
                      device=slot.device)
    add.scatter_add_(0, slot, torch.ones_like(slot, dtype=torch.int32))
    cand = torch.full((n_buckets + 1,), _NO_SEED, dtype=torch.int32,
                      device=slot.device)
    cand.scatter_reduce_(0, slot, idx.to(torch.int32), "amin")
    return add[:n_buckets], cand[:n_buckets]


def _merge(hits, first_seen, add, cand):
    """The ledger after a fold whose reduced terms are ``add``/``cand``."""
    # first_seen is a minimum seed id, not a temporal first: the fold order
    # cannot change it.
    best = torch.minimum(torch.where(first_seen >= 0, first_seen,
                                     _NO_SEED), cand)
    first_seen = torch.where(best < _NO_SEED, best, -1).to(torch.int32)
    return hits + add, first_seen


def fold_shards(hits, first_seen, parts):
    """Fold the masked worlds' behavior signatures into the ledger, over a
    batch held whole or split into shards: ``parts`` holds one ``(mb,
    fold_mask, idx)`` per shard, each on its own device (``fold_mask``
    (W,) bool selects the worlds, ``idx`` (W,) their seed ids). Each
    shard's terms (:func:`fold_terms`) are computed where it lies and
    reduced onto the ledger's device, the counts by a sum and the seed ids
    by a minimum: the JAX sweep's ``_cov_reducers``. The minimum is taken
    over the candidates, where an empty bucket reads ``_NO_SEED``, never
    over ledgers, whose ``-1`` for an empty bucket would win it. The
    ledger equals one fold over the whole batch: counts and minima do not
    depend on the order they are taken in. Returns the new ``(hits,
    first_seen)``."""
    add = cand = None
    for part in parts:
        a, c = fold_terms(hits.shape[0], *part)
        a, c = a.to(hits.device), c.to(hits.device)
        add = a if add is None else add + a
        cand = c if cand is None else torch.minimum(cand, c)
    return _merge(hits, first_seen, add, cand)


def fold_retired(hits, first_seen, mb, fold_mask, idx):
    """:func:`fold_shards` over a batch held whole."""
    return fold_shards(hits, first_seen, [(mb, fold_mask, idx)])


#: JAX's name for the fold of a batch held whole (the fused hunt's).
fold_retired_local = fold_retired


def distinct_count(hits: torch.Tensor) -> torch.Tensor:
    """Number of non-empty buckets (int32 scalar tensor)."""
    return (hits > 0).sum(dtype=torch.int32)


@dataclasses.dataclass
class SweepCoverage:
    """Host-side coverage ledger of one sweep (``SweepResult.coverage``).

    ``novelty_curve[i]`` is the cumulative distinct-behavior count after
    chunk ``SweepResult.n_active_chunks[i]``. ``distinct_behaviors`` also
    counts the end-of-sweep fold of worlds still live at exit.
    """

    n_buckets: int
    hits: np.ndarray             # (K,) worlds folded per bucket
    first_seen_seed: np.ndarray  # (K,) lowest seed id in bucket; -1 empty
    novelty_curve: np.ndarray    # cumulative distinct per executed chunk

    @property
    def distinct_behaviors(self) -> int:
        return int(np.count_nonzero(self.hits))

    @property
    def new_behaviors_per_chunk(self) -> np.ndarray:
        """Fresh buckets per chunk entry (the curve's derivative)."""
        c = np.asarray(self.novelty_curve, np.int64)
        return np.diff(c, prepend=0)

    def to_json(self) -> Dict[str, object]:
        """Compact JSON-safe record."""
        curve = [int(x) for x in self.novelty_curve]
        return {
            "n_buckets": int(self.n_buckets),
            "distinct_behaviors": self.distinct_behaviors,
            "worlds_folded": int(self.hits.sum()),
            "novelty_first": curve[0] if curve else 0,
            "novelty_last": curve[-1] if curve else 0,
            "novelty_chunks": len(curve),
        }


def coverage_of_counters(counters: Dict[str, np.ndarray],
                         n_buckets: int = DEFAULT_BUCKETS
                         ) -> Dict[str, object]:
    """Host-side ledger over a dict of per-slot counter vectors (JAX's
    ``coverage_of_counters``): the bridge kernel's metrics block, pulled
    once at the sweep's end, bucketized and FNV-folded in numpy u64 over
    its columns in sorted key order."""
    keys = sorted(counters)
    if not keys:
        return {"n_buckets": n_buckets, "distinct_behaviors": 0,
                "worlds_folded": 0}
    w = np.asarray(counters[keys[0]]).shape[0]
    h = np.full((w,), _FNV_SEED, np.uint32)
    for k in keys:
        col = np.asarray(counters[k], np.uint64)
        bl = np.zeros((w,), np.uint32)
        nz = col > 0
        # bit_length by a binary count (no float log2 on u64).
        x = col.copy()
        for s in (32, 16, 8, 4, 2, 1):
            hi = x >> np.uint64(s)
            move = hi > 0
            bl[move] += np.uint32(s)
            x[move] = hi[move]
        bl += nz.astype(np.uint32)
        h = (h ^ bl) * np.uint32(_FNV_PRIME)
    buckets = h % np.uint32(n_buckets)
    hits = np.bincount(buckets, minlength=n_buckets)
    return {
        "n_buckets": int(n_buckets),
        "distinct_behaviors": int(np.count_nonzero(hits)),
        "worlds_folded": int(w),
    }


def coverage_from_device(n_buckets: int, hits, first_seen,
                         novelty: Optional[list]) -> SweepCoverage:
    """Assemble the host dataclass from the pulled ledger arrays."""
    return SweepCoverage(
        n_buckets=int(n_buckets),
        hits=np.asarray(hits, np.int64),
        first_seen_seed=np.asarray(first_seen, np.int64),
        novelty_curve=np.asarray(novelty or [], np.int64),
    )
