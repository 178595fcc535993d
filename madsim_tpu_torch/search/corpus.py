"""The schedule corpus: the parent pool of the guided hunt.

The PyTorch counterpart of ``madsim_tpu/search/corpus.py``, bit for bit. A
fixed-capacity ledger of ``K`` surviving high-novelty ``(F, 4)`` fault
schedules. Novelty is the sketch distance of a retiring world's u32
behavior signature (``obs/coverage.behavior_signature``) against every
filled entry's: the least Hamming distance, :data:`EMPTY_NOVELTY` against
an empty corpus. Insertion is sequential over the retiring worlds, in slot
order, each against the corpus as the previous one left it; a candidate
replaces the lowest-score entry (unfilled entries score -1, so they fill
first; ties go to the lowest index) only if its novelty is at least
``min_novelty`` and strictly above that score.

The rule lives twice, as in the JAX package: :func:`harvest_fold` over
tensors and :func:`host_harvest_fold` over numpy arrays, equal bit for bit.
The sweep folds on the engine's device: on CUDA tensors
:func:`harvest_fold` is one launch of the hand-written kernel
``csrc/corpus_fold.cu`` (:mod:`.fold_kernel`), on the CPU its plain
version, a loop of torch ops (:func:`harvest_fold_plain`). The host twin
serves ``merge_corpus``. Signatures are carried as int64 values in
``[0, 2^32)`` on the device and as ``uint32`` on the host.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

# Novelty against an EMPTY corpus: one more than the largest Hamming
# distance of two u32s, so the first insert always wins.
EMPTY_NOVELTY = 33
# A disabled schedule row in its canonical form (triage's drop-as-disable).
DISABLED_ROW = (-1, 0, 0, 0)


class CorpusState(NamedTuple):
    """The corpus as tensors. ``gen`` counts refill generations (the
    generation half of a child's key), ``inserted`` the inserts; ``entry``
    and ``depth`` are the lineage lanes (obs/lineage.py), written at insert
    and never read by the insertion rule."""

    sched: torch.Tensor     # (K, F, 4) int32 parent schedules
    sig: torch.Tensor       # (K,) int64 u32 behavior signature at insert
    score: torch.Tensor     # (K,) int32 novelty at insert
    filled: torch.Tensor    # (K,) bool
    gen: torch.Tensor       # () int32 refill-generation counter
    inserted: torch.Tensor  # () int32 total inserts
    entry: torch.Tensor     # (K,) int32 lineage entry id (-1 unfilled)
    depth: torch.Tensor     # (K,) int32 ancestry depth at insert


def normalize_schedule(sched: np.ndarray) -> np.ndarray:
    """Every disabled row (time < 0) rewritten to :data:`DISABLED_ROW`."""
    out = np.array(sched, np.int32, copy=True)
    out[out[:, 0] < 0] = DISABLED_ROW
    return out


def corpus_init(k: int, template: np.ndarray, device=None) -> CorpusState:
    """A fresh corpus with the template schedule in slot 0 (entry 0,
    signature 0, score 0), so parents always exist."""
    return corpus_to_device(host_corpus_init(k, template), 0, 0, device)


def corpus_to_device(hc: "HostCorpus", gen: int, inserted: int,
                     device=None) -> CorpusState:
    """A :class:`HostCorpus` and the two counters as a
    :class:`CorpusState` on ``device``."""
    def t(x, dtype):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    return CorpusState(
        sched=t(hc.sched, torch.int32),
        sig=t(np.asarray(hc.sig, np.uint32).astype(np.int64), torch.int64),
        score=t(hc.score, torch.int32), filled=t(hc.filled, torch.bool),
        gen=torch.tensor(gen, dtype=torch.int32, device=device),
        inserted=torch.tensor(inserted, dtype=torch.int32, device=device),
        entry=t(hc.entry, torch.int32), depth=t(hc.depth, torch.int32))


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Per-element population count of u32 values (any integer dtype),
    SWAR in int64; int32 out."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (((x * 0x01010101) & 0xFFFFFFFF) >> 24).to(torch.int32)


def novelty(sig: torch.Tensor, corpus: CorpusState) -> torch.Tensor:
    """The least Hamming distance of one signature to any filled entry's;
    :data:`EMPTY_NOVELTY` when nothing is filled."""
    d = popcount32(sig ^ corpus.sig)
    d = torch.where(corpus.filled, d, EMPTY_NOVELTY)
    return torch.amin(d)


def retiring_mask(w: int, n_act: int, idx: torch.Tensor,
                  active: torch.Tensor) -> torch.Tensor:
    """The fold's rows of a compacted batch: past the live count, holding
    a real seed (``idx >= 0``), and finished (``~active``)."""
    rows = torch.arange(w, dtype=torch.int32, device=idx.device)
    return (rows >= n_act) & (idx >= 0) & ~active


def harvest_fold(corpus: CorpusState, sched: torch.Tensor,
                 sigs: torch.Tensor, fold_mask: torch.Tensor,
                 min_novelty: int, entries: torch.Tensor = None,
                 depths: torch.Tensor = None, with_masks: bool = False):
    """Fold the masked worlds' schedules into the corpus, one row at a time
    in row order (the JAX ``fori_loop``), as torch ops.

    ``sched`` (W, F, 4), ``sigs`` (W,) u32 values, ``fold_mask`` (W,) bool;
    ``entries``/``depths`` the candidates' lineage lanes (default -1 / 0).
    Returns the corpus and the insert count, and with ``with_masks`` the
    per-row ``(novel, inserted)`` masks.

    On CUDA tensors the fold is one launch of the hand-written kernel
    (:mod:`.fold_kernel`, ``csrc/corpus_fold.cu``), which takes absent
    lineage lanes as they are; on the CPU it is this loop of torch ops, the
    kernel's plain version."""
    w = sigs.shape[0]
    dev = sigs.device
    if dev.type == "cuda":
        from .fold_kernel import harvest_fold_cuda

        out = harvest_fold_cuda(corpus, sched, sigs, fold_mask, min_novelty,
                                entries, depths)
        return out if with_masks else out[:2]
    if entries is None:
        entries = torch.full((w,), -1, dtype=torch.int32, device=dev)
    if depths is None:
        depths = torch.zeros((w,), dtype=torch.int32, device=dev)
    return harvest_fold_plain(corpus, sched, sigs, fold_mask, min_novelty,
                              entries, depths, with_masks)


def harvest_fold_plain(corpus: CorpusState, sched: torch.Tensor,
                       sigs: torch.Tensor, fold_mask: torch.Tensor,
                       min_novelty: int, entries: torch.Tensor,
                       depths: torch.Tensor, with_masks: bool = False):
    """:func:`harvest_fold` as torch ops on any device: the plain version of
    the fold kernel (``entries``/``depths`` given)."""
    w = sigs.shape[0]
    dev = sigs.device
    sigs = sigs.to(torch.int64)
    c = corpus
    n_ins = torch.zeros((), dtype=torch.int32, device=dev)
    nov_m = torch.zeros((w,), dtype=torch.bool, device=dev)
    ins_m = torch.zeros((w,), dtype=torch.bool, device=dev)
    k = c.score.shape[0]
    for j in range(w):
        nov = novelty(sigs[j], c)
        key = torch.where(c.filled, c.score, -1)
        tgt = torch.argmin(key)        # the first minimum, as jnp.argmin
        novel_ok = fold_mask[j] & (nov >= min_novelty)
        do = novel_ok & (nov > key[tgt])
        at = (torch.arange(k, device=dev) == tgt) & do
        c = CorpusState(
            sched=torch.where(at[:, None, None], sched[j], c.sched),
            sig=torch.where(at, sigs[j], c.sig),
            score=torch.where(at, nov, c.score),
            filled=c.filled | at,
            gen=c.gen,
            inserted=c.inserted + do.to(torch.int32),
            entry=torch.where(at, entries[j], c.entry),
            depth=torch.where(at, depths[j], c.depth))
        n_ins = n_ins + do.to(torch.int32)
        nov_m[j] = novel_ok
        ins_m[j] = do
    if with_masks:
        return c, n_ins, nov_m, ins_m
    return c, n_ins


# ---------------------------------------------------------------------------
# The host twin
# ---------------------------------------------------------------------------

class HostCorpus(NamedTuple):
    """Host snapshot of a corpus (``sweep(search_corpus=...)`` takes one):
    the arrays of a :class:`CorpusState` without its two counters."""

    sched: np.ndarray   # (K, F, 4) int32
    sig: np.ndarray     # (K,) uint32
    score: np.ndarray   # (K,) int32
    filled: np.ndarray  # (K,) bool
    entry: np.ndarray   # (K,) int32
    depth: np.ndarray   # (K,) int32


def host_corpus_init(k: int, template: np.ndarray) -> HostCorpus:
    """Host twin of :func:`corpus_init`."""
    template = np.asarray(template, np.int32)
    sched = np.zeros((k, template.shape[0], 4), np.int32)
    sched[:, :, 0] = -1                      # DISABLED_ROW sentinels
    sched[0] = template
    filled = np.zeros((k,), bool)
    filled[0] = True
    entry = np.full((k,), -1, np.int32)
    entry[0] = 0                             # the template is entry 0
    return HostCorpus(sched=sched, sig=np.zeros((k,), np.uint32),
                      score=np.zeros((k,), np.int32), filled=filled,
                      entry=entry, depth=np.zeros((k,), np.int32))


def host_popcount32(x: int) -> int:
    """Population count of one u32: the scalar twin of
    :func:`popcount32`."""
    return bin(int(x) & 0xFFFFFFFF).count("1")


_BYTE_POPCOUNT = np.array([bin(i).count("1") for i in range(256)], np.int32)


def _popcount_np(x: np.ndarray) -> np.ndarray:
    """Population counts of a uint32 array, by byte table."""
    b = np.asarray(x, np.uint32).view(np.uint8).reshape(x.shape + (4,))
    return _BYTE_POPCOUNT[b].sum(axis=-1, dtype=np.int32)


def host_harvest_fold(corpus: HostCorpus, sched: np.ndarray,
                      sigs: np.ndarray, fold_mask: np.ndarray,
                      min_novelty: int, entries: np.ndarray = None,
                      depths: np.ndarray = None, with_masks: bool = False):
    """Host twin of :func:`harvest_fold`: the same sequential rule over
    numpy arrays, equal bit for bit. Rows outside ``fold_mask`` do nothing
    and are skipped. Returns the new corpus and the insert count (and the
    ``(novel, inserted)`` masks under ``with_masks``)."""
    c_sched = np.array(corpus.sched, np.int32, copy=True)
    c_sig = np.array(corpus.sig, np.uint32, copy=True)
    c_score = np.array(corpus.score, np.int32, copy=True)
    c_filled = np.array(corpus.filled, bool, copy=True)
    c_entry = np.array(corpus.entry, np.int32, copy=True)
    c_depth = np.array(corpus.depth, np.int32, copy=True)
    sched = np.asarray(sched, np.int32)
    sigs = np.asarray(sigs, np.uint32)
    fold_mask = np.asarray(fold_mask, bool)
    w = sigs.shape[0]
    entries = (np.full((w,), -1, np.int32) if entries is None
               else np.asarray(entries, np.int32))
    depths = (np.zeros((w,), np.int32) if depths is None
              else np.asarray(depths, np.int32))
    nov_m = np.zeros((w,), bool)
    ins_m = np.zeros((w,), bool)
    n_ins = 0
    for j in np.flatnonzero(fold_mask):
        d = _popcount_np(c_sig ^ sigs[j])
        nov = int(np.where(c_filled, d, EMPTY_NOVELTY).min())
        key = np.where(c_filled, c_score, np.int32(-1))
        tgt = int(np.argmin(key))            # first-min ties, like argmin
        nov_m[j] = nov >= int(min_novelty)
        if nov_m[j] and nov > int(key[tgt]):
            c_sched[tgt] = sched[j]
            c_sig[tgt] = sigs[j]
            c_score[tgt] = nov
            c_filled[tgt] = True
            c_entry[tgt] = entries[j]
            c_depth[tgt] = depths[j]
            ins_m[j] = True
            n_ins += 1
    out = HostCorpus(sched=c_sched, sig=c_sig, score=c_score,
                     filled=c_filled, entry=c_entry, depth=c_depth)
    if with_masks:
        return out, n_ins, nov_m, ins_m
    return out, n_ins


def merge_corpus(acc: HostCorpus, src: HostCorpus,
                 min_novelty: int) -> Tuple[HostCorpus, int]:
    """Fold one corpus's filled entries, in slot order, into ``acc``
    (scores recomputed against ``acc``; lineage lanes travel verbatim)."""
    return host_harvest_fold(acc, np.asarray(src.sched, np.int32),
                             np.asarray(src.sig, np.uint32),
                             np.asarray(src.filled, bool), min_novelty,
                             entries=np.asarray(src.entry, np.int32),
                             depths=np.asarray(src.depth, np.int32))


def pick_filled(corpus: CorpusState, draws: torch.Tensor) -> torch.Tensor:
    """u32 draws (int64 values) as indices of filled entries, uniform over
    the filled ones; int32 out, the draws' shape."""
    cum = torch.cumsum(corpus.filled.to(torch.int32), dim=0,
                       dtype=torch.int32)
    n_f = torch.clamp(cum[-1], min=1).to(torch.int64)
    j = (draws % n_f).to(torch.int32)
    # The index of the (j+1)-th filled slot: the first k with cum[k] == j+1.
    return torch.searchsorted(cum, (j + 1).reshape(-1), right=False
                              ).to(torch.int32).reshape(draws.shape)
