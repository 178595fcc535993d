"""The corpus insertion fold as one hand-written CUDA kernel
(``csrc/corpus_fold.cu``).

:func:`~madsim_tpu_torch.search.corpus.harvest_fold` calls
:func:`harvest_fold_cuda` on CUDA tensors; on the CPU it runs its plain
version, a loop of torch ops, which the kernel is held to bit for bit. The
kernel is one block of :data:`FOLD_THREADS` threads that takes the rows in
rounds, one row a thread, and commits each round up to its first insert
(see the source for the rule and the design). :func:`fold_model` is that
order in numpy. A fold is one launch, out of place: the wrapper allocates
the new corpus and the masks with ``torch.empty`` and copies nothing. The
kernel takes a corpus of at most :data:`MAX_K` entries.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from .corpus import (EMPTY_NOVELTY, CorpusState, HostCorpus, _popcount_np)

#: Launches of the fold kernel so far; a plain integer.
launches = 0

#: The most corpus entries the kernel holds in shared memory.
MAX_K = 4096
#: Threads of the kernel's one block: the rows of one round.
FOLD_THREADS = 256
#: The most fold rows staged in shared memory at a time.
SEG_ROWS = 4096

SOURCE = "corpus_fold"
_N_PTRS = 22


def _lib():
    lib = _build.load(SOURCE)
    if not getattr(lib, "_madsim_typed", False):
        lib.madsim_corpus_fold.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.madsim_corpus_fold.restype = ctypes.c_int
        lib.madsim_fold_chain.argtypes = [ctypes.c_int] * 4 + [
            ctypes.c_void_p, ctypes.c_void_p]
        lib.madsim_fold_chain.restype = ctypes.c_int
        lib.madsim_fold_empty.argtypes = [ctypes.c_void_p]
        lib.madsim_fold_empty.restype = ctypes.c_int
        lib._madsim_typed = True
    return lib


def check_inputs(corpus: CorpusState, sched: torch.Tensor,
                sigs: torch.Tensor, fold_mask: torch.Tensor,
                entries=None, depths=None) -> None:
    """Checks the kernel's inputs: the corpus lanes and the rows' tensors
    on one device, each of the dtype and shape the kernel reads and
    contiguous (``entries``/``depths`` may be None). Raises ValueError on
    anything else; converts nothing."""
    k = int(corpus.score.shape[0])
    w = int(sigs.shape[0]) if sigs.dim() == 1 else -1
    if not 1 <= k <= MAX_K:
        raise ValueError(f"the corpus fold kernel takes 1 <= K <= {MAX_K} "
                         f"entries; got {k}")
    row = tuple(corpus.sched.shape[1:])
    want = [("corpus.sched", corpus.sched, torch.int32, (k,) + row),
            ("corpus.sig", corpus.sig, torch.int64, (k,)),
            ("corpus.score", corpus.score, torch.int32, (k,)),
            ("corpus.filled", corpus.filled, torch.bool, (k,)),
            ("corpus.entry", corpus.entry, torch.int32, (k,)),
            ("corpus.depth", corpus.depth, torch.int32, (k,)),
            ("corpus.inserted", corpus.inserted, torch.int32, ()),
            ("sched", sched, torch.int32, (w,) + row),
            ("sigs", sigs, torch.int64, (w,)),
            ("fold_mask", fold_mask, torch.bool, (w,))]
    if entries is not None:
        want.append(("entries", entries, torch.int32, (w,)))
    if depths is not None:
        want.append(("depths", depths, torch.int32, (w,)))
    dev = sigs.device
    for name, x, dtype, shape in want:
        if x.device != dev:
            raise ValueError(f"the corpus fold kernel takes tensors on one "
                             f"device: {name} is on {x.device}, sigs on "
                             f"{dev}")
        if x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(f"the corpus fold kernel takes {name} as "
                             f"{dtype} {shape}; got {x.dtype} "
                             f"{tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"the corpus fold kernel takes contiguous "
                             f"tensors; {name} is not")


def harvest_fold_cuda(corpus: CorpusState, sched: torch.Tensor,
                      sigs: torch.Tensor, fold_mask: torch.Tensor,
                      min_novelty: int, entries: torch.Tensor = None,
                      depths: torch.Tensor = None):
    """The fold on the card: returns ``(corpus', n_ins, novel, inserted)``
    as :func:`~madsim_tpu_torch.search.corpus.harvest_fold` does with
    ``with_masks``. One launch, out of place; ``entries``/``depths`` None
    stand for -1 and 0. Nothing is read back to the host."""
    global launches
    check_inputs(corpus, sched, sigs, fold_mask, entries, depths)
    dev = sigs.device
    if dev.type != "cuda":
        raise ValueError(f"the corpus fold kernel takes CUDA tensors; got "
                         f"{dev} (harvest_fold runs the plain version "
                         f"there)")
    k = int(corpus.score.shape[0])
    w = int(sigs.shape[0])
    out = CorpusState(
        sched=torch.empty_like(corpus.sched),
        sig=torch.empty_like(corpus.sig),
        score=torch.empty_like(corpus.score),
        filled=torch.empty_like(corpus.filled), gen=corpus.gen,
        inserted=torch.empty_like(corpus.inserted),
        entry=torch.empty_like(corpus.entry),
        depth=torch.empty_like(corpus.depth))
    nov_m = torch.empty((w,), dtype=torch.bool, device=dev)
    ins_m = torch.empty((w,), dtype=torch.bool, device=dev)
    n_ins = torch.empty((), dtype=torch.int32, device=dev)
    ptrs = (ctypes.c_void_p * _N_PTRS)(*[
        None if x is None else x.data_ptr() for x in (
            corpus.sched, corpus.sig, corpus.score, corpus.filled,
            corpus.entry, corpus.depth, corpus.inserted, sched, sigs,
            fold_mask, entries, depths, out.sched, out.sig, out.score,
            out.filled, out.entry, out.depth, out.inserted, nov_m, ins_m,
            n_ins)])
    # Novelties lie in [0, EMPTY_NOVELTY]: clamping keeps every comparison
    # with min_novelty and fits a C int.
    min_nov = max(0, min(int(min_novelty), EMPTY_NOVELTY + 1))
    row_words = corpus.sched.numel() // k
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = lib.madsim_corpus_fold(ptrs, _N_PTRS, k, row_words, w,
                                        min_nov, stream)
    if status != 0:
        raise RuntimeError(f"corpus fold kernel: CUDA launch failed with "
                           f"error {status}")
    launches += 1
    return out, n_ins, nov_m, ins_m


def fold_model(corpus: HostCorpus, sched, sigs, fold_mask, min_novelty: int,
               entries=None, depths=None, threads: int = FOLD_THREADS,
               seg: int = SEG_ROWS):
    """The kernel's order of work in numpy: segments of ``seg`` rows,
    rounds of ``threads`` rows, each round committed up to its first
    inserting row, the least (key, index) pair refreshed at each insert,
    the corpus written out of place at the end. Returns ``(corpus', n_ins,
    novel, inserted, stats)``, equal to
    :func:`~madsim_tpu_torch.search.corpus.host_harvest_fold` with masks;
    ``stats`` holds the ``rounds`` the fold took, the entries it
    ``replaced`` and the ``filled`` entries it left (yardsticks of
    ``chip_smoke.py``)."""
    sig = np.array(corpus.sig, np.uint32, copy=True)
    filled = np.array(corpus.filled, bool, copy=True)
    key = np.where(filled, np.asarray(corpus.score, np.int64), -1)
    src = np.full(sig.shape, -1, np.int64)
    sched = np.asarray(sched, np.int32)
    sigs = np.asarray(sigs).astype(np.int64)
    sig32 = (sigs & 0xFFFFFFFF).astype(np.uint32)
    fold_mask = np.asarray(fold_mask, bool)
    w = sigs.shape[0]
    nov_m = np.zeros((w,), bool)
    ins_m = np.zeros((w,), bool)
    n_ins = rounds = 0
    t = int(np.argmin(key))          # the first least key
    for lo in range(0, w, seg):
        n = min(seg, w - lo)
        base = 0
        while base < n:
            rows = lo + base + np.arange(min(threads, n - base))
            d = _popcount_np(sig32[rows][:, None] ^ sig[None, filled])
            nov = np.minimum(d.min(axis=1, initial=EMPTY_NOVELTY),
                             EMPTY_NOVELTY)
            m = fold_mask[rows]
            novel = m & (nov >= int(min_novelty))
            would = novel & (nov > key[t])
            rounds += 1
            f = int(np.argmax(would)) if would.any() else rows.size
            nov_m[rows[:f]] = novel[:f]
            if f == rows.size:
                base += threads
                continue
            r = int(rows[f])
            sig[t], filled[t], key[t], src[t] = sig32[r], True, nov[f], r
            nov_m[r] = ins_m[r] = True
            n_ins += 1
            t = int(np.argmin(key))
            base += f + 1
    hit = src >= 0
    rows = src[hit]
    out = HostCorpus(*[np.array(x, dt, copy=True) for x, dt in zip(
        corpus, (np.int32, np.uint32, np.int32, bool, np.int32, np.int32))])
    out.sched[hit] = sched[rows]
    out.sig[hit] = sig[hit]
    out.score[hit] = key[hit]
    out.filled[:] = filled
    out.entry[hit] = -1 if entries is None else np.asarray(entries)[rows]
    out.depth[hit] = 0 if depths is None else np.asarray(depths)[rows]
    stats = dict(rounds=rounds, replaced=int(hit.sum()),
                 filled=int(out.filled.sum()))
    return out, n_ins, nov_m, ins_m, stats


#: Launches a yardstick queues behind a sleeping kernel, and the sleep
#: (about 25 ms at the H100's boost clock) that hides their host cost.
QUEUED = 20
SLEEP_CYCLES = 50_000_000


def _timed_ms(launch, device, per_call: bool, reps: int = 5) -> float:
    """Device ms of ``launch(stream)`` (a ctypes launch returning its
    status): per call, the median of ``reps`` CUDA event pairs each around
    one launch (the host's launch cost inside); else per launch over
    :data:`QUEUED` launches queued behind a sleeping kernel, the best of
    ``reps``. One launch warms up first."""
    dev = torch.device(device)
    times = []
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for rep in range(reps + 1):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            if not per_call and rep:
                torch.cuda._sleep(SLEEP_CYCLES)
            e0.record()
            for _ in range(1 if per_call or not rep else QUEUED):
                status = launch(stream)
                if status != 0:
                    raise RuntimeError(f"fold yardstick kernel: CUDA launch "
                                       f"failed with error {status}")
            e1.record()
            if not per_call and rep and e0.query():
                raise RuntimeError("the device reached the queued launches "
                                   "before they were all queued")
            e1.synchronize()
            times.append(e0.elapsed_time(e1) / (1 if per_call or not rep
                                                else QUEUED))
    times = sorted(times[1:])
    return times[len(times) // 2] if per_call else times[0]


def chain_ms(rounds: int, inserts: int, k: int, filled: int,
             device) -> float:
    """Device ms of the fold's dependent chain: ``rounds`` rounds of the
    kernel's round, each row scanning ``filled`` signatures, ``inserts``
    of them ending in an insert and a reduction over ``k`` keys
    (``fold_chain_kernel``, no device-memory traffic), per launch queued
    behind a sleep. :func:`fold_model`'s ``stats`` give a fold's rounds and
    the filled entries it ends with. A yardstick; it counts in no launch
    count."""
    if not 0 <= filled <= k <= MAX_K or k < 1:
        raise ValueError(f"the fold chain takes 0 <= filled <= K <= {MAX_K}"
                         f", K >= 1; got {filled}, {k}")
    out = torch.empty((), dtype=torch.int32, device=device)
    lib = _lib()
    return _timed_ms(lambda s: lib.madsim_fold_chain(
        int(rounds), int(inserts), int(k), int(filled), out.data_ptr(), s),
        device, per_call=False)


def launch_floor_ms(device, per_call: bool = False) -> float:
    """Device ms of an empty launch of the fold's block shape
    (``fold_empty_kernel``) on the current stream: per launch queued
    behind a sleep (the device's floor), or with ``per_call`` an event
    pair around one launch (the floor under a fold's time per call). A
    yardstick; it counts in no launch count."""
    lib = _lib()
    return _timed_ms(lib.madsim_fold_empty, device, per_call)
