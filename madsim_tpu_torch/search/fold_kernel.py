"""The corpus insertion fold as one hand-written CUDA kernel
(``csrc/corpus_fold.cu``).

:func:`~madsim_tpu_torch.search.corpus.harvest_fold` calls
:func:`harvest_fold_cuda` on CUDA tensors; on the CPU it runs its plain
version, a loop of torch ops, which the kernel is held to bit for bit. The
kernel is one warp over the rows in order, the corpus's signatures and keys
in shared memory (see the source for the rule and the design). It takes a
corpus of at most :data:`MAX_K` entries.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build

#: Launches of the fold kernel so far; a plain integer.
launches = 0

#: The most corpus entries the kernel holds in shared memory.
MAX_K = 4096

SOURCE = "corpus_fold"


def _lib():
    lib = _build.load(SOURCE)
    if not getattr(lib, "_madsim_typed", False):
        lib.madsim_corpus_fold.argtypes = (
            [ctypes.c_void_p] * 15 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        lib.madsim_corpus_fold.restype = ctypes.c_int
        lib.madsim_fold_chain.argtypes = [ctypes.c_int, ctypes.c_int,
                                          ctypes.c_void_p, ctypes.c_void_p]
        lib.madsim_fold_chain.restype = ctypes.c_int
        lib._madsim_typed = True
    return lib


def harvest_fold_cuda(corpus, sched: torch.Tensor, sigs: torch.Tensor,
                      fold_mask: torch.Tensor, min_novelty: int,
                      entries: torch.Tensor, depths: torch.Tensor):
    """The fold on the card: returns ``(corpus', n_ins, novel, inserted)``
    as :func:`~madsim_tpu_torch.search.corpus.harvest_fold` does with
    ``with_masks``. The corpus's tensors are copied, then folded in place
    by one launch; nothing is read back to the host."""
    global launches
    from .corpus import CorpusState

    dev = sigs.device
    k = int(corpus.score.shape[0])
    w = int(sigs.shape[0])
    if not 1 <= k <= MAX_K:
        raise ValueError(f"the corpus fold kernel takes 1 <= K <= {MAX_K} "
                         f"entries; got {k}")
    c = CorpusState(
        sched=corpus.sched.to(torch.int32).contiguous().clone(),
        sig=corpus.sig.to(torch.int64).contiguous().clone(),
        score=corpus.score.to(torch.int32).contiguous().clone(),
        filled=corpus.filled.to(torch.bool).contiguous().clone(),
        gen=corpus.gen,
        inserted=corpus.inserted.to(torch.int32).reshape(()).clone(),
        entry=corpus.entry.to(torch.int32).contiguous().clone(),
        depth=corpus.depth.to(torch.int32).contiguous().clone())
    row_words = int(c.sched[0].numel())
    ins = (sched.to(torch.int32).contiguous(), sigs.to(torch.int64)
           .contiguous(), fold_mask.to(torch.bool).contiguous(),
           entries.to(torch.int32).contiguous(),
           depths.to(torch.int32).contiguous())
    if tuple(ins[0].shape[1:]) != tuple(c.sched.shape[1:]) or \
            ins[0].shape[0] != w:
        raise ValueError(f"fold rows' schedules {tuple(sched.shape)} do not "
                         f"match the corpus's {tuple(c.sched.shape)}")
    tensors = (c.sched, c.sig, c.score, c.filled, c.entry, c.depth,
               c.inserted) + ins
    for x in tensors:
        if x.device != dev:
            raise ValueError("the corpus fold kernel takes CUDA tensors on "
                             "one device")
    nov_m = torch.empty((w,), dtype=torch.bool, device=dev)
    ins_m = torch.empty((w,), dtype=torch.bool, device=dev)
    n_ins = torch.empty((), dtype=torch.int32, device=dev)
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        status = lib.madsim_corpus_fold(
            *[x.data_ptr() for x in tensors],
            nov_m.data_ptr(), ins_m.data_ptr(), n_ins.data_ptr(), k,
            row_words, w, int(min_novelty), stream)
    if status != 0:
        raise RuntimeError(f"corpus fold kernel: CUDA launch failed with "
                           f"error {status}")
    launches += 1
    return c, n_ins, nov_m, ins_m


def chain_ms(rows: int, k: int, device, reps: int = 5) -> float:
    """Device ms of the fold's dependent chain over ``rows`` masked rows
    and ``k`` corpus entries (``fold_chain_kernel``, no device memory
    traffic): the latency bound of a fold of that many rows, the median
    of ``reps`` CUDA event pairs. A yardstick; it counts in no launch
    count."""
    if not 1 <= k <= MAX_K:
        raise ValueError(f"the fold chain takes 1 <= K <= {MAX_K}; got {k}")
    dev = torch.device(device)
    out = torch.empty((), dtype=torch.int32, device=dev)
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    times = []
    with torch.cuda.device(dev):
        for _ in range(reps + 1):  # the first warms up
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            status = lib.madsim_fold_chain(int(rows), int(k),
                                           out.data_ptr(), stream)
            e1.record()
            if status != 0:
                raise RuntimeError(f"fold chain kernel: CUDA launch failed "
                                   f"with error {status}")
            e1.synchronize()
            times.append(e0.elapsed_time(e1))
    times = sorted(times[1:])
    return times[len(times) // 2]
