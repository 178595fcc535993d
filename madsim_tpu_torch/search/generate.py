"""The search generator: harvest the retiring worlds, then mutate.

The PyTorch counterpart of ``madsim_tpu/search/generate.py``. At every
refill of a guided ``sweep(recycle=True, search=...)``
the generator

1. **harvests**: the behavior signature (``obs/coverage.behavior_signature``)
   of every slot retiring in this refill is scored against the corpus and
   the novel ones are folded in, one at a time in slot order
   (search/corpus.py);
2. **generates**: one child schedule per slot, from tournament-selected
   parents of the updated corpus under the splice and mutation operators
   (search/mutate.py), keyed by ``(search seed, slot seed id,
   generation)``.

:func:`generate_body` and :func:`generate_body_lineage` are the JAX
callables' counterparts over tensors; :func:`searcher` caches them per
engine. Their fold is
:func:`~madsim_tpu_torch.search.corpus.harvest_fold`: on CUDA one launch
of the hand-written fold kernel (``csrc/corpus_fold.cu``), on the CPU its
plain version. Every sweep loop runs them at each refill (the fused hunt
inside its device loop, behind a gate) over the whole world axis: on a
mesh the refill epoch gathers the split batch on the mesh's lead device,
where the corpus, the lineage tables and the operator table are kept, so
a refill is one fold launch whatever the mesh, and the children, made for
every slot, are split with the refilled batch.
"""
from __future__ import annotations

import torch

from ..obs.coverage import behavior_signature
from ..obs.lineage import LineageLanes, OperatorTable, credit, ops_bits
from .config import SearchConfig
from .corpus import CorpusState, harvest_fold, retiring_mask
from .mutate import make_children


def generate_body(eng_cfg, scfg: SearchConfig, w: int):
    """The harvest and generate step: ``(state, sched, idx, corpus, n_act,
    new_ids) -> (children, corpus', (n_filled, n_inserted))`` over a
    compacted batch (rows past ``n_act`` retiring).

    ``gate`` (a device bool scalar; the fused hunt's epoch trigger): where
    it is False the fold takes no row and the generation counter stays, so
    the corpus comes back unchanged (the children are then discarded)."""
    def run(state, sched, idx, corpus: CorpusState, n_act, new_ids,
            gate=None):
        if scfg.guided:
            sigs = behavior_signature(state.metrics)
            hmask = retiring_mask(w, n_act, idx, state.active)
            if gate is not None:
                hmask = hmask & gate
            corpus, _ = harvest_fold(corpus, sched, sigs, hmask,
                                     scfg.min_novelty)
        gen1 = corpus.gen + 1
        children = make_children(scfg, eng_cfg, corpus, new_ids, gen1)
        corpus = corpus._replace(gen=gen1 if gate is None else
                                 corpus.gen + gate.to(torch.int32))
        n_filled = torch.sum(corpus.filled, dtype=torch.int32)
        return children, corpus, (n_filled, corpus.inserted)

    return run


def generate_body_lineage(eng_cfg, scfg: SearchConfig, w: int):
    """:func:`generate_body` with the provenance lanes: ``(state, sched,
    idx, corpus, n_act, new_ids, fill_mask, lin, op_tab, lin_base) ->
    (children, child_lin, corpus', op_tab', stats)`` with ``stats`` the
    scalars ``(n_filled, inserted_total, gen, refill_novel,
    refill_inserted)``."""
    def run(state, sched, idx, corpus: CorpusState, n_act, new_ids,
            fill_mask, lin: LineageLanes, op_tab: OperatorTable, lin_base,
            gate=None):
        dev = idx.device
        n_ins = torch.zeros((), dtype=torch.int32, device=dev)
        nov_m = torch.zeros((w,), dtype=torch.bool, device=dev)
        if scfg.guided:
            sigs = behavior_signature(state.metrics)
            hmask = retiring_mask(w, n_act, idx, state.active)
            if gate is not None:
                hmask = hmask & gate
            obits = ops_bits(lin.ops)
            # A retiring world's entry id: its seed position + 1, offset.
            entries = torch.where(idx >= 0, lin_base + idx + 1,
                                  -1).to(torch.int32)
            corpus, n_ins, nov_m, ins_m = harvest_fold(
                corpus, sched, sigs, hmask, scfg.min_novelty,
                entries=entries, depths=lin.depth, with_masks=True)
            op_tab = op_tab._replace(
                novel=credit(op_tab.novel, obits, nov_m),
                survived=credit(op_tab.survived, obits, ins_m))
        gen1 = corpus.gen + 1
        children, child_lin = make_children(scfg, eng_cfg, corpus, new_ids,
                                            gen1, lineage=True)
        op_tab = op_tab._replace(
            produced=credit(op_tab.produced, ops_bits(child_lin.ops),
                            fill_mask))
        corpus = corpus._replace(gen=gen1 if gate is None else
                                 corpus.gen + gate.to(torch.int32))
        n_filled = torch.sum(corpus.filled, dtype=torch.int32)
        stats = (n_filled, corpus.inserted, corpus.gen,
                 torch.sum(nov_m, dtype=torch.int32), n_ins)
        return children, child_lin, corpus, op_tab, stats

    return run


def searcher(eng, scfg: SearchConfig, w: int, f_rows: int):
    """The harvest and generate step for this engine, batch width and
    schedule height (cached on the engine):
    :func:`generate_body_lineage` where ``scfg.lineage``, else
    :func:`generate_body`. On a mesh it runs on the whole world axis, on
    the mesh's lead device."""
    cache = eng.__dict__.setdefault("_searcher_cache", {})
    key = (w, f_rows, scfg)
    if key not in cache:
        body = generate_body_lineage if scfg.lineage else generate_body
        cache[key] = body(eng.cfg, scfg, w)
    return cache[key]
