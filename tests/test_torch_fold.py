"""The corpus fold on the CPU: the kernel's order of work
(``search/fold_kernel.py::fold_model``), the plain fold
(``harvest_fold_plain``, through ``harvest_fold`` on CPU tensors) and the
host twin (``host_harvest_fold``), each held bitwise to JAX's
``madsim_tpu/search/corpus.py::harvest_fold`` on every corpus lane, the
insert count and the novel and inserted masks; the wrapper's refusals.

Inputs are made with numpy from a seed (and by hypothesis): corpus sizes
K in {1, 2, 31, 32, 33, 64, 4096}; rows W not a multiple of 32, and none;
min_novelty 1 to 33; duplicate and all-equal signatures; tied scores;
unfilled entries; masks empty, full and sparse; every row inserting; the
insert counter near 2^32; lineage lanes absent. The model runs at the
kernel's block and segment sizes and at small ones (so a few dozen rows
cross rounds and segments). Tolerance: none, every operation is integer.
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from madsim_tpu.search import corpus as jcorpus
from madsim_tpu_torch.search import corpus as tcorpus
from madsim_tpu_torch.search import fold_kernel, generate
from madsim_tpu_torch.search.fold_kernel import check_inputs, fold_model

F_ROWS = 3
# (threads, segment rows) of the model: the kernel's, and small ones.
ORDERS = ((fold_kernel.FOLD_THREADS, fold_kernel.SEG_ROWS), (32, 40), (4, 9))


@jax.jit
def _jax_fold(corpus, sched, sigs, mask, min_novelty, entries, depths):
    return jcorpus.harvest_fold(corpus, sched, sigs, mask, min_novelty,
                                entries=entries, depths=depths,
                                with_masks=True)


def make_case(seed, k, w, *, mask="sparse", sigs="pool", min_novelty=None,
              inserted=0, lineage=True, filled=0.5):
    """A fold's inputs from a seed: a host corpus and its counter, the
    rows' (W, F, 4) schedules, u32 signatures, mask, lineage lanes (or
    None) and min_novelty."""
    rng = np.random.default_rng(seed)
    hc = tcorpus.HostCorpus(
        sched=rng.integers(-1, 9, (k, F_ROWS, 4)).astype(np.int32),
        sig=rng.integers(0, 2**32, k, dtype=np.uint64).astype(np.uint32),
        score=rng.integers(-1, 6, k).astype(np.int32),  # ties
        filled=rng.random(k) < filled,
        entry=rng.integers(-1, 99, k).astype(np.int32),
        depth=rng.integers(0, 9, k).astype(np.int32))
    pool = rng.integers(0, 2**32, 5, dtype=np.uint64).astype(np.uint32)
    s = {"pool": lambda: pool[rng.integers(0, 5, w)],
         "all_equal": lambda: np.full(w, pool[0], np.uint32),
         "distinct": lambda: (np.arange(w, dtype=np.uint64) * 2654435761
                              % 2**32).astype(np.uint32),
         "random": lambda: rng.integers(0, 2**32, w, dtype=np.uint64)
         .astype(np.uint32)}[sigs]()
    m = {"sparse": lambda: rng.random(w) < 0.3,
         "full": lambda: np.ones(w, bool),
         "empty": lambda: np.zeros(w, bool)}[mask]()
    rows = rng.integers(-1, 9, (w, F_ROWS, 4)).astype(np.int32)
    ent = rng.integers(0, 999, w).astype(np.int32) if lineage else None
    dep = rng.integers(0, 9, w).astype(np.int32) if lineage else None
    mn = int(rng.integers(1, 34)) if min_novelty is None else min_novelty
    return hc, inserted, rows, s, m, ent, dep, mn


def run_jax(hc, inserted, rows, sigs, mask, ent, dep, mn):
    w = sigs.shape[0]
    jc = jcorpus.CorpusState(
        sched=jnp.asarray(hc.sched), sig=jnp.asarray(hc.sig),
        score=jnp.asarray(hc.score), filled=jnp.asarray(hc.filled),
        gen=jnp.int32(5), inserted=jnp.int32(inserted),
        entry=jnp.asarray(hc.entry), depth=jnp.asarray(hc.depth))
    if w == 0:
        # JAX's fold cannot trace its loop body over no rows (it indexes a
        # zero-length axis); a fold of no rows leaves the corpus as it is.
        return jax.device_get((jc, 0, np.zeros(0, bool), np.zeros(0, bool)))
    out = _jax_fold(jc, jnp.asarray(rows), jnp.asarray(sigs, jnp.uint32),
                    jnp.asarray(mask), jnp.int32(mn),
                    jnp.full((w,), -1, jnp.int32) if ent is None
                    else jnp.asarray(ent),
                    jnp.zeros((w,), jnp.int32) if dep is None
                    else jnp.asarray(dep))
    return jax.device_get(out)


def assert_fold_equal(hc, inserted, rows, sigs, mask, ent, dep, mn):
    """JAX's fold against the model (every order), the plain fold and the
    host twin; returns JAX's insert count."""
    jc, jn, jnov, jins = run_jax(hc, inserted, rows, sigs, mask, ent, dep,
                                 mn)
    want = [np.asarray(getattr(jc, f)) for f in tcorpus.HostCorpus._fields]
    jn = int(jn)

    def same(label, corpus, n_ins, nov, ins):
        for f, a, b in zip(tcorpus.HostCorpus._fields, want, corpus):
            b = np.asarray(b)
            if f == "sig":
                a, b = a.astype(np.int64), b.astype(np.int64)
            assert a.dtype == b.dtype and np.array_equal(a, b), (label, f)
        assert int(n_ins) == jn, label
        assert np.array_equal(np.asarray(nov), jnov), label
        assert np.array_equal(np.asarray(ins), jins), label

    for threads, seg in ORDERS:
        out = fold_model(hc, rows, sigs, mask, mn, ent, dep,
                         threads=threads, seg=seg)
        same(f"model {threads}/{seg}", *out[:4])
        assert out[4]["replaced"] <= min(jn, hc.sig.shape[0])
    same("host twin", *tcorpus.host_harvest_fold(
        hc, rows, sigs, mask, mn, ent, dep, with_masks=True))
    tc = tcorpus.corpus_to_device(hc, 5, inserted, "cpu")
    t = torch.from_numpy
    launched = fold_kernel.launches
    pc, pn, pnov, pins = tcorpus.harvest_fold(
        tc, t(rows), t(sigs.astype(np.int64)), t(mask), mn,
        None if ent is None else t(ent), None if dep is None else t(dep),
        with_masks=True)
    assert fold_kernel.launches == launched  # the CPU runs the plain fold
    same("plain", tcorpus.HostCorpus(
        sched=pc.sched.numpy(), sig=pc.sig.numpy(), score=pc.score.numpy(),
        filled=pc.filled.numpy(), entry=pc.entry.numpy(),
        depth=pc.depth.numpy()), pn, pnov.numpy(), pins.numpy())
    assert int(pc.inserted) == int(jc.inserted) == \
        (inserted + jn + 2**31) % 2**32 - 2**31
    return jn


@pytest.mark.parametrize("k", [1, 2, 31, 32, 33, 64, 4096])
def test_fold_orders_match_jax_at_every_k(k):
    w = 77 if k < 4096 else 45
    jn = assert_fold_equal(*make_case(k, k, w, mask="full", sigs="random",
                                      min_novelty=2))
    assert jn > 0
    assert_fold_equal(*make_case(k + 1, k, w, min_novelty=1))


@pytest.mark.parametrize("case", [
    dict(mask="empty"), dict(mask="full", sigs="all_equal", min_novelty=1),
    dict(mask="full", min_novelty=33, filled=0.0),
    dict(mask="full", min_novelty=33, filled=1.0),
    dict(mask="full", inserted=2**31 - 1, lineage=False, min_novelty=1),
    dict(mask="full", inserted=-2, sigs="random"),
    dict(mask="sparse", sigs="distinct", lineage=False),
], ids=["empty_mask", "all_equal", "min33_unfilled", "min33_filled",
        "int32_wrap_no_lineage", "u32_wrap", "sparse_distinct"])
def test_fold_adversarial_cases_match_jax(case):
    assert_fold_equal(*make_case(7, 32, 77, **case))


def test_fold_with_no_rows_and_every_row_inserting():
    hc, ins, rows, sigs, mask, ent, dep, mn = make_case(3, 32, 0)
    assert assert_fold_equal(hc, ins, rows, sigs, mask, ent, dep, mn) == 0
    # An empty corpus and distinct signatures: every row inserts.
    for k, w in ((64, 64), (33, 33)):
        hc, ins, rows, sigs, mask, ent, dep, _ = make_case(
            4, k, w, mask="full", sigs="distinct", filled=0.0)
        assert assert_fold_equal(hc, ins, rows, sigs, mask, ent, dep,
                                 1) == w


@settings(max_examples=25, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(seed=st.integers(0, 2**32 - 1),
       shape=st.sampled_from([(1, 40), (32, 77), (33, 0), (64, 64)]),
       mask=st.sampled_from(["sparse", "full", "empty"]),
       sigs=st.sampled_from(["pool", "all_equal", "distinct", "random"]),
       min_novelty=st.integers(1, 33),
       inserted=st.sampled_from([0, 2**31 - 1, -1, -3, 12_345]),
       lineage=st.booleans(),
       filled=st.sampled_from([0.0, 0.5, 1.0]))
def test_fold_orders_match_jax_hypothesis(seed, shape, mask, sigs,
                                          min_novelty, inserted, lineage,
                                          filled):
    k, w = shape
    assert_fold_equal(*make_case(seed, k, w, mask=mask, sigs=sigs,
                                 min_novelty=min_novelty, inserted=inserted,
                                 lineage=lineage, filled=filled))


def torch_case(k=8, w=10, device="cpu"):
    hc, ins, rows, sigs, mask, ent, dep, mn = make_case(9, k, w)
    t = lambda x: torch.from_numpy(x).to(device)  # noqa: E731
    return (tcorpus.corpus_to_device(hc, 0, ins, device), t(rows),
            t(sigs.astype(np.int64)), t(mask), t(ent), t(dep), mn)


def test_fold_inputs_refuse_what_the_kernel_does_not_take():
    corpus, rows, sigs, mask, ent, dep, mn = torch_case()
    check_inputs(corpus, rows, sigs, mask, ent, dep)
    check_inputs(corpus, rows, sigs, mask)
    good = dict(corpus=corpus, sched=rows, sigs=sigs, fold_mask=mask,
                entries=ent, depths=dep)
    bad = [
        dict(sigs=sigs.to(torch.int32)),
        dict(fold_mask=mask.to(torch.uint8)),
        dict(sched=rows[:, :2]),
        dict(sched=rows.transpose(1, 2).contiguous().transpose(1, 2)),
        dict(entries=ent[:5]),
        dict(corpus=corpus._replace(sig=corpus.sig.to(torch.int32))),
        dict(corpus=corpus._replace(inserted=corpus.inserted.reshape(1))),
    ]
    for over in bad:
        with pytest.raises(ValueError):
            check_inputs(**dict(good, **over))
    big = tcorpus.corpus_init(fold_kernel.MAX_K + 1, rows[0].numpy())
    with pytest.raises(ValueError, match="K <="):
        check_inputs(big, rows, sigs, mask)
    # The wrapper refuses a CPU tensor (harvest_fold runs the plain fold
    # there); it never falls back.
    launched = fold_kernel.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        fold_kernel.harvest_fold_cuda(corpus, rows, sigs, mask, mn, ent, dep)
    assert fold_kernel.launches == launched


def test_guided_sweeps_hand_the_fold_what_the_kernel_takes(monkeypatch):
    """Every loop's guided refills pass the fold exactly the dtypes,
    shapes and contiguity the kernel takes, so the wrapper converts and
    copies nothing on the main path."""
    thunts = importlib.import_module("madsim_tpu_torch.search.hunts")
    tsweep = importlib.import_module("madsim_tpu_torch.parallel.sweep")
    import madsim_tpu_torch.engine as T

    seen = []
    real = generate.harvest_fold

    def checked(corpus, sched, sigs, mask, min_novelty, entries=None,
                depths=None, with_masks=False):
        check_inputs(corpus, sched, sigs, mask, entries, depths)
        seen.append(entries is not None)
        return real(corpus, sched, sigs, mask, min_novelty, entries,
                    depths, with_masks)

    monkeypatch.setattr(generate, "harvest_fold", checked)
    hunt = thunts.pair_hunt()
    eng = T.DeviceEngine(hunt.actor, hunt.cfg, device="cpu")
    for loop in (dict(pipeline=False), dict(), dict(fused=True)):
        for lineage in (True, False):
            kw = dict(hunt.sweep_kw, faults=hunt.template, **loop)
            tsweep.sweep(None, hunt.cfg, np.arange(64), engine=eng,
                         search=dataclasses.replace(hunt.search(True),
                                                    lineage=lineage), **kw)
    assert seen and any(seen)


@pytest.mark.cuda
def test_fold_kernel_on_the_card_refuses_and_launches_once():
    """On a CUDA device: the wrapper raises on a corpus above MAX_K and on
    a non-contiguous schedule, and a fold is one launch equal to the plain
    fold."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: torch.cuda.is_available() is "
                    "False here")
    corpus, rows, sigs, mask, ent, dep, mn = torch_case(device="cuda")
    big = tcorpus.corpus_init(fold_kernel.MAX_K + 1, rows[0].cpu().numpy(),
                              "cuda")
    with pytest.raises(ValueError, match="K <="):
        fold_kernel.harvest_fold_cuda(big, rows, sigs, mask, mn)
    with pytest.raises(ValueError, match="contiguous"):
        fold_kernel.harvest_fold_cuda(
            corpus, rows.transpose(1, 2).contiguous().transpose(1, 2), sigs,
            mask, mn)
    launched = fold_kernel.launches
    out = tcorpus.harvest_fold(corpus, rows, sigs, mask, mn, ent, dep,
                               with_masks=True)
    assert fold_kernel.launches == launched + 1
    plain = tcorpus.harvest_fold_plain(corpus, rows, sigs, mask, mn, ent,
                                       dep, with_masks=True)
    for a, b in zip(list(out[0]) + list(out[1:]),
                    list(plain[0]) + list(plain[1:])):
        assert torch.equal(a, b)


def test_model_constants_are_the_kernel_sources():
    """The wrapper's and the model's constants are the kernel's: block and
    segment sizes, the largest corpus, and the pointer count of the C
    entry (the members of ``FoldPtrs``)."""
    import pathlib
    import re

    src = (pathlib.Path(fold_kernel.__file__).resolve().parent.parent
           / "csrc" / "corpus_fold.cu").read_text()
    for name in ("FOLD_THREADS", "SEG_ROWS", "MAX_K", "EMPTY_NOVELTY"):
        m = re.search(rf"constexpr int {name} = (\d+);", src)
        assert m and int(m[1]) == getattr(fold_kernel, name), name
    body = src[src.index("struct FoldPtrs {"):src.index("};", src.index(
        "struct FoldPtrs {"))]
    assert len(re.findall(r"\*\s*\w+;", body)) == fold_kernel._N_PTRS
