"""The port's guided schedule search (madsim_tpu_torch/search) against the
JAX package on the CPU, bitwise (tolerance 0: every operation is integer).

- the splitmix64 lanes (``search/rng.py``) over edge values, and against
  the host splitmix64;
- the corpus: ``popcount32``, ``novelty``, ``harvest_fold`` with its masks,
  score ties and the ``argmin`` tie, ``pick_filled``, and the host twin
  against the port's own fold;
- ``make_children`` for every operator, at ``time_jitter_us`` 0 and not;
- the guided pair sweep at 128 seeds (the shape of tests/test_search.py),
  guided and random, lineage on and off: every ``SweepResult`` field, the
  ``SearchReport`` and the ``summary()`` string, and the count of device
  pulls against the plain serial sweep's;
- the validation errors of the guided sweep.

Inputs are ``np.arange`` seeds and fixed templates; each JAX sweep runs
once per module.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import madsim_tpu.engine as J
from madsim_tpu.parallel.mesh import seed_mesh
from madsim_tpu.search import corpus as jcorpus
from madsim_tpu.search import hunts as jhunts
from madsim_tpu.search import mutate as jmutate
from madsim_tpu.search import rng as jrng
from madsim_tpu.search.config import SearchConfig as JSearchConfig
import madsim_tpu_torch.engine as T
tsweep = importlib.import_module("madsim_tpu_torch.parallel.sweep")
from madsim_tpu_torch.search import corpus as tcorpus
from madsim_tpu_torch.search import hunts as thunts
from madsim_tpu_torch.search import mutate as tmutate
from madsim_tpu_torch.search import rng as trng
from madsim_tpu_torch.search.config import SearchConfig

jsweep = importlib.import_module("madsim_tpu.parallel.sweep")
MESH1 = seed_mesh(n_devices=1)
M32 = 0xFFFFFFFF
EDGE = [0, 1, 2, 0xFFFF, 0x10000, 0x7FFFFFFF, 0x80000000, 0xFFFEFFFF,
        0xFFFF0000, 0xFFFFFFFE, M32]


def u32(x):
    return np.asarray(x, np.int64) & M32


def tt(x):
    return torch.as_tensor(np.asarray(x, np.int64))


# ---------------------------------------------------------------------------
# splitmix64 lanes
# ---------------------------------------------------------------------------

def test_splitmix_limbs_match_jax_and_the_host_prng_on_edge_values():
    his, los = np.meshgrid(EDGE, EDGE)
    his, los = his.ravel(), los.ravel()
    th, tl = trng.splitmix64_dev((tt(his), tt(los)))
    jh, jl = jrng.splitmix64_dev((jnp.asarray(his, jnp.uint32),
                                  jnp.asarray(los, jnp.uint32)))
    np.testing.assert_array_equal(th.numpy(), u32(jh))
    np.testing.assert_array_equal(tl.numpy(), u32(jl))
    for hi, lo, a, b in zip(his, los, th.tolist(), tl.tolist()):
        x = (int(hi) << 32) | int(lo)
        assert ((a << 32) | b) == trng.splitmix64(x)
    # Products and sums whose limbs carry: every 32x32 product of the
    # edge values.
    a, b = np.meshgrid(EDGE, EDGE)
    t_hi, t_lo = trng._mul32_64(tt(a.ravel()), tt(b.ravel()))
    full = [int(x) * int(y) for x, y in zip(a.ravel(), b.ravel())]
    assert t_hi.tolist() == [f >> 32 for f in full]
    assert t_lo.tolist() == [f & M32 for f in full]
    s_hi, s_lo = trng._add64((tt(a.ravel()), tt(b.ravel())),
                             (tt(b.ravel()), tt(a.ravel())))
    for x, y, h, lo_ in zip(a.ravel(), b.ravel(), s_hi.tolist(),
                            s_lo.tolist()):
        s = (((int(x) << 32) | int(y)) + ((int(y) << 32) | int(x))) \
            & ((1 << 64) - 1)
        assert (h << 32 | lo_) == s


@pytest.mark.parametrize("seed", [0, 0x5EED_5EA7_C4, (1 << 64) - 1])
def test_stream_key_lanes_and_pct_match_jax(seed):
    ids = np.array([0, 1, 5, 2**31 - 1, -1, -2**31], np.int32)
    for gen in (0, 1, 7, 2**31 - 1):
        tk = trng.stream_key(seed, torch.from_numpy(ids), gen)
        jk = jrng.stream_key(seed, jnp.asarray(ids), gen)
        for a, b in zip(tk, jk):
            np.testing.assert_array_equal(a.numpy(), u32(b))
        tl = trng.lanes_u32(tk, 29)
        jl = jrng.lanes_u32(jk, 29)
        np.testing.assert_array_equal(tl.numpy(), u32(jl))
        np.testing.assert_array_equal(trng.pct(tl).numpy(),
                                      np.asarray(jrng.pct(jl)))
    # A stream state at the limbs' edges.
    x0 = (tt(EDGE), tt(EDGE[::-1]))
    np.testing.assert_array_equal(
        trng.lanes_u32(x0, 5).numpy(),
        u32(jrng.lanes_u32((jnp.asarray(EDGE, jnp.uint32),
                            jnp.asarray(EDGE[::-1], jnp.uint32)), 5)))


# ---------------------------------------------------------------------------
# The corpus
# ---------------------------------------------------------------------------

TMPL = np.array([[20_000, J.FAULT_RESTART, 0, 0],
                 [40_000, J.FAULT_KILL, 3, 0],
                 [-1, 0, 0, 0],
                 [60_000, J.FAULT_CLOG_LINK, 1, 2]], np.int32)


def corpora(k, template=TMPL):
    return jcorpus.corpus_init(k, template), tcorpus.corpus_init(k, template)


def assert_corpus_equal(jc, tc):
    for name in jc._fields:
        a, b = np.asarray(getattr(jc, name)), getattr(tc, name)
        b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        if name == "sig":
            a = a.astype(np.int64)
            b = b.astype(np.int64)
        np.testing.assert_array_equal(b, a, err_msg=name)


def test_popcount_and_novelty_match_jax():
    x = np.array(EDGE + [0b1011, 0x55555555, 0xAAAAAAAA], np.int64)
    np.testing.assert_array_equal(
        tcorpus.popcount32(tt(x)).numpy(),
        np.asarray(jcorpus.popcount32(jnp.asarray(x, jnp.uint32))))
    assert [tcorpus.host_popcount32(v) for v in x] == \
        tcorpus.popcount32(tt(x)).tolist()
    jc, tc = corpora(4)
    for sig in (0, 0b1011, M32):
        assert int(tcorpus.novelty(tt(sig), tc)) == \
            int(jcorpus.novelty(jnp.uint32(sig), jc))
    empty_t = tc._replace(filled=torch.zeros(4, dtype=torch.bool))
    assert int(tcorpus.novelty(tt(1), empty_t)) == tcorpus.EMPTY_NOVELTY


def fold_inputs(w=12, k=4):
    """Candidates with ties: repeated signatures (novelty 0 after the
    first insert), equal novelties (score ties) and a corpus full enough
    that the argmin picks among equal scores."""
    rng = np.random.default_rng(1)
    sched = np.broadcast_to(TMPL, (w,) + TMPL.shape).copy()
    sched[:, :, 0] += np.arange(w)[:, None] * 1000
    sigs = np.array([0b1011, 0b1011, 0, 0b111, 0b1110000, 0b111,
                     0xF0F0F0F0, 0x0F0F0F0F, 1, 2, 4, 8][:w], np.int64)
    mask = np.ones(w, bool)
    mask[[4, 9]] = False
    entries = np.arange(w, dtype=np.int32) + 100
    depths = rng.integers(0, 5, w).astype(np.int32)
    return sched, sigs, mask, entries, depths


@pytest.mark.parametrize("min_novelty", [1, 3])
def test_harvest_fold_with_masks_matches_jax_and_the_host_twin(min_novelty):
    sched, sigs, mask, entries, depths = fold_inputs()
    jc, tc = corpora(4)
    j_out = jcorpus.harvest_fold(
        jc, jnp.asarray(sched), jnp.asarray(sigs, jnp.uint32),
        jnp.asarray(mask), min_novelty, entries=jnp.asarray(entries),
        depths=jnp.asarray(depths), with_masks=True)
    t_out = tcorpus.harvest_fold(
        tc, torch.from_numpy(sched), tt(sigs), torch.from_numpy(mask),
        min_novelty, entries=torch.from_numpy(entries),
        depths=torch.from_numpy(depths), with_masks=True)
    assert_corpus_equal(j_out[0], t_out[0])
    assert int(j_out[1]) == int(t_out[1]) > 0
    for a, b in zip(j_out[2:], t_out[2:]):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    # The host twin against the port's own fold, from the same corpus.
    hc = tcorpus.host_corpus_init(4, TMPL)
    h_out = tcorpus.host_harvest_fold(hc, sched, sigs.astype(np.uint32),
                                      mask, min_novelty, entries=entries,
                                      depths=depths, with_masks=True)
    for name in h_out[0]._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(h_out[0], name)).astype(np.int64),
            getattr(t_out[0], name).numpy().astype(np.int64), err_msg=name)
    assert h_out[1] == int(t_out[1])
    for a, b in zip(h_out[2:], t_out[2:]):
        np.testing.assert_array_equal(a, b.numpy())
    # And the JAX package's host twin.
    jh = jcorpus.host_harvest_fold(jcorpus.host_corpus_init(4, TMPL), sched,
                                   sigs.astype(np.uint32), mask,
                                   min_novelty, entries=entries,
                                   depths=depths, with_masks=True)
    for name in jh[0]._fields:
        np.testing.assert_array_equal(getattr(h_out[0], name),
                                      getattr(jh[0], name), err_msg=name)


def test_argmin_takes_the_first_minimum_on_a_score_tie():
    """Every filled entry at the same score: the insert replaces the
    lowest index, in both packages and the host twin."""
    jc, tc = corpora(3)
    full = dict(filled=[True] * 3, score=[2, 2, 2])
    jc = jc._replace(**{k: jnp.asarray(v) for k, v in full.items()})
    tc = tc._replace(filled=torch.ones(3, dtype=torch.bool),
                     score=torch.full((3,), 2, dtype=torch.int32),
                     sig=tt([1, 2, 4]))
    jc = jc._replace(sig=jnp.asarray([1, 2, 4], jnp.uint32))
    sched = np.broadcast_to(TMPL, (1,) + TMPL.shape).copy()
    sig = np.array([0xFF00], np.int64)
    j2, jn = jcorpus.harvest_fold(jc, jnp.asarray(sched),
                                  jnp.asarray(sig, jnp.uint32),
                                  jnp.asarray([True]), 1)
    t2, tn = tcorpus.harvest_fold(tc, torch.from_numpy(sched), tt(sig),
                                  torch.tensor([True]), 1)
    assert int(jn) == int(tn) == 1
    assert_corpus_equal(j2, t2)
    assert int(t2.sig[0]) == 0xFF00 and t2.sig[1:].tolist() == [2, 4]
    assert int(torch.argmin(torch.tensor([3, 1, 1, 2]))) == 1


def test_pick_filled_matches_jax():
    jc, tc = corpora(8)
    filled = np.array([1, 0, 1, 1, 0, 0, 1, 0], bool)
    jc = jc._replace(filled=jnp.asarray(filled))
    tc = tc._replace(filled=torch.from_numpy(filled))
    draws = np.array(EDGE + list(range(20)), np.int64).reshape(-1, 1)
    np.testing.assert_array_equal(
        tcorpus.pick_filled(tc, tt(draws)).numpy(),
        np.asarray(jcorpus.pick_filled(jc, jnp.asarray(draws, jnp.uint32))))


# ---------------------------------------------------------------------------
# Mutation
# ---------------------------------------------------------------------------

MUT_TMPL = np.array([
    [100_000, J.FAULT_KILL, 1, 0], [150_000, J.FAULT_RESTART, 2, 0],
    [200_000, J.FAULT_PAUSE, 0, 0], [250_000, J.FAULT_RESUME, 0, 0],
    [300_000, J.FAULT_CLOG_NODE, 3, 0], [350_000, J.FAULT_UNCLOG_NODE, 3, 0],
    [400_000, J.FAULT_CLOG_LINK, 0, 4], [450_000, J.FAULT_UNCLOG_LINK, 0, 4],
    [500_000, J.FAULT_SET_LATENCY, 2_147_000_000, 2_147_400_000],
    [550_000, J.FAULT_SET_LOSS, 10_000, 0], [-1, 0, 0, 0],
    [1_999_990, J.FAULT_RESTART, 4, 0]], np.int32)


@pytest.mark.parametrize("jitter", [0, 7_777])
@pytest.mark.parametrize("lineage", [False, True])
def test_make_children_every_operator_matches_jax(jitter, lineage):
    ecfg = T.EngineConfig(n_nodes=5, t_limit_us=2_000_000)
    # Every operator at a high rate; a second filled parent with a
    # higher score so the tournament and the splice pick it.
    kw = dict(corpus=4, splice_pct=40, disable_pct=15, time_pct=30,
              node_pct=30, op_pct=25, time_jitter_us=jitter)
    jc, tc = corpora(4, MUT_TMPL)
    other = MUT_TMPL.copy()
    other[:, 0] = np.where(other[:, 0] >= 0, other[:, 0] + 5, -1)
    other[10] = [900_000, J.FAULT_PAUSE, 2, 0]
    upd = dict(filled=np.array([1, 1, 0, 0], bool),
               score=np.array([0, 3, 0, 0], np.int32),
               entry=np.array([0, 17, -1, -1], np.int32),
               depth=np.array([0, 2, 0, 0], np.int32))
    sched = np.stack([MUT_TMPL, other, MUT_TMPL, MUT_TMPL])
    jc = jc._replace(sched=jnp.asarray(sched),
                     **{k: jnp.asarray(v) for k, v in upd.items()})
    tc = tc._replace(sched=torch.from_numpy(sched),
                     **{k: torch.from_numpy(v) for k, v in upd.items()})
    ids = np.arange(64, dtype=np.int32) * 7
    for gen in (1, 9):
        jout = jmutate.make_children(JSearchConfig(**kw), ecfg, jc,
                                     jnp.asarray(ids), jnp.int32(gen),
                                     lineage=lineage)
        tout = tmutate.make_children(SearchConfig(**kw), ecfg, tc,
                                     torch.from_numpy(ids), gen,
                                     lineage=lineage)
        if lineage:
            (jk, jl), (tk, tl) = jout, tout
            for name in jl._fields:
                a, b = np.asarray(getattr(jl, name)), getattr(tl, name)
                assert b.dtype == {"ops": torch.int8}.get(name, torch.int32)
                np.testing.assert_array_equal(b.numpy(), a, err_msg=name)
            ops = tl.ops.to(torch.int32)
            # Every operator applied to some child.
            assert all(bool(((ops >> i) & 1).any()) for i in range(5))
        else:
            jk, tk = jout, tout
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        assert tk.dtype == torch.int32
    # The wrapped SET_LATENCY window and the jittered last row.
    kids = tk.numpy()
    assert (kids[..., 10, 0] >= -1).all()
    assert (kids[kids[..., 0] >= 0][:, 0] < 2_000_000).all()


@pytest.mark.parametrize("lineage", [False, True])
def test_generate_body_matches_jax(lineage):
    """One harvest-and-generate step over a compacted batch whose tail
    retires: the children, their lanes, the corpus, the operator table and
    the stats, as JAX's ``generate_body{,_lineage}`` gives them."""
    import dataclasses

    from madsim_tpu.obs import lineage as jlin
    from madsim_tpu.search import generate as jgen
    from madsim_tpu_torch.obs import lineage as tlin
    from madsim_tpu_torch.search import generate as tgen

    jh, th = jhunts.pair_hunt(), thunts.pair_hunt()
    je = J.DeviceEngine(jh.actor, jh.cfg)
    te = T.DeviceEngine(th.actor, th.cfg, device="cpu")
    w = 16
    scfg = dataclasses.replace(th.search(True), lineage=lineage)
    jscfg = JSearchConfig(**vars(scfg))
    kids = tmutate.make_children(scfg, th.cfg, tcorpus.corpus_init(
        8, th.template), torch.arange(w, dtype=torch.int32), 1).numpy()
    kids[::4, 0, 2] = 1                        # some worlds beacon once
    js = je.run_steps(je.init(np.arange(w), faults=kids), 6)
    ts = te.run_steps(te.init(np.arange(w), faults=kids), 6)
    n_act = 5
    idx = np.arange(w, dtype=np.int32)
    idx[[7, 12]] = -1                          # dead slots are not folded
    active = np.arange(w) < n_act
    js = js._replace(active=jnp.asarray(active))
    ts = ts._replace(active=torch.from_numpy(active))
    new_ids = np.arange(100, 100 + w, dtype=np.int32)
    jc, tc = corpora(8, th.template)
    if not lineage:
        jout = jgen.generate_body(je.cfg, jscfg, w)(
            js, jnp.asarray(kids), jnp.asarray(idx), jc, jnp.int32(n_act),
            jnp.asarray(new_ids))
        tout = tgen.searcher(te, scfg, w, kids.shape[1])(
            ts, torch.from_numpy(kids), torch.from_numpy(idx), tc, n_act,
            torch.from_numpy(new_ids))
        np.testing.assert_array_equal(tout[0].numpy(), np.asarray(jout[0]))
        assert_corpus_equal(jout[1], tout[1])
        assert [int(x) for x in tout[2]] == [int(x) for x in jout[2]]
        return
    fill = np.arange(w) >= n_act
    lin_np = (np.arange(w, dtype=np.int32), np.zeros(w, np.int32) - 1,
              (np.arange(w) % 32).astype(np.int8),
              np.arange(w, dtype=np.int32) % 3)
    jlanes = jlin.LineageLanes(*(jnp.asarray(a) for a in lin_np))
    tlanes = tlin.LineageLanes(*(torch.from_numpy(a) for a in lin_np))
    jout = jgen.generate_body_lineage(je.cfg, jscfg, w)(
        js, jnp.asarray(kids), jnp.asarray(idx), jc, jnp.int32(n_act),
        jnp.asarray(new_ids), jnp.asarray(fill), jlanes, jlin.table_zeros(),
        jnp.int32(7))
    tout = tgen.searcher(te, scfg, w, kids.shape[1])(
        ts, torch.from_numpy(kids), torch.from_numpy(idx), tc, n_act,
        torch.from_numpy(new_ids), torch.from_numpy(fill), tlanes,
        tlin.table_zeros(), 7)
    np.testing.assert_array_equal(tout[0].numpy(), np.asarray(jout[0]))
    for a, b in zip(jout[1], tout[1]):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert_corpus_equal(jout[2], tout[2])
    for a, b in zip(jout[3], tout[3]):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert [int(x) for x in tout[4]] == [int(x) for x in jout[4]]
    assert int(tout[4][4]) > 0, "the fold inserted nothing"


# ---------------------------------------------------------------------------
# The guided pair sweep
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pair_engines():
    jh, th = jhunts.pair_hunt(), thunts.pair_hunt()
    return (J.DeviceEngine(jh.actor, jh.cfg),
            T.DeviceEngine(th.actor, th.cfg, device="cpu"), th)


def run_both(pair_engines, n=128, count=False, **kw):
    je, te, hunt = pair_engines
    kw = dict(dict(hunt.sweep_kw, faults=hunt.template), **kw)
    counts = {"jax": 0, "torch": 0}
    with pytest.MonkeyPatch.context() as mp:
        for mod, name in ((jsweep, "jax"), (tsweep, "torch")):
            def fetch(tree, real=mod._fetch, name=name):
                counts[name] += 1
                return real(tree)

            mp.setattr(mod, "_fetch", fetch)
        jr = jsweep.sweep(None, je.cfg, np.arange(n), engine=je, mesh=MESH1,
                          pipeline=False, **kw)
        tr = tsweep.sweep(None, te.cfg, np.arange(n), engine=te,
                          pipeline=False, **kw)
    return jr, tr, counts


LOOP_COUNTS = ("chunks", "dispatches", "scalar_fetches", "retire_fetches",
               "pipelined", "fused", "superstep_max", "chunk_steps",
               "epochs_on_device", "dispatch_depth")


def assert_search_results_equal(jr, tr):
    """Every SweepResult field, the key order of the observations and the
    metrics aggregate, the SearchReport, and summary()."""
    np.testing.assert_array_equal(tr.seeds, jr.seeds)
    assert list(tr.observations) == list(jr.observations)
    for k, v in jr.observations.items():
        assert tr.observations[k].dtype == v.dtype, k
        np.testing.assert_array_equal(tr.observations[k], v, err_msg=k)
    np.testing.assert_array_equal(tr.bug, jr.bug)
    assert tr.steps_run == jr.steps_run
    for f in ("n_active_history", "n_active_chunks"):
        np.testing.assert_array_equal(getattr(tr, f), getattr(jr, f))
    assert tr.world_utilization == jr.world_utilization
    assert tr.faults_sha256 == jr.faults_sha256
    # The port's loop_stats are JAX's and the device flags its host read.
    assert sorted(tr.loop_stats) == sorted([*jr.loop_stats, "flag_reads"])
    for k in LOOP_COUNTS:
        assert tr.loop_stats[k] == jr.loop_stats[k], k
    for f in ("hits", "first_seen_seed", "novelty_curve"):
        np.testing.assert_array_equal(getattr(tr.coverage, f),
                                      getattr(jr.coverage, f))
    assert list(tr.metrics["aggregate"].items()) == \
        list(jr.metrics["aggregate"].items())
    a, b = jr.search, tr.search
    for f in ("generations", "inserted", "corpus_size", "corpus_capacity"):
        assert getattr(b, f) == getattr(a, f), f
    for f in ("corpus_sched", "corpus_sig", "corpus_score", "corpus_filled",
              "schedules", "corpus_entry", "corpus_depth"):
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(y, x, err_msg=f)
    assert (a.lineage is None) == (b.lineage is None)
    if a.lineage is not None:
        for f in ("parent1", "parent2", "ops", "depth"):
            np.testing.assert_array_equal(getattr(b.lineage, f),
                                          getattr(a.lineage, f))
        assert b.lineage.entry_base == a.lineage.entry_base
        assert b.lineage_depth() == a.lineage_depth()
    assert b.operator_stats == a.operator_stats
    assert b.summary() == a.summary()
    assert b.to_json() == a.to_json()
    assert tr.summary() == jr.summary()
    assert tr.repro_banner() == jr.repro_banner()
    np.testing.assert_array_equal(tr.triage_ctx.faults, jr.triage_ctx.faults)


@pytest.mark.parametrize("mode", ["guided", "random", "guided_no_lineage"])
def test_guided_pair_sweep_matches_jax(pair_engines, mode):
    th = pair_engines[2]
    scfg = th.search(mode != "random")
    if mode == "guided_no_lineage":
        import dataclasses

        scfg = dataclasses.replace(scfg, lineage=False)
    jscfg = JSearchConfig(**{f: getattr(scfg, f) for f in
                             scfg.__dataclass_fields__})
    # The JAX sweep takes its own SearchConfig; the knobs are the same.
    je, te, hunt = pair_engines
    kw = dict(hunt.sweep_kw, faults=hunt.template)
    jr = jsweep.sweep(None, je.cfg, np.arange(128), engine=je, mesh=MESH1,
                      pipeline=False, search=jscfg, **kw)
    tr = tsweep.sweep(None, te.cfg, np.arange(128), engine=te,
                      pipeline=False, search=scfg, **kw)
    assert_search_results_equal(jr, tr)
    if mode == "guided":
        assert tr.failing_seeds == [72]
        assert tr.search.corpus_size > 1 and tr.search.lineage_depth() >= 1
        chain = tr.search.ancestry(72)
        assert chain[-1]["kind"] == "template"
    if mode == "random":
        assert not tr.failing_seeds and tr.search.corpus_size == 1
    if mode == "guided_no_lineage":
        assert tr.search.lineage is None and tr.search.operator_stats is None


def test_guided_fetch_count_equals_the_plain_serial_sweeps(pair_engines):
    """A guided sweep pulls from the device as often as the plain serial
    sweep of the same shape (and as the JAX loop): once per chunk, once
    per retirement and once at the end — the fold rides the retire pull."""
    je, te, hunt = pair_engines
    jr, tr, counts = run_both(pair_engines, n=96,
                              search=JSearchConfig(**vars(hunt.search(True))))
    assert counts["torch"] == counts["jax"] == (
        tr.loop_stats["scalar_fetches"] + tr.loop_stats["retire_fetches"]
        + 1)
    plain = {"n": 0}
    with pytest.MonkeyPatch.context() as mp:
        def fetch(tree, real=tsweep._fetch):
            plain["n"] += 1
            return real(tree)

        mp.setattr(tsweep, "_fetch", fetch)
        pr = tsweep.sweep(None, te.cfg, np.arange(96), engine=te,
                          pipeline=False, faults=hunt.template,
                          **hunt.sweep_kw)
    assert pr.loop_stats["retire_fetches"] == tr.loop_stats["retire_fetches"]
    assert plain["n"] == counts["torch"]


def test_search_validation_errors_match_jax(pair_engines):
    je, te, hunt = pair_engines
    scfg = hunt.search(True)
    cases = [
        (dict(chunk_steps=32, max_steps=256, search=scfg, faults=hunt.template),
         "recycle=True"),
        (dict(hunt.sweep_kw, search=scfg), "fault-schedule template"),
        (dict(search_corpus=tcorpus.host_corpus_init(4, hunt.template),
              faults=hunt.template), "search_corpus"),
        (dict(search_gen0=1), "search_gen0"),
        (dict(search_lin_base=5), "search_lin_base"),
        (dict(search=scfg, search_gen0=-1, faults=hunt.template,
              **hunt.sweep_kw), "search_gen0 must be"),
    ]
    for kw, match in cases:
        kw = {k: v for k, v in kw.items() if k != "max_steps"}
        with pytest.raises(ValueError, match=match):
            tsweep.sweep(None, te.cfg, np.arange(8), engine=te,
                         pipeline=False, **kw)
        jkw = dict(kw)
        if "search" in jkw:
            jkw["search"] = JSearchConfig(**vars(jkw["search"]))
        if "search_corpus" in jkw:
            jkw["search_corpus"] = jcorpus.host_corpus_init(4, hunt.template)
        with pytest.raises(ValueError, match=match):
            jsweep.sweep(None, je.cfg, np.arange(8), engine=je, mesh=MESH1,
                         pipeline=False, **jkw)
    import dataclasses

    te_off = T.DeviceEngine(hunt.actor, dataclasses.replace(
        te.cfg, metrics=False), device="cpu")
    with pytest.raises(ValueError, match="metrics=True"):
        tsweep.sweep(None, te_off.cfg, np.arange(8), engine=te_off,
                     pipeline=False, faults=hunt.template, search=scfg,
                     **hunt.sweep_kw)
    with pytest.raises(ValueError, match="min_novelty"):
        SearchConfig(min_novelty=0)
    with pytest.raises(ValueError, match="cumulative"):
        SearchConfig(disable_pct=60, time_pct=60)
    with pytest.raises(ValueError, match=r"search_corpus.sched"):
        tsweep.sweep(None, te.cfg, np.arange(8), engine=te, pipeline=False,
                     faults=hunt.template, search=scfg,
                     search_corpus=tcorpus.host_corpus_init(4, hunt.template),
                     **hunt.sweep_kw)


def test_seeded_corpus_gen0_and_lin_base_match_jax(pair_engines):
    """``search_corpus`` (a host corpus), ``search_gen0`` and
    ``search_lin_base``: the fleet's entry points, the same in both."""
    je, te, hunt = pair_engines
    k = 32
    hc_t = tcorpus.host_corpus_init(k, hunt.template)
    sched = hc_t.sched.copy()
    sched[1] = hunt.template
    sched[1, 0, 2] = 1
    extra = dict(sched=sched, sig=np.array([0] + [0b101] + [0] * (k - 2),
                                           np.uint32),
                 score=np.array([0, 2] + [0] * (k - 2), np.int32),
                 filled=np.array([True, True] + [False] * (k - 2)),
                 entry=np.array([0, 41] + [-1] * (k - 2), np.int32),
                 depth=np.array([0, 1] + [0] * (k - 2), np.int32))
    hc_t = hc_t._replace(**extra)
    hc_j = jcorpus.host_corpus_init(k, hunt.template)._replace(**extra)
    kw = dict(hunt.sweep_kw, faults=hunt.template, search_gen0=3,
              search_lin_base=1000)
    jr = jsweep.sweep(None, je.cfg, np.arange(64), engine=je, mesh=MESH1,
                      pipeline=False, search_corpus=hc_j,
                      search=JSearchConfig(**vars(hunt.search(True))), **kw)
    tr = tsweep.sweep(None, te.cfg, np.arange(64), engine=te,
                      pipeline=False, search_corpus=hc_t,
                      search=hunt.search(True), **kw)
    assert_search_results_equal(jr, tr)
    assert tr.search.lineage.entry_base == 1000
