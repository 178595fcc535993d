"""Failure triage in the port (madsim_tpu_torch/triage) against the JAX
package on the CPU, bitwise:

- the schedule algebra (``shrink``): every candidate generator and the
  cost order on seeded random schedules;
- ``minimize_rows`` on a pure oracle: the minimized schedule and the
  loop's statistics;
- ``minimize`` on the pair-restart bug (the port's engine on
  ``device="cpu"``): the final schedule, the round history, the rounds,
  the candidates and ``provenance()`` equal JAX's in the serial and the
  pipelined loop, one sweep per round, and the JAX-derived pin of
  bench.py's minimize_bug leg (``golden.GOLDEN_MINIMIZE``) that
  ``chip_smoke.py`` holds the card to;
- a schedule-independent failure minimizes to empty, a non-failing seed
  raises ``TriageError``, and ``SweepResult.minimize`` round-trips;
- the bug corpus: k injected classes dedupe to exactly k, with JAX's
  keys, and ``behavior_signatures`` equals JAX's and the device
  preimage (``obs.coverage.behavior_signature``);
- a compiled family's ``triage(..., out_dir=...)``: the pb hunt's
  bundles, which carry the speclint protocol card, are JAX's byte for
  byte, and each package's replay CLI replays the other's; the family
  registry's ``compiled`` flags and classes.

JAX runs on a one-device mesh, as its own tests run on the CPU. W <= 64.
Tolerance: none, every operation is integer.
"""
import importlib

import numpy as np
import pytest
import torch

import madsim_tpu_torch.engine as T
from madsim_tpu.engine import DeviceEngine as JEngine
from madsim_tpu.engine.families import actor_families as j_families
from madsim_tpu.parallel.mesh import seed_mesh
from madsim_tpu.triage import failure_classes as j_failure_classes
from madsim_tpu.triage import minimize as j_minimize
from madsim_tpu.triage import minimize_rows as j_minimize_rows
from madsim_tpu.triage import shrink as jshrink
from madsim_tpu.triage import synthetic as jsyn
from madsim_tpu.triage.corpus import behavior_signatures as j_signatures
from madsim_tpu_torch.engine import families as tfamilies
from madsim_tpu_torch.engine import golden
from madsim_tpu_torch.engine.core import (FAULT_CLOG_LINK, FAULT_KILL,
                                          FAULT_PAUSE, FAULT_RESTART,
                                          FAULT_SET_LATENCY, FAULT_SET_LOSS)
from madsim_tpu_torch.obs.coverage import behavior_signature
from madsim_tpu_torch.obs.metrics import MetricsBlock
tsweep = importlib.import_module("madsim_tpu_torch.parallel.sweep")
from madsim_tpu_torch.triage import (MinimizeResult, TriageError,
                                     behavior_signatures, failure_classes,
                                     minimize, minimize_rows, triage)
from madsim_tpu_torch.triage import shrink
from madsim_tpu_torch.triage import synthetic as tsyn

jsweep = importlib.import_module("madsim_tpu.parallel.sweep")
MESH1 = seed_mesh(n_devices=1)
MIN_KW = dict(chunk_steps=32, max_steps=4_000)
ACFG = tsyn.PairRestartConfig()


@pytest.fixture(scope="module")
def pair_engines():
    """The pair-restart engines of both packages, metrics off."""
    return (JEngine(jsyn.PairRestartActor(jsyn.PairRestartConfig()),
                    jsyn.engine_config(jsyn.PairRestartConfig())),
            T.DeviceEngine(tsyn.PairRestartActor(ACFG),
                           tsyn.engine_config(ACFG), device="cpu"))


@pytest.fixture(scope="module")
def pair_engines_m():
    """The same with the metrics block on."""
    return (JEngine(jsyn.PairRestartActor(jsyn.PairRestartConfig()),
                    jsyn.engine_config(jsyn.PairRestartConfig(),
                                       metrics=True)),
            T.DeviceEngine(tsyn.PairRestartActor(ACFG),
                           tsyn.engine_config(ACFG, metrics=True),
                           device="cpu"))


def random_schedule(rng, n_rows):
    """A schedule of every op kind, some rows disabled."""
    ops = np.array([FAULT_KILL, FAULT_RESTART, FAULT_PAUSE, FAULT_SET_LOSS,
                    FAULT_SET_LATENCY, FAULT_CLOG_LINK], np.int32)
    rows = np.zeros((n_rows, 4), np.int32)
    rows[:, 0] = rng.integers(0, 1_000_000, n_rows)
    rows[:, 1] = rng.choice(ops, n_rows)
    rows[:, 2] = rng.integers(0, 4, n_rows)
    rows[:, 3] = rng.integers(0, 4, n_rows)
    loss = rows[:, 1] == FAULT_SET_LOSS
    rows[loss, 2] = rng.integers(1, 500_000, int(loss.sum()))
    lat = rows[:, 1] == FAULT_SET_LATENCY
    rows[lat, 2] = rng.integers(100, 1_000, int(lat.sum()))
    rows[lat, 3] = rows[lat, 2] + rng.integers(2, 5_000, int(lat.sum()))
    rows[rng.random(n_rows) < 0.2, 0] = -5
    return rows


def same_pairs(a, b):
    assert [p[0] for p in a] == [p[0] for p in b]
    for (_la, ca), (_lb, cb) in zip(a, b):
        assert ca.dtype == cb.dtype
        np.testing.assert_array_equal(ca, cb)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_shrink_candidates_and_cost_order_match_jax(seed):
    rng = np.random.default_rng(seed)
    rows = random_schedule(rng, 3 + 4 * seed)
    np.testing.assert_array_equal(shrink.as_schedule(rows),
                                  jshrink.as_schedule(rows))
    sched = shrink.normalize(rows)
    np.testing.assert_array_equal(sched, jshrink.normalize(rows))
    np.testing.assert_array_equal(shrink.DISABLED_ROW, jshrink.DISABLED_ROW)
    assert shrink.n_live(sched) == jshrink.n_live(sched)
    np.testing.assert_array_equal(shrink.compact(sched),
                                  jshrink.compact(sched))
    for k in (1, 2, 3, 5, 64):
        same_pairs(shrink.subset_candidates(sched, k),
                   jshrink.subset_candidates(sched, k))
    for gen in ("single_drop_candidates", "weaken_candidates",
                "tighten_candidates"):
        same_pairs(getattr(shrink, gen)(sched), getattr(jshrink, gen)(sched))
    # The total order: the same ranking of every candidate.
    cands = (shrink.subset_candidates(sched, 3)
             + shrink.weaken_candidates(sched)
             + shrink.tighten_candidates(sched))
    costs = [shrink.schedule_cost(c) for _l, c in cands]
    assert costs == [jshrink.schedule_cost(c) for _l, c in cands]
    for _l, c in shrink.weaken_candidates(sched) \
            + shrink.tighten_candidates(sched):
        assert shrink.schedule_cost(c) < shrink.schedule_cost(sched)
    with pytest.raises(ValueError, match=r"\(F, 4\)"):
        shrink.as_schedule(np.zeros((3, 5), np.int32))
    assert shrink.as_schedule(None).shape == (0, 4)


def test_minimize_rows_on_a_pure_oracle_matches_jax():
    """'Fails iff row 2 is a live KILL or PAUSE and row 5 is live': ddmin
    keeps the two rows, the weakening turns the KILL into a PAUSE."""
    rows = random_schedule(np.random.default_rng(7), 9)
    rows[2] = [1_000, FAULT_KILL, 1, 0]
    rows[5] = [2_000, FAULT_SET_LOSS, 300_000, 0]

    def evaluate(cands):
        return np.array([c[2, 0] >= 0 and int(c[2, 1]) in
                         (FAULT_KILL, FAULT_PAUSE) and c[5, 0] >= 0
                         for c in cands], bool)

    for kw in (dict(), dict(weaken=False), dict(tighten=True)):
        final, stats = minimize_rows(rows, evaluate, **kw)
        j_final, j_stats = j_minimize_rows(rows, evaluate, **kw)
        np.testing.assert_array_equal(final, j_final)
        assert stats == j_stats
    assert shrink.compact(final).shape == (2, 4)
    with pytest.raises(TriageError, match="does not fail"):
        minimize_rows(rows, lambda cands: np.zeros(len(cands), bool))
    with pytest.raises(TriageError, match="did not converge"):
        minimize_rows(rows, evaluate, max_rounds=2)


@pytest.fixture(scope="module")
def jax_pair_minimize(pair_engines):
    """JAX's minimization of the 32-row pair bug, in both loops."""
    je, _te = pair_engines
    rows = tsyn.pair_schedule(n_rows=32, need=(5, 20), acfg=ACFG)
    return rows, {p: j_minimize(None, je.cfg, 7, rows, engine=je,
                                mesh=MESH1, pipeline=p, **MIN_KW)
                  for p in (True, False)}


@pytest.mark.parametrize("pipeline", [True, False])
def test_minimize_on_the_pair_bug_matches_jax(pair_engines,
                                              jax_pair_minimize, pipeline,
                                              monkeypatch):
    """The known-minimal case: exactly rows {5, 20} of 32, with JAX's
    history, rounds, candidates and provenance, each round one sweep."""
    _je, te = pair_engines
    rows, jres = jax_pair_minimize
    calls = []
    real = tsweep.sweep

    def counting_sweep(actor, cfg, seeds, **kw):
        calls.append(len(np.asarray(seeds)))
        return real(actor, cfg, seeds, **kw)

    monkeypatch.setattr(tsweep, "sweep", counting_sweep)
    tr = minimize(None, te.cfg, 7, rows, engine=te, pipeline=pipeline,
                  **MIN_KW)
    jr = jres[pipeline]
    assert isinstance(tr, MinimizeResult)
    for f in ("original", "full", "schedule"):
        a, b = getattr(tr, f), getattr(jr, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert (tr.schedule == rows[[5, 20]]).all() and tr.one_minimal
    assert tr.history == jr.history
    assert (tr.rounds, tr.candidates_evaluated) == \
        (jr.rounds, jr.candidates_evaluated)
    assert tr.weakenings == jr.weakenings
    assert tr.provenance() == jr.provenance()
    assert tr.summary() == jr.summary()
    # One sweep per round, each padded to a power of two.
    assert len(calls) == tr.rounds
    assert all(c & (c - 1) == 0 for c in calls)
    assert sum(calls) >= tr.candidates_evaluated > tr.rounds
    # Serial and pipelined agree (their provenance differs in the knob).
    assert golden.minimize_digest(tr) == golden.minimize_digest(
        jres[not pipeline])


def test_minimize_pin_of_the_bench_leg(pair_engines):
    """bench.py's minimize_bug leg at its width (64 rows, need (10, 42),
    seed 7): the port reproduces the JAX-derived pin, and JAX still
    gives it."""
    je, te = pair_engines
    c = golden.MINIMIZE_BUG
    rows = tsyn.pair_schedule(n_rows=c["n_rows"], need=c["need"],
                              acfg=ACFG)
    kw = dict(chunk_steps=c["chunk_steps"], max_steps=c["max_steps"])
    jr = j_minimize(None, je.cfg, c["seed"], rows, engine=je, mesh=MESH1,
                    **kw)
    assert golden.minimize_digest(jr) == golden.GOLDEN_MINIMIZE
    tr = minimize(None, te.cfg, c["seed"], rows, engine=te, **kw)
    assert golden.minimize_digest(tr) == golden.GOLDEN_MINIMIZE
    assert (tr.schedule == rows[list(c["need"])]).all()


def test_schedule_independent_failure_minimizes_to_empty():
    class AlwaysBug(tsyn.PairRestartActor):
        def invariant(self, cfg, s):
            return s["restarts"][..., 0] >= 0          # a tautology

    eng = T.DeviceEngine(AlwaysBug(ACFG), tsyn.engine_config(ACFG),
                         device="cpu")
    rows = tsyn.pair_schedule(n_rows=4, need=(0, 3), acfg=ACFG)
    res = minimize(None, eng.cfg, 3, rows, engine=eng, **MIN_KW)
    assert res.final_rows == 0 and res.schedule.shape == (0, 4)
    assert res.one_minimal
    assert [h["phase"] for h in res.history] == ["verify-original",
                                                 "verify-1min"]


def test_minimize_rejects_a_non_failing_seed(pair_engines):
    _je, te = pair_engines
    rows = tsyn.pair_schedule(n_rows=8, need=(1, 6), acfg=ACFG)
    rows[6, 2] = 0                    # node_b never restarts
    with pytest.raises(TriageError, match="does not fail"):
        minimize(None, te.cfg, 7, rows, engine=te, **MIN_KW)


def test_sweep_result_minimize_round_trips(pair_engines):
    """SweepResult.minimize(seed) takes the seed's own row of per-world
    schedules and the sweep's engine; it equals a direct call."""
    _je, te = pair_engines
    n = 8
    rows = tsyn.pair_schedule(n_rows=8, need=(1, 6), acfg=ACFG)
    faults = np.broadcast_to(rows, (n, 8, 4)).copy()
    faults[1::2, 6, 2] = 0            # odd seeds: decoys, must pass
    res = tsweep.sweep(None, te.cfg, np.arange(n), faults=faults,
                       engine=te, **MIN_KW)
    assert res.failing_seeds == [0, 2, 4, 6]
    mr = res.minimize(**MIN_KW)        # the first failing seed
    direct = minimize(None, te.cfg, 0, rows, engine=te, **MIN_KW)
    assert mr.seed == 0
    np.testing.assert_array_equal(mr.full, direct.full)
    assert mr.history == direct.history
    assert (mr.schedule == rows[[1, 6]]).all()
    assert res.minimize(seed=4, pipeline=False, **MIN_KW).history \
        == direct.history
    with pytest.raises(TriageError, match="not part of this sweep"):
        res.minimize(seed=999, **MIN_KW)
    with pytest.raises(TriageError, match="does not fail"):
        res.minimize(seed=1, **MIN_KW)
    bare = tsweep.SweepResult(seeds=np.arange(2, dtype=np.uint64),
                              bug=np.array([True, False]),
                              observations={"bug": np.array([True, False])},
                              steps_run=0, n_devices=1)
    with pytest.raises(TriageError, match="no triage context"):
        bare.minimize()


def k_class_faults(n=24):
    """Per-world schedules of 2 / 4 / 8 live restart rows, each holding
    the pair: three failure classes (their fault_hist buckets differ)."""
    f = np.full((n, 8, 4), -1, np.int32)
    f[:, :, 1:] = 0
    for w in range(n):
        k = (2, 4, 8)[w % 3]
        f[w, :k] = tsyn.pair_schedule(n_rows=k, need=(0, k - 1), acfg=ACFG)
    return f


@pytest.fixture(scope="module")
def k_class_sweeps(pair_engines_m):
    je, te = pair_engines_m
    faults = k_class_faults()
    kw = dict(faults=faults, **MIN_KW)
    return (jsweep.sweep(None, je.cfg, np.arange(24), engine=je, mesh=MESH1,
                         **kw),
            tsweep.sweep(None, te.cfg, np.arange(24), engine=te, **kw))


def test_k_injected_classes_dedupe_to_exactly_k(k_class_sweeps):
    jr, tr = k_class_sweeps
    assert tr.failing_seeds == list(range(24))
    classes = failure_classes(tr)
    assert len(classes) == 3
    assert [c.representative for c in classes] == [0, 1, 2]
    assert all(c.invariant_id == "pair_restart_conjunction"
               for c in classes)
    j_classes = j_failure_classes(jr)
    assert [(c.key, c.signature, c.invariant_id, c.count)
            for c in classes] == [(c.key, c.signature, c.invariant_id,
                                   c.count) for c in j_classes]
    for a, b in zip(classes, j_classes):
        np.testing.assert_array_equal(a.seeds, b.seeds)
    # Bucketing only, no minimization.
    report = triage(tr, minimize=False)
    assert report.minimized == {} and report.bundles == {}
    assert report.summary().startswith(
        "triage: 24 failing seed(s) in 3 distinct failure class(es)")


def test_behavior_signatures_equal_jax_and_the_device_preimage(
        k_class_sweeps):
    jr, tr = k_class_sweeps
    per_seed = tr.metrics["per_seed"]
    host = behavior_signatures(per_seed)
    assert host.dtype == np.uint32
    np.testing.assert_array_equal(host, j_signatures(jr.metrics["per_seed"]))
    mb = MetricsBlock(**{f: torch.from_numpy(np.asarray(per_seed[f]))
                         for f in MetricsBlock._fields})
    dev = behavior_signature(mb).numpy().astype(np.uint32)
    np.testing.assert_array_equal(host, dev)


def test_triage_needs_metrics_and_a_context(pair_engines):
    _je, te = pair_engines
    res = tsweep.sweep(None, te.cfg, np.arange(4),
                       faults=tsyn.pair_schedule(n_rows=4, need=(0, 3),
                                                 acfg=ACFG),
                       engine=te, **MIN_KW)
    with pytest.raises(ValueError, match="metrics=True"):
        failure_classes(res)


def test_compiled_family_triage_bundles_equal_jax_and_replay_across(
        tmp_path):
    """A spec-backed actor's bundle carries the speclint protocol card:
    the pb hunt's triage bundles (16 seeds, metrics on, ``minimize=False``)
    are JAX's byte for byte, card included, and each package's replay CLI
    replays the other's bundle to the invariant raise."""
    import filecmp
    import io
    from contextlib import redirect_stderr, redirect_stdout

    from madsim_tpu.engine import EngineConfig as JEngineConfig
    from madsim_tpu.obs import cli as jcli
    from madsim_tpu.triage import triage as j_triage
    from madsim_tpu_torch.obs import bundle as tbundle
    from madsim_tpu_torch.obs import cli as tcli

    fam, ak, ck, faults, _steps = golden.FAMILY_CONFIGS["pb_hunt"]
    ck = dict(ck, metrics=True)
    jf, tf = j_families()[fam], tfamilies.family(fam)
    je = JEngine(jf.actor_cls(jf.config_cls(**ak)), JEngineConfig(**ck))
    te = T.DeviceEngine(tf.actor_cls(tf.config_cls(**ak)),
                        T.EngineConfig(**ck), device="cpu")
    seeds = np.arange(16)
    fa = np.asarray(faults, np.int32)
    kw = dict(chunk_steps=64, max_steps=4_000)
    jr = jsweep.sweep(None, je.cfg, seeds, engine=je, mesh=MESH1,
                      faults=fa, **kw)
    tr = tsweep.sweep(None, te.cfg, seeds, engine=te, faults=fa, **kw)
    assert tr.failing_seeds == jr.failing_seeds and tr.failing_seeds
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jrep = j_triage(jr, str(tmp_path / "j"), minimize=False)
    trep = triage(tr, str(tmp_path / "t"), minimize=False)
    assert [c.key for c in trep.classes] == [c.key for c in jrep.classes]
    assert trep.bundles and list(trep.bundles) == list(jrep.bundles)
    for key, path in trep.bundles.items():
        assert filecmp.cmp(path, jrep.bundles[key], shallow=False), key
        card = tbundle.load_bundle(path)["extra"]["protocol_card"]
        assert golden.card_digest(card) == golden.GOLDEN_CARDS["pb_hunt"]

    def quiet(main, argv):
        with redirect_stdout(io.StringIO()), \
                redirect_stderr(io.StringIO()) as err:
            rc = main(argv)
        return rc, err.getvalue()

    out = str(tmp_path / "o.json")
    jpath = next(iter(jrep.bundles.values()))
    tpath = next(iter(trep.bundles.values()))
    rc, err = quiet(tcli.main, ["replay", "--bundle", jpath, "--device",
                                "cpu", "--out", out])
    assert rc == 0 and "invariant RAISED" in err, err
    rc, err = quiet(jcli.main, ["replay", "--bundle", tpath, "--out", out])
    assert rc == 0 and "invariant RAISED" in err, err


def test_family_registry_matches_jax():
    t, j = tfamilies.actor_families(), j_families()
    assert list(t) == list(j)
    for name in t:
        assert t[name].compiled == j[name].compiled, name
        assert t[name].actor_cls.__name__ == j[name].actor_cls.__name__
        assert t[name].config_cls.__name__ == j[name].config_cls.__name__
    assert sorted(n for n in t if t[n].compiled) == ["paxos", "pb", "tpc"]
