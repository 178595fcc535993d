"""The cross-range corpus exchange in the port
(madsim_tpu_torch/fleet/exchange.py) against the JAX package on the CPU,
bitwise (tolerance 0).

The port's counterparts of tests/test_exchange.py:

- the host merge fold (``host_harvest_fold``, which ``merge_corpus``
  rides) equals the port's device fold (``harvest_fold``; on the CPU its
  plain version, the CUDA kernel's reference) and JAX's ``harvest_fold``
  on 12 random folds, twice each, lineage lanes and both masks included;
- the epoch partition, barrier and merge chain; duplicate, tampered and
  torn publishes; the coordinator's crash and resume;
- the exchanged fleet: chaotic == clean == single worker, epoch 0 equal
  to the plain fleet and later epochs changed by the seeding, a single
  epoch invisible, a resume over a populated state; and each of the
  port's exchanged fleets equal to JAX's exchanged fleet on one device
  (``mesh=seed_mesh(n_devices=1)``) on schedules, the merged corpus,
  lineage and operator stats;
- an ``exchange_state.npz`` written by either package resumes in the
  other, on its own and under a whole fleet;
- ``sweep(search_corpus=)`` seeding is invisible with the template corpus
  and adds no ``_fetch``; the validation errors; the stall report;
- bench.py's guided fleet (512 seeds, ranges of 64) holds the
  JAX-derived ``golden.GOLDEN_GUIDED_FLEET`` (recomputed from JAX by the
  test marked ``slow``).

The configuration is tests/test_exchange.py's: the guided pair family at
HUNT_NODES, 96 seeds in ranges of 48 through 32 slots, chunks of 32.
Engines are built with ``device="cpu"``.
"""
import importlib
import shutil

import numpy as np
import pytest
import torch

import madsim_tpu.fleet as jfleet
import madsim_tpu.search as jsearch
from madsim_tpu.engine import DeviceEngine as JDeviceEngine
from madsim_tpu.parallel.mesh import seed_mesh
from madsim_tpu.search import corpus as jcorpus
from madsim_tpu.search.family import hunt_search_config as j_hunt_search
from madsim_tpu_torch.engine import DeviceEngine, golden
from madsim_tpu_torch.fleet import (
    ChaosConfig,
    CorpusExchange,
    ExchangeConfig,
    FleetIntegrityError,
    FleetStalledError,
    TornPayloadError,
    fleet_sweep,
    split_ranges,
)
from madsim_tpu_torch.fleet.exchange import (
    GEN_STRIDE,
    corpus_payload,
    payload_corpus,
)
from madsim_tpu_torch.search import (
    GuidedPairActor,
    GuidedPairConfig,
    engine_config,
    family_schedule,
)
from madsim_tpu_torch.search.corpus import (
    HostCorpus,
    corpus_init,
    harvest_fold,
    host_corpus_init,
    host_harvest_fold,
    merge_corpus,
)
from madsim_tpu_torch.search.family import (
    HUNT_NODES,
    HUNT_ROWS,
    hunt_search_config,
)

sweep_mod = importlib.import_module("madsim_tpu_torch.parallel.sweep")
sweep = sweep_mod.sweep
MESH1 = seed_mesh(n_devices=1)

BATCH = dict(recycle=True, batch_worlds=32, chunk_steps=32)
N_SEEDS = 96
RANGE = 48  # > batch_worlds, so refills (and harvests) actually run
CORPUS_FIELDS = ("sched", "sig", "score", "filled", "entry", "depth")
CHAOS = ChaosConfig(seed=7, kill_at=(("w1", 2),),
                    duplicate_all_completions=True,
                    tear_publish_at=(("w0", 1),),
                    drop_rpc_rate=0.2, restart_after=2)


@pytest.fixture(scope="module")
def hunt():
    acfg = GuidedPairConfig(n=HUNT_NODES)
    cfg = engine_config(acfg)
    eng = DeviceEngine(GuidedPairActor(acfg), cfg, device="cpu")
    return eng, cfg, family_schedule(HUNT_ROWS, acfg)


@pytest.fixture(scope="module")
def jhunt():
    acfg = jsearch.GuidedPairConfig(n=HUNT_NODES)
    cfg = jsearch.engine_config(acfg)
    eng = JDeviceEngine(jsearch.GuidedPairActor(acfg), cfg)
    return eng, cfg, jsearch.family_schedule(HUNT_ROWS, acfg)


def _fleet(eng, cfg, tmpl, exchange=None, chaos=None, n_workers=2,
           n_seeds=N_SEEDS, range_size=RANGE, **kw):
    return fleet_sweep(None, cfg, np.arange(n_seeds), engine=eng,
                       faults=tmpl, n_workers=n_workers,
                       range_size=range_size, max_steps=10_000_000,
                       search=hunt_search_config(True), exchange=exchange,
                       chaos=chaos, **BATCH, **kw)


def _jfleet(jhunt, exchange=None, **kw):
    eng, cfg, tmpl = jhunt
    return jfleet.fleet_sweep(None, cfg, np.arange(N_SEEDS), engine=eng,
                              mesh=MESH1, faults=tmpl, n_workers=2,
                              range_size=RANGE, max_steps=10_000_000,
                              search=j_hunt_search(True), exchange=exchange,
                              **BATCH, **kw)


def assert_bitwise(a, b, search=True):
    np.testing.assert_array_equal(a.seeds, b.seeds)
    np.testing.assert_array_equal(a.bug, b.bug)
    assert set(a.observations) == set(b.observations)
    for k in a.observations:
        np.testing.assert_array_equal(np.asarray(a.observations[k]),
                                      np.asarray(b.observations[k]),
                                      err_msg=k)
    if search:
        assert (a.search is None) == (b.search is None)
        if a.search is not None:
            np.testing.assert_array_equal(a.search.schedules,
                                          b.search.schedules)
            for f in CORPUS_FIELDS:
                np.testing.assert_array_equal(
                    getattr(a.search, f"corpus_{f}"),
                    getattr(b.search, f"corpus_{f}"), err_msg=f)
            la, lb = a.search.lineage, b.search.lineage
            assert (la is None) == (lb is None)
            if la is not None:
                for f in ("parent1", "parent2", "ops", "depth"):
                    np.testing.assert_array_equal(
                        getattr(la, f), getattr(lb, f),
                        err_msg=f"lineage.{f}")
                assert a.search.operator_stats == b.search.operator_stats


# ---------------------------------------------------------------------------
# The twin: host merge fold == device fold == JAX's fold, bit for bit
# ---------------------------------------------------------------------------

def test_host_fold_parity_with_device(hunt):
    """The exchange's merge rides host_harvest_fold: it must reproduce the
    device fold exactly (ties, novelty gating, worst-first replacement,
    empty-corpus scoring, the lineage lanes and both masks), the port's
    and JAX's, from a fresh and from a folded corpus."""
    import jax.numpy as jnp

    _eng, _cfg, tmpl = hunt
    rng = np.random.RandomState(7)
    for trial in range(12):
        k = int(rng.randint(1, 7))
        w = int(rng.randint(1, 9))
        mn = int(rng.randint(1, 5))
        sched = rng.randint(-1, 60, size=(w, tmpl.shape[0], 4)) \
            .astype(np.int32)
        sigs = rng.randint(0, 2**32, size=(w,),
                           dtype=np.uint64).astype(np.uint32)
        mask = rng.rand(w) < 0.7
        entries = rng.randint(1, 500, size=(w,)).astype(np.int32)
        depths = rng.randint(0, 9, size=(w,)).astype(np.int32)
        dev = corpus_init(k, tmpl, device="cpu")
        jdev = jcorpus.corpus_init(k, tmpl)
        host = host_corpus_init(k, tmpl)
        for _round in range(2):  # fold twice: non-fresh corpus state too
            dev, nd, dnov, dins = harvest_fold(
                dev, torch.from_numpy(sched),
                torch.from_numpy(sigs.astype(np.int64)),
                torch.from_numpy(mask), mn,
                entries=torch.from_numpy(entries),
                depths=torch.from_numpy(depths), with_masks=True)
            jdev, jn, jnov, jins = jcorpus.harvest_fold(
                jdev, jnp.asarray(sched), jnp.asarray(sigs),
                jnp.asarray(mask), mn, entries=jnp.asarray(entries),
                depths=jnp.asarray(depths), with_masks=True)
            host, nh, hnov, hins = host_harvest_fold(
                host, sched, sigs, mask, mn, entries=entries,
                depths=depths, with_masks=True)
            assert int(nd) == nh == int(jn)
            for a, b, c in ((dnov, hnov, jnov), (dins, hins, jins)):
                np.testing.assert_array_equal(a.numpy(), b)
                np.testing.assert_array_equal(np.asarray(c), b)
            for name in CORPUS_FIELDS:
                want = np.asarray(getattr(host, name)).astype(np.int64)
                np.testing.assert_array_equal(
                    getattr(dev, name).numpy().astype(np.int64), want,
                    err_msg=f"trial {trial} field {name}")
                np.testing.assert_array_equal(
                    np.asarray(getattr(jdev, name)).astype(np.int64), want,
                    err_msg=f"trial {trial} field {name} (JAX)")
            sigs = rng.randint(0, 2**32, size=(w,),
                               dtype=np.uint64).astype(np.uint32)
    # The host init is the device init (the epoch-0 seed).
    d0, h0 = corpus_init(4, tmpl, device="cpu"), host_corpus_init(4, tmpl)
    for name in CORPUS_FIELDS:
        np.testing.assert_array_equal(
            getattr(d0, name).numpy().astype(np.int64),
            np.asarray(getattr(h0, name)).astype(np.int64))


# ---------------------------------------------------------------------------
# Epoch partition, barrier, merge chain (pure host units)
# ---------------------------------------------------------------------------

def _mk_exchange(n_ranges=4, every=2, k=4, tmpl=None, pkg=None, **kw):
    tmpl = tmpl if tmpl is not None else family_schedule(HUNT_ROWS)
    cls = CorpusExchange if pkg is None else pkg.CorpusExchange
    return cls(ranges=split_ranges(n_ranges * 8, 8), every=every,
               template=tmpl, corpus_k=k, min_novelty=1, **kw)


def _snap(tmpl, k=4, sigs=(9,)):
    c = host_corpus_init(k, tmpl)
    sched = np.broadcast_to(tmpl, (len(sigs),) + tmpl.shape)
    c, _ = host_harvest_fold(c, sched, np.asarray(sigs, np.uint32),
                             np.ones(len(sigs), bool), 1)
    return c


def test_epoch_barrier_and_merge_chain():
    tmpl = family_schedule(HUNT_ROWS)
    ex = _mk_exchange(n_ranges=4, every=2, tmpl=tmpl)
    assert [ex.epoch_of(r) for r in range(4)] == [0, 0, 1, 1]
    assert ex.gen0_of(0) == 0 and ex.gen0_of(2) == GEN_STRIDE
    assert GEN_STRIDE == jfleet.exchange.GEN_STRIDE
    assert ex.eligible(0) and ex.eligible(1)
    assert not ex.eligible(2)
    assert "exchange barrier" in ex.blocked_reason(2)
    assert ex.seed_corpus(0) is None  # epoch 0 = template (no payload)
    s0, s1 = _snap(tmpl, sigs=(9,)), _snap(tmpl, sigs=(12,))
    assert ex.publish(0, corpus_payload(s0), worker="w0")["accepted"]
    assert not ex.eligible(2)  # half-published epoch: still blocked
    assert ex.publish(1, corpus_payload(s1), worker="w1")["accepted"]
    assert ex.eligible(2) and ex.merged_through() == 1
    want, _ = merge_corpus(ex.base, s0, 1)
    want, _ = merge_corpus(want, s1, 1)
    got = ex.seed_corpus(2)
    for name in CORPUS_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(got, name)),
                                      np.asarray(getattr(want, name)))
    assert ex.stats["epochs_merged"] == 1
    # The wire payload is JAX's, checksum included.
    jpay = jfleet.exchange.corpus_payload(
        jcorpus.HostCorpus(*(np.asarray(x) for x in s0)))
    pay = corpus_payload(s0)
    assert pay["sha256"] == jpay["sha256"]


def test_duplicate_publish_dedupe_tamper_and_torn():
    tmpl = family_schedule(HUNT_ROWS)
    ex = _mk_exchange(n_ranges=2, every=1, tmpl=tmpl)
    snap = _snap(tmpl, sigs=(9,))
    assert ex.publish(0, corpus_payload(snap))["accepted"]
    out = ex.publish(0, corpus_payload(snap))
    assert out["accepted"] and out["duplicate"]
    assert ex.stats["publishes_duplicate"] == 1
    bad = HostCorpus(*(np.array(x, copy=True) for x in snap))
    bad.sig[0] ^= np.uint32(1)
    with pytest.raises(FleetIntegrityError, match="bitwise"):
        ex.publish(0, corpus_payload(bad))
    torn = corpus_payload(_snap(tmpl, sigs=(5,)))
    torn["sched"] = torn["sched"].copy()
    torn["sched"].flat[0] ^= 1
    out = ex.publish(1, torn)
    assert not out["accepted"] and out["torn"]
    assert ex.stats["publishes_torn"] == 1
    assert not ex.has(1)
    assert ex.publish(1, corpus_payload(_snap(tmpl, sigs=(5,))))["accepted"]
    with pytest.raises(TornPayloadError, match="checksum"):
        payload_corpus(torn)
    with pytest.raises(TornPayloadError, match="missing"):
        payload_corpus({"sched": torn["sched"]})
    with pytest.raises(TornPayloadError, match="entries"):
        payload_corpus(corpus_payload(snap), corpus_k=9)


def test_coordinator_crash_resume_is_bit_exact(tmp_path):
    tmpl = family_schedule(HUNT_ROWS)
    path = str(tmp_path / "exchange_state.npz")
    a = _mk_exchange(n_ranges=4, every=2, tmpl=tmpl, state_path=path)
    snaps = [_snap(tmpl, sigs=(int(s),)) for s in (9, 12, 33, 70)]
    a.publish(0, corpus_payload(snaps[0]))
    a.publish(1, corpus_payload(snaps[1]))  # epoch 0 merged + persisted
    assert a.merged_through() == 1
    b = _mk_exchange(n_ranges=4, every=2, tmpl=tmpl, state_path=path)
    assert b.resume(path) == 2
    assert b.merged_through() == 1
    for name in CORPUS_FIELDS:
        np.testing.assert_array_equal(
            np.asarray(getattr(a.merged_epoch(0), name)),
            np.asarray(getattr(b.merged_epoch(0), name)), err_msg=name)
    for ex in (a, b):
        ex.publish(2, corpus_payload(snaps[2]))
        ex.publish(3, corpus_payload(snaps[3]))
        assert ex.merged_through() == 2
    for name in CORPUS_FIELDS:
        np.testing.assert_array_equal(
            np.asarray(getattr(a.merged_epoch(1), name)),
            np.asarray(getattr(b.merged_epoch(1), name)), err_msg=name)
    with pytest.raises(FleetIntegrityError, match="different fleet"):
        _mk_exchange(n_ranges=4, every=1, tmpl=tmpl).resume(path)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_exchange_state_interchanges_with_jax(tmp_path, writer):
    """An ``exchange_state.npz`` written by one package resumes in the
    other: the same snapshots restored and the same merged chain."""
    tmpl = family_schedule(HUNT_ROWS)
    path = str(tmp_path / "exchange_state.npz")
    pkgs = {"jax": jfleet.exchange, "port": None}
    reader = "port" if writer == "jax" else "jax"
    w = _mk_exchange(n_ranges=4, every=2, tmpl=tmpl, pkg=pkgs[writer],
                     state_path=path)
    for rid, s in enumerate((9, 12, 33)):
        w.publish(rid, corpus_payload(_snap(tmpl, sigs=(s, s + 3))))
    r = _mk_exchange(n_ranges=4, every=2, tmpl=tmpl, pkg=pkgs[reader])
    assert r.resume(path) == 3
    assert r.merged_through() == w.merged_through() == 1
    for name in CORPUS_FIELDS:
        np.testing.assert_array_equal(
            np.asarray(getattr(r.merged_epoch(0), name)),
            np.asarray(getattr(w.merged_epoch(0), name)), err_msg=name)


# ---------------------------------------------------------------------------
# The fleet legs, and the port held to JAX
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fleets(hunt, tmp_path_factory):
    """The port's exchanged fleets (clean with a state file, chaotic,
    single worker) and plain fleet."""
    eng, cfg, tmpl = hunt
    path = str(tmp_path_factory.mktemp("tstate") / "exchange_state.npz")
    return {
        "clean": _fleet(eng, cfg, tmpl,
                        exchange=ExchangeConfig(every=1, state_path=path)),
        "chaotic": _fleet(eng, cfg, tmpl, exchange=ExchangeConfig(every=1),
                          chaos=CHAOS),
        "solo": _fleet(eng, cfg, tmpl, exchange=ExchangeConfig(every=1),
                       n_workers=1),
        "plain": _fleet(eng, cfg, tmpl, exchange=None),
        "state_path": path,
    }


@pytest.fixture(scope="module")
def jax_exchanged(jhunt, tmp_path_factory):
    """JAX's clean exchanged fleet on one device, with its state file."""
    path = str(tmp_path_factory.mktemp("jstate") / "exchange_state.npz")
    res = _jfleet(jhunt, exchange=jfleet.ExchangeConfig(every=1,
                                                        state_path=path))
    return res, path


def test_exchanged_fleet_chaotic_equals_clean_and_workers_invariant(fleets):
    """Clean == chaotic (a kill mid-epoch re-seeded from the last merged
    epoch, duplicated completions, a torn publish, dropped RPCs) == a
    single worker, bitwise on ids, observations, bugs, schedules, the
    merged corpus and lineage."""
    clean, chaotic = fleets["clean"], fleets["chaotic"]
    assert_bitwise(clean, chaotic)
    assert_bitwise(clean, fleets["solo"])
    st = chaotic.loop_stats["fleet"]
    assert st["kills"] >= 1, "the kill→re-lease leg must have fired"
    assert st["leases_reissued"] >= 1
    assert st["publishes_torn"] >= 1
    assert st["duplicate_completions"] >= 1
    assert st["epochs_merged"] == 2
    workers = st["workers"]
    assert sum(w["corpus_seeded"] for w in workers.values()) >= 1
    assert clean.search is not None
    assert clean.search.corpus_size >= 2


@pytest.mark.parametrize("name", ["clean", "chaotic", "solo"])
def test_exchanged_fleet_equals_jax(fleets, jax_exchanged, name):
    """Each of the port's exchanged fleets equals JAX's on one device:
    observations, schedules, the merged corpus, lineage and the operator
    table."""
    assert_bitwise(jax_exchanged[0], fleets[name])


def test_epoch0_matches_plain_fleet_and_seeding_changes_later_epochs(
        hunt, fleets):
    eng, cfg, tmpl = hunt
    plain, exchanged = fleets["plain"], fleets["clean"]
    for k in plain.observations:
        np.testing.assert_array_equal(
            np.asarray(plain.observations[k])[:RANGE],
            np.asarray(exchanged.observations[k])[:RANGE], err_msg=k)
    assert any(
        not np.array_equal(np.asarray(plain.observations[k])[RANGE:],
                           np.asarray(exchanged.observations[k])[RANGE:])
        for k in plain.observations), \
        "exchange seeding left epoch-1 ranges bitwise unchanged"
    single = _fleet(eng, cfg, tmpl, exchange=ExchangeConfig(every=2),
                    n_workers=1)
    assert_bitwise(plain, single, search=False)
    assert plain.search is None and single.search is not None
    st = single.loop_stats["fleet"]
    assert st["publishes"] == 2 and st["epochs_merged"] == 1


def _resumed(res, fresh):
    """A fleet run over a populated state file: every publish was a
    bitwise-checked duplicate, and the result is the fresh run's."""
    assert_bitwise(fresh, res)
    st = res.loop_stats["fleet"]
    assert st["publishes"] == 0
    assert st["publishes_duplicate"] == 2


def test_exchanged_fleet_resumes_coordinator_state_end_to_end(hunt, fleets):
    eng, cfg, tmpl = hunt
    _resumed(_fleet(eng, cfg, tmpl, exchange=ExchangeConfig(
        every=1, state_path=fleets["state_path"])), fleets["clean"])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_fleet_resumes_the_other_packages_state(hunt, jhunt, fleets,
                                                jax_exchanged, tmp_path,
                                                writer):
    """A whole fleet of one package resumes over the state file the other
    package's fleet wrote, to the same result."""
    eng, cfg, tmpl = hunt
    src = jax_exchanged[1] if writer == "jax" else fleets["state_path"]
    path = str(tmp_path / "exchange_state.npz")
    shutil.copyfile(src, path)
    if writer == "jax":
        res = _fleet(eng, cfg, tmpl,
                     exchange=ExchangeConfig(every=1, state_path=path))
    else:
        res = _jfleet(jhunt, exchange=jfleet.ExchangeConfig(
            every=1, state_path=path))
    _resumed(res, fleets["clean"])


# ---------------------------------------------------------------------------
# sweep(search_corpus=): invisible seeding, no added pulls
# ---------------------------------------------------------------------------

def test_search_corpus_template_seed_bitwise_invisible_and_no_new_syncs(
        hunt, monkeypatch):
    eng, cfg, tmpl = hunt
    scfg = hunt_search_config(True)

    def run(**kw):
        calls = []
        real = sweep_mod._fetch

        def counting(tree):
            calls.append(1)
            return real(tree)

        monkeypatch.setattr(sweep_mod, "_fetch", counting)
        try:
            res = sweep(None, cfg, np.arange(64), engine=eng, faults=tmpl,
                        max_steps=10_000_000, search=scfg, **BATCH, **kw)
        finally:
            monkeypatch.setattr(sweep_mod, "_fetch", real)
        return res, len(calls)

    base, n_base = run()
    seeded, n_seeded = run(
        search_corpus=host_corpus_init(scfg.corpus, tmpl))
    assert n_seeded == n_base
    assert (base.bug == seeded.bug).all()
    for k in base.observations:
        np.testing.assert_array_equal(np.asarray(base.observations[k]),
                                      np.asarray(seeded.observations[k]),
                                      err_msg=k)
    np.testing.assert_array_equal(base.search.schedules,
                                  seeded.search.schedules)
    np.testing.assert_array_equal(base.search.corpus_sched,
                                  seeded.search.corpus_sched)
    assert base.search.generations == seeded.search.generations


def test_search_corpus_and_gen0_validation(hunt):
    eng, cfg, tmpl = hunt
    scfg = hunt_search_config(True)
    with pytest.raises(ValueError, match="search=SearchConfig"):
        sweep(None, cfg, np.arange(8), engine=eng, faults=tmpl,
              max_steps=256,
              search_corpus=host_corpus_init(scfg.corpus, tmpl), **BATCH)
    with pytest.raises(ValueError, match="search=SearchConfig"):
        sweep(None, cfg, np.arange(8), engine=eng, faults=tmpl,
              max_steps=256, search_gen0=GEN_STRIDE, **BATCH)
    with pytest.raises(ValueError, match=r"\(K, F, 4\).*corpus=32"):
        sweep(None, cfg, np.arange(8), engine=eng, faults=tmpl,
              max_steps=256, search=scfg,
              search_corpus=host_corpus_init(scfg.corpus // 2, tmpl),
              **BATCH)
    with pytest.raises(ValueError, match="search=SearchConfig"):
        fleet_sweep(None, cfg, np.arange(16), engine=eng, faults=tmpl,
                    exchange=ExchangeConfig(), max_steps=256, **BATCH)
    with pytest.raises(ValueError, match="inline"):
        fleet_sweep(None, cfg, np.arange(16), engine=eng, faults=tmpl,
                    exchange=ExchangeConfig(), search=hunt_search_config(
                        True), spawn="process", max_steps=256, **BATCH)
    with pytest.raises(ValueError, match="every"):
        ExchangeConfig(every=0)


def test_stalled_error_names_ranges_holders_and_heartbeats(hunt):
    eng, cfg, tmpl = hunt
    with pytest.raises(FleetStalledError) as exc:
        fleet_sweep(None, cfg, np.arange(64), engine=eng, faults=tmpl,
                    n_workers=1, range_size=16, max_steps=10_000_000,
                    search=hunt_search_config(True),
                    exchange=ExchangeConfig(every=1),
                    chaos=ChaosConfig(seed=1, kill_at=(("w0", 1),),
                                      restart_after=-1), **BATCH)
    msg = str(exc.value)
    assert "range 0: held by w0" in msg
    assert "last heartbeat" in msg and "expires t=" in msg
    assert "exchange barrier" in msg


# ---------------------------------------------------------------------------
# bench.py's guided fleet, held to the JAX-derived pins
# ---------------------------------------------------------------------------

def guided_fleets(fleet_fn, leg):
    """bench.py's guided_fleet leg (``golden.GUIDED_FLEET``) through
    ``fleet_fn``: the independent and the exchanged fleet."""
    g = golden.GUIDED_FLEET
    kw = dict(engine=leg["engine"], faults=leg["template"],
              search=leg["search"], stop_on_first_bug=True,
              **leg["sweep_kw"], **leg.get("extra", {}))
    seeds = np.arange(g["budget"])
    ind = fleet_fn(None, leg["cfg"], seeds, n_workers=g["n_workers"],
                   range_size=g["range_size"], **kw)
    exc = fleet_fn(None, leg["cfg"], seeds, n_workers=g["n_workers"],
                   range_size=g["range_size"],
                   exchange=leg["exchange"](every=g["every"]), **kw)
    return ind, exc


def test_guided_fleet_holds_the_jax_pins():
    """The exchanged guided fleet finds the pair bug where no independent
    range can, at the seeds JAX's does (``golden.GOLDEN_GUIDED_FLEET``)."""
    from madsim_tpu_torch.search.hunts import pair_hunt

    h = pair_hunt()
    leg = dict(engine=DeviceEngine(h.actor, h.cfg, device="cpu"),
                cfg=h.cfg, template=h.template, search=h.search(True),
                sweep_kw=h.sweep_kw, exchange=ExchangeConfig)
    ind, exc = guided_fleets(fleet_sweep, leg)
    assert golden.guided_fleet_pins(ind, exc) == golden.GOLDEN_GUIDED_FLEET


@pytest.mark.slow
def test_guided_fleet_pins_recomputed_from_jax():
    """``golden.GOLDEN_GUIDED_FLEET`` is JAX's guided fleet on one
    device."""
    from madsim_tpu.search.hunts import pair_hunt

    h = pair_hunt()
    leg = dict(engine=JDeviceEngine(h.actor, h.cfg), cfg=h.cfg,
                template=h.template, search=h.search(True),
                sweep_kw=h.sweep_kw, exchange=jfleet.ExchangeConfig,
                extra=dict(mesh=MESH1))
    ind, exc = guided_fleets(jfleet.fleet_sweep, leg)
    assert golden.guided_fleet_pins(ind, exc) == golden.GOLDEN_GUIDED_FLEET
