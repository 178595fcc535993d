"""Observation digests of the JAX package, for checking the port where JAX
is not installed.

The GPU machine has no JAX, so the port cannot be compared with the JAX
package there directly. Instead, :data:`GOLDEN` holds the SHA-256 of the
JAX engine's ``observe()`` for seeds 0..63 of two deployments, and
:data:`GOLDEN_OBS` / :data:`GOLDEN_SWEEP` those of the hunt with the
metrics block and the flight recorder on: its ``observe()``, and the
result of a small recycled sweep (:data:`SWEEP`); :data:`GOLDEN_FAMILIES`
those of the compiled families' deployments (:data:`FAMILY_CONFIGS`).
``chip_smoke.py`` checks that the port, stepping through the CUDA kernel,
reproduces them. ``tests/test_torch_engine.py``, ``tests/test_torch_sweep.py``
and ``tests/test_torch_families.py`` recompute every digest from the JAX
package on the CPU, so the constants cannot drift from it.

:data:`GOLDEN_WIDE` holds the digests of one deployment of each family in
the wide lane profile (:data:`WIDE_CONFIGS`, ``packed=False``).

:data:`GOLDEN_MINIMIZE` pins the schedule minimizer: the
:func:`minimize_digest` of JAX's ``triage.minimize`` of bench.py's
minimize_bug leg (:data:`MINIMIZE_BUG`), recomputed from JAX by
``tests/test_torch_triage.py``.

The guided search's constants: :data:`GOLDEN_SEARCH`, the ``observe()``
digests of its two deployments at their templates (:data:`SEARCH_CONFIGS`),
and the pins of the three canonical guided hunts (:data:`HUNT_PINS` at the
full budget of 512 seeds, :data:`HUNT_PINS_REDUCED` at the budgets of the
CPU tests), each a :func:`hunt_pins` of JAX's ``sweep(search=...,
pipeline=False)``. ``tests/test_torch_hunts.py`` recomputes the deployment
digests and the reduced pins from JAX; the full-budget pins were computed
with JAX on the CPU by its test marked ``slow``::

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_hunts.py -m slow

The actor compiler's checks: :data:`GOLDEN_SPECLINT`, the findings of
JAX's speclint on the golden fixtures (loaded for the port by
:func:`speclint_fixture`); :data:`GOLDEN_CARDS`, the protocol cards of
the shipped specs and their bug variants (:data:`CARD_SPECS`);
:data:`GOLDEN_CHECK_ACTOR`, JAX's ``check_actor`` report of every
registered family; :data:`GOLDEN_CROSSCHECK`, JAX's host-twin
``crosscheck`` reports (:data:`CROSSCHECK_CASES`).
``tests/test_torch_speclint.py``, ``test_torch_host_twin.py`` and
``test_torch_conformance.py`` recompute them from JAX (the last two in
tests marked ``slow``).

The fleet's constants: :data:`GOLDEN_FLEET_RAFT`, the :func:`fleet_digest`
of JAX's chaotic Raft fleet (:data:`FLEET_RAFT`), recomputed from JAX by
``tests/test_torch_fleet.py``; :data:`GOLDEN_GUIDED_FLEET`, the
:func:`guided_fleet_pins` of bench.py's guided fleet (:data:`GUIDED_FLEET`),
independent and with the corpus exchange, recomputed from JAX by the test
marked ``slow`` in ``tests/test_torch_exchange.py``.
"""
from __future__ import annotations

import hashlib
import os
from typing import Dict

import numpy as np

from .core import FAULT_KILL, FAULT_RESTART

SEEDS = np.arange(64)

#: name -> (RaftDeviceConfig kwargs, EngineConfig kwargs, fault rows,
#: max_steps). The headline is bench.py's device_seed_rate deployment; the
#: hunt is bench_time_to_first_bug's, with a kill/restart schedule added.
CONFIGS = {
    "headline": (
        dict(n=3, log_cap=4),
        dict(n_nodes=3, outbox_cap=4, queue_cap=28, t_limit_us=1_000_000),
        None, 2_000),
    "hunt_faults": (
        dict(n=3, buggy_double_vote=True),
        dict(n_nodes=3, outbox_cap=4, queue_cap=64, t_limit_us=2_000_000,
             stop_on_bug=False),
        [[400_000, FAULT_KILL, 0, 0], [900_000, FAULT_RESTART, 0, 0]],
        4_000),
}

#: SHA-256 of observe() for SEEDS under each config (see observe_digest).
GOLDEN = {
    "headline":
        "2108f4f2e26feab0d9abab203cd086e84e32d20c9952d41306d0aafec6991f5c",
    "hunt_faults":
        "9d49b9d3f36ed613c1de05fccbc06de8513d14167753d6fce987cdf62dfb98a0",
}


#: The hunt with kill/restart (CONFIGS["hunt_faults"]) with these
#: EngineConfig fields added: the metrics block and a 64-deep ring.
OBS_ON = dict(metrics=True, blackbox=64)

#: A recycled sweep of the hunt with kill/restart, metrics on and a 16-deep
#: ring: the seeds and the sweep's keyword arguments (pipeline=False).
SWEEP = dict(seeds=np.arange(256), over=dict(metrics=True, blackbox=16),
             kwargs=dict(chunk_steps=64, max_steps=4_000, recycle=True,
                         batch_worlds=64))

#: SHA-256 of observe() for SEEDS under CONFIGS["hunt_faults"] + OBS_ON.
GOLDEN_OBS = (
    "317e110980ba730937aa0591e9111933cac2d520e7ca10f56caad1522c13dbb5")

#: sweep_digest of the SWEEP over CONFIGS["hunt_faults"] + SWEEP["over"].
GOLDEN_SWEEP = (
    "c723302d23f7261e764bcc23a0bdf6b8a91c8c6f00254b5d63944ea4bd6037c4")


#: The compiled families' deployments on the card: name -> (family in
#: ``engine/families.py``, its config kwargs, EngineConfig kwargs, fault
#: rows, max_steps). tpc_crosscheck and pb_crosscheck are bench.py's
#: bench_crosscheck legs (bench.py:980-990); pb_hunt is
#: tests/test_pb_actor.py's bug hunt (commit after the first ack, loss 0.3,
#: the primary killed at 130 ms).
FAMILY_CONFIGS = {
    "tpc_crosscheck": (
        "tpc", dict(n=4, n_txns=4, buggy_presumed_commit=True),
        dict(n_nodes=4, outbox_cap=5, queue_cap=64, t_limit_us=1_500_000,
             loss_rate=0.1),
        None, 5_000),
    "pb_crosscheck": (
        "pb", dict(n=3, n_writes=4),
        dict(n_nodes=3, outbox_cap=4, queue_cap=64, t_limit_us=1_500_000,
             loss_rate=0.05),
        None, 5_000),
    "pb_hunt": (
        "pb", dict(n=3, n_writes=4, buggy_commit_early=True),
        dict(n_nodes=3, outbox_cap=4, queue_cap=48, t_limit_us=2_000_000,
             loss_rate=0.3),
        [[130_000, FAULT_KILL, 0, 0]], 8_000),
}

#: SHA-256 of observe() for SEEDS under each of FAMILY_CONFIGS.
GOLDEN_FAMILIES = {
    "tpc_crosscheck":
        "8abbbff1adf8bdbab32c72ae149dcccf2fd135674c3db3d71850099baea3f50e",
    "pb_crosscheck":
        "7543f4af3011166516227ffddc8801951181ae153052443c7e0ed01c0827dc45",
    "pb_hunt":
        "18bb10c188dea992e33571d9fff19ca1270902e7c5673505abed9c63f370fda3",
}


#: The guided search's two deployments (search/hunts.py) at their
#: templates: name -> (family, config kwargs, EngineConfig kwargs, fault
#: rows, max_steps). paxos_hunt is hunts.paxos_hunt()'s (forgetful
#: acceptors, every decree contended; the template's six early restarts);
#: guided_pair is hunts.pair_hunt()'s (12 nodes; six restarts of filler
#: nodes).
SEARCH_CONFIGS = {
    "paxos_hunt": (
        "paxos", dict(buggy_forgetful_acceptor=True, contend_all=True),
        dict(n_nodes=5, outbox_cap=6, queue_cap=128, payload_words=5,
             t_limit_us=2_000_000, metrics=True),
        [[4_000, FAULT_RESTART, 0, 0], [8_000, FAULT_RESTART, 2, 0],
         [12_000, FAULT_RESTART, 4, 0], [16_000, FAULT_RESTART, 1, 0],
         [20_000, FAULT_RESTART, 3, 0], [24_000, FAULT_RESTART, 0, 0]],
        4_000),
    "guided_pair": (
        "guided_pair", dict(n=12),
        dict(n_nodes=12, outbox_cap=2, queue_cap=64, t_limit_us=2_000_000,
             metrics=True),
        [[20_000, FAULT_RESTART, 0, 0], [40_000, FAULT_RESTART, 3, 0],
         [60_000, FAULT_RESTART, 4, 0], [80_000, FAULT_RESTART, 5, 0],
         [100_000, FAULT_RESTART, 6, 0], [120_000, FAULT_RESTART, 7, 0]],
        4_000),
}

#: SHA-256 of observe() for SEEDS under each of SEARCH_CONFIGS.
GOLDEN_SEARCH = {
    "paxos_hunt": (
        "b4747c7128309ebf4311c6b591ff1f487cd63d0ac5ff5875f436d2e5987a8eca"),
    "guided_pair": (
        "16b4d97fa70a76168a2bb13aee3381230ec659e7077aebe183b8bbc661472118"),
}

#: The wide lane profile (``EngineConfig(packed=False)``, every narrow lane
#: int32): deployments of CONFIGS, FAMILY_CONFIGS and SEARCH_CONFIGS run
#: with ``packed=False`` added to their EngineConfig kwargs, name -> (the
#: dict holding it). One per family: Raft's two, tpc, pb, Paxos and the
#: guided pair.
WIDE_CONFIGS = {
    "headline": "CONFIGS", "hunt_faults": "CONFIGS",
    "tpc_crosscheck": "FAMILY_CONFIGS", "pb_hunt": "FAMILY_CONFIGS",
    "paxos_hunt": "SEARCH_CONFIGS", "guided_pair": "SEARCH_CONFIGS",
}

#: SHA-256 of observe() for SEEDS under each of WIDE_CONFIGS, wide. Computed
#: with the JAX package on the CPU (``JAX_PLATFORMS=cpu``): its
#: DeviceEngine with the deployment's actor and
#: ``EngineConfig(**kwargs, packed=False)``, ``observe(run(init(SEEDS,
#: faults), max_steps))``, :func:`observe_digest`;
#: ``tests/test_torch_wide.py`` recomputes them the same way.
GOLDEN_WIDE = {
    "headline": (
        "20db8bc3788a6f32cc5ca39fa4c0941d0413f4d2093b49d2a66dfcc0e587a06e"),
    "hunt_faults": (
        "5514afaadda736b70222732f54281e73650eff05da6aed8898fa0c34c4466fe4"),
    "tpc_crosscheck": (
        "b7681a99da86615523e93462d9617630aa6183caecbe8f1494c1c85561f2b11b"),
    "pb_hunt": (
        "559c9afef709b223f2b45db9b3f1c6b28622652c4c06bddf480c75eb5983c9fc"),
    "paxos_hunt": (
        "e5a28169590dca0381da1df42bb90c3761e25de55653c0b15fae87d6adc2e97b"),
    "guided_pair": (
        "f7caef8ab05466f7a52d4b003c15112a9b445ecfbb1c01b339eadc985a4bbee0"),
}


def wide_config(name: str):
    """``(family, config kwargs, EngineConfig kwargs, fault rows,
    max_steps)`` of a WIDE_CONFIGS deployment, ``packed=False`` added;
    Raft's family is ``"raft"``."""
    src = globals()[WIDE_CONFIGS[name]]
    if src is CONFIGS:
        rk, ck, faults, max_steps = CONFIGS[name]
        fam, ak = "raft", rk
    else:
        fam, ak, ck, faults, max_steps = src[name]
    return fam, ak, dict(ck, packed=False), faults, max_steps


#: The guided hunts as bench.py's guided_hunt leg runs them: 512 seeds,
#: stopping at the first bug except for raft (bugs at the budget).
HUNT_BUDGET = 512
HUNT_STOP_FIRST = {"pair": True, "raft": False, "paxos": True}
#: The budgets of the CPU tests' runs of the same hunts.
HUNT_BUDGET_REDUCED = {"pair": 128, "raft": 64, "paxos": 96}


def _ops(**rows):
    """An operator table from (produced, novel, survived, bug) rows, with
    obs/lineage.py's survival_pct."""
    return {name: dict(produced=p, novel=nv, survived=sv, bug=b,
                       survival_pct=round(100.0 * sv / p, 2) if p else 0.0)
            for name, (p, nv, sv, b) in rows.items()}


#: hunt_pins of JAX's guided and random runs at HUNT_BUDGET.
HUNT_PINS = {
    "pair": {
        "guided": dict(
            seeds_to_bug=73, bugs_found=1,
            generations=2, corpus_size=9,
            lineage_depth=2,
            operator_stats=_ops(
                splice=(50, 5, 5, 1), disable=(19, 3, 3, 0),
                time_jitter=(46, 5, 5, 1), node_rotate=(46, 3, 3, 1),
                op_flip=(13, 6, 6, 0)),
            search_digest=(
                "ffe6f4007696b3cef4155ac81f5c0906"
                "5491869921d87430b0dca946fe4abff9")),
        "random": dict(
            seeds_to_bug=409, bugs_found=1,
            generations=12, corpus_size=1,
            lineage_depth=1,
            operator_stats=_ops(
                splice=(282, 0, 0, 1), disable=(112, 0, 0, 0),
                time_jitter=(274, 0, 0, 1), node_rotate=(233, 0, 0, 1),
                op_flip=(114, 0, 0, 0)),
            search_digest=(
                "8a83d53a1f3c3655c9c1b422b0ffc034"
                "1cfdf31b6079a3e654dc225ae5110d04")),
    },
    "raft": {
        "guided": dict(
            seeds_to_bug=40, bugs_found=6,
            generations=21, corpus_size=16,
            lineage_depth=6,
            operator_stats=_ops(
                splice=(346, 299, 26, 2), disable=(101, 91, 8, 0),
                time_jitter=(448, 389, 32, 6), node_rotate=(269, 238, 14, 2),
                op_flip=(126, 114, 9, 1)),
            search_digest=(
                "33644c120a2e85ac63910dc779c8c2ff"
                "4f3d6b186b83e6cb4eabbecaa1b640c3")),
        "random": dict(
            seeds_to_bug=40, bugs_found=3,
            generations=25, corpus_size=1,
            lineage_depth=1,
            operator_stats=_ops(
                splice=(356, 0, 0, 2), disable=(132, 0, 0, 0),
                time_jitter=(458, 0, 0, 3), node_rotate=(287, 0, 0, 1),
                op_flip=(121, 0, 0, 0)),
            search_digest=(
                "ca4468ee4f99e1441566a7bdda4e840a"
                "205e0f4b0db55a7956e4a5576dcb69ae")),
    },
    "paxos": {
        "guided": dict(
            seeds_to_bug=191, bugs_found=1,
            generations=5, corpus_size=32,
            lineage_depth=5,
            operator_stats=_ops(
                splice=(122, 32, 25, 1), disable=(50, 12, 9, 0),
                time_jitter=(150, 37, 30, 1), node_rotate=(90, 26, 20, 0),
                op_flip=(40, 19, 16, 0)),
            search_digest=(
                "94775770f116ea2fda940858f8b81540"
                "b02e35501affa4375117b5130ac8eeac")),
        "random": dict(
            seeds_to_bug=None, bugs_found=0,
            generations=15, corpus_size=1,
            lineage_depth=1,
            operator_stats=_ops(
                splice=(357, 0, 0, 0), disable=(135, 0, 0, 0),
                time_jitter=(453, 0, 0, 0), node_rotate=(308, 0, 0, 0),
                op_flip=(127, 0, 0, 0)),
            search_digest=(
                "3902b9ba2724285ca26c0cb781174b9d"
                "0571b376be3fd820d33002fe1250b328")),
    },
}

#: hunt_pins of JAX's runs at HUNT_BUDGET_REDUCED.
HUNT_PINS_REDUCED = {
    "pair": {
        "guided": dict(
            seeds_to_bug=73, bugs_found=1,
            generations=2, corpus_size=9,
            lineage_depth=2,
            operator_stats=_ops(
                splice=(50, 5, 5, 1), disable=(19, 3, 3, 0),
                time_jitter=(46, 5, 5, 1), node_rotate=(46, 3, 3, 1),
                op_flip=(13, 6, 6, 0)),
            search_digest=(
                "3912599b242aa62ae7875a59c4a9e722"
                "bc08932ab640e94ebaf398a51318282a")),
        "random": dict(
            seeds_to_bug=None, bugs_found=0,
            generations=3, corpus_size=1,
            lineage_depth=1,
            operator_stats=_ops(
                splice=(71, 0, 0, 0), disable=(29, 0, 0, 0),
                time_jitter=(71, 0, 0, 0), node_rotate=(66, 0, 0, 0),
                op_flip=(20, 0, 0, 0)),
            search_digest=(
                "57104b20fd925554001c955bb6028b17"
                "9ad2169f3faf81f0a619678b9e4a1e2c")),
    },
    "raft": {
        "guided": dict(
            seeds_to_bug=40, bugs_found=1,
            generations=2, corpus_size=16,
            lineage_depth=2,
            operator_stats=_ops(
                splice=(26, 8, 7, 1), disable=(11, 3, 2, 0),
                time_jitter=(30, 10, 7, 1), node_rotate=(13, 4, 2, 0),
                op_flip=(8, 2, 1, 0)),
            search_digest=(
                "d07387e7f87cd2241a7caa9e3b65e951"
                "7e76666d73ddc394da50479c75befbc8")),
        "random": dict(
            seeds_to_bug=40, bugs_found=1,
            generations=2, corpus_size=1,
            lineage_depth=1,
            operator_stats=_ops(
                splice=(26, 0, 0, 1), disable=(11, 0, 0, 0),
                time_jitter=(30, 0, 0, 1), node_rotate=(13, 0, 0, 0),
                op_flip=(8, 0, 0, 0)),
            search_digest=(
                "db7b7c5716e879345fa2ff715199e353"
                "4f9e13878201b35e0fb87fe8cfb066c3")),
    },
    "paxos": {
        "guided": dict(
            seeds_to_bug=None, bugs_found=0,
            generations=2, corpus_size=10,
            lineage_depth=2,
            operator_stats=_ops(
                splice=(50, 5, 5, 0), disable=(19, 2, 2, 0),
                time_jitter=(62, 5, 5, 0), node_rotate=(34, 4, 4, 0),
                op_flip=(17, 5, 5, 0)),
            search_digest=(
                "b3d72b7687f7d3346e1027dc93cc1dfe"
                "5fc4a50405283e3deecef30fda6b7fa6")),
        "random": dict(
            seeds_to_bug=None, bugs_found=0,
            generations=2, corpus_size=1,
            lineage_depth=1,
            operator_stats=_ops(
                splice=(50, 0, 0, 0), disable=(19, 0, 0, 0),
                time_jitter=(62, 0, 0, 0), node_rotate=(36, 0, 0, 0),
                op_flip=(17, 0, 0, 0)),
            search_digest=(
                "68c140086cde70f966708e06d6e647ee"
                "3846e1a53e9189be950a6ecd881c2811")),
    },
}


def search_digest(report) -> str:
    """SHA-256 over a SearchReport's per-seed schedules and its corpus
    (schedules, signatures, scores, fill, lineage entry ids and depths)."""
    h = hashlib.sha256()
    _update(h, {name: getattr(report, name) for name in (
        "schedules", "corpus_sched", "corpus_sig", "corpus_score",
        "corpus_filled", "corpus_entry", "corpus_depth")})
    return h.hexdigest()


def hunt_pins(res) -> dict:
    """What a guided hunt is held to: the seeds it took to the first bug
    (None if none), the bugs found, the generations run, the corpus size,
    the deepest ancestry, the operator table and :func:`search_digest`."""
    f = res.failing_seeds
    r = res.search
    return dict(seeds_to_bug=(f[0] + 1) if f else None, bugs_found=len(f),
                generations=int(r.generations),
                corpus_size=int(r.corpus_size),
                lineage_depth=int(r.lineage_depth()),
                operator_stats=r.operator_stats,
                search_digest=search_digest(r))


def observe_digest(obs: Dict[str, np.ndarray]) -> str:
    """SHA-256 over an observation dict: every key in sorted order with
    its array's dtype, shape and bytes."""
    h = hashlib.sha256()
    _update(h, obs)
    return h.hexdigest()


def _update(h, arrays: Dict[str, np.ndarray]):
    for key in sorted(arrays):
        a = np.ascontiguousarray(np.asarray(arrays[key]))
        h.update(key.encode())
        h.update(a.dtype.str.encode())
        h.update(repr(a.shape).encode())
        h.update(a.tobytes())


def sweep_digest(res) -> str:
    """SHA-256 over a SweepResult: its seeds and bug flags, every
    observation, the occupancy history and its chunk indices, the coverage
    ledger (hits, first seen seeds, novelty curve) and ``summary()``."""
    h = hashlib.sha256()
    cov = res.coverage
    _update(h, {"seeds": res.seeds, "bug": res.bug,
                "n_active_history": res.n_active_history,
                "n_active_chunks": res.n_active_chunks,
                "cov_hits": cov.hits, "cov_first_seen": cov.first_seen_seed,
                "cov_novelty": cov.novelty_curve})
    _update(h, res.observations)
    h.update(res.summary().encode())
    return h.hexdigest()


def fleet_digest(res) -> str:
    """SHA-256 over a fleet result's contract fields: its seeds and bug
    flags, the coverage ledger's hits and first seen seeds (when metrics
    ran), every observation and the schedule fingerprint."""
    h = hashlib.sha256()
    _update(h, {"seeds": res.seeds, "bug": res.bug})
    if res.coverage is not None:
        _update(h, {"cov_hits": res.coverage.hits,
                    "cov_first_seen": res.coverage.first_seen_seed})
    _update(h, res.observations)
    h.update(str(res.faults_sha256).encode())
    return h.hexdigest()


#: The chaotic Raft fleet of tests/test_fleet.py: the Raft config, the
#: EngineConfig, the ChaosConfig fields (a kill, a preemption, duplicated
#: completions, dropped RPCs and heartbeats), and the fleet's shape (with a
#: checkpoint directory).
FLEET_RAFT = dict(
    raft=dict(n=3, buggy_double_vote=True),
    engine=dict(n_nodes=3, outbox_cap=4, queue_cap=64, t_limit_us=1_500_000,
                stop_on_bug=True, metrics=True),
    chaos=dict(seed=11, kill_at=(("w0", 2),), preempt_at=(("w1", 5),),
               duplicate_all_completions=True, drop_rpc_rate=0.25,
               drop_heartbeat_rate=0.1, restart_after=2),
    n_seeds=64, range_size=16, n_workers=2,
    sweep_kw=dict(chunk_steps=64, max_steps=20_000))

#: :func:`fleet_digest` of JAX's chaotic FLEET_RAFT fleet
#: (``fleet_sweep(..., mesh=seed_mesh(n_devices=1))``), recomputed from
#: JAX by tests/test_torch_fleet.py.
GOLDEN_FLEET_RAFT = (
    "e534d9a697616cee83fd9d3d0269320108eb24feb78cb99109b0f29217e4d036")

#: bench.py's guided_fleet leg: ``search/hunts.py``'s ``pair_hunt()``
#: (guided, its ``sweep_kw``, ``stop_on_first_bug``) over ``budget``
#: seeds in ranges of ``range_size``, two workers, independent and with
#: ``ExchangeConfig(every=1)``.
GUIDED_FLEET = dict(budget=512, range_size=64, every=1, n_workers=2)


def guided_fleet_pins(independent, exchanged) -> dict:
    """What the guided fleet is held to: the fewest seeds into a range
    before its first find (None: no range found the bug), both ways; the
    bugs found; the exchanged fleet's first failing global seed (1-based),
    merged corpus size, ancestry depth, operator table and
    :func:`search_digest`; and each fleet's :func:`fleet_digest`."""
    from ..fleet.lease import split_ranges

    ranges = split_ranges(GUIDED_FLEET["budget"],
                          GUIDED_FLEET["range_size"])

    def best(res):
        per = [s - r.lo + 1 for r in ranges
               for s in sorted(int(x) for x in res.failing_seeds)
               if r.lo <= s < r.hi]
        return min(per) if per else None

    f = exchanged.failing_seeds
    r = exchanged.search
    return dict(independent_seeds_to_bug=best(independent),
                exchanged_seeds_to_bug=best(exchanged),
                independent_bugs_found=len(independent.failing_seeds),
                exchanged_bugs_found=len(f),
                exchanged_first_global_seed=(int(f[0]) + 1) if f else None,
                merged_corpus_size=int(r.corpus_size),
                lineage_depth=int(r.lineage_depth()),
                operator_stats=r.operator_stats,
                search_digest=search_digest(r),
                fleet_digest_independent=fleet_digest(independent),
                fleet_digest_exchanged=fleet_digest(exchanged))


#: :func:`guided_fleet_pins` of JAX's guided fleets on one device
#: (``mesh=seed_mesh(n_devices=1)``), recomputed from JAX by
#: tests/test_torch_exchange.py's test marked ``slow``. The exchanged
#: fleet finds the pair bug 39 seeds into its range, at global seed 295;
#: no independent range finds it.
GOLDEN_GUIDED_FLEET = dict(
    independent_seeds_to_bug=None,
    exchanged_seeds_to_bug=39,
    independent_bugs_found=0,
    exchanged_bugs_found=1,
    exchanged_first_global_seed=295,
    merged_corpus_size=2,
    lineage_depth=1,
    operator_stats=_ops(
        splice=(190, 0, 0, 1), disable=(71, 0, 0, 0),
        time_jitter=(201, 0, 0, 0), node_rotate=(161, 0, 0, 1),
        op_flip=(64, 0, 0, 0)),
    search_digest=(
        "afc795130e0389da3ed9abe78581f269705b2e1e24f4798331c0183b99d69217"),
    fleet_digest_independent=(
        "a4979718f237206a249ad223b4740e82c8cc5f9dd67c73590032e885386bf2e5"),
    fleet_digest_exchanged=(
        "4d7c11553850ef126253cb34f5bf3177cf091d4c1d2c205c506c5ad8017e64b0"),
)


#: bench.py's minimize_bug leg at its full width: a 64-row restart schedule
#: (``triage/synthetic.py::pair_schedule``) whose failure needs exactly rows
#: ``need``, minimized for ``seed`` with these sweep knobs.
MINIMIZE_BUG = dict(n_rows=64, need=(10, 42), seed=7, chunk_steps=32,
                    max_steps=4_000)

#: minimize_digest of the JAX package's ``triage.minimize`` of
#: MINIMIZE_BUG (18 rounds, 87 candidates, the two load-bearing rows),
#: recomputed from JAX by ``tests/test_torch_triage.py``.
GOLDEN_MINIMIZE = (
    "075840245b5b4be13c33ef1ba879307c"
    "ae315269ee1e04b9bd7d3489b9f04152")


def minimize_digest(res) -> str:
    """SHA-256 over a MinimizeResult's outcome: the minimized ``(F, 4)``
    schedule, the round history, the rounds and candidates, the
    weakenings and the 1-minimality verdict (not the sweep loop, which
    must not change it)."""
    import json

    doc = {"full": np.asarray(res.full).tolist(), "history": res.history,
           "rounds": int(res.rounds),
           "candidates_evaluated": int(res.candidates_evaluated),
           "weakenings": list(res.weakenings),
           "one_minimal": bool(res.one_minimal)}
    return hashlib.sha256(
        json.dumps(doc, sort_keys=True).encode()).hexdigest()


# ---------------------------------------------------------------------------
# The actor compiler's checks: speclint, check_actor, the host-twin
# crosscheck. Recomputed from the JAX package by tests/test_torch_speclint.py
# and tests/test_torch_conformance.py (the check_actor and 64-seed
# crosscheck reports by their tests marked ``slow``).
# ---------------------------------------------------------------------------

#: The speclint golden fixtures, tests/fixtures/speclint/<name>.py.
SPECLINT_DIR = "tests/fixtures/speclint"


def speclint_fixture(path: str):
    """Import a speclint fixture against the port's spec model and return
    the module. The fixtures import ``madsim_tpu.actorc.spec``: that one
    line is rewritten to ``madsim_tpu_torch.actorc.spec`` in place, and
    the text is compiled under the fixture's own file name, so the
    handlers' ``co_filename`` and line numbers — which findings report —
    and the pragmas read back from the file agree with the JAX package's
    import of the same file."""
    import types

    path = os.path.abspath(path)
    with open(path, encoding="utf-8") as f:
        lines = f.read().split("\n")
    old = "from madsim_tpu.actorc.spec import"
    lines = [ln.replace(old, "from madsim_tpu_torch.actorc.spec import", 1)
             if ln.startswith(old) else ln for ln in lines]
    name = os.path.splitext(os.path.basename(path))[0]
    mod = types.ModuleType(f"speclint_fixture_{name}")
    mod.__file__ = path
    exec(compile("\n".join(lines), path, "exec"), mod.__dict__)
    return mod


def findings_digest(findings) -> str:
    """SHA-256 over the rendered findings (path, line, rule, message)."""
    return hashlib.sha256("\n".join(
        f.render() for f in findings).encode()).hexdigest()


#: fixture -> (the rules of its findings, in order; findings_digest) of
#: the JAX package's ``lint_spec(fixture.build(), root=<repo root>)``.
GOLDEN_SPECLINT = {
    "bad_capacity": (("SPC030", "SPC031"),
        "e26b366b6399265e70c0a76c4f4016b65f314412ae88d4fdd06bb3f3c74bf59e"),
    "bad_durability": (("SPC050",),
        "247748d732ccb690b490fa2e3221974c993e46e4e4ff9666b9d4d335cd3c6f9e"),
    "bad_effects": (("SPC040", "SPC041"),
        "5165567af97652c7e22d3b38b2801403bffff5568842d54f5ea4f8e0d3474f12"),
    "bad_noop": (("SPC012",),
        "1b721c16f475a37db2dc6a6715065a1f4f13e655f1233ae5848504298edc0f67"),
    "bad_timer": (("SPC021", "SPC010", "SPC020"),
        "c9962b8cc87df9271ae42e1688208b17aaf66edf125c73a12b15f681b924ed09"),
    "bad_unhandled": (("SPC011",),
        "aad46a863cd444337f5f26d360e658671c0cb546cede4bb3ce4253e51d4abdf2"),
    "bad_unreachable": (("SPC010",),
        "dfd0607d8354525806d50719330b8460e1bacf768e41fd15e1c89c02b3ca09ea"),
    "clean": ((),
        "e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855"),
    "stale_pragma": (("DET900",),
        "b55f80650dfddc3cc6af711768115bad88b37a3ebdb33e2b36ae2bbb5297530b"),
}

#: The shipped specs and their bug variants: name -> (family, config
#: kwargs). Each lints clean; tpc_crosscheck, pb_hunt and paxos_hunt are
#: the configs of FAMILY_CONFIGS and SEARCH_CONFIGS, pb_hunt_n3 that of
#: tests/test_actorc.py's pb crosscheck.
CARD_SPECS = {
    "tpc": ("tpc", {}),
    "tpc_presumed_commit": ("tpc", dict(buggy_presumed_commit=True)),
    "tpc_crosscheck": ("tpc", dict(n=4, n_txns=4,
                                   buggy_presumed_commit=True)),
    "pb": ("pb", {}),
    "pb_commit_early": ("pb", dict(buggy_commit_early=True)),
    "pb_hunt": ("pb", dict(n=3, n_writes=4, buggy_commit_early=True)),
    "pb_hunt_n3": ("pb", dict(n=3, n_writes=3, buggy_commit_early=True)),
    "paxos": ("paxos", {}),
    "paxos_forgetful": ("paxos", dict(buggy_forgetful_acceptor=True)),
    "paxos_hunt": ("paxos", dict(buggy_forgetful_acceptor=True,
                                 contend_all=True)),
}


def card_actor(name: str):
    """The port's family actor (TPCActor, PBActor, PaxosActor) of
    CARD_SPECS[name]: its ``spec`` is the spec, and the step kernel has a
    policy for it."""
    from .families import family

    fam, kw = CARD_SPECS[name]
    f = family(fam)
    return f.actor_cls(f.config_cls(**kw))


def card_spec(name: str):
    """The port's spec of CARD_SPECS[name]."""
    return card_actor(name).spec


def card_digest(card: str) -> str:
    return hashlib.sha256(card.encode()).hexdigest()


#: card_digest of the JAX package's protocol_card of each CARD_SPECS spec.
GOLDEN_CARDS = {
    "tpc":
        "85dcf020c83f50c9693b11fe2be2cd50c44dd7e128720718afe62b4a1f01953c",
    "tpc_presumed_commit":
        "85dcf020c83f50c9693b11fe2be2cd50c44dd7e128720718afe62b4a1f01953c",
    "tpc_crosscheck":
        "85dcf020c83f50c9693b11fe2be2cd50c44dd7e128720718afe62b4a1f01953c",
    "pb":
        "8b85e1045aebf5be14b787b6507aa2c1e2ff76103dc3719c0afde98f1f626ef3",
    "pb_commit_early":
        "8b85e1045aebf5be14b787b6507aa2c1e2ff76103dc3719c0afde98f1f626ef3",
    "pb_hunt":
        "8b85e1045aebf5be14b787b6507aa2c1e2ff76103dc3719c0afde98f1f626ef3",
    "pb_hunt_n3":
        "8b85e1045aebf5be14b787b6507aa2c1e2ff76103dc3719c0afde98f1f626ef3",
    "paxos":
        "4e0b544444eb40e247e5c82642f4899ce0261c4a425dc6e7e00c9b820a8e7934",
    "paxos_forgetful":
        "35a65e02e7ce5a63e9a967a698c905cd754c1233a351c826a0ecf5b8eb2cd0f9",
    "paxos_hunt":
        "35a65e02e7ce5a63e9a967a698c905cd754c1233a351c826a0ecf5b8eb2cd0f9",
}

#: check_actor over every registered family at tests/test_conformance.py's
#: shape (its canonical conformance() config, require_divergence from the
#: registry).
CHECK_ACTOR_SHAPE = dict(n_worlds=32, max_steps=3_000)

#: The JAX package's check_actor report of each family at CHECK_ACTOR_SHAPE.
GOLDEN_CHECK_ACTOR = {
    "guided_pair": {"n_worlds": 32, "steps_mean": 2.0,
                    "draws_per_kind": [0, 0], "bug_rate": 0.0, "qmax": 3},
    "pair_restart": {"n_worlds": 32, "steps_mean": 2.0,
                     "draws_per_kind": [0], "bug_rate": 0.0, "qmax": 3},
    "paxos": {"n_worlds": 32, "steps_mean": 80.09375,
              "draws_per_kind": [1, 0, 0, 0, 0, 0, 1], "bug_rate": 0.0,
              "qmax": 17},
    "pb": {"n_worlds": 32, "steps_mean": 219.53125,
           "draws_per_kind": [0, 1, 0, 0, 0, 1], "bug_rate": 0.0,
           "qmax": 25},
    "raft": {"n_worlds": 32, "steps_mean": 281.625,
             "draws_per_kind": [1, 0, 1, 0, 1, 0, 0], "bug_rate": 0.0,
             "qmax": 24},
    "tpc": {"n_worlds": 32, "steps_mean": 44.9375,
            "draws_per_kind": [0, 1, 0, 0, 0], "bug_rate": 0.0,
            "qmax": 11},
}

#: The host-twin crosscheck's deployments, tests/test_actorc.py's three:
#: name -> (CARD_SPECS entry, EngineConfig kwargs (None: the family's
#: engine_config), seeds, fault rows, max_steps). ":64" runs each at
#: seeds 0..63 and 400 steps.
CROSSCHECK_CASES = {
    "tpc": ("tpc_crosscheck",
            dict(n_nodes=4, outbox_cap=5, queue_cap=64,
                 t_limit_us=2_000_000, loss_rate=0.1),
            (0, 3), [[200_000, FAULT_KILL, 0, 0],
                     [500_000, FAULT_RESTART, 0, 0]], 250),
    "pb": ("pb_hunt_n3",
           dict(n_nodes=3, outbox_cap=4, queue_cap=48,
                t_limit_us=2_000_000, loss_rate=0.2),
           (0, 9), [[130_000, FAULT_KILL, 0, 0],
                    [900_000, FAULT_RESTART, 0, 0]], 250),
    "paxos": ("paxos_hunt", None, (0, 1, 5),
              [[80_000, FAULT_RESTART, 2, 0]], 250),
}
CROSSCHECK_CASES.update({
    name + ":64": (spec, ck, tuple(range(64)), faults, 400)
    for name, (spec, ck, _seeds, faults, _steps)
    in list(CROSSCHECK_CASES.items())})

#: The JAX package's crosscheck report of each CROSSCHECK_CASES entry.
GOLDEN_CROSSCHECK = {
    "tpc": {"n_seeds": 2, "steps_checked": 500, "events_delivered": 22,
            "restarts": 1, "max_steps": 250},
    "pb": {"n_seeds": 2, "steps_checked": 500, "events_delivered": 264,
           "restarts": 2, "max_steps": 250},
    "paxos": {"n_seeds": 3, "steps_checked": 750, "events_delivered": 321,
              "restarts": 3, "max_steps": 250},
    "tpc:64": {"n_seeds": 64, "steps_checked": 25600,
               "events_delivered": 1092, "restarts": 62, "max_steps": 400},
    "pb:64": {"n_seeds": 64, "steps_checked": 25600,
              "events_delivered": 7254, "restarts": 51, "max_steps": 400},
    "paxos:64": {"n_seeds": 64, "steps_checked": 25600,
                 "events_delivered": 6735, "restarts": 64,
                 "max_steps": 400},
}


def crosscheck_case(name: str):
    """``(actor, EngineConfig, seeds, fault rows, max_steps)`` of
    CROSSCHECK_CASES[name] in the port: the family actor, whose ``spec``
    the crosscheck takes and whose engine the kernel can step."""
    spec_name, ck, seeds, faults, steps = CROSSCHECK_CASES[name]
    actor = card_actor(spec_name)
    if ck is None:
        from ..actorc.families.paxos import PaxosConfig, engine_config

        cfg = engine_config(PaxosConfig(**CARD_SPECS[spec_name][1]))
    else:
        from .core import EngineConfig

        cfg = EngineConfig(**ck)
    return actor, cfg, list(seeds), np.asarray(faults, np.int32), steps
