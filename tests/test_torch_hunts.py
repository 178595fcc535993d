"""The three canonical guided hunts (madsim_tpu_torch/search/hunts.py)
through the port's ``sweep(search=..., pipeline=False)`` on the CPU,
against the JAX package's, bitwise, and the JAX-derived constants that
``chip_smoke.py`` holds the card to (``engine/golden.py``):

- pair, raft and Paxos at the reduced budgets
  (``golden.HUNT_BUDGET_REDUCED``), guided and random, stopping at the
  first bug as bench.py's guided_hunt leg does: every ``SweepResult``
  field, the ``SearchReport`` and ``summary()``, and the pins recomputed
  from JAX (``golden.HUNT_PINS_REDUCED``);
- the two search deployments' ``observe()`` digests
  (``golden.GOLDEN_SEARCH``), recomputed from JAX and reproduced by the
  port;
- marked ``slow``: the full-budget pins (``golden.HUNT_PINS``, 512 seeds),
  recomputed from JAX.

Tolerance: none, every operation is integer.
"""
import importlib

import numpy as np
import pytest

import madsim_tpu.engine as J
from madsim_tpu.engine.families import actor_families as j_families
from madsim_tpu.parallel.mesh import seed_mesh
from madsim_tpu.search import hunts as jhunts
import madsim_tpu_torch.engine as T
from madsim_tpu_torch.engine import families as tfamilies
from madsim_tpu_torch.engine import golden
tsweep = importlib.import_module("madsim_tpu_torch.parallel.sweep")
from madsim_tpu_torch.search import hunts as thunts
from test_torch_search import assert_search_results_equal

jsweep = importlib.import_module("madsim_tpu.parallel.sweep")
MESH1 = seed_mesh(n_devices=1)
HUNTS = ("pair", "raft", "paxos")


@pytest.fixture(scope="module")
def hunt_engines():
    """One engine per hunt and package (JAX compiles once per engine)."""
    out = {}

    def get(name):
        if name not in out:
            jh = getattr(jhunts, f"{name}_hunt")()
            th = getattr(thunts, f"{name}_hunt")()
            out[name] = (J.DeviceEngine(jh.actor, jh.cfg), jh,
                         T.DeviceEngine(th.actor, th.cfg, device="cpu"), th)
        return out[name]
    return get


def jax_hunt(je, jh, mode, budget):
    return jsweep.sweep(None, jh.cfg, np.arange(budget), engine=je,
                        faults=jh.template, mesh=MESH1, pipeline=False,
                        stop_on_first_bug=golden.HUNT_STOP_FIRST[jh_name(jh)],
                        search=jh.search(mode == "guided"), **jh.sweep_kw)


def jh_name(hunt):
    return {"pair_restart_family": "pair", "seeded_raft_double_vote": "raft",
            "paxos_forgetful_acceptor": "paxos"}[hunt.name]


@pytest.mark.parametrize("mode", ["guided", "random"])
@pytest.mark.parametrize("name", HUNTS)
def test_hunt_at_the_reduced_budget_matches_jax_and_its_pins(
        hunt_engines, name, mode):
    je, jh, te, th = hunt_engines(name)
    assert th.name == jh.name and vars(th.cfg) == vars(jh.cfg)
    np.testing.assert_array_equal(th.template, jh.template)
    assert vars(th.search(True)) == vars(jh.search(True))
    assert th.sweep_kw == jh.sweep_kw
    budget = golden.HUNT_BUDGET_REDUCED[name]
    jr = jax_hunt(je, jh, mode, budget)
    tr = tsweep.sweep(None, th.cfg, np.arange(budget), engine=te,
                      faults=th.template, pipeline=False,
                      stop_on_first_bug=golden.HUNT_STOP_FIRST[name],
                      search=th.search(mode == "guided"), **th.sweep_kw)
    assert_search_results_equal(jr, tr)
    assert golden.hunt_pins(jr) == golden.HUNT_PINS_REDUCED[name][mode]
    assert golden.hunt_pins(tr) == golden.HUNT_PINS_REDUCED[name][mode]


@pytest.mark.parametrize("name", sorted(golden.SEARCH_CONFIGS))
def test_search_deployment_digests_recomputed_from_jax(name):
    """golden.GOLDEN_SEARCH is the JAX package's observe() of the
    deployment at its template, and the port's plain step reproduces it;
    the configuration is the hunt's own."""
    fam, ak, ck, faults, max_steps = golden.SEARCH_CONFIGS[name]
    hunt = {"paxos_hunt": thunts.paxos_hunt,
            "guided_pair": thunts.pair_hunt}[name]()
    assert vars(hunt.cfg) == vars(T.EngineConfig(**ck))
    np.testing.assert_array_equal(np.asarray(faults, np.int32),
                                  hunt.template)
    fa = np.asarray(faults, np.int32)
    acls, ccls = j_families()[fam].load()
    je = J.DeviceEngine(acls(ccls(**ak)), J.EngineConfig(**ck))
    jobs = je.observe(je.run(je.init(golden.SEEDS, faults=fa), max_steps))
    assert not jobs["active"].any() and not jobs["overflow"].any()
    assert golden.observe_digest(jobs) == golden.GOLDEN_SEARCH[name]
    acls, ccls = tfamilies.actor_families()[fam].load()
    te = T.DeviceEngine(acls(ccls(**ak)), T.EngineConfig(**ck), device="cpu")
    tobs = te.observe(te.run(te.init(golden.SEEDS, faults=fa), max_steps))
    assert golden.observe_digest(tobs) == golden.GOLDEN_SEARCH[name]


@pytest.mark.slow
@pytest.mark.parametrize("name", HUNTS)
def test_full_budget_pins_recomputed_from_jax(hunt_engines, name):
    """golden.HUNT_PINS: JAX's guided and random hunts at 512 seeds."""
    je, jh, _te, _th = hunt_engines(name)
    for mode in ("guided", "random"):
        res = jax_hunt(je, jh, mode, golden.HUNT_BUDGET)
        assert golden.hunt_pins(res) == golden.HUNT_PINS[name][mode]
