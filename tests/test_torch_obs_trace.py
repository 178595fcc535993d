"""The port's ``trace()``, the flight recorder's host decode and the
metrics and ring writes in the wide (int32) lane profile, against the JAX
package, bitwise, on the CPU. The packed profile and the coverage ledger
are in tests/test_torch_obs.py; the two files run in parallel workers.

Tolerance: none — every operation is integer, or an exactly rounded
float32 product.
"""
import warnings

import numpy as np
import pytest

from madsim_tpu.obs import blackbox as jbb
from madsim_tpu_torch.obs import blackbox as tbb
from test_torch_obs import (CASES, HUNT_CK, HUNT_FAULTS, HUNT_RK,
                            check_leaves_and_invisibility, engines)


@pytest.mark.parametrize("name", sorted(CASES))
def test_wide_profile_metrics_and_ring_leaves_match_jax(name):
    """The wide profile (packed=False), with a ring 5 deep: not a power
    of two."""
    check_leaves_and_invisibility(name, packed=False, k=5)


@pytest.fixture(scope="module")
def hunt_engines():
    """The hunt with kill/restart, ring 16 deep and metrics on."""
    return engines(HUNT_RK, HUNT_CK, metrics=True, blackbox=16)


def test_trace_matches_jax_with_truncation_marker_and_warning(hunt_engines):
    je, te = hunt_engines
    ends = []
    for seed, max_steps in ((2, 4_000), (2, 60), (5, 60)):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            jt = je.trace(seed, max_steps=max_steps, faults=HUNT_FAULTS)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            tt = te.trace(seed, max_steps=max_steps, faults=HUNT_FAULTS)
        assert tt == jt, (seed, max_steps)
        end = tt[-1]
        truncated = end["kind"] == "truncated"
        assert truncated == (max_steps < 4_000)
        warned = [w for w in caught if issubclass(w.category, RuntimeWarning)
                  and "truncated at max_steps" in str(w.message)]
        # The warning comes only with a cut before any bug was seen.
        assert len(warned) == (truncated and not end["bug_seen"])
        ends.append((truncated, end.get("bug_seen")))
        if max_steps == 4_000:
            full = tt
    # A full trace, a cut after the raise and a cut without one.
    assert ends == [(False, None), (True, True), (True, False)]
    # The full trace holds the raise, dropped events (a killed
    # destination) and fault injections.
    assert sum(bool(e.get("bug_raised")) for e in full) == 1
    assert any(e.get("dropped") for e in full)
    assert any(e["kind"].startswith("fault:") for e in full)


def test_ring_decode_and_crosscheck_match_jax(hunt_engines):
    """A failing world's decoded ring, a wrapped one's, a torn one and a
    mismatch: the port's host decode equals JAX's, and the ring is the
    suffix of the port's own trace."""
    _je, te = hunt_engines
    state = te.run(te.init(np.arange(16), faults=HUNT_FAULTS), 4_000)
    obs = te.observe(state)
    rings = tbb.rings_from_observations(obs)
    assert rings.keys() == jbb.rings_from_observations(obs).keys()
    names = te.actor.kind_names
    rows = [int(np.argmax(obs["bug"])), int(np.argmax(~obs["bug"]))]
    assert obs["bug"][rows[0]] and not obs["bug"][rows[1]]
    for row in rows:
        one = {k: v[row] for k, v in rings.items()}
        dec = tbb.decode_ring(one, kind_names=names)
        assert dec == jbb.decode_ring(one, kind_names=names)
        trace = te.trace(row, max_steps=4_000, faults=HUNT_FAULTS)
        total = int(one["pos"])
        assert total > 16 and len(dec) == 16
        assert tbb.ring_matches_trace(dec, trace, total=total) is None
        assert jbb.ring_matches_trace(dec, trace, total=total) is None
        block = tbb.blackbox_block(dec, seed=row, k=16, pos=total,
                                   steps=int(obs["steps"][row]),
                                   faults=HUNT_FAULTS)
        assert block == jbb.blackbox_block(dec, seed=row, k=16, pos=total,
                                           steps=int(obs["steps"][row]),
                                           faults=HUNT_FAULTS)
    assert dec[-1]["kind"] != "invariant"
    bad = [dict(e) for e in dec]
    bad[3]["t_us"] += 1
    msg = tbb.ring_matches_trace(bad, trace, total=total)
    assert msg and msg == jbb.ring_matches_trace(bad, trace, total=total)
    assert (tbb.ring_matches_trace(dec, trace, total=total + 1)
            == jbb.ring_matches_trace(dec, trace, total=total + 1))
    torn = dict(one, step_lo=one["step_lo"].copy())
    torn["step_lo"][0] += 1
    for mod in (tbb, jbb):
        with pytest.raises(ValueError, match="torn"):
            mod.decode_ring(torn)
