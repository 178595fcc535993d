"""The world-axis split on 8 blocks against the JAX package's 8-device CPU
meshes, bitwise: the flat ``seed_mesh`` of 8 and the 2-D
``multihost_mesh`` of (2, 4), in the serial, pipelined and fused loops,
on every ``SweepResult`` field and the ``_fetch`` calls, and the two
meshes against each other (JAX's test_multihost_mesh_matches_flat_mesh).
The configuration and the helpers are tests/test_torch_mesh.py's (this
file splits from it so that each stays about a minute here). Tolerance:
none.
"""
import numpy as np
import pytest

from test_torch_mesh import (CPU, KW, LOOPS, SEEDS, both, engines,  # noqa: F401
                             one_thread, tmesh, tsweep)
from test_torch_sweep import assert_results_equal


@pytest.mark.parametrize("loop", sorted(LOOPS))
@pytest.mark.parametrize("mesh_name", ["k8", "2x4"])
def test_recycled_sweep_matches_jax_wide_mesh(engines, mesh_name, loop):
    """tests/test_torch_mesh.py's recycled sweep on 8 blocks: every
    field and the ``_fetch`` calls equal JAX's on its own 8 devices, and
    every step call takes one block (the 8 slots, one world a block)."""
    jr, tr, counts, widths = both(engines, mesh_name, **KW, **LOOPS[loop])
    assert_results_equal(jr, tr)
    assert tr.n_devices == 8
    assert tr.failing_seeds and tr.loop_stats["retire_fetches"] > 0
    assert counts["torch"] == counts["jax"]
    assert set(widths) == {1}


def test_flat_and_2d_meshes_agree(engines):
    """The DCN path (JAX's test_multihost_mesh_matches_flat_mesh): the
    (2, 4) mesh and the flat 8-device one give the same sweep."""
    _je, te = engines
    kw = dict(KW, pipeline=True)
    flat = tsweep.sweep(None, te.cfg, SEEDS, engine=te,
                        mesh=tmesh.seed_mesh([CPU] * 8), **kw)
    hier = tsweep.sweep(None, te.cfg, SEEDS, engine=te,
                        mesh=tmesh.multihost_mesh([CPU] * 8, n_hosts=2),
                        **kw)
    np.testing.assert_array_equal(flat.bug, hier.bug)
    for k, v in flat.observations.items():
        np.testing.assert_array_equal(hier.observations[k], v, err_msg=k)
    np.testing.assert_array_equal(flat.coverage.hits, hier.coverage.hits)
    np.testing.assert_array_equal(flat.coverage.first_seen_seed,
                                  hier.coverage.first_seen_seed)
