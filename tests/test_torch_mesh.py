"""The world-axis split (madsim_tpu_torch/parallel/mesh.py, and
``sweep(mesh=...)`` in madsim_tpu_torch/parallel/sweep.py) against the JAX
package's k-device CPU meshes, bitwise.

The port splits a batch over ``seed_mesh([torch.device("cpu")] * k)``:
k blocks of the CPU, each stepped apart by its own plain steps, the
scalars and the coverage fold reduced over the blocks, as the JAX
package's ``seed_mesh(n_devices=k)`` shards its batch over the k virtual
CPU devices tests/conftest.py forces. The mesh shapes the results (the
seeds pad to a mesh multiple, ``batch_worlds`` rounds up to one,
compaction halves only to mesh multiples), so each k is held to JAX's own
k: here k = 2 and 4 in the serial, pipelined and fused loops, on every
``SweepResult`` field (tests/test_torch_sweep.py
``assert_results_equal``), the ``_fetch`` calls included, with the mesh
helpers and their errors and the compaction buckets. k = 8 and the 2-D
``multihost_mesh`` of (2, 4) are in tests/test_torch_mesh_wide.py; the
guided hunt, the session, ``minimize`` and the checkpoints on a split in
tests/test_torch_mesh_hunts.py (the files split so that each stays about
a minute here).

The configuration is tests/test_torch_sweep.py's Raft hunt with a 0.4 s
time limit and its kill and restart at 0.15 and 0.3 s (a world lives
about 25-35 steps, so that the CPU, which steps every block apart, stays
quick), metrics on and a 64-bucket ledger; 14 seeds, which pad to 16 on 4
and 8 devices. Tolerance: none.
"""
import importlib

import numpy as np
import pytest
import torch

import madsim_tpu.engine as J
import madsim_tpu_torch.engine as T
from madsim_tpu.parallel import mesh as jmesh
from madsim_tpu_torch.parallel import mesh as tmesh
from test_torch_sweep import assert_results_equal

jsweep = importlib.import_module("madsim_tpu.parallel.sweep")
tsweep = importlib.import_module("madsim_tpu_torch.parallel.sweep")

CPU = torch.device("cpu")
RK = dict(n=3, n_proposals=2, buggy_double_vote=True)
CK = dict(n_nodes=3, outbox_cap=4, queue_cap=64, t_limit_us=400_000,
          metrics=True)
FAULTS = np.array([[150_000, J.FAULT_KILL, 0, 0],
                   [300_000, J.FAULT_RESTART, 0, 0]], np.int32)
SEEDS = np.arange(14)
# Recycled through 5 slots (6 on 2 devices, 8 on 4 and 8): refills, the
# dry-cursor shrink (on 4 devices), metrics and coverage in one sweep.
KW = dict(chunk_steps=16, max_steps=2_000, faults=FAULTS, recycle=True,
          batch_worlds=5, coverage_buckets=64)
LOOPS = {"serial": dict(pipeline=False), "pipelined": dict(pipeline=True),
         "fused": dict(fused=True)}


def meshes(name):
    """(JAX's mesh, the port's) by name."""
    if name == "2x4":
        return (jmesh.multihost_mesh(n_hosts=2),
                tmesh.multihost_mesh([CPU] * 8, n_hosts=2))
    k = int(name[1:])
    return jmesh.seed_mesh(n_devices=k), tmesh.seed_mesh([CPU] * k)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def engines():
    return (J.DeviceEngine(J.RaftActor(J.RaftDeviceConfig(**RK)),
                           J.EngineConfig(**CK)),
            T.DeviceEngine(T.RaftActor(T.RaftDeviceConfig(**RK)),
                           T.EngineConfig(**CK), device="cpu"))


def both(engines, mesh_name, seeds=SEEDS, **kw):
    """JAX's sweep on its mesh and the port's on its own, each with its
    ``_fetch`` calls counted, and the world counts of the port's step
    calls."""
    je, te = engines
    jm, tm = meshes(mesh_name)
    counts = {"jax": 0, "torch": 0}
    widths = []
    with pytest.MonkeyPatch.context() as mp:
        for mod, name in ((jsweep, "jax"), (tsweep, "torch")):
            def fetch(tree, real=mod._fetch, name=name):
                counts[name] += 1
                return real(tree)

            mp.setattr(mod, "_fetch", fetch)
        real_steps = T.DeviceEngine.run_steps

        def run_steps(self, state, k, gate=None):
            widths.append(int(state.active.shape[0]))
            return real_steps(self, state, k, gate=gate)

        mp.setattr(T.DeviceEngine, "run_steps", run_steps)
        jr = jsweep.sweep(None, je.cfg, seeds, engine=je, mesh=jm, **kw)
        tr = tsweep.sweep(None, te.cfg, seeds, engine=te, mesh=tm, **kw)
    return jr, tr, counts, widths


# ---------------------------------------------------------------------------
# The mesh helpers
# ---------------------------------------------------------------------------

def test_mesh_helpers_and_their_errors(engines):
    flat = tmesh.seed_mesh([CPU] * 8)
    assert flat.devices.shape == (8,) and flat.axis_names == ("worlds",)
    assert flat.size == 8 and flat.shape == {"worlds": 8}
    assert tmesh.seed_mesh([CPU] * 8, n_devices=4).devices.shape == (4,)
    two = tmesh.multihost_mesh([CPU] * 8)          # 2 hosts by default
    assert two.devices.shape == (2, 4)
    assert two.axis_names == ("dcn", "worlds") == jmesh.multihost_mesh(
        n_hosts=2).axis_names
    assert all(d == CPU for d in two.devices.flat)
    # JAX's error for a device list that does not split over the hosts.
    with pytest.raises(ValueError) as te:
        tmesh.multihost_mesh([CPU] * 6, n_hosts=4)
    import jax

    with pytest.raises(ValueError) as je:
        jmesh.multihost_mesh(jax.devices()[:6], n_hosts=4)
    assert str(te.value) == str(je.value)
    # Hashable and equal by value: the compiled-program caches key on it.
    assert tmesh.seed_mesh([CPU] * 2) == tmesh.seed_mesh(["cpu", "cpu"])
    assert len({tmesh.seed_mesh([CPU] * 2), tmesh.seed_mesh([CPU] * 2),
                tmesh.seed_mesh([CPU] * 4), two}) == 3
    assert tmesh.world_spec(two).axes == ("dcn", "worlds")
    assert tmesh.scalar_spec().axes == ()
    assert tmesh.world_sharding(two) == (two, tmesh.world_spec(two))
    # No CPU fallback: the default mesh is every CUDA device.
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError,
                           match=r"devices=\[torch.device\('cpu'\)\] \* k"):
            tmesh.seed_mesh()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmesh.multihost_mesh()
    # shard_worlds: contiguous blocks that gather back bitwise, and a
    # width that is not a mesh multiple raises.
    _je, te = engines
    state = te.init(np.arange(8), faults=FAULTS)
    sh = tmesh.shard_worlds(state, two)
    assert len(sh.shards) == 8 and sh.n_worlds == 8
    assert [int(b.now.shape[0]) for b in sh.shards] == [1] * 8
    from madsim_tpu_torch.engine.core import tree_leaves

    for a, b in zip(tree_leaves(state), tree_leaves(sh.gather())):
        assert torch.equal(a.view(torch.int32) if a.dtype == torch.uint32
                           else a, b.view(torch.int32)
                           if b.dtype == torch.uint32 else b)
    # Each block owns its memory.
    assert sh.shards[0].now.data_ptr() != state.now.data_ptr()
    with pytest.raises(ValueError, match="multiple of the mesh size"):
        tmesh.shard_worlds(te.init(np.arange(6)), tmesh.seed_mesh([CPU] * 4))
    # One device: the batch is the one block as it is.
    one = tmesh.shard_worlds(state, tmesh.seed_mesh([CPU]))
    assert one.shards[0] is state and one.gather() is state


def test_compact_bucket_boundaries():
    """JAX's cases (tests/test_parallel.py), and the two functions equal
    over a grid of widths, occupancies and mesh sizes."""
    cb = tsweep._compact_bucket
    assert cb(0, 64, 8) == 8 and cb(0, 16, 8) == 8
    assert cb(0, 8, 8) == 8 and cb(1, 8, 8) == 8
    assert cb(33, 64, 8) == 64 and cb(9, 16, 8) == 16
    assert cb(9, 64, 8) == 16 and cb(5, 64, 8) == 8
    assert cb(1, 7, 8) == 7
    assert cb(1, 384, 8) == 24 and cb(3, 24, 8) == 24
    assert cb(1, 64, 1) == 1 and cb(3, 64, 1) == 4
    for n_dev in (1, 2, 4, 8):
        for w in range(n_dev, 97, n_dev):
            for n_act in range(0, w + 1):
                assert cb(n_act, w, n_dev) == \
                    jsweep._compact_bucket(n_act, w, n_dev)


# ---------------------------------------------------------------------------
# The three loops on each mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("loop", sorted(LOOPS))
@pytest.mark.parametrize("mesh_name", ["k2", "k4"])
def test_recycled_sweep_matches_jax_mesh(engines, mesh_name, loop):
    """14 seeds padded to the mesh, recycled through slots that round up
    to it, metrics and coverage: every field equals JAX's sweep on its
    own mesh of that size, and so do the ``_fetch`` calls (one per read
    of the loop's scalars and per retirement, whatever the mesh). Each
    block is stepped apart: no step call takes more than a block."""
    jr, tr, counts, widths = both(engines, mesh_name, **KW, **LOOPS[loop])
    assert_results_equal(jr, tr)
    n_dev = 8 if mesh_name == "2x4" else int(mesh_name[1:])
    assert tr.n_devices == n_dev
    assert tr.failing_seeds and tr.loop_stats["retire_fetches"] > 0
    assert counts["torch"] == counts["jax"]
    w0 = 5 + (-5) % n_dev
    assert set(widths) <= {w0 // n_dev, w0 // n_dev // 2,
                           w0 // n_dev // 4}
    if loop == "fused":
        assert tr.loop_stats["epochs_on_device"] > 0


@pytest.mark.parametrize("loop", ["serial", "pipelined"])
def test_compacted_sweep_matches_jax_mesh(engines, loop):
    """compact=True on 2 devices: 24 seeds shrink by halves while the half
    is even (12 → 6 at most: 3 would not split over 2), as in JAX."""
    jr, tr, _counts, widths = both(
        engines, "k2", seeds=np.arange(24), chunk_steps=16,
        max_steps=2_000, faults=FAULTS, compact=True, **LOOPS[loop])
    assert_results_equal(jr, tr)
    assert tr.loop_stats["retire_fetches"] > 0
    assert 3 <= min(widths) < 12


def test_split_keeps_the_one_device_contract_fields(engines):
    """What JAX's own tests hold equal across meshes (bug, observations,
    coverage) is the same on a 4-way split as on one device; the padding
    changes only the loop's shape."""
    _je, te = engines
    kw = dict(KW, pipeline=True)
    one = tsweep.sweep(None, te.cfg, SEEDS, engine=te, **kw)
    four = tsweep.sweep(None, te.cfg, SEEDS, engine=te,
                        mesh=tmesh.seed_mesh([CPU] * 4), **kw)
    np.testing.assert_array_equal(one.bug, four.bug)
    for k, v in one.observations.items():
        np.testing.assert_array_equal(four.observations[k], v, err_msg=k)
    np.testing.assert_array_equal(one.coverage.hits, four.coverage.hits)
    np.testing.assert_array_equal(one.coverage.first_seen_seed,
                                  four.coverage.first_seen_seed)
    assert (one.n_devices, four.n_devices) == (1, 4)
