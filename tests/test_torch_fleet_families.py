"""The fleet's chaos matrix over the compiled families in the port
(madsim_tpu_torch/fleet): tests/test_fleet.py's pb and tpc legs.

A fleet sweep under tests/test_fleet.py's full failure mix (a kill, a
preemption, duplicated completions, dropped RPCs and heartbeats) returns
seed ids, bug flags, per-seed observations and the schedule fingerprint
bitwise those of a crash-free fleet and of the port's single-host
``sweep()``, bitwise (tolerance 0). The families run through the actor
compiler's plain step (``device="cpu"``; on CUDA, their kernel
policies); the CPU's plain step runs one thread here (a module fixture).
The Raft matrix, held to JAX's fleet as well, is in
tests/test_torch_fleet.py.
"""
import importlib

import numpy as np
import pytest
import torch

import madsim_tpu_torch.engine as T
from madsim_tpu_torch.fleet import ChaosConfig, fleet_sweep
from madsim_tpu_torch.fleet.merge import contract_mismatches

tsweep = importlib.import_module("madsim_tpu_torch.parallel.sweep")
SWEEP_KW = dict(chunk_steps=64, max_steps=20_000)
CHAOS = ChaosConfig(seed=11, kill_at=(("w0", 2),),
                    preempt_at=(("w1", 5),),
                    duplicate_all_completions=True,
                    drop_rpc_rate=0.25, drop_heartbeat_rate=0.1,
                    restart_after=2)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def matrix(eng, seeds):
    """Single-host, clean fleet and chaotic fleet (two workers, ranges of
    8): the fleets' contract fields equal the single-host sweep's."""
    single = tsweep.sweep(None, eng.cfg, seeds, engine=eng, **SWEEP_KW)
    clean = fleet_sweep(None, eng.cfg, seeds, engine=eng, n_workers=2,
                        range_size=8, **SWEEP_KW)
    chaotic = fleet_sweep(None, eng.cfg, seeds, engine=eng, n_workers=2,
                          range_size=8, chaos=CHAOS, **SWEEP_KW)
    assert contract_mismatches(single, clean) == []
    assert contract_mismatches(single, chaotic) == []
    assert single.failing_seeds == chaotic.failing_seeds
    return single, chaotic


def test_chaos_matrix_pb():
    eng = T.DeviceEngine(
        T.PBActor(T.PBDeviceConfig(n=3, n_writes=4)),
        T.EngineConfig(n_nodes=3, outbox_cap=4, queue_cap=64,
                       t_limit_us=1_500_000, loss_rate=0.05), device="cpu")
    _single, chaotic = matrix(eng, np.arange(32))
    assert chaotic.loop_stats["fleet"]["kills"] >= 1


def test_chaos_matrix_tpc():
    eng = T.DeviceEngine(
        T.TPCActor(T.TPCDeviceConfig(n=4, n_txns=4,
                                     buggy_presumed_commit=True)),
        T.EngineConfig(n_nodes=4, outbox_cap=5, queue_cap=64,
                       t_limit_us=1_500_000, loss_rate=0.1), device="cpu")
    single, _chaotic = matrix(eng, np.arange(32))
    assert single.failing_seeds  # buggy config: bug attribution survives


def test_compiled_actors_pickle_for_spawned_workers():
    """A spawned fleet worker receives the actor pickled: each compiled
    family pickles by its config and compiles again, to an actor whose
    worlds step as the original's."""
    import pickle

    from madsim_tpu_torch.actorc.families import paxos

    tcfg = T.EngineConfig(n_nodes=4, outbox_cap=5, queue_cap=64)
    pcfg = T.EngineConfig(n_nodes=3, outbox_cap=4, queue_cap=64)
    cases = ((T.TPCActor(T.TPCDeviceConfig(n=4, n_txns=4)), tcfg),
             (T.PBActor(T.PBDeviceConfig(n=3, n_writes=4)), pcfg),
             (paxos.PaxosActor(), paxos.engine_config()))
    for actor, cfg in cases:
        twin = pickle.loads(pickle.dumps(actor))
        assert type(twin) is type(actor) and twin is not actor
        obs = [e.observe(e.run(e.init(np.arange(8)), 64))
               for e in (T.DeviceEngine(a, cfg, device="cpu")
                         for a in (actor, twin))]
        for k in obs[0]:
            np.testing.assert_array_equal(obs[0][k], obs[1][k], err_msg=k)
