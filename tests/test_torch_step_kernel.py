"""The CUDA step kernel's tile plan (``engine/step_kernel.py``), on the CPU.

The kernel itself runs only on a GPU (``chip_smoke.py`` holds it to the
plain step there); what is checked here is the Python that sizes its
shared-memory tiles and builds its parameter vector: the plan of each
main-path deployment, the largest configuration the kernel takes, the
bank-conflict-free strides and the access widths. Pure integer
arithmetic, no tolerance.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import madsim_tpu_torch.engine as T
from madsim_tpu_torch.engine import golden, step_kernel
from madsim_tpu_torch.engine.core import DEFAULT_BLOCK, tree_leaves

HEADLINE = golden.CONFIGS["headline"][:2]
HUNT = (dict(n=3, buggy_double_vote=True), golden.CONFIGS["hunt_faults"][1])
LARGEST = (dict(n=8, log_cap=64),
           dict(n_nodes=8, queue_cap=256, payload_words=16))
ODD = (dict(n=5, log_cap=7),
       dict(n_nodes=5, outbox_cap=6, queue_cap=30, payload_words=11))


def engine(rk, ck, **over):
    return T.DeviceEngine(T.RaftActor(T.RaftDeviceConfig(**rk)),
                          T.EngineConfig(**dict(ck, **over)), device="cpu")


def plan_of(rk, ck, **over):
    eng = engine(rk, ck, **over)
    return step_kernel.tile_plan(eng.cfg, eng.actor.rcfg.log_cap)


def per_world_bytes(n, q, L):
    """Shared bytes one world's rows take: the q_time and q_meta rows (an
    odd number of 16-byte chunks), the dirty mask, the commit row and the
    two log rows (int16 strides of 2 mod 4)."""
    return (2 * 16 * (-(-q // 4) | 1) + 8 + 2 * (n + (2 - n) % 4)
            + 2 * 2 * (n * L + (2 - n * L) % 4))


@pytest.mark.parametrize("name,cfgs,smem", [
    ("headline", HEADLINE, 38_400),
    ("hunt", HUNT, 97_792),
])
def test_main_path_deployments_get_the_default_block(name, cfgs, smem):
    plan = plan_of(*cfgs)
    rk, ck = cfgs
    assert plan.block == DEFAULT_BLOCK == 128
    assert plan.smem_bytes == smem <= step_kernel.SMEM_MAX
    assert plan.smem_bytes == plan.block * per_world_bytes(
        ck["n_nodes"], ck["queue_cap"], rk.get("log_cap", 16))
    # Q % 4 == 0 and P = 8: 16-byte queue and payload accesses.
    assert (plan.q_unit, plan.pay_unit) == (16, 16)


def test_largest_config_fits_one_warp_per_block():
    """N=8, Q=256, L=64, P=16: 4,164 shared bytes per world, so the
    default block shrinks to 32 worlds; asking for 64 raises."""
    plan = plan_of(*LARGEST)
    assert (plan.block, plan.smem_bytes) == (32, 133_248)
    assert plan.smem_bytes <= step_kernel.SMEM_MAX
    with pytest.raises(ValueError, match="pallas_block=64"):
        plan_of(*LARGEST, pallas_block=64)
    assert plan_of(*LARGEST, pallas_block=48).block == 48


def test_a_config_without_room_for_one_warp_raises():
    rk, ck = LARGEST
    eng = engine(rk, ck)
    cfg = T.EngineConfig(**dict(ck, queue_cap=2048))  # beyond MAX_Q
    with pytest.raises(ValueError, match="no block of 32 worlds fits"):
        step_kernel.tile_plan(cfg, eng.actor.rcfg.log_cap)


@pytest.mark.parametrize("cfgs", [HEADLINE, HUNT, LARGEST, ODD],
                         ids=["headline", "hunt", "largest", "odd"])
def test_strides_avoid_bank_conflicts(cfgs):
    """The pop reads its queue rows 16 bytes at a time: the eight threads
    of a quarter warp (one world each) reading the same chunk of their rows
    hit eight different groups of four banks, because a row is an odd
    number of chunks. The invariant reads int16s: 32 threads reading the
    same column hit 32 different 4-byte banks, because the int16 tiles'
    stride is 2 mod 4 (an odd number of words)."""
    plan = plan_of(*cfgs)
    rk, ck = cfgs
    n, q = ck["n_nodes"], ck["queue_cap"]
    L = rk.get("log_cap", 16)
    assert plan.q_stride % 4 == 0 and plan.q_stride >= q
    chunks = plan.q_stride // 4
    t8 = np.arange(8)
    for col in range(-(-q // 4)):
        for quarter in range(4):
            groups = ((quarter * 8 + t8) * chunks + col) % 8
            assert len(set(groups)) == 8
    t = np.arange(32)
    for stride, row in ((plan.commit_stride, n), (plan.log_stride, n * L)):
        assert stride >= row
        for col in range(row):
            assert len(set(((t * stride + col) // 2) % 32)) == 32
    # Q=28 -> 7 chunks, unpadded; Q=64 -> 17 chunks (68 slots).
    assert plan.q_stride == {28: 28, 64: 68}.get(q, plan.q_stride)


def test_tiles_are_aligned_and_apart():
    for cfgs in (HEADLINE, HUNT, LARGEST, ODD):
        p = plan_of(*cfgs)
        b = p.block
        offs = [0, p.off_qm, p.off_dirty, p.off_commit, p.off_lt, p.off_lc,
                p.smem_bytes]
        sizes = [b * p.q_stride * 4, b * p.q_stride * 4, b * 8,
                 b * p.commit_stride * 2, b * p.log_stride * 2,
                 b * p.log_stride * 2]
        for lo, hi, size in zip(offs, offs[1:], sizes):
            assert lo % 16 == 0 and hi - lo >= size


def test_access_widths_follow_the_rows_and_the_tensors():
    # Odd rows: 4-byte queue accesses (Q=30), 2-byte commit and log
    # accesses (N=5, N*L=35), element-wise payload rows (P=11).
    p = plan_of(*ODD)
    assert (p.q_unit, p.commit_unit, p.log_unit, p.pay_unit) == (4, 2, 2, 2)
    # The launch narrows a width to the tensors' alignment.
    x = torch.zeros(64, dtype=torch.int32)
    assert step_kernel._aligned(16, x) == 16
    assert step_kernel._aligned(16, x[1:]) == 4
    assert step_kernel._aligned(16, x[2:]) == 8
    assert step_kernel._aligned(4, x[:8].view(torch.int16)[1:]) == 2


def test_launch_vector_matches_the_kernels_params():
    """W, the engine's parameters, the family's, and the tile plan: as many
    ints as the kernel's Params struct holds, the plan's block beside them.
    Each family's parameters in the order its policy
    (``csrc/actor_*.cuh``) reads them: Raft's, tpc's, pb's, Paxos's, and
    the two pair families' (the targets and the beacon flag)."""
    from madsim_tpu_torch.actorc.families.paxos import (PaxosActor,
                                                        PaxosConfig,
                                                        engine_config)
    from madsim_tpu_torch.search.family import (GuidedPairActor,
                                                GuidedPairConfig)
    from madsim_tpu_torch.triage.synthetic import (PairRestartActor,
                                                   PairRestartConfig)

    src = (Path(step_kernel.__file__).resolve().parent.parent / "csrc"
           / "step_common.cuh").read_text()
    n_params = int(re.search(r"constexpr int N_PARAMS = (\d+);", src)[1])
    n_fam = len(re.search(r"int (f0, .*);", src)[1].split(","))
    assert n_fam == step_kernel.N_FAMILY_PARAMS == 8
    tpc = T.TPCDeviceConfig(n=4, n_txns=4, buggy_presumed_commit=True)
    pb = T.PBDeviceConfig(n=3, n_writes=4, buggy_commit_early=True)
    px = PaxosConfig(buggy_forgetful_acceptor=True, contend_all=True)
    cases = [
        (engine(*HEADLINE), 0, [4, 4, 150_000, 300_000, 50_000, 0], 7, 16),
        (T.DeviceEngine(T.TPCActor(tpc), T.EngineConfig(
            n_nodes=4, outbox_cap=5, queue_cap=64), device="cpu"), 1,
         [4, 50_000, 120_000, 60_000, 32, 1], 5, 16),
        (T.DeviceEngine(T.PBActor(pb), T.EngineConfig(
            n_nodes=3, outbox_cap=4, queue_cap=48), device="cpu"), 2,
         [16, 50_000, 200_000, 400_000, 4, 100_000, 150_000, 1], 6, 16),
        (T.DeviceEngine(PaxosActor(px), engine_config(px), device="cpu"), 3,
         [3, 150_000, 400_000, 3, 40_000, 30_000, 1, 5_000], 7, 2),
        (T.DeviceEngine(GuidedPairActor(GuidedPairConfig(n=12)),
                        T.EngineConfig(n_nodes=12, outbox_cap=2,
                                       queue_cap=64), device="cpu"), 4,
         [1, 2, 1], 2, 16),
        (T.DeviceEngine(PairRestartActor(PairRestartConfig(node_b=3)),
                        T.EngineConfig(n_nodes=4, outbox_cap=2,
                                       queue_cap=64), device="cpu"), 4,
         [1, 3, 0], 1, 16),
    ]
    for eng, family, fparams, kinds, pay_unit in cases:
        fparams = fparams + [0] * (n_fam - len(fparams))
        leaves = tree_leaves(eng.init(np.arange(8)))
        block, ints = step_kernel.launch_ints(eng, leaves)
        plan = step_kernel.engine_plan(eng)
        cfg = eng.cfg
        f0, t0 = 7, 7 + n_fam
        assert block == plan.block
        assert len(ints) == n_params
        assert ints[0] == 8 and ints[1:t0] == step_kernel.kernel_params(eng)
        assert ints[1:f0] == [cfg.n_nodes, cfg.queue_cap, cfg.payload_words,
                              family, cfg.t_limit_us, 1]
        assert ints[f0:t0] == fparams
        raft = family == 0
        assert ints[t0:t0 + 13] == [
            plan.smem_bytes, plan.q_stride, plan.commit_stride,
            plan.log_stride, 16, plan.commit_unit, 4 if raft else 0,
            pay_unit, plan.off_qm, plan.off_dirty, plan.off_commit,
            plan.off_lt, plan.off_lc]
        # The families beside Raft take no commit or log tiles.
        assert (plan.commit_stride > 0) == raft
        # The optional lanes: metrics off, the family's kinds, no ring.
        assert ints[t0 + 13:] == [0, kinds, 0]
        # One pointer per leaf: the engine's 24, the actor's lanes, the
        # metrics block's 13 and the ring's 8 (null when off).
        ptrs = step_kernel.kernel_pointers(eng, leaves)
        assert len(ptrs) == len(leaves) + 21 and ptrs[-21:] == [0] * 21
