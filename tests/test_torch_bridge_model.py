"""The numpy model of the bridge's CUDA round and drain
(``bridge.cuda.bridge_model``) against the port's plain round and drain,
on the CPU, with tolerance 0.

The model is the kernels' order of work: the worlds grouped into blocks and
warps as the launch groups them, the staged rows, and each pop one
reduction of the fused key ``(dl, seq, index)`` with the partials of the
world's lanes merged in the shuffles' order, the advance's min taken from
the first pop and more_due from the last. Every StepOut and DrainOut
field, the clock, the lanes ``[:, :cap]`` and the metrics must equal
``step_plain`` and ``drain_plain``'s, on the synthetic streams and on
hand-built rows (a live candidate whose seq is INT64_MAX behind a
lower-index non-candidate, every lane empty, a cluster of 8 timers on one
deadline, a deadline within 50 ns of INF_NS, W not a multiple of the
worlds a warp or a block at 16 and 8 lanes a world).
"""
import numpy as np
import pytest
import torch

from madsim_tpu_torch.bridge import cuda as bcuda
from madsim_tpu_torch.bridge import golden
from madsim_tpu_torch.bridge.kernel import (INF_NS, BridgeKernel, DrainOut,
                                            HostBatch, StepOut, net_keys)
from madsim_tpu_torch.bridge.synthetic import SyntheticStream, drive


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    # The plain round's small ops run about twice as fast on one thread.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class ModelKernel:
    """A BridgeKernel whose rounds and drains are ``bridge_model``'s, on
    numpy state (the dump column starts at INF_NS and is never written)."""

    def __init__(self, seeds, *, cap, k_events, metrics=False):
        self.W, self.cap, self.k_events = len(seeds), cap, k_events
        self.k0, self.k1 = net_keys(seeds)
        self.clock = np.zeros((self.W,), np.int64)
        self.lane_dl = np.full((self.W, cap + 1), INF_NS, np.int64)
        self.lane_seq = np.zeros((self.W, cap + 1), np.int64)
        self.mb = np.zeros((6, self.W), np.int64) if metrics else None
        self.stats = []

    def _run(self, batch):
        (self.clock, self.lane_dl, self.lane_seq, self.mb, out,
         stats) = bcuda.bridge_model(
            self.clock, self.lane_dl, self.lane_seq, self.k0, self.k1, batch,
            cap=self.cap, k_events=self.k_events, mb=self.mb)
        self.stats.append(stats)
        return out

    def step(self, batch):
        return self._run(batch)

    def drain(self):
        return self._run(None)

    def reset_slots(self, pairs):
        for slot, seed in pairs:
            k0, k1 = net_keys([seed])
            self.k0[slot], self.k1[slot] = k0[0], k1[0]
            self.clock[slot] = 0
            self.lane_dl[slot] = INF_NS
            self.lane_seq[slot] = 0


def plain_kernel(seeds, **kw):
    return BridgeKernel(seeds, device="cpu", **kw)


def assert_same(model, plain, where):
    cap = plain.cap
    st = plain.state
    assert np.array_equal(model.clock, st.clock.numpy()), f"{where}: clock"
    for name, a, b in (("lane_dl", model.lane_dl, st.lane_dl),
                       ("lane_seq", model.lane_seq, st.lane_seq)):
        assert np.array_equal(a[:, :cap], b.numpy()[:, :cap]), \
            f"{where}: {name}"
    pm = plain.metrics()
    if pm is not None:
        assert np.array_equal(model.mb, np.stack(list(pm.values()))), \
            f"{where}: metrics"


def load(kernel, model, dl, seq, clock=None):
    """Gives both kernels the lanes ``dl``/``seq`` (W, cap) and clock."""
    w = dl.shape[0]
    clock = np.zeros((w,), np.int64) if clock is None else clock
    kernel.state.lane_dl[:, :kernel.cap] = torch.as_tensor(dl)
    kernel.state.lane_seq[:, :kernel.cap] = torch.as_tensor(seq)
    kernel.state.clock[:] = torch.as_tensor(clock)
    model.lane_dl[:, :kernel.cap] = dl
    model.lane_seq[:, :kernel.cap] = seq
    model.clock[:] = clock


def empty_batch(w, clock, advance=True):
    z = np.zeros((w, 1))
    return HostBatch(
        t_slot=z.astype(np.int32), t_dl=z.astype(np.int64),
        t_seq=z.astype(np.int64), t_mask=z.astype(bool),
        c_slot=z.astype(np.int32), c_mask=z.astype(bool),
        s_ctr=z.astype(np.uint64), s_base=z.astype(np.int64),
        s_slot=z.astype(np.int32), s_seq=z.astype(np.int64),
        s_thr=z.astype(np.uint64), s_lossall=z.astype(bool),
        s_lat_lo=z.astype(np.int64), s_lat_w=np.ones((w, 1), np.int64),
        s_mask=z.astype(bool), s_live=z.astype(bool),
        clock=np.asarray(clock, np.int64),
        advance=np.full((w,), advance))


def step_and_drain(plain, model, batch, where):
    """One round, then drains while any world has more due; every output
    and the state held to the plain version's."""
    want, got = plain.step(batch), model.step(batch)
    bad = golden.outputs_differ(StepOut(*got), StepOut(*want))
    assert not bad, f"{where}: step: {bad} differ"
    assert_same(model, plain, f"{where}: step")
    outs = [want]
    for n in range(8):
        if not np.asarray(outs[-1].more_due).any():
            break
        want = DrainOut(*[np.asarray(x) for x in plain.drain()])
        got = model.drain()
        bad = golden.outputs_differ(got, want)
        assert not bad, f"{where}: drain {n}: {bad} differ"
        assert_same(model, plain, f"{where}: drain {n}")
        outs.append(want)
    return outs


@pytest.mark.parametrize("cap,k_events", [(128, 4), (128, 1), (40, 4),
                                          (40, 1)])
@pytest.mark.parametrize("mode", ["realistic", "edge"])
def test_model_matches_plain_on_the_streams(mode, cap, k_events):
    seeds = np.arange(64)
    metrics = k_events == 4
    plain = plain_kernel(seeds, cap=cap, k_events=k_events, metrics=metrics)
    model = ModelKernel(seeds, cap=cap, k_events=k_events, metrics=metrics)
    stream = SyntheticStream(seeds, cap=cap, mode=mode, seed=cap + k_events)
    counts = dict(step=0, drain=0, reset=0)
    for op, outs in drive(stream, [plain, model], 16):
        counts[op] += 1
        if op != "reset":
            bad = golden.outputs_differ(outs[1], outs[0])
            assert not bad, f"{op} {counts[op]}: {bad} differ"
    assert_same(model, plain, "end")
    assert counts["step"] == 16
    if mode == "edge":
        assert counts["drain"] > 0 and counts["reset"] > 0
    # W=64 is below the target grid: 32 lanes and one world a block,
    # each world's rows copied by its lanes (CAP + 1 is odd).
    assert {(s["lanes_per_world"], s["worlds_per_block"])
            for s in model.stats} == {(32, 1)}
    assert all(s["async_warps"] == 64 for s in model.stats)


def test_inf_seq_candidate_behind_a_lower_index_non_candidate():
    """The least deadline's only candidate has seq INT64_MAX: every cand
    is INF, so JAX's argmin pops index 0, a slot at a later deadline, and
    keeps popping it; more_due stays set by the candidate."""
    w, cap = 4, 40
    dl = np.full((w, cap), INF_NS, np.int64)
    seq = np.zeros((w, cap), np.int64)
    dl[:, 0], seq[:, 0] = 900, 7        # non-candidate, lower index
    dl[:, 5], seq[:, 5] = 500, INF_NS   # the live candidate
    dl[1, 3], seq[1, 3] = 500, INF_NS   # two INF candidates
    dl[2, 0] = 500                      # slot 0 is a candidate too
    dl[3, 9], seq[3, 9] = 500, 4        # a real candidate wins
    for k in (1, 4):
        plain = plain_kernel(np.arange(w), cap=cap, k_events=k,
                             metrics=True)
        model = ModelKernel(np.arange(w), cap=cap, k_events=k, metrics=True)
        load(plain, model, dl, seq)
        outs = step_and_drain(plain, model, empty_batch(w, np.zeros(w)),
                              f"k={k}")
        slots = np.asarray(outs[0].event_slot)
        assert slots[0, 0] == 0 and slots[3, 0] == 9
        assert np.asarray(outs[0].more_due)[0]


def test_every_lane_empty():
    """Every lane empty: the advance finds no timer (a deadlock where it
    asked to advance), and each pop reads the whole row of seqs; at a
    clock of INF_NS the empty lanes fall due."""
    w, cap = 6, 40
    dl = np.full((w, cap), INF_NS, np.int64)
    rng = np.random.default_rng(3)
    seq = rng.integers(-5, 5, size=(w, cap)).astype(np.int64)
    seq[1] = INF_NS
    seq[2, 7] = -100
    for k in (1, 4):
        plain = plain_kernel(np.arange(w), cap=cap, k_events=k)
        model = ModelKernel(np.arange(w), cap=cap, k_events=k)
        load(plain, model, dl, seq)
        clock = np.array([0, 5, INF_NS, INF_NS - 1, INF_NS, 0], np.int64)
        advance = np.array([True, False, True, True, False, True])
        batch = empty_batch(w, clock)._replace(advance=advance)
        outs = step_and_drain(plain, model, batch, f"k={k}")
        assert np.array_equal(np.asarray(outs[0].deadlock), advance)
        assert np.asarray(outs[0].event_slot)[2, 0] == 7


def test_cluster_of_eight_on_one_deadline():
    """Eight timers on one deadline with k=4: two pops' worth of rounds and
    drains, in seq order with ties broken by the first index."""
    w, cap, k = 5, 128, 4
    plain = plain_kernel(np.arange(w), cap=cap, k_events=k, metrics=True)
    model = ModelKernel(np.arange(w), cap=cap, k_events=k, metrics=True)
    rng = np.random.default_rng(8)
    b = empty_batch(w, np.full(w, 10))
    t_slot = np.stack([rng.choice(cap, 8, replace=False) for _ in range(w)])
    t_seq = rng.integers(0, 4, size=(w, 8))     # repeated seqs: ties
    b = b._replace(
        t_slot=t_slot.astype(np.int32), t_dl=np.full((w, 8), 2_000_000),
        t_seq=t_seq.astype(np.int64), t_mask=np.ones((w, 8), bool))
    outs = step_and_drain(plain, model, b, "cluster")
    assert len(outs) >= 2
    assert np.asarray(outs[0].event_valid).all()


def test_deadline_within_50ns_of_inf():
    """A deadline within 50 ns of INF_NS: the advance's sum wraps below
    the clock, which stays; the lane is due only at a clock that high."""
    w, cap = 4, 40
    dl = np.full((w, cap), INF_NS, np.int64)
    seq = np.arange(w * cap, dtype=np.int64).reshape(w, cap)
    dl[:, 3] = INF_NS - np.array([1, 10, 49, 50])
    dl[2, 9] = INF_NS - 49
    for k in (1, 4):
        plain = plain_kernel(np.arange(w), cap=cap, k_events=k,
                             metrics=True)
        model = ModelKernel(np.arange(w), cap=cap, k_events=k, metrics=True)
        load(plain, model, dl, seq)
        clock = np.array([5, INF_NS - 10, INF_NS - 49, 0], np.int64)
        step_and_drain(plain, model, empty_batch(w, clock), f"k={k}")


@pytest.mark.parametrize("w,cap,lanes,paths", [
    (2049, 40, 16, (1024, 1)), (4097, 128, 8, (1024, 1)),
    (2051, 40, 16, (1025, 1)), (3003, 128, 16, (1501, 1)),
    (4101, 128, 8, (1025, 1))])
def test_w_not_a_multiple_of_the_worlds_a_block(w, cap, lanes, paths):
    """Wide rounds give a world 16 or 8 lanes (2 or 4 worlds a warp); at
    an odd W the last warp holds one world, which copies its row by its
    lanes while every other warp takes the bulk copy, and the warp's other
    groups run without a world. At 2,051, 3,003 and 4,101 the last block
    holds 3, 11 and 5 worlds: its seq rows start past an odd number of
    deadline words, padded to 16 bytes, and its full warps still take the
    bulk copy (``paths``: the bulk and the per-lane warps). The synthetic
    edge stream's first rounds."""
    seeds = np.arange(w)
    assert bcuda.launch_shape(w, cap)[0] == lanes
    plain = plain_kernel(seeds, cap=cap, k_events=4, metrics=True)
    model = ModelKernel(seeds, cap=cap, k_events=4, metrics=True)
    stream = SyntheticStream(seeds, cap=cap, mode="edge", seed=21)
    for op, outs in drive(stream, [plain, model], 3):
        if op != "reset":
            bad = golden.outputs_differ(outs[1], outs[0])
            assert not bad, f"{op}: {bad} differ"
    assert_same(model, plain, "end")
    st = model.stats[0]
    assert st["lanes_per_world"] == lanes
    assert (st["bulk_warps"], st["async_warps"]) == paths


@pytest.mark.parametrize("w,cap,want", [
    (1, 128, (32, 1)), (7, 40, (32, 1)), (130, 1024, (32, 1)),
    (264, 128, (32, 2)), (512, 128, (32, 2)), (512, 1024, (32, 2)),
    (1056, 128, (32, 8)), (2048, 40, (16, 8)), (3000, 128, (16, 16)),
    (4096, 128, (8, 16)), (4096, 1024, (32, 2))])
def test_launch_shape(w, cap, want):
    """The grid rule: 8 or 16 lanes a world only where each lane scans at
    most 16 slots and 1,024 warps remain; at least 132 blocks where W
    allows; at most 8 warps and 48 KB of staged rows a block."""
    lanes, warps, per = bcuda.launch_shape(w, cap)
    assert (lanes, per) == want
    assert per == warps * 32 // lanes and warps <= 8
    assert bcuda._smem_bytes(per, cap) <= bcuda.SMEM_BUDGET
