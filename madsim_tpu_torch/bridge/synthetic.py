"""Seeded, closed-loop streams of bridge rounds, for holding one kernel to
another.

:class:`SyntheticStream` plays the host driver's part for W worlds: it
keeps each world's lane slots in a free list, records timers, cancels and
sends into padded :class:`~madsim_tpu_torch.bridge.kernel.HostBatch`
rounds (slots distinct within each scatter, as the host driver's are),
and frees the slots that a round's or a drain's pops report, and the slots
of sends that were lost or had no destination, as ``SliceDriver`` does. Its
next round depends on the kernel's outputs, so two kernels driven by one
stream see the same rounds only while they agree. Numpy only: the stream
runs where JAX does not.

Two modes:

- ``realistic``: per world and round 0-3 timers 1-10 ms ahead, 0-2
  cancels and 0-4 sends at 1-10 ms latency, each world at one of the loss
  rates 0, 0.1, 0.5, 0.9 and 1.0;
- ``edge``: NET counters that cross 2^32 - 1 and 2^64 - 1, loss
  thresholds at and above 2^63, latency widths of 2^31 + 1, 2^40 and
  2^62 + 3, send times that make the delivery sum wrap, deadlines at and
  past the wheel's horizon (and within 50 ns of INF_NS, where the advance
  wraps), clusters of up to 8 timers on one deadline (more due than k
  pops, so drains follow), ``advance=False`` rows, rows with nothing left
  to wait for (deadlocks), a cancelled slot reused by a timer in the same
  round, and ``reset_slot`` / ``reset_slots`` every few rounds.

:func:`drive` runs a stream through one or more kernels in lockstep,
draining as the host driver does (the next drain is dispatched before the
current one is read).
"""
from __future__ import annotations

from typing import Iterator, List, Sequence, Tuple

import numpy as np

from .kernel import INF_NS, TIMER_MAX_NS, DrainOut, HostBatch, StepOut

MS = 1_000_000
#: Loss rates of the realistic worlds, by world index.
LOSS_RATES = (0.0, 0.1, 0.5, 0.9, 1.0)
#: Batch widths (T, C, S) of each mode.
WIDTHS = {"realistic": (4, 4, 4), "edge": (8, 4, 8)}
U64_MAX = (1 << 64) - 1


def loss_threshold(p: float) -> int:
    """The host's loss threshold of a loss rate, as a u64: a send is lost
    iff its draw is below it (or the rate is 1)."""
    if p <= 0.0:
        return 0
    if p >= 1.0:
        return U64_MAX
    return int(p * 18446744073709551616.0)


class SyntheticStream:
    """The host side of a bridge sweep over ``seeds``, made from ``seed``
    (see the module docstring)."""

    def __init__(self, seeds: Sequence[int], *, cap: int,
                 mode: str = "realistic", seed: int = 0):
        if mode not in WIDTHS:
            raise ValueError(f"mode is 'realistic' or 'edge'; got {mode!r}")
        self.mode = mode
        self.edge = mode == "edge"
        self.cap = int(cap)
        self.T, self.C, self.S = WIDTHS[mode]
        if self.T + self.S > self.cap:
            raise ValueError(f"cap {cap} holds fewer slots than a round of "
                             f"{mode} may take ({self.T + self.S})")
        w = self.W = len(seeds)
        self.rng = np.random.default_rng(seed)
        self.round = 0
        self.next_seed = int(max(seeds)) + 1 if w else 0
        self.occ = np.zeros((w, self.cap), bool)    # slot holds a timer
        self.held = np.zeros((w, self.cap), np.int64)  # its seq
        self.next_seq = np.zeros((w,), np.int64)
        self.clock = np.zeros((w,), np.int64)
        idx = np.arange(w)
        self.ctr = np.zeros((w,), np.uint64)
        p = np.array(LOSS_RATES)[idx % len(LOSS_RATES)]
        self.thr = np.array([loss_threshold(x) for x in p], np.uint64)
        self.lossall = p >= 1.0
        self.lat_lo = np.full((w,), MS, np.int64)
        self.lat_w = np.full((w,), 9 * MS, np.int64)
        if self.edge:
            kind = idx % 8
            # NET counters that cross the 32-bit and the 64-bit wrap.
            self._start_ctr = np.where(
                kind == 1, np.uint64((1 << 32) - 3),
                np.where(kind == 2, np.uint64(U64_MAX - 4), np.uint64(0)))
            self.ctr = self._start_ctr.copy()
            # Loss thresholds at and above 2^63.
            high = np.array([1 << 63, (1 << 63) + 12345, U64_MAX - 1],
                            np.uint64)
            self.thr = np.where(kind == 3, high[idx % 3], self.thr)
            self.lossall = np.where(kind == 3, False, self.lossall)
            # Latency widths past 2^31, 2^32 and 2^62.
            widths = np.array([(1 << 31) + 1, 1 << 40, (1 << 62) + 3],
                              np.int64)
            self.lat_w = np.where(kind == 4, widths[idx % 3], self.lat_w)
            self.lat_lo = np.where(kind == 4, (idx % 5) * 1000, self.lat_lo)
        else:
            self._start_ctr = self.ctr.copy()
        self._sends = None

    # -- rounds --------------------------------------------------------------
    def resets(self) -> List[Tuple[int, int]]:
        """The ``(slot, seed)`` pairs to re-key before the next round (edge
        mode, every fifth round; empty otherwise). The stream clears its
        own record of those worlds."""
        if not self.edge or self.round == 0 or self.round % 5 or not self.W:
            return []
        n = 1 if (self.round // 5) % 2 else min(self.W, 3)
        slots = np.sort(self.rng.choice(self.W, size=n, replace=False))
        pairs = []
        for s in slots.tolist():
            pairs.append((s, self.next_seed))
            self.next_seed += 1
            self.occ[s] = False
            self.clock[s] = 0
            self.ctr[s] = self._start_ctr[s]
        return pairs

    def _pick(self, free: np.ndarray, n: int) -> np.ndarray:
        """``n`` distinct random free slots per world (-1 where a world has
        fewer), in random order."""
        keys = self.rng.random(free.shape)
        keys[~free] = 2.0
        part = np.argpartition(keys, n - 1, axis=1)[:, :n]
        k = np.take_along_axis(keys, part, axis=1)
        order = np.argsort(k, axis=1, kind="stable")
        part = np.take_along_axis(part, order, axis=1)
        k = np.take_along_axis(k, order, axis=1)
        return np.where(k < 2.0, part, -1)

    def batch(self) -> HostBatch:
        """The next round's padded batch."""
        rng, w, cap = self.rng, self.W, self.cap
        T, C, S = self.T, self.C, self.S
        edge = self.edge
        idx = np.arange(w)

        # Cancels: up to 2 occupied slots (edge: up to C).
        n_c = rng.integers(0, (C if edge else 2) + 1, size=w)
        keys = rng.random((w, cap))
        keys[~self.occ] = 2.0
        c_order = np.argsort(keys, axis=1, kind="stable")[:, :C]
        c_mask = (np.arange(C)[None, :] < n_c[:, None]) & (
            np.take_along_axis(keys, c_order, axis=1) < 2.0)
        c_slot = np.where(c_mask, c_order, 0).astype(np.int32)
        r, c = np.nonzero(c_mask)
        self.occ[r, c_slot[r, c]] = False

        # Timers and sends take distinct free slots (cancelled ones among
        # them: the kernel cancels first).
        n_t = rng.integers(0, 4, size=w)
        n_s = rng.integers(0, 5, size=w)
        if edge:
            n_t = np.where(idx % 8 == 5, rng.integers(0, T + 1, size=w), n_t)
            n_t = np.where(idx % 8 == 0, 0, n_t)   # runs dry: deadlocks
            n_s = np.where(idx % 8 == 0, 0, n_s)
        picked = self._pick(~self.occ, T + S)
        if edge:
            # Cancel-then-reuse: the first cancelled slot becomes the first
            # timer's (where it was picked elsewhere, that pick takes the
            # first timer's old slot).
            reuse = (idx % 8 == 6) & c_mask[:, 0] & (n_t > 0)
            c0 = c_slot[:, :1].astype(picked.dtype)
            moved = (picked == c0) & reuse[:, None]
            picked = np.where(moved, picked[:, :1], picked)
            picked[:, 0] = np.where(reuse, c0[:, 0], picked[:, 0])
        t_slot = picked[:, :T]
        s_slot = picked[:, T:].copy()
        if edge:
            # A timer and a send on one slot: the send's write comes last.
            both = (idx % 8 == 6) & (n_t > 0) & (n_s > 0) & (t_slot[:, 0] >= 0)
            s_slot[:, 0] = np.where(both, t_slot[:, 0], s_slot[:, 0])
        t_mask = (np.arange(T)[None, :] < n_t[:, None]) & (t_slot >= 0)
        s_mask = (np.arange(S)[None, :] < n_s[:, None]) & (s_slot >= 0)

        clock_in = self.clock + np.where(rng.random(w) < 0.25,
                                         rng.integers(0, 1000, size=w), 0)
        t_dl = clock_in[:, None] + rng.integers(MS, 10 * MS, size=(w, T))
        if edge:
            # A cluster on one deadline: more due than k pops.
            cluster = idx % 8 == 5
            t_dl = np.where(cluster[:, None], t_dl[:, :1], t_dl)
            # At and past the horizon, and within 50 ns of INF_NS.
            far = rng.integers(0, 3, size=w)
            horizon = np.where(far == 0, TIMER_MAX_NS,
                               np.where(far == 1, TIMER_MAX_NS + 777,
                                        INF_NS - rng.integers(1, 50, size=w)))
            t_dl[:, 0] = np.where((idx % 8 == 7) & (rng.random(w) < 0.3),
                                  horizon, t_dl[:, 0])
        seq0 = self.next_seq[:, None]
        t_seq = seq0 + np.arange(T)[None, :]
        s_seq = seq0 + T + np.arange(S)[None, :]
        self.next_seq += T + S
        r, c = np.nonzero(t_mask)
        self.occ[r, t_slot[r, c]] = True
        self.held[r, t_slot[r, c]] = t_seq[r, c]

        # Sends: two NET draws each (loss, latency).
        k = np.cumsum(s_mask, axis=1) - s_mask
        s_ctr = self.ctr[:, None] + (2 * k).astype(np.uint64)
        self.ctr = self.ctr + (2 * s_mask.sum(axis=1)).astype(np.uint64)
        s_base = np.broadcast_to(clock_in[:, None], (w, S)).copy()
        if edge:
            near = (idx % 8 == 4)[:, None] & (rng.random((w, S)) < 0.2)
            s_base = np.where(near, INF_NS - rng.integers(0, 1 << 21,
                                                          size=(w, S)),
                              s_base)
        s_live = rng.random((w, S)) < 0.9
        self._sends = (s_slot, s_seq, s_mask & s_live)

        advance = np.ones((w,), bool)
        if edge:
            advance = rng.random(w) >= 0.1
        self.round += 1
        b = HostBatch(
            t_slot=np.where(t_mask, t_slot, 0).astype(np.int32),
            t_dl=t_dl.astype(np.int64), t_seq=t_seq.astype(np.int64),
            t_mask=t_mask, c_slot=c_slot, c_mask=c_mask,
            s_ctr=s_ctr.astype(np.uint64), s_base=s_base.astype(np.int64),
            s_slot=np.where(s_mask, s_slot, 0).astype(np.int32),
            s_seq=s_seq.astype(np.int64),
            s_thr=np.broadcast_to(self.thr[:, None], (w, S)).copy(),
            s_lossall=np.broadcast_to(self.lossall[:, None], (w, S)).copy(),
            s_lat_lo=np.broadcast_to(self.lat_lo[:, None], (w, S)).copy(),
            s_lat_w=np.broadcast_to(self.lat_w[:, None], (w, S)).copy(),
            s_mask=s_mask, s_live=s_live, clock=clock_in.astype(np.int64),
            advance=advance)
        return b

    def after_step(self, out: StepOut) -> None:
        """Take the round's outputs: the clock, the sends that landed, the
        popped slots."""
        s_slot, s_seq, live = self._sends
        r, c = np.nonzero(live & np.asarray(out.send_ok, bool))
        self.occ[r, s_slot[r, c]] = True
        self.held[r, s_slot[r, c]] = s_seq[r, c]
        self.clock = np.asarray(out.clock, np.int64).copy()
        r, c = np.nonzero(np.asarray(out.event_valid, bool))
        self.occ[r, np.asarray(out.event_slot, np.int64)[r, c]] = False

    def after_drain(self, out: DrainOut) -> None:
        """Free the slots a drain popped (found by their seqs, as the host
        driver does)."""
        valid = np.asarray(out.event_valid, bool)
        seq = np.asarray(out.event_seq, np.int64)
        for e in range(valid.shape[1]):
            hit = self.occ & (self.held == seq[:, e:e + 1]) \
                & valid[:, e:e + 1]
            self.occ &= ~hit


def _materialize(out, cls):
    return cls(*[np.asarray(x) for x in out])


def drive(stream: SyntheticStream, kernels: Sequence, rounds: int
          ) -> Iterator[Tuple[str, list]]:
    """Runs ``rounds`` rounds of ``stream`` through every kernel of
    ``kernels`` in lockstep; the stream follows the first kernel's outputs.
    Yields ``("reset", pairs)``, ``("step", outs)`` and ``("drain", outs)``,
    ``outs`` holding each kernel's outputs as numpy arrays. Drains follow
    a round while any world has more due, the next dispatched before the
    current is read."""
    for _ in range(rounds):
        pairs = stream.resets()
        if pairs:
            for k in kernels:
                k.reset_slots(pairs)
            yield "reset", pairs
        batch = stream.batch()
        outs = [_materialize(k.step(batch), StepOut) for k in kernels]
        yield "step", outs
        stream.after_step(outs[0])
        more = outs[0].more_due
        inflight = [k.drain() for k in kernels] if more.any() else None
        while inflight is not None:
            cur = inflight
            inflight = [k.drain() for k in kernels]
            outs = [_materialize(d, DrainOut) for d in cur]
            yield "drain", outs
            stream.after_drain(outs[0])
            if not outs[0].more_due.any():
                break
