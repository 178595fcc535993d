"""JAX-derived references of the bridge kernel, for checking the port where
JAX is not installed.

:data:`GOLDEN_BRIDGE` holds the SHA-256 (:class:`StreamDigest`) of JAX's
``BridgeKernel`` outputs over the synthetic streams
(:mod:`~madsim_tpu_torch.bridge.synthetic`, :data:`SYNTHETIC`) at W = 512
and W = 4096, ``cap=128``, ``k_events=4``, each mode with metrics off and
on: every round's StepOut, every drain's DrainOut, every reset, and at the
end the clock, the lanes ``[:, :cap]`` and the metrics.

:data:`RECORDINGS` names three streams recorded from JAX's own
``bridge.sweep`` over seeds 0..511: the RPC ping-pong world (bench config
1), the chaos world (loss, partitions, restarts) at ``k_events=1`` (whose
events never fall due together, so it drains nothing), and the drain
world (a cluster of sleepers on one deadline) at ``k_events=2``, whose
rounds are mostly drains. Each file holds every operation the sweep made on its
kernel (``reset_slot``/``reset_slots``, ``step`` with its HostBatch,
``drain``) with JAX's outputs, and JAX's state at the end; :func:`replay`
feeds it to a kernel open-loop.

``chip_smoke.py`` checks that the CUDA kernel reproduces both.
``tests/test_torch_bridge.py`` recomputes the digests and re-records the
streams from the JAX package on the CPU, so neither can drift from it.
"""
from __future__ import annotations

import hashlib
from pathlib import Path
from typing import Iterator, Tuple

import numpy as np

from .kernel import DrainOut, HostBatch, StepOut
from .synthetic import SyntheticStream, drive

#: The synthetic cases: kernel shape, the stream's seed, rounds per mode.
SYNTHETIC = dict(cap=128, k_events=4, seed=13,
                 rounds={"realistic": 32, "edge": 40}, widths=(512, 4096))

#: SHA-256 of JAX's outputs over each synthetic case, by
#: ``golden_key(mode, w, metrics)``.
GOLDEN_BRIDGE = {
    "realistic/w512/metrics-off":
        "2560ce6ccc76b55085f22c7c4a4d93a8a5f6fbccf1e4f4cce93945a2b8879673",
    "realistic/w512/metrics-on":
        "b6b4841b173c1755a61cebc7ecd4c2a0386b369ac627558f4fa4a0b9e9077e19",
    "realistic/w4096/metrics-off":
        "2e85c2d8e56b48709dba5a0a999fbd70747a8ea9c2b8c2098a86c4aa8a6b32e9",
    "realistic/w4096/metrics-on":
        "1a7316022a8f26c32cf8ae731bc9486e25c1db0cad1db0553baf8ecf646b7bb0",
    "edge/w512/metrics-off":
        "7b28db43bbf9236868ed95826fb394ce214c7e69783a0edf2030a86d3a522d48",
    "edge/w512/metrics-on":
        "906fd894f542b971962768f307d1389ef8e3cff0716402b4cc9d6002cf290470",
    "edge/w4096/metrics-off":
        "2f57b4a9e9810deb71ef7b627865635a186ea29b7b56d21ce34cc62289fb597a",
    "edge/w4096/metrics-on":
        "744c1d5033c11db253b1bad178623f7bacab649d30f6c2e33a80d314d968cc0d",
}

DATA = Path(__file__).resolve().parent / "data"
#: The recorded JAX sweeps, by name: (file, what was swept).
RECORDINGS = {
    "pingpong": ("pingpong.npz", "tests/test_bridge.py's RPC ping-pong "
                 "world, seeds 0..511, k_events=4"),
    "chaos": ("chaos_k1.npz", "tests/test_bridge.py's chaos world (loss "
              "0.08, partitions, a restart), seeds 0..511, k_events=1"),
    "drains": ("drains_k2.npz", "tests/test_bridge.py's drain world (11 "
               "sleepers, most on one deadline), seeds 0..511, k_events=2"),
}

#: The dtype of each output field, as digested and recorded.
OUT_DTYPES = {
    "clock": np.int64, "deadlock": np.bool_, "send_ok": np.bool_,
    "event_slot": np.int32, "event_seq": np.int64, "event_valid": np.bool_,
    "more_due": np.bool_}
#: The operation codes of a recording.
OPS = ("step", "drain", "reset")


def golden_key(mode: str, w: int, metrics: bool) -> str:
    return f"{mode}/w{w}/metrics-{'on' if metrics else 'off'}"


def to_host(x) -> np.ndarray:
    """A tensor on any device, or an array of either package, in numpy."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class StreamDigest:
    """SHA-256 over a kernel's outputs, in the order they came, and its
    final state."""

    def __init__(self):
        self._h = hashlib.sha256()

    def _put(self, tag: str, x, dtype) -> None:
        a = np.ascontiguousarray(np.asarray(x), dtype=dtype)
        self._h.update(f"{tag}:{a.shape}".encode())
        self._h.update(a.tobytes())

    def add(self, op: str, out) -> None:
        """One op of :func:`~madsim_tpu_torch.bridge.synthetic.drive`:
        ``("reset", pairs)``, ``("step", StepOut)`` or ``("drain",
        DrainOut)``."""
        if op == "reset":
            self._put(op, out, np.int64)
            return
        for name in out._fields:
            self._put(f"{op}.{name}", getattr(out, name), OUT_DTYPES[name])

    def final(self, kernel) -> None:
        """The kernel's clock, lanes ``[:, :cap]`` and metrics (JAX's or
        the port's kernel)."""
        st, cap = kernel.state, kernel.cap
        self._put("clock", to_host(st.clock), np.int64)
        self._put("lane_dl", to_host(st.lane_dl)[:, :cap], np.int64)
        self._put("lane_seq", to_host(st.lane_seq)[:, :cap], np.int64)
        mb = kernel.metrics()
        for name in sorted(mb or {}):
            self._put(f"metrics.{name}", mb[name], np.int64)

    def hexdigest(self) -> str:
        return self._h.hexdigest()


def synthetic_digest(kernel, mode: str) -> str:
    """Drives ``kernel`` (built over seeds ``0..W-1`` with
    :data:`SYNTHETIC`'s cap and k) through the synthetic ``mode`` stream
    and returns its :class:`StreamDigest`."""
    stream = SyntheticStream(np.arange(kernel.W), cap=kernel.cap, mode=mode,
                             seed=SYNTHETIC["seed"])
    d = StreamDigest()
    for op, outs in drive(stream, [kernel], SYNTHETIC["rounds"][mode]):
        d.add(op, outs if op == "reset" else outs[0])
    d.final(kernel)
    return d.hexdigest()


# ---------------------------------------------------------------------------
# Recorded streams.
# ---------------------------------------------------------------------------

def load_recording(name: str) -> dict:
    """The recorded stream ``name`` of :data:`RECORDINGS`, as a dict of
    arrays."""
    with np.load(DATA / RECORDINGS[name][0]) as f:
        return {k: f[k] for k in f.files}


def recording_kernel_args(rec: dict) -> Tuple[np.ndarray, dict]:
    """The seeds and keyword arguments of the recorded kernel."""
    return rec["seeds"], dict(cap=int(rec["cap"]),
                              k_events=int(rec["k_events"]))


def replay(rec: dict, kernel) -> Iterator[Tuple[int, str, object, object]]:
    """Feeds the recorded operations to ``kernel`` (built with
    :func:`recording_kernel_args`) open-loop; yields ``(i, op, got,
    want)`` for each step and drain, ``got`` the kernel's outputs and
    ``want`` JAX's, both as namedtuples of numpy arrays."""
    for i, code in enumerate(rec["ops"].tolist()):
        op = OPS[code]
        if op == "reset":
            kernel.reset_slots([tuple(p) for p in rec[f"{i}.r"].tolist()])
            continue
        if op == "step":
            batch = HostBatch(*[rec[f"{i}.b.{n}"] for n in HostBatch._fields])
            got = StepOut(*[np.asarray(x) for x in kernel.step(batch)])
            cls = StepOut
        else:
            got = DrainOut(*[np.asarray(x) for x in kernel.drain()])
            cls = DrainOut
        want = cls(*[rec[f"{i}.o.{n}"] for n in cls._fields])
        yield i, op, got, want


def outputs_differ(got, want) -> list:
    """The fields where two namedtuples of outputs differ."""
    return [n for n in want._fields
            if not np.array_equal(np.asarray(getattr(got, n)),
                                  np.asarray(getattr(want, n)))]
