"""Counter-based RNG core: Threefry-2x32, 20 rounds (Random123).

The PyTorch counterpart of ``madsim_tpu/ops/threefry.py``. Every random
decision in the simulator is a pure function of ``(seed, stream,
draw_index)`` through this block cipher, so the port draws the same bits
as the JAX package and the numpy host engine.

PyTorch has a ``uint32`` dtype for storage but no arithmetic on it (``+``,
``<<``, ``%`` and ``min`` raise on the CPU). The torch version therefore
computes in int64 with every intermediate masked to 32 bits; callers keep
*storage* as ``torch.uint32`` and convert with :func:`u32_to_i64` /
:func:`i64_to_u32`.
"""
from __future__ import annotations

import numpy as np
import torch

# Threefry-2x32 rotation constants (Random123).
_ROTATIONS = (13, 15, 26, 6, 17, 29, 16, 24)
_PARITY = 0x1BD11BDA
_M = 0xFFFFFFFF


def _rotl_np(x: np.ndarray, r: int) -> np.ndarray:
    r = np.uint32(r)
    return (x << r) | (x >> np.uint32(32 - int(r)))


def threefry2x32_np(k0, k1, c0, c1):
    """Threefry-2x32 (20 rounds) on numpy uint32 arrays or scalars.

    Returns a pair of uint32 arrays with the same shape as the inputs.
    """
    with np.errstate(over="ignore"):
        k0 = np.asarray(k0, dtype=np.uint32)
        k1 = np.asarray(k1, dtype=np.uint32)
        x0 = np.asarray(c0, dtype=np.uint32) + k0
        x1 = np.asarray(c1, dtype=np.uint32) + k1
        ks2 = k0 ^ k1 ^ np.uint32(_PARITY)
        ks = (k0, k1, ks2)
        for i in range(5):
            for r in range(4):
                x0 = x0 + x1
                x1 = _rotl_np(x1, _ROTATIONS[4 * (i % 2) + r])
                x1 = x1 ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
        return x0, x1


def u32_to_i64(x: torch.Tensor) -> torch.Tensor:
    """Any integer tensor (``uint32`` storage included) → int64 in
    [0, 2^32)."""
    return x.to(torch.int64) & _M


def i64_to_u32(x: torch.Tensor) -> torch.Tensor:
    """int64 → ``uint32`` storage, keeping the low 32 bits."""
    return (x & _M).to(torch.uint32)


def threefry2x32_i64(k0, k1, c0, c1):
    """Threefry-2x32 (20 rounds) on int64 tensors holding u32 values.

    Inputs broadcast against each other; outputs are int64 in [0, 2^32).
    The engine calls this form directly so its counters never leave
    int64 inside a step.
    """
    x0 = (c0 + k0) & _M
    x1 = (c1 + k1) & _M
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    for i in range(5):
        for r in range(4):
            x0 = (x0 + x1) & _M
            rot = _ROTATIONS[4 * (i % 2) + r]
            x1 = ((x1 << rot) & _M) | (x1 >> (32 - rot))
            x1 = x1 ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M
    return x0, x1


def threefry2x32_torch(k0, k1, c0, c1):
    """Threefry-2x32 (20 rounds) on integer tensors (``uint32`` storage or
    any signed type holding u32 values). Returns two ``uint32`` tensors.
    Bit-exact with :func:`threefry2x32_np` and the JAX version."""
    x0, x1 = threefry2x32_i64(u32_to_i64(k0), u32_to_i64(k1),
                              u32_to_i64(c0), u32_to_i64(c1))
    return i64_to_u32(x0), i64_to_u32(x1)


def threefry2x32_scalar(k0: int, k1: int, c0: int, c1: int):
    """Threefry-2x32 (20 rounds) on plain Python ints."""
    x0 = (c0 + k0) & _M
    x1 = (c1 + k1) & _M
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    for i in range(5):
        for r in range(4):
            x0 = (x0 + x1) & _M
            rot = _ROTATIONS[4 * (i % 2) + r]
            x1 = ((x1 << rot) & _M) | (x1 >> (32 - rot))
            x1 ^= x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M
    return x0, x1


# ---------------------------------------------------------------------------
# Stream derivation (see madsim_tpu/ops/threefry.py for the scheme): draw i
# of stream s under seed k is threefry(derive(k, s), (lo(i), hi(i))).
# ---------------------------------------------------------------------------

def seed_to_key(seed: int):
    """Split a u64 seed into a (k0, k1) uint32 pair."""
    seed &= (1 << 64) - 1
    return np.uint32(seed & 0xFFFFFFFF), np.uint32(seed >> 32)


def derive_stream_np(k0, k1, stream: int):
    """Derive an independent (k0, k1) key for a named stream id (u64)."""
    stream &= (1 << 64) - 1
    return threefry2x32_np(k0, k1, np.uint32(stream & 0xFFFFFFFF),
                           np.uint32(stream >> 32))


def derive_stream_torch(k0, k1, stream: int):
    """Torch version of :func:`derive_stream_np` (``k0``/``k1`` tensors,
    ``stream`` a u64 int). Returns two ``uint32`` tensors."""
    stream &= (1 << 64) - 1
    lo = torch.full_like(u32_to_i64(k0), stream & _M)
    return threefry2x32_torch(k0, k1, lo, torch.full_like(lo, stream >> 32))
