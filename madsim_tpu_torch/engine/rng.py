"""Per-world counter-based RNG for the batched engine.

The PyTorch counterpart of ``madsim_tpu/engine/rng.py``: a cursor over the
Threefry stream in :mod:`madsim_tpu_torch.ops.threefry`, batched over a
leading world axis. Every leaf of :class:`DevRng` is ``torch.uint32``
storage of shape ``(W,)``; draws come back as int64 tensors holding u32
values (torch has no u32 arithmetic, see the threefry module).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..ops.threefry import i64_to_u32, threefry2x32_i64, u32_to_i64
from .lanes import on_device


class DevRng(NamedTuple):
    """A named Threefry stream plus a draw counter, one per world."""

    k0: torch.Tensor       # (W,) uint32
    k1: torch.Tensor       # (W,) uint32
    counter: torch.Tensor  # (W,) uint32


def make_rng(seed_lo: torch.Tensor, seed_hi: torch.Tensor,
             stream: int) -> DevRng:
    """Derive the per-(seed, stream) key; mirrors ``derive_stream_np``."""
    lo = u32_to_i64(seed_lo)
    k0, k1 = threefry2x32_i64(lo, u32_to_i64(seed_hi),
                              torch.full_like(lo, stream & 0xFFFFFFFF),
                              torch.full_like(lo, (stream >> 32) & 0xFFFFFFFF))
    return DevRng(k0=i64_to_u32(k0), k1=i64_to_u32(k1),
                  counter=torch.zeros_like(k0).to(torch.uint32))


def next_u32_vec(rng: DevRng, k: int) -> Tuple[torch.Tensor, DevRng]:
    """``k`` draws per world at counters ``counter + 0 .. counter + k-1``.

    Returns ``(W, k)`` int64 values in [0, 2^32) and the advanced cursor
    (bit-identical to ``k`` sequential :func:`next_u32` calls)."""
    c = u32_to_i64(rng.counter)
    counters = (c[:, None] + torch.arange(k, device=c.device)) & 0xFFFFFFFF
    xs, _ = threefry2x32_i64(u32_to_i64(rng.k0)[:, None],
                             u32_to_i64(rng.k1)[:, None], counters,
                             torch.zeros_like(counters))
    return xs, rng._replace(counter=i64_to_u32(c + k))


def next_u32(rng: DevRng) -> Tuple[torch.Tensor, DevRng]:
    """One draw per world ((W,) int64); advances the counter."""
    xs, rng = next_u32_vec(rng, 1)
    return xs[:, 0], rng


def _u32_to_range(x: torch.Tensor, low, high) -> torch.Tensor:
    """Map u32 draw(s) to [low, high) int32 by the modulo method — the
    unsigned remainder of ``uint32(high - low)``, as the JAX twin."""
    low = on_device(low, x.device, torch.int32)
    high = on_device(high, x.device, torch.int32)
    width = (high.to(torch.int64) - low.to(torch.int64)) & 0xFFFFFFFF
    return low + (x % width).to(torch.int32)


def _u32_to_unit_f32(x: torch.Tensor) -> torch.Tensor:
    """Map u32 draw(s) to [0, 1) float32 from the top 24 bits (exact)."""
    return (x >> 8).to(torch.float32) * (2.0 ** -24)


def uniform_u32(rng: DevRng, low, high) -> Tuple[torch.Tensor, DevRng]:
    """Uniform int32 in [low, high) per world (one draw each)."""
    x, rng = next_u32(rng)
    return _u32_to_range(x, low, high), rng
