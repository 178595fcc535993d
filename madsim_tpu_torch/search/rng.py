"""Splitmix64 lanes: the mutation randomness of the guided hunt.

The PyTorch counterpart of ``madsim_tpu/search/rng.py``, bit for bit. The
schedule generator (search/mutate.py) draws per slot from counter-based
lanes, a pure function of ``(search seed, slot seed id, generation, draw
index)``, so every child is replayable from the sweep's inputs alone.

A u64 is carried as two u32 limbs ``(hi, lo)``. PyTorch has no arithmetic
on ``uint32`` (on the CPU ``+``, ``<<`` and ``%`` raise), so each limb is an
int64 tensor holding a value in ``[0, 2^32)``, and every sum is masked to
32 bits *before* a comparison that detects its carry (the JAX version reads
the carry off a u32 wrap-around; unmasked int64 limbs never wrap, and the
carry would be lost). Products keep the JAX version's 16-bit split, so no
intermediate passes 2^63.

Stream keys come from Threefry (``ops/threefry.py``), so the search stream
never aliases a simulation stream of the same world seed. Slot ``w`` at
generation ``g`` gets the state ``x0 = threefry2x32(search_seed, seed_id(w),
g, STREAM_SEARCH)``, and lane ``i`` is the low limb of ``splitmix64(x0 + i *
GAMMA)``, the host splitmix64 at an offset counter (:func:`splitmix64`).
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..ops.threefry import threefry2x32_torch, u32_to_i64

_M = 0xFFFFFFFF
# The splitmix64 increment and finalizer constants as (hi, lo) limbs.
_GAMMA = (0x9E3779B9, 0x7F4A7C15)
_MUL1 = (0xBF58476D, 0x1CE4E5B9)
_MUL2 = (0x94D049BB, 0x133111EB)

# Threefry stream id of the search generator, far from the engine's.
STREAM_SEARCH = 0x5EA7C4

Limbs = Tuple[torch.Tensor, torch.Tensor]


def _add64(a: Limbs, b: Limbs) -> Limbs:
    """(hi, lo) + (hi, lo) mod 2^64."""
    lo = (a[1] + b[1]) & _M
    carry = (lo < a[1]).to(torch.int64)
    return (a[0] + b[0] + carry) & _M, lo


def _mul_lo32(x: torch.Tensor, y) -> torch.Tensor:
    """x * y mod 2^32 for u32 values, in 16-bit halves of ``y`` (each
    product below 2^48)."""
    y0, y1 = y & 0xFFFF, y >> 16
    return (x * y0 + (((x * y1) & 0xFFFF) << 16)) & _M


def _mul32_64(a: torch.Tensor, b) -> Limbs:
    """Full 32x32 -> 64 product of u32 values as (hi, lo) limbs, in 16-bit
    partial products."""
    a0, a1 = a & 0xFFFF, a >> 16
    b0, b1 = b & 0xFFFF, b >> 16
    lo = a0 * b0
    p10 = a1 * b0
    mid = (p10 + a0 * b1) & _M            # the u32 sum; its wrap is a carry
    mid_carry = (mid < p10).to(torch.int64) << 16
    hi = (a1 * b1 + (mid >> 16) + mid_carry) & _M
    lo2 = (lo + ((mid & 0xFFFF) << 16)) & _M
    hi = (hi + (lo2 < lo).to(torch.int64)) & _M
    return hi, lo2


def _mul64(a: Limbs, b: Tuple[int, int]) -> Limbs:
    """(hi, lo) * (hi, lo) mod 2^64: the full low product plus the cross
    terms into the high limb, each mod 2^32."""
    hi, lo = _mul32_64(a[1], b[1])
    hi = (hi + _mul_lo32(a[1], b[0]) + _mul_lo32(a[0], b[1])) & _M
    return hi, lo


def _shr64_xor(x: Limbs, s: int) -> Limbs:
    """x ^ (x >> s) for 0 < s < 32."""
    hi, lo = x
    sh_lo = (lo >> s) | ((hi << (32 - s)) & _M)
    return hi ^ (hi >> s), lo ^ sh_lo


def splitmix64_dev(x: Limbs) -> Limbs:
    """One splitmix64 step on (hi, lo) limbs, equal to :func:`splitmix64`
    on the joined u64."""
    x = _add64(x, _GAMMA)
    x = _shr64_xor(x, 30)
    x = _mul64(x, _MUL1)
    x = _shr64_xor(x, 27)
    x = _mul64(x, _MUL2)
    return _shr64_xor(x, 31)


def splitmix64(x: int) -> int:
    """The host splitmix64 step on a Python int (the fleet's PRNG,
    ``madsim_tpu/fleet/rpc.py``): what :func:`splitmix64_dev` computes."""
    m = (1 << 64) - 1
    x = (x + 0x9E3779B97F4A7C15) & m
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & m
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & m
    return x ^ (x >> 31)


def stream_key(search_seed: int, seed_ids, generation) -> Limbs:
    """Per-slot stream state ``x0`` (hi, lo) from the search seed, the
    slots' seed ids (int32) and the generation counter, through Threefry."""
    ids = u32_to_i64(torch.as_tensor(seed_ids).to(torch.int32))
    gen = u32_to_i64(torch.as_tensor(generation, device=ids.device)
                     .to(torch.int32)).expand(ids.shape)
    k0 = torch.full_like(ids, search_seed & _M) ^ ids
    k1 = torch.full_like(ids, (search_seed >> 32) & _M)
    o0, o1 = threefry2x32_torch(k0, k1, gen,
                                torch.full_like(ids, STREAM_SEARCH))
    return u32_to_i64(o1), u32_to_i64(o0)  # (hi, lo)


def lanes_u32(x0: Limbs, n_draws: int) -> torch.Tensor:
    """``n_draws`` u32 lanes per stream (int64 values): lane ``i`` is the
    low limb of ``splitmix64(x0 + i * GAMMA)``. The draw axis is appended
    to the streams' shape."""
    i = torch.arange(n_draws, dtype=torch.int64, device=x0[1].device)
    g_hi, g_lo = _mul32_64(i, _GAMMA[1])
    g_hi = (g_hi + i * _GAMMA[0]) & _M
    ctr = _add64((x0[0][..., None] + torch.zeros_like(g_hi),
                  x0[1][..., None] + torch.zeros_like(g_lo)), (g_hi, g_lo))
    return splitmix64_dev(ctr)[1]


def pct(draw: torch.Tensor) -> torch.Tensor:
    """A u32 draw as an int32 percent bucket in [0, 100)."""
    return (draw % 100).to(torch.int32)
