"""Lane dtypes and indexing primitives, batched over a leading world axis.

The PyTorch counterpart of ``madsim_tpu/engine/lanes.py``. The JAX module
writes each helper for one world and ``vmap``s it; here every helper takes
tensors whose axis 0 is the world axis ``W`` and whose indices are
``(W,)`` (or ``(W, k)``) tensors, one per world.

The rules are the JAX package's, bit for bit:

- every narrow *write* saturates (:func:`narrow`, through :func:`upd` /
  :func:`upd2`), except lanes whose contract is modular, which wrap
  (:func:`narrow_wrap`, the generation lane);
- every narrow *read* widens to int32 (:func:`widen`);
- :func:`take_small` clamps an out-of-range index to the edge;
- :func:`onehot`, and therefore :func:`upd` / :func:`upd2`, select nothing
  for an out-of-range index: the write is a no-op.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch


class Lanes(NamedTuple):
    """Dtype registry for the engine's state lanes, by category (see the
    JAX ``Lanes`` docstring for what each category holds)."""

    node: Any
    code: Any
    slot: Any
    payload: Any
    time: Any = torch.int32
    counter: Any = torch.int32


#: Reference profile: every lane rides int32.
WIDE = Lanes(node=torch.int32, code=torch.int32, slot=torch.int32,
             payload=torch.int32)

#: Packed profile: node ids and codes int8, slots and payload words int16.
PACKED = Lanes(node=torch.int8, code=torch.int8, slot=torch.int16,
               payload=torch.int16)

_INT_TYPES = (torch.int8, torch.int16, torch.int32, torch.int64,
              torch.uint8)


def on_device(x, device, dtype=None) -> torch.Tensor:
    """``x`` as a tensor on ``device``, with ``torch.as_tensor``'s dtypes.
    On a CUDA device a Python or numpy scalar is written by a fill kernel:
    ``as_tensor`` would copy it from pageable host memory, which waits for
    the device's stream to drain."""
    if device is not None and torch.device(device).type == "cuda" \
            and isinstance(x, (bool, int, float, np.generic)):
        if dtype is None:
            dtype = torch.as_tensor(x).dtype
        if isinstance(x, np.generic):
            x = x.item()
        return torch.full((), x, dtype=dtype, device=device)
    return torch.as_tensor(x, dtype=dtype, device=device)


_TABLES: dict = {}


def const_table(values: tuple, dtype, device) -> torch.Tensor:
    """A small constant table on ``device``, copied there once (per
    values, dtype and device) and shared by later calls, which must not
    write it."""
    key = (values, dtype, str(device))
    t = _TABLES.get(key)
    if t is None:
        t = _TABLES[key] = torch.tensor(values, dtype=dtype, device=device)
    return t


def widen(x: torch.Tensor) -> torch.Tensor:
    """Narrow-lane read: widen to int32."""
    return x.to(torch.int32)


def narrow(x, dtype) -> torch.Tensor:
    """Narrow-lane write: saturate into ``dtype`` (a plain cast when
    ``dtype`` is not strictly narrower than ``x``)."""
    x = torch.as_tensor(x)
    if x.dtype == dtype:
        return x
    if (x.dtype in _INT_TYPES and dtype in _INT_TYPES
            and torch.iinfo(dtype).bits < torch.iinfo(x.dtype).bits):
        info = torch.iinfo(dtype)
        x = x.clamp(info.min, info.max)
    return x.to(dtype)


def narrow_wrap(x: torch.Tensor, dtype) -> torch.Tensor:
    """Narrow-lane write with two's-complement WRAP semantics (the
    mod-256 generation lane). Written out, not left to the cast."""
    bits = torch.iinfo(dtype).bits
    if bits < 32:
        half = 1 << (bits - 1)
        x = ((x.to(torch.int32) + half) & ((1 << bits) - 1)) - half
    return x.to(dtype)


def split_wide(v: torch.Tensor):
    """Split int32 values into two int16-range words ``(lo, hi)``."""
    v = v.to(torch.int32)
    lo = ((v & 0xFFFF) ^ 0x8000) - 0x8000
    hi = v >> 16
    return lo, hi


def join_wide(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`split_wide` (operands already widened int32)."""
    return (lo.to(torch.int32) & 0xFFFF) | (hi.to(torch.int32) << 16)


def onehot(i: torch.Tensor, n: int) -> torch.Tensor:
    """``i.shape + (n,)`` bool mask selecting index ``i``; an out-of-range
    index selects nothing."""
    return torch.arange(n, device=i.device) == i.unsqueeze(-1)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Population count of the low 32 bits (SWAR; torch has no popcount).
    Returns int32."""
    v = x.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) >> 24 & 0xFF).to(torch.int32)


def prefix_count(mask: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix count over the last axis: how many True lanes
    strictly precede each lane. int32."""
    m = mask.to(torch.int32)
    return (torch.cumsum(m, dim=-1) - m).to(torch.int32)


def take_small(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[w, idx[w]]`` per world, clamping out-of-range indices.

    ``x``: (W, m, ...). ``idx``: (W,) → (W, ...), or (W, k) → (W, k, ...).
    """
    m = x.shape[1]
    idx = idx.to(torch.int64).clamp(0, m - 1)
    rows = torch.arange(x.shape[0], device=x.device)
    if idx.dim() == 2:
        rows = rows[:, None]
    return x[rows, idx]


def _shaped(mask: torch.Tensor, ndim: int) -> torch.Tensor:
    """Reshape a (W, n) mask to broadcast over trailing dims of x."""
    return mask.reshape(mask.shape + (1,) * (ndim - 2))


def upd(x: torch.Tensor, i: torch.Tensor, v) -> torch.Tensor:
    """``x[w, i[w]] = v[w]`` per world, as a masked select (no-op for an
    out-of-range index; the value saturates into ``x``'s dtype).

    ``x``: (W, n, ...); ``v`` broadcasts against (W, ...)."""
    m = _shaped(onehot(i, x.shape[1]), x.ndim)
    v = narrow(on_device(v, x.device), x.dtype)
    if v.dim() > 0:
        v = v.unsqueeze(1)
    return torch.where(m, v, x)


def upd2(x: torch.Tensor, i: torch.Tensor, j: torch.Tensor,
         v) -> torch.Tensor:
    """``x[w, i[w], j[w]] = v[w]`` over axes 1 and 2 (saturating, no-op
    when either index is out of range). ``x``: (W, n, m, ...)."""
    m = (onehot(i, x.shape[1])[:, :, None]
         & onehot(j, x.shape[2])[:, None, :])
    m = m.reshape(m.shape + (1,) * (x.ndim - 3))
    v = narrow(on_device(v, x.device), x.dtype)
    if v.dim() > 0:
        v = v.reshape(v.shape[:1] + (1, 1) + v.shape[1:])
    return torch.where(m, v, x)
