"""Carrying world state between the JAX package and the port.

The simulator has no weights: its parameters are the configs, and its data
is the world state. A JAX ``WorldState`` pulled to the host as numpy arrays
in ``jax.tree.leaves`` order becomes the port's state with
:func:`state_from_numpy`, and :func:`state_to_numpy` turns it back — so a
state made by either package can be stepped by the other. The bridge
kernel's state, NET keys and metrics cross the same way
(:func:`bridge_state_to_numpy`, :func:`bridge_state_from_numpy`).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from .core import (
    EngineConfig,
    WorldState,
    tree_leaves,
    tree_paths,
    tree_unflatten,
)


def to_numpy(x) -> np.ndarray:
    """A tensor on any device (or an array) as a host numpy array in its
    own dtype; uint32 storage crosses as its int32 bits."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.uint32:
            return x.view(torch.int32).cpu().numpy().view(np.uint32)
        return x.cpu().numpy()
    return np.asarray(x)


def bit_view(x: torch.Tensor) -> torch.Tensor:
    """``x`` in a dtype whose comparisons are bitwise: uint32 (which torch
    cannot compare on every device) and float32 leaves as int32 views."""
    if x.dtype in (torch.uint32, torch.float32):
        return x.view(torch.int32)
    return x


def from_numpy(a: np.ndarray, device) -> torch.Tensor:
    """A host array as a tensor of its dtype on ``device`` (a copy; the
    inverse of :func:`to_numpy`)."""
    a = np.array(a, order="C", copy=True)
    if a.dtype == np.uint32:
        return torch.from_numpy(a.view(np.int32)).to(device).view(
            torch.uint32)
    return torch.from_numpy(a).to(device)


def state_template(actor, cfg: EngineConfig) -> WorldState:
    """A one-world :class:`WorldState` of ``actor`` under ``cfg``, built on
    the CPU — the structure :func:`state_from_numpy` fills (NamedTuple
    actor states and the dict states of compiled actors alike)."""
    from .core import DeviceEngine

    return DeviceEngine(actor, cfg, device="cpu").init(np.zeros(1, np.uint64))


def state_from_numpy(leaves: List[np.ndarray], cfg: EngineConfig, actor,
                     device) -> WorldState:
    """Build the port's state on ``device`` from numpy leaves in
    ``jax.tree.leaves`` order (38 for Raft; a compiled actor's lanes in
    sorted name order). Dtypes are kept, so a packed JAX state stays
    packed; each leaf's dtype and per-world shape are checked against the
    state ``actor`` makes under ``cfg`` (ValueError naming the leaf)."""
    tpl = state_template(actor, cfg)
    n_expected = len(tree_leaves(tpl))
    if len(leaves) != n_expected:
        raise ValueError(f"expected {n_expected} leaves, got {len(leaves)}")
    w = leaves[0].shape[0] if np.ndim(leaves[0]) else 0
    for name, t, a in zip(tree_paths(tpl), tree_leaves(tpl), leaves):
        want = str(t.dtype).replace("torch.", "")
        shape = (w,) + tuple(t.shape[1:])
        if str(a.dtype) != want or tuple(a.shape) != shape:
            raise ValueError(f"leaf {name} is {a.dtype}{list(a.shape)}; "
                             f"this EngineConfig and actor make "
                             f"{want}{list(shape)}")
    return tree_unflatten(tpl, [from_numpy(a, device) for a in leaves])


def state_to_numpy(state: WorldState) -> List[np.ndarray]:
    """The state's leaves as host numpy arrays, in leaf order."""
    return [to_numpy(x) for x in tree_leaves(state)]


#: A bridge kernel's arrays besides its metrics, with JAX's dtypes.
BRIDGE_ARRAYS = {"clock": np.int64, "lane_dl": np.int64,
                 "lane_seq": np.int64, "net_k0": np.uint32,
                 "net_k1": np.uint32}


def bridge_state_to_numpy(kernel) -> Dict[str, np.ndarray]:
    """A bridge kernel's ``BridgeState``, NET keys and ``BridgeMetrics``
    (when on) as host arrays with JAX's dtypes, by field name (copies).
    Takes the port's ``BridgeKernel`` or JAX's."""
    st = kernel.state
    out = {"clock": st.clock, "lane_dl": st.lane_dl, "lane_seq": st.lane_seq,
           "net_k0": kernel._net_k0, "net_k1": kernel._net_k1}
    if kernel._mb is not None:
        out.update(kernel._mb._asdict())
    # Copies: a CPU tensor's numpy view would follow the kernel.
    out = {k: np.array(to_numpy(v), copy=True) for k, v in out.items()}
    for k, dt in BRIDGE_ARRAYS.items():
        out[k] = out[k].astype(dt)
    return out


def bridge_state_from_numpy(kernel, arrays: Dict[str, np.ndarray]) -> None:
    """Loads :func:`bridge_state_to_numpy`'s arrays (from either package)
    into the port's ``BridgeKernel``, in place on its device: its shapes
    must match, and its metrics are loaded when both sides have them on
    (ValueError otherwise)."""
    st = kernel.state
    dst = {"clock": st.clock, "lane_dl": st.lane_dl,
           "lane_seq": st.lane_seq, "net_k0": kernel._net_k0,
           "net_k1": kernel._net_k1}
    if kernel._mb is not None:
        missing = [k for k in kernel._mb._fields if k not in arrays]
        if missing:
            raise ValueError(f"the kernel has metrics on, and the arrays lack "
                             f"{missing}")
        dst.update(kernel._mb._asdict())
    for name, t in dst.items():
        a = np.asarray(arrays[name])
        if tuple(a.shape) != tuple(t.shape):
            raise ValueError(f"{name} is {list(a.shape)}; the kernel holds "
                             f"{list(t.shape)}")
        t.copy_(torch.from_numpy(a.astype(np.int64)))
