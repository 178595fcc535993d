"""Shared actor-side helpers: payload padding and the outbox layout.

The PyTorch counterpart of ``madsim_tpu/engine/actor_util.py``, batched
over a leading world axis. Every actor assembles the same (N peer messages
+ 1 timer) :class:`~madsim_tpu_torch.engine.core.Outbox` through
:func:`make_outbox`.
"""
from __future__ import annotations

import torch

from .core import EngineConfig, Outbox
from .lanes import on_device


def pad_payload(cfg: EngineConfig, words) -> torch.Tensor:
    """(W, P) payload rows: the given (W,) words, zero-padded."""
    vals = [w.to(torch.int32) for w in words]
    pad = torch.zeros(vals[0].shape + (cfg.payload_words - len(vals),),
                      dtype=torch.int32, device=vals[0].device)
    return torch.cat([torch.stack(vals, dim=-1), pad], dim=-1)


def bcast_payload(cfg: EngineConfig, n: int, words) -> torch.Tensor:
    """(W, N, P) payload with the same words in every row of a world."""
    row = pad_payload(cfg, words)
    return row[:, None, :].expand(-1, n, -1)


def make_outbox(cfg: EngineConfig, n: int, msg_valid, msg_kind, msg_payload,
                timer_valid, timer_kind, timer_dst, timer_delay,
                timer_payload) -> Outbox:
    """Assemble the (N peers + 1 timer) outbox: (W, N) message fields and
    (W,) timer fields become (W, N + 1)."""
    w = msg_valid.shape[0]
    dev = msg_valid.device

    def app(xs, x):
        return torch.cat([xs, x[:, None]], dim=1)

    def i32(x):
        return on_device(x, dev, torch.int32).expand(w)

    return Outbox(
        valid=app(msg_valid, on_device(timer_valid, dev).expand(w)),
        is_timer=app(torch.zeros((w, n), dtype=torch.bool, device=dev),
                     torch.ones((w,), dtype=torch.bool, device=dev)),
        kind=app(msg_kind.to(torch.int32), i32(timer_kind)),
        dst=app(torch.arange(n, dtype=torch.int32, device=dev).expand(w, n),
                i32(timer_dst)),
        delay_us=app(torch.zeros((w, n), dtype=torch.int32, device=dev),
                     i32(timer_delay)),
        payload=torch.cat([msg_payload, timer_payload[:, None]], dim=1),
    )
