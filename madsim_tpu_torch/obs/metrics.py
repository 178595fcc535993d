"""The per-world metrics block: simulation counters written inside the step.

The PyTorch counterpart of ``madsim_tpu/obs/metrics.py``. With
``EngineConfig(metrics=True)`` every world carries a :class:`MetricsBlock`
in ``WorldState.metrics``, batched over the leading world axis, that the
step writes and never reads for a simulation decision: a metrics-on run
walks the bit-identical trajectory of a metrics-off one. Every increment is
gated on the world's pre-step ``active`` flag, so a frozen world's block
never moves. The counters are int32 in both lane profiles.

``DeviceEngine.observe`` adds one ``m_<field>`` entry per field, so the
sweep attributes the counters per seed like any other observation, and
:func:`metrics_from_observations` / :func:`aggregate_metrics` build the
per-seed and fleet frames of ``SweepResult.metrics``.

Like the JAX module, this one imports nothing of the engine (the engine
imports it).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

#: Width of the fault-injection histogram: one bin per fault op
#: (``FAULT_KILL`` = 0 .. ``FAULT_RESUME`` = 9).
NUM_FAULT_KINDS = 10

#: Observation-dict prefix of the metrics fields.
OBS_PREFIX = "m_"


class MetricsBlock(NamedTuple):
    """Per-world simulation counters, all int32, leading world axis W.

    ``msgs_sent``: message rows a live handler offered to the network;
    ``msgs_delivered`` / ``timer_fires``: events handled by the actor;
    ``drop_loss``: sends dropped by loss or a clogged node or link;
    ``drop_stale`` / ``drop_dead``: popped events discarded for a changed
    generation or a dead destination; ``drop_out_of_time``: events popped
    at or past ``t_limit_us``; ``enqueued``: events inserted into the queue
    (the init-time depth included); ``drop_overflow``: inserts refused by a
    full queue; ``drop_inf``: deadline-saturated events dropped at insert;
    ``vtime_us``: virtual microseconds advanced; ``fault_hist`` (W, 10):
    faults applied by op; ``kind_hist`` (W, num_kinds): delivered events by
    actor kind.
    """

    msgs_sent: torch.Tensor
    msgs_delivered: torch.Tensor
    timer_fires: torch.Tensor
    drop_loss: torch.Tensor
    drop_stale: torch.Tensor
    drop_dead: torch.Tensor
    drop_out_of_time: torch.Tensor
    enqueued: torch.Tensor
    drop_overflow: torch.Tensor
    drop_inf: torch.Tensor
    vtime_us: torch.Tensor
    fault_hist: torch.Tensor   # (W, NUM_FAULT_KINDS)
    kind_hist: torch.Tensor    # (W, num_kinds)

    @staticmethod
    def zeros(n_worlds: int, num_kinds: int, device=None) -> "MetricsBlock":
        """A fresh block for ``n_worlds`` worlds of an actor with
        ``num_kinds`` event kinds."""
        def z(*shape):
            return torch.zeros((n_worlds,) + shape, dtype=torch.int32,
                               device=device)

        return MetricsBlock(
            msgs_sent=z(), msgs_delivered=z(), timer_fires=z(),
            drop_loss=z(), drop_stale=z(), drop_dead=z(),
            drop_out_of_time=z(), enqueued=z(), drop_overflow=z(),
            drop_inf=z(), vtime_us=z(), fault_hist=z(NUM_FAULT_KINDS),
            kind_hist=z(num_kinds))


BLOCK_FIELDS = MetricsBlock._fields


def metrics_from_observations(obs: Dict[str, np.ndarray]
                              ) -> Optional[Dict[str, np.ndarray]]:
    """The per-seed metrics frame of an observation dict (its ``m_``
    entries), or ``None`` when the run was metrics-off."""
    per_seed = {k[len(OBS_PREFIX):]: np.asarray(v)
                for k, v in obs.items() if k.startswith(OBS_PREFIX)}
    return per_seed or None


def aggregate_metrics(per_seed: Dict[str, np.ndarray]) -> Dict[str, object]:
    """Fleet frame: counters summed over the seed axis, histograms as
    per-bin lists (JSON-serialisable)."""
    out: Dict[str, object] = {}
    for k, v in per_seed.items():
        s = np.asarray(v).sum(axis=0)
        out[k] = int(s) if np.ndim(s) == 0 else [int(x) for x in s]
    return out
