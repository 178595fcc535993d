"""Schedule mutation and crossover: the child generator of the guided hunt.

The PyTorch counterpart of ``madsim_tpu/search/mutate.py``, bit for bit.
Operators over ``(F, 4)`` fault-schedule rows ``[time_us, op, a, b]``,
vectorized over a ``(W, F)`` batch; each keeps a valid row valid, so a
child needs no host validation before ``DeviceEngine.refill``:

- **two-parent row splice** (``splice_pct`` per row): the row from the
  second parent;
- **row disable**: the canonical disabled row ``[-1, 0, 0, 0]``;
- **time jitter**: the fire time moves by up to ``±time_jitter_us``,
  clamped to ``[1, t_limit_us - 1]``;
- **node/param perturbation**: node ops rotate their target(s) within
  ``[0, n_nodes)``; ``SET_LOSS`` resamples its ppm in ``[0, 1e6]``;
  ``SET_LATENCY`` a window above its minimum;
- **op flip**: another op of the row's class — {KILL, RESTART, PAUSE,
  RESUME}, {CLOG_NODE, UNCLOG_NODE}, {CLOG_LINK, UNCLOG_LINK}; net-config
  ops never flip.

Each row draws one structural mutation from the cumulative
``SearchConfig`` distribution after the splice draw. Draws are u32 values
carried as int64 (search/rng.py); ``%`` on them is the unsigned modulus,
and the row arithmetic stays int32 so it wraps where the JAX version's
does.
"""
from __future__ import annotations

import torch

from ..engine.core import (
    FAULT_CLOG_LINK,
    FAULT_CLOG_NODE,
    FAULT_KILL,
    FAULT_PAUSE,
    FAULT_RESTART,
    FAULT_RESUME,
    FAULT_SET_LATENCY,
    FAULT_SET_LOSS,
    FAULT_UNCLOG_LINK,
    FAULT_UNCLOG_NODE,
)
from ..engine.lanes import const_table
from .config import SearchConfig
from .corpus import CorpusState, pick_filled
from .rng import lanes_u32, pct, stream_key

# Draws per row and per slot (search/rng.py lane layout).
ROW_DRAWS = 5      # splice, select, time, node, op
SLOT_DRAWS = 4     # parent 1 tournament pair, parent 2 tournament pair

# The liveness class of the op flip, in rotation order.
_LIVENESS = (FAULT_KILL, FAULT_RESTART, FAULT_PAUSE, FAULT_RESUME)


def _i32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int32)


def _flip_op(op: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """The op flip: another member of the row's class (uniform over the
    others), the identity for SET_* rows."""
    lv = const_table(tuple(_LIVENESS), torch.int32, op.device)
    is_lv = ((op == FAULT_KILL) | (op == FAULT_RESTART)
             | (op == FAULT_PAUSE) | (op == FAULT_RESUME))
    lv_pos = (_i32(op == FAULT_RESTART) * 1 + _i32(op == FAULT_PAUSE) * 2
              + _i32(op == FAULT_RESUME) * 3)
    lv_new = lv[((lv_pos + 1 + _i32(r % 3)) % 4).to(torch.int64)]
    node_clog = (op == FAULT_CLOG_NODE) | (op == FAULT_UNCLOG_NODE)
    link_clog = (op == FAULT_CLOG_LINK) | (op == FAULT_UNCLOG_LINK)
    out = torch.where(is_lv, lv_new, op)
    out = torch.where(node_clog, FAULT_CLOG_NODE + FAULT_UNCLOG_NODE - op,
                      out)
    out = torch.where(link_clog, FAULT_CLOG_LINK + FAULT_UNCLOG_LINK - op,
                      out)
    return out.to(torch.int32)


def make_children(scfg: SearchConfig, ecfg, corpus: CorpusState,
                  seed_ids: torch.Tensor, generation, lineage: bool = False):
    """One child schedule per slot, ``(W, F, 4)`` int32, on the corpus's
    device.

    ``seed_ids`` (W,) int32 are the seed ids the refilled slots will run
    (placeholders elsewhere: the refill discards those children). A child
    is a pure function of ``(scfg.seed, seed_id, generation)`` and the
    corpus. ``lineage=True`` also returns each child's
    :class:`~madsim_tpu_torch.obs.lineage.LineageLanes` (the tournament
    parents' entry ids, the applied-operator bitmask, ``1 + max(parent
    depths)``), from the masks computed here; the child's bytes are the
    same either way."""
    f_rows = corpus.sched.shape[1]
    n = int(ecfg.n_nodes)
    jitter = (int(scfg.time_jitter_us) if scfg.time_jitter_us
              else max(int(ecfg.t_limit_us) // 16, 1))
    t_max = int(ecfg.t_limit_us) - 1

    x0 = stream_key(scfg.seed, seed_ids, generation)
    draws = lanes_u32(x0, SLOT_DRAWS + f_rows * ROW_DRAWS)     # (W, D)
    rows_d = draws[:, SLOT_DRAWS:].reshape(draws.shape[0], f_rows,
                                           ROW_DRAWS)
    r_splice, r_sel, r_t, r_n, r_o = (rows_d[..., k] for k in range(5))

    def tournament(da, db):
        """Binary tournament over the filled entries: of two uniform picks
        the higher insertion score, the first on ties."""
        ca, cb = pick_filled(corpus, da), pick_filled(corpus, db)
        ca64, cb64 = ca.to(torch.int64), cb.to(torch.int64)
        return torch.where(corpus.score[cb64] > corpus.score[ca64], cb, ca)

    p1 = tournament(draws[:, 0], draws[:, 1]).to(torch.int64)
    p2 = tournament(draws[:, 2], draws[:, 3]).to(torch.int64)
    base = corpus.sched[p1]      # (W, F, 4)
    other = corpus.sched[p2]

    # Two-parent splice, per row.
    do_splice = pct(r_splice) < scfg.splice_pct
    row = torch.where(do_splice[..., None], other, base)
    t, op, a, b = (row[..., k] for k in range(4))
    enabled = t >= 0

    # One structural mutation per row, from the cumulative ranges.
    m = pct(r_sel)
    c_dis = int(scfg.disable_pct)
    c_time = c_dis + int(scfg.time_pct)
    c_node = c_time + int(scfg.node_pct)
    c_op = c_node + int(scfg.op_pct)
    do_dis = enabled & (m < c_dis)
    do_time = enabled & (m >= c_dis) & (m < c_time)
    do_node = enabled & (m >= c_time) & (m < c_node)
    do_op = enabled & (m >= c_node) & (m < c_op)

    # Time jitter: ±jitter, clamped inside the simulated window.
    delta = _i32(r_t % (2 * jitter + 1)) - jitter
    t = torch.where(do_time, torch.clamp(t + delta, 1, t_max), t)

    # Node/param perturbation.
    is_set_lat = op == FAULT_SET_LATENCY
    is_set_loss = op == FAULT_SET_LOSS
    is_link = (op == FAULT_CLOG_LINK) | (op == FAULT_UNCLOG_LINK)
    is_node_op = ~is_set_lat & ~is_set_loss
    rot_a = (a + 1 + _i32(r_n % max(n - 1, 1))) % n
    rot_b = (b + 1 + _i32((r_n >> 8) % max(n - 1, 1))) % n
    new_loss = _i32(r_n % 1_000_001)
    new_lat_hi = a + 1 + _i32(r_n % 1_000_000)     # int32: may wrap
    a = torch.where(do_node & is_node_op, rot_a,
                    torch.where(do_node & is_set_loss, new_loss, a))
    b = torch.where(do_node & is_link, rot_b,
                    torch.where(do_node & is_set_lat, new_lat_hi, b))

    # Op flip within the argument-compatible class.
    op = torch.where(do_op, _flip_op(op, r_o), op)

    t = torch.where(do_dis, -1, t)
    child = torch.stack([t, op, a, b], dim=-1).to(torch.int32)
    # Canonical disabled rows, whichever operator disabled them.
    disabled = child[..., 0] < 0
    child = torch.where(disabled[..., None],
                        const_table((-1, 0, 0, 0), torch.int32,
                                    child.device), child)
    if not lineage:
        return child
    from ..obs.lineage import LineageLanes, pack_ops

    ops = pack_ops([torch.any(mk, dim=-1) for mk in
                    (do_splice, do_dis, do_time, do_node, do_op)])
    d1, d2 = corpus.depth[p1], corpus.depth[p2]
    return child, LineageLanes(
        p1=corpus.entry[p1], p2=corpus.entry[p2], ops=ops,
        depth=(1 + torch.maximum(d1, d2)).to(torch.int32))
