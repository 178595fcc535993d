"""The evolution observatory: search lineage and operator outcome
accounting.

The PyTorch counterpart of ``madsim_tpu/obs/lineage.py``, bit for bit.
Write-only lanes carried beside the guided sweep's per-slot schedules:
every installed child carries its two splice parents' corpus **entry ids**,
a bitmask of the mutation operators applied to it, and its ancestry depth;
the operator table counts, per operator, the children that carried it
(``produced``), the retiring carriers that cleared the novelty bar
(``novel``), that entered the corpus (``survived``) and that found a bug
(``bug``, folded on the host from the per-seed lanes). Entry ids are
``lin_base + seed position + 1`` (0 is the template, -1 no parent), so
parents resolve by arithmetic. Nothing here feeds back into a child's bytes
or a corpus decision: lineage on and off give the same trajectories,
schedules and corpus.

The ops lane is int8 (5 bits used), written through ``engine/lanes.narrow``
and read through ``widen``; entry ids and depths are int32.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from ..engine.lanes import narrow, widen

# Operator classes, in bit order.
OP_NAMES = ("splice", "disable", "time_jitter", "node_rotate", "op_flip")
N_OPS = len(OP_NAMES)
OP_SPLICE, OP_DISABLE, OP_TIME, OP_NODE, OP_FLIP = range(N_OPS)

# Outcome rows of the operator table, in array order.
OUTCOME_NAMES = ("produced", "novel", "survived", "bug")

# The template's corpus entry, and the parent of a generation-0 world.
TEMPLATE_ENTRY = 0
NO_PARENT = -1

LINEAGE_SCHEMA = "madsim.search.lineage/1"
SEARCH_TELEMETRY_SCHEMA = "madsim.search.telemetry/1"


# ---------------------------------------------------------------------------
# Device lanes
# ---------------------------------------------------------------------------

class LineageLanes(NamedTuple):
    """Per-slot provenance lanes, permuted, split and refilled with the
    guided sweep's per-slot schedules."""

    p1: torch.Tensor     # (W,) int32 parent-1 corpus entry id (-1 = none)
    p2: torch.Tensor     # (W,) int32 parent-2 (splice) corpus entry id
    ops: torch.Tensor    # (W,) int8 packed operator bitmask (widen on read)
    depth: torch.Tensor  # (W,) int32 ancestry depth (template = 0)


def lanes_origin(w: int, device=None) -> LineageLanes:
    """Generation-0 lanes: no parents, no operators, depth 0."""
    return LineageLanes(
        p1=torch.full((w,), NO_PARENT, dtype=torch.int32, device=device),
        p2=torch.full((w,), NO_PARENT, dtype=torch.int32, device=device),
        ops=torch.zeros((w,), dtype=torch.int8, device=device),
        depth=torch.zeros((w,), dtype=torch.int32, device=device))


def lanes_buffer(n_ids: int, device=None) -> LineageLanes:
    """A per-seed lane buffer: one row per seed id and a trailing dump row,
    each at :func:`lanes_origin`'s values."""
    return lanes_origin(n_ids + 1, device)


def pack_ops(bits) -> torch.Tensor:
    """Per-operator bool masks ``bits[i]`` (each (W,)) folded into the
    packed int8 lane through the saturating ``narrow``."""
    m = torch.zeros(bits[0].shape, dtype=torch.int32, device=bits[0].device)
    for i, b in enumerate(bits):
        m = m | (b.to(torch.int32) << i)
    return narrow(m, torch.int8)


def ops_bits(ops: torch.Tensor) -> torch.Tensor:
    """The int8 ops lane as a (..., N_OPS) bool matrix."""
    wide = widen(ops)
    return (wide[..., None] >> torch.arange(
        N_OPS, dtype=torch.int32, device=ops.device)) & 1 > 0


class OperatorTable(NamedTuple):
    """Per-operator outcome counters (int32). The ``bug`` outcome is folded
    on the host from the per-seed lanes (:func:`host_credit`), since a find
    that stops the sweep never crosses a harvest."""

    produced: Any   # (N_OPS,) children installed carrying the op
    novel: Any      # (N_OPS,) retiring carriers >= min_novelty
    survived: Any   # (N_OPS,) retiring carriers inserted


def table_zeros(device=None) -> OperatorTable:
    z = torch.zeros((N_OPS,), dtype=torch.int32, device=device)
    return OperatorTable(produced=z, novel=z, survived=z)


def credit(counter: torch.Tensor, obits: torch.Tensor,
           mask: torch.Tensor) -> torch.Tensor:
    """``counter[o] += sum_w mask[w] & obits[w, o]`` in int32."""
    add = torch.sum(obits & mask[..., None], dim=0, dtype=torch.int32)
    return counter + add


# ---------------------------------------------------------------------------
# Host twin of the outcome crediting
# ---------------------------------------------------------------------------

def host_ops_bits(ops: np.ndarray) -> np.ndarray:
    """Numpy twin of :func:`ops_bits` over an i8/i32 mask vector."""
    wide = np.asarray(ops, np.int32)
    return (wide[..., None] >> np.arange(N_OPS, dtype=np.int32)) & 1 > 0


def host_credit(counter: np.ndarray, ops: np.ndarray,
                mask: np.ndarray) -> np.ndarray:
    """Numpy twin of :func:`credit`."""
    obits = host_ops_bits(ops)
    add = np.sum(obits & np.asarray(mask, bool)[..., None], axis=0,
                 dtype=np.int32)
    return np.asarray(counter, np.int32) + add


# ---------------------------------------------------------------------------
# Host-side lineage reconstruction
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SearchLineage:
    """Per-seed provenance of one guided sweep
    (``SweepResult.search.lineage``).

    Arrays are indexed by seed POSITION (row ``i`` of the sweep's seed
    vector). ``entry_base`` is the sweep's entry-id base: the world at
    position ``i`` — if its schedule survived into the corpus — holds
    entry id ``entry_base + i + 1``, so ``resolve(e) = e - 1 -
    entry_base`` maps a parent entry id back to a seed position. A
    fleet-merged lineage concatenates ranges into global positions with
    ``entry_base = 0`` (each range wrote ids at base ``range.lo``), so
    cross-range ancestry resolves with the same arithmetic.
    """

    parent1: np.ndarray   # (n,) i32 corpus entry id (-1 = generation 0)
    parent2: np.ndarray   # (n,) i32 splice-parent entry id
    ops: np.ndarray       # (n,) i32 applied-operator bitmask
    depth: np.ndarray     # (n,) i32 ancestry depth (template = 0)
    entry_base: int = 0

    def resolve(self, entry: int) -> Optional[int]:
        """Seed position holding ``entry``, or None for the template /
        an entry outside this report (an exchange-seeded parent from
        another range, visible only in the fleet-merged report)."""
        if entry <= TEMPLATE_ENTRY:
            return None
        pos = int(entry) - 1 - self.entry_base
        return pos if 0 <= pos < self.parent1.shape[0] else None

    @property
    def max_depth(self) -> int:
        return int(self.depth.max()) if self.depth.size else 0

    def to_json(self) -> Dict[str, Any]:
        return {"n_seeds": int(self.parent1.shape[0]),
                "entry_base": int(self.entry_base),
                "max_depth": self.max_depth}


def op_names(mask: int) -> List[str]:
    """Operator names set in a packed bitmask, in bit order."""
    return [name for i, name in enumerate(OP_NAMES) if (int(mask) >> i) & 1]


def ancestry(lin: SearchLineage, pos: int,
             seeds: Optional[np.ndarray] = None,
             max_depth: int = 10_000) -> List[Dict[str, Any]]:
    """The ancestry chain of the world at seed position ``pos``: a list
    of nodes from the find itself back to the generation-0 template,
    following the primary (``parent1``) line and recording the splice
    parent of every hop.

    Each node: ``{"pos", "seed", "entry", "depth", "ops", "parent1",
    "parent2", "kind"}`` with ``kind`` one of ``"world"`` /
    ``"template"`` / ``"external"`` (an exchange-seeded parent whose
    origin range is outside this report). Chains are finite by
    construction — parents always retired strictly earlier — but
    ``max_depth`` bounds a corrupted report.
    """
    chain: List[Dict[str, Any]] = []
    cur: Optional[int] = int(pos)
    hops = 0
    while cur is not None and hops < max_depth:
        hops += 1
        e1, e2 = int(lin.parent1[cur]), int(lin.parent2[cur])
        chain.append({
            "pos": cur,
            "seed": int(np.asarray(seeds)[cur]) if seeds is not None
            else cur,
            "entry": int(lin.entry_base) + cur + 1,
            "depth": int(lin.depth[cur]),
            "ops": op_names(int(lin.ops[cur])),
            "parent1": e1,
            "parent2": e2,
            "kind": "world",
        })
        if e1 == NO_PARENT:
            # Generation 0: this world ran the template itself.
            chain.append({"entry": NO_PARENT, "kind": "template",
                          "depth": 0, "ops": [], "parent1": NO_PARENT,
                          "parent2": NO_PARENT})
            return chain
        if e1 == TEMPLATE_ENTRY:
            chain.append({"entry": TEMPLATE_ENTRY, "kind": "template",
                          "depth": 0, "ops": [], "parent1": NO_PARENT,
                          "parent2": NO_PARENT})
            return chain
        nxt = lin.resolve(e1)
        if nxt is None:
            chain.append({"entry": e1, "kind": "external", "depth": -1,
                          "ops": [], "parent1": NO_PARENT,
                          "parent2": NO_PARENT})
            return chain
        cur = nxt
    return chain


def render_tree(chain: List[Dict[str, Any]]) -> str:
    """Terminal rendering of an ancestry chain (find first, template
    last) — the ``obs lineage`` CLI body."""
    lines: List[str] = []
    for i, node in enumerate(chain):
        pad = "" if i == 0 else "  " * (i - 1) + "└─ "
        if node["kind"] == "template":
            lines.append(f"{pad}template (entry {TEMPLATE_ENTRY}, "
                         "generation 0)")
            continue
        if node["kind"] == "external":
            lines.append(f"{pad}external entry {node['entry']} "
                         "(exchange-seeded; resolve in the fleet-merged "
                         "report)")
            continue
        if node["parent1"] == NO_PARENT:
            # Generation-0 world: it RAN the template (no mutation).
            lines.append(f"{pad}seed {node['seed']} (entry "
                         f"{node['entry']}, depth 0) ran the template")
            continue
        ops = "+".join(node["ops"]) if node["ops"] else "no-op-copy"
        splice = (f"  [x entry {node['parent2']}]"
                  if "splice" in node["ops"] else "")
        lines.append(f"{pad}seed {node['seed']} (entry {node['entry']}, "
                     f"depth {node['depth']}) via {ops}{splice}")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Operator stats (host dicts of the device OperatorTable)
# ---------------------------------------------------------------------------

def operator_stats(produced, novel, survived, bug) -> Dict[str, Dict[str, int]]:
    """Host dict of the pulled outcome table: one row per operator,
    ``{produced, novel, survived, bug, survival_pct}``."""
    out: Dict[str, Dict[str, int]] = {}
    produced = np.asarray(produced, np.int64)
    novel = np.asarray(novel, np.int64)
    survived = np.asarray(survived, np.int64)
    bug = np.asarray(bug, np.int64)
    for i, name in enumerate(OP_NAMES):
        p = int(produced[i])
        out[name] = {
            "produced": p,
            "novel": int(novel[i]),
            "survived": int(survived[i]),
            "bug": int(bug[i]),
            # Corpus-survival rate per installed carrier — the credit
            # signal a future operator scheduler would feed on.
            "survival_pct": round(100.0 * int(survived[i]) / p, 2)
            if p else 0.0,
        }
    return out


def merge_operator_stats(parts: List[Dict[str, Dict[str, int]]]
                         ) -> Dict[str, Dict[str, int]]:
    """Sum per-range operator tables into the fleet table (counts add;
    the rate recomputes)."""
    acc = {name: {k: 0 for k in OUTCOME_NAMES} for name in OP_NAMES}
    for part in parts:
        for name in OP_NAMES:
            row = part.get(name, {})
            for k in OUTCOME_NAMES:
                acc[name][k] += int(row.get(k, 0))
    for name in OP_NAMES:
        p = acc[name]["produced"]
        acc[name]["survival_pct"] = (round(
            100.0 * acc[name]["survived"] / p, 2) if p else 0.0)
    return acc


def top_operator(stats: Optional[Dict[str, Dict[str, int]]],
                 by: str = "survived") -> Optional[str]:
    """The operator with the highest ``by`` count (ties to bit order);
    None when the table is empty/absent or all-zero."""
    if not stats:
        return None
    best, best_v = None, 0
    for name in OP_NAMES:
        v = int(stats.get(name, {}).get(by, 0))
        if v > best_v:
            best, best_v = name, v
    return best


def render_operator_table(stats: Dict[str, Dict[str, int]]) -> str:
    """Fixed-width terminal table of the per-operator outcome counts."""
    head = (f"{'operator':<12} {'produced':>9} {'novel':>7} "
            f"{'survived':>9} {'bug':>5} {'surv%':>7}")
    lines = [head, "-" * len(head)]
    for name in OP_NAMES:
        row = stats.get(name, {})
        lines.append(
            f"{name:<12} {row.get('produced', 0):>9} "
            f"{row.get('novel', 0):>7} {row.get('survived', 0):>9} "
            f"{row.get('bug', 0):>5} {row.get('survival_pct', 0.0):>7}")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# The madsim.search.lineage/1 bundle block
# ---------------------------------------------------------------------------

def lineage_block(lin: SearchLineage, pos: int,
                  seeds: Optional[np.ndarray] = None,
                  stats: Optional[Dict[str, Dict[str, int]]] = None
                  ) -> Dict[str, Any]:
    """The provenance block a triage bundle carries for a guided find:
    the find's full ancestry chain plus the sweep's operator outcome
    table — a minimized repro that documents its own derivation
    (schema ``madsim.search.lineage/1``)."""
    chain = ancestry(lin, pos, seeds=seeds)
    applied = sorted({op for node in chain for op in node.get("ops", [])})
    return {
        "schema": LINEAGE_SCHEMA,
        "seed": chain[0].get("seed") if chain else None,
        "depth": chain[0].get("depth", 0) if chain else 0,
        "operators_applied": applied,
        "chain": chain,
        "operator_stats": stats,
    }
