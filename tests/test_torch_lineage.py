"""The evolution observatory of the port (madsim_tpu_torch/obs/lineage.py)
against the JAX package's (madsim_tpu/obs/lineage.py) on the CPU, bitwise:
the packed operator lane, ``credit`` and its host twin ``host_credit``,
the ancestry chains and their rendering, the operator tables, their merge
and rendering, and the lineage bundle block. Inputs: fixed lanes made with
numpy from a seed, shaped like a guided sweep's (chains that end at the
template, at a generation-0 world, and at an entry from outside the
report). Tolerance: none.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madsim_tpu.obs import lineage as jl
from madsim_tpu_torch.obs import lineage as tl


def test_constants_match_jax():
    for name in ("OP_NAMES", "N_OPS", "OUTCOME_NAMES", "TEMPLATE_ENTRY",
                 "NO_PARENT", "LINEAGE_SCHEMA", "SEARCH_TELEMETRY_SCHEMA",
                 "OP_SPLICE", "OP_DISABLE", "OP_TIME", "OP_NODE", "OP_FLIP"):
        assert getattr(tl, name) == getattr(jl, name), name
    assert tl.LineageLanes._fields == jl.LineageLanes._fields
    assert tl.OperatorTable._fields == jl.OperatorTable._fields


def test_lanes_origin_and_buffer_match_jax():
    for t, j in ((tl.lanes_origin(5), jl.lanes_origin(5)),
                 (tl.lanes_buffer(3), jl.lanes_buffer(3))):
        for name in j._fields:
            a, b = np.asarray(getattr(j, name)), getattr(t, name).numpy()
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(b, a, err_msg=name)


def test_pack_ops_ops_bits_and_credit_match_jax():
    rng = np.random.default_rng(7)
    bits = rng.random((5, 33)) < 0.4
    t_ops = tl.pack_ops([torch.from_numpy(b) for b in bits])
    j_ops = jl.pack_ops([jnp.asarray(b) for b in bits])
    assert t_ops.dtype == torch.int8
    np.testing.assert_array_equal(t_ops.numpy(), np.asarray(j_ops))
    t_bits = tl.ops_bits(t_ops)
    np.testing.assert_array_equal(t_bits.numpy(),
                                  np.asarray(jl.ops_bits(j_ops)))
    np.testing.assert_array_equal(t_bits.numpy(),
                                  tl.host_ops_bits(t_ops.numpy()))
    mask = rng.random(33) < 0.5
    counter = np.array([3, 0, 2**31 - 2, 5, 1], np.int32)
    t_c = tl.credit(torch.from_numpy(counter), t_bits,
                    torch.from_numpy(mask))
    j_c = jl.credit(jnp.asarray(counter), jl.ops_bits(j_ops),
                    jnp.asarray(mask))
    np.testing.assert_array_equal(t_c.numpy(), np.asarray(j_c))
    np.testing.assert_array_equal(
        tl.host_credit(counter, t_ops.numpy(), mask), t_c.numpy())
    np.testing.assert_array_equal(
        tl.host_credit(counter, t_ops.numpy(), mask),
        jl.host_credit(counter, np.asarray(j_ops), mask))
    z = tl.table_zeros()
    assert all(x.dtype == torch.int32 and x.tolist() == [0] * 5 for x in z)


def lineage_pair(entry_base=0):
    """A per-seed lineage of 12 seeds: generation-0 worlds (-1 parents),
    children of the template (entry 0), chains through earlier seeds,
    and a parent entry from outside the report."""
    p1 = np.array([-1, -1, 0, 0, 3, 4, 5, 0, 999, 7, 10, 11], np.int32)
    p2 = np.array([-1, -1, 0, 3, 0, 4, 2, 0, 0, 8, 6, 3], np.int32)
    ops = np.array([0, 0, 1, 5, 17, 2, 31, 8, 4, 16, 3, 6], np.int32)
    depth = np.array([0, 0, 1, 1, 2, 3, 4, 1, 1, 2, 3, 4], np.int32)
    if entry_base:
        p1 = np.where(p1 > 0, p1 + entry_base, p1)
        p2 = np.where(p2 > 0, p2 + entry_base, p2)
    return (tl.SearchLineage(p1, p2, ops, depth, entry_base),
            jl.SearchLineage(p1, p2, ops, depth, entry_base))


@pytest.mark.parametrize("entry_base", [0, 1000])
def test_ancestry_render_and_bundle_block_match_jax(entry_base):
    t, j = lineage_pair(entry_base)
    seeds = np.arange(12) + 40
    assert t.to_json() == j.to_json() and t.max_depth == j.max_depth
    stats = {name: dict(produced=4, novel=i, survived=1, bug=0,
                        survival_pct=25.0)
             for i, name in enumerate(tl.OP_NAMES)}
    kinds = set()
    for pos in range(12):
        for s in (None, seeds):
            tc, jc = tl.ancestry(t, pos, seeds=s), jl.ancestry(j, pos,
                                                               seeds=s)
            assert tc == jc
            assert tl.render_tree(tc) == jl.render_tree(jc)
            kinds |= {node["kind"] for node in tc}
        assert tl.lineage_block(t, pos, seeds=seeds, stats=stats) == \
            jl.lineage_block(j, pos, seeds=seeds, stats=stats)
        assert t.resolve(pos) == j.resolve(pos)
    assert kinds == {"world", "template", "external"}
    for mask in (0, 1, 6, 31):
        assert tl.op_names(mask) == jl.op_names(mask)


def test_operator_tables_match_jax():
    rng = np.random.default_rng(3)
    parts = []
    for _ in range(3):
        rows = rng.integers(0, 50, (4, 5))
        rows[0, 2] = 0     # an operator never produced: rate 0.0
        t = tl.operator_stats(*rows)
        assert t == jl.operator_stats(*rows)
        parts.append(t)
    assert tl.merge_operator_stats(parts) == jl.merge_operator_stats(parts)
    merged = tl.merge_operator_stats(parts)
    for by in ("survived", "novel", "bug", "produced"):
        assert tl.top_operator(merged, by) == jl.top_operator(merged, by)
    assert tl.top_operator(None) is None and jl.top_operator(None) is None
    zero = tl.operator_stats(*np.zeros((4, 5), np.int64))
    assert tl.top_operator(zero) is None
    assert tl.render_operator_table(merged) == \
        jl.render_operator_table(merged)
