"""The port's actor compiler (madsim_tpu_torch.actorc) against the JAX
package's (madsim_tpu.actorc), on the CPU.

- Spec validation: each malformed or over-wide spec of tests/test_actorc.py
  that needs no speclint raises the same pointed SpecError in both
  packages (speclint, the JAX compiler's extra gate, is not ported).
- Lowering: the lane dtypes from declared ranges, the dict state of a
  compiled actor, and the leaf order of its lanes, which must be JAX's
  (a dict flattens in sorted key order) for the state carrier, the
  kernel's pointers by leaf name and the checkpoint format.
- A small spec of its own through both engines, bitwise on every leaf.

Tolerance: none — every operation is integer.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import madsim_tpu.actorc as JA
import madsim_tpu.engine as J
import madsim_tpu_torch.actorc as TA
import madsim_tpu_torch.engine as T
from madsim_tpu.actorc.families.paxos import PaxosActor as JPaxos
from madsim_tpu.actorc.families.paxos import PaxosConfig as JPaxosConfig
from madsim_tpu_torch.actorc.families.paxos import PaxosActor as TPaxos
from madsim_tpu_torch.actorc.families.paxos import PaxosConfig as TPaxosCfg
from madsim_tpu_torch.actorc.spec import lane_dtype
from madsim_tpu_torch.engine.core import tree_leaves, tree_paths
from madsim_tpu_torch.engine.lanes import PACKED, WIDE


def _ping_spec(pkg, n=3, hi=100, word_hi=100, name="ping"):
    """tests/test_actorc.py's minimal spec, built from ``pkg``'s model."""
    def h_ping(c):
        cnt = c.read("count")
        c.write("count", cnt + 1)
        c.send("Ping", dst=(c.me + 1) % n, words=[c.arg("x")],
               when=cnt < 5)

    def init(c):
        c.event("Ping", time=10, dst=0, words=[1])

    return pkg.ActorSpec(
        name=name, n_nodes=n,
        lanes=(pkg.Lane("count", hi=hi),),
        messages=(pkg.Message("Ping", (pkg.Word("x", 0, word_hi),)),),
        handlers={"Ping": h_ping},
        init=init,
        invariant=lambda v: v.np.any(v.lane("count") > 1_000_000),
    )


def _cfg(eng_pkg, **kw):
    return eng_pkg.EngineConfig(**dict(dict(
        n_nodes=3, outbox_cap=4, queue_cap=16, t_limit_us=1_000_000), **kw))


def _packed_guard(pkg, eng_pkg):
    fake = type("Cfg", (), {"n_nodes": 200, "packed": True, "m": 201,
                            "payload_words": 8})()
    pkg.validate_spec(_ping_spec(pkg, n=200, name="wide_ping"), fake)


def _width_mismatch(pkg, eng_pkg):
    pkg.validate_spec(_ping_spec(pkg, n=200), _cfg(eng_pkg))


def _word_overflow(pkg, eng_pkg):
    pkg.validate_spec(_ping_spec(pkg, word_hi=100_000), _cfg(eng_pkg))


def _word_overflow_at_init(pkg, eng_pkg):
    eng = eng_pkg.DeviceEngine(
        pkg.CompiledActor(_ping_spec(pkg, word_hi=100_000)), _cfg(eng_pkg),
        **({"device": "cpu"} if eng_pkg is T else {}))
    eng.init(np.arange(2))


def _outbox_capacity(pkg, eng_pkg):
    pkg.validate_spec(_ping_spec(pkg), _cfg(eng_pkg, outbox_cap=6))


def _replace(**kw):
    def build(pkg, eng_pkg):
        base = _ping_spec(pkg)
        fields = {k: v(pkg) if callable(v) and k == "lanes" else v
                  for k, v in kw.items()}
        pkg.CompiledActor(dataclasses.replace(base, **fields))
    return build


def _run_one_step(handler):
    def build(pkg, eng_pkg):
        spec = dataclasses.replace(_ping_spec(pkg),
                                   handlers={"Ping": handler})
        eng = eng_pkg.DeviceEngine(
            pkg.CompiledActor(spec), _cfg(eng_pkg),
            **({"device": "cpu"} if eng_pkg is T else {}))
        eng.run(eng.init(np.arange(2)), max_steps=1)
    return build


def _greedy(c):
    c.uniform(0, 10)
    c.uniform(0, 10)  # the second draw violates the static rule


BAD_SPECS = {
    "packed_n_nodes": (_packed_guard, "wide_ping.*n_nodes=200.*int8"),
    "n_nodes_mismatch": (_width_mismatch, "n_nodes=200.*n_nodes=3"),
    "word_overflow": (_word_overflow, "'Ping'.*'x'.*100000.*int16"),
    "word_overflow_at_init": (_word_overflow_at_init, "'Ping'.*'x'"),
    "outbox_capacity": (_outbox_capacity, "n_nodes \\+ 1 = 4, got 6"),
    "unknown_handler": (_replace(handlers={"Pong": lambda c: None}),
                        "unknown message 'Pong'"),
    "inverted_range": (_replace(lanes=lambda p: (p.Lane("count", lo=5,
                                                        hi=2),)),
                       "inverted"),
    "duplicate_lane": (_replace(lanes=lambda p: (p.Lane("count", hi=1),
                                                 p.Lane("count", hi=1))),
                       "duplicate lane"),
    "volatile_world_lane": (_replace(lanes=lambda p: (
        p.Lane("g", hi=5, scope="world", durable=False),)),
        "on_restart hook"),
    "count_on_a_value_lane": (_run_one_step(lambda c: c.count("count")),
                              "counter lanes"),
    "second_draw": (_run_one_step(_greedy), "at most\\s+once per event"),
}

#: Cases whose fault the JAX package's speclint gate finds first.
SPECLINT_FIRST = {"count_on_a_value_lane", "second_draw"}


@pytest.mark.parametrize("case", sorted(BAD_SPECS))
def test_validate_spec_errors_match_jax(case):
    """The same SpecError, with the same message, in both packages. Where
    the JAX compiler's speclint gate evaluates the handler first
    (:data:`SPECLINT_FIRST`), JAX reports the fault as a speclint finding
    in words of its own, so both messages are held to the pattern only."""
    build, match = BAD_SPECS[case]
    msgs = []
    for pkg, eng_pkg in ((JA, J), (TA, T)):
        with pytest.raises(pkg.SpecError, match=match) as err:
            build(pkg, eng_pkg)
        msgs.append(str(err.value))
    if case not in SPECLINT_FIRST:
        assert msgs[0] == msgs[1]
    assert issubclass(TA.SpecError, ValueError)


def test_lane_dtype_from_declared_ranges():
    assert lane_dtype(TA.Lane("a", hi=100), PACKED) == torch.int8
    assert lane_dtype(TA.Lane("a", hi=30_000), PACKED) == torch.int16
    assert lane_dtype(TA.Lane("a", hi=100_000), PACKED) == torch.int32
    assert lane_dtype(TA.Lane("a", hi=100, lo=-200), PACKED) == torch.int16
    assert lane_dtype(TA.Lane("a", hi=100, kind="bitmask"),
                      PACKED) == torch.int32
    assert lane_dtype(TA.Lane("a", hi=100), WIDE) == torch.int32


def _families():
    return {
        "tpc": (J.TPCActor(J.TPCDeviceConfig(n=4, n_txns=4)),
                T.TPCActor(T.TPCDeviceConfig(n=4, n_txns=4)),
                dict(n_nodes=4, outbox_cap=5, queue_cap=64)),
        "pb": (J.PBActor(J.PBDeviceConfig(n=3)),
               T.PBActor(T.PBDeviceConfig(n=3)),
               dict(n_nodes=3, outbox_cap=4, queue_cap=48)),
        "paxos": (JPaxos(JPaxosConfig()), TPaxos(TPaxosCfg()),
                  dict(n_nodes=5, outbox_cap=6, queue_cap=128,
                       payload_words=5)),
    }


@pytest.mark.parametrize("family", ["tpc", "pb", "paxos"])
def test_state_layout_leaf_order_is_jax(family):
    """The port's leaf names and dtypes, in order, are those of
    ``jax.tree_util.tree_flatten_with_path`` on the JAX state — the
    compiled actor's dict of lanes in sorted key order."""
    ja, ta, ck = _families()[family]
    je = J.DeviceEngine(ja, J.EngineConfig(**ck, metrics=True, blackbox=4))
    te = T.DeviceEngine(ta, T.EngineConfig(**ck, metrics=True, blackbox=4),
                        device="cpu")
    js = je.init(np.arange(2))
    flat = jax.tree_util.tree_flatten_with_path(js)[0]
    jnames = []
    for path, _ in flat:
        parts = []
        for k in path:
            parts.append(str(getattr(k, "name", getattr(k, "key", k))))
        jnames.append(".".join(parts))
    layout = te.state_layout()
    assert [name for name, _, _ in layout] == jnames
    assert [str(dt).replace("torch.", "") for _, dt, _ in layout] == [
        str(np.asarray(x).dtype) for _, x in flat]
    lanes = [name for name in jnames if name.startswith("astate.")]
    assert lanes == sorted(lanes) and len(lanes) == len(ta.spec.lanes)


def test_compiled_actor_state_is_dict_of_declared_lanes():
    spec = _ping_spec(TA)
    eng = T.DeviceEngine(TA.CompiledActor(spec), _cfg(T), device="cpu")
    state = eng.init(np.arange(4))
    assert set(state.astate) == {"count"}
    assert state.astate["count"].dtype == torch.int8  # hi=100: code lane
    assert tree_paths(state.astate) == ["count"]
    final = eng.run(state, max_steps=200)
    assert (final.astate["count"].sum(dim=-1) >= 6).all()


def _probe_spec(pkg):
    """A spec that uses every write form and both draw contexts: node,
    node-table, vector-entry, full-vector (masked), scalar and counter
    writes, a volatile table lane, a restart hook that draws and arms,
    the event-time bug and a vector invariant."""
    n, K = 3, 4

    def h_tick(c):
        k = c.clip(c.arg("k"), 0, K - 1)
        v = c.read("v")
        c.write("v", v + 1)
        c.write("v", v + 2, when=v > 3)            # the last true write wins
        c.write_at("tab", k, c.read_at("tab", k) + 1)
        c.write_at("tab", k + 1, 200)              # saturates to 127
        c.write_vec_at("vec", k, c.read_vec_at("vec", k) + c.me + 1)
        c.write_vec("vec", c.read_vec("vec") * 2, when=c.arange(K) == k)
        c.write_scalar("top", c.maximum(c.read_scalar("top"), v))
        c.count("ticks", when=v % 2 == 0)
        c.bug((v > 9) & (c.me == 2))
        c.broadcast("Tick", [k + 1], when=v < 8)
        c.arm("Tock", delay=c.uniform(1_000, 5_000), words=[v])

    def h_tock(c):
        c.write_at("mem", c.clip(c.arg("v"), 0, K - 1), c.popcount(c.me + 5))
        c.send("Tick", dst=c.arg("v") % n, words=[c.arg("v")],
               when=c.read("v") < 12)

    def on_restart(c):
        c.write("v", c.read("v") + 10)
        c.arm("Tock", delay=c.uniform(100, 900), words=[c.u32() % 4])

    def init(c):
        for i in range(n):
            c.event("Tick", time=c.uniform(10, 500), dst=i, words=[i])

    return pkg.ActorSpec(
        name="probe", n_nodes=n,
        lanes=(pkg.Lane("v", hi=30_000),
               pkg.Lane("tab", hi=100, scope="node_table", cols=K),
               pkg.Lane("mem", hi=50, scope="node_table", cols=K,
                        durable=False, reset=7),
               pkg.Lane("vec", hi=30_000, scope="world_vec", cols=K),
               pkg.Lane("top", hi=30_000, scope="world"),
               pkg.Lane("ticks", hi=(1 << 31) - 1, scope="world",
                        kind="counter")),
        messages=(pkg.Message("Tick", (pkg.Word("k", 0, 100),)),
                  pkg.Message("Tock", (pkg.Word("v", 0, 30_000),),
                              timer=True)),
        handlers={"Tick": h_tick, "Tock": h_tock},
        init=init,
        on_restart=on_restart,
        invariant=lambda v: v.np.any(v.lane("tab") > 60),
        lint_allow=("*",),
    )


@pytest.mark.parametrize("lanes", ["off", "metrics_ring"])
def test_probe_spec_run_matches_jax(lanes):
    """The probe spec through both engines, with kill/restart faults and
    loss: every leaf and observe() bitwise equal."""
    over = dict(metrics=True, blackbox=8) if lanes != "off" else {}
    ck = dict(n_nodes=3, outbox_cap=4, queue_cap=32, t_limit_us=200_000,
              loss_rate=0.2, stop_on_bug=False, **over)
    faults = np.array([[3_000, J.FAULT_KILL, 1, 0],
                       [9_000, J.FAULT_RESTART, 1, 0],
                       [15_000, J.FAULT_RESTART, 2, 0]], np.int32)
    je = J.DeviceEngine(JA.CompiledActor(_probe_spec(JA)),
                        J.EngineConfig(**ck))
    te = T.DeviceEngine(TA.CompiledActor(_probe_spec(TA)),
                        T.EngineConfig(**ck), device="cpu")
    seeds = np.arange(16)
    js = je.run(je.init(seeds, faults=faults), 400)
    ts = te.run(te.init(seeds, faults=faults), 400)
    jl = [np.asarray(x) for x in jax.tree.leaves(js)]
    tl = T.state_to_numpy(ts)
    assert len(jl) == len(tl)
    bad = [p for p, a, b in zip(tree_paths(ts), jl, tl)
           if a.dtype != b.dtype or not np.array_equal(a, b)]
    assert not bad
    jo, to = je.observe(js), te.observe(ts)
    assert sorted(jo) == sorted(to)
    for k in jo:
        np.testing.assert_array_equal(to[k], jo[k], err_msg=k)
    # The paths it exists for ran: the bug rose somewhere, counters
    # counted, a table write saturated at the int8 lane's rail.
    assert to["bug"].any() and (to["ticks"] > 0).all()
    assert (ts.astate["tab"] == 127).any()
    assert len(tree_leaves(ts.astate)) == 6
