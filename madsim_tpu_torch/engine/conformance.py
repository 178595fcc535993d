"""Actor-protocol conformance checker.

The port's copy of ``madsim_tpu/engine/conformance.py``: the same checks,
messages and report. ``check_actor(actor, cfg)`` validates a DeviceEngine
actor against the actor contract, catching the mistakes that otherwise
surface as cryptic failures or — worse — as silent nondeterminism deep
inside a sweep:

- the engine accepts it (num_kinds declared and within packed width);
- state and outbox shapes are fixed and well-formed, with integer or
  bool dtypes;
- ``handle``/``on_restart`` keep the state's structure, shapes and
  dtypes (the JAX package finds a change as a ``while_loop`` carry
  mismatch while tracing its run; here one call of each on the device
  after the first run is held to the state it was given);
- ``handle`` is pure: same inputs ⇒ bitwise same outputs across two
  calls, and the RNG draw discipline holds on a sampled state: it
  advances the counter forward by a small bounded amount per kind;
- runs are seed-deterministic end-to-end (two identical runs agree
  bitwise) and distinct seeds actually diverge;
- restart resets are exercised (a kill/restart fault schedule runs clean).

Every run goes through :meth:`DeviceEngine.run`, so on a CUDA engine each
step is a launch of the CUDA step kernel with the family's policy; the
probes call the actor's Python methods on the engine's device. Returns a
report dict; raises ``ConformanceError`` on the first violation.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .convert import bit_view, to_numpy
from .core import (DeviceEngine, EngineConfig, FAULT_KILL, FAULT_RESTART,
                   tree_leaves, tree_map)
from .queue import Event, eligible_mask, pop_indexed

__all__ = ["check_actor", "ConformanceError"]


class ConformanceError(AssertionError):
    pass


def _require(ok: bool, msg: str) -> None:
    if not ok:
        raise ConformanceError(msg)


def _dtype_name(dtype: torch.dtype) -> str:
    """A torch dtype as numpy (and JAX) name it: ``float32``, ``int8``."""
    return str(dtype).replace("torch.", "")


def _integral(dtype: torch.dtype) -> bool:
    return not (dtype.is_floating_point or dtype.is_complex)


def _carry_check(eng: DeviceEngine, state) -> None:
    """One ``handle`` and one ``on_restart`` call over ``state``'s worlds,
    at the events their next step would pop: each must return the actor
    state with the structure, shapes and dtypes it was given."""
    cfg, actor = eng.cfg, eng.actor
    _q, ev, _found, _slot = pop_indexed(
        state.queue, eligible_mask(state.queue, state.paused))
    node = ev.src.clamp(0, cfg.n_nodes - 1)
    with torch.no_grad():
        after = (("handle()", actor.handle(cfg, state.astate, ev, state.now,
                                           state.rng)[0]),
                 ("on_restart()", actor.on_restart(cfg, state.astate, node,
                                                   state.now, state.rng)[0]))

    def layout(tree):
        return [(_dtype_name(x.dtype), tuple(x.shape))
                for x in tree_leaves(tree)]

    want = layout(state.astate)
    for who, astate in after:
        got = layout(astate)
        if len(got) != len(want):
            detail = (f"{who} returned {len(got)} state leaves for "
                      f"{len(want)}")
        else:
            bad = [(i, a, b) for i, (a, b) in enumerate(zip(want, got))
                   if a != b]
            if not bad:
                continue
            i, (d0, s0), (d1, s1) = bad[0]
            detail = (f"{who} returned astate leaf {i} as {d1} {s1}, "
                      f"given {d0} {s0}")
        raise ConformanceError(
            "handle()/on_restart() changed the state pytree's structure, "
            f"shapes, or dtypes (jit carry mismatch): {detail}")


def check_actor(actor, cfg: EngineConfig, n_worlds: int = 64,
                max_steps: int = 2_000,
                require_divergence: bool = True,
                device=None) -> Dict[str, Any]:
    """Validate ``actor`` against ``cfg``; see module docstring.

    ``require_divergence=False`` waives the distinct-seeds-diverge
    check for the synthetic fixture families (pair_restart,
    guided_pair) whose fault-free trajectory is deliberately
    schedule-driven and seed-invariant — every real protocol family
    keeps the default. ``device``: the engine's (``None``: CUDA, where
    the runs step through the kernel; ``"cpu"``: the plain step)."""
    _require(hasattr(actor, "handle") and hasattr(actor, "init")
             and hasattr(actor, "invariant") and hasattr(actor, "observe")
             and hasattr(actor, "on_restart"),
             "actor must implement init/handle/on_restart/invariant/observe")
    eng = DeviceEngine(actor, cfg, device=device)  # raises on num_kinds

    seeds = np.arange(n_worlds)
    state = eng.init(seeds)

    # -- fixed shapes, int-family dtypes -------------------------------
    for i, leaf in enumerate(tree_leaves(state.astate)):
        _require(tuple(leaf.shape[:1]) == (n_worlds,),
                 f"astate leaf {i} lacks the leading world axis: "
                 f"{tuple(leaf.shape)}")
        _require(_integral(leaf.dtype),
                 f"astate leaf {i} has non-integer dtype "
                 f"{_dtype_name(leaf.dtype)} "
                 "(device state must be int/bool for bitwise replay)")

    # -- end-to-end determinism + seed sensitivity ---------------------
    final_a = eng.run(eng.init(seeds), max_steps=max_steps)
    _carry_check(eng, state)
    obs_clean = eng.observe(final_a)
    _require(not obs_clean["overflow"].any(),
             f"queue overflow in the clean run (qmax="
             f"{int(obs_clean['qmax'].max())}): raise cfg.queue_cap — all "
             "later checks would run on silently-lossy trajectories")
    # -- RNG discipline: handle() is pure and its counter consumption per
    # kind is small and monotone. One world (world 0's final state), on
    # the engine's device. (The JAX package probes after the second run:
    # a handler impure per call gives both its runs the one trace, so
    # only this probe sees it. Here every step calls handle(), so such a
    # handler would fail the runs' comparison first; probing before it
    # names the method, as JAX does.)
    from .rng import make_rng

    dev = eng.device
    rng0 = make_rng(torch.ones((1,), dtype=torch.uint32, device=dev),
                    torch.zeros((1,), dtype=torch.uint32, device=dev), 99)
    astate0 = tree_map(lambda x: x[:1].clone(), final_a.astate)

    def i32(v):
        return torch.full((1,), v, dtype=torch.int32, device=dev)

    draws_per_kind = []
    for kind in range(actor.num_kinds):
        ev = Event(time=i32(1000), kind=i32(kind), flags=i32(0), src=i32(0),
                   dst=i32(0), gen=i32(0),
                   payload=torch.zeros((1, cfg.payload_words),
                                       dtype=torch.int32, device=dev))
        with torch.no_grad():
            out1 = actor.handle(cfg, astate0, ev, i32(1000), rng0)
            out2 = actor.handle(cfg, astate0, ev, i32(1000), rng0)
        for i, (a, b) in enumerate(zip(tree_leaves(tuple(out1)),
                                       tree_leaves(tuple(out2)))):
            _require(np.array_equal(to_numpy(a), to_numpy(b)),
                     f"handle(kind={kind}) is impure: leaf {i} differs "
                     "between two calls on identical inputs")
        delta = int(to_numpy(out1[2].counter)[0]) \
            - int(to_numpy(rng0.counter)[0])
        _require(0 <= delta <= 64,
                 f"kind {kind} consumed {delta} draws — counter must "
                 "advance forward by a small bounded amount")
        draws_per_kind.append(delta)

    final_b = eng.run(eng.init(seeds), max_steps=max_steps)
    # (Compared and reduced on the device: the same verdicts as JAX's
    # host comparisons, without pulling two whole states.)
    for i, (a, b) in enumerate(zip(tree_leaves(final_a),
                                   tree_leaves(final_b))):
        _require(torch.equal(bit_view(a), bit_view(b)),
                 f"two identical runs diverged at leaf {i}: "
                 "handle/init is impure (Python-level randomness, "
                 "iteration-order dependence, or global state)")
    # Seeds must actually diverge somewhere in the world TRAJECTORY (actor
    # state may legitimately converge to one canonical outcome, but
    # per-world clocks, step counts, queue contents, or counter advances
    # must not all coincide). The RNG keys are excluded: they are
    # seed-derived and always distinct.
    trajectory = ([final_a.now, final_a.steps, final_a.delivered,
                   final_a.qmax, final_a.rng.counter]
                  + tree_leaves(final_a.astate)
                  + tree_leaves(final_a.queue))
    # More than one distinct row (JAX: ``len(np.unique(rows, axis=0)) >
    # 1``) iff some row differs from the first.
    distinct = any(
        bool((bit_view(x) != bit_view(x)[:1]).any()) for x in trajectory)
    _require(distinct or not require_divergence,
             f"all {n_worlds} seeds produced bitwise-identical "
             "trajectories — nothing consumed randomness or virtual time; "
             "is init wiring the RNG through?")

    # -- restart path runs clean under a kill/restart schedule ---------
    faults = np.array([[cfg.t_limit_us // 4, FAULT_KILL, 0, 0],
                       [cfg.t_limit_us // 2, FAULT_RESTART, 0, 0]], np.int32)
    final_f = eng.run(eng.init(seeds, faults=faults), max_steps=max_steps)
    obs = eng.observe(final_f)
    _require(not obs["overflow"].any(),
             f"queue overflow under restart schedule (qmax="
             f"{int(obs['qmax'].max())}): raise cfg.queue_cap")
    _require(not obs["bug"].any(),
             f"invariant violated in {int(obs['bug'].sum())}/{n_worlds} "
             "worlds under a plain kill/restart schedule — on_restart "
             "corrupts durable state (or the clean config has a real bug)")

    # -- observe() respects the batch axis -----------------------------
    for key, val in obs.items():
        _require(np.asarray(val).shape[:1] == (n_worlds,),
                 f"observe()[{key!r}] lost the world axis "
                 f"(shape {np.asarray(val).shape}); reduce node axes with "
                 "axis=-1/-2, not axis=0")

    return {
        "n_worlds": n_worlds,
        "steps_mean": float(to_numpy(final_a.steps).mean()),
        "draws_per_kind": draws_per_kind,
        "bug_rate": float(to_numpy(final_a.bug).mean()),
        "qmax": int(np.asarray(obs["qmax"]).max()),
    }
