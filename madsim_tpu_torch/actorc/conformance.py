"""Host-twin conformance: lockstep crosscheck of a compiled actor
against its generated plain-Python reference interpreter.

The port's copy of ``madsim_tpu/actorc/conformance.py``. One device pass
on the engine's device records, per step of a real trajectory, the
popped event, the engine's deliver/fault gates, the raw entropy the
handler would draw, the handler's and the restart hook's outboxes, and
the post-step actor state (the plain step, :meth:`DeviceEngine.step_plain`);
the host twin (:mod:`madsim_tpu_torch.actorc.host`) then replays the SAME
event stream through the shared transition callables and every per-event
state lane, outbox row and bug decision is compared bitwise. A mismatch
is a compiler bug or a spec stepping outside the restricted expression
surface — either way it surfaces here, with the seed, step, event and
lane named, instead of as silent divergence deep inside a million-seed
sweep.

On a CUDA engine whose actor the CUDA step kernel has a policy for (the
tpc, pb and Paxos families: ``engine=DeviceEngine(TPCActor(tcfg), cfg)``
and the like; a bare ``CompiledActor`` of a spec has none) the pass also
steps a twin state with the kernel, one launch per step, and holds every
leaf of it to the plain step's after every recorded step: host twin =
plain step = kernel, on every event.

The JAX package records with one jitted scan vmapped over the seeds;
here the pass is a loop of batched steps over all sampled seeds at once,
its records kept on the device and pulled once. The comparison loop is
host-side Python over the pulled arrays, the JAX module's.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..engine.convert import bit_view
from ..engine.core import (DeviceEngine, EngineConfig, FAULT_RESTART, Outbox,
                           tree_leaves, tree_paths)
from ..engine.lanes import take_small, widen
from ..engine.queue import (FLAG_FAULT, FLAG_TIMER, GEN_MASK, eligible_mask,
                            pop_indexed)
from ..ops.threefry import threefry2x32_i64, u32_to_i64
from .compile import CompiledActor
from .host import HostActor
from .spec import ActorSpec

__all__ = ["crosscheck", "HostTwinMismatch", "ENTROPY_WORDS"]

# Raw u32 words recorded per step: the handler draws at most one (the
# compiler's static-draw rule), restart hooks may draw a few more —
# sequential next_u32 values ARE the Threefry stream at consecutive
# counters, so recording a block covers both.
ENTROPY_WORDS = 4

_OB_FIELDS = ("valid", "is_timer", "kind", "dst", "delay_us", "payload")


class HostTwinMismatch(AssertionError):
    """Device actor and generated host twin disagreed on an event."""


def _kernel_has_policy(actor) -> bool:
    from ..engine.step_kernel import family_of

    try:
        family_of(actor)
    except NotImplementedError:
        return False
    return True


def _record(eng: DeviceEngine, states, max_steps: int,
            twin=None) -> Dict[str, Any]:
    """Step ``states`` ``max_steps`` times on its device, recording per
    step the event, gates, entropy, handler/restart outboxes and
    post-step state; with ``twin`` (a copy of ``states`` on CUDA) also
    step it with the kernel and record, per leaf and world, whether it
    differs from the plain step. Returns host arrays with the world axis
    first and the step axis second."""
    cfg, actor = eng.cfg, eng.actor
    n = cfg.n_nodes
    s = states
    w = s.now.shape[0]
    dev = s.now.device
    cols: Dict[str, List[Any]] = {}

    def put(**kw):
        for k, v in kw.items():
            cols.setdefault(k, []).append(v)

    for _ in range(max_steps):
        # The same peek and gate derivation as DeviceEngine.trace: the
        # step's own pop happens inside step_plain below.
        _q, ev, found, _slot = pop_indexed(
            s.queue, eligible_mask(s.queue, s.paused) & s.active[:, None])
        now = torch.where(found, torch.maximum(s.now, ev.time), s.now)
        in_time = now < cfg.t_limit_us
        dst = ev.dst.clamp(0, n - 1)
        is_fault = (ev.flags & FLAG_FAULT) != 0
        is_timer = (ev.flags & FLAG_TIMER) != 0
        stale = is_timer & (ev.gen != (widen(take_small(s.gen, dst))
                                       & GEN_MASK))
        dead = ~take_small(s.alive, dst)
        deliver = found & in_time & ~is_fault & ~stale & ~dead
        do_fault = found & in_time & is_fault
        restart = do_fault & (ev.kind == FAULT_RESTART)
        rnode = ev.src.clamp(0, n - 1)

        # The entropy block the handler/restart hook would consume:
        # consecutive counters from the current cursor.
        ctr = u32_to_i64(s.rng.counter)[:, None]
        ctrs = (ctr + torch.arange(ENTROPY_WORDS, device=dev)) & 0xFFFFFFFF
        entropy, _ = threefry2x32_i64(u32_to_i64(s.rng.k0)[:, None],
                                      u32_to_i64(s.rng.k1)[:, None], ctrs,
                                      torch.zeros_like(ctrs))

        # What the step WILL do, from the same calls it makes (each only
        # where some world takes it: the comparison reads the handler's
        # outbox where the step delivers, the hook's where it restarts).
        empty = Outbox.empty(cfg, w, dev)
        ob_h, hbug = empty, torch.zeros_like(deliver)
        if bool(deliver.any()):
            _sh, ob_h, _rh, hbug = actor.handle(cfg, s.astate, ev, now,
                                                s.rng)
        ob_r = empty
        if bool(restart.any()):
            _sr, ob_r, _rr = actor.on_restart(cfg, s.astate, rnode, now,
                                              s.rng)

        s = eng.step_plain(s)
        put(found=found, deliver=deliver, restart=restart, rnode=rnode,
            now=now, kind=ev.kind, dst=ev.dst, src=ev.src,
            payload=ev.payload, entropy=entropy, hbug=hbug, bug=s.bug,
            **{"ob_h." + f: getattr(ob_h, f) for f in _OB_FIELDS},
            **{"ob_r." + f: getattr(ob_r, f) for f in _OB_FIELDS},
            **{"astate." + k: v for k, v in s.astate.items()})
        if twin is not None:
            eng.run_steps(twin, 1)
            put(kernel_diff=torch.stack([
                (bit_view(a) != bit_view(b)).reshape(w, -1).any(dim=1)
                for a, b in zip(tree_leaves(twin), tree_leaves(s))]))
    out = {}
    for k, v in cols.items():
        if k == "kernel_diff":  # (T, L, W) -> (W, T, L)
            out[k] = torch.stack(v).permute(2, 0, 1).cpu().numpy()
        else:
            out[k] = torch.stack(v, dim=1).cpu().numpy()
    return out


def _neq(a, b) -> bool:
    return not np.array_equal(np.asarray(a), np.asarray(b))


def _cmp_state(where: str, dev: Dict[str, Any], host: Dict[str, Any]):
    for name in host:
        if _neq(dev[name], host[name]):
            raise HostTwinMismatch(
                f"{where}: lane {name!r} diverged\n  device: "
                f"{np.asarray(dev[name])!r}\n  host:   "
                f"{np.asarray(host[name])!r}")


def _cmp_outbox(where: str, dev: Dict[str, Any], host):
    for field in _OB_FIELDS:
        d, h = dev[field], getattr(host, field)
        if _neq(d, h):
            raise HostTwinMismatch(
                f"{where}: outbox field {field!r} diverged\n  device: "
                f"{np.asarray(d)!r}\n  host:   {np.asarray(h)!r}")


def crosscheck(spec: ActorSpec, cfg: EngineConfig,
               seeds: Sequence[int], faults: Optional[np.ndarray] = None,
               max_steps: int = 400,
               engine: Optional[DeviceEngine] = None,
               device=None) -> Dict[str, Any]:
    """Crosscheck compiled-vs-host on real trajectories; see module
    docstring. Raises :class:`HostTwinMismatch` on the first
    divergence; returns an accounting report otherwise (JAX's, key for
    key). ``engine`` defaults to a new ``DeviceEngine`` of the spec on
    ``device`` (``None``: CUDA; ``"cpu"``: the plain step only); pass
    one whose actor the step kernel has a policy for to hold the kernel
    too (module docstring)."""
    eng = engine or DeviceEngine(CompiledActor(spec), cfg, device=device)
    host = HostActor(spec, packed=cfg.packed,
                     payload_words=cfg.payload_words)
    seeds = np.asarray(seeds, np.uint64)
    states = eng.init(seeds, faults=faults)
    init_astate = {k: v.cpu().numpy() for k, v in states.astate.items()}
    twin = None
    if eng.device.type == "cuda" and _kernel_has_policy(eng.actor):
        twin = eng.init(seeds, faults=faults)
    with torch.no_grad():
        recs = _record(eng, states, max_steps, twin)
    leaf_names = tree_paths(states)

    lanes = [ln.name for ln in spec.lanes]
    delivered = restarts = checked = 0
    for w, seed in enumerate(seeds):
        hstate = host.init_state()
        tag0 = f"spec {spec.name!r} seed {int(seed)}"
        _cmp_state(f"{tag0} initial state",
                   {k: init_astate[k][w] for k in lanes}, hstate)
        hlatch = False
        for i in range(max_steps):
            tag = f"{tag0} step {i}"
            ent = [int(x) for x in recs["entropy"][w, i]]
            if recs["deliver"][w, i]:
                hstate, hob, hbug = host.handle(
                    hstate, kind=int(recs["kind"][w, i]),
                    dst=int(recs["dst"][w, i]),
                    src=int(recs["src"][w, i]),
                    payload=[int(x) for x in recs["payload"][w, i]],
                    now=int(recs["now"][w, i]), entropy=ent)
                _cmp_outbox(
                    f"{tag} (deliver kind "
                    f"{eng.actor.kind_names[int(recs['kind'][w, i]) % len(eng.actor.kind_names)]})",
                    {f: recs["ob_h." + f][w, i] for f in _OB_FIELDS}, hob)
                if bool(recs["hbug"][w, i]) != hbug:
                    raise HostTwinMismatch(
                        f"{tag}: handler bug flag diverged (device "
                        f"{bool(recs['hbug'][w, i])}, host {hbug})")
                hlatch = hlatch or hbug
                delivered += 1
            elif recs["restart"][w, i]:
                hstate, hob = host.on_restart(
                    hstate, node=int(recs["rnode"][w, i]),
                    now=int(recs["now"][w, i]), entropy=ent)
                _cmp_outbox(f"{tag} (restart node "
                            f"{int(recs['rnode'][w, i])})",
                            {f: recs["ob_r." + f][w, i]
                             for f in _OB_FIELDS}, hob)
                restarts += 1
            _cmp_state(tag, {k: recs["astate." + k][w, i] for k in lanes},
                       hstate)
            hlatch = hlatch or host.invariant(hstate)
            if bool(recs["bug"][w, i]) != bool(hlatch):
                raise HostTwinMismatch(
                    f"{tag}: bug decision diverged (device "
                    f"{bool(recs['bug'][w, i])}, host twin {hlatch})")
            if "kernel_diff" in recs and recs["kernel_diff"][w, i].any():
                bad = [leaf_names[j] for j in
                       np.flatnonzero(recs["kernel_diff"][w, i])]
                raise HostTwinMismatch(
                    f"{tag}: the CUDA step kernel diverged from the plain "
                    f"step at lane {bad[0]!r} (leaves {bad})")
            checked += 1
    return {"n_seeds": len(seeds), "steps_checked": checked,
            "events_delivered": delivered, "restarts": restarts,
            "max_steps": max_steps}
