"""tracelint — pass 3, the part of the JAX package's program analysis that
carries over to PyTorch and CUDA.

The JAX pass traces the hot-path programs to jaxprs and compiles them
fresh; the port has no traced programs, so it runs each one once on the
device, at the JAX registry's pinned shapes, and checks what a run can
show:

- **TRC001 — host re-entry.** A program's device part reads nothing back
  to the host outside its declared reads. The reads go through the port's
  own seams — the sweep's ``_fetch``/``_to_host`` pulls and the device
  loops' flag reads (``Lookahead``) — which are counted on any device
  (``host_syncs``); a read through a seam the program does not declare is
  a finding. On CUDA the program also runs under
  ``torch.cuda.set_sync_debug_mode("error")`` (the declared reads lift it
  while they run), so a synchronizing op that bypasses the seams — a
  ``.item()``, a pageable copy in either direction — is a finding too.
  A bridge round returns host arrays by contract: its one copy out is its
  read (the bridge's ``d2h_copies``), and it runs outside the sync check.
- **TRC002 — nondeterministic ops.** On CUDA each program runs under
  ``torch.use_deterministic_algorithms(True)``; an op without a
  deterministic implementation raises, and is a finding.
- **TRC004 — in place.** Where the JAX program donates its state, the
  port writes it in place: every state leaf keeps its storage across the
  call (``data_ptr``).
- **BUD001/BUD002 — the ledger** (:mod:`.budgets`): ``host_syncs`` per
  call and ``state_bytes_per_world``, per device type and lane profile,
  against checked-in ceilings; a registry out of step with the ledger, or
  a program that fails to build, is BUD002.

What does not carry over is in :data:`.rules.NOT_CARRIED` (TRC003, TRC005
and XLA's flops, bytes, temp and peak sizes). :func:`registry` keeps the
JAX registry's names and shapes (``madsim_tpu/analysis/tracelint.py``);
each program is built on the port's counterpart, which its title names.

On CUDA every program runs once before it is measured, on inputs of its
own: that call builds and loads the kernels and fills the per-device
caches, so the measured call is the steady state.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import budgets as _budgets
from .pragmas import Finding
from .rules import RULES

# Pinned shapes: the JAX registry's.
RUN_WORLDS = 256
RUN_MAX_STEPS = 4_000
SWEEP_WORLDS = 64
SWEEP_CHUNK_STEPS = 16
SWEEP_K_MAX = 4
BLACKBOX_K = 64
PALLAS_WORLDS = 64
SEARCH_WORLDS = 32
SEARCH_ROWS = 6
TRIAGE_CANDS = 32
TRIAGE_ROWS = 16
ACTORC_WORLDS = 64
ACTORC_MAX_STEPS = 4_000
BRIDGE_SLOTS = 8
BRIDGE_CAP = 16
BRIDGE_K_EVENTS = 2
BRIDGE_PAD = 4
COV_BUCKETS = 64

#: The declared reads a program may make: the sweep's pulls, the device
#: loops' flag reads, a bridge round's copy out.
READS = ("fetch", "flags", "bridge")


@dataclasses.dataclass
class Built:
    """One program instance: ``call()`` runs it once; ``state`` is the
    world state it steps or writes (a tree, or a split ``Sharded``), whose
    storage TRC004 watches and whose bytes a world takes."""

    call: Callable[[], Any]
    state: Any = None


@dataclasses.dataclass
class TraceProgram:
    name: str
    title: str                    # one line for --list-programs
    build: Optional[Callable[[torch.device], Built]]  # None: no counterpart
    budget: bool = False          # in the ledger
    in_place: bool = False        # the JAX program donates its state
    reads: Tuple[str, ...] = ()   # its declared reads (READS)
    profile: str = "packed"       # the lane profile of its state


_CACHE: Dict[Any, Any] = {}


def _mesh(dev):
    from ..parallel.mesh import seed_mesh

    return seed_mesh([dev])


def _bug_engine(dev, metrics: bool = False, blackbox: int = 0):
    """The JAX registry's Raft bug configuration."""
    key = ("bug", str(dev), metrics, blackbox)
    if key not in _CACHE:
        from ..engine import (DeviceEngine, EngineConfig, RaftActor,
                              RaftDeviceConfig)

        cfg = EngineConfig(n_nodes=3, outbox_cap=4, queue_cap=64,
                           t_limit_us=2_000_000, stop_on_bug=False,
                           metrics=metrics, blackbox=blackbox)
        _CACHE[key] = DeviceEngine(
            RaftActor(RaftDeviceConfig(n=3, buggy_double_vote=True)), cfg,
            device=dev)
    return _CACHE[key]


def _build_engine_run(blackbox: int = 0):
    def build(dev) -> Built:
        eng = _bug_engine(dev, blackbox=blackbox)
        state = eng.init(np.arange(RUN_WORLDS))
        return Built(lambda: eng.run(state, RUN_MAX_STEPS), state)
    return build


def _build_pallas_step(dev) -> Built:
    eng = _bug_engine(dev)
    state = eng.init(np.arange(PALLAS_WORLDS))
    return Built(lambda: eng.run_steps(state, 1), state)


def _build_push_many(dev) -> Built:
    from ..engine.queue import Event, empty_queue, push_many

    q = empty_queue(1, 64, 2, device=dev)
    m = 4

    def z():
        return torch.zeros((1, m), dtype=torch.int32, device=dev)

    evs = Event(time=z(), kind=z(), flags=z(), src=z(), dst=z(), gen=z(),
                payload=torch.zeros((1, m, 2), dtype=torch.int32,
                                    device=dev))
    enable = torch.ones((1, m), dtype=torch.bool, device=dev)
    return Built(lambda: push_many(q, evs, enable), q)


def _build_refill_select(dev) -> Built:
    eng = _bug_engine(dev)
    mask = torch.zeros((SWEEP_WORLDS,), dtype=torch.bool, device=dev)
    fresh = eng.init(np.arange(SWEEP_WORLDS))
    state = eng.init(np.arange(SWEEP_WORLDS))
    return Built(lambda: eng._refill_select(mask, fresh, state), state)


def _sweep_state(eng, dev):
    from ..parallel.mesh import shard_worlds

    return shard_worlds(eng.init(np.arange(SWEEP_WORLDS)), _mesh(dev))


def _build_superstep(min_one: bool):
    def build(dev) -> Built:
        from ..parallel.sweep import sharded_superstep

        eng = _bug_engine(dev)
        runner = sharded_superstep(eng, _mesh(dev), SWEEP_CHUNK_STEPS,
                                   SWEEP_K_MAX, min_one=min_one)
        state = _sweep_state(eng, dev)
        return Built(lambda: runner(state, 0, False, SWEEP_K_MAX), state)
    return build


def _ledger_and_index(dev, w):
    from ..obs.coverage import ledger_zeros

    hits, first = ledger_zeros(COV_BUCKETS, dev)
    return hits, first, torch.arange(w, dtype=torch.int32, device=dev)


def _build_superstep_coverage(dev) -> Built:
    from ..parallel.sweep import sharded_superstep

    eng = _bug_engine(dev, metrics=True)
    runner = sharded_superstep(eng, _mesh(dev), SWEEP_CHUNK_STEPS,
                               SWEEP_K_MAX, coverage=COV_BUCKETS)
    state = _sweep_state(eng, dev)
    hits, first, idx = _ledger_and_index(dev, SWEEP_WORLDS)
    return Built(lambda: runner(state, hits, first, idx, SWEEP_WORLDS, 0,
                                False, SWEEP_K_MAX), state)


def _build_endfold(dev) -> Built:
    from ..parallel.sweep import _fold_end

    eng = _bug_engine(dev, metrics=True)
    state = _sweep_state(eng, dev)
    hits, first, idx = _ledger_and_index(dev, SWEEP_WORLDS)
    return Built(lambda: _fold_end(state, hits, first, idx, SWEEP_WORLDS,
                                   False), state)


def _build_compactor(dev) -> Built:
    from ..parallel.sweep import _compactor

    eng = _bug_engine(dev)
    state = eng.init(np.arange(SWEEP_WORLDS))
    idx = torch.arange(SWEEP_WORLDS, dtype=torch.int32, device=dev)
    return Built(lambda: _compactor(state, idx), state)


def _search_fixture(dev):
    """The guided-search builders' engine, configuration, template and
    per-slot tensors at the hunt shape (JAX's ``_search_fixture``)."""
    from ..obs.lineage import lanes_origin, table_zeros
    from ..search.corpus import corpus_init
    from ..search.family import (GuidedPairConfig, family_schedule,
                                 hunt_search_config)

    key = ("search", str(dev))
    if key not in _CACHE:
        from ..engine import DeviceEngine
        from ..search.family import GuidedPairActor, engine_config

        acfg = GuidedPairConfig(n=12)
        _CACHE[key] = DeviceEngine(GuidedPairActor(acfg),
                                   engine_config(acfg), device=dev)
    eng = _CACHE[key]
    scfg = hunt_search_config(True)
    tmpl = family_schedule(SEARCH_ROWS, GuidedPairConfig(n=12))
    w = SEARCH_WORLDS
    state = eng.init(np.arange(w), faults=tmpl)
    sched = torch.from_numpy(np.broadcast_to(tmpl, (w,) + tmpl.shape)
                             .copy()).to(dev)
    idx = torch.arange(w, dtype=torch.int32, device=dev)
    corpus = corpus_init(int(scfg.corpus), tmpl, dev)
    return dict(eng=eng, scfg=scfg, tmpl=tmpl, w=w, state=state,
                sched=sched, idx=idx, corpus=corpus,
                lin=lanes_origin(w, dev), op_tab=table_zeros(dev))


def _build_search_generate(dev) -> Built:
    from ..search.generate import searcher

    f = _search_fixture(dev)
    w = f["w"]
    gen = searcher(f["eng"], f["scfg"], w, SEARCH_ROWS)
    ids = torch.arange(w, dtype=torch.int32, device=dev)
    fill = torch.arange(w, device=dev) >= w // 2
    return Built(lambda: gen(f["state"], f["sched"], f["idx"], f["corpus"],
                             w // 2, ids, fill, f["lin"], f["op_tab"], 0),
                 f["state"])


def _build_compactor_sched(dev) -> Built:
    from ..parallel.sweep import _compactor

    f = _search_fixture(dev)
    return Built(lambda: _compactor(f["state"], f["idx"], extra=(
        f["sched"], *f["lin"])), f["state"])


def _build_fused_hunt(dev) -> Built:
    """The whole-hunt loop at its widest (guided, lineage, coverage), one
    mega-dispatch of ``SWEEP_K_MAX`` chunks."""
    from ..obs.coverage import ledger_zeros
    from ..obs.observatory import ProfilerWindow
    from ..parallel.mesh import shard_worlds
    from ..parallel.sweep import _fused_hunt

    f = _search_fixture(dev)
    w = f["w"]
    mesh = _mesh(dev)
    state = shard_worlds(f["state"], mesh)
    hits, first = ledger_zeros(COV_BUCKETS, dev)
    perf = {"dispatch_s": 0.0, "dispatches": 0, "device_wait_s": 0.0,
            "scalar_fetches": 0, "host_decision_s": 0.0}

    def call():
        return _fused_hunt(
            f["eng"], mesh, state, f["idx"], np.arange(w, dtype=np.uint64),
            w, f["tmpl"], False, f["scfg"], True, COV_BUCKETS, hits, first,
            f["sched"], f["corpus"], f["lin"], f["op_tab"], recycle=True,
            chunk_steps=SWEEP_CHUNK_STEPS, c_max=SWEEP_K_MAX,
            stop_on_first_bug=False, lin_base=0, perf=perf,
            prof=ProfilerWindow(None, (0, 0)),
            on_read=lambda *a: None)
    return Built(call, state)


def _build_triage_candidate_eval(dev) -> Built:
    from ..engine import DeviceEngine
    from ..parallel.mesh import shard_worlds
    from ..parallel.sweep import sharded_superstep
    from ..triage.synthetic import (PairRestartActor, PairRestartConfig,
                                    engine_config, pair_schedule)

    key = ("triage", str(dev))
    if key not in _CACHE:
        acfg = PairRestartConfig()
        _CACHE[key] = DeviceEngine(PairRestartActor(acfg),
                                   engine_config(acfg), device=dev)
    eng = _CACHE[key]
    runner = sharded_superstep(eng, _mesh(dev), SWEEP_CHUNK_STEPS,
                               SWEEP_K_MAX)
    cands = np.broadcast_to(pair_schedule(n_rows=TRIAGE_ROWS, need=(2, 11)),
                            (TRIAGE_CANDS, TRIAGE_ROWS, 4))
    state = shard_worlds(eng.init(np.full(TRIAGE_CANDS, 7, np.uint64),
                                  faults=cands), _mesh(dev))
    return Built(lambda: runner(state, 0, False, SWEEP_K_MAX), state)


def _build_actorc_run(family: str):
    def build(dev) -> Built:
        key = ("actorc", family, str(dev))
        if key not in _CACHE:
            from ..engine import DeviceEngine, EngineConfig

            if family == "paxos":
                from ..actorc.families.paxos import (PaxosActor,
                                                     PaxosConfig,
                                                     engine_config)

                acfg = PaxosConfig()
                eng = DeviceEngine(PaxosActor(acfg), engine_config(acfg),
                                   device=dev)
            elif family == "pb":
                from ..engine import PBActor, PBDeviceConfig

                eng = DeviceEngine(
                    PBActor(PBDeviceConfig()),
                    EngineConfig(n_nodes=3, outbox_cap=4, queue_cap=64,
                                 t_limit_us=2_000_000), device=dev)
            else:
                from ..engine import TPCActor, TPCDeviceConfig

                eng = DeviceEngine(
                    TPCActor(TPCDeviceConfig(n=4, n_txns=4)),
                    EngineConfig(n_nodes=4, outbox_cap=5, queue_cap=64,
                                 t_limit_us=2_000_000, stop_on_bug=False),
                    device=dev)
            _CACHE[key] = eng
        eng = _CACHE[key]
        state = eng.init(np.arange(ACTORC_WORLDS))
        return Built(lambda: eng.run(state, ACTORC_MAX_STEPS), state)
    return build


def _bridge(dev):
    from ..bridge.kernel import BridgeKernel

    return BridgeKernel(np.arange(1, BRIDGE_SLOTS + 1), cap=BRIDGE_CAP,
                        k_events=BRIDGE_K_EVENTS, device=str(dev))


def _build_bridge_step(dev) -> Built:
    from ..bridge.kernel import HostBatch

    bk = _bridge(dev)
    w, p = bk.W, BRIDGE_PAD
    batch = HostBatch(
        t_slot=np.zeros((w, p), np.int32), t_dl=np.zeros((w, p), np.int64),
        t_seq=np.zeros((w, p), np.int64), t_mask=np.zeros((w, p), bool),
        c_slot=np.zeros((w, p), np.int32), c_mask=np.zeros((w, p), bool),
        s_ctr=np.zeros((w, p), np.uint64), s_base=np.zeros((w, p), np.int64),
        s_slot=np.zeros((w, p), np.int32), s_seq=np.zeros((w, p), np.int64),
        s_thr=np.zeros((w, p), np.uint64), s_lossall=np.zeros((w, p), bool),
        s_lat_lo=np.zeros((w, p), np.int64),
        s_lat_w=np.ones((w, p), np.int64), s_mask=np.zeros((w, p), bool),
        s_live=np.zeros((w, p), bool), clock=np.zeros((w,), np.int64),
        advance=np.zeros((w,), bool))
    return Built(lambda: bk.step(batch), bk.state)


def _build_bridge_drain(dev) -> Built:
    bk = _bridge(dev)

    def call():
        out = bk.drain()
        return [np.asarray(x) for x in out]
    return Built(call, bk.state)


def registry() -> Dict[str, TraceProgram]:
    """The JAX registry's programs by name, each on its port counterpart.
    Builders are lazy: nothing runs until a check does."""
    loops = ("flags",)
    progs = [
        TraceProgram(
            "engine.run", "DeviceEngine.run: windows of step-kernel "
            f"launches and their flag reads (raft bug config, "
            f"W={RUN_WORLDS})", _build_engine_run(), budget=True,
            in_place=True, reads=loops),
        TraceProgram(
            "engine.run_blackbox", "DeviceEngine.run with the flight "
            f"recorder (EngineConfig(blackbox={BLACKBOX_K}), raft bug "
            f"config, W={RUN_WORLDS})", _build_engine_run(BLACKBOX_K),
            budget=True, in_place=True, reads=loops),
        TraceProgram(
            "engine.pallas_step", "one step-kernel launch "
            "(csrc/step_kernel.cuh; the plain step on the CPU; raft bug "
            f"config, W={PALLAS_WORLDS})", _build_pallas_step, budget=True,
            in_place=True),
        TraceProgram(
            "engine.push_many", "engine/queue.py push_many, the step's "
            "single-pass insert (one queue of 64 slots, 4 events)",
            _build_push_many),
        TraceProgram(
            "engine.refill_select", "DeviceEngine._refill_select, the "
            "recycle-slot select written into the old batch",
            _build_refill_select, budget=True, in_place=True),
        TraceProgram(
            "sweep.superstep", "sharded_superstep: DeviceEngine.superstep "
            f"(W={SWEEP_WORLDS}, chunk_steps={SWEEP_CHUNK_STEPS}, "
            f"k_max={SWEEP_K_MAX})", _build_superstep(False), budget=True,
            in_place=True, reads=loops),
        TraceProgram(
            "sweep.superstep_min_one", "the superstep's min_one variant "
            "(an epoch's first dispatch)", _build_superstep(True),
            budget=True, in_place=True, reads=loops),
        TraceProgram(
            "sweep.superstep_coverage", "the superstep with the "
            "retire-time coverage fold (metrics on)",
            _build_superstep_coverage, reads=loops),
        TraceProgram(
            "sweep.coverage_endfold", "the boundary coverage fold (resume "
            "pre-pass / end of sweep)", _build_endfold),
        TraceProgram(
            "sweep.compactor", "the stable active-first compaction (out of "
            "place: a permutation is a gather)", _build_compactor,
            budget=True),
        TraceProgram(
            "triage.candidate_eval", "a minimize round's superstep "
            f"(C={TRIAGE_CANDS} candidate schedules x F={TRIAGE_ROWS} rows "
            "over the pair_restart engine)", _build_triage_candidate_eval,
            budget=True, in_place=True, reads=loops),
        TraceProgram(
            "search.generate", "the searcher: the corpus fold "
            "(csrc/corpus_fold.cu on CUDA) and the children "
            f"(W={SEARCH_WORLDS} slots x F={SEARCH_ROWS} rows, guided pair "
            "family, lineage on; reads the state only)",
            _build_search_generate, budget=True),
        TraceProgram(
            "sweep.compactor_sched", "guided compaction: state, per-slot "
            "schedules and lineage lanes permuted together (out of place)",
            _build_compactor_sched, budget=True),
        TraceProgram(
            "sweep.fused_hunt", "the whole-hunt loop (_fused_hunt): chunks, "
            "compaction, harvest, coverage fold, searcher, refill and seed "
            f"cursor on the device, one mega-dispatch (W={SEARCH_WORLDS}, "
            f"chunk_steps={SWEEP_CHUNK_STEPS}, k={SWEEP_K_MAX}, guided pair "
            "family, lineage on); its state changes by epochs out of place",
            _build_fused_hunt, budget=True, reads=("fetch", "flags")),
        TraceProgram(
            "actorc.tpc_run", "DeviceEngine.run of the compiled two-phase "
            f"commit family (step kernel, W={ACTORC_WORLDS})",
            _build_actorc_run("tpc"), budget=True, in_place=True,
            reads=loops),
        TraceProgram(
            "actorc.pb_run", "DeviceEngine.run of the compiled "
            f"primary-backup family (step kernel, W={ACTORC_WORLDS})",
            _build_actorc_run("pb"), budget=True, in_place=True,
            reads=loops),
        TraceProgram(
            "actorc.paxos_run", "DeviceEngine.run of the compiled "
            f"multi-decree Paxos family (step kernel, W={ACTORC_WORLDS})",
            _build_actorc_run("paxos"), budget=True, in_place=True,
            reads=loops),
        TraceProgram(
            "bridge.step", "BridgeKernel.step: one round "
            f"(csrc/bridge_step.cu on CUDA; W={BRIDGE_SLOTS}, "
            f"cap={BRIDGE_CAP}), its outputs copied out",
            _build_bridge_step, budget=True, in_place=True,
            reads=("bridge",), profile="bridge"),
        TraceProgram(
            "bridge.drain", "BridgeKernel.drain: one pop-only round, its "
            "outputs copied out", _build_bridge_drain, budget=True,
            in_place=True, reads=("bridge",), profile="bridge"),
    ]
    return {p.name: p for p in progs}


# -- the checks ----------------------------------------------------------------

def _finding(program: str, rule: str, msg: str) -> Finding:
    r = RULES[rule]
    return Finding(f"trace/{program}", 0, rule,
                   f"{r.title}: {msg} — {r.suggestion}")


def _leaves(state) -> list:
    from ..engine.core import tree_leaves, world_blocks

    return [x for b in world_blocks(state) for x in tree_leaves(b)]


def state_bytes_per_world(state) -> Optional[float]:
    """Bytes of world state a world takes (every leaf's bytes over the
    world count), or None without a state."""
    leaves = _leaves(state) if state is not None else []
    if not leaves:
        return None
    from ..engine.core import world_blocks

    w = sum(int(b.now.shape[0]) if hasattr(b, "now")
            else int(_leaves(b)[0].shape[0]) for b in world_blocks(state))
    return round(sum(x.numel() * x.element_size() for x in leaves) / w, 2)


@contextlib.contextmanager
def _counted_reads(cuda: bool):
    """Count the declared reads by seam while the block runs, lifting the
    CUDA sync check around each; yields the ``{seam: count}`` dict."""
    import importlib

    from ..engine.core import Lookahead

    sweep = importlib.import_module("madsim_tpu_torch.parallel.sweep")
    counts = {r: 0 for r in READS}
    real_to_host, real_read = sweep._to_host, Lookahead.read

    @contextlib.contextmanager
    def lifted():
        if not cuda:
            yield
            return
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(0)
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(mode)

    def to_host(tree):
        counts["fetch"] += 1
        with lifted():
            return real_to_host(tree)

    def read(self, every=False):
        with lifted():
            out = real_read(self, every)
        counts["flags"] += len(out)
        return out

    bridge_d2h = None
    if cuda:
        from ..bridge import cuda as bridge_cuda

        bridge_d2h = bridge_cuda.d2h_copies
    sweep._to_host, Lookahead.read = to_host, read
    try:
        yield counts
    finally:
        sweep._to_host, Lookahead.read = real_to_host, real_read
        if bridge_d2h is not None:
            counts["bridge"] = bridge_cuda.d2h_copies - bridge_d2h


def check_program(name: str, prog: TraceProgram, dev: torch.device
                  ) -> Tuple[List[Finding], Dict[str, Any]]:
    """Run one program once on ``dev`` (after a warm-up call on CUDA) and
    check TRC001/TRC002/TRC004. Returns its findings and its line:
    ``host_syncs``, ``state_bytes_per_world``, ``in_place`` and
    ``deterministic`` (None where a check does not apply)."""
    cuda = dev.type == "cuda"
    if cuda:
        prog.build(dev).call()
        torch.cuda.synchronize(dev)
    built = prog.build(dev)
    if cuda:
        torch.cuda.synchronize(dev)
    findings: List[Finding] = []
    ptrs = [x.data_ptr() for x in _leaves(built.state)] \
        if built.state is not None else []
    sync_check = cuda and "bridge" not in prog.reads
    det_prev = torch.are_deterministic_algorithms_enabled()
    error = None
    with _counted_reads(cuda) as counts:
        if cuda:
            torch.use_deterministic_algorithms(True)
        if sync_check:
            torch.cuda.set_sync_debug_mode("error")
        try:
            built.call()
        except RuntimeError as exc:
            error = exc
        finally:
            if sync_check:
                torch.cuda.set_sync_debug_mode(0)
            if cuda:
                torch.use_deterministic_algorithms(det_prev)
                torch.cuda.synchronize(dev)
    if error is not None:
        text = str(error)
        rule = ("TRC002" if "deterministic" in text
                else "TRC001" if "synchroniz" in text else "BUD002")
        findings.append(_finding(name, rule, f"{type(error).__name__}: "
                                 f"{text.splitlines()[0] if text else ''}"))
    for seam, n in counts.items():
        if n and seam not in prog.reads:
            findings.append(_finding(
                name, "TRC001", f"{n} read(s) through the {seam!r} seam, "
                f"which the program does not declare (it declares "
                f"{list(prog.reads) or 'none'})"))
    in_place = None
    if prog.in_place and built.state is not None:
        now = [x.data_ptr() for x in _leaves(built.state)]
        moved = sum(a != b for a, b in zip(ptrs, now))
        in_place = moved == 0
        if moved:
            findings.append(_finding(
                name, "TRC004", f"{moved} of {len(now)} state leaves were "
                "given new storage by the call"))
    line = {"host_syncs": sum(counts.values()),
            "state_bytes_per_world": state_bytes_per_world(built.state),
            "in_place": in_place,
            "deterministic": (error is None or "deterministic" not in
                              str(error)) if cuda else None}
    return findings, line


def ledger_key(dev: torch.device, prog: TraceProgram) -> str:
    """The ledger's key for a program on a device type."""
    return f"{dev.type}/{prog.profile}"


def run_trace(programs: Optional[List[str]] = None,
              budget_check: bool = True,
              ledger_path: Optional[str] = None,
              device=None,
              regs: Optional[Dict[str, TraceProgram]] = None,
              ) -> Tuple[List[Finding], Dict[str, Dict[str, Any]]]:
    """Run tracelint over the registered programs on ``device`` (default
    CUDA, raising without one).

    Returns ``(findings, lines)``: each program's line (:func:`check_program`),
    and with ``budget_check`` the ledger diff (BUD001/BUD002) of the budget
    programs on this device type. ``regs`` replaces the registry (the
    tests' seeded faults)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "tracelint runs on the GPU by default, and no CUDA device "
                "was found: pass --device cpu")
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    all_regs = regs if regs is not None else registry()
    sel = all_regs
    if programs:
        unknown = [p for p in programs if p not in all_regs]
        if unknown:
            raise KeyError(f"unknown program(s): {unknown}; known: "
                           f"{sorted(all_regs)}")
        sel = {k: v for k, v in all_regs.items() if k in programs}
    findings: List[Finding] = []
    lines: Dict[str, Dict[str, Any]] = {}
    measured: Dict[str, Dict[str, Dict[str, Any]]] = {}
    for name, prog in sel.items():
        if prog.build is None:
            continue
        try:
            fs, line = check_program(name, prog, dev)
        except Exception as exc:  # noqa: BLE001 — reported as BUD002
            findings.append(_finding(
                name, "BUD002",
                f"program failed to build: {type(exc).__name__}: {exc}"))
            continue
        findings.extend(fs)
        lines[name] = line
        if prog.budget:
            measured.setdefault(ledger_key(dev, prog), {})[name] = line
    if budget_check:
        ledger = _budgets.load_ledger(ledger_path)
        registered = (sorted(all_regs) if not programs else None)
        for key, m in sorted(measured.items()):
            findings.extend(_budgets.diff_ledger(m, key, ledger,
                                                 registered=registered))
            registered = None   # the stale-entry scan once
        if registered is not None:
            findings.extend(_budgets.diff_ledger({}, "", ledger,
                                                 registered=registered))
    findings.sort(key=lambda f: (f.path, f.rule))
    return findings, lines
