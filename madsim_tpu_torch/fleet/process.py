"""Multiprocess fleet: real OS worker processes, pipes, and signals.

The deployment-shaped leg of the fabric: the coordinator stays in the
parent, each worker is a process started with ``spawn`` (CUDA cannot
survive a fork once the parent has initialised it) with its own engine
on ``device`` (default CUDA), RPCs ride ``multiprocessing`` pipes, and
preemption is a real ``SIGTERM`` handled by the worker's signal handler
(checkpoint + lease release + clean exit). The protocol objects are the
SAME classes the inline fabric runs — only the transport, the clock, and
the scheduler change — so the bitwise result contract carries over
unchanged while schedules become as nondeterministic as the OS makes
them.

On CUDA a worker loads the kernel libraries the parent built
(``_build``'s on-disk cache under ``.kernel_build/``, keyed by the
sources' hash) before it takes a lease, and reports what that took: its
``nvcc`` seconds (0.0 when every library was already built) and the load
time. After each quantum it reports its step and fold kernel launches.
The reports land in ``loop_stats["fleet"]["worker_reports"]``. Worker
crash-kill is a parent-side SIGKILL; recovery is the lease TTL doing its
job (the killed worker's launches since its last report are not
counted).
"""
from __future__ import annotations

import os
import sys
from typing import Any, Dict, Optional

import numpy as np

from .rpc import RealClock, RetryPolicy, RpcError

#: Seconds the parent goes on serving its workers after the last range is
#: done, for their last reports (a worker exits once it finds the hunt
#: done, well within it).
DRAIN_S = 10.0


def _wire_safe(kw: Dict[str, Any]) -> Dict[str, Any]:
    """Strip the process-local triage context from any SweepResult
    payload before it crosses the pipe: ``triage_ctx`` holds the live
    engine, and the coordinator side never uses it (merged fleet results
    carry None there anyway)."""
    import dataclasses as _dc

    def scrub(v):
        if getattr(v, "triage_ctx", None) is not None:
            return _dc.replace(v, triage_ctx=None)
        return v

    out = {k: scrub(v) for k, v in kw.items()}
    if isinstance(out.get("msgs"), list):
        out["msgs"] = [{k: scrub(v) for k, v in m.items()}
                       for m in out["msgs"]]
    return out


class PipeTransport:
    """Worker-side transport: one request/response per call over the
    process's pipe to the coordinator."""

    def __init__(self, conn):
        self.conn = conn

    def call(self, method: str, worker_id: str, **kw):
        try:
            self.conn.send({"method": method, "worker_id": worker_id,
                            "kw": _wire_safe(kw)})
            resp = self.conn.recv()
        except (EOFError, OSError, BrokenPipeError) as exc:
            raise RpcError(f"coordinator pipe failed: {exc}") from exc
        if "err" in resp:
            raise RpcError(resp["err"])
        return resp["ok"]


def _load_kernels(eng, search: bool) -> Dict[str, Any]:
    """Load the kernel libraries ``eng``'s path launches (the step kernel
    of its family; the fold kernel under ``search=``): built already by
    the parent, so this runs no ``nvcc`` — the returned ``nvcc_s`` (the
    build seconds by source, 0.0 for a library found built) says so."""
    from time import perf_counter

    from .. import _build
    from ..engine import step_kernel
    from ..search import fold_kernel

    names = [step_kernel.family_of(eng.actor).source]
    if search:
        names.append(fold_kernel.SOURCE)
    t0 = perf_counter()
    took = _build.build_all(names)
    for name in names:
        _build.load(name)
    load_s = perf_counter() - t0
    return {"nvcc_s": {k: round(v, 3) for k, v in took.items()},
            "load_s": round(load_s, 4)}


def _launch_counts(cuda: bool) -> Dict[str, int]:
    """This process's step and fold kernel launches so far."""
    if not cuda:
        return {"step_launches": 0, "fold_launches": 0}
    from ..engine import step_kernel
    from ..search import fold_kernel

    return {"step_launches": int(step_kernel.launches),
            "fold_launches": int(fold_kernel.launches)}


def _worker_main(conn, worker_id: str, actor, cfg, seeds, faults,
                 checkpoint_dir: Optional[str],
                 checkpoint_every_chunks: int,
                 sweep_kwargs: Dict[str, Any], device=None) -> None:
    """Entry point of a spawned worker process."""
    from ..engine.core import DeviceEngine
    from .worker import Worker

    eng = DeviceEngine(actor, cfg, device=device)
    cuda = eng.device.type == "cuda"
    clock = RealClock()
    transport = PipeTransport(conn)
    report = {"pid": os.getpid(), "device": str(eng.device)}
    if cuda:
        report.update(_load_kernels(
            eng, sweep_kwargs.get("search") is not None))
    try:
        transport.call("report", worker_id, report=report)
    except RpcError:
        conn.close()
        sys.exit(0)
    w = Worker(worker_id, eng, np.asarray(seeds, np.uint64), transport,
               clock, faults=faults,
               retry=RetryPolicy(base_delay=0.05, max_delay=1.0),
               checkpoint_dir=checkpoint_dir,
               checkpoint_every_chunks=checkpoint_every_chunks,
               sweep_kwargs=sweep_kwargs)
    w.install_sigterm_handler()
    while True:
        try:
            did = w.run_once()
            if did:
                transport.call("report", worker_id, report=dict(
                    _launch_counts(cuda), leases_run=w.stats["leases_run"]))
        except RpcError:
            break  # parent gone: nothing to report to
        if w.dead:
            break  # preempted (SIGTERM): lease released, exit cleanly
        if not did:
            try:
                if transport.call("poll_done", worker_id)["done"]:
                    break
            except RpcError:
                break
            clock.sleep(0.05)
    conn.close()
    sys.exit(0)


def process_fleet_sweep(actor, cfg, seeds, *, n_workers: int,
                        range_size: int,
                        faults: Optional[np.ndarray] = None,
                        lease_ttl: float = 5.0,
                        observe: Any = None,
                        checkpoint_dir: Optional[str] = None,
                        checkpoint_every_chunks: int = 4,
                        retry: Optional[RetryPolicy] = None,
                        kill_after_heartbeats: Optional[Dict[str, int]] = None,
                        preempt_after_heartbeats: Optional[Dict[str, int]]
                        = None,
                        max_restarts_per_worker: int = 1,
                        serve_timeout_s: float = 60.0,
                        device: Any = None,
                        **sweep_kwargs):
    """Run a fleet sweep with real worker processes (``spawn="process"``).

    ``kill_after_heartbeats`` / ``preempt_after_heartbeats`` map worker
    ids to a heartbeat count after which the parent SIGKILLs /
    SIGTERMs that worker — the process-mode chaos hooks (the inline
    fabric's richer ChaosConfig needs deterministic scheduling this
    mode deliberately gives up). A killed worker respawns up to
    ``max_restarts_per_worker`` times; its lease recovers via TTL
    expiry either way. ``lease_ttl`` is in SECONDS here. ``device``: the
    workers' engine device (default CUDA, as ``DeviceEngine``). Once every
    range is done the parent serves the workers up to ``DRAIN_S`` longer,
    so that their last reports arrive and they exit on their own.
    """
    import multiprocessing as mp
    import signal
    from multiprocessing.connection import wait as conn_wait

    from ..obs import observatory as _obsy
    from .coordinator import Coordinator

    seeds = np.asarray(seeds, np.uint64)
    clock = RealClock()
    emit, close = _obsy.make_observer(observe)
    coordinator = Coordinator(seeds, range_size=range_size,
                              lease_ttl=lease_ttl, clock=clock, emit=emit,
                              n_devices=1)
    if checkpoint_dir is not None:
        os.makedirs(checkpoint_dir, exist_ok=True)
    del retry  # worker-side policy is fixed in _worker_main

    ctx = mp.get_context("spawn")
    conns: Dict[Any, str] = {}
    procs: Dict[str, Any] = {}
    hb_served: Dict[str, int] = {}
    restarts: Dict[str, int] = {}
    reports: Dict[str, Dict[str, Any]] = {}

    def spawn_worker(wid: str) -> None:
        parent_conn, child_conn = ctx.Pipe()
        # The fleet's multiprocess leg IS real concurrency, host-side by
        # design; sim determinism is preserved by the merge layer's
        # bitwise contract, not by the scheduler.
        p = ctx.Process(target=_worker_main,
                        args=(child_conn, wid, actor, cfg, seeds, faults,
                              checkpoint_dir, checkpoint_every_chunks,
                              sweep_kwargs, device),
                        daemon=True)
        p.start()
        child_conn.close()
        conns[parent_conn] = wid
        procs[wid] = p
        coordinator.emit("worker_spawned", worker=wid, pid=p.pid)

    def on_report(wid: str, report: Dict[str, Any]) -> None:
        """A worker's start-up report (its kernel loads) or its launch
        counts after a quantum; one entry per life of the worker."""
        lives = reports.setdefault(wid, {"lives": []})["lives"]
        if "pid" in report:
            lives.append(dict(report))
            coordinator.emit("worker_loaded", worker=wid, **report)
        elif lives:
            lives[-1].update(report)

    def serve(timeout: float) -> None:
        """Answer every request that arrives within ``timeout`` s."""
        ready = conn_wait(list(conns), timeout=timeout)
        for conn in ready:
            wid = conns[conn]
            try:
                req = conn.recv()
            except (EOFError, OSError):
                del conns[conn]
                continue
            method, kw = req["method"], req["kw"]
            if method == "report":
                on_report(wid, kw["report"])
                conn.send({"ok": True})
                continue
            try:
                out = getattr(coordinator, f"rpc_{method}")(
                    worker_id=req["worker_id"], **kw)
                conn.send({"ok": out})
            except Exception as exc:  # noqa: BLE001 — to the worker
                conn.send({"err": f"{type(exc).__name__}: {exc}"})
            if method == "heartbeat":
                hb_served[wid] = hb_served.get(wid, 0) + 1
                n = hb_served[wid]
                if (kill_after_heartbeats or {}).get(wid) == n:
                    os.kill(procs[wid].pid, signal.SIGKILL)
                    coordinator.emit("worker_killed", worker=wid,
                                     via="SIGKILL")
                elif (preempt_after_heartbeats or {}).get(wid) == n:
                    os.kill(procs[wid].pid, signal.SIGTERM)
                    coordinator.emit("worker_preempt_signaled",
                                     worker=wid, via="SIGTERM")

    for i in range(n_workers):
        wid = f"w{i}"
        spawn_worker(wid)
        hb_served[wid] = 0
        restarts[wid] = 0

    t0 = clock.now()
    try:
        while not coordinator.done():
            if clock.now() - t0 > serve_timeout_s:
                raise TimeoutError(
                    f"process fleet did not converge in {serve_timeout_s}s; "
                    f"stats: {coordinator.stats}")
            coordinator.tick()
            # Reap dead processes; their leases recover via TTL.
            for wid, p in list(procs.items()):
                if p.exitcode is not None and p.exitcode != 0 and \
                        restarts[wid] < max_restarts_per_worker:
                    restarts[wid] += 1
                    coordinator.emit("worker_restarted", worker=wid,
                                     exitcode=p.exitcode)
                    spawn_worker(wid)
            serve(0.05)
        # Drain: serve until every worker has exited (the last reports
        # arrive; each finds the hunt done and leaves).
        t_drain = clock.now()
        while any(p.exitcode is None for p in procs.values()) and \
                clock.now() - t_drain < DRAIN_S:
            serve(0.05)
        stats = {"n_workers": n_workers, "spawn": "process",
                 "restarts": dict(restarts), "worker_reports": reports,
                 "wall_s": round(clock.now() - t0, 6)}
        return coordinator.finalize(fleet_stats=stats)
    finally:
        for p in procs.values():
            if p.exitcode is None:
                p.terminate()
        for p in procs.values():
            p.join(timeout=5.0)
        for conn in list(conns):
            conn.close()
        if close is not None:
            close()
