"""Time the CUDA kernels of two checkouts against each other, on one
card, in turns.

Usage (on a machine with the GPU)::

    python3 -m madsim_tpu_torch.kernel_ab [--fold | --bridge] OLD_ROOT NEW_ROOT

``OLD_ROOT`` and ``NEW_ROOT`` are roots of two checkouts of this
repository (for example the parent commit unpacked with ``git archive``
and the working tree). Each checkout's kernels are built from its own
sources (the two builds run together), then each checkout is timed in the
order old, new, new, old, each timing in a process of its own with that
checkout's root in place of this file's directory on ``sys.path`` (so the
older checkout needs no copy of this file).

The step kernel: the device time per step over a whole run's own
launches, in chunks of 100 queued behind a sleeping kernel (as
``chip_smoke.py``'s ``device_ms``), the best of three runs, over as many
launches as the run takes to freeze its last world (its largest
``steps``). The deployments are the Raft headline and hunt, the compiled
families' and the guided search's (``engine/golden.py`` ``CONFIGS``,
``FAMILY_CONFIGS`` and ``SEARCH_CONFIGS``), in the packed lane profile, at
``chip_smoke.py``'s widths.

The corpus fold kernel: ``search/corpus.py::harvest_fold`` on the card at
8,192 and 32 rows (as ``chip_smoke.py`` phase 4's first folds: the Paxos
hunt's corpus size and ``min_novelty``, the signatures of a Paxos hunt
batch after 200 steps, lineage lanes on; the template's schedule in every
row), per call (the median of 11 CUDA event
pairs, each around one call, the wrapper inside) and on the device alone
(the best of 3 runs of 20 calls queued behind a sleeping kernel).
``--fold`` times the fold kernel only.

``--bridge`` times only the bridge's round and drain kernels
(``csrc/bridge_step.cu``, through each checkout's ``bridge/cuda.py``) at
W=512 and 4,096, ``cap=128``, ``k_events=4`` (``chip_smoke.py`` phase 13's
shape): one batch of the realistic synthetic stream after 8 warm rounds,
each kernel's device time per launch over 50 launches queued behind a
sleeping kernel, the best of 3: ``step_W``/``drain_W`` repeat the launch on
one state (as phase 13 does: the batch's timers fall due again, so most
rounds pop k events, and the state stays in L2); ``fresh_step_W`` and
``fresh_drain_W`` launch each on its own copy of the warm state (the
round the stream sends next; 50 copies pass the L2). With them the
launch floor (an empty kernel on the round's grid, where the checkout has
one). Before them, in a fresh process, the wall per call of
``BridgeKernel.step`` and ``.drain`` (``wall_step_W``, ``wall_drain_W``;
the drain's outputs read) at W=64, 512 and 4,096 on the realistic stream,
the median of 24 after two warm rounds (as ``chip_smoke.py`` phase 13
(c)), and the median split of 24 more rounds, each made of the checkout's
own ``stage_batch`` and ``launch_step`` as its ``step`` makes it
(``split_W``: staging, the H2D enqueue, the launch, the D2H enqueue, the
wait, the output copy).

Prints the card's name and power limit, then one JSON line per timing:
``{"root": ..., "ms": {deployment: ms/step}, "fold_ms": {name: ms}}``
(``{"root": ..., "bridge_ms": {name: ms}}`` under ``--bridge``).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

SOURCES = ("step_raft", "step_tpc", "step_pb", "step_paxos", "step_pair",
           "corpus_fold")
# What the fold's timing builds: its kernel and the Paxos policy that makes
# its signatures.
FOLD_SOURCES = ("step_paxos", "corpus_fold")
BRIDGE_SOURCES = ("bridge_step",)
BRIDGE_WIDTHS = (512, 4096)
BRIDGE_WALL_WIDTHS = (64, 512, 4096)
BRIDGE_QUEUED = 50
CHUNK = 100
SLEEP_CYCLES = 200_000_000
FOLD_ROWS = (8192, 32)
FOLD_QUEUED = 20


def _fold_here(dev) -> dict:
    """Ms per call and on the device alone of the corpus fold at each of
    FOLD_ROWS rows, with the package on sys.path."""
    import numpy as np
    import torch

    from madsim_tpu_torch.engine import DeviceEngine
    from madsim_tpu_torch.obs.coverage import behavior_signature
    from madsim_tpu_torch.search import hunts
    from madsim_tpu_torch.search.corpus import corpus_init, harvest_fold

    hunt = hunts.paxos_hunt()
    scfg = hunt.search(True)
    tmpl = np.asarray(hunt.template, np.int32)
    out = {}
    for w in FOLD_ROWS:
        eng = DeviceEngine(hunt.actor, hunt.cfg, device=dev)
        state = eng.run_steps(eng.init(np.arange(w), faults=tmpl), 200)
        rows = torch.arange(w, device=dev)
        args = (corpus_init(scfg.corpus, tmpl, dev),
                torch.from_numpy(np.broadcast_to(tmpl, (w,) + tmpl.shape)
                                 .copy()).to(dev),
                behavior_signature(state.metrics),
                ~state.active | (rows % 3 == 0), scfg.min_novelty,
                (rows + 1).to(torch.int32), (rows % 5).to(torch.int32))
        del state
        harvest_fold(*args, with_masks=True)
        torch.cuda.synchronize()
        times = []
        for _ in range(11):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            harvest_fold(*args, with_masks=True)
            e1.record()
            e1.synchronize()
            times.append(e0.elapsed_time(e1))
        out[f"{w}_rows_per_call"] = sorted(times)[len(times) // 2]
        best = float("inf")
        for _ in range(3):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(SLEEP_CYCLES)
            e0.record()
            for _q in range(FOLD_QUEUED):
                harvest_fold(*args, with_masks=True)
            e1.record()
            if e0.query():
                raise RuntimeError("the device reached the queued folds "
                                   "before they were all queued")
            e1.synchronize()
            best = min(best, e0.elapsed_time(e1) / FOLD_QUEUED)
        out[f"{w}_rows_device"] = best
    return out


def _bridge_here(dev) -> dict:
    """Device ms per launch of the bridge's round, drain and launch floor
    at each of BRIDGE_WIDTHS, and the walls per call of ``BridgeKernel``'s
    round and drain at each of BRIDGE_WALL_WIDTHS, with the package on
    sys.path."""
    import time
    import types

    import numpy as np
    import torch

    from madsim_tpu_torch.bridge import cuda as bcuda
    from madsim_tpu_torch.bridge.kernel import (BridgeKernel, BridgeState,
                                                StepOut)
    from madsim_tpu_torch.bridge.synthetic import SyntheticStream, drive

    def best_ms(launch, before=None):
        """``launch(q)`` for q in range(BRIDGE_QUEUED), queued; ``before``
        runs ahead of each timing."""
        launch(0)
        torch.cuda.synchronize()
        best = float("inf")
        for _ in range(3):
            if before is not None:
                before()
                torch.cuda.synchronize()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(SLEEP_CYCLES // 4)
            e0.record()
            for q in range(BRIDGE_QUEUED):
                launch(q)
            e1.record()
            if e0.query():
                raise RuntimeError("the device reached the queued launches "
                                   "before they were all queued")
            e1.synchronize()
            best = min(best, e0.elapsed_time(e1) / BRIDGE_QUEUED)
        return best

    out = {}
    stream_c = torch.cuda.current_stream(dev)
    pieces = ("staging", "h2d_enqueue", "launch", "d2h_enqueue", "wait",
              "output_copy")
    for w in BRIDGE_WALL_WIDTHS:
        kern = BridgeKernel(np.arange(w), cap=128, k_events=4, device=dev)
        syn = SyntheticStream(np.arange(w), cap=128, mode="realistic",
                              seed=13)
        step_s, drain_s, split = [], [], []
        for _ in range(26):
            batch = syn.batch()
            t0 = time.perf_counter()
            res = kern.step(batch)
            step_s.append(time.perf_counter() - t0)
            syn.after_step(res)
        for _ in range(26):
            t0 = time.perf_counter()
            [np.asarray(x) for x in kern.drain()]
            drain_s.append(time.perf_counter() - t0)
        for _ in range(26):
            batch = syn.batch()
            t = [time.perf_counter()]
            stage = bcuda.stage_batch(kern, batch)
            t.append(time.perf_counter())
            stage.dev_in.copy_(stage.host_in, non_blocking=True)
            t.append(time.perf_counter())
            bcuda.launch_step(kern, stage, stream_c)
            t.append(time.perf_counter())
            stage.host_out.copy_(stage.dev_out, non_blocking=True)
            t.append(time.perf_counter())
            stream_c.synchronize()
            t.append(time.perf_counter())
            raw = stage.host_out.numpy().copy()
            res = StepOut(*bcuda._views(raw, stage.out_fields,
                                        stage.out_offs))
            t.append(time.perf_counter())
            syn.after_step(res)
            split.append(np.diff(t))
        out[f"wall_step_{w}"] = float(np.median(step_s[2:])) * 1e3
        out[f"wall_drain_{w}"] = float(np.median(drain_s[2:])) * 1e3
        out[f"split_{w}"] = dict(zip(pieces, (np.median(
            np.stack(split[2:]), axis=0) * 1e3).tolist()))
    for w in BRIDGE_WIDTHS:
        kern = BridgeKernel(np.arange(w), cap=128, k_events=4, device=dev)
        syn = SyntheticStream(np.arange(w), cap=128, mode="realistic",
                              seed=13)
        for _ in drive(syn, [kern], 8):
            pass
        stage = bcuda.stage_batch(kern, syn.batch())
        stage.dev_in.copy_(stage.host_in)
        dev_out = torch.empty(bcuda._layout(bcuda.drain_fields(w, 4))[1],
                              dtype=torch.uint8, device=dev)
        warm = BridgeState(*[x.clone() for x in kern.state])
        copies = [types.SimpleNamespace(
            state=BridgeState(*[x.clone() for x in warm]), W=w, cap=128,
            k_events=4, _net_k0=kern._net_k0, _net_k1=kern._net_k1,
            _mb_block=None) for _ in range(BRIDGE_QUEUED)]

        def reset():
            for c in copies + [kern]:
                for a, b in zip(c.state, warm):
                    a.copy_(b)

        out[f"fresh_step_{w}"] = best_ms(
            lambda q: bcuda.launch_step(copies[q], stage, stream_c), reset)
        out[f"fresh_drain_{w}"] = best_ms(
            lambda q: bcuda.launch_drain(copies[q], dev_out, stream_c),
            reset)
        reset()
        out[f"step_{w}"] = best_ms(
            lambda q: bcuda.launch_step(kern, stage, stream_c))
        out[f"drain_{w}"] = best_ms(
            lambda q: bcuda.launch_drain(kern, dev_out, stream_c))
        if hasattr(bcuda, "launch_empty"):
            out[f"floor_{w}"] = best_ms(
                lambda q: bcuda.launch_empty(w, 128, stream_c))
            lanes, _, per = bcuda.launch_shape(w, 128)
            out[f"lanes_per_world_{w}"] = lanes
            out[f"worlds_per_block_{w}"] = per
    return out


def _time_here(fold_only: bool) -> dict:
    """Device ms/step of each deployment (``ms``; none under
    ``fold_only``) and the fold's times (``fold_ms``) with the package on
    sys.path."""
    import numpy as np
    import torch

    from madsim_tpu_torch.engine import (DeviceEngine, EngineConfig, golden,
                                         step_kernel)
    from madsim_tpu_torch.engine.core import tree_leaves
    from madsim_tpu_torch.engine.families import family

    dev = torch.device("cuda")
    out = {}
    if fold_only:
        return {"ms": out, "fold_ms": _fold_here(dev)}
    cases = [("headline", ("raft",) + golden.CONFIGS["headline"][:2], None,
              524_288, golden.CONFIGS["headline"][3]),
             ("hunt", ("raft", dict(n=3, buggy_double_vote=True),
                       golden.CONFIGS["hunt_faults"][1]), None, 65_536,
              4_000)]
    for name, (fam, ak, ck, faults, steps) in {
            **golden.FAMILY_CONFIGS, **golden.SEARCH_CONFIGS}.items():
        cases.append((name, (fam, ak, ck), None if faults is None
                      else np.asarray(faults, np.int32), 65_536, steps))
    for name, (fam, ak, ck), faults, w, max_steps in cases:
        acls, ccls = family(fam).load()
        eng = DeviceEngine(acls(ccls(**ak)), EngineConfig(**ck), device=dev)
        state = eng.run(eng.init(np.arange(w), faults=faults), max_steps)
        total = int(state.steps.max())
        del state
        best = float("inf")
        for _ in range(3):
            leaves = tree_leaves(eng.init(np.arange(w), faults=faults))
            done, busy = 0, 0.0
            while done < total:
                k = min(CHUNK, total - done)
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                torch.cuda._sleep(SLEEP_CYCLES)
                e0.record()
                step_kernel.launch(eng, leaves, k)
                e1.record()
                if e0.query():
                    raise RuntimeError("the device reached the timed "
                                       "launches before they were queued")
                e1.synchronize()
                busy += e0.elapsed_time(e1)
                done += k
            best = min(best, busy / total)
        out[name] = best
    return {"ms": out, "fold_ms": _fold_here(dev)}


def _child(mode: str, root: str, *extra: str) -> subprocess.Popen:
    """This file run as ``mode`` against the checkout at ``root``."""
    return subprocess.Popen([sys.executable, os.path.abspath(__file__), mode,
                             root, *extra], cwd=root, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _wait(proc: subprocess.Popen, what: str) -> str:
    out, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"{what} failed:\n{out}\n{err}")
    return out


def _compare(roots, extra) -> None:
    """Builds both checkouts, then times them old, new, new, old."""
    builds = [_child("--build", r, *extra) for r in roots]
    for b, r in zip(builds, roots):
        _wait(b, f"the build of {r}")
    old, new = roots
    for root in (old, new, new, old):
        out = _wait(_child("--time", root, *extra), f"the timing of {root}")
        times = json.loads(out.strip().splitlines()[-1])
        print(json.dumps({"root": root, **times}), flush=True)


def main(argv) -> int:
    if argv[:1] in (["--build"], ["--time"]):
        # The checkout under test, not this file's package, is imported.
        sys.path[0] = argv[1]
        only = argv[2] if argv[2:] else None
        if argv[0] == "--build":
            from madsim_tpu_torch import _build

            _build.build_all({"--fold": FOLD_SOURCES,
                              "--bridge": BRIDGE_SOURCES}.get(only, SOURCES))
        elif only == "--bridge":
            import torch

            print(json.dumps({"bridge_ms": _bridge_here(
                torch.device("cuda"))}))
        else:
            print(json.dumps(_time_here(only == "--fold")))
        return 0
    mode = argv[0] if argv[:1] in (["--fold"], ["--bridge"]) else None
    argv = argv[1:] if mode else argv
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    _compare([os.path.abspath(r) for r in argv], [mode] if mode else [])
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
