"""Time the CUDA kernels of two checkouts against each other, on one
card, in turns.

Usage (on a machine with the GPU)::

    python3 -m madsim_tpu_torch.kernel_ab [--fold] OLD_ROOT NEW_ROOT

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

Prints the card's name and power limit, then one JSON line per timing:
``{"root": ..., "ms": {deployment: ms/step}, "fold_ms": {name: ms}}``.
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


def main(argv) -> int:
    if argv[:1] in (["--build"], ["--time"]):
        # The checkout under test, not this file's package, is imported.
        sys.path[0] = argv[1]
        if argv[0] == "--build":
            from madsim_tpu_torch import _build

            _build.build_all(FOLD_SOURCES if argv[2:] == ["--fold"]
                             else SOURCES)
        else:
            print(json.dumps(_time_here(argv[2:] == ["--fold"])))
        return 0
    fold_only = argv[:1] == ["--fold"]
    argv = argv[1:] if fold_only else argv
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    roots = [os.path.abspath(r) for r in argv]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    builds = [_child("--build", r, *(["--fold"] if fold_only else []))
              for r in roots]
    for b, r in zip(builds, roots):
        _wait(b, f"the build of {r}")
    old, new = roots
    for root in (old, new, new, old):
        out = _wait(_child("--time", root, *(["--fold"] if fold_only else [])),
                    f"the timing of {root}")
        times = json.loads(out.strip().splitlines()[-1])
        print(json.dumps({"root": root, **times}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
