#!/usr/bin/env python3
"""Chip smoke test of madsim_tpu_torch: the port's paths on one NVIDIA GPU.

Builds the CUDA step kernel from ``madsim_tpu_torch/csrc`` and drives the
batched Raft engine — ``DeviceEngine(RaftActor(..), EngineConfig(..))``,
``init``, ``run``, ``observe`` — and the bug hunt's seed sweep
(``madsim_tpu_torch.parallel.sweep.sweep``, ``refill``, ``trace``) through
it, then the compiled families two-phase commit and primary-backup
(``DeviceEngine(TPCActor(..) | PBActor(..), ..)``) through their kernel
policies, then the coverage-guided schedule search
(``sweep(..., search=SearchConfig(..))``) over the Paxos and pair-restart
families through theirs, each sweep through the serial, the pipelined
(the default) and the fused loop, and every family in the wide lane
profile (``EngineConfig(packed=False)``) too; then the sweeps'
checkpoints and resumes (``sweep(checkpoint_path=..., resume=True)``),
``crosscheck_backends`` (CUDA against the CPU) and
``EngineConfig(sequential_insert=True)``; then failure triage
(``triage.minimize``, ``SweepResult.minimize``, ``triage.triage``, the
repro bundles replayed by ``python -m madsim_tpu_torch.obs replay``) and
the sweep observatory (``sweep(observe=..., profile_dir=...)``); then the
actor compiler's checks (speclint and protocol cards, ``check_actor`` over
every family, the host-twin ``crosscheck`` held to the kernel, compiled-
family repro bundles); then the fleet (``SweepSession.run_group``,
``fleet.fleet_sweep`` inline under chaos, with the corpus exchange, and
with spawned worker processes); then the bridge's decision kernel
(``madsim_tpu_torch.bridge.BridgeKernel``: ``step``, ``drain``,
``reset_slot(s)``, ``metrics``); then the world-axis split
(``sweep(mesh=seed_mesh(...))``, ``multihost_mesh``, ``minimize(mesh=)``,
``SweepSession(mesh=)``, ``fleet_sweep(mesh=)``) and the program checks
(``python -m madsim_tpu_torch.analysis trace``). Phases, in order; any
failure exits non-zero:

1. card: name and power limit; uint32 <-> int64 round trip on CUDA tensors;
2. build: one nvcc per source (``step_raft.cu``, ``step_tpc.cu``,
   ``step_pb.cu``, ``step_paxos.cu``, ``step_pair.cu``, ``corpus_fold.cu``,
   ``bridge_step.cu``),
   all started together, with the ptxas register/spill report and the
   build time; fails unless every instantiation ``step_kernel<A, N>`` of
   both lane profiles (Raft, pb and Paxos N = 1..8, tpc N = 2..8, pair
   N = 1..12), every kernel of ``corpus_fold.cu`` (the fold, its
   chain yardstick, the empty launch) and both of ``bridge_step.cu`` (the
   round and the drain) has a 0-byte stack frame and no spills;
3. Threefry on the card: Random123 known answers and bitwise agreement with
   the plain torch version on 2^20 keys and counters;
4. kernel vs plain step, whole runs: six configurations at W=4096 (two of
   them at node counts and widths off the main path) and the two main-path
   deployments at their full W, every leaf compared bitwise after each of
   the first 64 steps, every 64th step after, and at the end; four of them
   again with the metrics block and/or the flight recorder written in the
   kernel (the hunt with kill/restart, the overflowing queue with a ring of
   5, sends saturating at INF_TIME, the odd widths) and the full-W hunt
   with both, each also held to a run with the lanes off on every other
   leaf; the families: tpc_crosscheck, pb_crosscheck and pb_hunt at
   W=4096 and at their main path's W=65,536, tpc with
   its coordinator killed and restarted, tpc at n = 8, and pb_hunt with
   the metrics block and a 64-deep ring (held also to its lanes-off run);
   then one step from a state whose frozen worlds were never checked by
   the invariant, with the lanes off and on; the guided search's
   families: Paxos (forgetful acceptors on and off) and the guided pair at
   n = 12 at their templates, pair-restart at n = 4 under
   ``pair_schedule``, and the guided pair and Paxos under per-slot
   ``(W, F, 4)`` schedules made by the port's ``make_children``, lanes off
   and on, at W=4096 and (``main_*``) W=65,536; the wide lane profile of
   every family (``:wide``: Raft under every fault op and at odd widths,
   tpc, pb, Paxos, both pair families, lanes off and on) at W=4096, and
   the Raft hunt at its full W, lanes off and on; then the corpus fold
   kernel against its plain version and its numpy model
   (``fold_kernel.fold_model``), bitwise on every corpus lane, the insert
   count and both masks: the Paxos hunt's folds at 8,192 and 32 slots
   with lineage lanes, timed per call, on the device alone and on the
   host, beside the bytes bound, the dependent chain of their rounds and
   inserts and the launch floor; and adversarial folds at K = 1, 16, 32,
   64 and 4,096 (duplicate and all-equal signatures, tied scores, unfilled
   entries, empty and full masks, every row inserting, the insert counter
   near 2^32, no lineage lanes, no rows);
5. held to JAX without JAX: observe() digests of seeds 0..63 equal the
   JAX-derived constants in ``madsim_tpu_torch/engine/golden.py``, with
   the lanes off and on, and so does the SweepResult of a small recycled
   sweep with both on (through each of the three loops, the fused one's
   ``world_utilization`` exempt), the families' three deployments, the
   guided search's two deployments at their templates, and one
   deployment of each family in the wide profile;
6. the main path at full size: the headline deployment at W=524,288 and the
   bug hunt at W=65,536, init and run timed apart (best of 3), the kernel's
   launches counted; the kernel's device time per step over the same
   launches, held against the bytes this run's steps need (and PR 1's
   least-traffic count beside it), the share of active worlds in each
   timed chunk, and the run's device idle share, beside a run loop that
   syncs with the host every 16 launches; then the same
   timing at 64, 128 and 256 worlds per block (where the tiles fit), each
   run's observations held to the main run's; then each family deployment
   at W=65,536 the same way (init and run best of 3, the launches, the
   kernel's time per step over the run's own launches against the bytes
   the family's steps need, the active share by chunk, the plain step),
   the guided search's two deployments (Paxos and the guided pair at
   their templates) among them; then every deployment in the wide lane
   profile (the kernel's time per step against its bound, the state
   bytes per world beside the packed profile's);
7. the bug hunt's sweep at full width (65,536 seeds), ``sweep(...,
   pipeline=False)`` as bench.py's legs run it, and then through the
   pipelined and the fused loop, each held to the serial run: (a)
   recycled through 8,192 slots, stopping at the first bug, timed, with
   its chunks' kernel device time and the device idle share; (b) every
   seed swept to retirement with metrics on, each observation equal to a
   monolithic ``init`` + ``run`` and the coverage ledger equal to the fold
   of its signatures; (c) the monolithic hunt with a 64-deep ring: the bug
   vector of the off run, a failing seed's decoded ring the suffix of
   ``trace()`` on the card, and the kernel's time and needed-bytes bound
   with the ring and the metrics off and on, and the state bytes per world
   they take; (d) the pb hunt recycled to its first bug over 65,536
   seeds, whose first failing seed fails again in an independent
   ``init`` + ``run``;
8. the guided hunts, each through the serial, the pipelined and the fused
   loop: (a) the three canonical hunts of bench.py's guided_hunt leg
   (pair, raft, Paxos; ``search/hunts.py``) at 512 seeds, guided and
   random, each held to the JAX pins of ``golden.HUNT_PINS`` (seeds to the
   first bug, bugs found, generations, corpus size, ancestry depth,
   operator table, digest of the schedules and the corpus), with its wall
   time, seeds/s, refills, ``_fetch`` calls, the searcher's and the fold
   kernel's ms and the device idle share, and one fold launch per guided
   refill (none in a random hunt); (b) the Paxos hunt at the width
   of phase 7's sweeps (65,536 seeds through 8,192 slots), guided, to its
   first bug, which fails again in an independent ``init`` + ``run`` under
   the schedule the search materialized for it;
9. checkpoints and the crosscheck on the card: (a) phase 7's sweep (b)
   with a checkpoint writer every 4 chunks, serial and pipelined, each
   equal to the unbroken sweep and timed beside the same loop without a
   writer, with the snapshots written, their bytes and write times, and
   the states the writer was handed held to synchronous copies taken at
   the same submits (serial); (b) the same sweep cut at chunk 20 and
   resumed in a fresh engine, in both loops; (c) the guided Paxos hunt of
   phase 8 cut after its second refill and resumed in a fresh engine, in
   both loops, holding the JAX pins, and ``fused=True`` refusing a
   ``checkpoint_path``; (d) ``crosscheck_backends``, CUDA against the
   CPU at W=1,024, on the Raft hunt with kill/restart, the pb hunt and
   Paxos in the wide profile, and a checkpoint written on the card loaded
   in a CPU engine, both then 64 steps on; (e) the kernel against the
   plain step with ``sequential_insert=True`` (the Raft hunt with
   kill/restart, tpc) at W=4096, and both against the run without it;
10. triage and the observatory on the card: (a) bench.py's minimize_bug
   leg at its width (``golden.MINIMIZE_BUG``: 64 rows, the bug needing
   rows 10 and 42, seed 7) in the serial and the pipelined loop, each
   round one sweep, the result exactly the two rows and its history the
   JAX pin ``golden.GOLDEN_MINIMIZE``, with its rounds, candidates,
   launches and wall; (b) tools/triage_demo.py's path (inject, hunt,
   ``triage(result, out_dir)``), with metrics and with metrics and a
   ring: one class minimized to its two rows, its bundle replayed through
   the CLI in this process and in a fresh one, to the invariant raise,
   the ring bitwise the replayed trace's suffix (``--crosscheck``); (c)
   phase 7's sweep (b) under the hunt's kill/restart schedule with the
   64-deep ring: ``triage(result, minimize=False)``'s classes, the first
   failing seed minimized in both loops (equal), the first class's
   bundle replayed and crosschecked in this process and in a fresh one;
   (d) phase 7's sweep (b) and phase 8's guided Paxos hunt with
   ``observe=<jsonl>`` in each loop, beside the same call without it
   (in turns): the same result, ``_fetch`` calls, flag reads, step
   launches and folds; the records parse, one per scalar read and the
   summary with ``loop_stats``, and ``watch`` renders them; then sweep
   (b) with ``profile_dir=``, whose ``torch.profiler`` trace names the
   step kernel's launches; and phase 10's own time.
11. the actor compiler's checks on the card: (a) speclint — the nine
   golden fixtures' findings (``tests/fixtures/speclint``, loaded against
   the port's spec model) equal the JAX-derived ``golden.GOLDEN_SPECLINT``
   in rule, path, line and message; the shipped specs and their bug
   variants lint clean and pass ``CompiledActor``'s gate, their protocol
   cards' sha256 ``golden.GOLDEN_CARDS``; (b) ``check_actor`` over every
   registered family (Raft, tpc, pb, Paxos, pair_restart, guided_pair)
   through the kernel at tests/test_conformance.py's shape (32 worlds,
   3,000 steps), each report ``golden.GOLDEN_CHECK_ACTOR``, then at
   W_FAMILY worlds with the family's canonical config unchanged (every
   check passes there too), each with its wall; (c) the host-twin ``crosscheck`` of tpc, pb and Paxos at
   tests/test_actorc.py's seeds and faults (250 steps) and at 64 seeds
   and 400 steps, each report ``golden.GOLDEN_CROSSCHECK``, every
   recorded step held to the host twin and, bitwise on every leaf, to a
   twin state stepped by the kernel (one launch per step), with its
   device pass and host comparison timed apart; a twin step changed
   after a launch is caught; (d) the pb hunt to retirement and the wide
   guided Paxos hunt (W_FAMILY seeds through 8,192 slots, metrics and a
   64-deep ring), ``triage(out_dir=...)``: every bundle carries the JAX
   protocol card, and one bundle of each replays in a fresh process
   (``--crosscheck``) to the invariant raise; and phase 11's own time.
12. the fleet on the card, over the Raft hunt (bench.py:1000-1080,
   metrics on, chunks of 64): (a) ``SweepSession.run_group`` twice, four
   8,192-seed ranges each (a 32,768-world standing batch; the second group
   on the recycled slots), each range equal to its solo ``sweep()`` by
   ``contract_mismatches``, the grouped ``_fetch`` calls at most the solo
   ones; (b) ``fleet_sweep`` of 65,536 seeds in 8 ranges on 2 workers,
   clean and under tests/test_fleet.py's chaos (a kill, a preemption,
   duplicated completions, dropped RPCs and heartbeats, a checkpoint
   directory), each equal to the single-host sweep, every chaos counter
   fired, the walls against the single-host sweep's; (c) tpc_crosscheck
   and pb_hunt at 8,192 seeds in 4 ranges, chaotic, each equal to its
   single-host sweep; (d) bench.py's guided_fleet (the pair hunt, 512
   seeds in ranges of 64), independent, exchanged and exchanged under
   chaos (a kill, a torn publish, duplicates): chaotic equal to clean on
   schedules, the merged corpus and lineage, the pins the JAX-derived
   ``golden.GOLDEN_GUIDED_FLEET``; the fold kernel equal to
   ``host_harvest_fold`` on 12 random folds and on every merge the
   exchange made; (e) ``spawn="process"``: 2 workers on CUDA, 16,384 seeds
   in 4 ranges, w0 SIGKILLed and w1 SIGTERMed by the parent, equal to the
   single-host sweep, each worker's library load (no ``nvcc``) and step
   launches as it reported them; (f) tests/test_fleet.py's chaotic 64-seed
   fleet against the JAX-derived ``golden.GOLDEN_FLEET_RAFT``; and phase
   12's own time.
13. the bridge decision kernel on the card (``cap=128``, ``k_events=4``):
   (a) ``BridgeKernel(device="cuda")`` driven by the synthetic realistic
   and edge streams (``bridge/synthetic.py``) at W=512 and 4,096, metrics
   off and on, in lockstep with the plain version on the CPU: every
   StepOut and DrainOut field, the clock, the lanes ``[:, :cap]`` and the
   metrics equal after every round and drain, and each stream's digest
   equal to the JAX-derived ``bridge.golden.GOLDEN_BRIDGE``; (b) the three
   recorded JAX ``bridge.sweep`` streams (ping-pong, chaos at k=1, the
   drain world at k=2; 512 seeds) replayed open-loop, every output and
   the final state equal to JAX's; the launches and host-device copies
   of (a) and (b); (c) each kernel's device time (launches queued behind
   a sleep) at W=512 and 4,096 beside its bound (the bytes this data
   needs: every deadline read once, the batch, the outputs and the slots
   written), the launch floor (an empty kernel on the same grid, queued
   the same way), the worlds a block and the plain version's time on the
   card, the wall per round of ``BridgeKernel.step`` and ``.drain`` on
   CUDA and on the CPU at W=64, 512 and 4,096 on the synthetic realistic
   stream, the median split of a CUDA round's and drain's wall there
   (staging, the copies' enqueues, the launch, the wait, the output), and
   the wall per call on the three recorded sweeps (W=512), each with the
   card's name and power limit; and phase 13's own time.
14. the world-axis split on the card, each leg timed: (a) phase 7's sweep
   (b) (65,536 seeds through 8,192 slots, metrics on) on ``seed_mesh()``
   equal to ``mesh=None`` on every SweepResult field in the serial,
   pipelined and fused loops; (b) the same sweep split 4 ways over the one
   card (``seed_mesh(devices=[cuda:0] * 4)``) and on
   ``multihost_mesh(devices=[cuda:0] * 4, n_hosts=2)``: bug, observations
   and coverage equal to (a), the two meshes equal on every field,
   ``n_devices`` 4, every launch a block of 2,048 worlds (the serial
   loop's launches 4 a step), ``_fetch`` calls per chunk no more than one
   device's; (c) 64 seeds through 32 slots (the hunt at 0.4 s with a
   kill and a restart) on 4 blocks of the card equal to 4 blocks of the
   CPU on every field, in each loop; (d) phase 8's guided Paxos hunt (512
   seeds) on 4 blocks holding the JAX pins, one fold launch a refill, and
   at 64 seeds (8 chunks) equal to the CPU's 4 blocks on every field and
   the search report; (e) ``minimize`` of ``golden.MINIMIZE_BUG`` on 4
   blocks (the JAX pin), ``SweepSession.run_group`` twice on 4 blocks
   and a clean ``fleet_sweep`` on (2, 2), each equal to one device; (f)
   ``python -m madsim_tpu_torch.analysis trace`` exits 0 (started with
   the phase, in a process of its own), its line per program logged; and
   phase 14's own time.

The last line of standard output is ``{"ok": true, "device": {...}}``; the
line before it lists each kernel route (the step kernel with Raft's, tpc's,
pb's, Paxos's and the pair families' policy, in each lane profile, the
corpus fold kernel, and the bridge's round and drain) with its launches
(phases 10's, 11's, 12's and 14's among them, the spawned fleet workers'
as they reported them) and times.

Usage: python3 chip_smoke.py   (from the root of the repository)
"""
from __future__ import annotations

import dataclasses
import importlib
import json
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
W_COMPARE = 4096
# Worlds of each compiled family's deployment at full size (bench.py's
# crosscheck legs run at most 1,024; 65,536 is the hunt's width).
W_FAMILY = 65_536
COMPARE_EVERY_STEP = 64
TIMED_STEPS = 100
# A sleep the device runs while the host queues a chunk of timed launches
# behind it: about 0.1 s at the H100's 1.98 GHz boost clock.
SLEEP_CYCLES = 200_000_000
# Worlds of the corpus fold kernel's comparisons: the wide hunt's slots
# and the canonical hunts' (search/hunts.py).
FOLD_WIDE, FOLD_NARROW = 8192, 32
# Folds queued behind a sleeping kernel to time the fold kernel on the
# device alone, and the corpus sizes of its adversarial comparisons (the
# hunts' 16, 32 and 64, and the kernel's bounds).
FOLD_QUEUED = 20
# Back-to-back folds whose host time per call is the wrapper's.
FOLD_HOST_CALLS = 200
FOLD_KS = (1, 16, 32, 64, 4096)
# Worlds per CUDA block timed against each other in phase 6.
BLOCK_SWEEP = (64, 128, 256)


class PhaseError(RuntimeError):
    pass


def ptxas_report(text, kernel):
    """ptxas -v figures (stack frame, spill stores, spill loads, registers)
    of each function whose mangled name nests the identifier ``kernel`` (one
    per template instantiation), by mangled name."""
    tag = f"{len(kernel)}{kernel}"  # Itanium mangling: <length><name>
    lines = text.splitlines()
    out = {}
    for i, line in enumerate(lines):
        if "Function properties for" not in line:
            continue
        name = line.split("Function properties for", 1)[1].strip()
        if tag + "E" not in name and tag + "I" not in name:
            continue
        figs = {}
        for nxt in lines[i + 1:i + 4]:
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", nxt)
            if m:
                figs.update(stack=int(m[1]), spill_stores=int(m[2]),
                            spill_loads=int(m[3]))
            m = re.search(r"Used (\d+) registers", nxt)
            if m:
                figs["registers"] = int(m[1])
        out[name] = figs
    return out


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def log(msg):
    print(msg, flush=True)


def phase_11(dev, w_wide=None, paxos_failing=None, replay_args=()):
    """Phase 11: the actor compiler's checks on ``dev`` (see the module
    docstring). ``w_wide``: the worlds of (b)'s wide runs and (d)'s hunts
    (default W_FAMILY); ``paxos_failing``: phase 8's wide Paxos hunt's
    failing seeds, which (d)'s hunt with a ring must reproduce;
    ``replay_args``: appended to each fresh-process replay. Returns the
    step kernel's launches by route and the fold kernel's launches, each
    counted from 0 and read after the phase's last leg."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from madsim_tpu_torch.actorc import CompiledActor, HostTwinMismatch
    from madsim_tpu_torch.actorc import conformance as conf_mod
    from madsim_tpu_torch.actorc import crosscheck
    from madsim_tpu_torch.analysis import speclint
    from madsim_tpu_torch.engine import (DeviceEngine, EngineConfig,
                                         check_actor, golden, step_kernel)
    from madsim_tpu_torch.engine.families import actor_families, family
    from madsim_tpu_torch.obs.bundle import load_bundle
    from madsim_tpu_torch.parallel.sweep import sweep
    from madsim_tpu_torch.search import fold_kernel, hunts
    from madsim_tpu_torch.triage import triage

    w_wide = w_wide or W_FAMILY
    t11 = time.perf_counter()
    route = {"raft": "raft", "tpc": "tpc", "pb": "pb", "paxos": "paxos",
             "pair_restart": "pair", "guided_pair": "pair"}
    launches = dict.fromkeys(("raft", "tpc", "pb", "paxos", "pair"), 0)
    folds = 0
    step_kernel.launches = fold_kernel.launches = 0

    def take(r):
        """Add the launches since the last take to route ``r``; returns
        them."""
        nonlocal folds
        n = step_kernel.launches
        launches[r] += n
        folds += fold_kernel.launches
        step_kernel.launches = fold_kernel.launches = 0
        return n

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    # (a) speclint: the golden fixtures, the shipped specs and their bug
    # variants, the protocol cards.
    t0 = time.perf_counter()
    for name, (rules, digest) in sorted(golden.GOLDEN_SPECLINT.items()):
        mod = golden.speclint_fixture(os.path.join(
            HERE, golden.SPECLINT_DIR, name + ".py"))
        fs = speclint.lint_spec(mod.build(), root=HERE)
        check(tuple(f.rule for f in fs) == rules
              and golden.findings_digest(fs) == digest,
              f"speclint: fixture {name}: findings differ from the JAX "
              f"golden:\n" + "\n".join(f.render() for f in fs))
    check(speclint.run_spec_pass(root=HERE) == [],
          "speclint: a shipped spec has findings")
    for name in sorted(golden.CARD_SPECS):
        spec = golden.card_spec(name)
        check(speclint.lint_spec(spec, root=HERE) == [],
              f"speclint: spec {name} has findings")
        check(golden.card_digest(speclint.protocol_card(spec))
              == golden.GOLDEN_CARDS[name],
              f"speclint: the protocol card of {name} differs from JAX's")
        CompiledActor(spec)   # the compile gate passes it
    log(f"[11 speclint a] {len(golden.GOLDEN_SPECLINT)} fixtures' findings "
        f"equal the JAX goldens (rule, path, line, message); the shipped "
        f"specs and {len(golden.CARD_SPECS)} variants lint clean and pass "
        f"the compile gate, their protocol cards' sha256 the JAX goldens; "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms")

    # (b) check_actor over every registered family through the kernel: at
    # tests/test_conformance.py's shape, held to the JAX golden, then at
    # w_wide worlds with the same canonical config.
    shape = golden.CHECK_ACTOR_SHAPE
    for name, fam in sorted(actor_families().items()):
        actor, cfg = fam.conformance()
        sync()
        t0 = time.perf_counter()
        rep = check_actor(actor, cfg, require_divergence=fam.divergent,
                          device=dev, **shape)
        sync()
        wall = time.perf_counter() - t0
        n = take(route[name])
        check(rep == golden.GOLDEN_CHECK_ACTOR[name],
              f"check_actor {name}: {rep} is not JAX's "
              f"{golden.GOLDEN_CHECK_ACTOR[name]}")
        check(n > 0, f"check_actor {name}: the step kernel never launched")
        actor, cfg = fam.conformance()
        sync()
        t0 = time.perf_counter()
        wide = check_actor(actor, cfg, n_worlds=w_wide,
                           max_steps=shape["max_steps"],
                           require_divergence=fam.divergent, device=dev)
        sync()
        wall_w = time.perf_counter() - t0
        n_w = take(route[name])
        check(wide["bug_rate"] == 0.0 and n_w > 0,
              f"check_actor {name} at {w_wide} worlds: {wide}")
        log(f"[11 check_actor b] {name} ({cfg.n_nodes} nodes, "
            f"Q={cfg.queue_cap}): at {shape['n_worlds']} worlds and "
            f"{shape['max_steps']} steps the JAX report {rep} in "
            f"{wall * 1e3:.1f} ms, {n} step launches; at {w_wide} worlds "
            f"{wide} in {wall_w * 1e3:.1f} ms, {n_w} step launches")

    # (c) the host-twin crosscheck: each step recorded by the plain step on
    # the card, held to the host twin and to a twin state stepped by the
    # kernel (one launch per step; the engines' actors are the family
    # classes, which the kernel has policies for); the reports JAX's.
    real_record = conf_mod._record
    rec_s = []

    def timed_record(*a, **k):
        sync()
        t0 = time.perf_counter()
        out = real_record(*a, **k)
        rec_s.append(time.perf_counter() - t0)
        return out

    conf_mod._record = timed_record
    try:
        for name in ("tpc", "pb", "paxos", "tpc:64", "pb:64", "paxos:64"):
            actor, cfg, seeds, faults, steps = golden.crosscheck_case(name)
            eng = DeviceEngine(actor, cfg, device=dev)
            sync()
            t0 = time.perf_counter()
            rep = crosscheck(actor.spec, cfg, seeds=seeds, faults=faults,
                             max_steps=steps, engine=eng)
            wall = time.perf_counter() - t0
            n = take(name.split(":")[0])
            check(rep == golden.GOLDEN_CROSSCHECK[name],
                  f"crosscheck {name}: {rep} is not JAX's "
                  f"{golden.GOLDEN_CROSSCHECK[name]}")
            check(n == steps, f"crosscheck {name}: {n} kernel launches "
                  f"for {steps} recorded steps")
            log(f"[11 crosscheck c] {name}: {len(seeds)} seeds x {steps} "
                f"steps, the JAX report {rep}; every step's state held "
                f"bitwise to the host twin and to the kernel ({n} "
                f"launches); wall {wall:.2f} s, of it the device pass "
                f"{rec_s[-1]:.2f} s and the host's comparison "
                f"{wall - rec_s[-1]:.2f} s")
    finally:
        conf_mod._record = real_record
    # The kernel leg catches a kernel step that differs: a twin engine
    # whose seventh launch is followed by a change of one lane.
    actor, cfg, seeds, faults, _steps = golden.crosscheck_case("tpc")
    eng = DeviceEngine(actor, cfg, device=dev)
    real_run_steps = eng.run_steps
    calls = [0]

    def nudged(state, k, gate=None):
        real_run_steps(state, k, gate)
        calls[0] += 1
        if calls[0] == 7:
            state.astate["txns_seen"].add_(1)
        return state

    eng.run_steps = nudged
    caught = None
    try:
        crosscheck(actor.spec, cfg, seeds=seeds, faults=faults,
                   max_steps=20, engine=eng)
    except HostTwinMismatch as exc:
        caught = str(exc)
    take("tpc")
    check(caught is not None and "step 6: the CUDA step kernel diverged "
          "from the plain step at lane 'astate.txns_seen'" in caught,
          f"crosscheck: a changed kernel step was not caught ({caught})")
    log(f"[11 crosscheck c] a twin step changed after launch 7 is caught: "
        f"{caught.splitlines()[0]}")

    # (d) compiled-family repro bundles: the pb hunt to retirement and the
    # wide guided Paxos hunt, each with metrics and a 64-deep ring, then
    # triage(out_dir=...); each bundle carries the JAX protocol card, and
    # one bundle of each replays in a fresh process (--crosscheck).
    work = tempfile.mkdtemp(prefix=".actorc_", dir=HERE)
    try:
        fam, ak, ck, faults, max_steps = golden.FAMILY_CONFIGS["pb_hunt"]
        tf = family(fam)
        eng = DeviceEngine(tf.actor_cls(tf.config_cls(**ak)),
                           EngineConfig(**dict(ck, metrics=True,
                                               blackbox=64)), device=dev)
        leg = dict(chunk_steps=64, max_steps=max_steps, recycle=True,
                   batch_worlds=min(8192, w_wide), pipeline=False,
                   faults=np.asarray(faults, np.int32))
        hunt = hunts.paxos_hunt()
        cfg_px = dataclasses.replace(hunt.cfg, blackbox=64)
        eng_px = DeviceEngine(hunt.actor, cfg_px, device=dev)
        leg_px = dict(faults=hunt.template, search=hunt.search(True),
                      recycle=True, batch_worlds=min(8192, w_wide),
                      chunk_steps=64, max_steps=50_000_000,
                      stop_on_first_bug=True, pipeline=False)
        for label, e, kw, r, card in (
                ("pb_hunt", eng, leg, "pb", "pb_hunt"),
                ("wide Paxos hunt", eng_px, leg_px, "paxos", "paxos_hunt")):
            out = os.path.join(work, r)
            os.makedirs(out)
            sync()
            t0 = time.perf_counter()
            res = sweep(None, e.cfg, np.arange(w_wide), engine=e, **kw)
            sync()
            wall_s = time.perf_counter() - t0
            check(res.failing_seeds, f"{label}: no bug found")
            if r == "paxos" and paxos_failing is not None:
                check(list(res.failing_seeds) == list(paxos_failing),
                      f"{label}: the ring changed the failing seeds")
            t0 = time.perf_counter()
            rep = triage(res, out_dir=out, minimize=False,
                         max_steps=100_000)
            wall_t = time.perf_counter() - t0
            check(rep.bundles and len(rep.bundles) == len(rep.classes),
                  f"{label}: {len(rep.bundles)} bundles for "
                  f"{len(rep.classes)} classes")
            for key, path in rep.bundles.items():
                b = load_bundle(path)
                check(golden.card_digest(b["extra"]["protocol_card"])
                      == golden.GOLDEN_CARDS[card],
                      f"{label}: bundle {key}'s protocol card is not JAX's")
            path = rep.bundles[rep.classes[0].key]
            trace_out = os.path.join(out, "trace.json")
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "madsim_tpu_torch.obs", "replay",
                 "--bundle", path, "--out", trace_out, "--crosscheck",
                 *replay_args], cwd=HERE,
                env=dict(os.environ, PYTHONPATH=HERE), capture_output=True,
                text=True, timeout=300)
            wall_r = time.perf_counter() - t0
            with open(trace_out, encoding="utf-8") as f:
                events = json.load(f)["traceEvents"]
            check(proc.returncode == 0 and "invariant RAISED" in proc.stderr
                  and "bitwise the suffix" in proc.stderr
                  and events[-1]["name"] == "invariant:raise",
                  f"{label}: the bundle's replay in a fresh process: rc "
                  f"{proc.returncode}: {proc.stderr[-600:]}")
            n = take(r)
            log(f"[11 bundles d] {label}, {w_wide} seeds through "
                f"{kw['batch_worlds']} slots, metrics and a 64-deep ring: "
                f"{len(res.failing_seeds)} failing in {wall_s * 1e3:.1f} ms; "
                f"triage(out_dir=..., minimize=False): {len(rep.classes)} "
                f"classes, {len(rep.bundles)} bundles in {wall_t * 1e3:.1f} "
                f"ms, each with the JAX protocol card; class "
                f"{rep.classes[0].key} (seed {rep.classes[0].representative})"
                f" replayed in a fresh process with --crosscheck: rc 0, the "
                f"invariant raised, the ring bitwise the replayed trace's "
                f"suffix, in {wall_r:.1f} s; {n} step launches")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"[11] phase 11 took {time.perf_counter() - t11:.1f} s; its step "
        f"kernel launches by route {launches}, fold launches {folds}")
    return launches, folds


def phase_12(dev, w_range=8192, fam_range=2048, proc_range=4096,
             lease_ttl=3.0):
    """Phase 12: the fleet on ``dev`` (see the module docstring).
    ``w_range``: the seeds of each range of (a)'s groups and (b)'s fleets
    (8 ranges in all); ``fam_range``: of each of (c)'s 4 ranges;
    ``proc_range``: of each of (e)'s 4 ranges, whose workers' leases expire
    after ``lease_ttl`` s. Returns the step kernel's launches by route and
    the fold kernel's launches in this process, each counted from 0 and
    read after the phase's last leg, and the step launches the process
    leg's workers reported."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from madsim_tpu_torch.engine import (DeviceEngine, EngineConfig,
                                         RaftActor, RaftDeviceConfig, golden,
                                         step_kernel)
    from madsim_tpu_torch.engine.families import family
    from madsim_tpu_torch.fleet import ChaosConfig, ExchangeConfig
    from madsim_tpu_torch.fleet import exchange as exchange_mod
    from madsim_tpu_torch.fleet import fleet_sweep
    from madsim_tpu_torch.fleet.merge import contract_mismatches
    from madsim_tpu_torch.parallel import SweepSession
    from madsim_tpu_torch.search import fold_kernel, hunts
    from madsim_tpu_torch.search.corpus import (corpus_init,
                                                corpus_to_device,
                                                harvest_fold,
                                                host_corpus_init,
                                                host_harvest_fold)
    sweep_mod = importlib.import_module("madsim_tpu_torch.parallel.sweep")

    t12 = time.perf_counter()
    cuda = dev.type == "cuda"
    launches = dict.fromkeys(("raft", "tpc", "pb", "pair"), 0)
    folds = 0
    step_kernel.launches = fold_kernel.launches = 0

    def take(r):
        """Add the launches since the last take to route ``r``; returns
        the step and fold launches."""
        nonlocal folds
        n, f = step_kernel.launches, fold_kernel.launches
        launches[r] += n
        folds += f
        step_kernel.launches = fold_kernel.launches = 0
        return n, f

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def timed(fn):
        """``fn()`` and its wall in s, the device synced on both sides."""
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, time.perf_counter() - t0

    def counted(fn):
        """``fn()``, its wall, and the sweep module's ``_fetch`` calls."""
        n = [0]
        real = sweep_mod._fetch

        def fetch(tree):
            n[0] += 1
            return real(tree)

        sweep_mod._fetch = fetch
        try:
            out, wall = timed(fn)
        finally:
            sweep_mod._fetch = real
        return out, wall, n[0]

    def same(a, b, tag):
        bad = contract_mismatches(a, b)
        check(not bad, f"{tag}: differs from the single-host sweep on "
              f"{', '.join(bad[:6])}")

    def fired(st, keys, tag):
        zero = [k for k in keys if not st.get(k)]
        check(not zero, f"{tag}: chaos counters that never fired: {zero}")

    chaos = ChaosConfig(**golden.FLEET_RAFT["chaos"])
    work = tempfile.mkdtemp(prefix=".fleet_", dir=HERE)
    try:
        # (a) the session: two run_group calls of four ranges each over
        # the Raft hunt (bench.py:1000-1080, metrics on), the second on
        # the recycled standing slots; each range against its solo sweep.
        hunt_rk = dict(n=3, buggy_double_vote=True)
        eng = DeviceEngine(RaftActor(RaftDeviceConfig(**hunt_rk)),
                           EngineConfig(**dict(
                               golden.CONFIGS["hunt_faults"][1],
                               metrics=True)), device=dev)
        kw = dict(chunk_steps=64, max_steps=4_000)
        n_all = 8 * w_range
        seeds = np.arange(n_all)
        sess = SweepSession(engine=eng, **kw)
        for gi in range(2):
            parts = [{"seeds": seeds[(4 * gi + r) * w_range:
                                     (4 * gi + r + 1) * w_range],
                      "faults": None} for r in range(4)]
            res, wall_g, f_g = counted(lambda: sess.run_group(parts))
            n_g, _ = take("raft")
            walls, f_solo = [], 0
            for part, r in zip(parts, res):
                solo, wall_s, f_s = counted(lambda: sweep_mod.sweep(
                    None, eng.cfg, part["seeds"], engine=eng, **kw))
                same(solo, r, f"[12 session a] group {gi}")
                walls.append(wall_s)
                f_solo += f_s
                check(r.loop_stats["session_reused_slots"] == (gi > 0),
                      "[12 session a] the standing slots were "
                      + ("not " if gi else "") + "recycled")
            n_s, _ = take("raft")
            check(f_g <= f_solo, f"[12 session a] group {gi}: {f_g} "
                  f"_fetch calls grouped against {f_solo} solo")
            check(not cuda or n_g > 0, "[12 session a] no step launch")
            ls = res[0].loop_stats
            log(f"[12 session a] group {gi} ({4 * w_range} worlds, "
                + ("recycled slots" if gi else "fresh install")
                + f"): 4 ranges each equal to its solo sweep "
                f"(contract_mismatches empty); wall {wall_g * 1e3:.1f} ms "
                f"against {sum(walls) * 1e3:.1f} ms for the 4 solo sweeps "
                f"({', '.join(f'{x * 1e3:.1f}' for x in walls)}); chunks "
                f"{ls['chunks']}, dispatches {ls['dispatches']}, _fetch "
                f"calls {f_g} grouped against {f_solo} solo, device flags "
                f"read {ls['flag_reads']}; step launches {n_g} grouped, "
                f"{n_s} solo")
        check(sess.reuse_hits == 7, f"[12 session a] reuse hits "
              f"{sess.reuse_hits}, expected 7")

        # (b) the inline fabric at full width: 8 ranges, 2 workers, clean
        # and under tests/test_fleet.py's chaos (with a checkpoint
        # directory), each against the single-host sweep.
        single, wall_1 = timed(lambda: sweep_mod.sweep(
            None, eng.cfg, seeds, engine=eng, **kw))
        n_1, _ = take("raft")
        log(f"[12 fabric b] single-host sweep of {n_all} seeds: wall "
            f"{wall_1 * 1e3:.1f} ms, {len(single.failing_seeds)} failing, "
            f"step launches {n_1}")
        for name, ch, ck in (("clean", None, None),
                             ("chaotic", chaos, os.path.join(work, "b"))):
            res, wall = timed(lambda: fleet_sweep(
                None, eng.cfg, seeds, engine=eng, n_workers=2,
                range_size=w_range, chaos=ch, checkpoint_dir=ck, **kw))
            n_b, _ = take("raft")
            same(single, res, f"[12 fabric b] {name}")
            st = res.loop_stats["fleet"]
            if ch is not None:
                fired(st, ("kills", "preemptions", "leases_expired",
                           "leases_reissued", "duplicate_completions",
                           "rpc_retries"), f"[12 fabric b] {name}")
                check(st["duplicates_crosschecked"]
                      == st["duplicate_completions"],
                      "[12 fabric b] a duplicate was not crosschecked")
            check(not cuda or n_b > 0, "[12 fabric b] no step launch")
            log(f"[12 fabric b] {name} fleet: equal to the single-host "
                f"sweep; wall {wall * 1e3:.1f} ms = {wall / wall_1:.2f}x "
                f"the single-host sweep's; leases {st['leases_issued']} "
                f"(reissued {st['leases_reissued']}, expired "
                f"{st['leases_expired']}), grouped leases "
                f"{st['grouped_leases']}, session reuse hits "
                f"{st['session_reuse_hits']}, control RPCs per lease "
                f"{st['control_rpcs_per_lease']} (all RPCs "
                f"{st['rpcs_per_lease']}), kills {st['kills']}, "
                f"preemptions {st['preemptions']}, duplicates "
                f"{st['duplicate_completions']}, RPC retries "
                f"{st['rpc_retries']}; acquire {st['acquire_s'] * 1e3:.1f} "
                f"ms, sweeps {st['sweep_s'] * 1e3:.1f} ms, merge "
                f"{st['merge_s'] * 1e3:.1f} ms; step launches {n_b}")

        # (c) the compiled families, chaotic: tpc_crosscheck and pb_hunt
        # over 4 ranges each.
        for name, route in (("tpc_crosscheck", "tpc"), ("pb_hunt", "pb")):
            fam, ak, ck, faults, max_steps = golden.FAMILY_CONFIGS[name]
            tf = family(fam)
            e = DeviceEngine(tf.actor_cls(tf.config_cls(**ak)),
                             EngineConfig(**ck), device=dev)
            fkw = dict(chunk_steps=64, max_steps=max_steps,
                       faults=(np.asarray(faults, np.int32)
                               if faults is not None else None))
            fseeds = np.arange(4 * fam_range)
            single_f, wall_f1 = timed(lambda: sweep_mod.sweep(
                None, e.cfg, fseeds, engine=e, **fkw))
            res, wall_f = timed(lambda: fleet_sweep(
                None, e.cfg, fseeds, engine=e, n_workers=2,
                range_size=fam_range, chaos=chaos, **fkw))
            n_c, _ = take(route)
            same(single_f, res, f"[12 families c] {name}")
            st = res.loop_stats["fleet"]
            check(not cuda or n_c > 0, f"[12 families c] {name}: no step "
                  f"launch")
            log(f"[12 families c] {name}: chaotic fleet of {len(fseeds)} "
                f"seeds in 4 ranges equal to the single-host sweep "
                f"({len(single_f.failing_seeds)} failing); wall "
                f"{wall_f * 1e3:.1f} ms against {wall_f1 * 1e3:.1f} ms; "
                f"kills {st['kills']}, preemptions {st['preemptions']}, "
                f"duplicates {st['duplicate_completions']}, reissued "
                f"{st['leases_reissued']}; step launches {n_c}")

        # (d) the corpus exchange: bench.py's guided_fleet (golden.
        # GUIDED_FLEET), independent, exchanged clean and exchanged under
        # chaos; every merge the exchange folds is recorded for the fold
        # kernel's comparison below.
        h = hunts.pair_hunt()
        eng_p = DeviceEngine(h.actor, h.cfg, device=dev)
        g = golden.GUIDED_FLEET
        gseeds = np.arange(g["budget"])
        gkw = dict(engine=eng_p, faults=h.template, search=h.search(True),
                   stop_on_first_bug=True, n_workers=g["n_workers"],
                   range_size=g["range_size"], **h.sweep_kw)
        xchaos = ChaosConfig(seed=7, kill_at=(("w1", 2),),
                             duplicate_all_completions=True,
                             tear_publish_at=(("w0", 1),),
                             drop_rpc_rate=0.2, restart_after=2)
        merges = []
        real_merge = exchange_mod.merge_corpus

        def recording(acc, src, min_novelty):
            out = real_merge(acc, src, min_novelty)
            merges.append((acc, src, min_novelty, out))
            return out

        exchange_mod.merge_corpus = recording
        try:
            runs = {}
            for name, ex, ch in (
                    ("independent", None, None),
                    ("exchanged", ExchangeConfig(every=g["every"]), None),
                    ("exchanged chaotic", ExchangeConfig(every=g["every"]),
                     xchaos)):
                res, wall = timed(lambda: fleet_sweep(
                    None, h.cfg, gseeds, exchange=ex, chaos=ch, **gkw))
                n_d, f_d = take("pair")
                runs[name] = (res, wall, n_d, f_d)
        finally:
            exchange_mod.merge_corpus = real_merge
        ind, exc, chx = (runs[k][0] for k in runs)
        pins = golden.guided_fleet_pins(ind, exc)
        check(pins == golden.GOLDEN_GUIDED_FLEET,
              f"[12 exchange d] the guided fleet's pins differ from JAX's:"
              f" {pins}")
        check(golden.fleet_digest(chx) == golden.fleet_digest(exc)
              and golden.search_digest(chx.search)
              == golden.search_digest(exc.search)
              and chx.search.operator_stats == exc.search.operator_stats
              and all(np.array_equal(getattr(chx.search.lineage, f),
                                      getattr(exc.search.lineage, f))
                      for f in ("parent1", "parent2", "ops", "depth")),
              "[12 exchange d] the chaotic exchanged fleet differs from "
              "the clean one")
        st = chx.loop_stats["fleet"]
        fired(st, ("kills", "leases_reissued", "publishes_torn",
                   "duplicate_completions"), "[12 exchange d] chaotic")
        check(not cuda or all(runs[k][3] > 0 for k in runs),
              "[12 exchange d] a guided fleet launched no fold")
        for name, (res, wall, n_d, f_d) in runs.items():
            s = res.loop_stats["fleet"]
            log(f"[12 exchange d] {name}: wall {wall * 1e3:.1f} ms, "
                f"{len(res.failing_seeds)} failing (first "
                f"{res.failing_seeds[:1]}), epochs merged "
                f"{s.get('epochs_merged', '-')}, publishes "
                f"{s.get('publishes', '-')} (torn "
                f"{s.get('publishes_torn', '-')}, duplicate "
                f"{s.get('publishes_duplicate', '-')}), kills {s['kills']}; "
                f"step launches {n_d}, fold launches {f_d}")
        log(f"[12 exchange d] pins equal JAX's (golden.GOLDEN_GUIDED_FLEET):"
            f" exchanged {pins['exchanged_seeds_to_bug']} seeds into its "
            f"range (global seed {pins['exchanged_first_global_seed']}), "
            f"independent {pins['independent_seeds_to_bug']}; chaotic "
            f"exchanged == clean on observations, schedules, the merged "
            f"corpus, lineage and operator stats")
        # The fold kernel against host_harvest_fold (the exchange's merge
        # fold): 12 random folds shaped as tests/test_exchange.py's, each
        # twice, and every merge this leg's exchange made. Their launches
        # are comparisons and are not counted.
        rng = np.random.RandomState(7)
        tmpl = h.template
        n_cmp = 0

        def kernel_vs_host(dc, hc, sched, sigs, mask, mn, entries, depths,
                           tag):
            def t(a):
                return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

            out = harvest_fold(dc, t(sched), t(sigs.astype(np.int64)),
                               t(mask), mn, entries=t(entries),
                               depths=t(depths), with_masks=True)
            want = host_harvest_fold(hc, sched, sigs, mask, mn,
                                     entries=entries, depths=depths,
                                     with_masks=True)
            for name in ("sched", "sig", "score", "filled", "entry",
                         "depth"):
                check(np.array_equal(
                    getattr(out[0], name).cpu().numpy().astype(np.int64),
                    np.asarray(getattr(want[0], name)).astype(np.int64)),
                    f"[12 fold d] {tag}: corpus lane {name} differs from "
                    f"host_harvest_fold")
            check(int(out[1]) == want[1]
                  and np.array_equal(out[2].cpu().numpy(), want[2])
                  and np.array_equal(out[3].cpu().numpy(), want[3]),
                  f"[12 fold d] {tag}: the insert count or a mask differs")
            return out[0], want[0]

        for trial in range(12):
            k = int(rng.randint(1, 7))
            w = int(rng.randint(1, 9))
            mn = int(rng.randint(1, 5))
            sched = rng.randint(-1, 60, size=(w, tmpl.shape[0], 4)) \
                .astype(np.int32)
            mask = rng.rand(w) < 0.7
            entries = rng.randint(1, 500, size=(w,)).astype(np.int32)
            depths = rng.randint(0, 9, size=(w,)).astype(np.int32)
            dc = corpus_init(k, tmpl, device=dev)
            hc = host_corpus_init(k, tmpl)
            for rnd in range(2):
                sigs = rng.randint(0, 2**32, size=(w,),
                                   dtype=np.uint64).astype(np.uint32)
                dc, hc = kernel_vs_host(dc, hc, sched, sigs, mask, mn,
                                        entries, depths,
                                        f"random fold {trial}.{rnd}")
                n_cmp += 1
        for i, (acc, src, mn, _out) in enumerate(merges):
            kernel_vs_host(corpus_to_device(acc, 0, 0, dev), acc,
                           np.asarray(src.sched, np.int32),
                           np.asarray(src.sig, np.uint32),
                           np.asarray(src.filled, bool), mn,
                           np.asarray(src.entry, np.int32),
                           np.asarray(src.depth, np.int32), f"merge {i}")
        check(not cuda or fold_kernel.launches == n_cmp + len(merges),
              f"[12 fold d] {fold_kernel.launches} fold launches for "
              f"{n_cmp + len(merges)} comparisons")
        fold_kernel.launches = 0
        log(f"[12 fold d] the fold kernel equals host_harvest_fold (every "
            f"corpus lane, the insert count, both masks) on {n_cmp} random "
            f"folds and on the {len(merges)} merges of this leg's "
            f"exchanges")

        # (e) real processes: spawned workers on the card, one SIGKILLed
        # and one SIGTERMed by the parent.
        pseeds = np.arange(4 * proc_range)
        single_p, _ = timed(lambda: sweep_mod.sweep(
            None, eng.cfg, pseeds, engine=eng, **kw))
        take("raft")
        if cuda:
            torch.cuda.empty_cache()
        recs = []
        res_p, wall_p = timed(lambda: fleet_sweep(
            RaftActor(RaftDeviceConfig(**hunt_rk)), eng.cfg, pseeds,
            n_workers=2, range_size=proc_range, spawn="process",
            device=None if cuda else "cpu", lease_ttl=lease_ttl,
            checkpoint_dir=os.path.join(work, "e"), observe=recs.append,
            kill_after_heartbeats={"w0": 2},
            preempt_after_heartbeats={"w1": 3}, serve_timeout_s=600.0,
            **kw))
        same(single_p, res_p, "[12 process e]")
        st = res_p.loop_stats["fleet"]
        check(st["restarts"].get("w0", 0) >= 1 and st["leases_expired"] >= 1
              and st["leases_released"] >= 1,
              f"[12 process e] the kill and the preemption did not both "
              f"land: restarts {st['restarts']}, expired "
              f"{st['leases_expired']}, released {st['leases_released']}")
        proc_launches = 0
        lives = []
        for wid, rep in sorted(st["worker_reports"].items()):
            for life in rep["lives"]:
                if cuda:
                    check(life.get("device", "").startswith("cuda"),
                          f"[12 process e] {wid} ran on {life.get('device')}")
                    check(all(v == 0.0 for v in life["nvcc_s"].values()),
                          f"[12 process e] {wid} ran nvcc: "
                          f"{life['nvcc_s']}")
                proc_launches += life.get("step_launches", 0)
                lives.append(f"{wid} pid {life['pid']}: load "
                             f"{life.get('load_s', 0.0) * 1e3:.1f} ms, nvcc "
                             f"{life.get('nvcc_s', {})}, step launches "
                             f"{life.get('step_launches', 'none reported')}")
        resumed = sum(1 for r in recs if r.get("event") == "lease_issued"
                      and r.get("resume_checkpoint"))
        check(not cuda or proc_launches > 0,
              "[12 process e] the workers reported no step launch")
        log(f"[12 process e] {len(pseeds)} seeds in 4 ranges, 2 spawned "
            f"workers on {'CUDA' if cuda else dev}, w0 SIGKILLed at its 2nd "
            f"heartbeat and respawned, w1 SIGTERMed at its 3rd: equal to "
            f"the single-host sweep; wall {wall_p:.2f} s with the spawns; "
            f"restarts {st['restarts']}, leases {st['leases_issued']} "
            f"(expired {st['leases_expired']}, released "
            f"{st['leases_released']}, {resumed} issued with a checkpoint "
            f"to resume); workers: " + "; ".join(lives))

        # (f) held to JAX without JAX: tests/test_fleet.py's chaotic Raft
        # fleet (golden.FLEET_RAFT) against golden.GOLDEN_FLEET_RAFT.
        fr = golden.FLEET_RAFT
        eng_f = DeviceEngine(RaftActor(RaftDeviceConfig(**fr["raft"])),
                             EngineConfig(**fr["engine"]), device=dev)
        res_f, wall = timed(lambda: fleet_sweep(
            None, eng_f.cfg, np.arange(fr["n_seeds"]), engine=eng_f,
            n_workers=fr["n_workers"], range_size=fr["range_size"],
            chaos=chaos, checkpoint_dir=os.path.join(work, "f"),
            **fr["sweep_kw"]))
        n_f, _ = take("raft")
        check(golden.fleet_digest(res_f) == golden.GOLDEN_FLEET_RAFT,
              "[12 golden f] the chaotic Raft fleet's digest differs from "
              "JAX's")
        log(f"[12 golden f] tests/test_fleet.py's chaotic fleet "
            f"({fr['n_seeds']} seeds, ranges of {fr['range_size']}): "
            f"fleet_digest equals golden.GOLDEN_FLEET_RAFT; "
            f"{len(res_f.failing_seeds)} failing, kills "
            f"{res_f.loop_stats['fleet']['kills']}; wall {wall * 1e3:.1f} "
            f"ms; step launches {n_f}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"[12] phase 12 took {time.perf_counter() - t12:.1f} s; its step "
        f"kernel launches by route {launches}, fold launches {folds}, and "
        f"the process leg's workers' step launches {proc_launches}")
    return launches, folds, proc_launches


def phase_13(dev, widths=(512, 4096), wall_widths=(64, 512, 4096),
             card=""):
    """Phase 13: the bridge decision kernel on ``dev`` (see the module
    docstring). ``widths``: the W of (a)'s synthetic streams (each held to
    ``bridge.golden.GOLDEN_BRIDGE`` where it has that W) and of (c)'s
    device times; ``wall_widths``: the W of (c)'s walls per round;
    ``card``: the card's name and power limit, printed beside each time.
    Returns the numbers of the kernels line's ``bridge_step`` and
    ``bridge_drain`` entries: launches counted from 0 over (a) and (b),
    the main path, and read just after it."""
    import numpy as np
    import torch

    from madsim_tpu_torch.bridge import cuda as bcuda
    from madsim_tpu_torch.bridge import golden as bgolden
    from madsim_tpu_torch.bridge.kernel import (INF_NS, BridgeKernel,
                                                DrainOut, HostBatch,
                                                batch_tensors, drain_plain,
                                                step_plain)
    from madsim_tpu_torch.bridge.synthetic import SyntheticStream, drive
    from madsim_tpu_torch.engine.convert import (bridge_state_from_numpy,
                                                 bridge_state_to_numpy)

    t13 = time.perf_counter()
    cuda = dev.type == "cuda"
    syn = bgolden.SYNTHETIC
    cap, k = syn["cap"], syn["k_events"]

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def same_state(a, b, where):
        sa, sb = bridge_state_to_numpy(a), bridge_state_to_numpy(b)
        for name in sa:
            x, y = sa[name], sb[name]
            if name.startswith("lane_"):
                x, y = x[:, :cap], y[:, :cap]
            check(np.array_equal(x, y), f"{where}: {name} differs from the "
                  f"plain version's")

    # (a) The synthetic streams at full width, CUDA against the plain
    # version on the CPU at every round and drain, and the digests.
    bcuda.reset_counts()
    rounds = 0
    for w in widths:
        for mode in ("realistic", "edge"):
            for metrics in (False, True):
                seeds = np.arange(w)
                gk = BridgeKernel(seeds, cap=cap, k_events=k, device=dev,
                                  metrics=metrics)
                ck = BridgeKernel(seeds, cap=cap, k_events=k, device="cpu",
                                  metrics=metrics)
                stream = SyntheticStream(seeds, cap=cap, mode=mode,
                                         seed=syn["seed"])
                digest = bgolden.StreamDigest()
                n = dict(step=0, drain=0, reset=0)
                where = f"[13 a] {mode} W={w} metrics={metrics}"
                t0 = time.perf_counter()
                for op, outs in drive(stream, [ck, gk], syn["rounds"][mode]):
                    n[op] += 1
                    if op == "reset":
                        digest.add(op, outs)
                        continue
                    digest.add(op, outs[1])
                    bad = bgolden.outputs_differ(outs[1], outs[0])
                    check(not bad, f"{where}: {op} {n[op]}: {bad} differ "
                          f"from the plain version's")
                    same_state(ck, gk, f"{where}: after {op} {n[op]}")
                digest.final(gk)
                key = bgolden.golden_key(mode, w, metrics)
                pinned = key in bgolden.GOLDEN_BRIDGE
                check(not pinned or digest.hexdigest()
                      == bgolden.GOLDEN_BRIDGE[key],
                      f"{where}: the digest differs from GOLDEN_BRIDGE")
                rounds += n["step"] + n["drain"]
                log(f"{where}: {n['step']} rounds, {n['drain']} drains, "
                    f"{n['reset']} resets, every output, the clock, the "
                    f"lanes [:, :cap] and the metrics equal to the plain "
                    f"version's after each; digest "
                    f"{'equals GOLDEN_BRIDGE' if pinned else 'not pinned'}; "
                    f"{time.perf_counter() - t0:.1f} s")

    # (b) The recorded JAX sweeps, open-loop, to JAX's outputs.
    for name in sorted(bgolden.RECORDINGS):
        rec = bgolden.load_recording(name)
        seeds, kw = bgolden.recording_kernel_args(rec)
        gk = BridgeKernel(seeds, device=dev, **kw)
        n = dict(step=0, drain=0)
        for i, op, got, want in bgolden.replay(rec, gk):
            n[op] += 1
            bad = bgolden.outputs_differ(got, want)
            check(not bad, f"[13 b] {name}: op {i} ({op}): {bad} differ "
                  f"from JAX's")
        st = bridge_state_to_numpy(gk)
        for f in ("clock", "lane_dl", "lane_seq"):
            have = st[f] if f == "clock" else st[f][:, :kw["cap"]]
            check(np.array_equal(have, rec[f"final.{f}"]),
                  f"[13 b] {name}: the final {f} differs from JAX's")
        rounds += n["step"] + n["drain"]
        log(f"[13 b] {name} ({bgolden.RECORDINGS[name][1]}): {n['step']} "
            f"rounds and {n['drain']} drains replayed, every output and "
            f"the final state equal to JAX's")
    sync()
    launches = dict(step=bcuda.step_launches, drain=bcuda.drain_launches)
    copies = dict(h2d=bcuda.h2d_copies, d2h=bcuda.d2h_copies)
    if cuda:
        check(launches["step"] > 0 and launches["drain"] > 0,
              f"[13] the main path launched the bridge kernels "
              f"{launches} times")
        check(copies["h2d"] == launches["step"]
              and copies["d2h"] == launches["step"] + launches["drain"],
              f"[13] copies {copies} for launches {launches}: expected one "
              f"H2D and one D2H a round, one D2H a drain")
    log(f"[13] main path: launches {launches} over {rounds} rounds and "
        f"drains; copies {copies} (a round: 1 H2D + 1 D2H; a drain: 1 D2H)")

    # (c) Times. The kernels' device time: launches queued behind a
    # sleeping kernel, so the event pair holds no host launch cost.
    def device_ms(launch, n=50):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES // 4)
        e0.record()
        for _ in range(n):
            launch()
        e1.record()
        check(not e0.query(), "[13 c] timing: the device reached the timed "
              "launches before they were all queued")
        e1.synchronize()
        return e0.elapsed_time(e1) / n

    def event_ms(fn, n=5):
        fn()
        sync()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(n):
            fn()
        e1.record()
        e1.synchronize()
        return e0.elapsed_time(e1) / n

    def warm(kern, w, n_rounds=8):
        stream = SyntheticStream(np.arange(w), cap=cap, mode="realistic",
                                 seed=syn["seed"])
        for _ in drive(stream, [kern], n_rounds):
            pass
        return stream

    def needed_bytes(gk, batch, S):
        """The bytes a round and a drain must move from ``gk``'s state
        with ``batch``, by this data: every deadline [:, :cap] read once
        (the minimum needs them all), the clock, the NET keys, the batch
        and the outputs; 8 B for each deadline the batch changes and 8 B
        for the seq of each timer and surviving live send; 16 B a pop
        (the seq read at the least deadline, the emptied deadline), and a
        whole row of seqs for each world whose lanes are all empty at its
        pops (every lane is a candidate). The round's data from the plain
        version on the CPU, from a copy of the state; the drain follows
        that round."""
        ck = BridgeKernel(np.arange(gk.W), cap=cap, k_events=k,
                          device="cpu")
        bridge_state_from_numpy(ck, bridge_state_to_numpy(gk))
        so = ck.step(batch)
        after_step = ck.state.lane_dl[:, :cap].numpy().copy()
        do = DrainOut(*[np.asarray(x) for x in ck.drain()])
        after_drain = ck.state.lane_dl[:, :cap].numpy()

        def in_range(slot, mask):
            slot = np.asarray(slot)
            return np.asarray(mask, bool) & (slot >= 0) & (slot < cap)

        def pops(out, lanes_after):
            # A world left empty with a pop to spare had a pop see every
            # lane empty.
            valid = np.asarray(out.event_valid, bool)
            empty = (lanes_after == INF_NS).all(1) & (valid.sum(1) < k)
            seq_reads = 8 * k * int((~empty).sum()) + 8 * cap * int(
                empty.sum())
            return seq_reads + 8 * int(valid.sum())

        w = gk.W
        lanes = w * cap * 8
        b = batch
        writes = (8 * int(in_range(b.c_slot, b.c_mask).sum())
                  + 16 * int(in_range(b.t_slot, b.t_mask).sum())
                  + 16 * int((in_range(b.s_slot, b.s_mask)
                              & np.asarray(b.s_live, bool)
                              & np.asarray(so.send_ok, bool)).sum()))
        batch_bytes = sum(np.asarray(x).nbytes for x in batch)
        step_out = w * (8 + 1 + 1 + k * (4 + 8 + 1)) + w * S
        drain_out = w * (1 + k * (8 + 1))
        step = (lanes + 16 * w + 16 * w + batch_bytes + step_out + writes
                + pops(so, after_step))
        drain = lanes + 8 * w + drain_out + pops(do, after_drain)
        return step, drain

    kern_times = {}
    for w in widths:
        gk = BridgeKernel(np.arange(w), cap=cap, k_events=k, device=dev)
        stream = warm(gk, w)
        batch = stream.batch()
        step_bytes, drain_bytes = needed_bytes(gk, batch, stream.S)
        lanes, _, per = bcuda.launch_shape(w, cap)
        paths = bcuda.lane_copy_paths(w, cap)
        if cuda:
            stage = bcuda.stage_batch(gk, batch)
            stage.dev_in.copy_(stage.host_in)
            stream_c = torch.cuda.current_stream(dev)
            dev_out = torch.empty(
                bcuda._layout(bcuda.drain_fields(w, k))[1],
                dtype=torch.uint8, device=dev)
            sync()
            step_ms = device_ms(lambda: bcuda.launch_step(gk, stage,
                                                          stream_c))
            drain_ms = device_ms(lambda: bcuda.launch_drain(gk, dev_out,
                                                            stream_c))
            floor_ms = device_ms(lambda: bcuda.launch_empty(w, cap,
                                                            stream_c))
            bt = batch_tensors(batch, dev)
            plain_step = event_ms(lambda: step_plain(
                gk.state, None, gk._net_k0, gk._net_k1, bt, cap=cap,
                k_events=k))
            plain_drain = event_ms(lambda: drain_plain(
                gk.state, None, cap=cap, k_events=k))
        else:
            step_ms = drain_ms = floor_ms = float("nan")
            plain_step = plain_drain = float("nan")
        kern_times[w] = dict(
            step_ms=step_ms, drain_ms=drain_ms, plain_step_ms=plain_step,
            plain_drain_ms=plain_drain, launch_floor_ms=floor_ms,
            worlds_per_block=per, lanes_per_world=lanes,
            step_bound_ms=step_bytes / HBM_BYTES_PER_S * 1e3,
            drain_bound_ms=drain_bytes / HBM_BYTES_PER_S * 1e3,
            step_mb=step_bytes / 1e6, drain_mb=drain_bytes / 1e6)
        t = kern_times[w]
        log(f"[13 c] W={w}, cap={cap}, k={k}, {lanes} lanes a world, {per} "
            f"worlds a block, {-(-w // per)} blocks (warps copying their "
            f"rows in bulk {paths.count('bulk')}, by lane "
            f"{paths.count('async')}) ({card}): "
            f"bridge_step {step_ms:.4f} ms on the device against a bound "
            f"of {t['step_bound_ms']:.5f} ms ({t['step_mb']:.2f} MB), plain "
            f"round on the card {plain_step:.3f} ms; bridge_drain "
            f"{drain_ms:.4f} ms against {t['drain_bound_ms']:.5f} ms "
            f"({t['drain_mb']:.2f} MB), plain drain {plain_drain:.3f} ms; "
            f"launch floor (an empty kernel on the grid) {floor_ms:.4f} ms; "
            f"bound/time step {t['step_bound_ms'] / step_ms:.3f}, drain "
            f"{t['drain_bound_ms'] / drain_ms:.3f}")

    # Wall per round of BridgeKernel.step and .drain (outputs read) on the
    # card and on the CPU: the realistic stream, after two warm rounds.
    walls = {}
    for w in wall_widths:
        for where in (("cuda", "cpu") if cuda else ("cpu",)):
            kern = BridgeKernel(np.arange(w), cap=cap, k_events=k,
                                device=dev if where == "cuda" else "cpu")
            stream = SyntheticStream(np.arange(w), cap=cap,
                                     mode="realistic", seed=syn["seed"])
            step_s = []
            for r in range(26):
                batch = stream.batch()
                t0 = time.perf_counter()
                out = kern.step(batch)
                if r >= 2:
                    step_s.append(time.perf_counter() - t0)
                stream.after_step(out)
            drain_s = []
            for r in range(26):
                t0 = time.perf_counter()
                d = kern.drain()
                _ = [np.asarray(x) for x in d]
                if r >= 2:
                    drain_s.append(time.perf_counter() - t0)
            walls[(where, w)] = (float(np.median(step_s)) * 1e3,
                                 float(np.median(drain_s)) * 1e3)
        line = ", ".join(f"{where} step {walls[(where, w)][0]:.3f} ms, "
                         f"drain {walls[(where, w)][1]:.3f} ms"
                         for where in ("cuda", "cpu") if (where, w) in walls)
        ratio = ""
        if ("cuda", w) in walls:
            (gs, gd), (cs, cd) = walls[("cuda", w)], walls[("cpu", w)]
            ratio = f"; CPU/CUDA step {cs / gs:.2f}x, drain {cd / gd:.2f}x"
        log(f"[13 c] wall per round at W={w} ({card}), median of 24: "
            f"{line}{ratio}")

    # Where a CUDA round's and drain's wall goes: the median of each piece
    # that bridge/cuda.py stamps (STEP_SPLIT, DRAIN_SPLIT), the realistic
    # stream, 24 rounds and drains after two warm ones; a drain's wait and
    # output are its fields' reads (the first waits on the copy).
    splits = {}
    for w in (wall_widths if cuda else ()):
        kern = BridgeKernel(np.arange(w), cap=cap, k_events=k, device=dev)
        stream = SyntheticStream(np.arange(w), cap=cap, mode="realistic",
                                 seed=syn["seed"])
        pieces = dict(step=[], drain=[])
        for r in range(26):
            batch = stream.batch()
            stamps = []
            out = bcuda.step(kern, batch, split=stamps)
            stream.after_step(out)
            stamps_d = []
            d = bcuda.drain(kern, split=stamps_d)
            stamps_d.append(time.perf_counter())
            np.asarray(d.more_due)
            stamps_d.append(time.perf_counter())
            _ = np.asarray(d.event_seq), np.asarray(d.event_valid)
            stamps_d.append(time.perf_counter())
            if r >= 2:
                pieces["step"].append(np.diff(stamps))
                pieces["drain"].append(np.diff(stamps_d)[
                    [0, 1, 2, 3, 5, 6]])
        names = dict(step=bcuda.STEP_SPLIT,
                     drain=bcuda.DRAIN_SPLIT + ("wait", "output_read"))
        for op in ("step", "drain"):
            med = np.median(np.stack(pieces[op]), axis=0) * 1e3
            splits[f"{op}:{w}"] = dict(zip(names[op], med.tolist()))
            log(f"[13 c] the wall of a CUDA {op} at W={w} ({card}), median "
                f"ms of 24: " + ", ".join(
                    f"{n} {v:.4f}" for n, v in zip(names[op], med))
                + f"; sum {med.sum():.4f}")

    # The same walls on the recorded JAX sweeps (W=512, the batch widths
    # the host driver padded to), replayed open-loop: each step and drain
    # call (outputs read), the median over the recording after its first
    # round (which allocates the staging buffers).
    rec_walls = {}
    for name in sorted(bgolden.RECORDINGS):
        rec = bgolden.load_recording(name)
        seeds, kw = bgolden.recording_kernel_args(rec)
        per = {}
        for where in (("cuda", "cpu") if cuda else ("cpu",)):
            kern = BridgeKernel(seeds, device=dev if where == "cuda"
                                else "cpu", **kw)
            times = dict(step=[], drain=[])
            for i, code in enumerate(rec["ops"].tolist()):
                op = bgolden.OPS[code]
                if op == "reset":
                    kern.reset_slots([tuple(p) for p in
                                      rec[f"{i}.r"].tolist()])
                    continue
                t0 = time.perf_counter()
                if op == "step":
                    kern.step(HostBatch(*[rec[f"{i}.b.{n}"]
                                          for n in HostBatch._fields]))
                else:
                    _ = [np.asarray(x) for x in kern.drain()]
                times[op].append(time.perf_counter() - t0)
            per[where] = {op: float(np.median(v[1:] if len(v) > 1 else v))
                          * 1e3 for op, v in times.items() if v}
            n_ops = {op: len(v) for op, v in times.items()}
            rec_walls[f"{where}:{name}"] = per[where]
        widths_seen = sorted({tuple(rec[f"{i}.b.{n}"].shape[1]
                                    for n in ("t_slot", "c_slot", "s_slot"))
                              for i, c in enumerate(rec["ops"].tolist())
                              if bgolden.OPS[c] == "step"})
        line = "; ".join(
            f"{where} " + ", ".join(f"{op} {ms:.3f} ms"
                                    for op, ms in per[where].items())
            for where in per)
        ratio = ""
        if "cuda" in per:
            ratio = "; CPU/CUDA " + ", ".join(
                f"{op} {per['cpu'][op] / per['cuda'][op]:.2f}x"
                for op in per["cuda"])
        log(f"[13 c] wall per call on the recorded {name} sweep (W="
            f"{len(seeds)}, k={kw['k_events']}, {n_ops['step']} rounds, "
            f"{n_ops['drain']} drains, (T, C, S) {widths_seen}) ({card}): "
            f"{line}{ratio}")
    log(f"[13] phase 13 took {time.perf_counter() - t13:.1f} s")
    top = max(widths)
    return dict(launches=launches, copies=copies, times=kern_times[top],
                w=top, walls={f"{a}:{b}": v for (a, b), v in walls.items()},
                rec_walls=rec_walls, kern_times=kern_times, splits=splits)


def phase_14(dev, w=65_536, batch_w=8_192, w_cmp=64, range_w=4_096,
             trace_args=(), hunt_over=None):
    """Phase 14: the world-axis split on ``dev`` (see the module
    docstring). ``w`` seeds through ``batch_w`` slots are sweep (b) of
    phase 7; ``w_cmp`` seeds are the legs held to the CPU's split;
    ``range_w`` the session's and the fleet's ranges; ``trace_args`` go to
    ``python -m madsim_tpu_torch.analysis trace``; ``hunt_over`` (a dict of
    EngineConfig fields) changes the Raft hunt's config, for a rehearsal on
    the CPU. Returns the step kernel's launches by route and the fold
    kernel's, each counted from 0 and read after the phase's last leg, and
    each leg's wall in s."""
    import threading

    t14 = time.perf_counter()
    # (f) runs beside the other legs: the program checks in a process of
    # their own, whose output a thread reads, stamping the wall from the
    # process's start to its exit.
    trace = subprocess.Popen(
        [sys.executable, "-m", "madsim_tpu_torch.analysis", "trace",
         *trace_args], cwd=HERE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    reaped = {}

    def reap():
        reaped["out"], reaped["err"] = trace.communicate()
        reaped["wall"] = time.perf_counter() - t14

    reaper = threading.Thread(target=reap, daemon=True)
    reaper.start()
    try:
        return _phase_14_legs(dev, trace, reaper, reaped, t14, w, batch_w,
                              w_cmp, range_w, hunt_over)
    finally:
        if trace.poll() is None:
            trace.kill()
            trace.wait()


def _phase_14_legs(dev, trace, reaper, reaped, t14, w, batch_w, w_cmp,
                   range_w, hunt_over):
    """Phase 14's legs (a) to (e), then (f)'s result from ``trace``, whose
    output, and wall from start to exit, the thread ``reaper`` puts in
    ``reaped``."""
    import numpy as np
    import torch

    from madsim_tpu_torch.engine import (DeviceEngine, EngineConfig,
                                         FAULT_KILL, FAULT_RESTART,
                                         RaftActor, RaftDeviceConfig, golden,
                                         step_kernel)
    from madsim_tpu_torch.fleet import fleet_sweep
    from madsim_tpu_torch.fleet.merge import contract_mismatches
    from madsim_tpu_torch.parallel import (SweepSession, multihost_mesh,
                                           seed_mesh)
    from madsim_tpu_torch.search import fold_kernel, hunts
    from madsim_tpu_torch.triage import minimize
    from madsim_tpu_torch.triage.synthetic import (PairRestartActor,
                                                   PairRestartConfig,
                                                   engine_config,
                                                   pair_schedule)
    sweep_mod = importlib.import_module("madsim_tpu_torch.parallel.sweep")

    cuda = dev.type == "cuda"
    cpu = torch.device("cpu")
    launches = dict.fromkeys(("raft", "paxos", "pair"), 0)
    folds = 0
    walls = {}
    step_kernel.launches = fold_kernel.launches = 0
    loops = {"serial": dict(pipeline=False), "pipelined": dict(pipeline=True),
             "fused": dict(fused=True)}

    def take(route):
        nonlocal folds
        launches[route] += step_kernel.launches
        folds += fold_kernel.launches
        step_kernel.launches = fold_kernel.launches = 0

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def run(fn):
        """``fn()`` and its ``_fetch`` calls, the device synced after."""
        n = [0]
        real = sweep_mod._fetch

        def fetch(tree):
            n[0] += 1
            return real(tree)

        sweep_mod._fetch = fetch
        try:
            out = fn()
            sync()
        finally:
            sweep_mod._fetch = real
        return out, n[0]

    def leg(name, t0):
        walls[name] = time.perf_counter() - t0
        log(f"[14 mesh] leg {name}: {walls[name]:.2f} s")

    def contract(a, b, tag):
        """What JAX's tests hold equal across meshes: the bug flags, every
        observation and the coverage ledger."""
        bad = contract_mismatches(a, b)
        check(not bad, f"{tag}: differs on {', '.join(bad[:6])}")

    def every_field(a, b, tag):
        """Every SweepResult field, the loop's counts among them."""
        contract(a, b, tag)
        for f in ("steps_run", "n_devices", "world_utilization",
                  "faults_sha256"):
            check(getattr(a, f) == getattr(b, f), f"{tag}: {f} "
                  f"{getattr(a, f)} against {getattr(b, f)}")
        for f in ("seeds", "n_active_history", "n_active_chunks"):
            check(np.array_equal(getattr(a, f), getattr(b, f)),
                  f"{tag}: {f} differs")
        if a.coverage is not None:
            check(np.array_equal(a.coverage.novelty_curve,
                                 b.coverage.novelty_curve),
                  f"{tag}: the novelty curve differs")
        if a.search is not None:
            check(golden.hunt_pins(a) == golden.hunt_pins(b),
                  f"{tag}: the search report differs")
        for k in ("chunks", "dispatches", "scalar_fetches",
                  "retire_fetches", "epochs_on_device", "superstep_max"):
            check(a.loop_stats[k] == b.loop_stats[k], f"{tag}: "
                  f"loop_stats {k} {a.loop_stats[k]} against "
                  f"{b.loop_stats[k]}")

    hunt_rk, hunt_ck = golden.CONFIGS["hunt_faults"][:2]

    def hunt_engine(d, **over):
        ck = dict(hunt_ck, **(hunt_over or {}))
        return DeviceEngine(RaftActor(RaftDeviceConfig(**hunt_rk)),
                            EngineConfig(**dict(ck, **over)), device=d)

    eng = hunt_engine(dev, stop_on_bug=True, metrics=True)
    seeds = np.arange(w)
    kw = dict(chunk_steps=64, max_steps=1_000_000, recycle=True,
              batch_worlds=batch_w)
    one = seed_mesh() if cuda else seed_mesh([dev])
    four = seed_mesh([dev] * 4)
    two_by_two = multihost_mesh([dev] * 4, n_hosts=2)
    check(one.devices.shape == (1,) and four.devices.shape == (4,)
          and two_by_two.devices.shape == (2, 2), "the meshes' shapes")

    # (a) one device, full width: seed_mesh() against mesh=None.
    t0 = time.perf_counter()
    ref = {}
    for loop, lkw in loops.items():
        base, f_base = run(lambda: sweep_mod.sweep(
            None, eng.cfg, seeds, engine=eng, **kw, **lkw))
        on_one, _ = run(lambda: sweep_mod.sweep(
            None, eng.cfg, seeds, engine=eng, mesh=one, **kw, **lkw))
        every_field(base, on_one, f"[14 mesh a] {loop}")
        check(not base.observations["active"].any(),
              f"[14 mesh a] {loop}: seeds left active")
        ref[loop] = (base, f_base)
    take("raft")
    leg("a", t0)
    log(f"[14 mesh a] {w} seeds through {batch_w} slots, metrics on, on "
        f"seed_mesh() ({one}): every SweepResult field equals mesh=None in "
        f"the serial, pipelined and fused loops; "
        f"{len(ref['serial'][0].failing_seeds)} failing")

    # (b) a 4-way split of the card, flat and 2-D, full width.
    t0 = time.perf_counter()
    for loop, lkw in loops.items():
        widths = []
        real_launch = step_kernel.launch

        def launch(e, leaves, k=1, gate=None):
            widths.append(int(leaves[0].shape[0]))
            return real_launch(e, leaves, k, gate)

        step_kernel.launch = launch
        n0 = step_kernel.launches
        try:
            r4, f4 = run(lambda: sweep_mod.sweep(
                None, eng.cfg, seeds, engine=eng, mesh=four, **kw, **lkw))
        finally:
            step_kernel.launch = real_launch
        n4 = step_kernel.launches - n0
        r22, f22 = run(lambda: sweep_mod.sweep(
            None, eng.cfg, seeds, engine=eng, mesh=two_by_two, **kw, **lkw))
        base, f_base = ref[loop]
        contract(base, r4, f"[14 mesh b] {loop}, 4 blocks")
        every_field(r4, r22, f"[14 mesh b] {loop}, (2, 2) against 4")
        check(r4.n_devices == r22.n_devices == 4,
              f"[14 mesh b] {loop}: n_devices {r4.n_devices}")
        check(f4 / r4.loop_stats["chunks"]
              <= f_base / base.loop_stats["chunks"],
              f"[14 mesh b] {loop}: {f4} _fetch calls over "
              f"{r4.loop_stats['chunks']} chunks on 4 blocks against "
              f"{f_base} over {base.loop_stats['chunks']} on one device")
        if cuda:
            check(max(widths) <= batch_w // 4, f"[14 mesh b] {loop}: a "
                  f"launch of {max(widths)} worlds, more than a block")
            if loop == "serial":
                check(n4 == 4 * r4.loop_stats["chunks"] * 64,
                      f"[14 mesh b] serial: {n4} launches for "
                      f"{r4.loop_stats['chunks']} chunks of 64 steps")
        log(f"[14 mesh b] {loop}: 4 blocks of the card and (2, 2): bug, "
            f"observations and coverage equal the one-device run, the two "
            f"meshes equal on every field; n_devices 4, {n4} step launches "
            f"(blocks of {min(widths) if widths else 0}-"
            f"{max(widths) if widths else 0} worlds), _fetch calls "
            f"{f4} over {r4.loop_stats['chunks']} chunks against {f_base} "
            f"over {base.loop_stats['chunks']} on one device, device flags "
            f"read {r4.loop_stats['flag_reads']}")
    take("raft")
    leg("b", t0)

    # (c) the card's 4-way split against the CPU's, every field, each loop.
    t0 = time.perf_counter()
    small = dict(stop_on_bug=True, metrics=True, t_limit_us=400_000)
    faults = np.array([[150_000, FAULT_KILL, 0, 0],
                       [300_000, FAULT_RESTART, 0, 0]], np.int32)
    ckw = dict(chunk_steps=16, max_steps=4_000, recycle=True,
               batch_worlds=w_cmp // 2, faults=faults)
    eng_d, eng_c = hunt_engine(dev, **small), hunt_engine(cpu, **small)
    for loop, lkw in loops.items():
        rd, _ = run(lambda: sweep_mod.sweep(
            None, eng_d.cfg, np.arange(w_cmp), engine=eng_d, mesh=four,
            **ckw, **lkw))
        rc, _ = run(lambda: sweep_mod.sweep(
            None, eng_c.cfg, np.arange(w_cmp), engine=eng_c,
            mesh=seed_mesh([cpu] * 4), **ckw, **lkw))
        every_field(rc, rd, f"[14 mesh c] {loop}")
        check(rd.failing_seeds and rd.loop_stats["retire_fetches"] > 0,
              f"[14 mesh c] {loop}: no bug or no refill")
    take("raft")
    leg("c", t0)
    log(f"[14 mesh c] {w_cmp} seeds through {w_cmp // 2} slots on 4 blocks "
        f"of the card equal 4 blocks of the CPU on every field in each "
        f"loop")

    # (d) the guided Paxos hunt of phase 8 on the 4-way split.
    t0 = time.perf_counter()
    hunt = hunts.paxos_hunt()
    eng_p = DeviceEngine(hunt.actor, hunt.cfg, device=dev)
    hkw = dict(hunt.sweep_kw, faults=hunt.template,
               stop_on_first_bug=golden.HUNT_STOP_FIRST["paxos"],
               search=hunt.search(True))
    f0 = fold_kernel.launches
    res_p, _ = run(lambda: sweep_mod.sweep(
        None, eng_p.cfg, np.arange(golden.HUNT_BUDGET), engine=eng_p,
        mesh=four, **hkw))
    n_folds = fold_kernel.launches - f0
    pins = golden.hunt_pins(res_p)
    check(pins == golden.HUNT_PINS["paxos"]["guided"],
          f"[14 mesh d] the guided Paxos hunt on 4 blocks: {pins} differ "
          f"from the JAX pins")
    check(not cuda or n_folds == res_p.search.generations,
          f"[14 mesh d] {n_folds} fold launches over "
          f"{res_p.search.generations} refills")
    eng_pc = DeviceEngine(hunt.actor, hunt.cfg, device=cpu)
    # The CPU steps a compiled family slowly: the budget is 8 chunks.
    small_p = dict(hkw, batch_worlds=w_cmp // 2, max_steps=256)
    rd, _ = run(lambda: sweep_mod.sweep(
        None, eng_p.cfg, np.arange(w_cmp), engine=eng_p, mesh=four,
        **small_p))
    rc, _ = run(lambda: sweep_mod.sweep(
        None, eng_pc.cfg, np.arange(w_cmp), engine=eng_pc,
        mesh=seed_mesh([cpu] * 4), **small_p))
    every_field(rc, rd, "[14 mesh d] the guided Paxos hunt on 4 blocks")
    check(rd.search.generations > 0, "[14 mesh d] no refill at w_cmp")
    take("paxos")
    leg("d", t0)
    log(f"[14 mesh d] the guided Paxos hunt ({golden.HUNT_BUDGET} seeds) "
        f"on 4 blocks holds the JAX pins ({pins['seeds_to_bug']} seeds to "
        f"the first bug, {pins['generations']} generations), "
        f"{n_folds} fold launches, one a refill; at {w_cmp} seeds "
        f"({rd.search.generations} refills) it equals the CPU's 4 blocks "
        f"on every field and the search report")

    # (e) triage, the session and the fleet on the split.
    t0 = time.perf_counter()
    acfg = PairRestartConfig()
    eng_t = DeviceEngine(PairRestartActor(acfg), engine_config(acfg),
                         device=dev)
    mb = golden.MINIMIZE_BUG
    rows = pair_schedule(n_rows=mb["n_rows"], need=mb["need"], acfg=acfg)
    mr = minimize(None, eng_t.cfg, mb["seed"], rows, engine=eng_t,
                  mesh=four, chunk_steps=mb["chunk_steps"],
                  max_steps=mb["max_steps"])
    check(golden.minimize_digest(mr) == golden.GOLDEN_MINIMIZE,
          "[14 mesh e] minimize on 4 blocks: not the JAX pin")
    take("pair")
    skw = dict(chunk_steps=64, max_steps=4_000)
    eng_s = hunt_engine(dev, metrics=True)
    sess = SweepSession(engine=eng_s, mesh=four, **skw)
    parts = [{"seeds": np.arange(r * range_w, (r + 1) * range_w - r),
              "faults": None} for r in range(2)]
    for gi in range(2):
        res_g = sess.run_group(parts)
        for part, r in zip(parts, res_g):
            solo = sweep_mod.sweep(None, eng_s.cfg, part["seeds"],
                                   engine=eng_s, **skw)
            contract(solo, r, f"[14 mesh e] session group {gi}")
            check(r.n_devices == 4, "[14 mesh e] session n_devices")
    fl = fleet_sweep(None, eng_s.cfg, np.arange(4 * range_w), engine=eng_s,
                     mesh=two_by_two, n_workers=2, range_size=range_w,
                     **skw)
    single = sweep_mod.sweep(None, eng_s.cfg, np.arange(4 * range_w),
                             engine=eng_s, **skw)
    contract(single, fl, "[14 mesh e] the fleet on (2, 2)")
    check(fl.n_devices == 4, "[14 mesh e] the fleet's n_devices")
    take("raft")
    leg("e", t0)
    log(f"[14 mesh e] minimize (golden.MINIMIZE_BUG) on 4 blocks: the JAX "
        f"pin, {mr.rounds} rounds; SweepSession.run_group of ranges of "
        f"{range_w} and {range_w - 1} seeds twice on 4 blocks, each equal "
        f"to the one-device solo sweep; a clean fleet_sweep of "
        f"{4 * range_w} seeds on (2, 2), 2 workers, equal to the one-device "
        f"sweep")

    # (f) the program checks, started with the phase.
    t0 = time.perf_counter()
    reaper.join(timeout=600)
    check(not reaper.is_alive(), "[14 trace] analysis trace did not exit "
          "within 600 s of the end of (e)")
    out, err = reaped["out"], reaped["err"]
    for line in out.splitlines():
        log(f"[14 trace] {line}")
    check(trace.returncode == 0, f"[14 trace] analysis trace exited "
          f"{trace.returncode}: {err[-2000:]}")
    walls["trace"] = reaped["wall"]
    log(f"[14 trace] the analysis trace process: {walls['trace']:.2f} s "
        f"from its start to its exit")
    leg("f (the wait after (e))", t0)
    walls["phase"] = time.perf_counter() - t14
    log(f"[14 mesh] phase 14: {walls['phase']:.1f} s")
    return launches, folds, walls


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import numpy as np

    from madsim_tpu_torch import _build
    from madsim_tpu_torch.bridge import cuda as bridge_cuda
    from madsim_tpu_torch.engine import (
        FAULT_CLOG_LINK, FAULT_CLOG_NODE, FAULT_KILL, FAULT_PAUSE,
        FAULT_RESTART, FAULT_RESUME, FAULT_SET_LATENCY, FAULT_SET_LOSS,
        FAULT_UNCLOG_LINK, FAULT_UNCLOG_NODE, DeviceEngine, EngineConfig,
        RaftActor, RaftDeviceConfig, golden, step_kernel)
    from madsim_tpu_torch.engine.core import (tree_leaves, tree_paths,
                                              tree_unflatten)
    from madsim_tpu_torch.engine.families import family
    from madsim_tpu_torch.obs.blackbox import (decode_ring,
                                               ring_matches_trace,
                                               rings_from_observations)
    from madsim_tpu_torch.obs.coverage import fold_retired, ledger_zeros
    from madsim_tpu_torch.ops.threefry import threefry2x32_torch
    sweep_mod = importlib.import_module("madsim_tpu_torch.parallel.sweep")
    from madsim_tpu_torch.parallel.sweep import sweep
    from madsim_tpu_torch.search import hunts
    from madsim_tpu_torch.search import fold_kernel
    from madsim_tpu_torch.search.corpus import (corpus_init, harvest_fold,
                                                harvest_fold_plain)
    from madsim_tpu_torch.search.mutate import make_children
    from madsim_tpu_torch.triage.synthetic import pair_schedule

    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # ---- 1. card ----------------------------------------------------------
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"[1 card] {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    x = torch.tensor([0, 1, 2**31 - 1, 2**31, 2**32 - 1], dtype=torch.int64,
                     device=dev)
    u = (x & 0xFFFFFFFF).to(torch.uint32)
    check(u.dtype == torch.uint32 and torch.equal(u.to(torch.int64), x),
          "uint32 <-> int64 round trip on CUDA changed values")
    log("[1 card] uint32 <-> int64 round trip on CUDA: ok")

    # ---- 2. build ---------------------------------------------------------
    # One nvcc per source, all started together: the kernel with Raft's,
    # two-phase commit's, primary-backup's, Paxos's and the pair families'
    # policy (one source per route, each in both lane profiles), and the
    # corpus fold kernel.
    sources = {f.route: f.source for f in step_kernel.FAMILIES}
    least = {f.route: f.least_n for f in step_kernel.FAMILIES}
    most = {f.route: f.max_n for f in step_kernel.FAMILIES}
    t0 = time.perf_counter()
    took = _build.build_all(list(sources.values()) + [fold_kernel.SOURCE,
                                                      bridge_cuda.SOURCE])
    log(f"[2 build] nvcc of {', '.join(s + '.cu' for s in took)} in "
        f"parallel: " + ", ".join(f"{s} {t:.1f} s" for s, t in took.items())
        + f"; wall {time.perf_counter() - t0:.1f} s")

    def no_local_memory(name, f):
        check(f["stack"] == 0 and f["spill_stores"] == 0
              and f["spill_loads"] == 0,
              f"{name} uses local memory: {f['stack']} bytes stack "
              f"frame, {f['spill_stores']} bytes spill stores, "
              f"{f['spill_loads']} bytes spill loads")

    for fam, src in sources.items():
        report = _build.build_log.get(src, "")
        for line in report.splitlines():
            if "error" in line:
                log(f"[2 build] {src}.cu: {line.strip()}")
        # One instantiation per node count the family takes and lane
        # profile, each without local memory.
        least_n = least[fam]
        want = 2 * (most[fam] - least_n + 1)
        ptx = ptxas_report(report, "step_kernel")
        check(len(ptx) == want and all(len(f) == 4 for f in ptx.values()),
              f"ptxas reported {len(ptx)} step_kernel instantiations in "
              f"{src}.cu, expected {want} with registers, stack frame and "
              f"spills")
        for name, f in ptx.items():
            no_local_memory(name, f)
        for prof in ("PackedProfile", "WideProfile"):
            by_n = {int(re.search(r"Li(\d+)E", name)[1]): f["registers"]
                    for name, f in ptx.items() if prof in name}
            check(len(by_n) == want // 2, f"{src}.cu: step_kernel "
                  f"instantiations of {prof} by N: {sorted(by_n)}")
            log(f"[2 build] {src}.cu: step_kernel<{fam}, {prof}, N> for "
                f"N={least_n}..{most[fam]}: 0 bytes stack frame and no "
                f"spills in each; registers by N "
                + ", ".join(f"{n}: {r}" for n, r in sorted(by_n.items())))
    # Every kernel of corpus_fold.cu: the fold, its chain yardstick and the
    # empty launch of the launch floor.
    fold_ptx = {}
    for kname in ("corpus_fold_kernel", "fold_chain_kernel",
                  "fold_empty_kernel"):
        found = ptxas_report(_build.build_log.get(fold_kernel.SOURCE, ""),
                             kname)
        check(len(found) == 1 and all(
            {"stack", "spill_stores", "spill_loads"} <= set(f)
            for f in found.values()), f"ptxas reported {len(found)} "
            f"{kname}, expected 1 with its stack frame and spills")
        fold_ptx.update(found)
    for name, f in fold_ptx.items():
        no_local_memory(name, f)
        log(f"[2 build] corpus_fold.cu: {name}: 0 bytes stack frame and "
            f"no spills, {f.get('registers', '?')} registers")
    # Every kernel of bridge_step.cu: the round and the drain at 8, 16 and
    # 32 lanes a world (32 with and without the bulk copy), and the empty
    # launch of the launch floor.
    for kname, want in (("bridge_step_kernel", 4),
                        ("bridge_drain_kernel", 4),
                        ("bridge_empty_kernel", 1)):
        found = ptxas_report(_build.build_log.get(bridge_cuda.SOURCE, ""),
                             kname)
        check(len(found) == want and all(
            {"stack", "spill_stores", "spill_loads"} <= set(f)
            for f in found.values()), f"ptxas reported {len(found)} "
            f"{kname}, expected {want} with its stack frame and spills")
        for name, f in found.items():
            no_local_memory(name, f)
            log(f"[2 build] bridge_step.cu: {name}: 0 bytes stack frame "
                f"and no spills, {f.get('registers', '?')} registers")

    # ---- 3. Threefry on the card ------------------------------------------
    kat = [((0x00000000, 0x00000000), (0x00000000, 0x00000000),
            (0x6B200159, 0x99BA4EFE)),
           ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF),
            (0x1CB996FC, 0xBB002BE7)),
           ((0x243F6A88, 0x85A308D3), (0x13198A2E, 0x03707344),
            (0xC4923A9C, 0x483DF7A0))]

    def u32(vals):
        return torch.tensor(vals, dtype=torch.int64, device=dev) \
            .to(torch.uint32)

    o0, o1 = step_kernel.threefry2x32(
        u32([k[1][0] for k in kat]), u32([k[1][1] for k in kat]),
        u32([k[0][0] for k in kat]), u32([k[0][1] for k in kat]))
    got = list(zip(o0.to(torch.int64).tolist(), o1.to(torch.int64).tolist()))
    check(got == [k[2] for k in kat], f"Threefry known answers: got {got}")
    g = torch.Generator(device=dev).manual_seed(0)
    ks = [torch.randint(0, 2**32, (1 << 20,), generator=g, device=dev,
                        dtype=torch.int64).to(torch.uint32) for _ in range(4)]
    ks[2][:4] = u32([2**32 - 1, 2**32 - 2, 0, 1])  # counters at the wrap
    a0, a1 = step_kernel.threefry2x32(*ks)
    b0, b1 = threefry2x32_torch(*ks)
    check(torch.equal(a0.to(torch.int64), b0.to(torch.int64))
          and torch.equal(a1.to(torch.int64), b1.to(torch.int64)),
          "Threefry kernel differs from the plain torch version")
    log("[3 threefry] known answers ok; 2^20 random (key, counter) pairs "
        "bitwise equal to the plain version")

    # ---- 4. kernel vs plain, whole runs -----------------------------------
    def bits(x):
        """A leaf as a tensor whose equality is bit equality."""
        if x.dtype == torch.uint32:
            return x.to(torch.int64)
        if x.dtype == torch.float32:
            return x.view(torch.int32)
        return x

    def diff(a, b):
        """(first leaf whose bits differ or None, max abs difference)."""
        first, err = None, 0.0
        for name, x, y in zip(tree_paths(a), tree_leaves(a),
                              tree_leaves(b)):
            if x.dtype == y.dtype and torch.equal(bits(x), bits(y)):
                continue
            first = first or name
            if x.dtype == y.dtype and x.numel():
                xv, yv = (v.to(torch.int64) if v.dtype == torch.uint32
                          else v for v in (x, y))
                err = max(err, float((xv.to(torch.float64)
                                      - yv.to(torch.float64)).abs().max()))
            else:
                err = float("inf")
        return first, err

    fault_mix = np.array([
        [100_000, FAULT_PAUSE, 1, 0], [250_000, FAULT_RESUME, 1, 0],
        [120_000, FAULT_CLOG_NODE, 2, 0], [400_000, FAULT_UNCLOG_NODE, 2, 0],
        [150_000, FAULT_CLOG_LINK, 0, 1], [600_000, FAULT_UNCLOG_LINK, 0, 1],
        [200_000, FAULT_SET_LATENCY, 500, 20_000],
        [300_000, FAULT_SET_LOSS, 200_000, 0], [800_000, FAULT_SET_LOSS, 0, 0],
        [500_000, FAULT_KILL, 1, 0], [650_000, FAULT_RESTART, 1, 0],
    ], np.int32)
    # The main path: the headline deployment and the bug hunt, at full W.
    mains = [
        ("headline", golden.CONFIGS["headline"][:2], None, 524_288, 2_000),
        ("hunt", (dict(n=3, buggy_double_vote=True),
                  golden.CONFIGS["hunt_faults"][1]), None, 65_536, 4_000),
    ]
    compare_cfgs = [
        ("headline", golden.CONFIGS["headline"][:2], None, W_COMPARE, 2_000,
         None),
        ("hunt_kill_restart", golden.CONFIGS["hunt_faults"][:2],
         np.asarray(golden.CONFIGS["hunt_faults"][2], np.int32), W_COMPARE,
         4_000, "bug"),
        ("overflow_q8", (dict(n=3, n_proposals=2),
                         dict(n_nodes=3, outbox_cap=4, queue_cap=8,
                              t_limit_us=2_000_000, stop_on_bug=False)),
         None, W_COMPARE, 3_000, "overflow"),
        ("fault_mix", (dict(n=3, n_proposals=3),
                       dict(n_nodes=3, outbox_cap=4, queue_cap=64,
                            t_limit_us=1_500_000, stop_on_bug=False)),
         fault_mix, W_COMPARE, 3_000, None),
        # Off the main path's widths: an odd node count with 4-byte queue
        # accesses (Q % 4 != 0, the padded pop) and element-wise payload
        # rows (P=12); an even node count whose commit and log rows take
        # 4-byte accesses.
        ("n5_q30_p12", (dict(n=5, n_proposals=3),
                        dict(n_nodes=5, outbox_cap=6, queue_cap=30,
                             payload_words=12, t_limit_us=1_500_000,
                             stop_on_bug=False)),
         fault_mix, W_COMPARE, 3_000, "overflow"),
        ("n4_l6", (dict(n=4, log_cap=6, n_proposals=3),
                   dict(n_nodes=4, outbox_cap=5, queue_cap=64,
                        t_limit_us=1_500_000, stop_on_bug=False)),
         None, W_COMPARE, 3_000, None),
    ] + [("main_" + name, cfgs, faults, w, max_steps,
          "bug" if name == "hunt" else None)
         for name, cfgs, faults, w, max_steps in mains]
    # The metrics block and the flight recorder, written inside the kernel:
    # the hunt with kill/restart and a 64-deep ring, the overflowing queue
    # with a ring of 5 (not a power of two), sends that saturate at
    # INF_TIME and drop, the odd widths with both, and the full-W hunt.
    hunt_rk, hunt_ck = compare_cfgs[1][1]
    inf_latency = np.array([[0, FAULT_SET_LATENCY, 2_000_000_000,
                             2_147_483_646]], np.int32)
    on = dict(metrics=True, blackbox=64)
    by_name = {c[0]: c for c in compare_cfgs}

    def with_lanes(name, new_name, expect, **over):
        _n, cfgs, faults, w, max_steps, _e = by_name[name]
        return (new_name, (*cfgs[:-1], dict(cfgs[-1], **over)), faults, w,
                max_steps, expect)

    compare_cfgs += [
        with_lanes("hunt_kill_restart", "hunt_kill_restart+obs",
                   "m_drop_dead", **on),
        with_lanes("overflow_q8", "overflow_q8+obs", "m_drop_overflow",
                   metrics=True, blackbox=5),
        ("inf_latency+metrics", (hunt_rk, dict(hunt_ck, metrics=True)),
         inf_latency, W_COMPARE, 4_000, "m_drop_inf"),
        with_lanes("n5_q30_p12", "n5_q30_p12+obs", "m_drop_loss", **on),
        with_lanes("main_hunt", "main_hunt+obs", "bug", **on),
    ]
    # The compiled families through their kernel policies: bench.py's
    # crosscheck legs and the pb hunt (golden.FAMILY_CONFIGS), tpc with
    # its coordinator killed and restarted (tests/test_tpc_actor.py), tpc
    # at n = 8 (the template's widest instantiation), and the pb hunt with
    # the metrics block and a 64-deep ring, held also to its lanes-off run.
    # The three deployments run both at W_COMPARE and, as main_*, at the
    # main path's W_FAMILY (phase 6 and the sweep of phase 7 (d)).
    # A family's cfgs are (family, config kwargs, EngineConfig kwargs).
    fam_compare = [
        (prefix + name, (fam, ak, ck),
         None if faults is None else np.asarray(faults, np.int32),
         w, max_steps, "bug" if name != "pb_crosscheck" else None)
        for prefix, w in (("", W_COMPARE), ("main_", W_FAMILY))
        for name, (fam, ak, ck, faults, max_steps)
        in golden.FAMILY_CONFIGS.items()]
    tpc_ak, tpc_ck = golden.FAMILY_CONFIGS["tpc_crosscheck"][1:3]
    fam_compare += [
        ("tpc_kill_restart", ("tpc", tpc_ak, dict(tpc_ck, stop_on_bug=False)),
         np.array([[200_000, FAULT_KILL, 0, 0],
                   [500_000, FAULT_RESTART, 0, 0]], np.int32),
         W_COMPARE, 5_000, "bug"),
        ("tpc_n8", ("tpc", dict(n=8, n_txns=6),
                    dict(n_nodes=8, outbox_cap=9, queue_cap=64,
                         t_limit_us=1_500_000, loss_rate=0.1)),
         None, W_COMPARE, 5_000, "aborts"),
        # Off the deployments' widths, under every fault op: 4-byte queue
        # accesses (Q=30), element-wise payload rows (P=12), other node
        # counts, a short pb log.
        ("tpc_n3_q30_p12", ("tpc", dict(n=3, n_txns=5, no_vote_num=100,
                                         buggy_presumed_commit=True),
                            dict(n_nodes=3, outbox_cap=4, queue_cap=30,
                                 payload_words=12, t_limit_us=1_500_000,
                                 loss_rate=0.2, stop_on_bug=False)),
         fault_mix, W_COMPARE, 5_000, "bug"),
        ("pb_n5_q30_p12", ("pb", dict(n=5, n_writes=5, log_cap=6,
                                       buggy_commit_early=True),
                           dict(n_nodes=5, outbox_cap=6, queue_cap=30,
                                payload_words=12, t_limit_us=1_500_000,
                                loss_rate=0.2, stop_on_bug=False)),
         fault_mix, W_COMPARE, 5_000, "overflow"),
    ]
    compare_cfgs += fam_compare
    by_name = {c[0]: c for c in compare_cfgs}
    compare_cfgs.append(with_lanes("pb_hunt", "pb_hunt+obs", "m_drop_loss",
                                   **on))

    def children(hunt, w, gen):
        """Per-slot (W, F, 4) schedules as a guided refill makes them: the
        port's make_children from a corpus holding the hunt's template."""
        seed_ids = torch.arange(w, dtype=torch.int32, device=dev)
        return make_children(hunt.search(True), hunt.cfg,
                             corpus_init(32, hunt.template, dev), seed_ids,
                             gen).cpu().numpy()

    # The guided search's families through their kernel policies, lanes
    # off and (+obs) on: Paxos with forgetful acceptors (the hunt's) and
    # without, and the guided pair at n = 12, at their templates and under
    # per-slot children of the template (generation 3 for Paxos, whose
    # jitter then reaches the amnesia windows, 1 for the pair), at
    # W_COMPARE and, as main_*, at the deployments' W_FAMILY; pair-restart
    # at n = 4 under pair_schedule.
    px_hunt, gp_hunt = hunts.paxos_hunt(), hunts.pair_hunt()
    px_fam, px_ak, px_ck, px_t, px_m = golden.SEARCH_CONFIGS["paxos_hunt"]
    gp_fam, gp_ak, gp_ck, gp_t, gp_m = golden.SEARCH_CONFIGS["guided_pair"]
    lanes_off = dict(metrics=False, blackbox=0)
    px_off = dict(px_ck, **lanes_off)
    gp_off = dict(gp_ck, **lanes_off)
    durable = dict(px_ak, buggy_forgetful_acceptor=False)
    search_compare = [
        ("pair_restart_n4", ("pair_restart", dict(n=4),
                             dict(n_nodes=4, outbox_cap=2, queue_cap=64,
                                  t_limit_us=2_000_000, stop_on_bug=False)),
         pair_schedule(32), W_COMPARE, 1_000, "bug"),
    ]
    for prefix, w in (("", W_COMPARE), ("main_", W_FAMILY)):
        px_kids, gp_kids = children(px_hunt, w, 3), children(gp_hunt, w, 1)
        search_compare += [
            (prefix + "paxos_hunt", (px_fam, px_ak, px_off),
             np.asarray(px_t, np.int32), w, px_m, "slots_decided"),
            (prefix + "paxos_durable", (px_fam, durable, px_off),
             np.asarray(px_t, np.int32), w, px_m, "slots_decided"),
            (prefix + "guided_pair", (gp_fam, gp_ak, gp_off),
             np.asarray(gp_t, np.int32), w, gp_m, "restarts_total"),
            (prefix + "paxos_children", (px_fam, px_ak, px_off), px_kids, w,
             px_m, "bug"),
            (prefix + "paxos_durable_children", (px_fam, durable, px_off),
             px_kids, w, px_m, "slots_decided"),
            (prefix + "guided_pair_children", (gp_fam, gp_ak, gp_off),
             gp_kids, w, gp_m, "bug"),
        ]
    compare_cfgs += search_compare
    by_name = {c[0]: c for c in compare_cfgs}
    compare_cfgs += [with_lanes(c[0], c[0] + "+obs", c[5], **on)
                     for c in search_compare]
    # The wide lane profile (packed=False, every narrow lane int32): each
    # family's wide instantiations against the plain step, lanes off and
    # on, under every fault op and at odd widths, and the Raft hunt at its
    # full W (to the same depth as the packed profile's).
    by_name = {c[0]: c for c in compare_cfgs}
    wide_names = ["headline", "hunt_kill_restart", "overflow_q8+obs",
                  "fault_mix", "n5_q30_p12+obs", "n4_l6",
                  "inf_latency+metrics", "main_hunt", "main_hunt+obs",
                  "tpc_crosscheck", "tpc_n3_q30_p12", "pb_hunt",
                  "pb_hunt+obs", "pb_n5_q30_p12", "paxos_hunt",
                  "paxos_hunt+obs", "paxos_children", "guided_pair",
                  "guided_pair+obs", "guided_pair_children",
                  "pair_restart_n4"]
    compare_cfgs += [with_lanes(name, name + ":wide", by_name[name][5],
                                packed=False) for name in wide_names]
    fam_err = {}

    def route_key(eng):
        """The kernel route an engine launches: its family's policy, and
        ``:wide`` for the wide lane profile's instantiations."""
        return (step_kernel.family_of(eng.actor).route
                + ("" if eng.cfg.packed else ":wide"))

    def make_engine(cfgs, **over):
        """An engine on the card from (RaftDeviceConfig kwargs,
        EngineConfig kwargs) or (family, config kwargs, EngineConfig
        kwargs)."""
        fam, ak, ck = cfgs if len(cfgs) == 3 else ("raft", *cfgs)
        acls, ccls = family(fam).load()
        return DeviceEngine(acls(ccls(**ak)), EngineConfig(**dict(ck, **over)),
                            device=dev)

    # The deepest comparison of the earlier paths runs at a smaller depth,
    # to make room for the guided search's comparisons in the script's
    # time: the full-width Raft hunt's first 256 of its 776 steps, lanes
    # off and on. Its whole run is still held to a recycled sweep's in
    # phase 7 (b), and the hunt with kill/restart to JAX's in phase 5.
    earlier_depth = {"main_hunt": 256, "main_hunt+obs": 256}
    for name, cfgs, faults, w, max_steps, expect in compare_cfgs:
        seeds = np.arange(w)
        t0 = time.perf_counter()
        ck = cfgs[-1]
        cut = name in earlier_depth
        max_steps = earlier_depth.get(name, max_steps)
        eng = make_engine(cfgs)
        fam = route_key(eng)
        ks_state = eng.init(seeds, faults=faults)
        pl_state = eng.init(seeds, faults=faults)
        first, err = diff(ks_state, pl_state)
        check(first is None, f"{name}: init not deterministic ({first})")
        steps = 0
        while steps < max_steps and (bool(ks_state.active.any())
                                     or bool(pl_state.active.any())):
            eng.step(ks_state)
            pl_state = eng.step_plain(pl_state)
            steps += 1
            if steps <= COMPARE_EVERY_STEP or steps % 64 == 0:
                first, err = diff(ks_state, pl_state)
                check(first is None, f"{name}: kernel and plain step differ "
                      f"first on leaf {first} after step {steps} "
                      f"(max abs err {err})")
                fam_err[fam] = max(fam_err.get(fam, 0.0), err)
        first, err = diff(ks_state, pl_state)
        fam_err[fam] = max(fam_err.get(fam, 0.0), err)
        check(first is None, f"{name}: kernel and plain step differ at the "
              f"end on leaf {first}")
        obs = eng.observe(ks_state)
        check(cut or not obs["active"].any(), f"{name}: worlds still active")
        if expect:
            check(obs[expect].any(), f"{name}: no world hit {expect}; the "
                  f"path it exists for went unexercised")
        if ck.get("metrics") or ck.get("blackbox"):
            # The lanes are invisible: the same steps with both off leave
            # every other leaf as the kernel's run with them on.
            eng_off = make_engine(cfgs, metrics=False, blackbox=0)
            off = eng_off.run_steps(eng_off.init(seeds, faults=faults),
                                    steps)
            on_leaves = dict(zip(tree_paths(ks_state),
                                 tree_leaves(ks_state)))
            for path, x in zip(tree_paths(off), tree_leaves(off)):
                check(torch.equal(bits(x), bits(on_leaves[path])),
                      f"{name}: the metrics or ring lanes changed leaf "
                      f"{path}")
            del off
        log(f"[4 compare] {name} ({fam}): W={w} {steps} steps"
            + (" (depth cut)" if cut else "") + " bitwise "
            f"equal (bug {int(obs['bug'].sum())}, overflow "
            f"{int(obs['overflow'].sum())}"
            + (f", elected {int(obs['leader_elected'].sum())}"
               if fam.startswith("raft") else "")
            + f") in {time.perf_counter() - t0:.1f} s")
        del ks_state, pl_state

    def frozen_step(eng, w, faults):
        """One kernel step and one plain step from a state whose frozen
        worlds the invariant never checked (see below); returns the max
        abs difference."""
        what = ("frozen worlds never checked"
                + (" (metrics and ring on)" if eng.cfg.blackbox else ""))
        state = eng.run_steps(eng.init(np.arange(w), faults=faults), 150)
        idx = torch.arange(w, device=dev)
        frozen = (idx < 256) | ((idx < 1024) & (idx % 4 != 0)) | (idx % 3 == 0)
        one = frozen & (idx % 2 == 1)
        a = state.astate
        a.commit[one, 1:] = 0
        top = a.commit.to(torch.int32).argmax(1)
        a.log_term[frozen, top[frozen], 0] += 1
        state.active[frozen] = False
        state.bug[frozen] = False
        n_committed = (a.commit > 0).sum(1)
        checked = frozen & (n_committed >= 2)
        check(int(checked.sum()) > 0 and int((frozen & ~checked).sum()) > 0
              and int((~frozen & state.active).sum()) > 0,
              f"{what}: the state lacks one of its kinds of world")
        ks_state = tree_unflatten(state,
                                  [x.clone() for x in tree_leaves(state)])
        eng.step(ks_state)
        pl_state = eng.step_plain(state)
        first, err = diff(ks_state, pl_state)
        check(first is None, f"{what}: kernel and plain step differ on leaf "
              f"{first} (max abs err {err})")
        flagged = pl_state.bug & frozen
        check(torch.equal(flagged, checked), f"{what}: the changed committed "
              f"entries were not flagged exactly where two nodes committed")
        if eng.cfg.blackbox:
            marked = (pl_state.blackbox.pos != state.blackbox.pos) & frozen
            check(torch.equal(marked, checked), f"{what}: the ring's markers "
                  f"do not fall exactly on the flagged frozen worlds")
        log(f"[4 compare] {what}: W={w}, {int(frozen.sum())} frozen "
            f"({int(checked.sum())} with two committed nodes, all flagged"
            + (", each with a ring marker" if eng.cfg.blackbox else "")
            + "), one step bitwise equal")
        return err

    # Frozen worlds that the invariant never checked, as a caller may hand
    # in: part way through fault_mix, whose proposals commit entries, worlds
    # are frozen with their bug flag cleared (every world of the first two
    # blocks, three in four of the next six, one in three after). Each
    # frozen world gets one committed log entry changed; every second one
    # also keeps only one committed node. One step of the kernel and of
    # the plain step must agree on every leaf.
    # With the ring on, each changed world records its raise as a marker.
    _name, (rk, ck), faults, w, _m, _e = by_name["fault_mix"]
    for lanes in ({}, dict(metrics=True, blackbox=8)):
        fam_err["raft"] = max(fam_err["raft"], frozen_step(
            DeviceEngine(RaftActor(RaftDeviceConfig(**rk)),
                         EngineConfig(**ck, **lanes), device=dev),
            w, faults))

    # The corpus fold kernel against its plain version (harvest_fold_plain,
    # torch ops) and its numpy model (fold_kernel.fold_model, the kernel's
    # order of work), bitwise on every corpus lane, the insert count and the
    # novel and inserted masks.
    # (a) The Paxos hunt's SearchConfig (corpus size and min_novelty),
    # lineage lanes on, the rows' signatures those of a Paxos hunt batch
    # with the metrics block after 200 steps, its retired worlds in the
    # mask. Two folds at each width: from the template's corpus, and from
    # the corpus the first left. Each is timed per call (a CUDA event pair
    # around harvest_fold, the host's wrapper inside it), on the device
    # alone (FOLD_QUEUED calls queued behind a sleeping kernel) and on the
    # host (FOLD_HOST_CALLS back to back), beside the dependent chain of
    # its rounds and inserts alone and the launch floor (an empty launch),
    # each timed on the device alone the same way, and the floor per call.
    from madsim_tpu_torch.obs.coverage import behavior_signature
    from madsim_tpu_torch.search.corpus import HostCorpus, corpus_to_device

    def host_corpus(c):
        return HostCorpus(
            sched=c.sched.cpu().numpy(),
            sig=c.sig.cpu().numpy().astype(np.uint32),
            score=c.score.cpu().numpy(), filled=c.filled.cpu().numpy(),
            entry=c.entry.cpu().numpy(), depth=c.depth.cpu().numpy())

    def fold_checked(label, corpus, sched, sigs, mask, min_nov, entries,
                     depths):
        """One fold through the kernel, held to the plain fold and to the
        model; returns the kernel's outputs, the model's stats and the
        plain fold's wall ms."""
        w = int(sigs.shape[0])
        out_k = harvest_fold(corpus, sched, sigs, mask, min_nov, entries,
                             depths, with_masks=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out_p = harvest_fold_plain(
            corpus, sched, sigs, mask, min_nov,
            torch.full((w,), -1, dtype=torch.int32, device=dev)
            if entries is None else entries,
            torch.zeros((w,), dtype=torch.int32, device=dev)
            if depths is None else depths, with_masks=True)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        for name, x, y in zip(corpus._fields, out_k[0], out_p[0]):
            check(x.dtype == y.dtype and torch.equal(x, y), f"fold "
                  f"{label}: the kernel's corpus {name} differs from the "
                  f"plain fold's")
        for name, x, y in zip(("n_ins", "novel", "inserted"), out_k[1:],
                              out_p[1:]):
            check(x.dtype == y.dtype and torch.equal(x, y), f"fold "
                  f"{label}: the kernel's {name} differs from the plain "
                  f"fold's")
        def host(x):
            return None if x is None else x.cpu().numpy()

        mc, m_ins, m_nov, m_insm, stats = fold_kernel.fold_model(
            host_corpus(corpus), host(sched), host(sigs), host(mask),
            min_nov, host(entries), host(depths))
        kc = host_corpus(out_k[0])
        check(all(np.array_equal(a, b) for a, b in zip(kc, mc))
              and int(out_k[1]) == m_ins
              and np.array_equal(host(out_k[2]), m_nov)
              and np.array_equal(host(out_k[3]), m_insm)
              and (int(out_k[0].inserted) - int(corpus.inserted) - m_ins)
              % 2**32 == 0, f"fold {label}: the kernel differs from "
              f"fold_model")
        return out_k, stats, plain_ms

    px_scfg = px_hunt.search(True)
    fold_runs = {}
    floor_ms = fold_kernel.launch_floor_ms(dev)
    floor_call_ms = fold_kernel.launch_floor_ms(dev, per_call=True)
    for w in (FOLD_WIDE, FOLD_NARROW):
        eng = make_engine((px_fam, px_ak, px_ck))
        state = eng.run_steps(eng.init(np.arange(w), faults=np.asarray(
            px_t, np.int32)), 200)
        sigs = behavior_signature(state.metrics)
        mask = ~state.active | (torch.arange(w, device=dev) % 3 == 0)
        sched = torch.from_numpy(children(px_hunt, w, 2)).to(dev)
        entries = torch.arange(w, dtype=torch.int32, device=dev) + 1
        depths = (torch.arange(w, dtype=torch.int32, device=dev) % 5)
        corpus = corpus_init(px_scfg.corpus, np.asarray(px_t, np.int32), dev)
        k = px_scfg.corpus
        call_ms, device_ms, host_us = [], [], []
        n_ins, chain_ms, replaced = [], [], []
        for rep in range(2):
            args = (corpus, sched, sigs, mask, px_scfg.min_novelty, entries,
                    depths)
            out_k, stats, plain_ms = fold_checked(f"W={w} #{rep}", *args)
            times = []
            for _t in range(5):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                harvest_fold(*args, with_masks=True)
                e1.record()
                e1.synchronize()
                times.append(e0.elapsed_time(e1))
            call_ms.append(sorted(times)[len(times) // 2])
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(SLEEP_CYCLES)
            e0.record()
            for _t in range(FOLD_QUEUED):
                harvest_fold(*args, with_masks=True)
            e1.record()
            check(not e0.query(), "fold timing: the device reached the "
                  "queued folds before they were all queued")
            e1.synchronize()
            device_ms.append(e0.elapsed_time(e1) / FOLD_QUEUED)
            t0 = time.perf_counter()
            for _t in range(FOLD_HOST_CALLS):
                harvest_fold(*args, with_masks=True)
            host_us.append((time.perf_counter() - t0) / FOLD_HOST_CALLS
                           * 1e6)
            torch.cuda.synchronize()
            n_ins.append(int(out_k[1]))
            replaced.append(stats["replaced"])
            chain_ms.append(fold_kernel.chain_ms(
                stats["rounds"], n_ins[-1], k, stats["filled"], dev))
            corpus = out_k[0]
        rows = int(mask.sum())
        # Bytes a fold must move: the old corpus read once and the new one
        # written once (K entries of schedule row, signature (int64
        # carrier), score, fill, entry and depth, and the insert counter);
        # every row's mask byte and its two output bytes; each masked row's
        # signature; per entry the fold replaced, its source row's
        # schedule, entry and depth; and the insert count. Each timing is
        # the mean of the two folds, so the replaced entries are too.
        row_bytes = sched[0].numel() * 4
        fold_bytes = (2 * k * (row_bytes + 21) + 12 + 3 * w + rows * 8
                      + sum(replaced) / 2 * (row_bytes + 8))
        fold_runs[w] = dict(
            ms=sum(device_ms) / 2, call_ms=sum(call_ms) / 2,
            host_us=sum(host_us) / 2, rows=rows,
            n_ins=n_ins, plain_ms=plain_ms,
            bound_ms=fold_bytes / HBM_BYTES_PER_S * 1e3,
            chain_ms=sum(chain_ms) / 2, floor_ms=floor_ms,
            floor_call_ms=floor_call_ms)
        log(f"[4 fold] corpus fold kernel vs plain and model, W={w}, K={k}, "
            f"min_novelty {px_scfg.min_novelty}, lineage on: two folds "
            f"bitwise equal ({rows} rows in the mask, inserts {n_ins}); "
            f"kernel per call {call_ms[0]:.4f} / {call_ms[1]:.4f} ms "
            f"(median of 5, the wrapper inside), on the device "
            f"{device_ms[0]:.4f} / {device_ms[1]:.4f} ms per fold "
            f"({FOLD_QUEUED} queued behind a sleep); the wrapper's host "
            f"time {host_us[0]:.1f} / {host_us[1]:.1f} us per call "
            f"({FOLD_HOST_CALLS} back to back); plain version "
            f"{plain_ms:.1f} ms; bytes bound "
            f"{fold_runs[w]['bound_ms'] * 1e3:.4f} us ({fold_bytes:.0f} B); "
            f"the dependent chain of its rounds and inserts alone "
            f"{chain_ms[0]:.4f} / {chain_ms[1]:.4f} ms on the device; launch "
            f"floor {floor_ms:.4f} ms on the device, {floor_call_ms:.4f} ms "
            f"per call; chain over device time "
            f"{fold_runs[w]['chain_ms'] / fold_runs[w]['ms']:.3f}")
        del state

    # (b) Adversarial folds at K in FOLD_KS, numpy-made from a seed, each
    # held to the plain fold and the model: rows not a multiple of 32 and
    # none; min_novelty from 1 to 33; duplicate and all-equal signatures;
    # tied scores; unfilled entries; masks empty, full and sparse; every
    # row inserting; the insert counter near 2^32; lineage lanes absent.
    fold_rng = np.random.default_rng(11)

    def adversarial(k, kind):
        f_rows = 6
        w = {"no_rows": 0, "every_insert": min(k, 300)}.get(kind, 300)
        score = fold_rng.integers(-1, 12, k).astype(np.int32)
        filled = fold_rng.random(k) < 0.6
        sig = fold_rng.integers(0, 2**32, k, dtype=np.uint64)
        pool = fold_rng.integers(0, 2**32, 7, dtype=np.uint64)
        sigs = pool[fold_rng.integers(0, 7, w)]
        mask = fold_rng.random(w) < 0.3
        min_nov = int(fold_rng.integers(1, 34))
        inserted = int(fold_rng.integers(0, 2**31))
        lineage = True
        if kind == "all_equal":
            sigs[:] = pool[0]
            mask[:] = True
            min_nov = 1
        elif kind == "ties":
            score[:] = 3
            filled[:] = True
            sig[:] = pool[fold_rng.integers(0, 7, k)]
            mask[:] = True
            min_nov = int(fold_rng.integers(1, 8))
        elif kind == "empty_mask":
            mask[:] = False
        elif kind == "every_insert":
            filled[:] = False
            sigs = np.arange(w, dtype=np.uint64) * 2654435761 % 2**32
            mask[:] = True
            min_nov = 1
        elif kind == "no_lineage":
            inserted = 2**31 - 3 if k % 2 else -2
            lineage = False
            mask[:] = True
            min_nov = int(fold_rng.integers(1, 4))
        elif kind == "high_novelty":
            min_nov = 33
            filled[:] = False
            mask[:] = True
        hc = HostCorpus(
            sched=fold_rng.integers(-1, 9, (k, f_rows, 4)).astype(np.int32),
            sig=sig.astype(np.uint32), score=score, filled=filled,
            entry=fold_rng.integers(-1, 99, k).astype(np.int32),
            depth=fold_rng.integers(0, 9, k).astype(np.int32))
        c = corpus_to_device(hc, 3, inserted, dev)

        def t(x, dtype):
            return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)

        rows = t(fold_rng.integers(-1, 9, (w, f_rows, 4)), torch.int32)
        ent = t(fold_rng.integers(0, 999, w), torch.int32) if lineage \
            else None
        dep = t(fold_rng.integers(0, 9, w), torch.int32) if lineage \
            else None
        return (c, rows, t(sigs.astype(np.int64), torch.int64),
                t(mask, torch.bool), min_nov, ent, dep)

    kinds = ("random", "all_equal", "ties", "empty_mask", "every_insert",
             "no_lineage", "high_novelty", "no_rows")
    adv_ins = {}
    for k in FOLD_KS:
        for kind in kinds:
            out_k, stats, _ = fold_checked(f"K={k} {kind}",
                                           *adversarial(k, kind))
            adv_ins[(k, kind)] = (int(out_k[1]), stats["rounds"])
    every = [v[0] == min(k, 300) for (k, kind), v in adv_ins.items()
             if kind == "every_insert"]
    check(all(every), f"fold: an every-row-inserts case did not insert "
          f"every row: {adv_ins}")
    log(f"[4 fold] corpus fold kernel vs plain and model at K in "
        f"{FOLD_KS}: {len(adv_ins)} adversarial folds bitwise equal "
        f"({', '.join(kinds)}); inserts and rounds by K: "
        + "; ".join(f"K={k}: " + ", ".join(
            f"{kind} {adv_ins[(k, kind)][0]}/{adv_ins[(k, kind)][1]}"
            for kind in kinds) for k in FOLD_KS))

    # ---- 5. held to JAX without JAX ---------------------------------------
    for name, (rk, ck, faults, max_steps) in golden.CONFIGS.items():
        eng = DeviceEngine(RaftActor(RaftDeviceConfig(**rk)),
                           EngineConfig(**ck), device=dev)
        fa = None if faults is None else np.asarray(faults, np.int32)
        obs = eng.observe(eng.run(eng.init(golden.SEEDS, faults=fa),
                                  max_steps))
        digest = golden.observe_digest(obs)
        check(digest == golden.GOLDEN[name],
              f"{name}: observe() digest {digest} != JAX-derived "
              f"{golden.GOLDEN[name]}")
        log(f"[5 golden] {name}: observe() digest equals the JAX-derived "
            f"constant")
    rk, ck, faults, max_steps = golden.CONFIGS["hunt_faults"]
    fa = np.asarray(faults, np.int32)
    eng = DeviceEngine(RaftActor(RaftDeviceConfig(**rk)),
                       EngineConfig(**ck, **golden.OBS_ON), device=dev)
    digest = golden.observe_digest(eng.observe(eng.run(
        eng.init(golden.SEEDS, faults=fa), max_steps)))
    check(digest == golden.GOLDEN_OBS, f"hunt_faults with {golden.OBS_ON}: "
          f"observe() digest {digest} != JAX-derived {golden.GOLDEN_OBS}")
    log(f"[5 golden] hunt_faults with {golden.OBS_ON}: observe() digest "
        f"equals the JAX-derived constant")
    sp = golden.SWEEP
    eng = DeviceEngine(RaftActor(RaftDeviceConfig(**rk)),
                       EngineConfig(**ck, **sp["over"]), device=dev)
    res = sweep(None, eng.cfg, sp["seeds"], faults=fa, engine=eng,
                pipeline=False, **sp["kwargs"])
    digest = golden.sweep_digest(res)
    check(digest == golden.GOLDEN_SWEEP, f"recycled sweep digest {digest} "
          f"!= JAX-derived {golden.GOLDEN_SWEEP}")
    log(f"[5 golden] recycled sweep of {len(sp['seeds'])} seeds "
        f"({sp['kwargs']}, {sp['over']}): SweepResult digest equals the "
        f"JAX-derived constant ({len(res.failing_seeds)} failing, "
        f"{res.loop_stats['chunks']} chunks)")
    # The same sweep through the pipelined and the fused loop, held to the
    # same constant (JAX holds its loops equal); the fused loop never
    # shrinks, so its world_utilization, and with it summary(), is the
    # serial run's only once that one field is exempt.
    for loop in ("pipeline", "fused"):
        res_l = sweep(None, eng.cfg, sp["seeds"], faults=fa, engine=eng,
                      **dict(sp["kwargs"], pipeline=loop == "pipeline",
                             fused=loop == "fused"))
        if loop == "fused":
            res_l = dataclasses.replace(
                res_l, world_utilization=res.world_utilization)
        digest = golden.sweep_digest(res_l)
        check(digest == golden.GOLDEN_SWEEP, f"{loop} recycled sweep "
              f"digest {digest} != JAX-derived {golden.GOLDEN_SWEEP}")
        log(f"[5 golden] the same sweep, {loop}: SweepResult digest equals "
            f"the JAX-derived constant"
            + (" (world_utilization exempt)" if loop == "fused" else "")
            + f"; {res_l.loop_stats['dispatches']} dispatches")
    for name in golden.WIDE_CONFIGS:
        fam, ak, ck, faults, max_steps = golden.wide_config(name)
        eng = make_engine((fam, ak, ck))
        fa = None if faults is None else np.asarray(faults, np.int32)
        obs = eng.observe(eng.run(eng.init(golden.SEEDS, faults=fa),
                                  max_steps))
        digest = golden.observe_digest(obs)
        check(digest == golden.GOLDEN_WIDE[name],
              f"{name} (wide): observe() digest {digest} != JAX-derived "
              f"{golden.GOLDEN_WIDE[name]}")
        log(f"[5 golden] {name} ({route_key(eng)}, packed=False): observe() "
            f"digest equals the JAX-derived constant "
            f"({int(obs['bug'].sum())} of 64 seeds failing)")
    for name, (fam, ak, ck, faults, max_steps) in \
            golden.FAMILY_CONFIGS.items():
        eng = make_engine((fam, ak, ck))
        fa = None if faults is None else np.asarray(faults, np.int32)
        obs = eng.observe(eng.run(eng.init(golden.SEEDS, faults=fa),
                                  max_steps))
        digest = golden.observe_digest(obs)
        check(digest == golden.GOLDEN_FAMILIES[name],
              f"{name}: observe() digest {digest} != JAX-derived "
              f"{golden.GOLDEN_FAMILIES[name]}")
        log(f"[5 golden] {name} ({fam}): observe() digest equals the "
            f"JAX-derived constant ({int(obs['bug'].sum())} of 64 seeds "
            f"failing)")
    for name, (fam, ak, ck, faults, max_steps) in \
            golden.SEARCH_CONFIGS.items():
        eng = make_engine((fam, ak, ck))
        obs = eng.observe(eng.run(eng.init(
            golden.SEEDS, faults=np.asarray(faults, np.int32)), max_steps))
        digest = golden.observe_digest(obs)
        check(digest == golden.GOLDEN_SEARCH[name],
              f"{name}: observe() digest {digest} != JAX-derived "
              f"{golden.GOLDEN_SEARCH[name]}")
        log(f"[5 golden] {name} ({fam}, the guided search's deployment at "
            f"its template): observe() digest equals the JAX-derived "
            f"constant")
    # ---- 6. the main path at full size ------------------------------------
    engines = {name: DeviceEngine(RaftActor(RaftDeviceConfig(**rk)),
                                  EngineConfig(**ck), device=dev)
               for name, (rk, ck), _f, _w, _m in mains}
    results = {}
    step_kernel.launches = 0
    for name, _cfgs, faults, w, max_steps in mains:
        eng = engines[name]
        before = step_kernel.launches
        best_init = best_run = float("inf")
        for rep in range(4):  # rep 0 warms up
            seeds = np.arange(w)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state = eng.init(seeds, faults=faults)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            n0 = step_kernel.launches
            state = eng.run(state, max_steps)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            if rep:
                best_init = min(best_init, t1 - t0)
                best_run = min(best_run, t2 - t1)
        obs = eng.observe(state)
        stats = eng.last_run_stats()
        results[name] = dict(
            w=w, init_s=best_init, run_s=best_run, obs=obs,
            launches=step_kernel.launches - before,
            run_launches=stats["launches"] - stats["noops"],
            all_launches=stats["launches"], noops=stats["noops"],
            seeds=seeds, state_bytes=sum(x.numel() * x.element_size()
                                         for x in tree_leaves(state)))
        del state
    main_launches = step_kernel.launches

    for name, r in results.items():
        obs = r["obs"]
        check(r["launches"] > 0, f"{name}: the step kernel never launched")
        check(not obs["active"].any(), f"{name}: worlds left active")
    hl, hunt = results["headline"], results["hunt"]
    check(not hl["obs"]["bug"].any(), "headline: the clean config flagged "
          "a bug")
    check(not hl["obs"]["overflow"].any(), "headline: queue overflow")
    check(hunt["obs"]["bug"].any(), "hunt: no bug found")

    # Outside the counted main path: the kernel's device time over the
    # run's own launches, the plain step's time, and the bytes each step
    # must move at the least; and the run loop as it was before this
    # slice, for its launches and idle share.
    def old_run_s(eng, w, max_steps, faults=None, every=16):
        """Best of 3 walls of a run loop that syncs with the host every 16
        launches (it tests active.any(), a device sync, before each 16),
        and its launches: the loop ``DeviceEngine.run`` replaced."""
        best = float("inf")
        for _rep in range(3):
            state = eng.init(np.arange(w), faults=faults)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            i = 0
            while i < max_steps and bool(state.active.any()):
                k = min(every, max_steps - i)
                eng.run_steps(state, k)
                i += k
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
            del state
        return best, i

    def device_ms(eng, w, total, faults=None):
        """Device ms of each chunk of TIMED_STEPS launches, over the
        ``total`` launches a run made from a fresh init. Each chunk is
        queued behind a sleeping kernel, and the check that the chunk's
        first event had not run when its last launch was queued proves
        that its launches ran back to back: the event pair holds the
        kernels and the gaps between them, not the host's launch cost."""
        state = eng.init(np.arange(w), faults=faults)
        leaves = tree_leaves(state)
        chunks = []
        while sum(k for k, _ in chunks) < total:
            k = min(TIMED_STEPS, total - sum(k for k, _ in chunks))
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(SLEEP_CYCLES)
            e0.record()
            step_kernel.launch(eng, leaves, k)
            e1.record()
            check(not e0.query(), "timing: the device reached the timed "
                  "launches before they were all queued")
            e1.synchronize()
            chunks.append((k, e0.elapsed_time(e1)))
        return chunks

    def plain_ms_per_step(eng, w, n=3, faults=None):
        """Event pair over n plain steps; the plain step syncs with the
        host inside (it skips branches no world takes), so this is its
        wall time on the device's clock."""
        state = eng.step_plain(eng.init(np.arange(w), faults=faults))
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(n):
            state = eng.step_plain(state)
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / n

    def lane_bytes(before, state):
        """Bytes one step moved in the optional lanes, per world: each
        metrics counter it changed is read and written (8 bytes), and a
        world that recorded a ring event read and wrote the ring's
        position (8 bytes) and wrote the 10-byte record."""
        out = torch.zeros_like(state.steps, dtype=torch.int64)
        if before is None:
            return out
        mb0, pos0 = before
        if mb0 is not None:
            for x0, x in zip(mb0, state.metrics):
                changed = x0 != x
                out += 8 * changed.reshape(changed.shape[0], -1).sum(1)
        if pos0 is not None:
            out += 18 * (pos0 != state.blackbox.pos)
        return out

    def lanes_of(state):
        """What :func:`lane_bytes` compares a step's result with."""
        if state.metrics is None and state.blackbox is None:
            return None
        return (None if state.metrics is None
                else [x.clone() for x in state.metrics],
                None if state.blackbox is None
                else state.blackbox.pos.clone())

    def least_bytes(eng, w, total):
        """Bytes each of the run's ``total`` steps must move at the least:
        per active world the queue's time and meta lanes (the pop scans
        them), the popped payload row, the pause lane, the destination's
        alive and generation bytes, the RNG cursor and key, the net model,
        the scalar lanes read and written, and the invariant's commit and
        log lanes of every node; per frozen world its active flag, depth
        lanes, bug flag and the invariant's reads; the metrics and ring
        lanes as :func:`lane_bytes` counts them. The handler's rows and
        the inserted events are not counted, so this is a lower bound."""
        cfg, L = eng.cfg, eng.actor.rcfg.log_cap
        n, q, p = cfg.n_nodes, cfg.queue_cap, cfg.payload_words
        inv = 2 * n + 4 * n * L
        frozen = 1 + 4 + 1 + inv
        active = (8 * q + 2 * p + n + 2 + 12 + 12 + inv
                  + 2 * (1 + 4 + 4 + 4 + 4) + 1 + 4 + 4)
        state = eng.init(np.arange(w))
        out = []
        for _ in range(total):
            a = int(state.active.sum())
            before = lanes_of(state)
            eng.run_steps(state, 1)
            out.append(a * active + (w - a) * frozen
                       + int(lane_bytes(before, state).sum()))
        return out

    def needed_bytes(eng, w, total):
        """Bytes each of the run's ``total`` steps needs, from this run's
        state: :func:`least_bytes`'s count, except that the invariant's log
        entries are counted only over each node pair's committed prefix
        (and none where the bug flag is already set), and the queue's meta
        lane whole only for a world with a paused node (else the popped
        slot's word). A frozen world reads its flags, depth lanes and
        commit row. The metrics and ring lanes count what :func:`lane_bytes`
        counts (nothing for a frozen world)."""
        cfg, L = eng.cfg, eng.actor.rcfg.log_cap
        n, q, p = cfg.n_nodes, cfg.queue_cap, cfg.payload_words
        # The payload, commit and log lanes' element: 2 bytes packed, 4
        # wide.
        e = 2 if cfg.packed else 4
        frozen = 1 + 4 + 1 + e * n
        active = (4 * q + 4 + e * p + n + 2 + 12 + 12 + e * n
                  + 2 * (1 + 4 + 4 + 4 + 4) + 1 + 4 + 4)
        off_diag = ~torch.eye(n, dtype=torch.bool, device=dev)
        state = eng.init(np.arange(w))
        out = []
        for _ in range(total):
            c = state.astate.commit.to(torch.int64).clamp(0, L)
            pair = torch.minimum(c[:, :, None], c[:, None, :]) * off_diag
            log_b = 2 * e * pair.amax(2).sum(1) * ~state.bug
            meta_b = 4 * (q - 1) * state.paused.any(1)
            step_b = (torch.where(state.active, active + meta_b, frozen)
                      + log_b)
            before = lanes_of(state)
            eng.run_steps(state, 1)
            out.append((step_b + lane_bytes(before, state)).sum())
        return [int(x) for x in torch.stack(out).cpu()]

    def active_shares(eng, w, total, faults=None):
        """Mean share of active worlds over each chunk of TIMED_STEPS of the
        run's ``total`` steps, replayed from a fresh init."""
        state = eng.init(np.arange(w), faults=faults)
        counts = []
        for _ in range(total):
            counts.append(state.active.sum())
            eng.run_steps(state, 1)
        counts = torch.stack(counts).cpu().numpy() / w
        return [float(counts[i:i + TIMED_STEPS].mean())
                for i in range(0, total, TIMED_STEPS)]

    for name, r in results.items():
        eng = engines[name]
        plan = step_kernel.tile_plan(eng.cfg, eng.actor.rcfg.log_cap)
        log(f"[6 main] {name}: tile plan {plan.block} worlds per block, "
            f"{plan.smem_bytes} B shared memory, strides q {plan.q_stride} "
            f"int32, commit {plan.commit_stride} / log {plan.log_stride} "
            f"int16")
        steps_run = r["run_launches"]
        chunks = device_ms(eng, r["w"], steps_run)
        r["active_share"] = active_shares(eng, r["w"], steps_run)
        per_step = least_bytes(eng, r["w"], steps_run)
        needed = needed_bytes(eng, r["w"], steps_run)
        first_k, first_ms = chunks[0]
        r["first_ms"] = first_ms / first_k
        r["first_bound_ms"] = (sum(needed[:first_k]) / first_k
                               / HBM_BYTES_PER_S * 1e3)
        r["busy_ms"] = sum(ms for _k, ms in chunks)
        r["kernel_ms"] = r["busy_ms"] / steps_run
        r["needed_bytes"] = sum(needed) / steps_run
        r["bound_ms"] = r["needed_bytes"] / HBM_BYTES_PER_S * 1e3
        r["least_bytes"] = sum(per_step) / steps_run
        r["least_bound_ms"] = r["least_bytes"] / HBM_BYTES_PER_S * 1e3
        r["plain_ms"] = plain_ms_per_step(eng, r["w"])
        r["full_state_ms"] = 2 * r["state_bytes"] / HBM_BYTES_PER_S * 1e3
        r["old_run_s"], r["old_launches"] = old_run_s(eng, r["w"], 100_000)
        obs = r["obs"]
        bugs = np.flatnonzero(obs["bug"])
        log(f"[6 main] {name}: W={r['w']} init {r['init_s'] * 1e3:.2f} ms, "
            f"run {r['run_s'] * 1e3:.2f} ms (best of 3); "
            f"{r['w'] / (r['init_s'] + r['run_s']):.0f} worlds/s incl. "
            f"init, {r['w'] / r['run_s']:.0f} run only; {steps_run} "
            f"launches per run (max world steps {int(obs['steps'].max())}, "
            f"mean {float(obs['steps'].mean()):.1f}), "
            f"{r['run_s'] * 1e3 / steps_run:.4f} ms/step wall")
        log(f"[6 main] {name}: kernel device time over the run's "
            f"{steps_run} launches {r['busy_ms']:.3f} ms = "
            f"{r['kernel_ms']:.4f} ms/step against a bound of "
            f"{r['bound_ms']:.4f} ms for the bytes its steps need "
            f"({r['needed_bytes'] / 1e6:.1f} MB/step; share "
            f"{r['bound_ms'] / r['kernel_ms']:.3f}) and PR 1's "
            f"least-traffic bound of {r['least_bound_ms']:.4f} ms "
            f"({r['least_bytes'] / 1e6:.1f} MB/step; share "
            f"{r['least_bound_ms'] / r['kernel_ms']:.3f}); device idle "
            f"share of the run {1 - r['busy_ms'] / (r['run_s'] * 1e3):.3f}")
        log(f"[6 run loop] {name}: DeviceEngine.run queued "
            f"{r['all_launches']} launches ({r['noops']} no-ops past "
            f"the last freeze, {steps_run} stepping), wall "
            f"{r['run_s'] * 1e3:.2f} ms, idle share "
            f"{1 - r['busy_ms'] / (r['run_s'] * 1e3):.3f}; the loop that "
            f"syncs every 16 launches: {r['old_launches']} "
            f"launches, wall {r['old_run_s'] * 1e3:.2f} ms, idle share "
            f"{1 - r['busy_ms'] / (r['old_run_s'] * 1e3):.3f}")
        log(f"[6 main] {name}: kernel ms/step by chunk of {TIMED_STEPS} "
            f"launches: " + ", ".join(f"{ms / k:.4f}" for k, ms in chunks)
            + f"; first chunk bound {r['first_bound_ms']:.4f} ms; "
            f"full-state traffic 2 x {r['state_bytes'] / 1e6:.1f} MB = "
            f"{r['full_state_ms']:.4f} ms ({r['state_bytes'] / r['w']:.0f} "
            f"B/world); plain step {r['plain_ms']:.3f} ms (no yardstick)")
        log(f"[6 main] {name}: active-world share by chunk of {TIMED_STEPS} "
            f"launches: " + ", ".join(f"{a:.4f}" for a in r["active_share"]))
        log(f"[6 main] {name}: elected {int(obs['leader_elected'].sum())}/"
            f"{r['w']}; overflow {int(obs['overflow'].sum())}; bugs "
            f"{len(bugs)}" + (f", first failing seed {int(r['seeds'][bugs[0]])}"
                              if len(bugs) else ""))
    log(f"[6 main] step kernel launches on the main path: {main_launches}")

    # Worlds per block: the same timing at each size whose tiles fit, each
    # run's observations held to the main run's.
    for name, (rk, ck), faults, w, max_steps in mains:
        r = results[name]
        times = []
        for block in BLOCK_SWEEP:
            eng = DeviceEngine(RaftActor(RaftDeviceConfig(**rk)),
                               EngineConfig(**ck, pallas_block=block),
                               device=dev)
            try:
                step_kernel.tile_plan(eng.cfg, eng.actor.rcfg.log_cap)
            except ValueError:
                times.append(f"B={block} does not fit")
                continue
            obs = eng.observe(eng.run(eng.init(r["seeds"], faults=faults),
                                      max_steps))
            check(golden.observe_digest(obs)
                  == golden.observe_digest(r["obs"]),
                  f"{name}: pallas_block={block} changed the observations")
            chunks = device_ms(eng, w, r["run_launches"])
            per_step = sum(ms for _k, ms in chunks) / r["run_launches"]
            times.append(f"B={block} {per_step:.4f}")
        log(f"[6 blocks] {name}: kernel ms/step over the run's "
            f"{r['run_launches']} launches: " + ", ".join(times))
    # ---- 6, the compiled families: each deployment at full size ----------
    def family_needed_bytes(eng, w, total, faults):
        """Bytes each of a family run's ``total`` steps needs, from this
        run's state: per active world the engine's part of
        :func:`needed_bytes` (the queue's time lane, the popped meta word,
        or the meta lane where a node is paused, the payload row, the
        scalar lanes and the net model); per frozen world its flags and
        depth lanes; per world whose bug flag is not yet set, what the
        invariant reads (tpc: the N x T decision table; pb: committed_max,
        and past it the views, the primary's log length, and the log row
        and committed_cmd over the committed prefix; Paxos: the N x S
        chosen table; pair: the two targets' counters); per delivered event
        the handler's reads (tpc: decided, decision, voted and votes_yes at
        the txn, 7 B; pb: the node's view, log_len, commit and wd_epoch,
        8 B; Paxos: the six int16 lanes at the node's slot, 12 B; pair:
        nothing); the actor lanes' bytes the step changed, written once;
        and the metrics and ring lanes as :func:`lane_bytes` counts
        them."""
        cfg, fam = eng.cfg, step_kernel.family_of(eng.actor).route
        n, q, p = cfg.n_nodes, cfg.queue_cap, cfg.payload_words
        # The int8 and int16 lanes' elements: 1 and 2 bytes packed, 4 wide.
        e1, e2 = (1, 2) if cfg.packed else (4, 4)
        active = (4 * q + 4 + e2 * p + n + 2 + 12 + 12
                  + 2 * (1 + 4 + 4 + 4 + 4) + 1 + 4 + 4)
        frozen = 1 + 4 + 1
        state = eng.init(np.arange(w), faults=faults)
        out = []
        for _ in range(total):
            a0 = {k: x.clone() for k, x in state.astate.items()}
            act, bug0 = state.active.clone(), state.bug.clone()
            deliv0 = state.delivered.clone()
            meta_b = 4 * (q - 1) * state.paused.any(1)
            if fam == "tpc":
                inv = e1 * n * eng.actor.tcfg.n_txns
                handler = 3 * e1 + 4
            elif fam == "paxos":
                inv = e2 * n * eng.actor.xcfg.n_slots
                handler = 6 * e2
            elif fam == "pair":
                inv = 8
                handler = 0
            else:
                cm = a0["committed_max"].to(torch.int64)
                lim = cm.clamp(0, eng.actor.pcfg.log_cap)
                inv = e2 + (cm > 0) * (e2 * n + e2 + 2 * e2 * lim)
                handler = 4 * e2
            before = lanes_of(state)
            eng.run_steps(state, 1)
            written = sum(
                (x != a0[k]).reshape(w, -1).sum(1) * x.element_size()
                for k, x in state.astate.items())
            step_b = (torch.where(act, active + meta_b, frozen)
                      + inv * ~bug0
                      + handler * (state.delivered != deliv0)
                      + written + lane_bytes(before, state))
            out.append(step_b.sum())
        return [int(x) for x in torch.stack(out).cpu()]

    fam_results, fam_launches = {}, {}
    # Whether each deployment finds a bug: the crosscheck legs' tpc and the
    # pb hunt do; the clean pb leg and the guided search's two templates
    # (no subset of either can fail) do not.
    expect_bug = {"tpc_crosscheck": True, "pb_crosscheck": False,
                  "pb_hunt": True, "paxos_hunt": False, "guided_pair": False}
    for name, (fam, ak, ck, faults, max_steps) in \
            {**golden.FAMILY_CONFIGS, **golden.SEARCH_CONFIGS}.items():
        eng = make_engine((fam, ak, ck))
        fam = step_kernel.family_of(eng.actor).route
        fa = None if faults is None else np.asarray(faults, np.int32)
        w = W_FAMILY
        step_kernel.launches = 0
        best_init = best_run = float("inf")
        for rep in range(4):  # rep 0 warms up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state = eng.init(np.arange(w), faults=fa)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            n0 = step_kernel.launches
            state = eng.run(state, max_steps)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            if rep:
                best_init = min(best_init, t1 - t0)
                best_run = min(best_run, t2 - t1)
        launched = step_kernel.launches
        fam_launches[fam] = fam_launches.get(fam, 0) + launched
        stats = eng.last_run_stats()
        steps_run = stats["launches"] - stats["noops"]
        obs = eng.observe(state)
        del state
        check(launched > 0, f"{name}: the step kernel never launched")
        check(not obs["active"].any(), f"{name}: worlds left active")
        check(obs["bug"].any() == expect_bug[name],
              f"{name}: {int(obs['bug'].sum())} failing worlds, against "
              f"the deployment's expectation")
        n0 = step_kernel.launches
        shares = active_shares(eng, w, steps_run, fa)
        check(step_kernel.launches - n0 == steps_run,
              f"{name}: {step_kernel.launches - n0} launches for "
              f"{steps_run} steps")
        chunks = device_ms(eng, w, steps_run, fa)
        needed = family_needed_bytes(eng, w, steps_run, fa)
        busy = sum(ms for _k, ms in chunks)
        old_s, old_launches = old_run_s(eng, w, max_steps, fa)
        r = dict(w=w, kernel_ms=busy / steps_run,
                 needed_bytes=sum(needed) / steps_run,
                 plain_ms=plain_ms_per_step(eng, w, faults=fa),
                 launches=launched)
        r["bound_ms"] = r["needed_bytes"] / HBM_BYTES_PER_S * 1e3
        fam_results[name] = r
        plan = step_kernel.engine_plan(eng)
        state_b = sum(int(np.prod(shape)) * torch.empty(
            0, dtype=dtype).element_size()
            for _n, dtype, shape in eng.state_layout())
        bugs = np.flatnonzero(obs["bug"])
        log(f"[6 family] {name} ({fam}, N={eng.cfg.n_nodes}, "
            f"Q={eng.cfg.queue_cap}, P={eng.cfg.payload_words}, "
            f"M={eng.cfg.m}): tile plan {plan.block} worlds per "
            f"block, {plan.smem_bytes} B shared memory (queue tiles only), "
            f"{state_b} state B/world")
        log(f"[6 family] {name}: W={w} init {best_init * 1e3:.2f} ms, run "
            f"{best_run * 1e3:.2f} ms (best of 3); "
            f"{w / (best_init + best_run):.0f} worlds/s incl. init, "
            f"{w / best_run:.0f} run only; {steps_run} launches per run "
            f"(max world steps {int(obs['steps'].max())}, mean "
            f"{float(obs['steps'].mean()):.1f}), "
            f"{best_run * 1e3 / steps_run:.4f} ms/step wall; {launched} "
            f"launches on this path (4 runs)")
        log(f"[6 family] {name}: kernel device time over the run's "
            f"{steps_run} launches {busy:.3f} ms = {r['kernel_ms']:.4f} "
            f"ms/step against a bound of {r['bound_ms']:.4f} ms for the "
            f"bytes its steps need ({r['needed_bytes'] / 1e6:.2f} MB/step; "
            f"share {r['bound_ms'] / r['kernel_ms']:.3f}); device idle "
            f"share of the run {1 - busy / (best_run * 1e3):.3f}; plain "
            f"step {r['plain_ms']:.3f} ms (no yardstick)")
        log(f"[6 run loop] {name}: DeviceEngine.run queued "
            f"{stats['launches']} launches ({stats['noops']} no-ops past "
            f"the last freeze), wall {best_run * 1e3:.2f} ms, "
            f"idle share {1 - busy / (best_run * 1e3):.3f}; the loop that "
            f"syncs every 16 launches: {old_launches} launches, "
            f"wall {old_s * 1e3:.2f} ms, idle share "
            f"{1 - busy / (old_s * 1e3):.3f}")
        log(f"[6 family] {name}: kernel ms/step by chunk of {TIMED_STEPS} "
            f"launches: " + ", ".join(f"{ms / k:.4f}" for k, ms in chunks))
        log(f"[6 family] {name}: active-world share by chunk of "
            f"{TIMED_STEPS} launches: " + ", ".join(f"{a:.4f}"
                                                    for a in shares))
        log(f"[6 family] {name}: bugs {len(bugs)}"
            + (f", first failing seed {int(bugs[0])}" if len(bugs) else "")
            + f"; overflow {int(obs['overflow'].sum())}")

    # ---- 6, the wide lane profile: each deployment at full size ----------
    # The headline, the hunt and every family deployment with
    # packed=False: the kernel's time per step over the run's own
    # launches against the bytes its steps need with the wide lanes'
    # widths, and the state bytes per world beside the packed profile's.
    wide_results, wide_launches = {}, {}
    wide_cases = [(name, ("raft", *cfgs), faults, w, max_steps)
                  for name, cfgs, faults, w, max_steps in mains]
    wide_cases += [(name, (fam, ak, ck),
                    None if faults is None else np.asarray(faults, np.int32),
                    W_FAMILY, max_steps)
                   for name, (fam, ak, ck, faults, max_steps) in
                   {**golden.FAMILY_CONFIGS, **golden.SEARCH_CONFIGS}.items()]
    for name, cfgs, fa, w, max_steps in wide_cases:
        packed_eng = make_engine(cfgs)
        eng = make_engine(cfgs, packed=False)
        route = route_key(eng)
        n0 = step_kernel.launches
        best_run = float("inf")
        for _rep in range(3):  # rep 0 warms up
            state = eng.init(np.arange(w), faults=fa)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state = eng.run(state, max_steps)
            torch.cuda.synchronize()
            if _rep:
                best_run = min(best_run, time.perf_counter() - t0)
        launched = step_kernel.launches - n0
        wide_launches[route] = wide_launches.get(route, 0) + launched
        check(launched > 0, f"{name} (wide): the step kernel never launched")
        check(not bool(state.active.any()), f"{name} (wide): worlds left "
              f"active")
        stats = eng.last_run_stats()
        steps_run = stats["launches"] - stats["noops"]
        del state
        chunks = device_ms(eng, w, steps_run, fa)
        busy = sum(ms for _k, ms in chunks)
        needed = (needed_bytes(eng, w, steps_run) if route.startswith("raft")
                  else family_needed_bytes(eng, w, steps_run, fa))
        r = dict(kernel_ms=busy / steps_run,
                 needed_bytes=sum(needed) / steps_run, launches=launched)
        r["bound_ms"] = r["needed_bytes"] / HBM_BYTES_PER_S * 1e3
        if name in ("headline", "tpc_crosscheck", "pb_crosscheck",
                    "paxos_hunt", "guided_pair"):
            r["plain_ms"] = plain_ms_per_step(eng, min(w, W_FAMILY),
                                              faults=fa)
        wide_results[name] = r

        def per_world(e):
            return sum(int(np.prod(shape)) * torch.empty(
                0, dtype=dtype).element_size()
                for _n, dtype, shape in e.state_layout())

        log(f"[6 wide] {name} ({route}): W={w}, {per_world(eng)} state "
            f"B/world (packed {per_world(packed_eng)}); run "
            f"{best_run * 1e3:.2f} ms (best of 2), {steps_run} stepping "
            f"launches; kernel {r['kernel_ms']:.4f} ms/step against a "
            f"bound of {r['bound_ms']:.4f} ms for the bytes its steps need "
            f"({r['needed_bytes'] / 1e6:.2f} MB/step; share "
            f"{r['bound_ms'] / r['kernel_ms']:.3f}); idle share "
            f"{1 - busy / (best_run * 1e3):.3f}")

    # ---- 7. the bug hunt's sweep at full width -----------------------------
    # The bench's bug-hunt legs (bench.py bench_time_to_first_bug) on the
    # hunt's 65,536 seeds: (a) the recycled hunt, (b) position
    # independence with the metrics block and the coverage ledger, (c) the
    # flight recorder against a replay.
    hunt_rk = dict(n=3, buggy_double_vote=True)
    hunt_ck = golden.CONFIGS["hunt_faults"][1]      # stop_on_bug=False
    w = results["hunt"]["w"]
    seeds = np.arange(w)
    batch_w = max(256, w // 8)

    def hunt_engine(**over):
        return DeviceEngine(RaftActor(RaftDeviceConfig(**hunt_rk)),
                            EngineConfig(**dict(hunt_ck, **over)),
                            device=dev)

    def chunk_device_ms(eng, sleep_cycles=SLEEP_CYCLES // 10):
        """Make ``eng``'s chunks time themselves: each chunk's launches
        are queued behind a sleeping kernel (``sleep_cycles`` long) and
        held by a CUDA event pair (as in :func:`device_ms`); returns the
        list the times land in."""
        times = []
        real = eng.run_steps

        def run_steps(state, k, gate=None):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(sleep_cycles)
            e0.record()
            real(state, k, gate=gate)
            e1.record()
            check(not e0.query(), "sweep timing: the device reached a "
                  "chunk's launches before they were all queued")
            e1.synchronize()
            times.append(e0.elapsed_time(e1))
            return state

        eng.run_steps = run_steps
        return times

    def untimed(eng):
        """Undo :func:`chunk_device_ms`."""
        del eng.run_steps

    def count_fetches():
        """Count the sweep module's ``_fetch`` calls; returns the list the
        count lands in and a function that undoes it."""
        n = [0]
        real = sweep_mod._fetch

        def fetch(tree):
            n[0] += 1
            return real(tree)

        sweep_mod._fetch = fetch

        def undo():
            sweep_mod._fetch = real

        return n, undo

    def same_result(a, b, util=True):
        """Whether two SweepResults agree on every result (and on
        world_utilization unless ``util`` is False)."""
        ok = (a.failing_seeds == b.failing_seeds
              and a.steps_run == b.steps_run
              and sorted(a.observations) == sorted(b.observations)
              and all(np.array_equal(a.observations[k], b.observations[k])
                      for k in a.observations)
              and np.array_equal(a.n_active_history, b.n_active_history)
              and np.array_equal(a.n_active_chunks, b.n_active_chunks))
        if a.coverage is not None:
            ok = ok and all(np.array_equal(getattr(a.coverage, f),
                                           getattr(b.coverage, f))
                            for f in ("hits", "first_seen_seed",
                                      "novelty_curve"))
        if a.search is not None:
            ok = ok and (golden.search_digest(a.search)
                         == golden.search_digest(b.search)
                         and a.search.operator_stats
                         == b.search.operator_stats)
        if util:
            ok = ok and a.world_utilization == b.world_utilization
        return ok

    def loop_legs(tag, eng, seeds, kw, ref, sleep=SLEEP_CYCLES // 10,
                  admitted=None):
        """The leg through the pipelined and the fused loop, each held to
        the serial run ``ref`` (world_utilization exempt under fused),
        with its wall, seeds/s, dispatches, ``_fetch`` calls, the device
        flags the host read (each a wait on the device), the kernel's
        device time over its chunks (a timed replay) and the device idle
        share; the fused loop's epoch bodies' share of the wall. Returns
        the step kernel's launches and the fold kernel's."""
        launched = folds = 0
        for loop in ("pipeline", "fused"):
            lkw = dict(kw, pipeline=loop == "pipeline",
                       fused=loop == "fused")
            sweep(None, eng.cfg, seeds, engine=eng, **lkw)  # warm-up
            n0, f0 = step_kernel.launches, fold_kernel.launches
            fetches, undo = count_fetches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                res = sweep(None, eng.cfg, seeds, engine=eng, **lkw)
                torch.cuda.synchronize()
            finally:
                undo()
            wall = time.perf_counter() - t0
            n_launch = step_kernel.launches - n0
            launched += n_launch
            folds += fold_kernel.launches - f0
            check(same_result(ref, res, util=loop == "pipeline"),
                  f"{tag} {loop}: the result differs from the serial "
                  f"loop's")
            fused_stats = dict(getattr(eng, "last_fused_stats", {}))
            chunk_ms = chunk_device_ms(eng, sleep)
            try:
                res_t = sweep(None, eng.cfg, seeds, engine=eng, **lkw)
            finally:
                untimed(eng)
            check(res_t.failing_seeds == res.failing_seeds,
                  f"{tag} {loop}: the timed replay found other seeds")
            n_in = (admitted(res) if admitted else len(seeds))
            ls = res.loop_stats
            extra = ""
            if loop == "fused":
                extra = (f"; {fused_stats['chunks_queued']} chunks queued, "
                         f"epoch bodies {fused_stats['epoch_s'] * 1e3:.1f} "
                         f"ms of host time = "
                         f"{fused_stats['epoch_s'] / wall:.3f} of the wall")
            log(f"[{tag}] {loop}: equal to the serial run"
                + (" (world_utilization exempt)" if loop == "fused" else "")
                + f"; wall {wall * 1e3:.2f} ms, {n_in} seeds = "
                f"{n_in / wall:.0f} seeds/s; chunks {ls['chunks']}, "
                f"dispatches {ls['dispatches']}, _fetch calls {fetches[0]} "
                f"({ls['scalar_fetches']} scalar, {ls['retire_fetches']} "
                f"retire), device flags read {ls['flag_reads']}; "
                f"world_utilization {res.world_utilization:.4f}; "
                f"step kernel launches {n_launch} (the chunks' "
                f"{ls['chunks'] * ls['chunk_steps']} and the no-ops "
                f"past a stop); kernel device time {sum(chunk_ms):.3f} ms, "
                f"device idle share {1 - sum(chunk_ms) / (wall * 1e3):.3f}"
                + extra)
        return launched, folds

    # (a) the recycled hunt: stop at the first bug.
    eng_s = hunt_engine(stop_on_bug=True)
    leg_a = dict(chunk_steps=64, max_steps=4_000, stop_on_first_bug=True,
                 recycle=True, batch_worlds=batch_w, pipeline=False)
    sweep(None, eng_s.cfg, seeds, engine=eng_s, **leg_a)  # warm-up
    step_kernel.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res_a = sweep(None, eng_s.cfg, seeds, engine=eng_s, **leg_a)
    torch.cuda.synchronize()
    wall_a = time.perf_counter() - t0
    sweep_launches = step_kernel.launches
    check(sweep_launches > 0, "sweep: the step kernel never launched")
    check(res_a.failing_seeds, "recycled hunt: no bug found")
    admitted = int((res_a.observations["steps"] > 0).sum())
    chunk_ms = chunk_device_ms(eng_s)
    res_t = sweep(None, eng_s.cfg, seeds, engine=eng_s, **leg_a)
    untimed(eng_s)
    check(res_t.failing_seeds == res_a.failing_seeds,
          "recycled hunt: the timed replay found other seeds")
    ls = res_a.loop_stats
    log(f"[7 sweep a] recycled hunt, {w} seeds, batch {batch_w}, chunks of "
        f"64, stop at the first bug: wall {wall_a * 1e3:.2f} ms, "
        f"{admitted} seeds admitted = {admitted / wall_a:.0f} seeds/s; "
        f"failing {res_a.failing_seeds[:8]} ({len(res_a.failing_seeds)}); "
        f"world_utilization {res_a.world_utilization:.4f}; chunks "
        f"{ls['chunks']}, dispatches {ls['dispatches']}, scalar fetches "
        f"{ls['scalar_fetches']}, retire fetches {ls['retire_fetches']}; "
        f"step kernel launches {sweep_launches}, device time "
        f"{sum(chunk_ms):.3f} ms, device idle share "
        f"{1 - sum(chunk_ms) / (wall_a * 1e3):.3f}")

    def seeds_admitted(res):
        return int((res.observations["steps"] > 0).sum())

    n_loops, _ = loop_legs("7 sweep a", eng_s, seeds, leg_a, res_a,
                           admitted=seeds_admitted)
    sweep_launches += n_loops

    # (b) position independence: every seed swept to retirement, recycled,
    # metrics on, equals a monolithic init + run of the same seeds.
    eng_m = hunt_engine(stop_on_bug=True, metrics=True)
    t0 = time.perf_counter()
    res_b = sweep(None, eng_m.cfg, seeds, engine=eng_m, chunk_steps=64,
                  max_steps=1_000_000, recycle=True, batch_worlds=batch_w,
                  pipeline=False)
    torch.cuda.synchronize()
    wall_b = time.perf_counter() - t0
    check(not res_b.observations["active"].any(),
          "position independence: seeds left active")
    mono = eng_m.run(eng_m.init(seeds), 100_000)
    mono_obs = eng_m.observe(mono)
    check(sorted(mono_obs) == sorted(res_b.observations),
          "position independence: observation keys differ")
    for key, v in mono_obs.items():
        check(np.array_equal(res_b.observations[key], v),
              f"position independence: {key} differs from a monolithic "
              f"run")
    hits, first = fold_retired(*ledger_zeros(res_b.coverage.n_buckets, dev),
                               mono.metrics,
                               torch.ones(w, dtype=torch.bool, device=dev),
                               torch.arange(w, dtype=torch.int32,
                                            device=dev))
    check(np.array_equal(res_b.coverage.hits, hits.cpu().numpy())
          and np.array_equal(res_b.coverage.first_seen_seed,
                             first.cpu().numpy()),
          "position independence: the coverage ledger is not the fold of "
          "the monolithic run's signatures")
    check(set(res_a.failing_seeds) <= set(res_b.failing_seeds),
          "a seed the recycled hunt reported does not fail")
    del mono
    leg_b = dict(chunk_steps=64, max_steps=1_000_000, recycle=True,
                 batch_worlds=batch_w, pipeline=False)
    chunk_ms = chunk_device_ms(eng_m)
    sweep(None, eng_m.cfg, seeds, engine=eng_m, **leg_b)
    untimed(eng_m)
    ls = res_b.loop_stats
    log(f"[7 sweep b] {w} seeds recycled through {batch_w} slots to "
        f"retirement with metrics on: every observation (m_* included) "
        f"equals a monolithic init + run, the coverage ledger the fold of "
        f"its signatures ({res_b.coverage.distinct_behaviors} behaviors); "
        f"{len(res_b.failing_seeds)} failing, every seed of (a) among "
        f"them; wall {wall_b * 1e3:.2f} ms = {w / wall_b:.0f} seeds/s, "
        f"world_utilization {res_b.world_utilization:.4f}, chunks "
        f"{ls['chunks']}, dispatches {ls['dispatches']}, scalar fetches "
        f"{ls['scalar_fetches']}, retire fetches {ls['retire_fetches']}; "
        f"step kernel device time {sum(chunk_ms):.3f} ms over "
        f"{len(chunk_ms)} chunks, device idle share "
        f"{1 - sum(chunk_ms) / (wall_b * 1e3):.3f}")
    n_loops, _ = loop_legs("7 sweep b", eng_m, seeds, leg_b, res_b)
    sweep_launches += n_loops

    # (c) the flight recorder: the monolithic hunt with the 64-deep ring,
    # and the kernel's price for the ring and the metrics.
    eng_bb = hunt_engine(blackbox=64)
    obs_bb = eng_bb.observe(eng_bb.run(eng_bb.init(seeds), 4_000))
    check(np.array_equal(obs_bb["bug"], results["hunt"]["obs"]["bug"]),
          "flight recorder: the ring-on run's bug vector differs")
    row = int(np.flatnonzero(obs_bb["bug"])[0])
    ring = rings_from_observations(obs_bb)
    pos = int(ring["pos"][row])
    entries = decode_ring({k: v[row] for k, v in ring.items()},
                          kind_names=eng_bb.actor.kind_names)
    replay = eng_bb.trace(int(seeds[row]), max_steps=4_000)
    err = ring_matches_trace(entries, replay, total=pos)
    check(err is None, f"flight recorder: {err}")
    log(f"[7 ring c] seed {int(seeds[row])}: its {len(entries)} ring "
        f"records (of {pos}) are the suffix of trace() on the card, ending "
        f"at {entries[-1]['kind']} step {entries[-1]['step']}")
    lane_cases = [("off", engines["hunt"]), ("ring", eng_bb),
                  ("metrics", hunt_engine(metrics=True)),
                  ("ring+metrics", hunt_engine(blackbox=64, metrics=True))]
    expect_bytes = {"off": 1934, "ring": 2578, "ring+metrics": 2690}
    lane_ms = {}
    for label, eng in lane_cases + lane_cases[:1]:
        per_world = sum(int(np.prod(shape)) * torch.empty(
            0, dtype=dtype).element_size()
            for _n, dtype, shape in eng.state_layout())
        if label in expect_bytes:
            check(per_world == expect_bytes[label],
                  f"{label}: {per_world} state bytes per world, expected "
                  f"{expect_bytes[label]}")
        total = results["hunt"]["run_launches"]
        ms = sum(m for _k, m in device_ms(eng, w, total)) / total
        bound = (sum(needed_bytes(eng, w, total)) / total
                 / HBM_BYTES_PER_S * 1e3)
        lane_ms.setdefault(label, []).append(ms)
        log(f"[7 ring c] hunt W={w}, {label}: {per_world} B/world; kernel "
            f"{ms:.4f} ms/step over {total} launches, needed-bytes bound "
            f"{bound:.4f} ms, share {bound / ms:.3f}")
    off_ms = sum(lane_ms["off"]) / len(lane_ms["off"])
    log("[7 ring c] kernel ms/step against the off runs' mean "
        f"{off_ms:.4f}: " + ", ".join(
            f"{label} {lane_ms[label][0] / off_ms - 1:+.3f}"
            for label, _e in lane_cases[1:]))
    # (d) the pb hunt (tests/test_pb_actor.py's, golden.FAMILY_CONFIGS)
    # through the recycled first-bug sweep over 65,536 seeds; its first
    # failing seed fails again in an independent init + run.
    fam, ak, ck, faults, max_steps = golden.FAMILY_CONFIGS["pb_hunt"]
    fa = np.asarray(faults, np.int32)
    eng_pb = make_engine((fam, ak, ck))
    seeds = np.arange(W_FAMILY)
    leg_d = dict(chunk_steps=64, max_steps=max_steps, stop_on_first_bug=True,
                 recycle=True, batch_worlds=8192, pipeline=False, faults=fa)
    sweep(None, eng_pb.cfg, seeds, engine=eng_pb, **leg_d)  # warm-up
    step_kernel.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res_d = sweep(None, eng_pb.cfg, seeds, engine=eng_pb, **leg_d)
    torch.cuda.synchronize()
    wall_d = time.perf_counter() - t0
    pb_sweep_launches = step_kernel.launches
    fam_launches["pb"] += pb_sweep_launches
    check(pb_sweep_launches > 0, "pb sweep: the step kernel never launched")
    check(res_d.failing_seeds, "pb sweep: no bug found")
    first = int(res_d.failing_seeds[0])
    alone = eng_pb.observe(eng_pb.run(eng_pb.init(np.array([first]),
                                                  faults=fa), max_steps))
    check(bool(alone["bug"][0]), f"pb sweep: seed {first} does not fail "
          f"in an independent init + run")
    admitted = int((res_d.observations["steps"] > 0).sum())
    chunk_ms = chunk_device_ms(eng_pb)
    res_t = sweep(None, eng_pb.cfg, seeds, engine=eng_pb, **leg_d)
    untimed(eng_pb)
    check(res_t.failing_seeds == res_d.failing_seeds,
          "pb sweep: the timed replay found other seeds")
    ls = res_d.loop_stats
    log(f"[7 sweep d] pb_hunt recycled, {W_FAMILY} seeds, batch 8192, "
        f"chunks of 64, stop at the first bug: wall {wall_d * 1e3:.2f} ms, "
        f"{admitted} seeds admitted = {admitted / wall_d:.0f} seeds/s; "
        f"failing {res_d.failing_seeds[:8]} ({len(res_d.failing_seeds)}); "
        f"seed {first} fails again alone (bug at "
        f"{int(alone['bug_time_us'][0])} us); world_utilization "
        f"{res_d.world_utilization:.4f}; chunks {ls['chunks']}, dispatches "
        f"{ls['dispatches']}; step kernel launches {pb_sweep_launches}, "
        f"device time {sum(chunk_ms):.3f} ms, device idle share "
        f"{1 - sum(chunk_ms) / (wall_d * 1e3):.3f}")
    n_loops, _ = loop_legs("7 sweep d", eng_pb, seeds, leg_d, res_d,
                           admitted=seeds_admitted)
    fam_launches["pb"] += n_loops

    # ---- 8. the guided hunts ----------------------------------------------
    # (a) bench.py's guided_hunt leg (search/hunts.py): each canonical hunt
    # at 512 seeds, guided and random, through the serial, the pipelined
    # and the fused loop, each held to the JAX pins (JAX holds its loops
    # equal); then a replay of the same hunt in the same loop that times
    # its chunks (chunk_device_ms), its searcher and its fold, and must
    # give the same pins. Each chunk waits behind a longer sleep than phase
    # 7's (about 50 ms, not 10): a raft hunt chunk's 64 launches once took
    # longer to queue than 10 ms, which the timing's check refuses.
    hunt_sleep = SLEEP_CYCLES // 2

    def timed_search():
        """Make the sweep's searcher (the fold of the retiring worlds, then
        the children, on the card) and its fold (the corpus fold kernel)
        time themselves, each between a CUDA event pair (the searcher's
        holds the host's launch gaps); returns the two lists the ms land
        in, and a function that undoes it."""
        gen_ms, fold_ms = [], []
        real_searcher = sweep_mod.searcher
        real_fold = fold_kernel.harvest_fold_cuda

        def timed(fn, out):
            def call(*a, **k):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                res = fn(*a, **k)
                e1.record()
                e1.synchronize()
                out.append(e0.elapsed_time(e1))
                return res
            return call

        def searcher(*a, **k):
            return timed(real_searcher(*a, **k), gen_ms)

        def undo():
            sweep_mod.searcher = real_searcher
            fold_kernel.harvest_fold_cuda = real_fold

        sweep_mod.searcher = searcher
        fold_kernel.harvest_fold_cuda = timed(real_fold, fold_ms)
        return gen_ms, fold_ms, undo

    def mean(xs):
        return sum(xs) / len(xs) if xs else 0.0

    hunt_launches = {}
    fold_launches = 0
    fold_kernel.launches = 0
    for hname in ("pair", "raft", "paxos"):
        hunt = getattr(hunts, f"{hname}_hunt")()
        route = step_kernel.family_of(hunt.actor).route
        for mode in ("guided", "random"):
            for loop in ("serial", "pipeline", "fused"):
                kw = dict(faults=hunt.template, pipeline=loop == "pipeline",
                          fused=loop == "fused",
                          stop_on_first_bug=golden.HUNT_STOP_FIRST[hname],
                          search=hunt.search(mode == "guided"),
                          **hunt.sweep_kw)
                seeds = np.arange(golden.HUNT_BUDGET)
                eng = DeviceEngine(hunt.actor, hunt.cfg, device=dev)
                n0, f0 = step_kernel.launches, fold_kernel.launches
                fetches, undo = count_fetches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                try:
                    res = sweep(None, hunt.cfg, seeds, engine=eng, **kw)
                    torch.cuda.synchronize()
                finally:
                    undo()
                wall = time.perf_counter() - t0
                launched = step_kernel.launches - n0
                folds = fold_kernel.launches - f0
                fold_launches += folds
                check(launched > 0, f"hunt {hname} {mode} {loop}: the step "
                      f"kernel never launched")
                check(folds == (res.search.generations if mode == "guided"
                                else 0), f"hunt {hname} {mode} {loop}: "
                      f"{folds} fold launches over "
                      f"{res.search.generations} refills")
                hunt_launches[route] = hunt_launches.get(route, 0) + launched
                pins = golden.hunt_pins(res)
                want = golden.HUNT_PINS[hname][mode]
                check(pins == want, f"hunt {hname} {mode} {loop}: {pins} "
                      f"differ from the JAX pins {want}")
                fused_stats = dict(getattr(eng, "last_fused_stats", {}))
                eng_t = DeviceEngine(hunt.actor, hunt.cfg, device=dev)
                chunk_ms = chunk_device_ms(eng_t, hunt_sleep)
                gen_ms, fold_ms, undo = timed_search()
                try:
                    res_t = sweep(None, hunt.cfg, seeds, engine=eng_t, **kw)
                finally:
                    undo()
                check(golden.hunt_pins(res_t) == pins, f"hunt {hname} "
                      f"{mode} {loop}: the timed replay gave other pins")
                admitted = int((res.observations["steps"] > 0).sum())
                ls = res.loop_stats
                extra = ""
                if loop == "fused":
                    extra = (f"; {fused_stats['chunks_queued']} chunks "
                             f"queued, epoch bodies (queued per trigger) "
                             f"{fused_stats['epoch_s'] * 1e3:.1f} ms of host "
                             f"time = {fused_stats['epoch_s'] / wall:.3f} of "
                             f"the wall")
                log(f"[8 hunt a] {hname} {mode} {loop} ({route} kernel, "
                    f"{golden.HUNT_BUDGET} seeds, batch "
                    f"{hunt.sweep_kw['batch_worlds']}, chunks of "
                    f"{hunt.sweep_kw['chunk_steps']}): the JAX pins hold "
                    f"(seeds to bug {pins['seeds_to_bug']}, bugs "
                    f"{pins['bugs_found']}, generations "
                    f"{pins['generations']}, corpus {pins['corpus_size']}, "
                    f"depth {pins['lineage_depth']}); wall "
                    f"{wall * 1e3:.2f} ms, {admitted} seeds admitted = "
                    f"{admitted / wall:.0f} seeds/s, "
                    f"{res.search.generations} refills, chunks "
                    f"{ls['chunks']}, dispatches {ls['dispatches']}, _fetch "
                    f"calls {fetches[0]}, device flags read "
                    f"{ls['flag_reads']}, {launched} step launches, {folds} "
                    f"fold launches; searcher {mean(gen_ms):.3f} ms over "
                    f"{len(gen_ms)} calls and fold kernel "
                    f"{mean(fold_ms):.3f} ms over {len(fold_ms)} (replay; "
                    f"{sum(gen_ms):.1f} ms of the hunt); kernel device time "
                    f"{sum(chunk_ms):.3f} ms, device idle share "
                    f"{1 - sum(chunk_ms) / (wall * 1e3):.3f}" + extra)
    # (b) the Paxos hunt at the width of phase 7's sweeps: 65,536 seeds
    # through 8,192 slots, guided, to its first bug, in each loop; that
    # seed fails again in an independent init + run under the schedule the
    # search materialized for it.
    hunt = hunts.paxos_hunt()
    seeds = np.arange(W_FAMILY)
    ref = None
    for loop in ("serial", "pipeline", "fused"):
        wide = dict(faults=hunt.template, search=hunt.search(True),
                    recycle=True, batch_worlds=8192, chunk_steps=64,
                    max_steps=50_000_000, stop_on_first_bug=True,
                    pipeline=loop == "pipeline", fused=loop == "fused")
        eng = DeviceEngine(hunt.actor, hunt.cfg, device=dev)
        n0, f0 = step_kernel.launches, fold_kernel.launches
        fetches, undo = count_fetches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            res = sweep(None, hunt.cfg, seeds, engine=eng, **wide)
            torch.cuda.synchronize()
        finally:
            undo()
        wall = time.perf_counter() - t0
        launched = step_kernel.launches - n0
        folds = fold_kernel.launches - f0
        fold_launches += folds
        hunt_launches["paxos"] += launched
        check(launched > 0 and folds == res.search.generations > 0,
              f"wide Paxos hunt {loop}: {launched} step launches, {folds} "
              f"fold launches over {res.search.generations} refills")
        check(res.failing_seeds, f"wide Paxos hunt {loop}: no bug found")
        if ref is None:
            ref = res
            first = int(res.failing_seeds[0])
            sched = res.search.schedules[first]
            alone = eng.observe(eng.run(eng.init(np.array([first]),
                                                 faults=sched), 100_000))
            check(bool(alone["bug"][0]), f"wide Paxos hunt: seed {first} "
                  f"does not fail in an independent init + run under its "
                  f"schedule")
            chain = res.search.ancestry(first)
        else:
            check(same_result(ref, res, util=loop == "pipeline"),
                  f"wide Paxos hunt {loop}: the result differs from the "
                  f"serial loop's")
        fused_stats = dict(getattr(eng, "last_fused_stats", {}))
        eng_t = DeviceEngine(hunt.actor, hunt.cfg, device=dev)
        chunk_ms = chunk_device_ms(eng_t, hunt_sleep)
        gen_ms, fold_ms, undo = timed_search()
        try:
            res_t = sweep(None, hunt.cfg, seeds, engine=eng_t, **wide)
        finally:
            undo()
        check(res_t.failing_seeds == res.failing_seeds
              and golden.search_digest(res_t.search)
              == golden.search_digest(res.search),
              f"wide Paxos hunt {loop}: the timed replay differs")
        admitted = int((res.observations["steps"] > 0).sum())
        ls = res.loop_stats
        extra = ""
        if loop == "fused":
            extra = (f"; {fused_stats['chunks_queued']} chunks queued, epoch "
                     f"bodies {fused_stats['epoch_s'] * 1e3:.1f} ms of host "
                     f"time = {fused_stats['epoch_s'] / wall:.3f} of the "
                     f"wall")
        log(f"[8 hunt b] Paxos guided {loop}, {W_FAMILY} seeds through 8192 "
            f"slots, chunks of 64, stop at the first bug: wall "
            f"{wall * 1e3:.2f} ms, {admitted} seeds admitted = "
            f"{admitted / wall:.0f} seeds/s; failing {res.failing_seeds[:8]} "
            f"({len(res.failing_seeds)}); seed {first} fails again alone "
            f"under its schedule (bug at {int(alone['bug_time_us'][0])} us; "
            f"ancestry depth {len(chain) - 1}, operators "
            f"{sorted({op for node in chain for op in node['ops']})}); "
            f"{res.search.generations} refills, corpus "
            f"{res.search.corpus_size}/{res.search.corpus_capacity}, "
            f"{res.search.inserted} inserts; chunks {ls['chunks']}, "
            f"dispatches {ls['dispatches']}, _fetch calls {fetches[0]}, "
            f"device flags read {ls['flag_reads']}; {launched} step "
            f"launches, {folds} fold launches; searcher "
            f"{mean(gen_ms):.3f} ms over {len(gen_ms)} calls and fold "
            f"kernel {mean(fold_ms):.3f} ms over {len(fold_ms)} (replay); "
            f"kernel device time {sum(chunk_ms):.3f} ms, device idle share "
            f"{1 - sum(chunk_ms) / (wall * 1e3):.3f}" + extra)
    wide_paxos_failing = list(ref.failing_seeds)
    # ---- 9. checkpoints and the crosscheck on the card --------------------
    # (a) phase 7's sweep (b), every seed to retirement, with a checkpoint
    # writer (every 4 chunks) in the serial and the pipelined loop, each
    # beside the same loop's run without one; the states the writer was
    # handed held to synchronous copies taken at the same submits (the
    # serial loop); (b) the same sweep cut at chunk 20 and resumed in a
    # fresh engine, in both loops; (c) the guided Paxos hunt of phase 8 cut
    # after its second refill and resumed in a fresh engine, in both loops;
    # (d) crosscheck_backends, CUDA against the CPU, at W = 1,024, and a
    # checkpoint written on the card loaded in a CPU engine; (e) the kernel
    # against the plain step with sequential_insert=True.
    import hashlib
    import shutil
    import tempfile

    from madsim_tpu_torch.engine import checkpoint as ckpt
    from madsim_tpu_torch.engine.convert import to_numpy
    from madsim_tpu_torch.engine.crosscheck import crosscheck_backends

    t9 = time.perf_counter()
    ckpt_dir = tempfile.mkdtemp(prefix=".ckpt_", dir=HERE)
    seeds = np.arange(w)
    every = 4
    ck_leg = dict(leg_b, checkpoint_every_chunks=every)

    def same_outcome(a, b):
        """Whether two SweepResults agree on what the JAX package's resume
        tests compare: observations (the metrics block among them), the
        failing seeds, the coverage ledger's hits and first-seen seeds,
        the search's report."""
        ok = (a.failing_seeds == b.failing_seeds
              and sorted(a.observations) == sorted(b.observations)
              and all(np.array_equal(a.observations[k], b.observations[k])
                      for k in a.observations))
        if a.coverage is not None:
            ok = ok and all(np.array_equal(getattr(a.coverage, f),
                                           getattr(b.coverage, f))
                            for f in ("hits", "first_seen_seed"))
        if a.search is not None:
            ok = ok and (golden.search_digest(a.search)
                         == golden.search_digest(b.search)
                         and a.search.operator_stats
                         == b.search.operator_stats)
        return ok

    def digest(leaves):
        h = hashlib.sha256()
        for a in leaves:
            h.update(np.ascontiguousarray(a).tobytes())
        return h.hexdigest()

    # The writer's saves, timed on its thread: (seconds, bytes, digest of
    # the leaves it was handed or None, the leaves or None).
    saves, keep = [], {"digest": False, "whole": 0}
    real_save = ckpt.save

    def timed_save(engine, state, path, **kw):
        t0 = time.perf_counter()
        real_save(engine, state, path, **kw)
        dt = time.perf_counter() - t0
        leaves = [to_numpy(x) for x in tree_leaves(state)]
        saves.append((dt, os.path.getsize(path),
                      digest(leaves) if keep["digest"] else None,
                      leaves if len(saves) < keep["whole"] else None))

    def ckpt_log(tag, loop, wall, wall_off, launched, walls):
        n_s = len(saves)
        mb = sum(s[1] for s in saves) / max(n_s, 1) / 1e6
        ws = [s[0] * 1e3 for s in saves]
        log(f"[9 ckpt {tag}] {loop}: wall {wall * 1e3:.2f} ms with the "
            f"writer against {wall_off * 1e3:.2f} ms without "
            f"({(wall / wall_off - 1) * 100:+.1f}%; best of 2 each, in "
            f"turns: without {[round(x * 1e3, 2) for x in walls['off']]}, "
            f"with {[round(x * 1e3, 2) for x in walls['on']]}); {n_s} "
            f"snapshots written over the two runs, {mb:.3f} MB each, write "
            f"{min(ws):.1f}-{max(ws):.1f} ms (mean "
            f"{sum(ws) / max(n_s, 1):.1f}) on the writer's thread; "
            f"{launched} step launches")

    ckpt.save = timed_save
    real_submit = sweep_mod._AsyncCheckpointer.submit
    ckpt_launches = {}

    def add_launches(route, n):
        ckpt_launches[route] = ckpt_launches.get(route, 0) + n

    walls_off = {}
    try:
        # (a) the whole sweep with a writer, beside the same loop without,
        # in turns (without, with, with, without); the best of each pair.
        for loop in ("serial", "pipeline"):
            kw = dict(ck_leg, pipeline=loop == "pipeline")
            off = dict(leg_b, pipeline=loop == "pipeline")
            path = os.path.join(ckpt_dir, f"a_{loop}.npz")
            walls = {"off": [], "on": []}
            saves.clear()
            keep.update(digest=False, whole=0)
            step_kernel.launches = 0
            for turn in ("off", "on", "on", "off"):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if turn == "off":
                    sweep(None, eng_m.cfg, seeds, engine=eng_m, **off)
                else:
                    res = sweep(None, eng_m.cfg, seeds, engine=eng_m,
                                checkpoint_path=path, **kw)
                torch.cuda.synchronize()
                walls[turn].append(time.perf_counter() - t0)
                if turn == "on":
                    check(same_outcome(res_b, res), f"checkpointed sweep "
                          f"{loop}: the result differs from phase 7's "
                          f"unbroken sweep")
            launched = step_kernel.launches
            add_launches("raft", launched)
            check(launched > 0, f"checkpointed sweep {loop}: the step "
                  f"kernel never launched")
            check(saves and ckpt.read_meta(path)["n_worlds"] == batch_w,
                  f"checkpointed sweep {loop}: no full-width snapshot")
            wall_off = walls_off[loop] = min(walls["off"])
            ckpt_log("a", loop, min(walls["on"]), wall_off, launched,
                     walls)
        # Where the writer's cost goes (serial loop): the same sweep with
        # the file write taken out (the device copies, the pull to the
        # host and the aux's concatenation stay), and with a snapshot
        # every 16 chunks.
        for what, every_v, write in (("no file write", every, False),
                                     ("every 16 chunks", 16, True)):
            saves.clear()
            if not write:
                ckpt.save = (lambda engine, state, path, **kw:
                             saves.append((0.0, 0, None, None)))
            step_kernel.launches = 0
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = sweep(None, eng_m.cfg, seeds, engine=eng_m,
                            checkpoint_path=os.path.join(ckpt_dir,
                                                         "a_var.npz"),
                            **dict(ck_leg, pipeline=False,
                                   checkpoint_every_chunks=every_v))
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            finally:
                ckpt.save = timed_save
            add_launches("raft", step_kernel.launches)
            check(same_outcome(res_b, res), f"checkpointed sweep, {what}: "
                  f"the result differs from phase 7's unbroken sweep")
            log(f"[9 ckpt a] serial, {what}: wall {wall * 1e3:.2f} ms "
                f"against {walls_off['serial'] * 1e3:.2f} ms without a "
                f"writer ({(wall / walls_off['serial'] - 1) * 100:+.1f}%); "
                f"{len(saves)} snapshots taken by the writer")

        # The torn-snapshot check: each state the writer was handed equals
        # a synchronous copy of the live state taken at some submit.
        submits = []

        def checked_submit(self, state, aux=None):
            torch.cuda.synchronize()
            leaves = [np.array(to_numpy(x), copy=True)
                      for x in tree_leaves(state)]
            submits.append((digest(leaves),
                            leaves if len(submits) < 4 else None))
            return real_submit(self, state, aux)

        sweep_mod._AsyncCheckpointer.submit = checked_submit
        saves.clear()
        keep.update(digest=True, whole=4)
        try:
            sweep(None, eng_m.cfg, seeds, engine=eng_m,
                  checkpoint_path=os.path.join(ckpt_dir, "torn.npz"),
                  **dict(ck_leg, pipeline=False))
        finally:
            sweep_mod._AsyncCheckpointer.submit = real_submit
        names = tree_paths(eng_m.init(np.arange(1)))
        by_digest = {d: i for i, (d, _l) in enumerate(submits)}
        for j, (_dt, _b, d, leaves) in enumerate(saves):
            i = by_digest.get(d)
            if i is None:
                ref_leaves = submits[min(j, 3)][1]
                torn = [n for n, a, b in zip(names, leaves or [],
                                             ref_leaves or [])
                        if not np.array_equal(a, b)]
                check(False, f"torn snapshot: write {j} equals no state "
                      f"submitted (first differing leaves {torn[:4]})")
            if leaves is not None and submits[i][1] is not None:
                for n, a, b in zip(names, leaves, submits[i][1]):
                    check(a.dtype == b.dtype and np.array_equal(a, b),
                          f"torn snapshot: write {j}, leaf {n}")
        whole = sum(1 for s in saves
                    if s[3] is not None and submits[by_digest[s[2]]][1]
                    is not None)
        log(f"[9 ckpt a] torn-snapshot check (serial): {len(saves)} writes "
            f"of {len(submits)} submits (latest wins), each equal to the "
            f"synchronous copy of the state at its submit; {whole} "
            f"compared leaf by leaf, every write by its sha256")

        # (b) cut at chunk 20, resumed in a fresh engine.
        for loop in ("serial", "pipeline"):
            path = os.path.join(ckpt_dir, f"b_{loop}.npz")
            kw = dict(ck_leg, pipeline=loop == "pipeline",
                      checkpoint_path=path)
            step_kernel.launches = 0
            t0 = time.perf_counter()
            part = sweep(None, eng_m.cfg, seeds, engine=eng_m,
                         **dict(kw, max_steps=64 * 20))
            check(part.steps_run == 64 * 20 and part.loop_stats["chunks"]
                  == 20, f"cut sweep {loop}: not cut at chunk 20")
            fresh = hunt_engine(stop_on_bug=True, metrics=True)
            res = sweep(None, fresh.cfg, seeds, engine=fresh, resume=True,
                        **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            add_launches("raft", step_kernel.launches)
            check(same_outcome(res_b, res), f"resumed sweep {loop}: the "
                  f"result differs from phase 7's unbroken sweep")
            log(f"[9 ckpt b] {loop}: cut at chunk 20 ({w} seeds through "
                f"{batch_w} slots), resumed in a fresh engine for "
                f"{res.loop_stats['chunks']} more chunks: equal to the "
                f"unbroken sweep; {wall * 1e3:.1f} ms for both calls, "
                f"{len(saves)} snapshots so far")

        # (c) the guided Paxos hunt, cut after its second refill.
        hunt = hunts.paxos_hunt()
        pk = dict(faults=hunt.template, search=hunt.search(True),
                  stop_on_first_bug=golden.HUNT_STOP_FIRST["paxos"],
                  **hunt.sweep_kw)
        pseeds = np.arange(golden.HUNT_BUDGET)
        want = golden.HUNT_PINS["paxos"]["guided"]
        step_kernel.launches = 0
        f0 = fold_kernel.launches
        ref = sweep(None, hunt.cfg, pseeds, pipeline=False,
                    engine=DeviceEngine(hunt.actor, hunt.cfg, device=dev),
                    **pk)
        check(golden.hunt_pins(ref) == want, "guided Paxos hunt: the pins "
              "differ from JAX's")
        half = hunt.sweep_kw["batch_worlds"] // 2
        refills = [i for i, a in enumerate(ref.n_active_history)
                   if a <= half]
        cut = refills[1] + 1
        for loop in ("serial", "pipeline"):
            path = os.path.join(ckpt_dir, f"c_{loop}.npz")
            kw = dict(pk, pipeline=loop == "pipeline", checkpoint_path=path,
                      checkpoint_every_chunks=1)
            t0 = time.perf_counter()
            part = sweep(None, hunt.cfg, pseeds,
                         engine=DeviceEngine(hunt.actor, hunt.cfg,
                                             device=dev),
                         **dict(kw, max_steps=cut
                                * hunt.sweep_kw["chunk_steps"]))
            check(part.search.generations >= 2, f"guided Paxos {loop}: "
                  f"the cut came before the second refill")
            res = sweep(None, hunt.cfg, pseeds, resume=True,
                        engine=DeviceEngine(hunt.actor, hunt.cfg,
                                            device=dev), **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            pins = golden.hunt_pins(res)
            check(pins == want, f"guided Paxos {loop} resumed: {pins} "
                  f"differ from the JAX pins {want}")
            check(same_outcome(ref, res), f"guided Paxos {loop} resumed: "
                  f"the result differs from the unbroken hunt's")
            log(f"[9 ckpt c] guided Paxos hunt {loop}, {len(pseeds)} "
                f"seeds: cut after chunk {cut} ({part.search.generations} "
                f"refills), resumed in a fresh engine: the JAX pins hold "
                f"(seeds to bug {pins['seeds_to_bug']}, generations "
                f"{pins['generations']}, corpus {pins['corpus_size']}) and "
                f"every result equals the unbroken hunt's; "
                f"{wall * 1e3:.1f} ms for both calls")
        add_launches("paxos", step_kernel.launches)
        ckpt_folds = fold_kernel.launches - f0
        check(ckpt_folds > 0, "guided Paxos: the fold kernel never "
              "launched")
        try:
            sweep(None, hunt.cfg, pseeds, fused=True,
                  engine=DeviceEngine(hunt.actor, hunt.cfg, device=dev),
                  checkpoint_path=os.path.join(ckpt_dir, "fused.npz"), **pk)
            check(False, "fused=True took a checkpoint_path")
        except ValueError as exc:
            check("fused=True cannot checkpoint" in str(exc),
                  f"fused=True refused a checkpoint with {exc}")
        log("[9 ckpt c] fused=True with checkpoint_path: refused with the "
            "JAX package's ValueError")
    finally:
        ckpt.save = real_save
        sweep_mod._AsyncCheckpointer.submit = real_submit

    # (d) crosscheck_backends, CUDA against the CPU, at W = 1,024.
    w_x = 1024
    legs = [
        ("hunt_faults", golden.CONFIGS["hunt_faults"][:2],
         golden.CONFIGS["hunt_faults"][2], {}, "raft"),
        ("pb_hunt", golden.FAMILY_CONFIGS["pb_hunt"][:3],
         golden.FAMILY_CONFIGS["pb_hunt"][3], {}, "pb"),
        ("paxos_hunt:wide", golden.SEARCH_CONFIGS["paxos_hunt"][:3],
         golden.SEARCH_CONFIGS["paxos_hunt"][3], dict(packed=False),
         "paxos:wide"),
    ]
    for name, cfgs, faults, over, route in legs:
        eng = make_engine(cfgs, **over)
        step_kernel.launches = 0
        t0 = time.perf_counter()
        try:
            summary = crosscheck_backends(eng, np.arange(w_x),
                                          faults=np.asarray(faults,
                                                            np.int32))
        except AssertionError as exc:
            check(False, f"crosscheck {name}: {exc}")
        wall = time.perf_counter() - t0
        launched = step_kernel.launches
        check(launched > 0 and summary["platform_a"] == "cuda"
              and summary["platform_b"] == "cpu", f"crosscheck {name}: "
              f"the CUDA leg did not run ({summary})")
        log(f"[9 crosscheck] {name}: W={w_x}, {summary['n_leaves']} leaves "
            f"and every observe() key bitwise equal, CUDA ({launched} step "
            f"launches) against the CPU's plain step; {wall:.2f} s for both "
            f"runs")
    # A checkpoint written on the card, loaded in a CPU engine; both
    # advance 64 steps.
    cfgs = golden.CONFIGS["hunt_faults"][:2]
    faults = np.asarray(golden.CONFIGS["hunt_faults"][2], np.int32)
    eng_g = make_engine(cfgs)
    step_kernel.launches = 0
    state_g = eng_g.run_steps(eng_g.init(np.arange(w_x), faults=faults), 200)
    path = os.path.join(ckpt_dir, "card.npz")
    ckpt.save(eng_g, state_g, path)
    eng_c = DeviceEngine(eng_g.actor, eng_g.cfg, device="cpu")
    state_c = ckpt.load(eng_c, path)
    eng_g.run_steps(state_g, 64)
    eng_c.run_steps(state_c, 64)
    for n, a, b in zip(tree_paths(state_g), tree_leaves(state_g),
                       tree_leaves(state_c)):
        check(np.array_equal(to_numpy(a), to_numpy(b)),
              f"card checkpoint on the CPU: leaf {n} differs after 64 steps")
    log(f"[9 crosscheck] a checkpoint written on the card at step 200 "
        f"(W={w_x}, {os.path.getsize(path) / 1e6:.3f} MB) loads in a CPU "
        f"engine; 64 more steps on each: every leaf bitwise equal")

    # (e) sequential_insert=True: the kernel against the plain step (whose
    # insert is then the chain of single pushes), and both against the
    # kernel's run without the flag.
    seq_cfgs = [
        ("hunt_kill_restart", golden.CONFIGS["hunt_faults"][:2],
         np.asarray(golden.CONFIGS["hunt_faults"][2], np.int32), 4_000,
         "raft"),
        ("tpc_crosscheck", golden.FAMILY_CONFIGS["tpc_crosscheck"][:3],
         None, 5_000, "tpc"),
    ]
    for name, cfgs, faults, max_steps, route in seq_cfgs:
        t0 = time.perf_counter()
        seeds_s = np.arange(W_COMPARE)
        eng_s = make_engine(cfgs, sequential_insert=True)
        eng_d = make_engine(cfgs)
        step_kernel.launches = 0
        ks_state = eng_s.init(seeds_s, faults=faults)
        pl_state = eng_s.init(seeds_s, faults=faults)
        d_state = eng_d.init(seeds_s, faults=faults)
        first, err = diff(ks_state, d_state)
        check(first is None, f"{name}: the push chain's init differs from "
              f"push_many's on leaf {first}")
        steps = 0
        while steps < max_steps and bool(ks_state.active.any()):
            eng_s.step(ks_state)
            pl_state = eng_s.step_plain(pl_state)
            steps += 1
            if steps <= COMPARE_EVERY_STEP or steps % 64 == 0:
                first, err = diff(ks_state, pl_state)
                check(first is None, f"{name} sequential_insert: kernel "
                      f"and plain step differ first on leaf {first} after "
                      f"step {steps} (max abs err {err})")
        first, err = diff(ks_state, pl_state)
        check(first is None, f"{name} sequential_insert: kernel and plain "
              f"step differ at the end on leaf {first}")
        eng_d.run_steps(d_state, steps)
        first, _err = diff(ks_state, d_state)
        check(first is None, f"{name}: the run with sequential_insert "
              f"differs from the run without on leaf {first}")
        fam_err[route] = max(fam_err.get(route, 0.0), err)
        obs = eng_s.observe(ks_state)
        check(not obs["active"].any() and obs["bug"].any(),
              f"{name} sequential_insert: the run did not end in bugs")
        log(f"[9 seq insert] {name}: W={W_COMPARE}, {steps} steps, kernel "
            f"and the plain step's chain of pushes bitwise equal (every "
            f"step to 64, every 64th after, the end), and equal to the "
            f"run without the flag (bug {int(obs['bug'].sum())}) in "
            f"{time.perf_counter() - t0:.1f} s")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    # The checkpointed sweeps are the main path's; the comparisons of (d)
    # and (e) are not counted.
    sweep_launches += ckpt_launches["raft"]
    hunt_launches["paxos"] += ckpt_launches["paxos"]
    fold_launches += ckpt_folds
    log(f"[9] phase 9 took {time.perf_counter() - t9:.1f} s; the "
        f"checkpointed sweeps' step kernel launches by route "
        f"{ckpt_launches}, fold launches {ckpt_folds}")
    # ---- 10. triage and the observatory on the card -----------------------
    # (a) bench.py's minimize_bug leg at its width (golden.MINIMIZE_BUG),
    # serial and pipelined, each round one sweep through the kernel, held
    # to the JAX-derived pin; (b) tools/triage_demo.py's path: inject,
    # hunt, triage, and each class's bundle replayed through the CLI in
    # this process (counted) and in a fresh one, with and without the ring
    # (--crosscheck); (c) the Raft hunt of phase 7 (b) under its own
    # kill/restart schedule with the 64-deep ring: bucketed, its first
    # failing seed minimized in both loops, its class's bundle replayed
    # and crosschecked; (d) phase 7's sweep (b) and phase 8's guided
    # Paxos hunt with observe= in each loop, equal to the same call without
    # it (results, _fetch calls, flag reads, launches), and one
    # profile_dir= run whose torch.profiler trace names the step kernel.
    import io

    from madsim_tpu_torch.obs import cli as obs_cli
    from madsim_tpu_torch.obs import observatory
    from madsim_tpu_torch.triage import minimize, triage
    from madsim_tpu_torch.triage.synthetic import (PairRestartActor,
                                                   PairRestartConfig)
    from madsim_tpu_torch.triage.synthetic import \
        engine_config as pair_config

    t10 = time.perf_counter()
    work = tempfile.mkdtemp(prefix=".triage_", dir=HERE)
    p10_launches = {"raft": 0, "pair": 0, "paxos": 0}
    p10_folds = 0

    def take(route):
        """Add the step kernel's launches since the last reset to
        ``route`` (and the fold kernel's to the folds), and reset both."""
        nonlocal p10_folds
        p10_launches[route] += step_kernel.launches
        p10_folds += fold_kernel.launches
        step_kernel.launches = fold_kernel.launches = 0

    def count_sweeps():
        """Count the sweep module's ``sweep`` calls (the minimizer's
        rounds); returns the list of their widths and an undo."""
        widths = []
        real = sweep_mod.sweep

        def counted(actor, cfg, seeds, **kw):
            widths.append(len(seeds))
            return real(actor, cfg, seeds, **kw)

        sweep_mod.sweep = counted

        def undo():
            sweep_mod.sweep = real

        return widths, undo

    def replay(args, fresh):
        """``python -m madsim_tpu_torch.obs <args>`` on the card: in this
        process (its launches counted), or in a fresh one. Returns the
        exit code, its standard error and its wall."""
        t0 = time.perf_counter()
        if fresh:
            proc = subprocess.run(
                [sys.executable, "-m", "madsim_tpu_torch.obs", *args],
                cwd=HERE, env=dict(os.environ, PYTHONPATH=HERE),
                capture_output=True, text=True, timeout=300)
            return proc.returncode, proc.stderr, time.perf_counter() - t0
        import contextlib

        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            rc = obs_cli.main(list(args))
        torch.cuda.synchronize()
        return rc, err.getvalue(), time.perf_counter() - t0

    def timeless(rec):
        """A telemetry record without what the host's clock gave it."""
        out = {k: v for k, v in rec.items()
               if k not in ("elapsed_s", "seeds_per_s", "eta_s")}
        if "loop_stats" in out:
            out["loop_stats"] = {k: v for k, v in out["loop_stats"].items()
                                 if not k.endswith("_s")}
        return out

    def ends_in_raise(path):
        with open(path, encoding="utf-8") as f:
            events = json.load(f)["traceEvents"]
        return bool(events) and events[-1]["name"] == "invariant:raise"

    # (a) the minimizer at bench.py's width.
    acfg = PairRestartConfig()
    eng_pr = DeviceEngine(PairRestartActor(acfg), pair_config(acfg),
                          device=dev)
    mb = golden.MINIMIZE_BUG
    rows = pair_schedule(n_rows=mb["n_rows"], need=mb["need"], acfg=acfg)
    min_kw = dict(engine=eng_pr, chunk_steps=mb["chunk_steps"],
                  max_steps=mb["max_steps"])
    minimize(None, eng_pr.cfg, mb["seed"], rows, **min_kw)   # warm-up
    step_kernel.launches = fold_kernel.launches = 0
    for loop in ("serial", "pipeline"):
        widths, undo = count_sweeps()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            mr = minimize(None, eng_pr.cfg, mb["seed"], rows,
                          pipeline=loop == "pipeline", **min_kw)
            torch.cuda.synchronize()
        finally:
            undo()
        wall = time.perf_counter() - t0
        launched = step_kernel.launches
        take("pair")
        check(mr.final_rows == 2 and mr.one_minimal
              and np.array_equal(mr.schedule, rows[list(mb["need"])]),
              f"minimizer {loop}: {mr.summary()}, not the two load-bearing "
              f"rows {mb['need']}")
        check(golden.minimize_digest(mr) == golden.GOLDEN_MINIMIZE,
              f"minimizer {loop}: the round history differs from the JAX "
              f"pin")
        check(len(widths) == mr.rounds, f"minimizer {loop}: "
              f"{len(widths)} sweeps for {mr.rounds} rounds")
        log(f"[10 minimize a] {loop}: {mb['n_rows']} rows -> rows "
            f"{list(mb['need'])}, 1-minimal, history equal to the JAX pin; "
            f"{mr.rounds} rounds, {mr.candidates_evaluated} candidates, "
            f"{len(widths) / mr.rounds:.0f} sweep per round (widths "
            f"{sorted(set(widths))}), {launched} step launches; wall "
            f"{wall * 1e3:.2f} ms = {mr.candidates_evaluated / wall:.0f} "
            f"candidates/s")

    # (b) the triage demo: 32 worlds, the even seeds under the 32-row
    # schedule with the pair at rows {5, 20}, the odd under a decoy.
    full = pair_schedule(n_rows=32, need=(5, 20), acfg=acfg)
    decoy = full.copy()
    decoy[20, 2] = 0
    demo_faults = np.stack([full if s % 2 == 0 else decoy
                            for s in range(32)])
    for label, over in (("metrics", {}), ("metrics+ring", {"blackbox": 16})):
        eng_d = DeviceEngine(PairRestartActor(acfg), dataclasses.replace(
            pair_config(acfg, metrics=True), **over), device=dev)
        ring = bool(over)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = sweep(None, eng_d.cfg, np.arange(32), faults=demo_faults,
                    engine=eng_d, chunk_steps=32, max_steps=4_000)
        check(res.failing_seeds == list(range(0, 32, 2)),
              f"triage demo ({label}): failing seeds {res.failing_seeds}")
        out = os.path.join(work, f"demo_{len(over)}")
        os.makedirs(out)
        report = triage(res, out_dir=out, chunk_steps=32, max_steps=4_000)
        torch.cuda.synchronize()
        wall_t = time.perf_counter() - t0
        check(len(report.classes) == 1,
              f"triage demo ({label}): {len(report.classes)} classes")
        key = report.classes[0].key
        mr = report.minimized[key]
        check(mr.final_rows == 2 and mr.one_minimal
              and np.array_equal(mr.schedule, full[[5, 20]]),
              f"triage demo ({label}): {mr.summary()}")
        bundle = report.bundles[key]
        extra = ["--crosscheck"] if ring else []
        walls = {}
        for fresh in (False, True):
            trace_out = os.path.join(out, f"trace_{int(fresh)}.json")
            rc, err, walls[fresh] = replay(
                ["replay", "--bundle", bundle, "--out", trace_out] + extra,
                fresh)
            check(rc == 0 and "invariant RAISED" in err
                  and ends_in_raise(trace_out)
                  and (not ring or "bitwise the suffix" in err),
                  f"triage demo ({label}): replay "
                  f"{'in a fresh process ' if fresh else ''}rc {rc}: "
                  f"{err[-600:]}")
        launched = step_kernel.launches
        take("pair")
        log(f"[10 triage b] demo ({label}): 16 of 32 seeds fail, 1 class, "
            f"its representative minimized 32 -> 2 rows (rows 5, 20) in "
            f"{mr.rounds} rounds ({mr.candidates_evaluated} candidates); "
            f"hunt + triage {wall_t * 1e3:.2f} ms; the bundle replayed "
            f"through the CLI on the card to the invariant raise"
            + (", its ring bitwise the replayed trace's suffix"
               if ring else "")
            + f": in this process {walls[False] * 1e3:.1f} ms, in a fresh "
            f"one rc 0 in {walls[True]:.1f} s; {launched} step launches")

    # (c) the Raft hunt at full width under its kill/restart schedule.
    hunt_faults = np.asarray(golden.CONFIGS["hunt_faults"][2], np.int32)
    hunt_steps = golden.CONFIGS["hunt_faults"][3]
    eng_c = hunt_engine(stop_on_bug=True, metrics=True, blackbox=64)
    seeds = np.arange(w)
    leg_c = dict(leg_b, faults=hunt_faults, pipeline=True)
    sweep(None, eng_c.cfg, seeds, engine=eng_c, **leg_c)      # warm-up
    step_kernel.launches = fold_kernel.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res_c = sweep(None, eng_c.cfg, seeds, engine=eng_c, **leg_c)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    check(res_c.failing_seeds, "Raft hunt with faults: no bug found")
    t0 = time.perf_counter()
    rep_c = triage(res_c, minimize=False)
    wall_b = time.perf_counter() - t0
    first = res_c.failing_seeds[0]
    check(rep_c.classes[0].representative == first,
          "Raft hunt triage: the first class is not the first failing "
          "seed's")
    mrs, walls = {}, {}
    for loop in ("serial", "pipeline"):
        widths, undo = count_sweeps()
        t0 = time.perf_counter()
        try:
            mrs[loop] = res_c.minimize(first, pipeline=loop == "pipeline",
                                       chunk_steps=64, max_steps=hunt_steps)
            torch.cuda.synchronize()
        finally:
            undo()
        walls[loop] = time.perf_counter() - t0
        check(len(widths) == mrs[loop].rounds,
              f"Raft minimize {loop}: not one sweep per round")
    check(golden.minimize_digest(mrs["serial"])
          == golden.minimize_digest(mrs["pipeline"]),
          "Raft minimize: the loops disagree")
    mr = mrs["serial"]
    out = os.path.join(work, "raft")
    os.makedirs(out)
    t0 = time.perf_counter()
    rep_cb = triage(res_c, out_dir=out, minimize=False, max_steps=hunt_steps)
    wall_w = time.perf_counter() - t0
    bundle = rep_cb.bundles[rep_c.classes[0].key]
    walls_r = {}
    for fresh in (False, True):
        trace_out = os.path.join(out, f"trace_{int(fresh)}.json")
        rc, err, walls_r[fresh] = replay(
            ["replay", "--bundle", bundle, "--out", trace_out,
             "--crosscheck"], fresh)
        check(rc == 0 and "invariant RAISED" in err
              and "bitwise the suffix" in err and ends_in_raise(trace_out),
              f"Raft hunt bundle: replay "
              f"{'in a fresh process ' if fresh else ''}rc {rc}: "
              f"{err[-600:]}")
    launched = step_kernel.launches
    take("raft")
    log(f"[10 triage c] Raft hunt, {w} seeds through {batch_w} slots, "
        f"metrics and a 64-deep ring, kill/restart: "
        f"{len(res_c.failing_seeds)} failing in {wall_s * 1e3:.2f} ms; "
        f"triage(minimize=False): "
        f"{len(rep_c.classes)} classes in {wall_b * 1e3:.1f} ms; seed "
        f"{first} minimized {mr.original_rows} -> {mr.final_rows} rows in "
        f"{mr.rounds} rounds ({mr.candidates_evaluated} candidates), equal "
        f"in both loops (serial {walls['serial'] * 1e3:.1f} ms, pipelined "
        f"{walls['pipeline'] * 1e3:.1f} ms); {len(rep_cb.bundles)} bundles "
        f"in {wall_w * 1e3:.1f} ms; the first class's bundle replayed to "
        f"the raise, its ring bitwise the replayed trace's suffix: in this "
        f"process {walls_r[False] * 1e3:.1f} ms, in a fresh one rc 0 in "
        f"{walls_r[True]:.1f} s; {launched} step launches")

    # (d) the observatory: each sweep with and without observe=.
    paxos = hunts.paxos_hunt()
    eng_px = DeviceEngine(paxos.actor, paxos.cfg, device=dev)
    obs_legs = [
        ("7 sweep b", eng_m, np.arange(w), dict(leg_b), "raft"),
        ("8 hunt b", eng_px, np.arange(W_FAMILY),
         dict(faults=paxos.template, search=paxos.search(True),
              recycle=True, batch_worlds=8192, chunk_steps=64,
              max_steps=50_000_000, stop_on_first_bug=True), "paxos")]
    for tag, eng, seeds, kw, route in obs_legs:
        for loop in ("serial", "pipeline", "fused"):
            lkw = dict(kw, pipeline=loop == "pipeline", fused=loop == "fused")
            path = os.path.join(work, f"tele_{route}_{loop}.jsonl")
            runs = {}
            sink = []
            # In turns: without, to the JSONL file, to a list in memory.
            for mode in ("plain", "observed", "memory", "memory",
                         "observed", "plain"):
                if mode == "memory":
                    sink.clear()
                extra = ({"observe": path} if mode == "observed" else
                         {"observe": sink.append} if mode == "memory"
                         else {})
                fetches, undo = count_fetches()
                step_kernel.launches = fold_kernel.launches = 0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                try:
                    res = sweep(None, eng.cfg, seeds, engine=eng, **lkw,
                                **extra)
                    torch.cuda.synchronize()
                finally:
                    undo()
                wall = time.perf_counter() - t0
                counts = (fetches[0], res.loop_stats["flag_reads"],
                          step_kernel.launches, fold_kernel.launches)
                take(route)
                if mode in runs:
                    check(counts == runs[mode][1] and same_result(
                        runs[mode][0], res), f"{tag} {loop} {mode}: the "
                        f"two runs differ")
                # The latest run: the stream on disk is its.
                runs[mode] = (res, counts,
                              runs.get(mode, (0, 0, []))[2] + [wall])
            plain, seen, mem = (runs["plain"], runs["observed"],
                                runs["memory"])
            for other in (seen, mem):
                check(same_result(plain[0], other[0]),
                      f"{tag} {loop}: observe= changed the result")
                check(plain[1] == other[1], f"{tag} {loop}: observe= "
                      f"changed the (_fetch, flag reads, launches, folds) "
                      f"{plain[1]} -> {other[1]}")
            with open(path, encoding="utf-8") as f:
                records = [json.loads(line) for line in f]
            check([timeless(r) for r in records]
                  == [timeless(r) for r in json.loads(json.dumps(sink))],
                  f"{tag} {loop}: the file's records differ from the "
                  f"callback's")
            progress = [r for r in records
                        if r["schema"] == "madsim.sweep.telemetry/1"]
            searched = [r for r in records
                        if r["schema"] == "madsim.search.telemetry/1"]
            summary = records[-1]
            check(summary.get("event") == "summary"
                  and summary["loop_stats"] == seen[0].loop_stats
                  and len(progress) == seen[0].loop_stats["scalar_fetches"]
                  and (route != "paxos" or searched),
                  f"{tag} {loop}: the telemetry stream is off")
            buf = io.StringIO()
            check(observatory.watch(path, out=buf) == 0
                  and "final:" in buf.getvalue(),
                  f"{tag} {loop}: watch did not render the stream")
            log(f"[10 observe d] {tag} {loop}: observe= leaves the result, "
                f"the _fetch calls, flag reads, step launches and folds "
                f"{plain[1]} unchanged; {len(records)} records "
                f"({len(progress)} progress, {len(searched)} search, the "
                f"summary with loop_stats), watch renders them; wall "
                f"without {min(plain[2]) * 1e3:.2f} ms, to the file "
                f"{min(seen[2]) * 1e3:.2f} ms, to a list "
                f"{min(mem[2]) * 1e3:.2f} ms (best of 2 each, in turns)")
    # One run with a profiler window over the first four dispatches.
    pdir = os.path.join(work, "profile")
    step_kernel.launches = fold_kernel.launches = 0
    res = sweep(None, eng_m.cfg, np.arange(w), engine=eng_m, profile_dir=pdir,
                profile_window=(0, 4), **leg_b)
    take("raft")
    check(same_result(res_b, res), "profile_dir=: the result differs from "
          "phase 7's sweep (b)")
    traces = [os.path.join(pdir, f) for f in os.listdir(pdir)]
    check(len(traces) == 1, f"profile_dir=: {len(traces)} traces written")
    with open(traces[0], encoding="utf-8") as f:
        events = json.load(f)["traceEvents"]
    kern = [e for e in events if "step_kernel" in str(e.get("name", ""))
            and e.get("cat") == "kernel"]
    check(kern, "profile_dir=: the torch.profiler trace names no step "
          "kernel launch")
    marks = sum(e.get("name") == "madsim:chunk" for e in events)
    log(f"[10 observe d] profile_dir= over dispatches 0-4 of sweep (b): "
        f"{os.path.getsize(traces[0]) / 1e6:.2f} MB trace, {len(kern)} step "
        f"kernel launches named ({kern[0]['name'][:60]}), "
        f"{sum(e.get('dur', 0) for e in kern) / 1e3:.3f} ms of device time, "
        f"{marks} madsim:chunk spans; the result equals phase 7's")
    shutil.rmtree(work, ignore_errors=True)
    log(f"[10] phase 10 took {time.perf_counter() - t10:.1f} s; its step "
        f"kernel launches by route {p10_launches}, fold launches "
        f"{p10_folds}")

    # ---- 11. the actor compiler's checks on the card ----------------------
    p11_launches, p11_folds = phase_11(dev, paxos_failing=wide_paxos_failing)

    # ---- 12. the fleet on the card -----------------------------------------
    p12_launches, p12_folds, p12_workers = phase_12(dev)

    # ---- 13. the bridge decision kernel on the card ------------------------
    p13 = phase_13(dev, card=card)

    # ---- 14. the world-axis split on the card ------------------------------
    p14_launches, p14_folds, _p14_walls = phase_14(dev)
    log(f"total {time.perf_counter() - t_start:.1f} s")

    print(card)
    kernels = [{
        "name": "step_kernel",
        "route": "cuda",
        "source": "madsim_tpu_torch/csrc/step_raft.cu",
        "replaces": "madsim_tpu/engine/pallas_step.py:132",
        "launches": (main_launches + sweep_launches + hunt_launches["raft"]
                     + p10_launches["raft"] + p11_launches["raft"]
                     + p12_launches["raft"] + p12_workers
                     + p14_launches["raft"]),
        "max_abs_err": fam_err["raft"],
        "ms": hl["kernel_ms"],
        "plain_ms": hl["plain_ms"],
        "bound_ms": hl["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
    }]
    for fam, main in (("tpc", "tpc_crosscheck"), ("pb", "pb_crosscheck"),
                      ("paxos", "paxos_hunt"), ("pair", "guided_pair")):
        r = fam_results[main]
        kernels.append({
            "name": f"step_kernel:{fam}",
            "route": "cuda",
            "source": f"madsim_tpu_torch/csrc/step_{fam}.cu",
            "replaces": "madsim_tpu/engine/pallas_step.py:132",
            "launches": (fam_launches[fam] + hunt_launches.get(fam, 0)
                         + p10_launches.get(fam, 0) + p11_launches[fam]
                         + p12_launches.get(fam, 0)
                         + p14_launches.get(fam, 0)),
            "max_abs_err": fam_err[fam],
            "ms": r["kernel_ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": "bytes",
            "library_ms": None,
        })
    # The wide lane profile's instantiations of each route, timed on the
    # deployment of phase 6 (wide) that the packed entry above names.
    for fam, main in (("raft", "headline"), ("tpc", "tpc_crosscheck"),
                      ("pb", "pb_crosscheck"), ("paxos", "paxos_hunt"),
                      ("pair", "guided_pair")):
        r = wide_results[main]
        kernels.append({
            "name": f"step_kernel:{fam}:wide",
            "route": "cuda",
            "source": f"madsim_tpu_torch/csrc/step_{fam}.cu",
            "replaces": "madsim_tpu/engine/pallas_step.py:132",
            "launches": wide_launches[fam + ":wide"],
            "max_abs_err": fam_err[fam + ":wide"],
            "ms": r["kernel_ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": "bytes",
            "library_ms": None,
        })
    # The corpus fold (the search's harvest_fold, an XLA program in the
    # JAX package), timed at the wide hunt's 8,192 slots on the device
    # alone; its time per call (the wrapper inside), its dependent chain
    # alone and the launch floor beside it.
    fr = fold_runs[FOLD_WIDE]
    kernels.append({
        "name": "corpus_fold",
        "route": "cuda",
        "source": "madsim_tpu_torch/csrc/corpus_fold.cu",
        "replaces": "madsim_tpu/search/corpus.py:131",
        "launches": (fold_launches + p10_folds + p11_folds + p12_folds
                     + p14_folds),
        "max_abs_err": 0.0,
        "ms": fr["ms"],
        "plain_ms": fr["plain_ms"],
        "bound_ms": fr["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "call_ms": fr["call_ms"],
        "host_us": fr["host_us"],
        "chain_ms": fr["chain_ms"],
        "launch_floor_ms": fr["floor_ms"],
        "launch_floor_call_ms": fr["floor_call_ms"],
    })
    # The bridge's round and drain (JAX's _step and _drain_step, XLA
    # programs), timed on the device at the widest W of phase 13.
    bt = p13["times"]
    for name, line, what in (("bridge_step", 127, "step"),
                             ("bridge_drain", 236, "drain")):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "madsim_tpu_torch/csrc/bridge_step.cu",
            "replaces": f"madsim_tpu/bridge/kernel.py:{line}",
            "launches": p13["launches"][what],
            "max_abs_err": 0.0,
            "ms": bt[f"{what}_ms"],
            "plain_ms": bt[f"plain_{what}_ms"],
            "bound_ms": bt[f"{what}_bound_ms"],
            "bound_by": "bytes",
            "library_ms": None,
            "w": p13["w"],
            "worlds_per_block": bt["worlds_per_block"],
            "lanes_per_world": bt["lanes_per_world"],
            "launch_floor_ms": bt["launch_floor_ms"],
            "ms_by_w": {w: t[f"{what}_ms"]
                        for w, t in p13["kern_times"].items()},
            "launch_floor_ms_by_w": {w: t["launch_floor_ms"]
                                     for w, t in p13["kern_times"].items()},
            "wall_ms_per_round": {k: v[0 if what == "step" else 1]
                                  for k, v in p13["walls"].items()},
            "wall_split_ms": {k.split(":")[1]: v
                              for k, v in p13["splits"].items()
                              if k.startswith(what + ":")},
            "recorded_wall_ms_per_call": {
                k: v[what] for k, v in p13["rec_walls"].items()
                if what in v},
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except PhaseError as exc:
        print(f"chip_smoke FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
