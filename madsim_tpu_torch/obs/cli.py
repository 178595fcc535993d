"""obs CLI: ``python -m madsim_tpu_torch.obs replay|lineage|watch ...``.

The port of ``madsim_tpu/obs/cli.py``. ``replay`` re-runs a failing seed
through the port's engine and exports its timeline; the whole recipe can
ride in a repro bundle (obs/bundle.py), written by either package.
``lineage`` renders a guided find's ancestry; ``watch`` tails or
summarizes a live sweep telemetry stream (``sweep(observe="tele.jsonl")``,
obs/observatory.py), optionally refreshing a Prometheus text snapshot:

    python -m madsim_tpu_torch.obs watch /tmp/tele.jsonl       # summary
    python -m madsim_tpu_torch.obs watch /tmp/tele.jsonl --follow \\
        --prom /var/lib/node_exporter/madsim.prom

Replay usage:

    # a seed from SweepResult.failing_seeds, explicit config
    python -m madsim_tpu_torch.obs replay --seed 17234 --actor raft \\
        --actor-config '{"n": 3, "buggy_double_vote": true}' \\
        --out trace.json

    # a bundle written by a failing sweep or by triage
    python -m madsim_tpu_torch.obs replay --bundle repro.json \\
        --out trace.json [--crosscheck]

Replay runs on the card (``--device cuda``, the default); ``--device
cpu`` runs the plain PyTorch step on the CPU. Device bundles re-trace the
seed through the same actor/config/schedule and write Chrome trace-event
JSON (``--format text`` for a terminal rendering). A ``host_test`` bundle
(the JAX package's host runtime, not part of the port) exits 2.
Exit codes: 0 = replay ran (and reproduced the recorded failure, when
one was recorded), 1 = a recorded failure did NOT reproduce, 2 = usage.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict, List, Optional

from .bundle import load_bundle
from .timeline import dump_chrome, render_text, trace_to_chrome


def _actor_registry() -> Dict[str, tuple]:
    # One shared family table (engine/families.py): the replay CLI and
    # triage's bundle naming read the same registry, so a family
    # registers once and replays and triages everywhere.
    from ..engine.families import actor_families

    return {name: (fam.actor_cls, fam.config_cls)
            for name, fam in actor_families().items()}


def _replay_device(seed: int, actor_name: str, actor_config: Dict[str, Any],
                   engine_config: Dict[str, Any], faults,
                   max_steps: int, out: Optional[str], fmt: str,
                   expect_bug: Optional[bool], device: str) -> int:
    import numpy as np

    from ..engine import DeviceEngine, EngineConfig

    registry = _actor_registry()
    if actor_name not in registry:
        print(f"obs replay: unknown actor {actor_name!r} "
              f"(known: {sorted(registry)})", file=sys.stderr)
        return 2
    actor_cls, acfg_cls = registry[actor_name]
    acfg = acfg_cls(**(actor_config or {}))
    actor = actor_cls(acfg)
    cfg = EngineConfig(**(engine_config or {"n_nodes": acfg.n}))
    frows = None if faults is None else np.asarray(faults, np.int32)
    eng = DeviceEngine(actor, cfg, device=device)
    trace = eng.trace(int(seed), max_steps=max_steps, faults=frows)
    bug_seen = any(e.get("bug_raised") for e in trace)
    if fmt == "text":
        text = render_text(trace)
        if out:
            with open(out, "w", encoding="utf-8") as f:
                f.write(text + "\n")
        else:
            print(text)
    else:
        doc = trace_to_chrome(trace, seed=int(seed),
                              label=f"{actor_name} seed {seed}")
        if out:
            dump_chrome(doc, out)
        else:
            json.dump(doc, sys.stdout, indent=1)
            print()
    print(f"obs replay: seed {seed} ({actor_name}): {len(trace)} events, "
          f"invariant {'RAISED' if bug_seen else 'held'}"
          + (f", wrote {out}" if out else ""), file=sys.stderr)
    if expect_bug and not bug_seen:
        print("obs replay: bundle recorded a failure but the invariant "
              "held on replay — config/schedule drift?", file=sys.stderr)
        return 1
    return 0


def _crosscheck_blackbox(bundle: Dict[str, Any], device: str) -> int:
    """``replay --crosscheck``: verify the bundle's recorded flight-
    recorder ring is BITWISE the suffix of a freshly replayed
    ``trace()`` (obs/blackbox.py ``ring_matches_trace``).

    The ``madsim.blackbox/1`` block is self-contained: it carries the
    schedule rows the ring was RECORDED under and the world's final
    step count, so the crosscheck replays exactly the recorded window —
    independent of the bundle's top-level (possibly minimized) schedule.
    Determinism makes this a free cross-execution check: a ring recorded
    by the CUDA kernel, held to a trace the replay device runs. Exit 0 =
    bitwise match, 1 =
    ring/replay divergence, 2 = no block / unknown actor.
    """
    import numpy as np

    from ..engine import DeviceEngine, EngineConfig
    from .blackbox import SCHEMA, ring_matches_trace

    block = (bundle.get("extra") or {}).get("blackbox")
    if not block:
        print("obs replay: --crosscheck needs a bundle carrying a "
              f"{SCHEMA} block (written by a blackbox-on sweep/triage "
              "— EngineConfig(blackbox=K))", file=sys.stderr)
        return 2
    if block.get("schema") != SCHEMA:
        print(f"obs replay: unknown blackbox block schema "
              f"{block.get('schema')!r} (this build reads {SCHEMA})",
              file=sys.stderr)
        return 2
    registry = _actor_registry()
    actor_name = bundle.get("actor")
    if actor_name not in registry:
        print(f"obs replay: unknown actor {actor_name!r} "
              f"(known: {sorted(registry)})", file=sys.stderr)
        return 2
    actor_cls, acfg_cls = registry[actor_name]
    actor = actor_cls(acfg_cls(**(bundle.get("actor_config") or {})))
    acfg_n = getattr(actor, "n", None)
    cfg = EngineConfig(**(bundle.get("engine_config")
                          or {"n_nodes": acfg_n}))
    frows = block.get("faults")
    frows = None if frows is None else np.asarray(frows, np.int32)
    eng = DeviceEngine(actor, cfg, device=device)
    steps = int(block.get("steps") or bundle.get("max_steps", 2_000))
    trace = eng.trace(int(block["seed"]), max_steps=steps, faults=frows)
    err = ring_matches_trace(block.get("events") or [], trace,
                             total=block.get("n_total"))
    if err:
        print(f"obs replay --crosscheck: RING/REPLAY DIVERGENCE: {err}",
              file=sys.stderr)
        return 1
    print(f"obs replay --crosscheck: seed {block['seed']}: recorded ring "
          f"({block.get('n_records')} events, K={block.get('k')}) is "
          f"bitwise the suffix of the replayed trace ({len(trace)} "
          "events)", file=sys.stderr)
    return 0


def _lineage_cmd(path: str, out=None) -> int:
    """``obs lineage <bundle|telemetry.jsonl>``: render a guided find's
    ancestry tree + the hunt's per-operator outcome table
    (obs/lineage.py; schema ``madsim.search.lineage/1``). Accepts a
    repro bundle carrying a ``lineage`` block (triage/corpus.py) or a
    sweep telemetry JSONL whose summary record carries ``search.finds``.
    Exit 0 = rendered, 2 = the file holds no lineage."""
    from .lineage import render_operator_table, render_tree

    out = out or sys.stdout
    if not os.path.exists(path):
        print(f"obs lineage: no such file: {path}", file=sys.stderr)
        return 2
    blocks: List[Dict[str, Any]] = []
    stats = None
    with open(path, encoding="utf-8") as f:
        text = f.read()
    try:
        doc = json.loads(text)
    except ValueError:
        doc = None
    if isinstance(doc, dict):
        # A repro bundle (obs/bundle.py) with a lineage block.
        block = doc.get("lineage")
        if block:
            blocks = [block]
            stats = block.get("operator_stats")
    else:
        # A telemetry JSONL stream: the sweep summary record carries
        # search.finds (+ operator_stats inside each block).
        for line in text.splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            srch = rec.get("search") if isinstance(rec, dict) else None
            if isinstance(srch, dict) and srch.get("finds"):
                blocks = list(srch["finds"])
                stats = (blocks[0].get("operator_stats")
                         or srch.get("operator_stats"))
    if not blocks:
        print(f"obs lineage: no lineage block in {path} — is it a "
              "guided-hunt bundle (triage over a search= sweep with "
              "SearchConfig(lineage=True)) or its telemetry stream?",
              file=sys.stderr)
        return 2
    for block in blocks:
        print(f"find: seed {block.get('seed')} (depth "
              f"{block.get('depth')}, operators: "
              f"{', '.join(block.get('operators_applied') or []) or 'none'})",
              file=out)
        print(render_tree(block.get("chain") or []), file=out)
        if stats is None:
            stats = block.get("operator_stats")
    if stats:
        print(render_operator_table(stats), file=out)
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="madsim_tpu_torch.obs",
        description="observability tools: replay failing seeds, export "
                    "timelines, render lineage, watch telemetry")
    sub = ap.add_subparsers(dest="cmd", required=True)
    rp = sub.add_parser("replay", help="replay a seed / repro bundle and "
                                       "export its timeline")
    rp.add_argument("--bundle", help="repro bundle JSON (obs/bundle.py)")
    rp.add_argument("--seed", type=int, help="seed to replay (without a "
                                             "bundle)")
    rp.add_argument("--actor", help="actor family: raft | pb | tpc | "
                                    "paxos | pair_restart | guided_pair")
    rp.add_argument("--actor-config", default=None,
                    help="JSON dict of actor-config overrides")
    rp.add_argument("--engine-config", default=None,
                    help="JSON dict of EngineConfig fields (n_nodes, ...)")
    rp.add_argument("--faults", default=None,
                    help="JSON (F, 4) fault rows [time_us, op, a, b]")
    rp.add_argument("--max-steps", type=int, default=None)
    rp.add_argument("--out", default=None, help="output file (default: "
                                                "stdout)")
    rp.add_argument("--format", choices=("chrome", "text"), default="chrome")
    rp.add_argument("--crosscheck", action="store_true",
                    help="after the replay, verify the bundle's recorded "
                         "flight-recorder ring (madsim.blackbox/1 block) "
                         "is bitwise the suffix of the replayed trace")
    rp.add_argument("--device", default="cuda",
                    help="torch device the replay runs on (default: cuda; "
                         "cpu runs the plain step on the CPU)")
    wp = sub.add_parser("watch", help="tail/summarize a sweep telemetry "
                                      "JSONL stream (sweep(observe=...))")
    wp.add_argument("file", help="telemetry JSONL written by "
                                 "sweep(observe=<path>)")
    wp.add_argument("--follow", action="store_true",
                    help="tail the stream until its summary record lands")
    wp.add_argument("--interval", type=float, default=1.0,
                    help="poll interval in seconds (--follow)")
    wp.add_argument("--prom", default=None,
                    help="also write a Prometheus text snapshot of the "
                         "latest record to this path (atomic rewrite)")
    lp = sub.add_parser("lineage", help="render a guided find's ancestry "
                                        "tree + operator outcome table")
    lp.add_argument("file", help="repro bundle with a lineage block, or "
                                 "a sweep telemetry JSONL")
    args = ap.parse_args(argv)

    if args.cmd == "lineage":
        return _lineage_cmd(args.file)
    if args.cmd == "watch":
        from .observatory import watch

        return watch(args.file, follow=args.follow, prom=args.prom,
                     interval=args.interval)
    if args.bundle:
        bundle = load_bundle(args.bundle)
        if bundle["kind"] == "host_test":
            print(f"obs replay: {args.bundle} is a host_test bundle: the "
                  "host runtime (@madsim_tpu.test) is not part of the "
                  "port; replay it with python -m madsim_tpu.obs",
                  file=sys.stderr)
            return 2
        rc = _replay_device(
            seed=bundle["seed"], actor_name=bundle["actor"],
            actor_config=bundle.get("actor_config") or {},
            engine_config=bundle.get("engine_config") or {},
            faults=bundle.get("faults"),
            max_steps=args.max_steps or int(bundle.get("max_steps", 2_000)),
            out=args.out, fmt=args.format,
            expect_bug=bundle.get("error") is not None, device=args.device)
        if rc != 0 or not args.crosscheck:
            return rc
        return _crosscheck_blackbox(bundle, args.device)
    if args.crosscheck:
        ap.error("--crosscheck needs --bundle (the recorded ring rides "
                 "the bundle's madsim.blackbox/1 block)")
    if args.seed is None or not args.actor:
        ap.error("replay needs --bundle, or --seed and --actor")
    return _replay_device(
        seed=args.seed, actor_name=args.actor,
        actor_config=json.loads(args.actor_config) if args.actor_config
        else {},
        engine_config=json.loads(args.engine_config) if args.engine_config
        else None,
        faults=json.loads(args.faults) if args.faults else None,
        max_steps=args.max_steps or 2_000, out=args.out, fmt=args.format,
        expect_bug=None, device=args.device)
