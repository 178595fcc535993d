"""Repro bundles: one JSON file that replays a failure verbatim.

The port of ``madsim_tpu/obs/bundle.py``. A *bundle* captures the whole
recipe of a failure — seed, engine/actor config (with a stable hash),
fault schedule, the recorded error — so
``python -m madsim_tpu_torch.obs replay --bundle repro.json`` reproduces
it with no archaeology. A bundle is a function of its inputs: the same
inputs give the same file, byte for byte, in both packages, and each
package replays the other's.

- ``kind="device_sweep"``: a failing seed from a device-engine sweep
  (``SweepResult.failing_seeds``); replay re-traces the seed through the
  same actor/config/schedule and exports the timeline.
- ``kind="host_test"``: a failing test of the JAX package's host
  runtime, written there by ``write_test_bundle``. The host runtime is
  not part of the port: :func:`load_bundle` reads such a bundle, and the
  replay CLI refuses it with a message that says so.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Any, Dict, Optional

BUNDLE_VERSION = 1


def _as_plain(obj: Any) -> Any:
    """Config objects → JSON-plain dicts (dataclasses pass through
    ``asdict``; dicts/lists/scalars unchanged)."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.asdict(obj)
    return obj


def config_digest(obj: Any) -> str:
    """Stable 16-hex fingerprint of a config dict/dataclass — the
    device-engine analog of ``Config.hash()`` (`config.rs:27-31`)."""
    canon = json.dumps(_as_plain(obj), sort_keys=True, default=str)
    return hashlib.sha256(canon.encode()).hexdigest()[:16]


def _write(bundle: Dict[str, Any], path: str, stem: str) -> str:
    if os.path.isdir(path):
        path = os.path.join(path, f"{stem}-{bundle['config_hash']}.json")
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(bundle, f, indent=2, default=str)
        f.write("\n")
    os.replace(tmp, path)
    return path


def write_sweep_bundle(path: str, *, seed: int, actor: str,
                       actor_config: Any, engine_config: Any,
                       faults: Optional[Any] = None,
                       max_steps: int = 2_000,
                       error: Optional[str] = None,
                       trace_path: Optional[str] = None,
                       minimization: Optional[Dict[str, Any]] = None,
                       lineage: Optional[Dict[str, Any]] = None,
                       extra: Optional[Dict[str, Any]] = None) -> str:
    """Write a device-sweep repro bundle; returns the file path.

    ``path`` may be a directory (a ``repro-seed<seed>-<hash>.json`` name
    is chosen inside it). ``actor`` is a replay-registry name
    (``raft``/``pb``/``tpc``/``paxos``/``pair_restart``/``guided_pair``
    — obs/cli.py); configs are
    the dataclass instances (or plain dicts) the sweep ran with;
    ``faults`` the schedule rows for THIS seed ((F, 4), or None).

    ``minimization`` (triage/minimize.py ``MinimizeResult.provenance()``)
    records how the recorded schedule was shrunk from the one the hunt
    actually swept — rounds, candidates evaluated, original→final row
    counts, weakenings applied (schema
    ``madsim.triage.minimization/1``). When present,
    ``faults`` should be the MINIMIZED rows: replay then reproduces the
    failure from the minimal schedule, which is the point.

    ``lineage`` (obs/lineage.py ``lineage_block``, schema
    ``madsim.search.lineage/1``) records a GUIDED find's derivation:
    the ancestry chain from the failing world back to the generation-0
    template — which corpus parents it was spliced from, which mutation
    operators touched it — plus the hunt's per-operator outcome table.
    Rendered by ``python -m madsim_tpu_torch.obs lineage <bundle>``.
    """
    import numpy as np

    acfg = _as_plain(actor_config)
    ecfg = _as_plain(engine_config)
    frows = None if faults is None else np.asarray(faults, np.int32).tolist()
    fault_sha = hashlib.sha256(
        json.dumps(frows).encode()).hexdigest()[:16] if frows else None
    bundle = {
        "version": BUNDLE_VERSION,
        "kind": "device_sweep",
        "seed": int(seed),
        "actor": actor,
        "actor_config": acfg,
        "engine_config": ecfg,
        "config_hash": config_digest({"actor": actor, "actor_config": acfg,
                                      "engine_config": ecfg}),
        "faults": frows,
        "faults_sha256": fault_sha,
        "max_steps": int(max_steps),
        "error": error,
        "trace_path": trace_path,
        "minimization": minimization,
        "lineage": lineage,
        "extra": dict(extra or {}),
    }
    return _write(bundle, path, f"repro-seed{int(seed)}")


def load_bundle(path: str) -> Dict[str, Any]:
    """Read and validate a bundle: a ``device_sweep`` bundle of either
    package, or a JAX package's ``host_test`` bundle."""
    with open(path, encoding="utf-8") as f:
        bundle = json.load(f)
    if bundle.get("version") != BUNDLE_VERSION:
        raise ValueError(
            f"unsupported bundle version {bundle.get('version')!r} "
            f"(this build reads version {BUNDLE_VERSION})")
    if bundle.get("kind") not in ("device_sweep", "host_test"):
        raise ValueError(f"unknown bundle kind {bundle.get('kind')!r}")
    return bundle
