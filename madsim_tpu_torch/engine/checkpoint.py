"""Engine checkpoints: a ``WorldState`` to an npz file on disk and back.

The PyTorch counterpart of ``madsim_tpu/engine/checkpoint.py``, in its
file format: the state's leaves as ``leaf_00000..leaf_NNNNN`` in
``jax.tree.leaves`` order (a compiled actor's lanes in sorted key order),
each in the JAX package's dtype, named host arrays beside them as
``aux_<name>``, and a ``meta`` JSON header (format version, leaf count,
world count, the engine's fingerprint, the caller's metadata, the aux
names). The structure comes from the engine at load time, so nothing is
pickled, and a split run is bitwise an unbroken one.

A file written by either package loads in the other where the two
fingerprints agree: for Raft and the pair actors (whose configs' reprs are
the same in both) under every ``EngineConfig``. A compiled actor's
(two-phase commit, primary-backup, Paxos) fingerprint in the JAX package
holds its spec's handler functions with their addresses, so its file loads
in no other engine, not even in JAX (ROADMAP Queue C 2). The port writes
each function by its qualified name without the address, so its own
checkpoints of those families resume in a new engine and a new process;
a JAX-written one of them does not load here.
"""
from __future__ import annotations

import json
import os
import re
from pathlib import Path
from typing import Dict, Optional, Union

import numpy as np

from .convert import state_from_numpy, to_numpy
from .core import tree_leaves

FORMAT_VERSION = 1

# npz entry prefix of the auxiliary arrays (a sweep's bookkeeping beside the
# state: the slot->seed index, the refill cursor, retired observations, the
# coverage ledger, the search's state). Loads that do not ask see none.
_AUX_PREFIX = "aux_"

# " at 0x7f..>" of a repr of a function or object: the address differs in
# every process.
_ADDRESS = re.compile(r" at 0x[0-9a-fA-F]+>")


class CheckpointError(RuntimeError):
    pass


def _config_fingerprint(engine) -> str:
    """What a checkpoint must match to resume: the actor's class and
    configuration and the ``EngineConfig`` — the JAX fingerprint's string,
    with every address in it dropped."""
    return _ADDRESS.sub(">", f"{type(engine.actor).__name__}/"
                             f"{vars(engine.actor)!r}/{engine.cfg!r}")


def save(engine, state, path: Union[str, Path],
         extra_meta: Optional[Dict[str, str]] = None,
         extra_arrays: Optional[Dict[str, np.ndarray]] = None) -> None:
    """Write a state (any world count; its leaves tensors on any device or
    host arrays; a batch split over a mesh, ``parallel/mesh.py``
    ``Sharded``, is written gathered) to ``path``, atomically: the bytes
    land in a temporary file that is flushed and fsync'd before
    ``os.replace`` publishes it, so a crash at any point leaves the
    previous checkpoint whole. A split sweep resumes on a mesh of the
    same size (the sweep's padded seeds are in its metadata).

    ``extra_arrays``: named host arrays saved beside the leaves
    (``aux_<name>``), read back by ``load(..., with_aux=True)``.
    ``extra_meta``: string pairs a later :func:`load` can require.
    """
    from ..parallel.mesh import Sharded

    if isinstance(state, Sharded):
        state = state.gather()
    leaves = [to_numpy(x) for x in tree_leaves(state)]
    arrays = {f"leaf_{i:05d}": a for i, a in enumerate(leaves)}
    aux = {f"{_AUX_PREFIX}{k}": np.asarray(v)
           for k, v in (extra_arrays or {}).items()}
    now = leaves[0]
    meta = {
        "version": FORMAT_VERSION,
        "n_leaves": len(leaves),
        "n_worlds": int(now.shape[0]) if now.ndim else 0,
        "config": _config_fingerprint(engine),
        "extra": dict(extra_meta or {}),
        "aux": sorted(extra_arrays or {}),
    }
    path = Path(path)
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as f:
        # Uncompressed: the write overlaps the sweep's next chunks.
        np.savez(f, meta=np.frombuffer(
            json.dumps(meta).encode(), dtype=np.uint8), **arrays, **aux)
        # Durability before visibility: the rename must never publish a
        # name whose bytes are still only in the page cache.
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _corrupt(path, exc: BaseException) -> CheckpointError:
    """A decode failure as a CheckpointError naming the file and what to
    do about it."""
    return CheckpointError(
        f"corrupt or truncated checkpoint {os.fspath(path)!r}: "
        f"{type(exc).__name__}: {exc}\n"
        "recovery options: delete the file (or run with resume=False) to "
        "restart this range from its seeds — re-execution is "
        "deterministic, so nothing but time is lost — or point at an "
        "older intact checkpoint")


def load(engine, path: Union[str, Path],
         expect_extra: Optional[Dict[str, str]] = None,
         with_aux: bool = False):
    """Read a state written by :func:`save` (by this package or, where the
    fingerprints agree, by the JAX package) onto the engine's device.

    ``expect_extra``: pairs the file's metadata must hold (a sweep's seed
    and schedule hashes). ``with_aux=True`` returns ``(state, aux)``,
    ``aux`` the arrays saved with ``extra_arrays`` (``{}`` for none).
    A truncated or corrupt file raises :class:`CheckpointError` naming
    the file and the recovery options.
    """
    try:
        with np.load(Path(path)) as z:
            try:
                meta = json.loads(bytes(z["meta"]).decode())
            except Exception as exc:
                raise _corrupt(path, exc) from exc
            if meta.get("version") != FORMAT_VERSION:
                raise CheckpointError(
                    f"unsupported checkpoint version {meta.get('version')}")
            fp = _config_fingerprint(engine)
            if meta["config"] != fp:
                raise CheckpointError(
                    "checkpoint was written by a different engine config:\n"
                    f"  checkpoint: {meta['config']}\n  this engine: {fp}")
            stored_extra = meta.get("extra", {})
            for key, value in (expect_extra or {}).items():
                if stored_extra.get(key) != value:
                    raise CheckpointError(
                        f"checkpoint metadata mismatch for {key!r}: "
                        f"checkpoint has {stored_extra.get(key)!r}, "
                        f"caller expects {value!r}")
            leaves = [z[f"leaf_{i:05d}"] for i in range(meta["n_leaves"])]
            aux = {name: z[f"{_AUX_PREFIX}{name}"]
                   for name in meta.get("aux", [])}
    except CheckpointError:
        raise
    except Exception as exc:
        # Garbage, truncation and missing members are one fact: this file
        # cannot be resumed from.
        raise _corrupt(path, exc) from exc
    try:
        state = state_from_numpy(leaves, engine.cfg, engine.actor,
                                 engine.device)
    except ValueError as exc:
        raise CheckpointError(
            f"checkpoint {os.fspath(path)!r} does not fit this engine: "
            f"{exc} — incompatible engine version") from exc
    return (state, aux) if with_aux else state


def read_meta(path: Union[str, Path]) -> Dict[str, object]:
    """The checkpoint's meta header alone, without decoding the state."""
    try:
        with np.load(Path(path)) as z:
            return json.loads(bytes(z["meta"]).decode())
    except Exception as exc:
        raise _corrupt(path, exc) from exc
