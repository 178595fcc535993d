"""Build the port's CUDA sources at first use.

Each ``madsim_tpu_torch/csrc/<name>.cu`` compiles with ``nvcc`` into a
shared library with a plain C interface, ``.kernel_build/<name>-<hash>.so``
at the root of the checkout, which :func:`load` opens with ``ctypes``. The
hash covers the source, the ``csrc/`` headers it includes (directly or
through another header) and the flags, so an edited source or header
rebuilds the libraries that include it and reuses the others. No
PyTorch headers, no ninja. :func:`build_all` runs one nvcc per source, all
started together.

A failed build raises :class:`BuildError` with nvcc's output; nothing falls
back to another implementation.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / ".kernel_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    # No fused multiply-add and no fast math: the step's float work (the
    # top-24-bit uniform, the loss compare, ppm * 1e-6) must round exactly
    # as the plain version does.
    "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


class BuildError(RuntimeError):
    """nvcc is missing or refused a source."""


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise BuildError("nvcc not found: the CUDA kernels build only where the "
                     "CUDA toolkit is installed")


def includes(path: Path) -> set:
    """The ``csrc/`` headers that ``path`` includes as ``#include "..."``,
    directly or through another of them."""
    found, todo = set(), [path]
    while todo:
        text = todo.pop().read_text()
        for inc in re.findall(r'^\s*#\s*include\s+"([^"]+)"', text, re.M):
            header = CSRC / inc
            if header not in found:
                found.add(header)
                todo.append(header)
    return found


def library_path(name: str) -> Path:
    source = CSRC / f"{name}.cu"
    h = hashlib.sha256()
    h.update(source.read_bytes())
    for header in sorted(includes(source)):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


#: nvcc's output (ptxas register and spill report) per built source.
build_log: Dict[str, str] = {}
_libs: Dict[str, ctypes.CDLL] = {}


def build(name: str) -> float:
    """Compile ``csrc/<name>.cu`` unless it is built already. Returns the
    seconds it took (0.0 when already built). nvcc's output is kept beside
    the library, so :data:`build_log` holds it either way."""
    return build_all([name])[name]


def build_all(names) -> Dict[str, float]:
    """Compile each ``csrc/<name>.cu`` that is not built yet, one nvcc
    process per source, all started together; returns the seconds each
    took (0.0 when already built). Raises :class:`BuildError` with nvcc's
    output if any build fails, after every process has ended."""
    took, procs = {}, {}
    for name in names:
        out = library_path(name)
        if out.exists():
            log = out.with_suffix(".log")
            build_log[name] = log.read_text() if log.exists() else ""
            took[name] = 0.0
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (time.perf_counter(), tmp, subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
             str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (t0, tmp, proc) in procs.items():
        text, _ = proc.communicate()
        took[name] = time.perf_counter() - t0
        build_log[name] = text
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {name}.cu (rc {proc.returncode}):"
                          f"\n{text}")
            continue
        out = library_path(name)
        out.with_suffix(".log").write_text(text)
        os.replace(tmp, out)
    if failed:
        raise BuildError("\n".join(failed))
    return took


def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu``, building it if needed."""
    lib = _libs.get(name)
    if lib is None:
        build(name)
        lib = _libs[name] = ctypes.CDLL(str(library_path(name)))
    return lib
