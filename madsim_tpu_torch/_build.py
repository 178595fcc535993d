"""Build the port's CUDA sources at first use.

Each ``madsim_tpu_torch/csrc/<name>.cu`` compiles with ``nvcc`` into a
shared library with a plain C interface, ``.kernel_build/<name>-<hash>.so``
at the root of the checkout, which :func:`load` opens with ``ctypes``. The
hash covers the source and the flags, so an edited source rebuilds and an
unchanged one is reused. No PyTorch headers, no ninja: a build takes
seconds.

A failed build raises :class:`BuildError` with nvcc's output; nothing falls
back to another implementation.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
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


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    h.update((CSRC / f"{name}.cu").read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


#: nvcc's output (ptxas register and spill report) per built source.
build_log: Dict[str, str] = {}
_libs: Dict[str, ctypes.CDLL] = {}


def build(name: str) -> float:
    """Compile ``csrc/<name>.cu`` unless it is built already. Returns the
    seconds it took (0.0 when already built). nvcc's output is kept beside
    the library, so :data:`build_log` holds it either way."""
    out = library_path(name)
    if out.exists():
        log = out.with_suffix(".log")
        build_log[name] = log.read_text() if log.exists() else ""
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                           str(CSRC / f"{name}.cu")],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    build_log[name] = proc.stdout
    if proc.returncode != 0:
        raise BuildError(f"nvcc failed on {name}.cu (rc {proc.returncode}):"
                         f"\n{proc.stdout}")
    out.with_suffix(".log").write_text(proc.stdout)
    os.replace(tmp, out)
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu``, building it if needed."""
    lib = _libs.get(name)
    if lib is None:
        build(name)
        lib = _libs[name] = ctypes.CDLL(str(library_path(name)))
    return lib
