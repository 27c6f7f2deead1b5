"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each kernel source `linearcorex_tpu_torch/csrc/<name>.cu` exposes a plain
C interface. At first use it is compiled for Hopper into a shared library,

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o _build/lib<name>_<hash>.so <name>.cu

and loaded with `ctypes.CDLL`. The library name carries a hash of the
source and the flags, so an edited source is rebuilt and an unchanged one
is reused from `linearcorex_tpu_torch/_build/` (listed in `.gitignore`).
Nothing here runs at import time: the CPU tests import every module of
the package on machines with no nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME or $CUDA_PATH, then $PATH, then the toolkit's
    conventional location."""
    for env in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(env)
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    conventional = Path("/usr/local/cuda/bin/nvcc")
    if conventional.is_file():
        return str(conventional)
    raise RuntimeError(
        "nvcc not found: set CUDA_HOME to the CUDA toolkit (the kernels of "
        "linearcorex_tpu_torch are compiled at first use for sm_90a)")


def _library_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build(name: str, force: bool = False) -> dict:
    """Compile csrc/<name>.cu into BUILD_DIR unless an up-to-date library
    is already there (or `force`). Returns {'path', 'seconds', 'log'}:
    seconds is 0.0 and log empty when nothing was compiled; log holds
    nvcc's output, including ptxas's register and shared-memory report."""
    out = _library_path(name)
    if out.is_file() and not force:
        return {"path": str(out), "seconds": 0.0, "log": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           str(CSRC_DIR / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed to build {name}.cu (exit {proc.returncode}):\n"
            f"{' '.join(cmd)}\n{log}")
    os.replace(tmp, out)   # atomic: a concurrent loader sees old or new
    return {"path": str(out), "seconds": seconds, "log": log}


def load(name: str) -> ctypes.CDLL:
    """The ctypes library built from csrc/<name>.cu, built first if it is
    missing or stale. (The dynamic loader returns the same handle when a
    path is loaded again.)"""
    return ctypes.CDLL(build(name)["path"])
