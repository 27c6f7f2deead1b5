"""Build the port's CUDA kernels with nvcc, and its host C++ library with
g++, and load them with ctypes.

Each kernel source `linearcorex_tpu_torch/csrc/<name>.cu` exposes a plain
C interface. At first use it is compiled for Hopper into a shared library,

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o _build/lib<name>_<hash>.so <name>.cu

and loaded with `ctypes.CDLL`. The library name carries a hash of the
source and the flags, so an edited source is rebuilt and an unchanged one
is reused from the build directory: `linearcorex_tpu_torch/_build/`
(`BUILD_DIR`, listed in `.gitignore`) unless `LINEARCOREX_TPU_CACHE_DIR`
moves it or `LINEARCOREX_TPU_NO_COMPILE_CACHE` makes it private to the
process (`utils.compile_cache` decides, at build time).

The host sources `csrc/gaussianize.cpp` and `csrc/loader.cpp` (the native
preprocessing kernels and the CSV block reader behind `utils.native`)
are built the same way into one library, with the flags of the repo's
`native/Makefile`:

    g++ -O3 -fPIC -shared -std=c++17 -o _build/liblcx_host_<hash>.so
        gaussianize.cpp loader.cpp

Nothing here runs at import time: the CPU tests import every module of
the package on machines with no nvcc. Every compile this process runs is
recorded in `COMPILES`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

from linearcorex_tpu_torch.utils.compile_cache import build_dir

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
HOST_SOURCES = ("gaussianize.cpp", "loader.cpp")
HOST_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")
# {'what', 'path', 'seconds'} of every compile this process has run
COMPILES: list = []


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
    return build_dir() / f"lib{name}_{digest.hexdigest()[:16]}.so"


def _compile(out: Path, compiler_cmd, what: str, force: bool) -> dict:
    """Run `compiler_cmd(tmp)` into a temporary file and move it onto
    `out`, unless `out` is already there (or `force`). Returns {'path',
    'seconds', 'log'}: seconds is 0.0 and log empty when nothing was
    compiled."""
    if out.is_file() and not force:
        return {"path": str(out), "seconds": 0.0, "log": ""}
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = compiler_cmd(tmp)
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"{cmd[0]} failed to build {what} (exit {proc.returncode}):\n"
            f"{' '.join(cmd)}\n{log}")
    os.replace(tmp, out)   # atomic: a concurrent loader sees old or new
    COMPILES.append({"what": what, "path": str(out), "seconds": seconds})
    return {"path": str(out), "seconds": seconds, "log": log}


def build(name: str, force: bool = False) -> dict:
    """Compile csrc/<name>.cu into the build directory unless an
    up-to-date library is already there (or `force`). Returns {'path',
    'seconds', 'log'}: seconds is 0.0 and log empty when nothing was
    compiled; log holds nvcc's output, including ptxas's register and
    shared-memory report."""
    return _compile(
        _library_path(name),
        lambda tmp: [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                     str(CSRC_DIR / f"{name}.cu")],
        f"{name}.cu", force)


def find_cxx() -> Optional[str]:
    """g++ on $PATH, or None when there is none."""
    return shutil.which("g++")


def _host_library_path() -> Path:
    digest = hashlib.sha256(" ".join(HOST_FLAGS).encode())
    for src in HOST_SOURCES:
        digest.update((CSRC_DIR / src).read_bytes())
    return build_dir() / f"liblcx_host_{digest.hexdigest()[:16]}.so"


def build_host(force: bool = False) -> dict:
    """Compile the host sources (HOST_SOURCES) into one shared library in
    the build directory unless an up-to-date one is already there (or
    `force`). Same hashed name and atomic replace as `build`, so several
    processes may build at once. Returns {'path', 'seconds', 'log'}. Raises
    RuntimeError when there is no g++ or when g++ fails (with its log)."""
    cxx = find_cxx()
    if cxx is None:
        raise RuntimeError(
            "g++ not found: the host library of linearcorex_tpu_torch is "
            "compiled at first use")
    return _compile(
        _host_library_path(),
        lambda tmp: [cxx, *HOST_FLAGS, "-o", str(tmp),
                     *(str(CSRC_DIR / src) for src in HOST_SOURCES)],
        " + ".join(HOST_SOURCES), force)


def load(name: str) -> ctypes.CDLL:
    """The ctypes library built from csrc/<name>.cu, built first if it is
    missing or stale. (The dynamic loader returns the same handle when a
    path is loaded again.)"""
    return ctypes.CDLL(build(name)["path"])
