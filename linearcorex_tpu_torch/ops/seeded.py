"""Seeded normal draws, bit for bit NumPy's legacy stream, on the host's
threads.

A seeded fit starts from `numpy.random.RandomState(seed).normal(...)`:
the random init's W0 (m, p) at scale 1/sqrt(p), the spectral init's Ω
(p, m), one stream a restart lane (seed + r). The JAX package, the
float64 oracle and the benchmark's reference derive each fit's start
from the same stream, so its bits are the contract: another generator
would be another fit. NumPy draws it in one sequential loop (28-38 ns a
normal on an H100's host). The host library (`csrc/seeded_normal.cpp`,
`lcx_seeded_normal`) draws the same bits on several threads: only the
MT19937 twist and the running count of kept polar attempts are
sequential. Nothing runs on the card: the device's `log` is not the
host libm's.

`seeded_normal(seeds, shape, ...)` draws now. `Draw(...)` begins the
same draw, on a host thread when it is large enough for several (the C
call releases the GIL), so that a fit can begin it at its entry and take
it after its preparation (`Corex._fit`); that thread marks its work
`lcx.draw.host`, a range a profiler records only where it records every
thread (`torch.profiler`'s `profile_all_threads`). A smaller draw runs
in the caller, inside the caller's own ranges. The draw is
written into host memory, pinned when it goes to a card, in the model
dtype for float32 and float64; for the half dtypes it is written in
float64 and cast as NumPy's float64 draw was, so nothing rounds twice
more than before.

The library is loaded and checked against NumPy on a short draw once a
process (`load`; `warmup_fit` calls it, so no build lands in a timed
fit). Without g++, or where the check fails, NumPy draws the same bits.
`counts` says which served.
"""

from __future__ import annotations

import math
import numbers
import os
import threading
import time
from typing import Optional

import numpy as np
import torch

from linearcorex_tpu_torch.utils.profiling import span

__all__ = ["seeded_normal", "Draw", "DrawCounts", "counts", "load",
           "threads_for"]

# The draws take one thread per this many normals: a thread costs ~0.1 ms
# to start on an H100's host, more than a smaller share of the draw saves
# (PERF.md §6).
MIN_NORMALS_PER_THREAD = 1 << 15
MAX_SEED = 2**32 - 1        # NumPy's legacy seeding takes 0 .. 2**32 - 1
# the check against NumPy: odd n past a few twisted blocks, two threads
_CHECK = {"seeds": (0, 12345, MAX_SEED), "n": 2001, "loc": 0.25,
          "scale": 1.0 / math.sqrt(3.0), "threads": 2}


class DrawCounts:
    """What the seeded draws of this process did (set to 0 by `reset`):
    the draws (one a fit's start: its W0, its Ω or a sweep's stack),
    their streams (one a seed) drawn by the host library and by NumPy,
    the normals drawn, and the host seconds spent drawing (on the drawing
    thread, waits for it not included)."""

    FIELDS = ("draws", "library", "numpy", "normals", "seconds")

    def __init__(self):
        self.reset()

    def reset(self):
        for name in self.FIELDS:
            setattr(self, name, 0)
        self.seconds = 0.0

    def as_dict(self) -> dict:
        return {name: getattr(self, name) for name in self.FIELDS}


counts = DrawCounts()

_lib = None                 # the checked library; False: NumPy serves
_load_lock = threading.Lock()
_counts_lock = threading.Lock()
fallback_reason: Optional[str] = None   # why NumPy serves, once decided


def _fill_library(lib, out: torch.Tensor, seeds, n: int, loc: float,
                  scale: float, threads: int) -> None:
    """`lcx_seeded_normal` into `out`, a contiguous host tensor of
    len(seeds) * n float32 or float64 values."""
    if out.device.type != "cpu" or not out.is_contiguous() \
            or out.dtype not in (torch.float32, torch.float64) \
            or out.numel() != len(seeds) * n:
        raise ValueError(
            f"the draw needs a contiguous host float32 or float64 tensor "
            f"of {len(seeds)} x {n} values, got {out.dtype} "
            f"{tuple(out.shape)} on {out.device}")
    arr = np.asarray(seeds, dtype=np.uint32)
    lib.lcx_seeded_normal(arr.ctypes.data, len(arr), n, loc, scale,
                          int(out.dtype == torch.float32), out.data_ptr(),
                          threads)


def _fill_numpy(out: torch.Tensor, seeds, shape, loc: float,
                scale: float) -> None:
    flat = out.view(len(seeds), *shape)
    for i, s in enumerate(seeds):
        flat[i].copy_(torch.from_numpy(np.random.RandomState(s).normal(
            loc=loc, scale=scale, size=shape)))


def _agrees(lib) -> bool:
    """The library's float64 draw is NumPy's, bit for bit, on `_CHECK`."""
    c = _CHECK
    out = torch.empty((len(c["seeds"]), c["n"]), dtype=torch.float64)
    _fill_library(lib, out, c["seeds"], c["n"], c["loc"], c["scale"],
                  c["threads"])
    want = np.stack([np.random.RandomState(s).normal(c["loc"], c["scale"],
                                                     c["n"])
                     for s in c["seeds"]])
    return np.array_equal(out.numpy().view(np.uint64), want.view(np.uint64))


def load() -> bool:
    """Load the host library (g++ builds it at first use) and check it
    against NumPy, once a process. True when it serves the draws; False
    when NumPy does (`fallback_reason` says why). A g++ that fails on
    the sources raises, as `utils.native.get_lib` does."""
    global _lib, fallback_reason
    with _load_lock:
        if _lib is None:
            from linearcorex_tpu_torch.utils import native
            lib = native.get_lib()
            if lib is None:
                _lib, fallback_reason = False, "no g++ to build the library"
            elif not _agrees(lib):
                _lib, fallback_reason = False, (
                    "the library's draw differs from NumPy's on this host")
            else:
                _lib = lib
        return _lib is not False


def threads_for(normals: int) -> int:
    """Threads for a draw of `normals` in all: one per
    MIN_NORMALS_PER_THREAD, at least one, at most the CPUs this process
    may run on."""
    try:
        cpus = len(os.sched_getaffinity(0))
    except AttributeError:    # no affinity on this platform
        cpus = os.cpu_count() or 1
    return max(1, min(cpus, normals // MIN_NORMALS_PER_THREAD))


def _count(served: str, streams: int, normals: int, seconds: float):
    with _counts_lock:
        counts.draws += 1
        setattr(counts, served, getattr(counts, served) + streams)
        counts.normals += normals
        counts.seconds += seconds


def _valid_seed(s) -> bool:
    return isinstance(s, numbers.Integral) and 0 <= s <= MAX_SEED


class Draw:
    """One seeded draw, begun at construction: NumPy's
    `RandomState(seeds).normal(loc, scale, shape)` for one integer seed,
    or the (len(seeds), *shape) stack of one stream a seed, as `dtype` on
    `device`. It runs on a host thread when `threads_for` gives it more
    than one, else in the caller. `result()` waits for it and returns it;
    `close()` waits for it and drops it, so that no thread outlives its
    buffer. Seeds NumPy refuses (negative, above 2**32 - 1, not integers)
    are left to NumPy at `result()`, which raises there as it did."""

    def __init__(self, seeds, shape, loc=0.0, scale=1.0,
                 dtype=torch.float32, device="cpu"):
        self._stack = np.ndim(seeds) > 0
        self._seeds = list(seeds) if self._stack else [seeds]
        self._valid = all(map(_valid_seed, self._seeds))
        self._shape = tuple(int(d) for d in shape)
        self._loc, self._scale = float(loc), float(scale)
        self._dtype = dtype
        self._device = torch.device(device)
        self._thread = None
        self._error = None
        self._seconds = None
        self._counted = False
        self._library = False
        self._host = None
        if not self._valid:
            return
        n = math.prod(self._shape)
        total = n * len(self._seeds)
        self._library = load()
        host = dtype if dtype in (torch.float32, torch.float64) \
            else torch.float64
        full = (len(self._seeds), *self._shape) if self._stack \
            else self._shape
        self._host = torch.empty(full, dtype=host,
                                 pin_memory=self._device.type == "cuda")
        threads = threads_for(total)
        if threads > 1:
            self._thread = threading.Thread(
                target=self._run_marked, args=(n, threads), daemon=True,
                name="lcx.draw.host")
            self._thread.start()
        else:
            self._run(n, 1)

    def _run(self, n: int, threads: int) -> None:
        t0 = time.perf_counter()
        try:
            if self._library:
                _fill_library(_lib, self._host, self._seeds, n, self._loc,
                              self._scale, threads)
            else:
                _fill_numpy(self._host, self._seeds, self._shape,
                            self._loc, self._scale)
        except Exception as e:   # raised again by result()
            self._error = e
        self._seconds = time.perf_counter() - t0

    def _run_marked(self, n: int, threads: int) -> None:
        with span("lcx.draw.host"):
            self._run(n, threads)

    def _join(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._host is not None and not self._counted:
            self._counted = True
            _count("library" if self._library else "numpy",
                   len(self._seeds), self._host.numel(), self._seconds)

    def close(self) -> None:
        """Wait for the draw and drop it."""
        self._join()
        self._host = None

    def result(self) -> torch.Tensor:
        """Wait for the draw; it as `dtype` on `device`."""
        self._join()
        if self._error is not None:
            raise self._error
        if not self._valid:
            w = np.stack([np.random.RandomState(s).normal(
                loc=self._loc, scale=self._scale, size=self._shape)
                for s in self._seeds])
            _count("numpy", len(self._seeds), w.size, 0.0)
            return torch.as_tensor(w if self._stack else w[0],
                                   dtype=self._dtype, device=self._device)
        out, self._host = self._host, None
        if out.dtype != self._dtype:   # a half dtype: cast on the host
            out = out.to(self._dtype)
        if self._device.type != "cpu":
            out = out.to(self._device, non_blocking=out.is_pinned())
        return out


def seeded_normal(seeds, shape, loc=0.0, scale=1.0, dtype=torch.float32,
                  device="cpu") -> torch.Tensor:
    """NumPy's `RandomState(seed).normal(loc, scale, shape)` for one
    integer seed, or the (len(seeds), *shape) stack of one stream a seed
    (`np.stack` of the per-seed draws), bit for bit, as `dtype` on
    `device`: float32 and float64 written directly, the half dtypes cast
    from the float64 draw."""
    return Draw(seeds, shape, loc, scale, dtype, device).result()
