"""Tracing and timing helpers.

Port of `linearcorex_tpu/utils/profiling.py`:
- `trace(logdir)` wraps `torch.profiler.profile` (CPU and CUDA
  activities), so a fit can be captured without code changes; the Chrome
  trace lands under `logdir`;
- `span(name)` marks a part of a fit as a named range of that trace, on
  the profiler's clock beside the kernels. While no profiler records, a
  span costs one check and nothing else. A fit marks these ranges
  (those marked "sync" wait for the device before they close, so that
  they hold their own device work and the phases of a traced fit do not
  overlap):

      lcx.fit                   Corex._fit: the whole fit (warmup's too)
        lcx.prepare             checks, the move, preprocessing, operand (sync)
          lcx.prepare.standardize  theta, imputation, standardisation (sync)
          lcx.prepare.operand   the Gram, bf16 cast or int8 operand (sync)
        lcx.init                the start W0, every restart lane's (sync)
          lcx.init.draw         the seeded draw and its copy (sync)
          lcx.init.spectral     the spectral init's Σ·Ω and QR (sync)
        lcx.solve               core.solver.fit_core, once per solve
          lcx.stage             one anneal stage
            lcx.stage.first     the stage's uncaptured first evaluation
            lcx.capture         the chunk's CUDA graph capture
        lcx.final               the moments at eps = 0 and the sort (sync)

  `partial_fit` and the moment-input fits mark lcx.init, lcx.solve and
  lcx.final only.
- `fit_report` turns FitDiagnostics into a readable per-stage summary
  (the diagnostics' tensors are read once, here, by explicit request);
- `iteration_rate` measures steady-state solver throughput with the
  discipline a CUDA card needs: an untimed warm-up first (the first call
  builds the kernel and lets cuBLAS pick its algorithms), CUDA events
  around each timed run, closed by a synchronize (kernel launches return
  before the work is done), and the minimum over repetitions. Compare two
  versions only within one process on one card, and keep the card's name
  and power limit beside the number: a card set below its maximum power
  runs slower under load. The iterations are the diagnostics' (every
  stage's count), never the evaluations: a captured solver loop also runs
  masked evaluations past a stage's end (`core.solver.counts`), which
  are not iterations.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import numpy as np
import torch

__all__ = ["trace", "span", "fit_report", "iteration_rate"]

_OFF = contextlib.nullcontext()


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a torch.profiler trace of the enclosed block (host
    operators, and the kernels of a CUDA card when there is one). On exit
    the Chrome trace is written to `logdir`/trace_<pid>_<ns>.json (open it
    in chrome://tracing or Perfetto). Yields the profiler, whose
    `key_averages()` hold the per-kernel times."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        # the trace is written when the block raises, too
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def span(name: str, sync: bool = False):
    """A context that marks the enclosed work as the range `name` of a
    `torch.profiler` trace (`trace`'s, or any profiler's), on the clock
    of the trace's kernels. While no profiler records it does nothing but
    that one check: no range, no event, no synchronize. With `sync`, a
    recorded span waits for the CUDA device (once CUDA is in use) before
    it closes, so that it holds its own device work; a span left by an
    exception closes without waiting."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _recorded(name, sync)


@contextlib.contextmanager
def _recorded(name: str, sync: bool):
    with torch.profiler.record_function(name):
        yield
        if sync and torch.cuda.is_initialized():
            torch.cuda.synchronize()


def _to_numpy(a) -> np.ndarray:
    from linearcorex_tpu_torch.core.solver import host_numpy
    return host_numpy(a.detach()) if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def fit_report(diagnostics, schedule=None) -> str:
    """Per-stage convergence table from FitDiagnostics. `schedule`
    defaults to the fit-time snapshot the diagnostics carry
    (`eps_schedule`); pass it explicitly only to override the labels."""
    iters = _to_numpy(diagnostics.iters_per_stage)
    tcs = _to_numpy(diagnostics.tc_per_stage)
    deltas = _to_numpy(diagnostics.delta_per_stage)
    if schedule is None:
        schedule = _to_numpy(diagnostics.eps_schedule).tolist()
    lines = ["stage  eps      iters   TC           max|dW|"]
    for s in range(len(iters)):
        eps = schedule[s] if schedule is not None else float("nan")
        lines.append(f"{s:>5}  {eps:7.4f}  {iters[s]:>5}   "
                     f"{tcs[s]:<12.6f} {deltas[s]:.3e}")
    lines.append(f"total iterations: {int(iters.sum())}")
    return "\n".join(lines)


def _on_cuda(diag) -> bool:
    return isinstance(diag.tc_per_stage, torch.Tensor) \
        and diag.tc_per_stage.is_cuda


def iteration_rate(run_fn, *args, warmup: bool = True,
                   n_timed: Optional[int] = None, reps: int = 3):
    """Time a fit program. run_fn(*args) must return (ws, diagnostics).

    One untimed call first (unless warmup=False), then `reps` timed calls,
    of which the minimum counts. When the run is on a CUDA card each call
    sits between two CUDA events and is closed by a synchronize; on the
    CPU it is timed by `time.perf_counter`. Which clock counts is decided
    once, before the timed calls. Returns
    (iterations_per_second, total_iterations, seconds), with
    total_iterations the sum of the diagnostics' iterations per stage, or
    `n_timed` when given."""
    def timed(card):
        if not card:
            t0 = time.perf_counter()
            _, diag = run_fn(*args)
            return diag, time.perf_counter() - t0
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        _, diag = run_fn(*args)
        end.record()
        torch.cuda.synchronize()
        return diag, start.elapsed_time(end) / 1e3

    # the clock is chosen once: from where the warm-up's diagnostics lie,
    # or, with no warm-up, from whether there is a card (two events on an
    # idle stream around a CPU run read the host's time)
    card = _on_cuda(run_fn(*args)[1]) if warmup \
        else torch.cuda.is_available()
    dt = float("inf")
    for _ in range(max(1, reps)):
        diag, seconds = timed(card)
        dt = min(dt, seconds)
    total = int(_to_numpy(diag.iters_per_stage).sum())
    if n_timed is not None:
        total = n_timed
    return total / dt, total, dt
