"""Spans and the device trace of a traced run, taken from the benchmark's
own files: the program is not edited.

- `LoopSpans` wraps the module attribute `models.corex.fit_core` (the
  solver loop; `parallel.restarts` reaches it through `models.corex`
  too) with two CUDA events on the caller's stream, which the loop's
  side stream waits on at entry and joins at exit, so each span is the
  loop's device time from the end of preparation to its last kernel. In
  a profiled fit it also marks the loop as a host range
  (`LOOP_RANGE`), after a synchronize, so that the loop's kernels are
  those that start inside it.
- `Profile` runs `torch.profiler` over a few whole fits and keeps the
  device operations (kernels, copies, sets) and the host events.
"""

from __future__ import annotations

import contextlib
import heapq
import time
from typing import List, NamedTuple, Optional, Tuple

LOOP_RANGE = "portbench.loop"
FIT_RANGE = "portbench.fit"


class LoopSpans:
    """Within the scope, every `fit_core` call records its device span
    (off a card, its host span: a test's dry run); `profiled` (set by the
    caller) also marks it as a host range."""

    def __init__(self, corex_module, torch, on_card: bool = True):
        self.mod, self.torch, self.on_card = corex_module, torch, on_card
        self.orig = corex_module.fit_core
        self.pending: list = []
        self.profiled = False

    def __enter__(self):
        self.mod.fit_core = self._wrapped
        return self

    def __exit__(self, *exc):
        self.mod.fit_core = self.orig

    def _wrapped(self, *args, **kwargs):
        torch = self.torch
        if not self.on_card:
            t0 = time.perf_counter()
            out = self.orig(*args, **kwargs)
            self.pending.append(1e3 * (time.perf_counter() - t0))
            return out
        rng = contextlib.nullcontext()
        if self.profiled:
            torch.cuda.synchronize()
            rng = torch.profiler.record_function(LOOP_RANGE)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with rng:
            start.record()
            out = self.orig(*args, **kwargs)
            end.record()
        self.pending.append((start, end))
        return out

    def take_ms(self) -> float:
        """The device milliseconds of the loops since the last call (the
        events are complete once the fit has returned and synchronized)."""
        ms = sum(p if isinstance(p, float) else p[0].elapsed_time(p[1])
                 for p in self.pending)
        self.pending = []
        return ms


class Op(NamedTuple):
    name: str
    start: int   # ns
    end: int     # ns


class Trace(NamedTuple):
    """What a profiled stretch of fits left: device operations, host
    events, the loop ranges and the stretch itself (ns on one clock)."""

    device: List[Op]
    host: List[Op]
    loops: List[Tuple[int, int]]
    window: Tuple[int, int]


class Profile:
    """torch.profiler over a stretch of whole fits (CPU and CUDA
    activities)."""

    def __init__(self, torch):
        from torch.profiler import ProfilerActivity, profile
        self.torch = torch
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])

    def start(self):
        self.torch.cuda.synchronize()
        self.prof.start()

    def stop(self):
        self.torch.cuda.synchronize()
        self.prof.stop()

    def trace(self) -> Trace:
        """The device operations and host events; the window is from the
        first profiled fit's start to the last one's end (`FIT_RANGE`)."""
        device, host, loops, fits = [], [], [], []
        for e in self.prof.profiler.kineto_results.events():
            start = e.start_ns()
            op = Op(e.name(), start, start + e.duration_ns())
            if str(e.device_type()).endswith("CUDA"):
                if not e.is_user_annotation():
                    device.append(op)
            else:
                host.append(op)
                if op.name == LOOP_RANGE:
                    loops.append((op.start, op.end))
                elif op.name == FIT_RANGE:
                    fits.append((op.start, op.end))
        spans = fits or [(o.start, o.end) for o in device + host]
        lo = min(s for s, _ in spans)
        hi = max(e for _, e in spans)
        return Trace(sorted(device, key=lambda o: o.start), host,
                     sorted(loops), (lo, hi))


def union(ops: List[Op], lo: Optional[int] = None,
          hi: Optional[int] = None) -> List[Tuple[int, int]]:
    """The union of the operations' intervals (clipped to [lo, hi]), as
    sorted disjoint intervals: the side stream's kernels overlap the
    main stream's, so busy time is a union, not a sum."""
    out: List[List[int]] = []
    for o in sorted(ops, key=lambda o: o.start):
        s, e = o.start, o.end
        if lo is not None:
            s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_ns(ops: List[Op], lo: int, hi: int) -> int:
    return sum(e - s for s, e in union(ops, lo, hi))


def inside(ops: List[Op], ranges: List[Tuple[int, int]]) -> List[Op]:
    """The operations that start inside one of `ranges`."""
    out, j = [], 0
    for o in ops:
        while j < len(ranges) and ranges[j][1] < o.start:
            j += 1
        if j < len(ranges) and ranges[j][0] <= o.start <= ranges[j][1]:
            out.append(o)
    return out


def matching(ops: List[Op], patterns) -> List[Op]:
    return [o for o in ops if any(p.search(o.name) for p in patterns)]


def device_ops(trace: Trace, top: int = 10):
    """The device operations that took most time: [name, seconds]."""
    tot: dict = {}
    for o in trace.device:
        tot[o.name] = tot.get(o.name, 0) + (o.end - o.start)
    best = sorted(tot.items(), key=lambda kv: -kv[1])[:top]
    return [[name[:160], ns / 1e9] for name, ns in best]


def idle_gaps(trace: Trace, top: int = 10):
    """The device's idle gaps within the trace, summed by what the host
    was doing at each gap's midpoint (the shortest host event around it,
    or "host code" where no profiled call was running; inside or outside
    the solver loop): [name, seconds]."""
    lo, hi = trace.window
    busy = union(trace.device, lo, hi)
    gaps, prev = [], lo
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = e
    if hi > prev:
        gaps.append((prev, hi))
    hosts = sorted((h for h in trace.host
                    if h.name not in (LOOP_RANGE, FIT_RANGE)),
                   key=lambda h: h.start)
    tot: dict = {}
    active: list = []          # heap of (duration, end, name)
    i = 0
    for s, e in gaps:
        mid = (s + e) // 2
        while i < len(hosts) and hosts[i].start <= mid:
            h = hosts[i]
            heapq.heappush(active, (h.end - h.start, h.end, h.name))
            i += 1
        while active and active[0][1] <= mid:
            heapq.heappop(active)
        name = active[0][2] if active else "host code"
        where = "loop" if any(a <= mid <= b for a, b in trace.loops) \
            else "outside"
        key = f"{where}: {name[:120]}"
        tot[key] = tot.get(key, 0) + (e - s)
    best = sorted(tot.items(), key=lambda kv: -kv[1])[:top]
    return [[name, ns / 1e9] for name, ns in best]
