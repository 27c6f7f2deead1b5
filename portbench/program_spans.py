"""The program's own spans in a traced run: the ranges that
`linearcorex_tpu_torch.utils.profiling.span` marks inside a fit (`lcx.fit`,
`lcx.prepare`, `lcx.init`, `lcx.solve`, `lcx.capture`, ...), found by name
among the trace's host events, within the profiled fits (`portbench.fit`
ranges). They lie on the profiler's clock with the device operations. A
program that marks no such range (one older than its spans) leaves every
reader here None."""

from __future__ import annotations

from typing import List, Optional, Tuple

from portbench import tracing


def fits(trace: tracing.Trace) -> List[Tuple[int, int]]:
    """The profiled fits' ranges, in order."""
    return sorted((h.start, h.end) for h in trace.host
                  if h.name == tracing.FIT_RANGE)


def ranges(trace: tracing.Trace, name: str) -> List[Tuple[int, int]]:
    """The program's ranges named `name` that lie within a profiled fit,
    in order."""
    outer = fits(trace)
    return sorted((h.start, h.end) for h in trace.host
                  if h.name == name and any(a <= h.start and h.end <= b
                                            for a, b in outer))


def per_fit_ms(ctx, name: str) -> Optional[float]:
    """The summed duration of the `name` ranges per profiled fit, ms; None
    where the trace holds no such range."""
    if ctx.trace is None:
        return None
    spans = ranges(ctx.trace, name)
    if not spans:
        return None
    return sum(e - s for s, e in spans) / len(fits(ctx.trace)) / 1e6


def idle_share(ctx, name: str) -> Optional[float]:
    """100 × (1 − the device's busy time inside the `name` ranges over
    their summed duration), %: busy time as the union of the device
    operations clipped to each range; None where there is no such
    range."""
    if ctx.trace is None:
        return None
    spans = ranges(ctx.trace, name)
    total = sum(e - s for s, e in spans)
    if total <= 0:
        return None
    busy = sum(tracing.busy_ns(ctx.trace.device, s, e) for s, e in spans)
    return 100.0 * (1.0 - busy / total)
