"""Arithmetic shared by the per-layer readers in `metrics/` of fit
traffic (`generators/fitloop.py`): each reads the window's fit records
(spans and the solver's counters), the device trace of its first fits
and the yardstick. A reader returns None where
it finds nothing to read; a share of a roofline or a peak is never made
up as 0."""

from __future__ import annotations

from typing import Optional

from portbench import tracing, yardstick


def profiled(ctx):
    """The records of the profiled fits (the window's first ones, whose
    loops lie in the trace)."""
    if ctx.trace is None:
        return []
    return [f for f in ctx.window.fits if f.profiled]


def unprofiled(ctx):
    """The records of the fits that ran without the profiler: what a
    span or a rate reads over, so that the profiler's own cost and the
    spans' synchronisations in the profiled fits stay out of it."""
    return [f for f in ctx.window.fits if not f.profiled]


def evaluations(fits) -> int:
    """The objective evaluations the loops ran: each stage's first one
    and every body of a chunk, masked ones included."""
    return sum(f.first_evaluations + f.bodies for f in fits)


def loop_ops(ctx, layer: str):
    """The device operations of the profiled loops that `layer`'s
    patterns (kernels/<layer>*.json) name."""
    ops = tracing.inside(ctx.trace.device, ctx.trace.loops)
    return tracing.matching(ops, ctx.patterns(layer))


def roofline(ctx, layer: str, least_s: float) -> Optional[float]:
    """100 × the least seconds of the work over the device seconds of the
    layer's kernels in the profiled loops; None when none ran."""
    if ctx.trace is None or least_s <= 0:
        return None
    ops = loop_ops(ctx, layer)
    dev_ns = sum(e - s for s, e in tracing.union(ops))
    if dev_ns <= 0:
        return None
    return 100.0 * least_s / (dev_ns / 1e9)


def sigma_gemm_least_s(ctx) -> float:
    return evaluations(profiled(ctx)) * yardstick.gemms(ctx.shape)["seconds"]


def chain_least_s(ctx) -> float:
    s = ctx.shape
    fits = profiled(ctx)
    one = sum(f.chain_launches for f in fits)
    lanes = sum(f.chain_lane_launches for f in fits)
    return (one * yardstick.chain(s.p, s.m, 1)["seconds"]
            + lanes * yardstick.chain(s.p, s.m, s.k)["seconds"])
