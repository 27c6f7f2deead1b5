"""device_idle_share: 1 − the union of the device's operation intervals
over the profiled fits' wall, %. A union, not a sum: the solver's side
stream overlaps the main one."""

from portbench import tracing


def read(ctx):
    if ctx.trace is None:
        return None
    lo, hi = ctx.trace.window
    if hi <= lo:
        return None
    return 100.0 * (1.0 - tracing.busy_ns(ctx.trace.device, lo, hi)
                    / (hi - lo))
