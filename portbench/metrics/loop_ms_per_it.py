"""loop_ms_per_it: the solver loop's device ms (`fit_core` spans, summed
over the fits that ran without the profiler) per lockstep iteration."""

from portbench import readers


def read(ctx):
    fits = readers.unprofiled(ctx)
    its = sum(f.iterations for f in fits)
    ms = sum(f.loop_ms for f in fits)
    if not its or not ms:
        return None
    return ms / its
