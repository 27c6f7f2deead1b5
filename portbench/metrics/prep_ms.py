"""prep_ms: the estimator's work per fit outside the solver loop
(`Corex.fit` with preprocessing, the operand, the start and the final
moments), ms: the fit's wall less the loop's device span, averaged over
the fits that ran without the profiler."""

from portbench import readers


def read(ctx):
    fits = readers.unprofiled(ctx)
    if not fits or not any(f.loop_ms for f in fits):
        return None
    return sum(1e3 * f.wall_s - f.loop_ms for f in fits) / len(fits)
