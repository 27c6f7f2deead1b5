"""fit_mfu: the least time of the work of the evaluations each fit
needed (its iterations and each stage's first evaluation, not the
masked ones), summed over the fits that ran without the profiler, over
their wall, %."""

from portbench import readers, yardstick


def read(ctx):
    fits = readers.unprofiled(ctx)
    wall = sum(f.wall_s for f in fits)
    if not fits or wall <= 0:
        return None
    needed = sum(f.iterations + f.first_evaluations for f in fits)
    least = needed * yardstick.evaluation(ctx.shape)["total"]
    return 100.0 * least / wall
