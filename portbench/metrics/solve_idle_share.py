"""solve_idle_share: 1 − the union of the device operations inside the
program's `lcx.solve` ranges (the annealed loop of `core.solver.fit_core`)
over the ranges' summed duration, %: the loop's own idle, apart from
preparation's and the final moments'."""

from portbench import program_spans


def read(ctx):
    return program_spans.idle_share(ctx, "lcx.solve")
