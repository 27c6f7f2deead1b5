"""masked_share: the evaluations the captured loop ran past a stage's
end (`core.solver.counts.masked`) over all its bodies, %, in the
window."""


def read(ctx):
    fits = ctx.window.fits
    bodies = sum(f.bodies for f in fits)
    if not bodies:
        return None
    return 100.0 * sum(f.masked for f in fits) / bodies
