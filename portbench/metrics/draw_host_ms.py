"""draw_host_ms: the host time of the program's seeded start draws (a
fit's W0 or Ω, or a restart sweep's lanes: one draw a fit), ms a draw,
from `ops.seeded.counts` over the whole run, the warm-up's draws
included: seconds on the drawing thread over draws. The draw runs beside
the fit's preparation; this reads its own cost, which `init_ms` (the
wait for it) leaves out. None for a program without that counter, or
one that drew nothing seeded."""


def read(ctx):
    try:
        from linearcorex_tpu_torch.ops import seeded
    except ImportError:
        return None
    counts = getattr(seeded, "counts", None)
    draws = getattr(counts, "draws", 0)
    if not draws:
        return None
    return 1e3 * counts.seconds / draws
