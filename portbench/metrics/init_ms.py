"""init_ms: the program's `lcx.init` ranges (the start W0: the seeded
draw and its copy, or the spectral init's Σ·Ω and QR, every restart
lane's; closed by a synchronize) per profiled fit, ms."""

from portbench import program_spans


def read(ctx):
    return program_spans.per_fit_ms(ctx, "lcx.init")
