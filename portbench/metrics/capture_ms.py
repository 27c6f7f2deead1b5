"""capture_ms: the program's `lcx.capture` ranges (the solver loop's
capture of its chunk into a CUDA graph) per profiled fit, ms. None where
no fit captured."""

from portbench import program_spans


def read(ctx):
    return program_spans.per_fit_ms(ctx, "lcx.capture")
