"""prepare_ms: the program's `lcx.prepare` ranges (`Corex._prepare_fit`:
the input checks, the move to the device, preprocessing and the operand,
closed by a synchronize) per profiled fit, ms."""

from portbench import program_spans


def read(ctx):
    return program_spans.per_fit_ms(ctx, "lcx.prepare")
