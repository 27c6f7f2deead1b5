"""lu_roofline: the fixed point's m×m inverses (one per evaluation and
lane) at 2·m³ each, their least time over the device time of the kernels
that kernels/lu*.json name in the profiled fits' loops, %. None off the
fixed point."""

from portbench import readers, yardstick


def read(ctx):
    if ctx.shape.optimizer != "fixed_point":
        return None
    least = readers.evaluations(readers.profiled(ctx)) * \
        yardstick.inverse(ctx.shape.m, ctx.shape.k)["seconds"]
    return readers.roofline(ctx, "lu", least)
