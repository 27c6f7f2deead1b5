"""chain_roofline: the chain kernel's launches in the profiled fits (the
port's `ns_chain.launches` and `lane_launches` counters) times the least
time of one launch's work, over the device time of the kernels that
kernels/chain*.json name, %."""

from portbench import readers


def read(ctx):
    return readers.roofline(ctx, "chain", readers.chain_least_s(ctx))
