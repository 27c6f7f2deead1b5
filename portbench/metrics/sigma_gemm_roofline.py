"""sigma_gemm_roofline: the loop's dense products (the Σ applications,
cov(y) = W·C_xy and the gradient's ρ·H or the fixed point's A⁻¹·AAᵀ) as
the yardstick counts them for the evaluations the loops ran, their least
time over the device time of the kernels that kernels/sigma_gemm*.json
name, in the profiled fits' loops, %."""

from portbench import readers


def read(ctx):
    return readers.roofline(ctx, "sigma_gemm", readers.sigma_gemm_least_s(ctx))
