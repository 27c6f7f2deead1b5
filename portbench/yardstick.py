"""The yardstick: the H100's published peaks and the work of one objective
evaluation of Linear CorEx, counted from the cell's shapes.

Frozen with the benchmark. A later change to the program changes how the
work is done, never how much of it the algorithm needs, so every share
here reads the same work whatever implements it.

Rules:
- Operations are the algorithm's, counted once: Σ·Wᵀ is 2·p²·m on the
  Gram path and 4·n·p·m on the samples path (X·v, then Xᵀ·(X·v)); the
  chain is qij = rr·ry (2·p·m²) and the symmetric H (p·m·(m+1)); the m×m
  inverse 2·m³; cov(y) = W·C_xy, the gradient's ρ·H and the fixed point's
  A⁻¹·AAᵀ are 2·p·m² each. No implementation's extra passes (3xTF32's
  three products, split-K, the LU's pivoting) are counted.
- Products that must be float32-accurate are read against the TF32 peak,
  495 TFLOP/s: no float32-accurate product on this card runs faster.
  int8 products are read against 1,979 TOP/s.
- Bytes are each input read once and each output written once, against
  3.35 TB/s.
- A least time is the larger of operations over the peak and bytes over
  the bandwidth.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

# NVIDIA H100 SXM5 data sheet, dense rates at the 700 W limit
PEAK_TF32 = 495e12        # FLOP/s, the float32-accurate ceiling
PEAK_BF16 = 989e12        # FLOP/s
PEAK_INT8 = 1979e12       # OP/s
PEAK_HBM = 3.35e12        # bytes/s
PEAKS = {"float32": PEAK_TF32, "bfloat16": PEAK_BF16, "int8": PEAK_INT8}
# bytes of one operand element by operand dtype
ITEM = {"float32": 4, "bfloat16": 2, "int8": 1}


class Shape(NamedTuple):
    """What a fit's work follows from: n samples, p variables, m factors,
    k lanes (1 for a single fit), the moment strategy ('gram' or
    'samples'), the optimizer ('momentum' or 'fixed_point') and the
    operand dtype of the Σ products ('float32', 'bfloat16' or 'int8')."""

    n: int
    p: int
    m: int
    k: int
    strategy: str
    optimizer: str
    operand: str


def least_time(flops: float, nbytes: float, peak: float) -> float:
    """Seconds: the larger of the operations' and the bytes' bound."""
    return max(flops / peak, nbytes / PEAK_HBM)


def sigma_apply(s: Shape) -> Dict[str, float]:
    """One application of the covariance to k·m columns (C_xy = Σ·Wᵀ, or
    AA·Σ on the momentum path): flops, bytes, least seconds."""
    cols = s.k * s.m
    it = ITEM[s.operand]
    if s.strategy == "gram":
        flops = 2.0 * s.p * s.p * cols
        nbytes = it * s.p * s.p + it * s.p * cols + 4.0 * s.p * cols
    else:
        flops = 4.0 * s.n * s.p * cols
        nbytes = it * s.n * s.p + it * s.p * cols + 4.0 * s.p * cols
    return {"flops": flops, "bytes": nbytes,
            "seconds": least_time(flops, nbytes, PEAKS[s.operand])}


def small_products(s: Shape) -> Dict[str, float]:
    """The evaluation's m-deep float32 products besides Σ: cov(y) = W·C_xy,
    and the gradient's ρ·H (momentum) or the fixed point's A⁻¹·AAᵀ."""
    flops = s.k * 2 * 2.0 * s.p * s.m * s.m
    nbytes = s.k * 4.0 * (2 * 3 * s.p * s.m + 3 * s.m * s.m)
    return {"flops": flops, "bytes": nbytes,
            "seconds": least_time(flops, nbytes, PEAK_TF32)}


def gemms(s: Shape) -> Dict[str, float]:
    """Every dense product of one evaluation outside the chain and the
    inverse: the Σ applications (two on the momentum path, one on the
    fixed point) and the small products."""
    sig = sigma_apply(s)
    small = small_products(s)
    n_apply = 2 if s.optimizer == "momentum" else 1
    return {key: n_apply * sig[key] + small[key]
            for key in ("flops", "bytes", "seconds")}


def chain(p: int, m: int, lanes: int = 1) -> Dict[str, float]:
    """One chain call over `lanes` lanes: qij and the symmetric H against
    the TF32 peak; C_xy, ry, sqz read, AA, H and 3m + 1 sums written."""
    flops = lanes * (2.0 * p * m * m + p * m * (m + 1))
    nbytes = lanes * 4.0 * (2 * p * m + 2 * m * m + 4 * m + 1)
    return {"flops": flops, "bytes": nbytes,
            "seconds": least_time(flops, nbytes, PEAK_TF32)}


def inverse(m: int, lanes: int = 1) -> Dict[str, float]:
    """One m×m inverse per lane (LU and the two triangular solves):
    2·m³ operations, the matrix read and its inverse written."""
    flops = lanes * 2.0 * m ** 3
    nbytes = lanes * 8.0 * m * m
    return {"flops": flops, "bytes": nbytes,
            "seconds": least_time(flops, nbytes, PEAK_TF32)}


def evaluation(s: Shape) -> Dict[str, float]:
    """The least seconds of one objective evaluation: the products, the
    chain and, on the fixed point, the inverse, each at its own bound."""
    parts = {"gemms": gemms(s)["seconds"],
             "chain": chain(s.p, s.m, s.k)["seconds"]}
    if s.optimizer == "fixed_point":
        parts["inverse"] = inverse(s.m, s.k)["seconds"]
    parts["total"] = sum(parts.values())
    return parts
