"""The Linear CorEx moment system as plain PyTorch functions.

Port of `linearcorex_tpu/ops/moments.py`:

- The 'samples' path never forms the p x p covariance: C_xy = Xᵀ(X·Wᵀ)/n
  is two skinny GEMMs. The 'gram' path builds Σ = XᵀX/n once and applies
  it with one Σ·Wᵀ GEMM per iteration.
- Matmuls keep the JAX package's accumulation rule (`_mm`): at least
  float32, and float64 stays float64. Float32 matmuls run at full float32,
  never TF32 (`full_f32_matmul`).
- Operand modes: `matmul_dtype='bfloat16'` runs the big GEMMs on bf16
  operands with a float32 product (`_mm_bf16`); `matmul_dtype='int8'`
  carries the operand as `QuantizedData` and runs int8 x int8 → int32
  products (`_int8_mm`, through `torch._int_mm`). Either way the moment
  chain receives a float32 C_xy.
- The elementwise moment chain of the gradient and fixed-point paths can
  run through the hand-written CUDA kernel `ops.cuda_moments.ns_chain`
  (`chain_kernel=True`); on a CPU tensor that call takes the kernel's plain
  PyTorch twin.
- The overlap objective (`overlap_obj_grad_*`) factors C_y with
  `torch.linalg.cholesky_ex`; a factorization that fails yields NaN, as
  `jnp.linalg.cholesky` does, so the solver rejects the step.

Annealing enters analytically: C_xy ← (1−eps²)·⟨x·y⟩ + eps²·Wᵀ. `eps` may
be a Python float or a 0-dim tensor of the compute dtype.

Restart lanes: every objective and moment function also takes `ws` of
shape (k, m, p), k independent fits side by side (`parallel.restarts`),
and returns its outputs with a leading lane axis. The data operand (X, Σ,
its bf16 cast or its `QuantizedData`) is shared by the lanes and applied
to all of them in one product, on their operands laid side by side
(`_lanes`, `_lane_rows`): Σ is read once per evaluation, not k times.
Per-column int8 quantization gives a lane's columns the scales of a
single fit, so its int8 products are bitwise those of the single fit. A
2-D `ws` runs exactly the single-fit operations.

A sample-sharded fit (`parallel.sharding`) hands the same functions a
`ShardedSamples` operand: this rank's row block of X with the total row
count and the mesh axes its rows are split over. Every Σ-application then
computes its partial product from the local rows and sums it over those
axes (`parallel.collectives.all_reduce`), dividing by the TOTAL row
count. Everything after that sum is replicated arithmetic on every rank,
so the chain kernel runs unchanged on each rank's full C_xy.
"""

from __future__ import annotations

import contextlib
import functools
import warnings
from typing import NamedTuple

import numpy as np
import torch

from linearcorex_tpu_torch.ops.cuda_moments import ns_chain
from linearcorex_tpu_torch.parallel.collectives import (all_reduce,
                                                        shard_index)

_F32 = torch.float32


@contextlib.contextmanager
def full_f32_matmul():
    """Run float32 matmuls at full float32 (no TF32) inside the scope and
    restore the caller's setting afterwards."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def _mm(a, b):
    """Matmul in the promoted operand dtype. Float32 and float64 operands
    accumulate in their own precision, which is the JAX package's rule
    (>= float32 accumulation, float64 kept as float64)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.matmul(a.to(dt), b.to(dt))


@functools.cache
def _cuda_mm_has_out_dtype() -> bool:
    """Whether this torch build has `torch.mm(..., out_dtype=)` for CUDA
    tensors (a bf16 x bf16 product returned in float32)."""
    return torch._C._dispatch_has_kernel_for_dispatch_key("aten::mm.dtype",
                                                         "CUDA")


def _mm_bf16(a, b, out_dtype):
    """Throughput-mode matmul: bf16 operands, float32 product, result in
    `out_dtype`. torch's bf16 matmul rounds its output to bf16, so it is
    not used: on CUDA `torch.mm(..., out_dtype=float32)` keeps the
    float32 product (the tensor cores' accumulation is ~1e-5 of the
    largest magnitude from exact at K = 10,000 on an H100); on the CPU
    (or a torch without it) the bf16-rounded operands are multiplied in
    float32."""
    a16, b16 = a.to(torch.bfloat16), b.to(torch.bfloat16)
    if a16.device.type == "cuda" and _cuda_mm_has_out_dtype():
        out = torch.mm(a16, b16, out_dtype=_F32)
    else:
        out = torch.matmul(a16.to(_F32), b16.to(_F32))
    return out.to(out_dtype)


# ---------------------------------------------------------------------------
# int8 quantized operand (matmul_dtype='int8')
# ---------------------------------------------------------------------------

class QuantizedData(NamedTuple):
    """int8-quantized data operand: X (or Σ) ≈ scale · q, one scale for
    the whole tensor. A per-tensor scale suits both operand kinds: the
    solver standardizes X column by column, and the Gram matrix of
    standardized data is a correlation matrix (entries in [−1, 1]).

    Products accumulate in int32, so a contraction over p has a worst case
    of 127²·p (it wraps beyond p ≈ 133k). `quantize_samples` guards this
    when it quantizes (`_check_int8_wrap`): it raises on a demonstrated
    wrap and warns on a merely possible one; use 'bfloat16' for data that
    is not roughly standardized."""

    q: torch.Tensor       # (n, p) samples or (p, p) Gram, int8
    scale: torch.Tensor   # () float32


class ShardedSamples(NamedTuple):
    """Sample-sharded X: this rank's row block (a tensor, its bf16 cast or
    its `QuantizedData`), the row count of the whole X and the mesh axes
    (`parallel.collectives.Axis`) the rows are split over, outermost
    first. Sums over samples reduce over `axes`, innermost first."""

    local: object         # torch.Tensor | QuantizedData, (n_total/d, p)
    n_total: int
    axes: tuple

    @property
    def reduce_axes(self):
        """The axes in reduce order: innermost (`data`) first."""
        return tuple(reversed(self.axes))


def _unsharded(data):
    """(local operand, total rows, reduce axes) of any samples operand; a
    plain operand holds every row and reduces over nothing."""
    if isinstance(data, ShardedSamples):
        return data.local, data.n_total, data.reduce_axes
    rows = data.q if isinstance(data, QuantizedData) else data
    return data, rows.shape[0], ()


def is_quantized(data) -> bool:
    """Whether a fit operand carries the int8 mode (sharded or not)."""
    return isinstance(_unsharded(data)[0], QuantizedData)


def n_rows(data) -> int:
    """Sample count of a samples operand (the whole X's, when sharded)."""
    return _unsharded(data)[1]


_INT32_MAX = float(2 ** 31 - 1)


def _round8(k: int) -> int:
    return -(-k // 8) * 8


def _padded(t, rows: int, cols: int):
    """`t` in the top-left corner of a contiguous zero (rows, cols)
    tensor."""
    out = t.new_zeros((rows, cols))
    out[:t.shape[0], :t.shape[1]] = t
    return out


def _int8_mm(a, b):
    """The exact int32 product a (M, K) · b (K, N) of int8 matrices,
    through `torch._int_mm`.

    cuBLAS's int8 GEMM takes M > 16, K and N multiples of 8, a row-major
    first operand and a column-major second one. Zero rows and columns
    leave an integer product exact, so the operands are zero-padded up to
    those shapes and the result sliced back; this runs on every device.
    The second operand is copied into column-major layout (it is the thin
    one on every path). A first operand that is not row-major, such as
    the samples path's qᵀ, is copied too: a transient (p, n) int8 buffer,
    n·p bytes, per call."""
    m_, k_ = a.shape
    n_ = b.shape[1]
    mp, kp = max(m_, 17), _round8(k_)
    if (mp, kp) != (m_, k_) or not a.is_contiguous():
        a = _padded(a, mp, kp)
    bt = _padded(b.T, _round8(n_), kp)      # (N, K) row-major = b col-major
    return torch._int_mm(a, bt.T)[:m_, :n_]


def _int8_abs_sum_bound(q, axes=()) -> float:
    """Guaranteed-safe int32 accumulation certificate: every contraction
    the int8 paths run (q·vq over axis 1, qᵀ·tq over axis 0, both against
    |operand| ≤ 127) is bounded in magnitude by 127 · max(row |q| sums,
    col |q| sums). If that is ≤ int32 max, no application vector can wrap.
    The sums are exact (int64). Rows split over `axes`: a column's sum
    adds the ranks' sums, the largest row sum is the largest of any
    rank's."""
    a = torch.abs(q).to(torch.int64)
    cols = all_reduce(torch.sum(a, dim=0), axes)
    rows = all_reduce(torch.amax(torch.sum(a, dim=1)), axes, op="max")
    return 127.0 * float(torch.maximum(torch.amax(cols), rows))


def _wrap32(r64):
    """An int64 sum as a 32-bit accumulator would hold it."""
    return ((r64 + 2 ** 31) % 2 ** 32 - 2 ** 31).to(torch.int32)


def _int8_wrap_probe(q, u, axes=(), row_start: int = 0) -> float:
    """Max relative disagreement between int32 and float32 accumulation of
    the same int8 operands over both contraction axes. A wrap shows as an
    O(1) relative error; float32 rounding is ~1e-6.

    Probe vectors: random columns and data-aligned ones (one power-
    iteration step, v = qᵀ·u), which model the solver's late-fit operands
    (the columns of Wᵀ/AAᵀ align with the data's principal structure).

    With the rows split over `axes` (`q` the local block, `row_start` its
    first row in the whole operand) the products are the whole operand's:
    the row-wise one is local, the one contracted over samples sums the
    ranks' partials, the int32 one as the 32-bit accumulator of a single
    device would hold it."""
    def err(r32, rf):
        num = all_reduce(torch.amax(torch.abs(r32.to(_F32) - rf)), axes,
                         op="max")
        den = all_reduce(torch.amax(torch.abs(rf)), axes, op="max")
        return num / torch.clamp(den, min=1.0)

    with full_f32_matmul():
        qf = q.to(_F32)
        rows = slice(row_start, row_start + q.shape[0])
        v = torch.cat([u[:q.shape[1]], all_reduce(qf.T @ u[rows], axes)],
                      dim=1)
        vq, _ = _quant_cols(v)
        t = qf @ vq.to(_F32)
        tq, _ = _quant_cols(t, axes)
        e_rows = err(_int8_mm(q, vq), torch.matmul(qf, vq.to(_F32)))
        r32 = _int8_mm(q.T, tq)
        if axes:
            r32 = _wrap32(all_reduce(r32.to(torch.int64), axes))
        rf = all_reduce(torch.matmul(qf.T, tq.to(_F32)), axes)
        e_cols = torch.amax(torch.abs(r32.to(_F32) - rf)) / torch.clamp(
            torch.amax(torch.abs(rf)), min=1.0)
        return float(torch.maximum(e_rows, e_cols))


def _check_int8_wrap(qd) -> None:
    """Guard against a silent int32 accumulator wrap (see
    `QuantizedData`). The certificate first; only when it fails, a probe
    of the actual int8 products with seeded random and data-aligned
    vectors: raise on a demonstrated wrap, warn on a merely possible
    one. A `ShardedSamples` operand is guarded as the whole X it is a
    block of: every rank reaches the same verdict."""
    qd, n_total, axes = _unsharded(qd)
    q = qd.q
    if q.ndim != 2:
        return
    bound = _int8_abs_sum_bound(q, axes)
    if bound <= _INT32_MAX:
        return
    u = torch.as_tensor(np.random.RandomState(0).normal(
        size=(max(n_total, q.shape[1]), 4)), dtype=_F32, device=q.device)
    row_start = shard_index(axes[::-1]) * q.shape[0]
    err = _int8_wrap_probe(q, u, axes, row_start)
    if err > 0.1:
        raise ValueError(
            f"int8 accumulation overflow: the quantized operand wraps the "
            f"int32 accumulator on a data-aligned application vector "
            f"(relative error {err:.2f} vs float accumulation) — int8 "
            f"results on this data would be silently wrong. Use "
            f"matmul_dtype='bfloat16' (or 'float32'). (Advanced: callers "
            f"of the low-level functions can pre-quantize with "
            f"quantize_samples(x, check_overflow=False), but the wrap is "
            f"demonstrated, not hypothetical.)")
    warnings.warn(
        f"int8 accumulation COULD overflow: the guaranteed-safe bound "
        f"127*max(|q| row/col sums) = {bound:.3g} exceeds int32 max "
        f"({_INT32_MAX:.3g}). A random-vector probe found no wrap "
        f"(relative error {err:.2g}), which is expected for standardized "
        f"zero-mean data, but adversarially aligned application vectors "
        f"could still wrap silently — prefer matmul_dtype='bfloat16' if "
        f"the data is not approximately standardized-Gaussian-like")


def _div127(a):
    """a / 127, correctly rounded on every device. (CUDA turns a division
    by a Python scalar into a product with its reciprocal, one bit off;
    a bit of the scale decides where values round to int8, so the card
    would quantize differently from the CPU and the JAX package.)"""
    return a / torch.full((), 127.0, dtype=a.dtype, device=a.device)


def _quantize(x, axes=()):
    """Abs-max scale, then round/clip/cast: (q int8, scale () float32).
    Rows split over `axes`: the scale is the whole tensor's."""
    amax = all_reduce(torch.amax(torch.abs(x)).to(_F32), axes, op="max")
    s = torch.clamp(_div127(amax), min=1e-30)
    q = torch.clamp(torch.round(x.to(_F32) / s), -127, 127).to(torch.int8)
    return q, s


def quantize_samples(x, check_overflow: bool = True):
    """Quantize a standardized samples matrix (or a correlation-scaled
    Gram matrix, see `quantize_gram`) to int8 with one global scale.
    check_overflow=True (default) runs the int32 wrap guard
    (`_check_int8_wrap`). A `ShardedSamples` operand comes back sharded
    alike, quantized with the scale of the whole X."""
    if isinstance(x, ShardedSamples):
        q, s = _quantize(x.local, x.reduce_axes)
        qd = x._replace(local=QuantizedData(q=q, scale=s))
    else:
        q, s = _quantize(x)
        qd = QuantizedData(q=q, scale=s)
    if check_overflow:
        _check_int8_wrap(qd)
    return qd


def quantize_gram(g, check_overflow: bool = True) -> QuantizedData:
    """Quantize a Gram/correlation matrix to int8 (per-tensor scale:
    correlation entries live in [−1, 1], so the range is homogeneous)."""
    return quantize_samples(g, check_overflow=check_overflow)


def _quant_cols(v, axes=()):
    """Per-column int8 quantization of an application operand (the
    columns of Wᵀ/AAᵀ span very different magnitudes, unlike X's). Rows
    split over `axes`: a column's scale is from its maximum over all
    rows."""
    amax = all_reduce(torch.amax(torch.abs(v), dim=0), axes, op="max")
    s = torch.clamp(_div127(amax), min=1e-30)
    q = torch.clamp(torch.round(v / s), -127, 127).to(torch.int8)
    return q, s


def _apply_sigma_int8(qd, v):
    """v (p, k) float32 ↦ Σ_emp·v through two int8 products (int32
    accumulation), samples operand. Scales factor out of the
    contractions: X ≈ sx·q and v ≈ q_v·diag(s_v) give
    X·v ≈ sx·(q·q_v)·diag(s_v); the intermediate is re-quantized per
    column for the second product.

    Sample-sharded, the result is bitwise the single-device one: the
    first product's rows are local, the column maxima of the intermediate
    are taken over all ranks, and the second product's int32 partials add
    exactly."""
    qd, n, axes = _unsharded(qd)
    vq, sv = _quant_cols(v)
    t = _int8_mm(qd.q, vq).to(_F32) * (qd.scale * sv)[None, :]
    tq, st = _quant_cols(t, axes)
    r = all_reduce(_int8_mm(qd.q.T, tq), axes)
    return r.to(_F32) * (qd.scale * st)[None, :] / n


def _apply_gram_int8(qd: QuantizedData, v):
    """v (p, k) float32 ↦ Σ·v through one int8 product (Gram operand)."""
    vq, sv = _quant_cols(v)
    return _int8_mm(qd.q, vq).to(_F32) * (qd.scale * sv)[None, :]


def _apply_int8(qd, v, gram: bool):
    return _apply_gram_int8(qd, v) if gram else _apply_sigma_int8(qd, v)


def _dequantized(x):
    """Float32 view of a quantized operand (the one-time exact paths:
    final moments). Plain tensors pass through."""
    if isinstance(x, QuantizedData):
        return x.q.to(_F32) * x.scale
    return x


class Moments(NamedTuple):
    """Moment tuple; field names and layout match
    `linearcorex_tpu.ops.moments.Moments`."""

    c_xy: torch.Tensor     # p x m
    cy: torch.Tensor       # m x m
    z2: torch.Tensor       # m
    ry: torch.Tensor       # m x m
    rho: torch.Tensor      # m x p
    invrho: torch.Tensor   # m x p
    rhoinvrho: torch.Tensor  # m x p
    qij: torch.Tensor      # m x p
    si: torch.Tensor       # p
    qi: torch.Tensor       # p
    vi: torch.Tensor       # p   <x_i^2 | Y>
    mi: torch.Tensor       # m x p
    i_y_x: torch.Tensor    # m
    tcs: torch.Tensor      # m
    tc: torch.Tensor       # scalar
    objective: torch.Tensor  # scalar

    def asdict(self):
        """Reference-keyed dict (`transform(details=True)`), including the
        reconstruction weights "X_i Z_j" and the "additivity" diagnostic
        Σ_i (Σ_j I(x_i;y_j) − I(x_i;Y))."""
        xz = reconstruction_weights(self)
        i_xi_y = -0.5 * torch.log(torch.clamp(self.vi, min=1e-30))
        additivity = torch.sum(torch.sum(self.mi, dim=0) - i_xi_y)
        return {
            "X_i Y_j": self.c_xy, "cy": self.cy, "Y_j^2": self.z2,
            "ry": self.ry, "rho": self.rho, "invrho": self.invrho,
            "rhoinvrho": self.rhoinvrho, "Qij": self.qij, "Si": self.si,
            "Qi": self.qi, "X_i^2 | Y": self.vi, "MI": self.mi,
            "I_y_x": self.i_y_x, "TCs": self.tcs, "TC": self.tc,
            "objective": self.objective, "X_i Z_j": xz,
            "additivity": additivity,
        }


def _anneal(c0, wt, eps):
    return (1.0 - eps ** 2) * c0 + (eps ** 2) * wt


def _lanes(fn, v):
    """Apply a column-wise linear map fn: (p, c) ↦ (q, c) to every lane of
    v (k, p, m) in one call, on the lanes' columns side by side (p, k·m),
    so the data operand inside `fn` is read once for all lanes. A 2-D v is
    one fit and goes to `fn` as it is."""
    if v.ndim == 2:
        return fn(v)
    k, p, m = v.shape
    out = fn(v.transpose(0, 1).reshape(p, k * m))
    return out.reshape(out.shape[0], k, m).transpose(0, 1)


def _lane_rows(fn, a):
    """Row-layout twin of `_lanes`: fn: (r, p) ↦ (r, q) on the lanes' rows
    stacked, (k·m, p)."""
    if a.ndim == 2:
        return fn(a)
    k, m, p = a.shape
    return fn(a.reshape(k * m, p)).reshape(k, m, -1)


def cxy_samples(x, ws, eps):
    """C_xy = Xᵀ(X·Wᵀ)/n, annealed; the p x p covariance is never
    formed. A QuantizedData operand is dequantized here (the one-time
    exact path: final moments)."""
    x, n, axes = _unsharded(x)
    x = _dequantized(x)
    c_xy = _lanes(lambda v: all_reduce(_mm(x.T, _mm(x, v)), axes) / n,
                  ws.mT)                                         # p x m
    return _anneal(c_xy, ws.mT, eps)


def cxy_gram(gram, ws, eps):
    """C_xy = Σ·Wᵀ, annealed: one O(p²·m) GEMM against the precomputed
    Gram matrix. A QuantizedData operand is dequantized here."""
    gram = _dequantized(gram)
    return _anneal(_lanes(lambda v: _mm(gram, v), ws.mT), ws.mT, eps)


def compute_gram(x):
    """Σ = XᵀX/n, once per fit, at full float32 (never TF32). From a
    `ShardedSamples` X: the ranks' products summed, Σ replicated."""
    x, n, axes = _unsharded(x)
    with full_f32_matmul():
        return all_reduce(_mm(x.T, x), axes) / n


def _cy_ry(ws, c_xy, y_scale):
    """cov(y) = W·C_xy + y_scale²·I, its diagonal z2, sqrt(z2) and the
    correlation ry."""
    m = ws.shape[-2]
    cy = _mm(ws, c_xy) + (y_scale ** 2) * torch.eye(
        m, dtype=ws.dtype, device=ws.device)
    z2 = torch.diagonal(cy, dim1=-2, dim2=-1)
    sqz = torch.sqrt(z2)
    ry = cy / (sqz[..., :, None] * sqz[..., None, :])
    return cy, z2, sqz, ry


def moments_from_cxy(ws, c_xy, y_scale: float, rho_clip: float) -> Moments:
    """All second-moment quantities plus TC/MI given C_xy."""
    dt = ws.dtype
    cy, z2, sqz, ry = _cy_ry(ws, c_xy, y_scale)
    rho = (c_xy / sqz[..., None, :]).mT
    rho = torch.clamp(rho, -rho_clip, rho_clip)
    invrho = 1.0 / (1.0 - rho ** 2)
    rhoinvrho = rho * invrho
    qij = _mm(ry, rhoinvrho)
    si = torch.sum(rho * rhoinvrho, dim=-2)
    qi = torch.sum(rhoinvrho * qij, dim=-2)
    # <x_i^2|Y>: mean squared residual of the product-of-experts
    # reconstruction, (1 + Q_i − S_i²)/(1 + S_i)².
    vi = (1.0 + qi - si ** 2) / (1.0 + si) ** 2
    mi = -0.5 * torch.log1p(-rho ** 2)
    i_y_x = 0.5 * torch.log(z2) - torch.log(
        torch.tensor(y_scale, dtype=dt, device=ws.device))
    tcs = torch.sum(mi, dim=-1) - i_y_x
    tc = torch.sum(tcs, dim=-1)
    objective = 0.5 * torch.sum(torch.log(torch.clamp(vi, min=1e-30)),
                                dim=-1) \
        + 0.5 * torch.sum(torch.log(z2), dim=-1)
    return Moments(c_xy=c_xy, cy=cy, z2=z2, ry=ry, rho=rho, invrho=invrho,
                   rhoinvrho=rhoinvrho, qij=qij, si=si, qi=qi, vi=vi, mi=mi,
                   i_y_x=i_y_x, tcs=tcs, tc=tc, objective=objective)


def permute_moments(mom: Moments, order) -> Moments:
    """Reindex the factor axis of every moment after the post-fit sort by
    decreasing TCs (per-variable quantities are factor sums, unchanged).
    `order` is (m,), or (k, m) for lanes."""
    def rows(a):
        return torch.take_along_dim(a, order[..., :, None], dim=-2)

    def cols(a):
        return torch.take_along_dim(a, order[..., None, :], dim=-1)

    def vec(a):
        return torch.take_along_dim(a, order, dim=-1)

    return Moments(
        c_xy=cols(mom.c_xy), cy=cols(rows(mom.cy)), z2=vec(mom.z2),
        ry=cols(rows(mom.ry)), rho=rows(mom.rho), invrho=rows(mom.invrho),
        rhoinvrho=rows(mom.rhoinvrho), qij=rows(mom.qij), si=mom.si,
        qi=mom.qi, vi=mom.vi, mi=rows(mom.mi), i_y_x=vec(mom.i_y_x),
        tcs=vec(mom.tcs), tc=mom.tc, objective=mom.objective,
    )


def reconstruction_weights(mom: Moments):
    """R (p x m): E[x_i|y] = Σ_j R_ij y_j with
    R_ij = rhoinvrho_ji/((1+S_i)·sqrt(z2_j))."""
    return (mom.rhoinvrho.mT / (1.0 + mom.si)[..., :, None]
            / torch.sqrt(mom.z2)[..., None, :])


def _ns_gradient_terms(mom: Moments):
    """Shared algebra of the non-overlap gradient. Returns (AA, H, coef,
    sqz) with sqrt(z2)·∂F/∂W = AA·Σ_eff + H·rho − coef[:,None]·rho."""
    rho, invrho, rr = mom.rho, mom.invrho, mom.rhoinvrho
    alpha = 1.0 / (1.0 + mom.qi - mom.si ** 2)
    beta = 1.0 / (1.0 + mom.si)
    h_fac = (1.0 + rho ** 2) * invrho ** 2
    aa = alpha[..., None, :] * h_fac * mom.qij \
        - 2.0 * (alpha * mom.si + beta)[..., None, :] * rho * invrho ** 2
    hmat = _mm(rr * alpha[..., None, :], rr.mT)
    kappa = torch.sum(aa * rho, dim=-1)
    mu = torch.sum(alpha[..., None, :] * rr * mom.qij, dim=-1)
    coef = kappa + mu - 1.0
    return aa, hmat, coef, torch.sqrt(mom.z2)


def _cxy_eff(data, ws, eps, bf16, gram):
    """Annealed effective cross-moment C_xy = Σ_eff·Wᵀ from X (samples),
    Σ (gram), either one in bf16, or int8-quantized: the one definition
    every objective and fixed-point entry point shares."""
    apply = _apply_sigma_t(data, bf16, gram, ws.dtype)
    return _anneal(_lanes(apply, ws.mT), ws.mT, eps)


def _apply_sigma_t(data, bf16, gram, dtype):
    """v (p, k) ↦ Σ_emp·v for the operand mode (un-annealed; callers
    blend eps themselves and lay lanes side by side with `_lanes`)."""
    if is_quantized(data):
        return lambda v: _apply_int8(data, v, gram).to(dtype)
    if gram:
        if bf16:
            return lambda v: _mm_bf16(data, v, dtype)
        return lambda v: _mm(data, v)
    x, n, axes = _unsharded(data)
    if bf16:
        return lambda v: all_reduce(
            _mm_bf16(x.T, _mm_bf16(x, v, dtype), dtype), axes) / n
    return lambda v: all_reduce(_mm(x.T, _mm(x, v)), axes) / n


def _run_chain(ws, c_xy, y_scale, rho_clip):
    """Shared prologue + fused chain call: cov(y) from C_xy, then the
    chain kernel. Returns (dt, z2, sqz, chain outputs...)."""
    _, z2, sqz, ry = _cy_ry(ws, c_xy, y_scale)
    return ws.dtype, z2, sqz, ns_chain(c_xy.contiguous(), ry.contiguous(),
                                       sqz.contiguous(), rho_clip)


def _chain_obj_tc(dt, z2, sum_log_vi, mi_sums, y_scale):
    """Objective F and TC from the chain kernel's reductions."""
    objective = 0.5 * sum_log_vi.to(dt) \
        + 0.5 * torch.sum(torch.log(z2), dim=-1)
    i_y_x = 0.5 * torch.log(z2) - torch.log(
        torch.tensor(y_scale, dtype=dt, device=z2.device))
    tc = torch.sum(mi_sums.to(dt) - i_y_x, dim=-1)
    return objective, tc


def _ns_obj_grad_chain(ws, c_xy, apply_sigma_t, eps, y_scale, rho_clip):
    """Objective/gradient through the fused chain kernel. Works in (p, m)
    layout end to end; `apply_sigma_t(v)` maps a (p, m) matrix to
    Σ_emp·v and the eps blend is applied here."""
    dt, z2, sqz, (aa_t, hmat, kappa, mu, mi_sums, sum_log_vi) = _run_chain(
        ws, c_xy, y_scale, rho_clip)
    aa_t = aa_t.to(dt)
    coef = (kappa + mu - 1.0).to(dt)
    aas_t = _anneal(_lanes(apply_sigma_t, aa_t), aa_t, eps)
    inv_sqz = (1.0 / sqz).to(dt)
    rho_t = torch.clamp(c_xy * inv_sqz[..., None, :], -rho_clip, rho_clip)
    grad_t = (aas_t + _mm(rho_t, hmat.to(dt))
              - rho_t * coef[..., None, :]) * inv_sqz[..., None, :]
    objective, tc = _chain_obj_tc(dt, z2, sum_log_vi, mi_sums, y_scale)
    return objective, grad_t.mT, tc


def ns_obj_grad_samples(ws, x, eps, y_scale, rho_clip, bf16=False,
                        chain_kernel=False):
    """(objective, gradient, TC) of the non-overlap objective, samples
    path: 4 skinny GEMMs (2 for the moments, 2 for AA·Σ_eff). bf16=True
    runs them on bfloat16 operands with float32 products; an int8
    QuantizedData `x` runs them as int8 products."""
    return _ns_obj_grad(ws, x, eps, y_scale, rho_clip, bf16, chain_kernel,
                        gram=False)


def ns_obj_grad_gram(ws, gram, eps, y_scale, rho_clip, bf16=False,
                     chain_kernel=False):
    """Same as `ns_obj_grad_samples` on the precomputed Gram matrix:
    2 O(p²·m) GEMMs per evaluation, independent of n."""
    return _ns_obj_grad(ws, gram, eps, y_scale, rho_clip, bf16,
                        chain_kernel, gram=True)


def _ns_obj_grad(ws, data, eps, y_scale, rho_clip, bf16, chain_kernel,
                 gram):
    c_xy = _cxy_eff(data, ws, eps, bf16, gram)
    if chain_kernel:
        return _ns_obj_grad_chain(
            ws, c_xy, _apply_sigma_t(data, bf16, gram, ws.dtype), eps,
            y_scale, rho_clip)
    mom = moments_from_cxy(ws, c_xy, y_scale, rho_clip)
    aa, hmat, coef, sqz = _ns_gradient_terms(mom)
    aas = _anneal(_lane_rows(_apply_sigma_rows(data, bf16, gram, ws.dtype),
                             aa), aa, eps)
    grad = (aas + _mm(hmat, mom.rho)
            - coef[..., :, None] * mom.rho) / sqz[..., :, None]
    return mom.objective, grad, mom.tc


def _apply_sigma_rows(data, bf16, gram, dtype):
    """a (r, p) ↦ a·Σ_emp for the operand mode: the row-layout form of
    `_apply_sigma_t` (the gradient path's AA·Σ)."""
    if is_quantized(data):
        return lambda a: _apply_int8(data, a.T, gram).T.to(dtype)
    if gram:
        if bf16:
            return lambda a: _mm_bf16(a, data, dtype)
        return lambda a: _mm(a, data)
    x, n, axes = _unsharded(data)
    if bf16:
        return lambda a: all_reduce(
            _mm_bf16(_mm_bf16(a, x.T, dtype), x, dtype), axes) / n
    return lambda a: all_reduce(_mm(_mm(a, x.T), x), axes) / n


# ---------------------------------------------------------------------------
# Damped fixed-point update (optimizer='fixed_point')
# ---------------------------------------------------------------------------

def ns_fp_parts(ws, data, eps, y_scale, rho_clip, bf16=False,
                chain_kernel=False, gram=False):
    """Pieces of the closed-form fixed-point target, before the m x m
    solve. Setting the gradient to zero with rho = diag(1/sqz)·W·Σ_eff
    gives Ŵ = diag(sqz)·(diag(coef) − H)⁻¹·AA. Returns (objective, tc,
    a_mat (m, m), aa_t (p, m), sqz (m,)). a_mat is near-singular once
    surplus factors have died; the damped accept/reject iteration
    tolerates the inexact inverse."""
    c_xy = _cxy_eff(data, ws, eps, bf16, gram)
    return fp_parts_from_cxy(ws, c_xy, y_scale, rho_clip, chain_kernel)


def fp_parts_from_cxy(ws, c_xy, y_scale, rho_clip, chain_kernel=False):
    """`ns_fp_parts` given an already-annealed C_xy."""
    if chain_kernel:
        dt, z2, sqz, (aa_t, hmat, kappa, mu, mi_sums, slv) = _run_chain(
            ws, c_xy, y_scale, rho_clip)
        coef = (kappa + mu - 1.0).to(dt)
        a_mat = torch.diag_embed(coef) - hmat.to(dt)
        objective, tc = _chain_obj_tc(dt, z2, slv, mi_sums, y_scale)
        return objective, tc, a_mat, aa_t.to(dt), sqz
    mom = moments_from_cxy(ws, c_xy, y_scale, rho_clip)
    aa, hmat, coef, sqz = _ns_gradient_terms(mom)
    a_mat = torch.diag_embed(coef) - hmat
    return mom.objective, mom.tc, a_mat, aa.mT, sqz


def fp_target_from_parts(ws, a_mat_inv, aa_t, sqz):
    """The solver direction ws − Ŵ from `ns_fp_parts` pieces and the
    inverse of a_mat (applied as inverse + GEMM, as the JAX package
    does)."""
    target = _mm(a_mat_inv, aa_t.mT) * sqz[..., :, None]
    return ws - target


def ns_fp_samples(ws, x, eps, y_scale, rho_clip, bf16=False,
                  chain_kernel=False):
    """(objective, ws − Ŵ, TC) for the damped fixed-point update, samples
    path. The solver's plain-GD step turns the direction into
    (1−γ)·ws + γ·Ŵ."""
    return _ns_fp(ws, x, eps, y_scale, rho_clip, bf16, chain_kernel,
                  gram=False)


def ns_fp_gram(ws, gram, eps, y_scale, rho_clip, bf16=False,
               chain_kernel=False):
    """Gram-path fixed-point update: one O(p²·m) GEMM per iteration."""
    return _ns_fp(ws, gram, eps, y_scale, rho_clip, bf16, chain_kernel,
                  gram=True)


def _ns_fp(ws, data, eps, y_scale, rho_clip, bf16, chain_kernel, gram):
    obj, tc, a_mat, aa_t, sqz = ns_fp_parts(
        ws, data, eps, y_scale, rho_clip, bf16, chain_kernel, gram)
    # inv_ex, as jnp.linalg.inv: a singular a_mat gives inf/NaN (a rejected
    # step of that lane) instead of an exception, and no host sync
    a_inv = torch.linalg.inv_ex(a_mat).inverse
    return obj, fp_target_from_parts(ws, a_inv, aa_t, sqz), tc


# ---------------------------------------------------------------------------
# Overlapping (discourage_overlap=False) objective: the exact Gaussian
# bound, with m x m solves and never a p x p one
# ---------------------------------------------------------------------------

def _cholesky_or_nan(cy):
    """Lower Cholesky factor of C_y, or all-NaN where C_y is not positive
    definite — what `jnp.linalg.cholesky` returns. The objective is then
    NaN, `f_new <= f` is False and the solver rejects the step, as in the
    JAX package. `cholesky_ex` reports the failure in `info` on the
    device, so this costs no host sync."""
    chol, info = torch.linalg.cholesky_ex(cy)
    return torch.where(info[..., None, None] == 0, chol, torch.nan)


def _overlap_core(ws, b, cy_chol, y_scale):
    """F and the shared terms given B = Σ_eff·Wᵀ and chol(C_y)."""
    m = ws.shape[-2]
    bm = torch.cholesky_solve(b.mT, cy_chol, upper=False).mT     # p x m
    v = torch.clamp(1.0 - torch.sum(bm * b, dim=-1), min=1e-12)
    logdet = 2.0 * torch.sum(
        torch.log(torch.diagonal(cy_chol, dim1=-2, dim2=-1)), dim=-1)
    f = 0.5 * torch.sum(torch.log(v), dim=-1) + 0.5 * logdet \
        - m * torch.log(torch.tensor(y_scale, dtype=ws.dtype,
                                     device=ws.device))
    return f, bm, v


def _overlap_from_b(ws, b, eps, y_scale, apply_sigma):
    """The overlap objective and gradient from the annealed B;
    `apply_sigma(g)` maps an (m, p) matrix to g·Σ_emp (lanes: their rows
    stacked, `_lane_rows`)."""
    mdim = ws.shape[-2]
    cy = _mm(ws, b) + (y_scale ** 2) * torch.eye(mdim, dtype=ws.dtype,
                                                 device=ws.device)
    chol = _cholesky_or_nan(cy)
    f, bm, v = _overlap_core(ws, b, chol, y_scale)
    g_lhs = (bm / v[..., :, None]).mT                            # m x p
    gs = _anneal(_lane_rows(apply_sigma, g_lhs), g_lhs, eps)
    k = _mm(g_lhs, b)
    mbt = torch.cholesky_solve(b.mT, chol, upper=False)          # m x p
    grad = -gs + _mm(k, mbt) + mbt
    return f, grad, -f


def overlap_obj_grad_samples(ws, x, eps, y_scale):
    """(objective, gradient, TC proxy) of the exact Gaussian objective.

    ∇F = −(M Bᵀ V)·Σ_eff + (M Bᵀ V B M)·Bᵀ + M·Bᵀ with M = C_y⁻¹,
    V = diag(1/v) (derivation in the JAX package's oracle)."""
    b = _anneal(_lanes(_apply_sigma_t(x, False, False, ws.dtype), ws.mT),
                ws.mT, eps)
    return _overlap_from_b(ws, b, eps, y_scale,
                           _apply_sigma_rows(x, False, False, ws.dtype))


def overlap_obj_grad_gram(ws, gram, eps, y_scale):
    """Gram-path variant of `overlap_obj_grad_samples`. Σ·Wᵀ keeps the
    working dtype. (The JAX package's product rounds it to float32 in
    every dtype, so in float64 the two differ at ~1e-7; the port agrees
    with the float64 oracle instead.)"""
    b = _anneal(_lanes(lambda v: _mm(gram, v), ws.mT), ws.mT, eps)
    return _overlap_from_b(ws, b, eps, y_scale, lambda g: _mm(g, gram))
