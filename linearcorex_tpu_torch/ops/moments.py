"""The Linear CorEx moment system as plain PyTorch functions.

Port of `linearcorex_tpu/ops/moments.py`:

- The 'samples' path never forms the p x p covariance: C_xy = Xᵀ(X·Wᵀ)/n
  is two skinny GEMMs. The 'gram' path builds Σ = XᵀX/n once and applies
  it with one Σ·Wᵀ GEMM per iteration.
- Matmuls keep the JAX package's accumulation rule (`_mm`): at least
  float32, and float64 stays float64. Float32 matmuls run at float32
  accuracy under torch's "highest" precision (`full_f32_matmul`, and a
  fit's scope under matmul_precision 'default'): cuBLAS's float32 GEMM,
  except the whole-Σ product on a card (`_sigma_mm`), which runs 3xTF32
  on the tensor cores with each 32-deep stage summed apart
  (`cuda_moments.sigma_gemm`), held to cuBLAS float32's accuracy. Under
  'high' every float32 product, that one included, is one TF32 pass on
  cuBLAS.
- The half-precision compute dtypes (`dtype='bfloat16'` or 'float16')
  run every function here in that dtype, as the JAX package's XLA chain
  does: a product accumulates in float32 and is rounded once, and the
  sample count a sum is divided by is rounded to the dtype first
  (`_per_sample`), as JAX's weak typing rounds it. torch has no
  half-precision LU, Cholesky or QR, and neither has the JAX package's
  LAPACK: the fixed point, the overlap objective, `score` and the
  spectral init raise NotImplementedError there (`check_factorizable`),
  as the JAX package does; nothing is upcast to make them run.
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

No objective evaluation reads a value from the device or copies one from
the host, so the solver can capture evaluations into a CUDA graph: the
scalars they need on the device (log y_scale, a half dtype's sample
count) are cached device constants (`device_scalar`), made before the
first evaluation (`prepare_constants`).

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

Variable and factor sharding
----------------------------
The same operand type carries a column split: under a `var` axis the
rank holds X[rows, I] (I its block of the p variables) and W[:, I], and a
Gram operand holds Σ's row block Σ[I, :] (`gram=True`). W's rows may be
split over a `model` axis (J, its block of the m factors): that axis
belongs to W, not to the data, so the functions take it as their own
argument (`model=`). `Split` carries both for the moment algebra; with
neither it is the identity and every function runs the single-device
operations unchanged.

- Σ-application, samples operand: X_loc·v_loc is (n_loc, k), summed over
  `var`; X_locᵀ·(that) gives this rank's (p_loc, k) rows, summed over the
  sample axes. The factor split needs nothing: Σ·W_Jᵀ is local.
- Σ-application, Gram operand: Σ[I, :] needs every column of v, so v
  (p_loc, k) is all-gathered over `var` into (p, k): (p − p_loc)·k values
  received per application, m·p per objective evaluation on the fixed
  point. (Forming Σ[:, I]·v_I and reduce-scattering it would move as much
  and needs Σ's columns, which a row block holds only through Σ's
  symmetry, and symmetric to the last bit only by luck.) The gradient
  path's AA·Σ runs the other way: the partial AA[:, I]·Σ[I, :] (m, p) is
  reduce-scattered over `var`, m·p values again.
- Sums over p (C_y = W·C_xy, H, κ, μ, the TCs, Σ log v) are local sums
  and one SUM `all_reduce` over `var`; sums over m (S_i, Q_i) one SUM of a
  (p_loc,) vector over `model`. The m-wide couplings (C_y, ry, qij =
  ry·rhoinvrho, H, the m x m inverse) need every factor: C_xy's columns
  are all-gathered over `model` once per evaluation (m·p_loc values),
  rho and rhoinvrho of every factor follow from it elementwise, and this
  rank computes the rows J of the products (gathered into the replicated
  m x m blocks). The fixed point's target rows J take AA of every factor:
  one more m·p_loc gather. No payload exceeds max(n·m, m·p) values.
- int8: column scales are maxima over `var`; the first product's int32
  partials are summed over `var` as int32, exactly, so the sharded
  Σ-application is bitwise the single-device one.
- The chain kernel (`chain_kernel=True`) takes the whole (p, m) C_xy: it
  is gathered over both axes and each rank keeps its block of the outputs.
"""

from __future__ import annotations

import contextlib
import functools
import warnings
from typing import NamedTuple, Optional

import numpy as np
import torch

from linearcorex_tpu_torch.ops.cuda_moments import ns_chain, sigma_gemm
from linearcorex_tpu_torch.parallel.collectives import (all_gather_dim,
                                                        all_reduce,
                                                        reduce_scatter_dim,
                                                        ring_pass,
                                                        shard_index)

_F32 = torch.float32
HALF_DTYPES = (torch.bfloat16, torch.float16)


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
    (>= float32 accumulation, float64 kept as float64); half operands
    accumulate in float32 and the product is rounded to their dtype once
    (the JAX package's `preferred_element_type=float32`, then the cast)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    if dt in HALF_DTYPES:
        return torch.matmul(a.to(_F32), b.to(_F32)).to(dt)
    return torch.matmul(a.to(dt), b.to(dt))


def _per_sample(t, n):
    """A sum over `n` samples divided by n. In a half dtype n is rounded
    to that dtype first, as the JAX package's weak typing rounds it (n =
    10,000 is 9984 in bfloat16), where torch would divide by it in
    float32; in float32 and float64 torch already rounds it so."""
    if t.dtype in HALF_DTYPES:
        return t / device_scalar(n, t.dtype, t.device)
    return t / n


@functools.cache
def device_scalar(value, dtype, device) -> torch.Tensor:
    """`torch.tensor(value, dtype=dtype, device=device)`, made once per
    (value, dtype, device) and kept, so an evaluation uses it without a
    copy from the host (a CUDA graph cannot hold one). The solver's
    objectives make theirs before their first evaluation
    (`prepare_constants`); one first asked for inside a graph capture
    raises."""
    _made_outside_capture(value, dtype, device)
    return torch.tensor(value, dtype=dtype, device=device)


@functools.cache
def _log_scalar(value, dtype, device) -> torch.Tensor:
    """log(`value`) in `dtype` on `device`, computed there once: the bits
    of `torch.log` of `device_scalar`, which every evaluation took."""
    _made_outside_capture(value, dtype, device)
    return torch.log(device_scalar(value, dtype, device))


def _made_outside_capture(value, dtype, device) -> None:
    if torch.device(device).type == "cuda" and \
            torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            f"the device constant {value!r} ({dtype}) was not made before "
            f"the CUDA graph capture: prepare_constants() must cover it")


def prepare_constants(data, y_scale: float, dtype, gram: bool) -> None:
    """Make the device constants an objective on `data` in compute dtype
    `dtype` takes (`device_scalar`): log(y_scale), and in a half dtype on
    the samples strategy the sample count. Called once per objective,
    before its first evaluation."""
    local = _unsharded(data)[0]
    device = (local.q if isinstance(local, QuantizedData) else local).device
    _log_scalar(y_scale, dtype, device)
    if dtype in HALF_DTYPES and not gram:
        device_scalar(n_rows(data), dtype, device)


def check_factorizable(dtype, op: str) -> None:
    """Raise NotImplementedError, naming `op` and the dtype, where `op` (an
    LU, Cholesky or QR factorization) would run in a half dtype: torch has
    no half-precision kernel for it, nor has the LAPACK the JAX package
    lowers to, which raises the same type there."""
    if dtype in HALF_DTYPES:
        raise NotImplementedError(
            f"{op} is not implemented for dtype "
            f"{str(dtype).removeprefix('torch.')}: the fixed point, the "
            f"overlap objective, score() and init='spectral' need it. Fit "
            f"with optimizer='momentum' (the default) and "
            f"discourage_overlap=True, or in dtype='float32'")


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
    """A sharded fit operand: this rank's block (a tensor, its bf16 cast or
    its `QuantizedData`), the row count of the whole operand, the mesh
    axes (`parallel.collectives.Axis`) its sample rows are split over,
    outermost first (sums over samples reduce over them, innermost first),
    and under variable sharding the column count of the whole operand and
    the `var` axis its columns are split over. A Gram operand (`gram`)
    carries no sample axis: `local` is Σ's row block over `var` and
    `n_total` is p."""

    local: object         # torch.Tensor | QuantizedData, (n_total/d, p_loc)
    n_total: int
    axes: tuple
    p_total: Optional[int] = None   # None: every column is local
    var: object = None    # Axis of the column (Gram: row) split, or None
    gram: bool = False

    @property
    def reduce_axes(self):
        """The axes in reduce order: innermost (`data`) first."""
        return tuple(reversed(self.axes))

    @property
    def all_axes(self):
        """Every axis the operand is split over: a whole-tensor maximum
        (the int8 scale) reduces over all of them."""
        return self.reduce_axes + ((self.var,) if self.var else ())


def _unsharded(data):
    """(local operand, total rows, reduce axes) of any samples operand; a
    plain operand holds every row and reduces over nothing."""
    if isinstance(data, ShardedSamples):
        return data.local, data.n_total, data.reduce_axes
    rows = data.q if isinstance(data, QuantizedData) else data
    return data, rows.shape[0], ()


def var_of(data):
    """The `var` axis an operand's columns (a Gram operand's rows) are
    split over, or None."""
    return data.var if isinstance(data, ShardedSamples) else None


def n_cols(data) -> int:
    """Variable count of an operand (the whole operand's, when sharded)."""
    if isinstance(data, ShardedSamples) and data.p_total:
        return data.p_total
    local = _unsharded(data)[0]
    return (local.q if isinstance(local, QuantizedData) else local).shape[-1]


class Split(NamedTuple):
    """How W (m, p) lies on this rank: its columns split over `var`, its
    rows over `model` (each a `parallel.collectives.Axis`, or None: not
    split). Sums over p reduce over `var` and sums over m over `model`;
    with neither axis every method is the identity, so the moment
    functions run the single-device operations unchanged."""

    var: object = None
    model: object = None

    @property
    def w_axes(self):
        """The axes W is split over."""
        return tuple(a for a in (self.var, self.model) if a is not None)

    def vsum(self, t):
        """A sum over p: the local partial summed over `var`."""
        return t if self.var is None else all_reduce(t, (self.var,))

    def msum(self, t):
        """A sum over m: the local partial summed over `model`."""
        return t if self.model is None else all_reduce(t, (self.model,))

    @staticmethod
    def _block(t, axis, dim):
        if axis is None:
            return t
        k = t.shape[dim] // axis.size
        return t.narrow(dim, axis.index * k, k)

    def mine(self, t, dim=-1):
        """This rank's factor block J of a dimension holding all m."""
        return self._block(t, self.model, dim)

    def my_vars(self, t, dim=0):
        """This rank's variable block I of a dimension holding all p."""
        return self._block(t, self.var, dim)

    def all_factors(self, t, dim=-1):
        """A dimension split over `model`, gathered whole."""
        return t if self.model is None else all_gather_dim(t, dim,
                                                           self.model)

    def all_vars(self, t, dim=0):
        """A dimension split over `var`, gathered whole."""
        return t if self.var is None else all_gather_dim(t, dim, self.var)

    def whole_w(self, w):
        """W (m, p) from this rank's block."""
        return self.all_vars(self.all_factors(w, -2), -1)


NO_SPLIT = Split()


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


def _int8_abs_sum_bound(q, axes=(), col_axes=()) -> float:
    """Guaranteed-safe int32 accumulation certificate: every contraction
    the int8 paths run (q·vq over axis 1, qᵀ·tq over axis 0, both against
    |operand| ≤ 127) is bounded in magnitude by 127 · max(row |q| sums,
    col |q| sums). If that is ≤ int32 max, no application vector can wrap.
    The sums are exact (int64). Rows split over `axes` (columns over
    `col_axes`): a column's (row's) sum adds the ranks' sums, and the
    largest is the largest of any rank's."""
    a = torch.abs(q).to(torch.int64)
    cols = all_reduce(torch.sum(a, dim=0), axes)
    rows = all_reduce(torch.amax(all_reduce(torch.sum(a, dim=1), col_axes)),
                      axes, op="max")
    cols = all_reduce(torch.amax(cols), col_axes, op="max")
    return 127.0 * float(torch.maximum(cols, rows))


def _wrap32(r64):
    """An int64 sum as a 32-bit accumulator would hold it."""
    return ((r64 + 2 ** 31) % 2 ** 32 - 2 ** 31).to(torch.int32)


def _int8_wrap_probe(q, u, axes=(), row_start: int = 0, col_axes=(),
                     col_start: int = 0) -> float:
    """Max relative disagreement between int32 and float32 accumulation of
    the same int8 operands over both contraction axes. A wrap shows as an
    O(1) relative error; float32 rounding is ~1e-6.

    Probe vectors: random columns and data-aligned ones (one power-
    iteration step, v = qᵀ·u), which model the solver's late-fit operands
    (the columns of Wᵀ/AAᵀ align with the data's principal structure).

    With the rows split over `axes` and the columns over `col_axes` (`q`
    the local block, `row_start` / `col_start` its first row / column in
    the whole operand) the products are the whole operand's: each
    contraction sums the ranks' partials, the int32 one as the 32-bit
    accumulator of a single device would hold it."""
    everywhere = tuple(axes) + tuple(col_axes)

    def err(r32, rf):
        num = all_reduce(torch.amax(torch.abs(r32.to(_F32) - rf)),
                         everywhere, op="max")
        den = all_reduce(torch.amax(torch.abs(rf)), everywhere, op="max")
        return num / torch.clamp(den, min=1.0)

    def exact(r32, over):
        if not over:
            return r32
        return _wrap32(all_reduce(r32.to(torch.int64), over))

    with full_f32_matmul():
        qf = q.to(_F32)
        rows = slice(row_start, row_start + q.shape[0])
        cols = slice(col_start, col_start + q.shape[1])
        v = torch.cat([u[cols], all_reduce(qf.T @ u[rows], axes)], dim=1)
        vq, _ = _quant_cols(v, col_axes)
        t = all_reduce(qf @ vq.to(_F32), col_axes)
        tq, _ = _quant_cols(t, axes)
        e_rows = err(exact(_int8_mm(q, vq), col_axes), t)
        rf = all_reduce(torch.matmul(qf.T, tq.to(_F32)), axes)
        e_cols = err(exact(_int8_mm(q.T, tq), axes), rf)
        return float(torch.maximum(e_rows, e_cols))


def _check_int8_wrap(qd) -> None:
    """Guard against a silent int32 accumulator wrap (see
    `QuantizedData`). The certificate first; only when it fails, a probe
    of the actual int8 products with seeded random and data-aligned
    vectors: raise on a demonstrated wrap, warn on a merely possible
    one. A `ShardedSamples` operand is guarded as the whole operand it is
    a block of: every rank reaches the same verdict."""
    var = var_of(qd)
    gram = isinstance(qd, ShardedSamples) and qd.gram
    p_total = n_cols(qd)
    qd, n_total, axes = _unsharded(qd)
    q = qd.q
    if q.ndim != 2:
        return
    # rows and columns split over: a Gram block's rows are over `var`
    row_axes, col_axes = ((var,), ()) if gram else (
        axes, (var,) if var else ())
    bound = _int8_abs_sum_bound(q, row_axes, col_axes)
    if bound <= _INT32_MAX:
        return
    u = torch.as_tensor(np.random.RandomState(0).normal(
        size=(max(n_total, p_total), 4)), dtype=_F32, device=q.device)
    row_start = shard_index(row_axes[::-1]) * q.shape[0]
    col_start = shard_index(col_axes) * q.shape[1]
    err = _int8_wrap_probe(q, u, row_axes, row_start, col_axes, col_start)
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
    alike, quantized with the scale of the whole operand."""
    if isinstance(x, ShardedSamples):
        q, s = _quantize(x.local, x.all_axes)
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
    exactly. So is the variable-sharded one: v's column maxima are taken
    over `var`, and the first product's int32 partials are summed over
    `var` before they become float32."""
    sp = Split(var=var_of(qd))
    qd, n, axes = _unsharded(qd)
    vq, sv = _quant_cols(v, sp.w_axes)
    t = sp.vsum(_int8_mm(qd.q, vq)).to(_F32) * (qd.scale * sv)[None, :]
    tq, st = _quant_cols(t, axes)
    r = all_reduce(_int8_mm(qd.q.T, tq), axes)
    return r.to(_F32) * (qd.scale * st)[None, :] / n


def _apply_gram_int8(qd, v):
    """v (p, k) float32 ↦ Σ·v through one int8 product (Gram operand). A
    row block Σ[I, :] over `var` takes v's rows I, quantizes them with
    the column maxima over `var` and gathers the int8 columns whole: the
    rows I of the single-device product, bit for bit."""
    sp = Split(var=var_of(qd))
    qd = _unsharded(qd)[0]
    vq, sv = _quant_cols(v, sp.w_axes)
    return _int8_mm(qd.q, sp.all_vars(vq)).to(_F32) \
        * (qd.scale * sv)[None, :]


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


def _sigma_mm(g, v):
    """Σ·v: the hand-written 3xTF32 kernel (`sigma_gemm`) where Σ is whole
    (square: a `var` row block of two or more ranks is not), Σ and v are
    float32 CUDA tensors and torch's float32 matmul precision is "highest"
    (the fit's scope under matmul_precision 'default', 'highest' or
    'float32', and `full_f32_matmul`); `_mm` everywhere else (the CPU,
    float64, half dtypes, a split Σ, 'high' and 'medium')."""
    if (g.is_cuda and g.dtype == _F32 and v.dtype == _F32
            and g.shape[0] == g.shape[1]
            and torch.get_float32_matmul_precision() == "highest"):
        return sigma_gemm(g, v)
    return _mm(g, v)


def _gram_t(g, var):
    """v (p_loc, k) ↦ Σ[I, :]·v for a Gram block over `var` (v's rows
    gathered whole), or Σ·v for a whole Σ, through `_sigma_mm`. The bf16
    operand mode passes its own `mm`."""
    sp = Split(var=var)
    return lambda v, mm=_sigma_mm: mm(g, sp.all_vars(v))


def _gram_rows(g, var):
    """a (r, p_loc) ↦ (a·Σ)[:, I] for a Gram block over `var`: this rank's
    partial a[:, I]·Σ[I, :] (r, p), summed over `var` with each rank
    keeping its columns (one reduce-scatter, r·p values); else a·Σ. The
    product is the single-device GEMM where the block is all of Σ."""
    if var is None:
        return lambda a, mm=_mm: mm(a, g)
    return lambda a, mm=_mm: reduce_scatter_dim(mm(a, g), -1, var)


def cxy_samples(x, ws, eps):
    """C_xy = Xᵀ(X·Wᵀ)/n, annealed; the p x p covariance is never
    formed. A QuantizedData operand is dequantized here (the one-time
    exact path: final moments). Variable-sharded: this rank's rows."""
    vs = Split(var=var_of(x)).vsum
    x, n, axes = _unsharded(x)
    x = _dequantized(x)
    c_xy = _lanes(lambda v: _per_sample(
        all_reduce(_mm(x.T, vs(_mm(x, v))), axes), n), ws.mT)   # p x m
    return _anneal(c_xy, ws.mT, eps)


def cxy_gram(gram, ws, eps):
    """C_xy = Σ·Wᵀ, annealed: one O(p²·m) GEMM against the precomputed
    Gram matrix (a row block: this rank's rows). A QuantizedData operand
    is dequantized here."""
    apply = _gram_t(_dequantized(_unsharded(gram)[0]), var_of(gram))
    return _anneal(_lanes(apply, ws.mT), ws.mT, eps)


def compute_gram(x):
    """Σ = XᵀX/n, once per fit, at full float32 (never TF32). From a
    `ShardedSamples` X: the ranks' products summed over the sample axes.
    Without a `var` axis Σ comes out whole on every rank.

    With X's columns split over `var`, no rank ever holds the whole X or
    the whole Σ: the result is this rank's row block Σ[I, :] = X[:, I]ᵀ·X
    /n as a Gram `ShardedSamples`. The other ranks' column blocks come one
    at a time around a ring over `var` (`ring_pass`), each multiplied into
    its columns of the block. Peak bytes per rank: its X block (n_loc ·
    p_loc), two blocks in flight (2 · n_loc · p_loc), the (p_loc, p) row
    block and one (p_loc, p_loc) product, times the element size.

    In a half dtype XᵀX is accumulated in float32 and rounded to the dtype
    before the division by n, as the JAX package does. Standardized columns
    put n on its diagonal, so a float16 Σ stays finite only for n up to
    65504, float16's largest value (bfloat16 has float32's range)."""
    var = var_of(x)
    xl, n, axes = _unsharded(x)
    with full_f32_matmul():
        if var is None:
            return _per_sample(all_reduce(_mm(xl.T, xl), axes), n)
        width = xl.shape[1]
        rows = xl.new_empty((width, width * var.size))
        blk = xl
        for step in range(var.size):
            j = (var.index - step) % var.size
            rows[:, j * width:(j + 1) * width] = _mm(xl.T, blk)
            if step + 1 < var.size:
                blk = ring_pass(blk, var)
        p = width * var.size
        return ShardedSamples(local=_per_sample(all_reduce(rows, axes), n),
                              n_total=p,
                              axes=(), p_total=p, var=var, gram=True)


def _cy_ry(ws, c_all, y_scale, sp=NO_SPLIT):
    """cov(y) = W·C_xy + y_scale²·I, its diagonal z2, sqrt(z2) and the
    correlation ry, all whole. `c_all` holds every factor's column of this
    rank's rows of C_xy; under a split the rows J of W·C_xy are summed over
    `var` and gathered over `model`."""
    m = c_all.shape[-1]
    cy = sp.all_factors(sp.vsum(_mm(ws, c_all)), -2) + (y_scale ** 2) \
        * torch.eye(m, dtype=ws.dtype, device=ws.device)
    z2 = torch.diagonal(cy, dim1=-2, dim2=-1)
    sqz = torch.sqrt(z2)
    ry = cy / (sqz[..., :, None] * sqz[..., None, :])
    return cy, z2, sqz, ry


def moments_from_cxy(ws, c_xy, y_scale: float, rho_clip: float, var=None,
                     model=None) -> Moments:
    """All second-moment quantities plus TC/MI given C_xy. Under a split
    (W's columns over `var`, its rows over `model`) `ws` and `c_xy` are
    this rank's blocks and so are the per-variable and per-factor fields
    of the result; cy, z2, ry, i_y_x, tcs, tc and the objective are whole
    (`whole_moments` gathers the rest)."""
    return _moment_parts(ws, c_xy, y_scale, rho_clip, Split(var, model))[0]


def _moment_parts(ws, c_xy, y_scale, rho_clip, sp=NO_SPLIT):
    """`moments_from_cxy`, plus rho and rhoinvrho of every factor on this
    rank's variables (the m-wide products take them)."""
    dt = ws.dtype
    c_all = sp.all_factors(c_xy)
    cy, z2, sqz, ry = _cy_ry(ws, c_all, y_scale, sp)
    rho_all = torch.clamp((c_all / sqz[..., None, :]).mT, -rho_clip,
                          rho_clip)
    invrho_all = 1.0 / (1.0 - rho_all ** 2)
    rr_all = rho_all * invrho_all
    rho, invrho, rhoinvrho = (sp.mine(t, -2)
                              for t in (rho_all, invrho_all, rr_all))
    qij = _mm(sp.mine(ry, -2), rr_all)
    si = sp.msum(torch.sum(rho * rhoinvrho, dim=-2))
    qi = sp.msum(torch.sum(rhoinvrho * qij, dim=-2))
    # <x_i^2|Y>: mean squared residual of the product-of-experts
    # reconstruction, (1 + Q_i − S_i²)/(1 + S_i)².
    vi = (1.0 + qi - si ** 2) / (1.0 + si) ** 2
    mi = -0.5 * torch.log1p(-rho ** 2)
    i_y_x = 0.5 * torch.log(z2) - _log_scalar(y_scale, dt, ws.device)
    tcs = sp.all_factors(sp.vsum(torch.sum(mi, dim=-1)) - sp.mine(i_y_x))
    tc = torch.sum(tcs, dim=-1)
    objective = 0.5 * sp.vsum(torch.sum(torch.log(torch.clamp(
        vi, min=1e-30)), dim=-1)) + 0.5 * torch.sum(torch.log(z2), dim=-1)
    mom = Moments(c_xy=c_xy, cy=cy, z2=z2, ry=ry, rho=rho, invrho=invrho,
                  rhoinvrho=rhoinvrho, qij=qij, si=si, qi=qi, vi=vi, mi=mi,
                  i_y_x=i_y_x, tcs=tcs, tc=tc, objective=objective)
    return mom, rho_all, rr_all


def whole_moments(mom: Moments, var=None, model=None) -> Moments:
    """The whole Moments from this rank's blocks (`moments_from_cxy` under
    a split): one gather of each (p, m), (m, p) and (p,) field."""
    sp = Split(var, model)

    def mp(t):
        return sp.all_vars(sp.all_factors(t, -2), -1)

    return mom._replace(
        c_xy=sp.all_vars(sp.all_factors(mom.c_xy, -1), -2),
        rho=mp(mom.rho), invrho=mp(mom.invrho), rhoinvrho=mp(mom.rhoinvrho),
        qij=mp(mom.qij), mi=mp(mom.mi), si=sp.all_vars(mom.si, -1),
        qi=sp.all_vars(mom.qi, -1), vi=sp.all_vars(mom.vi, -1))


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


def _ns_gradient_terms(mom: Moments, sp=NO_SPLIT, rr_all=None):
    """Shared algebra of the non-overlap gradient. Returns (AA, H, coef,
    sqz) with sqrt(z2)·∂F/∂W = AA·Σ_eff + H·rho − coef[:,None]·rho. Under
    a split AA is this rank's block, H whole, coef and sqz this rank's
    factors; `rr_all` is rhoinvrho of every factor (`_moment_parts`)."""
    rho, invrho, rr = mom.rho, mom.invrho, mom.rhoinvrho
    rr_all = rr if rr_all is None else rr_all
    alpha = 1.0 / (1.0 + mom.qi - mom.si ** 2)
    beta = 1.0 / (1.0 + mom.si)
    h_fac = (1.0 + rho ** 2) * invrho ** 2
    aa = alpha[..., None, :] * h_fac * mom.qij \
        - 2.0 * (alpha * mom.si + beta)[..., None, :] * rho * invrho ** 2
    hmat = sp.all_factors(sp.vsum(_mm(rr * alpha[..., None, :],
                                      rr_all.mT)), -2)
    kappa = sp.vsum(torch.sum(aa * rho, dim=-1))
    mu = sp.vsum(torch.sum(alpha[..., None, :] * rr * mom.qij, dim=-1))
    coef = kappa + mu - 1.0
    return aa, hmat, coef, sp.mine(torch.sqrt(mom.z2))


def _cxy_eff(data, ws, eps, bf16, gram):
    """Annealed effective cross-moment C_xy = Σ_eff·Wᵀ from X (samples),
    Σ (gram), either one in bf16, or int8-quantized: the one definition
    every objective and fixed-point entry point shares."""
    apply = _apply_sigma_t(data, bf16, gram, ws.dtype)
    return _anneal(_lanes(apply, ws.mT), ws.mT, eps)


def _apply_sigma_t(data, bf16, gram, dtype):
    """v (p, k) ↦ Σ_emp·v for the operand mode (un-annealed; callers
    blend eps themselves and lay lanes side by side with `_lanes`). Under
    `var`, v and the result are this rank's rows."""
    if is_quantized(data):
        return lambda v: _apply_int8(data, v, gram).to(dtype)
    var = var_of(data)
    x, n, axes = _unsharded(data)
    if gram:
        apply = _gram_t(x, var)
        if bf16:
            return lambda v: apply(
                v, lambda a, b: _mm_bf16(a, b, dtype))
        return apply
    vs = Split(var=var).vsum
    if bf16:
        return lambda v: _per_sample(all_reduce(
            _mm_bf16(x.T, vs(_mm_bf16(x, v, dtype)), dtype), axes), n)
    return lambda v: _per_sample(all_reduce(_mm(x.T, vs(_mm(x, v))), axes),
                                 n)


def _run_chain(ws, c_xy, y_scale, rho_clip, sp=NO_SPLIT):
    """Shared prologue + fused chain call: cov(y) from C_xy, then the
    chain kernel on the whole C_xy (under a split, gathered over `model`
    and `var` first). Returns (dt, z2, sqz, chain outputs, C_xy's rows of
    this rank with every factor)."""
    c_all = sp.all_factors(c_xy)
    _, z2, sqz, ry = _cy_ry(ws, c_all, y_scale, sp)
    whole = sp.all_vars(c_all)
    return ws.dtype, z2, sqz, ns_chain(whole.contiguous(), ry.contiguous(),
                                       sqz.contiguous(), rho_clip), c_all


def _chain_obj_tc(dt, z2, sum_log_vi, mi_sums, y_scale):
    """Objective F and TC from the chain kernel's reductions."""
    objective = 0.5 * sum_log_vi.to(dt) \
        + 0.5 * torch.sum(torch.log(z2), dim=-1)
    i_y_x = 0.5 * torch.log(z2) - _log_scalar(y_scale, dt, z2.device)
    tc = torch.sum(mi_sums.to(dt) - i_y_x, dim=-1)
    return objective, tc


def _ns_obj_grad_chain(ws, c_xy, apply_sigma_t, eps, y_scale, rho_clip,
                       sp=NO_SPLIT):
    """Objective/gradient through the fused chain kernel. Works in (p, m)
    layout end to end; `apply_sigma_t(v)` maps a (p, m) matrix to
    Σ_emp·v and the eps blend is applied here. Under a split the gradient
    is this rank's block."""
    dt, z2, sqz, (aa_t, hmat, kappa, mu, mi_sums, sum_log_vi), c_all = \
        _run_chain(ws, c_xy, y_scale, rho_clip, sp)
    aa_t = sp.mine(sp.my_vars(aa_t.to(dt)))
    coef = sp.mine((kappa + mu - 1.0).to(dt))
    aas_t = _anneal(_lanes(apply_sigma_t, aa_t), aa_t, eps)
    inv_sqz = (1.0 / sqz).to(dt)
    rho_t = torch.clamp(c_all * inv_sqz[..., None, :], -rho_clip, rho_clip)
    inv_mine = sp.mine(inv_sqz)
    grad_t = (aas_t + _mm(rho_t, sp.mine(hmat.to(dt)))
              - sp.mine(rho_t) * coef[..., None, :]) * inv_mine[..., None, :]
    objective, tc = _chain_obj_tc(dt, z2, sum_log_vi, mi_sums, y_scale)
    return objective, grad_t.mT, tc


def ns_obj_grad_samples(ws, x, eps, y_scale, rho_clip, bf16=False,
                        chain_kernel=False, model=None):
    """(objective, gradient, TC) of the non-overlap objective, samples
    path: 4 skinny GEMMs (2 for the moments, 2 for AA·Σ_eff). bf16=True
    runs them on bfloat16 operands with float32 products; an int8
    QuantizedData `x` runs them as int8 products. `model`: the axis W's
    rows are split over (`ws` this rank's rows)."""
    return _ns_obj_grad(ws, x, eps, y_scale, rho_clip, bf16, chain_kernel,
                        gram=False, model=model)


def ns_obj_grad_gram(ws, gram, eps, y_scale, rho_clip, bf16=False,
                     chain_kernel=False, model=None):
    """Same as `ns_obj_grad_samples` on the precomputed Gram matrix:
    2 O(p²·m) GEMMs per evaluation, independent of n."""
    return _ns_obj_grad(ws, gram, eps, y_scale, rho_clip, bf16,
                        chain_kernel, gram=True, model=model)


def _ns_obj_grad(ws, data, eps, y_scale, rho_clip, bf16, chain_kernel,
                 gram, model=None):
    sp = Split(var_of(data), model)
    c_xy = _cxy_eff(data, ws, eps, bf16, gram)
    if chain_kernel:
        return _ns_obj_grad_chain(
            ws, c_xy, _apply_sigma_t(data, bf16, gram, ws.dtype), eps,
            y_scale, rho_clip, sp)
    mom, rho_all, rr_all = _moment_parts(ws, c_xy, y_scale, rho_clip, sp)
    aa, hmat, coef, sqz = _ns_gradient_terms(mom, sp, rr_all)
    aas = _anneal(_lane_rows(_apply_sigma_rows(data, bf16, gram, ws.dtype),
                             aa), aa, eps)
    grad = (aas + _mm(sp.mine(hmat, -2), rho_all)
            - coef[..., :, None] * mom.rho) / sqz[..., :, None]
    return mom.objective, grad, mom.tc


def _apply_sigma_rows(data, bf16, gram, dtype):
    """a (r, p) ↦ a·Σ_emp for the operand mode: the row-layout form of
    `_apply_sigma_t` (the gradient path's AA·Σ). Under `var`, a and the
    result are this rank's columns."""
    if is_quantized(data):
        return lambda a: _apply_int8(data, a.T, gram).T.to(dtype)
    var = var_of(data)
    x, n, axes = _unsharded(data)
    if gram:
        apply = _gram_rows(x, var)
        if bf16:
            return lambda a: apply(a, lambda u, w: _mm_bf16(u, w, dtype))
        return apply
    vs = Split(var=var).vsum
    if bf16:
        return lambda a: _per_sample(all_reduce(
            _mm_bf16(vs(_mm_bf16(a, x.T, dtype)), x, dtype), axes), n)
    return lambda a: _per_sample(all_reduce(_mm(vs(_mm(a, x.T)), x), axes),
                                 n)


# ---------------------------------------------------------------------------
# Damped fixed-point update (optimizer='fixed_point')
# ---------------------------------------------------------------------------

def ns_fp_parts(ws, data, eps, y_scale, rho_clip, bf16=False,
                chain_kernel=False, gram=False, model=None):
    """Pieces of the closed-form fixed-point target, before the m x m
    solve. Setting the gradient to zero with rho = diag(1/sqz)·W·Σ_eff
    gives Ŵ = diag(sqz)·(diag(coef) − H)⁻¹·AA. Returns (objective, tc,
    a_mat (m, m), aa_t (p, m), sqz (m,)). a_mat is near-singular once
    surplus factors have died; the damped accept/reject iteration
    tolerates the inexact inverse."""
    c_xy = _cxy_eff(data, ws, eps, bf16, gram)
    return fp_parts_from_cxy(ws, c_xy, y_scale, rho_clip, chain_kernel,
                             var=var_of(data), model=model)


def fp_parts_from_cxy(ws, c_xy, y_scale, rho_clip, chain_kernel=False,
                      var=None, model=None):
    """`ns_fp_parts` given an already-annealed C_xy. Under a split aa_t is
    this rank's rows with every factor (p_loc, m) and sqz this rank's
    factors; a_mat is whole."""
    sp = Split(var, model)
    if chain_kernel:
        dt, z2, sqz, (aa_t, hmat, kappa, mu, mi_sums, slv), _ = _run_chain(
            ws, c_xy, y_scale, rho_clip, sp)
        coef = (kappa + mu - 1.0).to(dt)
        a_mat = torch.diag_embed(coef) - hmat.to(dt)
        objective, tc = _chain_obj_tc(dt, z2, slv, mi_sums, y_scale)
        return objective, tc, a_mat, sp.my_vars(aa_t.to(dt)), sp.mine(sqz)
    mom, _, rr_all = _moment_parts(ws, c_xy, y_scale, rho_clip, sp)
    aa, hmat, coef, sqz = _ns_gradient_terms(mom, sp, rr_all)
    a_mat = torch.diag_embed(sp.all_factors(coef)) - hmat
    return mom.objective, mom.tc, a_mat, sp.all_factors(aa, -2).mT, sqz


def fp_target_from_parts(ws, a_mat_inv, aa_t, sqz, model=None):
    """The solver direction ws − Ŵ from `ns_fp_parts` pieces and the
    inverse of a_mat (applied as inverse + GEMM, as the JAX package
    does). Under `model`, the rows J of this rank."""
    target = _mm(Split(model=model).mine(a_mat_inv, -2), aa_t.mT) \
        * sqz[..., :, None]
    return ws - target


def ns_fp_samples(ws, x, eps, y_scale, rho_clip, bf16=False,
                  chain_kernel=False, model=None):
    """(objective, ws − Ŵ, TC) for the damped fixed-point update, samples
    path. The solver's plain-GD step turns the direction into
    (1−γ)·ws + γ·Ŵ."""
    return _ns_fp(ws, x, eps, y_scale, rho_clip, bf16, chain_kernel,
                  gram=False, model=model)


def ns_fp_gram(ws, gram, eps, y_scale, rho_clip, bf16=False,
               chain_kernel=False, model=None):
    """Gram-path fixed-point update: one O(p²·m) GEMM per iteration."""
    return _ns_fp(ws, gram, eps, y_scale, rho_clip, bf16, chain_kernel,
                  gram=True, model=model)


def _ns_fp(ws, data, eps, y_scale, rho_clip, bf16, chain_kernel, gram,
           model=None):
    check_factorizable(ws.dtype, "the fixed point's LU inverse")
    obj, tc, a_mat, aa_t, sqz = ns_fp_parts(
        ws, data, eps, y_scale, rho_clip, bf16, chain_kernel, gram, model)
    # inv_ex, as jnp.linalg.inv: a singular a_mat gives inf/NaN (a rejected
    # step of that lane) instead of an exception, and no host sync
    a_inv = torch.linalg.inv_ex(a_mat).inverse
    return obj, fp_target_from_parts(ws, a_inv, aa_t, sqz, model), tc


# ---------------------------------------------------------------------------
# Overlapping (discourage_overlap=False) objective: the exact Gaussian
# bound, with m x m solves and never a p x p one
# ---------------------------------------------------------------------------

def _cholesky_or_nan(cy):
    """Lower Cholesky factor of C_y, or all-NaN where C_y is not positive
    definite — what `jnp.linalg.cholesky` returns. The objective is then
    NaN, `f_new <= f` is False and the solver rejects the step, as in the
    JAX package. `cholesky_ex` reports the failure in `info` on the
    device, so this costs no host sync. A half-dtype C_y raises
    NotImplementedError (`check_factorizable`)."""
    check_factorizable(cy.dtype, "Cholesky")
    chol, info = torch.linalg.cholesky_ex(cy)
    return torch.where(info[..., None, None] == 0, chol, torch.nan)


def _overlap_core(ws, b, cy_chol, y_scale, sp=NO_SPLIT):
    """F and the shared terms given B = Σ_eff·Wᵀ (this rank's rows, every
    factor) and chol(C_y)."""
    m = b.shape[-1]
    bm = torch.cholesky_solve(b.mT, cy_chol, upper=False).mT     # p x m
    v = torch.clamp(1.0 - torch.sum(bm * b, dim=-1), min=1e-12)
    logdet = 2.0 * torch.sum(
        torch.log(torch.diagonal(cy_chol, dim1=-2, dim2=-1)), dim=-1)
    f = 0.5 * sp.vsum(torch.sum(torch.log(v), dim=-1)) + 0.5 * logdet \
        - m * _log_scalar(y_scale, ws.dtype, ws.device)
    return f, bm, v


def _overlap_from_b(ws, b, eps, y_scale, apply_sigma, sp=NO_SPLIT):
    """The overlap objective and gradient from the annealed B;
    `apply_sigma(g)` maps an (m, p) matrix to g·Σ_emp (lanes: their rows
    stacked, `_lane_rows`). Under a split B and the gradient are this
    rank's blocks; B's columns are gathered over `model` and the m x m
    solves run whole on every rank."""
    b_all = sp.all_factors(b)
    mdim = b_all.shape[-1]
    cy = sp.all_factors(sp.vsum(_mm(ws, b_all)), -2) + (y_scale ** 2) \
        * torch.eye(mdim, dtype=ws.dtype, device=ws.device)
    chol = _cholesky_or_nan(cy)
    f, bm, v = _overlap_core(ws, b_all, chol, y_scale, sp)
    g_all = (bm / v[..., :, None]).mT                            # m x p
    g_lhs = sp.mine(g_all, -2)
    gs = _anneal(_lane_rows(apply_sigma, g_lhs), g_lhs, eps)
    k = sp.vsum(_mm(g_lhs, b_all))
    mbt = torch.cholesky_solve(b_all.mT, chol, upper=False)      # m x p
    grad = -gs + _mm(k, mbt) + sp.mine(mbt, -2)
    return f, grad, -f


def overlap_obj_grad_samples(ws, x, eps, y_scale, model=None):
    """(objective, gradient, TC proxy) of the exact Gaussian objective.

    ∇F = −(M Bᵀ V)·Σ_eff + (M Bᵀ V B M)·Bᵀ + M·Bᵀ with M = C_y⁻¹,
    V = diag(1/v) (derivation in the JAX package's oracle)."""
    b = _anneal(_lanes(_apply_sigma_t(x, False, False, ws.dtype), ws.mT),
                ws.mT, eps)
    return _overlap_from_b(ws, b, eps, y_scale,
                           _apply_sigma_rows(x, False, False, ws.dtype),
                           Split(var_of(x), model))


def overlap_obj_grad_gram(ws, gram, eps, y_scale, model=None):
    """Gram-path variant of `overlap_obj_grad_samples`. Σ·Wᵀ keeps the
    working dtype. (The JAX package's product rounds it to float32 in
    every dtype, so in float64 the two differ at ~1e-7; the port agrees
    with the float64 oracle instead.)"""
    g, var = _unsharded(gram)[0], var_of(gram)
    b = _anneal(_lanes(_gram_t(g, var), ws.mT), ws.mT, eps)
    return _overlap_from_b(ws, b, eps, y_scale, _gram_rows(g, var),
                           Split(var, model))
