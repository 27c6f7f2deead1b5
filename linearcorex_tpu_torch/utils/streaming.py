"""Streaming moment accumulation: fit Linear CorEx from batched data.

Port of `linearcorex_tpu/utils/streaming.py`, single-device. The Gram
path of the solver needs only the p x p correlation matrix, a plain
average over samples, so batches are accumulated on the device one at a
time (raw second moments and column sums, one product per batch) and the
fit runs from the accumulated moments without ever holding X:

    acc = GramAccumulator(p)              # device="cuda"
    for batch in stream:                  # each batch: (b, p)
        acc.update(batch)
    model = acc.fit(n_hidden=8, seed=0)

Equivalent (to floating-point precision) to `Corex(...).fit(concat(
batches))` with gaussianize='standard': the accumulated mean and variance
standardize the Gram analytically, corr = D⁻¹ (G_raw/n − μμᵀ) D⁻¹.

The accumulator's (p, p) and (p,) tensors live on an explicit device and
are updated in place (`addmm_`, `add_`). `fit`, `fit_csv` and
`fit_from_covariance` take `device` among their estimator arguments, as
`Corex` does.

With `mesh=` (and a `shard_vars` ShardingPlan, the default) every entry
point here keeps Σ as row blocks over the mesh's `var` axis from the first
batch on, and solves through `parallel.fit_sharded` (gram strategy): the
streamed fit and the fit of a p beyond one device compose, and no (p, p)
or (n, p) buffer ever lies whole on one device. The execution model is
`parallel.sharding`'s: one process per device, every rank makes the same
call with the same whole arguments and ends with the same fitted bits.
"""

from __future__ import annotations

import numpy as np
import torch

from linearcorex_tpu_torch.models.corex import (Corex, _fit_program,
                                                check_precision,
                                                input_kind,
                                                resolve_config,
                                                resolve_device,
                                                resolve_optimizer,
                                                torch_dtype)
from linearcorex_tpu_torch.ops import moments as M
from linearcorex_tpu_torch.ops import preprocessing as P
from linearcorex_tpu_torch.parallel import sharding as S
from linearcorex_tpu_torch.parallel.collectives import ring_pass
from linearcorex_tpu_torch.utils.compile_cache import ensure_compile_cache

__all__ = ["GramAccumulator", "fit_from_covariance", "iter_text_blocks",
           "fit_csv"]


def iter_text_blocks(path: str, block_rows: int = 8192,
                     delimiter: str = ",", skip_header: int = 0):
    """Yield (block_rows, p) float64 blocks from a delimited numeric text
    file: the native C++ single-pass reader (`csrc/loader.cpp`, O(block)
    memory) when the host library is built, otherwise a pure-Python
    reader with identical output."""
    from linearcorex_tpu_torch.utils import native

    if native.available():
        yield from native.CsvReader(path, block_rows=block_rows,
                                    delimiter=delimiter,
                                    skip_header=skip_header)
        return
    rows = []
    cols = None
    with open(path) as f:
        for i, line in enumerate(f):
            if i < skip_header:
                continue
            line = line.strip()
            if not line:
                continue
            # strict field semantics matching the native reader: blank
            # delimiters split on runs of whitespace; other delimiters
            # require non-empty fields (an empty field is silent data
            # misalignment, not a value)
            if delimiter in (" ", "\t"):
                parts = line.split()
            else:
                parts = [v.strip() for v in line.split(delimiter)]
                if any(not v for v in parts):
                    raise ValueError(
                        f"{path}:{i + 1}: empty field in row {line[:60]!r}")
            row = np.array([float(v) for v in parts])
            if cols is None:
                cols = row.size
            elif row.size != cols:
                raise ValueError(
                    f"{path}:{i + 1}: expected {cols} fields, got "
                    f"{row.size}")
            rows.append(row)
            if len(rows) == block_rows:
                yield np.stack(rows)
                rows = []
    if rows:
        yield np.stack(rows)


def _no_plan_without_mesh(where: str, mesh, sharding_plan) -> None:
    """A plan without a mesh cannot take effect: the caller's mistake, by
    name (the JAX package's ValueError)."""
    if mesh is None and sharding_plan is not None:
        raise ValueError(
            f"{where} received sharding_plan= without mesh=; a plan "
            f"without a mesh cannot take effect — pass both, or neither")


def _resolve_stream_plan(mesh, sharding_plan, p, where: str):
    """The ShardingPlan a moment-input fit runs under. Its operand is the
    p x p correlation, which carries no sample axis, so the plan must
    split the variables (`shard_vars`): a plan without it, or with
    `shard_slices`, raises by name. p must divide by the `var` extent.
    The plan's sample axes split nothing here: the ranks along them hold
    the same row block. The factor axis is checked against n_hidden by
    `fit_sharded` at solve time."""
    import dataclasses

    plan = sharding_plan if sharding_plan is not None else S.ShardingPlan(
        shard_samples=False, shard_vars=True)
    if not plan.shard_vars:
        raise ValueError(
            f"{where}(mesh=...) operates on the accumulated p x p "
            f"correlation (gram strategy), which carries no sample axis — "
            f"the ShardingPlan must set shard_vars=True to shard its rows "
            f"(got {plan}); shard_samples/shard_slices do not apply here")
    if plan.shard_slices:
        raise ValueError(
            f"{where}(mesh=...): shard_slices splits the SAMPLE axis; a "
            f"Gram operand carries none — use a shard_vars plan")
    S.validate_plan_shapes(dataclasses.replace(plan, shard_factors=False),
                           "gram", mesh, None, p, 1)
    return plan


def fit_csv(path: str, n_hidden: int, block_rows: int = 8192,
            delimiter: str = ",", skip_header: int = 0,
            mesh=None, sharding_plan=None, **corex_kwargs) -> Corex:
    """Out-of-core fit straight from a delimited numeric text file: stream
    blocks through a GramAccumulator (native reader when available), then
    fit from the accumulated moments. The file is never held in memory;
    each float64 block is uploaded to the device by `update`.
    `mesh=`/`sharding_plan=` accumulate and solve over the mesh (see
    GramAccumulator): every rank parses the whole file on its host and
    keeps its columns, so the parse repeats on each rank.

    Equivalent (to floating-point precision) to
    Corex(...).fit(np.loadtxt(path, ...)) with gaussianize='standard'."""
    _no_plan_without_mesh("fit_csv", mesh, sharding_plan)
    dtype = corex_kwargs.get("dtype", "float32")
    device = corex_kwargs.get("device", "cuda")
    if mesh is not None:
        S.check_mesh(mesh, device)   # before the parse, not after it
    acc = None
    for block in iter_text_blocks(path, block_rows, delimiter, skip_header):
        if acc is None:
            acc = GramAccumulator(block.shape[1], dtype=dtype,
                                  device=device, mesh=mesh,
                                  sharding_plan=sharding_plan)
        acc.update(block)
    if acc is None:
        raise ValueError(f"{path}: no data rows")
    return acc.fit(n_hidden, **corex_kwargs)


def fit_from_covariance(sigma, n_samples: int, n_hidden: int,
                        variable_means=None, mesh=None, sharding_plan=None,
                        **corex_kwargs) -> Corex:
    """Fit Linear CorEx directly from a p x p covariance (or correlation)
    matrix; no sample matrix is needed.

    Common when only the second-moment matrix is available (shared summary
    statistics). `n_samples` is the sample count behind sigma; the moments
    are exact inputs, so it does not enter the moment math, but it is
    recorded on the model and feeds the optimizer='auto' policy
    (fixed_point iff n_samples >= p): pass the real count.
    `variable_means` (default zeros) fills the model's theta, so
    `transform`/`predict` standardize new data with sigma's scale. sigma
    may be an array or a tensor; it is normalized on the model device in
    the model dtype, and the fitted attributes are of its kind (numpy
    arrays for an array, `models.corex.as_kind`).

    `mesh=`/`sharding_plan=` (a `shard_vars` plan, the default): each rank
    copies only its row block Σ[I, :] and the (p,) diagonal to its device
    and normalizes the block there, so the whole (p, p) never lands on one
    device; the solve runs through `parallel.fit_sharded`."""
    _reject_missing_values(corex_kwargs, "fit_from_covariance")
    _no_plan_without_mesh("fit_from_covariance", mesh, sharding_plan)
    if not isinstance(sigma, (np.ndarray, torch.Tensor)):
        sigma = np.asarray(sigma)
    p = sigma.shape[0]
    if tuple(sigma.shape) != (p, p):
        raise ValueError(f"sigma must be square, got {tuple(sigma.shape)}")
    model = Corex(n_hidden=n_hidden, gaussianize="standard", **corex_kwargs)
    plan = None
    if mesh is None:
        corr, std = _normalize_sigma(model._as_tensor(sigma))
    else:
        S.check_mesh(mesh, model._device)
        plan = _resolve_stream_plan(mesh, sharding_plan, p,
                                    "fit_from_covariance")
        var = S.var_axis(mesh, plan)
        diag = sigma.diagonal() if isinstance(sigma, torch.Tensor) \
            else np.diagonal(sigma)
        std = _std_from_var(model._as_tensor(diag))
        corr = S.shard_gram(sigma, var, model._device, model._dt)
        corr = corr._replace(local=corr.local / torch.outer(
            M.Split(var=var).my_vars(std), std))
    mean = (torch.zeros(p, dtype=model._dt, device=model._device)
            if variable_means is None else variable_means)
    return _solve_from_moments(model, corr, mean, std, int(n_samples),
                               mesh=mesh, plan=plan, kind=input_kind(sigma))


def _std_from_var(var):
    """The standard deviations the fit divides by, from the variances."""
    std = torch.sqrt(torch.clamp(var, min=1e-20))
    return torch.where(std < 1e-10, 1.0, std)


def _normalize_sigma(sigma):
    """(correlation, std) from a covariance matrix."""
    std = _std_from_var(torch.diagonal(sigma))
    return sigma / torch.outer(std, std), std


def _solve_from_moments(model, corr, mean, std, n_samples, init_ws=None,
                        mesh=None, plan=None, kind="numpy"):
    """Shared solve for every moment-input fit (`fit_from_covariance`,
    `GramAccumulator.fit`, `Corex.partial_fit`): record the affine theta,
    resolve the 'auto' knobs against the TRUE sample count (the Gram
    operand carries none), cast the correlation operand per matmul_dtype
    (int8 through `quantize_gram` and its wrap guard), and run the
    gram-strategy fit program in place on `model`. `init_ws` warm-starts
    (partial_fit); otherwise the init follows the model's own policy via
    `_resolve_w0`, pretrained weights and init='spectral' included.
    `kind` is that of the data behind the moments (`models.corex.as_kind`):
    the fitted attributes' kind.

    With `mesh`/`plan` (a validated `shard_vars` plan) `corr` is this
    rank's row block (a Gram `ShardedSamples`) and `mean`/`std` are whole:
    the solve runs through `parallel.fit_sharded`, as `Corex.fit(mesh=)`
    does. An unseeded model draws its W0 from a seed its ranks share; the
    int8 scale is the maximum over all of Σ; use_pallas='auto' resolves
    against the mesh inside `fit_sharded`."""
    ensure_compile_cache()   # a moment-input fit may be a process's first
    p = M.n_cols(corr)
    model.n_samples, model.nv = int(n_samples), p
    model._fit_kind = kind
    model.theta = P.Theta(mean=model._as_tensor(mean),
                          std=model._as_tensor(std))
    check_precision(model.config)
    if mesh is None:
        cfg = resolve_config(model.config, p, model._device,
                             n_samples=model.n_samples)
        data = model._as_tensor(corr)
    else:
        cfg = resolve_optimizer(model.config, p, model.n_samples)
        data = corr._replace(local=model._as_tensor(corr.local))
    model.resolved_optimizer_ = cfg.optimizer
    if cfg.matmul_dtype == "bfloat16":
        data = data._replace(local=data.local.to(torch.bfloat16)) \
            if mesh is not None else data.to(torch.bfloat16)
    elif cfg.matmul_dtype == "int8":
        data = M.quantize_gram(data)
    try:
        if mesh is not None:
            model._mesh_seed = S.shared_seed(model.seed, mesh,
                                             model._device)
        w0 = model._resolve_w0(init_ws, data=data, strategy="gram")
        if mesh is None:
            model.ws, model.moments, model.diagnostics = _fit_program(
                data, w0, cfg, "gram")
        else:
            model.ws, model.moments, model.diagnostics = S.fit_sharded(
                data, w0, cfg, mesh, plan, "gram",
                n_samples=model.n_samples, check_overflow=False)
    finally:
        model._mesh_seed = None
    model._serving_plan = plan   # None: single-device state
    # single-lane fits carry the plain fit's fitted attributes
    model.best_restart_ = 0
    return model


def _reject_missing_values(corex_kwargs, where):
    """Moment-input fits never see the raw samples, so the estimator's
    mean-imputation cannot run: accepting the argument would skip the
    imputation without a word (the wrong model, no error)."""
    if corex_kwargs.get("missing_values") is not None:
        raise ValueError(
            f"{where} fits from accumulated second moments and cannot "
            f"mean-impute missing_values (imputation needs the samples); "
            f"impute each batch before accumulation, or use Corex.fit on "
            f"the full sample matrix")


def _update_moments(g, s, x, x0, var=None):
    """One pass over a batch, folded into the running moments in place:
    shift by the accumulation pivot x0, one product XᵀX added onto g
    (`addmm_`) and the column sums onto s. The product runs in full
    float32 (never TF32), whatever the caller's global setting: the
    accumulated moments feed every solver iteration.

    Under a `var` axis x is this rank's column block X[:, I], x0 and s
    its columns, and g its row block G[I, :]: the other ranks' column
    blocks come around a ring over `var` (`ring_pass`), one at a time,
    each multiplied into its columns of g, as `ops.moments.compute_gram`
    builds Σ's row block. In a world of one that is the one `addmm_`.

    In a half dtype the batch's product is rounded to the dtype and then
    added, as the JAX package does (`ops.moments._mm`, then the sum), and
    in float16 every entry of g, the sum of (x − x0)² over all rows so
    far on the diagonal, must stay below 65504 (float16's largest value)
    or it overflows to inf, as it does there."""
    xs = x - x0[None, :]
    with M.full_f32_matmul():
        if g.dtype in M.HALF_DTYPES and (var is None or var.size == 1):
            g.add_(M._mm(xs.T, xs))
        elif var is None or var.size == 1:
            g.addmm_(xs.T, xs)
        else:
            width, blk = xs.shape[1], xs
            for step in range(var.size):
                j = (var.index - step) % var.size
                g[:, j * width:(j + 1) * width].addmm_(xs.T, blk)
                if step + 1 < var.size:
                    blk = ring_pass(blk, var)
    s.add_(torch.sum(xs, dim=0))


def _finalize_corr(g_raw, col_sum, n, var=None):
    """Standardized correlation matrix from raw accumulated moments, with
    the mean and std of the shifted data. Under a `var` axis g_raw is the
    row block G[I, :] and col_sum its columns' sums: the result is the
    correlation's row block, and the mean and std are gathered whole (the
    std of I is local, from the block's diagonal)."""
    sp = M.Split(var=var)
    mean = M._per_sample(col_sum, n)
    mean_all = sp.all_vars(mean)
    cov = M._per_sample(g_raw, n) - torch.outer(mean, mean_all)
    first = 0 if var is None else var.index * g_raw.shape[0]
    var_i = torch.clamp(torch.diagonal(cov, offset=first), min=1e-20)
    std = torch.sqrt(var_i)
    std = torch.where(std < 1e-10, 1.0, std)
    std_all = sp.all_vars(std)
    corr = cov / torch.outer(std, std_all)
    return corr, mean_all, std_all


class GramAccumulator:
    """Accumulate second moments over data batches; fit without holding X.

    Only gaussianize='standard' semantics are possible in one streaming
    pass (rank-based 'empirical' needs all data); that is also the
    solver's default mode.

    The (p, p) and (p,) running moments are tensors of `dtype` on
    `device` (default "cuda"; a CUDA device that is absent raises) and are
    updated in place by every batch. `fit` runs on the accumulator's
    device unless told otherwise.

    `mesh=` (optionally with a `shard_vars` ShardingPlan, the default if
    omitted) keeps the accumulator as Σ's row block over the mesh's `var`
    axis for its whole life: each rank holds G[I, :] (p/d, p) and its
    column sums, never the whole (p, p). `update` copies only the batch's
    column block X[:, I] to the device (a host array is sliced on the
    host, a tensor through a view) and builds the row block around a ring
    over `var`, so no rank holds a whole batch either. `correlation()`
    returns a `DTensor` split over `var`; `fit` solves through
    `parallel.fit_sharded` and the fitted estimator serves under the same
    plan. This is how a streamed fit reaches a p whose Σ does not fit on
    one device. Memory per rank: at n = p = 10,000 in float32 one rank
    holds Σ's 400 MB in a world of one; over four it holds a 100 MB row
    block plus a (1000, 2500) batch block and one in flight, about 20 MB.
    Every rank passes every batch whole (the SPMD rule of
    `parallel.sharding`)."""

    def __init__(self, p: int, dtype="float32", device="cuda", mesh=None,
                 sharding_plan=None):
        _no_plan_without_mesh("GramAccumulator", mesh, sharding_plan)
        self.p = p
        self.dtype = dtype if isinstance(dtype, torch.dtype) \
            else torch_dtype(dtype)
        self.device = resolve_device(device)
        self.mesh, self.plan, self._var = mesh, None, None
        rows = p
        if mesh is not None:
            S.check_mesh(mesh, self.device)
            self.plan = _resolve_stream_plan(mesh, sharding_plan, p,
                                             "GramAccumulator")
            self._var = S.var_axis(mesh, self.plan)
            rows = p // self._var.size
        self._g = torch.zeros((rows, p), dtype=self.dtype,
                              device=self.device)
        self._s = torch.zeros((rows,), dtype=self.dtype, device=self.device)
        self._x0 = None   # shift point (the first batch's column means)
        self._n = 0
        # the kind of the batches (`models.corex.input_kind`), that of the
        # fitted model's attributes: 'tensor' while every batch is one
        self._kind = None

    def update(self, x) -> "GramAccumulator":
        # Screening a host array for NaN/inf is cheap, and a NaN batch
        # poisons the accumulated Gram for good (TC = nan after the fit);
        # a batch already on a device is taken as it is rather than forced
        # through a host read per batch, as Corex's own validation does.
        if isinstance(x, np.ndarray) and not np.isfinite(x).all():
            raise ValueError(
                "batch contains NaN/inf; clean it before accumulation "
                "(the accumulated Gram cannot be repaired afterwards)")
        kind = input_kind(x)
        if not isinstance(x, (np.ndarray, torch.Tensor)):
            x = np.asarray(x)
        if x.ndim != 2 or x.shape[1] != self.p:
            raise ValueError(
                f"expected batch of shape (b, {self.p}), got "
                f"{tuple(x.shape)}")
        if x.shape[0] == 0:
            # an empty FIRST batch would set the shift point _x0 to the
            # mean of nothing (NaN) and poison every later batch; reject
            # empty batches everywhere
            raise ValueError("batch has 0 rows")
        if self._var is not None:
            x = x[:, S._block(self.p, (self._var,))]   # this rank's columns
        x = torch.as_tensor(x).to(device=self.device, dtype=self.dtype)
        if self._x0 is None:
            # Accumulate around the first batch's mean (shifted data):
            # cov = G'/n − μ'μ'ᵀ with μ' = μ − x0 small, so the
            # subtraction does not cancel catastrophically in float32
            # (~1% TC drift without the shift when means dominate
            # variances). Per column, so local under `var`.
            self._x0 = torch.mean(x, dim=0)
        _update_moments(self._g, self._s, x, self._x0, self._var)
        self._n += x.shape[0]
        self._kind = "numpy" if "numpy" in (self._kind, kind) else kind
        return self

    @property
    def n_samples(self) -> int:
        return self._n

    def _moments(self):
        """(corr, mean, std) of everything accumulated so far; under a
        mesh corr is this rank's row block (a Gram `ShardedSamples`) and
        mean and std are whole."""
        if self._n < 2:
            raise ValueError("need at least 2 accumulated samples")
        corr, mean_shift, std = _finalize_corr(self._g, self._s,
                                               float(self._n), self._var)
        x0 = M.Split(var=self._var).all_vars(self._x0)
        if self._var is not None:
            corr = M.ShardedSamples(local=corr, n_total=self.p, axes=(),
                                    p_total=self.p, var=self._var,
                                    gram=True)
        return corr, x0 + mean_shift, std

    def correlation(self):
        """The standardized p x p correlation matrix accumulated so far;
        under a mesh a `DTensor` whose row blocks are split over `var`
        (`.full_tensor()` gathers it)."""
        corr = self._moments()[0]
        if self.mesh is None:
            return corr
        return S.as_dtensor(corr.local, self.mesh, {S.VAR_AXIS: 0})

    def fit(self, n_hidden: int, **corex_kwargs) -> Corex:
        """Fit a Corex model from the accumulated moments (gram strategy),
        in the accumulator's dtype and on its device unless `corex_kwargs`
        say otherwise. An accumulator built with `mesh=` solves through
        `parallel.fit_sharded` under its layout, and the fitted estimator
        serves under it too.

        Returns a fitted estimator whose transform/predict/get_covariance
        behave exactly as if fit on the concatenated data with
        gaussianize='standard'. Its fitted attributes are tensors if every
        batch was one, else numpy arrays (`models.corex.as_kind`)."""
        corr, mean, std = self._moments()
        _reject_missing_values(corex_kwargs, "GramAccumulator.fit")
        corex_kwargs.setdefault("dtype",
                                str(self.dtype).removeprefix("torch."))
        corex_kwargs.setdefault("device", str(self.device))
        model = Corex(n_hidden=n_hidden, gaussianize="standard",
                      **corex_kwargs)
        return _solve_from_moments(model, corr, mean, std, self._n,
                                   mesh=self.mesh, plan=self.plan,
                                   kind=self._kind)
