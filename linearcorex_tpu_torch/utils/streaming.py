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
`Corex` does. The sharded forms (`mesh=`, `sharding_plan=`) of the JAX
package are not ported yet and raise NotImplementedError.
"""

from __future__ import annotations

import numpy as np
import torch

from linearcorex_tpu_torch.models.corex import (Corex, _fit_program,
                                                _no_mesh, check_ported,
                                                resolve_config,
                                                resolve_device, torch_dtype)
from linearcorex_tpu_torch.ops import moments as M
from linearcorex_tpu_torch.ops import preprocessing as P

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


def _no_stream_mesh(where: str, mesh, sharding_plan) -> None:
    """A plan without a mesh is the caller's mistake (the JAX package's
    ValueError); a mesh is the sharded form, which is not ported yet."""
    if mesh is None and sharding_plan is not None:
        raise ValueError(
            f"{where} received sharding_plan= without mesh=; a plan "
            f"without a mesh cannot take effect — pass both, or neither")
    _no_mesh(where, mesh, sharding_plan)


def fit_csv(path: str, n_hidden: int, block_rows: int = 8192,
            delimiter: str = ",", skip_header: int = 0,
            mesh=None, sharding_plan=None, **corex_kwargs) -> Corex:
    """Out-of-core fit straight from a delimited numeric text file: stream
    blocks through a GramAccumulator (native reader when available), then
    fit from the accumulated moments. The file is never held in memory;
    each float64 block is uploaded to the device by `update`.

    Equivalent (to floating-point precision) to
    Corex(...).fit(np.loadtxt(path, ...)) with gaussianize='standard'."""
    _no_stream_mesh("fit_csv", mesh, sharding_plan)
    dtype = corex_kwargs.get("dtype", "float32")
    device = corex_kwargs.get("device", "cuda")
    acc = None
    for block in iter_text_blocks(path, block_rows, delimiter, skip_header):
        if acc is None:
            acc = GramAccumulator(block.shape[1], dtype=dtype,
                                  device=device)
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
    the model dtype."""
    _reject_missing_values(corex_kwargs, "fit_from_covariance")
    _no_stream_mesh("fit_from_covariance", mesh, sharding_plan)
    if not isinstance(sigma, (np.ndarray, torch.Tensor)):
        sigma = np.asarray(sigma)
    p = sigma.shape[0]
    if tuple(sigma.shape) != (p, p):
        raise ValueError(f"sigma must be square, got {tuple(sigma.shape)}")
    model = Corex(n_hidden=n_hidden, gaussianize="standard", **corex_kwargs)
    corr, std = _normalize_sigma(model._as_tensor(sigma))
    mean = (torch.zeros(p, dtype=model._dt, device=model._device)
            if variable_means is None else variable_means)
    return _solve_from_moments(model, corr, mean, std, int(n_samples))


def _normalize_sigma(sigma):
    """(correlation, std) from a covariance matrix."""
    var = torch.diagonal(sigma)
    std = torch.sqrt(torch.clamp(var, min=1e-20))
    std = torch.where(std < 1e-10, 1.0, std)
    return sigma / torch.outer(std, std), std


def _solve_from_moments(model, corr, mean, std, n_samples, init_ws=None):
    """Shared solve for every moment-input fit (`fit_from_covariance`,
    `GramAccumulator.fit`, `Corex.partial_fit`): record the affine theta,
    resolve the 'auto' knobs against the TRUE sample count (the Gram
    operand carries none), cast the correlation operand per matmul_dtype
    (int8 through `quantize_gram` and its wrap guard), and run the
    gram-strategy fit program in place on `model`. `init_ws` warm-starts
    (partial_fit); otherwise the init follows the model's own policy via
    `_resolve_w0`, pretrained weights and init='spectral' included."""
    p = corr.shape[0]
    model.n_samples, model.nv = int(n_samples), p
    model.theta = P.Theta(mean=model._as_tensor(mean),
                          std=model._as_tensor(std))
    check_ported(model.config)
    cfg = resolve_config(model.config, p, model._device,
                         n_samples=model.n_samples)
    model.resolved_optimizer_ = cfg.optimizer
    data = model._as_tensor(corr)
    if cfg.matmul_dtype == "bfloat16":
        data = data.to(torch.bfloat16)
    elif cfg.matmul_dtype == "int8":
        data = M.quantize_gram(data)
    w0 = model._resolve_w0(init_ws, data=data, strategy="gram")
    model.ws, model.moments, model.diagnostics = _fit_program(
        data, w0, cfg, "gram")
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


def _update_moments(g, s, x, x0):
    """One pass over a batch, folded into the running moments in place:
    shift by the accumulation pivot x0, one product XᵀX added onto g
    (`addmm_`) and the column sums onto s. The product runs in full
    float32 (never TF32), whatever the caller's global setting: the
    accumulated moments feed every solver iteration."""
    xs = x - x0[None, :]
    with M.full_f32_matmul():
        g.addmm_(xs.T, xs)
    s.add_(torch.sum(xs, dim=0))


def _finalize_corr(g_raw, col_sum, n):
    """Standardized correlation matrix from raw accumulated moments."""
    mean = col_sum / n
    cov = g_raw / n - torch.outer(mean, mean)
    var = torch.clamp(torch.diagonal(cov), min=1e-20)
    std = torch.sqrt(var)
    std = torch.where(std < 1e-10, 1.0, std)
    corr = cov / torch.outer(std, std)
    return corr, mean, std


class GramAccumulator:
    """Accumulate second moments over data batches; fit without holding X.

    Only gaussianize='standard' semantics are possible in one streaming
    pass (rank-based 'empirical' needs all data); that is also the
    solver's default mode.

    The (p, p) and (p,) running moments are tensors of `dtype` on
    `device` (default "cuda"; a CUDA device that is absent raises) and are
    updated in place by every batch. `fit` runs on the accumulator's
    device unless told otherwise."""

    def __init__(self, p: int, dtype="float32", device="cuda", mesh=None,
                 sharding_plan=None):
        _no_stream_mesh("GramAccumulator", mesh, sharding_plan)
        self.p = p
        self.dtype = dtype if isinstance(dtype, torch.dtype) \
            else torch_dtype(dtype)
        self.device = resolve_device(device)
        self._g = torch.zeros((p, p), dtype=self.dtype, device=self.device)
        self._s = torch.zeros((p,), dtype=self.dtype, device=self.device)
        self._x0 = None   # shift point (the first batch's column means)
        self._n = 0

    def update(self, x) -> "GramAccumulator":
        # Screening a host array for NaN/inf is cheap, and a NaN batch
        # poisons the accumulated Gram for good (TC = nan after the fit);
        # a batch already on a device is taken as it is rather than forced
        # through a host read per batch, as Corex's own validation does.
        if isinstance(x, np.ndarray) and not np.isfinite(x).all():
            raise ValueError(
                "batch contains NaN/inf; clean it before accumulation "
                "(the accumulated Gram cannot be repaired afterwards)")
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
        x = torch.as_tensor(x).to(device=self.device, dtype=self.dtype)
        if self._x0 is None:
            # Accumulate around the first batch's mean (shifted data):
            # cov = G'/n − μ'μ'ᵀ with μ' = μ − x0 small, so the
            # subtraction does not cancel catastrophically in float32
            # (~1% TC drift without the shift when means dominate
            # variances).
            self._x0 = torch.mean(x, dim=0)
        _update_moments(self._g, self._s, x, self._x0)
        self._n += x.shape[0]
        return self

    @property
    def n_samples(self) -> int:
        return self._n

    def _moments(self):
        """(corr, mean, std) of everything accumulated so far."""
        if self._n < 2:
            raise ValueError("need at least 2 accumulated samples")
        corr, mean_shift, std = _finalize_corr(self._g, self._s,
                                               float(self._n))
        return corr, self._x0 + mean_shift, std

    def correlation(self):
        """The standardized p x p correlation matrix accumulated so far."""
        return self._moments()[0]

    def fit(self, n_hidden: int, **corex_kwargs) -> Corex:
        """Fit a Corex model from the accumulated moments (gram strategy),
        in the accumulator's dtype and on its device unless `corex_kwargs`
        say otherwise.

        Returns a fitted estimator whose transform/predict/get_covariance
        behave exactly as if fit on the concatenated data with
        gaussianize='standard'."""
        corr, mean, std = self._moments()
        _reject_missing_values(corex_kwargs, "GramAccumulator.fit")
        corex_kwargs.setdefault("dtype",
                                str(self.dtype).removeprefix("torch."))
        corex_kwargs.setdefault("device", str(self.device))
        model = Corex(n_hidden=n_hidden, gaussianize="standard",
                      **corex_kwargs)
        return _solve_from_moments(model, corr, mean, std, self._n)
