"""The `Corex` estimator of the PyTorch port: single-device fit and
inference.

Port of the single-device surface of `linearcorex_tpu/models/corex.py`:
the constructor surface (stored verbatim, validated at first use), the
'auto' resolution of the optimizer and of the chain kernel, the operand
modes (`matmul_dtype` 'float32', 'bfloat16', 'int8' with its wrap guard),
the seeded random and spectral inits, presets, the annealed fit on the
non-overlap and overlap objectives, the two-program `stage_subsample`
fit, the restart sweep (`n_restarts=k`: k lanes of one solve, the best
final TC kept), `partial_fit` (accumulated second moments, a warm-started
re-solve per batch), the native host route of 'empirical' preprocessing
for NumPy inputs on the CPU, `transform` (with `details=True`), `fit_transform`, the
serving methods (`predict`/`inverse_transform`, `get_covariance`,
`score`, `covariance_matvec`/`matmat`/`blocks`, all from the fitted
factor structure, never a p x p solve), the sklearn estimator protocol
and the fitted properties `tc`, `tcs`, `mis`, `clusters`, `history` and
`n_iter_`. sklearn and pandas are imported only where a method needs
them.

Differences by design:
- `device` (default "cuda") names where the fit runs. A CUDA device that
  is not there raises; nothing moves to the CPU behind the caller's back.
  `device="cpu"` runs the same code with the chain kernel's plain twin.
- The fit is a Python loop with one host read per iteration
  (`core.solver`), not one compiled program.
- `use_pallas='auto'` takes the CUDA chain kernel on a CUDA device for
  every non-overlap float32 fit the kernel supports, whatever the operand
  mode. The JAX package's m >= 128 gate was a TPU measurement and is not
  copied.

Options of the JAX package that are not ported yet (a mesh, the faster
`matmul_precision` values, AOT `warmup`) raise NotImplementedError, each
naming its ROADMAP.md queue item.
"""

from __future__ import annotations

import dataclasses
import inspect
import math
import numbers
import sys
import warnings
from typing import Optional

import numpy as np
import torch

from linearcorex_tpu_torch.config import (CorexConfig, PreprocessConfig,
                                          apply_preset)
from linearcorex_tpu_torch.core.solver import (FitDiagnostics, fit_core,
                                               sort_by_tcs)
from linearcorex_tpu_torch.ops import moments as M
from linearcorex_tpu_torch.ops import preprocessing as P
from linearcorex_tpu_torch.ops.cuda_moments import chain_supported
from linearcorex_tpu_torch.parallel import restarts as R

__all__ = ["Corex", "NotFittedError", "resolve_config", "resolve_optimizer"]


class NotFittedError(ValueError, AttributeError):
    """Inference was requested before `fit` (the same bases as
    `sklearn.exceptions.NotFittedError`). When sklearn is already
    imported, the raised exception is a subclass of both this class and
    sklearn's; sklearn is never imported for it."""


_dual_not_fitted_cls = None


def _raise_not_fitted(msg):
    global _dual_not_fitted_cls
    cls = NotFittedError
    if "sklearn" in sys.modules:
        if _dual_not_fitted_cls is None:
            from sklearn.exceptions import NotFittedError as _SkNFE

            class _DualNotFitted(NotFittedError, _SkNFE):
                pass

            _DualNotFitted.__name__ = "NotFittedError"
            _DualNotFitted.__qualname__ = "NotFittedError"
            _dual_not_fitted_cls = _DualNotFitted
        cls = _dual_not_fitted_cls
    raise cls(msg)


def _not_ported(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported to the PyTorch package yet (ROADMAP.md "
        f"Queue 1, {item}); the JAX package linearcorex_tpu supports it")


def _no_mesh(what: str, mesh, sharding_plan=None) -> None:
    if mesh is not None or sharding_plan is not None:
        _not_ported(f"{what}(mesh=..., sharding_plan=...)",
                    "item 17 (sharding)")


def check_ported(cfg: CorexConfig, mesh=None) -> None:
    """Raise NotImplementedError, by name, for an option of the JAX
    package that the port does not run yet."""
    _no_mesh("fit", mesh)
    if cfg.matmul_precision not in ("default", "highest"):
        _not_ported(f"matmul_precision={cfg.matmul_precision!r}",
                    "item 1 (config)")


def resolve_optimizer(cfg: CorexConfig, nv: int,
                      n_samples: Optional[int]) -> CorexConfig:
    """optimizer='auto' → 'fixed_point' when the problem is fully sampled
    (n_samples >= nv, so Σ̂ is full rank) on the non-overlap path, else
    'momentum' — the JAX package's policy.

    Also the JAX package's hazard check of stage_tol_factor under int8:
    a composed non-final stage tol that is large against the ~1/sqrt(p)
    scale of W's entries warns."""
    stage_tols = cfg.tol_schedule()
    if (len(stage_tols) > 1 and cfg.stage_tol_factor > 1.0
            and cfg.matmul_dtype == "int8"
            and max(stage_tols[:-1]) * np.sqrt(nv) >= 0.05):
        warnings.warn(
            f"stage_tol_factor={cfg.stage_tol_factor:g} with "
            f"matmul_dtype='int8' at p={nv}: the composed non-final "
            f"stage tol ({max(stage_tols[:-1]):g}) is large relative to "
            f"the ~1/sqrt(p) W-entry scale, and under int8 moment noise "
            f"the JAX package measured this to truncate annealing and "
            f"COLLAPSE TC at scale, where float32 holds TC at the same "
            f"composed tols. Use stage_tol_factor=1 with int8, or keep "
            f"the factor on the float32/bfloat16 path.")
    if cfg.optimizer != "auto":
        return cfg
    fp_ok = (cfg.discourage_overlap and n_samples is not None
             and n_samples >= nv)
    return dataclasses.replace(
        cfg, optimizer="fixed_point" if fp_ok else "momentum")


def resolve_config(cfg: CorexConfig, nv: int, device,
                   n_samples: Optional[int] = None) -> CorexConfig:
    """Resolve the 'auto' knobs against the device and the shapes.

    use_pallas='auto' → the CUDA chain kernel ('always') on a CUDA device
    when the path is non-overlap, the dtype is not float64 and
    `chain_supported(nv, n_hidden)` holds; 'never' otherwise (so a CPU
    fit runs the plain chain)."""
    cfg = resolve_optimizer(cfg, nv, n_samples)
    if cfg.use_pallas != "auto":
        return cfg
    ok = (torch.device(device).type == "cuda" and cfg.discourage_overlap
          and cfg.dtype != "float64" and chain_supported(nv, cfg.n_hidden))
    return dataclasses.replace(cfg, use_pallas="always" if ok else "never")


def chain_mode(cfg: CorexConfig) -> bool:
    """The chain_kernel flag ops.moments takes."""
    return cfg.use_pallas == "always"


def _make_obj_grad(data, cfg: CorexConfig, strategy: str):
    """Close the active objective/direction over the data (X or Σ). For
    optimizer='fixed_point' the returned "gradient" is the fixed-point
    residual ws − Ŵ, which the solver's plain-GD step turns into the
    damped update (1−γ)·ws + γ·Ŵ."""
    if cfg.optimizer == "auto":
        raise ValueError(
            "optimizer='auto' must be resolved against the data shapes "
            "before building the objective — call resolve_config(cfg, nv, "
            "device, n_samples=n) first (Corex.fit does)")
    if cfg.matmul_dtype == "int8" and not isinstance(data,
                                                     M.QuantizedData):
        # the int8 mode is carried by the operand (ops.moments dispatches
        # on QuantizedData); a plain tensor here would silently run f32
        raise ValueError(
            "matmul_dtype='int8' requires the quantized samples operand — "
            "pass M.quantize_samples(x) (Corex.fit does this)")
    if (cfg.stage_subsample < 1.0 and strategy == "samples"
            and subsample_stride(cfg.stage_subsample) > 1
            and len(cfg.anneal_schedule()) > 1):
        # one operand for the whole schedule cannot honor the staging:
        # Corex.fit realizes it in _fit_staged_subsample and hands the
        # pieces stage_subsample=1 configs
        raise ValueError(
            "stage_subsample < 1 reached a one-program solver loop, "
            "which runs the whole anneal schedule on one operand. Only "
            "Corex.fit implements the two-program subsampled staging — "
            "set stage_subsample=1 for other callers.")
    gram = strategy == "gram"
    if not cfg.discourage_overlap:
        # fixed_point + overlap is rejected by CorexConfig.__post_init__
        fn = M.overlap_obj_grad_gram if gram else M.overlap_obj_grad_samples
        return lambda ws, eps: fn(ws, data, eps, cfg.y_scale)
    bf16 = cfg.matmul_dtype == "bfloat16"
    chain = chain_mode(cfg)
    if cfg.optimizer == "fixed_point":
        fn = M.ns_fp_gram if gram else M.ns_fp_samples
    else:
        fn = M.ns_obj_grad_gram if gram else M.ns_obj_grad_samples
    return lambda ws, eps: fn(ws, data, eps, cfg.y_scale, cfg.rho_clip,
                              bf16=bf16, chain_kernel=chain)


def _fit_program(data, w0, cfg: CorexConfig, strategy: str):
    """The complete fit: annealed solve → final moments → factor sort.
    Returns (ws, Moments, FitDiagnostics). W0 of shape (k, m, p) fits k
    restart lanes and returns each with a leading lane axis."""
    with M.full_f32_matmul():
        ws, diag = fit_core(_make_obj_grad(data, cfg, strategy), w0, cfg)
        zero = torch.zeros((), dtype=w0.dtype, device=w0.device)
        if strategy == "gram":
            c_xy = M.cxy_gram(data, ws, zero)
        else:
            c_xy = M.cxy_samples(data, ws, zero)
        mom = M.moments_from_cxy(ws, c_xy, cfg.y_scale, cfg.rho_clip)
        ws_sorted, order = sort_by_tcs(ws, mom.tcs)
        return ws_sorted, M.permute_moments(mom, order), diag


def _spectral_init(data, omega, strategy: str, matmul_dtype: str):
    """Randomized range-finder init (init='spectral'): W₀ = Qᵀ with
    Q·R = Σ_emp·Ω for a random (p, m) block Ω, so the rows of W start
    spanning the top-m subspace of Σ̂. One Σ-application through the
    solver's own operator (any operand mode), then a thin QR."""
    apply = M._apply_sigma_t(data, matmul_dtype == "bfloat16",
                             strategy == "gram", omega.dtype)
    with M.full_f32_matmul():
        q, _ = torch.linalg.qr(apply(omega).to(omega.dtype))
    return q.T.contiguous()


def prepare_operand(xp, strategy: str, matmul_dtype: str):
    """The solver operand from preprocessed rows: X or its Gram matrix,
    cast to bf16 under matmul_dtype='bfloat16', or quantized with the
    int32 wrap guard under 'int8' (after preprocessing, whose
    standardized columns the per-tensor scale relies on)."""
    data = M.compute_gram(xp) if strategy == "gram" else xp
    if matmul_dtype == "bfloat16":
        return data.to(torch.bfloat16)
    if matmul_dtype == "int8":
        return M.quantize_samples(data)
    return data


def check_restart_sweep_supported(cfg: CorexConfig, strategy: str) -> None:
    """Reject configs a restart sweep cannot honor: the lanes run one
    solve over the whole anneal schedule, so the two-program
    stage_subsample fit has no sweep form."""
    if stage_subsample_active(cfg, strategy):
        raise ValueError(
            "stage_subsample < 1 is not supported with n_restarts > "
            "1: the restart sweep is one vmapped program over the "
            "whole anneal schedule. Set stage_subsample=1, or run "
            "the staged fits sequentially.")


def stage_subsample_active(cfg: CorexConfig, strategy: str) -> bool:
    """Whether the two-program stage-subsample fit applies: the config
    asks for it (stage_subsample < 1), the strategy is 'samples' (a Gram
    operand carries no sample axis: warned and ignored), the fraction
    drops rows (stride > 1: warned otherwise) and the schedule has a
    non-final stage to subsample."""
    if cfg.stage_subsample >= 1.0:
        return False
    if strategy != "samples":
        warnings.warn(
            f"stage_subsample={cfg.stage_subsample:g} is inert on the "
            f"gram moment strategy: the p x p operand carries no sample "
            f"axis (iteration cost is n-independent there). Use "
            f"moment_strategy='samples' — or drop the knob; the fit "
            f"proceeds on the full schedule unchanged.")
        return False
    if subsample_stride(cfg.stage_subsample) == 1:
        warnings.warn(
            f"stage_subsample={cfg.stage_subsample:g} rounds to row "
            f"stride 1 (fractions > 2/3 keep every row) — no actual "
            f"subsampling, so the staged two-program fit is skipped. "
            f"Use a fraction <= 2/3 (e.g. 0.5, 0.25) or drop the knob.")
        return False
    return len(cfg.anneal_schedule()) > 1


def subsample_stride(fraction: float) -> int:
    """Row stride k for stage_subsample: rows x[::k], k = round(1/f)."""
    return max(1, int(round(1.0 / float(fraction))))


def subsample_len(n: int, fraction: float) -> int:
    """len(x[::k]) for n rows."""
    return -(-int(n) // subsample_stride(fraction))


def _subsample_rows(data, fraction: float):
    """The non-final-stage operand: every k-th row (deterministic, no RNG),
    copied contiguous. QuantizedData keeps its per-tensor scale: the rows
    are a subset of the same standardized X."""
    k = subsample_stride(fraction)
    if k == 1:
        return data
    if isinstance(data, M.QuantizedData):
        return M.QuantizedData(q=data.q[::k].contiguous(), scale=data.scale)
    return data[::k].contiguous()


def _staged_subsample_cfgs(cfg: CorexConfig):
    """(prefix_cfg, final_cfg) for the two-program stage-subsample fit:
    the prefix runs anneal_schedule()[:-1] on the subsampled rows at the
    non-final stage tol; the final stage runs on the full data at `tol`.
    Both carry stage_subsample=1: the staging is realized by the operand
    choice, so the guard in _make_obj_grad must not trip on them."""
    sched = cfg.anneal_schedule()
    tols = cfg.tol_schedule()
    prefix = dataclasses.replace(cfg, eps_override=tuple(sched[:-1]),
                                 tol=tols[0], stage_tol_factor=1.0,
                                 stage_subsample=1.0)
    final = dataclasses.replace(cfg, eps_override=float(sched[-1]),
                                stage_tol_factor=1.0, stage_subsample=1.0)
    return prefix, final


def _fit_staged_subsample(data, w0, cfg: CorexConfig, strategy: str):
    """Stage-subsample fit: the non-final anneal stages on every k-th row
    (samples-path iteration cost is linear in n), the final stage on the
    full data. Each program ends with a factor sort by tcs, as in the JAX
    package (the float64 oracle mirrors the mid-sort). Returns (ws,
    Moments, FitDiagnostics) with both programs' per-stage diagnostics
    concatenated, so they cover the full schedule."""
    prefix_cfg, final_cfg = _staged_subsample_cfgs(cfg)
    n = (data.q if isinstance(data, M.QuantizedData) else data).shape[0]
    p = w0.shape[1]
    if cfg.optimizer == "fixed_point" and subsample_len(
            n, cfg.stage_subsample) < p <= n:
        warnings.warn(
            f"stage_subsample={cfg.stage_subsample:g}: the anneal-prefix "
            f"program runs on n_sub={subsample_len(n, cfg.stage_subsample)}"
            f" < p={p} rows with optimizer='fixed_point' — the prefix "
            f"selects the basin in the undersampled regime where "
            f"fixed_point is measured to commit to worse optima. Use "
            f"optimizer='momentum' (the undersampled-regime choice) or a "
            f"larger fraction.")
    data_sub = _subsample_rows(data, cfg.stage_subsample)
    ws1, _, d1 = _fit_program(data_sub, w0, prefix_cfg, strategy)
    ws, mom, d2 = _fit_program(data, ws1, final_cfg, strategy)
    diag = FitDiagnostics(*[torch.cat([a, b]) for a, b in zip(d1, d2)])
    return ws, mom, diag


def _ctor_defaults():
    """Constructor defaults of Corex.__init__, read from its signature."""
    return {k: v.default
            for k, v in inspect.signature(Corex.__init__).parameters.items()
            if v.default is not inspect.Parameter.empty}


# ---------------------------------------------------------------------------
# Serving: reconstruction, the factor-model covariance and its likelihood,
# from the fitted moments. Σ̂_std = diag(1 − Σ_j z_ji²) + ZᵀZ (unit diagonal)
# with Z = rhoinvrho/(1 + S_i) on the non-overlap path and Z = L⁻¹·C_xyᵀ,
# C_y = L·Lᵀ, on the overlap path; scaled back by the fitted std.
# ---------------------------------------------------------------------------

def _predict_ns(y, rhoinvrho, si, z2, theta):
    rec_w = (rhoinvrho.T / (1.0 + si)[:, None] / torch.sqrt(z2)[None, :])
    return P.invert(M._mm(y, rec_w.T), theta)


def _predict_overlap(y, cy, c_xy, theta):
    coef = torch.linalg.solve(cy, c_xy.T)
    return P.invert(M._mm(y, coef), theta)


def _unit_diag_scaled(cov, std):
    nv = cov.shape[0]
    cov = cov - torch.diag(torch.diagonal(cov)) + torch.eye(
        nv, dtype=cov.dtype, device=cov.device)
    return std[:, None] * std[None, :] * cov


def _factor_z_ns(rhoinvrho, si):
    """Z with Σ̂_std = diag(d) + ZᵀZ on the non-overlap path (shared by
    the covariance, `score` and the held-out scorer of `pick_n_hidden`)."""
    return rhoinvrho / (1.0 + si)[None, :]


def _factor_z_overlap(cy, c_xy):
    """Z for the overlap path: C_xy·C_y⁻¹·C_xyᵀ = ZᵀZ with Z = L⁻¹·C_xyᵀ,
    C_y = L·Lᵀ (NaN where C_y is not positive definite, as in JAX)."""
    return torch.linalg.solve_triangular(M._cholesky_or_nan(cy), c_xy.T,
                                         upper=False)


def _cov_ns(rhoinvrho, si, std):
    z = _factor_z_ns(rhoinvrho, si)
    return _unit_diag_scaled(M._mm(z.T, z), std)


def _cov_overlap(cy, c_xy, std):
    sol = torch.linalg.solve(cy, c_xy.T)
    return _unit_diag_scaled(M._mm(c_xy, sol), std)


def _matmat_ns(rhoinvrho, si, std, v):
    """Σ̂·V for V (p, k) on the non-overlap path; p x p never forms."""
    z = _factor_z_ns(rhoinvrho, si)
    sv = std[:, None] * v
    low = M._mm(z.T, M._mm(z, sv))
    diag = torch.sum(z * z, dim=0)
    return std[:, None] * (low + (1.0 - diag)[:, None] * sv)


def _matmat_overlap(cy, c_xy, std, v):
    """Σ̂·V for V (p, k) on the overlap path; p x p never forms."""
    sol = torch.linalg.solve(cy, c_xy.T)                   # m x p
    sv = std[:, None] * v
    low = M._mm(c_xy, M._mm(sol, sv))
    diag = torch.sum(c_xy * sol.T, dim=1)
    return std[:, None] * (low + (1.0 - diag)[:, None] * sv)


def _gaussian_ll(xp, z, std):
    """Mean Gaussian log-likelihood of preprocessed rows under Σ̂_std =
    diag(d) + ZᵀZ (d = 1 − Σ_j z_ji², the unit-diagonal completion),
    through Woodbury and the matrix determinant lemma: O(n·p·m + m³), the
    p x p never materializes. The `− Σ log std` term maps the density back
    through the affine standardization to the data's own scale."""
    p = xp.shape[1]
    mdim = z.shape[0]
    d = torch.clamp(1.0 - torch.sum(z * z, dim=0), min=1e-6)
    zd = z / d[None, :]
    a = torch.eye(mdim, dtype=z.dtype, device=z.device) + M._mm(zd, z.T)
    chol = M._cholesky_or_nan(a)
    logdet = torch.sum(torch.log(d)) + 2.0 * torch.sum(
        torch.log(torch.diagonal(chol)))
    t = xp / d[None, :]
    q1 = torch.sum(xp * t, dim=1)
    u = M._mm(t, z.T)                                        # n x m
    sol = torch.cholesky_solve(u.T, chol, upper=False)       # m x n
    q2 = torch.sum(u.T * sol, dim=0)
    log2pi = torch.log(torch.tensor(2.0 * math.pi, dtype=xp.dtype,
                                    device=xp.device))
    ll = -0.5 * (q1 - q2 + logdet + p * log2pi)
    return torch.mean(ll) - torch.sum(torch.log(std))


def _cov_rows(z, std, start: int, block: int):
    """Dense rows [start, start + block) of Σ̂ from Z, scaled back by
    std."""
    rows = M._mm(z[:, start:start + block].T, z)              # b x p
    idx = torch.arange(block, device=z.device)
    rows[idx, start + idx] = 1.0          # the unit-diagonal completion
    return std[start:start + block, None] * std[None, :] * rows


_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def torch_dtype(name: str) -> torch.dtype:
    """The compute dtype named by a `dtype=` argument."""
    if name not in _DTYPES:
        raise ValueError(f"dtype must be 'float32' or 'float64', got "
                         f"{name!r}")
    return _DTYPES[name]


def resolve_device(device) -> torch.device:
    """The device named by a `device=` argument: a CUDA device that is not
    there raises (nothing moves to the CPU behind the caller's back)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} but CUDA is not available; pass "
            f"device='cpu' to run the port on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be a CUDA device or 'cpu', got "
                         f"{device!r}")
    return dev


class Corex:
    """Linear CorEx estimator (the JAX package's surface, in PyTorch)."""

    def __init__(self, n_hidden=10, max_iter=10000, tol=1e-5, anneal=True,
                 missing_values=None, discourage_overlap=True,
                 gaussianize="standard", gpu=None, y_scale=1.0,
                 update_iter=10, pretrained_weights=None, verbose=False,
                 seed=None, dtype="float32", moment_strategy="auto",
                 record_history=True, matmul_dtype="float32",
                 use_pallas="auto", matmul_precision="default",
                 optimizer="momentum", momentum_beta=0.9, init="random",
                 preset="reference", stage_tol_factor=1.0,
                 stage_subsample=1.0, n_restarts=1, device="cuda"):
        # sklearn contract: store every argument verbatim; validation
        # happens at first use (the `config`/`pre_config` properties and
        # fit). `gpu` is accepted for API compatibility; `device` decides.
        self.n_hidden = n_hidden
        self.max_iter = max_iter
        self.tol = tol
        self.anneal = anneal
        self.missing_values = missing_values
        self.discourage_overlap = discourage_overlap
        self.gaussianize = gaussianize
        self.gpu = gpu
        self.y_scale = y_scale
        self.update_iter = update_iter
        self.pretrained_weights = pretrained_weights
        self.verbose = verbose
        self.seed = seed
        self.dtype = dtype
        self.moment_strategy = moment_strategy
        self.record_history = record_history
        self.matmul_dtype = matmul_dtype
        self.use_pallas = use_pallas
        self.matmul_precision = matmul_precision
        self.optimizer = optimizer
        self.momentum_beta = momentum_beta
        self.init = init
        self.preset = preset
        self.stage_tol_factor = stage_tol_factor
        self.stage_subsample = stage_subsample
        self.n_restarts = n_restarts
        self.device = device

    # Fitted state lives in private class-level defaults: an instance
    # carries no fitted attribute until fit (or corex_from_numpy) sets one
    # (sklearn's check_no_attributes_set_in_init and
    # check_dont_overwrite_parameters), and the public names are
    # properties over that storage.
    _ws: Optional[torch.Tensor] = None
    _theta: Optional[P.Theta] = None
    _moments: Optional[M.Moments] = None
    _diagnostics: Optional[FitDiagnostics] = None
    _nv: Optional[int] = None
    _n_samples: Optional[int] = None
    resolved_optimizer_: Optional[str] = None
    # the restart lane the last fit kept (0 for a single fit)
    best_restart_: Optional[int] = None
    # warm-start weights held apart from fitted state (a repeated fit is
    # fresh; corex_from_numpy re-arms this so a later fit warm-starts)
    _pretrained_ws: Optional[torch.Tensor] = None
    # the GramAccumulator of a partial_fit stream (fit drops it)
    _partial_acc = None

    ws = property(lambda self: self._ws,
                  lambda self, v: setattr(self, "_ws", v),
                  doc="Fitted (m, p) weight matrix (None before fit).")
    theta = property(lambda self: self._theta,
                     lambda self, v: setattr(self, "_theta", v),
                     doc="Preprocessing parameters (None before fit).")
    moments = property(lambda self: self._moments,
                       lambda self, v: setattr(self, "_moments", v),
                       doc="Fitted moments (None before fit).")
    diagnostics = property(
        lambda self: self._diagnostics,
        lambda self, v: setattr(self, "_diagnostics", v),
        doc="Per-stage FitDiagnostics (None before fit).")
    nv = property(lambda self: self._nv,
                  lambda self, v: setattr(self, "_nv", v),
                  doc="Fitted n_variables (None before fit).")
    n_samples = property(
        lambda self: self._n_samples,
        lambda self, v: setattr(self, "_n_samples", v),
        doc="n_samples of the last fit (None before fit).")

    # ------------------------------------------------------------------
    @property
    def config(self) -> CorexConfig:
        """The solver config derived from the current hyperparameters,
        with `preset` resolution: a preset supplies defaults, and any
        parameter set to a non-default value wins."""
        raw = dict(
            n_hidden=self.n_hidden, max_iter=self.max_iter, tol=self.tol,
            anneal=self.anneal, discourage_overlap=self.discourage_overlap,
            y_scale=self.y_scale, dtype=self.dtype,
            moment_strategy=self.moment_strategy,
            record_history=self.record_history,
            matmul_dtype=self.matmul_dtype, use_pallas=self.use_pallas,
            matmul_precision=self.matmul_precision,
            optimizer=self.optimizer, momentum_beta=self.momentum_beta,
            init=self.init, stage_tol_factor=self.stage_tol_factor,
            stage_subsample=self.stage_subsample)
        defaults = _ctor_defaults()
        user_set = {}
        for name, val in raw.items():
            try:
                changed = bool(val != defaults[name])
            except (ValueError, TypeError):
                changed = True   # array-valued: CorexConfig raises
            if changed:
                user_set[name] = val
        return CorexConfig(**{**raw, **apply_preset(self.preset, user_set)})

    @property
    def pre_config(self) -> PreprocessConfig:
        return PreprocessConfig(gaussianize=self.gaussianize,
                                missing_values=self.missing_values)

    @property
    def m(self) -> int:
        """Alias for n_hidden (the solver's factor-axis size)."""
        return self.n_hidden

    @property
    def _dt(self) -> torch.dtype:
        return torch_dtype(self.config.dtype)

    @property
    def _device(self) -> torch.device:
        return resolve_device(self.device)

    def _init_ws(self, p: int) -> torch.Tensor:
        """N(0, 1/sqrt(p)) init. Seeded: NumPy's RandomState, so a seed
        gives the same W0 as the JAX package and the float64 oracle.
        Unseeded: drawn on the device from fresh entropy."""
        if self.seed is None:
            gen = torch.Generator(device=self._device)
            gen.seed()
            return torch.randn((self.m, p), generator=gen, dtype=self._dt,
                               device=self._device) / float(np.sqrt(p))
        rng = np.random.RandomState(self.seed)
        w = rng.normal(loc=0.0, scale=1.0 / np.sqrt(p), size=(self.m, p))
        return torch.as_tensor(w, dtype=self._dt, device=self._device)

    @staticmethod
    def _coerce_2d(x, what="x"):
        """Shared input coercion: reject sparse input by name, densify
        array-likes (lists, DataFrames) with np.asarray, require 2-D and
        real values. Tensors stay tensors."""
        if hasattr(x, "toarray") and hasattr(x, "tocsr"):
            raise TypeError(
                f"sparse input is not supported: densify {what} first "
                f"(e.g. X.toarray())")
        if not isinstance(x, torch.Tensor):
            x = np.asarray(x)
        if x.ndim != 2:
            raise ValueError(
                f"expected a 2-D (n_samples, n_variables) array for "
                f"{what}, got shape {tuple(x.shape)}. Reshape your data "
                f"to 2-D (samples in rows).")
        if (x.is_complex() if isinstance(x, torch.Tensor)
                else np.iscomplexobj(x)):
            raise ValueError(
                f"Complex data not supported: {what} must be real-valued")
        if isinstance(x, np.ndarray) and x.dtype == object:
            # numeric object arrays densify; strings raise numpy's
            # could-not-convert ValueError
            x = x.astype(np.float64)
        return x

    def _to_tensor(self, x, what="x") -> torch.Tensor:
        """Coerce input to a 2-D real tensor of the model dtype on the
        model device."""
        return self._as_tensor(self._validate_input(x, what))

    def _validate_input(self, x, what="x"):
        """`_coerce_2d`, then the checks every entry point shares: finite
        host values (unless a missing-value marker is set) and at least
        one column. Returns the coerced array or tensor as it is."""
        x = self._coerce_2d(x, what)
        if isinstance(x, np.ndarray) and self.pre_config.missing_values \
                is None and not np.isfinite(x).all():
            raise ValueError(
                f"{what} contains NaN/inf; pass missing_values="
                f"<sentinel> after encoding missing entries, or clean "
                f"the data first")
        if x.shape[1] == 0:
            raise ValueError(
                f"0 feature(s) (shape={tuple(x.shape)}) while a minimum of "
                f"1 is required.")
        return x

    def _check_width(self, x, what="x") -> torch.Tensor:
        """`_to_tensor`, then the fitted width."""
        x = self._to_tensor(x, what)
        if x.shape[1] != self.nv:
            raise ValueError(
                f"{what} must be 2-D with {self.nv} columns (the fitted "
                f"n_variables); got shape {tuple(x.shape)}")
        return x

    def _as_tensor(self, a) -> torch.Tensor:
        """`a` (tensor or array-like) in the model dtype on the model
        device."""
        if not isinstance(a, torch.Tensor):
            a = np.asarray(a)
        return torch.as_tensor(a, dtype=self._dt, device=self._device)

    def _host_preprocess(self, x):
        """The native host route of 'empirical' gaussianization for NumPy
        inputs (`csrc/gaussianize.cpp` through `utils.native`): returns
        (x_preprocessed, theta) on the model device, equal to the torch
        route to double precision, or None where it does not apply (another
        mode, a tensor input, no host library, or a CUDA model).

        It applies on `device="cpu"` only. On a CUDA device the torch
        route (one device sort and two binary searches per column) is the
        faster of the two by a wide margin at n = p = 10,000 on an H100
        (`chip_smoke.py` phase `native` times both; PERF.md), so the rows
        go to the card and are ranked there."""
        pre = self.pre_config
        if pre.gaussianize != "empirical" or not isinstance(x, np.ndarray) \
                or self._device.type != "cpu":
            return None
        from linearcorex_tpu_torch.utils import native
        if not native.available():
            return None
        xh = np.asarray(x, dtype=np.float64)
        if pre.missing_values is not None:
            xh = native.mean_impute(xh, pre.missing_values)
        std = xh.std(0)
        theta = P.Theta(mean=self._as_tensor(xh.mean(0)),
                        std=self._as_tensor(np.where(std < 1e-10, 1.0, std)))
        return self._as_tensor(native.empirical_gaussianize(xh)), theta

    def _prepare_fit(self, x):
        """Input validation, preprocessing (sets theta/nv/n_samples),
        moment-strategy choice and 'auto' resolution. Returns (data, cfg,
        strategy) with data the solver operand: X or the Gram matrix,
        cast to bf16 under matmul_dtype='bfloat16' or quantized (after
        preprocessing, whose standardized columns the per-tensor scale
        relies on, and checked by the int32 wrap guard) under 'int8'.
        A full fit is fresh: it drops any `partial_fit` accumulation."""
        self._partial_acc = None
        x = self._validate_input(x)
        self.n_samples, self.nv = x.shape
        if self.n_samples < 2:
            raise ValueError(f"need at least 2 samples to fit, got "
                             f"n_samples={self.n_samples}")
        if self.nv < self.m:
            warnings.warn(
                f"n_hidden={self.m} exceeds n_variables={self.nv}; "
                f"surplus factors will converge to zero TC")
        strategy = self.config.pick_strategy(self.n_samples, self.nv)
        cfg = resolve_config(self.config, self.nv, self._device,
                             n_samples=self.n_samples)
        self.resolved_optimizer_ = cfg.optimizer
        pre = self.pre_config
        host = self._host_preprocess(x)
        if host is not None:
            xp, self.theta = host
        else:
            xp, self.theta = P.fit_preprocess(
                self._as_tensor(x), pre.gaussianize, pre.missing_values)
        return prepare_operand(xp, strategy, cfg.matmul_dtype), cfg, strategy

    def _resolve_w0(self, init_ws, data=None, strategy=None) -> torch.Tensor:
        """Initial weights: explicit init_ws > shape-matching pretrained
        weights > a fresh init per config.init ('random', or 'spectral',
        which needs the prepared operand, so fit passes (data,
        strategy))."""
        if init_ws is not None:
            w0 = self._as_tensor(init_ws)
            if tuple(w0.shape) != (self.m, self.nv):
                raise ValueError(
                    f"init_ws shape {tuple(w0.shape)} does not match "
                    f"(n_hidden, n_variables)=({self.m}, {self.nv})")
            return w0
        pre = self._pretrained_ws if self._pretrained_ws is not None \
            else self.pretrained_weights
        if pre is not None:
            pre = self._as_tensor(pre)
            if tuple(pre.shape) == (self.m, self.nv):
                return pre
        if self.config.init == "spectral" and data is not None:
            return _spectral_init(data, self._omega(self.seed), strategy,
                                  self.config.matmul_dtype)
        return self._init_ws(self.nv)

    def _omega(self, seed):
        """The spectral init's random (p, m) block Ω. It follows the
        random init's seeding: seeded → NumPy RandomState(seed) (the JAX
        package's Ω), unseeded → the device generator, fresh entropy."""
        if seed is None:
            gen = torch.Generator(device=self._device)
            gen.seed()
            return torch.randn((self.nv, self.m), generator=gen,
                               dtype=self._dt, device=self._device)
        return self._as_tensor(np.random.RandomState(seed).normal(
            size=(self.nv, self.m)))

    def _validated_restarts(self, init_ws) -> int:
        """Validate `n_restarts` at first use (stored verbatim by __init__
        and set_params) and reject the combinations a restart sweep cannot
        honor, by name."""
        r = self.n_restarts
        if not isinstance(r, numbers.Integral) or isinstance(r, bool) \
                or r < 1:
            raise ValueError(
                f"n_restarts must be an integer >= 1, got {r!r}")
        r = int(r)
        if r == 1:
            return 1
        if init_ws is not None or self._pretrained_ws is not None \
                or self.pretrained_weights is not None:
            raise ValueError(
                "n_restarts > 1 with an explicit warm start (init_ws / "
                "pretrained_weights / load_corex) would run identical "
                "lanes — every restart starts from the same W0. Drop the "
                "warm start, or set n_restarts=1.")
        return r

    def _spectral_restart_inits(self, data, strategy, restarts):
        """Per-lane spectral inits: lane r draws Ω from RandomState(seed +
        r) (seeded) or from the device generator seeded with base + r
        (unseeded), so lane 0 of a seeded sweep is the plain spectral fit's
        W0 and preset='throughput' composes with restarts."""
        base = R.seed_base(self.seed)
        outs = []
        for r in range(restarts):
            if self.seed is None:
                gen = torch.Generator(device=self._device).manual_seed(
                    base + r)
                omega = torch.randn((self.nv, self.m), generator=gen,
                                    dtype=self._dt, device=self._device)
            else:
                omega = self._omega(base + r)
            outs.append(_spectral_init(data, omega, strategy,
                                       self.config.matmul_dtype))
        return torch.stack(outs)

    def _fit_restart_sweep(self, data, cfg, strategy, restarts):
        """n_restarts > 1: the lanes run as one solve and the best final
        TC wins (`best_restart_` records the lane). Lane r starts from
        RandomState(seed + r), so lane 0 is the plain Corex(seed=seed) fit
        and the sweep is reproducible; seed=None draws a fresh base per
        call (`parallel.restarts.init_restarts`)."""
        check_restart_sweep_supported(cfg, strategy)
        run = R.restart_batch_runner(None)
        with R.lane_oom_guidance(restarts, self.m, self.nv,
                                 torch.empty((), dtype=self._dt)
                                 .element_size()):
            if cfg.init == "spectral":
                w0 = self._spectral_restart_inits(data, strategy, restarts)
            else:
                w0 = R.init_restarts(restarts, self.m, self.nv, self.seed,
                                     self._dt, self._device)
            ws_b, mom_b, diag_b = run(data, w0, cfg, strategy,
                                      self.n_samples)
            self.ws, self.moments, self.diagnostics, best = \
                R.best_restart(ws_b, mom_b, diag_b)
        self.best_restart_ = best
        if self.verbose:
            self._print_verbose()
        return self

    def fit(self, x, y=None, init_ws=None, mesh=None, sharding_plan=None):
        """Fit the model. `y` is ignored (unsupervised; accepted for
        sklearn Pipelines). `mesh`/`sharding_plan` belong to the JAX
        package's sharded fit and raise NotImplementedError here.

        With `n_restarts=k > 1` the fit runs k seeded lanes as one solve
        and keeps the best final TC (`_fit_restart_sweep`); init='spectral'
        sweeps draw one Ω per lane. A warm start or stage_subsample < 1
        with restarts raises by name."""
        ysh = getattr(y, "shape", None)
        xsh = getattr(x, "shape", None)
        if (ysh is not None and len(ysh) == 2 and init_ws is None
                and xsh is not None and len(xsh) == 2
                and tuple(ysh) == (self.n_hidden, xsh[1])
                and ysh[0] != xsh[0]):
            raise TypeError(
                f"fit() received a 2-D y of shape {tuple(ysh)} == "
                f"(n_hidden, n_variables) — pass initial weights as "
                f"fit(x, init_ws=...); y is the ignored sklearn target")
        del y
        restarts = self._validated_restarts(init_ws)
        _no_mesh("fit", mesh, sharding_plan)
        check_ported(self.config)
        data, cfg, strategy = self._prepare_fit(x)
        if restarts > 1:
            return self._fit_restart_sweep(data, cfg, strategy, restarts)
        w0 = self._resolve_w0(init_ws, data=data, strategy=strategy)
        fit = _fit_staged_subsample if stage_subsample_active(
            cfg, strategy) else _fit_program
        self.ws, self.moments, self.diagnostics = fit(data, w0, cfg,
                                                      strategy)
        self.best_restart_ = 0
        if self.verbose:
            self._print_verbose()
        return self

    def _print_verbose(self):
        """One TC line every `update_iter` iterations plus a per-stage
        summary, printed from the diagnostics after the fit."""
        d = self.diagnostics
        iters = d.iters_per_stage.tolist()
        tcs = d.tc_per_stage.tolist()
        deltas = d.delta_per_stage.tolist()
        hist = d.tc_history.cpu().numpy()
        step = max(1, int(self.update_iter))
        for s, eps in enumerate(d.eps_schedule.tolist()):
            k = int(iters[s])
            if hist.shape[1]:
                for i in range(step - 1, k, step):
                    print(f"eps={eps:.4f} iter={i + 1} TC={hist[s, i]:.6f}")
            print(f"eps: {eps:.4f}, iterations: {k}, TC: {tcs[s]:.6f}, "
                  f"delta: {deltas[s]:.2e}")

    # ------------------------------------------------------------------
    def fit_transform(self, x, y=None, mesh=None, sharding_plan=None):
        """fit, then transform the same rows (sklearn Pipelines call it
        with y positionally; it is ignored)."""
        del y
        self.fit(x, mesh=mesh, sharding_plan=sharding_plan)
        return self.transform(x)

    def _check_fitted(self):
        if self.ws is None or self.moments is None:
            _raise_not_fitted(
                "this Corex instance is not fitted yet; call fit(X) first")

    def transform(self, x, details=False, mesh=None, sharding_plan=None):
        """Project to factors: Y = X_preproc·Wᵀ. With details=True returns
        (Y, moments dict) with the moments of the given data under the
        fitted weights (the reference's keys). Under
        set_output(transform='pandas') the plain return is a DataFrame."""
        _no_mesh("transform", mesh, sharding_plan)
        self._check_fitted()
        x_orig = x
        x = self._check_width(x)
        pre = self.pre_config
        cfg = self.config
        with M.full_f32_matmul():
            xp = P.preprocess(x, pre.gaussianize, self.theta,
                              pre.missing_values)
            y = M._mm(xp, self.ws.T)
            if not details:
                return self._maybe_wrap_output(y, x_orig)
            zero = torch.zeros((), dtype=self.ws.dtype, device=x.device)
            c_xy = M.cxy_samples(xp, self.ws, zero)
            mom = M.moments_from_cxy(self.ws, c_xy, cfg.y_scale,
                                     cfg.rho_clip)
        return y, mom.asdict()

    def predict(self, y, mesh=None, sharding_plan=None):
        """Reconstruct variables from factors: the posterior-mean
        reconstruction, then the preprocessing inverted. The argument is
        the FACTOR matrix (n, m) from `transform` (the reference's
        semantics); `inverse_transform` is the sklearn spelling."""
        _no_mesh("predict", mesh, sharding_plan)
        self._check_fitted()
        y = self._coerce_2d(y, what="y")
        # the FITTED factor count: set_params(n_hidden=...) after fit must
        # not make the fitted factors un-predictable
        m_fit = self.ws.shape[0]
        if y.shape[1] != m_fit:
            raise ValueError(
                f"y must be 2-D with {m_fit} columns (the fitted "
                f"n_hidden); got shape {tuple(y.shape)}")
        if isinstance(y, np.ndarray) and not np.isfinite(y).all():
            raise ValueError(
                "factor input to predict contains NaN/inf")
        y = self._as_tensor(y)
        mom = self.moments
        with M.full_f32_matmul():
            if self.config.discourage_overlap:
                return _predict_ns(y, mom.rhoinvrho, mom.si, mom.z2,
                                   self.theta)
            return _predict_overlap(y, mom.cy, mom.c_xy, self.theta)

    def inverse_transform(self, y, mesh=None, sharding_plan=None):
        """sklearn spelling of `predict`: factors (n, m) back to the
        variable space (n, p)."""
        return self.predict(y, mesh=mesh, sharding_plan=sharding_plan)

    def get_covariance(self):
        """Dense p x p factor-model covariance estimate. For large p prefer
        `covariance_matvec`/`matmat`/`blocks`, which never materialize
        it."""
        self._check_fitted()
        mom = self.moments
        with M.full_f32_matmul():
            if self.config.discourage_overlap:
                return _cov_ns(mom.rhoinvrho, mom.si, self.theta.std)
            return _cov_overlap(mom.cy, mom.c_xy, self.theta.std)

    def score(self, x, y=None, mesh=None, sharding_plan=None):
        """Mean Gaussian log-likelihood of `x` under the fitted factor
        covariance (the sklearn scoring convention: higher is better; `y`
        is ignored). Woodbury on the diagonal-plus-low-rank Σ̂: O(n·p·m),
        the p x p never materializes. Only the affine gaussianize modes
        ('none', 'standard') carry a density back to the data's scale."""
        del y
        _no_mesh("score", mesh, sharding_plan)
        self._check_fitted()
        pre = self.pre_config
        if pre.gaussianize not in ("none", "standard"):
            raise ValueError(
                "score() requires gaussianize='none' or 'standard': the "
                "'empirical'/'outliers' transforms are non-affine, so a "
                "density on the original scale is not defined by Σ̂ alone")
        x = self._check_width(x)
        with M.full_f32_matmul():
            xp = P.preprocess(x, pre.gaussianize, self.theta,
                              pre.missing_values)
            return _gaussian_ll(xp, self._factor_z(), self.theta.std)

    def _covariance_apply(self, v):
        mom = self.moments
        v = self._as_tensor(v)
        with M.full_f32_matmul():
            if self.config.discourage_overlap:
                return _matmat_ns(mom.rhoinvrho, mom.si, self.theta.std, v)
            return _matmat_overlap(mom.cy, mom.c_xy, self.theta.std, v)

    def covariance_matvec(self, v, mesh=None, sharding_plan=None):
        """Σ̂·v through skinny products (the p x p never forms); equal to
        `get_covariance() @ v` to rounding on both solver paths."""
        _no_mesh("covariance_matvec", mesh, sharding_plan)
        self._check_fitted()
        if not hasattr(v, "ndim"):
            v = np.asarray(v)
        if v.ndim != 1 or v.shape[0] != self.nv:
            raise ValueError(
                f"v must be 1-D with {self.nv} entries (the fitted "
                f"n_variables); got shape {tuple(v.shape)} — use "
                f"covariance_matmat for (p, k) blocks")
        return self._covariance_apply(v[:, None])[:, 0]

    def covariance_matmat(self, v, mesh=None, sharding_plan=None):
        """Σ̂·V for a (p, k) block of vectors in one pass of skinny
        products."""
        _no_mesh("covariance_matmat", mesh, sharding_plan)
        self._check_fitted()
        if not hasattr(v, "ndim"):
            v = np.asarray(v)
        if v.ndim != 2 or v.shape[0] != self.nv:
            raise ValueError(
                f"v must be 2-D with {self.nv} rows (the fitted "
                f"n_variables); got shape {tuple(v.shape)}")
        return self._covariance_apply(v)

    def _factor_z(self):
        """The covariance factorization Z (m x p) of either solver path:
        Σ̂_std has off-diagonal ZᵀZ and unit diagonal."""
        mom = self.moments
        if self.config.discourage_overlap:
            return _factor_z_ns(mom.rhoinvrho, mom.si)
        return _factor_z_overlap(mom.cy, mom.c_xy)

    def covariance_blocks(self, block_size: int = 4096, mesh=None,
                          sharding_plan=None):
        """Yield `(start, rows)` dense row blocks of `get_covariance()`,
        in order over [0, p), without forming the p x p matrix; `rows` has
        shape (min(block_size, p - start), p). Every block is computed at
        one size (the last as the tail of a full block)."""
        _no_mesh("covariance_blocks", mesh, sharding_plan)
        self._check_fitted()
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        p = self.nv
        b = min(block_size, p)
        with M.full_f32_matmul():
            z = self._factor_z()
        start = 0
        while start < p:
            s = min(start, p - b)
            with M.full_f32_matmul():
                rows = _cov_rows(z, self.theta.std, s, b)
            yield start, rows[start - s:]
            start = s + b

    @property
    def n_iter_(self) -> int:
        """Total solver iterations of the last fit (summed over stages)."""
        if self.diagnostics is None:
            raise AttributeError(
                "n_iter_ is not available: this Corex instance is not "
                "fitted yet")
        return int(self.diagnostics.iters_per_stage.sum())

    @property
    def tcs(self) -> torch.Tensor:
        """Per-factor total correlation (sorted decreasing)."""
        return self.moments.tcs

    @property
    def tc(self) -> float:
        return float(torch.sum(self.moments.tcs))

    @property
    def mis(self) -> torch.Tensor:
        """MI matrix I(x_i; y_j), shape (m, p)."""
        return self.moments.mi

    @property
    def clusters(self) -> torch.Tensor:
        """Hard assignment of each variable to argmax_j I(x_i; y_j)."""
        return torch.argmax(self.moments.mi, dim=0)

    @property
    def history(self) -> dict:
        """Reference-style history dict built from the fit diagnostics."""
        if self.diagnostics is None:
            raise RuntimeError(
                "no fit diagnostics available; call fit(X) first")
        d = self.diagnostics
        iters = d.iters_per_stage.cpu().numpy()
        out = {"iters_per_stage": iters, "TC": [], "eps": []}
        hist = d.tc_history.cpu().numpy()
        for s, eps in enumerate(d.eps_schedule.tolist()):
            k = int(iters[s])
            if hist.shape[1]:
                out["TC"].extend(hist[s, :k].tolist())
                out["eps"].extend([eps] * k)
        return out

    # -- the sklearn estimator protocol ---------------------------------
    def get_params(self, deep=True):
        """Every constructor argument, verbatim (the attribute is the
        parameter, so sklearn's `clone` checks hold)."""
        return {k: getattr(self, k) for k in _ctor_defaults()}

    def set_params(self, **params):
        """Update hyperparameters in place; fitted state is kept and
        values are validated at first use, as in __init__."""
        names = _ctor_defaults()
        for k in params:
            if k not in names:
                raise ValueError(f"invalid parameter {k!r} for Corex")
        for k, v in params.items():
            setattr(self, k, v)
        return self

    def __sklearn_tags__(self):
        """sklearn >= 1.6 estimator tags: an unsupervised 2-D transformer;
        allow_nan when the missing marker is NaN. sklearn is imported here
        only, where sklearn itself asks."""
        from sklearn.utils import (InputTags, Tags, TargetTags,
                                   TransformerTags)
        mv = self.missing_values
        return Tags(
            estimator_type="transformer",
            target_tags=TargetTags(required=False),
            transformer_tags=TransformerTags(preserves_dtype=[]),
            input_tags=InputTags(two_d_array=True,
                                 allow_nan=mv is not None and mv != mv),
            non_deterministic=self.seed is None,
        )

    def __sklearn_is_fitted__(self):
        return self.ws is not None and self.moments is not None

    @property
    def n_features_in_(self):
        """The fitted input width (== `nv`), sklearn's name."""
        if self.nv is None:
            raise AttributeError(
                "n_features_in_ is not available: this Corex instance is "
                "not fitted yet")
        return self.nv

    def get_feature_names_out(self, input_features=None):
        """Names of the transform outputs, one per FITTED factor:
        `corex0`..`corex{m-1}`. `input_features`, when given, must have
        the fitted width."""
        self._check_fitted()
        if input_features is not None \
                and len(input_features) != self.nv:
            raise ValueError(
                f"input_features should have length equal to "
                f"n_features_in_ ({self.nv}), got {len(input_features)}")
        return np.asarray([f"corex{i}" for i in range(self.ws.shape[0])],
                          dtype=object)

    def set_output(self, *, transform=None):
        """sklearn's set_output API: transform='pandas' makes `transform`
        and `fit_transform` return a DataFrame with
        `get_feature_names_out` columns (the index of a DataFrame input
        kept); 'default' restores tensors; None changes nothing."""
        if transform is None:
            return self
        if transform not in ("default", "pandas"):
            raise ValueError(
                f"set_output transform must be 'default' or 'pandas', "
                f"got {transform!r}")
        self._output_transform = None if transform == "default" \
            else transform
        return self

    def _maybe_wrap_output(self, z, x_orig):
        if getattr(self, "_output_transform", None) != "pandas":
            return z
        import pandas as pd
        index = x_orig.index if hasattr(x_orig, "index") \
            and hasattr(x_orig, "columns") else None
        return pd.DataFrame(z.cpu().numpy(),
                            columns=self.get_feature_names_out(),
                            index=index)

    # ------------------------------------------------------------------
    def partial_fit(self, x, y=None, mesh=None, sharding_plan=None):
        """Incremental fit over row batches (the sklearn out-of-core
        convention, e.g. IncrementalPCA): each call folds the batch into
        an accumulated second-moment state (`utils.streaming.
        GramAccumulator`: one product per batch, X never held) on the
        model device and re-solves from the accumulated correlation,
        warm-started from the current weights, so the estimator is usable
        after every call. `fit` resets the accumulation; `partial_fit`
        continues it. `y` is ignored; `mesh`/`sharding_plan` belong to the
        JAX package's sharded accumulation and raise NotImplementedError.

        Equivalent to `fit(concat(batches))` with gaussianize='standard'
        up to the W init (identical accumulated moments; the warm start
        only changes the solver trajectory). Cost: one warm-started solve
        per call; to accumulate once and solve once use `GramAccumulator`
        or `fit_csv`, which this method wraps.

        Named errors: gaussianize must be 'standard' (rank-based
        'empirical' needs all data at once), missing_values is not
        supported (mean-imputation needs the full sample matrix),
        moment_strategy='samples' contradicts fitting from accumulated
        moments, and n_restarts > 1 has no fresh inits to draw. Batches
        may have any row count >= 1; the first solve needs >= 2
        accumulated samples."""
        del y
        from linearcorex_tpu_torch.utils.streaming import (
            GramAccumulator, _no_stream_mesh, _solve_from_moments)
        _no_stream_mesh("partial_fit", mesh, sharding_plan)
        pre = self.pre_config
        if pre.gaussianize != "standard":
            raise ValueError(
                f"partial_fit accumulates second moments in one streaming "
                f"pass, which only gaussianize='standard' semantics "
                f"permit (got {pre.gaussianize!r}; rank-based 'empirical' "
                f"needs all data at once)")
        if pre.missing_values is not None:
            raise ValueError(
                "partial_fit fits from accumulated second moments and "
                "cannot mean-impute missing_values (imputation needs the "
                "full sample matrix); impute each batch before the call, "
                "or use Corex.fit on the full data")
        if self.config.moment_strategy == "samples":
            raise ValueError(
                "partial_fit solves from the accumulated correlation "
                "matrix (gram strategy); moment_strategy='samples' "
                "contradicts that — use 'auto' or 'gram'")
        if self._validated_restarts(None) != 1:
            raise ValueError(
                "n_restarts > 1 is not supported by partial_fit: each "
                "call warm-starts from the current weights, so restart "
                "lanes have no fresh seeded inits to draw. Set "
                "n_restarts=1, or run Corex(n_restarts=k).fit on the "
                "full data.")
        check_ported(self.config)
        x = self._validate_input(x)        # batches of >= 1 row are legal
        acc = self._partial_acc
        expect = acc.p if acc is not None else self.nv
        if expect is not None and x.shape[1] != expect:
            # a width change mid-stream, or a new stream on an estimator
            # fitted on data of another width: refitting from scratch
            # would absorb a wrong-dataset fault
            raise ValueError(
                f"partial_fit batch has {x.shape[1]} variables; the "
                f"{'accumulated' if acc is not None else 'fitted'} state "
                f"has {expect} (use a fresh estimator — sklearn.clone — "
                f"to change the width)")
        if acc is None:
            acc = GramAccumulator(x.shape[1], dtype=self.config.dtype,
                                  device=self._device)
        # host arrays were screened for NaN/inf above: hand the
        # accumulator a tensor, so update() does not scan them again
        acc.update(self._as_tensor(x))
        self._partial_acc = acc   # commit before solving: the batch is
        #                           folded in even if this call cannot
        #                           solve yet (one sample, below)
        if acc.n_samples < 2:
            warnings.warn(
                "partial_fit has accumulated a single sample; the first "
                "solve needs >= 2. The batch is retained — the next "
                "partial_fit call will fit.")
            return self
        warm = self.ws
        if warm is not None and tuple(warm.shape) != (self.m, acc.p):
            warm = None   # stale shape (n_hidden changed via set_params)
        corr, mean, std = acc._moments()
        _solve_from_moments(self, corr, mean, std, acc.n_samples,
                            init_ws=warm)
        if self.verbose:
            self._print_verbose()
        return self

    def warmup(self, *args, **kwargs):
        """Ahead-of-time compilation of the JAX package's XLA programs:
        the port runs eagerly and has nothing to compile ahead."""
        raise NotImplementedError(
            "warmup compiles the JAX package's XLA programs ahead of time; "
            "the PyTorch port runs eagerly, with no compiled program to "
            "warm (ROADMAP.md: utils/compile_cache.py is not ported)")

    def __repr__(self):
        fitted = "" if self.ws is None else (
            f", fitted: nv={self.nv}, n_samples={self.n_samples}, "
            f"tc={self.tc:.4f}")
        return (f"Corex(n_hidden={self.n_hidden}, "
                f"discourage_overlap={self.discourage_overlap}, "
                f"gaussianize={self.gaussianize!r}, "
                f"optimizer={self.optimizer!r}, dtype={self.dtype!r}, "
                f"device={self.device!r}{fitted})")

