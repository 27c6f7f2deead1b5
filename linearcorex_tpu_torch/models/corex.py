"""The `Corex` estimator of the PyTorch port: single-device fit and
inference.

Port of the single-device fit of `linearcorex_tpu/models/corex.py`: the
constructor surface (stored verbatim, validated at first use), the 'auto'
resolution of the optimizer and of the chain kernel, the operand modes
(`matmul_dtype` 'float32', 'bfloat16', 'int8' with its wrap guard), the
seeded random and spectral inits, presets, the annealed fit on the
non-overlap and overlap objectives, the two-program `stage_subsample`
fit, `transform` (with `details=True`) and the fitted properties `tc`,
`tcs`, `mis`, `clusters`, `history` and `n_iter_`.

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

Options of the JAX package that are not ported yet (restarts, a mesh,
the faster `matmul_precision` values) raise NotImplementedError at fit,
each naming its ROADMAP.md queue item.
"""

from __future__ import annotations

import dataclasses
import inspect
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

__all__ = ["Corex", "NotFittedError", "resolve_config", "resolve_optimizer"]


class NotFittedError(ValueError, AttributeError):
    """Inference was requested before `fit` (the same bases as
    `sklearn.exceptions.NotFittedError`)."""


def _not_ported(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported to the PyTorch package yet (ROADMAP.md "
        f"Queue 1, {item}); the JAX package linearcorex_tpu supports it")


def check_ported(cfg: CorexConfig, n_restarts=1, mesh=None) -> None:
    """Raise NotImplementedError, by name, for an option of the JAX
    package that the port does not run yet."""
    if mesh is not None:
        _not_ported("fit(mesh=...)", "item 17 (sharding)")
    if n_restarts != 1:
        _not_ported("n_restarts > 1", "item 11 (restarts)")
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
    Returns (ws, Moments, FitDiagnostics)."""
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


_DTYPES = {"float32": torch.float32, "float64": torch.float64}


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

    # fitted state; None until fit (or corex_from_numpy) sets it
    ws: Optional[torch.Tensor] = None
    theta: Optional[P.Theta] = None
    moments: Optional[M.Moments] = None
    diagnostics: Optional[FitDiagnostics] = None
    nv: Optional[int] = None
    n_samples: Optional[int] = None
    resolved_optimizer_: Optional[str] = None
    best_restart_: Optional[int] = None
    # warm-start weights held apart from fitted state (a repeated fit is
    # fresh; corex_from_numpy re-arms this so a later fit warm-starts)
    _pretrained_ws: Optional[torch.Tensor] = None

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
        dt = self.config.dtype
        if dt not in _DTYPES:
            raise ValueError(f"dtype must be 'float32' or 'float64', got "
                             f"{dt!r}")
        return _DTYPES[dt]

    @property
    def _device(self) -> torch.device:
        dev = torch.device(self.device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"device={self.device!r} but CUDA is not available; pass "
                f"device='cpu' to run the port on the CPU")
        if dev.type not in ("cuda", "cpu"):
            raise ValueError(f"device must be a CUDA device or 'cpu', got "
                             f"{self.device!r}")
        return dev

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

    def _to_tensor(self, x, what="x") -> torch.Tensor:
        """Coerce input to a 2-D real tensor of the model dtype on the
        model device."""
        if hasattr(x, "toarray") and hasattr(x, "tocsr"):
            raise TypeError(
                f"sparse input is not supported: densify {what} first "
                f"(e.g. X.toarray())")
        if not isinstance(x, torch.Tensor):
            x = np.asarray(x)
            if np.iscomplexobj(x):
                raise ValueError(
                    f"Complex data not supported: {what} must be "
                    f"real-valued")
            if x.dtype == object:
                # numeric object arrays densify; strings raise numpy's
                # could-not-convert ValueError
                x = x.astype(np.float64)
            if self.pre_config.missing_values is None and x.ndim == 2 \
                    and not np.isfinite(x).all():
                raise ValueError(
                    f"{what} contains NaN/inf; pass missing_values="
                    f"<sentinel> after encoding missing entries, or clean "
                    f"the data first")
        elif x.is_complex():
            raise ValueError(
                f"Complex data not supported: {what} must be real-valued")
        if x.ndim != 2:
            raise ValueError(
                f"expected a 2-D (n_samples, n_variables) array for "
                f"{what}, got shape {tuple(x.shape)}")
        if x.shape[1] == 0:
            raise ValueError(
                f"0 feature(s) (shape={tuple(x.shape)}) while a minimum of "
                f"1 is required.")
        return self._as_tensor(x)

    def _as_tensor(self, a) -> torch.Tensor:
        """`a` (tensor or array-like) in the model dtype on the model
        device."""
        if not isinstance(a, torch.Tensor):
            a = np.asarray(a)
        return torch.as_tensor(a, dtype=self._dt, device=self._device)

    def _prepare_fit(self, x):
        """Input validation, preprocessing (sets theta/nv/n_samples),
        moment-strategy choice and 'auto' resolution. Returns (data, cfg,
        strategy) with data the solver operand: X or the Gram matrix,
        cast to bf16 under matmul_dtype='bfloat16' or quantized (after
        preprocessing, whose standardized columns the per-tensor scale
        relies on, and checked by the int32 wrap guard) under 'int8'."""
        x = self._to_tensor(x)
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
        xp, self.theta = P.fit_preprocess(x, pre.gaussianize,
                                          pre.missing_values)
        data = M.compute_gram(xp) if strategy == "gram" else xp
        if cfg.matmul_dtype == "bfloat16":
            data = data.to(torch.bfloat16)
        elif cfg.matmul_dtype == "int8":
            data = M.quantize_samples(data)
        return data, cfg, strategy

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
            # Ω follows the random init's seeding: seeded → NumPy
            # RandomState (the JAX package's Ω), unseeded → the device
            if self.seed is None:
                gen = torch.Generator(device=self._device)
                gen.seed()
                omega = torch.randn((self.nv, self.m), generator=gen,
                                    dtype=self._dt, device=self._device)
            else:
                omega = self._as_tensor(np.random.RandomState(
                    self.seed).normal(size=(self.nv, self.m)))
            return _spectral_init(data, omega, strategy,
                                  self.config.matmul_dtype)
        return self._init_ws(self.nv)

    def fit(self, x, y=None, init_ws=None, mesh=None, sharding_plan=None):
        """Fit the model. `y` is ignored (unsupervised; accepted for
        sklearn Pipelines). `mesh`/`sharding_plan` belong to the JAX
        package's sharded fit and raise NotImplementedError here."""
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
        del y, sharding_plan
        check_ported(self.config, self.n_restarts, mesh)
        data, cfg, strategy = self._prepare_fit(x)
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
    def _check_fitted(self):
        if self.ws is None or self.moments is None:
            raise NotFittedError(
                "this Corex instance is not fitted yet; call fit(X) first")

    def transform(self, x, details=False):
        """Project to factors: Y = X_preproc·Wᵀ. With details=True returns
        (Y, moments dict) with the moments of the given data under the
        fitted weights (the reference's keys)."""
        self._check_fitted()
        x = self._to_tensor(x)
        if x.shape[1] != self.nv:
            raise ValueError(
                f"x must be 2-D with {self.nv} columns (the fitted "
                f"n_variables); got shape {tuple(x.shape)}")
        pre = self.pre_config
        cfg = self.config
        with M.full_f32_matmul():
            xp = P.preprocess(x, pre.gaussianize, self.theta,
                              pre.missing_values)
            y = M._mm(xp, self.ws.T)
            if not details:
                return y
            zero = torch.zeros((), dtype=self.ws.dtype, device=x.device)
            c_xy = M.cxy_samples(xp, self.ws, zero)
            mom = M.moments_from_cxy(self.ws, c_xy, cfg.y_scale,
                                     cfg.rho_clip)
        return y, mom.asdict()

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

    def __repr__(self):
        fitted = "" if self.ws is None else (
            f", fitted: nv={self.nv}, n_samples={self.n_samples}, "
            f"tc={self.tc:.4f}")
        return (f"Corex(n_hidden={self.n_hidden}, "
                f"discourage_overlap={self.discourage_overlap}, "
                f"gaussianize={self.gaussianize!r}, "
                f"optimizer={self.optimizer!r}, dtype={self.dtype!r}, "
                f"device={self.device!r}{fitted})")

