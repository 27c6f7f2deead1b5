"""NumPy float64 oracle for Linear CorEx — the executable specification.

This is the port's own copy of the JAX package's `linearcorex_tpu/oracle/
oracle.py`, kept so that float64 parity can be checked where PyTorch runs
and JAX does not (a CUDA card's machine). It imports NumPy and SciPy only:
no torch, no JAX and nothing of either package. The spec is worth
something only while it is independent of the code under test, and a torch
version would share cuBLAS, cuSOLVER and torch's CPU LAPACK with the port.

The two copies are one specification. A change to either is made in both:
`tests/test_torch_oracle.py` holds their code equal (the syntax trees,
save this docstring) and their outputs equal bit for bit.

The estimator is Linear CorEx of Ver Steeg & Galstyan, "Low Complexity
Gaussian Latent Factor Models and a Blessing of Dimensionality"
(arXiv:1706.03353, NeurIPS 2017), with the feature surface of the reference
package gregversteeg/LinearCorex (`linearcorex.Corex`). Its equation system
was reconstructed from the paper and numerically validated (block recovery;
sum(tcs) against the direct Gaussian TC to ~0.1%; the annealing
moment-blend identity); see SURVEY.md §0 and §7.0.

Reference-parity anchors use the convention
`[U] linearcorex/linearcorex.py :: <symbol>` (upstream repo anchor; line
numbers intentionally omitted).

Model
-----
Standardized data x in R^{n x p} (⟨x_i⟩=0, ⟨x_i²⟩=1); latent factors
y = W x + ε with W in R^{m x p}, ε ~ N(0, η² I_m), η = y_scale. Noise is
handled analytically — never sampled (SURVEY.md §2.3).
"""

from __future__ import annotations

import numpy as np
from scipy.stats import norm, rankdata

__all__ = ["OracleCorex", "pick_n_hidden_oracle", "anneal_schedule"]

_RHO_CLIP = 1.0 - 1e-6


def anneal_schedule(anneal: bool, n_hidden: int, discourage_overlap: bool):
    """Annealing schedule of noise levels eps (SURVEY.md §2.4, [MED] constants).

    Geometric 0.6**k for k=1..6, ending in exact 0. Annealing is only applied
    for the multi-factor non-overlapping solver (single-factor and overlapping
    objectives do not need landscape smoothing in the reference
    `[U] :: Corex.fit`).
    """
    if anneal and n_hidden > 1 and discourage_overlap:
        return [0.6 ** k for k in range(1, 7)] + [0.0]
    return [0.0]


# ---------------------------------------------------------------------------
# Moment system (SURVEY.md §2.3 — [HIGH], numerically verified)
# ---------------------------------------------------------------------------

def calculate_moments(x, ws, eps=0.0, y_scale=1.0, quick=True):
    """All second-moment quantities + TC/MI for the current weights.

    Parity anchor: `[U] :: Corex._calculate_moments` (non-overlap variant).
    The p x p covariance is never formed: cost is two O(n·p·m) GEMMs plus
    O(p·m + m²·p) algebra.

    The annealing noise level `eps` enters analytically via the moment blend
    C_xy ← (1−eps²)·(Xᵀ(XWᵀ)/n) + eps²·Wᵀ   (SURVEY.md §2.4, verified).
    """
    x = np.asarray(x, dtype=np.float64)
    ws = np.asarray(ws, dtype=np.float64)
    n = x.shape[0]
    m = {}
    y = x @ ws.T                                        # n x m   GEMM 1
    c_xy = x.T @ y / n                                  # p x m   GEMM 2
    if eps > 0.0:
        c_xy = (1.0 - eps ** 2) * c_xy + eps ** 2 * ws.T
    c_y = ws @ c_xy + (y_scale ** 2) * np.eye(ws.shape[0])   # m x m
    z2 = np.diag(c_y).copy()                            # ⟨y_j²⟩
    sqz = np.sqrt(z2)
    m["X_i Y_j"] = c_xy
    m["cy"] = c_y
    m["Y_j^2"] = z2
    m["ry"] = c_y / np.outer(sqz, sqz)
    rho = (c_xy / sqz[np.newaxis, :]).T                 # m x p  corr(x_i, y_j)
    rho = np.clip(rho, -_RHO_CLIP, _RHO_CLIP)
    m["rho"] = rho
    m["invrho"] = 1.0 / (1.0 - rho ** 2)
    m["rhoinvrho"] = rho * m["invrho"]
    m["Qij"] = m["ry"] @ m["rhoinvrho"]
    m["Si"] = np.sum(rho * m["rhoinvrho"], axis=0)      # p
    m["Qi"] = np.sum(m["rhoinvrho"] * m["Qij"], axis=0)  # p
    # Conditional variance <x_i^2|Y>: mean squared residual of the
    # product-of-experts reconstruction
    #   xhat_i = 1/(1+S_i) * Σ_j rhoinvrho_ji y_j / sqrt(z2_j),
    # which in moment form is (1 + Q_i − S_i²)/(1 + S_i)²  (verified
    # empirically; reduces exactly to the ansatz 1/(1+S_i) when factors are
    # uncorrelated). The Q_i term is what discourages overlapping/duplicate
    # factors — a duplicated factor inflates Q_i without adding information.
    m["X_i^2 | Y"] = (1.0 + m["Qi"] - m["Si"] ** 2) / (1.0 + m["Si"]) ** 2
    m["MI"] = -0.5 * np.log1p(-rho ** 2)                # m x p
    with np.errstate(divide="ignore"):
        i_y_x = 0.5 * np.log(z2) - np.log(y_scale)      # I(y_j; X)
    m["I_y_x"] = i_y_x
    m["TCs"] = np.sum(m["MI"], axis=1) - i_y_x          # m
    m["TC"] = float(np.sum(m["TCs"]))
    # Objective F(W) = Σ_i ½ log v_i + Σ_j ½ log z2_j  (minimized)
    m["objective"] = float(
        0.5 * np.sum(np.log(np.maximum(m["X_i^2 | Y"], 1e-300)))
        + 0.5 * np.sum(np.log(z2))
    )
    if not quick:
        # Reconstruction weights: E[x_i|y] = Σ_j R_ij y_j with
        # R_ij = rhoinvrho_ji / ((1+S_i)·sqrt(z2_j)) — the product-of-experts
        # posterior mean (SURVEY.md §3.3, verified; note the PoE precision
        # 1/(1+S_i), which the Q-corrected residual variance above does not
        # replace).
        m["X_i Z_j"] = (
            m["rhoinvrho"].T / (1.0 + m["Si"])[:, None] / sqz[np.newaxis, :]
        )
        # Per-variable additivity diagnostic: Σ_j I(x_i;y_j) − I(x_i;Y)
        # (reported, not optimized — SURVEY.md §2.3 [LOW]).
        i_xi_y = -0.5 * np.log(m["X_i^2 | Y"])
        m["additivity"] = float(np.sum(np.sum(m["MI"], axis=0) - i_xi_y))
    return m


def _ns_gradient_terms(moments):
    """Shared algebra for the non-overlap gradient and fixed-point update.

    The objective (minimized) is
        F(W) = Σ_i ½ log v_i + Σ_j ½ log z2_j,
        v_i  = (1 + Q_i − S_i²)/(1 + S_i)²,
    which depends on W only through rho_ji, ry_jk and z2_j. Differentiating
    (using ∂rho_ji/∂w_jk = (Σ_ik − rho_ji·rho_jk)/sqrt(z2_j) and the
    analogous ry derivative) and collecting terms gives

        sqrt(z2_l)·∂F/∂W_l = (AA·Σ_eff)_l + (H·rho)_l − (κ_l + μ_l − 1)·rho_l

    with per-variable weights α_i = 1/(1+Q_i−S_i²), β_i = 1/(1+S_i) and

        AA_li = α_i·(1+rho²)·invrho²·Qij_li − 2(α_i S_i + β_i)·rho·invrho²,
        H_lk  = Σ_i α_i·rr_li·rr_ki          (m x m cross-factor coupling),
        κ_l   = Σ_i AA_li·rho_li,   μ_l = Σ_i α_i·rr_li·Qij_li.

    (The H matrix is the cross-factor interference term — the mechanism that
    actively discourages overlapping factors; parity anchor
    `[U] :: Corex._update_ws`, whose H = rhoinvrho/(1+Si) @ rhoinvrho.T is
    this same matrix with α_i in its uncorrelated-factor limit 1/(1+S_i).)

    Returns (AA, H, coef, sq) where coef_l = κ_l + μ_l − 1 and sq = sqrt(z2).
    """
    rho = moments["rho"]
    invrho = moments["invrho"]
    rr = moments["rhoinvrho"]
    qij = moments["Qij"]
    si = moments["Si"]
    qi = moments["Qi"]
    z2 = moments["Y_j^2"]
    alpha = 1.0 / (1.0 + qi - si ** 2)
    beta = 1.0 / (1.0 + si)
    h_fac = (1.0 + rho ** 2) * invrho ** 2
    aa = alpha[None, :] * h_fac * qij \
        - 2.0 * (alpha * si + beta)[None, :] * rho * invrho ** 2
    hmat = (rr * alpha[None, :]) @ rr.T                       # m x m
    kappa = np.sum(aa * rho, axis=1)
    mu = np.sum(alpha[None, :] * rr * qij, axis=1)
    coef = kappa + mu - 1.0
    return aa, hmat, coef, np.sqrt(z2)


def ns_gradient(moments, x, ws, eps):
    """Exact gradient of the non-overlap objective F (float64, for tests and
    the L-BFGS cross-check). Never materializes p x p: the AA·Σ_eff term is
    ((AA Xᵀ) X)/n blended with eps²·AA."""
    aa, hmat, coef, sq = _ns_gradient_terms(moments)
    rho = moments["rho"]
    n = x.shape[0]
    aas = (aa @ x.T) @ x / n
    if eps > 0.0:
        aas = (1.0 - eps ** 2) * aas + eps ** 2 * aa
    grad_scaled = aas + hmat @ rho - coef[:, None] * rho
    return grad_scaled / sq[:, None]


def ns_fixed_point_target(moments):
    """Closed-form fixed-point target Ŵ (`[U] :: _update_ws`, SURVEY.md
    §2.5/§7.0 — the reference's damped closed-form iteration, re-derived
    from stationarity of F). Setting the exact gradient to zero and
    substituting rho = diag(1/sqz)·W·Σ_eff gives, for invertible Σ_eff,

        Ŵ = diag(sqz)·(diag(coef) − H)⁻¹·AA

    — m x m algebra only, no Σ-sized GEMMs (a fixed-point iteration costs 2
    big GEMMs vs the gradient step's 4). The damped iterate
    W ← (1−γ)W + γŴ under the shared accept/reject rule converges to the
    same optima as heavy-ball on matched-n_hidden problems (validated in
    tests; on overcomplete n_hidden it can find better optima). Mirrored
    exactly by the JAX path (`ops/moments.py :: ns_fp_parts`) — including
    the explicit inverse (the TPU path applies A⁻¹ as inv + MXU GEMM
    because a p-RHS triangular solve is ~20x slower there; the oracle
    matches the operation for step parity)."""
    aa, hmat, coef, sq = _ns_gradient_terms(moments)
    return np.linalg.inv(np.diag(coef) - hmat) @ aa * sq[:, None]




# ---------------------------------------------------------------------------
# Overlapping (discourage_overlap=False) objective + gradient
# ---------------------------------------------------------------------------

def _overlap_objective_grad(ws, x, eps, y_scale):
    """Exact Gaussian TC objective and analytic gradient (overlap allowed).

    Minimizes F(W) = Σ_i ½ log v_i + ½ logdet(C_y/η²) with the exact
    conditional variance v_i = 1 − (B C_y⁻¹ Bᵀ)_ii, B = Σ_eff Wᵀ; this is the
    unrestricted Gaussian latent-factor objective the reference's
    discourage_overlap=False branch optimizes (SURVEY.md §2.5; it involves
    m x m solves but never a p x p matrix).
    """
    n, p = x.shape
    mm = ws.shape[0]
    b = x.T @ (x @ ws.T) / n                                  # p x m
    if eps > 0.0:
        b = (1.0 - eps ** 2) * b + eps ** 2 * ws.T
    c_y = ws @ b + (y_scale ** 2) * np.eye(mm)
    c_inv = np.linalg.inv(c_y)
    bm = b @ c_inv                                            # p x m
    v = 1.0 - np.sum(bm * b, axis=1)
    v = np.maximum(v, 1e-12)
    sign, logdet = np.linalg.slogdet(c_y)
    f = 0.5 * np.sum(np.log(v)) + 0.5 * logdet - mm * np.log(y_scale)
    # Gradient (derivation in repo docs): with V=diag(1/v), M=C_y⁻¹,
    #   ∇F = −(M Bᵀ V) Σ_eff + (M Bᵀ V B M) Bᵀ + M Bᵀ
    g_lhs = (c_inv @ b.T) / v[np.newaxis, :]                  # m x p = M Bᵀ V
    gs = (g_lhs @ x.T) @ x / n                                # (M Bᵀ V) Σ
    if eps > 0.0:
        gs = (1.0 - eps ** 2) * gs + eps ** 2 * g_lhs
    k = g_lhs @ b                                             # m x m
    grad = -gs + k @ (c_inv @ b.T) + c_inv @ b.T
    return f, grad


# ---------------------------------------------------------------------------
# Preprocessing (SURVEY.md §2.2)
# ---------------------------------------------------------------------------

class _Preprocessor:
    """standardize / outlier-clip / empirical-gaussianize + mean imputation.

    Parity anchor: `[U] :: Corex.preprocess / invert / mean_impute`.
    """

    def __init__(self, gaussianize="standard", missing_values=None):
        if gaussianize not in ("none", "standard", "outliers", "empirical"):
            raise ValueError(f"unknown gaussianize mode: {gaussianize!r}")
        self.gaussianize = gaussianize
        self.missing_values = missing_values
        self.theta = None            # (mean, std) learned at fit time

    def _impute(self, x):
        if self.missing_values is None:
            return x
        x = x.copy()
        if isinstance(self.missing_values, float) and np.isnan(
                self.missing_values):
            mask = np.isnan(x)
        else:
            mask = x == self.missing_values
        x[mask] = np.nan
        col_mean = np.nanmean(x, axis=0)
        col_mean = np.where(np.isnan(col_mean), 0.0, col_mean)
        idx = np.where(np.isnan(x))
        x[idx] = col_mean[idx[1]]
        return x

    def fit_transform(self, x):
        x = np.asarray(x, dtype=np.float64)
        x = self._impute(x)
        if self.gaussianize == "none":
            self.theta = (np.zeros(x.shape[1]), np.ones(x.shape[1]))
            return x
        mean = x.mean(axis=0)
        std = x.std(axis=0)
        std = np.where(std < 1e-10, 1.0, std)
        self.theta = (mean, std)
        z = (x - mean) / std
        if self.gaussianize == "standard":
            return z
        if self.gaussianize == "outliers":
            return _soft_clip(z)
        # 'empirical': rank-based gaussianization per column.
        n = x.shape[0]
        out = np.empty_like(x)
        for j in range(x.shape[1]):
            out[:, j] = norm.ppf((rankdata(x[:, j]) - 0.5) / n)
        return out

    def transform(self, x):
        x = np.asarray(x, dtype=np.float64)
        x = self._impute(x)
        if self.gaussianize == "none":
            return x
        mean, std = self.theta
        z = (x - mean) / std
        if self.gaussianize == "standard":
            return z
        if self.gaussianize == "outliers":
            return _soft_clip(z)
        n = x.shape[0]
        out = np.empty_like(x)
        for j in range(x.shape[1]):
            out[:, j] = norm.ppf((rankdata(x[:, j]) - 0.5) / n)
        return out

    def invert(self, z):
        """Undo the affine part (used by predict, `[U] :: Corex.invert`)."""
        mean, std = self.theta
        return z * std + mean


def _soft_clip(z, t=4.0):
    """Bounded transform for |z|>t so heavy tails don't dominate moments."""
    return np.where(np.abs(z) < t, z, np.sign(z) * (t + np.tanh(np.abs(z) - t)))


# ---------------------------------------------------------------------------
# Estimator
# ---------------------------------------------------------------------------

class OracleCorex:
    """Float64 reference estimator with the `linearcorex.Corex` surface.

    Parity anchor: `[U] linearcorex/linearcorex.py :: class Corex`.
    Constructor signature mirrors the reference (SURVEY.md §1 L5).
    """

    def __init__(self, n_hidden=10, max_iter=10000, tol=1e-5, anneal=True,
                 missing_values=None, discourage_overlap=True,
                 gaussianize="standard", gpu=False, y_scale=1.0,
                 update_iter=10, pretrained_weights=None, verbose=False,
                 seed=None, optimizer="momentum", momentum_beta=0.9,
                 init="random", stage_tol_factor=1.0,
                 stage_subsample=1.0):
        del gpu  # accepted for API parity; the oracle is CPU NumPy by design
        self.m = n_hidden
        self.max_iter = max_iter
        self.tol = tol
        self.anneal = anneal
        self.discourage_overlap = discourage_overlap
        self.y_scale = y_scale
        self.update_iter = update_iter
        self.verbose = verbose
        self.seed = seed
        if optimizer not in ("auto", "momentum", "gd", "fixed_point"):
            raise ValueError(
                f"unknown optimizer: {optimizer!r} (expected 'auto', "
                f"'momentum', 'gd' or 'fixed_point')")
        self.optimizer = optimizer
        if init not in ("random", "spectral"):
            raise ValueError(
                f"unknown init: {init!r} (expected 'random' or "
                f"'spectral')")
        self.init = init
        if stage_tol_factor < 1.0:
            raise ValueError(
                f"stage_tol_factor must be >= 1.0, got {stage_tol_factor}")
        self.stage_tol_factor = stage_tol_factor
        if not (0.0 < stage_subsample <= 1.0):
            raise ValueError(
                f"stage_subsample must be in (0, 1], got "
                f"{stage_subsample}")
        # mirrors Corex(stage_subsample=...)'s SAMPLES-strategy staging
        # (the JAX gram strategy ignores the knob; parity runs must pin
        # moment_strategy='samples')
        self.stage_subsample = stage_subsample
        # per-fit resolution of 'auto' (fit() overwrites); pre-fit direct
        # calls into _obj_grad/_fit_stage see the constructor value
        self.resolved_optimizer_ = optimizer
        self.momentum_beta = momentum_beta
        self.pre = _Preprocessor(gaussianize, missing_values)
        self.ws = None if pretrained_weights is None else np.asarray(
            pretrained_weights, dtype=np.float64)
        self.moments = None
        self.eps = 0.0
        self.history = {"TC": [], "deltas": [], "eps": [],
                        "iters_per_stage": []}
        self.nv = None
        self.n_samples = None

    # -- fitting ----------------------------------------------------------

    def _init_ws(self, p):
        rng = np.random.RandomState(self.seed)
        return rng.normal(loc=0.0, scale=1.0 / np.sqrt(p),
                          size=(self.m, p)).astype(np.float64)

    def _spectral_init(self, x):
        """Randomized range-finder init (init='spectral'): W₀ = Qᵀ with
        Q·R = Σ̂·Ω, Ω ~ RandomState(seed).normal((p, m)) — mirrors
        models.corex._spectral_init_program (same Ω draw, same one
        power iteration, samples-path Σ-application)."""
        n, p = x.shape
        omega = np.random.RandomState(self.seed).normal(
            size=(p, self.m))
        q, _ = np.linalg.qr(x.T @ (x @ omega) / n)
        return np.ascontiguousarray(q.T, dtype=np.float64)

    def fit(self, x, init_ws=None):
        x = self.pre.fit_transform(x)
        self.n_samples, self.nv = x.shape
        if self.optimizer == "auto":
            # mirror models.corex.resolve_optimizer's measured regime
            # policy: fixed_point iff fully sampled (n >= p) on the
            # non-overlap path. Resolved PER FIT into a separate attribute
            # — self.optimizer stays 'auto' so a refit on data in a
            # different regime re-resolves instead of reusing stale state.
            self.resolved_optimizer_ = ("fixed_point"
                                        if self.discourage_overlap
                                        and self.n_samples >= self.nv
                                        else "momentum")
        else:
            self.resolved_optimizer_ = self.optimizer
        if init_ws is not None:
            self.ws = np.asarray(init_ws, dtype=np.float64).copy()
        elif self.ws is None:
            self.ws = (self._spectral_init(x) if self.init == "spectral"
                       else self._init_ws(self.nv))
        schedule = anneal_schedule(self.anneal, self.m,
                                   self.discourage_overlap)
        # mirror CorexConfig.tol_schedule(): non-final stages run at
        # tol x stage_tol_factor, the final stage at tol exactly
        tols = ([self.tol * self.stage_tol_factor] * (len(schedule) - 1)
                + [self.tol])
        k = max(1, int(round(1.0 / self.stage_subsample)))
        if self.stage_subsample < 1.0 and k > 1 and len(schedule) > 1:
            # mirror models.corex._fit_staged_subsample step-for-step:
            # non-final stages on every k-th row, then the prefix
            # program's tcs factor sort (each compiled JAX program ends
            # with one), then the final stage on the full data at `tol`.
            # k == 1 (fraction > 2/3) is inert, mirroring
            # models.corex.stage_subsample_active — no rows would drop,
            # so the staged split is skipped on both sides.
            x_sub = x[::k]
            for eps, stage_tol in zip(schedule[:-1], tols[:-1]):
                self.eps = eps
                self._fit_stage(x_sub, eps, stage_tol)
            mom = calculate_moments(x_sub, self.ws, eps=0.0,
                                    y_scale=self.y_scale, quick=False)
            self.ws = self.ws[np.argsort(-mom["TCs"])]
            schedule, tols = schedule[-1:], tols[-1:]
        for eps, stage_tol in zip(schedule, tols):
            self.eps = eps
            self._fit_stage(x, eps, stage_tol)
        self.moments = calculate_moments(
            x, self.ws, eps=0.0, y_scale=self.y_scale, quick=False)
        order = np.argsort(-self.moments["TCs"])
        self.ws = self.ws[order]
        self.moments = calculate_moments(
            x, self.ws, eps=0.0, y_scale=self.y_scale, quick=False)
        self._x_fit = x
        return self

    def _obj_grad(self, ws, x, eps):
        """(objective, step direction, TC) for the active solver path.

        optimizer='fixed_point' returns the fixed-point residual ws − Ŵ so
        the plain-GD step ws − γ·(ws − Ŵ) realizes the damped closed-form
        update (1−γ)·ws + γ·Ŵ — identical structure to the JAX solver."""
        if self.resolved_optimizer_ == "auto":
            # mirror the JAX guard (models.corex._make_obj_grad): an
            # unresolved 'auto' would silently run plain GD below
            raise ValueError(
                "optimizer='auto' is resolved against the data shapes by "
                "fit(); call fit() (or set an explicit optimizer) before "
                "driving _obj_grad/_fit_stage directly")
        if self.discourage_overlap:
            m = calculate_moments(x, ws, eps=eps, y_scale=self.y_scale,
                                  quick=True)
            if self.resolved_optimizer_ == "fixed_point":
                return (m["objective"], ws - ns_fixed_point_target(m),
                        m["TC"])
            return m["objective"], ns_gradient(m, x, ws, eps), m["TC"]
        if self.resolved_optimizer_ == "fixed_point":
            raise ValueError(
                "optimizer='fixed_point' implements the non-overlap "
                "closed-form update; use 'momentum'/'gd' with "
                "discourage_overlap=False")
        f, g = _overlap_objective_grad(ws, x, eps, self.y_scale)
        return f, g, -f

    def _fit_stage(self, x, eps, tol=None):
        """Deterministic first-order solver with step halving.
        `tol` is the stage's convergence tolerance (defaults to
        self.tol; fit() passes the per-stage schedule mirroring
        CorexConfig.tol_schedule()).

        The same accept/reject rule is mirrored exactly by the JAX
        `lax.while_loop` solver so seed-matched runs are step-for-step
        comparable (SURVEY.md §4.2 item 1). Hyperparameters: lr0=0.05,
        growth x1.1 (cap 2.0), halve x0.5 on objective increase, stop on
        max|ΔW| < tol or lr underflow. optimizer='momentum' (default) uses
        heavy-ball v ← β·v − lr·g with v reset on rejection (~3x fewer
        iterations to the same TC than plain 'gd'); 'fixed_point' runs the
        damped closed-form update with γ starting at 0.5, capped at 1.0
        (undamped).
        """
        if tol is None:
            tol = self.tol
        fixed_point = self.resolved_optimizer_ == "fixed_point"
        lr = 0.5 if fixed_point else 0.05
        lr_cap = 1.0 if fixed_point else 2.0
        use_momentum = self.resolved_optimizer_ == "momentum"
        v = np.zeros_like(self.ws)
        f, g, tc = self._obj_grad(self.ws, x, eps)
        it = 0
        for it in range(self.max_iter):
            if use_momentum:
                v_new = self.momentum_beta * v - lr * g
                ws_new = self.ws + v_new
            else:
                ws_new = self.ws - lr * g
            f_new, g_new, tc_new = self._obj_grad(ws_new, x, eps)
            if f_new <= f:
                delta = float(np.max(np.abs(ws_new - self.ws)))
                self.ws, f, g, tc = ws_new, f_new, g_new, tc_new
                if use_momentum:
                    v = v_new
                lr = min(lr * 1.1, lr_cap)
            else:
                delta = np.inf
                lr *= 0.5
                if use_momentum:
                    v = np.zeros_like(self.ws)
            self.history["TC"].append(tc)
            self.history["deltas"].append(delta)
            self.history["eps"].append(eps)
            if self.verbose and it % self.update_iter == 0:
                print(f"eps={eps:.4f} it={it} TC={tc:.6f} "
                      f"delta={delta:.2e} lr={lr:.2e}")
            if delta < tol or lr < 1e-14:
                break
        self.history["iters_per_stage"].append(it + 1)

    def fit_transform(self, x):
        return self.fit(x).transform(x)

    # -- inference --------------------------------------------------------

    def transform(self, x, details=False):
        xp = self.pre.transform(x)
        y = xp @ self.ws.T
        if details:
            m = calculate_moments(xp, self.ws, eps=0.0,
                                  y_scale=self.y_scale, quick=False)
            return y, m
        return y

    def predict(self, y):
        """Reconstruct variables from factors: posterior mean E[x|y], then
        invert preprocessing (`[U] :: Corex.predict`, SURVEY.md §3.3)."""
        m = self.moments
        if self.discourage_overlap:
            xhat = np.asarray(y) @ m["X_i Z_j"].T
        else:
            b = m["X_i Y_j"]
            xhat = np.asarray(y) @ np.linalg.solve(m["cy"], b.T)
        return self.pre.invert(xhat)

    def get_covariance(self):
        """Factor-model estimate of cov(X) (`[U] :: Corex.get_covariance`,
        SURVEY.md §3.4; verified max-abs-err 0.019 vs sample corr)."""
        m = self.moments
        if self.discourage_overlap:
            z = m["rhoinvrho"] / (1.0 + m["Si"])[np.newaxis, :]
            cov = z.T @ z
        else:
            c_inv = np.linalg.inv(m["cy"])
            cov = m["X_i Y_j"] @ c_inv @ m["X_i Y_j"].T
        np.fill_diagonal(cov, 1.0)
        std = self.pre.theta[1]
        return std[:, None] * std[None, :] * cov

    # -- info-theoretic outputs (SURVEY.md §2.6) --------------------------

    @property
    def tcs(self):
        return self.moments["TCs"]

    @property
    def tc(self):
        return float(np.sum(self.moments["TCs"]))

    @property
    def mis(self):
        return self.moments["MI"]

    @property
    def clusters(self):
        return np.argmax(self.moments["MI"], axis=0)


def pick_n_hidden_oracle(data, repeat=1, max_n_hidden=None, verbose=False,
                         **kwargs):
    """Model selection by scanning n_hidden until TC stops improving.

    Parity anchor: `[U] linearcorex/linearcorex.py :: pick_n_hidden`
    (SURVEY.md §2.7 [MED]): fits with increasing n_hidden, `repeat` random
    restarts each (best TC kept), stops when an extra factor adds no TC.
    Returns (best_n, scores) where scores[k] is the best TC at n_hidden=k+1.
    """
    data = np.asarray(data, dtype=np.float64)
    if max_n_hidden is None:
        max_n_hidden = min(data.shape[1], 16)
    scores = []
    best_n, best_tc_overall = 1, -np.inf
    for n in range(1, max_n_hidden + 1):
        tc_best = -np.inf
        for r in range(repeat):
            c = OracleCorex(n_hidden=n, seed=r, **kwargs).fit(data)
            tc_best = max(tc_best, c.tc)
        scores.append(tc_best)
        if verbose:
            print(f"n_hidden={n}: TC={tc_best:.5f}")
        if tc_best > best_tc_overall + 1e-3:
            best_tc_overall, best_n = tc_best, n
        elif n > best_n + 1:
            break
    return best_n, np.array(scores)
