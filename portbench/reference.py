"""The plain reference of Linear CorEx (non-overlap objective), in PyTorch.

Written from the published algorithm (Ver Steeg and Galstyan, "Low
complexity Gaussian latent factor models and a blessing of
dimensionality", arXiv:1706.03353) and the estimator's documented
behaviour: standardisation of the columns, the annealed cross moment
C_xy = (1 − ε²)·Σ·Wᵀ + ε²·Wᵀ, the moments and total correlation, the
gradient of the objective, the damped fixed point, the seeded inits and
the int8 operand mode. It imports nothing of the program under test and
runs in float64 (`DT`) on whatever device its tensors are on.

It does three jobs:
- `Operand` + `moments` + `evaluate`: the float64 numbers that each fit
  of the window is judged against (`compare.py`);
- `first_step`: the first iteration of the accept/reject loop from the
  fit's own seeded start, re-derived (W and its TC);
- `fit`: the whole annealed fit, used only in place of the program as
  the lower-precision control (`control.py`, the tests): `precision`
  'tf32' rounds every product's operands to TF32, 'int4' quantizes the
  operand and the product columns to 4 bits where the program uses 8.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

DT = torch.float64
RHO_CLIP = 1.0 - 1e-6


def anneal_schedule(anneal: bool, m: int):
    """ε per stage: 0.6, 0.36, … 0.6⁶ and a final exact 0 when annealing
    a multi-factor fit, else the single stage ε = 0."""
    if anneal and m > 1:
        return [0.6 ** k for k in range(1, 7)] + [0.0]
    return [0.0]


def standardize(x: torch.Tensor):
    """Columns centred and scaled by their population std (a std below
    1e-10 counts as 1), in float64. Returns (z, mean, std)."""
    x = x.to(DT)
    mean = x.mean(0)
    std = x.std(0, correction=0)
    std = torch.where(std < 1e-10, torch.ones_like(std), std)
    return (x - mean) / std, mean, std


def tf32(a: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10-bit mantissa (nearest, ties
    away from zero, as the tensor cores' conversion), kept in float32."""
    bits = a.to(torch.float32).contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def quantize(a: torch.Tensor, levels: int, dim=None):
    """Abs-max quantization to the integers −levels..levels: one scale for
    the whole tensor (dim None) or one per column (dim 0). Returns
    (integers as float64, scale), so that a ≈ q·scale."""
    amax = a.abs().amax() if dim is None else a.abs().amax(dim=dim)
    s = torch.clamp(amax / levels, min=1e-30)
    q = torch.clamp(torch.round(a / s), -levels, levels)
    return q, s


class Operand:
    """The covariance as the fit applies it: Σ = ZᵀZ/n of the standardized
    data, whole ('gram') or through Z ('samples'), in float64; under
    `levels` (127 for int8, 7 for the int4 control) the program's operand
    mode re-derived: Σ (gram) or Z (samples) quantized with one scale, the
    applied columns quantized per column, integer products exact in
    float64. `rounding` (tf32) rounds both operands of every product."""

    def __init__(self, z: torch.Tensor, strategy: str,
                 levels: Optional[int] = None, rounding=None):
        self.n, self.p = z.shape
        self.strategy, self.levels, self.rounding = strategy, levels, rounding
        base = z.T @ z / self.n if strategy == "gram" else z
        if levels is None:
            self.q, self.scale = base, None
        else:
            self.q, self.scale = quantize(base, levels)
        if rounding is not None:
            self.q = rounding(self.q).to(base.dtype)

    def exact(self) -> "Operand":
        """The operand dequantized and applied without quantizing the
        columns, as the fit's final moments apply it (at the products'
        rounding, if any)."""
        out = Operand.__new__(Operand)
        out.n, out.p, out.strategy = self.n, self.p, self.strategy
        out.levels, out.rounding = None, self.rounding
        out.q = self.q if self.scale is None else self.q * self.scale
        out.scale = None
        return out

    def mm(self, a, b):
        """A product at the operand's rounding, if any."""
        if self.rounding is not None:
            a, b = self.rounding(a).to(a.dtype), self.rounding(b).to(b.dtype)
        return a @ b

    def apply(self, v: torch.Tensor) -> torch.Tensor:
        """Σ·v for v (p, c)."""
        if self.levels is None:
            if self.strategy == "gram":
                return self.mm(self.q, v)
            return self.mm(self.q.T, self.mm(self.q, v)) / self.n
        vq, sv = quantize(v, self.levels, dim=0)
        if self.strategy == "gram":
            return (self.q @ vq) * (self.scale * sv)[None, :]
        t = (self.q @ vq) * (self.scale * sv)[None, :]
        tq, st = quantize(t, self.levels, dim=0)
        return (self.q.T @ tq) * (self.scale * st)[None, :] / self.n


class Moments(NamedTuple):
    c_xy: torch.Tensor    # (p, m)
    tcs: torch.Tensor     # (m,)
    tc: torch.Tensor      # ()
    objective: torch.Tensor
    z2: torch.Tensor
    rho: torch.Tensor     # (m, p)
    invrho: torch.Tensor
    rr: torch.Tensor
    qij: torch.Tensor
    si: torch.Tensor
    qi: torch.Tensor


def moments(ws: torch.Tensor, c_xy: torch.Tensor, op: Operand,
            y_scale: float = 1.0) -> Moments:
    """TC, objective and the moment chain from W (m, p) and C_xy (p, m)."""
    m = ws.shape[0]
    cy = op.mm(ws, c_xy) + y_scale ** 2 * torch.eye(m, dtype=ws.dtype,
                                                     device=ws.device)
    z2 = torch.diagonal(cy)
    sqz = torch.sqrt(z2)
    ry = cy / (sqz[:, None] * sqz[None, :])
    rho = torch.clamp((c_xy / sqz[None, :]).T, -RHO_CLIP, RHO_CLIP)
    invrho = 1.0 / (1.0 - rho ** 2)
    rr = rho * invrho
    qij = op.mm(ry, rr)
    si = torch.sum(rho * rr, dim=0)
    qi = torch.sum(rr * qij, dim=0)
    vi = (1.0 + qi - si ** 2) / (1.0 + si) ** 2
    mi = -0.5 * torch.log1p(-rho ** 2)
    i_y_x = 0.5 * torch.log(z2) - math.log(y_scale)
    tcs = torch.sum(mi, dim=1) - i_y_x
    objective = 0.5 * torch.sum(torch.log(torch.clamp(vi, min=1e-30))) \
        + 0.5 * torch.sum(torch.log(z2))
    return Moments(c_xy, tcs, tcs.sum(), objective, z2, rho, invrho, rr, qij,
                   si, qi)


def cross(ws: torch.Tensor, op: Operand, eps: float) -> torch.Tensor:
    """The annealed C_xy of W."""
    return (1.0 - eps ** 2) * op.apply(ws.T) + eps ** 2 * ws.T


def evaluate(ws: torch.Tensor, op: Operand, eps: float, optimizer: str):
    """(objective, direction, TC) at W: the objective's gradient, or on
    the fixed point the residual W − Ŵ of the closed-form update."""
    mom = moments(ws, cross(ws, op, eps), op)
    rho, invrho, rr, qij, si, qi = (mom.rho, mom.invrho, mom.rr, mom.qij,
                                    mom.si, mom.qi)
    alpha = 1.0 / (1.0 + qi - si ** 2)
    beta = 1.0 / (1.0 + si)
    aa = alpha[None, :] * (1.0 + rho ** 2) * invrho ** 2 * qij \
        - 2.0 * (alpha * si + beta)[None, :] * rho * invrho ** 2
    hmat = op.mm(rr * alpha[None, :], rr.T)
    coef = torch.sum(aa * rho, dim=1) \
        + torch.sum(alpha[None, :] * rr * qij, dim=1) - 1.0
    sqz = torch.sqrt(mom.z2)
    if optimizer == "fixed_point":
        a_inv = torch.linalg.inv_ex(torch.diag(coef) - hmat).inverse
        target = op.mm(a_inv, aa) * sqz[:, None]
        return mom.objective, ws - target, mom.tc
    aas = (1.0 - eps ** 2) * op.apply(aa.T).T + eps ** 2 * aa
    grad = (aas + op.mm(hmat, rho) - coef[:, None] * rho) / sqz[:, None]
    return mom.objective, grad, mom.tc


def random_w0(seed: int, m: int, p: int, device) -> torch.Tensor:
    """The seeded random start: N(0, 1/√p) from NumPy's RandomState(seed),
    held in float32 as the fit holds it, returned in float64."""
    w = np.random.RandomState(seed).normal(0.0, 1.0 / np.sqrt(p), (m, p))
    return torch.as_tensor(w.astype(np.float32), device=device).to(DT)


def spectral_w0(seed: int, m: int, op: Operand, device) -> torch.Tensor:
    """The seeded spectral start: Ω (p, m) from RandomState(seed), held in
    float32; W₀ = Qᵀ of the thin QR of Σ·Ω."""
    omega = np.random.RandomState(seed).normal(size=(op.p, m))
    omega = torch.as_tensor(omega.astype(np.float32),
                            device=device).to(op.q.dtype)
    q, _ = torch.linalg.qr(op.apply(omega))
    return q.T.contiguous()


class Rules(NamedTuple):
    """The accept/reject loop's constants."""

    momentum: bool
    lr_init: float
    lr_cap: float
    beta: float = 0.9
    growth: float = 1.1
    halve: float = 0.5
    lr_min: float = 1e-14

    @classmethod
    def of(cls, optimizer: str):
        if optimizer == "fixed_point":
            return cls(False, 0.5, 1.0)
        return cls(True, 0.05, 2.0)


def _step(ws, v, g, lr, rules: Rules):
    if rules.momentum:
        v_new = rules.beta * v - lr * g
        return ws + v_new, v_new
    return ws - lr * g, v


def first_step(w0: torch.Tensor, op: Operand, eps: float, optimizer: str):
    """W and TC after the first iteration of the first stage (accepted or
    not): the TC is the first entry of the fit's TC history."""
    rules = Rules.of(optimizer)
    f0, g0, tc0 = evaluate(w0, op, eps, optimizer)
    w1, _ = _step(w0, torch.zeros_like(w0), g0, rules.lr_init, rules)
    f1, _, tc1 = evaluate(w1, op, eps, optimizer)
    if bool(f1 <= f0):
        return w1, float(tc1)
    return w0, float(tc0)


class Fit(NamedTuple):
    ws: torch.Tensor          # (m, p), sorted by decreasing TCs
    c_xy: torch.Tensor        # (p, m), of the sorted W, ε = 0
    tc: float
    tcs: torch.Tensor
    first_tc: float           # the TC history's first entry
    iterations: int


def fit(w0: torch.Tensor, op: Operand, optimizer: str, anneal: bool,
        tol: float, max_iter: int) -> Fit:
    """The annealed accept/reject fit from W₀: every stage runs until an
    accepted step moves no entry of W by `tol` or more, the step size
    falls below its floor, or `max_iter` iterations. A rejected step
    halves the step size (and drops the momentum); an accepted one grows
    it by 1.1 up to its cap. Ends with the moments at ε = 0 on the exact
    operand and the factors sorted by TC."""
    rules = Rules.of(optimizer)
    ws, first, total = w0, None, 0
    for eps in anneal_schedule(anneal, w0.shape[0]):
        f, g, tc = evaluate(ws, op, eps, optimizer)
        v = torch.zeros_like(ws)
        lr, it, delta = rules.lr_init, 0, math.inf
        while it < max_iter and delta >= tol and lr >= rules.lr_min:
            w_new, v_new = _step(ws, v, g, lr, rules)
            f_new, g_new, tc_new = evaluate(w_new, op, eps, optimizer)
            if bool(f_new <= f):
                delta = float(torch.max(torch.abs(w_new - ws)))
                ws, f, g, v, tc = w_new, f_new, g_new, v_new, tc_new
                lr = min(lr * rules.growth, rules.lr_cap)
            else:
                v = torch.zeros_like(ws) if rules.momentum else v
                lr, delta = lr * rules.halve, math.inf
            if first is None:
                first = float(tc)
            it += 1
        total += it
    exact = op.exact()
    mom = moments(ws, cross(ws, exact, 0.0), exact)
    order = torch.argsort(-mom.tcs, stable=True)
    ws = ws[order]
    return Fit(ws, mom.c_xy[:, order], float(mom.tc), mom.tcs[order],
               math.nan if first is None else first, total)
