"""The Linear CorEx moment system as plain PyTorch functions.

Port of the float32/float64 core of `linearcorex_tpu/ops/moments.py`:

- The 'samples' path never forms the p x p covariance: C_xy = Xᵀ(X·Wᵀ)/n
  is two skinny GEMMs. The 'gram' path builds Σ = XᵀX/n once and applies
  it with one Σ·Wᵀ GEMM per iteration.
- Matmuls keep the JAX package's accumulation rule (`_mm`): at least
  float32, and float64 stays float64. Float32 matmuls run at full float32,
  never TF32 (`full_f32_matmul`).
- The elementwise moment chain of the gradient and fixed-point paths can
  run through the hand-written CUDA kernel `ops.cuda_moments.ns_chain`
  (`chain_kernel=True`); on a CPU tensor that call takes the kernel's plain
  PyTorch twin.

Annealing enters analytically: C_xy ← (1−eps²)·⟨x·y⟩ + eps²·Wᵀ. `eps` may
be a Python float or a 0-dim tensor of the compute dtype.

The bf16 and int8 operand modes and the overlap objective are not ported
yet (ROADMAP.md Queue 1, items 7 and 8).
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch

from linearcorex_tpu_torch.ops.cuda_moments import ns_chain


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


def cxy_samples(x, ws, eps):
    """C_xy = Xᵀ(X·Wᵀ)/n, annealed; the p x p covariance is never
    formed."""
    n = x.shape[0]
    y = _mm(x, ws.T)                                              # n x m
    c_xy = _mm(x.T, y) / n                                        # p x m
    return _anneal(c_xy, ws.T, eps)


def cxy_gram(gram, ws, eps):
    """C_xy = Σ·Wᵀ, annealed: one O(p²·m) GEMM against the precomputed
    Gram matrix."""
    return _anneal(_mm(gram, ws.T), ws.T, eps)


def compute_gram(x):
    """Σ = XᵀX/n, once per fit, at full float32 (never TF32)."""
    n = x.shape[0]
    with full_f32_matmul():
        return _mm(x.T, x) / n


def _cy_ry(ws, c_xy, y_scale):
    """cov(y) = W·C_xy + y_scale²·I, its diagonal z2, sqrt(z2) and the
    correlation ry."""
    m = ws.shape[0]
    cy = _mm(ws, c_xy) + (y_scale ** 2) * torch.eye(
        m, dtype=ws.dtype, device=ws.device)
    z2 = torch.diagonal(cy)
    sqz = torch.sqrt(z2)
    ry = cy / torch.outer(sqz, sqz)
    return cy, z2, sqz, ry


def moments_from_cxy(ws, c_xy, y_scale: float, rho_clip: float) -> Moments:
    """All second-moment quantities plus TC/MI given C_xy."""
    dt = ws.dtype
    cy, z2, sqz, ry = _cy_ry(ws, c_xy, y_scale)
    rho = (c_xy / sqz[None, :]).T
    rho = torch.clamp(rho, -rho_clip, rho_clip)
    invrho = 1.0 / (1.0 - rho ** 2)
    rhoinvrho = rho * invrho
    qij = _mm(ry, rhoinvrho)
    si = torch.sum(rho * rhoinvrho, dim=0)
    qi = torch.sum(rhoinvrho * qij, dim=0)
    # <x_i^2|Y>: mean squared residual of the product-of-experts
    # reconstruction, (1 + Q_i − S_i²)/(1 + S_i)².
    vi = (1.0 + qi - si ** 2) / (1.0 + si) ** 2
    mi = -0.5 * torch.log1p(-rho ** 2)
    i_y_x = 0.5 * torch.log(z2) - torch.log(
        torch.tensor(y_scale, dtype=dt, device=ws.device))
    tcs = torch.sum(mi, dim=1) - i_y_x
    tc = torch.sum(tcs)
    objective = 0.5 * torch.sum(torch.log(torch.clamp(vi, min=1e-30))) \
        + 0.5 * torch.sum(torch.log(z2))
    return Moments(c_xy=c_xy, cy=cy, z2=z2, ry=ry, rho=rho, invrho=invrho,
                   rhoinvrho=rhoinvrho, qij=qij, si=si, qi=qi, vi=vi, mi=mi,
                   i_y_x=i_y_x, tcs=tcs, tc=tc, objective=objective)


def permute_moments(mom: Moments, order) -> Moments:
    """Reindex the factor axis of every moment after the post-fit sort by
    decreasing TCs (per-variable quantities are factor sums, unchanged)."""
    return Moments(
        c_xy=mom.c_xy[:, order], cy=mom.cy[order][:, order],
        z2=mom.z2[order], ry=mom.ry[order][:, order], rho=mom.rho[order],
        invrho=mom.invrho[order], rhoinvrho=mom.rhoinvrho[order],
        qij=mom.qij[order], si=mom.si, qi=mom.qi, vi=mom.vi,
        mi=mom.mi[order], i_y_x=mom.i_y_x[order], tcs=mom.tcs[order],
        tc=mom.tc, objective=mom.objective,
    )


def reconstruction_weights(mom: Moments):
    """R (p x m): E[x_i|y] = Σ_j R_ij y_j with
    R_ij = rhoinvrho_ji/((1+S_i)·sqrt(z2_j))."""
    return (mom.rhoinvrho.T / (1.0 + mom.si)[:, None]
            / torch.sqrt(mom.z2)[None, :])


def _ns_gradient_terms(mom: Moments):
    """Shared algebra of the non-overlap gradient. Returns (AA, H, coef,
    sqz) with sqrt(z2)·∂F/∂W = AA·Σ_eff + H·rho − coef[:,None]·rho."""
    rho, invrho, rr = mom.rho, mom.invrho, mom.rhoinvrho
    alpha = 1.0 / (1.0 + mom.qi - mom.si ** 2)
    beta = 1.0 / (1.0 + mom.si)
    h_fac = (1.0 + rho ** 2) * invrho ** 2
    aa = alpha[None, :] * h_fac * mom.qij \
        - 2.0 * (alpha * mom.si + beta)[None, :] * rho * invrho ** 2
    hmat = _mm(rr * alpha[None, :], rr.T)
    kappa = torch.sum(aa * rho, dim=1)
    mu = torch.sum(alpha[None, :] * rr * mom.qij, dim=1)
    coef = kappa + mu - 1.0
    return aa, hmat, coef, torch.sqrt(mom.z2)


def _cxy_eff(data, ws, eps, gram):
    """Annealed effective cross-moment C_xy = Σ_eff·Wᵀ from X (samples)
    or Σ (gram)."""
    return cxy_gram(data, ws, eps) if gram else cxy_samples(data, ws, eps)


def _apply_sigma_t(data, gram):
    """v (p, k) ↦ Σ_emp·v (un-annealed; callers blend eps themselves)."""
    if gram:
        return lambda v: _mm(data, v)
    n = data.shape[0]
    return lambda v: _mm(data.T, _mm(data, v)) / n


def _run_chain(ws, c_xy, y_scale, rho_clip):
    """Shared prologue + fused chain call: cov(y) from C_xy, then the
    chain kernel. Returns (dt, z2, sqz, chain outputs...)."""
    _, z2, sqz, ry = _cy_ry(ws, c_xy, y_scale)
    return ws.dtype, z2, sqz, ns_chain(c_xy.contiguous(), ry.contiguous(),
                                       sqz.contiguous(), rho_clip)


def _chain_obj_tc(dt, z2, sum_log_vi, mi_sums, y_scale):
    """Objective F and TC from the chain kernel's reductions."""
    objective = 0.5 * sum_log_vi.to(dt) + 0.5 * torch.sum(torch.log(z2))
    i_y_x = 0.5 * torch.log(z2) - torch.log(
        torch.tensor(y_scale, dtype=dt, device=z2.device))
    tc = torch.sum(mi_sums.to(dt) - i_y_x)
    return objective, tc


def _ns_obj_grad_chain(ws, c_xy, apply_sigma_t, eps, y_scale, rho_clip):
    """Objective/gradient through the fused chain kernel. Works in (p, m)
    layout end to end; `apply_sigma_t(v)` maps a (p, m) matrix to
    Σ_emp·v and the eps blend is applied here."""
    dt, z2, sqz, (aa_t, hmat, kappa, mu, mi_sums, sum_log_vi) = _run_chain(
        ws, c_xy, y_scale, rho_clip)
    aa_t = aa_t.to(dt)
    coef = (kappa + mu - 1.0).to(dt)
    aas_t = _anneal(apply_sigma_t(aa_t), aa_t, eps)
    inv_sqz = (1.0 / sqz).to(dt)
    rho_t = torch.clamp(c_xy * inv_sqz[None, :], -rho_clip, rho_clip)
    grad_t = (aas_t + _mm(rho_t, hmat.to(dt))
              - rho_t * coef[None, :]) * inv_sqz[None, :]
    objective, tc = _chain_obj_tc(dt, z2, sum_log_vi, mi_sums, y_scale)
    return objective, grad_t.T, tc


def ns_obj_grad_samples(ws, x, eps, y_scale, rho_clip, chain_kernel=False):
    """(objective, gradient, TC) of the non-overlap objective, samples
    path: 4 skinny GEMMs (2 for the moments, 2 for AA·Σ_eff)."""
    return _ns_obj_grad(ws, x, eps, y_scale, rho_clip, chain_kernel,
                        gram=False)


def ns_obj_grad_gram(ws, gram, eps, y_scale, rho_clip, chain_kernel=False):
    """Same as `ns_obj_grad_samples` on the precomputed Gram matrix:
    2 O(p²·m) GEMMs per evaluation, independent of n."""
    return _ns_obj_grad(ws, gram, eps, y_scale, rho_clip, chain_kernel,
                        gram=True)


def _ns_obj_grad(ws, data, eps, y_scale, rho_clip, chain_kernel, gram):
    c_xy = _cxy_eff(data, ws, eps, gram)
    if chain_kernel:
        return _ns_obj_grad_chain(ws, c_xy, _apply_sigma_t(data, gram), eps,
                                  y_scale, rho_clip)
    mom = moments_from_cxy(ws, c_xy, y_scale, rho_clip)
    aa, hmat, coef, sqz = _ns_gradient_terms(mom)
    if gram:
        aas = _mm(aa, data)
    else:
        aas = _mm(_mm(aa, data.T), data) / data.shape[0]
    aas = _anneal(aas, aa, eps)
    grad = (aas + _mm(hmat, mom.rho)
            - coef[:, None] * mom.rho) / sqz[:, None]
    return mom.objective, grad, mom.tc


# ---------------------------------------------------------------------------
# Damped fixed-point update (optimizer='fixed_point')
# ---------------------------------------------------------------------------

def ns_fp_parts(ws, data, eps, y_scale, rho_clip, chain_kernel=False,
                gram=False):
    """Pieces of the closed-form fixed-point target, before the m x m
    solve. Setting the gradient to zero with rho = diag(1/sqz)·W·Σ_eff
    gives Ŵ = diag(sqz)·(diag(coef) − H)⁻¹·AA. Returns (objective, tc,
    a_mat (m, m), aa_t (p, m), sqz (m,)). a_mat is near-singular once
    surplus factors have died; the damped accept/reject iteration
    tolerates the inexact inverse."""
    c_xy = _cxy_eff(data, ws, eps, gram)
    return fp_parts_from_cxy(ws, c_xy, y_scale, rho_clip, chain_kernel)


def fp_parts_from_cxy(ws, c_xy, y_scale, rho_clip, chain_kernel=False):
    """`ns_fp_parts` given an already-annealed C_xy."""
    if chain_kernel:
        dt, z2, sqz, (aa_t, hmat, kappa, mu, mi_sums, slv) = _run_chain(
            ws, c_xy, y_scale, rho_clip)
        coef = (kappa + mu - 1.0).to(dt)
        a_mat = torch.diag(coef) - hmat.to(dt)
        objective, tc = _chain_obj_tc(dt, z2, slv, mi_sums, y_scale)
        return objective, tc, a_mat, aa_t.to(dt), sqz
    mom = moments_from_cxy(ws, c_xy, y_scale, rho_clip)
    aa, hmat, coef, sqz = _ns_gradient_terms(mom)
    a_mat = torch.diag(coef) - hmat
    return mom.objective, mom.tc, a_mat, aa.T, sqz


def fp_target_from_parts(ws, a_mat_inv, aa_t, sqz):
    """The solver direction ws − Ŵ from `ns_fp_parts` pieces and the
    inverse of a_mat (applied as inverse + GEMM, as the JAX package
    does)."""
    target = _mm(a_mat_inv, aa_t.T) * sqz[:, None]
    return ws - target


def ns_fp_samples(ws, x, eps, y_scale, rho_clip, chain_kernel=False):
    """(objective, ws − Ŵ, TC) for the damped fixed-point update, samples
    path. The solver's plain-GD step turns the direction into
    (1−γ)·ws + γ·Ŵ."""
    return _ns_fp(ws, x, eps, y_scale, rho_clip, chain_kernel, gram=False)


def ns_fp_gram(ws, gram, eps, y_scale, rho_clip, chain_kernel=False):
    """Gram-path fixed-point update: one O(p²·m) GEMM per iteration."""
    return _ns_fp(ws, gram, eps, y_scale, rho_clip, chain_kernel, gram=True)


def _ns_fp(ws, data, eps, y_scale, rho_clip, chain_kernel, gram):
    obj, tc, a_mat, aa_t, sqz = ns_fp_parts(
        ws, data, eps, y_scale, rho_clip, chain_kernel, gram)
    return obj, fp_target_from_parts(ws, torch.linalg.inv(a_mat), aa_t,
                                     sqz), tc
