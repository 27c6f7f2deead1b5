"""The annealed accept/reject solver of Linear CorEx, in PyTorch.

Port of `linearcorex_tpu/core/solver.py`. The JAX package compiles the
whole schedule into one program (`lax.scan` over the eps stages, a
`lax.while_loop` per stage). Here both are Python loops: the carry (W,
objective, step direction, momentum buffer, TC) stays on the device, and
one host read per iteration fetches the accept flag and max|ΔW|, which
decide the step on the host. The rules are the JAX package's exactly:
the stopping predicate, the momentum reset on a rejected step, the step
growth and halving, and delta = inf on a reject. Step sizes and
tolerances are kept in the compute dtype (numpy scalars), so a fit stays
step-matched with the JAX package and the float64 oracle.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import numpy as np
import torch

from linearcorex_tpu_torch.config import CorexConfig

ObjGrad = Callable[[torch.Tensor, torch.Tensor],
                   Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


class FitDiagnostics(NamedTuple):
    """Per-stage record of a fit; the same fields as the JAX package's."""

    iters_per_stage: torch.Tensor     # (n_stages,) int32
    tc_per_stage: torch.Tensor        # (n_stages,)
    delta_per_stage: torch.Tensor     # (n_stages,)
    objective_per_stage: torch.Tensor  # (n_stages,)
    tc_history: torch.Tensor          # (n_stages, max_iter) or (n_stages, 0)
    eps_schedule: torch.Tensor        # (n_stages,) the schedule the fit ran


def _np_dtype(t: torch.Tensor) -> np.dtype:
    """The numpy dtype of a float32/float64 tensor (host-side step sizes
    and tolerances are kept in it)."""
    return np.dtype(str(t.dtype).removeprefix("torch."))


def _stage(obj_grad: ObjGrad, cfg: CorexConfig, ws0: torch.Tensor,
           eps: torch.Tensor, tol):
    """Run one annealing stage to convergence. `tol` is the stage's
    tolerance as a numpy scalar of the compute dtype.

    Optimizer: deterministic step-halving line search over plain GD,
    heavy-ball momentum (v ← β·v − lr·g, reset to 0 on a rejected step), or
    the damped fixed point ('fixed_point': obj_grad returns ws − Ŵ and the
    plain-GD step becomes (1−γ)·ws + γ·Ŵ)."""
    npdt = _np_dtype(ws0)
    momentum = cfg.optimizer == "momentum"
    fixed_point = cfg.optimizer == "fixed_point"
    lr = npdt.type(cfg.fp_gamma_init if fixed_point else cfg.lr_init)
    lr_cap = npdt.type(cfg.fp_gamma_cap if fixed_point else cfg.lr_cap)
    growth, halve = npdt.type(cfg.lr_growth), npdt.type(cfg.lr_halve)
    lr_min = npdt.type(cfg.lr_min)
    inf = npdt.type(np.inf)

    ws = ws0
    f, g, tc = obj_grad(ws0, eps)
    v = torch.zeros_like(ws0)
    it, delta = 0, inf
    hist = []
    while it < cfg.max_iter and delta >= tol and lr >= lr_min:
        if momentum:
            v_new = cfg.momentum_beta * v - float(lr) * g
            ws_new = ws + v_new
        else:
            ws_new = ws - float(lr) * g
        f_new, g_new, tc_new = obj_grad(ws_new, eps)
        step = torch.max(torch.abs(ws_new - ws))
        accept, step = torch.stack(
            [(f_new <= f).to(ws.dtype), step]).tolist()
        if accept:
            ws, f, g, tc = ws_new, f_new, g_new, tc_new
            if momentum:
                v = v_new
            delta = npdt.type(step)
            lr = min(lr * growth, lr_cap)
        else:
            if momentum:
                v = torch.zeros_like(v)
            delta = inf
            lr = lr * halve
        if cfg.record_history:
            hist.append(tc)
        it += 1
    return ws, (it, tc, delta, f, hist)


def fit_core(obj_grad: ObjGrad, w0: torch.Tensor, cfg: CorexConfig):
    """Full annealed fit: every stage of cfg.anneal_schedule() in turn,
    each run to its cfg.tol_schedule() tolerance. Returns (ws,
    FitDiagnostics)."""
    npdt = _np_dtype(w0)
    dev, dt = w0.device, w0.dtype
    schedule = np.asarray(cfg.anneal_schedule(), dtype=npdt)
    tols = np.asarray(cfg.tol_schedule(), dtype=npdt)
    hist_len = cfg.max_iter if cfg.record_history else 0
    ws = w0
    iters, tcs, deltas, objs, hists = [], [], [], [], []
    for eps, tol in zip(schedule, tols):
        eps_t = torch.tensor(eps, dtype=dt, device=dev)
        ws, (it, tc, delta, f, hist) = _stage(obj_grad, cfg, ws, eps_t, tol)
        row = torch.zeros((hist_len,), dtype=dt, device=dev)
        if hist:
            row[:len(hist)] = torch.stack(hist)
        iters.append(it)
        tcs.append(tc)
        deltas.append(float(delta))
        objs.append(f)
        hists.append(row)
    diag = FitDiagnostics(
        iters_per_stage=torch.tensor(iters, dtype=torch.int32),
        tc_per_stage=torch.stack(tcs),
        delta_per_stage=torch.tensor(deltas, dtype=dt, device=dev),
        objective_per_stage=torch.stack(objs),
        tc_history=torch.stack(hists),
        eps_schedule=torch.as_tensor(schedule, device=dev))
    return ws, diag


def sort_by_tcs(ws: torch.Tensor, tcs: torch.Tensor):
    """Reorder factors by decreasing per-factor TC."""
    order = torch.argsort(-tcs, stable=True)
    return ws[order], order
