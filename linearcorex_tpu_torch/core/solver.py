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

Restart lanes: `fit_core` given W0 of shape (k, m, p) runs k fits side
by side, as `jax.vmap` runs the JAX package's `fit_core`. Every lane keeps
its own step size, iteration count, delta and accept state; each
iteration evaluates every lane, and a lane whose own stopping predicate
is false stays frozen (W, objective, gradient, momentum, TC, step size,
count, delta and history unchanged) until every lane of the stage is
done; then all lanes enter the next stage. One host read per iteration
fetches the k accept flags and the k step sizes. So in float64 lane r
runs the iterations of the single fit from W0[r], stage by stage. The
diagnostics gain a leading lane axis.

Split W: under a variable or factor plan (`parallel.sharding`) each rank
holds a block of W, and the step size max|ΔW| that decides convergence is
a maximum over every block: one MAX `all_reduce` over the axes W is split
over (`w_axes`). It is exact, so every rank reads the same delta, stops at
the same iteration and never waits in a collective the others left.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import numpy as np
import torch

from linearcorex_tpu_torch.config import CorexConfig
from linearcorex_tpu_torch.parallel.collectives import all_reduce

ObjGrad = Callable[[torch.Tensor, torch.Tensor],
                   Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


class FitDiagnostics(NamedTuple):
    """Per-stage record of a fit; the same fields as the JAX package's.
    A lane-batched fit gives each field a leading lane axis."""

    iters_per_stage: torch.Tensor     # (n_stages,) int32
    tc_per_stage: torch.Tensor        # (n_stages,)
    delta_per_stage: torch.Tensor     # (n_stages,)
    objective_per_stage: torch.Tensor  # (n_stages,)
    tc_history: torch.Tensor          # (n_stages, max_iter) or (n_stages, 0)
    eps_schedule: torch.Tensor        # (n_stages,) the schedule the fit ran


def _host_dtype(dt: torch.dtype):
    """(numpy dtype, rounding) for host-side step sizes and tolerances of
    compute dtype `dt`: they are kept in `dt`, as the JAX package keeps
    them in the carry. numpy rounds every float16, float32 and float64
    result to its own dtype, so the rounding is the identity there.
    bfloat16, which numpy lacks, is held in float32, where a product of
    two bfloat16 values is exact, and each result is rounded to bfloat16
    by the rounding: one rounding per operation, as in bfloat16
    arithmetic."""
    if dt == torch.bfloat16:
        return np.dtype(np.float32), _round_bf16
    return np.dtype(str(dt).removeprefix("torch.")), lambda a: a


def _round_bf16(a):
    """float32 value(s) rounded to the nearest bfloat16, as float32."""
    r = torch.as_tensor(np.asarray(a, np.float32)).to(torch.bfloat16)
    return r.to(torch.float32).numpy()[()]


def host_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor read to the host as numpy; bfloat16, which numpy lacks, as
    float32 (exactly)."""
    t = t.cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _stage(obj_grad: ObjGrad, cfg: CorexConfig, ws0: torch.Tensor,
           eps: torch.Tensor, tol, w_axes=()):
    """Run one annealing stage to convergence. `tol` is the stage's
    tolerance as a numpy scalar of the compute dtype; `w_axes` the mesh
    axes W is split over.

    Optimizer: deterministic step-halving line search over plain GD,
    heavy-ball momentum (v ← β·v − lr·g, reset to 0 on a rejected step), or
    the damped fixed point ('fixed_point': obj_grad returns ws − Ŵ and the
    plain-GD step becomes (1−γ)·ws + γ·Ŵ)."""
    npdt, rnd = _host_dtype(ws0.dtype)
    momentum = cfg.optimizer == "momentum"
    fixed_point = cfg.optimizer == "fixed_point"
    lr, lr_cap, growth, halve, lr_min = (rnd(npdt.type(c)) for c in (
        cfg.fp_gamma_init if fixed_point else cfg.lr_init,
        cfg.fp_gamma_cap if fixed_point else cfg.lr_cap,
        cfg.lr_growth, cfg.lr_halve, cfg.lr_min))
    beta = float(rnd(npdt.type(cfg.momentum_beta)))
    inf = npdt.type(np.inf)

    ws = ws0
    f, g, tc = obj_grad(ws0, eps)
    v = torch.zeros_like(ws0)
    it, delta = 0, inf
    hist = []
    while it < cfg.max_iter and delta >= tol and lr >= lr_min:
        if momentum:
            v_new = beta * v - float(lr) * g
            ws_new = ws + v_new
        else:
            ws_new = ws - float(lr) * g
        f_new, g_new, tc_new = obj_grad(ws_new, eps)
        step = all_reduce(torch.max(torch.abs(ws_new - ws)), w_axes,
                          op="max")
        accept, step = torch.stack(
            [(f_new <= f).to(ws.dtype), step]).tolist()
        if accept:
            ws, f, g, tc = ws_new, f_new, g_new, tc_new
            if momentum:
                v = v_new
            delta = npdt.type(step)
            lr = rnd(min(lr * growth, lr_cap))
        else:
            if momentum:
                v = torch.zeros_like(v)
            delta = inf
            lr = rnd(lr * halve)
        if cfg.record_history:
            hist.append(tc)
        it += 1
    row = torch.zeros((cfg.max_iter if cfg.record_history else 0,),
                      dtype=ws0.dtype, device=ws0.device)
    if hist:
        row[:len(hist)] = torch.stack(hist)
    return ws, (it, tc, delta, f, row)


def _stage_lanes(obj_grad: ObjGrad, cfg: CorexConfig, ws0: torch.Tensor,
                 eps: torch.Tensor, tol, w_axes=()):
    """`_stage` for k lanes side by side, ws0 (k, m, p): the rules of
    `_stage` applied to every lane on its own, a lane frozen once its own
    predicate is false, until no lane runs. A frozen lane is evaluated at
    its current W (a no-op step) and its evaluation discarded."""
    dev, dt = ws0.device, ws0.dtype
    npdt, rnd = _host_dtype(dt)
    k = ws0.shape[0]
    momentum = cfg.optimizer == "momentum"
    fixed_point = cfg.optimizer == "fixed_point"
    lr = rnd(np.full(k, cfg.fp_gamma_init if fixed_point else cfg.lr_init,
                     dtype=npdt))
    lr_cap, growth, halve, lr_min = (rnd(npdt.type(c)) for c in (
        cfg.fp_gamma_cap if fixed_point else cfg.lr_cap, cfg.lr_growth,
        cfg.lr_halve, cfg.lr_min))
    beta = float(rnd(npdt.type(cfg.momentum_beta)))

    ws = ws0
    f, g, tc = obj_grad(ws0, eps)
    v = torch.zeros_like(ws0)
    it = np.zeros(k, dtype=np.int64)
    delta = np.full(k, np.inf, dtype=npdt)
    hist = []
    while True:
        run = (it < cfg.max_iter) & (delta >= tol) & (lr >= lr_min)
        if not run.any():
            break
        # one transfer to the device: the k step sizes and run flags
        host = torch.as_tensor(np.concatenate([lr, run]).astype(npdt))
        lr_t, run_t = host.to(device=dev, dtype=dt).split(k)
        lr_t, run_t = lr_t[:, None, None], run_t > 0
        run3 = run_t[:, None, None]
        if momentum:
            v_new = beta * v - lr_t * g
            ws_new = torch.where(run3, ws + v_new, ws)
        else:
            ws_new = torch.where(run3, ws - lr_t * g, ws)
        f_new, g_new, tc_new = obj_grad(ws_new, eps)
        step = all_reduce(torch.amax(torch.abs(ws_new - ws), dim=(-2, -1)),
                          w_axes, op="max")
        keep = (f_new <= f) & run_t
        # one host read: the k accept flags and the k step sizes
        flags = host_numpy(torch.stack([keep.to(dt), step]))
        accept = flags[0] > 0
        keep3 = keep[:, None, None]
        ws = torch.where(keep3, ws_new, ws)
        f = torch.where(keep, f_new, f)
        g = torch.where(keep3, g_new, g)
        tc = torch.where(keep, tc_new, tc)
        if momentum:
            v = torch.where(keep3, v_new, torch.where(run3, 0.0, v))
        reject = run & ~accept
        delta = np.where(accept, flags[1].astype(npdt),
                         np.where(reject, npdt.type(np.inf), delta))
        lr = rnd(np.where(accept, np.minimum(lr * growth, lr_cap),
                          np.where(reject, lr * halve, lr)).astype(npdt))
        it = it + run
        if cfg.record_history:
            hist.append(tc)
    row = torch.zeros((k, cfg.max_iter if cfg.record_history else 0),
                      dtype=dt, device=dev)
    if hist:
        # a lane runs the first it[r] iterations of the stage, then rests
        h = torch.stack(hist, dim=1)
        cols = torch.arange(h.shape[1], device=dev)[None, :]
        lim = torch.as_tensor(it, device=dev)[:, None]
        row[:, :h.shape[1]] = torch.where(cols < lim, h, 0.0)
    return ws, (it, tc, delta, f, row)


def fit_core(obj_grad: ObjGrad, w0: torch.Tensor, cfg: CorexConfig,
             w_axes=()):
    """Full annealed fit: every stage of cfg.anneal_schedule() in turn,
    each run to its cfg.tol_schedule() tolerance. W0 of shape (k, m, p)
    runs k lanes (`_stage_lanes`). `w0` may be this rank's block of W,
    split over the mesh axes `w_axes` (`parallel.collectives.Axis`).
    Returns (ws, FitDiagnostics)."""
    dev, dt = w0.device, w0.dtype
    npdt, rnd = _host_dtype(dt)
    stage = _stage_lanes if w0.ndim == 3 else _stage
    schedule = rnd(np.asarray(cfg.anneal_schedule(), dtype=npdt))
    tols = rnd(np.asarray(cfg.tol_schedule(), dtype=npdt))
    ws = w0
    iters, tcs, deltas, objs, hists = [], [], [], [], []
    for eps, tol in zip(schedule, tols):
        eps_t = torch.tensor(eps, dtype=dt, device=dev)
        ws, (it, tc, delta, f, row) = stage(obj_grad, cfg, ws, eps_t, tol,
                                            w_axes)
        iters.append(it)
        tcs.append(tc)
        deltas.append(delta)
        objs.append(f)
        hists.append(row)
    eps_schedule = torch.as_tensor(schedule, dtype=dt, device=dev)
    if w0.ndim == 3:
        eps_schedule = eps_schedule.expand(w0.shape[0], -1).contiguous()
    diag = FitDiagnostics(
        iters_per_stage=torch.as_tensor(np.stack(iters, axis=-1),
                                        dtype=torch.int32),
        tc_per_stage=torch.stack(tcs, dim=-1),
        delta_per_stage=torch.as_tensor(np.stack(deltas, axis=-1),
                                        dtype=dt, device=dev),
        objective_per_stage=torch.stack(objs, dim=-1),
        tc_history=torch.stack(hists, dim=-2),
        eps_schedule=eps_schedule)
    return ws, diag


def sort_by_tcs(ws: torch.Tensor, tcs: torch.Tensor):
    """Reorder factors by decreasing per-factor TC (per lane for ws
    (k, m, p) and tcs (k, m))."""
    order = torch.argsort(-tcs, dim=-1, stable=True)
    return torch.take_along_dim(ws, order[..., :, None], dim=-2), order
