"""The comparison that decides `correct`: each sampled fit of the window,
as the program returned it, against the float64 reference
(`reference.py`) on the same raw data.

The reference re-derives everything the program derived from X: the
standardisation, Σ, the int8 operand where the cell's call states it,
and each fit's seeded start. It reads the program's outputs only to
judge them. A cell compares the numbers that its workload file gives a
limit. Four are read per fit, each the largest over the judged fits (a
seeded sample of the window's fits, and the fit with the highest TC):

- `cxy_gap`: the fitted cross moment C_xy = Σ·Wᵀ (the moments the
  program returns with W) against the reference's from the same W,
  max|ΔC| / max|C|. It holds the Σ GEMM layer (and the final moments'
  standardisation and Σ) to the stated precision at the timed size.
- `tc_gap`: the returned TC against the reference's TC of the returned
  W, relative.
- `first_step_gap`: the TC history's first entry against the reference's
  first iteration from the fit's own seeded start (random or spectral),
  relative: the start, the objective and its gradient or fixed-point
  update (the chain, the Σ products, the inverse) and the first
  accept/reject decision.
- `residual_gap`: how far the returned W is from a stationary point of
  the last stage's objective (ε = 0, on the fit's own operand: int8
  where the call states it): max|D(W)| / max|W|, D the reference's
  gradient (momentum) or fixed-point residual W − Ŵ at the returned W.
  A loop whose state stops changing, or whose stages end early, returns
  a W that is no stationary point, whichever basin the fit is in; the
  three numbers above would still agree with it. (The int8 fixed point
  stops short of one in sound fits too, so its cell compares the next
  number instead.)

One is read over the window: `stall_gap`, for the window's fit with the
highest returned TC, the reference's TC of the W after that fit's first
accept/reject step over the TC the fit gained after it, TC(W₁) /
|TC(W) − TC(W₁)| (ε = 0, the exact operand). A sound window holds fits
that went far past their first step; a loop frozen after its first body
gains nothing after it (an unbounded reading), and one whose stages end
after a few steps gains little.

The fit's path between its first step and its end is not compared step
by step: a change of rounding can move a fit to another basin, so two
correct programs part there (see PERF.md).
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from portbench import reference as R

PRESETS = {
    # the estimator's documented presets (`Corex(preset=...)`)
    "reference": {},
    "throughput": {"matmul_dtype": "int8", "init": "spectral",
                   "anneal": False, "tol": 1e-4, "optimizer": "auto"},
}
DEFAULTS = {"matmul_dtype": "float32", "init": "random", "anneal": True,
            "tol": 1e-5, "optimizer": "momentum", "max_iter": 10000,
            "n_restarts": 1}
PER_FIT = ("cxy_gap", "tc_gap", "first_step_gap", "residual_gap")
CHECKS = PER_FIT + ("stall_gap",)


def settings(kwargs: dict, n: int, p: int) -> dict:
    """The call's effective settings, re-derived from its documented
    rules: the preset fills what the caller left at its default; the
    'auto' optimizer is the fixed point when n ≥ p, else momentum; the
    Gram strategy when p ≤ 20,000 and 2n ≥ p, else the samples one."""
    out = dict(DEFAULTS)
    preset = PRESETS[kwargs.get("preset", "reference")]
    out.update(preset)
    out.update({k: v for k, v in kwargs.items() if k != "preset"})
    if out["optimizer"] == "auto":
        out["optimizer"] = "fixed_point" if n >= p else "momentum"
    out["strategy"] = "gram" if p <= 20000 and 2 * n >= p else "samples"
    return out


def operand(z: torch.Tensor, st: dict, levels_override=None,
            rounding=None) -> R.Operand:
    levels = levels_override or (127 if st["matmul_dtype"] == "int8"
                                 else None)
    return R.Operand(z, st["strategy"], levels, rounding)


def start(seed: int, m: int, op: R.Operand, st: dict, device):
    if st["init"] == "spectral":
        return R.spectral_w0(seed, m, op, device)
    return R.random_w0(seed, m, op.p, device)


def gaps(fit_ws, fit_cxy, fit_tc, fit_first, w0, op: R.Operand,
         st: dict) -> Dict[str, float]:
    """The numbers of one fit (every argument in float64); its
    `stall_gap` is the window's when it is the fit with the highest TC."""
    exact = op.exact()
    c_ref = R.cross(fit_ws, exact, 0.0)
    cxy = float((fit_cxy - c_ref).abs().max() / c_ref.abs().max())
    tc_ref = float(R.moments(fit_ws, c_ref, exact).tc)
    eps0 = R.anneal_schedule(st["anneal"], fit_ws.shape[0])[0]
    w1, first_ref = R.first_step(w0, op, eps0, st["optimizer"])
    tc_w1 = float(R.moments(w1, R.cross(w1, exact, 0.0), exact).tc)
    gain = abs(tc_ref - tc_w1)
    d = R.evaluate(fit_ws, op, 0.0, st["optimizer"])[1]
    return {"cxy_gap": cxy,
            "tc_gap": abs(fit_tc - tc_ref) / abs(tc_ref),
            "first_step_gap": abs(fit_first - first_ref) / abs(first_ref),
            "residual_gap": float(d.abs().max() / fit_ws.abs().max()),
            "stall_gap": tc_w1 / gain if gain > 0 else math.inf}


def check(x: torch.Tensor, config: dict, kwargs: dict, samples, best,
          limits: Dict[str, float]):
    """Judge the sampled fits and the window's best one (`best`, or None
    when no fit finished). Returns ({name: {'value', 'limit'}} for the
    numbers in `limits`, per-fit readings). A reading that is not a
    finite number fails."""
    n, p = x.shape
    st = settings(kwargs, n, p)
    z, _, _ = R.standardize(x)
    op = operand(z, st)
    per_fit: List[Dict[str, float]] = []
    for s in list(samples) + ([best] if best is not None else []):
        w0 = start(s.seed + s.lane, config["n_hidden"], op, st, x.device)
        per_fit.append(gaps(s.ws.to(R.DT), s.c_xy.to(R.DT), float(s.tc),
                            float(s.first_tc), w0, op, st))
    out = {}
    for name in CHECKS:
        if name not in limits:
            continue
        if name == "stall_gap":
            vals = per_fit[-1:] if best is not None else []
        else:
            vals = per_fit
        vals = [f[name] for f in vals]
        worst = math.nan if not vals or any(not math.isfinite(v)
                                             for v in vals) else max(vals)
        out[name] = {"value": worst, "limit": limits[name]}
    return out, per_fit
