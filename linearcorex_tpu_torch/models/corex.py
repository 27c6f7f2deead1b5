"""The `Corex` estimator of the PyTorch port: fit and inference on one
device, and over a device mesh for plans over the sample, variable,
factor and restart axes.

Port of `linearcorex_tpu/models/corex.py`:
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

`fit(mesh=...)`, `fit_transform` and the serving methods take a
`torch.distributed` DeviceMesh and a `ShardingPlan` (`parallel.sharding`
states the model of execution: every rank makes the same call, keeps its
own block of the data, and ends with the whole fitted state);
`n_restarts=k` under a mesh splits the lanes over its `restarts` axis
(`parallel.restarts`). Under `shard_vars` serving keeps p-sized outputs
split over `var` (a `DTensor`).

Differences by design:
- `device` (default "cuda") names where the fit runs. A CUDA device that
  is not there raises; nothing moves to the CPU behind the caller's back.
  `device="cpu"` runs the same code with the chain kernel's plain twin.
- The fit is not one compiled program: `core.solver` keeps the loop's
  state on the device and, on a card outside a mesh, replays a captured
  CUDA graph of a few iterations between host reads.
- `use_pallas='auto'` takes the CUDA chain kernel on a CUDA device for
  every non-overlap float32 fit the kernel supports, whatever the operand
  mode. The JAX package's m >= 128 gate was a TPU measurement and is not
  copied.

- After a mesh fit the fitted state (W, the moments, theta) is whole on
  every rank, under every plan: the JAX package re-places it per
  `serving_state_specs`, but m x p is small beside the (n, p) X and the
  p-sized outputs, which stay split. Each serving call takes this rank's
  block of the state.

- `matmul_precision` maps onto torch's float32 matmul precision on a CUDA
  device (`precision_ctx`): 'default', 'highest' and 'float32' run full
  float32, 'high' and 'tensorfloat32' TF32, 'bfloat16' torch's "medium"
  (which cuBLAS serves as TF32 too).
  On the CPU every value runs full float32, as XLA:CPU does. The JAX
  package's dot-algorithm names have no counterpart and raise ValueError.
- Outputs follow the kind of their input (`as_kind`): a tensor in gives
  tensors on the model device, anything else numpy arrays, and the fitted
  attributes follow the fit's input. The JAX package returns `jax.Array`s,
  which `np.asarray` reads from any device; a CUDA tensor refuses it.
- `warmup` (`utils.compile_cache.warmup_fit`) runs the fit's programs once
  on synthetic operands, where the JAX package lowers and compiles them
  without data: it builds and loads what the fit uses, so the first fit of
  a process pays no build and no first load.
"""

from __future__ import annotations

import contextlib
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
                                               host_numpy, sort_by_tcs)
from linearcorex_tpu_torch.ops import moments as M
from linearcorex_tpu_torch.ops import preprocessing as P
from linearcorex_tpu_torch.ops.cuda_moments import chain_supported
from linearcorex_tpu_torch.parallel import restarts as R
from linearcorex_tpu_torch.parallel import sharding as S
from linearcorex_tpu_torch.parallel.collectives import all_gather_rows
from linearcorex_tpu_torch.parallel.sharding import DATA_AXIS, ShardingPlan
from linearcorex_tpu_torch.utils.compile_cache import (ensure_compile_cache,
                                                       warmup_fit)
from linearcorex_tpu_torch.utils.profiling import span

__all__ = ["Corex", "NotFittedError", "resolve_config", "resolve_optimizer",
           "pick_fit_strategy", "resolve_restart_mesh_layout",
           "RESTART_AXIS"]


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


# matmul_precision -> torch.set_float32_matmul_precision on a CUDA device
_PRECISIONS = {"default": "highest", "highest": "highest",
               "float32": "highest", "high": "high",
               "tensorfloat32": "high", "bfloat16": "medium"}


def check_precision(cfg: CorexConfig) -> str:
    """The torch float32 matmul precision of `cfg.matmul_precision` on a
    CUDA device. Raises ValueError, by name, for a value the port does
    not run: the JAX package's dot-algorithm names ('BF16_BF16_F32_X3',
    'TF32_TF32_F32', ...) pick XLA algorithms that have no torch
    counterpart."""
    try:
        return _PRECISIONS[cfg.matmul_precision]
    except (KeyError, TypeError):
        raise ValueError(
            f"matmul_precision={cfg.matmul_precision!r} is not run by the "
            f"PyTorch port: it takes {tuple(_PRECISIONS)}; the JAX "
            f"package's dot-algorithm names select XLA dot algorithms, "
            f"which have no torch counterpart") from None


@contextlib.contextmanager
def precision_ctx(cfg: CorexConfig, device):
    """Matmul-precision scope of a fit program (the JAX package's
    `precision_ctx`): on a CUDA device torch's float32 matmul precision
    is set per `cfg.matmul_precision` ('default' keeps full float32,
    'high' runs TF32 products, 'bfloat16' torch's "medium"), on the CPU
    it is full float32 whatever the value. The caller's setting comes
    back on exit, an exception included. Scopes that must stay exact
    (the Gram build, the accumulation, the int8 wrap guard, the spectral
    init) nest `M.full_f32_matmul` inside it."""
    want = check_precision(cfg)
    if torch.device(device).type != "cuda":
        want = "highest"
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision(want)
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


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


def pick_fit_strategy(config: CorexConfig, n: int, p: int,
                      plan=None) -> str:
    """moment_strategy resolution for a fit, with the plan rule: a
    sample-sharding plan turns 'auto' from gram to samples, because
    distributing X over the mesh is the point of such a plan and a Gram
    operand carries no sample axis to shard."""
    strategy = config.pick_strategy(n, p)
    if (strategy == "gram" and plan is not None
            and (plan.shard_samples or plan.shard_slices)
            and not plan.shard_vars):
        if config.moment_strategy == "auto":
            return "samples"
        # an explicit 'gram': honored, but a sample-only plan has no axis
        # of the Gram operand to shard, so the mesh fit runs replicated
        warnings.warn(
            "moment_strategy='gram' with a ShardingPlan that shards only "
            "sample axes: a Gram operand carries no sample axis, so the "
            "mesh fit will run fully REPLICATED (every device holds the "
            "whole p x p operand and does the whole work). Use "
            "ShardingPlan(shard_vars=True) to shard the Gram rows, or "
            "moment_strategy='auto'/'samples' to shard the sample axis.")
    return strategy


RESTART_AXIS = "restarts"  # mesh axis the restart lanes split over


def resolve_restart_mesh_layout(mesh, plan):
    """Layout for `Corex(n_restarts>1).fit(mesh=...)`. Returns
    (strategy_plan, data_axis):

    - strategy_plan is what `pick_fit_strategy`/`_prepare_fit` see: the
      caller's plan when the mesh carries DATA_AXIS and the plan shards
      samples (the combined restarts x data layout; the operand is then
      prepared sharded, so the raw X never lands whole on one device),
      else None (restart-only: every rank holds the whole operand).
    - data_axis is the sample-sharding mesh axis for
      `parallel.restarts.fit_restarts_sharded`, or None. Callers drop it
      to None when the resolved strategy is not 'samples'.

    The lanes always split over the RESTART_AXIS ('restarts') mesh axis;
    var/factor/slice sharding has no restart-sweep form. Both raise by
    name."""
    if RESTART_AXIS not in mesh.mesh_dim_names:
        raise ValueError(
            f"n_restarts > 1 under fit(mesh=...): the restart lanes "
            f"shard over a mesh axis named {RESTART_AXIS!r}, but the "
            f"mesh has axes {tuple(mesh.mesh_dim_names)}. Build it with "
            f"that axis — make_mesh((({RESTART_AXIS!r}, n_devices),)), or "
            f"the combined restarts x data layout make_mesh"
            f"((({RESTART_AXIS!r}, a), ({DATA_AXIS!r}, b))) — or call "
            f"parallel.restarts.fit_restarts_sharded directly for a "
            f"custom axis name.")
    check_restart_plan(plan)
    if plan.shard_samples and DATA_AXIS in mesh.mesh_dim_names:
        return plan, DATA_AXIS
    return None, None


def check_restart_plan(plan) -> None:
    """A restart sweep splits its lanes over `restarts` and its rows over
    `data` only: var, factor and slice plans raise by name."""
    if plan.shard_vars or plan.shard_factors or plan.shard_slices:
        raise ValueError(
            "n_restarts > 1 under fit(mesh=...) supports sample "
            "sharding only (the combined restarts x data layout); "
            "var/factor/slice sharding has no restart-sweep program. "
            "Use n_restarts=1 for those layouts, or drop them from the "
            "ShardingPlan.")


def chain_mode(cfg: CorexConfig) -> bool:
    """The chain_kernel flag ops.moments takes."""
    return cfg.use_pallas == "always"


def _make_obj_grad(data, cfg: CorexConfig, strategy: str, model=None):
    """Close the active objective/direction over the data (X or Σ); under
    a factor split (`model`, an Axis) over this rank's rows of W. For
    optimizer='fixed_point' the returned "gradient" is the fixed-point
    residual ws − Ŵ, which the solver's plain-GD step turns into the
    damped update (1−γ)·ws + γ·Ŵ."""
    if cfg.optimizer == "auto":
        raise ValueError(
            "optimizer='auto' must be resolved against the data shapes "
            "before building the objective — call resolve_config(cfg, nv, "
            "device, n_samples=n) first (Corex.fit does)")
    if cfg.matmul_dtype == "int8" and not M.is_quantized(data):
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
    # the objective's scalars on the device, before its first evaluation
    M.prepare_constants(data, cfg.y_scale, torch_dtype(cfg.dtype), gram)
    if not cfg.discourage_overlap:
        # fixed_point + overlap is rejected by CorexConfig.__post_init__
        fn = M.overlap_obj_grad_gram if gram else M.overlap_obj_grad_samples
        return lambda ws, eps: fn(ws, data, eps, cfg.y_scale, model=model)
    bf16 = cfg.matmul_dtype == "bfloat16"
    chain = chain_mode(cfg)
    if cfg.optimizer == "fixed_point":
        fn = M.ns_fp_gram if gram else M.ns_fp_samples
    else:
        fn = M.ns_obj_grad_gram if gram else M.ns_obj_grad_samples
    return lambda ws, eps: fn(ws, data, eps, cfg.y_scale, cfg.rho_clip,
                              bf16=bf16, chain_kernel=chain, model=model)


def _fit_program(data, w0, cfg: CorexConfig, strategy: str, model=None,
                 mesh: bool = False):
    """The complete fit: annealed solve → final moments → factor sort.
    Returns (ws, Moments, FitDiagnostics). W0 of shape (k, m, p) fits k
    restart lanes and returns each with a leading lane axis. `mesh`: the
    fit runs over a device mesh (`parallel.sharding`,
    `parallel.restarts.fit_restarts_sharded`), so its solver loop is not
    captured into a CUDA graph (`core.solver.fit_core`).

    One fit runs in `precision_ctx(cfg)`. Restart lanes run at full
    float32 whatever `matmul_precision` says, as the JAX package's
    restart program applies no precision scope.

    Split W (`parallel.sharding`): `w0` is this rank's block, its columns
    over the operand's `var` axis, its rows over `model`. The solve runs
    on the blocks; the final W and moments are gathered whole before the
    sort, so the result is whole on every rank."""
    scope = M.full_f32_matmul() if w0.ndim == 3 else precision_ctx(
        cfg, w0.device)
    with scope:
        ws, diag = fit_core(_make_obj_grad(data, cfg, strategy, model), w0,
                            cfg, M.Split(M.var_of(data), model).w_axes,
                            _mesh=mesh)
        ws_sorted, mom = final_moments(data, ws, cfg, strategy, model)
        return ws_sorted, mom, diag


def final_moments(data, ws, cfg: CorexConfig, strategy: str, model=None):
    """The end of every fit: the moments at eps = 0 from the final W, then
    the factor sort by TCs. Returns (sorted ws, Moments), whole on every
    rank: under a split (`ws` this rank's block, as in `_fit_program`)
    the split moment functions run and W and the moments are gathered
    before the sort."""
    with span("lcx.final", sync=True):
        sp = M.Split(M.var_of(data), model)
        zero = torch.zeros((), dtype=ws.dtype, device=ws.device)
        if strategy == "gram":
            c_xy = M.cxy_gram(data, ws, zero)
        else:
            c_xy = M.cxy_samples(data, ws, zero)
        mom = M.moments_from_cxy(ws, c_xy, cfg.y_scale, cfg.rho_clip, *sp)
        if sp.w_axes:
            ws, mom = sp.whole_w(ws), M.whole_moments(mom, *sp)
        ws_sorted, order = sort_by_tcs(ws, mom.tcs)
        return ws_sorted, M.permute_moments(mom, order)


def _spectral_init(data, omega, strategy: str, matmul_dtype: str):
    """Randomized range-finder init (init='spectral'): W₀ = Qᵀ with
    Q·R = Σ_emp·Ω for a random (p, m) block Ω, so the rows of W start
    spanning the top-m subspace of Σ̂. One Σ-application through the
    solver's own operator (any operand mode), then a thin QR. An operand
    split over `var` applies Σ to this rank's rows of Ω, and the (p, m)
    product is gathered whole over `var` for the QR."""
    with span("lcx.init.spectral", sync=True):
        apply = M._apply_sigma_t(data, matmul_dtype == "bfloat16",
                                 strategy == "gram", omega.dtype)
        sp = M.Split(var=M.var_of(data))
        M.check_factorizable(omega.dtype, "QR")
        with M.full_f32_matmul():
            q, _ = torch.linalg.qr(sp.all_vars(apply(sp.my_vars(omega)))
                                   .to(omega.dtype))
        return q.T.contiguous()


def prepare_operand(xp, strategy: str, matmul_dtype: str,
                    check_overflow: bool = True):
    """The solver operand from preprocessed rows: X or its Gram matrix,
    cast to bf16 under matmul_dtype='bfloat16', or quantized with the
    int32 wrap guard under 'int8' (after preprocessing, whose
    standardized columns the per-tensor scale relies on; a warmup's
    synthetic operand passes check_overflow=False). `xp` may be a
    `ShardedSamples` block (the mesh-aware prepare): the Gram matrix then
    sums the ranks' partial products and comes out replicated, or as this
    rank's row block of Σ when the columns are split over `var`; the
    samples operand stays sharded."""
    with span("lcx.prepare.operand", sync=True):
        data = M.compute_gram(xp) if strategy == "gram" else xp
        if matmul_dtype == "bfloat16":
            if isinstance(data, M.ShardedSamples):
                return data._replace(local=data.local.to(torch.bfloat16))
            return data.to(torch.bfloat16)
        if matmul_dtype == "int8":
            return M.quantize_samples(data, check_overflow=check_overflow)
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


def _matmat_ns(rhoinvrho, si, std, v, var=None):
    """Σ̂·V for V (p, k) on the non-overlap path; p x p never forms.
    Under `var` every argument is this rank's block of variables and the
    (m, k) product Z·V is summed over `var`: the rows I of Σ̂·V."""
    z = _factor_z_ns(rhoinvrho, si)
    sv = std[:, None] * v
    low = M._mm(z.T, M.Split(var=var).vsum(M._mm(z, sv)))
    diag = torch.sum(z * z, dim=0)
    return std[:, None] * (low + (1.0 - diag)[:, None] * sv)


def _matmat_overlap(cy, c_xy, std, v, var=None):
    """Σ̂·V for V (p, k) on the overlap path; p x p never forms (the rows
    I of it under `var`, as `_matmat_ns`)."""
    sol = torch.linalg.solve(cy, c_xy.T)                   # m x p
    sv = std[:, None] * v
    low = M._mm(c_xy, M.Split(var=var).vsum(M._mm(sol, sv)))
    diag = torch.sum(c_xy * sol.T, dim=1)
    return std[:, None] * (low + (1.0 - diag)[:, None] * sv)


def _gaussian_ll(xp, z, std, axes=(), var=None):
    """Mean Gaussian log-likelihood of preprocessed rows under Σ̂_std =
    diag(d) + ZᵀZ (d = 1 − Σ_j z_ji², the unit-diagonal completion),
    through Woodbury and the matrix determinant lemma: O(n·p·m + m³), the
    p x p never materializes. The `− Σ log std` term maps the density back
    through the affine standardization to the data's own scale. Rows split
    over the mesh `axes`: the per-row likelihoods (n values) are gathered
    and the mean taken over all of them on every rank. Variables split
    over `var` (xp, z and std this rank's columns): the terms that sum
    over p, (m, m), (n_loc, m) and (n_loc,) blocks, are summed over
    `var`."""
    vs = M.Split(var=var).vsum
    p = xp.shape[1] * (var.size if var is not None else 1)
    mdim = z.shape[0]
    d = torch.clamp(1.0 - torch.sum(z * z, dim=0), min=1e-6)
    zd = z / d[None, :]
    a = torch.eye(mdim, dtype=z.dtype, device=z.device) + vs(M._mm(zd, z.T))
    chol = M._cholesky_or_nan(a)
    logdet = vs(torch.sum(torch.log(d))) + 2.0 * torch.sum(
        torch.log(torch.diagonal(chol)))
    t = xp / d[None, :]
    q1 = vs(torch.sum(xp * t, dim=1))
    u = vs(M._mm(t, z.T))                                    # n x m
    sol = torch.cholesky_solve(u.T, chol, upper=False)       # m x n
    q2 = torch.sum(u.T * sol, dim=0)
    log2pi = torch.log(torch.tensor(2.0 * math.pi, dtype=xp.dtype,
                                    device=xp.device))
    ll = all_gather_rows(-0.5 * (q1 - q2 + logdet + p * log2pi), axes)
    return torch.mean(ll) - vs(torch.sum(torch.log(std)))


def _cov_rows(z, std, start: int, block: int, z_cols=None, std_cols=None,
              col0: int = 0):
    """Dense rows [start, start + block) of Σ̂ from Z, scaled back by
    std. `z_cols`/`std_cols` (default: all of `z`/`std`): the columns of Z
    and std the rows are computed over, the first of them variable
    `col0` (this rank's block under `var`)."""
    z_cols = z if z_cols is None else z_cols
    std_cols = std if std_cols is None else std_cols
    rows = M._mm(z[:, start:start + block].T, z_cols)         # b x p_loc
    idx = torch.arange(block, device=z.device)
    cols = start + idx - col0
    on = (cols >= 0) & (cols < rows.shape[1])
    rows[idx[on], cols[on]] = 1.0         # the unit-diagonal completion
    return std[start:start + block, None] * std_cols[None, :] * rows


_DTYPES = {"float32": torch.float32, "float64": torch.float64,
           "bfloat16": torch.bfloat16, "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    """The compute dtype named by a `dtype=` argument: the one place the
    name is checked. 'bfloat16' and 'float16' run the momentum and
    gradient fits in that dtype, as the JAX package does; the paths that
    factorize a matrix raise NotImplementedError there
    (`ops.moments.check_factorizable`)."""
    if name not in _DTYPES:
        raise ValueError(f"dtype must be one of {tuple(_DTYPES)}, got "
                         f"{name!r}")
    return _DTYPES[name]


def numpy_to_torch(a: np.ndarray):
    """A host array as torch takes it. NumPy has no bfloat16: a JAX
    bfloat16 array arrives as an `ml_dtypes.bfloat16` array, which
    `torch.from_numpy` refuses, so it crosses bit for bit through its
    16-bit words. A 2-byte void array is what `np.load` makes of a
    bfloat16 array that `np.save` wrote: the file does not say its type,
    and it raises ValueError, as in the JAX package. Other arrays pass
    unchanged."""
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        if a.dtype.name == "bfloat16":
            return torch.tensor(a.view(np.int16)).view(torch.bfloat16)
        raise ValueError(
            "a 2-byte void array: np.save writes a bfloat16 array so, and "
            "the file does not record its type, so it cannot be read back "
            "as bfloat16 (the JAX package's load_corex raises on it too). "
            "Save a float32 or float16 model instead")
    return a


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


# ---------------------------------------------------------------------------
# The output rule: outputs follow the kind of their input (sklearn's
# array-API rule, and the upstream LinearCorex's NumPy in, NumPy out). A
# torch.Tensor in gives tensors on the model device out; anything else
# (NumPy arrays, lists, DataFrames, memmaps: what `_coerce_2d` turns into an
# array) gives numpy.ndarrays, read back once at the end of the call. The
# fitted attributes follow the input of the fit (`Corex._fit_kind`). Every
# public method goes through `as_kind`; internal callers take the private
# tensor paths (`_transform`, `_predict`) and never read back.
# ---------------------------------------------------------------------------

def input_kind(x) -> str:
    """'tensor' for a torch.Tensor, 'numpy' for anything else."""
    return "tensor" if isinstance(x, torch.Tensor) else "numpy"


def as_kind(out, kind: str):
    """`out` (a tensor, or a tuple, list or dict of them) as `kind`. For
    'numpy' each tensor is read back through `host_numpy` (bfloat16 as
    float32, exactly), as a copy where the tensor already lies on the host,
    so that no array shares storage with the model's state. A `DTensor` (a
    p-sized output under a `shard_vars` plan) stays one: gathering it would
    build the buffer the plan exists to avoid. Other values pass."""
    if kind == "tensor":
        return out
    if isinstance(out, (tuple, list)):
        return type(out)(as_kind(o, kind) for o in out)
    if isinstance(out, dict):
        return {k: as_kind(v, kind) for k, v in out.items()}
    dtensor = sys.modules.get("torch.distributed.tensor")
    if not isinstance(out, torch.Tensor) or (
            dtensor is not None and isinstance(out, dtensor.DTensor)):
        return out
    a = host_numpy(out)
    return a.copy() if out.device.type == "cpu" \
        and out.dtype != torch.bfloat16 else a


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
    # the ShardingPlan of the last mesh fit or mesh serving call; serving
    # calls with sharding_plan=None reuse it. None: single-device state.
    _serving_plan = None
    # the seed of an UNSEEDED mesh fit, shared by its ranks while it runs
    _mesh_seed = None
    # the kind of the input of the last fit: the fitted attributes' kind
    # (`as_kind`). A model built from a file or from NumPy arrays is 'numpy'.
    _fit_kind = "numpy"
    # set_output(transform='pandas') sets 'pandas'
    _output_transform = None

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
    def _fit_seed(self):
        """The seed the inits of the running fit draw from: `seed`, or
        under a mesh the one its ranks share (`sharding.shared_seed`)."""
        return self.seed if self._mesh_seed is None else self._mesh_seed

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
        with span("lcx.init.draw", sync=True):
            if self._fit_seed is None:
                gen = torch.Generator(device=self._device)
                gen.seed()
                return torch.randn((self.m, p), generator=gen, dtype=self._dt,
                                   device=self._device) / float(np.sqrt(p))
            rng = np.random.RandomState(self._fit_seed)
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

    def _check_width(self, x, what="x", move=True):
        """`_to_tensor`, then the fitted width. move=False validates
        without moving a host array to the device (a mesh call moves only
        this rank's rows)."""
        x = self._to_tensor(x, what) if move else self._validate_input(
            x, what)
        if x.shape[1] != self.nv:
            raise ValueError(
                f"{what} must be 2-D with {self.nv} columns (the fitted "
                f"n_variables); got shape {tuple(x.shape)}")
        return x

    def _as_tensor(self, a) -> torch.Tensor:
        """`a` (tensor or array-like) in the model dtype on the model
        device. A host array is taken in C order (a DataFrame's values
        are often in Fortran order), so that its products add in the
        order of a tensor's and the result is bitwise the tensor call's."""
        if not isinstance(a, torch.Tensor):
            a = numpy_to_torch(np.asarray(a, order="C"))
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
        with span("lcx.prepare.standardize", sync=True):
            xh = np.asarray(x, dtype=np.float64)
            if pre.missing_values is not None:
                xh = native.mean_impute(xh, pre.missing_values)
            std = xh.std(0)
            theta = P.Theta(
                mean=self._as_tensor(xh.mean(0)),
                std=self._as_tensor(np.where(std < 1e-10, 1.0, std)))
            return self._as_tensor(native.empirical_gaussianize(xh)), theta

    def _prepare_fit(self, x, resolve=True, plan=None, mesh=None,
                     check_overflow=True):
        """Input validation, preprocessing (sets theta/nv/n_samples and
        the kind of the fitted attributes, `_fit_kind`),
        moment-strategy choice and 'auto' resolution. Returns (data, cfg,
        strategy) with data the solver operand: X or the Gram matrix,
        cast to bf16 under matmul_dtype='bfloat16' or quantized (after
        preprocessing, whose standardized columns the per-tensor scale
        relies on, and checked by the int32 wrap guard) under 'int8'.
        A full fit is fresh: it drops any `partial_fit` accumulation.

        resolve=False leaves use_pallas='auto' for a sharded fit that
        resolves it against its own mesh. `plan` (a ShardingPlan, mesh
        fits only) informs moment_strategy='auto' (`pick_fit_strategy`).
        With `mesh`, each rank takes its block of the raw X per the plan
        (rows over the sample axes, columns over `var`) BEFORE anything
        else, so neither the raw nor the standardized X ever lies whole
        on one device: the column statistics come from per-rank sums over
        the sample axes (they are per column, so local over `var`; theta
        is then gathered whole), and the operand comes out as
        `ShardedSamples` (a Gram operand as the sum of the ranks'
        products: replicated, or Σ row blocks under `shard_vars`). The
        native host route of 'empirical' is skipped under a mesh.
        check_overflow=False leaves out the int8 wrap guard (a warmup's
        synthetic operand)."""
        with span("lcx.prepare", sync=True):
            self._partial_acc = None
            self._fit_kind = input_kind(x)
            x = self._validate_input(x)
            self.n_samples, self.nv = x.shape
            if self.n_samples < 2:
                raise ValueError(f"need at least 2 samples to fit, got "
                                 f"n_samples={self.n_samples}")
            if self.nv < self.m:
                warnings.warn(
                    f"n_hidden={self.m} exceeds n_variables={self.nv}; "
                    f"surplus factors will converge to zero TC")
            strategy = pick_fit_strategy(self.config, self.n_samples, self.nv,
                                         plan)
            if resolve:
                cfg = resolve_config(self.config, self.nv, self._device,
                                     n_samples=self.n_samples)
            else:
                # the optimizer policy depends on the data shapes only:
                # resolved here, where n is still known
                cfg = resolve_optimizer(self.config, self.nv, self.n_samples)
            self.resolved_optimizer_ = cfg.optimizer
            pre = self.pre_config
            if mesh is not None:
                # raw_x=True: the rows of the RAW X are split per x_spec for
                # every strategy, so the sample-axis check applies to gram too
                S.validate_plan_shapes(plan, strategy, mesh, self.n_samples,
                                       self.nv, self.m, raw_x=True)
                axes = S.sample_axes(mesh, plan)
                var = S.var_axis(mesh, plan)
                block = S.shard_block(x, axes, var, self._device, self._dt)
                with span("lcx.prepare.standardize", sync=True):
                    xp, theta = P.fit_preprocess(
                        block, pre.gaussianize, pre.missing_values, axes)
                    whole = M.Split(var=var).all_vars
                    self.theta = P.Theta(mean=whole(theta.mean),
                                         std=whole(theta.std))
                if axes or var is not None:
                    xp = M.ShardedSamples(local=xp, n_total=self.n_samples,
                                          axes=axes, p_total=self.nv, var=var)
                return prepare_operand(xp, strategy, cfg.matmul_dtype,
                                       check_overflow), cfg, strategy
            host = self._host_preprocess(x)
            if host is not None:
                xp, self.theta = host
            else:
                x = self._as_tensor(x)
                with span("lcx.prepare.standardize", sync=True):
                    xp, self.theta = P.fit_preprocess(
                        x, pre.gaussianize, pre.missing_values)
            return prepare_operand(xp, strategy, cfg.matmul_dtype,
                                   check_overflow), cfg, strategy

    def _resolve_w0(self, init_ws, data=None, strategy=None) -> torch.Tensor:
        """Initial weights: explicit init_ws > shape-matching pretrained
        weights > a fresh init per config.init ('random', or 'spectral',
        which needs the prepared operand, so fit passes (data,
        strategy))."""
        with span("lcx.init", sync=True):
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
                return _spectral_init(data, self._omega(self._fit_seed),
                                      strategy, self.config.matmul_dtype)
            return self._init_ws(self.nv)

    def _omega(self, seed):
        """The spectral init's random (p, m) block Ω. It follows the
        random init's seeding: seeded → NumPy RandomState(seed) (the JAX
        package's Ω), unseeded → the device generator, fresh entropy."""
        with span("lcx.init.draw", sync=True):
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
        base = R.seed_base(self._fit_seed)
        outs = []
        for r in range(restarts):
            if self._fit_seed is None:
                gen = torch.Generator(device=self._device).manual_seed(
                    base + r)
                omega = torch.randn((self.nv, self.m), generator=gen,
                                    dtype=self._dt, device=self._device)
            else:
                omega = self._omega(base + r)
            outs.append(_spectral_init(data, omega, strategy,
                                       self.config.matmul_dtype))
        return torch.stack(outs)

    def _fit_restart_sweep(self, data, cfg, strategy, restarts,
                           mesh=None, data_axis=None, serving_plan=None):
        """n_restarts > 1: the lanes run as one solve and the best final
        TC wins (`best_restart_` records the lane). Lane r starts from
        RandomState(seed + r), so lane 0 is the plain Corex(seed=seed) fit
        and the sweep is reproducible; seed=None draws a fresh base per
        call (`parallel.restarts.init_restarts`).

        With `mesh` the lanes split over its RESTART_AXIS (and the sample
        rows over `data_axis` when given: the combined layout;
        `resolve_restart_mesh_layout` decided both). The runner pads the
        batch to the axis size with copies of the last init and drops
        them, so the winner is the single-device sweep's. cfg arrives
        unresolved (use_pallas='auto') and is resolved against the mesh."""
        check_restart_sweep_supported(cfg, strategy)
        run = R.restart_batch_runner(mesh, RESTART_AXIS, data_axis)
        with R.lane_oom_guidance(restarts, self.m, self.nv,
                                 torch.empty((), dtype=self._dt)
                                 .element_size()):
            with span("lcx.init", sync=True):
                if cfg.init == "spectral":
                    w0 = self._spectral_restart_inits(data, strategy,
                                                      restarts)
                else:
                    w0 = R.init_restarts(restarts, self.m, self.nv,
                                         self._fit_seed, self._dt,
                                         self._device)
            ws_b, mom_b, diag_b = run(data, w0, cfg, strategy,
                                      self.n_samples)
            self.ws, self.moments, self.diagnostics, best = \
                R.best_restart(ws_b, mom_b, diag_b)
        self.best_restart_ = best
        # combined layout: the caller's sample plan is a valid serving
        # layout on this mesh; a restart-only sweep records None (the
        # 'restarts' axis is a fit-time concept)
        self._serving_plan = serving_plan
        if self.verbose:
            self._print_verbose()
        return self

    def fit(self, x, y=None, init_ws=None, mesh=None, sharding_plan=None):
        """Fit the model. `y` is ignored (unsupervised; accepted for
        sklearn Pipelines). `mesh` (a torch.distributed DeviceMesh; see
        `parallel.sharding` for the model of execution) runs the same
        annealed fit with the sample rows split over the mesh's ranks per
        `sharding_plan` (a `ShardingPlan`, default: rows over `data`);
        every rank makes this call with the same arguments and ends with
        the same state, bit for bit. `ShardingPlan(shard_vars=True)`
        splits the variables over the mesh's `var` axis (X's columns, W's
        columns, Σ's rows when the gram strategy is kept) and
        `shard_factors=True` W's rows over its `model` axis, alone or with
        the sample axes.

        With `n_restarts=k > 1` the fit runs k seeded lanes as one solve
        and keeps the best final TC (`_fit_restart_sweep`); init='spectral'
        sweeps draw one Ω per lane. Under `mesh=` the lanes split over the
        mesh's 'restarts' axis, and the sample rows over its 'data' axis
        too when the plan shards samples
        (`resolve_restart_mesh_layout`). A warm start or stage_subsample
        < 1 with restarts, var/factor/slice plans with restarts and a
        mesh without a 'restarts' axis raise by name."""
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
        ensure_compile_cache()
        try:
            return self._fit(x, init_ws, mesh, sharding_plan)
        finally:
            self._mesh_seed = None

    def _fit(self, x, init_ws, mesh, sharding_plan, check_overflow=True):
        """The fit after `fit`'s check of `y`; `warmup_fit` runs it on a
        copy of the model with check_overflow=False (no wrap guard on its
        synthetic operand)."""
        with span("lcx.fit"):
            restarts = self._validated_restarts(init_ws)
            check_precision(self.config)
            plan = None
            if mesh is not None:
                plan = sharding_plan or ShardingPlan()
                if restarts > 1:
                    check_restart_plan(plan)
                S.check_mesh(mesh, self._device)
                self._mesh_seed = S.shared_seed(self.seed, mesh, self._device)
                if restarts > 1:
                    strategy_plan, data_axis = resolve_restart_mesh_layout(
                        mesh, plan)
                    xsh = getattr(x, "shape", None)
                    if self.config.stage_subsample < 1.0 and xsh is not None \
                            and len(xsh) == 2:
                        # raise before the rows move; _fit_restart_sweep
                        # checks again on the validated shapes
                        check_restart_sweep_supported(
                            self.config,
                            pick_fit_strategy(self.config, xsh[0], xsh[1],
                                              strategy_plan))
                    data, cfg, strategy = self._prepare_fit(
                        x, resolve=False, plan=strategy_plan,
                        mesh=mesh if strategy_plan is not None else None,
                        check_overflow=check_overflow)
                    if strategy != "samples":
                        # an explicit moment_strategy='gram' under a sample
                        # plan runs replicated (pick_fit_strategy warned)
                        data_axis = None
                    return self._fit_restart_sweep(
                        data, cfg, strategy, restarts, mesh=mesh,
                        data_axis=data_axis,
                        serving_plan=plan if data_axis is not None else None)
            data, cfg, strategy = self._prepare_fit(
                x, resolve=mesh is None, plan=plan, mesh=mesh,
                check_overflow=check_overflow)
            if restarts > 1:
                return self._fit_restart_sweep(data, cfg, strategy, restarts)
            w0 = self._resolve_w0(init_ws, data=data, strategy=strategy)
            if mesh is not None:
                if stage_subsample_active(cfg, strategy):
                    raise ValueError(
                        "stage_subsample < 1 is not supported under "
                        "fit(mesh=...) yet: a stride slice of the sharded "
                        "sample axis would leave the ranks with unequal row "
                        "blocks mid-fit. Run the mesh fit with "
                        "stage_subsample=1, or fit single-device.")
                # check_overflow=False: _prepare_fit guarded this operand
                self.ws, self.moments, self.diagnostics = S.fit_sharded(
                    data, w0, cfg, mesh, plan, strategy,
                    n_samples=self.n_samples, check_overflow=False)
                self._serving_plan = plan  # mesh serving calls default to it
            else:
                fit = _fit_staged_subsample if stage_subsample_active(
                    cfg, strategy) else _fit_program
                self.ws, self.moments, self.diagnostics = fit(data, w0, cfg,
                                                              strategy)
                self._serving_plan = None  # state is single-device again
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
        hist = host_numpy(d.tc_history)
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
        if mesh is not None and sharding_plan is None \
                and self._serving_plan is None:
            # a restart-only sweep: the mesh carries no serving axes and
            # the winning lane's state is whole on every rank, so each
            # transforms on its own. An explicit plan is honored (and
            # fails its validation by name).
            return self.transform(x)
        return self.transform(x, mesh=mesh, sharding_plan=sharding_plan)

    def _serving_layout(self, mesh, sharding_plan, n_rows=None):
        """Resolve, validate and remember the serving plan of a mesh call
        (`sharding_plan`, else the plan of the last mesh fit or serving
        call, else rows over `data`). Returns None without a mesh, else
        (sample axes, Split): the axes this call's rows split over and the
        `var` / `model` axes of the plan. The fitted state is whole on
        every rank; each method takes its block of it."""
        if mesh is None:
            return None
        plan = sharding_plan or self._serving_plan or ShardingPlan()
        S.check_mesh(mesh, self._device)
        S.validate_plan_shapes(plan, "samples", mesh, n_rows, self.nv,
                               self.ws.shape[0], raw_x=True)
        self._serving_plan = plan
        return S.sample_axes(mesh, plan), M.Split(S.var_axis(mesh, plan),
                                                  S.factor_axis(mesh, plan))

    def _serving_input(self, a, layout, cols=True):
        """This rank's block of a serving input (rows over the sample
        axes; columns over `var` when `cols`), on the model device."""
        if layout is None:
            return self._as_tensor(a)
        axes, sp = layout
        return S.shard_block(a, axes, sp.var if cols else None,
                             self._device, self._dt)

    def _check_fitted(self):
        if self.ws is None or self.moments is None:
            _raise_not_fitted(
                "this Corex instance is not fitted yet; call fit(X) first")

    def transform(self, x, details=False, mesh=None, sharding_plan=None):
        """Project to factors: Y = X_preproc·Wᵀ. With details=True returns
        (Y, moments dict) with the moments of the given data under the
        fitted weights (the reference's keys). Y and the moments are of
        the kind of `x` (`as_kind`: a tensor in, tensors on the model
        device out; else numpy arrays). Under
        set_output(transform='pandas') the plain return is a DataFrame.

        `mesh` (+ optional `sharding_plan`, default: the last mesh fit's,
        else rows over `data`) splits `x` per the plan: each rank
        projects its block (its rows over the sample axes, its columns
        over `var`, W's rows over `model`); the (n_loc, m) partials are
        summed over `var`, the factor columns gathered over `model` and
        the rows over the sample axes, so the (n, m) result is whole on
        every rank."""
        out = self._transform(x, details, mesh, sharding_plan)
        if not details and self._output_transform == "pandas":
            return self._as_frame(out, x)
        return as_kind(out, input_kind(x))

    def _transform(self, x, details=False, mesh=None, sharding_plan=None):
        """`transform` in tensors on the model device, for internal
        callers (the layers of `StackedCorex`)."""
        self._check_fitted()
        x = self._check_width(x, move=False)
        n = x.shape[0]
        layout = self._serving_layout(mesh, sharding_plan, n)
        axes, sp = layout or ((), M.NO_SPLIT)
        x = self._serving_input(x, layout)
        pre = self.pre_config
        cfg = self.config
        ws = sp.mine(sp.my_vars(self.ws, -1), -2)
        with M.full_f32_matmul():
            xp = P.preprocess(x, pre.gaussianize, self._theta_block(sp),
                              pre.missing_values, axes)
            y = all_gather_rows(sp.all_factors(sp.vsum(M._mm(xp, ws.T))),
                                axes)
            if not details:
                return y
            zero = torch.zeros((), dtype=self.ws.dtype, device=x.device)
            if axes or sp.var is not None:
                xp = M.ShardedSamples(local=xp, n_total=n, axes=axes,
                                      p_total=self.nv, var=sp.var)
            c_xy = M.cxy_samples(xp, ws, zero)
            mom = M.moments_from_cxy(ws, c_xy, cfg.y_scale, cfg.rho_clip,
                                     *sp)
            if sp.w_axes:
                mom = M.whole_moments(mom, *sp)
        return y, mom.asdict()

    def _theta_block(self, sp):
        """Theta on this rank's variables."""
        return P.Theta(mean=sp.my_vars(self.theta.mean, -1),
                       std=sp.my_vars(self.theta.std, -1))

    def predict(self, y, mesh=None, sharding_plan=None):
        """Reconstruct variables from factors: the posterior-mean
        reconstruction, then the preprocessing inverted. The argument is
        the FACTOR matrix (n, m) from `transform` (the reference's
        semantics); `inverse_transform` is the sklearn spelling. Under
        `mesh` the rows of `y` split over the plan's sample axes and the
        (n, p) reconstruction is gathered onto every rank; under
        `shard_vars` each rank reconstructs its columns only and the
        result is a `DTensor` split over the sample axes (rows) and `var`
        (columns), never gathered: `.full_tensor()` gathers it. The
        result is of the kind of `y` (`as_kind`)."""
        return as_kind(self._predict(y, mesh, sharding_plan), input_kind(y))

    def _predict(self, y, mesh=None, sharding_plan=None):
        """`predict` in tensors on the model device, for internal callers
        (the layers of `StackedCorex`)."""
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
        layout = self._serving_layout(mesh, sharding_plan, y.shape[0])
        axes, sp = layout or ((), M.NO_SPLIT)
        y = self._serving_input(y, layout, cols=False)
        mom = self.moments
        cols = M.Split(var=sp.var)
        with M.full_f32_matmul():
            if self.config.discourage_overlap:
                out = _predict_ns(y, cols.my_vars(mom.rhoinvrho, -1),
                                  cols.my_vars(mom.si, -1), mom.z2,
                                  self._theta_block(cols))
            else:
                out = _predict_overlap(y, mom.cy, cols.my_vars(mom.c_xy),
                                       self._theta_block(cols))
        if sp.var is not None:
            return S.as_dtensor(out, mesh, {**{a.name: 0 for a in axes},
                                            sp.var.name: 1})
        return all_gather_rows(out, axes)

    def inverse_transform(self, y, mesh=None, sharding_plan=None):
        """sklearn spelling of `predict`: factors (n, m) back to the
        variable space (n, p)."""
        return self.predict(y, mesh=mesh, sharding_plan=sharding_plan)

    def get_covariance(self):
        """Dense p x p factor-model covariance estimate. For large p prefer
        `covariance_matvec`/`matmat`/`blocks`, which never materialize
        it. Raises by name on var-sharded state (the last mesh fit or
        serving call had `ShardingPlan(shard_vars=True)`): the dense p x p
        is the buffer that plan exists to avoid. Of the kind of the fit's
        input, as the fitted attributes."""
        self._check_fitted()
        if self._serving_plan is not None and self._serving_plan.shard_vars:
            raise ValueError(
                "get_covariance() on var-sharded state (the model was fit "
                "or served under ShardingPlan(shard_vars=True)): the dense "
                "p x p export would materialize exactly the buffer the "
                "plan shards away. Use covariance_blocks(mesh=...) for "
                "dense row blocks per the plan, or covariance_matvec/"
                "covariance_matmat(mesh=...) to apply Σ̂ without "
                "materializing it.")
        mom = self.moments
        with M.full_f32_matmul():
            if self.config.discourage_overlap:
                cov = _cov_ns(mom.rhoinvrho, mom.si, self.theta.std)
            else:
                cov = _cov_overlap(mom.cy, mom.c_xy, self.theta.std)
        return as_kind(cov, self._fit_kind)

    def score(self, x, y=None, mesh=None, sharding_plan=None):
        """Mean Gaussian log-likelihood of `x` under the fitted factor
        covariance (the sklearn scoring convention: higher is better; `y`
        is ignored). Woodbury on the diagonal-plus-low-rank Σ̂: O(n·p·m),
        the p x p never materializes. Only the affine gaussianize modes
        ('none', 'standard') carry a density back to the data's scale.
        Under `mesh` each rank scores its block (under `shard_vars` its
        columns, the sums over p reduced over `var`) and the mean is over
        all rows. A Python float, whatever the input's kind."""
        del y
        self._check_fitted()
        pre = self.pre_config
        if pre.gaussianize not in ("none", "standard"):
            raise ValueError(
                "score() requires gaussianize='none' or 'standard': the "
                "'empirical'/'outliers' transforms are non-affine, so a "
                "density on the original scale is not defined by Σ̂ alone")
        x = self._check_width(x, move=False)
        layout = self._serving_layout(mesh, sharding_plan, x.shape[0])
        axes, sp = layout or ((), M.NO_SPLIT)
        x = self._serving_input(x, layout)
        cols = M.Split(var=sp.var)
        theta = self._theta_block(cols)
        with M.full_f32_matmul():
            xp = P.preprocess(x, pre.gaussianize, theta, pre.missing_values,
                              axes)
            return float(_gaussian_ll(xp, self._factor_z(cols), theta.std,
                                      axes, sp.var))

    def _covariance_apply(self, v, var=None):
        """Σ̂·V on this rank's rows of Σ̂ (all of them without `var`)."""
        mom = self.moments
        sp = M.Split(var=var)
        v = sp.my_vars(self._as_tensor(v))
        std = sp.my_vars(self.theta.std, -1)
        with M.full_f32_matmul():
            if self.config.discourage_overlap:
                return _matmat_ns(sp.my_vars(mom.rhoinvrho, -1),
                                  sp.my_vars(mom.si, -1), std, v, var)
            return _matmat_overlap(mom.cy, sp.my_vars(mom.c_xy), std, v,
                                   var)

    def _var_split_output(self, out, mesh, layout):
        """A (p, ...) serving output: a `DTensor` with its rows over `var`
        under a var plan, else the tensor itself."""
        if layout is None or layout[1].var is None:
            return out
        return S.as_dtensor(out, mesh, {layout[1].var.name: 0})

    def covariance_matvec(self, v, mesh=None, sharding_plan=None):
        """Σ̂·v through skinny products (the p x p never forms); equal to
        `get_covariance() @ v` to rounding on both solver paths. Under a
        var plan each rank computes its rows, returned as a `DTensor`
        split over `var`. The result is of the kind of `v` (`as_kind`)."""
        self._check_fitted()
        layout = self._serving_layout(mesh, sharding_plan)
        if not isinstance(v, torch.Tensor):
            v = np.asarray(v)
        if v.ndim != 1 or v.shape[0] != self.nv:
            raise ValueError(
                f"v must be 1-D with {self.nv} entries (the fitted "
                f"n_variables); got shape {tuple(v.shape)} — use "
                f"covariance_matmat for (p, k) blocks")
        out = self._covariance_apply(v[:, None], layout and layout[1].var)
        return as_kind(self._var_split_output(out[:, 0], mesh, layout),
                       input_kind(v))

    def covariance_matmat(self, v, mesh=None, sharding_plan=None):
        """Σ̂·V for a (p, k) block of vectors in one pass of skinny
        products (a `DTensor` of this rank's rows under a var plan). Of
        the kind of `v`, as `covariance_matvec`."""
        self._check_fitted()
        layout = self._serving_layout(mesh, sharding_plan)
        if not isinstance(v, torch.Tensor):
            v = np.asarray(v)
        if v.ndim != 2 or v.shape[0] != self.nv:
            raise ValueError(
                f"v must be 2-D with {self.nv} rows (the fitted "
                f"n_variables); got shape {tuple(v.shape)}")
        out = self._covariance_apply(v, layout and layout[1].var)
        return as_kind(self._var_split_output(out, mesh, layout),
                       input_kind(v))

    def _factor_z(self, sp=M.NO_SPLIT):
        """The covariance factorization Z (m x p) of either solver path:
        Σ̂_std has off-diagonal ZᵀZ and unit diagonal. Its columns on this
        rank's variables under `sp.var`."""
        mom = self.moments
        if self.config.discourage_overlap:
            return _factor_z_ns(sp.my_vars(mom.rhoinvrho, -1),
                                sp.my_vars(mom.si, -1))
        return _factor_z_overlap(mom.cy, sp.my_vars(mom.c_xy))

    def covariance_blocks(self, block_size: int = 4096, mesh=None,
                          sharding_plan=None):
        """Yield `(start, rows)` dense row blocks of `get_covariance()`,
        in order over [0, p), without forming the p x p matrix; `rows` has
        shape (min(block_size, p - start), p). Every block is computed at
        one size (the last as the tail of a full block). Under a var plan
        each rank computes its columns of every block, yielded as a
        `DTensor` split over `var` (equal to the single-device block bit
        for bit: the contraction over m is never split). The rows are of
        the kind of the fit's input, as the fitted attributes."""
        self._check_fitted()
        layout = self._serving_layout(mesh, sharding_plan)
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        p = self.nv
        b = min(block_size, p)
        cols = M.Split(var=layout and layout[1].var)
        with M.full_f32_matmul():
            z = self._factor_z()
            z_cols = self._factor_z(cols) if cols.var else z
        std_cols = cols.my_vars(self.theta.std, -1)
        col0 = cols.var.index * z_cols.shape[1] if cols.var else 0
        start = 0
        while start < p:
            s = min(start, p - b)
            with M.full_f32_matmul():
                rows = _cov_rows(z, self.theta.std, s, b, z_cols, std_cols,
                                 col0)
            tail = rows[start - s:]
            if cols.var is not None:
                tail = S.as_dtensor(tail, mesh, {cols.var.name: 1})
            yield start, as_kind(tail, self._fit_kind)
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
    def tcs(self):
        """Per-factor total correlation (sorted decreasing), of the kind of
        the fit's input (`as_kind`), as `mis` and `clusters`."""
        return as_kind(self.moments.tcs, self._fit_kind)

    @property
    def tc(self) -> float:
        return float(torch.sum(self.moments.tcs))

    @property
    def mis(self):
        """MI matrix I(x_i; y_j), shape (m, p)."""
        return as_kind(self.moments.mi, self._fit_kind)

    @property
    def clusters(self):
        """Hard assignment of each variable to argmax_j I(x_i; y_j)."""
        return as_kind(torch.argmax(self.moments.mi, dim=0), self._fit_kind)

    @property
    def history(self) -> dict:
        """Reference-style history dict built from the fit diagnostics."""
        if self.diagnostics is None:
            raise RuntimeError(
                "no fit diagnostics available; call fit(X) first")
        d = self.diagnostics
        iters = d.iters_per_stage.cpu().numpy()
        out = {"iters_per_stage": iters, "TC": [], "eps": []}
        hist = host_numpy(d.tc_history)
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
        kept); 'default' restores the input's kind (`as_kind`); None
        changes nothing."""
        if transform is None:
            return self
        if transform not in ("default", "pandas"):
            raise ValueError(
                f"set_output transform must be 'default' or 'pandas', "
                f"got {transform!r}")
        self._output_transform = None if transform == "default" \
            else transform
        return self

    def _as_frame(self, z, x_orig):
        """The pandas output of `transform`: a DataFrame of the (n, m)
        tensor `z`, the index of a DataFrame `x_orig` kept."""
        import pandas as pd
        index = x_orig.index if hasattr(x_orig, "index") \
            and hasattr(x_orig, "columns") else None
        return pd.DataFrame(host_numpy(z),
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
        continues it. `y` is ignored.

        `mesh=` (with an optional `shard_vars` `sharding_plan=`) keeps the
        accumulated state as Σ row blocks over the mesh's `var` axis and
        solves through `parallel.fit_sharded` (see `GramAccumulator`). The
        layout binds on the first call of a stream; later calls may omit
        it, and a different mesh or plan mid-stream raises (compared by
        value: a mesh rebuilt alike per call is the same layout).

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
            GramAccumulator, _solve_from_moments)
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
        check_precision(self.config)
        kind = input_kind(x)
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
        if acc is not None and (
                (mesh is not None and mesh != acc.mesh)
                or (sharding_plan is not None
                    and sharding_plan != acc.plan)):
            raise ValueError(
                "partial_fit received a different mesh/sharding_plan "
                "mid-stream; the accumulation layout binds on the first "
                "call (resharding a live accumulation would hide a "
                "wrong-mesh fault) — finish the stream, or start a fresh "
                "one (fit resets it, or use a new estimator)")
        if acc is None:
            acc = GramAccumulator(x.shape[1], dtype=self.config.dtype,
                                  device=self._device, mesh=mesh,
                                  sharding_plan=sharding_plan)
        # host arrays were screened for NaN/inf above: hand the
        # accumulator a tensor, so update() does not scan them again.
        # Under a mesh a host batch stays on the host: update() copies
        # only this rank's columns to the device.
        acc.update(self._as_tensor(x) if acc.mesh is None else x)
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
                            init_ws=warm, mesh=acc.mesh, plan=acc.plan,
                            kind=kind)
        if self.verbose:
            self._print_verbose()
        return self

    def warmup(self, n_samples, n_variables, mesh=None,
               sharding_plan=None):
        """Run the fit's programs once for declared input shapes, on
        synthetic operands (`utils.compile_cache.warmup_fit`): the first
        real `fit(X)` of this process on matching shapes then builds and
        loads nothing. The model stays unfitted. Returns self."""
        warmup_fit(self, n_samples, n_variables, mesh=mesh,
                   sharding_plan=sharding_plan)
        return self

    def __repr__(self):
        fitted = "" if self.ws is None else (
            f", fitted: nv={self.nv}, n_samples={self.n_samples}, "
            f"tc={self.tc:.4f}")
        return (f"Corex(n_hidden={self.n_hidden}, "
                f"discourage_overlap={self.discourage_overlap}, "
                f"gaussianize={self.gaussianize!r}, "
                f"optimizer={self.optimizer!r}, dtype={self.dtype!r}, "
                f"device={self.device!r}{fitted})")

