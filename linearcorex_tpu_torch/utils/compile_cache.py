"""The port's build directory, and the deploy-time warmups.

Port of `linearcorex_tpu/utils/compile_cache.py`. The JAX package compiles
XLA programs and keeps them in JAX's persistent compilation cache; its
warmups lower and compile a call's programs for declared shapes, so that
the first real call of a process loads instead of compiling. The port
compiles too, at first use: the chain kernel with nvcc and the host
library with g++ (`utils.build`). And a fresh process pays, at its first
call of each kind, for the CUDA context, the cuBLAS and cuSOLVER handles
and workspaces, and the first load of every kernel module that is loaded
lazily.

`ensure_compile_cache` decides the directory the builds go to, once per
process:
- a directory set by an earlier call (or by that call's `cache_dir`) is
  kept: the call is idempotent;
- `LINEARCOREX_TPU_NO_COMPILE_CACHE=1` opts out: it returns None, and
  builds go to a directory private to the process, removed at exit, so
  nothing is reused across processes;
- `LINEARCOREX_TPU_CACHE_DIR=<dir>` moves the directory. The JAX package
  reads the same variable for its XLA cache; the file names differ, so
  both packages may share one directory;
- the default is `linearcorex_tpu_torch/_build/` beside the sources, on
  the CPU too (the host library is built for CPU models);
- a directory that cannot be created or written returns None, and builds
  go to the private directory; the first such build warns once, naming
  `LINEARCOREX_TPU_CACHE_DIR`.
Every fit-shaped entry point calls it, as in the JAX package; it only
records the choice. `utils.build` asks `build_dir()` at build time, which
makes the directory.

The warmups (`warmup_fit`, `Corex.warmup`, `warmup_serving`, and
`models.selection.warmup_sweep`) are PyTorch's counterpart of an
ahead-of-time compile. Each runs the call it warms through the call's own
code, once, at the declared shapes, on synthetic operands made on the
model's device from a private `torch.Generator` and on a copy of the
model: a fit or a sweep cut to one iteration a stage, the serving calls on
synthetic fitted state. That builds and loads every library the call uses,
so the first real call of the process builds nothing, creates no handle
and loads no module. Where the JAX package lowers without data, these
execute; they touch no model and no random stream of the caller, and the
int8 wrap guard never runs on their synthetic values.
"""

from __future__ import annotations

import atexit
import math
import os
import shutil
import tempfile
import warnings
from pathlib import Path
from typing import Optional

import torch

__all__ = ["ensure_compile_cache", "build_dir", "warmup_fit",
           "warmup_serving"]

# the directory of this process's builds, once decided
_cache_dir: Optional[str] = None
# the opt-out's (or an unusable directory's) private directory
_private_dir: Optional[str] = None
_warned = False

# every synthetic operand of a warmup is drawn from a generator seeded so
SYNTHETIC_SEED = 0


def ensure_compile_cache(cache_dir: Optional[str] = None) -> Optional[str]:
    """Decide the directory the port's builds go to (idempotent,
    opt-out-able; see the module docstring for the policy). Returns it, or
    None when the cache is off or its directory unusable. It only decides:
    the directory is made by the first build (`build_dir`)."""
    global _cache_dir
    if os.environ.get("LINEARCOREX_TPU_NO_COMPILE_CACHE"):
        return None
    if _cache_dir is not None:
        return _cache_dir
    from linearcorex_tpu_torch.utils import build
    cache_dir = (cache_dir or os.environ.get("LINEARCOREX_TPU_CACHE_DIR")
                 or str(build.BUILD_DIR))
    if not _creatable(cache_dir):
        return None
    _cache_dir = cache_dir
    return cache_dir


def _creatable(path: str) -> bool:
    """Whether `path` is a writable directory or could be made one: its
    nearest existing ancestor is a directory this process may write."""
    path = os.path.abspath(path)
    while not os.path.exists(path):
        path = os.path.dirname(path)
    return os.path.isdir(path) and os.access(path, os.W_OK | os.X_OK)


def build_dir() -> Path:
    """The directory `utils.build` writes to now, made if need be:
    `ensure_compile_cache()`'s, or, when that is None, a temporary
    directory private to this process and removed at its exit. Falling
    back for an unusable directory warns once."""
    global _private_dir, _warned
    chosen = ensure_compile_cache()
    if chosen is not None:
        try:
            os.makedirs(chosen, exist_ok=True)
            return Path(chosen)
        except OSError:
            pass
    if not os.environ.get("LINEARCOREX_TPU_NO_COMPILE_CACHE") and not _warned:
        _warned = True
        warnings.warn(
            "linearcorex_tpu_torch cannot write its build directory "
            f"{chosen or os.environ.get('LINEARCOREX_TPU_CACHE_DIR')!r}: the "
            "kernels are built into a directory private to this process "
            "and rebuilt by every process. Set LINEARCOREX_TPU_CACHE_DIR "
            "to a writable directory to keep them.")
    if _private_dir is None:
        _private_dir = tempfile.mkdtemp(prefix="linearcorex_tpu_torch_")
        atexit.register(shutil.rmtree, _private_dir, True)
    return Path(_private_dir)


def synthetic_generator(device) -> torch.Generator:
    """The private generator a warmup draws its operands from."""
    return torch.Generator(device=device).manual_seed(SYNTHETIC_SEED)


def synchronize(device) -> None:
    """Wait for the card (a warmup's wall holds its work)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _shadow(model, **params):
    """A new `Corex` with `model`'s parameters (updated by `params`) and
    the state a fit or a serving call reads besides them: a warmup runs
    its calls on this copy and leaves `model` as it was."""
    from linearcorex_tpu_torch.models.corex import Corex
    shadow = Corex(**dict(model.get_params(), **params))
    shadow._pretrained_ws = model._pretrained_ws
    shadow._serving_plan = model._serving_plan
    return shadow


def warmup_fit(model, n_samples: int, n_variables: int, mesh=None,
               sharding_plan=None) -> None:
    """Run `model`'s fit programs once for an (n_samples, n_variables)
    input, on synthetic operands, so that the first real `fit` of this
    process on matching shapes builds and loads nothing.

    It fits a copy of the model with `max_iter=1` (one iteration a stage)
    on synthetic rows through the fit's own code (`Corex._fit`), so every
    choice the fit makes is made alike: the strategy, the 'auto' knobs,
    the operand, the init, the restart lanes and their selection, the
    stage-subsample programs, the mesh layout and its rejections. The
    one difference: the int8 wrap guard does not run on the synthetic
    operand. On the CPU the rows are a NumPy array, so 'empirical' takes
    the host library's route as a NumPy input does.

    With `mesh` (+ optional `sharding_plan`) every rank makes this call,
    as it makes the fit, and the sharded programs run (their collectives
    are counted in `collective_counts()`).

    The model stays as it was (unfitted if it was), and no random stream
    of the caller moves. There is no fallback: without nvcc on a card the
    warmup raises as the fit would."""
    from linearcorex_tpu_torch.core.solver import host_numpy
    ensure_compile_cache()
    shadow = _shadow(model, max_iter=1, verbose=False)
    dev = shadow._device
    x = torch.randn((int(n_samples), int(n_variables)),
                    generator=synthetic_generator(dev), dtype=shadow._dt,
                    device=dev)
    shadow._fit(host_numpy(x) if dev.type == "cpu" else x, None, mesh,
                sharding_plan, check_overflow=False)
    synchronize(dev)


def warmup_serving(model, batch_rows: int, n_variables=None,
                   matmat_k=None, cov_block=None, mesh=None,
                   sharding_plan=None) -> None:
    """Run the serving calls once at the declared shapes: `transform` and
    `predict` of `batch_rows` rows, `score` (the affine gaussianize modes
    only), and `covariance_matmat` of a (p, matmat_k) block /
    `covariance_blocks(cov_block)` when those are given. The companion of
    `warmup_fit` for deployments that only serve (load_corex → serve).

    The calls run on a copy of `model` that carries synthetic fitted state
    of the model's widths (W, theta and moments from Σ = I), so a fitted
    model is left exactly as it was. `n_variables` defaults to the fitted
    width; an unfitted model needs it. With `mesh` (+ optional
    `sharding_plan`, else the model's last serving plan, else rows over
    `data`) every rank makes this call and the sharded serving calls
    run."""
    from linearcorex_tpu_torch.ops import moments as M
    from linearcorex_tpu_torch.ops import preprocessing as P

    ensure_compile_cache()
    if n_variables is None:
        n_variables = model.nv
    if n_variables is None:
        raise ValueError(
            "n_variables is required when the model is not fitted yet")
    p, b = int(n_variables), int(batch_rows)
    m = model.ws.shape[0] if model.ws is not None else model.m
    dev, dt = model._device, model._dt
    gen = synthetic_generator(dev)

    def randn(*shape):
        return torch.randn(shape, generator=gen, dtype=dt, device=dev)

    shadow = _shadow(model)
    cfg = shadow.config
    ws = randn(m, p) / math.sqrt(p)
    shadow.ws, shadow.nv = ws, p
    shadow.theta = P.Theta(mean=randn(p), std=1.0 + randn(p).abs())
    with M.full_f32_matmul():
        shadow.moments = M.moments_from_cxy(ws, ws.T.contiguous(),
                                            cfg.y_scale, cfg.rho_clip)
    kw = dict(mesh=mesh, sharding_plan=sharding_plan)
    x = randn(b, p)
    shadow.predict(shadow.transform(x, **kw), **kw)
    if shadow.pre_config.gaussianize in ("none", "standard"):
        shadow.score(x, **kw)
    if matmat_k:
        shadow.covariance_matmat(randn(p, int(matmat_k)), **kw)
    if cov_block:
        next(shadow.covariance_blocks(int(cov_block), **kw))
    synchronize(dev)
