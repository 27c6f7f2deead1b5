"""Model selection: `pick_n_hidden`, in PyTorch.

Port of `linearcorex_tpu/models/selection.py`: fit Corex
for n_hidden = 1 .. max_n_hidden with `repeat` seeded restarts each and
keep the smallest n_hidden past which TC (or the held-out likelihood)
stops improving.

The padded sweep runs every (candidate, restart) pair as one lane of one
solve (`parallel.restarts`). Candidates share the factor axis
max_n_hidden: candidate nh's W0 has its rows from nh on set to zero, and
zero rows stay exactly zero through the solver and the chain kernel
(their rho is 0, so their AA rows, H entries and gradient rows are 0), so
each lane follows the dedicated nh-factor fit. The one difference from
per-candidate fits: nh=1 rides the shared multi-factor anneal schedule (a
dedicated n_hidden=1 fit skips annealing). padded_sweep=False runs the
reference's sequential per-candidate loop, each candidate's restarts as
lanes, with its early stop under criterion='tc'.

With `mesh=` the (candidate, restart) lanes split over the mesh's
`restart_axis`, and with `data_axis=` the sample rows over that axis too
(`parallel.restarts.fit_restarts_sharded`); every rank makes the same
call and gets the same answer. `warmup_sweep` runs the padded sweep's
programs once on synthetic operands at the declared shapes, so that the
first real sweep of a process builds and loads nothing.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from linearcorex_tpu_torch.config import CorexConfig
from linearcorex_tpu_torch.core.solver import host_numpy
from linearcorex_tpu_torch.models.corex import (_factor_z_ns,
                                                _factor_z_overlap,
                                                _gaussian_ll,
                                                pick_fit_strategy,
                                                prepare_operand,
                                                resolve_device, torch_dtype)
from linearcorex_tpu_torch.ops import moments as M
from linearcorex_tpu_torch.ops import preprocessing as P
from linearcorex_tpu_torch.parallel.restarts import (init_restarts,
                                                     restart_batch_runner,
                                                     seed_base)
from linearcorex_tpu_torch.utils import compile_cache as CC

__all__ = ["pick_n_hidden", "warmup_sweep"]

_DATA_AXIS_NEEDS_MESH = (
    "data_axis shards the sample rows over a mesh axis — pass "
    "mesh= too (make_mesh(((restart_axis, a), (data_axis, b))))")


def _sweep_cfg_and_strategy(n: int, p: int, max_n_hidden: int, dtype: str,
                            data_axis: Optional[str], corex_kwargs: dict):
    """(sweep CorexConfig, moment strategy) of the padded sweep. The
    strategy choice is `models.corex.pick_fit_strategy`'s, with
    `data_axis` expressed as the sample-sharding plan it is; an explicit
    'gram' with a data axis raises (a Gram operand has no sample axis to
    shard). `corex_kwargs` must already exclude the preprocessing kwargs
    (gaussianize, missing_values) and record_history (sweeps force it
    off)."""
    if "n_restarts" in corex_kwargs:
        raise TypeError(
            "the selection sweep (pick_n_hidden / warmup_sweep) runs "
            "its own restart lanes — pass repeat=k (the per-candidate "
            "restart count), not n_restarts= (the fixed-n_hidden Corex "
            "knob).")
    probe = CorexConfig(n_hidden=1, dtype=dtype, record_history=False,
                        **corex_kwargs)
    if probe.init == "spectral":
        raise ValueError(
            "init='spectral' is not supported by the selection sweep "
            "(pick_n_hidden / warmup_sweep): it draws its own seeded "
            "random init per (candidate, restart) lane, so the spectral "
            "init would be silently ignored. Drop init from the sweep "
            "kwargs, or run Corex(init='spectral', n_restarts=k) at a "
            "fixed n_hidden (spectral restart lanes are supported "
            "there).")
    plan = None
    if data_axis is not None:
        if probe.moment_strategy == "gram":
            raise ValueError(
                "data_axis shards the SAMPLE rows of X; a Gram operand "
                "carries none — the combined restarts x data layout is "
                "samples-strategy only (drop data_axis, or use "
                "moment_strategy='auto'/'samples')")
        from linearcorex_tpu_torch.parallel.sharding import ShardingPlan
        plan = ShardingPlan(shard_samples=True)
    cfg = CorexConfig(n_hidden=max_n_hidden, dtype=dtype,
                      record_history=False, **corex_kwargs)
    return cfg, pick_fit_strategy(probe, n, p, plan)


def _padded_inits(max_n: int, repeat: int, p: int, seed: Optional[int],
                  dtype, device) -> torch.Tensor:
    """(max_n·repeat, max_n, p) init stack: candidate k (n_hidden=k+1),
    restart r is RandomState(base+r).normal(size=(max_n, p)) with rows
    >= k+1 zeroed. NumPy fills row-major, so the active rows are bit-equal
    to the dedicated init_restarts(repeat, k+1, p, seed) draw."""
    base = seed_base(seed)
    full = np.stack([
        np.random.RandomState(base + r).normal(
            loc=0.0, scale=1.0 / np.sqrt(p), size=(max_n, p))
        for r in range(repeat)
    ])                                                  # (repeat, max_n, p)
    mask = (np.arange(max_n)[None, :] <= np.arange(max_n)[:, None])
    # (max_n, repeat, max_n, p): candidate-major, so scores reshape cleanly
    w0 = full[None, :, :, :] * mask[:, None, :, None]
    return torch.as_tensor(w0.reshape(max_n * repeat, max_n, p),
                           dtype=dtype, device=device)


def _smallest_within_tol(scores, tol: float) -> int:
    """Parsimony rule of the held-out criterion: the SMALLEST n_hidden
    whose score is within `tol` of the best (past the supported model
    size the held-out likelihood plateaus, and a bare argmax would pick
    by float noise). Non-finite scores (a diverged fit) are excluded;
    all non-finite raises."""
    scores = np.asarray(scores)
    if not np.isfinite(scores).any():
        raise ValueError(
            "every candidate's held-out score is non-finite — the fits "
            "diverged; check the data and tolerance")
    best = np.nanmax(np.where(np.isfinite(scores), scores, -np.inf))
    ok = np.isfinite(scores) & (scores >= best - tol)
    return int(np.argmax(ok)) + 1


def _best_n_from_scores(scores, tc_gain_tol: float) -> int:
    """The reference's saturation rule over the score curve, with its
    early stop: a candidate improving the best-so-far by more than
    tc_gain_tol becomes best; two consecutive non-improving candidates
    end the scan (so the padded and the sequential sweep pick alike)."""
    best_n, best_tc = 1, -np.inf
    for k, tc in enumerate(scores, start=1):
        if tc > best_tc + tc_gain_tol:
            best_tc, best_n = tc, k
        elif k > best_n + 1:
            break
    return best_n


def _score_lanes(xv, mom_b, overlap: bool) -> np.ndarray:
    """Held-out score of every lane: the mean Gaussian log-likelihood of
    the preprocessed validation rows under the lane's factor covariance
    (the `Corex.score` quantity, in the standardized space: the affine
    Jacobian is the same for every candidate). Dead surplus factors have
    zero rows in Z and add nothing."""
    one = torch.ones((1,), dtype=xv.dtype, device=xv.device)
    out = []
    with M.full_f32_matmul():
        for lane in range(mom_b.tc.shape[0]):
            if overlap:
                z = _factor_z_overlap(mom_b.cy[lane], mom_b.c_xy[lane])
            else:
                z = _factor_z_ns(mom_b.rhoinvrho[lane], mom_b.si[lane])
            out.append(_gaussian_ll(xv, z, one))
    return host_numpy(torch.stack(out))


def _heldout_split_sizes(n: int, val_fraction: float,
                         gaussianize: str) -> Tuple[int, int]:
    """Validate criterion='heldout' arguments; (n_train, n_val)."""
    if not 0.0 < val_fraction < 1.0:
        raise ValueError(
            f"val_fraction must be in (0, 1), got {val_fraction}")
    if gaussianize not in ("none", "standard"):
        raise ValueError(
            "criterion='heldout' requires gaussianize='none' or "
            "'standard' (non-affine transforms have no comparable "
            "held-out density)")
    n_val = max(1, int(round(n * val_fraction)))
    if n - n_val < 2:
        raise ValueError(
            f"need >= 2 training rows after holding out {n_val}")
    return n - n_val, n_val


def pick_n_hidden(data, repeat: int = 1, max_n_hidden: Optional[int] = None,
                  verbose: bool = False, tc_gain_tol: float = 1e-3,
                  dtype: str = "float32", seed: Optional[int] = None,
                  padded_sweep: bool = True, criterion: str = "tc",
                  val_fraction: float = 0.2, mesh=None,
                  restart_axis: str = "restarts",
                  data_axis: Optional[str] = None, device: str = "cuda",
                  **corex_kwargs):
    """Choose n_hidden; returns (best_n, scores).

    criterion='tc' (the reference's rule): scan until the training TC
    saturates; scores[k] is the best TC over `repeat` restarts at
    n_hidden = k+1. criterion='heldout': hold out `val_fraction` of the
    rows, fit on the rest, and pick the smallest n_hidden whose best
    held-out Gaussian log-likelihood (the `Corex.score` quantity) is
    within tc_gain_tol of the best; scores[k] is that likelihood.

    Extra kwargs flow into `CorexConfig` (max_iter, tol, anneal, ...).
    padded_sweep=True runs the whole (candidate, restart) grid as lanes of
    one solve; False runs the sequential per-candidate loop. `device`
    names where the sweep runs, as `Corex(device=...)` does.

    `mesh` (a DeviceMesh with a `restart_axis` axis) splits the
    (candidate, restart) lanes over that axis: each group of ranks runs
    its share against its own copy of the data. `data_axis` (a second
    mesh axis) also splits the sample rows of every Σ-application over
    that axis (samples strategy only; the summed cross-moments ride the
    data axis, nothing rides the restart axis before the final gather).
    That divides the solve's work per rank, not its memory: every rank
    still moves the whole X to its device and preprocesses it once, as
    without a mesh, and the solver reads its row block of the result
    (`Corex.fit(mesh=)` is the entry point that shards the raw rows
    before it preprocesses them). Every rank makes the same
    call and returns the same (best_n, scores); an unseeded sweep draws
    its seed on the mesh's first rank."""
    return _sweep(data, repeat, max_n_hidden, verbose, tc_gain_tol, dtype,
                  seed, padded_sweep, criterion, val_fraction, mesh,
                  restart_axis, data_axis, device, corex_kwargs)


def _sweep(data, repeat, max_n_hidden, verbose, tc_gain_tol, dtype, seed,
           padded_sweep, criterion, val_fraction, mesh, restart_axis,
           data_axis, device, corex_kwargs, check_overflow=True):
    """`pick_n_hidden`'s body; `warmup_sweep` runs it with
    check_overflow=False (no wrap guard on its synthetic operand)."""
    CC.ensure_compile_cache()
    if repeat < 1:
        raise ValueError(f"repeat must be >= 1, got {repeat}")
    if max_n_hidden is not None and max_n_hidden < 1:
        raise ValueError(f"max_n_hidden must be >= 1, got {max_n_hidden}")
    if criterion not in ("tc", "heldout"):
        raise ValueError(f"unknown criterion: {criterion!r} "
                         f"(expected 'tc' or 'heldout')")
    if data_axis is not None and mesh is None:
        raise ValueError(_DATA_AXIS_NEEDS_MESH)
    dev = resolve_device(device)
    if mesh is not None:
        from linearcorex_tpu_torch.parallel.sharding import (check_mesh,
                                                             shared_seed)
        check_mesh(mesh, dev)
        seed = shared_seed(seed, mesh, dev)   # unseeded: one draw for all
    dt = torch_dtype(dtype)
    n, p = np.shape(data)
    if max_n_hidden is None:
        max_n_hidden = min(p, 16)
    gaussianize = corex_kwargs.pop("gaussianize", "standard")
    missing_values = corex_kwargs.pop("missing_values", None)
    # sweeps never record the TC history (lanes x stages x max_iter)
    corex_kwargs.pop("record_history", None)
    n_train, n_val = n, 0
    if criterion == "heldout":
        n_train, n_val = _heldout_split_sizes(n, val_fraction, gaussianize)
    # argument errors before the split moves any data
    cfg, strategy = _sweep_cfg_and_strategy(n_train, p, max_n_hidden,
                                            dtype, data_axis, corex_kwargs)
    x = data if isinstance(data, torch.Tensor) else torch.as_tensor(
        np.asarray(data))
    x = x.to(dtype=dt, device=dev)
    xv = None
    if criterion == "heldout":
        perm = torch.as_tensor(
            np.random.RandomState(seed_base(seed)).permutation(n),
            device=dev)
        xv, x = x[perm[:n_val]], x[perm[n_val:]]
        n = x.shape[0]
    # preprocess once (training rows only under 'heldout'); every
    # candidate shares the operand, validation rows the training theta
    xp, theta = P.fit_preprocess(x, gaussianize, missing_values)
    shared = prepare_operand(xp, strategy, cfg.matmul_dtype, check_overflow)
    del x, xp
    if xv is not None:
        xv = P.preprocess(xv, gaussianize, theta, missing_values)
    overlap = not cfg.discourage_overlap
    label = "TC" if criterion == "tc" else "held-out loglik"
    run_batch = restart_batch_runner(mesh, restart_axis, data_axis)

    def lane_scores(mom_b):
        if criterion == "heldout":
            return _score_lanes(xv, mom_b, overlap)
        return host_numpy(mom_b.tc)

    if padded_sweep:
        w0 = _padded_inits(max_n_hidden, repeat, p, seed, dt, dev)
        _, mom_b, _ = run_batch(shared, w0, cfg, strategy, n)
        scores = lane_scores(mom_b).reshape(max_n_hidden, repeat).max(axis=1)
        if verbose:
            for nh, s in enumerate(scores, start=1):
                print(f"n_hidden={nh}: best {label} over {repeat} "
                      f"restarts = {s:.5f}")
        if criterion == "heldout":
            return _smallest_within_tol(scores, tc_gain_tol), \
                np.array(scores)
        return _best_n_from_scores(scores, tc_gain_tol), np.array(scores)

    scores = []
    best_n, best_tc_overall = 1, -np.inf
    for nh in range(1, max_n_hidden + 1):
        cfg = CorexConfig(n_hidden=nh, dtype=dtype, record_history=False,
                          **corex_kwargs)
        w0 = init_restarts(repeat, nh, p, seed, dt, dev)
        _, mom_b, _ = run_batch(shared, w0, cfg, strategy, n)
        s_best = float(np.max(lane_scores(mom_b)))
        scores.append(s_best)
        if verbose:
            print(f"n_hidden={nh}: best {label} over {repeat} restarts = "
                  f"{s_best:.5f}")
        if criterion == "tc":
            if s_best > best_tc_overall + tc_gain_tol:
                best_tc_overall, best_n = s_best, nh
            elif nh > best_n + 1:
                break  # two consecutive values added nothing: saturated
    if criterion == "heldout":
        best_n = _smallest_within_tol(np.array(scores), tc_gain_tol)
    return best_n, np.array(scores)


def warmup_sweep(n_samples: int, n_variables: int, repeat: int = 1,
                 max_n_hidden: Optional[int] = None, dtype: str = "float32",
                 criterion: str = "tc", val_fraction: float = 0.2,
                 mesh=None, restart_axis: str = "restarts",
                 data_axis: Optional[str] = None, verbose: bool = False,
                 tc_gain_tol: float = 1e-3, seed: Optional[int] = None,
                 padded_sweep: bool = True, device: str = "cuda",
                 **corex_kwargs) -> None:
    """Run the padded `pick_n_hidden` sweep's programs once for declared
    shapes, on synthetic operands, so that the first real sweep of this
    process builds and loads nothing: the selection counterpart of
    `utils.compile_cache.warmup_fit`.

    Pass the arguments the real `pick_n_hidden(data, ...)` call will use,
    with `n_samples` / `n_variables` the data's shape (under
    criterion='heldout' the FULL row count: the sweep splits it). It runs
    that sweep through `pick_n_hidden`'s own code on synthetic rows, cut
    to one iteration a stage and with the int8 wrap guard left out: the
    preprocessing and the operand, one lockstep evaluation of the
    (candidate x restart) grid as lanes of one solve (the lane kernel on a
    card), under 'heldout' the scorer of the validation rows, and the
    choice. `verbose` is ignored (the warmup prints nothing); the other
    knobs of the selection rule change no program. Only the padded sweep
    can be warmed: `padded_sweep=False` raises by name. With `mesh` every
    rank makes this call and the lanes split over `restart_axis` (and the
    rows over `data_axis`) as in the sweep."""
    if not padded_sweep:
        raise ValueError(
            "warmup_sweep warms the padded one-solve sweep only; "
            "padded_sweep=False runs one small solve per candidate, each "
            "warmed by its own first call")
    dev = resolve_device(device)
    x = torch.randn((int(n_samples), int(n_variables)),
                    generator=CC.synthetic_generator(dev),
                    dtype=torch_dtype(dtype), device=dev)
    _sweep(x, repeat, max_n_hidden, False, tc_gain_tol, dtype, seed, True,
           criterion, val_fraction, mesh, restart_axis, data_axis, device,
           dict(corex_kwargs, max_iter=1), check_overflow=False)
    CC.synchronize(dev)
