"""Checkpoint and resume for fitted Corex state.

Port of `linearcorex_tpu/utils/checkpoint.py`, single-device. The learned
state (ws, theta, moments, config) is one flat dict of arrays saved as a
portable `.npz`, so a fit can be resumed (`Corex.fit(init_ws=...)` keeps
its warm-start semantics), inference can run without refitting, and long
anneal schedules can be snapshotted at stage boundaries. No pickle: the
format is arrays plus a JSON config string.

The file format is the JAX package's, unchanged (format version 1): a
model saved by either package loads in the other, and a
`fit_with_checkpoints` directory begun by one is resumed by the other.
The device is not part of the file: `load_corex(path, device=...)` places
the model.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import warnings

import numpy as np
import torch

from linearcorex_tpu_torch.config import CorexConfig, PreprocessConfig
from linearcorex_tpu_torch.core.solver import FitDiagnostics, sort_by_tcs
from linearcorex_tpu_torch.models.corex import (Corex, _fit_program,
                                                _no_mesh, _subsample_rows,
                                                stage_subsample_active)
from linearcorex_tpu_torch.ops import moments as M
from linearcorex_tpu_torch.utils.interop import corex_from_numpy

__all__ = ["save_corex", "load_corex", "fit_with_checkpoints"]

_FORMAT_VERSION = 1


def _json_scalar(o):
    """json.dumps default= for checkpoint metadata: numpy scalars arrive
    verbatim from sklearn param grids (np.int64 seeds from np.arange,
    np.float64 tols), and the estimator stores parameters verbatim by
    contract, so they are canonicalized only here, where they are
    serialized (the loaded value is the same number)."""
    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, np.floating):
        return float(o)
    if isinstance(o, np.bool_):
        return bool(o)
    raise TypeError(
        f"checkpoint metadata value {o!r} ({type(o).__name__}) is not "
        f"JSON-serializable")


def _npz_path(path: str) -> str:
    """np.savez appends '.npz' when missing; normalize once so save and
    load agree on the real filename."""
    return path if path.endswith(".npz") else path + ".npz"


def _non_default_fields(cfg_obj) -> dict:
    """Config as a dict with the fields AT their dataclass default
    dropped. Used by the fit fingerprint, so that adding a config field
    (with a default) does not invalidate every existing stage checkpoint.
    A field explicitly set to its default is indistinguishable from one
    left alone; the fit is identical, so the fingerprint treats them the
    same."""
    out = {}
    for f in dataclasses.fields(cfg_obj):
        v = getattr(cfg_obj, f.name)
        if f.default is not dataclasses.MISSING and v == f.default:
            continue
        out[f.name] = v
    return out


def _fit_fingerprint(model: Corex, x, schedule) -> str:
    """Hash of (config, preprocessing, data shape and a content sample,
    anneal schedule). Stored in stage checkpoints so that a resume against
    different data or hyperparameters is detected instead of continuing
    from stale weights. Equal to the JAX package's fingerprint of the same
    (config, data, schedule); the device is not part of it."""
    payload = json.dumps(
        {
            "config": _non_default_fields(model.config),
            "pre_config": _non_default_fields(model.pre_config),
            "shape": [int(s) for s in x.shape],
            "schedule": [float(e) for e in schedule],
        },
        sort_keys=True, default=str).encode()
    h = hashlib.sha256(payload)
    if isinstance(x, torch.Tensor):
        # subsample on the device and pull at most 8 KB to the host
        flat = x.reshape(-1)
        stride = max(1, flat.numel() // 1024)
        sample = flat[::stride][:1024].to(torch.float64).cpu().numpy()
    else:
        flat = x.ravel()
        stride = max(1, flat.size // 1024)
        sample = np.ascontiguousarray(flat[::stride][:1024], np.float64)
    h.update(sample.tobytes())
    return h.hexdigest()


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def save_corex(model: Corex, path: str) -> None:
    """Save a fitted Corex to `path` (.npz): one device-to-host copy of
    the fitted state, by explicit request."""
    if model.ws is None or model.moments is None:
        raise ValueError("model is not fitted")
    path = _npz_path(path)
    meta = {
        "format_version": _FORMAT_VERSION,
        "config": dataclasses.asdict(model.config),
        "pre_config": dataclasses.asdict(model.pre_config),
        "seed": model.seed,
        "nv": model.nv,
        "n_samples": model.n_samples,
        "update_iter": model.update_iter,
        "verbose": model.verbose,
        # restart-sweep state: n_restarts so that a fit() after loading
        # raises by name (warm start x restarts) instead of fitting one
        # lane; best_restart_ so the fitted attributes round-trip
        "n_restarts": model.n_restarts,
        "best_restart": model.best_restart_,
    }
    arrays = {
        "ws": _host(model.ws),
        "theta_mean": _host(model.theta.mean),
        "theta_std": _host(model.theta.std),
        "meta_json": np.frombuffer(
            json.dumps(meta, default=_json_scalar).encode(),
            dtype=np.uint8),
    }
    for name, val in model.moments._asdict().items():
        arrays[f"mom_{name}"] = _host(val)
    np.savez(path, **arrays)


def fit_with_checkpoints(model: Corex, x, ckpt_dir: str, init_ws=None,
                         mesh=None, sharding_plan=None,
                         stage_callback=None):
    """Run the annealed fit one stage at a time, saving (ws, stage) at
    each anneal-stage boundary: recovery from preemption for long fits. If
    `ckpt_dir` already holds a stage file, fitting resumes from the stage
    after it.

    Each stage is one call of the fit program on a length-1 schedule; the
    extra cost against `Corex.fit` is one small save and one host read per
    stage. Data preparation is shared with `Corex.fit`
    (`Corex._prepare_fit`), so the checkpointed fit sees identically
    validated and preprocessed data. A fingerprint of (config, data,
    schedule) is stored with each stage; a resume whose fingerprint
    mismatches restarts from stage 0 with a warning instead of continuing
    from stale weights. Finishes by populating `model` exactly as
    `Corex.fit` does (final moments, sorted factors) and returns it.

    `mesh`/`sharding_plan` belong to the JAX package's sharded stages and
    raise NotImplementedError here.

    `stage_callback(stage, eps, ws, stats)` runs on the host after each
    stage. `stats` is the dict of per-stage arrays accumulated so far
    (iters/tc/delta/obj/hist); return values are ignored; exceptions
    propagate (the checkpoint of the completed stage is already on disk).
    """
    _no_mesh("fit_with_checkpoints", mesh, sharding_plan)
    if model._validated_restarts(init_ws) != 1:
        raise ValueError(
            "n_restarts > 1 is not supported by fit_with_checkpoints: "
            "the stage-by-stage fit re-enters the solver one stage "
            "at a time on a single lane. Run Corex(n_restarts=k).fit "
            "without checkpoints, or checkpoint k seeded single-restart "
            "fits (seed=s+r) and keep the best TC.")

    os.makedirs(ckpt_dir, exist_ok=True)
    state_path = os.path.join(ckpt_dir, "stage_state.npz")

    # coerced here for the fingerprint's shape and sample only: the one
    # scan for NaN/inf is `_prepare_fit`'s
    x = model._coerce_2d(x)
    data, cfg, strategy = model._prepare_fit(x)
    schedule = cfg.anneal_schedule()
    fingerprint = _fit_fingerprint(model, x, schedule)
    n_stages = len(schedule)
    # per-stage diagnostics, saved beside ws so that a resumed run still
    # reports the full history
    stats = {
        "iters": np.zeros(n_stages, np.int32),
        "tc": np.zeros(n_stages, np.float64),
        "delta": np.zeros(n_stages, np.float64),
        "obj": np.zeros(n_stages, np.float64),
        "hist": np.zeros((n_stages,
                          cfg.max_iter if cfg.record_history else 0),
                         np.float64),
    }
    start_stage = 0
    if os.path.exists(state_path):
        with np.load(state_path) as z:
            stored_fp = (bytes(z["fingerprint"]).decode()
                         if "fingerprint" in z.files else "")
            if stored_fp != fingerprint:
                warnings.warn(
                    f"checkpoint in {ckpt_dir!r} was written for a "
                    f"different (config, data, schedule); restarting the "
                    f"fit from stage 0")
            else:
                start_stage = min(int(z["stage"]), n_stages)
                ws = model._as_tensor(z["ws"])
                for k in stats:
                    if k in z.files and z[k].shape == stats[k].shape:
                        stats[k] = z[k].copy()
    if start_stage == 0:
        ws = model._resolve_w0(init_ws, data=data, strategy=strategy)

    fp_arr = np.frombuffer(fingerprint.encode(), dtype=np.uint8)
    tols = cfg.tol_schedule()
    # stage_subsample: the non-final stages run on every k-th row (the
    # contract of Corex.fit's two-program fit: the final stage always
    # sees the full data at `tol`). The subsampled operand is a
    # deterministic stride slice, so a resumed run rebuilds the identical
    # stage inputs.
    sub_active = stage_subsample_active(cfg, strategy)
    data_sub = (_subsample_rows(data, cfg.stage_subsample) if sub_active
                else data)
    for s in range(start_stage, n_stages):
        # this stage's tol, taken from the schedule (stage_tol_factor
        # loosens the non-final stages): the stage program's length-1
        # schedule makes its only stage "final", so tol passes through
        # unchanged. stage_subsample=1 in the stage config: the staging
        # is realized here by the choice of operand.
        stage_cfg = dataclasses.replace(cfg, eps_override=schedule[s],
                                        tol=tols[s], stage_subsample=1.0)
        stage_data = data if (not sub_active or s == n_stages - 1) \
            else data_sub
        ws, _, diag = _fit_program(stage_data, ws, stage_cfg, strategy)
        stats["iters"][s] = int(diag.iters_per_stage[0])
        stats["tc"][s], stats["delta"][s], stats["obj"][s] = torch.stack(
            [diag.tc_per_stage[0], diag.delta_per_stage[0],
             diag.objective_per_stage[0]]).tolist()
        if cfg.record_history:
            stats["hist"][s] = _host(diag.tc_history[0])
        np.savez(state_path, ws=_host(ws), stage=s + 1,
                 fingerprint=fp_arr, **stats)
        if stage_callback is not None:
            stage_callback(s, schedule[s], ws, stats)

    # finish exactly as Corex.fit does: full moments at eps = 0 and the
    # factor sort (no further solver steps)
    with M.full_f32_matmul():
        zero = torch.zeros((), dtype=ws.dtype, device=ws.device)
        c_xy = (M.cxy_gram(data, ws, zero) if strategy == "gram"
                else M.cxy_samples(data, ws, zero))
        mom = M.moments_from_cxy(ws, c_xy, cfg.y_scale, cfg.rho_clip)
        model.ws, order = sort_by_tcs(ws, mom.tcs)
        model.moments = M.permute_moments(mom, order)
    as_t = model._as_tensor
    model.diagnostics = FitDiagnostics(
        iters_per_stage=torch.as_tensor(stats["iters"]),
        tc_per_stage=as_t(stats["tc"]),
        delta_per_stage=as_t(stats["delta"]),
        objective_per_stage=as_t(stats["obj"]),
        tc_history=as_t(stats["hist"]),
        eps_schedule=as_t(np.asarray(schedule)))
    # the plain fit's fitted attributes (n_restarts > 1 is rejected above)
    model.best_restart_ = 0
    return model


def load_corex(path: str, device="cuda") -> Corex:
    """Reconstruct a fitted Corex on `device` (ready for inference; fit()
    warm-starts from the stored weights). Reads the files of either
    package's `save_corex`."""
    path = _npz_path(path)
    with np.load(path) as z:
        if "meta_json" not in z.files:
            raise ValueError(
                f"{path} is not a linearcorex_tpu checkpoint "
                f"(missing meta_json; found keys {z.files[:5]})")
        meta = json.loads(bytes(z["meta_json"]).decode())
        if meta["format_version"] > _FORMAT_VERSION:
            raise ValueError(
                f"checkpoint format {meta['format_version']} is newer than "
                f"this library ({_FORMAT_VERSION})")
        cfg = CorexConfig(**meta["config"])
        pre = PreprocessConfig(**meta["pre_config"])
        model = corex_from_numpy(
            z,
            n_hidden=cfg.n_hidden, max_iter=cfg.max_iter, tol=cfg.tol,
            anneal=cfg.anneal, missing_values=pre.missing_values,
            discourage_overlap=cfg.discourage_overlap,
            gaussianize=pre.gaussianize, y_scale=cfg.y_scale,
            seed=meta["seed"], dtype=cfg.dtype,
            moment_strategy=cfg.moment_strategy,
            record_history=cfg.record_history,
            matmul_dtype=cfg.matmul_dtype, use_pallas=cfg.use_pallas,
            matmul_precision=cfg.matmul_precision,
            optimizer=cfg.optimizer, momentum_beta=cfg.momentum_beta,
            init=cfg.init, stage_tol_factor=cfg.stage_tol_factor,
            stage_subsample=cfg.stage_subsample,
            update_iter=meta.get("update_iter", 10),
            verbose=meta.get("verbose", False),
            # restored verbatim: a fit() on a loaded n_restarts > 1 model
            # raises by name (the warm-start x restarts guard) rather
            # than fitting one lane
            n_restarts=meta.get("n_restarts", 1),
            device=device)
        model.nv = meta["nv"]
    return model
