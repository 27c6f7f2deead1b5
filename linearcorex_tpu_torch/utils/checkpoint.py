"""Checkpoint and resume for fitted Corex state.

Port of `linearcorex_tpu/utils/checkpoint.py`. The learned
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
import torch.distributed as dist

from linearcorex_tpu_torch.config import CorexConfig, PreprocessConfig
from linearcorex_tpu_torch.core.solver import FitDiagnostics, host_numpy
from linearcorex_tpu_torch.models.corex import (Corex, _fit_program,
                                                _subsample_rows,
                                                check_precision,
                                                final_moments, precision_ctx,
                                                stage_subsample_active)
from linearcorex_tpu_torch.parallel import sharding as S
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


def _savez(path: str, **arrays) -> None:
    """`np.savez(path, **arrays)` for numpy arrays and tensors. A bfloat16
    tensor is written as the JAX package's np.savez writes its
    `ml_dtypes.bfloat16` arrays: the 2-byte words under the header descr
    '<V2', since the .npy format cannot name bfloat16. `np.load` reads it
    back as void, and both packages' `load_corex` refuse it
    (`models.corex.numpy_to_torch`). Other tensors are saved as their
    numpy arrays, so every other file is np.savez's, byte for byte."""
    import zipfile
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, val in arrays.items():
            with zf.open(key + ".npy", "w", force_zip64=True) as fid:
                if isinstance(val, torch.Tensor) \
                        and val.dtype == torch.bfloat16:
                    bits = val.detach().cpu().contiguous().view(torch.int16)
                    np.lib.format.write_array_header_1_0(fid, {
                        "descr": "<V2", "fortran_order": False,
                        "shape": tuple(bits.shape)})
                    fid.write(bits.numpy().tobytes())
                    continue
                if isinstance(val, torch.Tensor):
                    val = val.detach().cpu().numpy()
                np.lib.format.write_array(fid, np.asanyarray(val),
                                          allow_pickle=False)


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
        "ws": model.ws,
        "theta_mean": model.theta.mean,
        "theta_std": model.theta.std,
        "meta_json": np.frombuffer(
            json.dumps(meta, default=_json_scalar).encode(),
            dtype=np.uint8),
    }
    for name, val in model.moments._asdict().items():
        arrays[f"mom_{name}"] = val
    _savez(path, **arrays)


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

    `mesh` (with an optional `sharding_plan`) runs every stage through
    `parallel.fit_sharded`, as `Corex.fit(mesh=...)` runs its fit, every
    rank making this call with the same arguments. The stage weights come
    back whole, so the file does not depend on the layout: a mesh
    checkpoint resumes on one device and the other way round. Exactly one
    rank, the mesh's first, writes the file (to a temporary name, then
    `os.replace`), and every rank waits for the write before it goes on;
    every rank reads the file on a resume. stage_subsample < 1 has no mesh
    form and raises.

    `stage_callback(stage, eps, ws, stats)` runs on the host after each
    stage, on every rank of a mesh (each rank is its own process). `stats`
    is the dict of per-stage arrays accumulated so far
    (iters/tc/delta/obj/hist); return values are ignored; exceptions
    propagate (the checkpoint of the completed stage is already on disk).
    """
    if model._validated_restarts(init_ws) != 1:
        raise ValueError(
            "n_restarts > 1 is not supported by fit_with_checkpoints: "
            "the stage-by-stage fit re-enters the solver one stage "
            "at a time on a single lane. Run Corex(n_restarts=k).fit "
            "without checkpoints, or checkpoint k seeded single-restart "
            "fits (seed=s+r) and keep the best TC.")
    check_precision(model.config)
    plan = None
    if mesh is not None:
        plan = sharding_plan or S.ShardingPlan()
        S.check_mesh(mesh, model._device)
    os.makedirs(ckpt_dir, exist_ok=True)
    try:
        if mesh is not None:
            model._mesh_seed = S.shared_seed(model.seed, mesh,
                                             model._device)
        return _fit_staged(model, x, ckpt_dir, init_ws, mesh, plan,
                           stage_callback)
    finally:
        model._mesh_seed = None


def _fit_staged(model, x, ckpt_dir, init_ws, mesh, plan, stage_callback):
    """`fit_with_checkpoints` once the layout is settled."""
    state_path = os.path.join(ckpt_dir, "stage_state.npz")
    # coerced here for the fingerprint's shape and sample only: the one
    # scan for NaN/inf is `_prepare_fit`'s
    x = model._coerce_2d(x)
    data, cfg, strategy = model._prepare_fit(x, resolve=mesh is None,
                                             plan=plan, mesh=mesh)
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
    if sub_active and mesh is not None:
        raise ValueError(
            "stage_subsample < 1 is not supported under "
            "fit_with_checkpoints(mesh=...): a stride slice of the "
            "sharded sample axis would leave the ranks with unequal row "
            "blocks mid-fit. Set stage_subsample=1, or checkpoint "
            "single-device.")
    data_sub = (_subsample_rows(data, cfg.stage_subsample) if sub_active
                else data)
    writer = mesh is None or S.mesh_first_rank(mesh) == dist.get_rank()
    for s in range(start_stage, n_stages):
        # this stage's tol, taken from the schedule (stage_tol_factor
        # loosens the non-final stages): the stage program's length-1
        # schedule makes its only stage "final", so tol passes through
        # unchanged. stage_subsample=1 in the stage config: the staging
        # is realized here by the choice of operand.
        stage_cfg = dataclasses.replace(cfg, eps_override=schedule[s],
                                        tol=tols[s], stage_subsample=1.0)
        if mesh is not None:
            # check_overflow=False: _prepare_fit guarded this operand
            ws, _, diag = S.fit_sharded(data, ws, stage_cfg, mesh, plan,
                                        strategy, n_samples=model.n_samples,
                                        check_overflow=False)
        else:
            stage_data = data if (not sub_active or s == n_stages - 1) \
                else data_sub
            ws, _, diag = _fit_program(stage_data, ws, stage_cfg, strategy)
        stats["iters"][s] = int(diag.iters_per_stage[0])
        stats["tc"][s], stats["delta"][s], stats["obj"][s] = torch.stack(
            [diag.tc_per_stage[0], diag.delta_per_stage[0],
             diag.objective_per_stage[0]]).tolist()
        if cfg.record_history:
            stats["hist"][s] = host_numpy(diag.tc_history[0])
        if writer:
            # a whole file or none: a preempted write leaves the last one
            tmp = os.path.join(ckpt_dir, "stage_state.tmp.npz")
            _savez(tmp, ws=ws, stage=s + 1, fingerprint=fp_arr, **stats)
            os.replace(tmp, state_path)
        if mesh is not None:
            S.mesh_barrier(mesh, ws.device)
        if stage_callback is not None:
            stage_callback(s, schedule[s], ws, stats)

    # finish exactly as Corex.fit does: full moments at eps = 0 and the
    # factor sort (no further solver steps)
    if mesh is not None:
        model.ws, model.moments = S.finish_sharded(
            data, ws, cfg, mesh, plan, strategy, n_samples=model.n_samples)
    else:
        with precision_ctx(cfg, ws.device):
            model.ws, model.moments = final_moments(data, ws, cfg,
                                                    strategy)
    model._serving_plan = plan   # None: single-device state
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
