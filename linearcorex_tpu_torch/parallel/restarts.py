"""Restart sweeps: k independent annealed fits run side by side as lanes.

Port of `linearcorex_tpu/parallel/restarts.py`. The JAX package runs a
sweep as `jax.vmap` over the whole annealed fit. Here the
lanes are a leading axis written out: `core.solver.fit_core` runs them
in lockstep (a lane frozen once its own predicate is false), the moment
functions apply the shared data operand to all lanes in one product, and
the chain kernel takes every lane in one launch per pass
(`ops.cuda_moments.ns_chain`).

Over a device mesh (`fit_restarts_sharded`, a mesh in
`restart_batch_runner`) the lanes split over a `restarts` axis: each
group of ranks runs its share of the lanes as one such solve, at its own
pace and with no collective across the axis during the fit (groups run
different iteration counts), and one `all_gather` over the axis at the
end hands every rank all lanes. With `data_axis`, each group's sample
rows split over that axis too and its (p, lanes·m) cross-moment is summed
over `data` only (`parallel.sharding` states the model of execution).
"""

from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch

from linearcorex_tpu_torch.config import CorexConfig
from linearcorex_tpu_torch.ops import moments as M
from linearcorex_tpu_torch.ops.seeded import seeded_normal
from linearcorex_tpu_torch.parallel.collectives import all_gather_lanes
from linearcorex_tpu_torch.utils.compile_cache import ensure_compile_cache
from linearcorex_tpu_torch.utils.profiling import span

__all__ = ["init_restarts", "fit_restarts", "fit_restarts_sharded",
           "best_restart", "restart_batch_runner", "padded_lanes",
           "lane_oom_guidance", "LaneOutOfMemoryError"]

# Values each lane keeps on the device at the peak of an iteration, in
# units of n_hidden x n_variables: W, the trial W, the gradient and the
# trial gradient, the momentum buffer and its trial, C_xy, the applied
# Σ-products and the chain's AA, rr and rr·α with their temporaries.
LANE_STATE_MATRICES = 16


class LaneOutOfMemoryError(MemoryError):
    """A restart sweep ran out of device memory; the message gives the
    lane-memory model and the remedies."""


def seed_base(seed: Optional[int]) -> int:
    """Restart-sweep seed base: seed itself, or fresh entropy when None
    (unseeded sweeps differ across calls, as Corex(seed=None) does)."""
    if seed is None:
        return int(np.random.SeedSequence().generate_state(1)[0] % (2**31))
    return seed


def restart_seeds(seed: Optional[int], n_restarts: int) -> list:
    """The seeds of a sweep's lanes, base + r (`seed_base`): lane 0's is
    the plain fit's seed."""
    base = seed_base(seed)
    return [base + r for r in range(n_restarts)]


def init_restarts(n_restarts: int, m: int, p: int, seed: Optional[int],
                  dtype=torch.float32, device="cuda") -> torch.Tensor:
    """Stack of seeded N(0, 1/sqrt(p)) inits, (n_restarts, m, p): restart
    r uses NumPy's RandomState(base + r) stream, bit for bit (drawn by
    `ops.seeded` on the host's threads), so restart 0 of a seeded sweep
    is the W0 of a plain `Corex(seed=seed)` fit (and of the JAX package's
    sweep). seed=None draws a fresh base (`seed_base`). On the card by
    default, as `Corex` and `pick_n_hidden` are; pass device="cpu" for
    the CPU."""
    with span("lcx.init.draw", sync=True):
        return seeded_normal(restart_seeds(seed, n_restarts), (m, p), 0.0,
                             1.0 / np.sqrt(p), dtype, device)


def fit_restarts(data, w0_batch: torch.Tensor, cfg: CorexConfig,
                 strategy: str, n_samples=None):
    """Run `len(w0_batch)` annealed fits as lanes of one solve: the final
    moments and the factor sort by TC per lane. Returns (ws_batch,
    Moments_batch, FitDiagnostics_batch), each with a leading lane axis;
    reduce with `best_restart`. `n_samples` feeds optimizer='auto' when
    `data` is a Gram matrix; on the samples strategy it is read from the
    data."""
    from linearcorex_tpu_torch.models.corex import (_fit_program,
                                                    resolve_config)
    ensure_compile_cache()
    if n_samples is None and strategy == "samples":
        n_samples = M.n_rows(data)
    cfg = resolve_config(cfg, w0_batch.shape[-1], w0_batch.device,
                         n_samples=n_samples)
    return _fit_program(data, w0_batch, cfg, strategy)


def fit_restarts_sharded(data, w0_batch, cfg: CorexConfig, strategy: str,
                         mesh, axis_name: str = "restarts",
                         n_samples=None, check_overflow: bool = True,
                         data_axis: Optional[str] = None):
    """Restart sweep with the lanes split over mesh axis `axis_name`:
    each group of ranks runs its k/r lanes as one solve and one
    `all_gather` over the axis at the end hands every rank all k lanes,
    in order. Nothing crosses the axis before that gather: the groups run
    different iteration counts. Complements `parallel.sharding.
    fit_sharded`, which shards the data of one big fit.

    `data_axis` (a second mesh axis, e.g. 'data') also splits the sample
    rows of the operand over that axis: the combined restarts x data
    layout. Each lane group's (p, lanes·m) cross-moment is summed over
    `data_axis` only. Samples strategy only: a Gram operand has no sample
    axis to shard. `data` is the whole operand on every rank (or the
    `ShardedSamples` block the mesh-aware prepare made).

    A caller-built `QuantizedData` operand runs the int8 accumulator-wrap
    guard here; check_overflow=False opts out when the same operand was
    guarded upstream."""
    from linearcorex_tpu_torch.models.corex import (_fit_program,
                                                    resolve_config,
                                                    torch_dtype)
    from linearcorex_tpu_torch.parallel import sharding as S
    ensure_compile_cache()
    device = S.check_mesh(mesh)
    if M.is_quantized(data) and check_overflow:
        M._check_int8_wrap(data)
    if n_samples is None and strategy == "samples":
        n_samples = M.n_rows(data)
    cfg = resolve_config(cfg, w0_batch.shape[-1], mesh.device_type,
                         n_samples=n_samples)
    sizes = S.mesh_sizes(mesh)
    d = sizes.get(axis_name)
    if d is None or w0_batch.shape[0] % d:
        raise ValueError(
            f"the restart batch ({w0_batch.shape[0]} fits) shards over "
            f"mesh axis {axis_name!r} (size {d}); the batch must divide "
            f"evenly — pad the init stack (pick_n_hidden does this "
            f"automatically) or adjust the mesh")
    dt = torch_dtype(cfg.dtype)
    axes = ()
    if data_axis is not None:
        if strategy != "samples":
            raise ValueError(
                "data_axis shards the SAMPLE rows of X; a Gram operand "
                "carries none — the combined restarts x data layout is "
                "samples-strategy only")
        dd = sizes.get(data_axis)
        if dd is None or M.n_rows(data) % dd:
            raise ValueError(
                f"data_axis={data_axis!r}: the {M.n_rows(data)} sample "
                f"rows must divide the mesh axis (size {dd}) evenly — "
                f"trim/pad the rows or adjust the mesh (rows shard "
                f"without padding)")
        axes = (S.mesh_axis(mesh, data_axis),)
    if strategy == "samples":
        rows = M._unsharded(data)[0]
        rows = rows.q if isinstance(rows, M.QuantizedData) else rows
        data = S.shard_samples(
            data, axes, device,
            None if isinstance(rows, torch.Tensor) else dt)
    elif isinstance(data, M.QuantizedData):
        data = M.QuantizedData(q=data.q.to(device),
                               scale=data.scale.to(device))
    else:
        data = S._as_device_tensor(data, device,
                                   None if isinstance(data, torch.Tensor)
                                   else dt)
    lane_axis = S.mesh_axis(mesh, axis_name)
    per = w0_batch.shape[0] // d
    w0 = S._as_device_tensor(
        w0_batch[lane_axis.index * per:(lane_axis.index + 1) * per],
        device, dt)
    ws, mom, diag = _fit_program(data, w0, cfg, strategy, mesh=True)
    # the per-stage iteration counts are kept on the host by the solver
    parts = [ws, *mom, *(a.to(device) for a in diag)]
    whole = all_gather_lanes(parts, lane_axis)
    n_mom = len(mom)
    diag_all = type(diag)(*whole[1 + n_mom:])
    diag_all = diag_all._replace(
        iters_per_stage=diag_all.iters_per_stage.to(
            diag.iters_per_stage.device))
    return whole[0], M.Moments(*whole[1:1 + n_mom]), diag_all


def padded_lanes(batch: int, axis_size: int) -> int:
    """Lane count after padding `batch` up to a multiple of the restart
    axis (the lanes split into equal shares)."""
    return batch + ((-batch) % axis_size)


def _lane_bytes(lanes: int, m: int, p: int, itemsize: int) -> int:
    return lanes * LANE_STATE_MATRICES * m * p * itemsize


@contextlib.contextmanager
def lane_oom_guidance(lanes: int, m: int, p: int, itemsize: int):
    """Scope that turns a device out-of-memory error inside a restart
    sweep into `LaneOutOfMemoryError`, whose message states the lane
    memory model and the remedies. Allocate the lanes and read their
    results inside the scope."""
    try:
        yield
    except torch.cuda.OutOfMemoryError as e:
        raise LaneOutOfMemoryError(
            f"the {lanes}-lane restart sweep ran out of device memory: "
            f"every lane holds its own (n_hidden, n_variables) = ({m}, {p})"
            f" solver state, about {LANE_STATE_MATRICES} such matrices, "
            f"{_lane_bytes(1, m, p, itemsize)} bytes a lane and "
            f"{_lane_bytes(lanes, m, p, itemsize)} for the sweep, beside "
            f"the shared data operand. Use fewer lanes (Corex n_restarts= "
            f"/ pick_n_hidden repeat=), run the fits one after another "
            f"(seeded single fits; pick_n_hidden(padded_sweep=False)), or "
            f"an int8 or bf16 operand for a smaller shared data operand. "
            f"Device error: {e}") from e


def restart_batch_runner(mesh=None, restart_axis: str = "restarts",
                         data_axis: Optional[str] = None):
    """Batch-fit dispatcher for restart sweeps, shared by
    `Corex(n_restarts=k)` and `pick_n_hidden`: `fit_restarts` on one
    device or, with a mesh, `fit_restarts_sharded` with the lanes split
    over `restart_axis` (and, when `data_axis` is given, the sample rows
    over that axis too). A batch that does not divide the axis is padded
    by repeating the last init, and the padded lanes are dropped from
    every result before selection. Both run under `lane_oom_guidance`,
    with the results read inside it."""
    if mesh is None:
        def run_single(data, w0, cfg, strategy, n):
            k, m, p = w0.shape
            with lane_oom_guidance(k, m, p, w0.element_size()):
                out = fit_restarts(data, w0, cfg, strategy, n_samples=n)
                if w0.device.type == "cuda":
                    torch.cuda.synchronize(w0.device)
            return out

        return run_single
    if restart_axis not in mesh.mesh_dim_names:
        raise ValueError(
            f"mesh has axes {tuple(mesh.mesh_dim_names)}; the restart "
            f"batch shards over {restart_axis!r} — build the mesh with "
            f"that axis (make_mesh((({restart_axis!r}, n_devices),))) or "
            f"pass restart_axis=")
    d = dict(zip(mesh.mesh_dim_names, tuple(mesh.mesh.shape)))[restart_axis]

    def run(data, w0, cfg, strategy, n):
        k, m, p = w0.shape
        pad = padded_lanes(k, d) - k
        with lane_oom_guidance((k + pad) // d, m, p, w0.element_size()):
            if pad:
                w0 = torch.cat([w0, w0[-1:].expand(pad, -1, -1)], dim=0)
            # check_overflow=False: every caller's prepare path already
            # ran the int8 wrap guard on this operand
            out = fit_restarts_sharded(data, w0, cfg, strategy, mesh,
                                       axis_name=restart_axis, n_samples=n,
                                       check_overflow=False,
                                       data_axis=data_axis)
            if mesh.device_type == "cuda":
                torch.cuda.synchronize()
        if pad:
            out = tuple(type(part)(*(a[:-pad] for a in part))
                        if isinstance(part, tuple) else part[:-pad]
                        for part in out)
        return out

    return run


def best_restart(ws_batch, mom_batch, diag_batch):
    """The lane with the highest final TC (the reference keeps the
    best-TC refit): (ws, Moments, FitDiagnostics, index)."""
    best = int(torch.argmax(mom_batch.tc))
    return (ws_batch[best], M.Moments(*(a[best] for a in mom_batch)),
            type(diag_batch)(*(a[best] for a in diag_batch)), best)
