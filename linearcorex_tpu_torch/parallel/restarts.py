"""Restart sweeps: k independent annealed fits run side by side as lanes.

Port of `linearcorex_tpu/parallel/restarts.py` for one device. The JAX
package runs a sweep as `jax.vmap` over the whole annealed fit. Here the
lanes are a leading axis written out: `core.solver.fit_core` runs them
in lockstep (a lane frozen once its own predicate is false), the moment
functions apply the shared data operand to all lanes in one product, and
the chain kernel takes every lane in one launch per pass
(`ops.cuda_moments.ns_chain`).

The sharded forms (`fit_restarts_sharded`, a mesh in
`restart_batch_runner`) are not ported yet (ROADMAP.md Queue 1, item 17).
"""

from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch

from linearcorex_tpu_torch.config import CorexConfig
from linearcorex_tpu_torch.ops import moments as M

__all__ = ["init_restarts", "fit_restarts", "best_restart",
           "restart_batch_runner", "lane_oom_guidance",
           "LaneOutOfMemoryError"]

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


def init_restarts(n_restarts: int, m: int, p: int, seed: Optional[int],
                  dtype=torch.float32, device="cuda") -> torch.Tensor:
    """Stack of seeded N(0, 1/sqrt(p)) inits, (n_restarts, m, p): restart
    r uses NumPy RandomState(base + r), so restart 0 of a seeded sweep is
    the W0 of a plain `Corex(seed=seed)` fit (and of the JAX package's
    sweep). seed=None draws a fresh base (`seed_base`). On the card by
    default, as `Corex` and `pick_n_hidden` are; pass device="cpu" for
    the CPU."""
    base = seed_base(seed)
    w0 = np.stack([
        np.random.RandomState(base + r).normal(
            loc=0.0, scale=1.0 / np.sqrt(p), size=(m, p))
        for r in range(n_restarts)
    ])
    return torch.as_tensor(w0, dtype=dtype, device=device)


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
    if n_samples is None and strategy == "samples":
        n_samples = (data.q if isinstance(data, M.QuantizedData)
                     else data).shape[0]
    cfg = resolve_config(cfg, w0_batch.shape[-1], w0_batch.device,
                         n_samples=n_samples)
    return _fit_program(data, w0_batch, cfg, strategy)


def fit_restarts_sharded(*args, **kwargs):
    """The restart sweep sharded over a device mesh: not ported yet."""
    raise NotImplementedError(
        "fit_restarts_sharded (restart lanes over a device mesh) is not "
        "ported to the PyTorch package yet (ROADMAP.md Queue 1, item 17 "
        "(sharding)); the JAX package linearcorex_tpu supports it")


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
    device, under `lane_oom_guidance`, with the results read inside it.
    A mesh (the sharded sweep) is not ported yet."""
    del restart_axis, data_axis
    if mesh is not None:
        raise NotImplementedError(
            "restart sweeps over a device mesh are not ported to the "
            "PyTorch package yet (ROADMAP.md Queue 1, item 17 (sharding)); "
            "the JAX package linearcorex_tpu supports them")

    def run_single(data, w0, cfg, strategy, n):
        k, m, p = w0.shape
        with lane_oom_guidance(k, m, p, w0.element_size()):
            out = fit_restarts(data, w0, cfg, strategy, n_samples=n)
            if w0.device.type == "cuda":
                torch.cuda.synchronize(w0.device)
        return out

    return run_single


def best_restart(ws_batch, mom_batch, diag_batch):
    """The lane with the highest final TC (the reference keeps the
    best-TC refit): (ws, Moments, FitDiagnostics, index)."""
    best = int(torch.argmax(mom_batch.tc))
    return (ws_batch[best], M.Moments(*(a[best] for a in mom_batch)),
            type(diag_batch)(*(a[best] for a in diag_batch)), best)
