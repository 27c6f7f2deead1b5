#!/usr/bin/env python3
"""Scaling workflows with the PyTorch port: restart sweeps, sharded fits
over a world of ranks, stacking, streaming, int8, and a warmed multi-slice
fit with sharded serving, a checkpoint and a blocked export. The flow of
`examples/scaling.py`, section by section.

    python examples/torch_scaling.py                          # one rank per card
    python examples/torch_scaling.py --device cpu --world 4   # four CPU ranks

PyTorch runs one process per device. So the mesh sections run in a world
of ranks, started once by `parallel.launch.run_world` (NCCL on cards, rank
r on card r; gloo on the CPU), where every rank makes the same calls with
the same arguments and gets the same bits back (`parallel/sharding.py`
states the model). The single-device sections run in this process. This
process prints rank 0's results, and exits non-zero, naming the rank,
if any rank's results differ from rank 0's.

A section that needs an even world is passed over, with a line that
says so, when the world is odd (a one-card machine runs the `data` fit
and the single-device branch of the production workflow), as the JAX
example passes over its sections on an odd device count. `--device cuda`
without a card raises, and a rank that fails fails the run.

On a cluster the ranks come from its own launcher (torchrun, a
scheduler), each calls `init_process_group` and then what
`mesh_sections` calls; build the slice axis from the nodes with
`make_hybrid_mesh(axes, granule_key=<rank -> node>)` instead of
`make_mesh`, so that the collectives inside a slice stay on one node.
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

import linearcorex_tpu_torch as lct
from linearcorex_tpu_torch.config import CorexConfig
from linearcorex_tpu_torch.models.corex import resolve_device
from linearcorex_tpu_torch.ops import preprocessing as P
from linearcorex_tpu_torch.parallel.launch import run_world
from linearcorex_tpu_torch.parallel.restarts import (best_restart,
                                                     fit_restarts,
                                                     init_restarts)
from linearcorex_tpu_torch.parallel.sharding import (DATA_AXIS, SLICE_AXIS,
                                                     ShardingPlan,
                                                     fit_sharded, make_mesh)

WORLD_TIMEOUT = 900.0   # seconds: the deadline of the whole world


def make_data(n=2048, p=128, m=8, seed=0):
    rng = np.random.RandomState(seed)
    z = rng.normal(size=(n, m))
    k = p // m
    x = np.repeat(z, k, axis=1) * 0.9 + 0.436 * rng.normal(size=(n, p))
    return x


def sweep_inputs(x, device):
    """The standardized rows, the config and the 8 seeded restart inits of
    section 1, which section 2 reuses (lane 0 as its W0)."""
    xp, _ = P.fit_preprocess(torch.as_tensor(x, dtype=torch.float32,
                                             device=device), "standard")
    cfg = CorexConfig(n_hidden=8, dtype="float32", record_history=False)
    w0 = init_restarts(8, 8, x.shape[1], seed=0, device=device)
    return xp, cfg, w0


def mesh_sections(rank, device, world, x, x_prod, ckpt_dir):
    """Every rank of the world runs this, with the same arguments: the
    sample-sharded fit (section 2), the restarts x data sweep (2b) and the
    multi-slice production workflow. Returns this rank's results; each
    must be bitwise rank 0's."""
    from linearcorex_tpu_torch.utils.checkpoint import fit_with_checkpoints

    out = {}
    # --- 2. sample-sharded fit over a `data` mesh of the whole world ----
    xp, cfg, w0 = sweep_inputs(x, device)
    mesh = make_mesh(((DATA_AXIS, world),), device=device)
    ws, mom, _ = fit_sharded(xp, w0[0], cfg, mesh, ShardingPlan())
    out["sharded"] = dict(tc=float(mom.tc), ws=ws.cpu().numpy())
    if world % 2:
        return out

    # --- 2b. the estimator surface: restart lanes over `restarts`, the
    # sample rows over `data`, one call
    mesh_rd = make_mesh((("restarts", 2), (DATA_AXIS, world // 2)),
                        device=device)
    est = lct.Corex(n_hidden=8, n_restarts=4, seed=0, record_history=False,
                    moment_strategy="samples", device=device).fit(
                        x, mesh=mesh_rd)
    out["restarts_data"] = dict(tc=est.tc, lane=est.best_restart_,
                                ws=est.ws.cpu().numpy())

    # --- the production workflow on a 2-level slice x data mesh: each
    # slice's rows are reduced over `data` first, then over `slice`. On a
    # cluster the slices should be the nodes: make_hybrid_mesh(((SLICE_AXIS,
    # nodes), (DATA_AXIS, per_node)), granule_key=lambda rank: rank //
    # per_node) in place of make_mesh
    mesh_sd = make_mesh(((SLICE_AXIS, 2), (DATA_AXIS, world // 2)),
                        device=device)
    plan = ShardingPlan(shard_samples=True, shard_slices=True)
    model = lct.Corex(n_hidden=8, seed=0, record_history=False,
                      device=device)
    # warm what the fit runs: the sharded fit on this mesh and plan
    model.warmup(*x_prod.shape, mesh=mesh_sd, sharding_plan=plan)
    model.fit(x_prod, mesh=mesh_sd, sharding_plan=plan)
    out["multi_slice"] = dict(tc=model.tc, ws=model.ws.cpu().numpy())
    # sharded serving: the rows split per the plan, the (n, m) factors
    # whole on every rank; sharding_plan=None reuses the fit's plan
    y = model.transform(x_prod, mesh=mesh_sd, sharding_plan=plan)
    out["serving"] = dict(y=y, ll=model.score(x_prod, mesh=mesh_sd))
    # one rank, the mesh's first, writes each stage file, so every rank
    # must see the same directory (a shared file system on a cluster)
    fit_with_checkpoints(model, x_prod, ckpt_dir, mesh=mesh_sd,
                         sharding_plan=plan)
    out["checkpointed"] = dict(tc=model.tc, ws=model.ws.cpu().numpy())
    out["export"] = blocked_export(model)
    return out


def blocked_export(model):
    """Dense rows of the p x p covariance without the p x p step (the path
    that matters at p=100k+), against `get_covariance()`."""
    rows = np.vstack([r for _, r in model.covariance_blocks(block_size=48)])
    full = model.get_covariance()
    return dict(shape=rows.shape, max_abs=float(np.abs(rows - full).max()))


def same_bits(a, b):
    """Whether two results of `mesh_sections` are equal bit for bit."""
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(same_bits(a[k], b[k]) for k in a))
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype
                and a.shape == b.shape and a.tobytes() == b.tobytes())
    if isinstance(a, float):
        return isinstance(b, float) and np.float64(a).tobytes() \
            == np.float64(b).tobytes()
    return a == b


def run_mesh_world(device, world):
    """Start the world once, run `mesh_sections` on every rank, check
    that every rank returned rank 0's bits, and return rank 0's
    results."""
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    x, x_prod = make_data(), make_data(n=2048, p=128, m=8, seed=3)
    with tempfile.TemporaryDirectory() as ckpt_dir:
        results = run_world(mesh_sections, world,
                            args=(device, world, x, x_prod, ckpt_dir),
                            backend=backend, timeout=WORLD_TIMEOUT)
    for rank, res in enumerate(results[1:], start=1):
        if not same_bits(results[0], res):
            raise SystemExit(f"rank {rank} returned other results than "
                             f"rank 0: the ranks of a mesh fit must agree "
                             f"bit for bit")
    print(f"world of {world} {backend} rank(s): every rank returned rank "
          f"0's results bit for bit")
    return results[0]


def passed_over(section, world):
    print(f"{section}: passed over (a world of {world} rank(s); the "
          f"layout needs an even world)")


def main(device, world):
    x = make_data()
    n, p = x.shape

    # --- 1. multi-restart sweep: 8 fits as lanes of one solve ------------
    xp, cfg, w0 = sweep_inputs(x, device)
    ws_b, mom_b, diag_b = fit_restarts(xp, w0, cfg, "samples")
    ws, mom, diag, idx = best_restart(ws_b, mom_b, diag_b)
    print(f"restart sweep: best TC {float(mom.tc):.3f} (restart {int(idx)}; "
          f"all: {mom_b.tc.cpu().numpy().round(2)})")

    # --- 2, 2b and the production workflow: one world of ranks ----------
    mesh_out = run_mesh_world(device, world)
    print(f"sharded fit over {world} rank(s): TC "
          f"{mesh_out['sharded']['tc']:.3f}")
    if "restarts_data" in mesh_out:
        est = mesh_out["restarts_data"]
        print(f"estimator restart sweep on the mesh: best TC "
              f"{est['tc']:.3f} (lane {est['lane']})")
    else:
        passed_over("estimator restart sweep on the mesh", world)

    # --- 3. stacked 2-layer CorEx ---------------------------------------
    stack = lct.StackedCorex([8, 2], seed=0, device=device).fit(x)
    print(f"stacked: layer TCs = "
          f"{[round(float(np.sum(t)), 2) for t in stack.tcs]}")
    return mesh_out


def streaming_demo(device):
    """Streaming + summary-statistics workflows (no X in memory)."""
    from linearcorex_tpu_torch import GramAccumulator, fit_from_covariance

    x = make_data(n=4096, p=128, m=8, seed=1)
    acc = GramAccumulator(p=128, device=device)
    for i in range(0, 4096, 512):           # batches stream through
        acc.update(x[i:i + 512])
    model = acc.fit(n_hidden=8, seed=0)
    print(f"streaming fit from {acc.n_samples} samples: TC {model.tc:.3f}")

    sigma = np.cov(x.T)                      # or shared summary statistics
    model2 = fit_from_covariance(sigma, n_samples=4096, n_hidden=8, seed=0,
                                 device=device)
    print(f"fit from covariance matrix:     TC {model2.tc:.3f}")


def int8_demo(device):
    """Quantized operand mode: int8 x int8 -> int32 products (pair with
    tol >= 1e-4)."""
    x = make_data(n=4096, p=256, m=8, seed=2)
    i8 = lct.Corex(n_hidden=8, seed=0, matmul_dtype="int8", tol=1e-4,
                   device=device).fit(x)
    f32 = lct.Corex(n_hidden=8, seed=0, tol=1e-4, device=device).fit(x)
    print(f"int8 fit: TC {i8.tc:.3f} (f32: {f32.tc:.3f}; optimizer ran: "
          f"{i8.resolved_optimizer_})")


def production_demo(device, world, mesh_out):
    """The production workflow: a warmed fit (build and load at deploy
    time, not at the first request), a 2-level multi-slice mesh, stage
    checkpoints on that mesh, and the blocked covariance export. On an
    even world it ran in the ranks (`mesh_sections`); on an odd one it
    runs here, on one device."""
    if world % 2 == 0:
        print(f"multi-slice fit (warmed): TC "
              f"{mesh_out['multi_slice']['tc']:.3f}")
        serving = mesh_out["serving"]
        print(f"sharded serving: factors {serving['y'].shape}, "
              f"log-likelihood {serving['ll']:.3f}")
        print(f"multi-slice checkpointed fit: TC "
              f"{mesh_out['checkpointed']['tc']:.3f}")
        export = mesh_out["export"]
    else:
        passed_over("multi-slice fit", world)
        x = make_data(n=2048, p=128, m=8, seed=3)
        model = lct.Corex(n_hidden=8, seed=0, record_history=False,
                          device=device)
        model.warmup(*x.shape)
        model.fit(x)
        print(f"single-device fit (warmed): TC {model.tc:.3f}")
        export = blocked_export(model)
    print(f"blocked covariance export: {export['shape']}, max|Δ| vs dense "
          f"= {export['max_abs']:.2e}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--world", type=int, default=None,
                    help="ranks of the mesh world (default: the card count "
                         "on cuda, 4 on the CPU)")
    args = ap.parse_args()
    dev = resolve_device(args.device).type
    world = args.world or (torch.cuda.device_count() if dev == "cuda"
                           else 4)
    mesh_out = main(dev, world)
    streaming_demo(dev)
    int8_demo(dev)
    production_demo(dev, world, mesh_out)
