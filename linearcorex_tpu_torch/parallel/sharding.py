"""Multi-device execution: sharded fits over a device mesh, on
`torch.distributed`.

Port of `linearcorex_tpu/parallel/sharding.py`: every `ShardingPlan` over
the sample axes (`data`, `slice`), the variable axis (`var`) and the
factor axis (`model`), alone or together on a mesh of several axes;
restart lanes over a `restarts` axis are in `parallel.restarts`.

The model of execution
----------------------
The JAX package is single-controller: one process hands a global array to
a `Mesh` and the compiler inserts the collectives. PyTorch is SPMD: one
process per device, and the collectives are written out here. The rule:

- `mesh=` is a `torch.distributed.device_mesh.DeviceMesh` with named axes,
  one process group per axis (`make_mesh`). The caller has initialized the
  default process group (NCCL for a CUDA mesh, gloo for a CPU mesh;
  `parallel.launch` does both for a local world). An entry point given a
  mesh without an initialized group raises by name, and so does a mesh
  whose device type differs from the model's device. Nothing falls back
  to one device.
- Every rank calls the same entry point with the same arguments: the
  whole X, as the JAX surface takes it. A rank keeps only its own block
  on its device (its rows over the sample axes, its columns over `var`);
  a rank that passes a host array never lands the whole X there.
- `var` splits the p variables: X's columns, W's columns and a Gram
  operand's rows (Σ row blocks). Per-variable quantities stay local; sums
  over p are local sums and one `all_reduce` over `var`, and only
  m-sized, (m, m) and (n_loc, m) blocks cross it (`ops.moments` states
  each). No rank ever holds the whole (n, p) X or the whole (p, p) Σ.
- `model` splits the m factors: W's rows. Sums over m are (p,) vectors
  summed over `model`; the m-wide couplings all-gather C_xy's columns (at
  most m x p values), and each rank computes its rows of them.
- Every result of a fit is replicated. After a fit, `ws`, the moments,
  the diagnostics and theta are equal bit for bit on every rank: each sum
  over ranks is an `all_reduce` or a gather, which leaves the same bits
  everywhere, and all arithmetic after it is the same on every rank. The
  fit ends with one all-gather of each split m x p or p x m result. The
  solver's accept/reject decisions and its step size read only such
  values (max|ΔW| is a MAX `all_reduce` over W's axes), so the ranks
  never take different branches. Serving calls return the (n, m) factors
  whole on every rank; under `var` a p-sized output stays split (a
  `torch.distributed.tensor.DTensor`, `Shard` over `var`).

The communication surface of a sample-sharded fit is one SUM `all_reduce`
of the (p, m) cross-moment per Σ-application (one per objective evaluation
on the fixed point, two on the gradient paths). Rows split over both
`slice` and `data` reduce over `data` first, then over `slice`: two
`all_reduce`s, in that fixed order. Everything after the sum is replicated,
so the fused chain kernel runs unchanged on each rank's full C_xy.
Under `var` or `model` the same Σ-applications carry this rank's block,
and the chain kernel takes the whole (p, m) C_xy: `use_pallas='auto'`
turns it off for such plans (`resolve_sharded_config`), and 'always'
all-gathers C_xy over the split axes before each launch.
`collective_counts()` reads back what a fit sent.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from linearcorex_tpu_torch.config import CorexConfig
from linearcorex_tpu_torch.ops import moments as M
from linearcorex_tpu_torch.parallel.collectives import (Axis, all_reduce,
                                                        broadcast_int,
                                                        collective_counts,
                                                        reset_collective_counts,
                                                        shard_count,
                                                        shard_index)
from linearcorex_tpu_torch.utils.compile_cache import ensure_compile_cache

__all__ = ["ShardingPlan", "make_mesh", "make_hybrid_mesh", "fit_sharded",
           "fit_shard_map", "finish_sharded", "operand_specs",
           "validate_plan_shapes", "resolve_sharded_config", "shard_block",
           "shard_w", "as_dtensor", "all_reduce", "collective_counts",
           "reset_collective_counts", "SLICE_AXIS", "DATA_AXIS", "VAR_AXIS",
           "FACTOR_AXIS"]

DATA_AXIS = "data"     # shards the sample axis n (inside a slice)
VAR_AXIS = "var"       # shards the variable axis p
FACTOR_AXIS = "model"  # shards the factor axis m
SLICE_AXIS = "slice"   # OUTER sample-axis shard of a 2-level slice x device
#                        mesh (the slower network between slices)


@dataclasses.dataclass(frozen=True)
class ShardingPlan:
    """How one fit maps onto a mesh. Hashable.

    shard_samples: split X rows (n) over DATA_AXIS          [primary]
    shard_vars:    split X cols + W cols (p) over VAR_AXIS
    shard_factors: split W rows (m) over FACTOR_AXIS
    shard_slices:  split X rows over SLICE_AXIS too: on a 2-level mesh
                   ((SLICE_AXIS, n_slices), (DATA_AXIS, per_slice)) the
                   sample axis shards over both, slice-major, and the
                   (p, m) cross-moment reduces inside a slice first.

    A spec is a plain tuple with one entry per dimension: None
    (replicated), an axis name, or a tuple of axis names (outermost
    first)."""

    shard_samples: bool = True
    shard_vars: bool = False
    shard_factors: bool = False
    shard_slices: bool = False

    def _sample_axes(self):
        axes = []
        if self.shard_slices:
            axes.append(SLICE_AXIS)
        if self.shard_samples:
            axes.append(DATA_AXIS)
        if not axes:
            return None
        return axes[0] if len(axes) == 1 else tuple(axes)

    def sample_axis_names(self) -> Tuple[str, ...]:
        """The mesh axes the sample rows split over, outermost first."""
        a = self._sample_axes()
        return () if a is None else (a,) if isinstance(a, str) else a

    def x_spec(self) -> tuple:
        return (self._sample_axes(), VAR_AXIS if self.shard_vars else None)

    def w_spec(self) -> tuple:
        return (FACTOR_AXIS if self.shard_factors else None,
                VAR_AXIS if self.shard_vars else None)

    def y_spec(self) -> tuple:
        """(n, m) factor-matrix layout: rows over the sample axes, columns
        over FACTOR_AXIS (the transform output, the predict input)."""
        return (self._sample_axes(),
                FACTOR_AXIS if self.shard_factors else None)

    def v_spec(self, ndim: int = 1) -> tuple:
        """(p,) / (p, k) operand layout (`covariance_matvec` / `_matmat`
        under a mesh): rows over VAR_AXIS, trailing dims replicated."""
        return (VAR_AXIS if self.shard_vars else None,
                *([None] * (ndim - 1)))


def operand_specs(plan: ShardingPlan, strategy: str):
    """(data_spec, w_spec) for a fit operand under `plan`. strategy='gram'
    shards Σ's rows along the variable axis (the sample axes don't exist
    on a Gram operand)."""
    if strategy == "gram":
        if plan.shard_slices:
            raise ValueError(
                "shard_slices splits the SAMPLE axis; a Gram operand "
                "carries none — use shard_vars for multi-device gram "
                "layouts (Σ row-blocks)")
        return ((VAR_AXIS if plan.shard_vars else None, None),
                (FACTOR_AXIS if plan.shard_factors else None, None))
    return plan.x_spec(), plan.w_spec()


def mesh_sizes(mesh) -> dict:
    """{axis name: size} of a DeviceMesh."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.mesh.shape)))


def validate_plan_shapes(plan: ShardingPlan, strategy: str, mesh,
                         n: Optional[int], p: int, m: int,
                         raw_x: bool = False) -> None:
    """Fail fast, by name: every axis the plan shards over must be in the
    mesh, and every sharded dimension must divide by the product of its
    mesh axes (rows are split into equal blocks, never padded). Pad or
    trim the data, or drop the offending plan flag, to fix.

    raw_x=True: the caller shards the RAW X (n x p) per `plan.x_spec()`
    before the operand is built (the mesh-aware prepare of
    `Corex.fit(mesh=...)`), so the sample-axis check applies even when
    strategy='gram'."""
    sizes = mesh_sizes(mesh)

    def need(axes_used, dim, value, what):
        total = 1
        for a in axes_used:
            if a not in sizes:
                raise ValueError(
                    f"plan shards {what} over mesh axis {a!r}, but the "
                    f"mesh has axes {tuple(sizes)} — build the mesh with "
                    f"that axis (make_mesh) or change the ShardingPlan")
            total *= sizes[a]
        if value % total:
            raise ValueError(
                f"{what} = {value} is not divisible by the mesh's "
                f"{'x'.join(axes_used)} extent ({total}); rows and columns "
                f"shard without padding — trim/pad the {dim} dimension or "
                f"adjust the plan/mesh")

    if raw_x or strategy != "gram":
        sample_axes = list(plan.sample_axis_names())
        if sample_axes and n is not None:
            need(sample_axes, "sample", n, "n_samples")
    if plan.shard_vars:
        need([VAR_AXIS], "variable", p, "n_variables")
    if plan.shard_factors:
        need([FACTOR_AXIS], "factor", m, "n_hidden")


_MESH_BACKEND = {"cuda": "nccl", "cpu": "gloo"}


def check_backend(device_type: str, group=None) -> None:
    """Hold a process group (None: the default one) to the backend a mesh
    over `device_type` devices needs: NCCL for the card, gloo for the
    CPU. gloo would take a card tensor too, through the host and without
    a word, so the pairing raises by name instead."""
    want = _MESH_BACKEND.get(device_type)
    by_device = dict(part.split(":") for part in
                     dist.get_backend_config(group).split(","))
    got = by_device.get(device_type)
    if want is not None and got != want:
        raise ValueError(
            f"a mesh over {device_type!r} devices needs the {want} "
            f"backend, but the process group carries "
            f"{got or 'no backend'} for {device_type!r} tensors "
            f"({dist.get_backend_config(group)}): call "
            f"init_process_group({want!r}, ...) (parallel.launch."
            f"run_world(..., backend={want!r})), or build the mesh with "
            f"make_mesh(device=...) for the backend you have")


def check_mesh(mesh, device=None) -> torch.device:
    """The device a rank computes on under `mesh`. Raises by name when
    torch.distributed has no default process group (the caller
    initializes it, one process per device), when the mesh's process
    groups do not carry the backend of its device type (`check_backend`),
    or when `device` (the model's) is of another type than the mesh."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "a mesh needs torch.distributed's default process group: run "
            "one process per device and call init_process_group (NCCL for "
            "a CUDA mesh, gloo for a CPU mesh) in each before the entry "
            "point — parallel.launch.run_world does this for a local world")
    mesh_dev = torch.device(mesh.device_type)
    for name in mesh.mesh_dim_names:
        check_backend(mesh_dev.type, mesh.get_group(name))
    if device is not None and torch.device(device).type != mesh_dev.type:
        raise ValueError(
            f"the mesh is over {mesh.device_type!r} devices but the model "
            f"runs on device={str(device)!r}; build the mesh with "
            f"make_mesh(device={torch.device(device).type!r}) or move the "
            f"model")
    if device is not None:
        return torch.device(device)
    return mesh_dev


def shared_seed(seed, mesh, device) -> int:
    """The seed every rank of `mesh` draws its inits from: `seed` itself,
    or, for an unseeded call, fresh entropy drawn on the mesh's first
    rank and broadcast (ranks that drew their own would start from
    different weights and part ways at the first accept/reject)."""
    if seed is not None:
        return seed
    base = int(np.random.SeedSequence().generate_state(1)[0] % (2 ** 31))
    return broadcast_int(base, mesh_first_rank(mesh), device)


def mesh_first_rank(mesh) -> int:
    """The rank (in the default process group) of the mesh's first
    device: the one rank that acts for the mesh where exactly one must
    (a shared seed's draw, a checkpoint file's write)."""
    return int(mesh.mesh.flatten()[0])


def mesh_barrier(mesh, device) -> None:
    """Return once every rank of `mesh` has called this: one one-element
    SUM `all_reduce` over each mesh axis in turn (a rank leaves the last
    only after every rank has entered the first)."""
    all_reduce(torch.zeros(1, device=device),
               [mesh_axis(mesh, name) for name in mesh.mesh_dim_names])


def mesh_axis(mesh, name: str) -> Axis:
    """One named axis of `mesh` as this rank sees it."""
    group = mesh.get_group(name)
    return Axis(name, group, dist.get_world_size(group),
                dist.get_rank(group))


def sample_axes(mesh, plan: ShardingPlan) -> Tuple[Axis, ...]:
    """The `Axis` tuple (outermost first) the plan splits sample rows
    over."""
    return tuple(mesh_axis(mesh, a) for a in plan.sample_axis_names())


def var_axis(mesh, plan: ShardingPlan) -> Optional[Axis]:
    """The `Axis` the plan splits the variables over, or None."""
    return mesh_axis(mesh, VAR_AXIS) if plan.shard_vars else None


def factor_axis(mesh, plan: ShardingPlan) -> Optional[Axis]:
    """The `Axis` the plan splits the factors (W's rows) over, or None."""
    return mesh_axis(mesh, FACTOR_AXIS) if plan.shard_factors else None


def _mesh_from_ranks(device_type: str, ranks: np.ndarray, names, timeout):
    """A DeviceMesh over the rank array `ranks`, one new process group per
    line of ranks along each axis, every group with `timeout`. Every rank
    of the world calls this with the same arguments."""
    from torch.distributed.device_mesh import DeviceMesh
    me = dist.get_rank()
    mine = []
    for dim in range(ranks.ndim):
        lines = np.moveaxis(ranks, dim, -1).reshape(-1, ranks.shape[dim])
        kept = None
        for line in lines.tolist():
            kw = {} if line == sorted(line) else {"sort_ranks": False}
            g = dist.new_group(ranks=line, timeout=timeout, **kw)
            if me in line:
                kept = g
        mine.append(kept)
    return DeviceMesh.from_group(
        mine[0] if len(mine) == 1 else mine, device_type,
        mesh=torch.as_tensor(ranks, dtype=torch.int),
        mesh_dim_names=tuple(names))


def make_mesh(axes: Optional[Tuple[Tuple[str, int], ...]] = None,
              device: str = "cuda", timeout=None):
    """Build a named mesh over the ranks of the initialized default
    process group, in rank order. Default: one `data` axis over all
    ranks, on the card; pass device="cpu" for a gloo world.

    axes: tuple of (axis_name, size); sizes must multiply to the world
    size. `timeout` (a timedelta) bounds every collective of the mesh's
    groups; None leaves the backend's default."""
    check_mesh_device = torch.device(device).type
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "make_mesh builds the mesh over torch.distributed's default "
            "process group, which is not initialized: run one process per "
            "device and call init_process_group in each "
            "(parallel.launch.run_world does this for a local world)")
    check_backend(check_mesh_device)
    world = dist.get_world_size()
    if axes is None:
        axes = ((DATA_AXIS, world),)
    names = tuple(a for a, _ in axes)
    sizes = tuple(int(s) for _, s in axes)
    if int(np.prod(sizes)) != world:
        raise ValueError(
            f"axes {dict(axes)} need {int(np.prod(sizes))} ranks, the "
            f"process group has {world}")
    return _mesh_from_ranks(check_mesh_device,
                            np.arange(world).reshape(sizes), names, timeout)


def make_hybrid_mesh(axes, device: str = "cuda", *, granule_key=None,
                     timeout=None):
    """Build the 2-level multi-slice mesh whose outer axis follows a
    physical grouping of the ranks instead of their enumeration order.

    axes: ((SLICE_AXIS, n_slices), (name, size), ...): the first axis must
      be `SLICE_AXIS`; the rest are inside a slice.
    granule_key: callable `rank -> slice id` (for instance the node a rank
      runs on). Slices are ordered by sorted key, the ranks of a slice by
      rank. Required: the JAX package's other branch reads the slice of a
      device from the TPU topology, which has no counterpart here.

    Pass the mesh to `fit_sharded` with a `shard_slices=True` plan."""
    names = tuple(a for a, _ in axes)
    sizes = tuple(int(s) for _, s in axes)
    if not names or names[0] != SLICE_AXIS:
        raise ValueError(
            f"the first axis of a hybrid mesh must be {SLICE_AXIS!r} "
            f"(the axis between slices); got axes {names} — reorder, or "
            f"use make_mesh for single-slice layouts")
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "make_hybrid_mesh builds the mesh over torch.distributed's "
            "default process group, which is not initialized")
    check_backend(torch.device(device).type)
    n_slices, inner = sizes[0], sizes[1:]
    world = dist.get_world_size()
    if world != int(np.prod(sizes)):
        raise ValueError(
            f"axes {dict(axes)} need {int(np.prod(sizes))} devices, "
            f"got {world}")
    if granule_key is None:
        raise ValueError(
            "make_hybrid_mesh needs granule_key=<rank -> slice id>: ranks "
            "carry no slice_index here (the JAX package reads it from the "
            "TPU topology) — pass for instance the node of each rank")
    groups: dict = {}
    for r in range(world):
        groups.setdefault(granule_key(r), []).append(r)
    if len(groups) != n_slices:
        raise ValueError(
            f"granule_key yields {len(groups)} slices; the mesh asks for "
            f"{n_slices}")
    per_slice = []
    need = int(np.prod(inner, dtype=int))
    for key in sorted(groups):
        g = groups[key]
        if len(g) != need:
            raise ValueError(
                f"slice {key!r} holds {len(g)} devices; the intra-slice "
                f"axes {dict(axes[1:])} need {need}")
        per_slice.append(np.asarray(g))
    return _mesh_from_ranks(torch.device(device).type,
                            np.stack(per_slice).reshape(sizes), names,
                            timeout)


def resolve_sharded_config(cfg: CorexConfig, mesh, plan: ShardingPlan,
                           p: int, n_samples) -> CorexConfig:
    """'auto'-knob resolution for a sharded fit: var/factor-sharded
    layouts turn the chain kernel off (it takes the full (p, m)
    cross-moment, which those layouts hold on no rank: 'always' gathers it
    before every launch), then the standard resolve_config runs against
    the MESH's device type."""
    from linearcorex_tpu_torch.models.corex import resolve_config
    if plan.shard_vars or plan.shard_factors:
        if cfg.use_pallas == "auto":
            cfg = dataclasses.replace(cfg, use_pallas="never")
    return resolve_config(cfg, p, mesh.device_type, n_samples=n_samples)


def _as_device_tensor(a, device, dtype=None):
    if not isinstance(a, torch.Tensor):
        a = torch.as_tensor(np.asarray(a))
    if dtype is not None and a.is_floating_point():
        return a.to(device=device, dtype=dtype)
    return a.to(device=device)


def _block(n: int, axes) -> slice:
    """This rank's block of a dimension of size n split over `axes`."""
    d = n // shard_count(axes)
    first = shard_index(axes) * d
    return slice(first, first + d)


def shard_rows(x, axes: Tuple[Axis, ...], device, dtype=None):
    """This rank's row block of the whole `x` (a tensor or a host array),
    on `device`: only the block is copied there. `axes` outermost first;
    no axes: all of `x`."""
    return _as_device_tensor(x[_block(x.shape[0], axes)], device, dtype)


def shard_block(x, axes: Tuple[Axis, ...], var: Optional[Axis], device,
                dtype=None):
    """This rank's block of the whole (n, p) `x`: its rows over the sample
    `axes` and its columns over `var` (None: every column), on `device`.
    Only the block is copied there."""
    cols = _block(x.shape[1], (var,) if var else ())
    return _as_device_tensor(x[_block(x.shape[0], axes), cols], device,
                             dtype)


def shard_w(w, var: Optional[Axis], model: Optional[Axis], device,
            dtype=None):
    """This rank's block of the whole (m, p) W: its rows over `model`,
    its columns over `var`."""
    return shard_block(w, (model,) if model else (), var, device, dtype)


def shard_samples(data, axes: Tuple[Axis, ...], device, dtype=None,
                  var: Optional[Axis] = None):
    """The `ShardedSamples` operand of this rank from the whole samples
    operand (X, its bf16 cast, or its `QuantizedData`, whose scale is
    already the whole tensor's): its rows over the sample `axes`, its
    columns over `var`. An operand that is sharded already, or a plan
    that splits neither, passes through (placed on `device`)."""
    if isinstance(data, M.ShardedSamples):
        return data
    if isinstance(data, M.QuantizedData):
        n, p = data.q.shape
        local = M.QuantizedData(
            q=shard_block(data.q, axes, var, device),
            scale=_as_device_tensor(data.scale, device))
    else:
        n, p = data.shape
        local = shard_block(data, axes, var, device, dtype)
    if not axes and var is None:
        return local
    return M.ShardedSamples(local=local, n_total=n, axes=tuple(axes),
                            p_total=p, var=var)


def shard_gram(data, var: Optional[Axis], device, dtype=None):
    """The Gram operand of this rank from the whole Σ (or its
    `QuantizedData`): its row block Σ[I, :] over `var`, or the whole Σ
    when the plan does not split the variables. An operand that is
    sharded already passes through."""
    if isinstance(data, M.ShardedSamples):
        return data
    quantized = isinstance(data, M.QuantizedData)
    p = (data.q if quantized else data).shape[0]
    rows = _block(p, (var,) if var else ())
    if quantized:
        local = M.QuantizedData(q=_as_device_tensor(data.q[rows], device),
                                scale=_as_device_tensor(data.scale, device))
    else:
        local = _as_device_tensor(data[rows], device, dtype)
    if var is None:
        return local
    return M.ShardedSamples(local=local, n_total=p, axes=(), p_total=p,
                            var=var, gram=True)


def as_dtensor(local: torch.Tensor, mesh, dims: dict):
    """A `DTensor` over `mesh` from this rank's block `local`: `dims` maps
    a mesh axis name to the tensor dimension it splits (`Shard`); every
    other axis holds the same block on each of its ranks (`Replicate`).
    `.full_tensor()` gathers it whole."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    sizes = mesh_sizes(mesh)
    shape = list(local.shape)
    for name, dim in dims.items():
        shape[dim] *= sizes[name]
    placements = [Shard(dims[name]) if name in dims else Replicate()
                  for name in mesh.mesh_dim_names]
    return DTensor.from_local(
        local.contiguous(), mesh, placements, run_check=False,
        shape=torch.Size(shape),
        stride=torch.empty(shape, device="meta").stride())


def fit_shard_map(x, w0, cfg: CorexConfig, mesh,
                  axis_name: str = DATA_AXIS):
    """Sample-sharded fit over the one mesh axis `axis_name`: each rank
    holds an n/d row block of X, computes its part of Xᵀ(X·Wᵀ) and sums
    the (p, m) cross-moment over the axis: once per objective evaluation
    on the fixed point, a second time for AA·Σ on the gradient path, once
    more for the final moments. Everything after the sum is replicated,
    which is what lets the fused chain kernel run under sharding
    (cfg.use_pallas='always'). The JAX package writes this form out with
    explicit psums beside its compiler-partitioned `fit_sharded`; here
    every collective is explicit already (`ops.moments` sums a
    `ShardedSamples` operand's partials), so this is the same fit program
    as `fit_sharded` with the default plan, behind the explicit form's
    own rejections. Only the non-overlap solver path is supported
    here."""
    from linearcorex_tpu_torch.models.corex import (_fit_program,
                                                    resolve_config,
                                                    torch_dtype)
    ensure_compile_cache()
    device = check_mesh(mesh)
    if not cfg.discourage_overlap:
        raise ValueError("fit_shard_map supports discourage_overlap=True "
                         "only; use fit_sharded for the overlap path")
    if M.is_quantized(x) or cfg.matmul_dtype == "int8":
        raise ValueError(
            "fit_shard_map runs the f32/bf16 collectives only; use "
            "fit_sharded for matmul_dtype='int8' — it reduces the int32 "
            "partials exactly and is held bitwise to the single-device "
            "int8 Σ-application")
    n_total, p = x.shape
    cfg = resolve_config(cfg, p, mesh.device_type, n_samples=n_total)
    if cfg.stage_subsample < 1.0 and len(cfg.anneal_schedule()) > 1:
        raise ValueError(
            "stage_subsample < 1 is not supported by fit_shard_map (one "
            "solve over the whole schedule); set stage_subsample=1, or "
            "fit single-device via Corex.fit")
    d = mesh_sizes(mesh).get(axis_name)
    if d is None or n_total % d:
        raise ValueError(
            f"fit_shard_map shards the {n_total} sample rows over mesh "
            f"axis {axis_name!r} (size {d}); the row count must divide "
            f"evenly (rows shard without padding)")
    dt = torch_dtype(cfg.dtype)
    axes = (mesh_axis(mesh, axis_name),)
    local = shard_rows(x, axes, device,
                       None if isinstance(x, torch.Tensor) else dt)
    return _fit_program(M.ShardedSamples(local, n_total, axes),
                        _as_device_tensor(w0, device, dt), cfg, "samples")


def fit_sharded(data, w0, cfg: CorexConfig, mesh,
                plan: ShardingPlan = ShardingPlan(),
                strategy: str = "samples", n_samples=None,
                check_overflow: bool = True):
    """Run the annealed fit with the data laid out per `plan` on `mesh`:
    the single-device fit program (`models.corex._fit_program`) on this
    rank's block of the operand and of W0 (`operand_specs`).

    strategy='samples': `data` is the whole X (n x p), on every rank; each
    keeps its rows over the plan's sample axes (`shard_samples` rows over
    `data`, `shard_slices` over `slice` too, slice-major) and its columns
    over `var` (`shard_vars`). strategy='gram': `data` is Σ (p x p); under
    `shard_vars` each rank keeps its row block Σ[I, :], else every rank
    holds all of it (a sample-only plan has no axis of it to shard). W0 is
    split by columns over `var` and by rows over `model`
    (`shard_factors`). `data` may also be the `ShardedSamples` block the
    mesh-aware prepare of `Corex.fit(mesh=...)` made. Returns (ws,
    Moments, FitDiagnostics), whole and the same bits on every rank.

    A caller-built `QuantizedData` operand runs the int8 accumulator-wrap
    guard here (this is where pre-quantized operands arrive, past
    `quantize_samples`' own guard); pass check_overflow=False only when
    the same operand was already guarded, as `Corex.fit(mesh=...)` does.
    """
    from linearcorex_tpu_torch.models.corex import _fit_program
    ensure_compile_cache()
    data, w_local, model, cfg = _sharded_operands(
        data, w0, cfg, mesh, plan, strategy, n_samples, check_overflow)
    return _fit_program(data, w_local, cfg, strategy, model=model)


def finish_sharded(data, ws, cfg: CorexConfig, mesh,
                   plan: ShardingPlan = ShardingPlan(),
                   strategy: str = "samples", n_samples=None):
    """The end of `fit_sharded` on its own: the moments at eps = 0 from
    the whole `ws` and the factor sort, each rank on its block of the
    operand and of W laid out as `fit_sharded` lays them out, in the fit's
    precision scope. Returns (sorted ws, Moments), whole and the same
    bits on every rank. The staged fit (`utils.checkpoint`) runs its
    stages through `fit_sharded` and ends here."""
    from linearcorex_tpu_torch.models.corex import (final_moments,
                                                    precision_ctx)
    data, w_local, model, cfg = _sharded_operands(
        data, ws, cfg, mesh, plan, strategy, n_samples, False)
    with precision_ctx(cfg, w_local.device):
        return final_moments(data, w_local, cfg, strategy, model)


def _sharded_operands(data, w0, cfg, mesh, plan, strategy, n_samples,
                      check_overflow):
    """(this rank's operand, its block of W0, the `model` Axis or None,
    the config resolved against the mesh) for `fit_sharded`."""
    from linearcorex_tpu_torch.models.corex import torch_dtype
    device = check_mesh(mesh)
    if M.is_quantized(data) and check_overflow:
        M._check_int8_wrap(data)
    operand = M._unsharded(data)[0]
    operand = operand.q if isinstance(operand, M.QuantizedData) else operand
    p = M.n_cols(data)
    if n_samples is None and strategy == "samples":
        n_samples = M.n_rows(data)
    cfg = resolve_sharded_config(cfg, mesh, plan, p, n_samples)
    validate_plan_shapes(plan, strategy, mesh,
                         n_samples if strategy != "gram" else None, p,
                         np.shape(w0)[0])
    operand_specs(plan, strategy)   # shard_slices on a Gram operand raises
    dt = torch_dtype(cfg.dtype)
    host_dt = None if isinstance(operand, torch.Tensor) else dt
    var, model = var_axis(mesh, plan), factor_axis(mesh, plan)
    if strategy == "gram":
        data = shard_gram(data, var, device, host_dt)
    else:
        data = shard_samples(data, sample_axes(mesh, plan), device, host_dt,
                             var)
    return data, shard_w(w0, var, model, device, dt), model, cfg
