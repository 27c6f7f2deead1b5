"""The collectives of a sharded fit, written out and counted.

Every sum, maximum, gather and hand-over that crosses ranks in this
package goes through the functions here (`all_reduce`, `all_gather_rows`,
`all_gather_dim`, `all_gather_lanes`, `reduce_scatter_dim`, `ring_pass`,
and `broadcast_int` for a shared seed), each a `torch.distributed` call on one mesh axis'
process group. Each call is recorded (kind, reduce op, axis, dtype,
elements, payload bytes), so after a fit `collective_counts()` is the
communication surface of what ran: the place `parallel/audit.py` holds in
the JAX package, which reads the same facts out of compiled HLO.

An `Axis` is one named axis of a device mesh as this rank sees it: the
process group of the ranks that differ from this one along that axis only,
its size and this rank's index in it. A reduce over several axes runs them
in the order given, one `all_reduce` per axis; the order of a float sum is
part of the result, so callers keep it fixed (`parallel.sharding` reduces
over `data`, then over `slice`).

This module imports torch only; `ops.moments`, `ops.preprocessing`,
`core.solver` and the serving methods call it for a sharded operand or a
split W.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = ["Axis", "Collective", "all_reduce", "all_gather_rows",
           "all_gather_dim", "all_gather_lanes", "reduce_scatter_dim",
           "ring_pass",
           "broadcast_int", "collective_counts",
           "reset_collective_counts", "shard_count", "shard_index"]


class Axis(NamedTuple):
    """One mesh axis from this rank's point of view."""

    name: str
    group: Any      # torch.distributed.ProcessGroup
    size: int
    index: int      # this rank's coordinate along the axis


class Collective(NamedTuple):
    """One kind of collective call: what was sent, over which axis."""

    kind: str       # "all_reduce" | "all_gather" | "reduce_scatter" |
    #                 "ring" | "broadcast"
    op: str         # "sum" | "max" | "" (gathers, broadcasts)
    axis: str
    dtype: str
    numel: int      # elements this rank contributes
    bytes: int      # payload bytes this rank contributes


# Collective -> number of calls, in order of first use.
_COUNTS: Dict[Collective, int] = {}

_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}
# one flat output tensor per gather; newer torch renames the call
_ALL_GATHER = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


def reset_collective_counts() -> None:
    """Forget every recorded collective."""
    _COUNTS.clear()


def collective_counts() -> Dict[Collective, int]:
    """The collectives made since the last reset: {Collective: calls},
    in order of first use."""
    return dict(_COUNTS)


def _record(kind: str, op: str, axis: Axis, t: torch.Tensor) -> None:
    key = Collective(kind, op, axis.name, str(t.dtype).removeprefix(
        "torch."), t.numel(), t.numel() * t.element_size())
    _COUNTS[key] = _COUNTS.get(key, 0) + 1


def shard_count(axes: Sequence[Axis]) -> int:
    """Number of blocks a dimension split over `axes` has."""
    n = 1
    for a in axes:
        n *= a.size
    return n


def shard_index(axes: Sequence[Axis]) -> int:
    """This rank's block of a dimension split over `axes`, the first axis
    outermost (rows over (`slice`, `data`): slice-major)."""
    i = 0
    for a in axes:
        i = i * a.size + a.index
    return i


def all_reduce(t: torch.Tensor, axes: Sequence[Axis],
               op: str = "sum") -> torch.Tensor:
    """`t` reduced over every axis in turn (one `all_reduce` per axis, in
    the order given). Returns a new tensor; `t` is left as it was. With no
    axes `t` itself comes back."""
    if not axes:
        return t
    out = t.contiguous().clone()
    for a in axes:
        _record("all_reduce", op, a, out)
        dist.all_reduce(out, op=_REDUCE_OPS[op], group=a.group)
    return out


def broadcast_int(value: int, src: int, device) -> int:
    """`value` as rank `src` of the default process group holds it, on
    every rank (one int64 through `device`)."""
    t = torch.tensor([value], dtype=torch.int64, device=device)
    _record("broadcast", "", Axis("world", None, dist.get_world_size(), 0),
            t)
    dist.broadcast(t, src=src)
    return int(t.item())


def _gather(t: torch.Tensor, a: Axis) -> torch.Tensor:
    """The blocks of every rank along `a`, concatenated on dim 0 in axis
    order."""
    t = t.contiguous()
    _record("all_gather", "", a, t)
    out = t.new_empty((a.size * t.shape[0],) + tuple(t.shape[1:]))
    _ALL_GATHER(out, t, group=a.group)
    return out


def all_gather_rows(t: torch.Tensor, axes: Sequence[Axis]) -> torch.Tensor:
    """The whole of a tensor whose dim 0 is split over `axes` (first axis
    outermost): gathered over the innermost axis first, so the blocks come
    back in `shard_index` order."""
    for a in reversed(tuple(axes)):
        t = _gather(t, a)
    return t


def all_gather_dim(t: torch.Tensor, dim: int, a: Axis) -> torch.Tensor:
    """The whole of a tensor whose dimension `dim` is split over the one
    axis `a` (one gather). The result keeps the input's layout: row-major,
    or the transpose of a row-major matrix (W's columns handed over as
    Wᵀ), so a product with it runs the same GEMM as with an unsplit
    operand."""
    if t.ndim == 2 and not t.is_contiguous() and t.mT.is_contiguous():
        return all_gather_dim(t.mT, 1 - dim % 2, a).mT
    if dim % t.ndim == 0:
        return _gather(t, a)
    return _gather(t.movedim(dim, 0), a).movedim(0, dim).contiguous()


def reduce_scatter_dim(t: torch.Tensor, dim: int, a: Axis) -> torch.Tensor:
    """`t` summed over the one axis `a`, each rank keeping its block of
    dimension `dim` (one reduce-scatter), in row-major layout."""
    src = t.movedim(dim, 0).contiguous()
    _record("reduce_scatter", "sum", a, src)
    out = src.new_empty((src.shape[0] // a.size,) + tuple(src.shape[1:]))
    _REDUCE_SCATTER(out, src, op=dist.ReduceOp.SUM, group=a.group)
    return out.movedim(0, dim).contiguous()


def ring_pass(t: torch.Tensor, a: Axis) -> torch.Tensor:
    """One step of a ring over `a`: this rank sends `t` to the next rank
    along the axis and returns the block of the previous one (same shape
    and dtype). `a.size - 1` passes hand every block to every rank, one
    block at a time."""
    t = t.contiguous()
    _record("ring", "", a, t)
    out = torch.empty_like(t)
    nxt = dist.get_global_rank(a.group, (a.index + 1) % a.size)
    prv = dist.get_global_rank(a.group, (a.index - 1) % a.size)
    for req in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, t, nxt, a.group),
            dist.P2POp(dist.irecv, out, prv, a.group)]):
        req.wait()
    return out


def all_gather_lanes(tensors: Sequence[torch.Tensor],
                     axis: Axis) -> Tuple[torch.Tensor, ...]:
    """Gather tensors that share a leading lane axis over `axis` in ONE
    collective per dtype: each is flattened to (lanes, -1), the tensors of
    one dtype laid side by side, gathered, and cut apart again. Returns
    the tensors with `axis.size` times the lanes, in the order given."""
    tensors = [t.contiguous() for t in tensors]
    lanes = tensors[0].shape[0]
    out: list = [None] * len(tensors)
    by_dtype: Dict[torch.dtype, list] = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([tensors[i].reshape(lanes, -1) for i in idx], dim=1)
        whole = _gather(flat, axis)
        parts = torch.split(whole, [tensors[i][0].numel() for i in idx],
                            dim=1)
        for i, part in zip(idx, parts):
            out[i] = part.reshape((whole.shape[0],)
                                  + tuple(tensors[i].shape[1:]))
    return tuple(out)
