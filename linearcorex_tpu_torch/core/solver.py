"""The annealed accept/reject solver of Linear CorEx, in PyTorch.

Port of `linearcorex_tpu/core/solver.py`, with its structure: the JAX
package compiles the whole schedule into one program (`lax.scan` over the
eps stages, a `lax.while_loop` per stage whose carry, predicate and body
live on the device). Here the carry (`_Carry`: W, objective, step
direction, momentum buffer, TC, step size, iteration count, delta, the
history row and the run flag) is a set of device tensors in the compute
dtype (the count int32), and one body (`_body`) applies the accept/reject
rules to it on the device with `torch.where`: the stopping predicate, the
step, the evaluation, the momentum reset on a rejected step, the step
growth and halving, delta = max|ΔW| or inf, the count and the history.
A body whose run flag is false leaves every field as it was, so the host
need not know when a stage ends: it runs the body in chunks of K and
reads one 4-byte flag (how many lanes still run) after each chunk,
through pinned memory and an event. `FitDiagnostics` is built with one
more read at the end. Nothing inside an evaluation reads the device or
copies from the host (`ops.moments` keeps its scalars as device
constants made with the objective).

On a CUDA device, for a fit with no mesh, the chunk of K bodies is
captured once per `fit_core` call into a `torch.cuda.CUDAGraph` and
replayed until the flag falls: a stage is a few graph launches and
⌈iterations/K⌉ host reads. The stage's first evaluation runs uncaptured
(stage 1's is the capture's warm-up), everything runs on one side
stream of the device, and the graph and its memory pool are released
when the fit ends. K is `CHUNK`. A fit on the CPU, over a mesh
(gloo collectives cannot be captured; NCCL capture is not done), or
whose batched factorizations torch routes to MAGMA (`_without_magma`:
fixed-point lanes at most m, the overlap objective's lanes) runs the
same body uncaptured with K = 1, the evaluations of the fits before this
design. A failed capture or replay raises by name; nothing
falls back. The chunk's masked evaluations (bodies run after the flag
fell) are counted in `counts`, apart from the iterations. Under a
recording profiler the solve, each stage, the stage's first evaluation
and the capture are named ranges of the trace (`lcx.solve`, `lcx.stage`,
`lcx.stage.first`, `lcx.capture`; `utils.profiling.span`); a chunk's
replay and read show as the runtime's own `cudaGraphLaunch` and
`cudaEventSynchronize`.

Step sizes and tolerances keep the JAX package's rounding: they live in
the compute dtype, every update one operation of that dtype (`_host_dtype`
gives the same values on the host for the rules' constants). So a fit
stays step-matched with the JAX package and the float64 oracle.

Restart lanes: `fit_core` given W0 of shape (k, m, p) runs k fits side
by side, as `jax.vmap` runs the JAX package's `fit_core`. Every lane keeps
its own step size, iteration count, delta and run flag in the carry, and
a lane whose own predicate is false is frozen (evaluated at its current
W and the evaluation discarded) until every lane of the stage is done;
then all lanes enter the next stage. So in float64 lane r runs the
iterations of the single fit from W0[r], stage by stage. The diagnostics
gain a leading lane axis. A 2-D W0 runs the one-lane body, bitwise the
plain fit.

Split W: under a variable or factor plan (`parallel.sharding`) each rank
holds a block of W, and the step size max|ΔW| that decides convergence is
a maximum over every block: one MAX `all_reduce` over the axes W is split
over (`w_axes`). It is exact, so every rank reads the same delta, stops at
the same iteration and never waits in a collective the others left.
"""

from __future__ import annotations

import contextlib
import math
import time
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from linearcorex_tpu_torch.config import CorexConfig
from linearcorex_tpu_torch.ops import cuda_moments
from linearcorex_tpu_torch.parallel.collectives import all_reduce
from linearcorex_tpu_torch.utils.profiling import span

ObjGrad = Callable[[torch.Tensor, torch.Tensor],
                   Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


class FitDiagnostics(NamedTuple):
    """Per-stage record of a fit; the same fields as the JAX package's.
    A lane-batched fit gives each field a leading lane axis."""

    iters_per_stage: torch.Tensor     # (n_stages,) int32
    tc_per_stage: torch.Tensor        # (n_stages,)
    delta_per_stage: torch.Tensor     # (n_stages,)
    objective_per_stage: torch.Tensor  # (n_stages,)
    tc_history: torch.Tensor          # (n_stages, max_iter) or (n_stages, 0)
    eps_schedule: torch.Tensor        # (n_stages,) the schedule the fit ran


# K, the bodies a captured chunk runs between two host reads. Every chunk
# but a stage's last runs K iterations; the last pays up to K - 1 masked
# evaluations, which cost as much as real ones. Measured on an H100
# (PERF.md, PR 16: annealed fits at the north star in three operand modes
# and 4 lanes, 32 lanes of m = 8, m = 32 at p = 512): K = 1, 2 and 4 are
# within the turns' spread of each other at every shape, K = 8 and 16
# lose 3-22% to masked evaluations. K = 2 halves the reads of K = 1.
CHUNK = 2


class LoopCounts:
    """What the accept/reject loops of this process did, summed over
    fits (set to 0 by `reset`): fits and captured fits; stages; host
    reads (one per chunk, one per fit for the diagnostics); the stages'
    first evaluations; the bodies the chunks ran, the iterations among
    them (a lane-batched fit counts its lockstep iterations), the masked
    evaluations (bodies run after every lane had stopped) and the chain
    kernel's launches in them (`ops.cuda_moments.ns_chain` counts them
    with the rest); seconds spent capturing graphs."""

    FIELDS = ("fits", "captured_fits", "stages", "host_reads",
              "first_evaluations", "bodies", "iterations", "masked",
              "masked_launches", "capture_seconds")

    def __init__(self):
        self.reset()

    def reset(self):
        for name in self.FIELDS:
            setattr(self, name, 0)
        self.capture_seconds = 0.0

    def as_dict(self) -> dict:
        return {name: getattr(self, name) for name in self.FIELDS}


counts = LoopCounts()


def _host_dtype(dt: torch.dtype):
    """(numpy dtype, rounding) for host-side step sizes and tolerances of
    compute dtype `dt`: they are kept in `dt`, as the JAX package keeps
    them in the carry. numpy rounds every float16, float32 and float64
    result to its own dtype, so the rounding is the identity there.
    bfloat16, which numpy lacks, is held in float32, where a product of
    two bfloat16 values is exact, and each result is rounded to bfloat16
    by the rounding: one rounding per operation, as in bfloat16
    arithmetic."""
    if dt == torch.bfloat16:
        return np.dtype(np.float32), _round_bf16
    return np.dtype(str(dt).removeprefix("torch.")), lambda a: a


def _round_bf16(a):
    """float32 value(s) rounded to the nearest bfloat16, as float32."""
    r = torch.as_tensor(np.asarray(a, np.float32)).to(torch.bfloat16)
    return r.to(torch.float32).numpy()[()]


def host_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor read to the host as numpy; bfloat16, which numpy lacks, as
    float32 (exactly)."""
    t = t.cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


class _Rules(NamedTuple):
    """The accept/reject constants of one fit, each a Python float of a
    value the compute dtype holds exactly (`_host_dtype`), so a product
    with a device tensor is one operation of that dtype."""

    momentum: bool
    beta: float
    lr_init: float
    lr_cap: float
    growth: float
    halve: float
    lr_min: float
    max_iter: int
    record: bool
    w_axes: tuple

    @classmethod
    def of(cls, cfg: CorexConfig, dt: torch.dtype, w_axes):
        npdt, rnd = _host_dtype(dt)
        fixed_point = cfg.optimizer == "fixed_point"
        lr_init, lr_cap, growth, halve, lr_min, beta = (
            float(rnd(npdt.type(c))) for c in (
                cfg.fp_gamma_init if fixed_point else cfg.lr_init,
                cfg.fp_gamma_cap if fixed_point else cfg.lr_cap,
                cfg.lr_growth, cfg.lr_halve, cfg.lr_min, cfg.momentum_beta))
        return cls(cfg.optimizer == "momentum", beta, lr_init, lr_cap,
                   growth, halve, lr_min, cfg.max_iter, cfg.record_history,
                   tuple(w_axes))


class _Carry(NamedTuple):
    """The loop state of one stage; scalars per lane: () for one lane,
    (k,) for k lanes. `v` is None off the momentum optimizer."""

    ws: torch.Tensor
    f: torch.Tensor
    g: torch.Tensor
    v: Optional[torch.Tensor]
    tc: torch.Tensor
    lr: torch.Tensor
    it: torch.Tensor       # int32
    delta: torch.Tensor
    hist: torch.Tensor     # (…, max_iter) or (…, 0)
    run: torch.Tensor      # bool: the predicate for the next body


def _mat(t):
    """A per-lane scalar broadcast against the lanes' (m, p) matrices."""
    return t[..., None, None]


def _body(obj_grad: ObjGrad, r: _Rules, c: _Carry, eps, tol, cols):
    """One iteration of the accept/reject loop on the device: the step,
    the evaluation at the stepped W, and the rules, every field under
    the run flag (a lane whose flag is false is evaluated at its own W
    and keeps every field). `cols` is arange(max_iter) on the device."""
    run_m = _mat(c.run)
    if r.momentum:
        v_new = r.beta * c.v - _mat(c.lr) * c.g
        ws_new = torch.where(run_m, c.ws + v_new, c.ws)
    else:
        ws_new = torch.where(run_m, c.ws - _mat(c.lr) * c.g, c.ws)
    f_new, g_new, tc_new = obj_grad(ws_new, eps)
    step = all_reduce(torch.amax(torch.abs(ws_new - c.ws), dim=(-2, -1)),
                      r.w_axes, op="max")
    accept = (f_new <= c.f) & c.run
    reject = c.run & ~accept
    acc_m = _mat(accept)
    v = c.v
    if r.momentum:
        v = torch.where(acc_m, v_new, torch.where(run_m, 0.0, c.v))
    tc = torch.where(accept, tc_new, c.tc)
    hist = c.hist
    if r.record:
        at = c.run[..., None] & (cols == c.it[..., None])
        hist = torch.where(at, tc[..., None], c.hist)
    lr = torch.where(accept, torch.clamp(c.lr * r.growth, max=r.lr_cap),
                     torch.where(reject, c.lr * r.halve, c.lr))
    delta = torch.where(accept, step,
                        torch.where(reject, math.inf, c.delta))
    it = c.it + c.run
    return _Carry(ws=torch.where(acc_m, ws_new, c.ws),
                  f=torch.where(accept, f_new, c.f),
                  g=torch.where(acc_m, g_new, c.g), v=v, tc=tc, lr=lr, it=it,
                  delta=delta, hist=hist,
                  run=(it < r.max_iter) & (delta >= tol) & (lr >= r.lr_min))


def _without_magma(cfg: CorexConfig, w0: torch.Tensor) -> bool:
    """Whether torch runs the fit's factorizations on the card without
    MAGMA. MAGMA's batched solvers allocate device memory inside the call,
    which a CUDA graph capture refuses ("operation not permitted when
    stream is capturing"; a batched Cholesky solve aborts the process in
    magma_internal.h), so such a fit runs uncaptured. torch's default
    routing (2.11): one lane's LU and Cholesky solve go to cuSOLVER; a
    batched m x m LU goes to MAGMA unless m <= 16 or (m <= 128 and k <=
    16), a batched Cholesky solve always."""
    if cfg.optimizer != "fixed_point" and cfg.discourage_overlap:
        return True
    backend = torch.backends.cuda.preferred_linalg_library()
    if backend != torch._C._LinalgBackend.Default:
        return backend == torch._C._LinalgBackend.Cusolver
    if w0.ndim == 2:
        return True
    k, m = w0.shape[0], w0.shape[-2]
    return cfg.discourage_overlap and (m <= 16 or (m <= 128 and k <= 16))


def _describe(w0: torch.Tensor, cfg: CorexConfig) -> str:
    lanes = f"{w0.shape[0]} lanes of " if w0.ndim == 3 else ""
    m, p = w0.shape[-2:]
    return (f"the {lanes}(m, p) = ({m}, {p}) fit (optimizer "
            f"{cfg.optimizer!r}, matmul_dtype {cfg.matmul_dtype!r}, dtype "
            f"{str(w0.dtype).removeprefix('torch.')}, use_pallas "
            f"{cfg.use_pallas!r}, discourage_overlap "
            f"{cfg.discourage_overlap}) on {w0.device}")


_SIDE_STREAMS: dict = {}


def _side_stream(dev: torch.device) -> torch.cuda.Stream:
    """The stream every captured fit on `dev` runs on (one per device, so
    the caching allocator keeps one pool of its blocks)."""
    index = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    if index not in _SIDE_STREAMS:
        _SIDE_STREAMS[index] = torch.cuda.Stream(device=index)
    return _SIDE_STREAMS[index]


class _Loop:
    """Runs a stage's chunks of K bodies: replays of one captured graph
    (`captured`) or the body called K times, and reads the run flag after
    each chunk. The graph is captured at the first chunk of the fit."""

    def __init__(self, obj_grad, rules, cols, eps, tol, k, captured, name):
        self.obj_grad, self.rules, self.cols = obj_grad, rules, cols
        self.eps, self.tol, self.k = eps, tol, k
        self.captured, self.name = captured, name
        self.graph = self.tally = None
        self.static = self.flag = None
        dev = eps.device
        self.host = torch.zeros((), dtype=torch.int32,
                                pin_memory=dev.type == "cuda")
        self.event = torch.cuda.Event() if dev.type == "cuda" else None

    def _read(self, flag) -> int:
        """The flag on the host: the one read of a chunk."""
        counts.host_reads += 1
        if self.event is None:
            return int(flag)
        self.host.copy_(flag, non_blocking=True)
        self.event.record()
        self.event.synchronize()
        return int(self.host)

    def _bodies(self, c: _Carry) -> _Carry:
        for _ in range(self.k):
            c = _body(self.obj_grad, self.rules, c, self.eps, self.tol,
                      self.cols)
        return c

    def _capture(self, c: _Carry):
        """Capture one chunk into a graph whose input and output are the
        static carry `c` (written in place at the chunk's end) and the
        flag."""
        self.static = c
        self.flag = torch.zeros((), dtype=torch.int32, device=c.ws.device)
        graph = torch.cuda.CUDAGraph()
        with span("lcx.capture"):
            t0 = time.perf_counter()
            with cuda_moments.counting_capture() as tally:
                graph.capture_begin()
                try:
                    out = self._bodies(c)
                    for dst, src in zip(c, out):
                        if dst is not None:
                            dst.copy_(src)
                    self.flag.copy_(out.run.sum(dtype=torch.int32))
                except BaseException as e:
                    try:
                        graph.capture_end()
                    except Exception:
                        pass
                    raise RuntimeError(
                        f"fit_core: capturing the accept/reject loop of "
                        f"{self.name} into a CUDA graph failed: {e}") from e
                graph.capture_end()
            counts.capture_seconds += time.perf_counter() - t0
        self.graph, self.tally = graph, tally

    def run_stage(self, c: _Carry):
        """Chunks until no lane runs; returns (final carry, chunks)."""
        chunks = 0
        if self.captured:
            if self.graph is None:
                self._capture(_copy_into(None, c))
            static = _copy_into(self.static, c)
            while True:
                try:
                    self.graph.replay()
                except Exception as e:
                    raise RuntimeError(
                        f"fit_core: replaying the captured accept/reject "
                        f"loop of {self.name} failed: {e}") from e
                cuda_moments.count_replay(self.tally)
                chunks += 1
                if not self._read(self.flag):
                    return static, chunks
        while True:
            c = self._bodies(c)
            chunks += 1
            if not self._read(c.run.sum(dtype=torch.int32)):
                return c, chunks

    def release(self):
        if self.graph is not None:
            self.graph.reset()
            self.graph = None


def _copy_into(static: Optional[_Carry], c: _Carry) -> _Carry:
    """`c` copied into the static carry (made when `static` is None)."""
    if static is None:
        return _Carry(*(None if t is None else t.clone() for t in c))
    for dst, src in zip(static, c):
        if dst is not None:
            dst.copy_(src)
    return static


def fit_core(obj_grad: ObjGrad, w0: torch.Tensor, cfg: CorexConfig,
             w_axes=(), *, _mesh: bool = False,
             _capture: Optional[bool] = None, _chunk: Optional[int] = None):
    """Full annealed fit: every stage of cfg.anneal_schedule() in turn,
    each run to its cfg.tol_schedule() tolerance. W0 of shape (k, m, p)
    runs k lanes. `w0` may be this rank's block of W, split over the mesh
    axes `w_axes` (`parallel.collectives.Axis`). Returns (ws,
    FitDiagnostics).

    A fit on a CUDA device replays a captured CUDA graph of K = `CHUNK`
    bodies; on the CPU, or over a mesh (`_mesh`, set by
    `parallel.sharding` and `parallel.restarts`), the body runs
    uncaptured with K = 1. `_capture` and `_chunk` override the path's
    choice and K (the tests hold every choice to the same bits)."""
    with span("lcx.solve"):
        dev, dt = w0.device, w0.dtype
        npdt, rnd = _host_dtype(dt)
        captured = _capture
        if captured is None:
            captured = dev.type == "cuda" and not _mesh \
                and _without_magma(cfg, w0)
        if captured and dev.type != "cuda":
            raise ValueError(f"fit_core: a captured loop needs a CUDA "
                             f"device, got {dev}")
        k = _chunk or (CHUNK if captured else 1)
        rules = _Rules.of(cfg, dt, w_axes)
        schedule = rnd(np.asarray(cfg.anneal_schedule(), dtype=npdt))
        tols = rnd(np.asarray(cfg.tol_schedule(), dtype=npdt))
        lanes = w0.shape[:-2]
        n_stages = len(schedule)
        counts.fits += 1
        counts.captured_fits += int(captured)
        side = _side_stream(dev) if captured else None
        if side is not None:
            side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side) if side is not None else \
                contextlib.nullcontext():
            eps_all = torch.as_tensor(schedule, dtype=dt, device=dev)
            tol_all = torch.as_tensor(tols, dtype=dt, device=dev)
            eps, tol = eps_all[0].clone(), tol_all[0].clone()
            width = cfg.max_iter if cfg.record_history else 0
            cols = torch.arange(width, dtype=torch.int32, device=dev)
            out_it = torch.zeros(lanes + (n_stages,), dtype=torch.int32,
                                 device=dev)
            out_tc, out_delta, out_f = (
                torch.zeros(lanes + (n_stages,), dtype=dt, device=dev)
                for _ in range(3))
            out_hist = torch.zeros(lanes + (n_stages, width), dtype=dt,
                                   device=dev)
            loop = _Loop(obj_grad, rules, cols, eps, tol, k, captured,
                         _describe(w0, cfg))
            chunks = []
            ws = w0
            try:
                for s in range(n_stages):
                    with span("lcx.stage"):
                        eps.copy_(eps_all[s])
                        tol.copy_(tol_all[s])
                        with span("lcx.stage.first"):
                            f, g, tc = obj_grad(ws, eps)
                        counts.stages += 1
                        counts.first_evaluations += 1
                        runs = (0 < rules.max_iter and np.inf >= tols[s]
                                and rules.lr_init >= rules.lr_min)
                        c = _Carry(
                            ws=ws, f=f, g=g,
                            v=torch.zeros_like(ws) if rules.momentum
                            else None,
                            tc=tc, lr=torch.full(lanes, rules.lr_init,
                                                 dtype=dt, device=dev),
                            it=torch.zeros(lanes, dtype=torch.int32,
                                           device=dev),
                            delta=torch.full(lanes, math.inf, dtype=dt,
                                             device=dev),
                            hist=torch.zeros(lanes + (width,), dtype=dt,
                                             device=dev),
                            run=torch.full(lanes, runs, dtype=torch.bool,
                                           device=dev))
                        n = 0
                        if runs:
                            c, n = loop.run_stage(c)
                        chunks.append(n)
                        ws = c.ws
                        out_it[..., s] = c.it
                        out_tc[..., s] = c.tc
                        out_delta[..., s] = c.delta
                        out_f[..., s] = c.f
                        out_hist[..., s, :] = c.hist
            finally:
                loop.release()
            # the one read of the diagnostics
            counts.host_reads += 1
            iters = out_it.cpu()
        if side is not None:
            torch.cuda.current_stream(dev).wait_stream(side)
        lockstep = iters.numpy().reshape(-1, n_stages).max(
            axis=0).tolist()
        counts.bodies += k * sum(chunks)
        counts.iterations += sum(lockstep)
        masked = sum(k * n - i for n, i in zip(chunks, lockstep))
        counts.masked += masked
        if loop.tally is not None:
            # every body of a chunk launches the kernel alike
            counts.masked_launches += masked * sum(loop.tally.values()) // k
        eps_schedule = eps_all if not lanes else \
            eps_all.expand(lanes + (n_stages,)).contiguous()
        diag = FitDiagnostics(iters_per_stage=iters, tc_per_stage=out_tc,
                              delta_per_stage=out_delta,
                              objective_per_stage=out_f,
                              tc_history=out_hist,
                              eps_schedule=eps_schedule)
        if side is not None:
            current = torch.cuda.current_stream(dev)
            for t in (ws, *diag[1:]):
                t.record_stream(current)
        return ws, diag


def sort_by_tcs(ws: torch.Tensor, tcs: torch.Tensor):
    """Reorder factors by decreasing per-factor TC (per lane for ws
    (k, m, p) and tcs (k, m))."""
    order = torch.argsort(-tcs, dim=-1, stable=True)
    return torch.take_along_dim(ws, order[..., :, None], dim=-2), order
