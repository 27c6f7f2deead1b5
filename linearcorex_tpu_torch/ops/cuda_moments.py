"""The port's hand-written CUDA kernels and their plain PyTorch twins: the
fused non-overlap moment chain (`ns_chain`) and the Gram path's Σ product
(`sigma_gemm`).

Counterpart of `linearcorex_tpu/ops/pallas_moments.py`. `ns_chain` runs
the whole elementwise moment chain and gradient algebra of the non-overlap
objective (rho → invrho → rr → qij = rr·ry → S_i/Q_i → AA, plus H and the
column reductions the solver needs) in one kernel, `csrc/ns_chain.cu`,
built for sm_90a at first use (`utils.build`). The source's header says
what bounds it on an H100 and how its passes keep the reductions
deterministic.

On a CUDA tensor `ns_chain` launches the kernel or raises. On a CPU tensor
it returns `ns_chain_reference`, the plain PyTorch version of the same
function, which is also what the kernel is held against.

Restart lanes: given operands with a leading lane axis, (k, p, m),
(k, m, m) and (k, m), `ns_chain` runs all k problems in one launch per
pass (`lcx_ns_chain_lanes`), and `ns_chain_reference` is the batched
plain twin. Lane l's kernel outputs are bitwise those of a one-lane
launch on lane l's inputs. Launches through the lane entry are counted
in `ns_chain.lane_launches`, one-lane launches in `ns_chain.launches`.

`sigma_gemm(sigma, v)` computes Σ·v for a whole float32 Σ (p, p) and a
float32 v (p, n) in 3xTF32 on the tensor cores (`csrc/sigma_gemm.cu`),
held to cuBLAS's full-float32 accuracy; its launches are counted in
`sigma_gemm.launches`. On a CPU tensor it returns `sigma_gemm_reference`,
`torch.matmul` at full float32.

CUDA graphs: a call inside `counting_capture()` is recorded into the
graph being captured, not run, so it adds to the scope's tally instead of
the counters; the solver adds the tally to the counters at every replay
(`count_replay`). So the counters count the kernels' runs, replayed or
not.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch

__all__ = ["ns_chain", "ns_chain_reference", "chain_supported",
           "sigma_gemm", "sigma_gemm_reference", "counting_capture",
           "count_replay", "CHAIN_KEYS"]

# The kernel's tiles do not depend on m, but its scratch holds the m x m
# partials of H over a few ranges of p; this caps that at ~270 MB.
MAX_M = 8192


def chain_supported(p: int, m: int) -> bool:
    """Whether the kernel takes a (p, m) problem: any p >= 1, and m from 1
    to MAX_M."""
    return p >= 1 and 1 <= m <= MAX_M


def ns_chain_reference(c_xy, ry, sqz, rho_clip):
    """Plain PyTorch version of `ns_chain` (the CPU path and the kernel's
    test oracle); the same algebra as the JAX package's
    `ns_chain_reference`. Operands with a leading lane axis give outputs
    with one, each lane computed on its own."""
    rho = torch.clamp(c_xy / sqz[..., None, :], -rho_clip, rho_clip)
    invrho = 1.0 / (1.0 - rho ** 2)
    rr = rho * invrho
    qij = rr @ ry
    si = torch.sum(rho * rr, dim=-1, keepdim=True)
    qi = torch.sum(rr * qij, dim=-1, keepdim=True)
    ni = 1.0 + qi - si ** 2
    alpha, beta = 1.0 / ni, 1.0 / (1.0 + si)
    aa = alpha * (1 + rho ** 2) * invrho ** 2 * qij \
        - 2.0 * (alpha * si + beta) * rho * invrho ** 2
    hmat = (rr * alpha).mT @ rr
    kappa = torch.sum(aa * rho, dim=-2)
    mu = torch.sum(alpha * rr * qij, dim=-2)
    mi_sums = torch.sum(-0.5 * torch.log1p(-rho ** 2), dim=-2)
    sum_log_vi = torch.sum(torch.log(torch.clamp(ni * beta ** 2,
                                                 min=1e-30)), dim=(-2, -1))
    return aa, hmat, kappa, mu, mi_sums, sum_log_vi


@functools.cache
def _kernel():
    """The built library with its C signatures declared (once per
    process)."""
    from linearcorex_tpu_torch.utils import build
    lib = build.load("ns_chain")
    lib.lcx_ns_chain_workspace.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.lcx_ns_chain_workspace.restype = ctypes.c_longlong
    lib.lcx_ns_chain.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_float, ctypes.c_int, ctypes.c_int]
        + [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p])
    lib.lcx_ns_chain.restype = ctypes.c_int
    lib.lcx_ns_chain_max_lanes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.lcx_ns_chain_max_lanes.restype = ctypes.c_int
    lib.lcx_ns_chain_lanes.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_float] + [ctypes.c_int] * 3
        + [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p])
    lib.lcx_ns_chain_lanes.restype = ctypes.c_int
    lib.lcx_error_string.argtypes = [ctypes.c_int]
    lib.lcx_error_string.restype = ctypes.c_char_p
    return lib


def _check_operands(c_xy, ry, sqz):
    *lanes, p, m = c_xy.shape
    lanes = tuple(lanes)
    for name, t, shape in (("c_xy", c_xy, lanes + (p, m)),
                           ("ry", ry, lanes + (m, m)),
                           ("sqz", sqz, lanes + (m,))):
        if t.device != c_xy.device:
            raise ValueError(f"ns_chain: {name} is on {t.device}, c_xy on "
                             f"{c_xy.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"ns_chain: {name} must be float32, got "
                             f"{t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"ns_chain: {name} must have shape {shape}, "
                             f"got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"ns_chain: {name} must be contiguous")


def ns_chain(c_xy: torch.Tensor, ry: torch.Tensor, sqz: torch.Tensor,
             rho_clip: float):
    """The whole non-overlap moment chain + gradient algebra, fused.

    Inputs: c_xy (p, m) annealed cross-moment; ry (m, m); sqz (m,) =
    sqrt(z2); float32 and contiguous, or bfloat16 / float16, which are
    cast to float32 here (the kernel computes in float32, and the outputs
    are float32 whatever the input dtype, as the JAX package's Pallas
    wrapper casts its operands). Returns (aa (p, m), hmat (m, m),
    kappa (m,), mu (m,), mi_sums (m,), sum_log_vi ()), as the JAX
    package's `ns_chain` does. With a leading lane axis on every operand
    ((k, p, m), (k, m, m), (k, m)) every output gains it, and the k lanes
    run in one launch per pass. Each kernel launch adds one to
    `ns_chain.launches` (one lane) or `ns_chain.lane_launches` (the lane
    entry); the CPU path adds to neither."""
    if c_xy.ndim not in (2, 3):
        raise ValueError(f"ns_chain: c_xy must be (p, m) or (lanes, p, m), "
                         f"got shape {tuple(c_xy.shape)}")
    p, m = c_xy.shape[-2:]
    if c_xy.dtype == torch.float64:
        # the kernel computes in float32; silently downcasting would break
        # the float64 oracle-parity contract
        raise ValueError(
            "the fused chain kernel computes in float32 and cannot honor "
            "dtype='float64'; set use_pallas='never' (or 'auto') for "
            "float64 parity runs")
    if not chain_supported(p, m):
        raise ValueError(
            f"the fused chain kernel supports 1 <= m <= {MAX_M} and p >= 1; "
            f"got p={p}, m={m} — set use_pallas='never' (or 'auto') for "
            f"the plain chain")
    if c_xy.dtype in (torch.bfloat16, torch.float16):
        c_xy, ry, sqz = (t.to(torch.float32).contiguous()
                         for t in (c_xy, ry, sqz))
    if c_xy.device.type == "cpu":
        return ns_chain_reference(c_xy, ry, sqz, rho_clip)
    if c_xy.device.type != "cuda":
        raise ValueError(f"ns_chain runs on CUDA or CPU tensors, got "
                         f"{c_xy.device}")
    _check_operands(c_xy, ry, sqz)
    lib = _kernel()
    dev = c_xy.device
    lanes = c_xy.shape[:-2]
    k = c_xy.shape[0] if lanes else 1
    work_len = lib.lcx_ns_chain_workspace(p, m)
    if lanes:
        _check_lanes(lib, k, p, m)
    try:
        aa = torch.empty(lanes + (p, m), dtype=torch.float32, device=dev)
        hmat = torch.empty(lanes + (m, m), dtype=torch.float32, device=dev)
        red = torch.empty(lanes + (3 * m + 1,), dtype=torch.float32,
                          device=dev)
        work = torch.empty((k * work_len,), dtype=torch.float32, device=dev)
    except torch.cuda.OutOfMemoryError as e:
        need = 4 * k * (work_len + p * m + m * m + 3 * m + 1)
        raise torch.cuda.OutOfMemoryError(
            f"ns_chain: the scratch and outputs of {k} lane(s) of (p, m) = "
            f"({p}, {m}) need {need} bytes, more than {dev} has free; "
            f"use fewer lanes") from e
    index = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    stream = torch.cuda.current_stream(dev).cuda_stream
    if lanes:
        rc = lib.lcx_ns_chain_lanes(
            c_xy.data_ptr(), ry.data_ptr(), sqz.data_ptr(), float(rho_clip),
            k, p, m, aa.data_ptr(), hmat.data_ptr(), red.data_ptr(),
            work.data_ptr(), index, stream)
    else:
        rc = lib.lcx_ns_chain(
            c_xy.data_ptr(), ry.data_ptr(), sqz.data_ptr(), float(rho_clip),
            p, m, aa.data_ptr(), hmat.data_ptr(), red.data_ptr(),
            work.data_ptr(), index, stream)
    if rc != 0:
        raise RuntimeError(
            f"ns_chain kernel launch failed: CUDA error {rc} "
            f"({lib.lcx_error_string(rc).decode()})")
    key = "lane_launches" if lanes else "launches"
    if _CAPTURES:
        _CAPTURES[-1][key] += 1
    else:
        setattr(ns_chain, key, getattr(ns_chain, key) + 1)
    return (aa, hmat, red[..., :m], red[..., m:2 * m], red[..., 2 * m:3 * m],
            red[..., 3 * m])


def _check_lanes(lib, k, p, m):
    """Raise by name when k lanes of (p, m) exceed what one launch's grid
    takes. Scratch that does not fit raises at its allocation, by name:
    querying the card's free memory before every launch would cost
    more than the launch on a small sweep (a 32-lane (1024, 8) selection
    iteration ran at 190 instead of 548 it/s on an H100)."""
    most = lib.lcx_ns_chain_max_lanes(p, m)
    if k > most:
        raise ValueError(
            f"ns_chain: {k} lanes of (p, m) = ({p}, {m}) exceed the {most} "
            f"one launch takes; split the lanes")


# the tallies of the graph captures in progress, innermost last
_CAPTURES: list = []


# the tally's keys of the chain kernel's launches
CHAIN_KEYS = ("launches", "lane_launches")


@contextlib.contextmanager
def counting_capture():
    """The scope of a CUDA graph capture: each `ns_chain` or `sigma_gemm`
    launch inside is recorded into the graph, not run, and adds one to the
    yielded tally ({'launches', 'lane_launches'} of the chain, CHAIN_KEYS,
    and 'sigma_gemm') instead of the counters."""
    tally = dict.fromkeys(CHAIN_KEYS + ("sigma_gemm",), 0)
    _CAPTURES.append(tally)
    try:
        yield tally
    finally:
        _CAPTURES.pop()


def count_replay(tally: dict) -> None:
    """Count one replay of a graph whose capture tallied `tally`: its
    launches run again, so each adds to the counters."""
    ns_chain.launches += tally["launches"]
    ns_chain.lane_launches += tally["lane_launches"]
    sigma_gemm.launches += tally["sigma_gemm"]


def sigma_gemm_reference(sigma: torch.Tensor, v: torch.Tensor):
    """Plain PyTorch version of `sigma_gemm` (the CPU path and the kernel's
    yardstick): `torch.matmul` at full float32."""
    from linearcorex_tpu_torch.ops.moments import full_f32_matmul
    with full_f32_matmul():
        return torch.matmul(sigma, v)


@functools.cache
def _sigma_kernel():
    """The built Σ-product library with its C signatures declared (once
    per process)."""
    from linearcorex_tpu_torch.utils import build
    lib = build.load("sigma_gemm")
    lib.lcx_sigma_gemm_workspace.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.lcx_sigma_gemm_workspace.restype = ctypes.c_longlong
    lib.lcx_sigma_gemm.argtypes = (
        [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
         ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int]
        + [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p])
    lib.lcx_sigma_gemm.restype = ctypes.c_int
    lib.lcx_sigma_gemm_error_string.argtypes = [ctypes.c_int]
    lib.lcx_sigma_gemm_error_string.restype = ctypes.c_char_p
    return lib


def sigma_gemm(sigma: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """C = Σ·v (p, n) for Σ (p, p) and v (p, n), both float32; v may have
    any strides (a transposed W is read as it lies).

    On a CUDA tensor: the kernel of `csrc/sigma_gemm.cu`, 3xTF32 on the
    tensor cores with each 32-deep stage summed apart (its header says
    how), or a ValueError; one launch adds one to `sigma_gemm.launches`.
    A Σ whose rows are not 16-byte aligned (p not a multiple of 4, or a
    strided view) is first copied into rows that are, a TMA rule. On a CPU
    tensor: `sigma_gemm_reference`, and no count."""
    if sigma.device.type == "cpu":
        return sigma_gemm_reference(sigma, v)
    if sigma.device.type != "cuda":
        raise ValueError(f"sigma_gemm runs on CUDA or CPU tensors, got "
                         f"{sigma.device}")
    if sigma.ndim != 2 or sigma.shape[0] != sigma.shape[1]:
        raise ValueError(f"sigma_gemm: sigma must be square (p, p), got "
                         f"shape {tuple(sigma.shape)}")
    p = sigma.shape[0]
    if v.ndim != 2 or v.shape[0] != p:
        raise ValueError(f"sigma_gemm: v must have shape ({p}, n), got "
                         f"{tuple(v.shape)}")
    for name, t in (("sigma", sigma), ("v", v)):
        if t.dtype != torch.float32:
            raise ValueError(f"sigma_gemm: {name} must be float32, got "
                             f"{t.dtype}")
        if t.device != sigma.device:
            raise ValueError(f"sigma_gemm: {name} is on {t.device}, sigma "
                             f"on {sigma.device}")
    n = v.shape[1]
    dev = sigma.device
    if not (sigma.stride(1) == 1 and sigma.stride(0) >= p
            and sigma.stride(0) % 4 == 0 and sigma.data_ptr() % 16 == 0):
        rows = torch.empty((p, -(-p // 4) * 4), dtype=torch.float32,
                           device=dev)
        rows[:, :p] = sigma
        sigma = rows
    lib = _sigma_kernel()
    out = torch.empty((p, n), dtype=torch.float32, device=dev)
    work = torch.empty((lib.lcx_sigma_gemm_workspace(p, n),),
                       dtype=torch.float32, device=dev)
    index = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    rc = lib.lcx_sigma_gemm(
        sigma.data_ptr(), sigma.stride(0), p, v.data_ptr(), v.stride(0),
        v.stride(1), n, out.data_ptr(), work.data_ptr(), index,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"sigma_gemm kernel launch failed: CUDA error {rc} "
            f"({lib.lcx_sigma_gemm_error_string(rc).decode()})")
    if _CAPTURES:
        _CAPTURES[-1]["sigma_gemm"] += 1
    else:
        sigma_gemm.launches += 1
    return out


ns_chain.launches = 0
ns_chain.lane_launches = 0
sigma_gemm.launches = 0
