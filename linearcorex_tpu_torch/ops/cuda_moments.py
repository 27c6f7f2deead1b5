"""The fused non-overlap moment chain: a hand-written CUDA kernel and its
plain PyTorch twin.

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
"""

from __future__ import annotations

import ctypes
import functools

import torch

__all__ = ["ns_chain", "ns_chain_reference", "chain_supported"]

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
    `ns_chain_reference`."""
    rho = torch.clamp(c_xy / sqz[None, :], -rho_clip, rho_clip)   # (p, m)
    invrho = 1.0 / (1.0 - rho ** 2)
    rr = rho * invrho
    qij = rr @ ry
    si = torch.sum(rho * rr, dim=1, keepdim=True)
    qi = torch.sum(rr * qij, dim=1, keepdim=True)
    ni = 1.0 + qi - si ** 2
    alpha, beta = 1.0 / ni, 1.0 / (1.0 + si)
    aa = alpha * (1 + rho ** 2) * invrho ** 2 * qij \
        - 2.0 * (alpha * si + beta) * rho * invrho ** 2
    hmat = (rr * alpha).T @ rr
    kappa = torch.sum(aa * rho, dim=0)
    mu = torch.sum(alpha * rr * qij, dim=0)
    mi_sums = torch.sum(-0.5 * torch.log1p(-rho ** 2), dim=0)
    sum_log_vi = torch.sum(torch.log(torch.clamp(ni * beta ** 2,
                                                 min=1e-30)))
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
    lib.lcx_error_string.argtypes = [ctypes.c_int]
    lib.lcx_error_string.restype = ctypes.c_char_p
    return lib


def _check_operands(c_xy, ry, sqz):
    p, m = c_xy.shape
    for name, t, shape in (("c_xy", c_xy, (p, m)), ("ry", ry, (m, m)),
                           ("sqz", sqz, (m,))):
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
    sqrt(z2); all float32 and contiguous. Returns (aa (p, m), hmat (m, m),
    kappa (m,), mu (m,), mi_sums (m,), sum_log_vi ()), as the JAX
    package's `ns_chain` does. Each kernel launch adds one to
    `ns_chain.launches`; the CPU path does not."""
    p, m = c_xy.shape
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
    if c_xy.device.type == "cpu":
        return ns_chain_reference(c_xy, ry, sqz, rho_clip)
    if c_xy.device.type != "cuda":
        raise ValueError(f"ns_chain runs on CUDA or CPU tensors, got "
                         f"{c_xy.device}")
    _check_operands(c_xy, ry, sqz)
    lib = _kernel()
    dev = c_xy.device
    aa = torch.empty((p, m), dtype=torch.float32, device=dev)
    hmat = torch.empty((m, m), dtype=torch.float32, device=dev)
    red = torch.empty((3 * m + 1,), dtype=torch.float32, device=dev)
    work = torch.empty((lib.lcx_ns_chain_workspace(p, m),),
                       dtype=torch.float32, device=dev)
    rc = lib.lcx_ns_chain(
        c_xy.data_ptr(), ry.data_ptr(), sqz.data_ptr(), float(rho_clip), p,
        m, aa.data_ptr(), hmat.data_ptr(), red.data_ptr(), work.data_ptr(),
        dev.index if dev.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"ns_chain kernel launch failed: CUDA error {rc} "
            f"({lib.lcx_error_string(rc).decode()})")
    ns_chain.launches += 1
    return (aa, hmat, red[:m], red[m:2 * m], red[2 * m:3 * m], red[3 * m])


ns_chain.launches = 0
