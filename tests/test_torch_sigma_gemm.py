"""The Gram path's Σ product (`ops.cuda_moments.sigma_gemm`, the kernel of
`csrc/sigma_gemm.cu`) on the CPU: its arithmetic, the rule that sends a
product to it, and the names the benchmark counts its time by.

The kernel itself runs only on a card: `tests/test_torch_cuda.py` holds it
to float64 and to cuBLAS's float32 product there. Here its 3xTF32
arithmetic is emulated in numpy: both operands split into TF32 hi/lo, each
32-deep stage summed from zero (lo·hi + hi·lo + hi·hi, exact in float64,
then rounded to float32 as the tensor cores' stage sum is) and added into a
float32 sum, the K ranges added in order. Against the float64 product the
emulation's error, max|C − C₆₄| / max|C₆₄|, must be at most twice
`torch.matmul`'s float32 error on the same inputs. Measured at the shapes
below (p, n, K ranges): (257, 7, 1) 2.87e-07 against 8.88e-07, (999, 130,
3) 2.29e-07 against 1.19e-06, (640, 24 = 3 lanes of 8, 2) 2.57e-07 against
9.04e-07, (1030, 64, 4) 2.05e-07 against 1.23e-06, (300, 512, 1) 2.11e-07
against 9.08e-07: 0.17-0.32 of the float32 error.
"""

import json
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from linearcorex_tpu_torch.ops import cuda_moments as CM
from linearcorex_tpu_torch.ops import moments as M
from tests.test_torch_chain import _tf32

# One intra-op thread: the suite runs its files in parallel worker
# processes, and an OpenMP pool per process on every core slows the
# small tensors here several times over.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
SOURCE = ROOT / "linearcorex_tpu_torch" / "csrc" / "sigma_gemm.cu"
KERNELS = ROOT / "portbench" / "kernels"
BK = 32   # the kernel's stage depth


def _gram(p, seed):
    """A float32 Gram matrix of standardized block data (half the
    variables share one factor) at n = 2p, and its generator."""
    rng = np.random.RandomState(seed)
    x = rng.normal(size=(2 * p, p))
    x[:, :p // 2] += 0.9 * rng.normal(size=(2 * p, 1))
    x = (x - x.mean(0)) / x.std(0)
    return (x.T @ x / (2 * p)).astype(np.float32), rng


def _emulate(sigma, v, splits):
    """Σ·v as the kernel forms it (the module's docstring): `splits` K
    ranges of whole stages, each a float32 sum of 32-deep stage sums."""
    p, n = v.shape
    a_hi, b_hi = _tf32(sigma), _tf32(v)
    a_lo, b_lo = _tf32(sigma - a_hi), _tf32(v - b_hi)
    k_split = math.ceil(math.ceil(p / BK) / splits) * BK
    out = None
    for k0 in range(0, p, k_split):
        acc = np.zeros((p, n), np.float32)
        for s0 in range(k0, min(k0 + k_split, p), BK):
            ks = slice(s0, min(s0 + BK, k0 + k_split, p))

            def mm(a, b):
                return a[:, ks].astype(np.float64) @ b[ks].astype(np.float64)
            acc = acc + (mm(a_lo, b_hi) + mm(a_hi, b_lo)
                         + mm(a_hi, b_hi)).astype(np.float32)
        out = acc if out is None else out + acc
    return out


@pytest.mark.parametrize("p,m,lanes,splits", [
    (257, 7, 1, 1), (999, 130, 1, 3), (640, 8, 3, 2), (1030, 64, 1, 4),
    (300, 512, 1, 1)])
def test_emulated_kernel_within_twice_float32_error(p, m, lanes, splits):
    """W's rows as the Gram path hands them over, lanes side by side
    (`moments._lanes`); the bound and the measured errors are in the
    module's docstring."""
    sigma, rng = _gram(p, seed=p)
    ws = torch.from_numpy((0.1 * rng.normal(size=(lanes, m, p))).astype(
        np.float32))
    handed = []
    M._lanes(lambda v: handed.append(v) or v, ws.mT if lanes > 1
             else ws[0].mT)
    v = handed[0].numpy()
    assert v.shape == (p, lanes * m)
    want = sigma.astype(np.float64) @ v.astype(np.float64)

    def err(c):
        return np.abs(c - want).max() / np.abs(want).max()
    with M.full_f32_matmul():
        plain = (torch.from_numpy(sigma) @ torch.from_numpy(v)).numpy()
    assert err(_emulate(sigma, v, splits)) <= 2 * err(plain)


def test_the_twin_is_full_float32_matmul():
    """On CPU tensors `sigma_gemm` is `torch.matmul` at full float32 and
    counts no launch."""
    sigma, rng = _gram(64, seed=0)
    v = torch.from_numpy(rng.normal(size=(64, 9)).astype(np.float32))
    before = CM.sigma_gemm.launches
    got = CM.sigma_gemm(torch.from_numpy(sigma), v)
    assert torch.equal(got, torch.from_numpy(sigma) @ v)
    assert CM.sigma_gemm.launches == before
    with pytest.raises(ValueError, match="CUDA or CPU"):
        CM.sigma_gemm(torch.from_numpy(sigma).to("meta"), v.to("meta"))


def _operand(case, sigma, rng):
    """(apply, v) of one dispatch case: the Σ-application the objective
    builds for it (`moments._apply_sigma_t`) and its (p, m) operand."""
    p = sigma.shape[0]
    g = torch.from_numpy(sigma)
    dt = {"float64": torch.float64, "bfloat16": torch.bfloat16,
          "float16": torch.float16}.get(case, torch.float32)
    v = torch.from_numpy(0.1 * rng.normal(size=(p, 8))).to(dt)
    if case == "int8":
        qd = M.quantize_gram(g)
        return M._apply_sigma_t(qd, False, True, torch.float32), v
    if case == "var":
        # a `var` row block of two ranks: Σ[I, :], not square
        return (lambda u: M._sigma_mm(g[:p // 2], u)), v
    return M._apply_sigma_t(g.to(dt), case == "bf16_operand", True, dt), v


@pytest.mark.parametrize("case,kernel", [
    ("float32", True), ("cpu", False), ("float64", False),
    ("bfloat16", False), ("float16", False), ("int8", False),
    ("bf16_operand", False), ("var", False), ("high", False),
    ("medium", False)])
def test_dispatch_rule(case, kernel, monkeypatch):
    """Which Σ-applications reach the kernel: a whole float32 Σ on a
    card under "highest" does; CPU tensors, float64, half dtypes, int8
    and bf16 operands, a `var`-split Σ and 'high'/'medium' keep `_mm`.
    Every case but "cpu" makes its tensors look like CUDA tensors to the
    rule, and the kernel is replaced by a recorder."""
    sigma, rng = _gram(48, seed=1)
    calls = []

    def recorder(g, v):
        calls.append((g.dtype, v.dtype, tuple(g.shape)))
        return M._mm(g, v)
    monkeypatch.setattr(M, "sigma_gemm", recorder)
    if case != "cpu":
        monkeypatch.setattr(torch.Tensor, "is_cuda",
                            property(lambda t: True))
    apply, v = _operand(case, sigma, rng)
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision(
        case if case in ("high", "medium") else "highest")
    try:
        apply(v)
    finally:
        torch.set_float32_matmul_precision(prev)
    assert bool(calls) == kernel, calls


def _globals():
    """The names of the `__global__` functions of csrc/sigma_gemm.cu."""
    src = SOURCE.read_text()
    names = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)"
                       r"\s+)?(\w+)\s*\(", src)
    assert len(names) == src.count("__global__")
    return names


@pytest.mark.parametrize("name", _globals())
def test_kernel_names_are_counted_as_sigma_gemm(name):
    """Every kernel of the file is read by the benchmark's `sigma_gemm`
    layer (its split and reduce passes included) and none by the chain's,
    as the profiler names it (demangled, in an anonymous namespace)."""
    assert "sigma_gemm" in name and "chain_" not in name
    traced = f"(anonymous namespace)::{name}(float const*, int)"

    def patterns(layer):
        return json.loads((KERNELS / f"{layer}.json").read_text())[
            "patterns"]
    assert any(re.search(pat, traced) for pat in patterns("sigma_gemm"))
    assert not any(re.search(pat, traced) for pat in patterns("chain"))
