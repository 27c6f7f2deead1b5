"""Tests of linearcorex_tpu_torch that need an NVIDIA card (marked `cuda`;
they skip without one), plus the CPU-side checks of the kernel wrapper.

This file imports neither JAX nor tests/conftest.py, so it also runs on a
machine without JAX:

    python -m pytest -o addopts="" --noconftest -q tests/test_torch_cuda.py

The kernel is held to its plain PyTorch twin at 1e-5 of the largest
magnitude (the JAX package's kernel-test bound) and must give bitwise-equal
outputs on a repeated launch.
"""

import numpy as np
import pytest
import torch

import linearcorex_tpu_torch as lct
from linearcorex_tpu_torch.ops import cuda_moments as CM
from linearcorex_tpu_torch.utils import build

RHO_CLIP = 1 - 1e-6


def _inputs(p, m, dev):
    rng = np.random.RandomState(1)
    w = rng.normal(scale=0.1, size=(m, p))
    x = rng.normal(size=(600, p))
    x = (x - x.mean(0)) / x.std(0)
    cxy = (x.T @ (x @ w.T) / 600).astype(np.float32)
    cy = w @ cxy + np.eye(m)
    z2 = np.diag(cy)
    ry = (cy / np.sqrt(np.outer(z2, z2))).astype(np.float32)
    return tuple(torch.from_numpy(a).to(dev) for a in
                 (cxy, ry, np.sqrt(z2).astype(np.float32)))


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")


def test_build_targets_hopper():
    flags = " ".join(build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "-shared" in flags
    path = build._library_path("ns_chain")
    assert path.parent == build.BUILD_DIR
    assert path.name.startswith("libns_chain_") and path.suffix == ".so"


def test_wrapper_rejects_other_devices():
    cxy, ry, sqz = (t.to("meta") for t in _inputs(64, 8, "cpu"))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        CM.ns_chain(cxy, ry, sqz, RHO_CLIP)


@pytest.mark.cuda
@pytest.mark.parametrize("p,m", [(10000, 512), (400, 100), (999, 7),
                                 (257, 130), (400, 128), (2000, 1030)])
def test_kernel_matches_twin(p, m):
    _need_cuda()
    cxy, ry, sqz = _inputs(p, m, "cuda")
    before = CM.ns_chain.launches
    got = CM.ns_chain(cxy, ry, sqz, RHO_CLIP)
    again = CM.ns_chain(cxy, ry, sqz, RHO_CLIP)
    torch.cuda.synchronize()
    assert CM.ns_chain.launches == before + 2
    want = CM.ns_chain_reference(cxy, ry, sqz, RHO_CLIP)
    for g, g2, w in zip(got, again, want):
        assert g.shape == w.shape
        denom = float(w.abs().max()) + 1e-12
        assert float((g - w).abs().max()) / denom < 1e-5
        assert torch.equal(g, g2)


@pytest.mark.cuda
def test_kernel_rejects_bad_operands():
    _need_cuda()
    cxy, ry, sqz = _inputs(64, 8, "cuda")
    with pytest.raises(ValueError, match="contiguous"):
        CM.ns_chain(cxy, ry.T, sqz, RHO_CLIP)
    with pytest.raises(ValueError, match="shape"):
        CM.ns_chain(cxy, ry[:4], sqz, RHO_CLIP)
    with pytest.raises(ValueError, match="float64"):
        CM.ns_chain(cxy.double(), ry.double(), sqz.double(), RHO_CLIP)


@pytest.mark.cuda
def test_fit_on_card_goes_through_kernel_and_agrees():
    """A small fit on the card runs the kernel and agrees with the port's
    float64 CPU fit: same clusters, TC within 1e-3 relative."""
    _need_cuda()
    rng = np.random.RandomState(3)
    x = np.repeat(rng.normal(size=(2000, 8)), 32, axis=1) * 0.9 \
        + 0.436 * rng.normal(size=(2000, 256))
    w0 = rng.normal(scale=1 / 16, size=(8, 256))
    before = CM.ns_chain.launches
    gpu = lct.Corex(n_hidden=8, use_pallas="always", device="cuda").fit(
        x, init_ws=w0)
    assert CM.ns_chain.launches > before
    cpu = lct.Corex(n_hidden=8, dtype="float64", device="cpu").fit(
        x, init_ws=w0)
    assert np.array_equal(gpu.clusters.cpu().numpy(), cpu.clusters.numpy())
    assert abs(gpu.tc - cpu.tc) / abs(cpu.tc) < 1e-3
