"""The PyTorch port's fused chain (`linearcorex_tpu_torch.ops.cuda_moments`)
against the JAX package's `ns_chain`.

On the CPU the port's `ns_chain` returns its plain PyTorch twin; the CUDA
kernel itself is held against that twin on the card by `chip_smoke.py`
and by `tests/test_torch_cuda.py`. Inputs are made with numpy from a
seed as `tests/test_pallas.py` makes them; the tolerance, 1e-5 of the
largest magnitude, is that file's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import linearcorex_tpu.ops.pallas_moments as PM
from linearcorex_tpu_torch.ops import cuda_moments as CM
from tests.conftest import block_data

RHO_CLIP = 1 - 1e-6
SHAPES = [(400, 100), (999, 7), (257, 130), (400, 128)]


def _inputs(p, m):
    """(c_xy, ry, sqz) as float32 numpy arrays. (400, 128) uses block data
    as test_pallas.test_ns_chain_matches_reference does."""
    if (p, m) == (400, 128):
        rng = np.random.RandomState(0)
        x = block_data(n=2000, p=p, m=8, seed=1)
        w = rng.normal(scale=0.1, size=(m, p))
    else:
        rng = np.random.RandomState(1)
        w = rng.normal(scale=0.1, size=(m, p))
        x = rng.normal(size=(600, p))
    n = x.shape[0]
    x = (x - x.mean(0)) / x.std(0)
    cxy = (x.T @ (x @ w.T) / n).astype(np.float32)
    cy = w @ cxy + np.eye(m)
    z2 = np.diag(cy)
    ry = (cy / np.sqrt(np.outer(z2, z2))).astype(np.float32)
    return cxy, ry, np.sqrt(z2).astype(np.float32)


def _assert_close(got, want, tol=1e-5):
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        assert g.shape == w.shape
        denom = np.max(np.abs(w)) + 1e-12
        assert np.max(np.abs(g - w)) / denom < tol


@pytest.mark.parametrize("p,m", SHAPES)
def test_twin_matches_jax_reference(p, m):
    cxy, ry, sqz = _inputs(p, m)
    want = PM.ns_chain_reference(jnp.asarray(cxy), jnp.asarray(ry),
                                 jnp.asarray(sqz), RHO_CLIP)
    got = CM.ns_chain_reference(torch.from_numpy(cxy), torch.from_numpy(ry),
                                torch.from_numpy(sqz), RHO_CLIP)
    _assert_close([t.numpy() for t in got], want)


@pytest.mark.parametrize("p,m", SHAPES)
def test_cpu_ns_chain_matches_jax_kernel_interpret(p, m, monkeypatch):
    """The port's ns_chain on CPU tensors against the JAX package's Pallas
    kernel run through the Pallas interpreter; the launch counter stays
    at 0 because no kernel was launched."""
    cxy, ry, sqz = _inputs(p, m)
    want = PM.ns_chain(jnp.asarray(cxy), jnp.asarray(ry), jnp.asarray(sqz),
                       RHO_CLIP, interpret=True)
    monkeypatch.setattr(CM.ns_chain, "launches", 0)
    got = CM.ns_chain(torch.from_numpy(cxy), torch.from_numpy(ry),
                      torch.from_numpy(sqz), RHO_CLIP)
    assert CM.ns_chain.launches == 0
    _assert_close([t.numpy() for t in got], want)


def test_ns_chain_rejects_float64():
    p, m = 256, 128
    with pytest.raises(ValueError, match="float64"):
        CM.ns_chain(torch.zeros((p, m), dtype=torch.float64),
                    torch.eye(m, dtype=torch.float64),
                    torch.ones((m,), dtype=torch.float64), RHO_CLIP)


def test_chain_supported_limit():
    assert CM.chain_supported(10000, 512)
    assert CM.chain_supported(999, 7)
    assert CM.chain_supported(1, CM.MAX_M)
    # the m x m partials of H in the kernel's scratch bound m
    assert not CM.chain_supported(256, CM.MAX_M + 1)
    assert not CM.chain_supported(0, 8)

