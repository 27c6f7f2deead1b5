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

# One intra-op thread: the suite runs its files in parallel worker
# processes, and an OpenMP pool per process on every core slows the
# small tensors here several times over.
torch.set_num_threads(1)

RHO_CLIP = 1 - 1e-6
SHAPES = [(400, 100), (999, 7), (257, 130), (400, 128)]
BLOCK_SHAPES = [(400, 128), (2000, 512)]


def _inputs(p, m):
    """(c_xy, ry, sqz) as float32 numpy arrays. The BLOCK_SHAPES use block
    data as test_pallas.test_ns_chain_matches_reference does."""
    if (p, m) in BLOCK_SHAPES:
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



def _tf32(x):
    """x rounded to TF32 as the kernel's cvt.rna.tf32.f32 rounds it: the
    low 13 mantissa bits of the float32 bit pattern, to nearest, ties away
    from zero."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def _split_product(a, b):
    """a·b as the kernel forms it: each float32 operand split into hi =
    tf32(x) and lo = tf32(x - hi), the product taken as lo·hi + hi·lo +
    hi·hi (each TF32 product exact, summed here in float64)."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)

    def mm(u, v):
        return u.astype(np.float64) @ v.astype(np.float64)
    return (mm(a_lo, b_hi) + mm(a_hi, b_lo) + mm(a_hi, b_hi)).astype(
        np.float32)


def _split_chain(cxy, ry, sqz, clip):
    """The chain in float32 with both m-deep products taken through the
    kernel's 3xTF32 split (`_split_product`)."""
    rho = np.clip(cxy / sqz[None, :], -clip, clip)
    invrho = np.float32(1) / (np.float32(1) - rho ** 2)
    rr = rho * invrho
    qij = _split_product(rr, ry)
    si = np.sum(rho * rr, axis=-1, keepdims=True)
    qi = np.sum(rr * qij, axis=-1, keepdims=True)
    ni = 1 + qi - si ** 2
    alpha, beta = 1 / ni, 1 / (1 + si)
    aa = alpha * (1 + rho ** 2) * invrho ** 2 * qij \
        - 2 * (alpha * si + beta) * rho * invrho ** 2
    hmat = _split_product((rr * alpha).T, rr)
    return (aa, hmat, np.sum(aa * rho, axis=0),
            np.sum(alpha * rr * qij, axis=0),
            np.sum(-0.5 * np.log1p(-rho ** 2), axis=0),
            np.sum(np.log(np.maximum(ni * beta ** 2, 1e-30))))


def test_tf32_rounding_matches_rna():
    x = np.array([1.0, 1 + 2 ** -11, 1 + 2 ** -12, 1 + 3 * 2 ** -12,
                  -(1 + 2 ** -11), 0.0, 2 + 2 ** -12], np.float32)
    # 1 + 2^-11 is the tie between 1 and 1 + 2^-10: away from zero
    want = np.array([1.0, 1 + 2 ** -10, 1.0, 1 + 2 ** -10,
                     -(1 + 2 ** -10), 0.0, 2.0], np.float32)
    np.testing.assert_array_equal(_tf32(x), want)
    y = np.random.RandomState(0).normal(size=1000).astype(np.float32)
    hi = _tf32(y)
    assert np.all(hi.view(np.uint32) & 0x1FFF == 0)
    assert np.max(np.abs(hi - y) / np.abs(y)) <= 2.0 ** -11


@pytest.mark.parametrize("p,m", SHAPES + [(2000, 512)])
def test_split_products_within_the_bar(p, m):
    """The kernel's 3xTF32 representation error is inside the 1e-5 bar:
    the chain with both products taken through the split agrees with the
    plain twin and with the JAX package's reference."""
    cxy, ry, sqz = _inputs(p, m)
    got = _split_chain(cxy, ry, sqz, np.float32(RHO_CLIP))
    twin = CM.ns_chain_reference(torch.from_numpy(cxy), torch.from_numpy(ry),
                                 torch.from_numpy(sqz), RHO_CLIP)
    _assert_close(got, [t.numpy() for t in twin])
    jax_ref = PM.ns_chain_reference(jnp.asarray(cxy), jnp.asarray(ry),
                                    jnp.asarray(sqz), RHO_CLIP)
    _assert_close(got, jax_ref)
