"""The PyTorch port's moment system (`linearcorex_tpu_torch.ops.moments`)
against the JAX package's (`linearcorex_tpu.ops.moments`).

Float64 carries the step-matched parity contract, so the float64 paths
must agree to 1e-10. The chain path runs in float32 (the kernel's type);
there the bars are those `tests/test_pallas.py` holds the JAX chain path
to against its plain path. Inputs are made with numpy from a seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from linearcorex_tpu.ops import moments as JM
from linearcorex_tpu_torch.ops import moments as TM
from tests.conftest import block_data

# One intra-op thread: the suite runs its files in parallel worker
# processes, and an OpenMP pool per process on every core slows the
# small tensors here several times over.
torch.set_num_threads(1)

Y_SCALE, RHO_CLIP = 1.0, 1 - 1e-6
TOL64 = 1e-10


def _data(p=64, m=8, scale=0.05, seed=2):
    x = block_data(n=1000, p=p, m=8, seed=1)
    x = (x - x.mean(0)) / x.std(0)
    gram = x.T @ x / x.shape[0]
    ws = np.random.RandomState(seed).normal(scale=scale, size=(m, p))
    return x, gram, ws


def _close(a, b, tol):
    a = np.asarray(a, np.float64)
    b = b.detach().cpu().numpy() if isinstance(b, torch.Tensor) else \
        np.asarray(b, np.float64)
    assert a.shape == b.shape
    assert np.max(np.abs(a - b), initial=0.0) < tol


@pytest.mark.parametrize("eps", [0.0, 0.36])
def test_moments_from_cxy_f64(eps):
    x, _, ws = _data()
    cj = JM.cxy_samples(jnp.asarray(x), jnp.asarray(ws), eps)
    ct = TM.cxy_samples(torch.from_numpy(x), torch.from_numpy(ws), eps)
    _close(cj, ct, TOL64)
    mj = JM.moments_from_cxy(jnp.asarray(ws), cj, Y_SCALE, RHO_CLIP)
    mt = TM.moments_from_cxy(torch.from_numpy(ws), ct, Y_SCALE, RHO_CLIP)
    for name in JM.Moments._fields:
        _close(getattr(mj, name), getattr(mt, name), TOL64)
    dj, dt = mj.asdict(), mt.asdict()
    for key in dj:
        _close(dj[key], dt[key], TOL64)


@pytest.mark.parametrize("strategy", ["samples", "gram"])
@pytest.mark.parametrize("kind", ["obj_grad", "fp"])
@pytest.mark.parametrize("eps", [0.0, 0.36])
def test_objective_and_direction_f64(strategy, kind, eps):
    """ns_obj_grad_{samples,gram} and ns_fp_{samples,gram}: objective,
    direction and TC agree with the JAX package in float64."""
    x, gram, ws = _data()
    data = x if strategy == "samples" else gram
    name = f"ns_{kind}_{strategy}"
    fj, gj, tj = getattr(JM, name)(jnp.asarray(ws), jnp.asarray(data), eps,
                                    Y_SCALE, RHO_CLIP)
    ft, gt, tt = getattr(TM, name)(torch.from_numpy(ws),
                                   torch.from_numpy(data), eps, Y_SCALE,
                                   RHO_CLIP)
    _close(fj, ft, TOL64)
    _close(tj, tt, TOL64)
    _close(gj, gt, TOL64)


def test_compute_gram_f64():
    x, gram, _ = _data()
    _close(JM.compute_gram(jnp.asarray(x)),
           TM.compute_gram(torch.from_numpy(x)), TOL64)
    _close(gram, TM.compute_gram(torch.from_numpy(x)), TOL64)


@pytest.mark.parametrize("eps", [0.0, 0.36])
def test_chain_path_f32_matches_jax_chain(eps, pallas_interpret):
    """chain_kernel=True in float32: the port (the kernel's CPU twin)
    against the JAX package's Pallas chain (interpreter), gram and samples,
    at test_pallas.py's bars: objective 1e-5 relative, TC 1e-4 relative,
    gradient 2e-3 absolute."""
    p, m = 256, 128
    x = block_data(n=2000, p=p, m=8, seed=1)
    x = (x - x.mean(0)) / x.std(0)
    gram = (x.T @ x / x.shape[0]).astype(np.float32)
    x = x.astype(np.float32)
    ws = np.random.RandomState(2).normal(scale=0.05, size=(m, p)).astype(
        np.float32)
    for name, data in (("ns_obj_grad_gram", gram),
                       ("ns_obj_grad_samples", x)):
        fj, gj, tj = getattr(JM, name)(jnp.asarray(ws), jnp.asarray(data),
                                        eps, Y_SCALE, RHO_CLIP,
                                        chain_kernel=True)
        ft, gt, tt = getattr(TM, name)(torch.from_numpy(ws),
                                       torch.from_numpy(data), eps, Y_SCALE,
                                       RHO_CLIP, chain_kernel=True)
        assert abs(float(fj) - float(ft)) / abs(float(fj)) < 1e-5
        assert abs(float(tj) - float(tt)) / max(abs(float(tj)), 1e-6) < 1e-4
        assert np.abs(np.asarray(gj) - gt.numpy()).max() < 2e-3


@pytest.mark.parametrize("eps", [0.0, 0.36])
def test_chain_path_matches_plain_path_f32(eps):
    """Within the port: chain_kernel=True equals the plain chain, for the
    gradient and the fixed-point parts (test_pallas.py's bars)."""
    p, m = 256, 128
    x = block_data(n=2000, p=p, m=8, seed=1)
    x = (x - x.mean(0)) / x.std(0)
    gram = torch.from_numpy((x.T @ x / x.shape[0]).astype(np.float32))
    ws = torch.from_numpy(np.random.RandomState(2).normal(
        scale=0.05, size=(m, p)).astype(np.float32))
    f1, g1, t1 = TM.ns_obj_grad_gram(ws, gram, eps, Y_SCALE, RHO_CLIP)
    f2, g2, t2 = TM.ns_obj_grad_gram(ws, gram, eps, Y_SCALE, RHO_CLIP,
                                     chain_kernel=True)
    assert abs(float(f1 - f2)) / abs(float(f1)) < 1e-5
    assert abs(float(t1 - t2)) / max(abs(float(t1)), 1e-6) < 1e-4
    assert float((g1 - g2).abs().max()) < 2e-3
    parts = [TM.ns_fp_parts(ws, gram, eps, Y_SCALE, RHO_CLIP, gram=True,
                            chain_kernel=c) for c in (False, True)]
    for a, b in zip(parts[0], parts[1]):
        denom = float(a.abs().max()) + 1e-12
        assert float((a - b).abs().max()) / denom < 1e-4


def test_moments_asdict_keys_match_jax():
    x, _, ws = _data()
    mj = JM.moments_from_cxy(jnp.asarray(ws), JM.cxy_samples(
        jnp.asarray(x), jnp.asarray(ws), 0.0), Y_SCALE, RHO_CLIP)
    mt = TM.moments_from_cxy(torch.from_numpy(ws), TM.cxy_samples(
        torch.from_numpy(x), torch.from_numpy(ws), 0.0), Y_SCALE, RHO_CLIP)
    assert list(mt.asdict()) == list(mj.asdict())
    assert TM.Moments._fields == JM.Moments._fields


def test_permute_and_reconstruction_f64():
    x, _, ws = _data()
    mj = JM.moments_from_cxy(jnp.asarray(ws), JM.cxy_samples(
        jnp.asarray(x), jnp.asarray(ws), 0.0), Y_SCALE, RHO_CLIP)
    mt = TM.moments_from_cxy(torch.from_numpy(ws), TM.cxy_samples(
        torch.from_numpy(x), torch.from_numpy(ws), 0.0), Y_SCALE, RHO_CLIP)
    order = np.random.RandomState(0).permutation(ws.shape[0])
    pj = JM.permute_moments(mj, jnp.asarray(order))
    pt = TM.permute_moments(mt, torch.from_numpy(order))
    for name in JM.Moments._fields:
        _close(getattr(pj, name), getattr(pt, name), TOL64)
    _close(JM.reconstruction_weights(pj), TM.reconstruction_weights(pt),
           TOL64)
