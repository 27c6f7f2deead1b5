"""The PyTorch port's overlap objective (`discourage_overlap=False`)
against the JAX package's and the float64 oracle.

In float64 both of the port's objective functions agree to 1e-10 with
the JAX package's samples function (the gram one on Σ = XᵀX/n), and
fits from the same W0 are step-matched with the float64 oracle (the same
iterations per stage, TC and W within 1e-8) on both strategies. The JAX
package is step-matched with them on the samples strategy. Its gram
function rounds Σ·Wᵀ to float32 in every dtype (its
`preferred_element_type`), so in float64 it differs from the port's by
~1e-7 and its gram fit leaves the oracle's trajectory; the port keeps
float64 (ROADMAP.md Queue 3). Where C_y is not positive definite the
objective is NaN and the solver rejects the step, as
`jnp.linalg.cholesky` makes the JAX package do; nothing raises.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import linearcorex_tpu as lc
import linearcorex_tpu_torch as lct
from linearcorex_tpu.config import CorexConfig as JaxConfig
from linearcorex_tpu.core.solver import fit_core as jax_fit_core
from linearcorex_tpu.ops import moments as JM
from linearcorex_tpu.oracle import OracleCorex
from linearcorex_tpu_torch.config import CorexConfig
from linearcorex_tpu_torch.core.solver import fit_core
from linearcorex_tpu_torch.models.corex import _make_obj_grad
from linearcorex_tpu_torch.ops import moments as TM
from tests.conftest import block_data

# One intra-op thread: the suite runs its files in parallel worker
# processes, and an OpenMP pool per process on every core slows the
# small tensors here several times over.
torch.set_num_threads(1)

TOL64 = 1e-8


def _inputs(p=32, m=4, seed=3):
    x = block_data(n=500, p=p, m=m, seed=seed)
    x = (x - x.mean(0)) / x.std(0)
    ws = np.random.RandomState(7).normal(scale=1 / np.sqrt(p), size=(m, p))
    return x, x.T @ x / x.shape[0], ws


@pytest.mark.parametrize("strategy", ["samples", "gram"])
@pytest.mark.parametrize("eps", [0.0, 0.36])
def test_overlap_obj_grad_f64_matches_jax(strategy, eps):
    x, gram, ws = _inputs()
    data = x if strategy == "samples" else gram
    fj, gj, tj = JM.overlap_obj_grad_samples(jnp.asarray(ws),
                                             jnp.asarray(x), eps, 1.0)
    ft, gt, tt = getattr(TM, f"overlap_obj_grad_{strategy}")(
        torch.from_numpy(ws), torch.from_numpy(data), eps, 1.0)
    assert abs(float(fj) - float(ft)) < 1e-10
    assert abs(float(tj) - float(tt)) < 1e-10
    assert np.abs(np.asarray(gj) - gt.numpy()).max() < 1e-10
    if strategy == "gram":
        # the JAX gram function's float32-rounded Σ·Wᵀ: ~1e-7 apart
        fg, gg, _ = JM.overlap_obj_grad_gram(jnp.asarray(ws),
                                             jnp.asarray(gram), eps, 1.0)
        assert 1e-12 < abs(float(fg) - float(ft)) < 1e-6
        assert np.abs(np.asarray(gg) - gt.numpy()).max() < 1e-6


@pytest.mark.parametrize("strategy", ["samples", "gram"])
def test_overlap_f32_matches_jax(strategy):
    x, gram, ws = _inputs()
    data = (x if strategy == "samples" else gram).astype(np.float32)
    ws = ws.astype(np.float32)
    name = f"overlap_obj_grad_{strategy}"
    fj, gj, _ = getattr(JM, name)(jnp.asarray(ws), jnp.asarray(data), 0.0,
                                   1.0)
    ft, gt, _ = getattr(TM, name)(torch.from_numpy(ws),
                                  torch.from_numpy(data), 0.0, 1.0)
    assert abs(float(fj) - float(ft)) <= 1e-5 * abs(float(fj))
    assert np.abs(np.asarray(gj) - gt.numpy()).max() \
        <= 1e-4 * np.abs(np.asarray(gj)).max()


@pytest.mark.parametrize("strategy", ["samples", "gram"])
@pytest.mark.parametrize("optimizer", ["momentum", "gd"])
def test_overlap_fit_f64_step_matched(strategy, optimizer):
    x = block_data(n=500, p=32, m=4, seed=3)
    w0 = np.random.RandomState(7).normal(scale=1 / np.sqrt(32),
                                         size=(4, 32))
    kw = dict(n_hidden=4, discourage_overlap=False, max_iter=2000,
              optimizer=optimizer)
    c = lct.Corex(dtype="float64", moment_strategy=strategy, device="cpu",
                  **kw).fit(x, init_ws=w0)
    o = OracleCorex(**kw).fit(x, init_ws=w0)
    iters = c.diagnostics.iters_per_stage.tolist()
    refs = [(o.history["iters_per_stage"], o.tc, o.ws, o.clusters)]
    if strategy == "samples":
        j = lc.Corex(dtype="float64", moment_strategy=strategy, **kw).fit(
            x, init_ws=w0)
        assert c.resolved_optimizer_ == j.resolved_optimizer_
        refs.append((np.asarray(j.diagnostics.iters_per_stage).tolist(),
                     float(j.tc), np.asarray(j.ws), np.asarray(j.clusters)))
    for ref_iters, ref_tc, ref_ws, ref_cl in refs:
        assert iters == ref_iters
        assert abs(c.tc - ref_tc) < TOL64
        assert np.abs(c.ws.numpy() - ref_ws).max() < TOL64
        assert np.array_equal(c.clusters, ref_cl)


def test_overlap_auto_resolves_momentum_and_no_chain():
    x = block_data(n=500, p=32, m=4, seed=3)
    c = lct.Corex(n_hidden=4, discourage_overlap=False, optimizer="auto",
                  use_pallas="auto", seed=0, max_iter=50, device="cpu")
    c.fit(x)
    assert c.resolved_optimizer_ == "momentum"
    from linearcorex_tpu_torch.models.corex import resolve_config
    cfg = resolve_config(c.config, 32, "cuda", n_samples=500)
    assert cfg.use_pallas == "never"


def test_overlap_bf16_fit_matches_jax():
    x = block_data(n=500, p=32, m=4, seed=3)
    w0 = np.random.RandomState(7).normal(scale=1 / np.sqrt(32),
                                         size=(4, 32))
    kw = dict(n_hidden=4, discourage_overlap=False, matmul_dtype="bfloat16",
              tol=1e-4, moment_strategy="gram")
    c = lct.Corex(device="cpu", **kw).fit(x, init_ws=w0)
    j = lc.Corex(**kw).fit(x, init_ws=w0)
    assert np.array_equal(c.clusters, np.asarray(j.clusters))
    assert abs(c.tc - float(j.tc)) <= 1e-2 * abs(float(j.tc))


def _indefinite_gram(p=8):
    return np.diag(np.r_[np.ones(p // 2), -np.ones(p // 2)] * 4.0)


def test_non_pd_cy_gives_nan_objective_not_an_exception():
    gram = _indefinite_gram()
    ws = np.zeros((2, 8))
    ws[0, 4] = ws[1, 5] = 1.0         # W·Σ·Wᵀ = −4·I, C_y = −3·I
    fj, gj, _ = JM.overlap_obj_grad_gram(jnp.asarray(ws), jnp.asarray(gram),
                                         0.0, 1.0)
    ft, gt, tt = TM.overlap_obj_grad_gram(torch.from_numpy(ws),
                                          torch.from_numpy(gram), 0.0, 1.0)
    assert np.isnan(float(fj)) and bool(torch.isnan(ft))
    assert bool(torch.isnan(gt).all()) and bool(torch.isnan(tt))
    assert not bool(TM._cholesky_or_nan(torch.eye(2)).isnan().any())


def test_non_pd_step_is_rejected_as_in_jax():
    """A first step so long that C_y leaves the positive-definite cone:
    the port sees a NaN objective, rejects the step, halves it and goes
    on, on the JAX package's trajectory (the same iterations; W within
    1e-6 of its largest entry, the JAX gram product's float32
    rounding)."""
    gram = _indefinite_gram()
    w0 = np.random.RandomState(0).normal(scale=0.1, size=(2, 8))
    kw = dict(n_hidden=2, discourage_overlap=False, anneal=False,
              lr_init=1e3, max_iter=40, tol=1e-7)
    seen = []
    inner = _make_obj_grad(torch.from_numpy(gram), CorexConfig(**kw), "gram")

    def obj_grad(ws, eps):
        out = inner(ws, eps)
        seen.append(bool(torch.isnan(out[0])))
        return out

    ws, diag = fit_core(obj_grad, torch.from_numpy(w0), CorexConfig(**kw))
    assert seen[0] is False and any(seen), "no step reached a non-PD C_y"
    cfg_j = JaxConfig(**kw)
    wj, dj = jax_fit_core(
        lambda w, e: JM.overlap_obj_grad_gram(w, jnp.asarray(gram), e, 1.0),
        jnp.asarray(w0), cfg_j)
    assert diag.iters_per_stage.tolist() == \
        np.asarray(dj.iters_per_stage).tolist()
    assert np.abs(ws.numpy() - np.asarray(wj)).max() \
        < 1e-6 * np.abs(np.asarray(wj)).max()
    assert bool(torch.isfinite(diag.objective_per_stage).all())
    assert bool(torch.isfinite(ws).all())
