"""The PyTorch port's fit knobs against the JAX package: init='spectral',
preset='throughput' and the two-program `stage_subsample` fit.

The spectral W0 agrees with the JAX package's `_spectral_init_program`
to 1e-10 in float64, up to the sign of each row (QR's sign convention is
the LAPACK build's). Float64 fits are step-matched with the JAX package
and the oracle (the same iterations per stage, TC and W within 1e-8), as
`tests/test_stage_subsample.py` holds the JAX package to the oracle.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import linearcorex_tpu as lc
import linearcorex_tpu_torch as lct
from linearcorex_tpu.models.corex import \
    _spectral_init_program as jax_spectral
from linearcorex_tpu.ops import moments as JM
from linearcorex_tpu.oracle import OracleCorex
from linearcorex_tpu_torch.config import CorexConfig
from linearcorex_tpu_torch.models import corex as TC
from linearcorex_tpu_torch.ops import moments as TM
from tests.conftest import block_data

# One intra-op thread: the suite runs its files in parallel worker
# processes, and an OpenMP pool per process on every core slows the
# small tensors here several times over.
torch.set_num_threads(1)

TOL64 = 1e-8


def _w0(m, p, seed=42):
    return np.random.RandomState(seed).normal(scale=1.0 / np.sqrt(p),
                                              size=(m, p))


def _sign_fixed(w):
    """Each row flipped so its largest-magnitude entry is positive."""
    w = np.asarray(w, np.float64)
    idx = np.argmax(np.abs(w), axis=1)
    return w * np.sign(w[np.arange(w.shape[0]), idx])[:, None]


# ---------------------------------------------------------------------------
# init='spectral'
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("strategy", ["samples", "gram"])
def test_spectral_init_f64_matches_jax(strategy):
    x = block_data(n=600, p=48, m=6, seed=1)
    x = (x - x.mean(0)) / x.std(0)
    data = x if strategy == "samples" else x.T @ x / x.shape[0]
    omega = np.random.RandomState(3).normal(size=(48, 6))
    want = jax_spectral(jnp.asarray(data), jnp.asarray(omega), strategy,
                        "float32")
    got = TC._spectral_init(torch.from_numpy(data), torch.from_numpy(omega),
                            strategy, "float32")
    assert got.shape == (6, 48) and got.dtype == torch.float64
    assert np.abs(_sign_fixed(want) - _sign_fixed(got.numpy())).max() \
        < 1e-10
    assert np.allclose(got.numpy() @ got.numpy().T, np.eye(6), atol=1e-12)


@pytest.mark.parametrize("mode", ["bfloat16", "int8"])
@pytest.mark.parametrize("strategy", ["samples", "gram"])
def test_spectral_init_operand_modes_match_jax(mode, strategy):
    """Through the bf16 and int8 Σ-applications, float32: within 1e-5."""
    x = block_data(n=600, p=48, m=6, seed=1)
    x = ((x - x.mean(0)) / x.std(0)).astype(np.float32)
    data = x if strategy == "samples" else (x.T @ x / 600).astype(
        np.float32)
    omega = np.random.RandomState(3).normal(size=(48, 6)).astype(np.float32)
    if mode == "int8":
        dj = JM.quantize_samples(jnp.asarray(data))
        dt = TM.quantize_samples(torch.from_numpy(data))
    else:
        dj = jnp.asarray(data, jnp.bfloat16)
        dt = torch.from_numpy(data).to(torch.bfloat16)
    want = jax_spectral(dj, jnp.asarray(omega), strategy, mode)
    got = TC._spectral_init(dt, torch.from_numpy(omega), strategy, mode)
    assert got.dtype == torch.float32
    assert np.abs(_sign_fixed(want) - _sign_fixed(got.numpy())).max() < 1e-5


def test_spectral_fit_f64_step_matched_with_jax():
    """Seeded: Ω from RandomState(seed), as in the JAX package; the whole
    fit is then step-matched."""
    x = block_data(n=1000, p=64, m=8, seed=0)
    kw = dict(n_hidden=8, init="spectral", anneal=False, seed=5,
              dtype="float64")
    c = lct.Corex(device="cpu", **kw).fit(x)
    j = lc.Corex(**kw).fit(x)
    assert c.diagnostics.iters_per_stage.tolist() == \
        np.asarray(j.diagnostics.iters_per_stage).tolist()
    assert abs(c.tc - float(j.tc)) < TOL64
    assert np.abs(c.ws.numpy() - np.asarray(j.ws)).max() < TOL64
    assert np.array_equal(c.clusters, np.asarray(j.clusters))


def test_spectral_unseeded_draws_on_device():
    x = block_data(n=300, p=32, m=4, seed=0)
    c = lct.Corex(n_hidden=4, init="spectral", anneal=False, device="cpu")
    data, _, strategy = c._prepare_fit(x)
    w_a = c._resolve_w0(None, data=data, strategy=strategy)
    w_b = c._resolve_w0(None, data=data, strategy=strategy)
    assert w_a.shape == (4, 32) and not torch.equal(w_a, w_b)
    assert torch.allclose(w_a @ w_a.T, torch.eye(4), atol=1e-5)


def test_spectral_with_anneal_warns_as_jax():
    with pytest.warns(UserWarning, match="spectral"):
        lc.Corex(n_hidden=4, init="spectral").config
    with pytest.warns(UserWarning, match="anneal=False"):
        lct.Corex(n_hidden=4, init="spectral", device="cpu").config


# ---------------------------------------------------------------------------
# preset='throughput'
# ---------------------------------------------------------------------------

def test_throughput_preset_resolves_as_jax():
    for kw in ({}, dict(tol=1e-5), dict(matmul_dtype="bfloat16"),
               dict(anneal=True, init="random")):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            ours = lct.Corex(n_hidden=4, preset="throughput", **kw).config
            theirs = lc.Corex(n_hidden=4, preset="throughput", **kw).config
        for name in CorexConfig.__dataclass_fields__:
            assert getattr(ours, name) == getattr(theirs, name), (kw, name)
    cfg = lct.Corex(n_hidden=4, preset="throughput").config
    assert (cfg.matmul_dtype, cfg.init, cfg.anneal, cfg.optimizer) == \
        ("int8", "spectral", False, "auto")
    with pytest.raises(ValueError, match="preset"):
        lct.Corex(n_hidden=4, preset="fastest").config


def test_throughput_fit_matches_jax():
    x = block_data(n=1000, p=64, m=4, seed=0)
    c = lct.Corex(n_hidden=4, preset="throughput", seed=0,
                  device="cpu").fit(x)
    j = lc.Corex(n_hidden=4, preset="throughput", seed=0).fit(x)
    assert c.resolved_optimizer_ == j.resolved_optimizer_ == "fixed_point"
    assert len(c.diagnostics.iters_per_stage) == 1
    assert np.array_equal(c.clusters, np.asarray(j.clusters)), (
        c.diagnostics.iters_per_stage.tolist(),
        np.asarray(j.diagnostics.iters_per_stage).tolist())
    assert abs(c.tc - float(j.tc)) <= 1e-3 * float(j.tc)


# ---------------------------------------------------------------------------
# stage_subsample
# ---------------------------------------------------------------------------

def test_stage_subsample_f64_step_matched():
    """tests/test_stage_subsample.py's momentum case, the port against
    the JAX package and the oracle; the staging changes the trajectory
    (the pin is not vacuous). Data seed 2: on seeds 0 and 1 one of the
    three flips one accept/reject at a tol boundary from low-bit
    differences in the subsampled products (the seed lottery
    tests/test_stage_subsample.py describes); seeds 2 and 3 are
    step-matched on all three."""
    x = block_data(n=1000, p=64, m=8, seed=2)
    w0 = _w0(8, 64)
    c = lct.Corex(n_hidden=8, dtype="float64", stage_subsample=0.25,
                  moment_strategy="samples", device="cpu").fit(x, init_ws=w0)
    j = lc.Corex(n_hidden=8, dtype="float64", stage_subsample=0.25,
                 moment_strategy="samples").fit(x, init_ws=w0)
    o = OracleCorex(n_hidden=8, stage_subsample=0.25).fit(x, init_ws=w0)
    iters = c.diagnostics.iters_per_stage.tolist()
    assert iters == np.asarray(j.diagnostics.iters_per_stage).tolist()
    assert iters == o.history["iters_per_stage"]
    for tc, ws in ((float(j.tc), np.asarray(j.ws)), (o.tc, o.ws)):
        assert abs(c.tc - tc) < TOL64
        assert np.abs(c.ws.numpy() - ws).max() < TOL64
    base = lct.Corex(n_hidden=8, dtype="float64", moment_strategy="samples",
                     device="cpu").fit(x, init_ws=w0)
    assert iters != base.diagnostics.iters_per_stage.tolist()
    # the diagnostics cover the full schedule
    full = CorexConfig(n_hidden=8).anneal_schedule()
    assert c.diagnostics.eps_schedule.tolist() == pytest.approx(list(full))
    assert len(c.history["TC"]) == c.n_iter_ == sum(iters)


def test_stage_subsample_fixed_point_optimum():
    x = block_data(n=1000, p=64, m=8, seed=0)
    w0 = _w0(8, 64)
    kw = dict(n_hidden=8, stage_subsample=0.25, optimizer="fixed_point")
    c = lct.Corex(dtype="float64", moment_strategy="samples", device="cpu",
                  **kw).fit(x, init_ws=w0)
    o = OracleCorex(**kw).fit(x, init_ws=w0)
    assert abs(c.tc - o.tc) < 1e-6 * max(1.0, abs(o.tc))
    assert np.abs(c.ws.numpy() - o.ws).max() < 1e-6


def test_stage_subsample_stride_one_warns_and_is_inert():
    x = block_data(n=500, p=32, m=4, seed=3)
    w0 = _w0(4, 32, seed=5)
    ref = lct.Corex(n_hidden=4, dtype="float64", moment_strategy="samples",
                    device="cpu").fit(x, init_ws=w0)
    with pytest.warns(UserWarning, match="stride 1"):
        c = lct.Corex(n_hidden=4, dtype="float64", stage_subsample=0.9,
                      moment_strategy="samples", device="cpu").fit(
            x, init_ws=w0)
    assert torch.equal(c.ws, ref.ws)


def test_stage_subsample_gram_warns_and_is_inert():
    x = block_data(n=500, p=32, m=4, seed=3)
    w0 = _w0(4, 32)
    with pytest.warns(UserWarning, match="inert on the gram"):
        c = lct.Corex(n_hidden=4, dtype="float64", stage_subsample=0.25,
                      moment_strategy="gram", device="cpu").fit(
            x, init_ws=w0)
    ref = lct.Corex(n_hidden=4, dtype="float64", moment_strategy="gram",
                    device="cpu").fit(x, init_ws=w0)
    assert torch.equal(c.ws, ref.ws)


def test_stage_subsample_undersampled_fixed_point_warns():
    x = block_data(n=100, p=64, m=4, seed=0)
    with pytest.warns(UserWarning, match="undersampled"):
        lct.Corex(n_hidden=4, stage_subsample=0.5, optimizer="fixed_point",
                  moment_strategy="samples", max_iter=20, seed=0,
                  device="cpu").fit(x)


@pytest.mark.parametrize("mode", ["int8", "bfloat16"])
def test_stage_subsample_operand_modes(mode):
    """The quantized operand subsamples by rows and keeps its scale. The
    fit gives the JAX fit's clusters and TC within 2e-2 (the bar
    tests/test_int8.py holds the JAX int8 fit to against float32: the
    subsampled prefix runs on half the rows, where the quantization noise
    is larger)."""
    x = block_data(n=1000, p=64, m=4, seed=0)
    kw = dict(n_hidden=4, matmul_dtype=mode, tol=1e-4, seed=0,
              stage_subsample=0.5, moment_strategy="samples")
    c = lct.Corex(device="cpu", **kw).fit(x)
    j = lc.Corex(**kw).fit(x)
    assert np.array_equal(c.clusters, np.asarray(j.clusters))
    assert abs(c.tc - float(j.tc)) <= 2e-2 * float(j.tc)
    qd = TM.quantize_samples(torch.from_numpy(x.astype(np.float32)))
    sub = TC._subsample_rows(qd, 0.25)
    assert torch.equal(sub.q, qd.q[::4]) and sub.scale is qd.scale
    assert sub.q.is_contiguous()


def test_stage_subsample_helpers_match_jax():
    from linearcorex_tpu.models import corex as JC
    for f in (1.0, 0.9, 0.5, 0.34, 0.25, 0.1):
        assert TC.subsample_stride(f) == JC.subsample_stride(f)
        assert TC.subsample_len(1001, f) == JC.subsample_len(1001, f)
    cfg = CorexConfig(n_hidden=4, stage_subsample=0.25, tol=1e-4,
                      stage_tol_factor=3.0)
    from linearcorex_tpu.config import CorexConfig as JaxConfig
    jcfg = JaxConfig(n_hidden=4, stage_subsample=0.25, tol=1e-4,
                     stage_tol_factor=3.0)
    for ours, theirs in zip(TC._staged_subsample_cfgs(cfg),
                            JC._staged_subsample_cfgs(jcfg)):
        assert ours.anneal_schedule() == theirs.anneal_schedule()
        assert ours.tol_schedule() == theirs.tol_schedule()
        assert ours.stage_subsample == theirs.stage_subsample == 1.0


def test_one_program_guard():
    cfg = CorexConfig(n_hidden=4, stage_subsample=0.5)
    with pytest.raises(ValueError, match="one-program"):
        TC._make_obj_grad(torch.zeros((16, 8)), cfg, "samples")
    # inert combinations pass: gram, anneal=False
    TC._make_obj_grad(torch.zeros((8, 8)), cfg, "gram")
    TC._make_obj_grad(torch.zeros((16, 8)), CorexConfig(
        n_hidden=4, stage_subsample=0.5, anneal=False), "samples")
