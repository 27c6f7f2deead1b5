"""The port's moment-input fits (`GramAccumulator`, `fit_csv`,
`fit_from_covariance`, `Corex.partial_fit`) on their own and against the
JAX package's.

The same batches, made with numpy from a seed, go through both packages.
In float64 the accumulated correlation agrees within 1e-12 and the fits
from the same seeded W0 are step-matched: the same iterations per stage,
TC and W within 1e-8. float32 fits are held to the float32 bar of
`tests/test_torch_corex.py` (same clusters, TC within 1e-3 relative). The
port runs on `device="cpu"`.
"""

import numpy as np
import pytest
import torch

import linearcorex_tpu as lc
import linearcorex_tpu_torch as lct
from linearcorex_tpu_torch.utils.checkpoint import fit_with_checkpoints
from linearcorex_tpu_torch.utils.streaming import (GramAccumulator,
                                                   fit_csv,
                                                   fit_from_covariance)
from tests.conftest import block_data

torch.set_num_threads(1)

TOL64 = 1e-8


def _acc(p, dtype="float64"):
    return GramAccumulator(p=p, dtype=dtype, device="cpu")


def _corex(**kw):
    return lct.Corex(device="cpu", **kw)


# ---------------------------------------------------------------------------
# the port on its own (the JAX package's streaming tests, on the port)
# ---------------------------------------------------------------------------

def test_streaming_equals_in_memory():
    x = block_data(n=1200, p=64, m=8, seed=0)
    acc = _acc(64)
    for start in range(0, 1200, 256):   # uneven final batch on purpose
        acc.update(x[start:start + 256])
    assert acc.n_samples == 1200
    m_stream = acc.fit(n_hidden=8, seed=0)
    assert m_stream.device == "cpu" and m_stream.dtype == "float64"
    m_mem = _corex(n_hidden=8, seed=0, dtype="float64",
                   moment_strategy="gram").fit(x)
    assert abs(m_stream.tc - m_mem.tc) < 1e-6
    assert (m_stream.ws - m_mem.ws).abs().max() < 1e-6
    assert torch.equal(m_stream.clusters, m_mem.clusters)
    assert (m_stream.transform(x) - m_mem.transform(x)).abs().max() < 1e-6
    assert m_stream.best_restart_ == 0


def test_streaming_correlation_matches_numpy():
    x = block_data(n=500, p=16, m=2, seed=1)
    acc = _acc(16)
    acc.update(x[:200]).update(torch.as_tensor(x[200:]))   # array, tensor
    assert np.abs(acc.correlation().numpy() - np.corrcoef(x.T)).max() < 1e-10


def test_streaming_updates_in_place():
    x = block_data(n=300, p=8, m=2, seed=1)
    acc = _acc(8)
    g, s = acc._g, acc._s
    acc.update(x[:100]).update(x[100:])
    assert acc._g is g and acc._s is s and float(g.abs().sum()) > 0


def test_streaming_validation():
    acc = _acc(8, "float32")
    with pytest.raises(ValueError, match="at least 2"):
        acc.fit(n_hidden=2)
    with pytest.raises(ValueError, match="expected batch"):
        acc.update(np.zeros((5, 9)))
    with pytest.raises(ValueError, match="expected batch"):
        acc.update(np.zeros(8))
    with pytest.raises(ValueError, match="dtype"):
        GramAccumulator(8, dtype="float16", device="cpu")


def test_streaming_large_means_f32_accuracy():
    """Cancellation stress: with column means far above the stds in
    float32, the shifted accumulation and the full-float32 batch products
    keep the correlation accurate (a naive E[xx'] − mm' loses ~1% here),
    whatever the caller's global matmul precision."""
    x = block_data(n=2000, p=32, m=4, seed=7).astype(np.float32) + 1000.0
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("medium")
    try:
        acc = _acc(32, "float32")
        for i in range(0, 2000, 512):
            acc.update(x[i:i + 512])
        assert torch.get_float32_matmul_precision() == "medium"
    finally:
        torch.set_float32_matmul_precision(prev)
    corr = acc.correlation().double().numpy()
    truth = np.corrcoef(x.astype(np.float64).T)
    assert np.abs(corr - truth).max() < 1e-4


def test_fit_from_covariance_matches_data_fit():
    x = block_data(n=1500, p=48, m=6, seed=3)
    sigma = np.cov(x.T, bias=True)
    m_cov = fit_from_covariance(sigma, n_samples=1500, n_hidden=6, seed=0,
                                dtype="float64", variable_means=x.mean(0),
                                device="cpu")
    m_dat = _corex(n_hidden=6, seed=0, dtype="float64",
                   moment_strategy="gram").fit(x)
    assert abs(m_cov.tc - m_dat.tc) < 1e-6
    assert torch.equal(m_cov.clusters, m_dat.clusters)
    assert (m_cov.transform(x) - m_dat.transform(x)).abs().max() < 1e-6
    # a tensor sigma is taken as it is
    m_t = fit_from_covariance(torch.as_tensor(sigma), 1500, 6, seed=0,
                              dtype="float64", device="cpu")
    assert abs(m_t.tc - m_cov.tc) < 1e-12


def test_fit_from_covariance_validation():
    with pytest.raises(ValueError, match="square"):
        fit_from_covariance(np.zeros((4, 5)), 100, 2, device="cpu")


def test_streaming_rejects_nan_batch():
    x = np.random.RandomState(0).normal(size=(100, 8))
    x[3, 2] = np.nan
    with pytest.raises(ValueError, match="NaN"):
        _acc(8).update(x)


def test_streaming_rejects_missing_values():
    x = np.random.RandomState(0).normal(size=(100, 8))
    acc = _acc(8).update(x)
    with pytest.raises(ValueError, match="missing_values"):
        acc.fit(n_hidden=2, missing_values=-999.0)
    with pytest.raises(ValueError, match="missing_values"):
        fit_from_covariance(np.eye(8), 100, 2, missing_values=-999.0,
                            device="cpu")


def test_streaming_rejects_empty_batch():
    with pytest.raises(ValueError, match="0 rows"):
        _acc(8).update(np.zeros((0, 8)))
    with pytest.raises(ValueError, match="0 rows"):
        _corex(n_hidden=2).partial_fit(np.zeros((0, 8)))


def test_partial_fit_single_batch_equals_acc_fit():
    x = block_data(n=800, p=48, m=6, seed=3)
    m_pf = _corex(n_hidden=6, seed=0, dtype="float64").partial_fit(x)
    m_acc = _acc(48).update(x).fit(n_hidden=6, seed=0, dtype="float64")
    assert abs(m_pf.tc - m_acc.tc) < 1e-8
    assert (m_pf.ws - m_acc.ws).abs().max() < 1e-8


def test_partial_fit_batched_equals_full_fit():
    x = block_data(n=1200, p=64, m=8, seed=0)
    mdl = _corex(n_hidden=8, seed=0, dtype="float64")
    for start in range(0, 1200, 256):    # uneven final batch on purpose
        mdl.partial_fit(x[start:start + 256])
        assert tuple(mdl.transform(x[:4]).shape) == (4, 8)
    assert mdl.n_samples == 1200
    m_mem = _corex(n_hidden=8, seed=0, dtype="float64",
                   moment_strategy="gram").fit(x)
    assert abs(mdl.tc - m_mem.tc) < 1e-3 * abs(m_mem.tc)
    assert torch.equal(mdl.clusters, m_mem.clusters)


def test_partial_fit_fit_resets_accumulation(tmp_path):
    x = block_data(n=400, p=32, m=4, seed=5)
    mdl = _corex(n_hidden=4, seed=0, dtype="float64")
    assert mdl._partial_acc is None and "_partial_acc" not in vars(mdl)
    mdl.partial_fit(x[:200])
    assert mdl.n_samples == 200
    mdl.fit(x)                       # fresh full fit
    assert mdl._partial_acc is None
    assert mdl.n_samples == 400
    mdl.partial_fit(x[:100])         # new accumulation, not 400 + 100
    assert mdl.n_samples == 100
    # the checkpointed fit is a full fit too
    mdl.partial_fit(x[:100])
    fit_with_checkpoints(mdl, x, str(tmp_path / "ck"))
    assert mdl._partial_acc is None and mdl.n_samples == 400


def test_partial_fit_validation():
    x = block_data(n=100, p=16, m=2, seed=6)
    with pytest.raises(ValueError, match="gaussianize='standard'|standard"):
        _corex(n_hidden=2, gaussianize="empirical").partial_fit(x)
    with pytest.raises(ValueError, match="missing_values"):
        _corex(n_hidden=2, missing_values=-999.0).partial_fit(x)
    with pytest.raises(ValueError, match="moment_strategy"):
        _corex(n_hidden=2, moment_strategy="samples").partial_fit(x)
    with pytest.raises(ValueError, match="n_restarts > 1"):
        _corex(n_hidden=2, n_restarts=2).partial_fit(x)
    mdl = _corex(n_hidden=2, seed=0).partial_fit(x)
    with pytest.raises(ValueError, match="16"):
        mdl.partial_fit(np.zeros((10, 9)))   # width change mid-stream


def test_partial_fit_single_row_first_batch_defers():
    x = block_data(n=64, p=8, m=2, seed=7)
    mdl = _corex(n_hidden=2, seed=0, dtype="float64")
    with pytest.warns(UserWarning, match="single sample"):
        mdl.partial_fit(x[:1])
    with pytest.raises(lct.NotFittedError):
        mdl.transform(x[:4])
    mdl.partial_fit(x[1:])
    assert mdl.n_samples == 64           # the first row was not dropped
    assert tuple(mdl.transform(x[:4]).shape) == (4, 2)


def test_partial_fit_warm_starts_and_drops_a_stale_shape():
    x = block_data(n=600, p=32, m=4, seed=2)
    mdl = _corex(n_hidden=4, seed=0, dtype="float64")
    mdl.partial_fit(x[:300])
    first = mdl.n_iter_
    mdl.partial_fit(x[300:])
    assert mdl.n_iter_ < first           # warm start from the current ws
    mdl.set_params(n_hidden=3)
    mdl.partial_fit(x[:50])              # stale (4, 32) ws: fresh init
    assert tuple(mdl.ws.shape) == (3, 32) and mdl.n_samples == 650


def test_partial_fit_width_change_after_fit_raises():
    x = block_data(n=200, p=64, m=4, seed=10)
    mdl = _corex(n_hidden=4, seed=0, dtype="float64").fit(x)
    with pytest.raises(ValueError, match="64"):
        mdl.partial_fit(x[:, :32])


def test_partial_fit_verbose_prints(capsys):
    x = block_data(n=200, p=16, m=2, seed=1)
    _corex(n_hidden=2, seed=0, verbose=True, max_iter=20).partial_fit(x)
    assert "iterations:" in capsys.readouterr().out


def test_moment_input_fits_honor_init_policy():
    x = block_data(n=600, p=32, m=4, seed=8)
    sigma = np.cov(x.T)
    kw = dict(seed=0, dtype="float64", device="cpu")
    m1 = fit_from_covariance(sigma, 600, 4, **kw)
    m2 = fit_from_covariance(sigma, 600, 4, pretrained_weights=m1.ws.numpy(),
                             **kw)
    assert (m2.ws - m1.ws).abs().max() < 1e-4
    assert int(m2.diagnostics.iters_per_stage[-1]) <= \
        int(m1.diagnostics.iters_per_stage[-1])
    with pytest.warns(UserWarning, match="spectral.*anneal"):
        m3 = fit_from_covariance(sigma, 600, 4, init="spectral", **kw)
    assert m3.tc == pytest.approx(m1.tc, rel=0.05)
    assert m3.diagnostics.iters_per_stage.tolist() != \
        m1.diagnostics.iters_per_stage.tolist()


def test_auto_optimizer_resolves_against_the_true_sample_count():
    """The Gram operand carries no sample count: 'auto' must see the
    accumulated n, or a fully sampled stream would take momentum."""
    x = block_data(n=300, p=16, m=2, seed=4)
    acc = _acc(16).update(x)
    assert acc.fit(2, seed=0, optimizer="auto", max_iter=30) \
        .resolved_optimizer_ == "fixed_point"
    few = fit_from_covariance(acc.correlation(), 10, 2, seed=0,
                              optimizer="auto", max_iter=30, device="cpu")
    assert few.resolved_optimizer_ == "momentum" and few.n_samples == 10


def test_fit_csv_matches_in_memory(tmp_path):
    x = block_data(n=500, p=24, m=3, seed=5)
    path = str(tmp_path / "x.tsv")
    np.savetxt(path, x, delimiter="\t")
    m = fit_csv(path, n_hidden=3, block_rows=128, delimiter="\t", seed=0,
                dtype="float64", device="cpu")
    ref = _acc(24).update(x).fit(n_hidden=3, seed=0)
    assert abs(m.tc - ref.tc) < 1e-8
    assert (m.ws - ref.ws).abs().max() < 1e-8
    empty = tmp_path / "empty.csv"
    empty.write_text("\n\n")
    with pytest.raises(ValueError, match="no data rows|no parsable"):
        fit_csv(str(empty), 2, device="cpu")


def test_accumulator_device_is_explicit():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GramAccumulator(8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fit_from_covariance(np.eye(8), 100, 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lct.Corex(n_hidden=2).partial_fit(np.zeros((4, 8)))


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

BATCHES = [(0, 256), (256, 512), (512, 768), (768, 1000)]


@pytest.fixture(scope="module")
def data():
    return block_data(n=1000, p=64, m=8, seed=0)


def _both_accs(x, dtype="float64"):
    a = _acc(x.shape[1], dtype)
    j = lc.GramAccumulator(x.shape[1], dtype=dtype)
    for lo, hi in BATCHES:
        a.update(x[lo:hi].astype(dtype))
        j.update(x[lo:hi].astype(dtype))
    return a, j


def _assert_step_matched(c, j):
    assert c.diagnostics.iters_per_stage.tolist() == \
        np.asarray(j.diagnostics.iters_per_stage).tolist()
    assert abs(c.tc - float(j.tc)) < TOL64
    assert np.abs(c.ws.numpy() - np.asarray(j.ws)).max() < TOL64
    assert np.array_equal(c.clusters.numpy(), np.asarray(j.clusters))
    assert c.n_samples == j.n_samples and c.nv == j.nv
    assert c.resolved_optimizer_ == j.resolved_optimizer_
    assert np.abs(c.theta.mean.numpy() - np.asarray(j.theta.mean)).max() \
        < 1e-12
    assert np.abs(c.theta.std.numpy() - np.asarray(j.theta.std)).max() \
        < 1e-12


def test_correlation_matches_jax(data):
    a, j = _both_accs(data)
    assert a.n_samples == j.n_samples == 1000
    assert np.abs(a.correlation().numpy()
                  - np.asarray(j.correlation())).max() < 1e-12


@pytest.mark.parametrize("optimizer", ["momentum", "auto"])
def test_acc_fit_step_matched_with_jax(optimizer, data):
    a, j = _both_accs(data)
    _assert_step_matched(a.fit(8, seed=0, optimizer=optimizer),
                         j.fit(8, seed=0, optimizer=optimizer))


def test_fit_from_covariance_step_matched_with_jax(data):
    sigma = np.cov(data.T, bias=True)
    kw = dict(seed=0, dtype="float64", variable_means=data.mean(0))
    c = fit_from_covariance(sigma, 1000, 8, device="cpu", **kw)
    j = lc.fit_from_covariance(sigma, 1000, 8, **kw)
    _assert_step_matched(c, j)
    x2 = block_data(n=100, p=64, m=8, seed=5)
    assert np.abs(c.transform(x2).numpy()
                  - np.asarray(j.transform(x2))).max() < TOL64


def test_fit_csv_step_matched_with_jax(data, tmp_path):
    path = str(tmp_path / "x.csv")
    np.savetxt(path, data, delimiter=",", header="a header line")
    kw = dict(n_hidden=8, block_rows=300, skip_header=1, seed=0,
              dtype="float64")
    _assert_step_matched(fit_csv(path, device="cpu", **kw),
                         lc.fit_csv(path, **kw))


def test_partial_fit_step_matched_with_jax(data):
    """Four batches: every call's solve (the warm starts included) runs
    the JAX package's iterations."""
    c = _corex(n_hidden=8, seed=0, dtype="float64")
    j = lc.Corex(n_hidden=8, seed=0, dtype="float64")
    for lo, hi in BATCHES:
        c.partial_fit(data[lo:hi])
        j.partial_fit(data[lo:hi])
        _assert_step_matched(c, j)


def test_f32_streamed_fit_matches_jax_f32(data):
    a, j = _both_accs(data, "float32")
    c, jm = a.fit(8, seed=0), j.fit(8, seed=0)
    assert c.ws.dtype == torch.float32
    assert np.abs(a.correlation().numpy()
                  - np.asarray(j.correlation())).max() < 1e-5
    assert np.array_equal(c.clusters.numpy(), np.asarray(jm.clusters))
    assert abs(c.tc - float(jm.tc)) / float(jm.tc) < 1e-3


@pytest.mark.parametrize("matmul_dtype", ["int8", "bfloat16"])
def test_operand_modes_through_solve_from_moments(matmul_dtype, data):
    """The quantized and the bf16 correlation operand through
    `_solve_from_moments`: the JAX fit's clusters, TC within 1e-3."""
    a, j = _both_accs(data, "float32")
    kw = dict(seed=0, matmul_dtype=matmul_dtype, optimizer="fixed_point",
              tol=1e-4)
    c, jm = a.fit(8, **kw), j.fit(8, **kw)
    assert np.array_equal(c.clusters.numpy(), np.asarray(jm.clusters))
    assert abs(c.tc - float(jm.tc)) <= 1e-3 * abs(float(jm.tc))


# ---------------------------------------------------------------------------
# the sharded forms wait for the port of parallel/sharding.py
# ---------------------------------------------------------------------------

def _fitted():
    x = block_data(n=60, p=8, m=2, seed=0)
    return x, lct.StackedCorex([2, 1], seed=0, max_iter=5,
                               device="cpu").fit(x)


_ENTRY_POINTS = {
    "GramAccumulator": lambda **kw: GramAccumulator(8, device="cpu", **kw),
    "fit_from_covariance": lambda **kw: fit_from_covariance(
        np.eye(8), 100, 2, device="cpu", **kw),
    "fit_csv": lambda **kw: fit_csv("no-such-file.csv", 2, device="cpu",
                                    **kw),
    "partial_fit": lambda **kw: _corex(n_hidden=2).partial_fit(
        np.zeros((4, 8)), **kw),
    "fit_with_checkpoints": lambda **kw: fit_with_checkpoints(
        _corex(n_hidden=2), np.zeros((4, 8)), "no-such-dir", **kw),
    "StackedCorex.fit": lambda **kw: lct.StackedCorex(
        [2, 1], device="cpu").fit(np.zeros((4, 8)), **kw),
    "StackedCorex.fit_transform": lambda **kw: lct.StackedCorex(
        [2, 1], device="cpu").fit_transform(np.zeros((4, 8)), **kw),
    "StackedCorex.transform": lambda **kw: _fitted()[1].transform(
        _fitted()[0], **kw),
    "StackedCorex.transform_all": lambda **kw: _fitted()[1].transform_all(
        _fitted()[0], **kw),
    "StackedCorex.predict": lambda **kw: _fitted()[1].predict(
        np.zeros((4, 1)), **kw),
    "StackedCorex.inverse_transform": lambda **kw: _fitted()[1]
    .inverse_transform(np.zeros((4, 1)), **kw),
}


@pytest.mark.parametrize("name", sorted(_ENTRY_POINTS))
def test_mesh_raises_not_implemented(name, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(NotImplementedError, match="item 17"):
        _ENTRY_POINTS[name](mesh=object())
    assert not (tmp_path / "no-such-dir").exists()


@pytest.mark.parametrize("name", ["GramAccumulator", "fit_from_covariance",
                                  "fit_csv", "partial_fit"])
def test_sharding_plan_without_mesh_raises_as_jax(name):
    with pytest.raises(ValueError, match="without mesh="):
        _ENTRY_POINTS[name](sharding_plan=object())
    with pytest.raises(ValueError, match="without mesh="):
        lc.GramAccumulator(8, sharding_plan=object())
