"""`matmul_precision` in the PyTorch port: every value the JAX package runs.

On a CUDA device a fit runs in `models.corex.precision_ctx`, which sets
torch's float32 matmul precision per the value ('default', 'highest',
'float32': full float32; 'high', 'tensorfloat32': TF32; 'bfloat16':
torch's "medium") and restores the caller's afterwards. On the CPU every
value runs full float32, as XLA:CPU computes float32 dots, so here each
accepted value is bitwise the 'highest' fit and within the float32
parity bar (`tests/test_parity.py::test_f32_tpu_dtype_quality`: the same
clusters, TC within 1e-3 relative) of the JAX package's fit with the same
value. The JAX package's dot-algorithm names are refused by name. The
mapping on a CUDA device is read off the scope itself; what TF32 does to
a product is checked on the card by `chip_smoke.py`.
"""

import numpy as np
import pytest
import torch

import linearcorex_tpu as lc
import linearcorex_tpu_torch as lct
from linearcorex_tpu_torch.config import CorexConfig
from linearcorex_tpu_torch.models import corex as TC
from linearcorex_tpu_torch.utils.checkpoint import (fit_with_checkpoints,
                                                    load_corex, save_corex)
from tests.conftest import block_data

torch.set_num_threads(1)

ACCEPTED = ["default", "highest", "float32", "high", "tensorfloat32",
            "bfloat16"]
ON_CUDA = {"default": "highest", "highest": "highest", "float32": "highest",
           "high": "high", "tensorfloat32": "high", "bfloat16": "medium"}
DOT_ALGORITHMS = ["BF16_BF16_F32", "BF16_BF16_F32_X3", "BF16_BF16_F32_X6",
                  "TF32_TF32_F32", "TF32_TF32_F32_X3", "F32_F32_F32",
                  "ANY_F8_ANY_F8_F32"]
FIT = dict(n_hidden=8, max_iter=300, device="cpu")


@pytest.fixture(scope="module")
def data():
    x = block_data(n=1000, p=64, m=8, seed=0)
    w0 = np.random.RandomState(42).normal(scale=1.0 / 8.0, size=(8, 64))
    return x, w0


@pytest.fixture(scope="module")
def highest(data):
    x, w0 = data
    return lct.Corex(matmul_precision="highest", **FIT).fit(x, init_ws=w0)


@pytest.fixture(autouse=True)
def caller_precision():
    """Every test starts from, and leaves behind, the default setting."""
    prev = torch.get_float32_matmul_precision()
    yield
    assert torch.get_float32_matmul_precision() == prev
    torch.set_float32_matmul_precision(prev)


@pytest.mark.parametrize("value", ACCEPTED)
def test_every_accepted_value_fits_bitwise_the_highest_fit_on_the_cpu(
        data, highest, value):
    x, w0 = data
    c = lct.Corex(matmul_precision=value, **FIT).fit(x, init_ws=w0)
    assert c.ws.dtype == torch.float32
    assert torch.equal(c.ws, highest.ws) and c.tc == highest.tc
    assert c.diagnostics.iters_per_stage.tolist() \
        == highest.diagnostics.iters_per_stage.tolist()


@pytest.mark.parametrize("value", ACCEPTED)
def test_fit_matches_the_jax_fit_with_the_same_value(data, value):
    x, w0 = data
    c = lct.Corex(matmul_precision=value, **FIT).fit(x, init_ws=w0)
    j = lc.Corex(n_hidden=8, max_iter=300, dtype="float32",
                 matmul_precision=value).fit(x, init_ws=w0)
    assert np.array_equal(c.clusters, np.asarray(j.clusters))
    assert abs(c.tc - j.tc) / j.tc < 1e-3


@pytest.mark.parametrize("value", ["high", "bfloat16"])
def test_float64_is_unaffected(data, value):
    x, w0 = data
    kw = dict(FIT, dtype="float64")
    a = lct.Corex(matmul_precision=value, **kw).fit(x, init_ws=w0)
    b = lct.Corex(**kw).fit(x, init_ws=w0)
    assert torch.equal(a.ws, b.ws) and a.tc == b.tc


@pytest.mark.parametrize("value", ACCEPTED)
def test_scope_maps_the_value_on_a_cuda_device_and_restores(value):
    """The scope sets torch's setting per the table on a CUDA device (read
    off the scope; no card is needed to set it) and full float32 on the
    CPU, and hands the caller's setting back."""
    torch.set_float32_matmul_precision("medium")
    cfg = CorexConfig(matmul_precision=value)
    with TC.precision_ctx(cfg, "cuda"):
        assert torch.get_float32_matmul_precision() == ON_CUDA[value]
    assert torch.get_float32_matmul_precision() == "medium"
    with TC.precision_ctx(cfg, "cpu"):
        assert torch.get_float32_matmul_precision() == "highest"
    assert torch.get_float32_matmul_precision() == "medium"
    torch.set_float32_matmul_precision("highest")


@pytest.mark.parametrize("caller", ["highest", "high", "medium"])
def test_callers_setting_is_restored_after_a_fit(data, caller):
    x, w0 = data
    torch.set_float32_matmul_precision(caller)
    try:
        lct.Corex(matmul_precision="high", **FIT).fit(x, init_ws=w0)
        assert torch.get_float32_matmul_precision() == caller
    finally:
        torch.set_float32_matmul_precision("highest")


def test_callers_setting_is_restored_after_a_fit_that_raises(
        data, monkeypatch):
    x, w0 = data

    def broken(*args, **kwargs):
        assert torch.get_float32_matmul_precision() == "highest"
        raise RuntimeError("solver failed")

    monkeypatch.setattr(TC, "fit_core", broken)
    torch.set_float32_matmul_precision("medium")
    try:
        with pytest.raises(RuntimeError, match="solver failed"):
            lct.Corex(matmul_precision="high", **FIT).fit(x, init_ws=w0)
        assert torch.get_float32_matmul_precision() == "medium"
    finally:
        torch.set_float32_matmul_precision("highest")


def _recorded(monkeypatch):
    """Patch the fit's scope to map as on a CUDA device, and record the
    setting the solver runs under."""
    real_ctx, real_core, seen = TC.precision_ctx, TC.fit_core, []

    def cuda_ctx(cfg, device):
        return real_ctx(cfg, "cuda")

    def core(*args, **kwargs):
        seen.append(torch.get_float32_matmul_precision())
        return real_core(*args, **kwargs)

    monkeypatch.setattr(TC, "precision_ctx", cuda_ctx)
    monkeypatch.setattr(TC, "fit_core", core)
    return seen


@pytest.mark.parametrize("value", ["high", "bfloat16"])
def test_one_fit_runs_in_the_scope_and_restart_lanes_at_full_float32(
        data, monkeypatch, value):
    """The JAX package's restart program applies no precision scope, so
    the port's lanes keep full float32 whatever the value."""
    x, w0 = data
    seen = _recorded(monkeypatch)
    lct.Corex(matmul_precision=value, **dict(FIT, max_iter=5)).fit(
        x, init_ws=w0)
    lct.Corex(matmul_precision=value, n_restarts=2, seed=0,
              **dict(FIT, max_iter=5)).fit(x)
    assert seen == [ON_CUDA[value], "highest"]


def test_moment_input_and_staged_fits_run_in_the_scope(data, monkeypatch,
                                                       tmp_path):
    x, w0 = data
    seen = _recorded(monkeypatch)
    kw = dict(FIT, max_iter=5, matmul_precision="high")
    acc = lct.GramAccumulator(64, device="cpu")
    acc.update(x)
    acc.fit(**kw)
    lct.fit_from_covariance(np.cov(x.T), 1000, **kw)
    lct.Corex(**kw).partial_fit(x)
    fit_with_checkpoints(lct.Corex(**kw), x, str(tmp_path), init_ws=w0)
    assert seen and set(seen) == {"high"}


@pytest.mark.parametrize("name", DOT_ALGORITHMS)
def test_dot_algorithm_names_are_refused_by_name(data, name):
    x, w0 = data
    with pytest.raises(ValueError, match="dot-algorithm"):
        lct.Corex(matmul_precision=name, **FIT).fit(x, init_ws=w0)


@pytest.mark.parametrize("entry", ["partial_fit", "accumulator",
                                   "covariance", "checkpoint"])
def test_every_entry_point_refuses_a_dot_algorithm(data, entry, tmp_path):
    x, w0 = data
    kw = dict(FIT, matmul_precision="TF32_TF32_F32")
    calls = {
        "partial_fit": lambda: lct.Corex(**kw).partial_fit(x),
        "accumulator": lambda: lct.GramAccumulator(
            64, device="cpu").update(x).fit(**kw),
        "covariance": lambda: lct.fit_from_covariance(np.cov(x.T), 1000,
                                                      **kw),
        "checkpoint": lambda: fit_with_checkpoints(
            lct.Corex(**kw), x, str(tmp_path / "ck"), init_ws=w0)}
    with pytest.raises(ValueError, match="dot-algorithm"):
        calls[entry]()


@pytest.mark.parametrize("value", ACCEPTED)
def test_save_and_load_round_trip_the_value(data, tmp_path, value):
    x, w0 = data
    c = lct.Corex(matmul_precision=value, **dict(FIT, max_iter=5)).fit(
        x, init_ws=w0)
    path = str(tmp_path / "model.npz")
    save_corex(c, path)
    again = load_corex(path, device="cpu")
    assert again.matmul_precision == value
    assert again.config.matmul_precision == value
    assert np.array_equal(again.transform(x), c.transform(x))
