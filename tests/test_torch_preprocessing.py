"""The PyTorch port's preprocessing against the JAX package's, float64,
on numpy inputs made from a seed."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from linearcorex_tpu.ops import preprocessing as JP
from linearcorex_tpu_torch.ops import preprocessing as TP

# One intra-op thread: the suite runs its files in parallel worker
# processes, and an OpenMP pool per process on every core slows the
# small tensors here several times over.
torch.set_num_threads(1)


@pytest.mark.parametrize("mode", ["none", "standard", "outliers"])
@pytest.mark.parametrize("missing", [None, -1.0, float("nan")])
def test_fit_preprocess_and_preprocess_match_jax(mode, missing):
    rng = np.random.RandomState(2)
    x = rng.lognormal(size=(300, 12))
    if missing is not None:
        x[::5, 2] = missing
        x[::7, 5] = missing
    xj, thj = JP.fit_preprocess(jnp.asarray(x), mode, missing)
    xt, tht = TP.fit_preprocess(torch.from_numpy(x), mode, missing)
    assert np.abs(np.asarray(xj) - xt.numpy()).max() < 1e-12
    for a, b in zip(thj, tht):
        assert np.abs(np.asarray(a) - b.numpy()).max() < 1e-12
    x2 = rng.lognormal(size=(50, 12))
    pj = JP.preprocess(jnp.asarray(x2), mode, thj, missing)
    pt = TP.preprocess(torch.from_numpy(x2), mode, tht, missing)
    assert np.abs(np.asarray(pj) - pt.numpy()).max() < 1e-12
    back = TP.invert(TP.preprocess(torch.from_numpy(x2), "standard", tht),
                     tht)
    assert np.abs(back.numpy() - x2).max() < 1e-10


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("missing", [None, -1.0])
def test_empirical_matches_jax(dtype, missing):
    """'empirical' values within 1e-6 of the JAX package's, fit time and
    transform time (which re-ranks the new batch), with ties in the
    data; theta as for the other modes."""
    rng = np.random.RandomState(2)
    x = np.round(rng.lognormal(size=(300, 12)), 1).astype(dtype)  # ties
    if missing is not None:
        x[::5, 2] = missing
    xj, thj = JP.fit_preprocess(jnp.asarray(x), "empirical", missing)
    xt, tht = TP.fit_preprocess(torch.from_numpy(x), "empirical", missing)
    assert xt.dtype == torch.from_numpy(x).dtype
    assert np.abs(np.asarray(xj) - xt.numpy()).max() < 1e-6
    for a, b in zip(thj, tht):
        assert np.abs(np.asarray(a) - b.numpy()).max() < 1e-6
    x2 = np.round(rng.lognormal(size=(50, 12)), 1).astype(dtype)
    pj = JP.preprocess(jnp.asarray(x2), "empirical", thj, missing)
    pt = TP.preprocess(torch.from_numpy(x2), "empirical", tht, missing)
    assert np.abs(np.asarray(pj) - pt.numpy()).max() < 1e-6


def test_empirical_matches_oracle():
    from linearcorex_tpu.oracle.oracle import _Preprocessor
    x = np.random.RandomState(2).lognormal(size=(300, 12))
    xt, _ = TP.fit_preprocess(torch.from_numpy(x), "empirical")
    want = _Preprocessor(gaussianize="empirical").fit_transform(x)
    assert np.abs(xt.numpy() - want).max() < 1e-9


def test_rankdata_ties_match_scipy():
    from scipy.stats import rankdata
    col = np.array([3.0, 1.0, 2.0, 2.0, 2.0, 5.0, 1.0])
    x = np.stack([col, -col, np.zeros_like(col)], axis=1)
    got = TP.rankdata_average(torch.from_numpy(x))
    assert got.dtype == torch.float64
    for j in range(3):
        assert np.array_equal(got[:, j].numpy(), rankdata(x[:, j]))
    jr = JP.rankdata_average(jnp.asarray(col))
    assert np.array_equal(np.asarray(jr), got[:, 0].numpy())
