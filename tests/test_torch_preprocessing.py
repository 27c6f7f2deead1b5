"""The PyTorch port's preprocessing against the JAX package's, float64,
on numpy inputs made from a seed."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from linearcorex_tpu.ops import preprocessing as JP
from linearcorex_tpu_torch.ops import preprocessing as TP


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


def test_empirical_not_ported():
    x = torch.from_numpy(np.random.RandomState(0).normal(size=(20, 3)))
    with pytest.raises(NotImplementedError, match="Queue 1"):
        TP.fit_preprocess(x, "empirical")
