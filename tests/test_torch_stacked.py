"""The port's `StackedCorex` on its own and against the JAX package's: a
two-layer float64 stack from seeded inits is step-matched per layer (the
same iterations per stage, TC and W within 1e-8), and `transform_all`,
`predict` and `clusters` agree. The port runs on `device="cpu"`.
"""

import numpy as np
import pytest
import torch

import linearcorex_tpu as lc
import linearcorex_tpu_torch as lct
from linearcorex_tpu_torch.models.stacked import StackedCorex
from tests.conftest import block_data

torch.set_num_threads(1)

TOL64 = 1e-8


def hierarchical_data(n=1500, seed=0):
    """Two-level structure: 4 fine blocks of variables; the fine factors
    pair up under 2 coarse super-factors (what layer 2 should find)."""
    rng = np.random.RandomState(seed)
    g = rng.normal(size=(n, 2))                        # coarse
    z = np.empty((n, 4))
    for j in range(4):
        z[:, j] = 0.8 * g[:, j // 2] + 0.6 * rng.normal(size=n)
    x = np.empty((n, 24))
    for j in range(4):
        for i in range(6):
            x[:, j * 6 + i] = 0.9 * z[:, j] + 0.436 * rng.normal(size=n)
    return x


@pytest.fixture(scope="module")
def x():
    return hierarchical_data()


def test_two_layer_fit_recovers_hierarchy(x):
    s = StackedCorex([4, 2], seed=0, dtype="float64", device="cpu").fit(x)
    cl1 = s.clusters[0].numpy()
    for j in range(4):
        assert len(set(cl1[j * 6:(j + 1) * 6])) == 1
    assert len({cl1[j * 6] for j in range(4)}) == 4
    cl2 = s.clusters[1].numpy()
    inv = np.empty(4, dtype=int)
    for j in range(4):
        inv[cl1[j * 6]] = j          # factor index -> fine block id
    pair = {}
    for f in range(4):
        pair.setdefault(inv[f] // 2, set()).add(int(cl2[f]))
    assert all(len(v) == 1 for v in pair.values()), \
        "sibling fine factors must share a layer-2 factor"
    assert pair[0] != pair[1]


def test_transform_predict_shapes(x):
    s = StackedCorex([4, 2], seed=0, device="cpu").fit(x)
    y2 = s.transform(x)
    assert tuple(y2.shape) == (1500, 2)
    ys = s.transform_all(x)
    assert [a.shape[1] for a in ys] == [4, 2]
    assert torch.equal(s.transform(x, level=0), ys[0])
    assert torch.equal(ys[1], y2)
    xh = s.predict(y2)
    assert tuple(xh.shape) == x.shape
    corr = np.corrcoef(xh.numpy().ravel(), x.ravel())[0, 1]
    assert corr > 0.6


def test_stacked_tc_positive_layers(x):
    s = StackedCorex([4, 2], seed=0, device="cpu").fit(x)
    assert s.tc > 0
    assert all(float(t.sum()) > 0 for t in s.tcs)
    assert s.tc == pytest.approx(sum(float(t.sum()) for t in s.tcs))


def test_stacked_sklearn_conventions():
    xs = block_data(n=200, p=16, m=4, seed=1)
    s = StackedCorex([4, 2], seed=0, device="cpu").fit(xs, np.arange(200))
    z = StackedCorex([4, 2], seed=0, device="cpu").fit_transform(xs, None)
    assert torch.allclose(z, s.transform(xs))
    assert torch.equal(s.inverse_transform(z), s.predict(z))


def test_layer_options():
    """Layer 1 takes the caller's preprocessing; deeper layers always
    standardize and impute nothing; every other option, the device
    included, reaches every layer."""
    with pytest.raises(ValueError, match="non-empty"):
        StackedCorex([])
    s = StackedCorex([4, 2, 1], gaussianize="empirical",
                     missing_values=-1.0, dtype="float64", n_restarts=2,
                     device="cpu")
    assert [la.n_hidden for la in s.layers] == [4, 2, 1]
    assert [la.gaussianize for la in s.layers] == \
        ["empirical", "standard", "standard"]
    assert [la.missing_values for la in s.layers] == [-1.0, None, None]
    assert all(la.device == "cpu" and la.dtype == "float64"
               and la.n_restarts == 2 for la in s.layers)
    assert all(la.device == "cuda" for la in StackedCorex([2, 1]).layers)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            StackedCorex([2, 1]).fit(np.zeros((10, 4)))


def test_layers_hand_over_tensors(x, monkeypatch):
    """The factors go from layer to layer as tensors, never through the
    host."""
    seen = []
    real = lct.Corex.fit

    def fit(self, data, *a, **kw):
        seen.append(type(data))
        return real(self, data, *a, **kw)

    monkeypatch.setattr(lct.Corex, "fit", fit)
    StackedCorex([4, 2], seed=0, max_iter=10, device="cpu").fit(x)
    assert seen == [np.ndarray, torch.Tensor]


def test_stack_step_matched_with_jax(x):
    kw = dict(seed=0, dtype="float64")
    s = StackedCorex([4, 2], device="cpu", **kw).fit(x)
    j = lc.StackedCorex([4, 2], **kw).fit(x)
    for la, lb in zip(s.layers, j.layers):
        assert la.diagnostics.iters_per_stage.tolist() == \
            np.asarray(lb.diagnostics.iters_per_stage).tolist()
        assert abs(la.tc - float(lb.tc)) < TOL64
        assert np.abs(la.ws.numpy() - np.asarray(lb.ws)).max() < TOL64
    assert abs(s.tc - j.tc) < TOL64
    for a, b in zip(s.clusters, j.clusters):
        assert np.array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(s.tcs, j.tcs):
        assert np.abs(a.numpy() - np.asarray(b)).max() < TOL64
    x2 = hierarchical_data(n=200, seed=4)
    for a, b in zip(s.transform_all(x2), j.transform_all(x2)):
        assert np.abs(a.numpy() - np.asarray(b)).max() < TOL64
    y = s.transform(x2)
    assert np.abs(s.predict(y).numpy()
                  - np.asarray(j.predict(np.asarray(y)))).max() < TOL64


def test_stack_restart_sweep_matches_jax():
    """n_restarts reaches every layer: each runs its own best-of-k sweep
    and keeps the lane the JAX stack keeps."""
    xs = block_data(n=256, p=32, m=4, seed=3, strength=0.3)
    kw = dict(n_restarts=2, seed=7, max_iter=100, record_history=False,
              moment_strategy="samples", dtype="float64")
    s = StackedCorex([4, 2], device="cpu", **kw).fit(xs)
    j = lc.StackedCorex([4, 2], **kw).fit(xs)
    for la, lb in zip(s.layers, j.layers):
        assert la.best_restart_ == lb.best_restart_
        assert np.abs(la.ws.numpy() - np.asarray(lb.ws)).max() < 1e-7
