"""The serving surface of the PyTorch port against the JAX package's:
`predict`/`inverse_transform`, `get_covariance`, `score` and
`covariance_matvec`/`matmat`/`blocks`, plus `fit_transform` and the
sklearn estimator protocol.

A float64 model fitted by the JAX package is carried across
(`corex_from_numpy`), so both packages serve the same state: every method
must agree within 1e-10 on both objectives. Argument errors carry the JAX
package's messages. The sklearn battery's failure set is pinned on
`Corex(device="cpu")`.
"""

import pathlib
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import linearcorex_tpu as lc
import linearcorex_tpu_torch as lct
from linearcorex_tpu.utils.checkpoint import save_corex
from tests.conftest import block_data

sklearn = pytest.importorskip("sklearn")

from sklearn.base import clone  # noqa: E402
from sklearn.exceptions import NotFittedError  # noqa: E402
from sklearn.model_selection import GridSearchCV, cross_val_score  # noqa: E402
from sklearn.pipeline import Pipeline  # noqa: E402
from sklearn.utils.validation import check_is_fitted  # noqa: E402

# One intra-op thread: the suite runs its files in parallel worker
# processes, and an OpenMP pool per process on every core slows the
# small tensors here several times over.
torch.set_num_threads(1)

TOL = 1e-10
OBJECTIVES = {"ns": dict(), "overlap": dict(discourage_overlap=False,
                                            max_iter=500)}


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """(JAX model, carried-across port model) per objective, float64."""
    x = block_data(n=600, p=40, m=5, seed=2)
    out = {}
    for name, kw in OBJECTIVES.items():
        j = lc.Corex(n_hidden=5, seed=1, dtype="float64", **kw).fit(x)
        path = tmp_path_factory.mktemp(name) / "model.npz"
        save_corex(j, str(path))
        with np.load(path) as z:
            state = {k: z[k] for k in z.files}
        out[name] = (j, lct.corex_from_numpy(state, n_hidden=5,
                                             dtype="float64", device="cpu",
                                             **kw))
    return out


def _close(got, want, tol=TOL):
    """The port's answer to NumPy input is NumPy (`score` a float)."""
    want = np.asarray(want)
    assert isinstance(got, np.ndarray if want.ndim else float), type(got)
    assert np.shape(got) == want.shape
    assert np.abs(got - want).max() <= tol * max(
        1.0, np.abs(want).max())


METHODS = ["predict", "inverse_transform", "get_covariance", "score",
           "covariance_matvec", "covariance_matmat", "covariance_blocks"]


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("objective", list(OBJECTIVES))
def test_serving_matches_jax(objective, method, models):
    j, c = models[objective]
    rng = np.random.RandomState(5)
    x2 = block_data(n=150, p=40, m=5, seed=8)
    if method in ("predict", "inverse_transform"):
        y = np.asarray(j.transform(x2))
        _close(getattr(c, method)(y), getattr(j, method)(y))
    elif method == "get_covariance":
        _close(c.get_covariance(), j.get_covariance())
    elif method == "score":
        _close(c.score(x2), j.score(x2))
    elif method == "covariance_matvec":
        v = rng.normal(size=40)
        _close(c.covariance_matvec(v), j.covariance_matvec(v))
        _close(c.covariance_matvec(v), c.get_covariance() @ v)
    elif method == "covariance_matmat":
        v = rng.normal(size=(40, 6))
        _close(c.covariance_matmat(v), j.covariance_matmat(v))
        _close(c.covariance_matmat(v), c.get_covariance() @ v)
    else:
        dense = c.get_covariance()
        for size in (7, 40, 64):
            got = list(c.covariance_blocks(size))
            want = list(j.covariance_blocks(size))
            assert [s for s, _ in got] == [s for s, _ in want]
            for (_, g), (_, w) in zip(got, want):
                _close(g, w)
            _close(np.concatenate([r for _, r in got]), dense)


def test_score_prefers_the_fitted_structure(models):
    _, c = models["ns"]
    x2 = block_data(n=150, p=40, m=5, seed=8)
    shuffled = np.random.RandomState(0).permutation(x2.T).T
    assert float(c.score(x2)) > float(c.score(shuffled))


def _raises_as_jax(exc, jax_call, port_call):
    with pytest.raises(exc) as want:
        jax_call()
    with pytest.raises(exc) as got:
        port_call()
    assert str(got.value) == str(want.value)


BAD_CALLS = {
    "predict_width": lambda m: m.predict(np.zeros((3, 4))),
    "predict_nan": lambda m: m.predict(np.full((3, 5), np.nan)),
    "predict_1d": lambda m: m.predict(np.zeros(5)),
    "matvec_shape": lambda m: m.covariance_matvec(np.zeros((40, 2))),
    "matmat_shape": lambda m: m.covariance_matmat(np.zeros(40)),
    "blocks_size": lambda m: next(iter(m.covariance_blocks(0))),
    "score_width": lambda m: m.score(np.zeros((3, 7))),
}


@pytest.mark.parametrize("name", list(BAD_CALLS))
def test_argument_errors_as_jax(name, models):
    j, c = models["ns"]
    _raises_as_jax(ValueError, lambda: BAD_CALLS[name](j),
                   lambda: BAD_CALLS[name](c))


def test_score_rejects_non_affine_gaussianize_as_jax():
    x = block_data(n=200, p=16, m=2, seed=0)
    kw = dict(n_hidden=2, gaussianize="empirical", seed=0, max_iter=30)
    j = lc.Corex(**kw).fit(x)
    c = lct.Corex(device="cpu", **kw).fit(x)
    _raises_as_jax(ValueError, lambda: j.score(x), lambda: c.score(x))


@pytest.mark.parametrize("method", ["transform", "predict", "score",
                                    "covariance_matvec",
                                    "covariance_matmat",
                                    "covariance_blocks", "fit_transform"])
def test_mesh_arguments_raise_by_item(method, models):
    _, c = models["ns"]
    args = {"predict": np.zeros((2, 5)), "covariance_matvec": np.zeros(40),
            "covariance_matmat": np.zeros((40, 1))}.get(
        method, np.zeros((4, 40)))
    # every plan serves under a mesh (tests/test_torch_sharding.py,
    # tests/test_torch_sharding_vars.py); a mesh without a process group
    # raises by name, whatever the plan
    from linearcorex_tpu_torch.parallel.sharding import ShardingPlan
    with pytest.raises(RuntimeError, match="default process group"):
        out = getattr(c, method)(
            args, mesh=object(), sharding_plan=ShardingPlan(shard_vars=True))
        next(iter(out))
    with pytest.raises(RuntimeError, match="default process group"):
        out = getattr(c, method)(args, mesh=object())
        next(iter(out))


def test_fit_transform_is_fit_then_transform():
    x = block_data(n=300, p=24, m=3, seed=1)
    a = lct.Corex(n_hidden=3, seed=0, device="cpu")
    y = a.fit_transform(x, None)
    b = lct.Corex(n_hidden=3, seed=0, device="cpu").fit(x)
    assert np.array_equal(y, b.transform(x))


def test_params_round_trip_and_fitted_width():
    x = block_data(n=300, p=24, m=3, seed=1)
    c = lct.Corex(n_hidden=3, seed=0, tol=1e-4, device="cpu")
    params = c.get_params()
    assert params["n_hidden"] == 3 and params["device"] == "cpu"
    assert params["n_restarts"] == 1
    c2 = clone(c)
    assert c2.get_params() == params
    c.fit(x)
    y = c.transform(x)
    c.set_params(n_hidden=5)          # fitted state kept
    assert tuple(c.predict(y).shape) == (300, 24)
    with pytest.raises(ValueError, match="3 columns"):
        c.predict(np.zeros((2, 5)))
    assert c.get_feature_names_out().tolist() == ["corex0", "corex1",
                                                  "corex2"]
    with pytest.raises(ValueError, match="invalid parameter"):
        c.set_params(bogus=1)
    c.set_params(n_restarts="bad")     # stored verbatim, raised at fit
    with pytest.raises(ValueError, match="n_restarts"):
        c.fit(x)


def test_not_fitted_protocol():
    c = lct.Corex(n_hidden=2, device="cpu")
    with pytest.raises(NotFittedError):
        check_is_fitted(c)
    for call in (lambda: c.predict(np.zeros((2, 2))), c.get_covariance,
                 lambda: c.get_feature_names_out()):
        # sklearn is imported: the raise is sklearn's class and the port's
        with pytest.raises(NotFittedError) as e:
            call()
        assert isinstance(e.value, lct.NotFittedError)
    with pytest.raises(AttributeError, match="not fitted"):
        c.n_features_in_
    x = block_data(n=200, p=16, m=2, seed=0)
    c.fit(x)
    check_is_fitted(c)
    assert c.n_features_in_ == 16


def test_sklearn_tags():
    t = lct.Corex(seed=0, device="cpu").__sklearn_tags__()
    assert t.estimator_type == "transformer"
    assert t.input_tags.allow_nan is False
    assert t.non_deterministic is False
    t_nan = lct.Corex(missing_values=float("nan")).__sklearn_tags__()
    assert t_nan.input_tags.allow_nan is True
    assert lct.Corex(seed=None).__sklearn_tags__().non_deterministic


def test_pipeline_cross_validation_and_grid_search():
    x = block_data(n=240, p=24, m=3, seed=0)
    est = lct.Corex(n_hidden=3, seed=0, max_iter=60, device="cpu")
    z = Pipeline([("corex", est)]).fit_transform(x, None)
    assert tuple(z.shape) == (240, 3)
    scores = cross_val_score(clone(est), x, cv=3)
    assert scores.shape == (3,) and np.isfinite(scores).all()
    rng = np.random.default_rng(0)
    xs = rng.normal(size=(240, 3)) @ rng.normal(size=(3, 18)) \
        + 0.1 * rng.normal(size=(240, 18))
    gs = GridSearchCV(lct.Corex(n_hidden=1, seed=0, max_iter=40,
                                device="cpu"), {"n_hidden": [1, 3]}, cv=2)
    assert gs.fit(xs).best_params_["n_hidden"] == 3


def test_pandas_output_and_pickle():
    pd = pytest.importorskip("pandas")
    x = block_data(n=200, p=16, m=2, seed=0)
    xdf = pd.DataFrame(x, index=np.arange(200) + 1000)
    c = lct.Corex(n_hidden=2, seed=0, max_iter=40, device="cpu")
    z = c.set_output(transform="pandas").fit_transform(xdf)
    assert isinstance(z, pd.DataFrame)
    assert list(z.columns) == ["corex0", "corex1"] and z.index[0] == 1000
    y, mom = c.transform(x, details=True)
    assert isinstance(y, np.ndarray) and isinstance(mom, dict)
    c.set_output(transform="default")
    assert isinstance(c.transform(x), np.ndarray)
    with pytest.raises(ValueError, match="set_output"):
        c.set_output(transform="polars")
    c2 = pickle.loads(pickle.dumps(c))
    assert np.array_equal(c2.transform(x), c.transform(x))
    # the fit's input kind survives pickling: a DataFrame fit reports NumPy
    assert isinstance(c2.tcs, np.ndarray)


# sklearn's battery calls predict with feature-space X; the reference API
# defines predict(Y) on factors (tests/test_sklearn_interop.py pins the
# same set for the JAX package). NumPy in gives NumPy out, so
# check_fit_idempotent passes, as it does for the JAX package.
_PREDICT_SEMANTICS = "predict takes the (n, m) FACTOR matrix"
_EXPECTED_FAILURES = {
    "check_estimators_dtypes": _PREDICT_SEMANTICS,
    "check_dtype_object": _PREDICT_SEMANTICS,
    "check_estimators_nan_inf": _PREDICT_SEMANTICS,
    "check_estimators_pickle": _PREDICT_SEMANTICS,
    "check_f_contiguous_array_estimator": _PREDICT_SEMANTICS,
    "check_methods_sample_order_invariance": _PREDICT_SEMANTICS,
    "check_methods_subset_invariance": _PREDICT_SEMANTICS,
    "check_dict_unchanged": _PREDICT_SEMANTICS,
    "check_n_features_in_after_fitting": _PREDICT_SEMANTICS,
}


def test_check_estimator_failure_set_pinned():
    from sklearn.utils.estimator_checks import check_estimator

    from tests.test_sklearn_interop import _EXPECTED_FAILURES as jax_set
    assert set(_EXPECTED_FAILURES) == set(jax_set)
    results = check_estimator(
        lct.Corex(n_hidden=2, max_iter=30, seed=0, device="cpu"),
        on_fail=None)
    failed = {r["check_name"] for r in results if r["status"] == "failed"}
    passed = {r["check_name"] for r in results if r["status"] == "passed"}
    assert failed == set(_EXPECTED_FAILURES), failed ^ set(
        _EXPECTED_FAILURES)
    assert len(passed) >= 30
    assert "check_fit_idempotent" in passed


def test_import_leaves_jax_sklearn_and_pandas_out():
    code = ("import sys, linearcorex_tpu_torch; "
            "bad = [m for m in ('jax', 'sklearn', 'pandas', "
            "'linearcorex_tpu') if m in sys.modules]; "
            "assert not bad, bad; print('ok')")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300,
                          cwd=str(pathlib.Path(__file__).resolve().parents[1]))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip() == "ok"
