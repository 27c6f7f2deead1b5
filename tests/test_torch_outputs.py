"""The output rule of the PyTorch port: outputs follow the kind of their
input (`models.corex.as_kind`), sklearn's array-API rule and the upstream
LinearCorEx's (NumPy in, NumPy out).

Every public output of `Corex` and `StackedCorex` is called with each kind
of input: a NumPy array, a list, a pandas object, a NumPy memmap and a CPU
tensor. A tensor in gives a tensor on the model device out; every other
kind gives a `numpy.ndarray`, bitwise the host copy
(`core.solver.host_numpy`) of the same call on a tensor. The fitted
attributes (`tcs`, `mis`, `clusters`, `get_covariance`,
`covariance_blocks`) follow the input of the fit, and a fit from any kind
is bitwise the fit from a tensor. Then: the kind of the models that the
constructors build from a file, from NumPy or from moments, and after a
pickle; no host round trip between the layers of a stack; and sklearn
steps after `Corex` in a Pipeline.
"""

import itertools
import pickle

import numpy as np
import pytest
import torch

import linearcorex_tpu_torch as lct
from linearcorex_tpu_torch.core.solver import host_numpy
from linearcorex_tpu_torch.models import corex as TC
from linearcorex_tpu_torch.utils.checkpoint import fit_with_checkpoints
from tests.conftest import block_data

# One intra-op thread: the suite runs its files in parallel worker
# processes, and an OpenMP pool per process on every core slows the
# small tensors here several times over.
torch.set_num_threads(1)

N, P, M = 200, 16, 2
SKW = dict(seed=0, max_iter=60, device="cpu")     # a stack's layers
KW = dict(n_hidden=M, **SKW)
STACK = [M, 1]
_files = itertools.count()


def _pandas(a, tmp):
    pd = pytest.importorskip("pandas")
    return pd.DataFrame(a) if a.ndim == 2 else pd.Series(a)


def _memmap(a, tmp):
    mm = np.memmap(tmp / f"a{next(_files)}.dat", dtype=a.dtype, mode="w+",
                   shape=a.shape)
    mm[:] = a
    return mm


# each kind of input, made from a NumPy array
KINDS = {"numpy": lambda a, tmp: a,
         "list": lambda a, tmp: a.tolist(),
         "pandas": _pandas,
         "memmap": _memmap,
         "tensor": lambda a, tmp: torch.as_tensor(a)}


def _check(out, ref, kind):
    """`out` is of `kind` (a tensor for 'tensor', else a numpy.ndarray)
    and holds the bits of `ref`, the same output of a tensor call."""
    if isinstance(ref, dict):
        assert isinstance(out, dict) and list(out) == list(ref)
        for k in ref:
            _check(out[k], ref[k], kind)
        return
    if isinstance(ref, (tuple, list)):
        assert type(out) is type(ref) and len(out) == len(ref)
        for o, r in zip(out, ref):
            _check(o, r, kind)
        return
    assert isinstance(ref, torch.Tensor) and ref.device.type == "cpu"
    if kind == "tensor":
        assert isinstance(out, torch.Tensor)
        assert out.device == ref.device and out.dtype == ref.dtype
        assert torch.equal(out, ref)
    else:
        want = host_numpy(ref)
        assert type(out) is np.ndarray, type(out)
        assert out.dtype == want.dtype and out.shape == want.shape
        assert np.array_equal(out, want)


@pytest.fixture(scope="module")
def x():
    return block_data(n=N, p=P, m=M, seed=0)


@pytest.fixture(scope="module")
def served(x):
    """One Corex and one StackedCorex fitted on NumPy, and the inputs of
    their serving calls as NumPy arrays."""
    c = lct.Corex(**KW).fit(x)
    s = lct.StackedCorex(STACK, **SKW).fit(x)
    rng = np.random.RandomState(1)
    inputs = dict(x=x, y=c.transform(x), y2=s.transform(x),
                  v=rng.normal(size=P), vb=rng.normal(size=(P, 3)))
    return {"corex": c, "stacked": s}, inputs


SERVING = {
    "transform": ("corex", "x", lambda m, a: m.transform(a)),
    "transform_details": ("corex", "x",
                          lambda m, a: m.transform(a, details=True)),
    "predict": ("corex", "y", lambda m, a: m.predict(a)),
    "inverse_transform": ("corex", "y", lambda m, a: m.inverse_transform(a)),
    "covariance_matvec": ("corex", "v",
                          lambda m, a: m.covariance_matvec(a)),
    "covariance_matmat": ("corex", "vb",
                          lambda m, a: m.covariance_matmat(a)),
    "stacked_transform": ("stacked", "x", lambda s, a: s.transform(a)),
    "stacked_transform_level0": ("stacked", "x",
                                 lambda s, a: s.transform(a, level=0)),
    "stacked_transform_all": ("stacked", "x",
                              lambda s, a: s.transform_all(a)),
    "stacked_predict": ("stacked", "y2", lambda s, a: s.predict(a)),
    "stacked_inverse_transform": ("stacked", "y2",
                                  lambda s, a: s.inverse_transform(a)),
}


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("case", list(SERVING))
def test_serving_output_follows_the_input_kind(case, kind, served,
                                               tmp_path):
    models, inputs = served
    which, arg, call = SERVING[case]
    a = inputs[arg]
    _check(call(models[which], KINDS[kind](a, tmp_path)),
           call(models[which], torch.as_tensor(a)), kind)


@pytest.fixture(scope="module")
def fits(x, tmp_path_factory):
    """Per kind of the fit's input: a Corex and a StackedCorex fitted on
    it, and fit_transform's output for each."""
    tmp = tmp_path_factory.mktemp("fits")
    out = {}
    for kind, make in KINDS.items():
        out[kind] = dict(
            corex=lct.Corex(**KW).fit(make(x, tmp)),
            stacked=lct.StackedCorex(STACK, **SKW).fit(make(x, tmp)),
            fit_transform=lct.Corex(**KW).fit_transform(make(x, tmp)),
            stacked_fit_transform=lct.StackedCorex(
                STACK, **SKW).fit_transform(make(x, tmp)))
    return out


FITTED = {
    "tcs": lambda f: f["corex"].tcs,
    "mis": lambda f: f["corex"].mis,
    "clusters": lambda f: f["corex"].clusters,
    "get_covariance": lambda f: f["corex"].get_covariance(),
    "covariance_blocks": lambda f: [
        r for _, r in f["corex"].covariance_blocks(5)],
    "fit_transform": lambda f: f["fit_transform"],
    "stacked_tcs": lambda f: f["stacked"].tcs,
    "stacked_clusters": lambda f: f["stacked"].clusters,
    "stacked_fit_transform": lambda f: f["stacked_fit_transform"],
}


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("case", list(FITTED))
def test_fitted_output_follows_the_fit_input_kind(case, kind, fits):
    _check(FITTED[case](fits[kind]), FITTED[case](fits["tensor"]), kind)


def test_scalars_stay_python_floats(fits, x):
    for kind in ("numpy", "tensor"):
        c = fits[kind]["corex"]
        assert type(c.tc) is float and type(fits[kind]["stacked"].tc) \
            is float
        assert type(c.score(KINDS[kind](x, None))) is float
    assert fits["numpy"]["corex"].score(x) == \
        fits["tensor"]["corex"].score(torch.as_tensor(x))


def _stream(x, make):
    acc = lct.GramAccumulator(P, device="cpu")
    for i, start in enumerate(range(0, N, 50)):
        acc.update(make(x[start:start + 50], i))
    return acc.fit(**KW)


def _partial(x, make):
    c = lct.Corex(**KW)
    for start in range(0, N, 100):
        c.partial_fit(make(x[start:start + 100]))
    return c


def _saved(model, tmp):
    path = str(tmp / f"m{next(_files)}.npz")
    lct.save_corex(model, path)
    return path


def _csv(x, tmp):
    path = tmp / f"x{next(_files)}.csv"
    np.savetxt(path, x, delimiter=",")
    return lct.fit_csv(str(path), **KW)


# how a model is built, and the kind its fitted attributes must be
CONSTRUCTORS = {
    "load_corex": ("numpy", lambda x, tmp: lct.load_corex(
        _saved(lct.Corex(**KW).fit(torch.as_tensor(x)), tmp),
        device="cpu")),
    "corex_from_numpy": ("numpy", lambda x, tmp: lct.corex_from_numpy(
        np.load(_saved(lct.Corex(**KW).fit(x), tmp)), **KW)),
    "fit_csv": ("numpy", _csv),
    "fit_from_covariance_numpy": ("numpy", lambda x, tmp:
                                  lct.fit_from_covariance(
                                      np.cov(x.T), N, **KW)),
    "fit_from_covariance_tensor": ("tensor", lambda x, tmp:
                                   lct.fit_from_covariance(
                                       torch.as_tensor(np.cov(x.T)), N,
                                       **KW)),
    "accumulator_numpy": ("numpy", lambda x, tmp: _stream(
        x, lambda b, i: b)),
    "accumulator_tensor": ("tensor", lambda x, tmp: _stream(
        x, lambda b, i: torch.as_tensor(b))),
    "accumulator_mixed": ("numpy", lambda x, tmp: _stream(
        x, lambda b, i: torch.as_tensor(b) if i else b)),
    "partial_fit_numpy": ("numpy", lambda x, tmp: _partial(
        x, lambda b: b)),
    "partial_fit_tensor": ("tensor", lambda x, tmp: _partial(
        x, torch.as_tensor)),
    "checkpoints_numpy": ("numpy", lambda x, tmp: fit_with_checkpoints(
        lct.Corex(**KW), x, str(tmp / f"ck{next(_files)}"))),
    "checkpoints_tensor": ("tensor", lambda x, tmp: fit_with_checkpoints(
        lct.Corex(**KW), torch.as_tensor(x), str(tmp / f"ck{next(_files)}"))),
    "pickled_tensor_fit": ("tensor", lambda x, tmp: pickle.loads(
        pickle.dumps(lct.Corex(**KW).fit(torch.as_tensor(x))))),
    "pickled_numpy_fit": ("numpy", lambda x, tmp: pickle.loads(
        pickle.dumps(lct.Corex(**KW).fit(torch.as_tensor(x)).fit(x)))),
}


@pytest.mark.parametrize("case", list(CONSTRUCTORS))
def test_constructed_models_report_in_their_inputs_kind(case, x, tmp_path):
    """A model built from a file or from NumPy reports NumPy; one built
    from tensors reports tensors; the kind survives a pickle. Serving
    calls follow their own input whatever the model's kind."""
    kind, build = CONSTRUCTORS[case]
    model = build(x, tmp_path)
    want = torch.Tensor if kind == "tensor" else np.ndarray
    for out in (model.tcs, model.mis, model.clusters,
                model.get_covariance(),
                next(model.covariance_blocks(4))[1]):
        assert isinstance(out, want), type(out)
    assert isinstance(model.transform(x), np.ndarray)
    assert isinstance(model.transform(torch.as_tensor(x)), torch.Tensor)


@pytest.mark.parametrize("method", ["fit", "transform", "transform_all",
                                    "predict"])
def test_stack_makes_no_host_round_trip_between_layers(method, x,
                                                       monkeypatch):
    """A NumPy input goes to the device once, in layer 1, and comes back
    once, at the end: every deeper layer takes a tensor, and the read-backs
    (`host_numpy` in the output rule) are one per returned array."""
    s = lct.StackedCorex([M, 2, 1], **SKW).fit(x)
    y3 = s.transform(x)
    seen, reads = [], []
    for name in ("_transform", "_predict"):
        real = getattr(TC.Corex, name)

        def spy(self, a, *args, _real=real, **kw):
            seen.append(type(a).__name__)
            return _real(self, a, *args, **kw)
        monkeypatch.setattr(TC.Corex, name, spy)
    real_host = TC.host_numpy
    monkeypatch.setattr(TC, "host_numpy",
                        lambda t: reads.append(t.shape) or real_host(t))
    arg = y3 if method == "predict" else x
    out = getattr(s, method)(arg) if method != "fit" else \
        lct.StackedCorex([M, 2, 1], **SKW).fit(x)
    assert seen == ["ndarray", "Tensor", "Tensor"]
    n_out = {"fit": 0, "transform": 1, "transform_all": 3, "predict": 1}
    assert len(reads) == n_out[method]
    if method != "fit":
        assert all(type(o) is np.ndarray for o in (
            out if isinstance(out, list) else [out]))


def test_sklearn_steps_after_corex():
    """`Pipeline([Corex, StandardScaler, LinearRegression])` on NumPy
    input: the regression's target is a mix of the planted factors, which
    Corex's factors recover; and the round trip through Corex and the
    scaler, `np.linalg.norm(recon - x)`, as the JAX package's example
    computes it."""
    pytest.importorskip("sklearn")
    from sklearn.linear_model import LinearRegression
    from sklearn.pipeline import Pipeline
    from sklearn.preprocessing import StandardScaler
    rng = np.random.RandomState(0)
    z = rng.normal(size=(400, 3))
    x = np.repeat(z, 6, axis=1) * 0.9 + 0.44 * rng.normal(size=(400, 18))
    target = z @ np.array([1.0, -2.0, 0.5])
    est = dict(n_hidden=3, seed=0, max_iter=200, device="cpu")
    pipe = Pipeline([("corex", lct.Corex(**est)),
                     ("scale", StandardScaler()),
                     ("reg", LinearRegression())]).fit(x, target)
    assert isinstance(pipe.predict(x), np.ndarray)
    assert pipe.score(x, target) > 0.9
    rt = Pipeline([("corex", lct.Corex(**est)),
                   ("scale", StandardScaler())])
    factors = rt.fit_transform(x)
    recon = rt.inverse_transform(factors)
    assert type(recon) is np.ndarray and recon.shape == x.shape
    rel = np.linalg.norm(recon - x) / np.linalg.norm(x)
    alone = lct.Corex(**est).fit(x)
    rel0 = np.linalg.norm(alone.predict(alone.transform(x)) - x) \
        / np.linalg.norm(x)
    assert rel < 0.6 and abs(rel - rel0) < 1e-5
