"""The half-precision compute dtypes, `dtype='bfloat16'` and
`dtype='float16'`: the port against the JAX package on the CPU.

Both packages run the fit in the half dtype, the JAX package through
XLA:CPU, the port through torch's CPU ops. Each rounds in its own places
(XLA may keep float32 inside a fusion; torch rounds after every op), so the
paths part after a few iterations and the iteration counts differ. The
result is held instead: the same seeded data and init go through both, and
each fit must give the same clusters (the same partition of the variables:
factors whose TCs tie in a half dtype may be sorted in another order) and a
TC within `ULPS[dtype]` units in the last place of the dtype at |TC|
(0.125 in bfloat16 and 0.015625 in float16 at TC ≈ 19).

Measured on this data (n=300, p=32, m=4, init from RandomState(0)), in
ulps of the dtype at |TC|, bfloat16 / float16:

    gram (the default fit)      0 / 3       samples           1 / 3
    matmul_dtype='bfloat16'     0 / 7.5     n_restarts=3      0 / 0
    GramAccumulator.fit         0 / 4       StackedCorex      0.16 / 2.8

(with matmul_dtype='bfloat16' in float16 both packages return a float32
TC, so the count is not whole). The bounds below sit above these.

The paths that factorize a matrix (the fixed point's LU inverse, the
overlap objective's and `score`'s Cholesky, the spectral init's QR) raise
NotImplementedError in both packages, and int8 operands raise ValueError.
float16 checkpoints cross between the packages both ways; a bfloat16
model is saved as the same bytes by both, which neither can load.
"""

import json
import zipfile

import numpy as np
import pytest
import torch

import linearcorex_tpu as lc
import linearcorex_tpu_torch as lct
from linearcorex_tpu.utils import checkpoint as JC
from linearcorex_tpu_torch.ops.cuda_moments import (ns_chain,
                                                    ns_chain_reference)
from linearcorex_tpu_torch.utils import checkpoint as TC
from linearcorex_tpu_torch.utils.streaming import GramAccumulator

# One intra-op thread: the suite runs its files in parallel worker
# processes, and an OpenMP pool per process on every core slows the
# small tensors here several times over.
torch.set_num_threads(1)

DTYPES = ["bfloat16", "float16"]
# TC bound in units in the last place of the dtype at |TC|
ULPS = {"bfloat16": 2, "float16": 12}
MANTISSA = {"bfloat16": 7, "float16": 10}
# NumPy outputs: numpy has no bfloat16, which reads back as float32 exactly
HOST = {"bfloat16": np.float32, "float16": np.float16}
TORCH = {"bfloat16": torch.bfloat16, "float16": torch.float16}


@pytest.fixture(scope="module")
def x():
    rng = np.random.RandomState(0)
    z = rng.normal(size=(300, 4))
    return np.repeat(z, 8, axis=1) * 0.9 + 0.44 * rng.normal(size=(300, 32))


@pytest.fixture(scope="module")
def w0():
    """The init of Corex(seed=0) at (m, p) = (4, 32), passed explicitly."""
    return np.random.RandomState(0).normal(scale=1.0 / np.sqrt(32),
                                           size=(4, 32))


def _ulp(tc, dtype):
    return 2.0 ** (np.floor(np.log2(abs(tc))) - MANTISSA[dtype])


def _partition(clusters):
    c = np.asarray(clusters)
    return sorted(tuple(np.flatnonzero(c == k)) for k in np.unique(c))


def _host(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _assert_in_dtype(a, dtype):
    """The host array `a` holds values of `dtype` only."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    assert torch.equal(t.to(TORCH[dtype]).to(t.dtype), t)


def _assert_same_result(j_tc, j_clusters, t_tc, t_clusters, dtype):
    assert _partition(t_clusters) == _partition(j_clusters)
    assert np.isfinite(t_tc)
    assert abs(float(t_tc) - float(j_tc)) \
        <= ULPS[dtype] * _ulp(float(j_tc), dtype)


FITS = {
    "gram": {},
    "samples": dict(moment_strategy="samples"),
    "matmul_bf16": dict(matmul_dtype="bfloat16"),
}


@pytest.mark.parametrize("case", list(FITS))
@pytest.mark.parametrize("dtype", DTYPES)
def test_default_fit_matches_jax(dtype, case, x, w0):
    """The default momentum fit (and its operand modes), from one init:
    the same clusters and TC, in the dtype, with the same resolution of
    the knobs."""
    kw = dict(n_hidden=4, dtype=dtype, **FITS[case])
    j = lc.Corex(**kw).fit(x, init_ws=w0)
    c = lct.Corex(device="cpu", **kw).fit(x, init_ws=w0)
    _assert_same_result(j.tc, j.clusters, c.tc, c.clusters, dtype)
    assert c.resolved_optimizer_ == j.resolved_optimizer_ == "momentum"
    assert c.ws.dtype == TORCH[dtype] and str(j.ws.dtype) == dtype
    # TC moves in the dtype's steps: it is a value of the dtype
    if case != "matmul_bf16":
        assert float(torch.tensor(c.tc).to(TORCH[dtype])) == c.tc
    h = c.history
    assert len(h["TC"]) == c.n_iter_ == sum(h["iters_per_stage"])
    assert np.isfinite(h["TC"]).all()


@pytest.mark.parametrize("dtype", DTYPES)
def test_restart_sweep_matches_jax(dtype, x):
    j = lc.Corex(n_hidden=4, seed=0, dtype=dtype, n_restarts=3).fit(x)
    c = lct.Corex(n_hidden=4, seed=0, dtype=dtype, n_restarts=3,
                  device="cpu").fit(x)
    _assert_same_result(j.tc, j.clusters, c.tc, c.clusters, dtype)
    assert c.ws.dtype == TORCH[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
def test_accumulator_fit_matches_jax(dtype, x):
    """GramAccumulator(p, dtype=) then .fit. max_iter=2000 bounds a
    bfloat16 stage whose accept test ties (the port's final stage ran to
    10,000 iterations there, at the same TC)."""
    a = lc.GramAccumulator(32, dtype=dtype)
    b = GramAccumulator(32, dtype=dtype, device="cpu")
    for lo in range(0, 300, 100):
        a.update(x[lo:lo + 100])
        b.update(x[lo:lo + 100])
    assert b.correlation().dtype == TORCH[dtype]
    j = a.fit(n_hidden=4, seed=0, max_iter=2000)
    c = b.fit(n_hidden=4, seed=0, max_iter=2000)
    _assert_same_result(j.tc, j.clusters, c.tc, c.clusters, dtype)
    assert c.ws.dtype == TORCH[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
def test_fit_from_covariance_matches_jax(dtype, x):
    sigma = np.cov(x.T, bias=True)
    kw = dict(n_samples=300, n_hidden=4, seed=0, dtype=dtype,
              max_iter=2000)
    j = lc.fit_from_covariance(sigma, **kw)
    c = lct.fit_from_covariance(sigma, device="cpu", **kw)
    _assert_same_result(j.tc, j.clusters, c.tc, c.clusters, dtype)
    assert c.ws.dtype == TORCH[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
def test_fit_csv_matches_jax(dtype, x, tmp_path):
    path = str(tmp_path / "x.csv")
    np.savetxt(path, x, delimiter=",")
    kw = dict(n_hidden=4, block_rows=128, seed=0, dtype=dtype, max_iter=2000)
    j = lc.fit_csv(path, **kw)
    c = lct.fit_csv(path, device="cpu", **kw)
    _assert_same_result(j.tc, j.clusters, c.tc, c.clusters, dtype)
    assert c.ws.dtype == TORCH[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
def test_stacked_matches_jax(dtype, x):
    j = lc.StackedCorex([4, 2], seed=0, dtype=dtype).fit(x)
    c = lct.StackedCorex([4, 2], seed=0, dtype=dtype, device="cpu").fit(x)
    _assert_same_result(j.tc, j.layers[0].clusters, c.tc,
                        c.layers[0].clusters, dtype)
    assert c.transform(x).dtype == HOST[dtype]
    _assert_in_dtype(c.transform(x), dtype)
    assert c.transform(torch.as_tensor(x)).dtype == TORCH[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
def test_pick_n_hidden_matches_jax(dtype, x):
    """The same choice. tc_gain_tol=0.5 is four bfloat16 ulps at TC ≈ 19:
    the default 1e-3 is below the dtype's resolution, where the choice
    among the plateau's ties is noise in either package."""
    kw = dict(repeat=2, max_n_hidden=6, max_iter=200, seed=0, dtype=dtype,
              tc_gain_tol=0.5)
    nj, sj = lc.pick_n_hidden(x, **kw)
    nt, st = lct.pick_n_hidden(x, device="cpu", **kw)
    assert nt == nj == 4
    for a, b in zip(st, np.asarray(sj, np.float64)):
        assert abs(float(a) - b) <= 2 * ULPS[dtype] * _ulp(b, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_serving_outputs_in_the_model_dtype(dtype, x):
    """A JAX fit carried across (`corex_from_numpy`, bfloat16 arrays
    through their 16-bit words): every serving output holds values of the
    model dtype, as the JAX package's do, and is within a few ulps of its
    values. NumPy in gives NumPy out (bfloat16 as float32, exactly)."""
    j = lc.Corex(n_hidden=4, seed=0, dtype=dtype).fit(x)
    state = {"ws": np.asarray(j.ws), "theta_mean": np.asarray(j.theta.mean),
             "theta_std": np.asarray(j.theta.std)}
    state.update({f"mom_{k}": np.asarray(v)
                  for k, v in j.moments._asdict().items()})
    c = lct.corex_from_numpy(state, n_hidden=4, dtype=dtype, device="cpu")
    assert torch.equal(c.ws.view(torch.int16), torch.tensor(
        np.asarray(j.ws).view(np.int16)))
    assert c.tc == float(j.tc)
    dt = TORCH[dtype]
    y = c.transform(x)
    yt = c.transform(torch.as_tensor(x))
    assert yt.dtype == dt and np.array_equal(yt.float().numpy(), y)
    v = np.linspace(-1, 1, 32)
    outs = {
        "transform": (y, j.transform(x)),
        "predict": (c.predict(y), j.predict(j.transform(x))),
        "get_covariance": (c.get_covariance(), j.get_covariance()),
        "covariance_matvec": (c.covariance_matvec(v),
                              j.covariance_matvec(v)),
        "covariance_matmat": (c.covariance_matmat(v[:, None]),
                              j.covariance_matmat(v[:, None])),
        "covariance_blocks": (next(c.covariance_blocks(8))[1],
                              next(j.covariance_blocks(8))[1]),
    }
    rel = 2.0 ** -MANTISSA[dtype]
    for name, (ours, theirs) in outs.items():
        assert ours.dtype == HOST[dtype], name
        _assert_in_dtype(ours, dtype)
        assert str(theirs.dtype) == dtype, name
        a, b = _host(ours), _host(theirs)
        assert np.abs(a - b).max() <= 8 * rel * max(1.0, np.abs(b).max()), \
            name


ERRORS = {
    "auto_n_ge_p": (dict(optimizer="auto"), NotImplementedError),
    "fixed_point": (dict(optimizer="fixed_point"), NotImplementedError),
    "overlap": (dict(discourage_overlap=False), NotImplementedError),
    "spectral": (dict(init="spectral", anneal=False), NotImplementedError),
    "int8": (dict(matmul_dtype="int8"), ValueError),
}


@pytest.mark.parametrize("case", list(ERRORS))
@pytest.mark.parametrize("dtype", DTYPES)
def test_unsupported_paths_raise_as_in_jax(dtype, case, x):
    """The same exception type in both packages. The port names the dtype
    and the operation; nothing is upcast to make them run."""
    kw, exc = ERRORS[case]
    with pytest.raises(exc):
        lc.Corex(n_hidden=4, seed=0, dtype=dtype, **kw).fit(x)
    with pytest.raises(exc, match=dtype if exc is NotImplementedError
                       else "float32"):
        lct.Corex(n_hidden=4, seed=0, dtype=dtype, device="cpu",
                  **kw).fit(x)


@pytest.mark.parametrize("dtype", DTYPES)
def test_score_raises_as_in_jax(dtype, x):
    j = lc.Corex(n_hidden=4, seed=0, dtype=dtype, max_iter=50).fit(x)
    c = lct.Corex(n_hidden=4, seed=0, dtype=dtype, max_iter=50,
                  device="cpu").fit(x)
    with pytest.raises(NotImplementedError):
        j.score(x)
    with pytest.raises(NotImplementedError, match="Cholesky.*" + dtype):
        c.score(x)


@pytest.mark.parametrize("dtype", DTYPES)
def test_chain_wrapper_takes_half_operands(dtype):
    """`ns_chain` casts half operands to float32 (as the JAX package's
    Pallas wrapper does) and returns float32: on the CPU, bitwise its
    plain twin on the casts, one lane and lanes."""
    g = torch.Generator().manual_seed(0)
    dt = TORCH[dtype]
    for lanes in ((), (3,)):
        c = (torch.randn(lanes + (40, 6), generator=g) * 0.3).to(dt)
        r = torch.eye(6).expand(lanes + (6, 6)).contiguous().to(dt)
        s = (1.0 + torch.rand(lanes + (6,), generator=g)).to(dt)
        got = ns_chain(c, r, s, 1.0 - 1e-6)
        want = ns_chain_reference(c.float(), r.float(), s.float(),
                                  1.0 - 1e-6)
        for a, b in zip(got, want):
            assert a.dtype == torch.float32
            assert torch.equal(a, b)


def test_float16_checkpoints_cross_both_ways(x, tmp_path):
    j = lc.Corex(n_hidden=4, seed=0, dtype="float16").fit(x)
    JC.save_corex(j, str(tmp_path / "jax.npz"))
    c = TC.load_corex(str(tmp_path / "jax.npz"), device="cpu")
    assert c.ws.dtype == torch.float16
    assert np.array_equal(c.ws.numpy(), np.asarray(j.ws))
    assert c.tc == float(j.tc)
    assert np.array_equal(c.transform(x).view(np.int16),
                          np.asarray(j.transform(x)).view(np.int16))

    t = lct.Corex(n_hidden=4, seed=0, dtype="float16", device="cpu").fit(x)
    TC.save_corex(t, str(tmp_path / "port.npz"))
    k = JC.load_corex(str(tmp_path / "port.npz"))
    assert str(k.ws.dtype) == "float16"
    assert np.array_equal(np.asarray(k.ws), t.ws.numpy())
    assert float(k.tc) == t.tc
    assert np.array_equal(np.asarray(k.clusters), t.clusters)


def test_bfloat16_checkpoint_bytes_equal_and_both_loads_raise(x, tmp_path):
    """The port saves a bfloat16 model as the same bytes as the JAX
    package: every array of the archive, the 2-byte words under the
    header descr '<V2' (the zip container differs only in its time
    stamps). np.load reads such arrays back as void, and both packages'
    load_corex raise ValueError on the file: a fault of the reference,
    kept for parity (ROADMAP Queue 3)."""
    j = lc.Corex(n_hidden=4, seed=0, dtype="bfloat16").fit(x)
    JC.save_corex(j, str(tmp_path / "jax.npz"))
    state = {"ws": np.asarray(j.ws), "theta_mean": np.asarray(j.theta.mean),
             "theta_std": np.asarray(j.theta.std)}
    state.update({f"mom_{k}": np.asarray(v)
                  for k, v in j.moments._asdict().items()})
    c = lct.corex_from_numpy(state, n_samples=300, n_hidden=4, seed=0,
                             dtype="bfloat16", device="cpu")
    TC.save_corex(c, str(tmp_path / "port.npz"))
    with zipfile.ZipFile(tmp_path / "jax.npz") as a, \
            zipfile.ZipFile(tmp_path / "port.npz") as b:
        assert a.namelist() == b.namelist()
        for name in a.namelist():
            assert a.read(name) == b.read(name), name
        assert b"'descr': '<V2'" in b.read("ws.npy")
    with np.load(tmp_path / "port.npz") as z:
        assert z["ws"].dtype.kind == "V"
        assert json.loads(bytes(z["meta_json"]).decode())["config"][
            "dtype"] == "bfloat16"
    for path in ("jax.npz", "port.npz"):
        with pytest.raises(ValueError):
            JC.load_corex(str(tmp_path / path))
        with pytest.raises(ValueError, match="bfloat16"):
            TC.load_corex(str(tmp_path / path), device="cpu")


@pytest.mark.parametrize("dtype", DTYPES)
def test_jax_half_arrays_cross_into_the_port(dtype):
    """A JAX array of a half dtype, as numpy (`ml_dtypes.bfloat16` for
    bfloat16), becomes a port tensor of the same dtype, bit for bit."""
    import jax.numpy as jnp
    a = np.asarray(jnp.asarray(np.linspace(-3, 3, 24).reshape(4, 6),
                               dtype))
    c = lct.Corex(n_hidden=2, dtype=dtype, device="cpu")
    t = c._as_tensor(a)
    assert t.dtype == TORCH[dtype]
    assert np.array_equal(t.view(torch.int16).numpy(), a.view(np.int16))
