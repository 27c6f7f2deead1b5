"""The port's host C++ library (`linearcorex_tpu_torch/utils/native.py`,
built by g++ from `linearcorex_tpu_torch/csrc/*.cpp`) against scipy and
numpy to 1e-12, against the JAX package's `utils.native` bitwise, and the
pure-Python text reader against the native one. The two copies of each
copied C++ source are held byte-identical (`csrc/seeded_normal.cpp` is
the port's own, held to NumPy by `tests/test_torch_seeded_normal.py`).
"""

import pathlib

import numpy as np
import pytest
import torch
from scipy.stats import norm, rankdata

import linearcorex_tpu_torch as lct
from linearcorex_tpu.utils import native as jnative
from linearcorex_tpu_torch.utils import build
from linearcorex_tpu_torch.utils import native
from linearcorex_tpu_torch.utils import streaming as S

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]

needs_native = pytest.mark.skipif(
    not native.available(), reason="no C++ compiler: host library not built")


# the host sources copied from `native/`
COPIED_SOURCES = ("gaussianize.cpp", "loader.cpp")


@pytest.mark.parametrize("name", COPIED_SOURCES)
def test_cpp_copies_are_byte_identical(name):
    ours = (build.CSRC_DIR / name).read_bytes()
    assert ours == (ROOT / "native" / name).read_bytes()


def test_host_library_is_the_ports_own_build():
    """Built with the Makefile's flags, no contraction into fused
    multiply-adds and threads, into _build/ under a hashed name; the
    library under native/ is never the one loaded."""
    assert set(build.HOST_FLAGS) == {"-O3", "-fPIC", "-shared",
                                     "-std=c++17", "-ffp-contract=off",
                                     "-pthread"}
    assert set(COPIED_SOURCES) < set(build.HOST_SOURCES)
    path = build._host_library_path()
    assert path.parent == build.BUILD_DIR
    assert path.name.startswith("liblcx_host_") and path.suffix == ".so"
    if native.available():
        assert path.is_file()
        assert native.get_lib()._name == str(path)


def test_only_a_missing_compiler_means_unavailable(monkeypatch, tmp_path):
    """No g++: `available()` is False and nothing raises. A g++ that fails
    on the sources raises with its log instead of passing for absent."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(build, "find_cxx", lambda: None)
    assert native.get_lib() is None and not native.available()
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        build.build_host()

    failing = tmp_path / "g++"
    failing.write_text("#!/bin/sh\necho 'loader.cpp: broken' >&2\nexit 1\n")
    failing.chmod(0o755)
    monkeypatch.setattr(build, "find_cxx", lambda: str(failing))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(
        build, "_host_library_path",
        lambda: tmp_path / "_build" / "liblcx_host_broken.so")
    with pytest.raises(RuntimeError, match="loader.cpp: broken"):
        native.available()


@needs_native
def test_ndtri_matches_scipy_and_jax_native():
    p = np.linspace(1e-12, 1 - 1e-12, 10001)
    got = native.ndtri(p)
    assert np.abs(got - norm.ppf(p)).max() < 1e-12
    if jnative.available():
        assert np.array_equal(got, jnative.ndtri(p))


@needs_native
def test_empirical_gaussianize_matches_scipy_and_jax_native():
    rng = np.random.RandomState(0)
    x = rng.lognormal(size=(500, 7))
    x[::13, 2] = x[0, 2]  # inject ties
    got = native.empirical_gaussianize(x)
    want = np.empty_like(x)
    for j in range(x.shape[1]):
        want[:, j] = norm.ppf((rankdata(x[:, j]) - 0.5) / x.shape[0])
    assert np.abs(got - want).max() < 1e-12
    if jnative.available():
        assert np.array_equal(got, jnative.empirical_gaussianize(x))


@needs_native
@pytest.mark.parametrize("sentinel", [-999.0, float("nan")])
def test_mean_impute_matches_numpy_and_jax_native(sentinel):
    rng = np.random.RandomState(1)
    x = rng.normal(size=(200, 5))
    x[::7, 1] = sentinel
    x[:, 4] = sentinel  # fully missing column → zeros
    got = native.mean_impute(x, sentinel)
    ref = x.copy()
    for j in range(5):
        mask = np.isnan(ref[:, j]) if sentinel != sentinel \
            else ref[:, j] == sentinel
        obs = ref[~mask, j]
        ref[mask, j] = obs.mean() if obs.size else 0.0
    assert np.abs(got - ref).max() < 1e-12
    if jnative.available():
        assert np.array_equal(got, jnative.mean_impute(x, sentinel))


@needs_native
@pytest.mark.parametrize("missing", [None, -999.0])
def test_host_preprocess_matches_device_path(missing):
    """The native 'empirical' route for NumPy inputs on the CPU against
    the torch route a tensor input takes: preprocessed rows and theta
    within 1e-9, and the float64 fits alike."""
    rng = np.random.RandomState(3)
    x = rng.lognormal(size=(400, 24))
    if missing is not None:
        x[::9, 3] = missing
    kw = dict(n_hidden=4, gaussianize="empirical", dtype="float64",
              missing_values=missing, device="cpu")
    host = lct.Corex(**kw)._host_preprocess(x)
    assert host is not None
    from linearcorex_tpu_torch.ops import preprocessing as P
    xp, theta = P.fit_preprocess(torch.as_tensor(x), "empirical", missing)
    assert (host[0] - xp).abs().max() < 1e-9
    assert (host[1].mean - theta.mean).abs().max() < 1e-9
    assert (host[1].std - theta.std).abs().max() < 1e-9
    w0 = rng.normal(scale=1 / np.sqrt(24), size=(4, 24))
    c_host = lct.Corex(**kw).fit(x, init_ws=w0)
    c_dev = lct.Corex(**kw).fit(torch.as_tensor(x), init_ws=w0)
    assert abs(c_host.tc - c_dev.tc) < 1e-5
    assert (c_host.ws - c_dev.ws).abs().max() < 1e-3


def test_host_preprocess_rule():
    """It applies to 'empirical' NumPy inputs of a CPU model only."""
    x = np.random.RandomState(0).normal(size=(50, 4))
    assert lct.Corex(device="cpu")._host_preprocess(x) is None
    emp = lct.Corex(gaussianize="empirical", device="cpu")
    assert emp._host_preprocess(torch.as_tensor(x)) is None
    assert (emp._host_preprocess(x) is not None) == native.available()


@needs_native
def test_csv_reader_matches_loadtxt(tmp_path):
    """The native block reader reproduces np.loadtxt exactly, across
    block boundaries, a header and nan cells."""
    rng = np.random.RandomState(0)
    x = rng.normal(size=(257, 7))
    x[3, 2] = np.nan
    path = str(tmp_path / "d.csv")
    with open(path, "w") as f:
        f.write("c0,c1,c2,c3,c4,c5,c6\n")
        for row in x:
            f.write(",".join(f"{v:.17g}" for v in row) + "\n")
    with native.CsvReader(path, block_rows=100, skip_header=1) as r:
        blocks = list(r)
    assert [b.shape[0] for b in blocks] == [100, 100, 57]
    got = np.concatenate(blocks)
    want = np.loadtxt(path, delimiter=",", skiprows=1)
    assert np.array_equal(got, want, equal_nan=True)
    if jnative.available():
        theirs = np.concatenate(list(jnative.CsvReader(
            path, block_rows=100, skip_header=1)))
        assert np.array_equal(got, theirs, equal_nan=True)


@needs_native
def test_csv_reader_errors_and_close(tmp_path):
    with pytest.raises(FileNotFoundError):
        native.CsvReader(str(tmp_path / "missing.csv"))
    with pytest.raises(ValueError, match="block_rows"):
        native.CsvReader(str(tmp_path / "missing.csv"), block_rows=0)
    bad = str(tmp_path / "bad.csv")
    with open(bad, "w") as f:
        f.write("1.0,2.0\n3.0,oops\n")
    with pytest.raises(ValueError, match="unparsable"):
        list(native.CsvReader(bad, block_rows=10))
    good = str(tmp_path / "good.csv")
    with open(good, "w") as f:
        f.write("1,2\n3,4\n5,6\n")
    r = native.CsvReader(good, block_rows=1)
    assert next(r).tolist() == [[1.0, 2.0]]
    r.close()                      # abandoned iteration
    assert r._h is None
    r.close()                      # idempotent
    assert list(r) == []


def _write(tmp_path, name, text):
    p = tmp_path / name
    p.write_text(text)
    return str(p)


@pytest.fixture(params=["native", "python"])
def reader(request, monkeypatch):
    """Run a loader test through the native reader and through the
    pure-Python one."""
    if request.param == "python":
        monkeypatch.setattr(native, "available", lambda: False)
    elif not native.available():
        pytest.skip("no C++ compiler: host library not built")
    return request.param


def test_loader_space_delimited(tmp_path, reader):
    path = _write(tmp_path, "sp.txt", "1.0 2.0  3.0\n4.0 5.0 6.0\n")
    x = np.vstack(list(S.iter_text_blocks(path, delimiter=" ")))
    assert np.array_equal(x, [[1, 2, 3], [4, 5, 6]])


def test_loader_blank_crlf_lines(tmp_path, reader):
    path = _write(tmp_path, "crlf.csv", "1,2\r\n\r\n3,4\r\n\n5,6\r\n")
    x = np.vstack(list(S.iter_text_blocks(path)))
    assert np.array_equal(x, [[1, 2], [3, 4], [5, 6]])


@pytest.mark.parametrize("text", ["1,2,3\n1,,2\n", "1,2,3\n1,2\n",
                                  "1,2,\n", "1,+-5,2\n", "1,++5,2\n"],
                         ids=["empty_field", "ragged_row", "trailing",
                              "plus_minus", "double_plus"])
def test_loader_rejects(tmp_path, reader, text):
    """An empty field, a ragged row, a trailing delimiter and a double
    sign are rejected by both readers alike."""
    path = _write(tmp_path, "bad.csv", text)
    with pytest.raises(ValueError):
        list(S.iter_text_blocks(path))


@needs_native
def test_loader_python_reader_matches_native(tmp_path, monkeypatch):
    good = _write(tmp_path, "g.csv",
                  "+1, 2,3\r\n\r\n4,5 ,6e+1\n-inf,nan,1.5\n")
    spaced = _write(tmp_path, "g2.txt", "1 2  3\n4 5 6\n")
    x_native = np.vstack(list(S.iter_text_blocks(good)))
    s_native = np.vstack(list(S.iter_text_blocks(spaced, delimiter=" ")))
    monkeypatch.setattr(native, "available", lambda: False)
    x_py = np.vstack(list(S.iter_text_blocks(good, block_rows=2)))
    s_py = np.vstack(list(S.iter_text_blocks(spaced, delimiter=" ")))
    assert np.array_equal(x_native, x_py, equal_nan=True)
    assert np.array_equal(s_native, s_py, equal_nan=True)
