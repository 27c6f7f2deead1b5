"""The port's build directory policy and deploy-time warmups
(`linearcorex_tpu_torch/utils/compile_cache.py`, `Corex.warmup`,
`models.selection.warmup_sweep`) against the JAX package's.

A warmup runs a call's programs once on synthetic operands; what follows
it must be the call without it, bit for bit, on the same seeded data: fit
(every operand mode, both strategies, both optimizers, spectral init,
stage_subsample, restart lanes, overlap), serving, the selection sweep,
and the mesh forms in a four-rank gloo world. The model stays as it was
and no random stream moves. Each argument set that makes the JAX
package's warmups raise makes the port's raise the same exception type,
and each set one accepts the other accepts. The port runs on
`device="cpu"`.

This module does not import JAX at its top: the world's ranks import it.
"""

import datetime
import hashlib
import os
import pathlib
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

import linearcorex_tpu_torch as lct
from linearcorex_tpu_torch.ops import moments as TM
from linearcorex_tpu_torch.parallel import sharding as S
from linearcorex_tpu_torch.parallel.launch import run_world
from linearcorex_tpu_torch.utils import build
from linearcorex_tpu_torch.utils import compile_cache as CC

# One intra-op thread: the suite runs its files in parallel worker
# processes, and an OpenMP pool per process on every core slows the
# small tensors here several times over.
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
N, P, M = 256, 32, 4
KW = dict(device="cpu", n_hidden=M, max_iter=60, seed=0)
WORLD = 4
WORLD_TIMEOUT = 480.0
VAR = S.ShardingPlan(shard_samples=False, shard_vars=True)
FACTOR = S.ShardingPlan(shard_samples=False, shard_factors=True)


def block_data(n=N, p=P, m=M, seed=0, strength=0.9):
    """`tests.conftest.block_data`, copied: that module imports JAX."""
    rng = np.random.RandomState(seed)
    z = rng.normal(size=(n, m))
    k = p // m
    x = np.empty((n, p))
    for j in range(m):
        for i in range(k):
            x[:, j * k + i] = strength * z[:, j] + np.sqrt(
                1.0 - strength ** 2) * rng.normal(size=n)
    return x


def _raised(fn):
    """The name of the exception type `fn` raises, or None."""
    try:
        fn()
    except Exception as e:   # the parent compares the type
        return type(e).__name__
    return None


def _snapshot(model):
    """Every attribute of `model`, tensors (and tuples of them) cloned."""
    def copy(v):
        if isinstance(v, torch.Tensor):
            return v.clone()
        if isinstance(v, tuple):
            return type(v)(*map(copy, v)) if hasattr(v, "_fields") \
                else tuple(map(copy, v))
        return v
    return {k: copy(v) for k, v in vars(model).items()}


def _same(a, b):
    """Bitwise equality of snapshots, tensors, tuples and plain values."""
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype \
            and torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(map(_same, a, b))
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b)
    return a == b


def _fit_bits(model):
    d = model.diagnostics
    return (model.ws, model.tc, d.iters_per_stage, d.tc_per_stage,
            model.theta, model.moments)


def _rng_state():
    return torch.get_rng_state(), np.random.get_state()[1].copy()


@pytest.fixture
def fresh_cache(monkeypatch):
    """The policy's module state and environment as in a new process; the
    previous state comes back after the test."""
    monkeypatch.setattr(CC, "_cache_dir", None)
    monkeypatch.setattr(CC, "_private_dir", None)
    monkeypatch.setattr(CC, "_warned", False)
    monkeypatch.delenv("LINEARCOREX_TPU_CACHE_DIR", raising=False)
    monkeypatch.delenv("LINEARCOREX_TPU_NO_COMPILE_CACHE", raising=False)
    return monkeypatch


# -- ensure_compile_cache's policy -------------------------------------------

def test_default_is_the_package_build_directory(fresh_cache):
    """On by default, on the CPU too: the package's own _build/."""
    assert CC.ensure_compile_cache() == str(build.BUILD_DIR)
    assert build._library_path("ns_chain").parent == build.BUILD_DIR
    assert build._host_library_path().parent == build.BUILD_DIR


def test_cache_dir_is_respected_and_the_call_idempotent(fresh_cache,
                                                        tmp_path):
    first = tmp_path / "first"
    assert CC.ensure_compile_cache(str(first)) == str(first)
    assert not first.exists()              # decided; made by the first build
    # an earlier call's directory is kept, whatever a later one asks
    assert CC.ensure_compile_cache(str(tmp_path / "second")) == str(first)
    fresh_cache.setenv("LINEARCOREX_TPU_CACHE_DIR", str(tmp_path / "env"))
    assert CC.ensure_compile_cache() == str(first)
    assert not (tmp_path / "second").exists()
    assert CC.build_dir() == first and first.is_dir()


def test_environment_variable_moves_the_directory(fresh_cache, tmp_path):
    target = tmp_path / "shared" / "cache"
    fresh_cache.setenv("LINEARCOREX_TPU_CACHE_DIR", str(target))
    assert CC.ensure_compile_cache() == str(target)
    assert build._library_path("ns_chain").parent == target
    assert target.is_dir()


def test_a_fit_decides_the_directory(fresh_cache, tmp_path):
    """Every fit-shaped entry point calls ensure_compile_cache; a fit that
    builds nothing leaves the file system alone. (The seeded start's host
    library is loaded first, as an earlier fit of the process leaves it,
    so that the result does not depend on which files ran before it.)"""
    from linearcorex_tpu_torch.ops import seeded
    seeded.load()
    fresh_cache.setattr(CC, "_cache_dir", None)
    fresh_cache.setenv("LINEARCOREX_TPU_CACHE_DIR", str(tmp_path / "fit"))
    lct.Corex(**dict(KW, max_iter=5)).fit(block_data())
    assert CC._cache_dir == str(tmp_path / "fit")
    assert not (tmp_path / "fit").exists()


def test_opt_out_builds_into_a_private_directory(fresh_cache):
    fresh_cache.setenv("LINEARCOREX_TPU_NO_COMPILE_CACHE", "1")
    assert CC.ensure_compile_cache() is None
    private = CC.build_dir()
    assert private.is_dir() and private != build.BUILD_DIR
    assert CC.build_dir() == private            # one per process
    assert build._library_path("ns_chain").parent == private
    assert CC._cache_dir is None                # nothing decided for later


def test_unwritable_directory_warns_once_and_returns_none(fresh_cache,
                                                          tmp_path):
    blocker = tmp_path / "a_file"
    blocker.write_text("")
    fresh_cache.setenv("LINEARCOREX_TPU_CACHE_DIR", str(blocker / "sub"))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert CC.ensure_compile_cache() is None   # a fit does not warn
    with pytest.warns(UserWarning, match="LINEARCOREX_TPU_CACHE_DIR"):
        private = CC.build_dir()                   # the first build does
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert CC.ensure_compile_cache() is None
        assert CC.build_dir() == private           # warned once only
    assert private.is_dir() and private.parent != blocker


@pytest.mark.skipif(build.find_cxx() is None, reason="needs g++ on PATH")
@pytest.mark.parametrize("opt_out", [False, True])
def test_build_host_writes_into_the_chosen_directory(fresh_cache, tmp_path,
                                                     opt_out):
    if opt_out:
        fresh_cache.setenv("LINEARCOREX_TPU_NO_COMPILE_CACHE", "1")
    else:
        fresh_cache.setenv("LINEARCOREX_TPU_CACHE_DIR", str(tmp_path))
    before = len(build.COMPILES)
    rec = build.build_host()
    path = pathlib.Path(rec["path"])
    assert path.is_file()
    assert path.parent == (CC.build_dir() if opt_out else tmp_path)
    assert build.COMPILES[before:] == [
        {"what": " + ".join(build.HOST_SOURCES), "path": rec["path"],
         "seconds": rec["seconds"]}]
    # a second call reuses the library and compiles nothing
    assert build.build_host()["seconds"] == 0.0
    assert len(build.COMPILES) == before + 1


# -- warmup, then fit: bitwise the fit without the warmup --------------------

FIT_CASES = {
    "gram_fixed_point": dict(optimizer="fixed_point"),
    "samples_momentum": dict(moment_strategy="samples"),
    "auto": dict(optimizer="auto"),
    "bfloat16": dict(matmul_dtype="bfloat16"),
    "int8": dict(matmul_dtype="int8"),
    "int8_samples": dict(matmul_dtype="int8", moment_strategy="samples"),
    "spectral": dict(init="spectral", anneal=False),
    "stage_subsample": dict(stage_subsample=0.5, moment_strategy="samples"),
    "restarts": dict(n_restarts=3),
    "overlap": dict(discourage_overlap=False),
    "empirical": dict(gaussianize="empirical"),
}


@pytest.mark.parametrize("case,dtype", [
    (case, dtype) for case in sorted(FIT_CASES)
    for dtype in ("float32", "float64")
    # matmul_dtype='int8' requires dtype='float32' (CorexConfig raises)
    if not (dtype == "float64" and "int8" in case)])
def test_warmup_then_fit_is_the_fit(case, dtype):
    kw = dict(KW, dtype=dtype, **FIT_CASES[case])
    x = block_data()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        plain = lct.Corex(**kw).fit(x)
        warmed = lct.Corex(**kw)
        before, rng = _snapshot(warmed), _rng_state()
        assert warmed.warmup(N, P) is warmed
        assert _same(_snapshot(warmed), before)      # still unfitted
        assert warmed.ws is None and warmed.nv is None
        assert _same(_rng_state(), rng)
        warmed.fit(x)
    assert _same(_fit_bits(warmed), _fit_bits(plain))
    assert warmed.best_restart_ == plain.best_restart_


def test_warmup_leaves_a_fitted_model_as_it_was():
    x = block_data()
    model = lct.Corex(**KW).fit(x)
    before = _snapshot(model)
    model.warmup(2 * N, P)
    assert _same(_snapshot(model), before)


def test_warmup_never_runs_the_int8_wrap_guard(monkeypatch):
    """The guard's verdict is data-dependent: on synthetic values it would
    fire or warn where the JAX package's warmup (which runs no data) never
    does. The fit still runs it."""
    calls = []
    monkeypatch.setattr(TM, "_check_int8_wrap", calls.append)
    model = lct.Corex(**dict(KW, matmul_dtype="int8"))
    for moment_strategy in ("gram", "samples"):
        model.set_params(moment_strategy=moment_strategy).warmup(N, P)
    assert calls == []
    model.fit(block_data())
    assert len(calls) == 1


def test_warmup_rejects_what_the_fit_rejects():
    """A warmup never runs a program the fit would refuse."""
    with pytest.raises(ValueError, match="n_restarts must be"):
        lct.Corex(**dict(KW, n_restarts=0)).warmup(N, P)
    with pytest.raises(ValueError, match="matmul_precision"):
        lct.Corex(**dict(KW, matmul_precision="TF32_TF32_F32")).warmup(N, P)
    with pytest.raises(ValueError, match="stage_subsample"):
        lct.Corex(**dict(KW, n_restarts=2, stage_subsample=0.5,
                         moment_strategy="samples")).warmup(N, P)


def _programs(monkeypatch):
    """Record every fit program (`_fit_program`, with the operand's type,
    shape and dtype, W0's shape, the strategy and the config but its
    max_iter), spectral init and held-out scoring that runs from now on."""
    import dataclasses

    from linearcorex_tpu_torch.models import corex as TC
    from linearcorex_tpu_torch.models import selection as TS
    runs = []

    def record(name, fn):
        def wrapped(*args, **kwargs):
            runs.append((name,) + describe(*args))
            return fn(*args, **kwargs)
        return wrapped

    def describe(data, *rest):
        op = getattr(data, "q", data)
        out = (type(data).__name__, tuple(op.shape), op.dtype)
        if rest and isinstance(rest[0], torch.Tensor):
            out += (tuple(rest[0].shape),)
        for r in rest[1:]:
            out += ((dataclasses.replace(r, max_iter=1)
                     if dataclasses.is_dataclass(r) else r),)
        return out

    monkeypatch.setattr(TC, "_fit_program",
                        record("fit", TC._fit_program))
    monkeypatch.setattr(TC, "_spectral_init",
                        record("spectral", TC._spectral_init))
    monkeypatch.setattr(TS, "_score_lanes", record("score", TS._score_lanes))
    return runs


@pytest.mark.parametrize("case", sorted(FIT_CASES))
def test_warmup_runs_the_fits_programs(monkeypatch, case):
    """The warmup runs the programs the fit runs, in the fit's order, on
    operands of the fit's types, shapes and dtypes under the fit's config
    (one iteration a stage)."""
    kw = dict(KW, **FIT_CASES[case])
    runs = _programs(monkeypatch)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        lct.Corex(**kw).warmup(N, P)
        warmed, runs[:] = list(runs), []
        lct.Corex(**kw).fit(block_data())
    assert warmed == runs and any(r[0] == "fit" for r in runs)


@pytest.mark.parametrize("criterion", ["tc", "heldout"])
def test_warmup_sweep_runs_the_sweeps_programs(monkeypatch, criterion):
    kw = dict(repeat=2, max_n_hidden=5, max_iter=60, seed=0,
              criterion=criterion, device="cpu")
    runs = _programs(monkeypatch)
    lct.warmup_sweep(N, P, **kw)
    warmed, runs[:] = list(runs), []
    lct.pick_n_hidden(block_data(), **kw)
    assert warmed == runs and runs[0][0] == "fit"
    assert (runs[-1][0] == "score") == (criterion == "heldout")


# -- serving -----------------------------------------------------------------

def _serve(model, x):
    y = model.transform(x)
    out = [y, model.predict(y), model.covariance_matmat(np.eye(P)[:, :3]),
           [r for _, r in model.covariance_blocks(8)]]
    if model.gaussianize in ("none", "standard"):
        out.append(model.score(x))
    return out


@pytest.mark.parametrize("gaussianize", ["standard", "none", "empirical"])
@pytest.mark.parametrize("overlap", [False, True])
def test_warmup_serving_then_serve_is_the_serving(gaussianize, overlap):
    x = block_data()
    kw = dict(KW, gaussianize=gaussianize, discourage_overlap=not overlap)
    model = lct.Corex(**kw).fit(x)
    plain = _serve(model, x[:50])
    before, rng = _snapshot(model), _rng_state()
    lct.warmup_serving(model, 50, matmat_k=3, cov_block=8)
    assert _same(_snapshot(model), before)
    assert _same(_rng_state(), rng)
    assert _same(_serve(model, x[:50]), plain)


def test_warmup_serving_before_any_fit():
    x = block_data()
    model = lct.Corex(**KW)
    lct.warmup_serving(model, 50, n_variables=P, matmat_k=3, cov_block=8)
    assert model.ws is None and model.nv is None
    plain = lct.Corex(**KW).fit(x)
    assert _same(_serve(model.fit(x), x[:50]), _serve(plain, x[:50]))


def test_warmup_serving_requires_a_width():
    with pytest.raises(ValueError, match="n_variables is required"):
        lct.warmup_serving(lct.Corex(**KW), 10)


# -- selection ---------------------------------------------------------------

@pytest.mark.parametrize("criterion", ["tc", "heldout"])
def test_warmup_sweep_then_sweep_is_the_sweep(criterion):
    x = block_data()
    kw = dict(repeat=2, max_n_hidden=5, max_iter=60, seed=0,
              criterion=criterion, device="cpu")
    plain = lct.pick_n_hidden(x, **kw)
    rng = _rng_state()
    assert lct.warmup_sweep(N, P, verbose=True, tc_gain_tol=0.5,
                            **kw) is None
    assert _same(_rng_state(), rng)
    warmed = lct.pick_n_hidden(x, **kw)
    assert warmed[0] == plain[0]
    assert np.array_equal(warmed[1], plain[1])


# -- against the JAX package: the same rejects, the same accepted sets -------

def _jax_mesh(*axes):
    from linearcorex_tpu.parallel.sharding import make_mesh
    return make_mesh(tuple(axes))


def _jax_plan(**kw):
    from linearcorex_tpu.parallel.sharding import ShardingPlan
    return ShardingPlan(**kw)


# (case, port call, JAX call); no mesh: both run here
SINGLE = {
    "serving_unfitted_no_width": (
        lambda: lct.warmup_serving(lct.Corex(n_hidden=4, device="cpu"), 10),
        lambda lc: lc.warmup_serving(lc.Corex(n_hidden=4), 10)),
    "sweep_not_padded": (
        lambda: lct.warmup_sweep(64, 16, padded_sweep=False, device="cpu"),
        lambda lc: lc.warmup_sweep(64, 16, padded_sweep=False)),
    "sweep_unknown_criterion": (
        lambda: lct.warmup_sweep(64, 16, criterion="bic", device="cpu"),
        lambda lc: lc.warmup_sweep(64, 16, criterion="bic")),
    "sweep_data_axis_without_mesh": (
        lambda: lct.warmup_sweep(64, 16, data_axis="data", device="cpu"),
        lambda lc: lc.warmup_sweep(64, 16, data_axis="data")),
    "sweep_spectral": (
        lambda: lct.warmup_sweep(64, 16, init="spectral", device="cpu"),
        lambda lc: lc.warmup_sweep(64, 16, init="spectral")),
    "sweep_n_restarts": (
        lambda: lct.warmup_sweep(64, 16, n_restarts=2, device="cpu"),
        lambda lc: lc.warmup_sweep(64, 16, n_restarts=2)),
    "sweep_heldout_fraction": (
        lambda: lct.warmup_sweep(64, 16, criterion="heldout",
                                 val_fraction=1.5, device="cpu"),
        lambda lc: lc.warmup_sweep(64, 16, criterion="heldout",
                                   val_fraction=1.5)),
    "sweep_heldout_empirical": (
        lambda: lct.warmup_sweep(64, 16, criterion="heldout",
                                 gaussianize="empirical", device="cpu"),
        lambda lc: lc.warmup_sweep(64, 16, criterion="heldout",
                                   gaussianize="empirical")),
    "restarts_with_warm_start": (
        lambda: lct.warmup_fit(lct.Corex(
            n_hidden=4, n_restarts=2, pretrained_weights=np.zeros((4, 16)),
            device="cpu"), 64, 16),
        lambda lc: lc.warmup_fit(lc.Corex(
            n_hidden=4, n_restarts=2, pretrained_weights=np.zeros((4, 16))),
            64, 16)),
    "restarts_with_stage_subsample": (
        lambda: lct.warmup_fit(lct.Corex(
            n_hidden=4, n_restarts=2, stage_subsample=0.5,
            moment_strategy="samples", device="cpu"), 64, 16),
        lambda lc: lc.warmup_fit(lc.Corex(
            n_hidden=4, n_restarts=2, stage_subsample=0.5,
            moment_strategy="samples"), 64, 16)),
    "bad_n_restarts": (
        lambda: lct.warmup_fit(lct.Corex(n_hidden=4, n_restarts=0,
                                         device="cpu"), 64, 16),
        lambda lc: lc.warmup_fit(lc.Corex(n_hidden=4, n_restarts=0), 64,
                                 16)),
    # accepted by both (the JAX package compiles these small programs)
    "accepted_fit": (
        lambda: lct.warmup_fit(lct.Corex(n_hidden=4, device="cpu"), 64, 16),
        lambda lc: lc.warmup_fit(lc.Corex(n_hidden=4), 64, 16)),
    "accepted_serving": (
        lambda: lct.warmup_serving(lct.Corex(n_hidden=4, device="cpu"), 10,
                                   n_variables=16),
        lambda lc: lc.warmup_serving(lc.Corex(n_hidden=4), 10,
                                     n_variables=16)),
    "accepted_sweep": (
        lambda: lct.warmup_sweep(64, 16, repeat=2, max_n_hidden=2,
                                 device="cpu"),
        lambda lc: lc.warmup_sweep(64, 16, repeat=2, max_n_hidden=2)),
}


@pytest.mark.parametrize("case", sorted(SINGLE))
def test_single_device_raises_as_the_jax_package(case):
    import linearcorex_tpu as lc
    port_call, jax_call = SINGLE[case]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = _raised(lambda: jax_call(lc))
        got = _raised(port_call)
    assert got == want, (case, got, want)
    assert (want is None) == case.startswith("accepted")


# the mesh cases: the port's side runs in the world (`_mesh_rejects`)
MESH_JAX = {
    "subsample_under_mesh": lambda lc: lc.warmup_fit(
        lc.Corex(n_hidden=4, stage_subsample=0.5), 64, 16,
        mesh=_jax_mesh(("data", 8))),
    "restarts_under_var_plan": lambda lc: lc.warmup_fit(
        lc.Corex(n_hidden=4, n_restarts=2), 64, 16,
        mesh=_jax_mesh(("restarts", 2), ("var", 4)),
        sharding_plan=_jax_plan(shard_samples=False, shard_vars=True)),
    "restarts_without_restart_axis": lambda lc: lc.warmup_fit(
        lc.Corex(n_hidden=4, n_restarts=2), 64, 16,
        mesh=_jax_mesh(("data", 8))),
    "rows_not_divisible": lambda lc: lc.warmup_fit(
        lc.Corex(n_hidden=4), 63, 16, mesh=_jax_mesh(("data", 8))),
    "serving_rows_not_divisible": lambda lc: lc.warmup_serving(
        lc.Corex(n_hidden=4), 10, n_variables=16,
        mesh=_jax_mesh(("data", 8))),
    "sweep_without_restart_axis": lambda lc: lc.warmup_sweep(
        64, 16, mesh=_jax_mesh(("data", 8))),
    "sweep_rows_not_divisible": lambda lc: lc.warmup_sweep(
        63, 16, mesh=_jax_mesh(("restarts", 2), ("data", 4)),
        data_axis="data"),
    "accepted_mesh_fit": lambda lc: lc.warmup_fit(
        lc.Corex(n_hidden=4), 64, 16, mesh=_jax_mesh(("data", 8))),
}


def _mesh_rejects(mesh_of):
    """The port's side of MESH_JAX, on this world's meshes (4 ranks where
    the JAX package's meshes have 8 devices: each case fails, or passes,
    for the same reason)."""
    data4 = mesh_of(("data", 4))
    cpu = dict(n_hidden=4, device="cpu")
    return {
        "subsample_under_mesh": _raised(lambda: lct.warmup_fit(
            lct.Corex(stage_subsample=0.5, **cpu), 64, 16, mesh=data4)),
        "restarts_under_var_plan": _raised(lambda: lct.warmup_fit(
            lct.Corex(n_restarts=2, **cpu), 64, 16,
            mesh=mesh_of(("restarts", 1), ("var", 4)), sharding_plan=VAR)),
        "restarts_without_restart_axis": _raised(lambda: lct.warmup_fit(
            lct.Corex(n_restarts=2, **cpu), 64, 16, mesh=data4)),
        "rows_not_divisible": _raised(lambda: lct.warmup_fit(
            lct.Corex(**cpu), 63, 16, mesh=data4)),
        "serving_rows_not_divisible": _raised(lambda: lct.warmup_serving(
            lct.Corex(**cpu), 10, n_variables=16, mesh=data4)),
        "sweep_without_restart_axis": _raised(lambda: lct.warmup_sweep(
            64, 16, mesh=data4, device="cpu")),
        "sweep_rows_not_divisible": _raised(lambda: lct.warmup_sweep(
            63, 16, mesh=mesh_of(("restarts", 2), ("data", 2)),
            data_axis="data", device="cpu")),
        "accepted_mesh_fit": _raised(lambda: lct.warmup_fit(
            lct.Corex(**cpu), 64, 16, mesh=data4)),
    }


# -- the mesh forms: a four-rank gloo world ----------------------------------

# (case, mesh axes, plan or None, Corex kwargs)
MESH_FITS = {
    "data": ((("data", 4),), None, {}),
    "data_float64": ((("data", 4),), None, dict(dtype="float64")),
    "data_int8": ((("data", 4),), None, dict(matmul_dtype="int8")),
    "data_spectral": ((("data", 4),), None,
                      dict(init="spectral", anneal=False)),
    "var_gram": ((("var", 4),), VAR, {}),
    "var_samples": ((("var", 4),), VAR, dict(moment_strategy="samples")),
    "factor": ((("model", 4),), FACTOR, {}),
    "restarts": ((("restarts", 4),), None, dict(n_restarts=3)),
    "restarts_x_data": ((("restarts", 2), ("data", 2)), None,
                        dict(n_restarts=2)),
}


def _world(rank):
    """Runs on every rank. Returns {case: result}; rank 0's results are
    asserted, and `digest` (a hash of every fitted W) is compared across
    ranks."""
    warnings.simplefilter("ignore")
    timeout = datetime.timedelta(seconds=WORLD_TIMEOUT)

    def mesh_of(*axes):
        return S.make_mesh(tuple(axes), device="cpu", timeout=timeout)

    x = block_data()
    out, digest = {}, hashlib.sha1()
    for case, (axes, plan, extra) in MESH_FITS.items():
        mesh = mesh_of(*axes)
        kw = dict(KW, **extra)
        plain = lct.Corex(**kw).fit(x, mesh=mesh, sharding_plan=plan)
        warmed = lct.Corex(**kw)
        before, rng = _snapshot(warmed), _rng_state()
        S.reset_collective_counts()
        warmed.warmup(N, P, mesh=mesh, sharding_plan=plan)
        counted = sum(S.collective_counts().values())
        untouched = _same(_snapshot(warmed), before) \
            and _same(_rng_state(), rng)
        warmed.fit(x, mesh=mesh, sharding_plan=plan)
        out[case] = dict(bitwise=_same(_fit_bits(warmed), _fit_bits(plain)),
                         untouched=untouched, collectives=counted)
        digest.update(warmed.ws.numpy().tobytes())

    # serving under the data and var plans
    for case, axes, plan in (("serving_data", (("data", 4),), None),
                             ("serving_var", (("var", 4),), VAR)):
        mesh = mesh_of(*axes)
        model = lct.Corex(**KW).fit(x, mesh=mesh, sharding_plan=plan)

        def serve():
            y = model.transform(x, mesh=mesh)
            out_ = [y, model.score(x, mesh=mesh),
                    model.predict(y, mesh=mesh),
                    model.covariance_matmat(np.eye(P)[:, :2], mesh=mesh),
                    next(model.covariance_blocks(8, mesh=mesh))[1]]
            return [t.to_local() if hasattr(t, "to_local") else t
                    for t in out_]
        plain = serve()
        before = _snapshot(model)
        S.reset_collective_counts()
        lct.warmup_serving(model, N, matmat_k=2, cov_block=8, mesh=mesh,
                           sharding_plan=plan)
        counted = sum(S.collective_counts().values())
        untouched = _same(_snapshot(model), before)
        out[case] = dict(bitwise=_same(serve(), plain), untouched=untouched,
                         collectives=counted)

    # the selection sweep over the restarts axis, and restarts x data
    for case, axes, data_axis in (("sweep", (("restarts", 4),), None),
                                  ("sweep_x_data",
                                   (("restarts", 2), ("data", 2)), "data")):
        mesh = mesh_of(*axes)
        kw = dict(repeat=2, max_n_hidden=4, max_iter=60, seed=0, mesh=mesh,
                  data_axis=data_axis, device="cpu")
        plain = lct.pick_n_hidden(x, **kw)
        S.reset_collective_counts()
        lct.warmup_sweep(N, P, **kw)
        counted = sum(S.collective_counts().values())
        warmed = lct.pick_n_hidden(x, **kw)
        out[case] = dict(bitwise=warmed[0] == plain[0]
                         and np.array_equal(warmed[1], plain[1]),
                         untouched=True, collectives=counted)
        digest.update(np.asarray(warmed[1]).tobytes())

    out["rejects"] = _mesh_rejects(mesh_of)
    out["digest"] = digest.hexdigest()
    return out if rank == 0 else {"digest": out["digest"]}


@pytest.fixture(scope="module")
def world():
    ranks = run_world(_world, WORLD, backend="gloo", timeout=WORLD_TIMEOUT)
    res = ranks[0]
    res["all_digests"] = [r["digest"] for r in ranks]
    return res


@pytest.mark.parametrize("case", sorted(MESH_FITS) + [
    "serving_data", "serving_var", "sweep", "sweep_x_data"])
def test_mesh_warmup_then_call_is_the_call(world, case):
    """On every rank: the warmup leaves the model and the random streams as
    they were, sends its collectives (counted), and the fit, serving call
    or sweep after it is the unwarmed one bit for bit."""
    res = world[case]
    assert res["bitwise"] and res["untouched"], res
    assert res["collectives"] > 0


def test_mesh_ranks_agree(world):
    assert len(set(world["all_digests"])) == 1


@pytest.mark.parametrize("case", sorted(MESH_JAX))
def test_mesh_raises_as_the_jax_package(world, case):
    import linearcorex_tpu as lc
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = _raised(lambda: MESH_JAX[case](lc))
    assert world["rejects"][case] == want, case
    assert (want is None) == case.startswith("accepted")


# -- the deploy example ------------------------------------------------------

def test_deploy_example_runs_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT),
               LINEARCOREX_TPU_CACHE_DIR=str(tmp_path / "cache"))
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "torch_deploy_warmup.py"),
         "--out", str(tmp_path / "model.npz")],
        capture_output=True, text=True, timeout=600, cwd=str(tmp_path),
        env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "transform (" in proc.stdout
    assert (tmp_path / "model.npz").is_file()
