"""The PyTorch port's `Corex` against the JAX package's `Corex` and the
float64 oracle.

Float64 fits from the same explicit W0 must be step-matched: identical
iterations per anneal stage, identical clusters, and TC and W within 1e-8
— the gap the JAX path itself shows against the oracle. Float32 fits are
held to `tests/test_parity.py`'s float32 bars (same clusters, TC within
1e-3 relative). Data are made with numpy from a seed; the port runs on
`device="cpu"`.
"""

import dataclasses
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import linearcorex_tpu as lc
import linearcorex_tpu_torch as lct
from linearcorex_tpu.config import CorexConfig as JaxConfig
from linearcorex_tpu.oracle import OracleCorex
from linearcorex_tpu.utils.checkpoint import save_corex
from linearcorex_tpu_torch.config import CorexConfig
from linearcorex_tpu_torch.models.corex import resolve_config
from linearcorex_tpu_torch.parallel.sharding import ShardingPlan
from tests.conftest import block_data

# One intra-op thread: the suite runs its files in parallel worker
# processes, and an OpenMP pool per process on every core slows the
# small tensors here several times over.
torch.set_num_threads(1)

TOL64 = 1e-8


def _shared_init(m, p, seed=42):
    return np.random.RandomState(seed).normal(scale=1.0 / np.sqrt(p),
                                              size=(m, p))


@pytest.fixture(scope="module")
def data():
    return block_data(n=1000, p=64, m=8, seed=0)


@pytest.mark.parametrize("strategy", ["samples", "gram"])
@pytest.mark.parametrize("optimizer",
                         ["momentum", "fixed_point", "gd", "auto"])
def test_f64_fit_step_matched(strategy, optimizer, data):
    """Same W0 → the same iterations per stage, clusters, TC and W as the
    JAX package and as the float64 oracle."""
    w0 = _shared_init(8, 64)
    kw = dict(n_hidden=8, optimizer=optimizer)
    if optimizer == "gd":
        kw["max_iter"] = 300      # plain GD converges slowly; cap stages
    c = lct.Corex(dtype="float64", moment_strategy=strategy, device="cpu",
                  **kw).fit(data, init_ws=w0)
    j = lc.Corex(dtype="float64", moment_strategy=strategy, **kw).fit(
        data, init_ws=w0)
    o = OracleCorex(**kw).fit(data, init_ws=w0)
    iters = c.diagnostics.iters_per_stage.tolist()
    assert iters == np.asarray(j.diagnostics.iters_per_stage).tolist()
    assert iters == o.history["iters_per_stage"]
    assert c.resolved_optimizer_ == j.resolved_optimizer_
    assert c.n_iter_ == j.n_iter_ == sum(iters)
    for ref_tc, ref_ws, ref_cl in ((j.tc, np.asarray(j.ws),
                                    np.asarray(j.clusters)),
                                   (o.tc, o.ws, o.clusters)):
        assert abs(c.tc - ref_tc) < TOL64
        assert np.abs(c.ws.numpy() - ref_ws).max() < TOL64
        assert np.array_equal(c.clusters, ref_cl)
    assert np.abs(c.tcs - o.tcs).max() < TOL64
    assert np.abs(c.mis - o.mis).max() < TOL64
    # the per-iteration TC trajectory, to 1e-8 of its magnitude
    h, hj = c.history, j.history
    assert np.allclose(h["TC"], hj["TC"], rtol=TOL64 / 10, atol=TOL64)
    assert h["eps"] == hj["eps"]


@pytest.mark.parametrize("use_pallas", ["never", "always"])
def test_f32_matches_jax_f32(use_pallas, data):
    """float32: the same clusters as the JAX package's float32 fit and TC
    within 1e-3 relative ('always' runs the chain kernel's CPU twin)."""
    w0 = _shared_init(8, 64)
    c = lct.Corex(n_hidden=8, use_pallas=use_pallas, device="cpu").fit(
        data, init_ws=w0)
    j = lc.Corex(n_hidden=8).fit(data, init_ws=w0)
    assert c.ws.dtype == torch.float32
    assert np.array_equal(c.clusters, np.asarray(j.clusters))
    assert abs(c.tc - j.tc) / j.tc < 1e-3


def test_seeded_init_matches_jax(data):
    """A seed gives the JAX package's W0 (numpy RandomState), so seeded
    fits agree without an explicit init."""
    c = lct.Corex(n_hidden=8, seed=3, dtype="float64", device="cpu").fit(
        data)
    j = lc.Corex(n_hidden=8, seed=3, dtype="float64").fit(data)
    assert abs(c.tc - j.tc) < TOL64
    assert np.abs(c.ws.numpy() - np.asarray(j.ws)).max() < TOL64


def test_transform_and_details_match_jax(data):
    w0 = _shared_init(8, 64)
    c = lct.Corex(n_hidden=8, dtype="float64", device="cpu").fit(
        data, init_ws=w0)
    j = lc.Corex(n_hidden=8, dtype="float64").fit(data, init_ws=w0)
    x2 = block_data(n=300, p=64, m=8, seed=9)
    y = c.transform(x2)
    assert tuple(y.shape) == (300, 8)
    assert np.abs(y - np.asarray(j.transform(x2))).max() < TOL64
    yd, md = c.transform(x2, details=True)
    yj, mj = j.transform(x2, details=True)
    assert np.abs(yd - np.asarray(yj)).max() < TOL64
    assert list(md) == list(mj)
    # relative to each entry's largest magnitude: a variable at the rho
    # clip has invrho ~5e5, where the last bits of rho move invrho by ~1e-6
    for key in mj:
        want = np.asarray(mj[key])
        scale = max(1.0, float(np.abs(want).max()))
        assert np.abs(md[key] - want).max() < TOL64 * scale, key


@pytest.mark.parametrize("kwargs", [
    dict(matmul_dtype="int8", tol=1e-4),
    dict(discourage_overlap=False, max_iter=500),
])
def test_corex_from_numpy_carries_jax_int8_and_overlap_fits(kwargs, data,
                                                            tmp_path):
    """A JAX int8 fit and a JAX overlap fit, carried across: transform
    within 1e-6 of the JAX model's, tc and clusters equal."""
    j = lc.Corex(n_hidden=8, seed=1, **kwargs).fit(data)
    path = tmp_path / "model.npz"
    save_corex(j, str(path))
    with np.load(path) as z:
        state = {k: z[k] for k in z.files}
    c = lct.corex_from_numpy(state, n_hidden=8, device="cpu", **kwargs)
    x2 = block_data(n=200, p=64, m=8, seed=4)
    want = np.asarray(j.transform(x2))
    assert np.abs(c.transform(x2) - want).max() \
        <= 1e-6 * max(1.0, np.abs(want).max())
    assert c.tc == float(j.tc)
    assert np.array_equal(c.clusters, np.asarray(j.clusters))


def test_corex_from_numpy_carries_a_jax_fit(data, tmp_path):
    """A JAX-fitted model's save_corex arrays build a port model that
    transforms like the JAX model and reports the same TC and clusters."""
    j = lc.Corex(n_hidden=8, seed=1, dtype="float64").fit(data)
    path = tmp_path / "model.npz"
    save_corex(j, str(path))
    with np.load(path) as z:
        state = {k: z[k] for k in z.files}
    c = lct.corex_from_numpy(state, n_hidden=8, dtype="float64",
                             device="cpu")
    x2 = block_data(n=200, p=64, m=8, seed=4)
    assert np.abs(c.transform(x2)
                  - np.asarray(j.transform(x2))).max() < 1e-10
    assert abs(c.tc - j.tc) < 1e-10
    assert np.abs(c.tcs - np.asarray(j.tcs)).max() < 1e-10
    assert np.abs(c.mis - np.asarray(j.mis)).max() < 1e-10
    assert np.array_equal(c.clusters, np.asarray(j.clusters))
    # a later fit warm-starts from the carried weights, as after load_corex
    assert torch.equal(c._resolve_w0(None), c.ws)
    # the sample count and the kept lane come across with the arrays
    assert (c.n_samples, c.best_restart_) == (j.n_samples, 0) == (1000, 0)
    assert f"n_samples=1000, tc={j.tc:.4f}" in repr(c)
    bare = {k: v for k, v in state.items() if k != "meta_json"}
    c2 = lct.corex_from_numpy(bare, n_hidden=8, dtype="float64",
                              device="cpu")
    assert (c2.n_samples, c2.best_restart_) == (None, 0)
    c3 = lct.corex_from_numpy(bare, n_samples=77, best_restart=2,
                              n_hidden=8, dtype="float64", device="cpu")
    assert (c3.n_samples, c3.best_restart_) == (77, 2)
    assert "n_samples=77" in repr(c3)


def test_config_fields_and_defaults_match_jax():
    ours = [(f.name, f.default) for f in dataclasses.fields(CorexConfig)]
    theirs = [(f.name, f.default) for f in dataclasses.fields(JaxConfig)]
    assert ours == theirs
    assert CorexConfig().anneal_schedule() == JaxConfig().anneal_schedule()
    cfg = dict(n_hidden=4, stage_tol_factor=10.0, tol=1e-4)
    assert CorexConfig(**cfg).tol_schedule() == \
        JaxConfig(**cfg).tol_schedule()
    for n, p in ((100, 50), (100, 300), (30000, 25000)):
        assert CorexConfig().pick_strategy(n, p) == \
            JaxConfig().pick_strategy(n, p)


def test_use_pallas_interpret_rejected_by_name():
    with pytest.raises(ValueError, match="interpret"):
        CorexConfig(use_pallas="interpret")


def test_resolve_config_per_device():
    cfg = CorexConfig(n_hidden=512, optimizer="auto")
    cuda = resolve_config(cfg, 10000, "cuda", n_samples=10000)
    assert (cuda.optimizer, cuda.use_pallas) == ("fixed_point", "always")
    assert resolve_config(cfg, 10000, "cpu", 10000).use_pallas == "never"
    f64 = dataclasses.replace(cfg, dtype="float64")
    assert resolve_config(f64, 10000, "cuda", 10000).use_pallas == "never"
    # beyond the kernel's limit the plain chain runs
    wide = dataclasses.replace(cfg, n_hidden=9000)
    assert resolve_config(wide, 10000, "cuda", 10000).use_pallas == "never"
    # undersampled → heavy-ball, as in the JAX package
    assert resolve_config(cfg, 10000, "cuda", 200).optimizer == "momentum"


@pytest.mark.parametrize("kwargs,fit_kwargs,error,text", [
    # var and factor plans run (tests/test_torch_sharding_vars.py): a
    # restart sweep under one raises by name, and a mesh without a
    # process group says what to initialize
    (dict(n_restarts=2), dict(mesh=object(),
                              sharding_plan=ShardingPlan(shard_vars=True)),
     ValueError, "sample sharding only"),
    ({}, dict(mesh=object(),
              sharding_plan=ShardingPlan(shard_factors=True)),
     RuntimeError, "default process group"),
    # every matmul_precision the JAX package names runs
    # (tests/test_torch_precision.py), but its dot-algorithm names
    (dict(matmul_precision="BF16_BF16_F32_X3"), {}, ValueError,
     "dot-algorithm"),
])
def test_unported_options_raise(kwargs, fit_kwargs, error, text, data):
    c = lct.Corex(n_hidden=4, device="cpu", **kwargs)
    with pytest.raises(error, match=text):
        c.fit(data, **fit_kwargs)


@pytest.mark.parametrize("kwargs,bar", [
    (dict(init="spectral", anneal=False), 1e-3),
    (dict(stage_subsample=0.5, moment_strategy="samples"), 1e-3),
    (dict(discourage_overlap=False), 1e-3),
    (dict(matmul_dtype="bfloat16", optimizer="fixed_point", tol=1e-4),
     1e-3),
    (dict(matmul_dtype="int8", optimizer="fixed_point", tol=1e-4), 1e-3),
    (dict(gaussianize="empirical"), 1e-3),
    (dict(preset="throughput"), 1e-3),
])
def test_formerly_unported_options_fit_and_match_jax(kwargs, bar, data):
    """Each option that raised NotImplementedError before now fits on the
    CPU and gives the JAX fit's clusters, with TC within `bar` relative
    (the float32 bar of tests/test_parity.py; the operand modes run the
    fixed point, whose TC quantization noise does not scatter — see
    tests/test_torch_operands.py)."""
    c = lct.Corex(n_hidden=8, seed=0, device="cpu", **kwargs).fit(data)
    j = lc.Corex(n_hidden=8, seed=0, **kwargs).fit(data)
    assert np.array_equal(c.clusters, np.asarray(j.clusters))
    assert abs(c.tc - float(j.tc)) <= bar * abs(float(j.tc)), (
        c.diagnostics.iters_per_stage.tolist(),
        np.asarray(j.diagnostics.iters_per_stage).tolist())


def test_zero_width_input_raises_as_jax():
    x = np.zeros((10, 0))
    with pytest.raises(ValueError, match="0 feature") as want:
        lc.Corex(n_hidden=2).fit(x)
    with pytest.raises(ValueError, match="0 feature") as got:
        lct.Corex(n_hidden=2, device="cpu").fit(x)
    assert "minimum of 1 is required" in str(want.value)
    assert "minimum of 1 is required" in str(got.value)
    fitted = lct.Corex(n_hidden=2, device="cpu", max_iter=5).fit(
        np.random.RandomState(0).normal(size=(10, 3)))
    with pytest.raises(ValueError, match="0 feature"):
        fitted.transform(torch.zeros((4, 0)))


def test_object_array_fits_as_jax(data):
    """A numeric dtype=object array densifies to float64 and fits: the
    same TC in float64 as the JAX package."""
    x = data.astype(object)
    w0 = _shared_init(8, 64)
    c = lct.Corex(n_hidden=8, dtype="float64", device="cpu").fit(
        x, init_ws=w0)
    j = lc.Corex(n_hidden=8, dtype="float64").fit(x, init_ws=w0)
    assert abs(c.tc - float(j.tc)) < TOL64
    assert np.array_equal(c.clusters, np.asarray(j.clusters))
    with pytest.raises(ValueError):
        lct.Corex(n_hidden=2, device="cpu").fit(
            np.array([["a", "b"], ["c", "d"]], dtype=object))


def test_cuda_device_without_cuda_raises(data):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lct.Corex(n_hidden=4).fit(data)


def test_not_fitted_and_surface(data):
    c = lct.Corex(n_hidden=4, device="cpu", max_iter=50)
    with pytest.raises(lct.NotFittedError):
        c.transform(data)
    c.fit(data)
    assert c.best_restart_ == 0
    assert len(c.history["TC"]) == c.n_iter_
    assert c.diagnostics.tc_history.shape == (7, 50)
    with pytest.raises(ValueError, match="columns"):
        c.transform(data[:, :10])
    # constructor arguments are stored verbatim; validation waits for use
    bad = lct.Corex(n_hidden=4, optimizer="nope", device="cpu")
    assert bad.optimizer == "nope"
    with pytest.raises(ValueError, match="optimizer"):
        bad.fit(data)


PORT_MODULES = ["config", "core.solver", "models.corex", "models.selection",
                "models.stacked", "ops.cuda_moments", "ops.moments",
                "ops.preprocessing", "parallel.collectives",
                "parallel.launch", "parallel.restarts", "parallel.sharding",
                "utils.build", "utils.checkpoint", "utils.compile_cache",
                "utils.interop", "utils.native",
                "utils.profiling", "utils.streaming"]


def test_port_exports_all_but_the_xla_warmups():
    """The port exports the JAX package's whole surface, the four
    deploy-time warmup names included (they were once the names it left
    out), and one name of its own: the interop helper."""
    assert lct.__version__ == lc.__version__
    assert set(lc.__all__) - set(lct.__all__) == set()
    assert set(lct.__all__) - set(lc.__all__) == {"corex_from_numpy"}
    for name in lct.__all__:
        assert getattr(lct, name) is not None
    assert lct.QuantizedData is lct.quantize_gram(torch.eye(4)).__class__


def test_port_module_list_is_complete():
    root = pathlib.Path(lct.__file__).resolve().parent
    found = sorted(
        str(f.relative_to(root).with_suffix("")).replace("/", ".")
        for f in root.rglob("*.py") if f.name != "__init__.py")
    assert found == sorted(PORT_MODULES)


def test_import_leaves_jax_out():
    mods = ", ".join(f"linearcorex_tpu_torch.{m}" for m in PORT_MODULES)
    code = (f"import sys, linearcorex_tpu_torch, {mods}; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert 'linearcorex_tpu' not in sys.modules; print('ok')")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300,
                          cwd=str(pathlib.Path(__file__).resolve().parents[1]))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip() == "ok"
