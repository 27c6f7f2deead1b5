"""The port's `save_corex`/`load_corex`/`fit_with_checkpoints` on their
own and against the JAX package's: one file format for both.

A model saved by either package loads in the other and serves equal
values (1e-10, float64); the fit fingerprint of one (config, data,
schedule) is the same string in both; a float64 `fit_with_checkpoints`
directory begun by one package and interrupted is resumed by the other to
the uninterrupted result (same iterations per stage, TC and W within
1e-8). The port runs on `device="cpu"`.
"""

import dataclasses
import json
import os
import warnings

import numpy as np
import pytest
import torch

import linearcorex_tpu as lc
import linearcorex_tpu_torch as lct
from linearcorex_tpu.utils import checkpoint as JC
from linearcorex_tpu_torch.models.corex import _fit_program
from linearcorex_tpu_torch.ops import moments as M
from linearcorex_tpu_torch.ops import preprocessing as P
from linearcorex_tpu_torch.utils import checkpoint as TC
from linearcorex_tpu_torch.utils.checkpoint import (fit_with_checkpoints,
                                                    load_corex, save_corex)
from tests.conftest import block_data

torch.set_num_threads(1)

TOL64 = 1e-8


@pytest.fixture(scope="module")
def x():
    return block_data(n=500, p=32, m=4, seed=3)


def _w0(seed=5):
    return np.random.RandomState(seed).normal(scale=1 / np.sqrt(32),
                                              size=(4, 32))


def _corex(**kw):
    return lct.Corex(n_hidden=4, device="cpu", **kw)


# ---------------------------------------------------------------------------
# the port on its own (the JAX package's checkpoint tests, on the port)
# ---------------------------------------------------------------------------

def test_save_load_roundtrip(tmp_path, x):
    c = _corex(seed=0, dtype="float64").fit(x)
    path = str(tmp_path / "model.npz")
    save_corex(c, path)
    c2 = load_corex(path, device="cpu")
    assert torch.equal(c2.ws, c.ws)
    assert abs(c2.tc - c.tc) < 1e-12
    assert np.array_equal(c2.clusters, c.clusters)
    assert np.abs(c.transform(x) - c2.transform(x)).max() < 1e-12
    assert np.abs(c.get_covariance() - c2.get_covariance()).max() < 1e-12
    assert (c2.nv, c2.n_samples, c2.best_restart_) == (32, 500, 0)
    assert c2.device == "cpu" and c2.get_params() == c.get_params()


def test_resume_warm_start(tmp_path, x):
    c = _corex(seed=0).fit(x)
    path = str(tmp_path / "model.npz")
    save_corex(c, path)
    c2 = load_corex(path, device="cpu")
    c2.fit(x)   # warm start from the stored ws, over the whole schedule
    assert c2.n_iter_ < c.n_iter_
    assert abs(c2.tc - c.tc) < 1e-2


def test_unfitted_raises(tmp_path):
    with pytest.raises(ValueError, match="not fitted"):
        save_corex(_corex(), str(tmp_path / "x.npz"))


def test_load_rejects_other_files(tmp_path):
    path = str(tmp_path / "other.npz")
    np.savez(path, a=np.zeros(3))
    with pytest.raises(ValueError, match="not a linearcorex_tpu checkpoint"):
        load_corex(path, device="cpu")
    newer = str(tmp_path / "newer.npz")
    meta = json.dumps({"format_version": 99}).encode()
    np.savez(newer, meta_json=np.frombuffer(meta, dtype=np.uint8))
    with pytest.raises(ValueError, match="newer"):
        load_corex(newer, device="cpu")


def test_load_places_the_model_on_the_named_device(tmp_path, x):
    c = _corex(seed=0, max_iter=20).fit(x)
    path = str(tmp_path / "m.npz")
    save_corex(c, path)
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta_json"]).decode())
    assert "device" not in meta and "device" not in meta["config"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            load_corex(path)


def test_fit_with_checkpoints_matches_plain_fit(tmp_path, x):
    ref = _corex(dtype="float64").fit(x, init_ws=_w0())
    m2 = _corex(dtype="float64")
    assert fit_with_checkpoints(m2, x, str(tmp_path / "ck"),
                                init_ws=_w0()) is m2
    assert abs(m2.tc - ref.tc) < 1e-9
    assert (m2.ws - ref.ws).abs().max() < 1e-9
    assert m2.best_restart_ == 0
    for got, want in zip(m2.diagnostics, ref.diagnostics):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.allclose(got.double(), want.double(), atol=1e-9)
    assert m2.history["TC"] == pytest.approx(ref.history["TC"], abs=1e-9)


def test_fit_with_checkpoints_resumes(tmp_path, x):
    """Interrupting after stage k and starting again resumes from stage
    k + 1 and reaches the same final solution."""
    ckdir = str(tmp_path / "ck")
    model = _corex(dtype="float64")
    xp, _ = P.fit_preprocess(torch.as_tensor(x), "standard")
    strategy = model.config.pick_strategy(*x.shape)
    data = M.compute_gram(xp) if strategy == "gram" else xp
    schedule = model.config.anneal_schedule()
    ws = torch.as_tensor(_w0())
    os.makedirs(ckdir, exist_ok=True)
    fp = np.frombuffer(TC._fit_fingerprint(model, x, schedule).encode(),
                       dtype=np.uint8)
    for s in range(3):
        cfg_s = dataclasses.replace(model.config, eps_override=schedule[s])
        ws, _, _ = _fit_program(data, ws, cfg_s, strategy)
        np.savez(os.path.join(ckdir, "stage_state.npz"), ws=ws.numpy(),
                 stage=s + 1, fingerprint=fp)
    ran = []
    m2 = _corex(dtype="float64")
    fit_with_checkpoints(m2, x, ckdir, init_ws=_w0(),
                         stage_callback=lambda s, *a: ran.append(s))
    assert ran == list(range(3, len(schedule)))
    ref = _corex(dtype="float64")
    fit_with_checkpoints(ref, x, str(tmp_path / "ck2"), init_ws=_w0())
    assert abs(m2.tc - ref.tc) < 1e-9


def test_fit_with_checkpoints_rejects_stale_checkpoint(tmp_path, x):
    ckdir = str(tmp_path / "ck")
    fit_with_checkpoints(_corex(dtype="float64"), x, ckdir, init_ws=_w0())
    x2 = x[::-1].copy() * 1.5 + 0.1
    m2 = _corex(dtype="float64")
    with pytest.warns(UserWarning, match="different"):
        fit_with_checkpoints(m2, x2, ckdir, init_ws=_w0())
    ref = _corex(dtype="float64").fit(x2, init_ws=_w0())
    assert abs(m2.tc - ref.tc) < 1e-9
    m3 = _corex(dtype="float64", tol=1e-4)
    with pytest.warns(UserWarning, match="different"):
        fit_with_checkpoints(m3, x2, ckdir, init_ws=_w0())
    assert np.isfinite(m3.tc)


def test_fit_with_checkpoints_validates_like_fit(tmp_path):
    m = lct.Corex(n_hidden=2, device="cpu")
    with pytest.raises(ValueError, match="2-D"):
        fit_with_checkpoints(m, np.zeros(8), str(tmp_path / "ck"))
    bad = np.random.RandomState(0).normal(size=(20, 8))
    bad[3, 4] = np.nan
    with pytest.raises(ValueError, match="NaN"):
        fit_with_checkpoints(m, bad, str(tmp_path / "ck"))
    with pytest.raises(ValueError, match="n_restarts > 1"):
        fit_with_checkpoints(lct.Corex(n_hidden=2, n_restarts=2,
                                       device="cpu"),
                             bad, str(tmp_path / "ck"))


def test_save_load_path_without_suffix(tmp_path, x):
    c = _corex(seed=0, update_iter=7, verbose=False, max_iter=30).fit(x)
    path = str(tmp_path / "model")  # no .npz
    save_corex(c, path)
    assert os.path.exists(path + ".npz")
    c2 = load_corex(path, device="cpu")
    assert torch.equal(c2.ws, c.ws)
    assert c2.update_iter == 7 and c2.verbose is False


def test_save_takes_numpy_scalar_parameters(tmp_path, x):
    """Parameters arrive verbatim from sklearn grids (np.int64 seeds,
    np.float64 tols): the metadata canonicalizes them."""
    c = _corex(seed=np.int64(3), tol=np.float64(1e-4),
               max_iter=np.int64(30)).fit(x)
    path = str(tmp_path / "m.npz")
    save_corex(c, path)
    c2 = load_corex(path, device="cpu")
    assert c2.seed == 3 and type(c2.seed) is int and c2.tol == 1e-4
    with pytest.raises(TypeError, match="not JSON-serializable"):
        TC._json_scalar(object())


def test_checkpointed_int8_fit_close_to_plain(tmp_path, x):
    kw = dict(seed=0, matmul_dtype="int8", tol=1e-4)
    m = _corex(**kw)
    fit_with_checkpoints(m, x, str(tmp_path / "ck8"))
    plain = _corex(**kw).fit(x)
    assert abs(m.tc - plain.tc) / plain.tc < 0.02
    assert np.array_equal(m.clusters, plain.clusters)


def test_stage_callback_runs_per_stage(tmp_path, x):
    seen = []

    def cb(stage, eps, ws, stats):
        seen.append((stage, float(eps), tuple(ws.shape),
                     int(stats["iters"][stage])))

    model = _corex(dtype="float64")
    fit_with_checkpoints(model, x, str(tmp_path / "ck"), stage_callback=cb)
    schedule = model.config.anneal_schedule()
    assert [s[0] for s in seen] == list(range(len(schedule)))
    assert [s[1] for s in seen] == [float(e) for e in schedule]
    assert all(shape == (4, 32) for _, _, shape, _ in seen)
    assert all(iters > 0 for *_, iters in seen)


def test_fit_with_checkpoints_respects_stage_tol_factor(tmp_path, x):
    ref = _corex(dtype="float64", stage_tol_factor=10.0).fit(
        x, init_ws=_w0())
    m2 = _corex(dtype="float64", stage_tol_factor=10.0)
    fit_with_checkpoints(m2, x, str(tmp_path / "ck"), init_ws=_w0())
    assert abs(m2.tc - ref.tc) < 1e-9
    assert (m2.ws - ref.ws).abs().max() < 1e-9
    base = _corex(dtype="float64").fit(x, init_ws=_w0())
    assert (m2.diagnostics.iters_per_stage[:-1].sum()
            < base.diagnostics.iters_per_stage[:-1].sum())


def test_fit_with_checkpoints_stage_subsample(tmp_path, x):
    """The non-final stages run on every second row, the final stage on
    the full data: the two-program fit's result."""
    kw = dict(dtype="float64", stage_subsample=0.5,
              moment_strategy="samples")
    ref = _corex(**kw).fit(x, init_ws=_w0())
    m2 = _corex(**kw)
    fit_with_checkpoints(m2, x, str(tmp_path / "ck"), init_ws=_w0())
    assert m2.diagnostics.iters_per_stage.tolist() == \
        ref.diagnostics.iters_per_stage.tolist()
    assert abs(m2.tc - ref.tc) < 1e-9


def test_save_load_roundtrips_stage_tol_factor(tmp_path, x):
    c = _corex(seed=0, dtype="float64", stage_tol_factor=10.0,
               max_iter=30).fit(x)
    path = str(tmp_path / "m.npz")
    save_corex(c, path)
    c2 = load_corex(path, device="cpu")
    assert c2.stage_tol_factor == 10.0
    assert c2.get_params()["stage_tol_factor"] == 10.0
    assert c2.config.tol_schedule() == c.config.tol_schedule()


def test_loaded_sweep_model_refuses_a_warm_started_sweep(tmp_path, x):
    c = _corex(seed=0, n_restarts=2, max_iter=20).fit(x)
    path = str(tmp_path / "m.npz")
    save_corex(c, path)
    c2 = load_corex(path, device="cpu")
    assert c2.n_restarts == 2 and c2.best_restart_ == c.best_restart_
    with pytest.raises(ValueError, match="identical"):
        c2.fit(x)


def test_fingerprint_ignores_default_valued_config_fields(x):
    m_default = _corex(dtype="float64")
    m_explicit = _corex(dtype="float64", stage_tol_factor=1.0)
    m_changed = _corex(dtype="float64", stage_tol_factor=10.0)
    sched = m_default.config.anneal_schedule()
    fp_d = TC._fit_fingerprint(m_default, x, sched)
    assert fp_d == TC._fit_fingerprint(m_explicit, x, sched)
    assert fp_d != TC._fit_fingerprint(m_changed, x, sched)
    assert fp_d != TC._fit_fingerprint(m_default, x + 1.0, sched)
    # a tensor is subsampled where it lies and hashes like its array
    assert fp_d == TC._fit_fingerprint(m_default, torch.as_tensor(x), sched)


# ---------------------------------------------------------------------------
# against the JAX package: one file format
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kwargs", [
    dict(dtype="float64"),
    dict(dtype="float64", stage_tol_factor=10.0, tol=1e-4),
    dict(dtype="float32", matmul_dtype="int8", optimizer="fixed_point"),
    dict(dtype="float64", gaussianize="outliers", missing_values=-999.0),
])
def test_fingerprints_equal_across_packages(kwargs, x):
    c = _corex(seed=0, **kwargs)
    j = lc.Corex(n_hidden=4, seed=0, **kwargs)
    sched = c.config.anneal_schedule()
    assert sched == j.config.anneal_schedule()
    assert TC._fit_fingerprint(c, x, sched) == \
        JC._fit_fingerprint(j, x, sched)


def _assert_serves_alike(c, j, x):
    x2 = block_data(n=120, p=32, m=4, seed=8)
    y = c.transform(x2)
    assert np.abs(y - np.asarray(j.transform(x2))).max() < 1e-10
    assert np.abs(c.predict(y)
                  - np.asarray(j.predict(np.asarray(y)))).max() < 1e-10
    assert abs(c.tc - float(j.tc)) < 1e-10
    assert np.abs(c.tcs - np.asarray(j.tcs)).max() < 1e-10
    assert np.array_equal(c.clusters, np.asarray(j.clusters))
    assert (c.nv, c.n_samples, c.best_restart_, c.seed) == \
        (j.nv, j.n_samples, j.best_restart_, j.seed)


@pytest.mark.parametrize("kwargs", [
    {}, dict(discourage_overlap=False, max_iter=300),
    dict(n_restarts=2, max_iter=100)],
    ids=["plain", "overlap", "sweep"])
def test_jax_saved_model_loads_in_the_port(kwargs, tmp_path, x):
    j = lc.Corex(n_hidden=4, seed=1, dtype="float64", **kwargs).fit(x)
    path = str(tmp_path / "jax_model.npz")
    JC.save_corex(j, path)
    c = load_corex(path, device="cpu")
    _assert_serves_alike(c, j, x)
    want = {k: v for k, v in j.get_params().items()}
    got = c.get_params()
    assert got.pop("device") == "cpu"
    for gone in ("gpu", "pretrained_weights", "preset"):
        want.pop(gone, None), got.pop(gone, None)
    assert got == want


@pytest.mark.parametrize("kwargs", [
    {}, dict(discourage_overlap=False, max_iter=300),
    dict(n_restarts=2, max_iter=100)],
    ids=["plain", "overlap", "sweep"])
def test_port_saved_model_loads_in_jax(kwargs, tmp_path, x):
    c = _corex(seed=1, dtype="float64", **kwargs).fit(x)
    path = str(tmp_path / "torch_model.npz")
    save_corex(c, path)
    j = JC.load_corex(path)
    _assert_serves_alike(c, j, x)
    with np.load(path) as z:
        ours = sorted(z.files)
        meta = json.loads(bytes(z["meta_json"]).decode())
    JC.save_corex(j, str(tmp_path / "again.npz"))
    with np.load(str(tmp_path / "again.npz")) as z:
        assert sorted(z.files) == ours
        assert json.loads(bytes(z["meta_json"]).decode()) == meta


class _Interrupt(Exception):
    pass


def _stop_after(stage):
    def cb(s, eps, ws, stats):
        if s == stage:
            raise _Interrupt
    return cb


def _assert_resumed_like(model, ref):
    """`model` resumed in one package, `ref` uninterrupted in the JAX
    package."""
    def host(a):
        return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    assert host(model.diagnostics.iters_per_stage).tolist() == \
        np.asarray(ref.diagnostics.iters_per_stage).tolist()
    assert abs(float(model.tc) - float(ref.tc)) < TOL64
    assert np.abs(host(model.ws) - np.asarray(ref.ws)).max() < TOL64
    assert np.abs(host(model.diagnostics.tc_history)
                  - np.asarray(ref.diagnostics.tc_history)).max() < TOL64


def test_jax_checkpoints_resumed_by_the_port(tmp_path, x):
    ref = lc.Corex(n_hidden=4, dtype="float64")
    JC.fit_with_checkpoints(ref, x, str(tmp_path / "ref"), init_ws=_w0())
    ckdir = str(tmp_path / "ck")
    with pytest.raises(_Interrupt):
        JC.fit_with_checkpoints(lc.Corex(n_hidden=4, dtype="float64"), x,
                                ckdir, init_ws=_w0(),
                                stage_callback=_stop_after(3))
    ran = []
    c = _corex(dtype="float64")
    fit_with_checkpoints(c, x, ckdir, init_ws=_w0(),
                         stage_callback=lambda s, *a: ran.append(s))
    assert ran == [4, 5, 6]                     # resumed, not restarted
    _assert_resumed_like(c, ref)


def test_port_checkpoints_resumed_by_jax(tmp_path, x):
    ref = lc.Corex(n_hidden=4, dtype="float64")
    JC.fit_with_checkpoints(ref, x, str(tmp_path / "ref"), init_ws=_w0())
    ckdir = str(tmp_path / "ck")
    with pytest.raises(_Interrupt):
        fit_with_checkpoints(_corex(dtype="float64"), x, ckdir,
                             init_ws=_w0(), stage_callback=_stop_after(3))
    ran = []
    j = lc.Corex(n_hidden=4, dtype="float64")
    with warnings.catch_warnings():
        # a fingerprint mismatch would warn and restart from stage 0
        warnings.filterwarnings("error", message=".*different.*")
        JC.fit_with_checkpoints(j, x, ckdir, init_ws=_w0(),
                                stage_callback=lambda s, *a: ran.append(s))
    assert ran == [4, 5, 6]
    _assert_resumed_like(j, ref)


def test_checkpointed_fit_step_matched_with_jax(tmp_path, x):
    kw = dict(dtype="float64", optimizer="auto")
    c = _corex(**kw)
    fit_with_checkpoints(c, x, str(tmp_path / "c"), init_ws=_w0())
    j = lc.Corex(n_hidden=4, **kw)
    JC.fit_with_checkpoints(j, x, str(tmp_path / "j"), init_ws=_w0())
    _assert_resumed_like(c, j)
    assert c.resolved_optimizer_ == j.resolved_optimizer_ == "fixed_point"
    with np.load(str(tmp_path / "c" / "stage_state.npz")) as zc, \
            np.load(str(tmp_path / "j" / "stage_state.npz")) as zj:
        assert sorted(zc.files) == sorted(zj.files)
        assert bytes(zc["fingerprint"]) == bytes(zj["fingerprint"])
        for k in zc.files:
            assert zc[k].shape == zj[k].shape and zc[k].dtype == zj[k].dtype
