"""Restart sweeps of the PyTorch port (`Corex(n_restarts=k)`,
`parallel.restarts`) against the JAX package's vmapped sweep, the float64
oracle and the port's own single fits.

Float64 lanes from the same `init_restarts` stack must be step-matched
with the JAX sweep's lanes: identical iterations per anneal stage, W, TC
and the TC history within 1e-8. The one exception is the overlap
objective on the gram strategy, whose JAX product rounds Σ·Wᵀ to float32
in every dtype (ROADMAP.md Queue 3): there each lane is held to the
float64 oracle and to the port's single fit from the same W0. int8 and
bf16 lanes are held to the JAX sweep's lanes at the operand tolerances
of tests/test_torch_operands.py (same clusters, TC within 1e-3 relative
on the fixed point).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import linearcorex_tpu as lc
import linearcorex_tpu_torch as lct
from linearcorex_tpu.config import CorexConfig as JaxConfig
from linearcorex_tpu.oracle import OracleCorex
from linearcorex_tpu.ops import moments as JM
from linearcorex_tpu.ops import preprocessing as JP
from linearcorex_tpu.parallel.restarts import fit_restarts as jax_sweep
from linearcorex_tpu.parallel.restarts import init_restarts as jax_inits
from linearcorex_tpu_torch.config import CorexConfig
from linearcorex_tpu_torch.models.corex import _fit_program, resolve_config
from linearcorex_tpu_torch.ops import cuda_moments as CM
from linearcorex_tpu_torch.ops import moments as TM
from linearcorex_tpu_torch.ops import preprocessing as TP
from linearcorex_tpu_torch.parallel import restarts as TR
from tests.conftest import block_data

# One intra-op thread: the suite runs its files in parallel worker
# processes, and an OpenMP pool per process on every core slows the
# small tensors here several times over.
torch.set_num_threads(1)

TOL64 = 1e-8
KW = dict(n_hidden=4, dtype="float64", record_history=False,
          moment_strategy="samples", max_iter=500)


def _lottery_data():
    """Weak matched-m structure: the lanes land in different optima, so
    the best-of-k choice is not vacuous (tests/test_restarts_estimator)."""
    return np.asarray(block_data(n=256, p=32, m=4, seed=3, strength=0.3))


def _operands(x, strategy, dtype=torch.float64):
    """The solver operand of both packages from the same rows."""
    xj, _ = JP.fit_preprocess(jnp.asarray(x, jnp.dtype(str(dtype)[6:])),
                              "standard")
    xt, _ = TP.fit_preprocess(torch.as_tensor(x, dtype=dtype), "standard")
    if strategy == "gram":
        return JM.compute_gram(xj), TM.compute_gram(xt)
    return xj, xt


@pytest.mark.parametrize("objective", ["fixed_point", "momentum",
                                       "overlap"])
@pytest.mark.parametrize("strategy", ["samples", "gram"])
def test_lanes_step_matched_with_jax_sweep(strategy, objective):
    x = block_data(n=500, p=32, m=4, seed=3)
    kw = dict(n_hidden=4, dtype="float64", max_iter=2000)
    kw.update(dict(discourage_overlap=False) if objective == "overlap"
              else dict(optimizer=objective))
    dj, dt = _operands(x, strategy)
    w0 = TR.init_restarts(3, 4, 32, seed=17, dtype=torch.float64,
                          device="cpu")
    assert np.array_equal(
        w0.numpy(), np.asarray(jax_inits(3, 4, 32, 17, jnp.float64)))
    ws, mom, diag = TR.fit_restarts(dt, w0, CorexConfig(**kw), strategy)
    stages = len(CorexConfig(**kw).anneal_schedule())
    assert ws.shape == (3, 4, 32) and mom.tc.shape == (3,)
    assert diag.iters_per_stage.shape == (3, stages)
    assert diag.tc_history.shape == (3, stages, 2000)
    if strategy == "gram" and objective == "overlap":
        cfg = resolve_config(CorexConfig(**kw), 32, "cpu", 500)
        okw = {k: v for k, v in kw.items() if k != "dtype"}
        for r in range(3):
            o = OracleCorex(**okw).fit(x, init_ws=w0[r].numpy())
            assert diag.iters_per_stage[r].tolist() == \
                o.history["iters_per_stage"]
            assert abs(float(mom.tc[r]) - o.tc) < TOL64
            assert np.abs(ws[r].numpy() - o.ws).max() < TOL64
            w1, m1, d1 = _fit_program(dt, w0[r], cfg, strategy)
            assert torch.equal(d1.iters_per_stage, diag.iters_per_stage[r])
            assert float((w1 - ws[r]).abs().max()) < TOL64
        return
    wj, mj, dgj = jax_sweep(dj, jnp.asarray(w0.numpy()), JaxConfig(**kw),
                            strategy)
    assert diag.iters_per_stage.tolist() == \
        np.asarray(dgj.iters_per_stage).tolist()
    assert np.abs(ws.numpy() - np.asarray(wj)).max() < TOL64
    assert np.abs(mom.tc.numpy() - np.asarray(mj.tc)).max() < TOL64
    # the per-iteration TC of every lane, zero past the lane's own count
    assert np.abs(diag.tc_history.numpy()
                  - np.asarray(dgj.tc_history)).max() < TOL64
    assert np.abs(diag.delta_per_stage.numpy()
                  - np.asarray(dgj.delta_per_stage)).max() < TOL64


def test_sweep_equals_best_of_single_fits():
    """Corex(n_restarts=4, seed=s) is the best of the single fits
    Corex(seed=s+r), and picks the JAX sweep's lane."""
    x = _lottery_data()
    sweep = lct.Corex(n_restarts=4, seed=7, device="cpu", **KW).fit(x)
    singles = [lct.Corex(seed=7 + r, device="cpu", **KW).fit(x)
               for r in range(4)]
    tcs = [c.tc for c in singles]
    best = int(np.argmax(tcs))
    assert sweep.best_restart_ == best
    assert sweep.tc == pytest.approx(tcs[best], rel=1e-9)
    assert float((sweep.ws - singles[best].ws).abs().max()) < TOL64
    assert len(set(tcs)) > 1, "the lanes found no spread of optima"
    j = lc.Corex(n_restarts=4, seed=7, **KW).fit(x)
    assert j.best_restart_ == best
    assert abs(sweep.tc - float(j.tc)) < TOL64
    # the winning lane's state serves as a single fit's does
    assert sweep.diagnostics.iters_per_stage.shape == (7,)
    assert len(sweep.history["iters_per_stage"]) == 7
    y = sweep.fit_transform(x)
    assert tuple(y.shape) == (256, 4)
    assert tuple(sweep.get_covariance().shape) == (32, 32)


def test_single_restart_is_plain_fit():
    """n_restarts=1 (the default) is exactly the plain fit path."""
    x = _lottery_data()
    a = lct.Corex(seed=7, device="cpu", **KW).fit(x)
    b = lct.Corex(n_restarts=1, seed=7, device="cpu", **KW).fit(x)
    assert torch.equal(a.ws, b.ws)
    for fa, fb in zip(a.moments, b.moments):
        assert torch.equal(fa, fb)
    for fa, fb in zip(a.diagnostics, b.diagnostics):
        assert torch.equal(fa, fb)
    assert b.best_restart_ == 0


def test_unseeded_sweep_differs_across_calls():
    x = _lottery_data()
    a = lct.Corex(n_restarts=2, seed=None, device="cpu", **KW).fit(x)
    b = lct.Corex(n_restarts=2, seed=None, device="cpu", **KW).fit(x)
    assert not torch.equal(a.ws, b.ws)


def test_init_restarts_defaults_to_the_card():
    """Like Corex and pick_n_hidden, init_restarts targets the card unless
    asked for the CPU: without a card it raises instead of returning a CPU
    tensor."""
    if torch.cuda.is_available():
        assert TR.init_restarts(2, 4, 32, seed=0).device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            TR.init_restarts(2, 4, 32, seed=0)
    cpu = TR.init_restarts(2, 4, 32, seed=0, device="cpu")
    assert cpu.device.type == "cpu" and tuple(cpu.shape) == (2, 4, 32)


@pytest.mark.parametrize("bad", [0, -1, 1.0, 2.5, True, "bad", None])
def test_n_restarts_validated_as_jax(bad):
    """The integer check (bool and float rejected) with the JAX package's
    message; 1.0 and 0 were let through or misreported before."""
    x = _lottery_data()
    with pytest.raises(ValueError) as want:
        lc.Corex(n_restarts=bad, **KW).fit(x)
    with pytest.raises(ValueError) as got:
        lct.Corex(n_restarts=bad, device="cpu", **KW).fit(x)
    assert str(got.value) == str(want.value)
    assert "n_restarts must be an integer >= 1" in str(got.value)


def test_restart_guards_raise_as_jax():
    x = _lottery_data()
    w = np.zeros((4, 32))
    cases = [(dict(n_restarts=2), dict(init_ws=w)),
             (dict(n_restarts=2, pretrained_weights=w), {}),
             (dict(n_restarts=2, stage_subsample=0.25), {})]
    for kw, fit_kw in cases:
        with pytest.raises(ValueError) as want:
            lc.Corex(**KW, **kw).fit(x, **fit_kw)
        with pytest.raises(ValueError) as got:
            lct.Corex(device="cpu", **KW, **kw).fit(x, **fit_kw)
        assert str(got.value) == str(want.value)
    # a carried-across model warm-starts, so a sweep on it raises too
    fitted = lct.Corex(seed=0, device="cpu", **KW).fit(x)
    state = {"ws": fitted.ws.numpy(), "theta_mean": fitted.theta.mean,
             "theta_std": fitted.theta.std}
    state.update({f"mom_{k}": v for k, v in fitted.moments._asdict().items()})
    carried = lct.corex_from_numpy(state, n_restarts=2, device="cpu", **KW)
    with pytest.raises(ValueError, match="warm start"):
        carried.fit(x)


def test_spectral_sweep_equals_best_of_single_fits():
    """init='spectral' lanes draw Ω from RandomState(seed + r): the sweep
    is the best of the single spectral fits, lane 0 the plain one."""
    x = _lottery_data()
    kw = dict(KW, init="spectral", anneal=False)
    sweep = lct.Corex(n_restarts=4, seed=7, device="cpu", **kw).fit(x)
    singles = [lct.Corex(seed=7 + r, device="cpu", **kw).fit(x)
               for r in range(4)]
    tcs = [c.tc for c in singles]
    best = int(np.argmax(tcs))
    assert sweep.best_restart_ == best
    assert sweep.tc == pytest.approx(tcs[best], rel=1e-9)
    assert float((sweep.ws - singles[best].ws).abs().max()) < TOL64
    assert len(set(tcs)) > 1
    j = lc.Corex(n_restarts=4, seed=7, **kw).fit(x)
    assert j.best_restart_ == best
    assert abs(sweep.tc - float(j.tc)) < TOL64


def test_throughput_preset_composes_with_restarts():
    """preset='throughput' (int8, spectral, one stage) with restarts:
    the JAX sweep's winner, clusters and TC within 1e-3."""
    x = np.asarray(_lottery_data(), np.float32)
    kw = dict(n_hidden=4, preset="throughput", n_restarts=3, seed=0,
              max_iter=200, record_history=False)
    c = lct.Corex(device="cpu", **kw).fit(x)
    j = lc.Corex(**kw).fit(x)
    assert c.config.init == "spectral" and c.config.matmul_dtype == "int8"
    assert c.best_restart_ == j.best_restart_
    assert np.array_equal(c.clusters, np.asarray(j.clusters))
    assert abs(c.tc - float(j.tc)) <= 1e-3 * abs(float(j.tc))


@pytest.mark.parametrize("mode", ["int8", "bfloat16"])
def test_operand_mode_lanes_match_jax(mode):
    """int8 and bf16 lanes (fixed point, tol=1e-4, the data of
    tests/test_torch_operands.py): every lane gives the JAX sweep lane's
    clusters and TC within 1e-3 relative."""
    x = block_data(n=1000, p=64, m=4, seed=0)
    kw = dict(n_hidden=4, optimizer="fixed_point", tol=1e-4,
              matmul_dtype=mode, record_history=False)
    dj, dt = _operands(x.astype(np.float32), "gram", torch.float32)
    if mode == "int8":
        dj, dt = JM.quantize_samples(dj), TM.quantize_samples(dt)
    else:
        dt = dt.to(torch.bfloat16)
    w0 = TR.init_restarts(3, 4, 64, seed=5, device="cpu")
    ws, mom, _ = TR.fit_restarts(dt, w0, CorexConfig(**kw), "gram")
    wj, mj, _ = jax_sweep(dj, jnp.asarray(w0.numpy()), JaxConfig(**kw),
                          "gram")
    tcj = np.asarray(mj.tc)
    assert np.abs(mom.tc.numpy() - tcj).max() <= 1e-3 * np.abs(tcj).max()
    assert np.array_equal(torch.argmax(mom.mi, dim=1).numpy(),
                          np.asarray(jnp.argmax(mj.mi, axis=1)))


@pytest.mark.parametrize("strategy", ["samples", "gram"])
def test_lane_products_equal_single_products(strategy):
    """The lanes' operands laid side by side: an int8 lane's cross-moment
    is bitwise the single call's (per-column scales); float32 agrees to
    rounding."""
    rng = np.random.RandomState(0)
    x = block_data(n=300, p=48, m=4, seed=1).astype(np.float32)
    x = (x - x.mean(0)) / x.std(0)
    data = torch.from_numpy(x)
    if strategy == "gram":
        data = TM.compute_gram(data)
    ws = torch.as_tensor(rng.normal(scale=0.15, size=(3, 6, 48)),
                         dtype=torch.float32)
    gram = strategy == "gram"
    for operand in (TM.quantize_samples(data), data):
        lanes = TM._cxy_eff(operand, ws, 0.36, False, gram)
        for r in range(3):
            one = TM._cxy_eff(operand, ws[r], 0.36, False, gram)
            if isinstance(operand, TM.QuantizedData):
                assert torch.equal(lanes[r], one)
            else:
                assert float((lanes[r] - one).abs().max()) \
                    <= 1e-6 * float(one.abs().max())


def test_batched_twin_equals_single_twin_per_lane():
    rng = np.random.RandomState(2)
    k, p, m = 3, 70, 9
    w = rng.normal(scale=0.1, size=(k, m, p))
    x = rng.normal(size=(400, p))
    x = (x - x.mean(0)) / x.std(0)
    cxy = np.einsum("np,nq,kmq->kpm", x, x, w) / 400
    cy = np.einsum("kmp,kpj->kmj", w, cxy) + np.eye(m)
    z2 = np.diagonal(cy, axis1=1, axis2=2)
    ry = cy / np.sqrt(z2[:, :, None] * z2[:, None, :])
    ops = [torch.as_tensor(a, dtype=torch.float32)
           for a in (cxy, ry, np.sqrt(z2))]
    before = (CM.ns_chain.launches, CM.ns_chain.lane_launches)
    lanes = CM.ns_chain(*ops, 1 - 1e-6)        # CPU: the batched twin
    assert (CM.ns_chain.launches, CM.ns_chain.lane_launches) == before
    shapes = [(k, p, m), (k, m, m), (k, m), (k, m), (k, m), (k,)]
    assert [tuple(t.shape) for t in lanes] == shapes
    for r in range(k):
        one = CM.ns_chain_reference(ops[0][r], ops[1][r], ops[2][r],
                                    1 - 1e-6)
        for a, b in zip(lanes, one):
            assert float((a[r] - b).abs().max()) \
                <= 1e-6 * (float(b.abs().max()) + 1e-12)


def test_nan_lane_stays_in_its_lane():
    """A lane that diverges (NaN W0) rejects every step and stays frozen;
    the other lanes run exactly as in a sweep without it."""
    x = block_data(n=500, p=32, m=4, seed=3)
    _, dt = _operands(x, "gram")
    cfg = CorexConfig(n_hidden=4, dtype="float64", optimizer="fixed_point",
                      record_history=False)
    w0 = TR.init_restarts(2, 4, 32, seed=1, dtype=torch.float64,
                          device="cpu")
    bad = torch.full((1, 4, 32), float("nan"), dtype=torch.float64)
    ws3, mom3, d3 = TR.fit_restarts(dt, torch.cat([w0[:1], bad, w0[1:]]),
                                    cfg, "gram")
    ws2, mom2, d2 = TR.fit_restarts(dt, w0, cfg, "gram")
    assert torch.equal(d3.iters_per_stage[[0, 2]], d2.iters_per_stage)
    assert float((ws3[[0, 2]] - ws2).abs().max()) < 1e-12
    assert bool(torch.isnan(mom3.tc[1]))
    assert int(torch.argmax(mom3.tc)) == 1    # NaN wins argmax, as in JAX


def test_lane_oom_raises_guidance(monkeypatch):
    """A device OOM inside a sweep (estimator and selection) surfaces as
    LaneOutOfMemoryError with the lane-memory model in bytes and the
    remedies; other errors pass through untouched."""
    x = _lottery_data()

    def boom(*a, **k):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory.")

    monkeypatch.setattr(TR, "fit_restarts", boom)
    with pytest.raises(TR.LaneOutOfMemoryError, match="fewer lanes") as e:
        lct.Corex(n_restarts=3, seed=0, device="cpu", **KW).fit(x)
    assert f"{16 * 4 * 32 * 8} bytes a lane" in str(e.value)
    assert "TPU" not in str(e.value) and "p=100k" not in str(e.value)
    with pytest.raises(TR.LaneOutOfMemoryError, match="fewer lanes"):
        lct.pick_n_hidden(x, repeat=2, max_n_hidden=3, max_iter=50,
                          seed=0, device="cpu")

    def other(*a, **k):
        raise RuntimeError("something else")

    monkeypatch.setattr(TR, "fit_restarts", other)
    with pytest.raises(RuntimeError, match="something else"):
        lct.Corex(n_restarts=3, seed=0, device="cpu", **KW).fit(x)


def test_mesh_forms_raise_by_item():
    # the sweeps over a mesh run (tests/test_torch_sharding.py); what still
    # raises by item is a plan over the variable or factor axis, and a
    # mesh without an initialized process group raises by name
    from linearcorex_tpu_torch.parallel.sharding import ShardingPlan

    class NoRestartAxis:
        mesh_dim_names = ("data",)

    with pytest.raises(ValueError, match="restart batch shards over"):
        TR.restart_batch_runner(mesh=NoRestartAxis())
    with pytest.raises(RuntimeError, match="default process group"):
        TR.fit_restarts_sharded(None, None, None, "samples", object())
    with pytest.raises(RuntimeError, match="default process group"):
        lct.Corex(n_restarts=2, device="cpu", **KW).fit(
            _lottery_data(), mesh=object())
    with pytest.raises(ValueError, match="sample sharding only"):
        lct.Corex(n_restarts=2, device="cpu", **KW).fit(
            _lottery_data(), mesh=object(),
            sharding_plan=ShardingPlan(shard_vars=True))


def test_verbose_sweep_prints_the_winner(capsys):
    lct.Corex(n_restarts=2, seed=0, verbose=True, device="cpu",
              **dict(KW, record_history=True, max_iter=50)).fit(
        _lottery_data())
    out = capsys.readouterr().out
    assert out.count("iterations:") == 7
