"""Sharded fits of the PyTorch port (`parallel.sharding`, `Corex.fit(mesh=)`,
restart sweeps and `pick_n_hidden` over a mesh) on a four-rank CPU world.

PyTorch runs one process per device, so the module spawns ONE world of
four ranks (gloo, a file rendezvous, no network) per run; `_world` drives
every case inside it and hands numpy results back, which the parent
asserts as separate tests. The references are the port's own
single-device fits (W and TC within 1e-7, the JAX tests' bound, and the
same iterations per stage) and the JAX package's sharded fits on its
8-device CPU mesh (`tests/test_sharding.py`'s setup), from the same seeded
numpy X and RandomState W0.

This module imports neither JAX nor `tests.conftest` at the top: the
spawned ranks import it, and the port runs without JAX. Tests that need
the JAX reference import it inside the function.
"""

import datetime
import hashlib
import time
import warnings

import numpy as np
import pytest
import torch

import linearcorex_tpu_torch as lct
from linearcorex_tpu_torch.config import CorexConfig
from linearcorex_tpu_torch.models import corex as TC
from linearcorex_tpu_torch.ops import moments as TM
from linearcorex_tpu_torch.ops import preprocessing as TP
from linearcorex_tpu_torch.parallel import restarts as TR
from linearcorex_tpu_torch.parallel import sharding as S
from linearcorex_tpu_torch.parallel.launch import run_world

# One intra-op thread: the suite runs its files in parallel worker
# processes, and an OpenMP pool per process on every core slows the
# small tensors here several times over.
torch.set_num_threads(1)

TOL = 1e-7          # W and TC, sharded against single-device (float64)
WORLD = 4
WORLD_TIMEOUT = 480.0
KW64 = dict(n_hidden=8, dtype="float64", record_history=False)
# a few iterations per stage: enough where the case is about the layout
SHORT = dict(max_iter=40, **KW64)


def block_data(n=1000, p=64, m=8, seed=0, strength=0.9):
    """`tests.conftest.block_data`, copied: that module imports JAX."""
    rng = np.random.RandomState(seed)
    z = rng.normal(size=(n, m))
    k = p // m
    x = np.empty((n, p))
    for j in range(m):
        for i in range(k):
            x[:, j * k + i] = strength * z[:, j] + np.sqrt(
                1.0 - strength ** 2) * rng.normal(size=n)
    if p > m * k:
        x[:, m * k:] = rng.normal(size=(n, p - m * k))
    return x


def _x512():
    return block_data(n=512, p=64, m=8, seed=0)


def _w0():
    return np.random.RandomState(42).normal(scale=1 / 8, size=(8, 64))


def _x256():
    return block_data(n=256, p=64, m=4, seed=1)


def _std(x, dtype=torch.float64):
    return TP.fit_preprocess(torch.as_tensor(x, dtype=dtype), "standard")[0]


def _fit_out(ws, mom, diag):
    return dict(ws=ws.numpy(), tc=np.asarray(mom.tc.numpy()),
                iters=diag.iters_per_stage.numpy())


def _counts():
    return [tuple(k) + (v,) for k, v in S.collective_counts().items()]


def _raised(fn):
    """(exception type name, message) of what `fn` raises, or None."""
    try:
        fn()
    except Exception as e:   # the parent asserts type and message
        return type(e).__name__, str(e)
    return None


# ---------------------------------------------------------------------------
# The world: every case that needs more than one rank
# ---------------------------------------------------------------------------

def _world(rank):
    """Runs on every rank of the four-rank world. Returns {case: result};
    rank 0's results are asserted, and `digest` (a hash of every fitted W)
    is compared across ranks."""
    warnings.simplefilter("ignore")
    out, digest = {}, hashlib.sha1()
    timeout = datetime.timedelta(seconds=WORLD_TIMEOUT)

    def mesh_of(*axes):
        return S.make_mesh(tuple(axes), device="cpu", timeout=timeout)

    data4 = mesh_of(("data", 4))
    slice2 = mesh_of(("slice", 2), ("data", 2))
    restarts4 = mesh_of(("restarts", 4))
    r2d2 = mesh_of(("restarts", 2), ("data", 2))
    hybrid = S.make_hybrid_mesh((("slice", 2), ("data", 2)), device="cpu",
                                granule_key=lambda r: r % 2,
                                timeout=timeout)
    out["hybrid_ranks"] = hybrid.mesh.tolist()
    # slices in descending rank order: the lines of ranks along `slice`
    # are not ascending, and rows must still come back in mesh order
    flipped = S.make_hybrid_mesh((("slice", 2), ("data", 2)), device="cpu",
                                 granule_key=lambda r: -(r % 2),
                                 timeout=timeout)
    from linearcorex_tpu_torch.parallel.collectives import all_gather_rows
    out["flipped_ranks"] = flipped.mesh.tolist()
    out["flipped_rows"] = all_gather_rows(
        torch.tensor([rank]), S.sample_axes(
            flipped, S.ShardingPlan(shard_slices=True))).tolist()
    out["hybrid_names"] = tuple(hybrid.mesh_dim_names)

    x, w0 = _x512(), _w0()
    xp = _std(x)
    two_level = S.ShardingPlan(shard_samples=True, shard_slices=True)

    def keep(name, res):
        out[name] = _fit_out(*res)
        digest.update(out[name]["ws"].tobytes())

    # fit_sharded / fit_shard_map, both optimizers, data and slice x data
    for opt in ("momentum", "fixed_point"):
        cfg = CorexConfig(optimizer=opt, **KW64)
        S.reset_collective_counts()
        keep(f"sharded_{opt}", S.fit_sharded(xp.numpy(), w0, cfg, data4))
        out[f"counts_{opt}"] = _counts()
        short = CorexConfig(optimizer=opt, **SHORT)
        S.reset_collective_counts()
        keep(f"shard_map_{opt}", S.fit_shard_map(xp, w0, short, data4))
        out[f"counts_shard_map_{opt}"] = _counts()
        keep(f"short_{opt}", S.fit_sharded(xp, w0, short, data4))
        keep(f"short_again_{opt}", S.fit_sharded(xp, w0, short, data4))
        S.reset_collective_counts()
        keep(f"two_level_{opt}",
             S.fit_sharded(xp, w0, short, slice2, two_level))
        out[f"counts_two_level_{opt}"] = _counts()
    keep("sharded_auto", S.fit_sharded(
        xp, w0, CorexConfig(optimizer="auto", **SHORT), data4))
    keep("hybrid", S.fit_sharded(xp, w0, CorexConfig(**SHORT), hybrid,
                                 two_level))
    keep("overlap", S.fit_sharded(
        xp, w0, CorexConfig(discourage_overlap=False, max_iter=100, **KW64),
        data4))
    keep("replicated", S.fit_sharded(
        xp, w0, CorexConfig(**SHORT), data4,
        S.ShardingPlan(shard_samples=False)))
    keep("gram_replicated", S.fit_sharded(
        TM.compute_gram(xp), w0, CorexConfig(**SHORT), data4,
        strategy="gram", n_samples=512))
    keep("bf16", S.fit_sharded(
        _std(x, torch.float32), w0,
        CorexConfig(n_hidden=8, record_history=False, max_iter=60,
                    matmul_dtype="bfloat16", optimizer="fixed_point"),
        data4))
    x16 = _std(x, torch.float32).to(torch.bfloat16)
    v16 = torch.as_tensor(w0.T, dtype=torch.float32)
    rows16 = S.shard_samples(x16, S.sample_axes(data4, S.ShardingPlan()),
                             "cpu")
    out["bf16_apply"] = dict(
        sharded=TM._apply_sigma_t(rows16, True, False, torch.float32)(
            v16).numpy(),
        single=TM._apply_sigma_t(x16, True, False, torch.float32)(
            v16).numpy())

    # the estimator surface
    cm = lct.Corex(device="cpu", **SHORT).fit(x, init_ws=w0, mesh=data4)
    digest.update(cm.ws.numpy().tobytes())
    out["corex_mesh"] = dict(
        ws=cm.ws.numpy(), tc=cm.tc, iters=cm.diagnostics.iters_per_stage
        .numpy(), y=cm.transform(x), mean=cm.theta.mean.numpy(),
        std=cm.theta.std.numpy(), cov_finite=bool(np.isfinite(
            cm.get_covariance()).all()), plan=cm._serving_plan,
        optimizer=cm.resolved_optimizer_)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        cg = lct.Corex(device="cpu", moment_strategy="gram", max_iter=50,
                       **KW64).fit(x, init_ws=w0, mesh=data4)
    out["corex_gram"] = dict(ws=cg.ws.numpy(),
                             warned=[str(w.message) for w in rec])
    x3 = block_data(n=512, p=64, m=8, seed=3)
    w7 = np.random.RandomState(7).normal(scale=1 / 8, size=(8, 64))
    ce = lct.Corex(device="cpu", gaussianize="empirical",
                   moment_strategy="samples", **SHORT).fit(
        x3, init_ws=w7, mesh=data4)
    out["corex_empirical"] = dict(ws=ce.ws.numpy(), tc=ce.tc,
                                  y32=ce.transform(x3[:32]))
    xm = x.copy()
    xm[::7, 3] = -999.0
    cmiss = lct.Corex(device="cpu", missing_values=-999.0, max_iter=100,
                      moment_strategy="samples", **KW64).fit(
        xm, init_ws=w0, mesh=slice2, sharding_plan=two_level)
    out["corex_missing"] = dict(ws=cmiss.ws.numpy(), tc=cmiss.tc,
                                mean=cmiss.theta.mean.numpy())
    cf = lct.Corex(device="cpu", seed=0, **SHORT)
    out["fit_transform"] = dict(
        y=cf.fit_transform(x, mesh=data4), plan=cf._serving_plan)
    # unseeded: the ranks share one drawn seed (the digest compares them)
    cu = lct.Corex(device="cpu", max_iter=30, **KW64).fit(x, mesh=data4)
    digest.update(cu.ws.numpy().tobytes())

    # serving under sample plans
    for name, mesh, plan in (("data", data4, S.ShardingPlan()),
                             ("two_level", slice2, two_level)):
        sm = lct.Corex(device="cpu", moment_strategy="samples", seed=0,
                       **SHORT).fit(x, init_ws=w0)
        y = sm.transform(x, mesh=mesh, sharding_plan=plan)
        v = np.random.RandomState(3).normal(size=64)
        vb = np.random.RandomState(4).normal(size=(64, 5))
        out[f"serving_{name}"] = dict(
            y=y,
            xh=sm.predict(y, mesh=mesh),   # sticky plan
            score=float(sm.score(x, mesh=mesh, sharding_plan=plan)),
            mv=sm.covariance_matvec(v, mesh=mesh),
            mm=sm.covariance_matmat(vb, mesh=mesh,
                                    sharding_plan=plan),
            blocks=np.vstack([r for _, r in sm.covariance_blocks(
                24, mesh=mesh)]),
            sticky=sm._serving_plan == plan)
    se = lct.Corex(device="cpu", moment_strategy="samples", seed=0,
                   gaussianize="empirical", **SHORT).fit(x, init_ws=w0)
    y, det = se.transform(x, details=True, mesh=data4)
    out["serving_details"] = dict(y=y, tc=float(det["TC"]),
                                  rho=det["rho"])
    sm = lct.Corex(device="cpu", moment_strategy="samples", seed=0,
                   **SHORT).fit(x, init_ws=w0)
    out["serving_errors"] = dict(
        rows=_raised(lambda: sm.transform(x[:510], mesh=data4)),
        axis=_raised(lambda: sm.transform(x, mesh=restarts4)))

    # int8: the sharded Σ-application is bitwise the single-device one
    x32 = _std(x, torch.float32)
    qd = TM.quantize_samples(x32)
    axes = S.sample_axes(data4, S.ShardingPlan())
    qs = S.shard_samples(qd, axes, "cpu")
    v = torch.as_tensor(np.random.RandomState(5).normal(size=(64, 24)),
                        dtype=torch.float32)
    xs = TM.ShardedSamples(S.shard_rows(x32, axes, "cpu"), 512, axes)
    q_sharded = TM.quantize_samples(xs)
    out["int8_apply"] = dict(
        sharded=TM._apply_sigma_int8(qs, v).numpy(),
        single=TM._apply_sigma_int8(qd, v).numpy(),
        scale_equal=bool(q_sharded.local.scale == qd.scale),
        q_equal=bool(torch.equal(
            q_sharded.local.q, S.shard_rows(qd.q, axes, "cpu"))))
    cfg8 = CorexConfig(n_hidden=8, record_history=False, max_iter=80,
                       matmul_dtype="int8", moment_strategy="samples",
                       tol=1e-4)
    w32 = w0.astype(np.float32)
    S.reset_collective_counts()
    keep("int8_sharded", S.fit_sharded(qd, w32, cfg8, data4))
    out["counts_int8"] = _counts()
    rs = np.random.RandomState(0)
    xw = np.tile(rs.choice([-1.0, 1.0], size=(1 << 18, 1)),
                 (1, 16)).astype(np.float32)
    guard = lct.Corex(n_hidden=2, matmul_dtype="int8", device="cpu",
                      record_history=False, moment_strategy="samples")
    out["int8_guard"] = _raised(lambda: guard._prepare_fit(
        xw, resolve=False, plan=S.ShardingPlan(), mesh=data4))
    del xw

    # named rejections that need an axis of more than one rank
    x502 = block_data(n=502, p=64, m=8, seed=0)
    cfg = CorexConfig(**KW64)
    out["errors"] = dict(
        gram_rows=_raised(lambda: lct.Corex(
            n_hidden=8, record_history=False, moment_strategy="gram",
            device="cpu")._prepare_fit(x502, resolve=False,
                                       plan=S.ShardingPlan(), mesh=data4)),
        rows=_raised(lambda: S.fit_sharded(x502, w0, cfg, data4)),
        axis=_raised(lambda: S.fit_sharded(xp, w0, cfg, restarts4)),
        shard_map_rows=_raised(lambda: S.fit_shard_map(
            torch.as_tensor(x502), w0, cfg, data4)),
        shard_map_axis=_raised(lambda: S.fit_shard_map(
            xp, w0, cfg, restarts4)),
        stage_subsample=_raised(lambda: lct.Corex(
            device="cpu", stage_subsample=0.5, moment_strategy="samples",
            **KW64).fit(x, mesh=data4)),
        no_restart_axis=_raised(lambda: lct.Corex(
            device="cpu", n_restarts=2, seed=0, **KW64).fit(x, mesh=data4)),
        restart_slices=_raised(lambda: lct.Corex(
            device="cpu", n_restarts=2, seed=0, **KW64).fit(
            x, mesh=r2d2, sharding_plan=two_level)),
        hybrid_first=_raised(lambda: S.make_hybrid_mesh(
            (("data", 4),), device="cpu", granule_key=lambda r: 0)),
        hybrid_devices=_raised(lambda: S.make_hybrid_mesh(
            (("slice", 2), ("data", 8)), device="cpu",
            granule_key=lambda r: r % 2)),
        hybrid_slices=_raised(lambda: S.make_hybrid_mesh(
            (("slice", 4), ("data", 1)), device="cpu",
            granule_key=lambda r: r % 2)),
        hybrid_no_key=_raised(lambda: S.make_hybrid_mesh(
            (("slice", 1), ("data", 4)), device="cpu")),
        mesh_ranks=_raised(lambda: S.make_mesh((("data", 8),),
                                               device="cpu")),
        device=_raised(lambda: S.check_mesh(data4, "cuda")),
    )

    # restart sweeps
    x2 = _x256()
    xp2 = _std(x2)
    cfg_r = CorexConfig(n_hidden=4, dtype="float64", record_history=False,
                        max_iter=150)
    w8 = TR.init_restarts(8, 4, 64, seed=3, dtype=torch.float64,
                          device="cpu")
    S.reset_collective_counts()
    keep("restarts4", TR.fit_restarts_sharded(xp2, w8, cfg_r, "samples",
                                              restarts4))
    out["counts_restarts4"] = _counts()
    cfg_rs = CorexConfig(n_hidden=4, dtype="float64", record_history=False,
                         max_iter=150, moment_strategy="samples")
    S.reset_collective_counts()
    keep("r2d2", TR.fit_restarts_sharded(xp2, w8[:4], cfg_rs, "samples",
                                         r2d2, data_axis="data"))
    out["counts_r2d2"] = _counts()
    run = TR.restart_batch_runner(restarts4)
    keep("padded3", run(xp2, w8[:3], cfg_r, "samples", 256))
    gram = torch.eye(16, dtype=torch.float32)
    w2 = TR.init_restarts(4, 2, 16, seed=0, device="cpu")
    cfg2 = CorexConfig(n_hidden=2, record_history=False)
    out["restart_errors"] = dict(
        gram=_raised(lambda: TR.fit_restarts_sharded(
            gram, w2, cfg2, "gram", r2d2, data_axis="data", n_samples=100)),
        rows=_raised(lambda: TR.fit_restarts_sharded(
            torch.zeros((31, 16)), w2, cfg2, "samples", r2d2,
            data_axis="data")),
        batch=_raised(lambda: TR.fit_restarts_sharded(
            xp2, w8[:3], cfg_r, "samples", restarts4)),
        runner_axis=_raised(lambda: TR.restart_batch_runner(data4)))
    xl = block_data(n=256, p=32, m=4, seed=3, strength=0.3)
    kw = dict(n_hidden=4, dtype="float64", record_history=False,
              moment_strategy="samples", max_iter=100, n_restarts=4, seed=0,
              device="cpu")
    for name, mesh in (("restarts4", restarts4), ("r2d2", r2d2)):
        c = lct.Corex(**kw).fit(xl, mesh=mesh)
        digest.update(c.ws.numpy().tobytes())
        out[f"corex_{name}"] = dict(
            ws=c.ws.numpy(), tc=c.tc, best=c.best_restart_,
            plan=c._serving_plan,
            y=c.fit_transform(xl, mesh=mesh))
    xs4 = block_data(n=400, p=16, m=2, seed=4)
    skw = dict(repeat=2, max_n_hidden=3, seed=0, max_iter=100,
               dtype="float64", device="cpu")
    out["pick_restarts4"] = lct.pick_n_hidden(xs4, mesh=restarts4, **skw)
    out["pick_r2d2"] = lct.pick_n_hidden(xs4, mesh=r2d2, data_axis="data",
                                         **skw)
    out["pick_heldout"] = lct.pick_n_hidden(
        xs4, mesh=r2d2, data_axis="data", criterion="heldout",
        padded_sweep=False, **skw)
    out["digest"] = digest.hexdigest()
    if rank:
        return {"digest": out["digest"]}
    return out


@pytest.fixture(scope="module")
def world():
    t0 = time.monotonic()
    ranks = run_world(_world, WORLD, backend="gloo", timeout=WORLD_TIMEOUT)
    res = ranks[0]
    res["all_digests"] = [r["digest"] for r in ranks]
    res["seconds"] = time.monotonic() - t0
    return res


# -- single-device references, computed once in the parent -------------------

@pytest.fixture(scope="module")
def single():
    """The port's single-device samples fits from the same X and W0."""
    xp, w0 = _std(_x512()), torch.as_tensor(_w0())
    out = {}
    for name, kw in (("momentum", dict(optimizer="momentum", **KW64)),
                     ("fixed_point", dict(optimizer="fixed_point", **KW64)),
                     ("short_momentum", dict(optimizer="momentum", **SHORT)),
                     ("short_fixed_point", dict(optimizer="fixed_point",
                                                **SHORT)),
                     ("overlap", dict(discourage_overlap=False,
                                      **dict(KW64, max_iter=100)))):
        cfg = TC.resolve_config(CorexConfig(**kw), 64, "cpu", 512)
        out[name] = _fit_out(*TC._fit_program(xp, w0, cfg, "samples"))
    cfg = TC.resolve_config(CorexConfig(**SHORT), 64, "cpu", 512)
    out["gram"] = _fit_out(*TC._fit_program(TM.compute_gram(xp), w0, cfg,
                                            "gram"))
    return out


def _close(got, ref, tol=TOL):
    assert np.abs(got["ws"] - ref["ws"]).max() < tol
    assert np.abs(got["tc"] - ref["tc"]).max() < tol
    assert got["iters"].tolist() == ref["iters"].tolist()


@pytest.mark.parametrize("optimizer", ["momentum", "fixed_point"])
def test_data_sharded_fit(world, single, optimizer):
    _close(world[f"sharded_{optimizer}"], single[optimizer])


@pytest.mark.parametrize("optimizer", ["momentum", "fixed_point"])
def test_sharded_deterministic(world, optimizer):
    a, b = world[f"short_{optimizer}"], world[f"short_again_{optimizer}"]
    assert np.array_equal(a["ws"], b["ws"]) and a["tc"] == b["tc"]


def test_every_rank_ends_with_the_same_bits(world):
    assert len(set(world["all_digests"])) == 1
    assert len(world["all_digests"]) == WORLD


def test_shard_map_explicit_psum_matches(world, single):
    _close(world["shard_map_momentum"], single["short_momentum"])
    assert np.abs(world["shard_map_momentum"]["ws"]
                  - world["short_momentum"]["ws"]).max() < TOL


def test_shard_map_fixed_point_matches_single_device(world, single):
    _close(world["shard_map_fixed_point"], single["short_fixed_point"])


@pytest.mark.parametrize("optimizer", ["momentum", "fixed_point"])
def test_multislice_two_level_dp_equivalence(world, single, optimizer):
    _close(world[f"two_level_{optimizer}"], single[f"short_{optimizer}"])


def test_sharded_fit_resolves_optimizer_auto(world):
    a, f = world["sharded_auto"], world["short_fixed_point"]
    assert np.array_equal(a["ws"], f["ws"]) and a["tc"] == f["tc"]


def test_overlap_objective_runs_sharded(world, single):
    _close(world["overlap"], single["overlap"])


def test_replicated_plan_and_gram_run_whole_on_every_rank(world, single):
    assert np.array_equal(world["replicated"]["ws"],
                          single["short_momentum"]["ws"])
    assert np.array_equal(world["gram_replicated"]["ws"],
                          single["gram"]["ws"])


def test_bf16_partials_sum_in_float32(world):
    x32 = _std(_x512(), torch.float32)
    cfg = TC.resolve_config(CorexConfig(
        n_hidden=8, record_history=False, max_iter=60,
        matmul_dtype="bfloat16", optimizer="fixed_point"), 64, "cpu", 512)
    ref = _fit_out(*TC._fit_program(
        x32, torch.as_tensor(_w0(), dtype=torch.float32), cfg, "samples"))
    got = world["bf16"]
    assert got["ws"].dtype == np.float32
    # a fit under bf16 operand noise scatters (tests/test_torch_operands):
    # the fits agree to 1e-2, one Σ-application to float32 rounding
    assert abs(float(got["tc"]) - float(ref["tc"])) < 1e-2 * abs(
        float(ref["tc"]))
    a = world["bf16_apply"]
    assert a["sharded"].dtype == np.float32
    assert np.abs(a["sharded"] - a["single"]).max() < 1e-5 * np.abs(
        a["single"]).max()


def test_corex_fit_with_mesh_matches_plain_fit(world):
    x, w0 = _x512(), _w0()
    cs = lct.Corex(device="cpu", moment_strategy="samples", **SHORT).fit(
        x, init_ws=w0)
    got = world["corex_mesh"]
    assert abs(got["tc"] - cs.tc) < TOL
    assert np.abs(got["ws"] - cs.ws.numpy()).max() < TOL
    assert got["iters"].tolist() == cs.diagnostics.iters_per_stage.tolist()
    assert np.abs(got["y"] - cs.transform(x)).max() < TOL
    assert np.abs(got["mean"] - cs.theta.mean.numpy()).max() < 1e-12
    assert np.abs(got["std"] - cs.theta.std.numpy()).max() < 1e-12
    assert got["cov_finite"] and got["plan"] == S.ShardingPlan()
    assert got["optimizer"] == cs.resolved_optimizer_


def test_explicit_gram_under_a_sample_plan_warns_and_runs_replicated(world):
    x, w0 = _x512(), _w0()
    cs = lct.Corex(device="cpu", moment_strategy="gram", max_iter=50,
                   **KW64).fit(x, init_ws=w0)
    assert np.abs(world["corex_gram"]["ws"] - cs.ws.numpy()).max() < TOL
    assert any("REPLICATED" in w for w in world["corex_gram"]["warned"])


def test_mesh_fit_with_gaussianize_matches_single_device(world):
    x3 = block_data(n=512, p=64, m=8, seed=3)
    w7 = np.random.RandomState(7).normal(scale=1 / 8, size=(8, 64))
    cs = lct.Corex(device="cpu", gaussianize="empirical",
                   moment_strategy="samples", **SHORT).fit(x3, init_ws=w7)
    got = world["corex_empirical"]
    assert abs(got["tc"] - cs.tc) < TOL
    assert np.abs(got["ws"] - cs.ws.numpy()).max() < TOL
    assert np.abs(got["y32"] - cs.transform(x3[:32])).max() < TOL


def test_mesh_fit_imputes_missing_values_over_all_rows(world):
    x, w0 = _x512(), _w0()
    x[::7, 3] = -999.0
    cs = lct.Corex(device="cpu", missing_values=-999.0, max_iter=100,
                   moment_strategy="samples", **KW64).fit(x, init_ws=w0)
    got = world["corex_missing"]
    assert np.abs(got["mean"] - cs.theta.mean.numpy()).max() < 1e-12
    assert abs(got["tc"] - cs.tc) < TOL
    assert np.abs(got["ws"] - cs.ws.numpy()).max() < TOL


def test_fit_transform_threads_mesh(world):
    x = _x512()
    y_ref = lct.Corex(device="cpu", moment_strategy="samples", seed=0,
                      **SHORT).fit_transform(x)
    assert np.abs(world["fit_transform"]["y"] - y_ref).max() < TOL
    assert world["fit_transform"]["plan"] == S.ShardingPlan()


@pytest.fixture(scope="module")
def served():
    x, w0 = _x512(), _w0()
    return x, lct.Corex(device="cpu", moment_strategy="samples", seed=0,
                        **SHORT).fit(x, init_ws=w0)


@pytest.mark.parametrize("layout", ["data", "two_level"])
def test_serving_mesh_equivalence_nonoverlap(world, served, layout):
    x, cs = served
    got = world[f"serving_{layout}"]
    y_ref = cs.transform(x)
    assert np.abs(got["y"] - y_ref).max() < 1e-9
    assert np.abs(got["xh"] - cs.predict(y_ref)).max() < 1e-9
    assert abs(got["score"] - float(cs.score(x))) < 1e-9
    v = np.random.RandomState(3).normal(size=64)
    vb = np.random.RandomState(4).normal(size=(64, 5))
    assert np.abs(got["mv"] - cs.covariance_matvec(v)).max() < 1e-9
    assert np.abs(got["mm"] - cs.covariance_matmat(vb)).max() < 1e-9
    assert np.array_equal(got["blocks"], cs.get_covariance()) or \
        np.abs(got["blocks"] - cs.get_covariance()).max() < 1e-12
    assert got["sticky"]


def test_serving_mesh_details_and_empirical(world):
    x, w0 = _x512(), _w0()
    cs = lct.Corex(device="cpu", moment_strategy="samples", seed=0,
                   gaussianize="empirical", **SHORT).fit(x, init_ws=w0)
    y_ref, det_ref = cs.transform(x, details=True)
    got = world["serving_details"]
    assert np.abs(got["y"] - y_ref).max() < 1e-9
    assert abs(got["tc"] - float(det_ref["TC"])) < 1e-9
    assert np.abs(got["rho"] - det_ref["rho"]).max() < 1e-9


def test_serving_mesh_divisibility_error(world):
    rows, axis = world["serving_errors"]["rows"], \
        world["serving_errors"]["axis"]
    assert rows[0] == "ValueError" and "divisible" in rows[1]
    assert axis[0] == "ValueError" and "mesh has axes" in axis[1]


def test_sharded_int8_sigma_application_is_bitwise(world):
    got = world["int8_apply"]
    assert np.array_equal(got["sharded"], got["single"])
    assert got["scale_equal"] and got["q_equal"]


def test_sharded_int8_fit_follows_the_single_device_fit(world):
    x32 = _std(_x512(), torch.float32)
    cfg8 = TC.resolve_config(CorexConfig(
        n_hidden=8, record_history=False, max_iter=80, matmul_dtype="int8",
        moment_strategy="samples", tol=1e-4), 64, "cpu", 512)
    ref = _fit_out(*TC._fit_program(
        TM.quantize_samples(x32),
        torch.as_tensor(_w0(), dtype=torch.float32), cfg8, "samples"))
    got = world["int8_sharded"]
    # every iteration's operands are bitwise equal; only the final exact
    # float32 moments sum in another order
    assert got["iters"].tolist() == ref["iters"].tolist()
    assert np.array_equal(got["ws"], ref["ws"])
    assert abs(float(got["tc"]) - float(ref["tc"])) < 1e-4


def test_mesh_aware_prepare_int8_still_guarded(world):
    kind, msg = world["int8_guard"]
    assert kind == "ValueError" and "overflow" in msg


def test_mesh_aware_prepare_gram_non_dividing_n_fails_by_name(world):
    kind, msg = world["errors"]["gram_rows"]
    assert kind == "ValueError" and "n_samples" in msg


@pytest.mark.parametrize("case,kind,text", [
    ("rows", "ValueError", "not divisible"),
    ("axis", "ValueError", "mesh has axes"),
    ("shard_map_rows", "ValueError", "must divide"),
    ("shard_map_axis", "ValueError", "must divide"),
    ("stage_subsample", "ValueError", "stage_subsample < 1 is not supported "
                                      "under fit(mesh=...)"),
    ("no_restart_axis", "ValueError", "'restarts'"),
    ("restart_slices", "ValueError", "sample sharding only"),
    ("mesh_ranks", "ValueError", "need 8 ranks"),
    ("device", "ValueError", "the mesh is over"),
])
def test_named_rejections_in_the_world(world, case, kind, text):
    got = world["errors"][case]
    assert got is not None and got[0] == kind and text in got[1], got


def test_make_hybrid_mesh_granule_key(world):
    """Slices follow the key (rank % 2: interleaved), ordered by sorted
    key, and a two-level fit on that mesh equals the single-device fit."""
    assert world["hybrid_names"] == ("slice", "data")
    assert world["hybrid_ranks"] == [[0, 2], [1, 3]]
    assert world["flipped_ranks"] == [[1, 3], [0, 2]]
    assert world["flipped_rows"] == [1, 3, 0, 2]


def test_make_hybrid_mesh_fit(world, single):
    _close(world["hybrid"], single["short_momentum"])


@pytest.mark.parametrize("case,text", [
    ("hybrid_first", "first axis"), ("hybrid_devices", "devices"),
    ("hybrid_slices", "slices"), ("hybrid_no_key", "granule_key")])
def test_make_hybrid_mesh_validation(world, case, text):
    kind, msg = world["errors"][case]
    assert kind == "ValueError" and text in msg


@pytest.fixture(scope="module")
def sweep():
    """The one-device sweep from the same init stack."""
    xp2 = _std(_x256())
    w8 = TR.init_restarts(8, 4, 64, seed=3, dtype=torch.float64,
                          device="cpu")
    cfg = CorexConfig(n_hidden=4, dtype="float64", record_history=False,
                      max_iter=150)
    return _fit_out(*TR.fit_restarts(xp2, w8, cfg, "samples"))


def _lanes_close(got, ref, lanes, tol):
    assert got["ws"].shape[0] == lanes
    assert np.abs(got["ws"] - ref["ws"][:lanes]).max() < tol
    assert np.abs(got["tc"] - ref["tc"][:lanes]).max() < tol
    assert got["iters"].tolist() == ref["iters"][:lanes].tolist()


def test_restart_axis_sharded_matches_unsharded(world, sweep):
    _lanes_close(world["restarts4"], sweep, 8, 1e-8)


def test_restarts_x_data_2d_layout_matches_unsharded(world, sweep):
    _lanes_close(world["r2d2"], sweep, 4, 1e-7)


def test_restart_batch_is_padded_and_the_padding_dropped(world, sweep):
    assert TR.padded_lanes(3, 4) == 4
    _lanes_close(world["padded3"], sweep, 3, 1e-8)


@pytest.mark.parametrize("case,text", [
    ("gram", "Gram"), ("rows", "divide"), ("batch", "must divide"),
    ("runner_axis", "restart batch shards over")])
def test_restarts_x_data_validation(world, case, text):
    kind, msg = world["restart_errors"][case]
    assert kind == "ValueError" and text in msg


@pytest.mark.parametrize("layout", ["restarts4", "r2d2"])
def test_corex_restarts_over_a_mesh_pick_the_same_winner(world, layout):
    xl = block_data(n=256, p=32, m=4, seed=3, strength=0.3)
    cs = lct.Corex(n_hidden=4, dtype="float64", record_history=False,
                   moment_strategy="samples", max_iter=100, n_restarts=4,
                   seed=0, device="cpu").fit(xl)
    got = world[f"corex_{layout}"]
    assert got["best"] == cs.best_restart_
    assert abs(got["tc"] - cs.tc) < TOL
    assert np.abs(got["ws"] - cs.ws.numpy()).max() < TOL
    assert np.abs(got["y"] - cs.transform(xl)).max() < TOL
    assert got["plan"] == (S.ShardingPlan() if layout == "r2d2" else None)


@pytest.mark.parametrize("case,kw", [
    ("pick_restarts4", {}), ("pick_r2d2", {}),
    ("pick_heldout", dict(criterion="heldout", padded_sweep=False))])
def test_pick_n_hidden_over_a_mesh_picks_the_same_m(world, case, kw):
    xs4 = block_data(n=400, p=16, m=2, seed=4)
    if case != "pick_restarts4":
        kw = dict(kw, moment_strategy="samples")   # the data_axis rule
    best, scores = lct.pick_n_hidden(
        xs4, repeat=2, max_n_hidden=3, seed=0, max_iter=100,
        dtype="float64", device="cpu", **kw)
    got_best, got_scores = world[case]
    assert got_best == best
    assert np.abs(got_scores - scores).max() < 1e-7


# -- the collectives a fit makes (in place of the HLO audit) ----------------

def _evals(fit):
    """Objective evaluations of a fit: one per iteration, one per stage."""
    return int(fit["iters"].sum()) + len(fit["iters"])


def test_dp_comm_surface_is_pxm_allreduce_only(world):
    """A data-sharded fit makes SUM all-reduces of the (p, m)
    cross-moment only: one per objective evaluation on the fixed point,
    two on the momentum path, and one for the final moments."""
    for opt, per_eval in (("fixed_point", 1), ("momentum", 2)):
        for name, fit in ((f"counts_{opt}", f"sharded_{opt}"),
                          (f"counts_shard_map_{opt}", f"shard_map_{opt}")):
            counts = world[name]
            assert len(counts) == 1, counts
            kind, op, axis, dtype, numel, nbytes, calls = counts[0]
            assert (kind, op, axis, dtype) == ("all_reduce", "sum", "data",
                                               "float64")
            assert numel == 64 * 8 and nbytes == 64 * 8 * 8
            assert calls == per_eval * _evals(world[fit]) + 1


def test_multislice_comm_surface_reduces_data_then_slice(world):
    counts = world["counts_two_level_momentum"]
    assert [c[:3] for c in counts] == [("all_reduce", "sum", "data"),
                                       ("all_reduce", "sum", "slice")]
    assert counts[0][-1] == counts[1][-1]
    assert all(c[4] == 64 * 8 for c in counts)


def test_int8_comm_surface(world):
    """int8: the (p, m) int32 partials and the per-column maxima (m
    floats) of the requantization; the final exact moments in float32."""
    kinds = {(c[1], c[3], c[4]) for c in world["counts_int8"]}
    assert kinds == {("max", "float32", 8), ("sum", "int32", 64 * 8),
                     ("sum", "float32", 64 * 8)}
    assert all(c[0] == "all_reduce" and c[2] == "data"
               for c in world["counts_int8"])


def test_restarts_x_data_comm_surface(world):
    """restarts x data: the (p, lanes·m) partials ride 'data' only;
    nothing rides 'restarts' but the gathers that end the sweep."""
    counts = world["counts_r2d2"]
    on_data = [c for c in counts if c[2] == "data"]
    on_restarts = [c for c in counts if c[2] == "restarts"]
    assert len(on_data) + len(on_restarts) == len(counts)
    lanes_per_group = 2
    for c in on_data:
        assert c[:2] == ("all_reduce", "sum")
        assert c[4] == 64 * lanes_per_group * 4       # p x (lanes·m)
    assert on_restarts and all(c[0] == "all_gather" and c[-1] == 1
                               for c in on_restarts)
    assert len(on_restarts) == 2                      # floats, counts
    only = world["counts_restarts4"]
    assert all(c[0] == "all_gather" and c[2] == "restarts" for c in only)


# -- against the JAX package's sharded fits ----------------------------------

@pytest.mark.parametrize("optimizer", ["momentum", "fixed_point"])
def test_sharded_fit_matches_the_jax_sharded_fit(world, optimizer):
    """The same seeded X and RandomState W0 through `linearcorex_tpu`'s
    `fit_sharded` on its 8-device CPU mesh and through the port's on four
    ranks."""
    import jax.numpy as jnp

    from linearcorex_tpu.config import CorexConfig as JaxConfig
    from linearcorex_tpu.ops import preprocessing as JP
    from linearcorex_tpu.parallel import sharding as JS
    xp, _ = JP.fit_preprocess(jnp.asarray(_x512(), jnp.float64), "standard")
    ws, mom, diag = JS.fit_sharded(
        xp, jnp.asarray(_w0(), jnp.float64),
        JaxConfig(optimizer=optimizer, **KW64),
        JS.make_mesh(((JS.DATA_AXIS, 8),)), JS.ShardingPlan())
    got = world[f"sharded_{optimizer}"]
    assert np.abs(got["ws"] - np.asarray(ws)).max() < TOL
    assert abs(float(got["tc"]) - float(mom.tc)) < TOL
    assert got["iters"].tolist() == np.asarray(
        diag.iters_per_stage).tolist()


def test_restart_sweep_matches_the_jax_sharded_sweep(world):
    import jax.numpy as jnp

    from linearcorex_tpu.config import CorexConfig as JaxConfig
    from linearcorex_tpu.ops import preprocessing as JP
    from linearcorex_tpu.parallel import restarts as JR
    from linearcorex_tpu.parallel.sharding import make_mesh
    xp, _ = JP.fit_preprocess(jnp.asarray(_x256(), jnp.float64), "standard")
    cfg = JaxConfig(n_hidden=4, dtype="float64", record_history=False,
                    max_iter=150, moment_strategy="samples")
    w0 = JR.init_restarts(4, 4, 64, seed=3, dtype=jnp.float64)
    ws, mom, diag = JR.fit_restarts_sharded(
        xp, w0, cfg, "samples", make_mesh((("restarts", 2), ("data", 4))),
        data_axis="data")
    got = world["r2d2"]
    assert np.abs(got["ws"] - np.asarray(ws)).max() < TOL
    assert np.abs(got["tc"] - np.asarray(mom.tc)).max() < TOL
    assert got["iters"].tolist() == np.asarray(
        diag.iters_per_stage).tolist()


# -- single-process tests (no world) -----------------------------------------

PLANS = [dict(), dict(shard_samples=False), dict(shard_vars=True),
         dict(shard_factors=True), dict(shard_slices=True),
         dict(shard_samples=False, shard_slices=True),
         dict(shard_samples=False, shard_vars=True, shard_factors=True),
         dict(shard_samples=True, shard_vars=True, shard_slices=True)]


def _norm(spec):
    """A JAX PartitionSpec or the port's tuple spec as nested tuples."""
    return tuple(tuple(a) if isinstance(a, (tuple, list)) else a
                 for a in spec)


@pytest.mark.parametrize("flags", PLANS)
def test_sharding_plan_specs_equal_the_jax_package(flags):
    from linearcorex_tpu.parallel import sharding as JS
    a, b = S.ShardingPlan(**flags), JS.ShardingPlan(**flags)
    assert (S.DATA_AXIS, S.VAR_AXIS, S.FACTOR_AXIS, S.SLICE_AXIS) == (
        JS.DATA_AXIS, JS.VAR_AXIS, JS.FACTOR_AXIS, JS.SLICE_AXIS)
    assert _norm(a.x_spec()) == _norm(b.x_spec())
    assert _norm(a.w_spec()) == _norm(b.w_spec())
    assert _norm(a.y_spec()) == _norm(b.y_spec())
    for ndim in (1, 2, 3):
        got, want = _norm(a.v_spec(ndim)), _norm(b.v_spec(ndim))
        assert got[:len(want)] == want and not any(got[len(want):])
    for strategy in ("samples", "gram"):
        if strategy == "gram" and a.shard_slices:
            for mod, plan in ((S, a), (JS, b)):
                with pytest.raises(ValueError, match="[Gg]ram"):
                    mod.operand_specs(plan, strategy)
            continue
        got, want = S.operand_specs(a, strategy), JS.operand_specs(
            b, strategy)
        for g, w in zip(got, want):
            g, w = _norm(g), _norm(w)
            assert g[:len(w)] == w and not any(g[len(w):])
    assert hash(a) == hash(S.ShardingPlan(**flags))


def test_gram_operand_rejects_slice_axis():
    with pytest.raises(ValueError, match="[Gg]ram"):
        S.operand_specs(S.ShardingPlan(shard_slices=True), "gram")


class _Mesh:
    """Names and shape of a mesh: all `validate_plan_shapes` reads."""

    def __init__(self, *axes):
        self.mesh_dim_names = tuple(a for a, _ in axes)
        self.mesh = np.zeros(tuple(s for _, s in axes))


@pytest.mark.parametrize("flags,axes,strategy,n,p,m,raw_x", [
    (dict(), (("data", 8),), "samples", 512, 64, 8, False),
    (dict(), (("data", 8),), "samples", 510, 64, 8, False),
    (dict(), (("data", 8),), "gram", 510, 64, 8, False),
    (dict(), (("data", 8),), "gram", 510, 64, 8, True),
    (dict(), (("var", 8),), "samples", 512, 64, 8, False),
    (dict(shard_slices=True), (("slice", 2), ("data", 4)), "samples", 508,
     64, 8, False),
    (dict(shard_slices=True), (("slice", 2), ("data", 4)), "samples", 512,
     64, 8, False),
    (dict(shard_samples=False, shard_vars=True), (("var", 8),), "samples",
     512, 60, 8, False),
    (dict(shard_samples=False, shard_factors=True), (("model", 4),),
     "samples", 512, 64, 6, False),
    (dict(shard_samples=False, shard_factors=True), (("model", 4),),
     "samples", None, 64, 8, False),
    (dict(), (("data", 8),), "samples", None, 64, 8, True),
])
def test_validate_plan_shapes_equals_the_jax_package(flags, axes, strategy,
                                                     n, p, m, raw_x):
    import jax

    from linearcorex_tpu.parallel import sharding as JS
    jmesh = JS.make_mesh(axes, jax.devices()[:int(np.prod(
        [s for _, s in axes]))])
    want = _raised(lambda: JS.validate_plan_shapes(
        JS.ShardingPlan(**flags), strategy, jmesh, n, p, m, raw_x=raw_x))
    got = _raised(lambda: S.validate_plan_shapes(
        S.ShardingPlan(**flags), strategy, _Mesh(*axes), n, p, m,
        raw_x=raw_x))
    assert (got is None) == (want is None)
    if want is not None:
        assert got[0] == want[0]
        # the same sentence up to the clause that names the compiler
        assert got[1].split(";")[0] == want[1].split(";")[0]


@pytest.mark.parametrize("batch,axis", [(1, 1), (3, 4), (8, 4), (9, 4),
                                        (32, 8), (5, 2), (7, 7)])
def test_padded_lanes_equals_the_jax_package(batch, axis):
    from linearcorex_tpu.parallel.restarts import padded_lanes
    assert TR.padded_lanes(batch, axis) == padded_lanes(batch, axis)


def test_pick_fit_strategy_follows_the_plan_rule():
    from linearcorex_tpu.config import CorexConfig as JaxConfig
    from linearcorex_tpu.models.corex import pick_fit_strategy
    from linearcorex_tpu.parallel.sharding import ShardingPlan as JPlan
    for flags in PLANS + [None]:
        for ms in ("auto", "samples", "gram"):
            for n, p in ((512, 64), (20, 64)):
                with warnings.catch_warnings(record=True) as got_w:
                    warnings.simplefilter("always")
                    got = TC.pick_fit_strategy(
                        CorexConfig(moment_strategy=ms), n, p,
                        None if flags is None else S.ShardingPlan(**flags))
                with warnings.catch_warnings(record=True) as want_w:
                    warnings.simplefilter("always")
                    want = pick_fit_strategy(
                        JaxConfig(moment_strategy=ms), n, p,
                        None if flags is None else JPlan(**flags))
                assert got == want and len(got_w) == len(want_w)


def test_resolve_sharded_config_turns_the_chain_off_for_var_plans():
    mesh = _Mesh(("var", 2))
    mesh.device_type = "cuda"
    cfg = CorexConfig(n_hidden=8)
    on = S.resolve_sharded_config(cfg, mesh, S.ShardingPlan(), 64, 512)
    off = S.resolve_sharded_config(
        cfg, mesh, S.ShardingPlan(shard_samples=False, shard_vars=True), 64,
        512)
    assert on.use_pallas == "always" and off.use_pallas == "never"
    assert on.optimizer == off.optimizer == "momentum"


def test_moment_input_entry_points_still_raise_naming_item_17e(tmp_path):
    x = _x512()
    acc = lct.GramAccumulator(64, device="cpu")
    acc.update(x)
    stack = lct.StackedCorex([4, 1], device="cpu", max_iter=20).fit(x)
    from linearcorex_tpu_torch.utils.checkpoint import fit_with_checkpoints
    calls = [
        lambda: lct.GramAccumulator(64, device="cpu", mesh=object()),
        lambda: lct.fit_from_covariance(np.eye(8), 100, 2, mesh=object(),
                                        device="cpu"),
        lambda: lct.fit_csv(str(tmp_path / "x.csv"), 2, mesh=object()),
        lambda: lct.Corex(device="cpu", **KW64).partial_fit(
            x, mesh=object()),
        lambda: fit_with_checkpoints(
            lct.Corex(device="cpu", **KW64), x, str(tmp_path / "ckpt"),
            mesh=object()),
        lambda: lct.StackedCorex([4, 1], device="cpu").fit(x, mesh=object()),
        lambda: stack.transform(x, mesh=object()),
        lambda: stack.predict(np.zeros((4, 1)), mesh=object()),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="default process group"):
            call()
    assert not (tmp_path / "ckpt").exists()


def test_entry_points_without_a_process_group_raise_by_name():
    """A mesh without torch.distributed's default group: RuntimeError that
    says what to initialize; never a fit on one device instead."""
    x = _x512()
    c = lct.Corex(device="cpu", max_iter=20, **KW64).fit(x)
    calls = [
        lambda: S.make_mesh(device="cpu"),
        lambda: S.make_hybrid_mesh((("slice", 1), ("data", 1)),
                                   device="cpu", granule_key=lambda r: 0),
        lambda: lct.Corex(device="cpu", **KW64).fit(x, mesh=object()),
        lambda: S.fit_sharded(x, _w0(), CorexConfig(**KW64), object()),
        lambda: S.fit_shard_map(x, _w0(), CorexConfig(**KW64), object()),
        lambda: TR.fit_restarts_sharded(x, np.zeros((2, 8, 64)),
                                        CorexConfig(**KW64), "samples",
                                        object()),
        lambda: c.transform(x, mesh=object()),
        lambda: c.score(x, mesh=object()),
        lambda: c.covariance_matvec(np.zeros(64), mesh=object()),
        lambda: lct.pick_n_hidden(x, mesh=object(), device="cpu"),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="default process group"):
            call()


class _RelabelledMesh:
    """A mesh's groups under another device type: what a caller who built
    a DeviceMesh by hand over the wrong backend's groups would pass."""

    def __init__(self, mesh, device_type):
        self.device_type = device_type
        self.mesh_dim_names = mesh.mesh_dim_names
        self.get_group = mesh.get_group


def _solo(rank):
    """A world of one rank: the rejections that need a mesh but no peers,
    and the bitwise rule (one rank holds every row, so its mesh fit is the
    plain samples fit bit for bit)."""
    mesh = S.make_mesh(device="cpu")
    x, w0 = _x512(), _w0()
    xp = _std(x)
    cfg = CorexConfig(**KW64)
    out = dict(
        overlap=_raised(lambda: S.fit_shard_map(
            xp, w0, CorexConfig(discourage_overlap=False, **KW64), mesh)),
        int8=_raised(lambda: S.fit_shard_map(
            _std(x, torch.float32), w0,
            CorexConfig(n_hidden=8, matmul_dtype="int8"), mesh)),
        stage_subsample=_raised(lambda: S.fit_shard_map(
            xp, w0, CorexConfig(stage_subsample=0.5, **KW64), mesh)),
        slices_on_gram=_raised(lambda: S.fit_sharded(
            TM.compute_gram(xp), w0, cfg, mesh,
            S.ShardingPlan(shard_samples=False, shard_slices=True),
            strategy="gram", n_samples=512)),
        sweep_subsample=_raised(lambda: lct.Corex(
            device="cpu", n_restarts=2, seed=0, stage_subsample=0.5,
            moment_strategy="samples", **KW64).fit(
            x, mesh=S.make_mesh((("restarts", 1),), device="cpu"))),
        gram_data_axis=_raised(lambda: lct.pick_n_hidden(
            x, mesh=S.make_mesh((("restarts", 1), ("data", 1)),
                                device="cpu"),
            data_axis="data", moment_strategy="gram", device="cpu")),
        # a mesh is held to its world's backend: this world is gloo, so a
        # mesh over the cards must raise, when built and when handed in
        cuda_mesh_on_gloo=_raised(lambda: S.make_mesh(device="cuda")),
        cuda_hybrid_on_gloo=_raised(lambda: S.make_hybrid_mesh(
            (("slice", 1), ("data", 1)), device="cuda",
            granule_key=lambda r: 0)),
        cuda_mesh_handed_in=_raised(lambda: S.fit_sharded(
            xp, w0, cfg, _RelabelledMesh(mesh, "cuda"))),
    )
    kw = dict(device="cpu", n_hidden=8, record_history=False, max_iter=40)
    a = lct.Corex(**kw).fit(x, init_ws=w0, mesh=mesh)
    b = lct.Corex(moment_strategy="samples", **kw).fit(x, init_ws=w0)
    out["bitwise"] = bool(
        torch.equal(a.ws, b.ws) and a.tc == b.tc
        and np.array_equal(a.transform(x, mesh=mesh), b.transform(x))
        and a.score(x, mesh=mesh) == b.score(x))
    out["counts"] = len(S.collective_counts())
    return out


@pytest.fixture(scope="module")
def solo():
    return run_world(_solo, 1, backend="gloo", timeout=120.0)[0]


@pytest.mark.parametrize("case,kind,text", [
    ("overlap", "ValueError", "discourage_overlap=True"),
    ("int8", "ValueError", "int8"),
    ("stage_subsample", "ValueError", "stage_subsample < 1 is not "
                                      "supported by fit_shard_map"),
    ("slices_on_gram", "ValueError", "Gram operand"),
    ("sweep_subsample", "ValueError", "n_restarts"),
    ("gram_data_axis", "ValueError", "Gram operand"),
    ("cuda_mesh_on_gloo", "ValueError", "needs the nccl backend"),
    ("cuda_hybrid_on_gloo", "ValueError", "needs the nccl backend"),
    ("cuda_mesh_handed_in", "ValueError", "needs the nccl backend"),
])
def test_named_rejections_in_a_world_of_one(solo, case, kind, text):
    got = solo[case]
    assert got is not None and got[0] == kind and text in got[1], got


def test_a_world_of_one_is_bitwise_the_plain_samples_fit(solo):
    assert solo["bitwise"] and solo["counts"] > 0


def _hang(rank):
    """Rank 1 never joins the collective rank 0 waits in."""
    import torch.distributed as dist
    if rank == 0:
        dist.all_reduce(torch.zeros(4))
    else:
        time.sleep(600)


def test_a_world_cannot_outlive_its_timeout():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="did not finish|raised|died"):
        run_world(_hang, 2, backend="gloo", timeout=5.0)
    assert time.monotonic() - t0 < 40.0


def _boom(rank):
    raise KeyError(f"rank {rank} fails")


def test_a_failing_rank_is_reported_with_its_traceback():
    with pytest.raises(RuntimeError, match="KeyError"):
        run_world(_boom, 2, backend="gloo", timeout=60.0)


def test_the_launcher_defaults_to_the_card_like_the_mesh_and_the_model():
    """`run_world`, `make_mesh` and `Corex` agree on where they run when
    the caller says nothing: NCCL, "cuda", "cuda"."""
    import inspect
    assert inspect.signature(run_world).parameters["backend"].default == "nccl"
    assert inspect.signature(S.make_mesh).parameters["device"].default == "cuda"
    assert inspect.signature(lct.Corex).parameters["device"].default == "cuda"


def test_the_port_and_this_module_import_no_jax_in_a_rank():
    """A spawned rank imports this module and the port, never JAX."""
    assert run_world(_modules, 1, backend="gloo", timeout=60.0)[0] == []


def _modules(rank):
    import sys
    return sorted(m for m in sys.modules
                  if m == "jax" or m.startswith(("jax.", "linearcorex_tpu.")))
