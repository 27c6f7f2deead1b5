"""Variable and factor sharding of the PyTorch port (`ShardingPlan(
shard_vars=True)` / `shard_factors=True` in `parallel.sharding`,
`Corex.fit(mesh=)` and the serving methods under those plans) on a
four-rank CPU world.

As in `tests/test_torch_sharding.py`, the module spawns ONE world of four
ranks (gloo, a file rendezvous, no network) per run; `_world` drives every
case and hands numpy results back, which the parent asserts as separate
tests. The meshes are the JAX tests' with four ranks in place of eight:
`var` 4, `model` 4, `data` 2 x `var` 2, `data` 2 x `model` 2, and the Gram
operand with Σ's rows over `var` 4. The references are the port's own
single-device fits (W and TC within 1e-7 in float64, the same iterations
per stage) and the JAX package's sharded fits on its 8-device CPU mesh,
from the same seeded numpy X and RandomState W0.

This module imports neither JAX nor `tests.conftest` at the top: the
spawned ranks import it, and the port runs without JAX.
"""

import copy
import datetime
import hashlib
import os
import tempfile
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
from linearcorex_tpu_torch.parallel import sharding as S
from linearcorex_tpu_torch.parallel.launch import run_world

# One intra-op thread: the suite runs its files in parallel worker
# processes, and an OpenMP pool per process on every core slows the
# small tensors here several times over.
torch.set_num_threads(1)

TOL = 1e-7          # W and TC, sharded against single-device (float64)
SERVE_TOL = 1e-9    # serving under a plan against the single-device call
WORLD = 4
WORLD_TIMEOUT = 900.0   # a deadline for a hang: the world takes ~40 s alone
N, P, M = 512, 64, 8
KW64 = dict(n_hidden=M, dtype="float64", record_history=False)
# a few iterations per stage: enough where the case is about the layout
SHORT = dict(max_iter=25, **KW64)
# the served models, one per solver path
SERVED = {"ns": {}, "overlap": dict(discourage_overlap=False, max_iter=100)}

VAR = S.ShardingPlan(shard_samples=False, shard_vars=True)
FACTOR = S.ShardingPlan(shard_samples=False, shard_factors=True)
HALF_DTYPES = ("bfloat16", "float16")
HALF_KW = dict(n_hidden=4, seed=0, max_iter=2000, device="cpu")
# TC bound in units in the last place of the dtype at |TC|, and the
# dtype's mantissa bits (tests/test_torch_half_dtypes.py)
HALF_ULPS = {"bfloat16": 2, "float16": 12}
HALF_MANTISSA = {"bfloat16": 7, "float16": 10}
DATA_VAR = S.ShardingPlan(shard_samples=True, shard_vars=True)
DATA_FACTOR = S.ShardingPlan(shard_samples=True, shard_factors=True)
LAYOUTS = {"var": ((("var", 4),), VAR),
           "factor": ((("model", 4),), FACTOR),
           "data_var": ((("data", 2), ("var", 2)), DATA_VAR),
           "data_factor": ((("data", 2), ("model", 2)), DATA_FACTOR)}
FITS = [(name, "momentum") for name in LAYOUTS] + [
    ("var", "fixed_point"), ("data_factor", "fixed_point")]


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
    return block_data(n=N, p=P, m=M, seed=0)


def _w0():
    return np.random.RandomState(42).normal(scale=1 / 8, size=(M, P))


def _x_half():
    """n=400, p=32, m=4: four blocks of eight (the half-dtype tests' data
    at 400 rows)."""
    rng = np.random.RandomState(0)
    z = rng.normal(size=(400, 4))
    return np.repeat(z, 8, axis=1) * 0.9 + 0.44 * rng.normal(size=(400, 32))


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


def _local(t):
    """(local block, placements as strings) of a DTensor, or (t, None)."""
    if hasattr(t, "to_local"):
        return t.to_local().numpy(), [
            f"Shard({p.dim})" if p.is_shard() else "Replicate"
            for p in t.placements]
    return np.asarray(t), None


def _whole(t):
    return np.asarray(t.full_tensor() if hasattr(t, "full_tensor") else t)


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
    meshes = {name: S.make_mesh(axes, device="cpu", timeout=timeout)
              for name, (axes, _) in LAYOUTS.items()}
    data4 = S.make_mesh((("data", 4),), device="cpu", timeout=timeout)
    vm = S.make_mesh((("var", 2), ("model", 2)), device="cpu",
                     timeout=timeout)
    x, w0 = _x512(), _w0()
    xp = _std(x)

    def keep(name, res):
        out[name] = _fit_out(*res)
        digest.update(out[name]["ws"].tobytes())

    # fits: every plan on the gradient path, one plan of each axis on the
    # fixed point, a few iterations per stage
    for name, opt in FITS:
        S.reset_collective_counts()
        keep(f"{name}_{opt}", S.fit_sharded(
            xp, w0, CorexConfig(optimizer=opt, **SHORT), meshes[name],
            LAYOUTS[name][1]))
        out[f"counts_{name}_{opt}"] = _counts()
    # to the tolerance: the step size is a MAX over W's blocks, or the
    # ranks would stop at different iterations and the world would hang
    keep("var_to_tol", S.fit_sharded(
        xp, w0, CorexConfig(optimizer="fixed_point", anneal=False, **KW64),
        meshes["var"], VAR))
    keep("var_model", S.fit_sharded(
        xp, w0, CorexConfig(**SHORT), vm,
        S.ShardingPlan(shard_samples=False, shard_vars=True,
                       shard_factors=True)))
    S.reset_collective_counts()
    keep("gram_var", S.fit_sharded(
        TM.compute_gram(xp), w0, CorexConfig(**SHORT), meshes["var"], VAR,
        strategy="gram", n_samples=N))
    out["counts_gram_var"] = _counts()
    for name in ("data_var", "factor"):
        keep(f"overlap_{name}", S.fit_sharded(
            xp, w0, CorexConfig(discourage_overlap=False, **SHORT),
            meshes[name], LAYOUTS[name][1]))

    # the chain kernel's path under a split (float32; the CPU twin): one
    # evaluation of each objective, and a short fit
    x32 = _std(x, torch.float32)
    w32 = torch.as_tensor(w0, dtype=torch.float32)
    eps = torch.tensor(0.36, dtype=torch.float32)
    for name in ("var", "factor"):
        plan = LAYOUTS[name][1]
        var = S.var_axis(meshes[name], plan)
        model = S.factor_axis(meshes[name], plan)
        rows = S.shard_samples(x32, (), "cpu", var=var)
        wl = S.shard_w(w32, var, model, "cpu")
        res = {}
        for chain in (False, True):
            for fn in (TM.ns_fp_samples, TM.ns_obj_grad_samples):
                f, g, tc = fn(wl, rows, eps, 1.0, 1 - 1e-6,
                              chain_kernel=chain, model=model)
                res[chain, fn.__name__] = (
                    float(f), float(tc),
                    TM.Split(var, model).whole_w(g).numpy())
        out[f"chain_eval_{name}"] = res
        cfg = CorexConfig(n_hidden=M, record_history=False, max_iter=25,
                          optimizer="fixed_point", use_pallas="always")
        keep(f"chain_fit_{name}", S.fit_sharded(x32, w32, cfg,
                                                 meshes[name], plan))

    # int8: the Σ-application under `var` and under `model` is bitwise
    qd = TM.quantize_samples(x32)
    v = torch.as_tensor(np.random.RandomState(5).normal(size=(P, 24)),
                        dtype=torch.float32)
    single = TM._apply_sigma_int8(qd, v)
    var = S.var_axis(meshes["var"], VAR)
    cols = S._block(P, (var,))
    xs = S.shard_samples(x32, (), "cpu", var=var)
    q_var = TM.quantize_samples(xs)
    dv_mesh = meshes["data_var"]
    dv_axes, dv_var = S.sample_axes(dv_mesh, DATA_VAR), S.var_axis(
        dv_mesh, DATA_VAR)
    model = S.factor_axis(meshes["factor"], FACTOR)
    fac = S._block(M, (model,))
    g_single = TM._apply_gram_int8(TM.quantize_gram(TM.compute_gram(x32)),
                                   v)
    g_var = TM.quantize_gram(TM.compute_gram(xs))
    out["int8_apply"] = dict(
        var=TM._apply_sigma_int8(S.shard_samples(qd, (), "cpu", var=var),
                                 v[cols]).numpy(),
        data_var=TM._apply_sigma_int8(
            S.shard_samples(qd, dv_axes, "cpu", var=dv_var),
            v[S._block(P, (dv_var,))]).numpy(),
        model=TM._apply_sigma_int8(qd, v[:, fac]).numpy(),
        single=single.numpy(), cols=(cols.start, cols.stop),
        dv_cols=(S._block(P, (dv_var,)).start, S._block(P, (dv_var,)).stop),
        fac=(fac.start, fac.stop),
        scale_equal=bool(q_var.local.scale == qd.scale),
        q_equal=bool(torch.equal(q_var.local.q, qd.q[:, cols])),
        gram_var=TM._apply_gram_int8(g_var, v[cols]).numpy(),
        gram_single=g_single.numpy())
    cfg8 = CorexConfig(n_hidden=M, record_history=False, max_iter=40,
                       matmul_dtype="int8", moment_strategy="samples",
                       tol=1e-4, optimizer="fixed_point")
    S.reset_collective_counts()
    keep("int8_var", S.fit_sharded(qd, w0.astype(np.float32), cfg8,
                                   meshes["var"], VAR))
    out["counts_int8_var"] = _counts()
    keep("int8_factor", S.fit_sharded(qd, w0.astype(np.float32), cfg8,
                                      meshes["factor"], FACTOR))
    rs = np.random.RandomState(0)
    xw = np.tile(rs.choice([-1.0, 1.0], size=(1 << 18, 1)),
                 (1, 16)).astype(np.float32)
    guard = lct.Corex(n_hidden=2, matmul_dtype="int8", device="cpu",
                      record_history=False, moment_strategy="samples")
    out["int8_guard"] = _raised(lambda: guard._prepare_fit(
        xw, resolve=False, plan=VAR, mesh=meshes["var"]))
    del xw

    # the estimator surface: the mesh-aware prepare and Corex.fit(mesh=)
    prep = {}
    for name, strategy in (("var", "auto"), ("data_var", "auto"),
                           ("data_var", "samples"), ("factor", "auto")):
        model = lct.Corex(device="cpu", moment_strategy=strategy, **KW64)
        data, _, got = model._prepare_fit(x, resolve=False,
                                          plan=LAYOUTS[name][1],
                                          mesh=meshes[name])
        local = data.local if isinstance(data, TM.ShardedSamples) else data
        prep[name, strategy] = dict(
            strategy=got, sharded=isinstance(data, TM.ShardedSamples),
            gram=getattr(data, "gram", False), shape=tuple(local.shape),
            theta=tuple(model.theta.mean.shape))
    out["prepare"] = prep
    for name in ("var", "data_factor"):
        cm = lct.Corex(device="cpu", **SHORT).fit(
            x, init_ws=w0, mesh=meshes[name],
            sharding_plan=LAYOUTS[name][1])
        digest.update(cm.ws.numpy().tobytes())
        out[f"corex_{name}"] = dict(ws=cm.ws.numpy(), tc=cm.tc,
                                    iters=cm.diagnostics.iters_per_stage
                                    .numpy(), plan=cm._serving_plan)
    cs = lct.Corex(device="cpu", init="spectral", seed=0,
                   moment_strategy="samples", **SHORT).fit(
        x, mesh=meshes["data_var"], sharding_plan=DATA_VAR)
    out["corex_spectral"] = dict(ws=cs.ws.numpy(), tc=cs.tc)
    cf = lct.Corex(device="cpu", seed=0, moment_strategy="samples", **SHORT)
    out["fit_transform"] = dict(
        y=cf.fit_transform(x, mesh=meshes["data_var"],
                           sharding_plan=DATA_VAR),
        plan=cf._serving_plan)

    # serving under the four plans, both solver paths: a fresh copy of one
    # fitted model per plan (a serving call remembers its plan)
    v1 = np.random.RandomState(3).normal(size=P)
    vb = np.random.RandomState(4).normal(size=(P, 5))
    for path, kw in SERVED.items():
        fitted = lct.Corex(device="cpu", moment_strategy="samples", seed=0,
                           **dict(SHORT, **kw)).fit(x, init_ws=w0)
        if path == "ns":
            fitted_ns = fitted
        for name, (_, plan) in LAYOUTS.items():
            sm = copy.deepcopy(fitted)
            mesh = meshes[name]
            S.reset_collective_counts()
            y = sm.transform(x, mesh=mesh, sharding_plan=plan)
            out[f"counts_transform_{name}_{path}"] = _counts()
            xh = sm.predict(y, mesh=mesh)           # sticky plan
            mv = sm.covariance_matvec(v1, mesh=mesh)
            mm = sm.covariance_matmat(vb, mesh=mesh, sharding_plan=plan)
            blocks = list(sm.covariance_blocks(24, mesh=mesh))
            out[f"serving_{name}_{path}"] = dict(
                y=y, xh=_whole(xh), xh_local=_local(xh),
                score=float(sm.score(x, mesh=mesh, sharding_plan=plan)),
                mv=_whole(mv), mv_local=_local(mv), mm=_whole(mm),
                starts=[s for s, _ in blocks],
                blocks=[_whole(r) for _, r in blocks],
                block_local=_local(blocks[0][1]),
                sticky=sm._serving_plan == plan,
                get_cov=_raised(sm.get_covariance))
    se = copy.deepcopy(fitted_ns)
    y, det = se.transform(x, details=True, mesh=meshes["data_var"],
                          sharding_plan=DATA_VAR)
    out["serving_details"] = dict(y=y, tc=float(det["TC"]),
                                  rho=det["rho"])
    # after save_corex / load_corex, and the sticky plan across calls
    from linearcorex_tpu_torch.utils.checkpoint import load_corex, save_corex
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, f"model_{rank}.npz")
        save_corex(se, path)
        served = load_corex(path, device="cpu")
    out["served"] = dict(
        y=served.transform(x, mesh=meshes["data_var"],
                           sharding_plan=DATA_VAR),
        score=float(served.score(x, mesh=meshes["data_var"])))
    sticky = copy.deepcopy(fitted_ns)
    sticky.transform(x, mesh=meshes["var"], sharding_plan=VAR)
    mv = sticky.covariance_matvec(np.ones(P), mesh=meshes["var"])
    out["sticky"] = dict(
        plan=sticky._serving_plan, var_split=_local(mv)[0].shape,
        get_cov=_raised(sticky.get_covariance),
        blocks0=_whole(dict(sticky.covariance_blocks(
            P, mesh=meshes["var"]))[0]))
    sticky.fit(x, init_ws=w0)
    out["sticky"]["after_refit"] = (sticky._serving_plan,
                                    tuple(sticky.get_covariance().shape))

    # named rejections
    x501 = block_data(n=501, p=P, m=M, seed=0)
    x62 = block_data(n=N, p=62, m=M, seed=0)
    cfg = CorexConfig(**KW64)
    out["errors"] = dict(
        cols=_raised(lambda: S.fit_sharded(x62, np.zeros((M, 62)), cfg,
                                           meshes["var"], VAR)),
        factors=_raised(lambda: S.fit_sharded(xp, w0[:6], cfg,
                                              meshes["factor"], FACTOR)),
        rows=_raised(lambda: S.fit_sharded(x501, w0, cfg,
                                           meshes["data_var"], DATA_VAR)),
        axis=_raised(lambda: S.fit_sharded(xp, w0, cfg, data4, VAR)),
        gram_rows=_raised(lambda: lct.Corex(
            device="cpu", **KW64)._prepare_fit(
            x501, resolve=False, plan=DATA_VAR, mesh=meshes["data_var"])),
        restarts=_raised(lambda: lct.Corex(
            device="cpu", n_restarts=2, seed=0, **KW64).fit(
            x, mesh=meshes["var"], sharding_plan=VAR)),
        serve_cols=_raised(lambda: lct.Corex(
            device="cpu", **SHORT).fit(x62).transform(
            x62, mesh=meshes["var"], sharding_plan=VAR)),
        serve_axis=_raised(lambda: se.covariance_matvec(
            np.zeros(P), mesh=data4, sharding_plan=VAR)),
    )

    # half dtypes under the data and the var plan (the iterations may
    # differ from the plain fit's: a sum over rows or over p adds in
    # another order and an accept flips)
    for dt in HALF_DTYPES:
        for name, (mesh, plan) in (("data", (data4, None)),
                                   ("var", (meshes["var"], VAR))):
            hm = lct.Corex(**HALF_KW, dtype=dt).fit(
                _x_half(), mesh=mesh, sharding_plan=plan)
            out[f"half_{dt}_{name}"] = dict(tc=hm.tc,
                                            clusters=hm.clusters)

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
    """The port's single-device fits from the same X and W0."""
    xp, w0 = _std(_x512()), torch.as_tensor(_w0())
    out = {}
    for name, kw, strategy in (
            ("momentum", dict(optimizer="momentum", **SHORT), "samples"),
            ("fixed_point", dict(optimizer="fixed_point", **SHORT),
             "samples"),
            ("to_tol", dict(optimizer="fixed_point", anneal=False, **KW64),
             "samples"),
            ("overlap", dict(discourage_overlap=False, **SHORT), "samples"),
            ("gram", dict(SHORT), "gram")):
        cfg = TC.resolve_config(CorexConfig(**kw), P, "cpu", N)
        data = TM.compute_gram(xp) if strategy == "gram" else xp
        out[name] = _fit_out(*TC._fit_program(data, w0, cfg, strategy))
    return out


def _close(got, ref, tol=TOL):
    assert np.abs(got["ws"] - ref["ws"]).max() < tol
    assert np.abs(got["tc"] - ref["tc"]).max() < tol
    assert got["iters"].tolist() == ref["iters"].tolist()


@pytest.mark.parametrize("layout,optimizer", FITS)
def test_var_and_factor_sharded_fits_match_the_single_device_fit(
        world, single, layout, optimizer):
    _close(world[f"{layout}_{optimizer}"], single[optimizer])


def test_var_sharded_fit_converges_on_tol_like_the_single_device_fit(
        world, single):
    got = world["var_to_tol"]
    _close(got, single["to_tol"])
    # every stage stopped on its tolerance, not on max_iter
    assert (got["iters"] < KW64.get("max_iter", 10000)).all()


def test_var_and_factor_split_at_once(world, single):
    _close(world["var_model"], single["momentum"])


def test_gram_var_sharded_fit(world, single):
    """Σ's rows over `var`: the single-device gram fit."""
    _close(world["gram_var"], single["gram"])


@pytest.mark.parametrize("layout", ["data_var", "factor"])
def test_overlap_objective_under_var_and_factor_plans(world, single, layout):
    _close(world[f"overlap_{layout}"], single["overlap"])


def test_every_rank_ends_with_the_same_bits(world):
    assert len(world["all_digests"]) == WORLD
    assert len(set(world["all_digests"])) == 1


@pytest.mark.parametrize("layout", ["var", "factor"])
def test_chain_kernel_path_gathers_cxy_and_keeps_its_block(world, layout):
    """use_pallas='always' under a split: the chain (the CPU twin here)
    runs on the gathered C_xy, and each rank keeps its block: one
    evaluation equals the plain chain's under the same split and the
    single-device chain's, to float32 rounding."""
    x32 = _std(_x512(), torch.float32)
    w32 = torch.as_tensor(_w0(), dtype=torch.float32)
    eps = torch.tensor(0.36, dtype=torch.float32)
    got = world[f"chain_eval_{layout}"]
    for fn in (TM.ns_fp_samples, TM.ns_obj_grad_samples):
        f, g, tc = fn(w32, x32, eps, 1.0, 1 - 1e-6, chain_kernel=True)
        for chain in (False, True):
            gf, gtc, gg = got[chain, fn.__name__]
            assert abs(gf - float(f)) <= 1e-5 * abs(float(f))
            assert abs(gtc - float(tc)) <= 1e-5 * abs(float(tc))
            assert np.abs(gg - g.numpy()).max() <= 1e-5 * np.abs(
                g.numpy()).max()


@pytest.mark.parametrize("layout", ["var", "factor"])
def test_chain_kernel_fit_under_a_split(world, layout):
    x32 = _std(_x512(), torch.float32)
    cfg = TC.resolve_config(CorexConfig(
        n_hidden=M, record_history=False, max_iter=25,
        optimizer="fixed_point", use_pallas="always"), P, "cpu", N)
    ref = _fit_out(*TC._fit_program(
        x32, torch.as_tensor(_w0(), dtype=torch.float32), cfg, "samples"))
    got = world[f"chain_fit_{layout}"]
    assert got["ws"].dtype == np.float32
    # float32 sums over p (var) or the gathered m-wide products (model) add
    # in another order, which flips an accept here and there: the stages
    # run other iteration counts (var: 32 against 36 in stage 6 on this
    # data), so W and TC are held, not the iterations
    assert abs(float(got["tc"]) - float(ref["tc"])) < 1e-5 * abs(
        float(ref["tc"]))
    assert np.abs(got["ws"] - ref["ws"]).max() < 1e-2


@pytest.mark.parametrize("layout", ["var", "data_var", "model"])
def test_int8_sigma_application_under_var_and_model_is_bitwise(world,
                                                               layout):
    got = world["int8_apply"]
    single = got["single"]
    if layout == "model":
        a, b = got["fac"]
        want = single[:, a:b]
    else:
        a, b = got["cols" if layout == "var" else "dv_cols"]
        want = single[a:b]
    assert np.array_equal(got[layout], want)


def test_int8_var_quantization_and_gram_rows_are_bitwise(world):
    got = world["int8_apply"]
    assert got["scale_equal"] and got["q_equal"]
    a, b = got["cols"]
    assert np.array_equal(got["gram_var"], got["gram_single"][a:b])


@pytest.mark.parametrize("layout", ["var", "factor"])
def test_int8_fit_follows_the_single_device_fit(world, layout):
    x32 = _std(_x512(), torch.float32)
    cfg8 = TC.resolve_config(CorexConfig(
        n_hidden=M, record_history=False, max_iter=40, matmul_dtype="int8",
        moment_strategy="samples", tol=1e-4, optimizer="fixed_point"), P,
        "cpu", N)
    ref = _fit_out(*TC._fit_program(
        TM.quantize_samples(x32),
        torch.as_tensor(_w0(), dtype=torch.float32), cfg8, "samples"))
    got = world[f"int8_{layout}"]
    # the int8 products are bitwise; the float32 sums over p (var) or the
    # m-wide products (model) of the moment algebra add in another order,
    # and that flips an accept here and there (var: 18 against 20
    # iterations in stage 3 on this data), so W and TC are held, not the
    # iterations
    assert np.abs(got["ws"] - ref["ws"]).max() < 1e-4
    assert abs(float(got["tc"]) - float(ref["tc"])) < 1e-5 * abs(
        float(ref["tc"]))


def test_mesh_aware_prepare_int8_still_guarded_under_var(world):
    kind, msg = world["int8_guard"]
    assert kind == "ValueError" and "overflow" in msg


def _evals(fit):
    return int(fit["iters"].sum()) + len(fit["iters"])


@pytest.mark.parametrize("layout,optimizer", [
    f for f in FITS if f[0] in ("var", "data_var")])
def test_var_sharded_comm_is_nm_and_mm(world, layout, optimizer):
    """A var-plan samples fit sends n x m and m-sized blocks: no payload
    exceeds max(n·m, m·p) values, none is p x p or n x p. The (n_loc, m)
    partial of X·Wᵀ is summed over `var` once per Σ-application."""
    counts = world[f"counts_{layout}_{optimizer}"]
    assert counts
    for kind, op, axis, dtype, numel, nbytes, calls in counts:
        assert numel <= max(N * M, M * P), (kind, axis, numel)
        assert numel != N * P
    # here p·p = n·m: every payload of that size is one of the (n_loc, m)
    # partials, one per Σ-application, and nothing else
    n_loc = N // (2 if layout == "data_var" else 1)
    xw = [c for c in counts if c[4] == n_loc * M]
    assert all(c[:3] == ("all_reduce", "sum", "var") for c in xw)
    per_eval = 2 if optimizer == "momentum" else 1
    fit = world[f"{layout}_{optimizer}"]
    assert sum(c[-1] for c in xw) == per_eval * _evals(fit) + 1
    assert not [c for c in counts if c[4] == P * P and c not in xw]
    steps = [c for c in counts if c[1] == "max" and c[4] == 1]
    assert steps and all(c[2] == "var" for c in steps)


@pytest.mark.parametrize("layout,optimizer", [
    f for f in FITS if f[0] in ("factor", "data_factor")])
def test_factor_sharded_comm_is_at_most_mp(world, layout, optimizer):
    counts = world[f"counts_{layout}_{optimizer}"]
    gathers = [c for c in counts if c[0] == "all_gather"
               and c[2] == "model"]
    assert gathers
    for kind, op, axis, dtype, numel, nbytes, calls in counts:
        if axis == "model":
            assert numel * 2 <= M * P, (kind, numel)   # this rank's share
        assert numel <= M * P


def test_gram_var_fit_gathers_w_columns_only(world):
    """Σ row blocks: each application gathers v's (p_loc, m) rows; nothing
    p x p crosses."""
    for kind, op, axis, dtype, numel, nbytes, calls in world[
            "counts_gram_var"]:
        assert axis == "var" and numel <= M * P and numel != P * P


def test_int8_var_comm_sums_int32_partials(world):
    kinds = {(c[1], c[3]) for c in world["counts_int8_var"]}
    assert ("sum", "int32") in kinds and ("max", "float32") in kinds
    for c in world["counts_int8_var"]:
        assert c[4] <= max(N * M, M * P)


@pytest.mark.parametrize("case", [("var", "auto"), ("data_var", "auto"),
                                  ("data_var", "samples"),
                                  ("factor", "auto")])
def test_mesh_aware_prepare_holds_only_this_ranks_block(world, case):
    """No rank holds the whole (n, p) X or the whole (p, p) Σ: under a
    var plan the auto rule keeps gram and each rank holds its Σ row block;
    with 'samples' its X block. A factor plan splits W only."""
    got = world["prepare"][case]
    name, strategy = case
    assert got["theta"] == (P,)            # theta is gathered whole
    if name == "factor":
        assert got["strategy"] == "gram" and not got["sharded"]
        assert got["shape"] == (P, P)
    elif strategy == "auto":
        assert got["strategy"] == "gram" and got["sharded"] and got["gram"]
        d = 4 if name == "var" else 2
        assert got["shape"] == (P // d, P)
    else:
        assert got["strategy"] == "samples" and got["sharded"]
        assert got["shape"] == (N // 2, P // 2)


@pytest.mark.parametrize("layout", ["var", "data_factor"])
def test_corex_fit_with_mesh_and_plan(world, layout):
    x, w0 = _x512(), _w0()
    cs = lct.Corex(device="cpu", **SHORT).fit(x, init_ws=w0)
    got = world[f"corex_{layout}"]
    if layout == "data_factor":
        # the plan rule takes the samples strategy under a sample plan
        cs = lct.Corex(device="cpu", moment_strategy="samples",
                       **SHORT).fit(x, init_ws=w0)
    assert abs(got["tc"] - cs.tc) < TOL
    assert np.abs(got["ws"] - cs.ws.numpy()).max() < TOL
    assert got["iters"].tolist() == cs.diagnostics.iters_per_stage.tolist()
    assert got["plan"] == LAYOUTS[layout][1]


def test_spectral_init_under_a_var_plan(world):
    cs = lct.Corex(device="cpu", init="spectral", seed=0,
                   moment_strategy="samples", **SHORT).fit(_x512())
    got = world["corex_spectral"]
    assert abs(got["tc"] - cs.tc) < TOL
    assert np.abs(got["ws"] - cs.ws.numpy()).max() < TOL


def test_fit_transform_threads_a_var_plan(world):
    y_ref = lct.Corex(device="cpu", moment_strategy="samples", seed=0,
                      **SHORT).fit_transform(_x512())
    got = world["fit_transform"]
    assert np.abs(got["y"] - y_ref).max() < TOL
    assert got["plan"] == DATA_VAR


@pytest.fixture(scope="module")
def served():
    x, w0 = _x512(), _w0()
    return x, {path: lct.Corex(device="cpu", moment_strategy="samples",
                               seed=0, **dict(SHORT, **kw)).fit(
        x, init_ws=w0) for path, kw in SERVED.items()}


@pytest.mark.parametrize("path", ["ns", "overlap"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_serving_mesh_equivalence(world, served, layout, path):
    x, models = served
    cs = models[path]
    got = world[f"serving_{layout}_{path}"]
    y_ref = cs.transform(x)
    assert np.abs(got["y"] - y_ref).max() < SERVE_TOL
    assert np.abs(got["xh"] - cs.predict(y_ref)).max() < SERVE_TOL
    assert abs(got["score"] - float(cs.score(x))) < SERVE_TOL
    v = np.random.RandomState(3).normal(size=P)
    vb = np.random.RandomState(4).normal(size=(P, 5))
    assert np.abs(got["mv"] - cs.covariance_matvec(v)).max() \
        < SERVE_TOL
    assert np.abs(got["mm"] - cs.covariance_matmat(vb)).max() \
        < SERVE_TOL
    assert got["sticky"]


@pytest.mark.parametrize("path", ["ns", "overlap"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_covariance_blocks_sharded_bitequal(world, served, layout, path):
    """p = 64, block = 24: the blocks start at 0, 24, 48 and the last is
    the tail of a full-size one; each equals the single-device block bit
    for bit (the contraction over m is never split)."""
    _, models = served
    ref = list(models[path].covariance_blocks(24))
    got = world[f"serving_{layout}_{path}"]
    assert got["starts"] == [s for s, _ in ref] == [0, 24, 48]
    for g, (_, r) in zip(got["blocks"], ref):
        assert g.shape == tuple(r.shape)
        assert np.array_equal(g, r)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_serving_outputs_are_split_over_var(world, layout):
    """Under `var` the p-sized outputs come back as DTensors holding this
    rank's columns (rows: for a (p,) or (p, k) output); under `model`
    they are whole tensors."""
    got = world[f"serving_{layout}_ns"]
    xh, place = got["xh_local"]
    mv, mv_place = got["mv_local"]
    blk, blk_place = got["block_local"]
    if "var" in layout:
        d = 4 if layout == "var" else 2
        rows = N // (2 if layout == "data_var" else 1)
        assert xh.shape == (rows, P // d) and mv.shape == (P // d,)
        assert blk.shape == (24, P // d)
        assert place == ["Shard(0)", "Shard(1)"][-len(place):]
        assert "Shard(0)" in mv_place and "Shard(1)" in blk_place
        assert isinstance(got["get_cov"], tuple)
    else:
        assert place is None and xh.shape == (N, P) and mv.shape == (P,)
        assert got["get_cov"] is None


@pytest.mark.parametrize("layout", ["var", "data_var"])
def test_var_transform_reduces_only_n_by_m_partials(world, layout):
    """transform under `var`: one SUM of the (n_loc, m) partials over
    `var`, the rows gathered over the sample axes; nothing p-sized."""
    counts = world[f"counts_transform_{layout}_ns"]
    on_var = [c for c in counts if c[2] == "var"]
    n_loc = N // (2 if layout == "data_var" else 1)
    assert on_var and all(c[:2] == ("all_reduce", "sum")
                          and c[4] == n_loc * M for c in on_var)
    assert all(c[4] <= N * M for c in counts)


def test_serving_details_under_a_var_plan(world, served):
    x, models = served
    y_ref, det_ref = models["ns"].transform(x, details=True)
    got = world["serving_details"]
    assert np.abs(got["y"] - y_ref).max() < SERVE_TOL
    assert abs(got["tc"] - float(det_ref["TC"])) < SERVE_TOL
    assert np.abs(got["rho"] - det_ref["rho"]).max() < SERVE_TOL


def test_serving_after_load_corex(world, served):
    x, models = served
    got = world["served"]
    assert np.abs(got["y"] - models["ns"].transform(x)).max() \
        < SERVE_TOL
    assert abs(got["score"] - float(models["ns"].score(x))) < SERVE_TOL


def test_serving_plan_sticky_and_get_covariance_raises(world, served):
    _, models = served
    got = world["sticky"]
    assert got["plan"] == VAR and got["var_split"] == (P // 4,)
    kind, msg = got["get_cov"]
    assert kind == "ValueError" and "var-sharded" in msg
    assert np.abs(got["blocks0"]
                  - models["ns"].get_covariance()).max() < 1e-12
    # a single-device refit resets the plan and the dense export
    assert got["after_refit"] == (None, (P, P))


@pytest.mark.parametrize("case,kind,text", [
    ("cols", "ValueError", "n_variables = 62 is not divisible"),
    ("factors", "ValueError", "n_hidden = 6 is not divisible"),
    ("rows", "ValueError", "n_samples = 501 is not divisible"),
    ("axis", "ValueError", "mesh has axes"),
    ("gram_rows", "ValueError", "n_samples"),
    ("restarts", "ValueError", "sample sharding only"),
    ("serve_cols", "ValueError", "n_variables = 62 is not divisible"),
    ("serve_axis", "ValueError", "mesh has axes"),
])
def test_named_rejections_in_the_world(world, case, kind, text):
    got = world["errors"][case]
    assert got is not None and got[0] == kind and text in got[1], got


# -- against the JAX package's sharded fits ----------------------------------

JAX_LAYOUTS = {"var": (("var", 8),), "factor": (("model", 8),),
               "data_var": (("data", 2), ("var", 4)),
               "data_factor": (("data", 4), ("model", 2))}


@pytest.mark.parametrize("layout", list(JAX_LAYOUTS) + ["gram_var"])
def test_sharded_fit_matches_the_jax_sharded_fit(world, layout):
    """The same seeded X and RandomState W0 through `linearcorex_tpu`'s
    `fit_sharded` on its 8-device CPU mesh and through the port's on four
    ranks."""
    import jax.numpy as jnp

    from linearcorex_tpu.config import CorexConfig as JaxConfig
    from linearcorex_tpu.ops import moments as JM
    from linearcorex_tpu.ops import preprocessing as JP
    from linearcorex_tpu.parallel import sharding as JS
    xp, _ = JP.fit_preprocess(jnp.asarray(_x512(), jnp.float64), "standard")
    w0 = jnp.asarray(_w0(), jnp.float64)
    if layout == "gram_var":
        ws, mom, diag = JS.fit_sharded(
            JM.compute_gram(xp), w0, JaxConfig(**SHORT),
            JS.make_mesh((("var", 8),)), JS.ShardingPlan(
                shard_samples=False, shard_vars=True), strategy="gram",
            n_samples=N)
        got = world["gram_var"]
    else:
        plan = LAYOUTS[layout][1]
        ws, mom, diag = JS.fit_sharded(
            xp, w0, JaxConfig(optimizer="momentum", **SHORT),
            JS.make_mesh(JAX_LAYOUTS[layout]), JS.ShardingPlan(
                shard_samples=plan.shard_samples, shard_vars=plan.shard_vars,
                shard_factors=plan.shard_factors))
        got = world[f"{layout}_momentum"]
    assert np.abs(got["ws"] - np.asarray(ws)).max() < TOL
    assert abs(float(got["tc"]) - float(mom.tc)) < TOL
    assert got["iters"].tolist() == np.asarray(
        diag.iters_per_stage).tolist()


# -- a world of one: the split code with every block whole -------------------

def _solo(rank):
    """One rank: every block is the whole thing and every collective the
    identity, so each var and factor plan's fit is the plain fit bit for
    bit (W, TC, iterations), through the same split code."""
    warnings.simplefilter("ignore")
    x, w0 = _x512(), _w0()
    out = {}
    kw = dict(device="cpu", n_hidden=M, record_history=False, max_iter=40)
    for name, axes, plan, strategy in (
            ("var", (("var", 1),), VAR, "gram"),
            ("factor", (("model", 1),), FACTOR, "gram"),
            ("data_var", (("data", 1), ("var", 1)), DATA_VAR, "gram"),
            ("data_factor", (("data", 1), ("model", 1)), DATA_FACTOR,
             "samples")):
        mesh = S.make_mesh(axes, device="cpu")
        for dt, opt in (("float32", "fixed_point"), ("int8", "fixed_point"),
                        ("momentum", "momentum")):
            mode = dict(matmul_dtype="float32" if dt == "momentum" else dt,
                        optimizer=opt)
            a = lct.Corex(**mode, **kw).fit(
                x, init_ws=w0, mesh=mesh, sharding_plan=plan)
            b = lct.Corex(moment_strategy=strategy, **mode, **kw).fit(
                x, init_ws=w0)
            out[name, dt] = bool(
                torch.equal(a.ws, b.ws) and a.tc == b.tc
                and a.diagnostics.iters_per_stage.tolist()
                == b.diagnostics.iters_per_stage.tolist())
    return out


@pytest.fixture(scope="module")
def solo():
    return run_world(_solo, 1, backend="gloo", timeout=240.0)[0]


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("dt", ["float32", "int8", "momentum"])
def test_a_world_of_one_is_bitwise_the_plain_fit(solo, layout, dt):
    assert solo[layout, dt]


def _partition(clusters):
    c = np.asarray(clusters)
    return sorted(tuple(np.flatnonzero(c == k)) for k in np.unique(c))


@pytest.mark.parametrize("plan", ["data", "var"])
@pytest.mark.parametrize("dtype", HALF_DTYPES)
def test_half_dtype_mesh_fit_follows_the_plain_fit(world, dtype, plan):
    """bfloat16 and float16 fits under the data plan (rows over 4 ranks)
    and the var plan (columns over 4) against the plain fit: TC within the
    half-dtype tests' ulps of it and the same partition of the variables
    (factors whose TCs tie in the dtype may sort in another order). The
    iterations are not held: sums over rows or over p add in another
    order, and an accept flips."""
    ref = lct.Corex(**HALF_KW, dtype=dtype).fit(_x_half())
    got = world[f"half_{dtype}_{plan}"]
    ulp = 2.0 ** (np.floor(np.log2(abs(ref.tc))) - HALF_MANTISSA[dtype])
    assert abs(got["tc"] - ref.tc) <= HALF_ULPS[dtype] * ulp
    assert _partition(got["clusters"]) == _partition(ref.clusters)
