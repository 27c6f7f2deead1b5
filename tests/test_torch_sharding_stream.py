"""The moment-input and staged fits of the PyTorch port over a device mesh
(`GramAccumulator`, `fit_csv`, `fit_from_covariance` and
`Corex.partial_fit` with `mesh=`, `utils.checkpoint.fit_with_checkpoints`
with `mesh=`, and `StackedCorex` under a mesh) on a four-rank CPU world.

As in `tests/test_torch_sharding_vars.py`, the module spawns ONE world of
four ranks (gloo, a file rendezvous, no network) per run; `_world` drives
every case and hands numpy results back, which the parent asserts as
separate tests. The cases are the JAX package's tests of the same forms
(`tests/test_streaming.py`, `tests/test_checkpoint.py`,
`tests/test_stacked.py`, `tests/test_sharding.py`) with four ranks in
place of eight. Each is held against the port's single-device form (W
and TC within 1e-7 in float64, the same iterations per stage) and against
the JAX package's mesh form on its 8-device CPU mesh, from the same
seeded numpy data. A world of one holds the mesh forms to their plain
forms bit for bit.

This module imports neither JAX nor `tests.conftest` at the top: the
spawned ranks import it, and the port runs without JAX.
"""

import datetime
import hashlib
import os
import shutil
import time
import warnings

import numpy as np
import pytest
import torch

import linearcorex_tpu_torch as lct
from linearcorex_tpu_torch.parallel import sharding as S
from linearcorex_tpu_torch.parallel.launch import run_world
from linearcorex_tpu_torch.utils.checkpoint import fit_with_checkpoints

# One intra-op thread: the suite runs its files in parallel worker
# processes, and an OpenMP pool per process on every core slows the
# small tensors here several times over.
torch.set_num_threads(1)

TOL = 1e-7          # W and TC, mesh form against single-device (float64)
CORR_TOL = 1e-12    # the accumulated correlation
CKPT_TOL = 1e-9     # checkpointed mesh fit against Corex.fit(mesh=)
WORLD = 4
WORLD_TIMEOUT = 900.0   # a deadline for a hang: the world takes ~60 s alone
KW64 = dict(dtype="float64", device="cpu")

VAR = S.ShardingPlan(shard_samples=False, shard_vars=True)
DATA_VAR = S.ShardingPlan(shard_samples=True, shard_vars=True)


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


# the data of each case, as the JAX tests make it
def _x_acc():
    return block_data(n=1200, p=64, m=8, seed=0)


def _x_pf():
    return block_data(n=1024, p=32, m=4, seed=11)


def _x_cov():
    return block_data(n=900, p=48, m=6, seed=12)


def _x_csv():
    return block_data(n=300, p=16, m=2, seed=13)


def _x_int8():
    return block_data(n=800, p=32, m=4, seed=14).astype(np.float32)


def _x_ckpt():
    return block_data(n=1000, p=64, m=8, seed=0)


def _x_resume():
    return block_data(n=500, p=32, m=4, seed=3)[:496]


def _x_stack():
    return block_data(n=512, p=64, m=8, seed=4)


def _x_stack_e2e():
    return block_data(n=512, p=64, m=8, seed=5)


def _x_restarts():
    return block_data(n=256, p=32, m=4, seed=3, strength=0.3)


def _w_ckpt():
    return np.random.RandomState(5).normal(scale=1 / np.sqrt(64),
                                           size=(8, 64))


def _w_resume():
    return np.random.RandomState(5).normal(scale=1 / np.sqrt(32),
                                           size=(4, 32))


STACK_E2E = dict(record_history=False, seed=0, max_iter=500,
                 moment_strategy="samples", **KW64)
RESTART_KW = dict(n_restarts=2, seed=7, max_iter=100, record_history=False,
                  moment_strategy="samples", **KW64)


def _fit(model):
    """What the parent asserts of a fitted estimator."""
    return dict(ws=model.ws.numpy(), tc=float(model.tc),
                iters=model.diagnostics.iters_per_stage.numpy(),
                clusters=model.clusters,
                n_samples=model.n_samples, plan=model._serving_plan)


def _raised(fn):
    """(exception type name, message) of what `fn` raises, or None."""
    try:
        fn()
    except Exception as e:   # the parent asserts type and message
        return type(e).__name__, str(e)
    return None


def _whole(t):
    return np.asarray(t.full_tensor() if hasattr(t, "full_tensor") else t)


def _accumulate(x, batch, **kw):
    acc = lct.GramAccumulator(x.shape[1], **kw)
    for start in range(0, x.shape[0], batch):
        acc.update(x[start:start + batch])
    return acc


def _partial(x, mesh=None, batch=256, **kw):
    """partial_fit in batches, the mesh on the first call only."""
    est = lct.Corex(n_hidden=4, seed=0, **KW64, **kw)
    for k, start in enumerate(range(0, x.shape[0], batch)):
        est.partial_fit(x[start:start + batch],
                        mesh=mesh if k == 0 else None)
    return est


class _Stop(Exception):
    pass


def _stop_after(stage):
    def callback(s, eps, ws, stats):
        if s == stage:
            raise _Stop
    return callback


# ---------------------------------------------------------------------------
# The world: every case that needs more than one rank
# ---------------------------------------------------------------------------

def _world(rank, csv_path, ck_root):
    """Runs on every rank of the four-rank world. Returns {case: result};
    rank 0's results are asserted, and `digest` (a hash of every fitted W)
    is compared across ranks."""
    warnings.simplefilter("ignore")
    out, digest = {}, hashlib.sha1()
    timeout = datetime.timedelta(seconds=WORLD_TIMEOUT)

    def mesh_of(*axes):
        return S.make_mesh(axes, device="cpu", timeout=timeout)

    var4 = mesh_of(("var", 4))
    data4 = mesh_of(("data", 4))
    dv = mesh_of(("data", 2), ("var", 2))
    vd = mesh_of(("var", 2), ("data", 2))

    def keep(name, model):
        out[name] = _fit(model)
        digest.update(out[name]["ws"].tobytes())

    # the accumulator: Σ's row block per rank from the first batch on
    x = _x_acc()
    acc = _accumulate(x, 256, mesh=var4, **KW64)
    corr = acc.correlation()
    out["acc_state"] = dict(
        g=tuple(acc._g.shape), s=tuple(acc._s.shape),
        corr_local=tuple(corr.to_local().shape),
        placements=[f"Shard({p.dim})" if p.is_shard() else "Replicate"
                    for p in corr.placements], n=acc.n_samples)
    out["acc_corr"] = _whole(corr)
    model = acc.fit(n_hidden=8, seed=0)
    keep("acc", model)
    out["acc_transform"] = model.transform(x[:16], mesh=var4)
    # the same plan on a data x var mesh: the ranks along `data` hold the
    # same row block
    keep("acc_data_var", _accumulate(x, 256, mesh=dv, sharding_plan=DATA_VAR,
                                     **KW64).fit(n_hidden=8, seed=0))

    # partial_fit with the mesh on the first call only, and its layout
    # checks mid-stream
    keep("partial_fit", _partial(_x_pf(), var4))
    est = lct.Corex(n_hidden=4, seed=0, **KW64)
    xs = _x_pf()[:128]
    est.partial_fit(xs[:64], mesh=var4)
    out["mid_stream"] = dict(
        other_mesh=_raised(lambda: est.partial_fit(xs[64:], mesh=vd)),
        other_plan=_raised(lambda: est.partial_fit(
            xs[64:], sharding_plan=DATA_VAR)),
        rebuilt_mesh=_raised(lambda: est.partial_fit(
            xs[64:], mesh=mesh_of(("var", 4)))),
        n_samples=est.n_samples)

    # fit_from_covariance and fit_csv
    x = _x_cov()
    keep("cov", lct.fit_from_covariance(np.cov(x.T, bias=True), 900, 6,
                                        seed=0, mesh=var4, **KW64))
    keep("csv", lct.fit_csv(csv_path, n_hidden=2, block_rows=128, seed=0,
                            mesh=var4, **KW64))

    # int8 over the mesh: quantize_gram's scale and guard on the split Σ
    acc8 = _accumulate(_x_int8(), 256, mesh=var4, dtype="float32",
                       device="cpu")
    keep("int8", acc8.fit(n_hidden=4, seed=0, matmul_dtype="int8", tol=1e-4))

    # named rejections
    out["errors"] = dict(
        sample_plan=_raised(lambda: lct.GramAccumulator(
            64, mesh=var4, sharding_plan=S.ShardingPlan(), **KW64)),
        slices=_raised(lambda: lct.GramAccumulator(
            64, mesh=var4, sharding_plan=S.ShardingPlan(
                shard_vars=True, shard_slices=True), **KW64)),
        divisible=_raised(lambda: lct.GramAccumulator(63, mesh=var4,
                                                      **KW64)),
        cov_plan=_raised(lambda: lct.fit_from_covariance(
            np.eye(64), 100, 4, mesh=var4,
            sharding_plan=S.ShardingPlan(shard_samples=True), **KW64)),
        no_var_axis=_raised(lambda: lct.GramAccumulator(64, mesh=data4,
                                                        **KW64)),
        plan_without_mesh=_raised(lambda: lct.GramAccumulator(
            64, sharding_plan=VAR, **KW64)),
        subsample=_raised(lambda: fit_with_checkpoints(
            lct.Corex(n_hidden=8, stage_subsample=0.5,
                      moment_strategy="samples", **KW64), _x_ckpt(),
            os.path.join(ck_root, "subsample"), mesh=data4)))

    # checkpoints: every stage through fit_sharded, one writer
    x, w0 = _x_ckpt(), _w_ckpt()
    calls = []

    def count(s, eps, ws, stats):
        calls.append(s)

    for name, mesh, plan in (("data", data4, None), ("var", var4, VAR)):
        keep(f"ckpt_{name}", fit_with_checkpoints(
            lct.Corex(n_hidden=8, **KW64), x,
            os.path.join(ck_root, f"ckpt_{name}"), init_ws=w0, mesh=mesh,
            sharding_plan=plan, stage_callback=count))
        keep(f"fit_{name}", lct.Corex(n_hidden=8, **KW64).fit(
            x, init_ws=w0, mesh=mesh, sharding_plan=plan))
    out["callbacks"] = len(calls)
    out["ckpt_files"] = sorted(os.listdir(os.path.join(ck_root,
                                                       "ckpt_data")))
    # interrupted after stage 2 under the mesh, then resumed under it; the
    # parent resumes another interrupted copy on one device
    cut = os.path.join(ck_root, "cut_mesh")
    out["cut"] = _raised(lambda: fit_with_checkpoints(
        lct.Corex(n_hidden=8, **KW64), x, cut, init_ws=w0, mesh=var4,
        sharding_plan=VAR, stage_callback=_stop_after(2)))
    if rank == 0:
        shutil.copytree(cut, os.path.join(ck_root, "cut_mesh_for_one"))
    S.mesh_barrier(var4, "cpu")
    keep("ckpt_resumed", fit_with_checkpoints(
        lct.Corex(n_hidden=8, **KW64), x, cut, init_ws=w0, mesh=var4,
        sharding_plan=VAR))
    # a checkpoint written on one device resumes under the mesh
    keep("ckpt_from_one", fit_with_checkpoints(
        lct.Corex(n_hidden=4, **KW64), _x_resume(),
        os.path.join(ck_root, "single_done"), init_ws=_w_resume(),
        mesh=data4))

    # the stack: every layer's fit over the mesh
    x = _x_stack()
    stacks = {
        "stack_data": lct.StackedCorex([8, 2], seed=0, **KW64).fit(
            x, mesh=data4),
        "stack_var": lct.StackedCorex([8, 2], seed=0, **KW64).fit(
            x, mesh=var4, sharding_plan=VAR)}
    x = _x_stack_e2e()
    sm = lct.StackedCorex([8, 2], **STACK_E2E).fit(x, mesh=dv,
                                                   sharding_plan=DATA_VAR)
    stacks["stack_e2e"] = sm
    for name, st in stacks.items():
        out[name] = dict(tc=st.tc, tcs=st.tcs,
                         plans=[la._serving_plan for la in st.layers])
        for la in st.layers:
            digest.update(la.ws.numpy().tobytes())
    ys = lct.StackedCorex([8, 2], **STACK_E2E).fit(x).transform(x)
    alls = sm.transform_all(x, mesh=dv, sharding_plan=DATA_VAR)
    out["stack_serving"] = dict(
        y=sm.transform(x, mesh=dv, sharding_plan=DATA_VAR),
        xh=_whole(sm.predict(ys, mesh=dv, sharding_plan=DATA_VAR)),
        xh_inverse=_whole(sm.inverse_transform(ys, mesh=dv,
                                               sharding_plan=DATA_VAR)),
        all_shapes=[tuple(a.shape) for a in alls],
        fit_transform=lct.StackedCorex([8, 2], **STACK_E2E).fit_transform(
            x, mesh=dv, sharding_plan=DATA_VAR))
    # restart sweeps in every layer: a restarts x data mesh, and a
    # restart-only mesh, whose transform between layers runs per rank
    x = _x_restarts()
    rd = mesh_of(("restarts", 2), ("data", 2))
    r4 = mesh_of(("restarts", 4))
    for name, mesh in (("restarts_data", rd), ("restarts_only", r4)):
        st = lct.StackedCorex([4, 2], **RESTART_KW).fit(x, mesh=mesh)
        out[name] = [dict(ws=la.ws.numpy(), best=la.best_restart_)
                     for la in st.layers]
    out["restarts_only_fit_transform"] = lct.StackedCorex(
        [4, 2], **RESTART_KW).fit_transform(x, mesh=r4)
    out["digest"] = digest.hexdigest()
    if rank:
        return {"digest": out["digest"], "callbacks": out["callbacks"]}
    return out


@pytest.fixture(scope="module")
def ck_root(tmp_path_factory):
    """The directory the world's checkpoints share (every rank reads the
    same files; one writes), with a complete single-device checkpoint of
    the resume case in `single_done`."""
    root = tmp_path_factory.mktemp("ckpt")
    fit_with_checkpoints(lct.Corex(n_hidden=4, **KW64), _x_resume(),
                         str(root / "single_done"), init_ws=_w_resume())
    return root


@pytest.fixture(scope="module")
def csv_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("csv") / "data.csv"
    np.savetxt(path, _x_csv(), delimiter=",")
    return str(path)


@pytest.fixture(scope="module")
def world(ck_root, csv_path):
    t0 = time.monotonic()
    ranks = run_world(_world, WORLD, (csv_path, str(ck_root)),
                      backend="gloo", timeout=WORLD_TIMEOUT)
    res = ranks[0]
    res["all_digests"] = [r["digest"] for r in ranks]
    res["all_callbacks"] = [r["callbacks"] for r in ranks]
    res["seconds"] = time.monotonic() - t0
    return res


# -- single-device references, computed once in the parent -------------------

@pytest.fixture(scope="module")
def single(csv_path, tmp_path_factory):
    """The port's single-device forms of every case."""
    out = {}
    x = _x_acc()
    acc = _accumulate(x, 256, **KW64)
    out["acc_corr"] = acc.correlation().numpy()
    model = acc.fit(n_hidden=8, seed=0)
    out["acc"] = _fit(model)
    out["acc_transform"] = model.transform(x[:16])
    out["partial_fit"] = _fit(_partial(_x_pf()))
    x = _x_cov()
    out["cov"] = _fit(lct.fit_from_covariance(np.cov(x.T, bias=True), 900,
                                              6, seed=0, **KW64))
    out["csv"] = _fit(lct.fit_csv(csv_path, n_hidden=2, block_rows=128,
                                  seed=0, **KW64))
    out["int8"] = _fit(_accumulate(_x_int8(), 256, dtype="float32",
                                   device="cpu").fit(
        n_hidden=4, seed=0, matmul_dtype="int8", tol=1e-4))
    root = tmp_path_factory.mktemp("single")
    x, w0 = _x_ckpt(), _w_ckpt()
    out["ckpt"] = _fit(fit_with_checkpoints(
        lct.Corex(n_hidden=8, **KW64), x, str(root / "ck"), init_ws=w0))
    out["ckpt_resume"] = _fit(fit_with_checkpoints(
        lct.Corex(n_hidden=4, **KW64), _x_resume(), str(root / "resume"),
        init_ws=_w_resume()))
    x = _x_stack()
    st = lct.StackedCorex([8, 2], seed=0, **KW64).fit(x)
    out["stack"] = dict(tc=st.tc, tcs=st.tcs)
    x = _x_stack_e2e()
    ss = lct.StackedCorex([8, 2], **STACK_E2E).fit(x)
    ys = ss.transform(x)
    out["stack_e2e"] = dict(tc=ss.tc, y=ys,
                            xh=ss.predict(ys),
                            tcs=ss.tcs)
    x = _x_restarts()
    rs = lct.StackedCorex([4, 2], **RESTART_KW).fit(x)
    out["restarts"] = [dict(ws=la.ws.numpy(), best=la.best_restart_)
                       for la in rs.layers]
    out["restarts_y"] = rs.transform(x)
    return out


def _close(got, ref, tol=TOL, iters=True):
    assert np.abs(got["ws"] - ref["ws"]).max() < tol
    assert abs(got["tc"] - ref["tc"]) < tol
    assert np.array_equal(got["clusters"], ref["clusters"])
    if iters:
        assert got["iters"].tolist() == ref["iters"].tolist()


def test_accumulator_keeps_only_its_row_block(world):
    """Σ's row block over `var` 4 from the first batch: (16, 64) per rank,
    never the whole (64, 64); correlation() a DTensor of those blocks."""
    got = world["acc_state"]
    assert got["g"] == (16, 64) and got["s"] == (16,)
    assert got["corr_local"] == (16, 64)
    assert got["placements"] == ["Shard(0)"] and got["n"] == 1200


def test_accumulated_correlation_equals_single_device(world, single):
    assert np.abs(world["acc_corr"] - single["acc_corr"]).max() < CORR_TOL


@pytest.mark.parametrize("case", ["acc", "acc_data_var", "partial_fit",
                                  "cov", "csv"])
def test_moment_input_mesh_fit_equals_single_device(world, single, case):
    ref = single["acc" if case == "acc_data_var" else case]
    _close(world[case], ref)
    assert world[case]["n_samples"] == ref["n_samples"]


@pytest.mark.parametrize("case,plan", [("acc", VAR), ("acc_data_var",
                                                      DATA_VAR),
                                       ("partial_fit", VAR), ("cov", VAR),
                                       ("csv", VAR)])
def test_mesh_fit_serves_under_its_plan(world, case, plan):
    assert world[case]["plan"] == plan


def test_accumulator_model_transforms_over_the_mesh(world, single):
    assert np.abs(world["acc_transform"]
                  - single["acc_transform"]).max() < TOL


def test_int8_accumulator_over_the_mesh_runs_guarded(world, single):
    """quantize_gram scales by the maximum over all of Σ and guards the
    split operand: the fit follows the single-device int8 fit (the JAX
    test's bar: TC within 5%, the same clusters)."""
    got, ref = world["int8"], single["int8"]
    assert got["ws"].dtype == np.float32
    assert got["tc"] == pytest.approx(ref["tc"], rel=0.05)
    assert np.array_equal(got["clusters"], ref["clusters"])


@pytest.mark.parametrize("case,text", [
    ("other_mesh", "mid-stream"), ("other_plan", "mid-stream")])
def test_partial_fit_layout_binds_on_the_first_call(world, case, text):
    kind, msg = world["mid_stream"][case]
    assert kind == "ValueError" and text in msg


def test_partial_fit_compares_meshes_by_value(world):
    """A mesh rebuilt alike mid-stream is the same layout: the batch is
    taken (64 + 64 rows; the two refused calls took none)."""
    got = world["mid_stream"]
    assert got["rebuilt_mesh"] is None and got["n_samples"] == 128


@pytest.mark.parametrize("case,kind,text", [
    ("sample_plan", "ValueError", "shard_vars"),
    ("slices", "ValueError", "shard_slices"),
    ("divisible", "ValueError", "divisible"),
    ("cov_plan", "ValueError", "shard_vars"),
    ("no_var_axis", "ValueError", "mesh has axes"),
    ("plan_without_mesh", "ValueError", "without mesh="),
    ("subsample", "ValueError", "stage_subsample"),
])
def test_named_rejections_in_the_world(world, case, kind, text):
    got = world["errors"][case]
    assert got is not None and got[0] == kind and text in got[1], got


@pytest.mark.parametrize("layout", ["data", "var"])
def test_checkpointed_mesh_fit_equals_mesh_fit(world, layout):
    """Every stage through fit_sharded: the checkpointed fit equals
    Corex.fit(mesh=) from the same W0 within 1e-9 (the JAX test's bar)."""
    got, ref = world[f"ckpt_{layout}"], world[f"fit_{layout}"]
    assert np.abs(got["ws"] - ref["ws"]).max() < CKPT_TOL
    assert abs(got["tc"] - ref["tc"]) < CKPT_TOL
    assert got["plan"] == ref["plan"]


@pytest.mark.parametrize("layout", ["data", "var"])
def test_checkpointed_mesh_fit_equals_single_device_checkpointed_fit(
        world, single, layout):
    _close(world[f"ckpt_{layout}"], single["ckpt"])


def test_one_writer_and_a_callback_on_every_rank(world):
    """One file per directory, no temporary left behind, and the stage
    callback ran on each of the four ranks, once per stage of each of the
    two checkpointed fits."""
    assert world["ckpt_files"] == ["stage_state.npz"]
    n = len(world["ckpt_data"]["iters"])
    assert world["all_callbacks"] == [2 * n] * WORLD


def test_interrupted_mesh_checkpoint_resumes_under_the_mesh(world):
    assert world["cut"][0] == "_Stop"
    _close(world["ckpt_resumed"], world["ckpt_var"], tol=CKPT_TOL)


def test_mesh_checkpoint_resumes_on_one_device(world, ck_root):
    """The interrupted mesh checkpoint's file is whole W: one device
    resumes it and ends where the uninterrupted mesh fit did."""
    got = _fit(fit_with_checkpoints(
        lct.Corex(n_hidden=8, **KW64), _x_ckpt(),
        str(ck_root / "cut_mesh_for_one"), init_ws=_w_ckpt()))
    _close(got, world["ckpt_var"], tol=CKPT_TOL)
    assert got["plan"] is None


def test_single_device_checkpoint_resumes_under_the_mesh(world, single):
    _close(world["ckpt_from_one"], single["ckpt_resume"], tol=CKPT_TOL)


@pytest.mark.parametrize("layout", ["stack_data", "stack_var"])
def test_stacked_mesh_fit_matches_single_device(world, single, layout):
    got, ref = world[layout], single["stack"]
    assert abs(got["tc"] - ref["tc"]) < 1e-8
    for a, b in zip(got["tcs"], ref["tcs"]):
        assert np.abs(a - b).max() < 1e-8


def test_stacked_var_plan_applies_to_layer_one_only(world):
    assert world["stack_var"]["plans"] == [
        VAR, S.ShardingPlan(shard_samples=False)]
    assert world["stack_e2e"]["plans"] == [
        DATA_VAR, S.ShardingPlan(shard_samples=True)]


def test_stacked_mesh_end_to_end(world, single):
    got, ref = world["stack_serving"], single["stack_e2e"]
    assert abs(world["stack_e2e"]["tc"] - ref["tc"]) < TOL
    assert np.abs(got["y"] - ref["y"]).max() < 1e-9
    assert np.abs(got["xh"] - ref["xh"]).max() < 1e-9
    assert np.array_equal(got["xh_inverse"], got["xh"])
    assert got["all_shapes"] == [(512, 8), (512, 2)]
    assert np.abs(got["fit_transform"] - ref["y"]).max() < TOL


@pytest.mark.parametrize("layout", ["restarts_data", "restarts_only"])
def test_stacked_restart_sweeps_compose_with_the_mesh(world, single,
                                                      layout):
    for got, ref in zip(world[layout], single["restarts"]):
        assert got["best"] == ref["best"]
        assert np.abs(got["ws"] - ref["ws"]).max() < TOL


def test_stacked_restart_only_mesh_fit_transform(world, single):
    assert np.abs(world["restarts_only_fit_transform"]
                  - single["restarts_y"]).max() < TOL


def test_every_rank_ends_with_the_same_bits(world):
    assert len(world["all_digests"]) == WORLD
    assert len(set(world["all_digests"])) == 1


# -- against the JAX package's mesh forms ------------------------------------

@pytest.fixture(scope="module")
def jax_forms(csv_path, tmp_path_factory):
    """The JAX package's mesh forms of the same cases on its 8-device CPU
    mesh (`var` 8 where the port's world has `var` 4)."""
    import linearcorex_tpu as lc
    from linearcorex_tpu.models.stacked import StackedCorex as JStack
    from linearcorex_tpu.parallel.sharding import ShardingPlan as JPlan
    from linearcorex_tpu.parallel.sharding import make_mesh
    from linearcorex_tpu.utils.checkpoint import \
        fit_with_checkpoints as jax_ckpt

    def fit(model):
        return dict(ws=np.asarray(model.ws), tc=float(model.tc),
                    iters=np.asarray(model.diagnostics.iters_per_stage),
                    clusters=np.asarray(model.clusters))

    var8, data8 = make_mesh((("var", 8),)), make_mesh()
    out = {}
    x = _x_acc()
    acc = lc.GramAccumulator(64, dtype="float64", mesh=var8)
    for start in range(0, 1200, 256):
        acc.update(x[start:start + 256])
    out["acc_corr"] = np.asarray(acc.correlation())
    out["acc"] = fit(acc.fit(n_hidden=8, seed=0))
    est = lc.Corex(n_hidden=4, seed=0, dtype="float64")
    x = _x_pf()
    for k, start in enumerate(range(0, 1024, 256)):
        est.partial_fit(x[start:start + 256], mesh=var8 if k == 0 else None)
    out["partial_fit"] = fit(est)
    x = _x_cov()
    out["cov"] = fit(lc.fit_from_covariance(np.cov(x.T, bias=True), 900, 6,
                                            seed=0, dtype="float64",
                                            mesh=var8))
    out["csv"] = fit(lc.fit_csv(csv_path, n_hidden=2, block_rows=128,
                                seed=0, dtype="float64", mesh=var8))
    root = tmp_path_factory.mktemp("jax_ckpt")
    m = lc.Corex(n_hidden=8, dtype="float64")
    jax_ckpt(m, _x_ckpt(), str(root / "ck"), init_ws=_w_ckpt(), mesh=data8)
    out["ckpt_data"] = fit(m)
    x = _x_stack()
    for name, kw in (("stack_data", dict(mesh=data8)),
                     ("stack_var", dict(mesh=var8, sharding_plan=JPlan(
                         shard_samples=False, shard_vars=True)))):
        st = JStack([8, 2], seed=0, dtype="float64").fit(x, **kw)
        out[name] = dict(tc=st.tc, tcs=[np.asarray(t) for t in st.tcs])
    return out


@pytest.mark.parametrize("case", ["acc", "partial_fit", "cov", "csv",
                                  "ckpt_data"])
def test_mesh_form_matches_the_jax_mesh_form(world, jax_forms, case):
    _close(world[case], jax_forms[case])


def test_accumulated_correlation_matches_the_jax_mesh_form(world,
                                                           jax_forms):
    assert np.abs(world["acc_corr"] - jax_forms["acc_corr"]).max() \
        < CORR_TOL


@pytest.mark.parametrize("layout", ["stack_data", "stack_var"])
def test_stacked_mesh_fit_matches_the_jax_mesh_form(world, jax_forms,
                                                    layout):
    got, ref = world[layout], jax_forms[layout]
    assert abs(got["tc"] - ref["tc"]) < TOL
    for a, b in zip(got["tcs"], ref["tcs"]):
        assert np.abs(a - b).max() < TOL


# -- a world of one: the split code with every block whole -------------------

def _solo(rank, csv_path, ck_root):
    """One rank: every block is the whole thing and every collective runs
    over one rank, so each mesh form is its plain form bit for bit (W,
    TC, iterations per stage) in float32 and int8."""
    warnings.simplefilter("ignore")
    mesh = S.make_mesh((("var", 1),), device="cpu")
    x = _x_acc().astype(np.float32)
    kw = dict(dtype="float32", device="cpu")
    out = {}

    def same(a, b):
        return bool(torch.equal(a.ws, b.ws) and a.tc == b.tc
                    and a.diagnostics.iters_per_stage.tolist()
                    == b.diagnostics.iters_per_stage.tolist())

    acc = _accumulate(x, 256, mesh=mesh, **kw)
    ref = _accumulate(x, 256, **kw)
    out["correlation"] = bool(torch.equal(acc.correlation().full_tensor(),
                                          ref.correlation()))
    for dt in ("float32", "int8"):
        fit = dict(n_hidden=8, seed=0, max_iter=200, matmul_dtype=dt,
                   optimizer="fixed_point", tol=1e-4)
        out[f"accumulator_{dt}"] = same(acc.fit(**fit), ref.fit(**fit))
        sig = np.cov(x.T.astype(np.float64), bias=True)
        out[f"covariance_{dt}"] = same(
            lct.fit_from_covariance(sig, 1200, mesh=mesh, **fit, **kw),
            lct.fit_from_covariance(sig, 1200, **fit, **kw))
    a = lct.Corex(n_hidden=8, seed=0, max_iter=200, **kw)
    b = lct.Corex(n_hidden=8, seed=0, max_iter=200, **kw)
    for k, start in enumerate((0, 600)):
        a.partial_fit(x[start:start + 600], mesh=mesh if k == 0 else None)
        b.partial_fit(x[start:start + 600])
    out["partial_fit"] = same(a, b)
    for dt in ("float32", "int8"):
        ck = dict(n_hidden=8, max_iter=200, matmul_dtype=dt, **kw)
        w0 = _w_ckpt()
        out[f"checkpoint_{dt}"] = same(
            fit_with_checkpoints(lct.Corex(**ck), x,
                                 os.path.join(ck_root, f"solo_mesh_{dt}"),
                                 init_ws=w0, mesh=mesh, sharding_plan=VAR),
            fit_with_checkpoints(lct.Corex(**ck), x,
                                 os.path.join(ck_root, f"solo_{dt}"),
                                 init_ws=w0))
    sa = lct.StackedCorex([8, 2], seed=0, max_iter=200, **kw).fit(
        x, mesh=mesh, sharding_plan=VAR)
    sb = lct.StackedCorex([8, 2], seed=0, max_iter=200, **kw).fit(x)
    out["stack"] = all(same(p, q) for p, q in zip(sa.layers, sb.layers))
    return out


@pytest.fixture(scope="module")
def solo(ck_root, csv_path):
    return run_world(_solo, 1, (csv_path, str(ck_root)), backend="gloo",
                     timeout=240.0)[0]


@pytest.mark.parametrize("case", [
    "correlation", "accumulator_float32", "accumulator_int8",
    "covariance_float32", "covariance_int8", "partial_fit",
    "checkpoint_float32", "checkpoint_int8", "stack"])
def test_a_world_of_one_is_bitwise_the_plain_form(solo, case):
    assert solo[case]
