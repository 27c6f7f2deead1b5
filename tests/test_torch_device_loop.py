"""The solver's accept/reject loop as a device program, on the CPU.

`core.solver.fit_core` keeps its carry on the device and reads one flag
per chunk of K bodies. Held here:
- K = 1, 3 and 8 give the same bits (W and every `FitDiagnostics` field)
  over the optimizers, one lane and 3 lanes, the history on and off,
  float64/float32/bfloat16/float16, gram and samples, and the operand
  modes; a `Corex` fit's `n_iter_` and `history` too;
- on a toy float64 objective written once for torch and once for JAX, the
  port's `fit_core` is step-matched with the JAX package's (the same
  iterations per stage, TC and W within 1e-12), one lane and lanes;
- no evaluation copies a value from the host or reads one from the
  device, and a fit reads the host at most ⌈iterations/K⌉ + stages + 1
  times, every read the solver's own;
- the rules that decide which fits a card captures, and the launch
  counting of captured graphs.
The card's side (capture and replay, bitwise the uncaptured loop) is in
tests/test_torch_cuda.py.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import linearcorex_tpu_torch as lct
from linearcorex_tpu.config import CorexConfig as JaxConfig
from linearcorex_tpu.core.solver import fit_core as jax_fit_core
from linearcorex_tpu_torch.config import CorexConfig
from linearcorex_tpu_torch.core import solver as S
from linearcorex_tpu_torch.models import corex as TC
from linearcorex_tpu_torch.ops import cuda_moments as CM
from linearcorex_tpu_torch.parallel.restarts import init_restarts
from linearcorex_tpu_torch.utils import profiling as TP
from tests.conftest import block_data

torch.set_num_threads(1)

M_, P_ = 3, 12
TOY_TOL = 1e-12


@pytest.fixture(scope="module")
def x():
    return block_data(n=200, p=P_, m=M_, seed=4)


def _fit(x, chunk, lanes=1, **kw):
    """(ws, diagnostics) of `fit_core` on the objective `Corex.fit` builds
    for `kw`, with K = `chunk`."""
    model = lct.Corex(n_hidden=M_, seed=0, device="cpu", **kw)
    data, cfg, strategy = model._prepare_fit(x)
    if lanes == 1:
        w0 = model._resolve_w0(None)
    else:
        w0 = init_restarts(lanes, M_, P_, 0, TC.torch_dtype(cfg.dtype),
                           "cpu")
    return S.fit_core(TC._make_obj_grad(data, cfg, strategy), w0, cfg,
                      _chunk=chunk)


def _same(a, b):
    return a.dtype == b.dtype and a.device == b.device \
        and a.shape == b.shape and torch.equal(a, b)


def _assert_same_fits(runs):
    (ws0, d0), *rest = runs
    for ws, d in rest:
        assert _same(ws, ws0)
        for f in d0._fields:
            assert _same(getattr(d, f), getattr(d0, f)), f


CHUNK_CASES = [(opt, dt) for opt in ("gd", "momentum", "fixed_point")
               for dt in ("float64", "float32", "bfloat16", "float16")
               if not (opt == "fixed_point" and dt in ("bfloat16",
                                                       "float16"))]


@pytest.mark.parametrize("strategy", ["gram", "samples"])
@pytest.mark.parametrize("lanes", [1, 3])
@pytest.mark.parametrize("optimizer,dtype", CHUNK_CASES)
def test_chunk_size_keeps_every_bit(x, optimizer, dtype, lanes, strategy):
    for record in (True, False):
        kw = dict(optimizer=optimizer, dtype=dtype, max_iter=40,
                  moment_strategy=strategy, record_history=record)
        runs = [_fit(x, k, lanes, **kw) for k in (1, 3, 8)]
        _assert_same_fits(runs)
        d = runs[0][1]
        assert d.iters_per_stage.dtype == torch.int32
        assert d.iters_per_stage.shape[-1] == d.tc_per_stage.shape[-1] > 1
        assert d.tc_history.shape[-1] == (40 if record else 0)


@pytest.mark.parametrize("lanes", [1, 3])
@pytest.mark.parametrize("use_pallas", ["never", "always"])
@pytest.mark.parametrize("matmul_dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("optimizer", ["momentum", "fixed_point"])
def test_chunk_size_keeps_every_bit_of_operand_modes(
        x, optimizer, matmul_dtype, use_pallas, lanes):
    kw = dict(optimizer=optimizer, matmul_dtype=matmul_dtype,
              use_pallas=use_pallas, max_iter=40)
    _assert_same_fits([_fit(x, k, lanes, **kw) for k in (1, 3, 8)])


@pytest.mark.parametrize("lanes", [1, 3])
def test_chunk_size_keeps_every_bit_of_the_overlap_objective(x, lanes):
    kw = dict(discourage_overlap=False, max_iter=40, dtype="float64")
    _assert_same_fits([_fit(x, k, lanes, **kw) for k in (1, 3, 8)])


@pytest.mark.parametrize("chunk", [3, 8])
def test_a_corex_fit_keeps_its_iterations_and_history(x, chunk,
                                                      monkeypatch):
    kw = dict(n_hidden=M_, seed=0, device="cpu", max_iter=60)
    plain = lct.Corex(**kw).fit(x)
    monkeypatch.setattr(TC, "fit_core",
                        functools.partial(S.fit_core, _chunk=chunk))
    chunked = lct.Corex(**kw).fit(x)
    assert chunked.n_iter_ == plain.n_iter_
    assert np.array_equal(chunked.clusters, plain.clusters)
    assert torch.equal(chunked.ws, plain.ws)
    h0, h1 = plain.history, chunked.history
    assert h0.keys() == h1.keys()
    assert np.array_equal(h0["iters_per_stage"], h1["iters_per_stage"])
    for a, b in zip(h0["TC"], h1["TC"]):
        assert np.array_equal(a, b)


# --- step-matched with the JAX package on a toy float64 objective ---------

def _toy_parts(rng, lanes):
    a = rng.normal(size=(M_, P_))
    c = rng.uniform(1.0, 12.0, size=(M_, P_))
    w0 = rng.normal(scale=0.5, size=lanes + (M_, P_))
    return a, c, w0


def _toy_torch(a, c):
    a, c = torch.as_tensor(a), torch.as_tensor(c)

    def obj(ws, eps):
        d = ws - a
        e2 = eps ** 2
        f = torch.sum(0.5 * c * d * d + 0.25 * d ** 4 + e2 * ws,
                      dim=(-2, -1))
        g = c * d + d ** 3 + e2
        return f, g, -f
    return obj


def _toy_jax(a, c):
    a, c = jnp.asarray(a), jnp.asarray(c)

    def obj(ws, eps):
        d = ws - a
        e2 = eps ** 2
        f = jnp.sum(0.5 * c * d * d + 0.25 * d ** 4 + e2 * ws,
                    axis=(-2, -1))
        g = c * d + d ** 3 + e2
        return f, g, -f
    return obj


@pytest.mark.parametrize("chunk", [1, 8])
@pytest.mark.parametrize("lanes", [(), (3,)])
@pytest.mark.parametrize("optimizer", ["gd", "momentum", "fixed_point"])
def test_toy_objective_step_matched_with_jax(optimizer, lanes, chunk):
    a, c, w0 = _toy_parts(np.random.RandomState(5), lanes)
    kw = dict(n_hidden=M_, dtype="float64", optimizer=optimizer,
              max_iter=150, tol=1e-6)
    ws, diag = S.fit_core(_toy_torch(a, c), torch.as_tensor(w0),
                          CorexConfig(**kw), _chunk=chunk)

    def jax_fit(w):
        return jax_fit_core(_toy_jax(a, c), w, JaxConfig(**kw))
    run = jax.vmap(jax_fit) if lanes else jax_fit
    wj, dj = jax.jit(run)(jnp.asarray(w0))
    iters = diag.iters_per_stage.numpy()
    assert iters.tolist() == np.asarray(dj.iters_per_stage).tolist()
    assert np.abs(ws.numpy() - np.asarray(wj)).max() < TOY_TOL
    for f in ("tc_per_stage", "objective_per_stage", "tc_history",
              "eps_schedule"):
        got, want = getattr(diag, f).numpy(), np.asarray(getattr(dj, f))
        assert got.shape == want.shape, f
        assert np.abs(got - want).max() < TOY_TOL * max(
            1.0, np.abs(want).max()), f
    delta, dwant = diag.delta_per_stage.numpy(), np.asarray(
        dj.delta_per_stage)
    assert np.array_equal(np.isinf(delta), np.isinf(dwant))
    fin = np.isfinite(dwant)
    assert np.abs(delta[fin] - dwant[fin]).max() < TOY_TOL


def test_toy_objective_runs_rejections():
    """The toy objective exercises the halving: some steps of the fit are
    rejected (the step size falls below its start)."""
    a, c, w0 = _toy_parts(np.random.RandomState(5), ())
    obj = _toy_torch(a, c)
    cfg = CorexConfig(n_hidden=M_, dtype="float64", optimizer="gd",
                      max_iter=150, tol=1e-6, anneal=False)
    seen = []

    def watched(ws, eps):
        out = obj(ws, eps)
        seen.append(float(out[0]))
        return out
    S.fit_core(watched, torch.as_tensor(w0), cfg)
    assert any(b > a for a, b in zip(seen, seen[1:]))


# --- no host copy or device read inside an evaluation ---------------------

HOST_OPS = {"_local_scalar_dense", "lift_fresh", "lift_fresh_copy", "item"}


class _Watch(TorchDispatchMode):
    """Records the aten ops of the scope that copy a Python value into a
    tensor (`torch.tensor`) or read one out (`.item()`, `float()`,
    `bool()`, `.tolist()`)."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in HOST_OPS:
            self.seen.append(name)
        return func(*args, **(kwargs or {}))


def _watched(obj_grad, log):
    def wrapped(ws, eps):
        with _Watch() as w:
            out = obj_grad(ws, eps)
        log.append(w.seen)
        return out
    return wrapped


def test_the_watch_sees_host_copies_and_reads():
    with _Watch() as w:
        t = torch.tensor(2.0)
        float(t * 3)
    assert "lift_fresh" in w.seen and "_local_scalar_dense" in w.seen


EVAL_PATHS = [
    dict(),
    dict(optimizer="momentum"),
    dict(optimizer="momentum", moment_strategy="samples"),
    dict(moment_strategy="samples"),
    dict(matmul_dtype="int8"),
    dict(matmul_dtype="int8", moment_strategy="samples",
         optimizer="momentum"),
    dict(matmul_dtype="bfloat16", use_pallas="always"),
    dict(use_pallas="always", optimizer="momentum"),
    dict(discourage_overlap=False, optimizer="momentum"),
    dict(discourage_overlap=False, optimizer="gd",
         moment_strategy="samples"),
    dict(dtype="bfloat16", optimizer="momentum", moment_strategy="samples"),
    dict(dtype="float16", optimizer="momentum", moment_strategy="samples"),
    dict(dtype="bfloat16", optimizer="momentum"),
    dict(dtype="float64", optimizer="gd", y_scale=0.7),
]


@pytest.mark.parametrize("lanes", [1, 3])
@pytest.mark.parametrize("chunk", [1, 8])
@pytest.mark.parametrize("kw", EVAL_PATHS, ids=lambda kw: "-".join(
    f"{k}={v}" for k, v in kw.items()) or "fixed_point")
def test_no_host_copy_or_read_inside_an_evaluation(x, kw, chunk, lanes):
    kw = dict(dict(optimizer="fixed_point", max_iter=30), **kw)
    model = lct.Corex(n_hidden=M_, seed=0, device="cpu", **kw)
    data, cfg, strategy = model._prepare_fit(x)
    w0 = model._resolve_w0(None) if lanes == 1 else init_restarts(
        lanes, M_, P_, 0, TC.torch_dtype(cfg.dtype), "cpu")
    evals = []
    obj_grad = _watched(TC._make_obj_grad(data, cfg, strategy), evals)
    S.counts.reset()
    with _Watch() as whole:
        _, diag = S.fit_core(obj_grad, w0, cfg, _chunk=chunk)
    assert evals and all(seen == [] for seen in evals), \
        sorted({op for seen in evals for op in seen})
    stages = diag.iters_per_stage.shape[-1]
    iters = int(diag.iters_per_stage.reshape(-1, stages).amax(0).sum())
    c = S.counts.as_dict()
    assert c["host_reads"] <= math.ceil(iters / chunk) + stages + 1
    # every read of the fit is one of the solver's flag reads (the
    # diagnostics' read is a copy, which on the CPU reads nothing)
    assert whole.seen.count("_local_scalar_dense") == c["host_reads"] - 1
    assert len(evals) == c["first_evaluations"] + c["bodies"]
    assert c["iterations"] == iters
    assert c["masked"] == c["bodies"] - iters
    assert c["masked_launches"] == 0      # no graph, no tally


def test_loop_counts_of_a_fit(x):
    S.counts.reset()
    _, diag = _fit(x, 8, max_iter=30)
    c = S.counts.as_dict()
    stages = len(diag.iters_per_stage)
    chunks = sum(math.ceil(int(i) / 8) for i in diag.iters_per_stage)
    assert c["fits"] == 1 and c["captured_fits"] == 0
    assert c["stages"] == c["first_evaluations"] == stages
    assert c["host_reads"] == chunks + 1
    assert c["bodies"] == 8 * chunks
    assert c["iterations"] == int(diag.iters_per_stage.sum())
    S.counts.reset()
    assert S.counts.as_dict()["host_reads"] == 0


def test_iteration_rate_counts_iterations_not_evaluations(x):
    model = lct.Corex(n_hidden=M_, seed=0, device="cpu", max_iter=20,
                      tol=0.0, anneal=False)
    data, cfg, strategy = model._prepare_fit(x)
    w0 = model._resolve_w0(None)
    obj_grad = TC._make_obj_grad(data, cfg, strategy)
    rate, total, seconds = TP.iteration_rate(
        lambda: S.fit_core(obj_grad, w0, cfg, _chunk=8), reps=1)
    assert total == 20 and rate == pytest.approx(20 / seconds)
    _, diag = S.fit_core(obj_grad, w0, cfg, _chunk=8)
    assert "total iterations: 20" in TP.fit_report(diag)


# --- which fits a card captures, and how their launches count ------------

def test_the_cpu_loop_is_never_captured(x):
    S.counts.reset()
    _fit(x, None, max_iter=10)
    assert S.counts.captured_fits == 0
    model = lct.Corex(n_hidden=M_, seed=0, device="cpu", max_iter=10)
    data, cfg, strategy = model._prepare_fit(x)
    with pytest.raises(ValueError, match="needs a CUDA device"):
        S.fit_core(TC._make_obj_grad(data, cfg, strategy),
                   model._resolve_w0(None), cfg, _capture=True)


@pytest.mark.parametrize("lanes,m,kw,magma_free", [
    ((), 512, dict(optimizer="fixed_point"), True),
    ((), 512, dict(discourage_overlap=False), True),
    ((4,), 512, dict(optimizer="momentum"), True),
    ((4,), 512, dict(optimizer="fixed_point"), False),
    ((32,), 8, dict(optimizer="fixed_point"), True),
    ((40,), 16, dict(optimizer="fixed_point"), True),
    ((40,), 17, dict(optimizer="fixed_point"), False),
    ((16,), 128, dict(optimizer="fixed_point"), True),
    ((17,), 32, dict(optimizer="fixed_point"), False),
    ((4,), 129, dict(optimizer="fixed_point"), False),
    ((3,), 8, dict(discourage_overlap=False), False),
])
def test_fits_whose_factorizations_reach_magma_run_uncaptured(lanes, m, kw,
                                                              magma_free):
    """The rule against torch's default routing, as measured on the card:
    a batched LU or Cholesky solve that MAGMA runs cannot be captured."""
    cfg = CorexConfig(n_hidden=m, **kw)
    w0 = torch.empty(lanes + (m, 64), device="meta")
    assert S._without_magma(cfg, w0) is magma_free


def test_a_cpu_fit_reads_once_an_iteration(x):
    """K = 1 off the card: the evaluations of the loop before the device
    carry, one read an iteration; a card's chunk is the solver's
    constant."""
    S.counts.reset()
    _, diag = _fit(x, None, max_iter=30)
    c = S.counts.as_dict()
    assert c["bodies"] == c["iterations"] == int(diag.iters_per_stage.sum())
    assert c["host_reads"] == c["iterations"] + 1 and c["masked"] == 0
    assert isinstance(S.CHUNK, int) and S.CHUNK >= 1


def test_captured_launches_count_at_every_replay():
    before = (CM.ns_chain.launches, CM.ns_chain.lane_launches,
              CM.sigma_gemm.launches)
    with CM.counting_capture() as outer:
        with CM.counting_capture() as inner:
            inner["launches"] += 5
        outer["lane_launches"] += 2
        outer["sigma_gemm"] += 4
    assert (CM.ns_chain.launches, CM.ns_chain.lane_launches,
            CM.sigma_gemm.launches) == before
    for _ in range(3):
        CM.count_replay(inner)
        CM.count_replay(outer)
    assert CM.ns_chain.launches == before[0] + 15
    assert CM.ns_chain.lane_launches == before[1] + 6
    assert CM.sigma_gemm.launches == before[2] + 12
    CM.ns_chain.launches, CM.ns_chain.lane_launches, \
        CM.sigma_gemm.launches = before
