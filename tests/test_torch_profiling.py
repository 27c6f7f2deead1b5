"""The port's profiling helpers: `fit_report` string for string against
the JAX package's on a diagnostics carried across, `iteration_rate`'s
return triple, and `trace` writing a Chrome trace. On the CPU.
"""

import json
import os

import numpy as np
import pytest
import torch

import linearcorex_tpu as lc
import linearcorex_tpu_torch as lct
from linearcorex_tpu.utils import profiling as JP
from linearcorex_tpu_torch.core.solver import FitDiagnostics, fit_core
from linearcorex_tpu_torch.models.corex import (_make_obj_grad,
                                                resolve_config)
from linearcorex_tpu_torch.ops import moments as M
from linearcorex_tpu_torch.utils import profiling as TP
from tests.conftest import block_data

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def x():
    return block_data(n=400, p=32, m=4, seed=2)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_fit_report_equals_jax_on_a_carried_diagnostics(dtype, x):
    j = lc.Corex(n_hidden=4, seed=0, dtype=dtype).fit(x)
    carried = FitDiagnostics(*[torch.as_tensor(np.array(a))
                               for a in j.diagnostics])
    assert TP.fit_report(carried) == JP.fit_report(j.diagnostics)
    labels = list(range(len(carried.iters_per_stage)))
    assert TP.fit_report(carried, schedule=labels) == \
        JP.fit_report(j.diagnostics, schedule=labels)


def test_fit_report_of_a_port_fit(x):
    c = lct.Corex(n_hidden=4, seed=0, dtype="float64", device="cpu").fit(x)
    j = lc.Corex(n_hidden=4, seed=0, dtype="float64").fit(x)
    report = TP.fit_report(c.diagnostics)
    assert report.splitlines()[0].startswith("stage  eps")
    assert report.splitlines()[-1] == f"total iterations: {c.n_iter_}"
    # step-matched fits print the same table up to the last digits
    assert [ln.split()[:3] for ln in report.splitlines()[1:-1]] == \
        [ln.split()[:3]
         for ln in JP.fit_report(j.diagnostics).splitlines()[1:-1]]


def _runner(x, iters):
    model = lct.Corex(n_hidden=4, seed=0, device="cpu", max_iter=iters,
                      tol=0.0, anneal=False, record_history=False)
    data, cfg, strategy = model._prepare_fit(x)
    w0 = model._resolve_w0(None)
    obj_grad = _make_obj_grad(data, cfg, strategy)
    calls = []

    def run(w):
        calls.append(1)
        with M.full_f32_matmul():
            return fit_core(obj_grad, w, cfg)
    return run, w0, calls


@pytest.mark.parametrize("warmup,reps,n_calls", [(True, 3, 4), (False, 2, 2),
                                                 (True, 0, 2)])
def test_iteration_rate_triple(warmup, reps, n_calls, x):
    run, w0, calls = _runner(x, 25)
    rate, total, seconds = TP.iteration_rate(run, w0, warmup=warmup,
                                             reps=reps)
    assert len(calls) == n_calls          # the warm-up, then the timed runs
    assert total == 25 and seconds > 0
    assert rate == pytest.approx(total / seconds)


def test_iteration_rate_n_timed(x):
    run, w0, _ = _runner(x, 10)
    rate, total, seconds = TP.iteration_rate(run, w0, n_timed=7, reps=1)
    assert total == 7 and rate == pytest.approx(7 / seconds)


def test_trace_writes_a_chrome_trace(tmp_path, x):
    logdir = str(tmp_path / "traces")
    with TP.trace(logdir) as prof:
        lct.Corex(n_hidden=4, seed=0, device="cpu", max_iter=3).fit(x)
    files = os.listdir(logdir)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(os.path.join(logdir, files[0])) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
    assert any("mm" in e.key for e in prof.key_averages())


def test_trace_writes_when_the_block_raises(tmp_path):
    logdir = str(tmp_path / "t")
    with pytest.raises(KeyError):
        with TP.trace(logdir):
            torch.ones(3).sum()
            raise KeyError("boom")
    assert len(os.listdir(logdir)) == 1
