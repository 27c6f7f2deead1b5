"""chip_smoke.py's orchestration, on the CPU at a tiny size.

Phase oracle_card runs the oracle's fits in a child process on the host
(`chip_smoke.OracleChild`, `chip_smoke.oracle_child`) while the card's
phases go on. The child's fits must be the same bits as the same fits in
this process at the same thread count, and a child that fails, is
stopped, or outlives its deadline must fail the phase by name. Phase
card_tests gates on pytest's JUnit file: a skipped, failed or erroring
case fails it.
"""

import os
import pathlib
import sys
import time

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from linearcorex_tpu_torch.oracle import OracleCorex
from linearcorex_tpu_torch.parallel.restarts import init_restarts

# One intra-op thread: the suite runs its files in parallel worker
# processes, and an OpenMP pool per process on every core slows the
# small tensors here several times over.
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
FULL, SMALL = (200, 40, 8, 4), (300, 32, 4, 4, 8)
FULL_MAX_ITER, SMALL_MAX_ITER = 8, 100


def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


def _child(C, **kw):
    return C.OracleChild("cpu", device="cpu", full=FULL, small=SMALL,
                         full_max_iter=FULL_MAX_ITER,
                         small_max_iter=SMALL_MAX_ITER, **kw)


def _in_process(C):
    """The child's fits, made here from the same seeds: {record name:
    (OracleCorex, {extra output: array})}."""
    n, p, m, blocks = FULL
    x = C.block_data(n, p, blocks, seed=C.DATA_SEED,
                     dev=torch.device("cpu")).to(torch.float64).numpy()
    w0 = np.random.RandomState(0).normal(scale=1 / np.sqrt(p), size=(m, p))
    fits = {}
    for opt in ("momentum", "fixed_point"):
        fit = OracleCorex(n_hidden=m, max_iter=FULL_MAX_ITER,
                          optimizer=opt).fit(x, init_ws=w0)
        fits[f"full_{opt}"] = (fit, dict(y=fit.transform(x)))
    xs, x_miss, ws_wide = C._oracle_small_data(SMALL)
    m, wide_m = SMALL[2], SMALL[4]
    base = dict(n_hidden=m, max_iter=SMALL_MAX_ITER)
    for name, kw in C.ORACLE_ROWS:
        data = x_miss if "missing_values" in kw else xs
        init = {} if kw.get("init") == "spectral" else dict(
            init_ws=ws_wide[:m])
        fit = OracleCorex(**base, **C._oracle_kw(kw)).fit(data, **init)
        y, mom = fit.transform(data, details=True)
        fits[f"small_{name}"] = (fit, dict(
            y=y, predict=fit.predict(y), covariance=fit.get_covariance(),
            tcs=fit.tcs, mis=fit.mis, details=mom))
    fits[f"small_fixed_point_gram_m{wide_m}"] = (OracleCorex(
        n_hidden=wide_m, max_iter=SMALL_MAX_ITER,
        optimizer="fixed_point").fit(xs, init_ws=ws_wide), {})
    w0s = init_restarts(C.ORACLE_LANES, m, SMALL[1], 17, torch.float64,
                        "cpu").numpy()
    for opt in ("fixed_point", "momentum"):
        for r in range(C.ORACLE_LANES):
            fits[f"lanes_{opt}_{r}"] = (OracleCorex(
                n_hidden=m, max_iter=SMALL_MAX_ITER, optimizer=opt).fit(
                xs, init_ws=w0s[r]), {})
    return fits


def test_oracle_child_bitwise_in_process():
    """Every fit of the oracle child, on one core with one BLAS thread,
    is the same fit in this process under one BLAS thread bit for bit:
    TC history, iterations per stage, W, clusters, TC and the outputs the
    phase compares. The child hands this process its cores and torch
    threads back at the join."""
    C = _chip_smoke()
    cores, threads = os.sched_getaffinity(0), torch.get_num_threads()
    child = _child(C, cores=sorted(cores)[-1:])
    try:
        child.projection()
        got = child.join()
    finally:
        child.close()
    assert os.sched_getaffinity(0) == cores
    assert torch.get_num_threads() == threads
    assert child.done["threads"] == 1 and not os.path.exists(child.dir)
    with threadpool_limits(1):
        want = _in_process(C)
    assert sorted(got) == sorted(want)
    for name, (fit, extra) in want.items():
        rec = got[name]
        assert rec.history["iters_per_stage"] == [
            int(k) for k in fit.history["iters_per_stage"]], name
        assert np.array_equal(rec.history["TC"], fit.history["TC"]), name
        assert np.array_equal(rec.ws, fit.ws), name
        assert np.array_equal(rec.clusters, fit.clusters), name
        assert rec.tc == fit.tc, name
        details = extra.pop("details", {})
        assert sorted(rec.details) == sorted(details), name
        for k, v in details.items():
            assert np.array_equal(rec.details[k], v), (name, k)
        for k, v in extra.items():
            assert np.array_equal(getattr(rec, k), v), (name, k)


@pytest.mark.parametrize("fault, says", [
    ("killed", "exited with -9"),
    ("broken", "exited with 1"),
    ("deadline", "still running at its deadline"),
])
def test_oracle_child_fault_fails_the_join(fault, says):
    """A child that is killed, that raises, or that still runs at its
    deadline (it is then stopped) fails the join by name, and leaves no
    process behind."""
    C = _chip_smoke()
    kw = dict(full_max_iter=FULL_MAX_ITER, small_max_iter=SMALL_MAX_ITER)
    if fault == "broken":
        kw["full_max_iter"] = "eight"
    elif fault == "deadline":
        kw["deadline"] = time.perf_counter()
    child = C.OracleChild("cpu", device="cpu", full=FULL, small=SMALL, **kw)
    try:
        if fault == "killed":
            child.proc.kill()
        with pytest.raises(RuntimeError, match=says) as raised:
            child.join()
    finally:
        child.close()
    assert child.proc.poll() is not None
    if fault == "broken":       # the message carries the child's log
        assert "TypeError" in str(raised.value)


def test_oracle_card_phase_fails_on_a_killed_child(capsys):
    """The phase runs the card's fits, then fails at the join when the
    child it was handed has died, before any comparison."""
    C = _chip_smoke()
    child = _child(C)
    child.proc.kill()
    with pytest.raises(RuntimeError, match="oracle child exited"):
        C.oracle_card_phase("cpu", child=child)
    phases = [C.json.loads(ln)["phase"]
              for ln in capsys.readouterr().out.splitlines()]
    assert phases == ["oracle_card_host"]
    assert not os.path.exists(child.dir)


def _junit(tmp_path, cases):
    body = "".join(f'<testcase classname="tests.test_torch_cuda" '
                   f'name="t{i}" time="0.1">{inner}</testcase>'
                   for i, inner in enumerate(cases))
    path = tmp_path / "card_tests.xml"
    path.write_text(f'<?xml version="1.0" encoding="utf-8"?><testsuites>'
                    f'<testsuite name="pytest" errors="0" failures="0" '
                    f'skipped="0" tests="{len(cases)}">{body}</testsuite>'
                    f'</testsuites>')
    return str(path)


SKIP = '<skipped type="pytest.skip" message="needs a CUDA card">skip</skipped>'


@pytest.mark.parametrize("cases, code, passes", [
    (["", ""], 0, True),
    (["", SKIP], 0, False),
    (["", '<failure message="assert 1 == 2">trace</failure>'], 1, False),
    (['<error message="fixture failed">trace</error>'], 1, False),
    (["", ""], 1, False),
    ([], 5, False),
])
def test_card_tests_gate(tmp_path, cases, code, passes):
    """Phase card_tests passes a clean JUnit file with exit code 0 only:
    a skipped (no card found), failed or erroring case, a non-zero exit
    or no case at all fails it."""
    C = _chip_smoke()
    path = _junit(tmp_path, cases)
    if passes:
        assert C.card_tests_counts(path, code) == dict(
            tests=2, passed=2, skipped=0, failed=0, errors=0)
    else:
        with pytest.raises(RuntimeError, match="card_tests"):
            C.card_tests_counts(path, code)


def test_card_tests_phase_on_the_cpu(tmp_path):
    """The phase's own pytest run of tests/test_torch_cuda.py: without a
    card its card cases skip, so the phase fails, naming the skips."""
    C = _chip_smoke()
    with pytest.raises(RuntimeError, match=r"'skipped': [1-9]"):
        C.card_tests_phase("cpu", str(tmp_path))
