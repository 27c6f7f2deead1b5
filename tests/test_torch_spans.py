"""The fit's spans (`utils.profiling.span`), on the CPU.

Under `profiling.trace` a fit's phases appear in the written Chrome trace
as named ranges, nested as `utils/profiling.py` lists them; with no
profiler recording a fit opens no range and waits for no device; a
profiled fit gives the bits of an unprofiled one; and a fit that raises
inside a span leaves no range open. (The card's side, the ranges and the
kernels on one clock, is `tests/test_torch_cuda.py`'s.)
"""

import glob
import json

import numpy as np
import pytest
import torch

import linearcorex_tpu_torch as lct
from linearcorex_tpu_torch.models import corex as C
from linearcorex_tpu_torch.ops import moments as M
from linearcorex_tpu_torch.utils import profiling
from tests.conftest import block_data

torch.set_num_threads(1)

# each range and the range it lies in
PARENT = {
    "lcx.prepare": "lcx.fit",
    "lcx.prepare.standardize": "lcx.prepare",
    "lcx.prepare.operand": "lcx.prepare",
    "lcx.init": "lcx.fit",
    "lcx.init.draw": "lcx.init",
    "lcx.init.spectral": "lcx.init",
    "lcx.solve": "lcx.fit",
    "lcx.stage": "lcx.solve",
    "lcx.stage.first": "lcx.stage",
    "lcx.capture": "lcx.stage",
    "lcx.final": "lcx.fit",
}
# the spans that wait for the device before they close
SYNCED = {"lcx.prepare", "lcx.prepare.standardize", "lcx.prepare.operand",
          "lcx.init", "lcx.init.draw", "lcx.init.spectral", "lcx.final"}
PHASES = ("lcx.prepare", "lcx.init", "lcx.solve", "lcx.final")
# the Chrome trace's microseconds are rounded to the nanosecond
SLACK_US = 0.01
N, P, HIDDEN = 200, 32, 4

FITS = {
    "default": {},
    "throughput": {"preset": "throughput"},
    "restarts4": {"n_restarts": 4},
    "stage_subsample": {"stage_subsample": 0.5,
                        "moment_strategy": "samples"},
    "warmup": {},
}


@pytest.fixture(scope="module")
def x():
    return block_data(n=N, p=P, m=HIDDEN, seed=3).astype(np.float32)


def _run(case, x, **kw):
    model = lct.Corex(n_hidden=HIDDEN, seed=0, device="cpu", **FITS[case],
                      **kw)
    if case == "warmup":
        return model.warmup(*x.shape)
    return model.fit(x)


def _spans(logdir):
    """The fit's ranges in the Chrome trace under `logdir`: (name, start
    µs, end µs), in order of their start."""
    path, = glob.glob(f"{logdir}/*.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return sorted(((e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") == "user_annotation"
                   and e["name"].startswith("lcx.")), key=lambda s: s[1])


def _inside(child, parent):
    return parent[1] - SLACK_US <= child[1] and \
        child[2] <= parent[2] + SLACK_US


def _count_programs(monkeypatch):
    """Counts the `_fit_program` calls (one solve and one final each)."""
    calls = []
    orig = C._fit_program

    def counted(*args, **kwargs):
        calls.append(1)
        return orig(*args, **kwargs)

    monkeypatch.setattr(C, "_fit_program", counted)
    return calls


@pytest.mark.parametrize("case", sorted(FITS))
def test_spans_nest_as_listed(case, x, tmp_path, monkeypatch):
    """One lcx.fit; every range inside its parent; the phases in order,
    apart; one lcx.solve and one lcx.final per `_fit_program` call, one
    lcx.stage per anneal stage inside the solves, one lcx.stage.first in
    each stage."""
    programs = _count_programs(monkeypatch)
    with profiling.trace(str(tmp_path)):
        model = _run(case, x)
    spans = _spans(tmp_path)
    names = [s[0] for s in spans]
    assert names.count("lcx.fit") == 1
    for child in spans:
        if child[0] != "lcx.fit":
            assert any(p[0] == PARENT[child[0]] and _inside(child, p)
                       for p in spans), child
    want = {"lcx.fit", "lcx.prepare", "lcx.prepare.standardize",
            "lcx.prepare.operand", "lcx.init", "lcx.init.draw",
            "lcx.solve", "lcx.stage", "lcx.stage.first", "lcx.final"}
    if case == "throughput":
        want.add("lcx.init.spectral")
    # the CPU runs the loop uncaptured: no lcx.capture
    assert set(names) == want
    assert len(programs) == (2 if case == "stage_subsample" else 1)
    assert names.count("lcx.solve") == names.count("lcx.final") == \
        len(programs)
    assert names.count("lcx.init") == names.count("lcx.prepare") == 1
    phases = [s for s in spans if s[0] in PHASES]
    assert [s[0] for s in phases] == ["lcx.prepare", "lcx.init"] + [
        "lcx.solve", "lcx.final"] * len(programs)
    for a, b in zip(phases, phases[1:]):
        assert a[2] <= b[1] + SLACK_US, (a, b)
    stages = [s for s in spans if s[0] == "lcx.stage"]
    assert len(stages) == len(model.config.anneal_schedule())
    for st in stages:
        assert sum(s[0] == "lcx.stage.first" and _inside(s, st)
                   for s in spans) == 1


class _Counter:
    """Stands in for `torch.profiler.record_function`: counts the ranges
    opened and closed, and opens the real one."""

    def __init__(self, real):
        self.real, self.opened, self.closed = real, [], 0

    def __call__(self, name):
        counter = self

        class Range:
            def __enter__(self):
                counter.opened.append(name)
                self.inner = counter.real(name)
                return self.inner.__enter__()

            def __exit__(self, *exc):
                counter.closed += 1
                return self.inner.__exit__(*exc)

        return Range()


@pytest.fixture
def counted(monkeypatch):
    """`record_function` and `torch.cuda.synchronize` counted, with CUDA
    taken as in use, so that a span would wait if it were recorded."""
    rf = _Counter(torch.profiler.record_function)
    syncs = []
    monkeypatch.setattr(torch.profiler, "record_function", rf)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: syncs.append(a))
    return rf, syncs


@pytest.mark.parametrize("case", ["default", "throughput", "restarts4"])
def test_no_profiler_no_range_no_sync(case, x, counted, tmp_path):
    """With no profiler recording a fit opens no range and waits for no
    device; under the profiler every span opens one range and each sync
    span waits once, before it closes."""
    rf, syncs = counted
    _run(case, x)
    assert rf.opened == [] and syncs == []
    with profiling.trace(str(tmp_path)):
        _run(case, x)
    assert rf.opened and all(n.startswith("lcx.") for n in rf.opened)
    assert rf.closed == len(rf.opened)
    assert sorted(rf.opened) == sorted(s[0] for s in _spans(tmp_path))
    assert len(syncs) == sum(n in SYNCED for n in rf.opened)


def _state(model):
    return ([model.ws] + list(model.moments) + list(model.diagnostics))


@pytest.mark.parametrize("kw", [{}, {"matmul_dtype": "int8"},
                                {"n_restarts": 4}],
                         ids=["float32", "int8", "lanes4"])
def test_profiled_fit_is_bitwise_the_fit(kw, x, tmp_path):
    plain = lct.Corex(n_hidden=HIDDEN, seed=5, device="cpu", **kw).fit(x)
    with profiling.trace(str(tmp_path)):
        traced = lct.Corex(n_hidden=HIDDEN, seed=5, device="cpu",
                           **kw).fit(x)
    a, b = _state(plain), _state(traced)
    assert len(a) == len(b)
    for u, v in zip(a, b):
        assert type(u) is type(v)
        if isinstance(u, torch.Tensor):
            assert u.dtype == v.dtype and torch.equal(u, v)
        else:
            assert u == v
    assert plain.best_restart_ == traced.best_restart_


@pytest.mark.parametrize("where", ["standardize", "operand"])
def test_a_raise_inside_prepare_leaves_no_range_open(where, x, counted,
                                                     tmp_path, monkeypatch):
    """A fault inside lcx.prepare closes every range it was inside, waits
    for nothing, and the next fit's ranges stand alone."""
    rf, syncs = counted
    target = (C.P, "fit_preprocess") if where == "standardize" \
        else (M, "compute_gram")

    def fail(*args, **kwargs):
        raise RuntimeError("planted fault")

    monkeypatch.setattr(*target, fail)
    with profiling.trace(str(tmp_path / "a")):
        with pytest.raises(RuntimeError, match="planted fault"):
            lct.Corex(n_hidden=HIDDEN, seed=0, device="cpu",
                      moment_strategy="gram").fit(x)
        opened = list(rf.opened)
        assert rf.closed == len(opened)
        assert opened == ["lcx.fit", "lcx.prepare",
                          "lcx.prepare.standardize"] + (
            ["lcx.prepare.operand"] if where == "operand" else [])
        # only a span that closed normally waited: lcx.prepare.standardize
        # before the Gram's fault
        assert len(syncs) == (where == "operand")
        monkeypatch.undo()
        lct.Corex(n_hidden=HIDDEN, seed=0, device="cpu").fit(x)
    spans = _spans(tmp_path / "a")
    fits = [s for s in spans if s[0] == "lcx.fit"]
    assert len(fits) == 2 and fits[0][2] <= fits[1][1]
    assert [s[0] for s in spans if _inside(s, fits[0])] == opened
