"""Dry runs of the harness on the CPU at a tiny size: the last line's
form, `correct` false under each fault the cells can have and under the
lower-precision control put in the program's place, and the import
rules."""

import json
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch

from conftest import ROOT, TINY_CELLS

KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


@pytest.mark.parametrize("cell", sorted(TINY_CELLS))
@pytest.mark.parametrize("trace", [0, 1])
def test_last_line(tiny_root, dry_run, cell, trace):
    rc, res, err = dry_run(tiny_root, cell, trace=trace)
    assert rc == 0, err
    assert set(res) >= KEYS and list(res)[-1] == "checks"
    assert res["correct"] is True, err
    assert res["attempted"] >= 1 and res["failed"] == 0
    names = set(res["metrics"])
    if trace:
        assert {"prep_ms", "loop_ms_per_it", "masked_share",
                "fit_mfu"} <= names
    else:
        assert names == {"fit_it_per_s", "setup_s"}
    for c in res["checks"].values():
        assert c["value"] <= c["limit"]
    names = list(res["checks"])
    lines = err.strip().splitlines()[-len(names):]
    assert [ln.split()[1] for ln in lines] == names
    assert names[:3] == ["cxy_gap", "tc_gap", "first_step_gap"]
    assert names[3:] == (["stall_gap"] if "throughput" in cell
                         else ["residual_gap"])


def _state_unchanged(monkeypatch):
    """Each step returns W and what follows from it unchanged, and the
    stage ends (a body that returned the whole carry unchanged, its
    count and run flag too, would never end the loop)."""
    from linearcorex_tpu_torch.core import solver
    orig = solver._body

    def stuck(obj_grad, r, c, *args):
        out = orig(obj_grad, r, c, *args)
        return out._replace(ws=c.ws, f=c.f, g=c.g, v=c.v, tc=c.tc,
                            hist=c.hist, run=c.run & False)

    monkeypatch.setattr(solver, "_body", stuck)


def _frozen_after_first_body(monkeypatch):
    """The loop's state stops changing after the first body of a fit:
    the first step and its TC-history entry are right, every later body
    returns W and what follows from it unchanged and ends its stage, and
    the final moments agree with the W returned (a replay whose results
    never reach the carry, with the loop still ending)."""
    from linearcorex_tpu_torch.core import solver
    from linearcorex_tpu_torch.models import corex
    orig_body, orig_fit = solver._body, corex.fit_core
    done = []

    def fit_core(*args, **kwargs):
        done.clear()
        return orig_fit(*args, **kwargs)

    def frozen(obj_grad, r, c, *args):
        if not done:
            done.append(True)
            return orig_body(obj_grad, r, c, *args)
        out = orig_body(obj_grad, r, c, *args)
        return out._replace(ws=c.ws, f=c.f, g=c.g, v=c.v, tc=c.tc,
                            hist=c.hist, it=c.it, run=c.run & False)

    monkeypatch.setattr(corex, "fit_core", fit_core)
    monkeypatch.setattr(solver, "_body", frozen)


def _half_batch(monkeypatch):
    """The operand built from the first half of the samples: Σ (or X on
    the samples path) and every mean over the rest."""
    from linearcorex_tpu_torch.models import corex
    orig = corex.prepare_operand
    monkeypatch.setattr(corex, "prepare_operand",
                        lambda xp, *a, **k: orig(xp[: xp.shape[0] // 2],
                                                 *a, **k))


def _answer_altered(monkeypatch):
    from linearcorex_tpu_torch.models import corex
    orig = corex.final_moments

    def altered(*args, **kwargs):
        ws, mom = orig(*args, **kwargs)
        ws = ws.clone()
        ws[..., 0, :] *= 1.01
        return ws, mom

    monkeypatch.setattr(corex, "final_moments", altered)


@pytest.mark.parametrize("fault", [_state_unchanged,
                                   _frozen_after_first_body, _half_batch,
                                   _answer_altered])
@pytest.mark.parametrize("cell", sorted(TINY_CELLS))
def test_faults_make_correct_false(tiny_root, dry_run, monkeypatch, fault,
                                   cell):
    """A step that returns its state unchanged, from the first body or
    from the second on; half of the samples left out of Σ, the mean over
    the rest; the fitted W altered where it is produced. (The cells run
    on one card: no exchange between chips.)"""
    fault(monkeypatch)
    rc, res, err = dry_run(tiny_root, cell, seconds=0.2)
    assert rc == 0, err
    assert res["correct"] is False


def _control(kind):
    """fitloop.fit_once replaced by the reference fit at the precision
    below the cell's (`sweep.reference_control`)."""
    from portbench import compare, sweep

    def fit_once(lct, x, kwargs, seed, device):
        st = compare.settings(kwargs, *x.shape)
        cfg = {"n_hidden": kwargs["n_hidden"]}
        ws, cxy, tc, first, lane = sweep.reference_control(
            x, cfg, st, seed, kind, torch)
        hist = torch.full((1, 1), first, dtype=torch.float64)
        return SimpleNamespace(
            ws=ws, best_restart_=lane,
            moments=SimpleNamespace(c_xy=cxy, tc=torch.tensor(tc)),
            diagnostics=SimpleNamespace(tc_history=hist))

    return fit_once


@pytest.mark.parametrize("cell,kind", [("tiny-default", "reference-tf32"),
                                       ("tiny-restarts8", "reference-tf32"),
                                       ("tiny-wide-default", "reference-tf32"),
                                       ("tiny-throughput", "reference-int4")])
def test_control_is_not_correct(tiny_root, dry_run, monkeypatch, cell,
                                kind):
    from portbench.generators import fitloop
    monkeypatch.setattr(fitloop, "fit_once", _control(kind))
    rc, res, err = dry_run(tiny_root, cell, seconds=0.2)
    assert rc == 0, err
    assert res["correct"] is False


def _loaded_modules(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("trace", [0, 1])
def test_a_run_loads_no_jax(tiny_root, trace):
    """Everything a run loads, the readers of a traced run and the
    comparison included."""
    code = (
        "import io, json, sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from pathlib import Path\n"
        "from portbench import harness\n"
        "rc = harness.run(['--workload', 'tiny-default', '--seed', '5',\n"
        f"    '--seconds', '0.2', '--trace', '{trace}'],\n"
        f"    root=Path({str(tiny_root)!r}), require_card=False,\n"
        "    device='cpu', out=io.StringIO(), err=io.StringIO())\n"
        "assert rc == 0\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    tops = _loaded_modules(code)
    assert "linearcorex_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "linearcorex_tpu"}


def test_reference_imports_nothing_of_the_program():
    code = (
        "import json, sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from portbench import compare, reference, yardstick\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    tops = _loaded_modules(code)
    assert not tops & {"jax", "jaxlib", "flax", "linearcorex_tpu",
                       "linearcorex_tpu_torch"}


def test_a_late_jax_import_prints_no_result(tiny_root, dry_run,
                                            monkeypatch):
    """A module that the comparison loads after the window, with a
    forbidden top-level name: the run exits non-zero with no result."""
    from portbench import compare
    orig = compare.check

    def check(*args, **kwargs):
        sys.modules["jaxlib"] = SimpleNamespace()
        return orig(*args, **kwargs)

    monkeypatch.setattr(compare, "check", check)
    monkeypatch.delitem(sys.modules, "jaxlib", raising=False)
    rc, res, err = dry_run(tiny_root, "tiny-default", seconds=0.2, trace=1)
    assert rc != 0 and res is None
    assert "jaxlib" in err


def test_forbidden_names_compare_whole():
    from portbench import harness
    sys.modules.setdefault("linearcorex_tpu_torch_x", SimpleNamespace())
    try:
        assert "linearcorex_tpu" not in harness.forbidden_modules()
    finally:
        sys.modules.pop("linearcorex_tpu_torch_x", None)


def test_no_card_no_result(tmp_path):
    """Without a card the command exits non-zero and prints no result;
    so it does in a directory that holds only BENCHMARK.json and the
    benchmark's files."""
    from conftest import copy_bench
    root = copy_bench(tmp_path, code=True)
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "ns-default-f32",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=root,
        capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.cuda
def test_one_cell_on_the_card():
    """A short run of the first cell on a card (skips without one)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "ns-default-f32",
         "--seed", "2147483999", "--seconds", "2", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"


def test_profiler_stops_once(monkeypatch):
    """Fits longer than `PROFILED_SECONDS`: the profiler starts before the
    first fit and stops once, after it; only that fit is marked."""
    import linearcorex_tpu_torch as lct
    from portbench import datagen
    from portbench.generators import fitloop
    monkeypatch.setattr(fitloop, "PROFILED_SECONDS", 0.0)

    class Recorder:
        def __init__(self):
            self.calls = []

        def start(self):
            self.calls.append("start")

        def stop(self):
            self.calls.append("stop")

        def trace(self):
            return None

    rec = Recorder()
    x = datagen.block_data(64, 32, 4, 0.9, 0.436, 1, "cpu")
    kw = {"n_hidden": 4}
    w = fitloop.run(lct, x, kw, datagen.fit_seeds(1), 1.5, "cpu", torch,
                    sample_seed=1, profile=rec, n_samples=2)
    assert rec.calls == ["start", "stop"]
    assert len(w.fits) >= 2
    assert [f.profiled for f in w.fits] == [True] + [False] * (
        len(w.fits) - 1)
