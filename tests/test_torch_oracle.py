"""The port's float64 oracle (`linearcorex_tpu_torch.oracle`) against the
JAX package's (`linearcorex_tpu.oracle`), of which it is a copy.

The two are one specification: the same public names, the same code save
the module docstring, and every public output equal bit for bit
(`np.array_equal`) on the same NumPy inputs from a seed. The port's copy
imports NumPy and SciPy only, so a machine without JAX can hold a card to
it; `chip_smoke.py`'s phase `oracle_card` does so, and runs here on the CPU
at a tiny size.
"""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import linearcorex_tpu.oracle as JO
import linearcorex_tpu_torch.oracle as TO
from tests.conftest import block_data

# One intra-op thread: the suite runs its files in parallel worker
# processes, and an OpenMP pool per process on every core slows the
# small tensors here several times over.
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "linearcorex_tpu_torch" / "oracle" / "oracle.py"
JAX = ROOT / "linearcorex_tpu" / "oracle" / "oracle.py"
N, P, M = 300, 32, 4
MISSING = -999.0


def test_all_names_the_jax_oracles():
    assert TO.__all__ == JO.__all__
    for name in TO.__all__:
        assert getattr(TO, name) is not getattr(JO, name)


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0, "a relative import"
            roots.add(node.module.split(".")[0])
    return roots


def test_imports_only_numpy_and_scipy():
    assert _imported_roots(PORT) == {"__future__", "numpy", "scipy"}


def test_code_is_the_jax_oracles_save_the_docstring():
    """A change to either copy is made in both."""
    def body(path):
        tree = ast.parse(path.read_text())
        assert isinstance(tree.body[0].value, ast.Constant)
        return ast.dump(ast.Module(body=tree.body[1:], type_ignores=[]))
    assert body(PORT) == body(JAX)


def test_import_leaves_jax_and_the_jax_package_out():
    code = ("import sys, linearcorex_tpu_torch.oracle; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'linearcorex_tpu' or "
            "m.startswith('linearcorex_tpu.')]; "
            "assert not bad, bad; print('ok')")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=str(ROOT))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip() == "ok"


def _equal(a, b, what):
    if isinstance(a, dict):
        assert list(a) == list(b), what
        for k in a:
            _equal(a[k], b[k], f"{what}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{what}[{i}]")
    else:
        assert np.array_equal(np.asarray(a), np.asarray(b)), what


def _data(missing=False):
    x = block_data(n=N, p=P, m=M, seed=5)
    if missing:
        x[np.random.RandomState(6).random_sample(x.shape) < 0.01] = MISSING
    return x


@pytest.mark.parametrize("kw", [
    dict(optimizer="momentum"),
    dict(optimizer="gd"),
    dict(optimizer="fixed_point"),
    dict(optimizer="auto"),
    dict(discourage_overlap=False),
    dict(gaussianize="standard", optimizer="fixed_point"),
    dict(gaussianize="outliers"),
    dict(gaussianize="empirical"),
    dict(gaussianize="none"),
    dict(init="random", seed=3),
    dict(init="spectral", seed=3),
    dict(stage_subsample=1.0, optimizer="fixed_point"),
    dict(stage_subsample=0.5),
    dict(missing_values=MISSING),
    dict(anneal=False),
    dict(stage_tol_factor=2),
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_fit_and_serving_bitwise_the_jax_oracles(kw):
    """Every public output of a fit, transform(details=True), predict and
    get_covariance, from the same W0 (or the same seed where the init is
    drawn)."""
    x = _data(missing="missing_values" in kw)
    fit = {} if "seed" in kw else dict(
        init_ws=np.random.RandomState(4).normal(scale=1 / np.sqrt(P),
                                                size=(M, P)))
    fits = [o.OracleCorex(n_hidden=M, max_iter=200, **kw).fit(x, **fit)
            for o in (TO, JO)]
    t, j = fits
    _equal(t.history, j.history, "history")
    for name in ("ws", "tcs", "mis", "clusters", "tc",
                 "resolved_optimizer_"):
        _equal(getattr(t, name), getattr(j, name), name)
    x2 = block_data(n=120, p=P, m=M, seed=8)
    (yt, mt), (yj, mj) = (f.transform(x2, details=True) for f in fits)
    _equal(yt, yj, "transform")
    _equal(mt, mj, "details")
    _equal(t.predict(yt), j.predict(yj), "predict")
    _equal(t.get_covariance(), j.get_covariance(), "get_covariance")


@pytest.mark.parametrize("quick", [True, False])
@pytest.mark.parametrize("eps", [0.0, 0.36])
def test_calculate_moments_bitwise(quick, eps):
    x = _data()
    x = (x - x.mean(0)) / x.std(0)
    ws = np.random.RandomState(2).normal(size=(M, P)) / np.sqrt(P)
    _equal(TO.calculate_moments(x, ws, eps=eps, quick=quick),
           JO.calculate_moments(x, ws, eps=eps, quick=quick), "moments")


@pytest.mark.parametrize("anneal", [True, False])
@pytest.mark.parametrize("n_hidden", [1, 4])
@pytest.mark.parametrize("discourage_overlap", [True, False])
def test_anneal_schedule_equal(anneal, n_hidden, discourage_overlap):
    args = (anneal, n_hidden, discourage_overlap)
    assert TO.anneal_schedule(*args) == JO.anneal_schedule(*args)


def test_pick_n_hidden_oracle_bitwise():
    x = block_data(n=200, p=16, m=2, seed=1)
    kw = dict(repeat=2, max_n_hidden=4, max_iter=100)
    _equal(TO.pick_n_hidden_oracle(x, **kw),
           JO.pick_n_hidden_oracle(x, **kw), "pick_n_hidden_oracle")


def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


def test_oracle_card_phase_on_the_cpu(capsys):
    """chip_smoke.py's phase oracle_card with device="cpu" at a tiny size:
    every gate runs (the port's float64 CPU fits against the port's
    oracle), and every row reports."""
    C = _chip_smoke()
    out = C.oracle_card_phase("cpu", device="cpu", full=(200, 40, 8, 4),
                              small=(300, 32, 4, 4, 8), full_max_iter=8,
                              small_max_iter=100)
    assert out == {"oracle_card_f32": 0}    # the CPU runs the chain's twin
    rows = [ln for ln in capsys.readouterr().out.splitlines()
            if '"phase": "oracle_card"' in ln]
    names = [C.json.loads(ln)["row"] for ln in rows]
    assert names[:3] == ["momentum_gram", "momentum_samples",
                         "fixed_point_gram"]
    assert names[3:3 + len(C.ORACLE_ROWS)] == [r for r, _ in C.ORACLE_ROWS]
    assert names[3 + len(C.ORACLE_ROWS):] == (
        ["fixed_point_gram_m8", "kernel_f32"] + ["lanes_fixed_point"] * 3
        + ["lanes_momentum"] * 3)


def test_oracle_card_phase_fails_past_its_host_budget(monkeypatch, capsys):
    """The oracle child projects its full-width fits from one timed
    evaluation, and the phase fails, naming the child's threads, before
    any fit when they would pass the time left before the child's
    deadline (here none: AFTER_JOIN_SECONDS takes all of SCRIPT_SECONDS)."""
    C = _chip_smoke()
    monkeypatch.setattr(C, "AFTER_JOIN_SECONDS", C.SCRIPT_SECONDS)
    with pytest.raises(RuntimeError, match="threads"):
        C.oracle_card_phase("cpu", device="cpu", full=(200, 40, 8, 4))
    phases = [C.json.loads(ln)["phase"]
              for ln in capsys.readouterr().out.splitlines()]
    assert phases == ["oracle_card_host", "oracle_card_projection"]


def _history(tcs_by_stage):
    return dict(iters_per_stage=[len(t) for t in tcs_by_stage],
                TC=[v for t in tcs_by_stage for v in t])


@pytest.mark.parametrize("other, parting", [
    ([[1.0, 2.0], [3.0, 4.0, 5.0]], None),
    ([[1.0, 2.0], [3.0, 4.5, 5.0]], dict(stage=1, iteration=1)),
    ([[1.0, 2.0], [3.0, 4.0]], dict(stage=1, iteration=2)),
])
def test_first_parting(other, parting):
    """chip_smoke.py's _first_parting: where two TC histories part (a
    difference past the bound, or a stage that ends earlier), and the
    largest absolute and relative differences over the shared
    iterations."""
    C = _chip_smoke()
    a, b = _history(other), _history([[1.0, 2.0], [3.0, 4.0, 5.0]])
    got, most_abs, most_rel = C._first_parting(a, b)
    if parting is None:
        assert got is None
    else:
        assert {k: got[k] for k in parting} == parting
        assert got["max_diff_before"] == 0.0
    want = 0.5 if parting and parting["iteration"] == 1 else 0.0
    assert most_abs == want and most_rel == want / 4.0
    assert C._first_parting(a, b, tol=0.1, relative=True)[0] == got


@pytest.mark.parametrize("change, held", [
    ({}, True),
    ({"iters_per_stage_card": [300, 299]}, False),
    ({"clusters_equal": False}, False),
    ({"tc_abs_diff": 2e-6}, False),
    ({"w_max_abs_diff": 2e-6}, False),
])
def test_fixed_point_held(change, held):
    """The gate of the fixed point's small rows and lanes: the same
    iterations per stage and clusters, final TC and W within
    ORACLE_FP_TOL."""
    C = _chip_smoke()
    fields = dict(iters_per_stage_card=[300, 300],
                  iters_per_stage_oracle=[300, 300], clusters_equal=True,
                  tc_abs_diff=2.5e-9, w_max_abs_diff=1.03e-8)
    assert C._fixed_point_held({**fields, **change}) is held
