"""The PyTorch port's examples run on the CPU (`--device cpu`; their
default is a CUDA card), each as its own process, and print what their JAX
counterparts print: `examples/torch_basic_usage.py`,
`torch_sklearn_pipeline.py` (the Pipeline round trip with
`np.linalg.norm(recon - x)`, the pandas output, `cross_val_score` and
`GridSearchCV`) and `torch_covariance_quality.py`. The deploy example,
`torch_deploy_warmup.py`, is run by `tests/test_torch_compile_cache.py`.
"""

import os
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _run(name, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
               LINEARCOREX_TPU_CACHE_DIR=str(tmp_path / "cache"))
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples" / name), "--device", "cpu"],
        capture_output=True, text=True, timeout=600, cwd=str(tmp_path),
        env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout


def test_basic_usage_example(tmp_path):
    out = _run("torch_basic_usage.py", tmp_path)
    for line in ("total correlation explained", "variable clusters",
                 "reconstruction rel. error", "covariance estimate shape:"
                 "   (64, 64)", "pick_n_hidden chose:         8",
                 "checkpoint round-trip:       ok"):
        assert line in out, line


def test_sklearn_pipeline_example(tmp_path):
    pytest.importorskip("sklearn")
    pytest.importorskip("pandas")
    out = _run("torch_sklearn_pipeline.py", tmp_path)
    rel = float(re.search(r"reconstruction rel-err ([0-9.]+)", out)[1])
    assert "pipeline factors (400, 3)" in out and rel < 0.5
    assert "pandas factors: DataFrame ['corex0', 'corex1', 'corex2']" in out
    assert "3-fold held-out log-likelihood" in out
    assert "grid search best n_hidden: 3" in out


def test_covariance_quality_example(tmp_path):
    out = _run("torch_covariance_quality.py", tmp_path)
    errs = dict(re.findall(r"^(sample|Ledoit|Linear)\S* .* ([0-9.]+)$", out,
                           re.M))
    # the factor model beats the sample covariance and shrinkage
    assert float(errs["Linear"]) < float(errs["Ledoit"]) \
        < float(errs["sample"])
    assert "clusters recovered: 16/16" in out
