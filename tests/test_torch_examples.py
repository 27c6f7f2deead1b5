"""The PyTorch port's examples run on the CPU (`--device cpu`; their
default is a CUDA card), each as its own process, and print what their JAX
counterparts print: `examples/torch_basic_usage.py`,
`torch_sklearn_pipeline.py` (the Pipeline round trip with
`np.linalg.norm(recon - x)`, the pandas output, `cross_val_score` and
`GridSearchCV`) and `torch_covariance_quality.py`. The deploy example,
`torch_deploy_warmup.py`, is run by `tests/test_torch_compile_cache.py`.

`torch_scaling.py` runs once, in a world of four gloo ranks
(`--device cpu --world 4`), and its printed numbers are held to those of
the JAX package's `examples/scaling.py`, run unchanged in a process of its
own on four CPU devices. This module imports no JAX.
"""

import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

# One intra-op thread: the suite runs its files in parallel worker
# processes, and an OpenMP pool per process on every core slows the
# small tensors here several times over.
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]


# The port's float32 fits against the JAX package's: TC within 1e-3
# relative (tests/test_parity.py's float32 bar, as in
# tests/test_torch_corex.py :: test_f32_matches_jax_f32). The int8 fit runs
# momentum, whose TC quantization noise scatters: within 1e-2 relative,
# tests/test_torch_operands.py's bar for momentum in the operand modes
# (the JAX package's own int8 fit of this example's data, W0 changed by
# 1e-7 relative, scatters over 192.37-193.42).
F32_REL = 1e-3
INT8_MOMENTUM_REL = 1e-2
# what the printed values were rounded to: 3 decimals, and 2 for lists
ROUND3, ROUND2 = 1e-3, 1e-2
EXPORT_TOL = 1e-5       # the blocked covariance export against the dense
# the preamble of tests/conftest.py (the CPU platform, float64 allowed)
# with four host devices, then the JAX example as it is
JAX_EXAMPLE = (
    "import os, runpy, sys\n"
    "os.environ.setdefault('JAX_ENABLE_X64', '1')\n"
    "import jax\n"
    "jax.config.update('jax_platforms', 'cpu')\n"
    "jax.config.update('jax_num_cpu_devices', 4)\n"
    "jax.config.update('jax_enable_x64', True)\n"
    "sys.argv = [{path!r}]\n"
    "runpy.run_path({path!r}, run_name='__main__')\n")


def _env(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
               LINEARCOREX_TPU_CACHE_DIR=str(tmp_path / "cache"))
    env.pop("LINEARCOREX_TPU_NO_COMPILE_CACHE", None)
    return env


def _run(name, tmp_path, *args):
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples" / name), "--device", "cpu",
         *args], capture_output=True, text=True, timeout=600,
        cwd=str(tmp_path), env=_env(tmp_path))
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


# -- examples/torch_scaling.py ----------------------------------------------

NUM = r"(-?[0-9.]+(?:e[-+][0-9]+)?)"


def _numbers(out):
    """The numbers a run of either scaling example printed, by section
    (the JAX example says "device(s)" and "AOT-warmed" where the port
    says "rank(s)" and "warmed")."""
    def one(pattern, cast=float):
        got = re.search(pattern, out, re.M)
        return None if got is None else tuple(
            cast(g) if g is not None else None for g in got.groups())

    sweep = one(r"^restart sweep: best TC " + NUM + r" \(restart (\d+); "
                r"all: \[([^\]]*)\]\)", str)
    stack = one(r"^stacked: layer TCs = \[([^\]]*)\]", str)
    int8 = one(r"^int8 fit: TC " + NUM + r" \(f32: " + NUM
               + r"; optimizer ran: (\w+)\)", str)
    return dict(
        sweep_tc=float(sweep[0]), sweep_best=int(sweep[1]),
        sweep_all=[float(v) for v in sweep[2].split()],
        sharded=one(r"^sharded fit over \d+ \w+\(s\): TC " + NUM)[0],
        mesh_sweep=one(r"^estimator restart sweep on the mesh: best TC "
                       + NUM + r" \(lane (\d+)\)"),
        stack=[float(v) for v in stack[0].split(",")],
        streaming=one(r"^streaming fit from 4096 samples: TC " + NUM)[0],
        covariance=one(r"^fit from covariance matrix: +TC " + NUM)[0],
        int8=float(int8[0]), int8_f32=float(int8[1]),
        int8_optimizer=int8[2],
        multi_slice=one(r"^multi-slice fit \((?:AOT-)?warmed\): TC "
                        + NUM)[0],
        serving=one(r"^sharded serving: factors \(2048, 8\), "
                    r"log-likelihood " + NUM)[0],
        checkpointed=one(r"^multi-slice checkpointed fit: TC " + NUM)[0],
        export=one(r"^blocked covariance export: \(128, 128\), "
                   r"max\|Δ\| vs dense = " + NUM)[0])


@pytest.fixture(scope="module")
def scaling_out(tmp_path_factory):
    """One run of the port's example in a world of four gloo ranks."""
    return _run("torch_scaling.py", tmp_path_factory.mktemp("scaling"),
                "--world", "4")


@pytest.fixture(scope="module")
def jax_scaling_out(tmp_path_factory):
    """The JAX package's examples/scaling.py, unchanged, on four CPU
    devices, in a process of its own."""
    tmp = tmp_path_factory.mktemp("jax_scaling")
    env = _env(tmp)
    env.pop("LINEARCOREX_TPU_CACHE_DIR")
    proc = subprocess.run(
        [sys.executable, "-c", JAX_EXAMPLE.format(
            path=str(ROOT / "examples" / "scaling.py"))],
        capture_output=True, text=True, timeout=600, cwd=str(tmp),
        env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout


def test_scaling_example(scaling_out):
    """Every section prints its line at four ranks, none is passed over,
    every rank returned rank 0's bits, and the blocked export is the
    dense covariance."""
    assert "passed over" not in scaling_out
    assert ("world of 4 gloo rank(s): every rank returned rank 0's "
            "results bit for bit") in scaling_out
    for line in ("restart sweep: best TC", "sharded fit over 4 rank(s): TC",
                 "estimator restart sweep on the mesh: best TC",
                 "stacked: layer TCs = [", "streaming fit from 4096 "
                 "samples: TC", "fit from covariance matrix:     TC",
                 "int8 fit: TC", "multi-slice fit (warmed): TC",
                 "sharded serving: factors (2048, 8), log-likelihood",
                 "multi-slice checkpointed fit: TC",
                 "blocked covariance export: (128, 128)"):
        assert line in scaling_out, line
    assert _numbers(scaling_out)["export"] <= EXPORT_TOL


def _close(got, want, rel, rounding):
    return abs(got - want) <= rel * abs(want) + rounding


def test_scaling_example_matches_jax_example(scaling_out, jax_scaling_out):
    """The numbers both examples print. Single-device sections (every
    restart lane's TC, the stack's layer TCs, the streamed and covariance
    TCs, float32 and int8) and the mesh sections (the port's ranks are
    bitwise equal, `test_scaling_example`; here their TC against the JAX
    example's four-device mesh) within F32_REL, or INT8_MOMENTUM_REL for
    the int8 fit, widened by the print's rounding. The restart lanes all
    reach one optimum (float64 lanes agree to 1e-12), so which lane wins
    is float32 rounding: the port's winner must be a best lane of the JAX
    sweep's printed lanes."""
    got, want = _numbers(scaling_out), _numbers(jax_scaling_out)
    for key in ("sweep_tc", "sharded", "streaming", "covariance",
                "int8_f32", "multi_slice", "serving", "checkpointed"):
        assert _close(got[key], want[key], F32_REL, ROUND3), \
            (key, got[key], want[key])
    assert _close(got["int8"], want["int8"], INT8_MOMENTUM_REL, ROUND3), \
        (got["int8"], want["int8"])
    assert got["int8_optimizer"] == want["int8_optimizer"] == "momentum"
    for key in ("sweep_all", "stack"):
        assert len(got[key]) == len(want[key]), key
        for g, w in zip(got[key], want[key]):
            assert _close(g, w, F32_REL, ROUND2), (key, got[key], want[key])
    best = max(want["sweep_all"])
    assert _close(want["sweep_all"][got["sweep_best"]], best, F32_REL,
                  ROUND2)
    tc, lane = got["mesh_sweep"][0], int(got["mesh_sweep"][1])
    assert _close(tc, want["mesh_sweep"][0], F32_REL, ROUND3)
    assert lane in range(4) and _close(want["sweep_all"][lane], best,
                                       F32_REL, ROUND2)
    assert got["export"] <= EXPORT_TOL and want["export"] <= EXPORT_TOL
