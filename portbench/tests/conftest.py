"""Fixtures of the benchmark's CPU tests: a copy of the benchmark's data
files with tiny cells added, each by its own files, for dry runs of the
harness on the CPU."""

import io
import json
import os
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY = {"name": "tiny", "n_samples": 64, "n_variables": 32, "n_hidden": 4,
        "data": {"generator": "block", "blocks": 4, "loading": 0.9,
                 "noise": 0.436}}
# sound CPU readings at this size are below 2e-6, the TF32 control's near
# 1e-4 and the int4 control's near 1e-2; `residual_gap` of sound momentum
# fits 5e-4-3.2e-3, of the loop frozen after its first body 4-13, of the
# TF32 control 0.02-0.07. The int8 fixed point's cell compares
# `stall_gap` in its place, as the benchmark's does: sound windows read
# 1.1-2.5, the frozen loop 8e6
TINY_LIMITS = {"cxy_gap": 2e-5, "tc_gap": 2e-5, "first_step_gap": 2e-5,
               "residual_gap": 0.01}
LIMITS_FIXED_POINT = {"cxy_gap": 2e-5, "tc_gap": 2e-5,
                      "first_step_gap": 2e-5, "stall_gap": 10.0}
# n < p/2: the samples path, as the omics configuration runs
TINY_WIDE = dict(TINY, name="tiny-wide", n_samples=24, n_variables=64)
TINY_CELLS = {"tiny-default": ("tiny", "fit-default"),
              "tiny-throughput": ("tiny", "fit-throughput",
                                  LIMITS_FIXED_POINT),
              "tiny-restarts8": ("tiny", "fit-restarts8"),
              "tiny-wide-default": ("tiny-wide", "fit-default")}


def copy_bench(dst: Path, code: bool = False) -> Path:
    """BENCHMARK.json and the benchmark's data files under `dst`; with
    `code`, every file of the benchmark (the tests' runs otherwise use
    the benchmark's own modules and generators)."""
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    if code:
        shutil.copytree(ROOT / "portbench", dst / "portbench",
                        ignore=shutil.ignore_patterns("__pycache__"))
        return dst
    for sub in ("configs", "traffic", "workloads", "metrics", "kernels"):
        shutil.copytree(ROOT / "portbench" / sub, dst / "portbench" / sub)
    return dst


def add_json(path: Path, obj) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj, indent=1) + "\n")


def add_cell(root: Path, name: str, config: str, traffic: str,
             limits=None, **extra) -> None:
    """A cell by its workload file and its BENCHMARK.json entry; the
    per-layer metrics that list cells list it too."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": name, "config": config,
                              "traffic": traffic, "chips": 1,
                              "why": "a tiny cell of the CPU tests"})
    # the tiny cells report the metrics of the north-star default cell
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "ns-default-f32" in m.get("workloads", []):
            m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    add_json(root / "portbench" / "workloads" / f"{name}.json",
             {"config": config, "traffic": traffic, "chips": 1,
              "why": "a tiny cell of the CPU tests",
              "limits": limits or TINY_LIMITS, **extra})


def add_config(root: Path, cfg: dict) -> None:
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({
        "name": cfg["name"], "source": "https://arxiv.org/abs/1706.03353",
        "file": f"portbench/configs/{cfg['name']}.json",
        "reduced": ["n_samples", "n_variables", "n_hidden"],
        "why": "a tiny configuration of the CPU tests"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    add_json(root / "portbench" / "configs" / f"{cfg['name']}.json", cfg)


@pytest.fixture
def tiny_root(tmp_path):
    root = copy_bench(tmp_path)
    add_config(root, TINY)
    add_config(root, TINY_WIDE)
    for name, (config, traffic, *limits) in TINY_CELLS.items():
        add_cell(root, name, config, traffic, *limits)
    return root


@pytest.fixture
def dry_run():
    """harness.run on the CPU with the look for a card skipped; returns
    (exit code, the result dict or None, standard error). The variables
    the harness sets in the environment are restored after the test."""
    saved = dict(os.environ)

    def go(root, workload, seed=2147483999, seconds=0.5, trace=0):
        from portbench import harness
        out, err = io.StringIO(), io.StringIO()
        rc = harness.run(["--workload", workload, "--seed", str(seed),
                          "--seconds", str(seconds), "--trace", str(trace)],
                         root=root, require_card=False, device="cpu",
                         out=out, err=err)
        lines = out.getvalue().strip().splitlines()
        return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()

    yield go
    os.environ.clear()
    os.environ.update(saved)
