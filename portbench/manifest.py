"""Finds a cell's pieces by name: everything the harness runs is data or
a small file of its own, so a later change adds a configuration, a cell,
a traffic mix, a per-layer metric or a kernel pattern by adding a file.

- `BENCHMARK.json` (the checkout's root): the cells, the end-to-end and
  per-layer metrics;
- `portbench/configs/<config>.json`: a configuration's sizes and data;
- `portbench/traffic/<traffic>.json`: a traffic mix's parameters, read by
  the generator its `generator` key names;
- `portbench/generators/<generator>.py`: a kind of traffic, its set-up,
  window and comparison (`generators/__init__.py` says what it has);
- `portbench/workloads/<cell>.json`: a cell's comparison limits;
- `portbench/metrics/<metric>.py`: a per-layer metric's reader, a
  function `read(ctx)` that returns a number or None;
- `portbench/kernels/<layer>.json`: the kernel-name patterns a reader
  takes from a trace.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path
from typing import Callable, List, Optional

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


class Manifest:
    """`BENCHMARK.json` and the files it names, under `root` (the
    checkout)."""

    def __init__(self, root: Optional[Path] = None):
        self.root = Path(root) if root is not None else ROOT
        self.bench = self.root / "portbench"
        with open(self.root / "BENCHMARK.json") as f:
            self.spec = json.load(f)

    def _entry(self, key: str, name: str) -> dict:
        for e in self.spec[key]:
            if e["name"] == name:
                return e
        raise KeyError(f"{key} has no entry named {name!r}")

    def _json(self, *parts) -> dict:
        with open(self.bench.joinpath(*parts)) as f:
            return json.load(f)

    def cell(self, name: str) -> dict:
        """The cell `name`: its BENCHMARK.json entry, its configuration
        (as run), its traffic mix, its workload file and its metrics."""
        w = self._entry("workloads", name)
        conf = self._entry("configs", w["config"])
        return {
            "name": name,
            "chips": w["chips"],
            "config_name": w["config"],
            "config": self._json(Path(conf["file"]).relative_to(
                "portbench")),
            "traffic_name": w["traffic"],
            "traffic": self._json("traffic", f"{w['traffic']}.json"),
            "workload": self._json("workloads", f"{name}.json"),
            "end_to_end": [m for m in self.spec["end_to_end"]
                           if name in m.get("workloads", [name])],
            "per_layer": [m for m in self.spec["per_layer"]
                          if name in m.get("workloads", [name])],
        }

    def generator(self, name: str):
        """The module generators/<name>.py under the checkout: the
        benchmark's own as `portbench.generators.<name>`, a file that only
        this checkout holds loaded by its path."""
        path = self.bench / "generators" / f"{name}.py"
        own = BENCH_DIR / "generators" / f"{name}.py"
        if not re.fullmatch(r"[A-Za-z0-9_]+", name) or not (
                path.is_file() or own.is_file()):
            raise KeyError(f"no traffic generator named {name!r}")
        if not path.is_file() or path.resolve() == own.resolve():
            return importlib.import_module(f"portbench.generators.{name}")
        return _load(f"portbench_generator_{name}", path)

    def reader(self, metric: str) -> Callable:
        """The `read(ctx)` function of metrics/<metric>.py; a metric split
        by the cells it serves (`<name>.<group>`, each group moving its
        own end-to-end metric) reads with metrics/<name>.py unless it has
        a file of its own."""
        path = self.bench / "metrics" / f"{metric}.py"
        if not path.is_file():
            path = self.bench / "metrics" / f"{metric.split('.')[0]}.py"
        return _load(
            f"portbench_metric_{re.sub(r'[^0-9A-Za-z_]', '_', metric)}",
            path).read

    def patterns(self, layer: str) -> List[re.Pattern]:
        """Every kernels/<layer>*.json's patterns: a later file
        (`<layer>.<more>.json`) adds names without editing the first."""
        out = []
        for path in sorted((self.bench / "kernels").glob(f"{layer}*.json")):
            stem = path.name[:-len(".json")]
            if stem != layer and not stem.startswith(layer + "."):
                continue
            with open(path) as f:
                out += [re.compile(p) for p in json.load(f)["patterns"]]
        return out


def _load(module_name: str, path: Path):
    spec = importlib.util.spec_from_file_location(module_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
