"""One run of one cell: set-up, the measured window, the comparison, the
result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

1. Refuses to run (exit 3, no result) without a CUDA card, or with fewer
   cards than the cell asks for.
2. Set-up: the cell's traffic generator (`generators/<name>.py`, named by
   its mix) makes the data from `--seed` and warms every shape the
   traffic uses; every build and kernel cache sits in the checkout's
   fixed `.portbench_cache/`, so only a checkout's first run builds.
   `setup_s` runs from the interpreter's start to the window's, the
   import of torch and of the port included.
3. The window: the generator's traffic for `--seconds`.
4. After the window: the peak device memory, then the generator's
   comparison with the plain reference.
5. A check that no JAX module was loaded, then the result: every
   compared number beside its limit as the last lines of standard error,
   then one JSON line on standard output, its `checks` key last.

With `--trace 0` the metrics are the cell's end-to-end ones; with
`--trace 1` the per-layer ones, read by `metrics/<name>.py` from the
window's spans and counters and a device trace of its first stretch.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import sys
import time
from pathlib import Path
from typing import NamedTuple, Optional

FORBIDDEN = ("jax", "jaxlib", "flax", "linearcorex_tpu")
CACHE = ".portbench_cache"


class Context(NamedTuple):
    """What a per-layer reader reads."""

    cell: dict
    shape: object          # yardstick.Shape, or None
    window: object         # the generator's window
    trace: object          # tracing.Trace or None
    patterns: object       # callable: layer -> compiled patterns


def parse(argv):
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def forbidden_modules():
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def set_caches(root: Path):
    """Every build and kernel cache inside the checkout, at fixed paths."""
    base = root / CACHE
    os.environ["LINEARCOREX_TPU_CACHE_DIR"] = str(base / "build")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(base / "cuda")
    os.environ.pop("LINEARCOREX_TPU_NO_COMPILE_CACHE", None)
    os.environ["USE_FLAX"] = "0"


def device_info(torch, device, chips: int) -> dict:
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": chips,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}


def end_to_end(cell: dict, values: dict, setup_s: float) -> dict:
    values = dict(values, setup_s=setup_s)
    # a metric split by cell groups (`<name>.<group>`) reads as <name>
    return {m["name"]: {"value": values[m["name"].split(".")[0]],
                        "unit": m["unit"]}
            for m in cell["end_to_end"]}


def per_layer(cell: dict, ctx: Context, manifest) -> dict:
    out = {}
    for m in cell["per_layer"]:
        v = manifest.reader(m["name"])(ctx)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def run(argv=None, *, root: Optional[Path] = None, started=None,
        require_card: bool = True, device: Optional[str] = None,
        out=None, err=None) -> int:
    """One run; returns the exit code. `require_card=False` and `device`
    let a test drive the rest of a run on the CPU."""
    started = time.perf_counter() if started is None else started
    out = out or sys.stdout
    err = err or sys.stderr
    args = parse(argv)
    from portbench.manifest import Manifest
    manifest = Manifest(root)
    cell = manifest.cell(args.workload)
    set_caches(manifest.root)

    import torch
    if require_card:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < cell["chips"]:
            print(f"portbench: the cell {cell['name']} needs "
                  f"{cell['chips']} CUDA card(s); this machine has {have}",
                  file=err)
            return 3
    device = device or "cuda"

    from portbench import tracing
    gen = manifest.generator(cell["traffic"]["generator"])
    on_card = torch.device(device).type == "cuda"
    state = gen.setup(cell, args.seed, device)
    if on_card:
        torch.cuda.synchronize()
    gc.collect()
    setup_s = time.perf_counter() - started

    window = gen.measure(state, args.seconds, args.seed, bool(args.trace))
    dev = device_info(torch, device, cell["chips"])
    if args.trace:
        metrics = per_layer(cell, Context(cell, gen.shape(state), window,
                                          window.trace, manifest.patterns),
                            manifest)
        if window.trace is not None:
            lo, hi = window.trace.window
            dev["busy_s"] = tracing.busy_ns(window.trace.device, lo,
                                            hi) / 1e9
            dev["window_s"] = (hi - lo) / 1e9
    else:
        metrics = end_to_end(cell, gen.values(state, window), setup_s)

    # the comparison, once the window has closed and its outputs are freed
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    checks = gen.check(state, window)
    correct = passed(checks) and not window.failed and window.attempted > 0
    for e in window.errors[:5]:
        print(f"portbench: {e}", file=err)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=err)
    result = {"correct": correct, "attempted": window.attempted,
              "failed": window.failed, "metrics": metrics, "device": dev}
    if args.trace and window.trace is not None:
        result["breakdown"] = {
            "device_ops": tracing.device_ops(window.trace),
            "idle_gaps": tracing.idle_gaps(window.trace)}
    result["checks"] = checks
    # last, after the readers and the comparison have loaded what they load
    loaded = forbidden_modules()
    if loaded:
        print(f"portbench: the run loaded {', '.join(loaded)}: nothing "
              f"the benchmark runs may import JAX or the JAX package",
              file=err)
        return 4
    print(json.dumps(result), file=out, flush=True)
    return 0


def passed(checks: dict) -> bool:
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
               for c in checks.values())
