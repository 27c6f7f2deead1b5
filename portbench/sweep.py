"""The seed sweep and the lower-precision control of a cell, on the card.
Not part of a benchmark run: it measures what the limits in
`workloads/<cell>.json` are set from.

    python3 portbench/sweep.py --workload <cell> --seeds 1,2,3 --fits 3
        [--control 2] [--faults 2] [--kernels] --out <file>.jsonl

For each data seed, `--fits` user fits of the cell's call (the window's
own fits: the same data, seed stream and call), each judged by
`compare.gaps`: one JSON line per fit. For the first `--control` seeds,
as many fits of the control, judged alike; for the first `--faults`
seeds, as many of each planted fault:
- `fault-frozen`: the loop's state frozen from its second body on, in
  the reference put in the program's place: each lane's W after the
  first accept/reject body, its final moments, the best lane kept;
- `fault-tol10`: the program with every stage's tolerance ten times the
  call's, so that each stage ends early.
The control is the step below the precision the cell's call states:
- a float32 single fit: the program itself with matmul_precision='high'
  (its TF32 path);
- a float32 restart sweep (whose lanes run at full float32 whatever the
  precision): the reference in the program's place in float32 with
  every product's operands rounded to TF32, lane by lane, the best TC
  kept;
- the int8 operand: the reference in the program's place in float32 on
  a 4-bit operand (levels ±7).
`--kernels` adds one line: every device operation of one profiled fit,
with its count and seconds.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def control_kind(st: dict) -> str:
    if st["matmul_dtype"] == "int8":
        return "reference-int4"
    if int(st.get("n_restarts", 1)) > 1:
        return "reference-tf32"
    return "program-high"


def reference_control(x, config, st, seed, kind, torch):
    """The reference fit in the program's place, below the stated
    precision; returns (ws, c_xy, tc, first_tc, lane) in float64."""
    from portbench import compare
    from portbench import reference as R
    z32 = R.standardize(x)[0].to(torch.float32)
    if kind == "reference-int4":
        op = compare.operand(z32, st, levels_override=7)
    else:
        op = compare.operand(z32, st, rounding=R.tf32)
    best = None
    for lane in range(int(st.get("n_restarts", 1))):
        w0 = compare.start(seed + lane, config["n_hidden"], op, st,
                           x.device).to(torch.float32)
        f = R.fit(w0, op, st["optimizer"], st["anneal"], st["tol"],
                  st["max_iter"])
        if best is None or f.tc > best[0].tc:
            best = (f, lane)
    f, lane = best
    return (f.ws.to(R.DT), f.c_xy.to(R.DT), f.tc, f.first_tc, lane)


def frozen_fault(x, config, st, seed, torch):
    """The outputs of a fit whose loop state stops changing after its
    first body, re-derived in float64: (ws, c_xy, tc, first_tc, lane)."""
    from portbench import compare
    from portbench import reference as R
    op = compare.operand(R.standardize(x)[0], st)
    exact = op.exact()
    m = config["n_hidden"]
    eps0 = R.anneal_schedule(st["anneal"], m)[0]
    rules = R.Rules.of(st["optimizer"])
    best = None
    for lane in range(int(st.get("n_restarts", 1))):
        w0 = compare.start(seed + lane, m, op, st, x.device)
        f0, g0, tc0 = R.evaluate(w0, op, eps0, st["optimizer"])
        w1, _ = R._step(w0, torch.zeros_like(w0), g0, rules.lr_init, rules)
        f1, _, tc1 = R.evaluate(w1, op, eps0, st["optimizer"])
        ws, first = (w1, tc1) if bool(f1 <= f0) else (w0, tc0)
        mom = R.moments(ws, R.cross(ws, exact, 0.0), exact)
        order = torch.argsort(-mom.tcs, stable=True)
        if best is None or float(mom.tc) > best[2]:
            best = (ws[order], mom.c_xy[:, order], float(mom.tc),
                    float(first), lane)
    return best


def kernels(lct, x, kwargs, seed, torch):
    from torch.profiler import ProfilerActivity, profile
    from portbench.generators import fitloop
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fitloop.fit_once(lct, x, kwargs, seed, "cuda")
        torch.cuda.synchronize()
    tot = {}
    for e in prof.profiler.kineto_results.events():
        if str(e.device_type()).endswith("CUDA") and \
                not e.is_user_annotation():
            c, s = tot.get(e.name(), (0, 0.0))
            tot[e.name()] = (c + 1, s + e.duration_ns() / 1e9)
    return sorted(([n, c, s] for n, (c, s) in tot.items()),
                  key=lambda r: -r[2])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--fits", type=int, default=3)
    ap.add_argument("--control", type=int, default=0)
    ap.add_argument("--faults", type=int, default=0)
    ap.add_argument("--kernels", action="store_true")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    from portbench import compare, datagen, harness
    from portbench.generators import fitloop
    from portbench import reference as R
    from portbench.manifest import Manifest
    cell = Manifest(ROOT).cell(args.workload)
    harness.set_caches(ROOT)
    import torch
    dev = "cuda"
    if not torch.cuda.is_available():
        print("sweep: no CUDA card", file=sys.stderr)
        return 3
    import linearcorex_tpu_torch as lct
    config = cell["config"]
    kwargs = fitloop.estimator_kwargs(config, cell["traffic"])
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    power = None
    try:
        import subprocess
        power = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
    except OSError:
        pass
    seeds = [int(s) for s in args.seeds.split(",")]
    sync = torch.cuda.synchronize
    with open(out, "a") as f:
        def emit(rec):
            rec.update(workload=args.workload, card=power)
            f.write(json.dumps(rec) + "\n")
            f.flush()

        for si, seed in enumerate(seeds):
            x = datagen.make_data(config, seed, dev)
            st = compare.settings(kwargs, *x.shape)
            z = R.standardize(x)[0]
            op = compare.operand(z, st)
            stream = datagen.fit_seeds(seed)
            fit_seeds = [next(stream) for _ in range(args.fits + 1)]
            fitloop.warm(lct, x, kwargs, dev)
            if args.kernels and si == 0:
                emit({"kind": "kernels",
                      "ops": kernels(lct, x, kwargs, fit_seeds[0], torch)})
            kinds = ["program"]
            if si < args.control:
                kinds.append(control_kind(st))
            if si < args.faults:
                kinds += ["fault-frozen", "fault-tol10"]
            for kind in kinds:
                for fs in fit_seeds[1:]:
                    sync()
                    t0 = time.perf_counter()
                    its = None
                    if kind == "reference-int4" or kind == "reference-tf32":
                        ws, cxy, tc, first, lane = reference_control(
                            x, config, st, fs, kind, torch)
                    elif kind == "fault-frozen":
                        ws, cxy, tc, first, lane = frozen_fault(
                            x, config, st, fs, torch)
                    else:
                        kw = dict(kwargs)
                        if kind == "program-high":
                            kw["matmul_precision"] = "high"
                        elif kind == "fault-tol10":
                            kw["tol"] = 10 * st["tol"]
                        model = fitloop.fit_once(lct, x, kw, fs, dev)
                        s = fitloop.sample_of(model, fs)
                        ws, cxy = s.ws.to(R.DT), s.c_xy.to(R.DT)
                        tc, first, lane = float(s.tc), float(s.first_tc), \
                            s.lane
                        its = int(model.diagnostics.iters_per_stage.sum())
                        del model
                    sync()
                    wall = time.perf_counter() - t0
                    w0 = compare.start(fs + lane, config["n_hidden"], op,
                                       st, x.device)
                    g = compare.gaps(ws, cxy, tc, first, w0, op, st)
                    emit({"kind": kind, "seed": seed, "fit_seed": fs,
                          "lane": lane, "wall_s": wall, "tc": tc,
                          "iterations": its, **g})
            del x, z, op
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.path[0] = str(ROOT)
    sys.exit(main())
