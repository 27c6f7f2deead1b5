#!/usr/bin/env python3
"""Time two checkouts of the PyTorch port against each other, in turns, on
one CUDA card.

    python3 compare_chain.py OTHER_ROOT [PHASE ...]

Run from the root of a checkout, on a machine with one NVIDIA Hopper card
(H100), nvcc and PyTorch built for CUDA. OTHER_ROOT is another checkout of
the repository, for example the parent commit unpacked with `git archive`
into a directory that .gitignore lists. Each turn runs in a process of its
own with one checkout's `linearcorex_tpu_torch` first on sys.path (its
chain kernel built from its own source into its own `_build/`), in the
order other, this, this, other. A turn runs the PHASEs named (all four by
default), on the same seeded inputs and with this checkout's
`chip_smoke.py` helpers:

- kernel: the chain kernel at (p, m) = (10000, 512), its lane entry at
  (4, 10000, 512), and the lane entry at the padded selection grid's
  (32, 1024, 8), where a call is host-bound: CUDA events, a warm-up, min
  of 3 runs of 20 calls;
- fit_core: iterations/s at the north-star shape (gram, fixed point,
  anneal=False, tol=0, 200 iterations) in float32, bfloat16 and int8
  through the kernel: a warm-up, then the best of two timed runs;
- selection: the walls of pick_n_hidden at n=2000, p=1024 (max_n_hidden=8,
  repeat=4, max_iter=2000), padded and sequential, 'tc' and 'heldout';
- basins: the annealed north-star fit (Corex.fit, optimizer='auto') in
  float32 and int8 at data and W0 seeds 0-5: TC, iterations and the share
  of planted blocks recovered whole, which show the basin each fit lands in.

Each turn prints one JSON line; the last line gathers every metric's values
per checkout over its two turns. Imports nothing of JAX.
"""

import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
RHO_CLIP = 1 - 1e-6


PHASES = ("kernel", "fit_core", "selection", "basins")
BASIN_SEEDS = range(6)


def turn(root, phases):
    """One turn on the checkout at `root`; returns its measurements."""
    sys.path.insert(0, str(root))
    import torch
    import linearcorex_tpu_torch as lct
    check = Path(lct.__file__).resolve()
    if Path(root).resolve() not in check.parents:
        raise RuntimeError(f"imported {check}, not the package under {root}")
    from linearcorex_tpu_torch.ops.cuda_moments import ns_chain

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    out = {"root": str(root)}

    if "kernel" in phases:
        kernel_times(cs, ns_chain, out)
    if "fit_core" in phases:
        fit_core_rates(cs, dev, out)
    if "selection" in phases:
        selection_walls(cs, lct, dev, out)
    if "basins" in phases:
        basins(cs, dev, out)
    return out


def kernel_times(cs, ns_chain, out):
    import torch
    one = cs.chain_inputs(cs.P, cs.M)
    out["kernel_ms"] = cs.time_ms(lambda: ns_chain(*one, RHO_CLIP), inner=20)
    four = [cs.chain_inputs(cs.P, cs.M, seed=1 + i) for i in range(cs.LANES)]
    four = tuple(torch.stack(t) for t in zip(*four))
    out["lanes_ms"] = cs.time_ms(lambda: ns_chain(*four, RHO_CLIP), inner=20)
    grid = [cs.chain_inputs(cs.SEL_P, 8, seed=1 + i, dead=5)
            for i in range(32)]
    grid = tuple(torch.stack(t) for t in zip(*grid))
    out["selection_grid_ms"] = cs.time_ms(lambda: ns_chain(*grid, RHO_CLIP),
                                          inner=20)
    del one, four, grid


def fit_core_rates(cs, dev, out):
    operands, w0 = cs.timed_operands(dev)
    for mode in ("float32", "bfloat16", "int8"):
        run, diag = cs.fit_core_runner(operands[mode], w0, mode, "always",
                                       cs.TIMED_ITERS)
        run()
        rates = []
        for _ in range(2):
            ms = cs.time_ms(run, reps=1, warmup=False)
            rates.append(int(diag["diag"].iters_per_stage.sum()) / (ms / 1e3))
        out[f"fit_core_it_per_s_{mode}"] = max(rates)
    del operands, w0


def selection_walls(cs, lct, dev, out):
    import torch
    x = cs.block_data(cs.SEL_N, cs.SEL_P, cs.SEL_BLOCKS,
                      seed=cs.DATA_SEED + 2, dev=dev)
    for criterion in ("tc", "heldout"):
        for padded in (True, False):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            best, _ = lct.pick_n_hidden(
                x, repeat=4, max_n_hidden=8, max_iter=2000, seed=0,
                padded_sweep=padded, criterion=criterion, device="cuda")
            torch.cuda.synchronize()
            name = f"selection_{criterion}_{'padded' if padded else 'seq'}"
            out[f"{name}_s"] = time.perf_counter() - t0
            out[f"{name}_best_n"] = best


def basins(cs, dev, out):
    for seed in BASIN_SEEDS:
        x = cs.block_data(cs.N, cs.P, cs.BLOCKS, seed=seed, dev=dev)
        for mode in ("float32", "int8"):
            model, _, _, _ = cs.north_star_fit(x, seed=seed, optimizer="auto",
                                               matmul_dtype=mode)
            key = f"basin_{mode}_seed{seed}"
            out[f"{key}_tc"] = model.tc
            out[f"{key}_n_iter"] = model.n_iter_
            out[f"{key}_blocks_whole"] = cs.blocks_whole(
                model.clusters.cpu().numpy())
            del model
        del x


def main():
    if len(sys.argv) >= 3 and sys.argv[1] == "--turn":
        print(json.dumps(turn(sys.argv[2], sys.argv[3:])), flush=True)
        return
    phases = sys.argv[2:] or list(PHASES)
    if len(sys.argv) < 2 or not set(phases) <= set(PHASES):
        raise SystemExit(__doc__)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("compare_chain: torch.cuda.is_available() is False "
                         "— this script runs only on a CUDA card")
    other = Path(sys.argv[1]).resolve()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    turns = {"other": [], "this": []}
    for which in ("other", "this", "this", "other"):
        root = other if which == "other" else HERE
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                               "--turn", str(root), *phases],
                              capture_output=True,
                              text=True, cwd=root, timeout=1800)
        if proc.returncode != 0:
            raise RuntimeError(f"compare_chain: the turn on {root} failed:\n"
                               f"{proc.stdout}\n{proc.stderr}")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        turns[which].append(res)
        print(json.dumps({"turn": which, **res}), flush=True)
    keys = [k for k in turns["this"][0] if k != "root"]
    print(json.dumps({"card": card, "other": str(other), "this": str(HERE),
                      "metrics": {k: {w: [t[k] for t in turns[w]]
                                      for w in ("other", "this")}
                                  for k in keys}}), flush=True)


if __name__ == "__main__":
    main()
