#!/usr/bin/env python3
"""The deploy-time workflow of the PyTorch port: warm, fit, save; then,
in the serving process, load, warm, serve.

    python examples/torch_deploy_warmup.py                # on the CPU
    python examples/torch_deploy_warmup.py --device cuda  # on a card

`Corex.warmup(n, p)` runs the fit's programs once on synthetic operands at
the declared shapes: it builds the chain kernel (nvcc) or the host library
(g++) into the build directory if they are not there yet, and pays the
first-call costs of the process (CUDA context, cuBLAS/cuSOLVER handles,
module loads), so the first real fit does not. `warmup_serving` does the
same for the serving calls of a loaded model. The build directory is
`linearcorex_tpu_torch/_build/` unless `LINEARCOREX_TPU_CACHE_DIR` moves
it (`ensure_compile_cache`). Each step prints its wall time.
"""

import argparse
import time

import numpy as np
import torch

import linearcorex_tpu_torch as lct


def block_data(n, p, blocks, seed=0):
    """p variables in `blocks` equal groups, each driven by one factor."""
    rng = np.random.RandomState(seed)
    z = rng.normal(size=(n, blocks))
    return (np.repeat(z, p // blocks, axis=1) * 0.9
            + 0.436 * rng.normal(size=(n, p)))


def timed(label, fn, device):
    t0 = time.perf_counter()
    out = fn()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    print(f"{label}: {time.perf_counter() - t0:.3f} s")
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--n", type=int, default=800)
    ap.add_argument("--p", type=int, default=32)
    ap.add_argument("--n-hidden", type=int, default=4)
    ap.add_argument("--out", default="corex_model.npz")
    args = ap.parse_args()
    dev = args.device
    print("build directory:", lct.ensure_compile_cache())

    # the fitting process: warm at deploy time, then fit and save
    x = block_data(args.n, args.p, args.n_hidden)
    model = lct.Corex(n_hidden=args.n_hidden, seed=0, device=dev)
    timed("warmup", lambda: model.warmup(args.n, args.p), dev)
    timed("first fit", lambda: model.fit(x), dev)
    print(f"tc = {model.tc:.4f}, clusters = "
          f"{model.clusters.tolist()}")
    lct.save_corex(model, args.out)

    # the serving process: load, warm for the batch size, serve
    served = lct.load_corex(args.out, device=dev)
    timed("warmup_serving", lambda: lct.warmup_serving(served, 256), dev)
    batch = x[:256]
    y = timed("first transform", lambda: served.transform(batch), dev)
    timed("first score", lambda: served.score(batch), dev)
    print(f"transform {tuple(y.shape)}, equal to the fitted model's: "
          f"{bool(np.array_equal(y, model.transform(batch)))}")


if __name__ == "__main__":
    main()
