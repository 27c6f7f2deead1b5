#!/usr/bin/env python3
"""Basic Linear CorEx workflow with the PyTorch port, the flow of
`examples/basic_usage.py` (the reference README usage).

    python examples/torch_basic_usage.py                # on a CUDA card
    python examples/torch_basic_usage.py --device cpu   # on the CPU

NumPy in, NumPy out: the data is a NumPy array, so every output (`tcs`,
`clusters`, `transform`, `predict`, `get_covariance`) is a NumPy array on
the host, whichever device the model runs on; a torch tensor in would give
tensors on the model's device out. `--device cuda` without a card raises.
"""

import argparse
import os
import tempfile

import numpy as np

import linearcorex_tpu_torch as lct


def make_block_data(n=2000, p=64, m=8, strength=0.9, seed=0):
    rng = np.random.RandomState(seed)
    z = rng.normal(size=(n, m))
    x = np.empty((n, p))
    k = p // m
    for j in range(m):
        for i in range(k):
            x[:, j * k + i] = strength * z[:, j] + np.sqrt(
                1 - strength ** 2) * rng.normal(size=n)
    return x


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = args.device
    x = make_block_data()

    # Fit: the annealed optimization; on a card its loop replays a CUDA graph.
    model = lct.Corex(n_hidden=8, seed=0, verbose=True, device=dev).fit(x)

    print(f"\ntotal correlation explained: {model.tc:.3f}")
    print(f"per-factor TC (sorted):      {np.asarray(model.tcs).round(2)}")
    print(f"variable clusters:           {np.asarray(model.clusters)}")

    # Factors and reconstruction
    y = model.transform(x)
    x_hat = model.predict(y)
    resid = np.linalg.norm(np.asarray(x_hat) - x) / np.linalg.norm(x)
    print(f"reconstruction rel. error:   {resid:.3f}")

    # Regularized covariance estimate (the paper's headline use-case)
    sigma = model.get_covariance()
    print(f"covariance estimate shape:   {sigma.shape}")

    # Held-out model evaluation (sklearn scoring convention)
    print(f"mean log-likelihood:         {float(model.score(x)):.3f}")

    # Model selection: how many factors does the data support?
    best_n, scores = lct.pick_n_hidden(x, repeat=2, max_n_hidden=12, seed=0,
                                       device=dev)
    print(f"pick_n_hidden chose:         {best_n}")
    best_cv, _ = lct.pick_n_hidden(x, repeat=2, max_n_hidden=12, seed=0,
                                   criterion="heldout", device=dev)
    print(f"held-out criterion chose:    {best_cv}")

    # Throughput recipes: preset='throughput' bundles int8 operands, the
    # spectral init, anneal=False and tol=1e-4; n_restarts=4 runs four
    # spectral lanes as one solve and keeps the best TC; stage_tol_factor
    # runs the non-final annealing stages at a looser tol.
    fast = lct.Corex(n_hidden=8, seed=0, preset="throughput", n_restarts=4,
                     device=dev).fit(x)
    annealed = lct.Corex(n_hidden=8, seed=0, stage_tol_factor=10.0,
                         device=dev).fit(x)
    print(f"preset='throughput' TC:      {float(fast.tc):.3f}  "
          "(int8 + no anneal: built for large strong-structure data — "
          "at toy scale the annealed path above wins)")
    print(f"stage_tol_factor=10 TC:      {float(annealed.tc):.3f}")

    # Persistence: the .npz file the JAX package reads and writes too
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "corex_model.npz")
        lct.save_corex(model, path)
        restored = lct.load_corex(path, device=dev)
    assert abs(restored.tc - model.tc) < 1e-9
    print("checkpoint round-trip:       ok")


if __name__ == "__main__":
    main()
