#!/usr/bin/env python3
"""The PyTorch port's Corex estimator inside the sklearn ecosystem, the
flow of `examples/sklearn_pipeline.py`.

    python examples/torch_sklearn_pipeline.py                # on a CUDA card
    python examples/torch_sklearn_pipeline.py --device cpu   # on the CPU

The estimator implements the sklearn protocol (get/set_params, clone,
tags, check_is_fitted, an ignored `y` on fit/score), so it drops into
Pipelines, cross-validation and grid search. Its outputs follow the kind
of their input: NumPy in gives NumPy out on any device, so the steps after
Corex, `np.linalg.norm(recon - x)` and sklearn's scorers take them as they
are. `score(X)` is the held-out mean Gaussian log-likelihood under the
fitted factor model, which makes GridSearchCV model selection meaningful
for an unsupervised estimator. Needs sklearn (and pandas for the named
columns); `--device cuda` without a card raises.
"""

import argparse

import numpy as np

import linearcorex_tpu_torch as lct


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = args.device

    from sklearn.model_selection import GridSearchCV, cross_val_score
    from sklearn.pipeline import Pipeline

    # 3 planted factors, 18 observed variables
    rng = np.random.default_rng(0)
    z = rng.normal(size=(400, 3))
    w = rng.normal(size=(3, 18))
    x = z @ w + 0.1 * rng.normal(size=(400, 18))

    # --- Pipeline: fit_transform / inverse_transform round trip --------
    pipe = Pipeline([("corex", lct.Corex(n_hidden=3, seed=0, max_iter=200,
                                         device=dev))])
    factors = pipe.fit_transform(x)
    recon = pipe.inverse_transform(factors)
    rel = np.linalg.norm(recon - x) / np.linalg.norm(x)
    print(f"pipeline factors {factors.shape}, reconstruction rel-err {rel:.3f}")

    # --- pandas output: named factor columns ---------------------------
    try:
        import pandas as pd
    except ImportError:
        pd = None
    if pd is not None:
        xdf = pd.DataFrame(x, columns=[f"v{i}" for i in range(18)])
        named = Pipeline([("corex", lct.Corex(n_hidden=3, seed=0,
                                              max_iter=200, device=dev))])
        named.set_output(transform="pandas")
        zdf = named.fit_transform(xdf)
        print("pandas factors:", type(zdf).__name__, list(zdf.columns))

    # --- Cross-validated likelihood ------------------------------------
    scores = cross_val_score(
        lct.Corex(n_hidden=3, seed=0, max_iter=200, device=dev), x, cv=3)
    print("3-fold held-out log-likelihood:", np.round(scores, 3))

    # --- Grid search over n_hidden: recovers the planted factor count --
    gs = GridSearchCV(lct.Corex(seed=0, max_iter=200, device=dev),
                      {"n_hidden": [1, 2, 3, 5]}, cv=2)
    gs.fit(x)
    print("grid search best n_hidden:", gs.best_params_["n_hidden"],
          "(planted: 3)")


if __name__ == "__main__":
    main()
