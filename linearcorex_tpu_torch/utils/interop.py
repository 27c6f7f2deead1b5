"""Carry a fitted model between the JAX package and the PyTorch port.

`corex_from_numpy(state, **params)` builds a fitted port `Corex` from the
numpy arrays that either package's `save_corex` writes: `ws`,
`theta_mean`, `theta_std`, one `mom_<field>` per `Moments` field, and the
`meta_json` metadata when present. The result transforms like the saved
model and reports the same `tc`/`tcs`/`mis`/`clusters`. `utils.checkpoint.
load_corex` reads the `.npz` file itself and builds on this function.
"""

from __future__ import annotations

import json

from linearcorex_tpu_torch.models.corex import Corex
from linearcorex_tpu_torch.ops.moments import Moments
from linearcorex_tpu_torch.ops.preprocessing import Theta

def corex_from_numpy(state, n_samples=None, best_restart=None,
                     **params) -> Corex:
    """A fitted `Corex(**params)` holding the arrays of `state` (a mapping
    such as an opened `.npz`), cast to the model dtype on the model device.
    `n_samples` and `best_restart_` come from the keywords, else from the
    state's `meta_json` (a file without the restart key carries a
    single-lane fit: lane 0), else they are None and 0. A later `fit` warm-starts
    from the stored weights, as after `load_corex`."""
    model = Corex(**params)
    model.ws = model._as_tensor(state["ws"])
    model.theta = Theta(mean=model._as_tensor(state["theta_mean"]),
                        std=model._as_tensor(state["theta_std"]))
    model.moments = Moments(**{name: model._as_tensor(state[f"mom_{name}"])
                               for name in Moments._fields})
    model.nv = model.ws.shape[1]
    meta = json.loads(bytes(state["meta_json"]).decode()) \
        if "meta_json" in state else {}
    if n_samples is None:
        n_samples = meta.get("n_samples")
    if best_restart is None:
        best_restart = meta.get("best_restart", 0)
    model.n_samples = None if n_samples is None else int(n_samples)
    model.best_restart_ = None if best_restart is None else int(best_restart)
    model._pretrained_ws = model.ws
    return model
