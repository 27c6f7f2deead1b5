"""Carry a model fitted by the JAX package across to the PyTorch port.

`corex_from_numpy(state, **params)` builds a fitted port `Corex` from the
numpy arrays that `linearcorex_tpu.utils.checkpoint.save_corex` writes:
`ws`, `theta_mean`, `theta_std` and one `mom_<field>` per `Moments` field.
The result transforms like the JAX model and reports the same
`tc`/`tcs`/`mis`/`clusters`. Reading the `.npz` file itself (`load_corex`)
is not ported yet (ROADMAP.md Queue 1, item 14).
"""

from __future__ import annotations

from linearcorex_tpu_torch.models.corex import Corex
from linearcorex_tpu_torch.ops.moments import Moments
from linearcorex_tpu_torch.ops.preprocessing import Theta


def corex_from_numpy(state, **params) -> Corex:
    """A fitted `Corex(**params)` holding the arrays of `state` (a mapping
    such as an opened `.npz`), cast to the model dtype on the model device.
    A later `fit` warm-starts from the stored weights, as after the JAX
    package's `load_corex`."""
    model = Corex(**params)
    model.ws = model._as_tensor(state["ws"])
    model.theta = Theta(mean=model._as_tensor(state["theta_mean"]),
                        std=model._as_tensor(state["theta_std"]))
    model.moments = Moments(**{name: model._as_tensor(state[f"mom_{name}"])
                               for name in Moments._fields})
    model.nv = model.ws.shape[1]
    model._pretrained_ws = model.ws
    return model
