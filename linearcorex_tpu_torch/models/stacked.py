"""Stacked (multi-layer) Linear CorEx.

Port of `linearcorex_tpu/models/stacked.py`. Hierarchical
factor discovery fits a second Corex on the first layer's latent factors.
Layers are sequential fits, so this is composition at the API level: `fit`
trains layer k on layer k-1's `transform` output; `transform` composes
the projections; `predict` runs the posterior-mean reconstructions back
down the stack. The factors handed from layer to layer stay tensors on
the layers' device (the layers' private `_transform`/`_predict`): a NumPy
input is copied to the device once, by layer 1, and the result read back
once, at the end (`models.corex.as_kind`). Outputs and fitted attributes
follow the kind of their input, as `Corex`'s do.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

from linearcorex_tpu_torch.models.corex import Corex, as_kind, input_kind

__all__ = ["StackedCorex"]


class StackedCorex:
    """A stack of Corex layers; layer k fits the factors of layer k-1.

    Layer 1 takes the user's preprocessing options; deeper layers always
    standardize their (already continuous, roughly Gaussian) factor
    inputs. Every other argument, `device` included, reaches every layer.
    `mesh`/`sharding_plan` reach every layer's fit and serving calls; the
    plan's `var` and factor axes apply to layer 1 only (`_layer_plan`).
    """

    def __init__(self, n_hiddens: Sequence[int], **corex_kwargs):
        if not n_hiddens:
            raise ValueError("n_hiddens must be non-empty")
        self.layers: List[Corex] = []
        deep_kwargs = dict(corex_kwargs)
        deep_kwargs["gaussianize"] = "standard"
        deep_kwargs.pop("missing_values", None)
        for k, m in enumerate(n_hiddens):
            self.layers.append(
                Corex(n_hidden=m, **(corex_kwargs if k == 0
                                     else deep_kwargs)))

    @staticmethod
    def _layer_plan(plan, k):
        """The plan of layer k: the plan's `var` and factor axes describe
        the p-wide operand of layer 1 only. Deeper layers take narrow (n,
        m_k) factor matrices that need not divide those mesh extents (and
        gain nothing from them), so they keep just the sample axes, which
        divide by construction (n is the same down the stack)."""
        if k == 0 or plan is None or not (plan.shard_vars
                                          or plan.shard_factors):
            return plan
        return dataclasses.replace(plan, shard_vars=False,
                                   shard_factors=False)

    def fit(self, x, y=None, mesh=None, sharding_plan=None):
        """Fit layer by layer; `y` is accepted and ignored (unsupervised:
        the sklearn slot, as in `Corex.fit`). `mesh`/`sharding_plan` reach
        each layer's `Corex.fit(mesh=...)` and the transform between
        layers, so a `shard_vars` stack never holds the p-wide X whole on
        one device."""
        del y
        data = x
        for k, layer in enumerate(self.layers):
            lp = self._layer_plan(sharding_plan, k)
            layer.fit(data, mesh=mesh, sharding_plan=lp)
            if mesh is not None and sharding_plan is None \
                    and layer._serving_plan is None:
                # a restart-only sweep: the mesh carries no serving axes,
                # so the transform between layers runs on each rank's own
                # device, as Corex.fit_transform does; an explicit plan is
                # honored (and fails its validation by name)
                data = layer._transform(data)
            else:
                data = layer._transform(data, mesh=mesh, sharding_plan=lp)
        for layer in self.layers:   # every layer reports in x's kind
            layer._fit_kind = input_kind(x)
        return self

    def transform(self, x, level: int = -1, mesh=None, sharding_plan=None):
        """Factors at `level` (default: the deepest layer); `mesh` serves
        each layer's projection over the mesh (`Corex.transform`)."""
        levels = range(len(self.layers)) if level == -1 \
            else range(level + 1)
        data = x
        for k in levels:
            data = self.layers[k]._transform(
                data, mesh=mesh,
                sharding_plan=self._layer_plan(sharding_plan, k))
        return as_kind(data, input_kind(x))

    def fit_transform(self, x, y=None, mesh=None, sharding_plan=None):
        """sklearn convention: fit the stack, return the deepest factors
        (`y` ignored); `mesh`/`sharding_plan` reach the fit and the final
        transform."""
        del y
        self.fit(x, mesh=mesh, sharding_plan=sharding_plan)
        if mesh is not None and sharding_plan is None and all(
                layer._serving_plan is None for layer in self.layers):
            # a restart-only sweep (see fit): transform on each rank
            return self.transform(x)
        return self.transform(x, mesh=mesh, sharding_plan=sharding_plan)

    def transform_all(self, x, mesh=None, sharding_plan=None):
        """List of factor matrices, one per layer (shallow → deep)."""
        out, data = [], x
        for k, layer in enumerate(self.layers):
            data = layer._transform(
                data, mesh=mesh,
                sharding_plan=self._layer_plan(sharding_plan, k))
            out.append(data)
        return as_kind(out, input_kind(x))

    def predict(self, y, mesh=None, sharding_plan=None):
        """Reconstruct the input from the deepest factors. Under `mesh`
        the (n, p) reconstruction comes back per the plan
        (`Corex.predict`: a `DTensor` split over `var` under `shard_vars`)."""
        data = y
        last = len(self.layers) - 1
        for i, layer in enumerate(reversed(self.layers)):
            data = layer._predict(
                data, mesh=mesh,
                sharding_plan=self._layer_plan(sharding_plan, last - i))
        return as_kind(data, input_kind(y))

    def inverse_transform(self, y, mesh=None, sharding_plan=None):
        """sklearn spelling of `predict`: deepest factors → input space."""
        return self.predict(y, mesh=mesh, sharding_plan=sharding_plan)

    @property
    def tcs(self):
        """Per-layer per-factor TC, of the kind of the fit's input."""
        return [layer.tcs for layer in self.layers]

    @property
    def tc(self):
        """Total TC explained, summed over layers (the stacked objective's
        additive decomposition)."""
        return float(sum(layer.tc for layer in self.layers))

    @property
    def clusters(self):
        """Per-layer hard cluster assignments; clusters[0] assigns input
        variables to layer-1 factors, clusters[k] assigns layer-k factors
        to layer-(k+1) factors."""
        return [layer.clusters for layer in self.layers]
