"""Stacked (multi-layer) Linear CorEx.

Port of `linearcorex_tpu/models/stacked.py`, single-device. Hierarchical
factor discovery fits a second Corex on the first layer's latent factors.
Layers are sequential fits, so this is composition at the API level: `fit`
trains layer k on layer k-1's `transform` output; `transform` composes
the projections; `predict` runs the posterior-mean reconstructions back
down the stack. The factors handed from layer to layer stay tensors on
the layers' device.
"""

from __future__ import annotations

from typing import List, Sequence

from linearcorex_tpu_torch.models.corex import Corex, _no_mesh

__all__ = ["StackedCorex"]


class StackedCorex:
    """A stack of Corex layers; layer k fits the factors of layer k-1.

    Layer 1 takes the user's preprocessing options; deeper layers always
    standardize their (already continuous, roughly Gaussian) factor
    inputs. Every other argument, `device` included, reaches every layer.
    `mesh`/`sharding_plan` belong to the JAX package's sharded layers and
    raise NotImplementedError.
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

    def fit(self, x, y=None, mesh=None, sharding_plan=None):
        """Fit layer by layer; `y` is accepted and ignored (unsupervised:
        the sklearn slot, as in `Corex.fit`)."""
        del y
        _no_mesh("StackedCorex.fit", mesh, sharding_plan)
        data = x
        for layer in self.layers:
            layer.fit(data)
            data = layer.transform(data)
        return self

    def transform(self, x, level: int = -1, mesh=None, sharding_plan=None):
        """Factors at `level` (default: the deepest layer)."""
        _no_mesh("StackedCorex.transform", mesh, sharding_plan)
        levels = range(len(self.layers)) if level == -1 \
            else range(level + 1)
        data = x
        for k in levels:
            data = self.layers[k].transform(data)
        return data

    def fit_transform(self, x, y=None, mesh=None, sharding_plan=None):
        """sklearn convention: fit the stack, return the deepest factors
        (`y` ignored)."""
        del y
        self.fit(x, mesh=mesh, sharding_plan=sharding_plan)
        return self.transform(x)

    def transform_all(self, x, mesh=None, sharding_plan=None):
        """List of factor matrices, one per layer (shallow → deep)."""
        _no_mesh("StackedCorex.transform_all", mesh, sharding_plan)
        out, data = [], x
        for layer in self.layers:
            data = layer.transform(data)
            out.append(data)
        return out

    def predict(self, y, mesh=None, sharding_plan=None):
        """Reconstruct the input from the deepest factors."""
        _no_mesh("StackedCorex.predict", mesh, sharding_plan)
        data = y
        for layer in reversed(self.layers):
            data = layer.predict(data)
        return data

    def inverse_transform(self, y, mesh=None, sharding_plan=None):
        """sklearn spelling of `predict`: deepest factors → input space."""
        return self.predict(y, mesh=mesh, sharding_plan=sharding_plan)

    @property
    def tcs(self):
        """Per-layer tensors of per-factor TC."""
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
