"""Preprocessing for Linear CorEx, as plain PyTorch functions.

Port of `linearcorex_tpu/ops/preprocessing.py`: 'none', 'standard',
'outliers' and 'empirical' gaussianization plus sentinel-value mean
imputation. Theta (mean, std) is fitted once and reapplied at transform
time; 'empirical' ranks each batch it is given, at fit and at transform
time alike, as the JAX package does.

Under a sample-sharding plan (`parallel.sharding`) every function here
takes `axes`: the mesh axes (`parallel.collectives.Axis`, outermost first)
that the rows of `x` are split over, `x` being this rank's row block.
Column statistics then come from per-rank sums added over those axes (the
mean first, then the centred second moment); 'empirical' ranks whole
columns, gathered one column block at a time so that no rank ever holds
more than n x ceil(p/ranks) gathered values. Axes that hold one block in
all (a world of one rank) reduce nothing: that block is the whole X and
its statistics are the single-device ones, bit for bit.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from linearcorex_tpu_torch.parallel.collectives import (all_gather_rows,
                                                        all_reduce,
                                                        shard_count,
                                                        shard_index)


class Theta(NamedTuple):
    """Fitted preprocessing statistics."""

    mean: torch.Tensor  # p
    std: torch.Tensor   # p


def mean_impute(x: torch.Tensor, missing_values: float,
                axes=()) -> torch.Tensor:
    """Replace sentinel entries by the per-column mean of observed entries
    (over every rank's rows, when split over `axes`). Columns with no
    observed entries impute to 0. A NaN sentinel is matched with isnan."""
    if isinstance(missing_values, float) and math.isnan(missing_values):
        mask = torch.isnan(x)
    else:
        mask = x == missing_values
    cnt = torch.sum(~mask, dim=0)
    total = torch.sum(torch.where(mask, 0.0, x), dim=0)
    if shard_count(axes) > 1:
        cnt = all_reduce(cnt, axes[::-1])
        total = all_reduce(total, axes[::-1])
    col_mean = torch.where(cnt > 0, total / torch.clamp(cnt, min=1), 0.0)
    return torch.where(mask, col_mean[None, :].to(x.dtype), x)


def fit_theta(x: torch.Tensor, axes=()) -> Theta:
    if shard_count(axes) > 1:
        n = x.shape[0] * shard_count(axes)
        mean = all_reduce(torch.sum(x, dim=0), axes[::-1]) / n
        var = all_reduce(torch.sum((x - mean[None, :]) ** 2, dim=0),
                         axes[::-1]) / n
        std = torch.sqrt(var)
    else:
        mean = torch.mean(x, dim=0)
        std = torch.std(x, dim=0, correction=0)
    std = torch.where(std < 1e-10, 1.0, std)
    return Theta(mean=mean, std=std)


def soft_clip(z: torch.Tensor, t: float = 4.0) -> torch.Tensor:
    """Bounded transform of |z|>t ('outliers' mode): heavy tails stop
    dominating second moments but ordering is preserved."""
    return torch.where(torch.abs(z) < t, z,
                       torch.sign(z) * (t + torch.tanh(torch.abs(z) - t)))


def rankdata_average(x: torch.Tensor) -> torch.Tensor:
    """Average-tie ranks of each column of x (n, p), float64
    (scipy.stats.rankdata per column): rank = (#less + #less_or_equal +
    1)/2, from one sort and two binary searches per column. Works in
    (p, n) layout, as `torch.searchsorted` searches the last dimension."""
    xt = x.T.contiguous()
    s = torch.sort(xt, dim=1).values
    lo = torch.searchsorted(s, xt, side="left")
    hi = torch.searchsorted(s, xt, side="right")
    return (0.5 * (lo + hi + 1).to(torch.float64)).T


def empirical_gaussianize(x: torch.Tensor, axes=()) -> torch.Tensor:
    """Rank-based gaussianization: Φ⁻¹((rank − 0.5)/n) per column,
    computed in float64 and returned in x's dtype and row-major layout.
    Rows split over `axes`: ranks are over the whole column (see the
    module docstring), so the values are those of the single-device call
    on the whole X."""
    d = shard_count(axes)
    if d > 1:
        rows, p = x.shape
        first = shard_index(axes) * rows
        width = -(-p // d)
        out = torch.empty_like(x)
        for c0 in range(0, p, width):
            cols = all_gather_rows(x[:, c0:c0 + width], axes)
            out[:, c0:c0 + width] = empirical_gaussianize(cols)[
                first:first + rows]
        return out
    n = x.shape[0]
    return torch.special.ndtri((rankdata_average(x) - 0.5) / n).to(
        x.dtype).contiguous()


def preprocess(x: torch.Tensor, gaussianize: str, theta: Theta,
               missing_values: Optional[float] = None,
               axes=()) -> torch.Tensor:
    """Apply the fitted preprocessing (transform-time path)."""
    if missing_values is not None:
        x = mean_impute(x, missing_values, axes)
    if gaussianize == "none":
        return x
    if gaussianize == "empirical":
        return empirical_gaussianize(x, axes)
    z = (x - theta.mean[None, :]) / theta.std[None, :]
    if gaussianize == "standard":
        return z
    return soft_clip(z)


def fit_preprocess(x: torch.Tensor, gaussianize: str,
                   missing_values: Optional[float] = None, axes=()):
    """Fit theta on x and return (x_preprocessed, theta)."""
    if missing_values is not None:
        x = mean_impute(x, missing_values, axes)
    if gaussianize == "none":
        p = x.shape[1]
        theta = Theta(mean=x.new_zeros(p), std=x.new_ones(p))
        return x, theta
    theta = fit_theta(x, axes)
    if gaussianize == "empirical":
        return empirical_gaussianize(x, axes), theta
    z = (x - theta.mean[None, :]) / theta.std[None, :]
    if gaussianize == "standard":
        return z, theta
    return soft_clip(z), theta


def invert(z: torch.Tensor, theta: Theta) -> torch.Tensor:
    """Undo the affine part of the preprocessing."""
    return z * theta.std[None, :] + theta.mean[None, :]
