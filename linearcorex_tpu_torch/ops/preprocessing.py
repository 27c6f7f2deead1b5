"""Preprocessing for Linear CorEx, as plain PyTorch functions.

Port of `linearcorex_tpu/ops/preprocessing.py`: 'none', 'standard' and
'outliers' gaussianization plus sentinel-value mean imputation. Theta
(mean, std) is fitted once and reapplied at transform time. The rank-based
'empirical' mode is not ported yet (ROADMAP.md Queue 1, item 2).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch


class Theta(NamedTuple):
    """Fitted preprocessing statistics."""

    mean: torch.Tensor  # p
    std: torch.Tensor   # p


def _empirical_not_ported():
    raise NotImplementedError(
        "gaussianize='empirical' is not ported to the PyTorch package yet "
        "(ROADMAP.md Queue 1, item 2); use 'standard', 'outliers' or "
        "'none', or the JAX package linearcorex_tpu")


def mean_impute(x: torch.Tensor, missing_values: float) -> torch.Tensor:
    """Replace sentinel entries by the per-column mean of observed entries.
    Columns with no observed entries impute to 0. A NaN sentinel is
    matched with isnan."""
    if isinstance(missing_values, float) and math.isnan(missing_values):
        mask = torch.isnan(x)
    else:
        mask = x == missing_values
    cnt = torch.sum(~mask, dim=0)
    total = torch.sum(torch.where(mask, 0.0, x), dim=0)
    col_mean = torch.where(cnt > 0, total / torch.clamp(cnt, min=1), 0.0)
    return torch.where(mask, col_mean[None, :].to(x.dtype), x)


def fit_theta(x: torch.Tensor) -> Theta:
    mean = torch.mean(x, dim=0)
    std = torch.std(x, dim=0, correction=0)
    std = torch.where(std < 1e-10, 1.0, std)
    return Theta(mean=mean, std=std)


def soft_clip(z: torch.Tensor, t: float = 4.0) -> torch.Tensor:
    """Bounded transform of |z|>t ('outliers' mode): heavy tails stop
    dominating second moments but ordering is preserved."""
    return torch.where(torch.abs(z) < t, z,
                       torch.sign(z) * (t + torch.tanh(torch.abs(z) - t)))


def preprocess(x: torch.Tensor, gaussianize: str, theta: Theta,
               missing_values: Optional[float] = None) -> torch.Tensor:
    """Apply the fitted preprocessing (transform-time path)."""
    if gaussianize == "empirical":
        _empirical_not_ported()
    if missing_values is not None:
        x = mean_impute(x, missing_values)
    if gaussianize == "none":
        return x
    z = (x - theta.mean[None, :]) / theta.std[None, :]
    if gaussianize == "standard":
        return z
    return soft_clip(z)


def fit_preprocess(x: torch.Tensor, gaussianize: str,
                   missing_values: Optional[float] = None):
    """Fit theta on x and return (x_preprocessed, theta)."""
    if gaussianize == "empirical":
        _empirical_not_ported()
    if missing_values is not None:
        x = mean_impute(x, missing_values)
    if gaussianize == "none":
        p = x.shape[1]
        theta = Theta(mean=x.new_zeros(p), std=x.new_ones(p))
        return x, theta
    theta = fit_theta(x)
    z = (x - theta.mean[None, :]) / theta.std[None, :]
    if gaussianize == "standard":
        return z, theta
    return soft_clip(z), theta


def invert(z: torch.Tensor, theta: Theta) -> torch.Tensor:
    """Undo the affine part of the preprocessing."""
    return z * theta.std[None, :] + theta.mean[None, :]
