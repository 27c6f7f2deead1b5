"""Static configuration of one Linear CorEx solve (PyTorch port).

A copy, not an import, of `linearcorex_tpu/config.py`: importing that
module would run the JAX package's `__init__`, which imports JAX. Field
names, defaults, validation and the schedule helpers are identical, so a
configuration means the same thing in both packages (the tests pin the
fields and defaults to the JAX dataclass). The measured notes behind the
defaults live beside the JAX copy; they were taken on a TPU and say
nothing about this port's speed.

One difference: `use_pallas='interpret'` (the Pallas interpreter of the
JAX package) is rejected by name. On a CUDA device 'always' runs the
hand-written chain kernel; on the CPU it runs the kernel's plain PyTorch
twin.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# Named hyperparameter bundles for `Corex(preset=...)`: each maps
# constructor parameters to the preset's DEFAULT values; a parameter the
# user sets to a non-default value wins (see `apply_preset`).
PRESETS = {
    "reference": {},
    "throughput": {
        "matmul_dtype": "int8",
        "init": "spectral",
        "anneal": False,
        "tol": 1e-4,
        "optimizer": "auto",
    },
}


def apply_preset(preset: str, user_set: dict) -> dict:
    """Merge `user_set` (parameters the caller explicitly chose) over the
    preset's values. Returns a dict covering the preset's keys plus
    everything in `user_set`; raises on an unknown preset."""
    try:
        overrides = PRESETS[preset]
    except (KeyError, TypeError):
        raise ValueError(
            f"unknown preset: {preset!r} (expected one of "
            f"{tuple(PRESETS)})") from None
    out = dict(user_set)
    for k, v in overrides.items():
        out.setdefault(k, v)
    return out


@dataclasses.dataclass(frozen=True)
class CorexConfig:
    """Hyperparameters of one Linear CorEx solve (hashable, immutable).

    Mirrors `linearcorex_tpu.config.CorexConfig` field for field.
    """

    n_hidden: int = 10
    max_iter: int = 10000
    tol: float = 1e-5
    anneal: bool = True
    discourage_overlap: bool = True
    y_scale: float = 1.0
    # 'float32' (the device dtype) or 'float64' (oracle-parity runs).
    dtype: str = "float32"
    # Operand type of the big moment GEMMs: 'float32', 'bfloat16' (bf16
    # operands, float32 products) or 'int8' (quantized operand, int32
    # products; needs dtype='float32' and the non-overlap path).
    matmul_dtype: str = "float32"
    # 'default' and 'highest' both run float32 matmuls at full float32
    # (never TF32) in the port.
    matmul_precision: str = "default"
    # 'samples' = Xᵀ(X·Wᵀ)/n; 'gram' = Σ·Wᵀ with Σ = XᵀX/n built once;
    # 'auto' picks per shapes (`pick_strategy`).
    moment_strategy: str = "auto"
    gram_max_p: int = 20000
    # The fused chain kernel: 'always' routes the non-overlap moment
    # chain through `ops.cuda_moments.ns_chain`, 'never' keeps the plain
    # PyTorch chain, 'auto' is resolved per device by
    # `models.corex.resolve_config`.
    use_pallas: str = "auto"
    # 'momentum' (heavy-ball), 'gd', 'fixed_point' (damped closed-form
    # update), or 'auto' (fixed_point when n >= p on the non-overlap
    # path, else momentum).
    optimizer: str = "momentum"
    momentum_beta: float = 0.9
    init: str = "random"
    # Tolerance multiplier for the non-final anneal stages.
    stage_tol_factor: float = 1.0
    # Row-subsample fraction for the non-final anneal stages (samples
    # strategy; the final stage always runs on the full data).
    stage_subsample: float = 1.0
    lr_init: float = 0.05
    lr_growth: float = 1.1
    lr_cap: float = 2.0
    lr_halve: float = 0.5
    lr_min: float = 1e-14
    # fixed_point damping γ ∈ (0, 1]: W ← (1−γ)W + γŴ.
    fp_gamma_init: float = 0.5
    fp_gamma_cap: float = 1.0
    rho_clip: float = 1.0 - 1e-6
    record_history: bool = True
    # When set, the fit runs exactly this eps schedule (a scalar = one
    # stage, a tuple = several).
    eps_override: Optional[float] = None

    def __post_init__(self):
        import numbers
        for name in ("tol", "y_scale", "momentum_beta", "lr_init",
                     "lr_growth", "lr_cap", "lr_halve", "lr_min",
                     "fp_gamma_init", "fp_gamma_cap", "rho_clip",
                     "stage_tol_factor", "stage_subsample"):
            v = getattr(self, name)
            if not isinstance(v, numbers.Real):
                raise TypeError(
                    f"{name} must be a real scalar, got "
                    f"{type(v).__name__} ({v!r}) — every CorexConfig field "
                    f"must stay hashable")
        for name in ("n_hidden", "max_iter", "gram_max_p"):
            v = getattr(self, name)
            if not isinstance(v, numbers.Integral):
                raise TypeError(
                    f"{name} must be an integer, got {type(v).__name__} "
                    f"({v!r})")
        if self.eps_override is not None:
            ok_scalar = isinstance(self.eps_override, numbers.Real)
            ok_tuple = (isinstance(self.eps_override, tuple)
                        and len(self.eps_override) >= 1
                        and all(isinstance(e, numbers.Real)
                                for e in self.eps_override))
            if not (ok_scalar or ok_tuple):
                raise TypeError(
                    f"eps_override must be a real scalar, a non-empty "
                    f"tuple of real scalars, or None, got "
                    f"{type(self.eps_override).__name__}")
        if self.max_iter < 1:
            raise ValueError(f"max_iter must be >= 1, got {self.max_iter}")
        if self.stage_tol_factor < 1.0:
            raise ValueError(
                f"stage_tol_factor must be >= 1.0 (it LOOSENS the "
                f"non-final anneal stages; 1.0 = reference-parity "
                f"per-stage convergence), got {self.stage_tol_factor}")
        if not (0.0 < self.stage_subsample <= 1.0):
            raise ValueError(
                f"stage_subsample must be in (0, 1] (the fraction of "
                f"sample rows the non-final anneal stages run on; 1.0 = "
                f"reference-parity full-data stages), got "
                f"{self.stage_subsample}")
        if self.n_hidden < 1:
            raise ValueError(f"n_hidden must be >= 1, got {self.n_hidden}")
        if self.moment_strategy not in ("auto", "samples", "gram"):
            raise ValueError(
                f"unknown moment_strategy: {self.moment_strategy!r} "
                f"(expected 'auto', 'samples' or 'gram')")
        if self.optimizer not in ("auto", "momentum", "gd", "fixed_point"):
            raise ValueError(
                f"unknown optimizer: {self.optimizer!r} (expected 'auto', "
                f"'momentum', 'gd' or 'fixed_point')")
        if self.optimizer == "fixed_point" and not self.discourage_overlap:
            raise ValueError(
                "optimizer='fixed_point' implements the non-overlap "
                "closed-form update; use 'momentum'/'gd' with "
                "discourage_overlap=False")
        if self.init not in ("random", "spectral"):
            raise ValueError(
                f"unknown init: {self.init!r} (expected 'random' or "
                f"'spectral')")
        if self.init == "spectral" and self.anneal and self.n_hidden > 1 \
                and self.discourage_overlap:
            import warnings
            warnings.warn(
                "init='spectral' with anneal=True: the JAX package "
                "measured this harmful on strong-structure data at scale "
                "(the early high-eps stages scramble the aligned init) — "
                "pair spectral with anneal=False")
        if self.use_pallas == "interpret":
            raise ValueError(
                "use_pallas='interpret' runs the JAX package's Pallas "
                "interpreter and has no counterpart in the PyTorch port: "
                "use 'always' (the CUDA chain kernel on a CUDA device, its "
                "plain PyTorch twin on the CPU), 'never' or 'auto'")
        if self.use_pallas not in ("auto", "always", "never"):
            raise ValueError(
                f"unknown use_pallas: {self.use_pallas!r} (expected 'auto', "
                f"'always' or 'never')")
        if self.matmul_dtype not in ("float32", "bfloat16", "int8"):
            raise ValueError(
                f"unknown matmul_dtype: {self.matmul_dtype!r} (expected "
                f"'float32', 'bfloat16' or 'int8')")
        if self.matmul_dtype == "int8":
            if not self.discourage_overlap:
                raise ValueError(
                    "matmul_dtype='int8' supports the non-overlap solver "
                    "path only")
            if self.dtype != "float32":
                raise ValueError(
                    "matmul_dtype='int8' requires dtype='float32' (the "
                    "quantization noise floor is far above float64 "
                    "parity tolerances)")

    def anneal_schedule(self) -> Tuple[float, ...]:
        """Annealing eps schedule: geometric 0.6**k ending in exact 0;
        only for the multi-factor non-overlap solver."""
        if self.eps_override is not None:
            if isinstance(self.eps_override, tuple):
                return tuple(float(e) for e in self.eps_override)
            return (self.eps_override,)
        if self.anneal and self.n_hidden > 1 and self.discourage_overlap:
            return tuple(0.6 ** k for k in range(1, 7)) + (0.0,)
        return (0.0,)

    def tol_schedule(self) -> Tuple[float, ...]:
        """Per-stage convergence tolerances, aligned with
        `anneal_schedule()`: every stage but the last runs at
        tol x stage_tol_factor; the final stage always runs at `tol`."""
        n_stages = len(self.anneal_schedule())
        return ((self.tol * self.stage_tol_factor,) * (n_stages - 1)
                + (self.tol,))

    def pick_strategy(self, n: int, p: int) -> str:
        if self.moment_strategy != "auto":
            return self.moment_strategy
        if p <= self.gram_max_p and 2 * n >= p:
            return "gram"
        return "samples"


@dataclasses.dataclass(frozen=True)
class PreprocessConfig:
    """Preprocessing options: gaussianize mode + missing value
    sentinel."""

    gaussianize: str = "standard"
    missing_values: Optional[float] = None

    def __post_init__(self):
        if self.gaussianize not in ("none", "standard", "outliers",
                                    "empirical"):
            raise ValueError(
                f"unknown gaussianize mode: {self.gaussianize!r}")
