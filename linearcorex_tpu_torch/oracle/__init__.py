"""Float64 NumPy oracle — the executable specification (SURVEY.md §7.0).

The port's own copy of `linearcorex_tpu.oracle`: NumPy and SciPy only, so
it runs on a machine with PyTorch and without JAX.
"""

from linearcorex_tpu_torch.oracle.oracle import (
    OracleCorex,
    anneal_schedule,
    calculate_moments,
    pick_n_hidden_oracle,
)

__all__ = [
    "OracleCorex",
    "anneal_schedule",
    "calculate_moments",
    "pick_n_hidden_oracle",
]
