"""linearcorex_tpu_torch — Linear CorEx in PyTorch, with a hand-written
CUDA kernel for the fused moment chain, for NVIDIA Hopper (H100).

The port of the JAX package `linearcorex_tpu`, which stays the reference.
It imports torch and never JAX. Usage:

    import linearcorex_tpu_torch as lct
    c = lct.Corex(n_hidden=8, seed=0).fit(x)          # device="cuda"
    y = c.transform(x)
    c.tc, c.tcs, c.mis, c.clusters
"""

from linearcorex_tpu_torch.config import CorexConfig, PreprocessConfig
from linearcorex_tpu_torch.models.corex import Corex, NotFittedError
from linearcorex_tpu_torch.utils.interop import corex_from_numpy

__all__ = [
    "Corex",
    "CorexConfig",
    "PreprocessConfig",
    "NotFittedError",
    "corex_from_numpy",
]
