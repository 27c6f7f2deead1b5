"""linearcorex_tpu_torch — Linear CorEx in PyTorch, with a hand-written
CUDA kernel for the fused moment chain, for NVIDIA Hopper (H100).

The port of the JAX package `linearcorex_tpu`, which stays the reference.
It imports torch and never JAX. Usage:

    import linearcorex_tpu_torch as lct
    c = lct.Corex(n_hidden=8, seed=0).fit(x)          # device="cuda"
    y = c.transform(x)
    c.tc, c.tcs, c.mis, c.clusters
    best = lct.Corex(n_hidden=8, n_restarts=4, seed=0).fit(x)  # 4 lanes
    n, scores = lct.pick_n_hidden(x, repeat=4, max_n_hidden=8, seed=0)
    acc = lct.GramAccumulator(p)                      # streaming moments
    for batch in stream: acc.update(batch)
    c = acc.fit(n_hidden=8, seed=0)
    lct.save_corex(c, "model.npz"); c = lct.load_corex("model.npz")
    s = lct.StackedCorex([8, 2], seed=0).fit(x)       # a hierarchy
    lct.Corex(n_hidden=8, seed=0).warmup(*x.shape)    # at deploy time:
    lct.warmup_serving(lct.load_corex("model.npz"), 4096)  # build, load

Over several devices (one process per device, `torch.distributed`):

    from linearcorex_tpu_torch.parallel.sharding import make_mesh
    c = lct.Corex(n_hidden=8, seed=0).fit(x, mesh=make_mesh())  # every rank
"""

from linearcorex_tpu_torch.config import CorexConfig, PreprocessConfig
from linearcorex_tpu_torch.models.corex import Corex, NotFittedError
from linearcorex_tpu_torch.models.selection import (pick_n_hidden,
                                                    warmup_sweep)
from linearcorex_tpu_torch.models.stacked import StackedCorex
from linearcorex_tpu_torch.ops.moments import (QuantizedData, quantize_gram,
                                               quantize_samples)
from linearcorex_tpu_torch.utils.checkpoint import load_corex, save_corex
from linearcorex_tpu_torch.utils.compile_cache import (ensure_compile_cache,
                                                       warmup_fit,
                                                       warmup_serving)
from linearcorex_tpu_torch.utils.interop import corex_from_numpy
from linearcorex_tpu_torch.utils.streaming import (GramAccumulator, fit_csv,
                                                   fit_from_covariance)

__version__ = "0.4.0"

__all__ = [
    "__version__",
    "Corex",
    "CorexConfig",
    "GramAccumulator",
    "NotFittedError",
    "PreprocessConfig",
    "QuantizedData",
    "StackedCorex",
    "corex_from_numpy",
    "ensure_compile_cache",
    "fit_csv",
    "fit_from_covariance",
    "load_corex",
    "pick_n_hidden",
    "quantize_gram",
    "quantize_samples",
    "save_corex",
    "warmup_fit",
    "warmup_serving",
    "warmup_sweep",
]
