"""The benchmark of linearcorex_tpu_torch, the PyTorch + CUDA port of
Linear CorEx, on one NVIDIA H100: user fits at the north-star and omics
shapes, judged against a float64 reference. `run.py` is the command;
`BENCHMARK.json` at the checkout's root lists the cells and metrics.

Nothing here imports JAX or the JAX package `linearcorex_tpu`.
"""
