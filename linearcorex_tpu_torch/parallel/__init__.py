"""Parallel execution of the PyTorch port.

- `restarts`: k fits run as lanes of one solve, on one device or split
  over a mesh's `restarts` axis.
- `sharding`: fits over a `torch.distributed` device mesh with the
  samples, the variables and the factors split per a `ShardingPlan`
  (plans, meshes, `fit_sharded`, `fit_shard_map`); its docstring states
  the model of execution.
- `collectives`: every cross-rank sum, maximum and gather, counted.
- `launch`: start a local world of ranks that run one function.
"""
