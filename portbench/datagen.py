"""The configurations' data, made on the device from the run's seed.

`block_data` is the north-star generator (a copy of `chip_smoke.py`'s,
itself `bench.py`'s): p variables in `blocks` equal blocks, each driven by
one latent factor with loading 0.9, plus noise of scale 0.436, drawn from
one seeded `torch.Generator` in two calls. The fit seeds are drawn from
the run's seed on the host.
"""

from __future__ import annotations

import numpy as np
import torch


def block_data(n: int, p: int, blocks: int, loading: float, noise: float,
               seed: int, device) -> torch.Tensor:
    """(n, p) float32 block data on `device` from `seed`."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    z = torch.randn((n, blocks), generator=gen, device=device)
    e = torch.randn((n, p), generator=gen, device=device)
    return torch.repeat_interleave(z, p // blocks, dim=1) * loading \
        + noise * e


def make_data(cfg: dict, seed: int, device) -> torch.Tensor:
    """The configuration's data matrix for a run seeded `seed`."""
    d = cfg["data"]
    if d["generator"] != "block":
        raise ValueError(f"unknown data generator {d['generator']!r}")
    return block_data(cfg["n_samples"], cfg["n_variables"], d["blocks"],
                      d["loading"], d["noise"], seed, device)


def fit_seeds(seed: int):
    """An endless stream of fit seeds drawn from the run's seed: each fit
    of the window starts from its own W0, as restarts by hand do. Each is
    below 2**31 - 16, so a restart sweep's lanes (seed + r) stay valid
    NumPy seeds."""
    rng = np.random.default_rng([int(seed), 0x5EED])
    while True:
        yield int(rng.integers(0, 2 ** 31 - 16))
