"""The generator of fit traffic: a closed loop with one client, the way a
user fits. A mix in `traffic/` that names it holds one parameter,
`estimator_kwargs`: the estimator's arguments besides `n_hidden` (the
configuration's) and `seed` (drawn per fit), e.g. {} for the library's
defaults, {"preset": "throughput"} or {"n_restarts": 4}.

Set-up: the configuration's data as a float32 tensor on the card, made
from the run's seed, and the library's own warm-up of the call at the
data's shape (`Corex.warmup`: the fit's code at one iteration a stage,
the same work whatever the seed), which builds or loads the chain kernel
and warms cuBLAS, cuSOLVER and the graph capture.

The window: back-to-back fits, each of a fresh `Corex(**estimator_kwargs,
seed=s).fit(x)`, synchronised after each fit; it runs whole fits until
`seconds` have passed and ends when the fit in progress ends. The seeds
come from the run's seed (`datagen.fit_seeds`), so each fit starts from
its own W0. A traced run wraps the solver loop with spans
(`tracing.LoopSpans`) and profiles whole fits from the window's start
until `PROFILED_SECONDS` of them have been profiled.

A seeded reservoir keeps a uniform sample of `CHECKED_FITS` of the
window's fits (the fitted W, its C_xy, TC and the first entry of the TC
history, on the device), and the window keeps the fit with the highest
TC, for the comparison after the window (`compare.py`).
"""

from __future__ import annotations

import contextlib
import math
import random
import time
from typing import List, NamedTuple, Optional

CHECKED_FITS = 4
PROFILED_SECONDS = 1.0


class FitRecord(NamedTuple):
    seed: int
    wall_s: float
    loop_ms: float        # device ms of the solver loop (traced runs)
    iterations: int       # lockstep iterations (the solver's counter)
    first_evaluations: int
    bodies: int
    masked: int
    chain_launches: int
    chain_lane_launches: int
    profiled: bool        # run under the profiler (traced runs)


class Sample(NamedTuple):
    seed: int             # the fit's seed
    lane: int             # the restart lane the fit kept
    ws: object            # (m, p) fitted W, sorted
    c_xy: object          # (p, m) its cross moment at ε = 0
    tc: object            # () its TC
    first_tc: object      # () the TC history's first entry


class Window(NamedTuple):
    fits: List[FitRecord]
    failed: int
    wall_s: float
    samples: List[Sample]
    best: Optional[Sample]    # the fit with the highest TC
    trace: Optional[object]   # tracing.Trace of the profiled fits
    errors: List[str]

    @property
    def attempted(self) -> int:
        return len(self.fits) + self.failed


class State(NamedTuple):
    cell: dict
    kwargs: dict          # the estimator's arguments
    x: object             # (n, p) float32 data on the device
    device: str


def estimator_kwargs(config: dict, traffic: dict) -> dict:
    kw = dict(traffic["estimator_kwargs"])
    kw["n_hidden"] = config["n_hidden"]
    return kw


def setup(cell: dict, seed: int, device) -> State:
    import linearcorex_tpu_torch as lct
    from portbench import datagen
    kwargs = estimator_kwargs(cell["config"], cell["traffic"])
    x = datagen.make_data(cell["config"], seed, device)
    warm(lct, x, kwargs, device)
    return State(cell, kwargs, x, device)


def measure(state: State, seconds: float, seed: int, trace: bool):
    import torch
    import linearcorex_tpu_torch as lct
    from linearcorex_tpu_torch.models import corex as corex_module
    from portbench import datagen, tracing
    on_card = torch.device(state.device).type == "cuda"
    spans = tracing.LoopSpans(corex_module, torch, on_card) \
        if trace else None
    profile = tracing.Profile(torch) if trace and on_card else None
    with spans or contextlib.nullcontext():
        return run(lct, state.x, state.kwargs, datagen.fit_seeds(seed),
                   seconds, state.device, torch, sample_seed=seed,
                   spans=spans, profile=profile)


def values(state: State, window) -> dict:
    its = sum(f.iterations for f in window.fits)
    return {"fit_it_per_s": its / window.wall_s}


def shape(state: State):
    from portbench import compare, yardstick
    config = state.cell["config"]
    st = compare.settings(state.kwargs, *state.x.shape)
    return yardstick.Shape(
        n=config["n_samples"], p=config["n_variables"],
        m=config["n_hidden"], k=int(st["n_restarts"]),
        strategy=st["strategy"], optimizer=st["optimizer"],
        operand=st["matmul_dtype"])


def check(state: State, window) -> dict:
    from portbench import compare
    checks, _ = compare.check(state.x, state.cell["config"], state.kwargs,
                              window.samples, window.best,
                              state.cell["workload"]["limits"])
    return checks


def _counters(solver, chain):
    c = solver.counts
    return (c.iterations, c.first_evaluations, c.bodies, c.masked,
            chain.launches, chain.lane_launches)


def warm(lct, x, kwargs: dict, device):
    """The library's warm-up of the call at the data's shape: every
    kernel built and loaded, every handle made, before the window."""
    lct.Corex(**kwargs, seed=0, device=device).warmup(*x.shape)


def fit_once(lct, x, kwargs: dict, seed: int, device):
    """One user fit; returns the fitted estimator."""
    return lct.Corex(**kwargs, seed=seed, device=device).fit(x)


def run(lct, x, kwargs: dict, seeds, seconds: float, device, torch,
        sample_seed: int, spans=None, profile=None,
        n_samples: int = CHECKED_FITS) -> Window:
    """The measured window. `spans` (tracing.LoopSpans) and `profile`
    (tracing.Profile) only in a traced run: the profiler covers whole
    fits from the window's start until `PROFILED_SECONDS` of them have
    run, so that the trace stays small."""
    from linearcorex_tpu_torch.core import solver
    from linearcorex_tpu_torch.ops.cuda_moments import ns_chain
    from portbench.tracing import FIT_RANGE

    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    rng = random.Random(sample_seed)
    fits: List[FitRecord] = []
    samples: List[Sample] = []
    best, best_tc = None, -math.inf
    errors: List[str] = []
    failed = 0
    trace = None
    profiling = profile is not None     # until the profiler has stopped
    sync()
    if profiling:
        profile.start()
    t_start = time.perf_counter()
    while True:
        profiled = profiling
        if spans is not None:
            spans.profiled = profiled
        seed = next(seeds)
        before = _counters(solver, ns_chain)
        t0 = time.perf_counter()
        try:
            if profiled:
                with torch.profiler.record_function(FIT_RANGE):
                    model = fit_once(lct, x, kwargs, seed, device)
                    sync()
            else:
                model = fit_once(lct, x, kwargs, seed, device)
                sync()
        except Exception as e:   # a failed fit is counted, the loop goes on
            sync()
            failed += 1
            errors.append(f"fit seed {seed}: {type(e).__name__}: {e}")
            model = None
            if spans is not None:
                spans.take_ms()
        now = time.perf_counter()
        if model is not None:
            after = _counters(solver, ns_chain)
            d = [a - b for a, b in zip(after, before)]
            fits.append(FitRecord(seed, now - t0,
                                  spans.take_ms() if spans else 0.0, *d,
                                  profiled))
            _reservoir(rng, samples, n_samples, len(fits), model, seed)
            tc = float(model.moments.tc)
            if tc > best_tc:
                best, best_tc = sample_of(model, seed), tc
            del model
        if profiling and now - t_start >= PROFILED_SECONDS:
            profile.stop()
            profiling = False
        if now - t_start >= seconds:
            break
    wall_s = time.perf_counter() - t_start
    if profiling:
        profile.stop()
    if profile is not None:
        trace = profile.trace()
    return Window(fits, failed, wall_s, samples, best, trace, errors)


def _reservoir(rng, samples, k, count, model, seed):
    """Algorithm R: after `count` fits every fit is in `samples` with
    probability k/count. Decisions come from the run's seed only."""
    slot = len(samples) if len(samples) < k else rng.randrange(count)
    if slot >= k:
        return
    s = sample_of(model, seed)
    if slot == len(samples):
        samples.append(s)
    else:
        samples[slot] = s


def sample_of(model, seed: int) -> Sample:
    """What the comparison reads of a fitted estimator, copied."""
    return Sample(seed, int(model.best_restart_ or 0), model.ws.clone(),
                  model.moments.c_xy.clone(), model.moments.tc.clone(),
                  model.diagnostics.tc_history[0, 0].clone())
