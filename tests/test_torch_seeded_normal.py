"""The seeded draws of the port's starts (`ops.seeded`, the host
library's `csrc/seeded_normal.cpp`): bit for bit NumPy's legacy
`RandomState(seed).normal(loc, scale, size)` at every seed, size and
dtype a fit draws, on one thread or many, through the library or its
NumPy fallback; and the fit's use of them: the draw a seeded fit begins
at its entry is the one its start takes, a fit that raises leaves no
drawing thread behind, and a warm start begins none.
"""

import ctypes
import math
import os
import threading

import numpy as np
import pytest
import torch

import linearcorex_tpu_torch as lct
from linearcorex_tpu_torch.models import corex as C
from linearcorex_tpu_torch.ops import seeded
from linearcorex_tpu_torch.parallel import restarts as R
from linearcorex_tpu_torch.parallel.restarts import init_restarts
from linearcorex_tpu_torch.utils import native

torch.set_num_threads(1)

needs_library = pytest.mark.skipif(
    not seeded.load(), reason=f"NumPy serves the draws: "
    f"{seeded.fallback_reason}")

SEEDS = (0, 1, 7, 2**31 - 1, 2**32 - 1)
SIZES = (1, 2, 623, 625, 1000, 999, (10000, 512), (512, 10000))
DTYPES = {"float32": torch.float32, "float64": torch.float64,
          "bfloat16": torch.bfloat16}

_numpy_draws = {}


def numpy_draw(seed, size, loc, scale):
    """NumPy's draw, kept for the other dtypes of the same case."""
    key = (seed, size, loc, scale)
    if key not in _numpy_draws:
        _numpy_draws.clear()
        _numpy_draws[key] = np.random.RandomState(seed).normal(
            loc=loc, scale=scale, size=size)
    return _numpy_draws[key]


_AS_INT = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def bitwise(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.view(_AS_INT[a.element_size()]), b.view(_AS_INT[b.element_size()]))


def _scale(size):
    """The random init's scale, 1/sqrt(p), p the draw's last axis."""
    return 1.0 / np.sqrt(size[-1] if isinstance(size, tuple) else size)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("size", SIZES, ids=str)
@pytest.mark.parametrize("seed", SEEDS)
def test_draw_is_numpys(seed, size, dtype):
    """As NumPy's float64 draw cast to the dtype, as the fit casts it:
    float32 and float64 written directly, bfloat16 from float64."""
    scale = _scale(size)
    want = torch.as_tensor(numpy_draw(seed, size, 0.0, scale),
                           dtype=DTYPES[dtype])
    shape = size if isinstance(size, tuple) else (size,)
    got = seeded.seeded_normal(seed, shape, 0.0, scale, DTYPES[dtype])
    assert bitwise(got, want)


@pytest.mark.parametrize("loc, scale", [(0.25, 1.7), (-3.0, 1e-3),
                                        (0.0, 1.0)])
@pytest.mark.parametrize("size", [1, 2, 623, 624, 625, 4097], ids=str)
def test_loc_and_scale_as_numpys(size, loc, scale):
    """loc + scale·g in double, rounded once to the dtype."""
    want = np.random.RandomState(11).normal(loc=loc, scale=scale,
                                            size=size)
    for dtype in (torch.float64, torch.float32):
        got = seeded.seeded_normal(11, (size,), loc, scale, dtype)
        assert bitwise(got, torch.as_tensor(want, dtype=dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=str)
@pytest.mark.parametrize("k, m, p", [(1, 4, 32), (3, 5, 33), (8, 64, 1000)])
def test_init_restarts_is_the_stack_of_lane_draws(k, m, p, dtype):
    """`init_restarts`' (k, m, p) stack: lane r is RandomState(seed + r)."""
    want = np.stack([np.random.RandomState(17 + r).normal(
        loc=0.0, scale=1.0 / np.sqrt(p), size=(m, p)) for r in range(k)])
    got = init_restarts(k, m, p, 17, dtype, "cpu")
    assert bitwise(got, torch.as_tensor(want, dtype=dtype))


@needs_library
@pytest.mark.parametrize("threads", [2, 3, 8, 13])
@pytest.mark.parametrize("k, n", [(1, 1), (1, 100003), (3, 4097),
                                  (8, 65536)])
def test_one_thread_and_many_agree(k, n, threads):
    """The library's draw does not depend on its threads: ranges, the
    running offset and the attempts past the estimated blocks land on
    the same slots."""
    seeds = [5 + 1000 * r for r in range(k)]
    one = torch.empty((k, n), dtype=torch.float64)
    many = torch.empty((k, n), dtype=torch.float64)
    seeded._fill_library(seeded._lib, one, seeds, n, 0.0, 1.0, 1)
    seeded._fill_library(seeded._lib, many, seeds, n, 0.0, 1.0, threads)
    assert bitwise(one, many)
    want = np.stack([np.random.RandomState(s).normal(size=n) for s in seeds])
    assert bitwise(one, torch.as_tensor(want))


@needs_library
def test_draws_from_several_threads_at_once():
    """Fits drawing in several Python threads at once, each draw on more
    threads than the host has cores: every draw NumPy's, none left
    running."""
    cases = [(seed, (64, 3000 + 7 * seed)) for seed in range(6)]
    got = {}

    def draw(seed, shape):
        got[seed] = seeded.Draw(seed, shape, 0.0, 0.5, torch.float64)
        got[seed] = got[seed].result()

    workers = [threading.Thread(target=draw, args=case) for case in cases]
    for w in workers:
        w.start()
    for w in workers:
        w.join(timeout=60)
        assert not w.is_alive()
    for seed, shape in cases:
        want = np.random.RandomState(seed).normal(0.0, 0.5, shape)
        assert bitwise(got[seed], torch.as_tensor(want))
    assert _live_draw_threads() == []


def test_the_library_takes_only_a_host_buffer_of_its_size():
    with pytest.raises(ValueError, match="contiguous host"):
        seeded._fill_library(None, torch.empty((2, 5)), [1, 2], 6, 0.0,
                             1.0, 1)
    with pytest.raises(ValueError, match="contiguous host"):
        seeded._fill_library(None, torch.empty((5, 2)).t(), [1, 2], 5,
                             0.0, 1.0, 1)
    with pytest.raises(ValueError, match="contiguous host"):
        seeded._fill_library(None, torch.empty(10, dtype=torch.float16),
                             [1, 2], 5, 0.0, 1.0, 1)


def test_threads_follow_the_size():
    """One thread below MIN_NORMALS_PER_THREAD, one more per that many,
    never more than the CPUs this process may use."""
    per = seeded.MIN_NORMALS_PER_THREAD
    assert seeded.threads_for(0) == seeded.threads_for(per - 1) == 1
    cpus = len(os.sched_getaffinity(0))
    assert seeded.threads_for(2 * per) == min(2, cpus)
    assert seeded.threads_for(10**9) == cpus


@pytest.fixture
def numpy_serves(monkeypatch):
    """The host library taken away: NumPy serves every draw."""
    monkeypatch.setattr(seeded, "_lib", None)
    monkeypatch.setattr(seeded, "fallback_reason", None)
    monkeypatch.setattr(native, "get_lib", lambda: None)
    assert not seeded.load()
    assert seeded.fallback_reason == "no g++ to build the library"


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_numpy_fallback_gives_the_same_bits(numpy_serves, dtype,
                                            monkeypatch):
    monkeypatch.setattr(seeded, "counts", seeded.DrawCounts())
    for size in [(625,), (64, 1000)]:
        want = torch.as_tensor(np.random.RandomState(3).normal(
            loc=0.0, scale=_scale(size), size=size), dtype=DTYPES[dtype])
        got = seeded.seeded_normal(3, size, 0.0, _scale(size),
                                   DTYPES[dtype])
        assert bitwise(got, want)
    stack = init_restarts(4, 64, 1000, 9, DTYPES[dtype], "cpu")
    want = np.stack([np.random.RandomState(9 + r).normal(
        loc=0.0, scale=1.0 / np.sqrt(1000), size=(64, 1000))
        for r in range(4)])
    assert bitwise(stack, torch.as_tensor(want, dtype=DTYPES[dtype]))
    assert seeded.counts.library == 0 and seeded.counts.numpy == 6
    assert seeded.counts.normals == 625 + 64000 + 4 * 64000


def test_a_library_that_disagrees_is_not_used(monkeypatch):
    """A library whose check against NumPy fails is left for NumPy."""
    monkeypatch.setattr(seeded, "_lib", None)
    monkeypatch.setattr(seeded, "fallback_reason", None)
    monkeypatch.setattr(native, "get_lib", lambda: object())
    monkeypatch.setattr(seeded, "_agrees", lambda lib: False)
    assert not seeded.load()
    assert "differs" in seeded.fallback_reason
    got = seeded.seeded_normal(2, (700,))
    want = np.random.RandomState(2).normal(size=700)
    assert bitwise(got, torch.as_tensor(want, dtype=torch.float32))


@needs_library
def test_the_check_reads_numpys_stream():
    """The load-time check passes on the library and fails on a draw one
    slot off."""
    assert seeded._agrees(seeded._lib)

    class Shifted:
        def lcx_seeded_normal(self, seeds, k, n, loc, scale, f32, out,
                              threads):
            seeded._lib.lcx_seeded_normal(seeds, k, n, loc, scale, f32,
                                          out, threads)
            view = (ctypes.c_double * (k * n)).from_address(out)
            view[0] = view[1]

    assert not seeded._agrees(Shifted())


@pytest.mark.parametrize("seed, error", [(-1, ValueError),
                                         (2**32, ValueError),
                                         (1.5, TypeError)])
def test_seeds_numpy_refuses_raise_as_numpy_does(seed, error):
    with pytest.raises(error):
        np.random.RandomState(seed)
    draw = seeded.Draw(seed, (3, 4))
    with pytest.raises(error):
        draw.result()
    with pytest.raises(error):
        lct.Corex(n_hidden=2, seed=seed, device="cpu").fit(
            np.random.RandomState(0).normal(size=(20, 6)))


def _live_draw_threads():
    return [t for t in threading.enumerate()
            if t.name == "lcx.draw.host" and t.is_alive()]


@pytest.fixture
def begun(monkeypatch):
    """The `Draw`s begun, recorded."""
    made = []

    class Recorded(seeded.Draw):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    monkeypatch.setattr(seeded, "Draw", Recorded)
    return made


# W0 (8, 10000): 80,000 normals, a draw on a thread of its own where the
# process may use two CPUs
WIDE = (40, 10000)
WIDE_M = 8


def test_a_fit_that_raises_leaves_no_drawing_thread(begun):
    x = np.full(WIDE, np.nan)
    with pytest.raises(ValueError, match="NaN"):
        lct.Corex(n_hidden=WIDE_M, seed=4, device="cpu").fit(x)
    assert len(begun) == 1
    draw = begun[0]
    assert draw._thread is None and draw._host is None
    assert _live_draw_threads() == []


def test_a_raising_restart_sweep_leaves_no_drawing_thread(begun):
    x = np.full(WIDE, np.inf)
    model = lct.Corex(n_hidden=WIDE_M, seed=4, n_restarts=3, device="cpu")
    with pytest.raises(ValueError):
        model.fit(x)
    assert len(begun) == 1 and begun[0]._host is None
    assert _live_draw_threads() == [] and model._draw is None


@pytest.mark.parametrize("start", ["init_ws", "pretrained"])
def test_a_warm_start_begins_no_draw(begun, start):
    rng = np.random.RandomState(1)
    x = rng.normal(size=(60, 12)).astype(np.float32)
    w = rng.normal(size=(3, 12)).astype(np.float32)
    if start == "init_ws":
        lct.Corex(n_hidden=3, seed=0, device="cpu", max_iter=5).fit(
            x, init_ws=w)
    else:
        lct.Corex(n_hidden=3, seed=0, device="cpu", max_iter=5,
                  pretrained_weights=w).fit(x)
    assert begun == []


@pytest.mark.parametrize("kw, lanes, shape", [
    ({}, 1, (4, 1500)),
    ({"init": "spectral", "anneal": False}, 1, (1500, 4)),
    ({"n_restarts": 3}, 3, (4, 1500)),
    ({"preset": "throughput", "n_restarts": 2}, 2, (1500, 4)),
], ids=["random", "spectral", "restarts3", "throughput_restarts2"])
def test_seeded_fit_takes_the_draw_it_began(begun, kw, lanes, shape,
                                            monkeypatch):
    """One draw a fit, begun before its preparation and taken by its
    start, counted in `seeded.counts`; the fit is bitwise the one whose
    start draws when it runs (a list input has no shape to begin from)."""
    monkeypatch.setattr(seeded, "counts", seeded.DrawCounts())
    before_prepare = []
    prepare = C.Corex._prepare_fit

    def counted_prepare(self, *args, **kwargs):
        before_prepare.append(len(begun))
        return prepare(self, *args, **kwargs)

    monkeypatch.setattr(C.Corex, "_prepare_fit", counted_prepare)
    rng = np.random.RandomState(2)
    x = rng.normal(size=(50, 1500)).astype(np.float32)
    fit = lct.Corex(n_hidden=4, seed=6, device="cpu", max_iter=20,
                    **kw).fit(x)
    assert before_prepare == [1] and len(begun) == 1
    assert begun[0]._host is None
    library = seeded.load()
    c = seeded.counts
    assert c.draws == 1
    assert (c.library, c.numpy) == ((lanes, 0) if library else (0, lanes))
    assert c.normals == lanes * math.prod(shape) and c.seconds > 0.0
    late = lct.Corex(n_hidden=4, seed=6, device="cpu", max_iter=20,
                     **kw).fit(x.tolist())
    assert before_prepare == [1, 1] and len(begun) == 2
    assert bitwise(fit.ws, late.ws)
    assert c.draws == 2 and c.library + c.numpy == 2 * lanes


@pytest.mark.parametrize("init, restarts, seeds, shape", [
    ("random", 1, 5, (3, 20)),
    ("spectral", 1, 5, (20, 3)),
    ("random", 4, [5, 6, 7, 8], (3, 20)),
    ("spectral", 2, [5, 6], (20, 3)),
])
def test_one_spec_says_what_a_start_draws(init, restarts, seeds, shape):
    """`_start_draw_spec`, which both the draw begun at a fit's entry and
    its start's take: W0 (m, p) at 1/sqrt(p), Ω (p, m) at 1, the lanes'
    seeds those of `init_restarts`; and the start drawn from it is
    NumPy's draw."""
    model = lct.Corex(n_hidden=3, seed=5, device="cpu")
    scale = 1.0 / np.sqrt(20) if init == "random" else 1.0
    assert model._start_draw_spec(init, 20, restarts) == (seeds, shape,
                                                          scale)
    assert R.restart_seeds(5, restarts) == list(np.atleast_1d(seeds))
    model.nv = 20
    got = model._seeded_start(init, 20, restarts)
    want = np.stack([np.random.RandomState(s).normal(0.0, scale, shape)
                     for s in np.atleast_1d(seeds)])
    assert bitwise(got, torch.as_tensor(want if restarts > 1 else want[0],
                                        dtype=torch.float32))
    assert model._draw is None


@pytest.mark.skipif(not native.available(), reason="needs g++ on PATH")
def test_warmup_builds_the_library_so_that_the_fit_builds_nothing(
        tmp_path, monkeypatch):
    """On a fresh build directory `Corex.warmup` builds, loads and checks
    the host library, seeded model or not; a seeded fit after it builds
    nothing and draws through the library."""
    from linearcorex_tpu_torch.utils import build
    from linearcorex_tpu_torch.utils import compile_cache as CC
    monkeypatch.setattr(CC, "_cache_dir", None)
    monkeypatch.setenv("LINEARCOREX_TPU_CACHE_DIR", str(tmp_path))
    monkeypatch.delenv("LINEARCOREX_TPU_NO_COMPILE_CACHE", raising=False)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(seeded, "_lib", None)
    monkeypatch.setattr(seeded, "counts", seeded.DrawCounts())
    done = len(build.COMPILES)
    lct.Corex(n_hidden=2, device="cpu").warmup(30, 8)
    assert seeded._lib not in (None, False)
    assert [c["what"] for c in build.COMPILES[done:]] == [
        " + ".join(build.HOST_SOURCES)]
    assert build.COMPILES[-1]["path"].startswith(str(tmp_path))
    seeded.counts.reset()
    lct.Corex(n_hidden=2, seed=3, device="cpu", max_iter=5).fit(
        np.random.RandomState(0).normal(size=(30, 8)))
    assert len(build.COMPILES) == done + 1
    assert (seeded.counts.draws, seeded.counts.library) == (1, 1)
