"""The reader of the program's seeded-draw counter
(`metrics/draw_host_ms.py`): host ms a draw from `ops.seeded.counts`,
None where the program has no such counter or drew nothing seeded, the
`.throughput` name read by the same file, and a seeded fit read on the
CPU."""

import sys

import numpy as np
import pytest

from conftest import ROOT
from portbench.manifest import Manifest

NAMES = ("draw_host_ms", "draw_host_ms.throughput")


@pytest.fixture
def counts(monkeypatch):
    from linearcorex_tpu_torch.ops import seeded
    fresh = seeded.DrawCounts()
    monkeypatch.setattr(seeded, "counts", fresh)
    return fresh


@pytest.mark.parametrize("name", NAMES)
def test_ms_a_draw(counts, name):
    read = Manifest(ROOT).reader(name)
    assert read(None) is None             # nothing drawn yet
    counts.draws, counts.library, counts.seconds = 4, 32, 0.05
    assert read(None) == pytest.approx(12.5)


@pytest.mark.parametrize("name", NAMES)
def test_none_without_the_counter(counts, monkeypatch, name):
    """A program older than the counter: no `ops.seeded` module, or one
    without `counts` or its `draws`."""
    from linearcorex_tpu_torch import ops
    from linearcorex_tpu_torch.ops import seeded
    read = Manifest(ROOT).reader(name)
    counts.draws = 1                 # would read, were it there
    monkeypatch.delattr(seeded, "counts")
    assert read(None) is None
    monkeypatch.delattr(ops, "seeded")
    monkeypatch.setitem(sys.modules, "linearcorex_tpu_torch.ops.seeded",
                        None)
    with pytest.raises(ImportError):
        from linearcorex_tpu_torch.ops import seeded  # noqa: F401,F811
    assert read(None) is None


def test_a_seeded_fit_is_read(counts):
    import linearcorex_tpu_torch as lct
    lct.Corex(n_hidden=2, seed=1, device="cpu", max_iter=5).fit(
        np.random.RandomState(0).normal(size=(40, 12)))
    got = Manifest(ROOT).reader("draw_host_ms")(None)
    assert counts.draws == 1 and got == 1e3 * counts.seconds > 0.0
