"""`pick_n_hidden` of the PyTorch port against the JAX package's.

In float64 with the same kwargs both packages must choose the same
n_hidden and give every candidate's score within 1e-8, on the padded
sweep (every (candidate, restart) pair a lane of one solve) and the
sequential per-candidate loop, under criterion 'tc' and 'heldout'. The
data are those of tests/test_selection.py. Argument errors carry the JAX
package's messages.
"""

import numpy as np
import pytest
import torch

import linearcorex_tpu as lc
import linearcorex_tpu_torch as lct
from linearcorex_tpu.models import selection as JS
from linearcorex_tpu_torch.config import CorexConfig
from linearcorex_tpu_torch.models import selection as TS
from linearcorex_tpu_torch.ops import moments as TM
from linearcorex_tpu_torch.ops import preprocessing as TP
from linearcorex_tpu_torch.parallel import restarts as TR
from tests.conftest import block_data

# One intra-op thread: the suite runs its files in parallel worker
# processes, and an OpenMP pool per process on every core slows the
# small tensors here several times over.
torch.set_num_threads(1)

TOL64 = 1e-8


def _case(criterion):
    if criterion == "tc":
        return block_data(n=800, p=24, m=3, seed=9), dict(max_iter=4000)
    return block_data(n=1200, p=32, m=4, seed=7), dict(tol=1e-4)


@pytest.mark.parametrize("criterion", ["tc", "heldout"])
@pytest.mark.parametrize("padded", [True, False])
def test_pick_n_hidden_matches_jax(padded, criterion):
    x, extra = _case(criterion)
    kw = dict(repeat=2, max_n_hidden=5, dtype="float64", seed=0,
              padded_sweep=padded, criterion=criterion, **extra)
    best_j, scores_j = lc.pick_n_hidden(x, **kw)
    best_t, scores_t = lct.pick_n_hidden(x, device="cpu", **kw)
    assert best_t == best_j
    assert len(scores_t) == len(scores_j)
    assert np.abs(scores_t - np.asarray(scores_j)).max() < TOL64
    assert best_t == (3 if criterion == "tc" else 4)


def test_padded_sweep_is_one_solve(monkeypatch):
    calls = []
    real = TR.fit_restarts

    def counting(data, w0, *a, **k):
        calls.append(tuple(w0.shape))
        return real(data, w0, *a, **k)

    monkeypatch.setattr(TR, "fit_restarts", counting)
    x = block_data(n=400, p=16, m=2, seed=4)
    _, scores = lct.pick_n_hidden(x, repeat=2, max_n_hidden=4, seed=0,
                                  max_iter=500, device="cpu")
    assert calls == [(8, 4, 16)]
    assert len(scores) == 4 and np.isfinite(scores).all()


@pytest.mark.parametrize("optimizer,chain", [("momentum", "always"),
                                             ("momentum", "never"),
                                             ("fixed_point", "always")])
def test_zero_surplus_rows_stay_zero(optimizer, chain):
    """Candidate nh's rows nh.. start at zero and stay exactly zero
    through the solver and the chain (its CPU twin): rho = 0 gives zero AA
    rows and zero H entries."""
    x = block_data(n=500, p=32, m=4, seed=1).astype(np.float32)
    xp, _ = TP.fit_preprocess(torch.from_numpy(x), "standard")
    cfg = CorexConfig(n_hidden=6, optimizer=optimizer, use_pallas=chain,
                      record_history=False, max_iter=300)
    w0 = TS._padded_inits(6, 2, 32, 0, torch.float32, "cpu")
    ws, mom, _ = TR.fit_restarts(TM.compute_gram(xp), w0, cfg, "gram")
    for lane in range(12):
        nh = lane // 2 + 1
        dead = ws[lane].abs().sum(dim=1) == 0
        assert int(dead.sum()) == 6 - nh
        assert bool((mom.tcs[lane][dead] == 0).all())


def _raises_as_jax(exc, x, **kw):
    with pytest.raises(exc) as want:
        lc.pick_n_hidden(x, **kw)
    with pytest.raises(exc) as got:
        lct.pick_n_hidden(x, device="cpu", **kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("exc,kw", [
    (ValueError, dict(repeat=0)),
    (ValueError, dict(max_n_hidden=0)),
    (ValueError, dict(criterion="bogus")),
    (TypeError, dict(n_restarts=3)),
    (ValueError, dict(init="spectral")),
    (ValueError, dict(criterion="heldout", val_fraction=1.5)),
    (ValueError, dict(criterion="heldout", gaussianize="empirical")),
    (ValueError, dict(data_axis="data")),
])
def test_argument_errors_as_jax(exc, kw):
    _raises_as_jax(exc, np.random.RandomState(0).normal(size=(50, 8)), **kw)


def test_too_few_training_rows_as_jax():
    _raises_as_jax(ValueError, np.random.RandomState(0).normal(size=(3, 8)),
                   criterion="heldout", val_fraction=0.9)


@pytest.mark.parametrize("scores", [
    [np.nan, 1.0, 1.0005, 0.2],
    [-np.inf, 2.0, np.nan, 1.9995],
    [0.5, 0.7, 0.71, 0.7095],
])
def test_smallest_within_tol_as_jax(scores):
    """Non-finite candidates are excluded; the smallest n within tol of
    the best wins."""
    assert TS._smallest_within_tol(scores, 1e-3) == \
        JS._smallest_within_tol(scores, 1e-3)


def test_smallest_within_tol_all_non_finite_raises():
    for fn in (TS._smallest_within_tol, JS._smallest_within_tol):
        with pytest.raises(ValueError, match="non-finite"):
            fn([np.nan, -np.inf], 1e-3)


def test_best_n_from_scores_as_jax():
    rng = np.random.RandomState(0)
    for _ in range(50):
        curve = np.cumsum(rng.choice([0.0, 0.0005, 0.5], size=8))
        assert TS._best_n_from_scores(curve, 1e-3) == \
            JS._best_n_from_scores(curve, 1e-3)


def test_mesh_and_missing_card_raise():
    x = block_data(n=200, p=16, m=2, seed=0)
    # a mesh needs an initialized process group (the mesh sweep itself is
    # driven in tests/test_torch_sharding.py)
    with pytest.raises(RuntimeError, match="default process group"):
        lct.pick_n_hidden(x, mesh=object(), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            lct.pick_n_hidden(x)


def test_verbose_reports_each_candidate(capsys):
    x = block_data(n=400, p=16, m=2, seed=4)
    lct.pick_n_hidden(x, repeat=2, max_n_hidden=3, seed=0, max_iter=200,
                      verbose=True, device="cpu")
    out = capsys.readouterr().out
    assert out.count("best TC over 2 restarts") == 3
