"""The PyTorch port's operand modes (matmul_dtype 'bfloat16' and 'int8')
against the JAX package's, on the CPU.

The int8 primitives compute the same integers: the quantized operand q is
bitwise equal and its scale within 1e-7; the Σ-applications agree to 1e-6
of their largest magnitude, ragged shapes included. The bf16 product
agrees to 1e-6 (float32 sums taken in another order). The int32 wrap
guard raises, warns and stays silent where the JAX package's does.

Fits: int8 and bf16, gram and samples, fixed point and momentum, with the
plain chain and with the chain kernel's CPU twin ('always'; the JAX side
then runs its Pallas kernel in the interpreter). Each must give the JAX
fit's clusters. TC: within 1e-3 relative for the fixed point; within
1e-2 for momentum, whose accept/reject line search stops at a TC that
quantization noise scatters — the JAX package against itself, with W0
changed by 1e-7 relative, scatters by up to 4.2e-3 on the bf16 momentum
fits of this data (n=1000, p=64, m=4).
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import linearcorex_tpu as lc
import linearcorex_tpu_torch as lct
from linearcorex_tpu.config import CorexConfig as JaxConfig
from linearcorex_tpu.models.corex import \
    resolve_optimizer as jax_resolve_optimizer
from linearcorex_tpu.ops import moments as JM
from linearcorex_tpu_torch.config import CorexConfig
from linearcorex_tpu_torch.models.corex import (_make_obj_grad,
                                                resolve_optimizer)
from linearcorex_tpu_torch.ops import moments as TM
from tests.conftest import block_data

# One intra-op thread: the suite runs its files in parallel worker
# processes, and an OpenMP pool per process on every core slows the
# small tensors here several times over.
torch.set_num_threads(1)

Y_SCALE, RHO_CLIP = 1.0, 1 - 1e-6


def _std(n=1500, p=48, m=6, seed=2):
    x = block_data(n=n, p=p, m=m, seed=seed)
    return ((x - x.mean(0)) / x.std(0)).astype(np.float32)


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = b.detach().cpu().numpy().astype(np.float64) \
        if isinstance(b, torch.Tensor) else np.asarray(b, np.float64)
    assert a.shape == b.shape
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-30)


@pytest.mark.parametrize("shape", [(1500, 48), (999, 999), (40, 7)])
def test_quantize_matches_jax(shape):
    x = np.random.RandomState(0).normal(size=shape).astype(np.float32)
    qj = JM.quantize_samples(jnp.asarray(x))
    qt = TM.quantize_samples(torch.from_numpy(x))
    assert qt.q.dtype == torch.int8 and qt.scale.dtype == torch.float32
    assert np.array_equal(np.asarray(qj.q), qt.q.numpy())
    assert abs(float(qj.scale) - float(qt.scale)) <= 1e-7 * float(qj.scale)
    gt = TM.quantize_gram(torch.from_numpy(x))
    assert torch.equal(gt.q, qt.q)


@pytest.mark.parametrize("p,k", [(48, 6), (999, 7), (64, 16)])
def test_quant_cols_matches_jax(p, k):
    v = np.random.RandomState(1).normal(size=(p, k)).astype(np.float32)
    v[:, 0] *= 1e-3                       # columns of different magnitude
    qj, sj = JM._quant_cols(jnp.asarray(v))
    qt, st = TM._quant_cols(torch.from_numpy(v))
    assert np.array_equal(np.asarray(qj), qt.numpy())
    assert _rel(sj, st) <= 1e-7


@pytest.mark.parametrize("n,p,k", [(1500, 48, 6), (999, 999, 7),
                                   (20, 13, 3), (1000, 64, 512)])
def test_apply_int8_matches_jax(n, p, k):
    """Both Σ-applications, at aligned and ragged shapes (the port pads
    every operand up to cuBLAS's int8 shape rules, on every device)."""
    rng = np.random.RandomState(3)
    x = rng.normal(size=(n, p)).astype(np.float32)
    x = (x - x.mean(0)) / x.std(0)
    g = (x.T @ x / n).astype(np.float32)
    v = (0.1 * rng.normal(size=(p, k))).astype(np.float32)
    for name, data in (("_apply_sigma_int8", x), ("_apply_gram_int8", g)):
        qj = JM.quantize_samples(jnp.asarray(data))
        qt = TM.quantize_samples(torch.from_numpy(data))
        want = getattr(JM, name)(qj, jnp.asarray(v))
        got = getattr(TM, name)(qt, torch.from_numpy(v))
        assert got.dtype == torch.float32
        assert _rel(want, got) <= 1e-6, name


@pytest.mark.parametrize("m,k,n", [(999, 999, 7), (5, 9, 3), (17, 8, 8),
                                   (64, 1000, 20)])
def test_int8_mm_is_exact_on_ragged_shapes(m, k, n):
    rng = np.random.RandomState(4)
    a = torch.from_numpy(rng.randint(-127, 128, size=(m, k)).astype(np.int8))
    b = torch.from_numpy(rng.randint(-127, 128, size=(k, n)).astype(np.int8))
    want = (a.to(torch.int64) @ b.to(torch.int64)).to(torch.int32)
    got = TM._int8_mm(a, b)
    assert got.dtype == torch.int32 and got.shape == (m, n)
    assert torch.equal(got, want)
    assert torch.equal(TM._int8_mm(b.T, a.T), want.T)   # transposed views


def test_dequantized():
    x = _std()
    qt = TM.quantize_samples(torch.from_numpy(x))
    assert _rel(JM._dequantized(JM.quantize_samples(jnp.asarray(x))),
                TM._dequantized(qt)) <= 1e-7
    plain = torch.zeros(3)
    assert TM._dequantized(plain) is plain


@pytest.mark.parametrize("shape", [(48, 6), (999, 7)])
def test_mm_bf16_matches_jax(shape):
    """float32 result of the bf16-rounded operands, within 1e-6 of the
    largest magnitude of the JAX product."""
    rng = np.random.RandomState(5)
    a = rng.normal(size=(shape[0], shape[0])).astype(np.float32)
    b = rng.normal(size=shape).astype(np.float32)
    want = JM._mm_bf16(jnp.asarray(a), jnp.asarray(b), jnp.float32)
    got = TM._mm_bf16(torch.from_numpy(a), torch.from_numpy(b),
                      torch.float32)
    assert got.dtype == torch.float32
    assert _rel(want, got) <= 1e-6
    # it is not the plain float32 product: the operands were rounded
    assert _rel(a @ b, got) > 1e-4


@pytest.mark.parametrize("strategy", ["samples", "gram"])
@pytest.mark.parametrize("kind", ["obj_grad", "fp"])
@pytest.mark.parametrize("mode", ["bfloat16", "int8"])
def test_objective_and_direction_match_jax(strategy, kind, mode):
    """ns_{obj_grad,fp}_{samples,gram} on each operand: objective and TC
    within 1e-5 relative, direction within 1e-4 of its largest
    magnitude."""
    x = _std(n=1000, p=64, m=8, seed=1)
    data = x if strategy == "samples" else (x.T @ x / 1000).astype(
        np.float32)
    ws = np.random.RandomState(2).normal(scale=0.05, size=(8, 64)).astype(
        np.float32)
    name = f"ns_{kind}_{strategy}"
    bf16 = mode == "bfloat16"
    if mode == "int8":
        dj = JM.quantize_samples(jnp.asarray(data))
        dt = TM.quantize_samples(torch.from_numpy(data))
    else:
        dj, dt = jnp.asarray(data, jnp.bfloat16), \
            torch.from_numpy(data).to(torch.bfloat16)
    for eps in (0.0, 0.36):
        fj, gj, tj = getattr(JM, name)(jnp.asarray(ws), dj, eps, Y_SCALE,
                                        RHO_CLIP, bf16=bf16)
        ft, gt, tt = getattr(TM, name)(torch.from_numpy(ws), dt, eps,
                                       Y_SCALE, RHO_CLIP, bf16=bf16)
        assert abs(float(fj) - float(ft)) <= 1e-5 * abs(float(fj))
        assert abs(float(tj) - float(tt)) <= 1e-5 * abs(float(tj))
        assert _rel(gj, gt) <= 1e-4


# ---------------------------------------------------------------------------
# the int32 wrap guard: tests/test_int8.py's three outcomes
# ---------------------------------------------------------------------------

def test_wrap_guard_raises_on_aligned_wrap():
    """A rank-1-aligned operand whose int8 product wraps int32 (127² x
    140k > 2³¹): both packages raise."""
    x = np.ones((2, 140_000), np.float32)
    with pytest.raises(ValueError, match="overflow"):
        JM.quantize_samples(jnp.asarray(x))
    with pytest.raises(ValueError, match="int8 accumulation overflow"):
        TM.quantize_samples(torch.from_numpy(x))
    # the escape hatch skips the guard
    assert TM.quantize_samples(torch.from_numpy(x),
                               check_overflow=False).q.shape == x.shape


def test_wrap_guard_warns_when_possible_but_unwrapped():
    rng = np.random.RandomState(0)
    x = rng.choice([-1.0, 1.0], size=(2, 140_000)).astype(np.float32)
    with pytest.warns(UserWarning, match="COULD overflow"):
        JM.quantize_samples(jnp.asarray(x))
    with pytest.warns(UserWarning, match="COULD overflow"):
        qd = TM.quantize_samples(torch.from_numpy(x))
    v = rng.normal(size=(140_000, 2)).astype(np.float32)
    ref = x.T @ (x @ v) / 2
    got = TM._apply_sigma_int8(qd, torch.from_numpy(v)).numpy()
    assert np.abs(got - ref).max() / np.abs(ref).max() < 0.05


def test_wrap_guard_silent_on_standard_data():
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        qd = TM.quantize_samples(torch.from_numpy(_std()))
    assert qd.q.dtype == torch.int8
    assert TM._int8_abs_sum_bound(qd.q) <= TM._INT32_MAX


def test_wrap_probe_matches_jax():
    rng = np.random.RandomState(0)
    x = rng.choice([-1.0, 1.0], size=(2, 140_000)).astype(np.float32)
    qj = JM.quantize_samples(jnp.asarray(x), check_overflow=False)
    qt = TM.quantize_samples(torch.from_numpy(x), check_overflow=False)
    u = np.random.RandomState(0).normal(size=(140_000, 4))
    ej = float(JM._int8_wrap_probe(qj.q, jnp.asarray(u, jnp.float32)))
    et = TM._int8_wrap_probe(qt.q, torch.as_tensor(u, dtype=torch.float32))
    assert abs(ej - et) <= 1e-6
    assert float(JM._int8_abs_sum_bound(qj.q)) == pytest.approx(
        TM._int8_abs_sum_bound(qt.q), rel=1e-6)


# ---------------------------------------------------------------------------
# estimator wiring
# ---------------------------------------------------------------------------

def test_obj_grad_rejects_plain_operand_under_int8():
    with pytest.raises(ValueError, match="quantized"):
        _make_obj_grad(torch.zeros((16, 8)),
                       CorexConfig(n_hidden=4, matmul_dtype="int8"),
                       "samples")


def test_int8_stage_tol_factor_hazard_warns_as_jax():
    kw = dict(n_hidden=4, matmul_dtype="int8", tol=1e-3,
              stage_tol_factor=10.0)
    with pytest.warns(UserWarning, match="stage_tol_factor"):
        jax_resolve_optimizer(JaxConfig(**kw), 10_000, 10_000)
    with pytest.warns(UserWarning, match="COLLAPSE TC"):
        resolve_optimizer(CorexConfig(**kw), 10_000, 10_000)
    # float32 at the same tols, and a factor of 1, stay silent
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        resolve_optimizer(CorexConfig(**{**kw, "matmul_dtype": "float32"}),
                          10_000, 10_000)
        resolve_optimizer(CorexConfig(**{**kw, "stage_tol_factor": 1.0}),
                          10_000, 10_000)


@pytest.mark.parametrize("mode", ["bfloat16", "int8"])
def test_operand_built_after_preprocessing(mode):
    """The fit's operand: X or Σ of the standardized data, then the bf16
    cast or the int8 quantize, as the JAX package's _prepare_program."""
    x = block_data(n=300, p=32, m=4, seed=0)
    for strategy in ("samples", "gram"):
        c = lct.Corex(n_hidden=4, matmul_dtype=mode, device="cpu",
                      moment_strategy=strategy)
        data, cfg, got_strategy = c._prepare_fit(x)
        assert got_strategy == strategy
        xs = (x - x.mean(0)) / x.std(0)
        want = xs if strategy == "samples" else xs.T @ xs / x.shape[0]
        if mode == "int8":
            assert isinstance(data, TM.QuantizedData)
            assert np.abs(TM._dequantized(data).numpy() - want).max() \
                <= float(data.scale)
        else:
            assert data.dtype == torch.bfloat16
            assert np.abs(data.float().numpy() - want).max() \
                <= 2 ** -8 * np.abs(want).max()


FIT_CASES = [(mode, strategy, optimizer, chain)
             for mode in ("int8", "bfloat16")
             for strategy in ("samples", "gram")
             for optimizer in ("fixed_point", "momentum")
             for chain in ("never", "always")]


@pytest.fixture(scope="module")
def fit_data():
    return block_data(n=1000, p=64, m=4, seed=0)


@pytest.mark.parametrize("mode,strategy,optimizer,chain", FIT_CASES)
def test_fit_matches_jax(mode, strategy, optimizer, chain, fit_data):
    w0 = np.random.RandomState(42).normal(scale=1 / 8, size=(4, 64))
    kw = dict(n_hidden=4, matmul_dtype=mode, tol=1e-4,
              moment_strategy=strategy, optimizer=optimizer)
    j = lc.Corex(use_pallas="interpret" if chain == "always" else "never",
                 **kw).fit(fit_data, init_ws=w0)
    c = lct.Corex(use_pallas=chain, device="cpu", **kw).fit(
        fit_data, init_ws=w0)
    bar = 1e-3 if optimizer == "fixed_point" else 1e-2
    iters = (f"iterations per stage: port "
             f"{c.diagnostics.iters_per_stage.tolist()}, JAX "
             f"{np.asarray(j.diagnostics.iters_per_stage).tolist()}")
    assert np.array_equal(c.clusters, np.asarray(j.clusters)), iters
    assert abs(c.tc - float(j.tc)) <= bar * float(j.tc), \
        f"TC port {c.tc}, JAX {float(j.tc)}; {iters}"
    assert c.ws.dtype == torch.float32
    y = c.transform(fit_data)
    assert y.shape == (1000, 4) and bool(np.isfinite(y).all())


def test_int8_auto_resolves_fixed_point(fit_data):
    c = lct.Corex(n_hidden=4, matmul_dtype="int8", optimizer="auto",
                  tol=1e-4, seed=0, device="cpu").fit(fit_data)
    j = lc.Corex(n_hidden=4, matmul_dtype="int8", optimizer="auto",
                 tol=1e-4, seed=0).fit(fit_data)
    assert c.resolved_optimizer_ == j.resolved_optimizer_ == "fixed_point"
    assert np.array_equal(c.clusters, np.asarray(j.clusters))
    assert abs(c.tc - float(j.tc)) <= 1e-3 * float(j.tc)


def test_int8_config_validation_as_jax():
    for kw in (dict(dtype="float64"), dict(discourage_overlap=False)):
        with pytest.raises(ValueError, match="int8"):
            JaxConfig(n_hidden=4, matmul_dtype="int8", **kw)
        with pytest.raises(ValueError, match="int8"):
            CorexConfig(n_hidden=4, matmul_dtype="int8", **kw)
