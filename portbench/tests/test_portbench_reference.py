"""The plain reference against the port at a tiny size on the CPU, in
float64: standardisation, the moments and TC, the gradient, the fixed
point's direction, the int8 operand and the seeded starts."""

import numpy as np
import pytest
import torch

from portbench import compare
from portbench import reference as R

N, P, M = 96, 40, 5


@pytest.fixture(scope="module")
def data():
    gen = torch.Generator().manual_seed(3)
    z = torch.randn((N, 5), generator=gen, dtype=torch.float64)
    e = torch.randn((N, P), generator=gen, dtype=torch.float64)
    return torch.repeat_interleave(z, P // 5, dim=1) * 0.9 + 0.436 * e


def port_operand(x, strategy, int8=False):
    from linearcorex_tpu_torch.ops import moments as Mo
    from linearcorex_tpu_torch.ops import preprocessing as Pp
    xp, _ = Pp.fit_preprocess(x, "standard")
    data = Mo.compute_gram(xp) if strategy == "gram" else xp
    return Mo.quantize_samples(data.float()) if int8 else data


@pytest.mark.parametrize("strategy", ["gram", "samples"])
@pytest.mark.parametrize("optimizer", ["momentum", "fixed_point"])
@pytest.mark.parametrize("eps", [0.6, 0.0])
def test_evaluation_matches_port(data, strategy, optimizer, eps):
    from linearcorex_tpu_torch.ops import moments as Mo
    z, _, _ = R.standardize(data)
    op = R.Operand(z, strategy)
    w = R.random_w0(11, M, P, "cpu")
    f, g, tc = R.evaluate(w, op, eps, optimizer)
    operand = port_operand(data, strategy)
    gram = strategy == "gram"
    fn = {("momentum", True): Mo.ns_obj_grad_gram,
          ("momentum", False): Mo.ns_obj_grad_samples,
          ("fixed_point", True): Mo.ns_fp_gram,
          ("fixed_point", False): Mo.ns_fp_samples}[optimizer, gram]
    Mo.prepare_constants(operand, 1.0, torch.float64, gram)
    pf, pg, ptc = fn(w, operand, torch.tensor(eps, dtype=torch.float64),
                     1.0, R.RHO_CLIP)
    assert float(f) == pytest.approx(float(pf), rel=1e-10)
    assert float(tc) == pytest.approx(float(ptc), rel=1e-10)
    assert torch.allclose(g, pg, rtol=1e-8, atol=1e-12)


def test_int8_operand_matches_port(data):
    """The reference's int8 Σ-application re-derived from the float64 Σ
    agrees with the port's quantized products to the float32 rounding of
    the port's Σ."""
    from linearcorex_tpu_torch.ops import moments as Mo
    x32 = data.float()
    z, _, _ = R.standardize(x32)
    op = R.Operand(z, "gram", levels=127)
    qd = port_operand(x32, "gram", int8=True)
    assert float(qd.scale) == pytest.approx(float(op.scale), rel=1e-6)
    assert (qd.q.double() - op.q).abs().max() <= 1
    w = R.random_w0(5, M, P, "cpu")
    got = Mo._apply_gram_int8(qd, w.T.float()).double()
    want = op.apply(w.T)
    assert float((got - want).abs().max() / want.abs().max()) < 1e-2


def test_random_start_is_the_estimators():
    import linearcorex_tpu_torch as lct
    c = lct.Corex(n_hidden=M, seed=1234, device="cpu")
    w = c._init_ws(P)
    assert torch.equal(w.double(), R.random_w0(1234, M, P, "cpu"))


def test_settings_follow_the_documented_rules():
    st = compare.settings({"preset": "throughput", "n_hidden": 8}, 100, 50)
    assert (st["matmul_dtype"], st["init"], st["anneal"], st["optimizer"],
            st["strategy"], st["tol"]) == ("int8", "spectral", False,
                                           "fixed_point", "gram", 1e-4)
    st = compare.settings({"n_hidden": 8}, 200, 10000)
    assert (st["optimizer"], st["strategy"]) == ("momentum", "samples")
    st = compare.settings({"n_restarts": 4}, 100, 100)
    assert st["n_restarts"] == 4 and st["strategy"] == "gram"


def test_tf32_rounding():
    a = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10, -3.0 + 2 ** -12])
    r = R.tf32(a)
    assert r[0] == 1.0 and r[2] == 1.0 + 2 ** -10
    assert r[1] == 1.0 + 2 ** -10          # a tie rounds away from zero
    assert r[3] == -3.0
    bits = r.view(torch.int32)
    assert bool(((bits & 0x1FFF) == 0).all())


def test_reference_fit_converges_like_the_port(data):
    """The reference's own fit (the control's engine), run in float64,
    ends at a TC within 1% of the port's float64 fit from the same start
    (both are annealed momentum fits of the same objective)."""
    import linearcorex_tpu_torch as lct
    z, _, _ = R.standardize(data)
    op = R.Operand(z, "gram")
    w0 = R.random_w0(21, M, P, "cpu")
    ref = R.fit(w0, op, "momentum", True, 1e-5, 2000)
    port = lct.Corex(n_hidden=M, seed=21, device="cpu", dtype="float64",
                     max_iter=2000).fit(data)
    assert ref.tc == pytest.approx(float(port.tc), rel=1e-2)
    assert np.isfinite(ref.first_tc)
