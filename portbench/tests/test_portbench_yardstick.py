"""The yardstick's operation and byte counts against values worked by
hand."""

import pytest

from portbench import yardstick as Y

NS = Y.Shape(n=10000, p=10000, m=512, k=1, strategy="gram",
             optimizer="momentum", operand="float32")


def test_sigma_gram():
    s = Y.sigma_apply(NS)
    assert s["flops"] == 2 * 10000 ** 2 * 512 == 1.024e11
    # Σ read (4e8 bytes), W read and C_xy written (2 x 2.048e7)
    assert s["bytes"] == 4e8 + 2.048e7 + 2.048e7
    assert s["seconds"] == pytest.approx(1.024e11 / 495e12)


def test_sigma_samples_and_int8():
    omics = NS._replace(n=200, m=64, strategy="samples")
    s = Y.sigma_apply(omics)
    assert s["flops"] == 4 * 200 * 10000 * 64 == 5.12e8
    assert s["bytes"] == 4 * 200 * 10000 + 4 * 10000 * 64 * 2
    i8 = Y.sigma_apply(NS._replace(operand="int8"))
    assert i8["bytes"] == 1e8 + 10000 * 512 + 4 * 10000 * 512
    assert i8["seconds"] == pytest.approx(1.024e11 / 1979e12)


def test_chain_inverse_and_lanes():
    c = Y.chain(10000, 512)
    assert c["flops"] == 2 * 10000 * 512 ** 2 + 10000 * 512 * 513
    assert Y.chain(10000, 512, 4)["flops"] == 4 * c["flops"]
    inv = Y.inverse(512)
    assert inv["flops"] == 2 * 512 ** 3
    assert inv["bytes"] == 8 * 512 * 512


def test_evaluation_counts_two_products_on_momentum():
    mom = Y.gemms(NS)
    fp = Y.gemms(NS._replace(optimizer="fixed_point"))
    sig = Y.sigma_apply(NS)["flops"]
    assert mom["flops"] - fp["flops"] == pytest.approx(sig)
    assert "inverse" in Y.evaluation(NS._replace(optimizer="fixed_point"))
    assert "inverse" not in Y.evaluation(NS)
    lanes = Y.evaluation(NS._replace(k=4))["total"]
    assert lanes == pytest.approx(4 * Y.evaluation(NS)["total"], rel=0.02)
