"""Tests of linearcorex_tpu_torch that need an NVIDIA card (marked `cuda`;
they skip without one), plus the CPU-side checks of the kernel wrapper.

This file imports neither JAX nor tests/conftest.py, so it also runs on a
machine without JAX (float64 card fits are held to the port's own copy of
the oracle, `linearcorex_tpu_torch.oracle`):

    python -m pytest -o addopts="" --noconftest -q tests/test_torch_cuda.py

The chain kernel is held to its plain PyTorch twin at 1e-5 of the largest
magnitude (the JAX package's kernel-test bound) and must give bitwise-equal
outputs on a repeated launch. The Σ-product kernel is held to float64: its
error must be at most twice cuBLAS's full-float32 product's on the same
inputs, and a repeated launch or a graph replay bitwise equal. The operand modes are held to the same calls
on the CPU: int8 products bitwise, their scaled results to 1e-6 relative;
the bf16 product must come back in float32, within 1e-5 of the float32
product of the bf16-rounded operands (a bf16-rounded output misses by
~1e-3).
"""

import functools

import numpy as np
import pytest
import torch

import linearcorex_tpu_torch as lct
from linearcorex_tpu_torch.core import solver as TS
from linearcorex_tpu_torch.ops import cuda_moments as CM
from linearcorex_tpu_torch.oracle import OracleCorex
from linearcorex_tpu_torch.ops import moments as TM
from linearcorex_tpu_torch.ops import preprocessing as TP
from linearcorex_tpu_torch.utils import build

RHO_CLIP = 1 - 1e-6


def _inputs(p, m, dev):
    rng = np.random.RandomState(1)
    w = rng.normal(scale=0.1, size=(m, p))
    x = rng.normal(size=(600, p))
    x = (x - x.mean(0)) / x.std(0)
    cxy = (x.T @ (x @ w.T) / 600).astype(np.float32)
    cy = w @ cxy + np.eye(m)
    z2 = np.diag(cy)
    ry = (cy / np.sqrt(np.outer(z2, z2))).astype(np.float32)
    return tuple(torch.from_numpy(a).to(dev) for a in
                 (cxy, ry, np.sqrt(z2).astype(np.float32)))


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")


def test_build_targets_hopper():
    flags = " ".join(build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "-shared" in flags
    path = build._library_path("ns_chain")
    assert path.parent == build.BUILD_DIR
    assert path.name.startswith("libns_chain_") and path.suffix == ".so"


def test_wrapper_rejects_other_devices():
    cxy, ry, sqz = (t.to("meta") for t in _inputs(64, 8, "cpu"))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        CM.ns_chain(cxy, ry, sqz, RHO_CLIP)


@pytest.mark.cuda
@pytest.mark.parametrize("p,m", [(10000, 512), (400, 100), (999, 7),
                                 (257, 130), (400, 128), (2000, 1030),
                                 (1, 8), (37, 256), (1024, 8), (300, 520)])
def test_kernel_matches_twin(p, m):
    """Within 1e-5 of the twin and bitwise-repeatable, at the GEMM tiles'
    edges too: p below one 64-row warpgroup tile (1, 37), m of one
    8-column block (8), of whole 128-column tiles (256, 512) and ragged
    past them (130, 520, 1030)."""
    _need_cuda()
    cxy, ry, sqz = _inputs(p, m, "cuda")
    before = CM.ns_chain.launches
    got = CM.ns_chain(cxy, ry, sqz, RHO_CLIP)
    again = CM.ns_chain(cxy, ry, sqz, RHO_CLIP)
    torch.cuda.synchronize()
    assert CM.ns_chain.launches == before + 2
    want = CM.ns_chain_reference(cxy, ry, sqz, RHO_CLIP)
    for g, g2, w in zip(got, again, want):
        assert g.shape == w.shape
        denom = float(w.abs().max()) + 1e-12
        assert float((g - w).abs().max()) / denom < 1e-5
        assert torch.equal(g, g2)


@pytest.mark.cuda
def test_kernel_rejects_bad_operands():
    _need_cuda()
    cxy, ry, sqz = _inputs(64, 8, "cuda")
    with pytest.raises(ValueError, match="contiguous"):
        CM.ns_chain(cxy, ry.T, sqz, RHO_CLIP)
    with pytest.raises(ValueError, match="shape"):
        CM.ns_chain(cxy, ry[:4], sqz, RHO_CLIP)
    with pytest.raises(ValueError, match="float64"):
        CM.ns_chain(cxy.double(), ry.double(), sqz.double(), RHO_CLIP)


@pytest.mark.cuda
def test_fit_on_card_goes_through_kernel_and_agrees():
    """A small fit on the card runs the kernel and agrees with the port's
    float64 CPU fit: same clusters, TC within 1e-3 relative."""
    _need_cuda()
    rng = np.random.RandomState(3)
    x = np.repeat(rng.normal(size=(2000, 8)), 32, axis=1) * 0.9 \
        + 0.436 * rng.normal(size=(2000, 256))
    w0 = rng.normal(scale=1 / 16, size=(8, 256))
    before = CM.ns_chain.launches
    gpu = lct.Corex(n_hidden=8, use_pallas="always", device="cuda").fit(
        x, init_ws=w0)
    assert CM.ns_chain.launches > before
    cpu = lct.Corex(n_hidden=8, dtype="float64", device="cpu").fit(
        x, init_ws=w0)
    assert np.array_equal(gpu.clusters, cpu.clusters)
    assert abs(gpu.tc - cpu.tc) / abs(cpu.tc) < 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [(), (3,)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_kernel_takes_half_operands(dtype, lanes):
    """bfloat16 and float16 operands are cast to float32 at the wrapper:
    the outputs are float32 and bitwise the kernel's on the casts, one
    lane and lanes, each call one launch."""
    _need_cuda()
    args = _lane_inputs(lanes[0], 999, 7, "cuda", 0) if lanes \
        else _inputs(999, 7, "cuda")
    half = tuple(a.to(dtype) for a in args)
    count = "lane_launches" if lanes else "launches"
    before = getattr(CM.ns_chain, count)
    got = CM.ns_chain(*half, RHO_CLIP)
    want = CM.ns_chain(*(a.float() for a in half), RHO_CLIP)
    torch.cuda.synchronize()
    assert getattr(CM.ns_chain, count) == before + 2
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert torch.equal(g, w)


def _partition(clusters):
    c = np.asarray(clusters)
    return sorted(tuple(np.flatnonzero(c == k)) for k in np.unique(c))


@pytest.mark.cuda
def test_bfloat16_fit_on_card_agrees_with_cpu():
    """A small dtype='bfloat16' momentum fit on the card runs the kernel
    on float32 casts and gives the clusters of the port's bfloat16 fit on
    the CPU (the same partition: factors whose TCs tie in bfloat16 may be
    sorted in another order), from the same W0."""
    _need_cuda()
    rng = np.random.RandomState(3)
    x = np.repeat(rng.normal(size=(2000, 8)), 32, axis=1) * 0.9 \
        + 0.436 * rng.normal(size=(2000, 256))
    w0 = rng.normal(scale=1 / 16, size=(8, 256))
    kw = dict(n_hidden=8, dtype="bfloat16", max_iter=2000)
    before = CM.ns_chain.launches
    gpu = lct.Corex(device="cuda", **kw).fit(x, init_ws=w0)
    assert CM.ns_chain.launches > before
    assert gpu.ws.dtype == torch.bfloat16
    assert gpu.resolved_optimizer_ == "momentum"
    cpu = lct.Corex(device="cpu", **kw).fit(x, init_ws=w0)
    assert _partition(gpu.clusters) == _partition(cpu.clusters)
    assert np.isfinite(gpu.tc) and bool(torch.isfinite(gpu.ws).all())


def _standardized(n, p, seed=0):
    x = np.random.RandomState(seed).normal(size=(n, p))
    x[:, 1:] += x[:, :1]                    # some correlation
    return ((x - x.mean(0)) / x.std(0)).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("n,p,k", [(2000, 1024, 64), (1500, 999, 7)])
def test_int8_products_on_card_match_cpu(n, p, k):
    _need_cuda()
    x = _standardized(n, p)
    g = x.T @ x / n
    v = np.random.RandomState(1).normal(scale=0.1, size=(p, k)).astype(
        np.float32)
    for data, apply in ((x, TM._apply_sigma_int8), (g, TM._apply_gram_int8)):
        qc = TM.quantize_samples(torch.from_numpy(data))
        qg = TM.quantize_samples(torch.from_numpy(data).cuda())
        assert torch.equal(qg.q.cpu(), qc.q)
        vq, _ = TM._quant_cols(torch.from_numpy(v))
        assert torch.equal(TM._int8_mm(qg.q, vq.cuda()).cpu(),
                           TM._int8_mm(qc.q, vq))
        assert torch.equal(TM._int8_mm(qg.q.T, qg.q[:, :k]).cpu(),
                           TM._int8_mm(qc.q.T, qc.q[:, :k]))
        want = apply(qc, torch.from_numpy(v))
        got = apply(qg, torch.from_numpy(v).cuda()).cpu()
        assert got.dtype == torch.float32
        assert float((got - want).abs().max()) \
            <= 1e-6 * float(want.abs().max())


@pytest.mark.cuda
def test_mm_bf16_on_card_returns_float32():
    _need_cuda()
    rng = np.random.RandomState(2)
    a = torch.from_numpy(rng.normal(size=(1024, 1024)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(1024, 96)).astype(np.float32))
    a, b = a.cuda(), b.cuda()
    with TM.full_f32_matmul():
        got = TM._mm_bf16(a, b, torch.float32)
        want = a.bfloat16().float() @ b.bfloat16().float()
        rounded = (a.bfloat16() @ b.bfloat16()).float()
    scale = float(want.abs().max())
    assert got.dtype == torch.float32
    assert float((got - want).abs().max()) < 1e-5 * scale
    # the bound is tight enough to catch a bf16-rounded output
    assert float((rounded - want).abs().max()) > 1e-5 * scale


@pytest.mark.cuda
def test_empirical_on_card_matches_cpu():
    _need_cuda()
    x = np.round(np.random.RandomState(3).lognormal(size=(400, 30)), 1)
    want, _ = TP.fit_preprocess(torch.from_numpy(x), "empirical")
    got, _ = TP.fit_preprocess(torch.from_numpy(x).cuda(), "empirical")
    assert float((got.cpu() - want).abs().max()) < 1e-12
    got32, _ = TP.fit_preprocess(torch.from_numpy(x).float().cuda(),
                                 "empirical")
    assert float((got32.cpu().double() - want).abs().max()) < 1e-6


@pytest.mark.cuda
def test_overlap_non_pd_cy_gives_nan_on_card():
    _need_cuda()
    gram = torch.diag(torch.tensor([4.0] * 4 + [-4.0] * 4)).cuda()
    ws = torch.zeros((2, 8), device="cuda")
    ws[0, 4] = ws[1, 5] = 1.0            # C_y = −3·I
    f, g, tc = TM.overlap_obj_grad_gram(ws, gram, 0.0, 1.0)
    assert bool(torch.isnan(f)) and bool(torch.isnan(g).all())
    ws[0, 4] = ws[1, 5] = 0.1            # C_y = 0.96·I, positive definite
    f, g, tc = TM.overlap_obj_grad_gram(ws, gram, 0.0, 1.0)
    assert bool(torch.isfinite(f)) and bool(torch.isfinite(g).all())


@pytest.mark.cuda
@pytest.mark.parametrize("chain", ["always", "never"])
@pytest.mark.parametrize("strategy", ["gram", "samples"])
@pytest.mark.parametrize("mode", ["int8", "bfloat16"])
def test_operand_mode_fit_on_card(mode, strategy, chain):
    """An int8 or bf16 fit on the card (fixed point, block data n=1000,
    p=64, m=4), gram or samples, through the chain kernel or the plain
    chain, agrees with the same fit on the CPU: same clusters, TC within
    1e-2 relative (the fit stops at tol=1e-4 under quantization noise: on
    the CPU alone the plain and the kernel's twin chain differ by 6e-3 in
    bf16 on this data). Only 'always' launches the kernel."""
    _need_cuda()
    rng = np.random.RandomState(0)
    z = rng.normal(size=(1000, 4))
    x = np.repeat(z, 16, axis=1) * 0.9 + np.sqrt(1 - 0.81) * rng.normal(
        size=(1000, 64))
    w0 = np.random.RandomState(42).normal(scale=1 / 8, size=(4, 64))
    kw = dict(n_hidden=4, matmul_dtype=mode, optimizer="fixed_point",
              tol=1e-4, moment_strategy=strategy)
    before = CM.ns_chain.launches
    gpu = lct.Corex(use_pallas=chain, device="cuda", **kw).fit(
        x, init_ws=w0)
    assert (CM.ns_chain.launches > before) == (chain == "always")
    cpu = lct.Corex(device="cpu", **kw).fit(x, init_ws=w0)
    assert np.array_equal(gpu.clusters, cpu.clusters)
    assert abs(gpu.tc - cpu.tc) <= 1e-2 * abs(cpu.tc)


def _lane_inputs(k, p, m, dev, dead_rows=0):
    """k lanes of chain inputs; the last `dead_rows` factors of every lane
    have zero weights (a padded selection lane): zero C_xy columns and
    the identity in their ry rows and columns."""
    rng = np.random.RandomState(4)
    x = rng.normal(size=(600, p))
    x = (x - x.mean(0)) / x.std(0)
    out = []
    for _ in range(k):
        w = rng.normal(scale=0.1, size=(m, p))
        if dead_rows:
            w[m - dead_rows:] = 0.0
        cxy = (x.T @ (x @ w.T) / 600).astype(np.float32)
        cy = w @ cxy + np.eye(m)
        z2 = np.diag(cy)
        ry = (cy / np.sqrt(np.outer(z2, z2))).astype(np.float32)
        out.append((cxy, ry, np.sqrt(z2).astype(np.float32)))
    return tuple(torch.from_numpy(np.stack(a)).to(dev) for a in zip(*out))


@pytest.mark.cuda
@pytest.mark.parametrize("k,p,m,dead", [(4, 10000, 512, 0), (3, 999, 7, 0),
                                        (32, 1024, 8, 5), (16, 1024, 8, 3)])
def test_lane_kernel_matches_twin_and_single_launches(k, p, m, dead):
    """The lane entry against the batched twin (1e-5 of the largest
    magnitude), every lane bitwise equal to a one-lane launch on its
    inputs, a second launch bitwise equal to the first; zero W rows give
    exactly zero AA rows and H entries."""
    _need_cuda()
    cxy, ry, sqz = _lane_inputs(k, p, m, "cuda", dead)
    before = CM.ns_chain.lane_launches
    got = CM.ns_chain(cxy, ry, sqz, RHO_CLIP)
    again = CM.ns_chain(cxy, ry, sqz, RHO_CLIP)
    torch.cuda.synchronize()
    assert CM.ns_chain.lane_launches == before + 2
    want = CM.ns_chain_reference(cxy, ry, sqz, RHO_CLIP)
    for g, g2, w in zip(got, again, want):
        assert g.shape == w.shape
        denom = float(w.abs().max()) + 1e-12
        assert float((g - w).abs().max()) / denom < 1e-5
        assert torch.equal(g, g2)
    for lane in range(k):
        one = CM.ns_chain(cxy[lane], ry[lane], sqz[lane], RHO_CLIP)
        for g, o in zip(got, one):
            assert torch.equal(g[lane], o)
    if dead:
        aa, hmat = got[0], got[1]
        assert bool((aa[:, :, m - dead:] == 0).all())
        assert bool((hmat[:, m - dead:, :] == 0).all())
        assert bool((hmat[:, :, m - dead:] == 0).all())


@pytest.mark.cuda
def test_lane_kernel_rejects_too_many_lanes():
    _need_cuda()
    cxy, ry, sqz = _lane_inputs(2, 64, 8, "cuda")
    lib = CM._kernel()
    most = lib.lcx_ns_chain_max_lanes(64, 8)
    big = (cxy[:1].expand(most + 1, -1, -1).contiguous(),
           ry[:1].expand(most + 1, -1, -1).contiguous(),
           sqz[:1].expand(most + 1, -1).contiguous())
    with pytest.raises(ValueError, match="lanes"):
        CM.ns_chain(*big, RHO_CLIP)


@pytest.mark.cuda
@pytest.mark.parametrize("overlap", [False, True])
def test_small_sweep_on_card_agrees_with_cpu(overlap):
    """A 3-lane float32 sweep on the card (n=2000, p=256, m=8) against the
    port's float64 CPU sweep from the same seeds: the same clusters, TC
    within 1e-3 relative, and a winning lane that is a best lane on the
    CPU too (the non-overlap lanes reach one optimum, TC equal to 1e-9
    in float64, so the argmax among them is float32 noise); the
    non-overlap sweep runs the lane kernel."""
    _need_cuda()
    rng = np.random.RandomState(3)
    x = np.repeat(rng.normal(size=(2000, 8)), 32, axis=1) * 0.9 \
        + 0.436 * rng.normal(size=(2000, 256))
    kw = dict(n_hidden=8, n_restarts=3, seed=0, max_iter=2000,
              discourage_overlap=not overlap)
    before = CM.ns_chain.lane_launches
    gpu = lct.Corex(device="cuda", **kw).fit(x)
    assert (CM.ns_chain.lane_launches > before) == (not overlap)
    cpu = lct.Corex(dtype="float64", device="cpu", **kw).fit(x)
    single = dict(kw, n_restarts=1, seed=kw["seed"] + gpu.best_restart_)
    lane = lct.Corex(dtype="float64", device="cpu", **single).fit(x)
    assert abs(lane.tc - cpu.tc) / abs(cpu.tc) < 1e-3
    assert np.array_equal(gpu.clusters, cpu.clusters)
    assert abs(gpu.tc - cpu.tc) / abs(cpu.tc) < 1e-3


def _small_blocks():
    rng = np.random.RandomState(3)
    x = np.repeat(rng.normal(size=(2000, 8)), 32, axis=1) * 0.9 \
        + 0.436 * rng.normal(size=(2000, 256))
    return x, rng.normal(scale=1 / 16, size=(8, 256))


def _agree(gpu, cpu):
    assert np.array_equal(gpu.clusters, cpu.clusters)
    assert abs(gpu.tc - cpu.tc) / abs(cpu.tc) < 1e-3


@pytest.mark.cuda
def test_streamed_fit_on_card_agrees_with_cpu():
    """Five batches into a GramAccumulator on the card, then the fit
    through the chain kernel, and a 4-batch partial_fit, against the
    port's float64 CPU results from the same W0."""
    _need_cuda()
    x, w0 = _small_blocks()
    kw = dict(n_hidden=8, seed=0, max_iter=2000, pretrained_weights=w0)
    acc = lct.GramAccumulator(256)
    ref = lct.GramAccumulator(256, dtype="float64", device="cpu")
    for i in range(0, 2000, 400):
        acc.update(x[i:i + 400])
        ref.update(x[i:i + 400])
    assert acc._g.is_cuda and acc.device.type == "cuda"
    corr = acc.correlation()
    assert float((corr.cpu().double() - ref.correlation()).abs().max()) \
        < 1e-5
    before = CM.ns_chain.launches
    gpu = acc.fit(use_pallas="always", **kw)
    assert CM.ns_chain.launches > before and gpu.ws.is_cuda
    _agree(gpu, ref.fit(**kw))
    pf_gpu = lct.Corex(use_pallas="always", **kw)
    pf_cpu = lct.Corex(dtype="float64", device="cpu", **kw)
    before = CM.ns_chain.launches
    for i in range(0, 2000, 500):
        pf_gpu.partial_fit(x[i:i + 500])
        pf_cpu.partial_fit(x[i:i + 500])
    assert CM.ns_chain.launches > before and pf_gpu.n_samples == 2000
    _agree(pf_gpu, pf_cpu)


@pytest.mark.cuda
def test_save_load_and_checkpoints_on_card(tmp_path):
    """save_corex → load_corex on the card serves bitwise what was saved,
    and the same within 1e-5 when loaded on the CPU; the checkpointed fit
    runs the kernel in every stage and agrees with the float64 CPU fit."""
    _need_cuda()
    from linearcorex_tpu_torch.utils.checkpoint import fit_with_checkpoints
    x, w0 = _small_blocks()
    kw = dict(n_hidden=8, seed=0, max_iter=2000)
    gpu = lct.Corex(use_pallas="always", **kw)
    per_stage = []

    def cb(stage, eps, ws, stats):
        per_stage.append(CM.ns_chain.launches)
        assert ws.is_cuda

    before = CM.ns_chain.launches
    fit_with_checkpoints(gpu, x, str(tmp_path / "ck"), init_ws=w0,
                         stage_callback=cb)
    assert all(b > a for a, b in zip([before] + per_stage, per_stage))
    cpu = lct.Corex(dtype="float64", device="cpu", **kw).fit(x, init_ws=w0)
    _agree(gpu, cpu)
    path = str(tmp_path / "m.npz")
    lct.save_corex(gpu, path)
    again = lct.load_corex(path)
    assert again.ws.is_cuda and again.device == "cuda"
    xt = torch.as_tensor(x, dtype=torch.float32, device="cuda")
    y = gpu.transform(xt)
    assert torch.equal(again.transform(xt), y)
    host = lct.load_corex(path, device="cpu")
    y_host = host.transform(x)
    assert isinstance(y_host, np.ndarray)
    assert float(np.abs(y_host - y.cpu().numpy()).max()) \
        <= 1e-5 * float(y.abs().max())


@pytest.mark.cuda
def test_two_layer_stack_on_card_agrees_with_cpu():
    """Eight fine blocks under two coarse factors, so that layer 2 has a
    structure to find (on independent blocks its clusters are noise)."""
    _need_cuda()
    rng = np.random.RandomState(3)
    coarse = rng.normal(size=(2000, 2))
    fine = 0.8 * np.repeat(coarse, 4, axis=1) + 0.6 * rng.normal(
        size=(2000, 8))
    x = np.repeat(fine, 32, axis=1) * 0.9 + 0.436 * rng.normal(
        size=(2000, 256))
    kw = dict(seed=0, max_iter=2000)
    before = CM.ns_chain.launches
    gpu = lct.StackedCorex([8, 2], use_pallas="always", **kw).fit(x)
    assert CM.ns_chain.launches > before
    cpu = lct.StackedCorex([8, 2], dtype="float64", device="cpu",
                           **kw).fit(x)
    for lg, lcpu in zip(gpu.layers, cpu.layers):
        assert lg.ws.is_cuda
        _agree(lg, lcpu)
    ys = gpu.transform_all(x)
    assert all(isinstance(y, np.ndarray) for y in ys)
    assert tuple(gpu.predict(ys[-1]).shape) == x.shape
    yt = gpu.transform_all(torch.as_tensor(x, dtype=torch.float32,
                                           device="cuda"))
    assert all(y.is_cuda for y in yt)
    assert all(np.array_equal(a, b.cpu().numpy()) for a, b in zip(ys, yt))


@pytest.mark.cuda
@pytest.mark.parametrize("matmul_dtype", ["float32", "int8"])
def test_mesh_fit_in_a_world_of_one_is_the_plain_samples_fit(tmp_path,
                                                             matmul_dtype):
    """One NCCL rank on the card: Corex.fit(mesh=) runs the samples
    strategy through the chain kernel and, an all-reduce over one rank
    changing no bit, ends bitwise where the plain samples fit does; so do
    transform and score under the mesh, and a restarts-axis sweep."""
    _need_cuda()
    import torch.distributed as dist

    from linearcorex_tpu_torch.parallel import sharding as S
    from linearcorex_tpu_torch.parallel.launch import init_local_group
    x = torch.as_tensor(_small_blocks()[0], dtype=torch.float32)
    kw = dict(n_hidden=8, seed=0, max_iter=200, tol=1e-4,
              matmul_dtype=matmul_dtype, device="cuda")
    init_local_group("nccl", 0, 1, str(tmp_path / "rendezvous"),
                     timeout=120.0)
    try:
        mesh = S.make_mesh()
        CM.ns_chain.launches = 0
        S.reset_collective_counts()
        a = lct.Corex(**kw).fit(x, mesh=mesh)
        launches = CM.ns_chain.launches
        calls = S.collective_counts()
        b = lct.Corex(moment_strategy="samples", **kw).fit(x)
        assert launches > 0
        assert torch.equal(a.ws, b.ws) and a.tc == b.tc
        assert torch.equal(a.diagnostics.iters_per_stage,
                           b.diagnostics.iters_per_stage)
        assert torch.equal(a.transform(x, mesh=mesh), b.transform(x))
        assert a.score(x, mesh=mesh) == b.score(x)
        assert calls and all(c.kind == "all_reduce" and c.axis == "data"
                             for c in calls)
        rmesh = S.make_mesh((("restarts", 1),))
        CM.ns_chain.lane_launches = 0
        c = lct.Corex(n_restarts=3, **kw).fit(x, mesh=rmesh)
        d = lct.Corex(n_restarts=3, **kw).fit(x)
        assert CM.ns_chain.lane_launches > 0
        assert torch.equal(c.ws, d.ws) and c.best_restart_ == d.best_restart_
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("matmul_dtype", ["float32", "int8"])
def test_var_and_factor_fits_in_a_world_of_one_are_the_plain_fit(
        tmp_path, matmul_dtype):
    """One NCCL rank on the card: var and factor plans run the split code
    with every block whole and every collective over one rank, so each
    mesh fit ends bitwise where the plain fit with use_pallas='never'
    does; with use_pallas='always' the var fit gathers C_xy and launches
    the chain kernel as often as the plain kernel fit, bitwise alike; var
    serving is bitwise the plain calls."""
    _need_cuda()
    import torch.distributed as dist

    from linearcorex_tpu_torch.parallel import sharding as S
    from linearcorex_tpu_torch.parallel.launch import init_local_group
    x = torch.as_tensor(_small_blocks()[0], dtype=torch.float32,
                        device="cuda")
    kw = dict(n_hidden=8, seed=0, max_iter=200, tol=1e-4,
              matmul_dtype=matmul_dtype, device="cuda")
    var = S.ShardingPlan(shard_samples=False, shard_vars=True)
    init_local_group("nccl", 0, 1, str(tmp_path / "rendezvous"),
                     timeout=120.0)
    try:
        for axes, plan, strategy in (
                ((("var", 1),), var, "gram"),
                ((("data", 1), ("model", 1)),
                 S.ShardingPlan(shard_factors=True), "samples")):
            mesh = S.make_mesh(axes)
            a = lct.Corex(**kw).fit(x, mesh=mesh, sharding_plan=plan)
            b = lct.Corex(moment_strategy=strategy, use_pallas="never",
                          **kw).fit(x)
            assert torch.equal(a.ws, b.ws) and a.tc == b.tc
            assert torch.equal(a.diagnostics.iters_per_stage,
                               b.diagnostics.iters_per_stage)
        mesh = S.make_mesh((("var", 1),))
        assert torch.equal(a.transform(x), b.transform(x))
        y = b.transform(x)
        served = lct.Corex(moment_strategy="gram", **kw).fit(
            x, mesh=mesh, sharding_plan=var)
        plain = lct.Corex(moment_strategy="gram", use_pallas="never",
                          **kw).fit(x)
        assert torch.equal(served.transform(x, mesh=mesh),
                           plain.transform(x))
        assert torch.equal(served.predict(y, mesh=mesh).full_tensor(),
                           plain.predict(y))
        assert served.score(x, mesh=mesh) == plain.score(x)
        CM.ns_chain.launches = 0
        k = lct.Corex(use_pallas="always", **kw).fit(
            x, mesh=mesh, sharding_plan=var)
        launches = CM.ns_chain.launches
        CM.ns_chain.launches = 0
        TS.counts.reset()
        kp = lct.Corex(use_pallas="always", **kw).fit(x)
        # the mesh fit runs its loop uncaptured: the plain fit's launches
        # less those of its captured chunks' masked evaluations
        assert launches > 0 and launches == \
            CM.ns_chain.launches - TS.counts.masked_launches
        assert torch.equal(k.ws, kp.ws) and k.tc == kp.tc
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_a_mesh_is_held_to_its_worlds_backend(tmp_path):
    """An NCCL world carries a CUDA mesh and refuses a CPU mesh by name
    (the mirror of the gloo world's refusal of a CUDA mesh, which the
    CPU tests cover)."""
    _need_cuda()
    import torch.distributed as dist

    from linearcorex_tpu_torch.parallel import sharding as S
    from linearcorex_tpu_torch.parallel.launch import init_local_group
    init_local_group("nccl", 0, 1, str(tmp_path / "rendezvous"),
                     timeout=120.0)
    try:
        assert S.check_mesh(S.make_mesh()).type == "cuda"
        with pytest.raises(ValueError, match="needs the gloo backend"):
            S.make_mesh(device="cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("matmul_dtype", ["float32", "int8"])
def test_moment_input_and_staged_mesh_forms_in_a_world_of_one(
        tmp_path, matmul_dtype):
    """One NCCL rank on the card: the mesh accumulator, partial_fit with
    the mesh on the first call and the mesh checkpointed fit are their
    plain forms bit for bit (the var plan turns the kernel off, so the
    plain forms run use_pallas='never'); the accumulator's correlation is
    bitwise the plain one."""
    _need_cuda()
    import torch.distributed as dist

    from linearcorex_tpu_torch.parallel import sharding as S
    from linearcorex_tpu_torch.parallel.launch import init_local_group
    from linearcorex_tpu_torch.utils.checkpoint import fit_with_checkpoints
    x = torch.as_tensor(_small_blocks()[0], dtype=torch.float32,
                        device="cuda")
    kw = dict(n_hidden=8, seed=0, max_iter=200, tol=1e-4,
              matmul_dtype=matmul_dtype)

    def same(a, b):
        return (torch.equal(a.ws, b.ws) and a.tc == b.tc
                and torch.equal(a.diagnostics.iters_per_stage,
                                b.diagnostics.iters_per_stage))

    init_local_group("nccl", 0, 1, str(tmp_path / "rendezvous"),
                     timeout=120.0)
    try:
        mesh = S.make_mesh((("var", 1),))
        acc, ref = lct.GramAccumulator(x.shape[1], mesh=mesh), \
            lct.GramAccumulator(x.shape[1])
        for i in range(0, x.shape[0], 500):
            acc.update(x[i:i + 500])
            ref.update(x[i:i + 500])
        assert torch.equal(acc.correlation().full_tensor(),
                           ref.correlation())
        assert same(acc.fit(**kw), ref.fit(use_pallas="never", **kw))
        a = lct.Corex(device="cuda", **kw)
        b = lct.Corex(device="cuda", use_pallas="never", **kw)
        for k, i in enumerate((0, 1000)):
            a.partial_fit(x[i:i + 1000], mesh=mesh if k == 0 else None)
            b.partial_fit(x[i:i + 1000])
        assert same(a, b)
        assert same(
            fit_with_checkpoints(lct.Corex(device="cuda", **kw), x,
                                 str(tmp_path / "mesh"), mesh=mesh,
                                 sharding_plan=S.ShardingPlan(
                                     shard_samples=False, shard_vars=True)),
            fit_with_checkpoints(lct.Corex(device="cuda", use_pallas="never",
                                           **kw), x, str(tmp_path / "one")))
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_matmul_precision_high_runs_tf32_on_the_card():
    """'high' runs the float32 products in TF32 (the Σ·Wᵀ product moves,
    by less than 1e-2 relative), 'highest' at full float32 (bitwise the
    product outside any scope with TF32 off), and a 'high' fit runs and
    hands the caller's setting back."""
    _need_cuda()
    from linearcorex_tpu_torch.config import CorexConfig
    from linearcorex_tpu_torch.models.corex import precision_ctx
    gen = torch.Generator(device="cuda").manual_seed(0)
    a = torch.randn((2048, 2048), generator=gen, device="cuda")
    b = torch.randn((2048, 64), generator=gen, device="cuda")
    with TM.full_f32_matmul():
        exact = a @ b
    with precision_ctx(CorexConfig(matmul_precision="high"), "cuda"):
        tf32 = a @ b
    with precision_ctx(CorexConfig(matmul_precision="highest"), "cuda"):
        full = a @ b
    rel = float((tf32 - exact).abs().max() / exact.abs().max())
    assert 0 < rel < 1e-2
    assert torch.equal(full, exact)
    prev = torch.get_float32_matmul_precision()
    x = torch.as_tensor(_small_blocks()[0], dtype=torch.float32,
                        device="cuda")
    c = lct.Corex(n_hidden=8, seed=0, max_iter=200, matmul_precision="high",
                  device="cuda").fit(x)
    assert np.isfinite(c.tc)
    assert torch.get_float32_matmul_precision() == prev


@pytest.mark.cuda
def test_warmup_builds_so_that_the_fit_builds_nothing(tmp_path, monkeypatch):
    """On a fresh LINEARCOREX_TPU_CACHE_DIR, Corex.warmup builds the chain
    kernel, the Σ-product kernel and the host library of the seeded start
    there and launches both kernels; the fit after it builds nothing, adds
    no file, runs the kernels, and is the unwarmed fit bit for bit."""
    _need_cuda()
    from linearcorex_tpu_torch.ops import seeded
    from linearcorex_tpu_torch.utils import compile_cache as CC
    from linearcorex_tpu_torch.utils import native
    monkeypatch.setattr(CC, "_cache_dir", None)
    monkeypatch.setenv("LINEARCOREX_TPU_CACHE_DIR", str(tmp_path))
    monkeypatch.delenv("LINEARCOREX_TPU_NO_COMPILE_CACHE", raising=False)
    CM._kernel.cache_clear()       # load the libraries from the new directory
    CM._sigma_kernel.cache_clear()
    # and the host library, whatever an earlier test loaded
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(seeded, "_lib", None)
    try:
        gen = torch.Generator(device="cuda").manual_seed(0)
        x = torch.randn((2000, 512), generator=gen, device="cuda")
        kw = dict(n_hidden=32, seed=0, max_iter=100, device="cuda")
        done = len(build.COMPILES)
        launches = CM.ns_chain.launches, CM.sigma_gemm.launches
        model = lct.Corex(**kw).warmup(*x.shape)
        torch.cuda.synchronize()
        assert model.ws is None
        assert sorted(c["what"] for c in build.COMPILES[done:]) == sorted(
            ["ns_chain.cu", "sigma_gemm.cu", " + ".join(build.HOST_SOURCES)])
        assert all(c["path"].startswith(str(tmp_path))
                   for c in build.COMPILES[done:])
        assert CM.ns_chain.launches > launches[0]
        assert CM.sigma_gemm.launches > launches[1]
        files = sorted(tmp_path.iterdir())
        launches = CM.ns_chain.launches, CM.sigma_gemm.launches
        model.fit(x)
        torch.cuda.synchronize()
        assert len(build.COMPILES) == done + 3
        assert sorted(tmp_path.iterdir()) == files
        assert CM.ns_chain.launches > launches[0]
        assert CM.sigma_gemm.launches > launches[1]
        plain = lct.Corex(**kw).fit(x)
        assert torch.equal(model.ws, plain.ws) and model.tc == plain.tc
    finally:
        CM._kernel.cache_clear()
        CM._sigma_kernel.cache_clear()


@pytest.mark.cuda
def test_outputs_follow_the_input_kind_on_the_card():
    """A CUDA model: NumPy in gives NumPy out, bitwise the host copy of the
    tensor call's output, and a CUDA tensor in gives a CUDA tensor out; a
    fit on NumPy reports its attributes in NumPy, bitwise those of the
    same fit on a tensor; np.asarray reads every public output of it, and
    the JAX example's `np.asarray(x_hat) - x` runs."""
    _need_cuda()
    from linearcorex_tpu_torch.core.solver import host_numpy
    x, _ = _small_blocks()
    xt = torch.as_tensor(x, dtype=torch.float32, device="cuda")
    kw = dict(n_hidden=8, seed=0, max_iter=200)
    c = lct.Corex(**kw).fit(x)
    t = lct.Corex(**kw).fit(xt)
    assert c.ws.is_cuda
    for name in ("tcs", "mis", "clusters"):
        a, b = getattr(c, name), getattr(t, name)
        assert type(a) is np.ndarray and b.is_cuda, name
        assert np.array_equal(a, host_numpy(b)), name
    v = np.linspace(-1, 1, 256)
    for name, call, arg in (
            ("transform", c.transform, x),
            ("predict", c.predict, c.transform(x)),
            ("inverse_transform", c.inverse_transform, c.transform(x)),
            ("covariance_matvec", c.covariance_matvec, v),
            ("covariance_matmat", c.covariance_matmat, v[:, None])):
        out, ref = call(arg), call(torch.as_tensor(arg, device="cuda"))
        assert type(out) is np.ndarray and out.dtype == np.float32, name
        assert ref.is_cuda and np.array_equal(out, host_numpy(ref)), name
    y, mom = c.transform(x, details=True)
    outs = [c.tcs, c.mis, c.clusters, y, *mom.values(), c.predict(y),
            c.get_covariance(), next(c.covariance_blocks(64))[1],
            c.fit_transform(x), c.covariance_matvec(v)]
    for out in outs:
        assert type(np.asarray(out)) is np.ndarray
        assert np.isfinite(np.asarray(out)).all()
    x_hat = c.predict(y)
    resid = np.linalg.norm(np.asarray(x_hat) - x) / np.linalg.norm(x)
    assert 0 < resid < 1


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["fit", "transform", "predict"])
def test_stack_on_numpy_makes_no_host_round_trip_on_the_card(method,
                                                             monkeypatch):
    """StackedCorex on NumPy: layer 1 takes the NumPy array, every deeper
    layer a CUDA tensor, and the only device-to-host copy is the one of
    the returned array (`host_numpy`, through which the output rule reads
    back)."""
    _need_cuda()
    from linearcorex_tpu_torch.models import corex as TC
    x, _ = _small_blocks()
    kw = dict(seed=0, max_iter=200)
    s = lct.StackedCorex([8, 2], **kw).fit(x)
    y = s.transform(x)
    assert type(y) is np.ndarray
    seen, reads = [], []
    for name in ("_transform", "_predict"):
        real = getattr(TC.Corex, name)

        def spy(self, a, *args, _real=real, **kwargs):
            seen.append(a.device.type if isinstance(a, torch.Tensor)
                        else type(a).__name__)
            return _real(self, a, *args, **kwargs)
        monkeypatch.setattr(TC.Corex, name, spy)
    real_host = TC.host_numpy
    monkeypatch.setattr(TC, "host_numpy",
                        lambda t: reads.append(t.device.type)
                        or real_host(t))
    if method == "fit":
        lct.StackedCorex([8, 2], **kw).fit(x)
    else:
        out = getattr(s, method)(y if method == "predict" else x)
        assert type(out) is np.ndarray
    assert seen == ["ndarray", "cuda"]
    assert reads == ([] if method == "fit" else ["cuda"])


def _block_data(n=1000, p=64, m=8, seed=0, strength=0.9):
    """tests/conftest.py's `block_data` (this file does not import it):
    p variables in m equal blocks, each driven by one latent factor."""
    rng = np.random.RandomState(seed)
    z = rng.normal(size=(n, m))
    k = p // m
    x = np.empty((n, p))
    for j in range(m):
        for i in range(k):
            x[:, j * k + i] = strength * z[:, j] + np.sqrt(
                1.0 - strength ** 2) * rng.normal(size=n)
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("strategy", ["samples", "gram"])
@pytest.mark.parametrize("optimizer",
                         ["momentum", "fixed_point", "gd", "auto"])
def test_f64_card_fit_step_matched_with_oracle(strategy, optimizer):
    """A float64 fit on the card (cuBLAS, cuSOLVER) from the same W0 as
    the port's float64 oracle (NumPy, SciPy): the same iterations per
    stage and clusters, TC, W, tcs and mis within 1e-8
    (tests/test_torch_corex.py's bar on the CPU), and every iteration's TC
    within 1e-8 relative (plain GD drifts to ~2e-9 relative on the CPU)."""
    _need_cuda()
    x = _block_data()
    w0 = np.random.RandomState(42).normal(scale=1 / 8, size=(8, 64))
    kw = dict(n_hidden=8, optimizer=optimizer)
    if optimizer == "gd":
        kw["max_iter"] = 300      # plain GD converges slowly; cap stages
    c = lct.Corex(dtype="float64", moment_strategy=strategy, **kw).fit(
        x, init_ws=w0)
    o = OracleCorex(**kw).fit(x, init_ws=w0)
    assert c.ws.device.type == "cuda"
    assert c.diagnostics.iters_per_stage.tolist() == \
        o.history["iters_per_stage"]
    assert c.resolved_optimizer_ == o.resolved_optimizer_
    assert abs(c.tc - o.tc) < 1e-8
    assert np.abs(c.ws.cpu().numpy() - o.ws).max() < 1e-8
    assert np.array_equal(c.clusters, o.clusters)
    assert np.abs(c.tcs - o.tcs).max() < 1e-8
    assert np.abs(c.mis - o.mis).max() < 1e-8
    assert np.allclose(c.history["TC"], o.history["TC"], rtol=1e-8, atol=0)


# --- the solver's loop as a captured CUDA graph ---------------------------

def _loop_problem(lanes, m, matmul_dtype, optimizer, p=512,
                  overlap=False, use_pallas="always"):
    """(objective, W0, config) of a fit at n = 2,000 on the card, through
    the chain kernel unless `use_pallas` says otherwise (the overlap
    objective has none)."""
    from linearcorex_tpu_torch.models import corex as TCX
    from linearcorex_tpu_torch.parallel.restarts import init_restarts
    x = _block_data(n=2000, p=p, m=8, seed=3)
    kw = dict(discourage_overlap=False) if overlap else dict(
        optimizer=optimizer, use_pallas=use_pallas)
    model = lct.Corex(n_hidden=m, seed=0, max_iter=150,
                      matmul_dtype=matmul_dtype, **kw)
    data, cfg, strategy = model._prepare_fit(x)
    w0 = model._resolve_w0(None) if not lanes else init_restarts(
        lanes[0], m, p, 0, torch.float32, "cuda")
    return TCX._make_obj_grad(data, cfg, strategy), w0, cfg


def _loop_run(obj_grad, w0, cfg, **kw):
    """fit_core's result, the loop counts and the kernel's launches of one
    fit."""
    TS.counts.reset()
    CM.ns_chain.launches = CM.ns_chain.lane_launches = 0
    with TM.full_f32_matmul():
        ws, diag = TS.fit_core(obj_grad, w0, cfg, **kw)
    torch.cuda.synchronize()
    return ws, diag, TS.counts.as_dict(), (CM.ns_chain.launches,
                                           CM.ns_chain.lane_launches)


@pytest.mark.cuda
@pytest.mark.parametrize("optimizer", ["fixed_point", "momentum"])
@pytest.mark.parametrize("matmul_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("lanes,m", [((), 32), ((4,), 8), ((4,), 32)])
def test_captured_loop_is_bitwise_the_uncaptured_loop(lanes, m,
                                                      matmul_dtype,
                                                      optimizer):
    """The fit replays a captured graph of K bodies (the path's choice)
    and ends with the uncaptured loop's bits in W and every diagnostic; the kernel's counters count each replay, so the captured
    fit launches it once per evaluation run, masked ones included."""
    _need_cuda()
    obj_grad, w0, cfg = _loop_problem(lanes, m, matmul_dtype, optimizer)
    ws_u, d_u, c_u, l_u = _loop_run(obj_grad, w0, cfg, _capture=False)
    ws_c, d_c, c_c, l_c = _loop_run(obj_grad, w0, cfg)
    # (4 fixed-point lanes at m <= 128 take cuSOLVER's batched LU)
    assert c_c["captured_fits"] == 1
    assert c_u["captured_fits"] == 0 and c_u["masked"] == 0
    assert torch.equal(ws_c, ws_u)
    for f in d_u._fields:
        a, b = getattr(d_c, f), getattr(d_u, f)
        assert a.device == b.device and a.dtype == b.dtype, f
        assert torch.equal(a, b), f
    assert c_c["iterations"] == c_u["iterations"]
    k = 1 if lanes else 0
    assert l_u[1 - k] == 0 and l_c[1 - k] == 0
    assert l_u[k] == c_u["first_evaluations"] + c_u["iterations"]
    assert l_c[k] == c_c["first_evaluations"] + c_c["bodies"]
    assert l_c[k] - l_u[k] == c_c["masked"] == c_c["masked_launches"]
    stages = d_u.iters_per_stage.shape[-1]
    assert c_c["host_reads"] <= -(-c_c["iterations"] // TS.CHUNK) \
        + stages + 1


@pytest.mark.cuda
@pytest.mark.parametrize("overlap,lanes", [(False, (16,)), (True, ()),
                                           (True, (3,))])
def test_captured_loop_bitwise_off_the_kernel(overlap, lanes):
    """The plain chain's graph (use_pallas='never') at the selection's m
    = 8 over 16 lanes, and the overlap objective (cuSOLVER's Cholesky for
    one lane, captured; MAGMA's batched solve for lanes, not)."""
    _need_cuda()
    obj_grad, w0, cfg = _loop_problem(lanes, 8, "float32", "fixed_point",
                                      overlap=overlap, use_pallas="never")
    ws_u, d_u, c_u, _ = _loop_run(obj_grad, w0, cfg, _capture=False)
    ws_c, d_c, c_c, _ = _loop_run(obj_grad, w0, cfg)
    assert c_c["captured_fits"] == (0 if overlap and lanes else 1)
    assert torch.equal(ws_c, ws_u)
    for f in d_u._fields:
        assert torch.equal(getattr(d_c, f), getattr(d_u, f)), f


@pytest.mark.cuda
def test_a_failed_capture_raises_by_name():
    """An objective that reads the device cannot be captured: the fit
    raises, naming itself, and does not run on uncaptured; the card
    serves the next fit."""
    _need_cuda()
    obj_grad, w0, cfg = _loop_problem((), 32, "float32", "fixed_point")

    def reads(ws, eps):
        f, g, tc = obj_grad(ws, eps)
        float(f)
        return f, g, tc
    with pytest.raises(RuntimeError, match=r"capturing the accept/reject "
                       r"loop of the \(m, p\) = \(32, 512\) fit"):
        TS.fit_core(reads, w0, cfg)
    ws_u, d_u, _, _ = _loop_run(obj_grad, w0, cfg, _capture=False)
    ws_c, d_c, _, _ = _loop_run(obj_grad, w0, cfg)
    assert torch.equal(ws_c, ws_u)


@pytest.mark.cuda
def test_mesh_fit_and_corex_fit_choose_their_loop(tmp_path):
    """Corex.fit on the card replays a graph, a world-of-one mesh fit runs
    the same body uncaptured, and both give the plain samples fit's
    bits."""
    _need_cuda()
    import torch.distributed as dist

    from linearcorex_tpu_torch.parallel import sharding as S
    from linearcorex_tpu_torch.parallel.launch import init_local_group
    x = _block_data(n=2000, p=256, m=8, seed=1)
    kw = dict(n_hidden=8, seed=0, max_iter=150, optimizer="fixed_point")
    TS.counts.reset()
    plain = lct.Corex(moment_strategy="samples", **kw).fit(x)
    assert TS.counts.fits == TS.counts.captured_fits == 1
    init_local_group("nccl", 0, 1, str(tmp_path / "rendezvous"),
                     timeout=120.0)
    try:
        TS.counts.reset()
        meshed = lct.Corex(**kw).fit(x, mesh=S.make_mesh())
        assert TS.counts.fits == 1 and TS.counts.captured_fits == 0
    finally:
        dist.destroy_process_group()
    assert np.array_equal(meshed.ws.cpu().numpy(), plain.ws.cpu().numpy())
    assert torch.equal(meshed.diagnostics.iters_per_stage,
                       plain.diagnostics.iters_per_stage)


# --- the fit's spans on the profiler's clock ------------------------------

@pytest.mark.cuda
def test_spans_and_kernels_share_one_clock(tmp_path):
    """A default fit on the card under `utils.profiling.trace`: every
    kernel launched inside `lcx.prepare.operand` (the Gram's products)
    starts on the device inside that range, every kernel of a graph
    replay (launched by `cudaGraphLaunch`) inside `lcx.solve`, and the
    loop's capture lies in its first stage. The profiled fit gives the
    unprofiled fit's bits."""
    _need_cuda()
    import json

    from linearcorex_tpu_torch.utils import profiling
    x = torch.as_tensor(_block_data(n=2000, p=512, m=8, seed=3),
                        dtype=torch.float32, device="cuda")
    kw = dict(n_hidden=16, seed=0, max_iter=150)
    lct.Corex(**kw).warmup(*x.shape)
    plain = lct.Corex(**kw).fit(x)
    with profiling.trace(str(tmp_path)):
        traced = lct.Corex(**kw).fit(x)
    for a, b in zip([plain.ws, *plain.moments, *plain.diagnostics],
                    [traced.ws, *traced.moments, *traced.diagnostics]):
        assert torch.equal(a, b)

    path, = tmp_path.glob("*.json")
    events = json.loads(path.read_text())["traceEvents"]

    def ranges(name):
        return [(e["ts"], e["ts"] + e["dur"]) for e in events
                if e.get("cat") == "user_annotation" and e["name"] == name]

    def within(t, spans):
        # the trace's microseconds are rounded to the nanosecond
        return any(a - 0.01 <= t <= b + 0.01 for a, b in spans)

    launches = {e["args"]["correlation"]: e for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}

    def launch(kernel):
        return launches.get(kernel["args"].get("correlation"), {})

    kernels = [e for e in events if e.get("cat") == "kernel"]
    assert kernels, "the trace holds no kernel"
    operand, solve = ranges("lcx.prepare.operand"), ranges("lcx.solve")
    stages, capture = ranges("lcx.stage"), ranges("lcx.capture")
    assert len(operand) == len(solve) == len(capture) == 1
    assert within(capture[0][0], stages[:1]) and \
        within(capture[0][1], stages[:1])
    gram = [k for k in kernels
            if within(launch(k).get("ts", -1.0), operand)]
    replayed = [k for k in kernels
                if launch(k).get("name") == "cudaGraphLaunch"]
    assert gram and any("gemm" in k["name"].lower() for k in gram)
    assert replayed
    for k in gram:
        assert within(k["ts"], operand), k["name"]
    for k in replayed:
        assert within(k["ts"], solve), k["name"]


# --- the Gram path's Σ product (csrc/sigma_gemm.cu) ------------------------

def _rel_err(c, want):
    return float((c.double() - want).abs().max() / want.abs().max())


@functools.cache
def _north_star_sigma():
    """Σ of the north-star cell's data (portbench's generator, seed 0) as
    the fit prepares it, and W of a short default fit on that data."""
    from portbench import datagen
    x = datagen.block_data(10000, 10000, 100, 0.9, 0.436, 0, "cuda")
    model = lct.Corex(n_hidden=512, seed=0, max_iter=30, device="cuda")
    sigma = model._prepare_fit(x)[0]
    model.fit(x)
    return sigma, model.ws


@pytest.mark.cuda
@pytest.mark.parametrize("operand", ["fit_w", "random"])
def test_sigma_gemm_as_exact_as_cublas_at_the_north_star(operand):
    """At p = 10,000, n = 512, on the cell's Σ with a fit's Wᵀ (a strided
    view, as the Gram path hands it over) or a random V: the kernel's
    max|C − C₆₄| / max|C₆₄| is at most twice cuBLAS's full-float32
    product's on the same inputs, and the product is launched once a
    call."""
    _need_cuda()
    sigma, ws = _north_star_sigma()
    gen = torch.Generator(device="cuda").manual_seed(1)
    v = ws.T if operand == "fit_w" else torch.randn(
        (10000, 512), generator=gen, device="cuda")
    before = CM.sigma_gemm.launches
    got = CM.sigma_gemm(sigma, v)
    plain = CM.sigma_gemm_reference(sigma, v)
    torch.cuda.synchronize()
    assert CM.sigma_gemm.launches == before + 1
    want = sigma.double() @ v.double()
    assert _rel_err(got, want) <= 2 * _rel_err(plain, want)


@pytest.mark.cuda
@pytest.mark.parametrize("p,m,lanes", [(999, 7, 1), (1030, 1030, 1),
                                       (10000, 7, 1), (10000, 512, 4)])
def test_sigma_gemm_ragged_and_lanes(p, m, lanes):
    """Ragged p and n (Σ's rows copied into 16-byte rows at p = 999,
    1030) and four restart lanes side by side (n = 2,048, `_lanes`'s
    layout): within twice cuBLAS's float32 error of float64, and a second
    launch bitwise the first."""
    _need_cuda()
    x = torch.from_numpy(_standardized(2 * p, p, seed=p)).to("cuda")
    sigma = CM.sigma_gemm_reference(x.T, x) / (2 * p)
    gen = torch.Generator(device="cuda").manual_seed(p + m)
    ws = 0.1 * torch.randn((lanes, m, p), generator=gen, device="cuda")
    handed = []
    TM._lanes(lambda v: handed.append(v) or v,
              ws.mT if lanes > 1 else ws[0].mT)
    v = handed[0]
    got = CM.sigma_gemm(sigma, v)
    again = CM.sigma_gemm(sigma, v)
    plain = CM.sigma_gemm_reference(sigma, v)
    torch.cuda.synchronize()
    want = sigma.double() @ v.double()
    assert got.shape == (p, lanes * m)
    assert _rel_err(got, want) <= 2 * _rel_err(plain, want)
    assert torch.equal(got, again)


@pytest.mark.cuda
def test_sigma_gemm_replayed_is_bitwise_eager_and_counted():
    """The product captured into a CUDA graph (under `counting_capture`,
    as the solver captures its loop) replays bitwise the eager call; the
    capture adds to the tally, not the counter, and each replay counted
    by `count_replay` adds one launch; the chain's keys stay 0."""
    _need_cuda()
    sigma, ws = _north_star_sigma()
    v = ws.T
    eager = CM.sigma_gemm(sigma, v)
    before = CM.sigma_gemm.launches
    graph = torch.cuda.CUDAGraph()
    with CM.counting_capture() as tally:
        with torch.cuda.graph(graph):
            out = CM.sigma_gemm(sigma, v)
    assert CM.sigma_gemm.launches == before
    assert tally == {"launches": 0, "lane_launches": 0, "sigma_gemm": 1}
    for _ in range(2):
        out.zero_()
        graph.replay()
        CM.count_replay(tally)
        torch.cuda.synchronize()
        assert torch.equal(out, eager)
    assert CM.sigma_gemm.launches == before + 2
    graph.reset()


@pytest.mark.cuda
@pytest.mark.parametrize("precision,kernel", [("default", True),
                                              ("high", False)])
def test_default_fit_runs_the_sigma_kernel(precision, kernel):
    """A default float32 Gram fit on the card runs its Σ products in the
    kernel, every evaluation; under matmul_precision='high' they stay one
    TF32 pass on cuBLAS and the kernel is never launched."""
    _need_cuda()
    x = _block_data(n=2000, p=512, m=8, seed=3)
    before = CM.sigma_gemm.launches
    TS.counts.reset()
    c = lct.Corex(n_hidden=16, seed=0, max_iter=100,
                  matmul_precision=precision, device="cuda").fit(x)
    ran = CM.sigma_gemm.launches - before
    assert np.isfinite(c.tc)
    if kernel:
        # one product a fixed-point evaluation, two a momentum one
        assert ran >= TS.counts.first_evaluations + TS.counts.bodies
    else:
        assert ran == 0
