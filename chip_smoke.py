#!/usr/bin/env python3
"""Drive the PyTorch port of Linear CorEx once on one CUDA card, and check it.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one NVIDIA Hopper card
(H100), nvcc and PyTorch built for CUDA. It imports nothing of JAX. Each
phase prints one JSON line; any failed phase raises, so the script exits
non-zero and does not print the final line.

1. env       card name and power limit, torch/CUDA versions; TF32 off.
2. build     compiles linearcorex_tpu_torch/csrc/ns_chain.cu for sm_90a
             (nvcc) and the host library from csrc/*.cpp (g++), both
             started together; ptxas must report 0 spill bytes for every
             kernel, and the library must hold HGMMA (wgmma) instructions
             (cuobjdump -sass), so the products demonstrably run on the
             tensor cores.
   native    the host library is available; its ndtri against
             torch.special.ndtri (float64) to 1e-12; a generated 2000 x 64
             CSV read by CsvReader equal to the pure-Python reader.
             Reported: the two routes of 'empirical' preprocessing for a
             NumPy input at n = p = 10,000, ranked on the card or by the
             host library; the card's must be the faster (it is the one
             Corex takes on a CUDA device) and the two must agree.
3. kernels   the chain kernel against its plain PyTorch twin at
             (p, m) = (10000, 512), (512, 32) (a stack's layer 2),
             (400, 100), (999, 7), (257, 130), (1, 8), (37, 256),
             (1024, 8), (300, 520), (2000, 1030):
             max|kernel - twin| / max|twin| < 1e-5 for every output, and
             a second launch bitwise equal to the first.
   kernels_lanes  the lane entry (every lane in one launch per pass)
             against the batched twin at (k, p, m) = (4, 10000, 512),
             (3, 999, 7), (32, 1024, 8) and (16, 1024, 8), the last two
             padded selection grids whose 5 or 3 zero W rows per lane must
             give exactly zero AA rows and H entries: within 1e-5 for every
             output, every lane bitwise equal to a one-lane launch on its
             inputs, a second launch bitwise equal to the first.
4. operands  the int8 and bf16 products on the card at (p, m) = (10000,
             512) and (999, 7): quantize_gram, _quant_cols and every int8
             product bitwise equal to the same call on the CPU, the scaled
             Σ-applications within 1e-6 relative; _mm_bf16 in float32,
             within BF16_TOL of the largest magnitude of the exact product
             of the bf16-rounded operands (a bf16-rounded output misses).
5. fit       the main paths, each with the launch count set to 0 just
             before and read just after: Corex(n_hidden=512,
             optimizer='auto', seed=0).fit(x) on block data with n = p =
             10,000 and 100 planted blocks (gram strategy, damped fixed
             point, the chain kernel) in float32 ('fit'), with
             matmul_dtype='int8' (the JAX package's benchmark
             configuration, 'fit_int8') and 'bfloat16' ('fit_bf16'), and
             preset='throughput' (int8, spectral W0, anneal=False,
             'fit_throughput'). Each must run the kernel, resolve the fixed
             point and give a finite TC and transform; int8 must pass the
             wrap guard silently. The share of blocks landing whole in one
             cluster is reported against a bar of 0.95 (see BLOCKS_BAR).
             The float32 fit with use_pallas='never' is reported beside it.
   fit_restarts  Corex(n_hidden=512, n_restarts=4, seed=0,
             optimizer='auto').fit(x) on the same data in float32 and
             with matmul_dtype='int8': each must run the lane kernel,
             resolve the fixed point, keep the lane of the highest TC
             (best_restart_), give a finite TC and transform, and pass the
             int8 wrap guard silently. Reported: the winner's block share
             against BLOCKS_BAR, the sweep's wall and peak device memory
             against four single fits with seeds 0-3.
   serving   on the float32 north-star model: predict/inverse_transform
             finite; covariance_matmat of 8 random columns equal to
             get_covariance() @ V within 1e-5 relative; the first and
             last covariance_blocks(4096) blocks equal to those rows of
             get_covariance(); score(x) finite and above the score of x
             with its columns shuffled.
   host_outputs  outputs follow the kind of their input, on the same
             model: a NumPy copy of x in gives float32 ndarrays out,
             transform (n, m) and predict (n, p) bitwise host_numpy of the
             tensor calls, which give CUDA tensors; two north-star fits on
             the NumPy copy (through the kernel) give tcs/mis/clusters as
             ndarrays bitwise the tensor fit's host copies, np.asarray
             reads every public output and np.linalg.norm(recon - x)
             runs, and the two fits pass a hand-rolled
             check_fit_idempotent (np.issubdtype on every output dtype).
             Reported: transform of the 10,000 rows NumPy in and out
             against tensor in and out, and the host-side NaN/inf scan,
             the host-to-device copy, the product and the device-to-host
             copy apart (CUDA events, min of 3, in turns).
   sharded   a world of one rank on the card (torch.distributed, NCCL
             by default, a file rendezvous, no network; the backend is
             printed): Corex(n_hidden=512, optimizer='auto', seed=0).fit(x,
             mesh=make_mesh()) in float32 and with matmul_dtype='int8'. The
             plan rule must resolve the samples strategy, and the fit must
             be the plain moment_strategy='samples' fit from the same W0
             bit for bit (W, TC, iterations per stage), through the kernel
             with the same launches; its collectives (kind, op, axis,
             bytes, calls) must be one (p, m) all-reduce per objective
             evaluation and one for the final moments (int8: a max of m
             floats and an int32 sum per evaluation). Corex(n_restarts=4)
             .fit(x, mesh=make_mesh((("restarts", 1),))) must be the plain
             4-lane sweep bit for bit, through the lane kernel, with
             nothing on the restarts axis but the gathers that end it;
             transform(mesh=) and score(mesh=) on the float32 model bitwise
             the plain calls. Reported: wall seconds and iterations/s of
             the mesh fit and the plain samples fit, beside the gram fit's.
   sharded_vars  the same world of one: Corex.fit(x, mesh=) under the
             variable and factor plans, var (the gram strategy with Σ's
             rows over `var`, and samples), data x var, factor and data x
             factor, in float32 and with matmul_dtype='int8': each must be
             the plain fit with use_pallas='never' of the strategy its
             plan resolves bit for bit (W, TC, iterations per stage; the
             plans turn the chain kernel off), with no collective payload
             beyond max(n·m, m·p). The var fit with use_pallas='always'
             must gather C_xy once per evaluation, launch the kernel as
             often as the plain kernel fit and end bitwise where it does.
             transform/predict/score/covariance_blocks(mesh=) under the
             var plan bitwise the plain calls (predict and the blocks as
             DTensors split over `var`), get_covariance() raising by
             name. Reported: one m x p all-gather over `var` alone, and
             the mesh fits' walls beside the plain fits'.
   sharded_stream  the same world of one: the moment-input and staged
             fits over `make_mesh((("var", 1),))`, each bitwise its plain
             form (W, TC, iterations per stage; the var plan turns the
             kernel off on 'auto', so the plain forms run with
             use_pallas='never'): GramAccumulator(P, mesh=) over ten
             1000-row batches, its correlation() bitwise the plain one,
             acc.fit in float32 and int8, and with use_pallas='always'
             against the plain kernel fit with the same launches;
             fit_from_covariance(mesh=) of the accumulated covariance;
             partial_fit over two halves with the mesh on the first call;
             fit_with_checkpoints(mesh=) whole, cut after stage 2 and
             resumed under the mesh, and the mesh checkpoint resumed on
             one device; StackedCorex([512, 32]) under the var plan
             against the plain stack whose layer 1 runs 'never', and
             under the data plan against the plain samples stack, each
             launching the kernel as often (max_iter=300 per stage, a cut
             depth). Reported: accumulation ms per batch, mesh and plain
             in turns; ms per checkpoint stage; walls.
   precision the Σ·Wᵀ product at the north-star shape under
             matmul_precision 'high' must differ from the full-float32 one
             by more than 0 and less than 1e-2 relative (TF32 ran), and
             under 'highest' equal it bit for bit ('bfloat16' reported,
             and whether it equals the TF32 product); fit_core float32
             iterations/s with 'highest', 'high' and 'bfloat16' in turns;
             the annealed fit's TC and block share over seeds 0-5 with
             'high' and 'highest' (reported, not gated: TF32 moves the
             basin).
   streaming x in ten batches of 1000 rows into GramAccumulator(P) on the
             card: correlation() within 1e-5 of compute_gram of the
             standardized x; acc.fit(n_hidden=512, optimizer='auto',
             seed=0) runs the kernel, resolves the fixed point, gives a
             finite TC and transform; fit_from_covariance(
             acc.correlation(), n) from the same seed gives the same TC
             within 1e-6 relative where it is handed the same operand bit
             for bit (reported otherwise: normalizing a correlation again
             may move entries by an ulp, and a float32 fit at this shape
             then changes basin); from the accumulated covariance, which
             normalizes to the streamed operand bit for bit, it must give
             the streamed fit's TC. The same with matmul_dtype='int8', the
             wrap guard silent. Reported: TC and block share beside the
             in-memory fit's, accumulation and fit walls, peak memory.
   partial_fit  two calls of 5000 rows on one estimator: both solve
             through the kernel, the second warm-starts (its iterations
             reported against the first's), finite TC; a following fit
             drops the accumulation.
   checkpoint  fit_with_checkpoints of the float32 fit into a temporary
             directory, uninterrupted, then interrupted after stage 3 and
             resumed: the kernel runs in every stage, the resumed fit has
             the uninterrupted one's iterations per stage and its TC
             within 1e-6 relative; save_corex -> load_corex on the card
             transforms bitwise alike, and within 1e-5 relative when
             loaded with device="cpu".
   stacked   StackedCorex([512, 32], optimizer='auto', seed=0).fit(x):
             layer 1 through the kernel at full width, layer 2 on the
             (10,000, 512) factors, which stay on the card; every layer's
             TC finite and positive, transform (n, 32) and predict (n, p)
             finite. Layer 2 is then fitted again on the same factors from
             the same W0 with use_pallas='never': the kernel's fit must
             reach the plain chain's TC within 1e-3 relative; iterations
             per stage, walls and clusters of both are reported.
   default_paths  the paths a user reaches by default, each through
             Corex(n_hidden=512, seed=0, ...).fit at n = p = 10,000 (n =
             2,000 for the wide rows), max_iter=300 a stage (a cut depth):
             the library's own default (optimizer='momentum', gram) in
             float32 and with matmul_dtype 'int8' and 'bfloat16';
             dtype='bfloat16' and 'float16' (the chain kernel on float32
             casts); the n < p regime with optimizer='auto' (samples,
             momentum) in float32 and int8; the overlap objective on gram
             and samples (Cholesky, no kernel); 'empirical' and
             stage_subsample=0.5 (fixed point, kernel); dtype='float64'
             (cuBLAS and cuSOLVER in float64, no kernel). Gates: TC and W
             finite, the strategy and optimizer of the row, the kernel
             launched where the row says and nowhere else, the clusters a
             partition of p, a second momentum float32, bfloat16 and
             float64 fit bitwise the first, and the chain wrapper on
             bfloat16 and float16 operands bitwise the kernel on their
             float32 casts. Reported: wall, iterations per stage, TC,
             block share, peak bytes; fit_core ms per iteration of
             momentum (float32 and bfloat16) against the fixed point, in
             turns; the phase's seconds.
6. small     small fits on the card (n=2000, p=256, m=8) against the
             port's float64 CPU fit from the same W0 — same clusters, TC
             within 1e-3 relative: the non-overlap fit through the kernel
             ('small_reference'); the overlap objective (momentum, gram
             and samples), 'empirical' preprocessing and stage_subsample
             =0.5 ('small_paths'); 3-lane restart sweeps, non-overlap
             through the lane kernel and overlap, against the float64
             CPU sweep from the same seeds: same clusters, TC within
             1e-3, and a winning lane that is a best lane on the CPU too
             ('small_restarts'); streamed, partial_fit in four batches,
             checkpointed and two-layer stacked fits against the float64
             CPU results from the same W0 ('small_streaming').
             float64_card_vs_cpu: float64 fits on the card against the
             same fits on the CPU from one W0 (n=2000, p=1024, m=32, 8
             planted blocks): momentum on gram and on samples and the
             overlap objective must be step-matched (iterations per stage
             equal, TC and W within 1e-8); the fixed point is reported
             with the iteration where the pair parts (its near-singular
             m x m inverse parts two LAPACKs at this shape).
   selection pick_n_hidden on block data with n=2000, p=1024 and 4
             planted blocks of 256 (max_n_hidden=8, repeat=4,
             max_iter=2000), padded and sequential, criterion 'tc' and
             'heldout': each runs the lane kernel, and padded and
             sequential choose the same n_hidden per criterion. Reported:
             whether it is 4, and the walls.
   warmup    what a fresh process pays at its first call, and what the
             deploy-time warmups take off it: fresh `python3 -c` processes
             on the card, each call timed by the wall clock around it and
             a synchronize. At n = p = 10,000, m = 512: (a) cold, in
             float32, LINEARCOREX_TPU_CACHE_DIR an empty directory: the
             first Corex.fit, nvcc's and g++'s seconds within it, and g++
             alone after it; then in float32 and int8 (b) a new process
             on that directory: the first and second fits; (c) a new
             process on another empty directory: Corex.warmup(n, p)
             (nvcc within it), then the first and second fits. (d)
             load_corex of (b)'s float32 model, then
             warmup_serving(model, 4096): the first transform/score of
             4096 rows against the second. (e) warmup_sweep, then
             pick_n_hidden at the selection size (max_iter=200 a stage, a
             cut depth), first against second.
             Gates: (a) builds the kernel inside its first fit and (b)
             builds nothing; (c)'s warmup builds and launches the kernel,
             nothing is built and no file appears after it, and its first
             fit is (b)'s first fit bit for bit (W, TC, iterations per
             stage), its save_corex file (b)'s array for array; (e)'s
             warmup launches the lane kernel, and its sweep is the same
             sweep run in the script's own process (never warmed) bit
             for bit.
7. timing    fit_core iterations/s at p=10k, m=512 (gram, fixed_point,
             anneal=False, tol=0, 200 iterations): float32 with the kernel
             and with the plain chain, bf16 and int8 with the kernel; CUDA
             events, an untimed warm-up, min of 3, the versions in turns.
             The kernel alone against its twin, the same way, beside its
             bound (3xTF32 on the tensor cores, and on the CUDA cores) and
             the time torch.matmul takes for its two products alone in
             full float32 (products_library_ms: timed only, never called
             by the port). The lane kernel at (4, 10000, 512) against four
             one-lane launches and against the batched twin, with the same
             bounds and yardstick; fit_core on 4 lanes (float32 and int8,
             100 iterations) against the one-lane fit_core. The kernel
             against its twin at small m (8, 64, 128; p = 1024 and 10000),
             where a use_pallas='auto' gate would cross over.
8. profile   torch.profiler over 20 such iterations per operand mode and
             for 4 float32 lanes: wall, device-busy and idle time per
             iteration and the kernels that take the most device time.
   profiling utils.profiling.iteration_rate over the float32 fit_core run
             within 5% of this script's own CUDA-event figure for it; a
             utils.profiling.trace of three iterations holds a kernel of
             ns_chain.cu by name.

Before the last line it prints the kernels' summary line and the card's
`nvidia-smi` name and power limit; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

TOL_REL = 1e-5          # kernel vs twin, relative to the largest magnitude
N, P, M, BLOCKS = 10_000, 10_000, 512, 100
FIT_MAX_ITER, FIT_TOL = 1000, 1e-4
DATA_SEED = 0
# The share of planted blocks one fit recovers whole depends on the basin
# it lands in: 0.2-0.99 over data seeds, tolerances, optimizers and both
# chain paths on an H100 (PERF.md), so no single fit clears 0.95 reliably.
# The script reports the share against that bar and gates the fit on what
# is deterministic: the kernel ran, TC and transform are finite, and a
# small fit on the card agrees with the float64 CPU fit.
BLOCKS_BAR = 0.95
TIMED_ITERS = 200
TIMED_ITERS_LANES = 100
PROFILED_ITERS = 20
LANES = 4               # restart lanes of the north-star sweep
SEL_N, SEL_P, SEL_BLOCKS = 2000, 1024, 4
SMALL_TOL_REL = 1e-3    # card f32 fit vs the port's float64 CPU fit
STREAM_BATCH = 1000     # rows per batch of the streamed north-star fit
PF_MAX_ITER = 300       # per stage, for the two partial_fit solves
STACK = [M, 32]
STACK_TOL_REL = 1e-3    # a stack's layer 2: kernel fit vs plain-chain fit
STACK_MAX_ITER = 300    # per stage, for the mesh stacks of sharded_stream
WARMUP_ROWS = 4096      # rows of a serving batch in phase warmup
# per stage, for phase warmup's sweeps (selection runs 2000, ~29 s a sweep)
WARMUP_SWEEP_MAX_ITER = 200
WARMUP_CHILD_TIMEOUT = 600
WIDE_N = 2000           # rows of phase default_paths' n < p rows
DEFAULT_MAX_ITER = 300  # per stage, for phase default_paths (a cut depth)
F64_TOL = 1e-8          # float64 card fit vs float64 CPU fit, TC and W
F64_MAX_ITER = 300      # per stage, for phase float64_card_vs_cpu
F64_GATED = ("momentum_gram", "momentum_samples", "overlap_gram")
# _mm_bf16 on the card vs the exact (float64) product of the bf16-rounded
# operands, relative to its largest magnitude. The tensor cores' float32
# accumulation itself is 1.2e-5-2.2e-5 off at K = 10,000 on an H100 (a
# CUDA-core float32 GEMM 4e-7-4.4e-6); a bf16-rounded output is 1.8e-3-
# 2.9e-3 off. The bound sits between the two.
BF16_TOL = 1e-4


def chain_bounds_ms(lanes, p, m):
    """The least time an H100 could take for `lanes` chains of (p, m), in
    ms, from the H100 SXM's published peaks: the bytes the
    chain must move (C_xy and ry read, AA, H and the 3m + 1 sums written,
    sqz read; 4 bytes each) over 3.35 TB/s, against its two m-deep products
    — qij = rr·ry (2·p·m² flops) and the symmetric H = (rr·α)ᵀ·rr (its
    m(m+1)/2 distinct entries, p·m·(m+1) flops) — as 3xTF32 (three TF32
    products each) over 495 TFLOP/s, or in float32 on the CUDA cores over
    67 TFLOP/s. Returns (3xTF32 bound, CUDA-core bound); both are bound by
    operations at the north-star shape."""
    moved = lanes * 4 * (2 * p * m + 2 * m * m + 4 * m + 1) / 3.35e12
    flops = lanes * (2 * p * m * m + p * m * (m + 1))
    return (max(moved, 3 * flops / 495e12) * 1e3,
            max(moved, flops / 67e12) * 1e3)


def chain_products_ms(cxy, ry, sqz, rho_clip):
    """torch.matmul of the chain's two products, rr·ry and (rr·α)ᵀ·rr, in
    full float32 (TF32 off) on the kernel's inputs: the library yardstick
    for the work that bounds the kernel. Timed only; the port never calls
    it."""
    import torch
    from linearcorex_tpu_torch.ops import moments as Mo
    rho = torch.clamp(cxy / sqz[..., None, :], -rho_clip, rho_clip)
    rr = rho / (1.0 - rho ** 2)
    qij = rr @ ry
    si = torch.sum(rho * rr, dim=-1, keepdim=True)
    qi = torch.sum(rr * qij, dim=-1, keepdim=True)
    rra = rr / (1.0 + qi - si ** 2)
    del rho, qij
    with Mo.full_f32_matmul():
        return time_ms(lambda: (rr @ ry, rra.mT @ rr), inner=20)


def chain_pass_ms(args, launches=10):
    """Device ms per launch of each pass of the chain kernel on `args`
    (torch.profiler over `launches` launches after a warm-up), by kernel
    name: split, qij product, row pass, H product, reduce."""
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile
    from linearcorex_tpu_torch.ops.cuda_moments import ns_chain
    names = {"chain_split_kernel": "split", "chain_gemm_kernel<true>": "qij",
             "chain_rows_kernel": "rows", "chain_gemm_kernel<false>": "hmat",
             "chain_reduce_kernel": "reduce"}
    ns_chain(*args, 1 - 1e-6)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(launches):
            ns_chain(*args, 1 - 1e-6)
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        found = re.search(r"chain_\w+(<\w+>)?", e.key)
        if found and found.group(0) in names \
                and getattr(e, "device_time_total", 0) > 0:
            out[names[found.group(0)]] = e.device_time_total / 1e3 / launches
    check(len(out) == len(names), f"the profile shows the passes {out}")
    return out


def build_checks(rec):
    """Phase build's gates: 0 spill bytes in every ptxas report, and the
    HGMMA instructions in the built library (cuobjdump from nvcc's
    toolkit). Returns (ptxas lines, HGMMA count)."""
    import re
    from pathlib import Path

    from linearcorex_tpu_torch.utils import build
    ptxas = [ln.strip() for ln in rec["log"].splitlines()
             if "registers" in ln or "spill" in ln]
    spills = [tuple(map(int, m)) for m in re.findall(
        r"(\d+) bytes spill stores, (\d+) bytes spill loads", rec["log"])]
    check(spills and all(st == ld == 0 for st, ld in spills),
          f"ptxas reports spills (or no report): {spills}")
    cuobjdump = Path(build.find_nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", rec["path"]],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    hgmma = sum("HGMMA" in ln for ln in sass.splitlines())
    check(hgmma > 0, "the built library holds no HGMMA instruction: the "
          "chain's products do not run on the tensor cores")
    return ptxas, hgmma


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(ok, msg):
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def chain_inputs(p, m, seed=1, dead=0):
    """Moment-chain inputs made as the JAX package's kernel tests make
    them: C_xy from standardized Gaussian data and random weights. The
    last `dead` factors get zero weights (a padded selection lane)."""
    import numpy as np
    import torch
    rng = np.random.RandomState(seed)
    w = rng.normal(scale=0.1, size=(m, p))
    if dead:
        w[m - dead:] = 0.0
    x = rng.normal(size=(600, p))
    x = (x - x.mean(0)) / x.std(0)
    cxy = x.T @ (x @ w.T) / 600
    cy = w @ cxy.astype(np.float32).astype(np.float64) + np.eye(m)
    z2 = np.diag(cy)
    ry = cy / np.sqrt(np.outer(z2, z2))
    dev = torch.device("cuda")
    return (torch.as_tensor(cxy, dtype=torch.float32, device=dev),
            torch.as_tensor(ry, dtype=torch.float32, device=dev),
            torch.as_tensor(np.sqrt(z2), dtype=torch.float32, device=dev))


def time_ms(fn, reps=3, inner=1, warmup=True):
    """Min over `reps` of the CUDA-event time of `inner` calls, per call,
    after one untimed call (unless warmup=False)."""
    import torch
    if warmup:
        fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / inner)
    return best


def block_data(n, p, blocks, seed, dev):
    """Block-structured data: p variables in `blocks` equal blocks, each
    driven by one latent factor with loading 0.9 (the north-star shape's
    generator), drawn on the card from a seeded generator."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)
    z = torch.randn((n, blocks), generator=gen, device=dev)
    e = torch.randn((n, p), generator=gen, device=dev)
    return torch.repeat_interleave(z, p // blocks, dim=1) * 0.9 + 0.436 * e


def blocks_whole(clusters):
    """Share of the planted blocks whose variables all fall into one
    cluster (block b holds variables b*k .. b*k + k - 1)."""
    k = P // BLOCKS
    return sum(len(set(clusters[b * k:(b + 1) * k].tolist())) == 1
               for b in range(BLOCKS)) / BLOCKS


def check_operands(p, m, n, dev):
    """The int8 and bf16 products of the operand modes on the card,
    against the same calls on the CPU (phase 4). Returns the fields of
    the phase's line."""
    import numpy as np
    import torch
    from linearcorex_tpu_torch.ops import moments as Mo

    gen = torch.Generator().manual_seed(7)
    x = torch.randn((n, p), generator=gen)
    x[:, 1:] += 0.5 * x[:, :1]                  # correlated columns
    x = (x - x.mean(0)) / x.std(0, correction=0)
    gram = Mo.compute_gram(x.to(dev)).cpu()
    v = 0.1 * torch.randn((p, m), generator=gen)
    out = {}
    for kind, data in (("gram", gram), ("samples", x)):
        quantize = Mo.quantize_gram if kind == "gram" else \
            Mo.quantize_samples
        qc, qg = quantize(data), quantize(data.to(dev))
        check(torch.equal(qg.q.cpu(), qc.q)
              and torch.equal(qg.scale.cpu(), qc.scale),
              f"quantize_{kind} at ({p}, {m}) differs between card and CPU")
        vq_c, _ = Mo._quant_cols(v)
        vq_g, _ = Mo._quant_cols(v.to(dev))
        check(torch.equal(vq_g.cpu(), vq_c),
              f"_quant_cols at ({p}, {m}) differs between card and CPU")
        products = [(qc.q, vq_c, qg.q, vq_g)]
        if kind == "samples":
            # the second product contracts the sample axis (qᵀ·tq)
            t = Mo._int8_mm(qc.q, vq_c).to(torch.float32) \
                * (qc.scale * Mo._quant_cols(v)[1])[None, :]
            tq, _ = Mo._quant_cols(t)
            products.append((qc.q.T, tq, qg.q.T, tq.to(dev)))
        for a_c, b_c, a_g, b_g in products:
            check(torch.equal(Mo._int8_mm(a_g, b_g).cpu(),
                              Mo._int8_mm(a_c, b_c)),
                  f"int8 product ({kind}, {tuple(a_c.shape)} x "
                  f"{tuple(b_c.shape)}) differs between card and CPU")
        apply = Mo._apply_gram_int8 if kind == "gram" else \
            Mo._apply_sigma_int8
        want = apply(qc, v)
        got = apply(qg, v.to(dev)).cpu()
        rel = float((got - want).abs().max() / want.abs().max())
        check(got.dtype == torch.float32 and rel <= 1e-6,
              f"{apply.__name__} at ({p}, {m}) is off by {rel:.3e} "
              f"relative to the CPU (bound 1e-6)")
        out[f"{apply.__name__}_rel_err"] = rel

    a, b = gram.to(dev), v.to(dev)
    with Mo.full_f32_matmul():
        got = Mo._mm_bf16(a, b, torch.float32)
        rounded = (a.bfloat16() @ b.bfloat16()).float()
    want = a.bfloat16().double() @ b.bfloat16().double()
    scale = float(want.abs().max())
    err = float((got.double() - want).abs().max()) / scale
    err_rounded = float((rounded.double() - want).abs().max()) / scale
    check(got.dtype == torch.float32, f"_mm_bf16 returned {got.dtype}")
    check(err < BF16_TOL, f"_mm_bf16 at ({p}, {m}) is off by {err:.3e} of "
          f"the largest magnitude (bound {BF16_TOL:g})")
    check(err_rounded >= BF16_TOL, "the bf16 check cannot tell a "
          "bf16-rounded output apart at this shape")
    out.update(mm_bf16_rel_err=err, bf16_rounded_output_rel_err=err_rounded,
               mm_out_dtype_route=Mo._cuda_mm_has_out_dtype())
    return out


def north_star_fit(x, seed=0, **kw):
    """One annealed fit at the north-star shape through `Corex.fit`, with
    the chain kernel's launch counts set to 0 just before and read just
    after. Returns (model, launches, seconds, warnings raised); launches
    counts the lane entry's launches for a restart sweep (n_restarts in
    kw), the one-lane entry's otherwise. Peak device memory of the fit is
    left in torch.cuda.max_memory_allocated()."""
    import linearcorex_tpu_torch as lct

    model = lct.Corex(n_hidden=M, seed=seed, tol=FIT_TOL,
                      max_iter=FIT_MAX_ITER, device="cuda", **kw)
    return counted(lambda: model.fit(x), lanes=kw.get("n_restarts", 1) > 1)


def restart_sweeps(x, card):
    """Phase fit_restarts: the north-star sweep in float32 and int8 through
    Corex(n_restarts=4).fit, each against four single fits (seeds 0-3).
    The lanes' TCs are read where the fit picks its winner
    (parallel.restarts.best_restart). Returns ({path: lane launches}, the
    float32 sweep's result for the sharded phase to hold its own
    against)."""
    import numpy as np
    import torch
    from linearcorex_tpu_torch.parallel import restarts as R

    launches, sweep_ref = {}, None
    real = R.best_restart
    for name, kw in (("fit_restarts", {}),
                     ("fit_restarts_int8", dict(matmul_dtype="int8"))):
        seen = {}

        def recording(ws_b, mom_b, diag_b):
            seen["lane_tc"] = mom_b.tc.tolist()
            seen["lane_iters"] = diag_b.iters_per_stage.sum(-1).tolist()
            return real(ws_b, mom_b, diag_b)

        R.best_restart = recording
        try:
            model, launches[name], sweep_s, msgs = north_star_fit(
                x, optimizer="auto", n_restarts=LANES, **kw)
        finally:
            R.best_restart = real
        sweep_peak = torch.cuda.max_memory_allocated()
        fields = check_north_star(name, model, launches[name], x, None)
        check(model.best_restart_ == int(np.argmax(seen["lane_tc"])),
              f"{name}: best_restart_={model.best_restart_} is not the "
              f"argmax of the lanes' TC {seen['lane_tc']}")
        guard = [w for w in msgs if "overflow" in w]
        check(not guard, f"{name}: the int8 wrap guard spoke: {guard}")
        singles = []
        for r in range(LANES):
            one, _, s1, _ = north_star_fit(x, seed=r, optimizer="auto", **kw)
            singles.append(dict(
                seed=r, tc=one.tc, n_iter=one.n_iter_, seconds=s1,
                blocks_whole=blocks_whole(one.clusters.cpu().numpy()),
                peak_bytes=torch.cuda.max_memory_allocated()))
            del one
        single_s = sum(o["seconds"] for o in singles)
        single_peak = max(o["peak_bytes"] for o in singles)
        emit(name, lanes=LANES, best_restart=model.best_restart_,
             lane_tc=seen["lane_tc"], lane_iters=seen["lane_iters"],
             sweep_seconds=sweep_s, singles_seconds=single_s,
             sweep_over_singles=sweep_s / single_s,
             peak_bytes_sweep=sweep_peak, peak_bytes_single=single_peak,
             bytes_per_extra_lane=(sweep_peak - single_peak) / (LANES - 1),
             singles=singles, warnings=msgs, card=card,
             **{k: v for k, v in fields.items() if k != "tc_f32_same_w0"})
        if sweep_ref is None:
            sweep_ref = sweep_result(model, launches[name], sweep_s)
        del model
    return launches, sweep_ref


def sweep_result(model, launches, seconds):
    """What the sharded phase compares of a restart sweep."""
    return dict(ws=model.ws.clone(), tc=model.tc, best=model.best_restart_,
                iters=model.diagnostics.iters_per_stage.tolist(),
                launches=launches, seconds=seconds)


def sharded_phase(x, card, sweep_ref=None, backend="nccl"):
    """Phase sharded: the mesh forms of Corex.fit, the restart sweep,
    transform and score in a world of one rank on the card, each held bit
    for bit against its plain form (`sweep_ref`: the plain float32 sweep,
    fitted here when not given). Returns ({path: launches}, {path: lane
    launches}) of the mesh runs."""
    import numpy as np
    import torch
    import torch.distributed as dist

    import linearcorex_tpu_torch as lct
    from linearcorex_tpu_torch.parallel import sharding as S
    from linearcorex_tpu_torch.parallel.launch import init_local_group

    def fit_kw(**kw):
        return dict(n_hidden=M, seed=0, tol=FIT_TOL, max_iter=FIT_MAX_ITER,
                    optimizer="auto", device="cuda", **kw)

    def counts():
        return [dict(c._asdict(), calls=n)
                for c, n in S.collective_counts().items()]

    launches, lane_launches = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        init_local_group(backend, 0, 1, os.path.join(tmp, "rendezvous"),
                         timeout=600.0)
        try:
            mesh = S.make_mesh()
            check(tuple(mesh.mesh_dim_names) == (S.DATA_AXIS,)
                  and mesh.device_type == "cuda",
                  f"make_mesh() gave {mesh}")
            emit("sharded_world", backend=dist.get_backend(), world_size=1,
                 rendezvous="file://", init_seconds=time.perf_counter() - t0,
                 nccl_socket_ifname=os.environ.get("NCCL_SOCKET_IFNAME"),
                 card=card)
            # one (p, m) float32 all-reduce alone, as the fit makes it
            part = torch.zeros((P, M), device="cuda")
            axes = S.sample_axes(mesh, S.ShardingPlan())
            reduce_ms = time_ms(lambda: S.all_reduce(part, axes), inner=20)
            clone_ms = time_ms(lambda: part.clone(), inner=20)
            del part
            S.reset_collective_counts()
            emit("sharded_all_reduce", backend=dist.get_backend(), p=P, m=M,
                 bytes=P * M * 4, all_reduce_ms=reduce_ms,
                 of_which_clone_ms=clone_ms, card=card)
            model_f32 = None
            for name, kw in (("sharded", {}),
                             ("sharded_int8", dict(matmul_dtype="int8"))):
                # turns mesh, plain, plain, mesh: the first fit of a kind
                # pays the set-up of its GEMM shapes and of the group
                model = lct.Corex(**fit_kw(**kw))
                S.reset_collective_counts()
                _, launches[name], mesh_s, msgs = counted(
                    lambda: model.fit(x, mesh=mesh))
                calls = counts()
                plain = lct.Corex(**fit_kw(moment_strategy="samples", **kw))
                _, plain_launches, plain_s, _ = counted(lambda: plain.fit(x))
                again = lct.Corex(**fit_kw(moment_strategy="samples", **kw))
                plain_s = min(plain_s, counted(lambda: again.fit(x))[2])
                check(torch.equal(again.ws, plain.ws),
                      f"{name}: two plain fits differ")
                again = lct.Corex(**fit_kw(**kw))
                mesh_s = min(mesh_s, counted(
                    lambda: again.fit(x, mesh=mesh))[2])
                check(torch.equal(again.ws, model.ws),
                      f"{name}: two mesh fits differ")
                del again
                iters = model.diagnostics.iters_per_stage.tolist()
                check(launches[name] > 0, f"{name}: the mesh fit never "
                      f"launched the chain kernel")
                check(model.resolved_optimizer_ == "fixed_point",
                      f"{name}: optimizer resolved to "
                      f"{model.resolved_optimizer_}")
                check(torch.equal(model.ws, plain.ws) and model.tc == plain.tc
                      and iters == plain.diagnostics.iters_per_stage.tolist()
                      and launches[name] == plain_launches,
                      f"{name}: the world-of-one mesh fit is not the plain "
                      f"samples-strategy fit bit for bit (TC {model.tc} "
                      f"against {plain.tc}, iterations {iters} against "
                      f"{plain.diagnostics.iters_per_stage.tolist()})")
                check(torch.equal(model.theta.mean, plain.theta.mean)
                      and torch.equal(model.theta.std, plain.theta.std),
                      f"{name}: theta differs from the plain fit's")
                guard = [w for w in msgs if "overflow" in w]
                check(not guard, f"{name}: the int8 wrap guard spoke: "
                      f"{guard}")
                evals = sum(iters) + len(iters)
                sums = [c for c in calls if c["op"] == "sum"
                        and c["numel"] == P * M]
                check(all(c["kind"] == "all_reduce" and c["axis"]
                          == S.DATA_AXIS for c in calls)
                      and sum(c["calls"] for c in sums) == evals + 1
                      # besides: the per-column maxima (m floats) and the
                      # set-up's scale and wrap-guard sums (<= p values)
                      and all(c["numel"] == P * M or c["numel"] <= P
                              for c in calls),
                      f"{name}: unexpected collectives {calls} for {evals} "
                      f"objective evaluations")
                n_iter = model.n_iter_
                emit(name, backend=dist.get_backend(), strategy="samples",
                     bitwise_plain_samples_fit=True, tc=model.tc,
                     n_iter=n_iter, iters_per_stage=iters,
                     kernel_launches=launches[name],
                     objective_evaluations=evals, collectives=calls,
                     mesh_fit_seconds=mesh_s, plain_fit_seconds=plain_s,
                     mesh_it_per_s=n_iter / mesh_s,
                     plain_it_per_s=n_iter / plain_s,
                     blocks_whole=blocks_whole(
                         model.clusters.cpu().numpy()),
                     warnings=msgs, card=card, **kw)
                if model_f32 is None:
                    model_f32 = model
                    y = model.transform(x, mesh=mesh)
                    score = model.score(x, mesh=mesh)
                    check(torch.equal(y, plain.transform(x)),
                          "transform(mesh=) differs from the plain call")
                    check(score == plain.score(x),
                          "score(mesh=) differs from the plain call")
                    check(tuple(y.shape) == (N, M)
                          and bool(torch.isfinite(y).all())
                          and np.isfinite(score),
                          "mesh serving is not finite")
                    emit("sharded_serving", transform_bitwise=True,
                         score_bitwise=True, score=float(score),
                         plan=str(model._serving_plan), card=card)
                del plain, model
            del model_f32

            rmesh = S.make_mesh((("restarts", 1),))
            if sweep_ref is None:
                plain = lct.Corex(**fit_kw(n_restarts=LANES))
                _, n_l, s_l, _ = counted(lambda: plain.fit(x), lanes=True)
                sweep_ref = sweep_result(plain, n_l, s_l)
                del plain
            sweep = lct.Corex(**fit_kw(n_restarts=LANES))
            S.reset_collective_counts()
            _, lane_launches["sharded_restarts"], sweep_s, _ = counted(
                lambda: sweep.fit(x, mesh=rmesh), lanes=True)
            calls = counts()
            iters = sweep.diagnostics.iters_per_stage.tolist()
            check(lane_launches["sharded_restarts"] > 0,
                  "the mesh sweep never launched the lane kernel")
            check(torch.equal(sweep.ws, sweep_ref["ws"])
                  and sweep.tc == sweep_ref["tc"]
                  and sweep.best_restart_ == sweep_ref["best"]
                  and iters == sweep_ref["iters"]
                  and lane_launches["sharded_restarts"]
                  == sweep_ref["launches"],
                  f"the restarts-axis sweep is not the plain sweep bit for "
                  f"bit (TC {sweep.tc} against {sweep_ref['tc']}, lane "
                  f"{sweep.best_restart_} against {sweep_ref['best']})")
            check(calls and all(c["kind"] == "all_gather" and c["axis"]
                                == "restarts" and c["calls"] == 1
                                for c in calls),
                  f"the restarts-axis sweep made {calls}")
            emit("sharded_restarts", backend=dist.get_backend(), lanes=LANES,
                 bitwise_plain_sweep=True, tc=sweep.tc,
                 best_restart=sweep.best_restart_, iters_per_stage=iters,
                 lane_kernel_launches=lane_launches["sharded_restarts"],
                 collectives=calls, mesh_sweep_seconds=sweep_s,
                 plain_sweep_seconds=sweep_ref["seconds"], card=card)
            del sweep
        finally:
            dist.destroy_process_group()
    return launches, lane_launches


def sharded_vars_phase(x, card, backend="nccl"):
    """Phase sharded_vars: Corex.fit(mesh=) under the variable and factor
    plans in a world of one rank on the card, where every block is the
    whole thing and every collective runs over one rank: each mesh fit
    must be the plain fit with use_pallas='never' bit for bit (the plans
    turn the chain kernel off), and with use_pallas='always' the var fit
    must gather C_xy, launch the kernel as often as the plain kernel fit
    and end bitwise where it does. Var-plan serving bitwise the plain
    calls. Returns {path: launches} of the kernel path."""
    import torch
    import torch.distributed as dist

    import linearcorex_tpu_torch as lct
    from linearcorex_tpu_torch.parallel import sharding as S
    from linearcorex_tpu_torch.parallel.collectives import all_gather_dim
    from linearcorex_tpu_torch.parallel.launch import init_local_group

    def fit_kw(**kw):
        return dict(n_hidden=M, seed=0, tol=FIT_TOL, max_iter=FIT_MAX_ITER,
                    optimizer="auto", device="cuda", **kw)

    def counts():
        return [dict(c._asdict(), calls=n)
                for c, n in S.collective_counts().items()]

    var_plan = S.ShardingPlan(shard_samples=False, shard_vars=True)
    # (name, mesh axes, plan, the strategy the plan resolves at n = p)
    layouts = (
        ("var_gram", (("var", 1),), var_plan, "gram"),
        ("var_samples", (("var", 1),), var_plan, "samples"),
        ("data_var", (("data", 1), ("var", 1)),
         S.ShardingPlan(shard_vars=True), "gram"),
        ("factor", (("model", 1),),
         S.ShardingPlan(shard_samples=False, shard_factors=True), "gram"),
        ("data_factor", (("data", 1), ("model", 1)),
         S.ShardingPlan(shard_factors=True), "samples"))
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        init_local_group(backend, 0, 1, os.path.join(tmp, "rendezvous"),
                         timeout=600.0)
        try:
            meshes = {axes: S.make_mesh(axes) for _, axes, _, _ in layouts}
            var_mesh = meshes[(("var", 1),)]
            emit("sharded_vars_world", backend=dist.get_backend(),
                 world_size=1, meshes=[list(a) for a in meshes],
                 init_seconds=time.perf_counter() - t0, card=card)
            # one m x p float32 all-gather over `var` alone, as a fit ends
            w = torch.zeros((M, P), device="cuda")
            var = S.var_axis(var_mesh, var_plan)
            gather_ms = time_ms(lambda: all_gather_dim(w, -1, var), inner=20)
            clone_ms = time_ms(lambda: w.clone(), inner=20)
            del w
            S.reset_collective_counts()
            emit("sharded_vars_all_gather", m=M, p=P, bytes=M * P * 4,
                 all_gather_ms=gather_ms, of_which_copy_ms=clone_ms,
                 card=card)

            plain = {}
            for dt in ("float32", "int8"):
                for strategy in ("gram", "samples"):
                    model = lct.Corex(**fit_kw(
                        use_pallas="never", moment_strategy=strategy,
                        matmul_dtype=dt))
                    _, n_l, secs, _ = counted(lambda: model.fit(x))
                    check(n_l == 0, "use_pallas='never' launched the kernel")
                    plain[dt, strategy] = dict(
                        model=model, seconds=secs,
                        iters=model.diagnostics.iters_per_stage.tolist())
            served = None
            for dt in ("float32", "int8"):
                for name, axes, plan, strategy in layouts:
                    kw = dict(matmul_dtype=dt)
                    if name == "var_samples":
                        kw["moment_strategy"] = "samples"
                    model = lct.Corex(**fit_kw(**kw))
                    S.reset_collective_counts()
                    _, n_l, secs, msgs = counted(lambda: model.fit(
                        x, mesh=meshes[axes], sharding_plan=plan))
                    calls = counts()
                    ref = plain[dt, strategy]
                    iters = model.diagnostics.iters_per_stage.tolist()
                    label = f"{name}/{dt}"
                    check(n_l == 0, f"{label}: use_pallas='auto' launched "
                          f"the kernel under a var/factor plan")
                    check(model.resolved_optimizer_ == "fixed_point",
                          f"{label}: optimizer {model.resolved_optimizer_}")
                    check(torch.equal(model.ws, ref["model"].ws)
                          and model.tc == ref["model"].tc
                          and iters == ref["iters"],
                          f"{label}: the world-of-one mesh fit is not the "
                          f"plain {strategy} fit bit for bit (TC {model.tc} "
                          f"against {ref['model'].tc}, iterations {iters} "
                          f"against {ref['iters']})")
                    guard = [w for w in msgs if "overflow" in w]
                    check(not guard, f"{label}: the int8 wrap guard spoke")
                    # besides the gram build's one sum of Σ's row block
                    # over the sample axes, at set-up
                    build = [c for c in calls if strategy == "gram"
                             and c["axis"] == "data" and c["calls"] == 1
                             and c["numel"] == P * P]
                    check(all(c["numel"] <= max(N * M, M * P)
                              and c["numel"] != N * P
                              for c in calls if c not in build),
                          f"{label}: a payload beyond max(n·m, m·p): {calls}")
                    emit("sharded_vars", layout=name, matmul_dtype=dt,
                         strategy=strategy, bitwise_plain_fit=True,
                         tc=model.tc, iters_per_stage=iters,
                         mesh_fit_seconds=secs,
                         plain_fit_seconds=ref["seconds"],
                         mesh_over_plain=secs / ref["seconds"],
                         collectives=calls, card=card)
                    if (name, dt) == ("var_gram", "float32"):
                        served = model
                    else:
                        del model
            plain_f32 = plain["float32", "gram"]["model"]
            del plain

            # the kernel path: use_pallas='always' under the var plan
            kp = lct.Corex(**fit_kw(use_pallas="always"))
            _, n_plain, s_plain, _ = counted(lambda: kp.fit(x))
            km = lct.Corex(**fit_kw(use_pallas="always"))
            S.reset_collective_counts()
            _, launches["sharded_vars_always"], s_mesh, _ = counted(
                lambda: km.fit(x, mesh=var_mesh, sharding_plan=var_plan))
            calls = counts()
            iters = km.diagnostics.iters_per_stage.tolist()
            evals = sum(iters) + len(iters)
            gathers = [c for c in calls if c["kind"] == "all_gather"
                       and c["numel"] == P * M]
            check(launches["sharded_vars_always"] > 0
                  and launches["sharded_vars_always"] == n_plain,
                  f"the var-plan kernel fit launched "
                  f"{launches['sharded_vars_always']} times, the plain "
                  f"kernel fit {n_plain}")
            check(torch.equal(km.ws, kp.ws) and km.tc == kp.tc
                  and iters == kp.diagnostics.iters_per_stage.tolist(),
                  f"the var-plan kernel fit is not the plain kernel fit bit "
                  f"for bit (TC {km.tc} against {kp.tc})")
            # each evaluation gathers W's columns for Σ·Wᵀ and C_xy for
            # the kernel, both (p, m)
            check(sum(c["calls"] for c in gathers) >= 2 * evals,
                  f"the var-plan kernel fit made "
                  f"{sum(c['calls'] for c in gathers)} (p, m) gathers for "
                  f"{evals} evaluations: {calls}")
            emit("sharded_vars_kernel", layout="var_gram",
                 use_pallas="always", bitwise_plain_kernel_fit=True,
                 kernel_launches=launches["sharded_vars_always"], tc=km.tc,
                 iters_per_stage=iters, evaluations=evals,
                 pm_gathers=sum(c["calls"] for c in gathers),
                 mesh_fit_seconds=s_mesh, plain_fit_seconds=s_plain,
                 collectives=calls, card=card)
            del kp, km

            # var-plan serving against the single-device calls
            t0 = time.perf_counter()
            y = served.transform(x, mesh=var_mesh)
            xr = served.predict(y, mesh=var_mesh)
            score = served.score(x, mesh=var_mesh)
            blocks = list(served.covariance_blocks(4096, mesh=var_mesh))
            torch.cuda.synchronize()
            serve_s = time.perf_counter() - t0
            check(torch.equal(y, plain_f32.transform(x)),
                  "var-plan transform differs from the plain call")
            check(torch.equal(xr.full_tensor(), plain_f32.predict(y)),
                  "var-plan predict differs from the plain call")
            check(score == plain_f32.score(x),
                  "var-plan score differs from the plain call")
            ref_blocks = list(plain_f32.covariance_blocks(4096))
            check([s for s, _ in blocks] == [s for s, _ in ref_blocks]
                  and all(torch.equal(r.full_tensor(), q)
                          for (_, r), (_, q) in zip(blocks, ref_blocks)),
                  "var-plan covariance_blocks differ from the plain blocks")
            try:
                served.get_covariance()
                raised = False
            except ValueError as e:
                raised = "var-sharded" in str(e)
            check(raised, "get_covariance() on var-sharded state did not "
                  "raise by name")
            emit("sharded_vars_serving", transform_bitwise=True,
                 predict_bitwise=True, score_bitwise=True,
                 blocks_bitwise=True, blocks=len(blocks),
                 predict_placements=[str(p) for p in xr.placements],
                 score=float(score), serving_seconds=serve_s, card=card)
            del served, plain_f32, y, xr, blocks, ref_blocks
        finally:
            dist.destroy_process_group()
    return launches


def sharded_stream_phase(x, card, backend="nccl"):
    """Phase sharded_stream: the moment-input and staged fits over a mesh
    (`GramAccumulator`, `fit_from_covariance`, `partial_fit`,
    `fit_with_checkpoints` and `StackedCorex` with `mesh=`) in a world of
    one rank on the card, each held bit for bit against its plain form:
    under the var plan `use_pallas='auto'` turns the kernel off, so the
    plain forms run with 'never', and the accumulator's 'always' fit
    against the plain 'always' fit. Returns {path: launches}."""
    import shutil

    import torch
    import torch.distributed as dist

    import linearcorex_tpu_torch as lct
    from linearcorex_tpu_torch.parallel import sharding as S
    from linearcorex_tpu_torch.parallel.launch import init_local_group
    from linearcorex_tpu_torch.utils.checkpoint import fit_with_checkpoints

    kw = dict(optimizer="auto", seed=0, tol=FIT_TOL, max_iter=FIT_MAX_ITER)

    def same(a, b):
        return bool(torch.equal(a.ws, b.ws) and a.tc == b.tc
                    and a.diagnostics.iters_per_stage.tolist()
                    == b.diagnostics.iters_per_stage.tolist())

    def gate(label, a, b, launches_a, launches_b):
        check(same(a, b), f"{label}: the world-of-one mesh form is not the "
              f"plain form bit for bit (TC {a.tc} against {b.tc})")
        check(launches_a == launches_b, f"{label}: the mesh form launched "
              f"the kernel {launches_a} times, the plain form {launches_b}")
        return dict(tc=a.tc, iters_per_stage=a.diagnostics.iters_per_stage
                    .tolist(), kernel_launches=launches_a, bitwise=True)

    def accumulate(**acc_kw):
        acc = lct.GramAccumulator(P, **acc_kw)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(0, N, STREAM_BATCH):
            acc.update(x[i:i + STREAM_BATCH])
        end.record()
        torch.cuda.synchronize()
        return acc, start.elapsed_time(end) / (N // STREAM_BATCH)

    var_plan = S.ShardingPlan(shard_samples=False, shard_vars=True)
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        init_local_group(backend, 0, 1, os.path.join(tmp, "rendezvous"),
                         timeout=600.0)
        try:
            mesh = S.make_mesh((("var", 1),))
            data_mesh = S.make_mesh()
            emit("sharded_stream_world", backend=dist.get_backend(),
                 world_size=1, init_seconds=time.perf_counter() - t0,
                 card=card)

            # streaming: ten batches into each accumulator, in turns
            lct.GramAccumulator(P, mesh=mesh).update(x[:STREAM_BATCH])
            ms = {"plain": [], "mesh": []}
            for which in ("plain", "mesh", "mesh", "plain"):
                acc, per_batch = accumulate(
                    **({"mesh": mesh} if which == "mesh" else {}))
                ms[which].append(per_batch)
                if which == "mesh":
                    acc_mesh = acc
                else:
                    acc_plain = acc
                del acc
            check(tuple(acc_mesh._g.shape) == (P, P) and acc_mesh.plan
                  == var_plan, "the mesh accumulator's state or plan")
            corr = acc_mesh.correlation()
            check(torch.equal(corr.full_tensor(), acc_plain.correlation()),
                  "the mesh accumulator's correlation is not the plain "
                  "one bit for bit")
            del corr
            fits = {}
            for name, dt, pallas in (("f32", "float32", "never"),
                                     ("int8", "int8", "never"),
                                     ("always", "float32", "always")):
                mine = {} if pallas == "never" else {"use_pallas": pallas}
                a, n_a, s_a, msgs = counted(lambda: acc_mesh.fit(
                    n_hidden=M, matmul_dtype=dt, **mine, **kw))
                b, n_b, s_b, _ = counted(lambda: acc_plain.fit(
                    n_hidden=M, matmul_dtype=dt, use_pallas=pallas, **kw))
                check(a._serving_plan == var_plan, f"acc.fit/{name}: plan "
                      f"{a._serving_plan}")
                check(not [w for w in msgs if "overflow" in w],
                      f"acc.fit/{name}: the int8 wrap guard spoke")
                check(pallas == "never" or n_a > 0,
                      f"acc.fit/{name}: the kernel never launched")
                fits[name] = dict(gate(f"acc.fit/{name}", a, b, n_a, n_b),
                                  mesh_fit_seconds=s_a,
                                  plain_fit_seconds=s_b)
                launches[f"sharded_stream_{name}"] = n_a
                del a, b
            emit("sharded_stream", plan="var", batches=N // STREAM_BATCH,
                 batch_rows=STREAM_BATCH, correlation_bitwise=True,
                 accumulate_ms_per_batch_mesh=ms["mesh"],
                 accumulate_ms_per_batch_plain=ms["plain"], fits=fits,
                 card=card)
            mean_shift = acc_plain._s / float(N)
            cov = acc_plain._g / float(N) - torch.outer(mean_shift,
                                                         mean_shift)
            del acc_mesh, acc_plain

            # the covariance input
            a, n_a, s_a, _ = counted(lambda: lct.fit_from_covariance(
                cov, N, M, mesh=mesh, **kw))
            b, n_b, s_b, _ = counted(lambda: lct.fit_from_covariance(
                cov, N, M, use_pallas="never", **kw))
            emit("sharded_stream_covariance", mesh_fit_seconds=s_a,
                 plain_fit_seconds=s_b, card=card,
                 **gate("fit_from_covariance", a, b, n_a, n_b))
            del a, b, cov

            # partial_fit: two calls, the mesh on the first only
            half = N // 2
            est = {k: lct.Corex(n_hidden=M, device="cuda", **dict(
                kw, max_iter=PF_MAX_ITER, **({} if k == "mesh" else {
                    "use_pallas": "never"}))) for k in ("mesh", "plain")}
            secs = {"mesh": 0.0, "plain": 0.0}
            for k in range(2):
                batch = x[k * half:(k + 1) * half]
                for which in ("mesh", "plain"):
                    _, n_l, s, _ = counted(lambda: est[which].partial_fit(
                        batch, mesh=mesh if which == "mesh" and k == 0
                        else None))
                    check(n_l == 0, "partial_fit launched the kernel")
                    secs[which] += s
            check(est["mesh"]._partial_acc.mesh is mesh,
                  "partial_fit did not keep the first call's mesh")
            emit("sharded_stream_partial_fit", calls=2,
                 mesh_seconds=secs["mesh"], plain_seconds=secs["plain"],
                 card=card, **gate("partial_fit", est["mesh"],
                                   est["plain"], 0, 0))
            del est

            # checkpoints: whole, cut after stage 2 and resumed, and a mesh
            # checkpoint resumed on one device
            class Interrupted(Exception):
                pass

            def ckpt(path, on_mesh, stop_after=None):
                stamps = []

                def callback(stage, eps, ws, stats):
                    torch.cuda.synchronize()
                    stamps.append(time.perf_counter())
                    if stage == stop_after:
                        raise Interrupted
                extra = {} if on_mesh else {"use_pallas": "never"}
                model = lct.Corex(n_hidden=M, device="cuda", **kw, **extra)
                t_0 = time.perf_counter()
                try:
                    _, n_l, _, _ = counted(lambda: fit_with_checkpoints(
                        model, x, os.path.join(tmp, path),
                        mesh=mesh if on_mesh else None,
                        sharding_plan=var_plan if on_mesh else None,
                        stage_callback=callback))
                except Interrupted:
                    return None, None
                check(n_l == 0, f"checkpoint {path} launched the kernel")
                stage_ms = [1e3 * (b - a) for a, b in
                            zip([t_0] + stamps, stamps)]
                return model, stage_ms

            plain, plain_ms = ckpt("plain", False)
            whole, whole_ms = ckpt("mesh", True)
            ckpt("cut", True, stop_after=2)
            shutil.copytree(os.path.join(tmp, "cut"),
                            os.path.join(tmp, "cut_one"))
            resumed, _ = ckpt("cut", True)
            on_one, _ = ckpt("cut_one", False)
            fields = gate("checkpoint", whole, plain, 0, 0)
            for label, m_ in (("resumed under the mesh", resumed),
                              ("resumed on one device", on_one)):
                check(same(m_, plain), f"checkpoint {label}: not the plain "
                      f"checkpointed fit bit for bit")
            emit("sharded_stream_checkpoint", stages=len(whole_ms),
                 mesh_ms_per_stage=whole_ms, plain_ms_per_stage=plain_ms,
                 resumed_bitwise=True, resumed_on_one_device_bitwise=True,
                 card=card, **fields)
            del plain, whole, resumed, on_one

            # the stack: the var plan against the plain stack whose layer 1
            # runs 'never' (the plan turns the kernel off there, not in
            # layer 2), and the data plan against the plain samples stack
            stack_kw = dict(kw, max_iter=STACK_MAX_ITER, device="cuda")
            for name, plan, plain_kw in (
                    ("var", var_plan, {}),
                    ("data", None, {"moment_strategy": "samples"})):
                sm = lct.StackedCorex(STACK, **stack_kw)
                sp = lct.StackedCorex(STACK, **stack_kw, **plain_kw)
                if name == "var":
                    sp.layers[0].set_params(use_pallas="never")
                _, n_a, s_a, _ = counted(lambda: sm.fit(
                    x, mesh=mesh if name == "var" else data_mesh,
                    sharding_plan=plan))
                _, n_b, s_b, _ = counted(lambda: sp.fit(x))
                check(n_a > 0, f"the {name}-plan stack never launched the "
                      f"kernel")
                layers = [gate(f"stack/{name} layer {k + 1}", a, b, 0, 0)
                          for k, (a, b) in enumerate(zip(sm.layers,
                                                         sp.layers))]
                check(n_a == n_b, f"the {name}-plan stack launched the "
                      f"kernel {n_a} times, the plain stack {n_b}")
                launches[f"sharded_stream_stack_{name}"] = n_a
                emit("sharded_stream_stack", plan=name, n_hiddens=STACK,
                     max_iter=STACK_MAX_ITER, layers=layers,
                     kernel_launches=n_a, mesh_fit_seconds=s_a,
                     plain_fit_seconds=s_b,
                     layer_plans=[str(la._serving_plan)
                                  for la in sm.layers], card=card)
                del sm, sp
        finally:
            dist.destroy_process_group()
    return launches


def precision_phase(x, card):
    """Phase precision: matmul_precision on the card. The Σ·Wᵀ product
    under 'high' must differ from the full-float32 product (TF32 ran) by
    less than 1e-2 relative, and under 'highest' equal it bit for bit;
    fit_core at the north-star shape in float32 with 'highest', 'high'
    and 'bfloat16' in turns (it/s reported); the annealed fit's TC and
    block share over seeds 0-5 with 'high' against 'highest', reported.
    Returns {path: launches}."""
    import numpy as np
    import torch

    import linearcorex_tpu_torch as lct
    from linearcorex_tpu_torch.config import CorexConfig
    from linearcorex_tpu_torch.models.corex import precision_ctx
    from linearcorex_tpu_torch.ops import moments as Mo

    xs = (x - x.mean(0)) / x.std(0, correction=0)
    gram = Mo.compute_gram(xs)
    del xs
    w0 = torch.as_tensor(np.random.RandomState(0).normal(
        scale=1 / np.sqrt(P), size=(M, P)), dtype=torch.float32,
        device="cuda")
    with Mo.full_f32_matmul():
        exact = Mo._mm(gram, w0.T)
    products = {}
    for value in ("highest", "high", "bfloat16"):
        with precision_ctx(CorexConfig(matmul_precision=value), "cuda"):
            got = Mo._mm(gram, w0.T)
        products[value] = dict(
            rel_diff=float((got - exact).abs().max() / exact.abs().max()),
            bitwise_full_f32=bool(torch.equal(got, exact)), out=got)
    check(products["highest"]["bitwise_full_f32"],
          "the Σ·Wᵀ product under 'highest' is not the full-float32 one")
    rel = products["high"]["rel_diff"]
    check(0 < rel < 1e-2, f"the Σ·Wᵀ product under 'high' is {rel:.3e} off "
          f"the full-float32 one relative (TF32 should give (0, 1e-2))")
    bf16_is_tf32 = bool(torch.equal(products["bfloat16"]["out"],
                                    products["high"]["out"]))
    for v in products.values():
        del v["out"]

    variants = ("highest", "high", "bfloat16")
    rates = {v: [] for v in variants}
    for turn in (variants, variants[::-1], variants):
        for value in turn:
            run, out = fit_core_runner(gram, w0, "float32", "always",
                                       TIMED_ITERS, precision=value)
            ms = time_ms(run, reps=1, warmup=not rates[value])
            rates[value].append(
                int(out["diag"].iters_per_stage.sum()) / (ms / 1e3))
    del gram

    launches, basins = {}, {}
    for value in ("highest", "high"):
        launches[f"precision_{value}"] = 0
        basins[value] = []
        for seed in range(6):
            model, n_l, secs, _ = north_star_fit(
                x, seed=seed, optimizer="auto", matmul_precision=value)
            check(n_l > 0 and np.isfinite(model.tc),
                  f"precision {value} seed {seed}: launches {n_l}, TC "
                  f"{model.tc}")
            launches[f"precision_{value}"] += n_l
            basins[value].append(dict(
                seed=seed, tc=model.tc, fit_seconds=secs,
                iters=int(model.diagnostics.iters_per_stage.sum()),
                blocks_whole=blocks_whole(model.clusters.cpu().numpy())))
            del model
    emit("precision", products=products, bfloat16_product_is_tf32=bf16_is_tf32,
         it_per_s={v: max(r) for v, r in rates.items()},
         all_turns=rates, iters=TIMED_ITERS, basins=basins, card=card)
    return launches


def serving(model, x, card):
    """Phase serving, on the float32 north-star model."""
    import torch

    y = model.transform(x)
    xr = model.predict(y)
    check(tuple(xr.shape) == (N, P) and bool(torch.isfinite(xr).all()),
          "predict is not finite")
    check(torch.equal(model.inverse_transform(y), xr),
          "inverse_transform differs from predict")
    dense = model.get_covariance()
    gen = torch.Generator(device="cuda").manual_seed(3)
    v = torch.randn((P, 8), generator=gen, device="cuda")
    from linearcorex_tpu_torch.ops import moments as Mo
    with Mo.full_f32_matmul():
        want = dense @ v
    got = model.covariance_matmat(v)
    matmat_rel = float((got - want).abs().max() / want.abs().max())
    check(matmat_rel < 1e-5, f"covariance_matmat is off by {matmat_rel:.3e}"
          f" relative to get_covariance() @ V (bound 1e-5)")
    blocks = list(model.covariance_blocks(4096))
    check([s for s, _ in blocks] == list(range(0, P, 4096)),
          "covariance_blocks starts")
    block_rel = {}
    for start, rows in (blocks[0], blocks[-1]):
        ref = dense[start:start + rows.shape[0]]
        block_rel[start] = float((rows - ref).abs().max() / ref.abs().max())
        check(rows.shape == ref.shape and block_rel[start] < 1e-5,
              f"covariance_blocks at {start} is off by "
              f"{block_rel[start]:.3e} (bound 1e-5)")
    perm = torch.randperm(P, generator=gen, device="cuda")
    score = float(model.score(x))
    shuffled = float(model.score(x[:, perm]))
    check(score == score and abs(score) < float("inf"),
          f"score is not finite: {score}")
    check(score > shuffled, f"score {score} is not above the score of the "
          f"column-shuffled data {shuffled}")
    emit("serving", predict_finite=True, matmat_rel_err=matmat_rel,
         block_rel_err=block_rel,
         blocks_bitwise=[bool(torch.equal(rows, dense[s:s + rows.shape[0]]))
                         for s, rows in (blocks[0], blocks[-1])],
         score=score, score_shuffled=shuffled, card=card)


def host_outputs_phase(model, x, card):
    """Phase host_outputs: outputs follow the kind of their input, at the
    north-star width. `model` is the float32 north-star fit on the CUDA
    `x`; `xh` is a NumPy copy of x (the same float32 values). Gates:
    transform and predict of NumPy input give float32 ndarrays of (n, m)
    and (n, p), bitwise `host_numpy` of the tensor calls, which give CUDA
    tensors; the north-star fit on xh (through the chain kernel: the path
    'host_outputs') gives tcs, mis and clusters as ndarrays bitwise the
    host copies of `model`'s tensors; np.asarray reads every public
    output of it and np.linalg.norm(recon - xh) runs; a second fit on xh
    passes a hand-rolled check_fit_idempotent (sklearn's: np.issubdtype
    on every output's dtype, the two fits' outputs within 2 eps of it).
    Timing: transform of the n rows NumPy in and out against tensor in
    and out, and its parts: the host-side checks of xh (`_check_width`:
    the NaN/inf scan and the width), the host-to-device copy of xh (the
    operand's own `_as_tensor`), the tensor call, the device-to-host copy
    of its result (`host_numpy`); CUDA events around each call (the NumPy
    call returns only after its copy back; host-only work spans the
    idle stream's events), min of 3, in turns. Returns {path:
    launches}."""
    import numpy as np
    import torch
    from linearcorex_tpu_torch.core.solver import host_numpy

    t_phase = time.perf_counter()
    xh = x.cpu().numpy()
    check(xh.dtype == np.float32 and xh.shape == (N, P),
          "the NumPy copy of x is not float32 (n, p)")
    y_t, y_h = model.transform(x), model.transform(xh)
    r_t, r_h = model.predict(y_t), model.predict(y_h)
    for name, t, h, shape in (("transform", y_t, y_h, (N, M)),
                              ("predict", r_t, r_h, (N, P))):
        check(isinstance(t, torch.Tensor) and t.is_cuda,
              f"{name} of a CUDA tensor is not a CUDA tensor")
        check(type(h) is np.ndarray and h.dtype == np.float32
              and h.shape == shape,
              f"{name} of NumPy input gave {type(h).__name__} "
              f"{getattr(h, 'dtype', None)} {getattr(h, 'shape', None)}")
        check(np.array_equal(h, host_numpy(t)),
              f"{name} of NumPy input is not the tensor call's bits")
    rel_recon = float(np.linalg.norm(r_h - xh) / np.linalg.norm(xh))
    check(np.isfinite(rel_recon), "np.linalg.norm(recon - x) is not finite")
    del r_t, r_h

    launches, fits = {}, []
    for path in ("host_outputs", "host_outputs_refit"):
        fitted, launches[path], secs, _ = north_star_fit(xh,
                                                         optimizer="auto")
        check(launches[path] > 0, f"{path}: the chain kernel never ran")
        fits.append((fitted, secs))
    fitted = fits[0][0]
    for name in ("tcs", "mis", "clusters"):
        h, t = getattr(fitted, name), getattr(model, name)
        check(isinstance(t, torch.Tensor) and t.is_cuda,
              f"{name} of the tensor fit is not a CUDA tensor")
        check(type(h) is np.ndarray and np.array_equal(h, host_numpy(t)),
              f"{name} of the NumPy fit is not the tensor fit's bits")
    outs = dict(
        tcs=fitted.tcs, mis=fitted.mis, clusters=fitted.clusters,
        transform=fitted.transform(xh[:4096]),
        get_covariance=fitted.get_covariance(),
        covariance_matvec=fitted.covariance_matvec(np.ones(P)),
        covariance_blocks=next(fitted.covariance_blocks(4096))[1])
    outs["predict"] = fitted.predict(outs["transform"])
    for name, out in outs.items():
        check(type(np.asarray(out)) is np.ndarray
              and np.isfinite(np.asarray(out)).all(),
              f"np.asarray({name}) of the NumPy fit failed")
    # sklearn's check_fit_idempotent, by hand: the methods on held-out
    # rows and the fitted attributes of two fits on the same data
    x_test = xh[N // 2:]
    idem = {}
    for name, get in (("transform", lambda f: f.transform(x_test)),
                      ("predict", lambda f: f.predict(f.transform(x_test))),
                      ("tcs", lambda f: f.tcs), ("mis", lambda f: f.mis),
                      ("clusters", lambda f: f.clusters)):
        a, b = get(fits[0][0]), get(fits[1][0])
        dt = b.dtype if np.issubdtype(b.dtype, np.floating) \
            else np.float64
        tol = 2 * np.finfo(dt).eps
        np.testing.assert_allclose(a, b, atol=max(tol, 1e-9),
                                   rtol=max(tol, 1e-7))
        idem[name] = str(b.dtype)
    fit_s = [s for _, s in fits]
    del outs, fits, fitted

    parts = {"numpy": lambda: model.transform(xh),
             "tensor": lambda: model.transform(x),
             "validate": lambda: model._check_width(xh, move=False),
             "h2d": lambda: model._as_tensor(xh),
             "d2h": lambda: host_numpy(y_t)}
    ms = {k: float("inf") for k in parts}
    for turn in (*parts, *reversed(parts)):
        ms[turn] = min(ms[turn], time_ms(parts[turn]))
    emit("host_outputs", n=N, p=P, m=M, transform_bitwise=True,
         predict_bitwise=True, fit_attributes_bitwise=True,
         tensor_in_tensor_out=True, recon_rel_err=rel_recon,
         fit_idempotent_dtypes=idem,
         fit_seconds=fit_s,
         transform_numpy_ms=ms["numpy"], transform_tensor_ms=ms["tensor"],
         host_validate_ms=ms["validate"], h2d_ms=ms["h2d"],
         d2h_ms=ms["d2h"],
         h2d_bytes=xh.nbytes, d2h_bytes=y_h.nbytes,
         phase_seconds=time.perf_counter() - t_phase, card=card)
    return launches


def check_north_star(name, model, launches, x, tc_f32,
                     gram_by_construction=False):
    """Gates shared by the north-star fits; returns the reported fields.
    A moment-input fit is on the gram strategy by construction."""
    import numpy as np
    import torch

    check(gram_by_construction
          or model.config.pick_strategy(N, P) == "gram",
          f"{name}: the fit did not take the gram strategy")
    check(model.resolved_optimizer_ == "fixed_point",
          f"{name}: optimizer resolved to {model.resolved_optimizer_}")
    check(launches > 0, f"{name}: the fit never launched the chain kernel")
    tc = model.tc
    check(np.isfinite(tc), f"{name}: TC is not finite: {tc}")
    y = model.transform(x)
    check(tuple(y.shape) == (N, M), f"{name}: transform shape "
          f"{tuple(y.shape)}")
    check(bool(torch.isfinite(y).all()), f"{name}: transform is not finite")
    whole = blocks_whole(model.clusters.cpu().numpy())
    return dict(tc=tc, tc_f32_same_w0=tc_f32, n_iter=model.n_iter_,
                iters_per_stage=model.diagnostics.iters_per_stage.tolist(),
                kernel_launches=launches, blocks_whole=whole,
                blocks_bar=BLOCKS_BAR, blocks_bar_met=whole >= BLOCKS_BAR)


def counted(fn, lanes=False):
    """Run fn() with the chain kernel's launch counts set to 0 just before
    and read just after. Returns (result, launches, seconds, warnings
    raised): the one-lane entry's launches, or the lane entry's with
    `lanes`; the other entry must not have run. Peak device memory of the
    run is left in torch.cuda.max_memory_allocated()."""
    import warnings

    import torch
    from linearcorex_tpu_torch.ops.cuda_moments import ns_chain

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ns_chain.launches = ns_chain.lane_launches = 0
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        out = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    ran, other = ns_chain.launches, ns_chain.lane_launches
    if lanes:
        ran, other = other, ran
    check(other == 0, "a restart sweep launched the one-lane kernel"
          if lanes else "a single-lane path launched the lane kernel")
    return out, ran, seconds, [str(w.message) for w in rec]


def native_phase(x, card):
    """Phase native: the host library, its ndtri and CSV reader, and the
    two routes of 'empirical' preprocessing for a NumPy input at the
    north-star size."""
    import numpy as np
    import torch
    import linearcorex_tpu_torch as lct
    from linearcorex_tpu_torch.ops import preprocessing as Pre
    from linearcorex_tpu_torch.utils import native
    from linearcorex_tpu_torch.utils import streaming as S

    check(native.available(), "the host library did not build or load")
    q = torch.linspace(1e-12, 1 - 1e-12, 100_001, dtype=torch.float64)
    ndtri_err = float((torch.as_tensor(native.ndtri(q.numpy()))
                       - torch.special.ndtri(q)).abs().max())
    check(ndtri_err < 1e-12, f"native ndtri is off by {ndtri_err:.3e} from "
          f"torch.special.ndtri (bound 1e-12)")

    rows = np.random.RandomState(11).normal(size=(2000, 64))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "rows.csv")
        np.savetxt(path, rows, delimiter=",", header="a header line")
        t0 = time.perf_counter()
        with native.CsvReader(path, block_rows=512, skip_header=1) as reader:
            got = np.concatenate(list(reader))
        native_s = time.perf_counter() - t0
        real = native.available
        native.available = lambda: False
        try:
            t0 = time.perf_counter()
            want = np.concatenate(list(S.iter_text_blocks(
                path, block_rows=512, skip_header=1)))
            python_s = time.perf_counter() - t0
        finally:
            native.available = real
    check(got.shape == (2000, 64) and np.array_equal(got, want),
          "CsvReader and the pure-Python reader disagree")
    check(np.array_equal(got, rows), "CsvReader does not give back the "
          "rows that were written")

    # 'empirical' for a NumPy input: ranked on the card (what Corex does on
    # a CUDA device) against the host library's route plus the upload
    x_host = x.cpu().numpy()

    def on_card():
        t = torch.as_tensor(x_host, dtype=torch.float32, device="cuda")
        out = Pre.fit_preprocess(t, "empirical")
        torch.cuda.synchronize()
        return out

    on_card()
    card_s = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        xp_card, theta_card = on_card()
        card_s = min(card_s, time.perf_counter() - t0)
    host_model = lct.Corex(gaussianize="empirical", device="cpu")
    t0 = time.perf_counter()
    xp_host, theta_host = host_model._host_preprocess(x_host)
    xp_host = xp_host.to("cuda")
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    routes_err = float((xp_card - xp_host).abs().max())
    theta_err = float((theta_card.std.cpu() - theta_host.std).abs().max())
    check(routes_err < 1e-5 and theta_err < 1e-5,
          f"the two 'empirical' routes disagree: rows {routes_err:.3e}, "
          f"std {theta_err:.3e}")
    check(card_s < host_s, f"ranking on the card ({card_s:.3f} s) is not "
          f"faster than the host library ({host_s:.3f} s): Corex takes the "
          f"slower route on a CUDA device")
    check(lct.Corex(gaussianize="empirical",
                    device="cuda")._host_preprocess(x_host[:10]) is None,
          "a CUDA model took the host route")
    emit("native", available=True, ndtri_max_err=ndtri_err,
         csv_rows=2000, csv_cols=64, csv_native_seconds=native_s,
         csv_python_seconds=python_s, empirical_n=N, empirical_p=P,
         empirical_card_route_seconds=card_s,
         empirical_host_route_seconds=host_s,
         empirical_routes_max_abs_diff=routes_err, card=card)


def streaming_phase(x, ref, card):
    """Phase streaming, in float32 and with matmul_dtype='int8'. `ref`
    holds the in-memory fit's figures. Returns {path: launches}."""
    import numpy as np
    import torch
    import linearcorex_tpu_torch as lct
    from linearcorex_tpu_torch.ops import moments as Mo
    from linearcorex_tpu_torch.utils.streaming import _normalize_sigma

    lct.GramAccumulator(P).update(x[:STREAM_BATCH])     # untimed warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    acc = lct.GramAccumulator(P)
    check(acc._g.is_cuda, "the accumulator is not on the card")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(0, N, STREAM_BATCH):
        acc.update(x[i:i + STREAM_BATCH])
    end.record()
    torch.cuda.synchronize()
    acc_ms = start.elapsed_time(end)
    acc_peak = torch.cuda.max_memory_allocated()
    check(acc.n_samples == N, f"accumulated {acc.n_samples} rows")
    corr = acc.correlation()
    xs = (x - x.mean(0)) / x.std(0, correction=0)
    corr_err = float((corr - Mo.compute_gram(xs)).abs().max())
    del xs
    check(corr_err < 1e-5, f"the streamed correlation is off by "
          f"{corr_err:.3e} from compute_gram of the standardized x (bound "
          f"1e-5 of the largest magnitude, 1)")
    same_operand = bool(torch.equal(_normalize_sigma(corr)[0], corr))
    mean_shift = acc._s / float(N)
    cov_acc = acc._g / float(N) - torch.outer(mean_shift, mean_shift)
    check(torch.equal(_normalize_sigma(cov_acc)[0], corr),
          "the accumulated covariance does not normalize to correlation()")

    launches = {}
    kw = dict(optimizer="auto", seed=0, tol=FIT_TOL, max_iter=FIT_MAX_ITER)
    for name, extra in (("streaming", {}),
                        ("streaming_int8", dict(matmul_dtype="int8"))):
        model, launches[name], fit_s, msgs = counted(
            lambda: acc.fit(n_hidden=M, **kw, **extra))
        fit_peak = torch.cuda.max_memory_allocated()
        fields = check_north_star(name, model, launches[name], x,
                                  ref["tc"], gram_by_construction=True)
        check(model.n_samples == N and model.device == "cuda",
              f"{name}: n_samples={model.n_samples}, device={model.device}")
        guard = [w for w in msgs if "overflow" in w]
        check(not guard, f"{name}: the int8 wrap guard spoke: {guard}")
        cov_name = name.replace("streaming", "from_covariance")
        cov, launches[cov_name], cov_s, _ = counted(
            lambda: lct.fit_from_covariance(corr, N, M, **kw, **extra))
        check(launches[cov_name] > 0 and np.isfinite(cov.tc)
              and cov.resolved_optimizer_ == "fixed_point",
              f"{cov_name}: launches {launches[cov_name]}, TC {cov.tc}, "
              f"optimizer {cov.resolved_optimizer_}")
        tc_rel = abs(cov.tc - model.tc) / abs(model.tc)
        check(not same_operand or tc_rel < 1e-6,
              f"{cov_name}: TC {cov.tc} against the streamed fit's "
              f"{model.tc} from the same operand and seed")
        # the accumulated covariance normalizes to the streamed operand
        # bit for bit, so the fit from it must be the streamed fit
        exact, launches[cov_name + "_exact"], _, _ = counted(
            lambda: lct.fit_from_covariance(cov_acc, N, M, **kw, **extra))
        exact_rel = abs(exact.tc - model.tc) / abs(model.tc)
        check(launches[cov_name + "_exact"] > 0 and exact_rel < 1e-6,
              f"{cov_name}: from the accumulated covariance TC {exact.tc} "
              f"against the streamed fit's {model.tc}")
        emit(name, batches=N // STREAM_BATCH, batch_rows=STREAM_BATCH,
             accumulate_ms=acc_ms,
             accumulate_ms_per_batch=acc_ms / (N // STREAM_BATCH),
             corr_max_abs_err=corr_err, fit_seconds=fit_s,
             fit_seconds_in_memory=ref["seconds"],
             tc_in_memory=ref["tc"], blocks_whole_in_memory=ref["blocks"],
             peak_bytes_accumulate=acc_peak, peak_bytes_fit=fit_peak,
             from_covariance_tc=cov.tc, from_covariance_tc_rel_diff=tc_rel,
             from_covariance_same_operand_bitwise=same_operand,
             from_covariance_bitwise=bool(torch.equal(cov.ws, model.ws)),
             from_accumulated_covariance_tc_rel_diff=exact_rel,
             from_accumulated_covariance_bitwise=bool(
                 torch.equal(exact.ws, model.ws)),
             from_covariance_seconds=cov_s,
             from_covariance_launches=launches[cov_name],
             warnings=msgs, card=card,
             **{k: v for k, v in fields.items() if k != "tc_f32_same_w0"})
        del model, cov, exact
    return launches


def partial_fit_phase(x, card):
    """Phase partial_fit: two calls of half the rows each on one
    estimator. Returns {path: launches}."""
    import numpy as np
    import linearcorex_tpu_torch as lct

    half = N // 2
    est = lct.Corex(n_hidden=M, optimizer="auto", seed=0, tol=FIT_TOL,
                    max_iter=PF_MAX_ITER, device="cuda")
    launches, calls = {}, []
    for k, name in enumerate(("partial_fit_1", "partial_fit_2")):
        _, launches[name], secs, _ = counted(
            lambda: est.partial_fit(x[k * half:(k + 1) * half]))
        check(launches[name] > 0, f"{name} never launched the chain kernel")
        check(np.isfinite(est.tc), f"{name}: TC is not finite: {est.tc}")
        check(est.n_samples == (k + 1) * half,
              f"{name}: n_samples={est.n_samples}")
        calls.append(dict(n_samples=est.n_samples, tc=est.tc,
                          optimizer=est.resolved_optimizer_,
                          n_iter=est.n_iter_, seconds=secs,
                          iters_per_stage=est.diagnostics.iters_per_stage
                          .tolist(), kernel_launches=launches[name]))
    check(est._partial_acc is not None and est._partial_acc._g.is_cuda,
          "partial_fit keeps no accumulation on the card")
    est.set_params(max_iter=20)
    est.fit(x)
    check(est._partial_acc is None and est.n_samples == N,
          "fit did not drop the partial_fit accumulation")
    emit("partial_fit", calls=calls, max_iter=PF_MAX_ITER,
         second_over_first_iters=calls[1]["n_iter"] / calls[0]["n_iter"],
         blocks_whole=None, fit_resets_accumulation=True, card=card)
    return launches


def checkpoint_phase(x, ref, card):
    """Phase checkpoint: fit_with_checkpoints uninterrupted, then
    interrupted after stage 3 and resumed; save_corex -> load_corex.
    Returns {path: launches}."""
    import numpy as np
    import torch
    import linearcorex_tpu_torch as lct
    from linearcorex_tpu_torch.ops.cuda_moments import ns_chain
    from linearcorex_tpu_torch.utils.checkpoint import fit_with_checkpoints

    class Interrupted(Exception):
        pass

    def fresh():
        return lct.Corex(n_hidden=M, optimizer="auto", seed=0, tol=FIT_TOL,
                         max_iter=FIT_MAX_ITER, device="cuda")

    def run(ckdir, stop_after=None):
        per_stage = []

        def callback(stage, eps, ws, stats):
            per_stage.append(ns_chain.launches - sum(per_stage))
            check(ws.is_cuda, "a stage's weights left the card")
            if stage == stop_after:
                raise Interrupted

        model = fresh()
        try:
            _, n, secs, _ = counted(lambda: fit_with_checkpoints(
                model, x, ckdir, stage_callback=callback))
        except Interrupted:
            return None, per_stage, None
        check(per_stage and all(k > 0 for k in per_stage),
              f"a checkpointed stage ran without the kernel: {per_stage}")
        return model, per_stage, secs

    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        whole, stages, whole_s = run(os.path.join(tmp, "whole"))
        launches["checkpoint"] = sum(stages)
        fields = check_north_star("checkpoint", whole, sum(stages), x,
                                  ref["tc"])
        _, first, _ = run(os.path.join(tmp, "cut"), stop_after=3)
        check(len(first) == 4 and all(k > 0 for k in first),
              f"the interrupted run's stages: {first}")
        resumed, rest, resumed_s = run(os.path.join(tmp, "cut"))
        launches["checkpoint_resumed"] = sum(rest)
        check(len(rest) == len(stages) - 4,
              f"the resumed run ran {len(rest)} stages, not "
              f"{len(stages) - 4}")
        check(resumed.diagnostics.iters_per_stage.tolist()
              == whole.diagnostics.iters_per_stage.tolist(),
              "the resumed fit's iterations per stage differ from the "
              "uninterrupted fit's")
        tc_rel = abs(resumed.tc - whole.tc) / abs(whole.tc)
        check(tc_rel < 1e-6, f"the resumed fit's TC {resumed.tc} against "
              f"the uninterrupted {whole.tc}")
        state_bytes = os.path.getsize(os.path.join(tmp, "whole",
                                                   "stage_state.npz"))

        path = os.path.join(tmp, "model.npz")
        t0 = time.perf_counter()
        lct.save_corex(whole, path)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        again = lct.load_corex(path)
        load_s = time.perf_counter() - t0
        check(again.ws.is_cuda, "load_corex did not place the model on the "
              "card")
        y = whole.transform(x)
        check(torch.equal(again.transform(x), y),
              "the loaded model's transform differs from the saved one's")
        host = lct.load_corex(path, device="cpu")
        y_host = host.transform(x[:2000].cpu())
        host_rel = float((y_host - y[:2000].cpu()).abs().max()
                         / y[:2000].abs().max())
        check(not y_host.is_cuda and host_rel < 1e-5,
              f"the model loaded on the CPU transforms {host_rel:.3e} "
              f"off (bound 1e-5 relative)")
        model_bytes = os.path.getsize(path)
    emit("checkpoint", stages=len(stages), launches_per_stage=stages,
         launches_per_stage_resumed=rest, fit_seconds=whole_s,
         fit_seconds_plain=ref["seconds"],
         overhead_seconds_per_stage=(whole_s - ref["seconds"]) / len(stages),
         resumed_seconds=resumed_s, resumed_tc_rel_diff=tc_rel,
         resumed_bitwise=bool(torch.equal(resumed.ws, whole.ws)),
         plain_fit_tc_rel_diff=abs(whole.tc - ref["tc"]) / abs(ref["tc"]),
         stage_state_bytes=state_bytes, model_bytes=model_bytes,
         save_seconds=save_s, load_seconds=load_s,
         loaded_transform_bitwise=True, loaded_on_cpu_rel_err=host_rel,
         card=card,
         **{k: v for k, v in fields.items() if k != "tc_f32_same_w0"})
    return launches


def stacked_phase(x, card):
    """Phase stacked: a two-layer stack at the north-star width. Returns
    {path: launches}."""
    import numpy as np
    import torch
    import linearcorex_tpu_torch as lct
    from linearcorex_tpu_torch.ops.cuda_moments import ns_chain

    marks, handed = [], []
    real = lct.Corex.fit

    def recording(self, data, *args, **kwargs):
        handed.append(isinstance(data, torch.Tensor) and data.is_cuda)
        out = real(self, data, *args, **kwargs)
        marks.append(ns_chain.launches)
        return out

    stack = lct.StackedCorex(STACK, optimizer="auto", seed=0, tol=FIT_TOL,
                             max_iter=FIT_MAX_ITER, device="cuda")
    lct.Corex.fit = recording
    try:
        _, total, secs, _ = counted(lambda: stack.fit(x))
    finally:
        lct.Corex.fit = real
    peak = torch.cuda.max_memory_allocated()
    per_layer = [marks[0]] + [b - a for a, b in zip(marks, marks[1:])]
    check(len(per_layer) == len(STACK) and per_layer[0] > 0,
          f"stacked: kernel launches per layer {per_layer}")
    check(all(handed), "a layer was handed factors that are not on the card")
    check(tuple(stack.layers[1].ws.shape) == (STACK[1], STACK[0]),
          f"layer 2 weights {tuple(stack.layers[1].ws.shape)}")
    layer_tc = [layer.tc for layer in stack.layers]
    check(all(np.isfinite(t) and t > 0 for t in layer_tc),
          f"stacked: a layer's TC is not finite and positive: {layer_tc}")
    y = stack.transform(x)
    check(tuple(y.shape) == (N, STACK[-1]) and bool(torch.isfinite(y).all()),
          f"stacked: transform {tuple(y.shape)} is not finite")
    xr = stack.predict(y)
    check(tuple(xr.shape) == (N, P) and bool(torch.isfinite(xr).all()),
          "stacked: predict is not finite")

    # layer 2 again through the plain chain: same factors, same seed and so
    # the same W0 (after the counts were read; it launches no kernel)
    deep = stack.layers[1]
    plain = lct.Corex(n_hidden=STACK[1], optimizer="auto", seed=0,
                      tol=FIT_TOL, max_iter=FIT_MAX_ITER,
                      gaussianize="standard", use_pallas="never",
                      device="cuda")
    factors = stack.layers[0].transform(x)
    before = ns_chain.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain.fit(factors)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    check(ns_chain.launches == before,
          "stacked: the plain-chain fit launched the kernel")
    tc_rel = abs(deep.tc - plain.tc) / abs(plain.tc)
    check(tc_rel < STACK_TOL_REL,
          f"stacked: layer 2 through the kernel gives TC {deep.tc}, through "
          f"the plain chain {plain.tc}: {tc_rel:.3e} apart (bound "
          f"{STACK_TOL_REL:g})")
    same = bool((deep.clusters == plain.clusters).all())
    emit("stacked", n_hiddens=STACK, layer_tc=layer_tc, tc=stack.tc,
         launches_per_layer=per_layer, fit_seconds=secs,
         layer_optimizers=[la.resolved_optimizer_ for la in stack.layers],
         layer_iters=[la.n_iter_ for la in stack.layers],
         layer2_iters_per_stage=deep.diagnostics.iters_per_stage.tolist(),
         layer2_delta_per_stage=deep.diagnostics.delta_per_stage.tolist(),
         layer2_tc_per_stage=deep.diagnostics.tc_per_stage.tolist(),
         layer2_plain=dict(
             tc=plain.tc, tc_rel_diff=tc_rel, bound=STACK_TOL_REL,
             iters_per_stage=plain.diagnostics.iters_per_stage.tolist(),
             same_clusters=same, fit_seconds=plain_s),
         blocks_whole=blocks_whole(stack.clusters[0].cpu().numpy()),
         peak_bytes=peak, card=card)
    return {"stacked": total}


# Phase default_paths: the paths a user reaches by default, at full width.
# Each row: (name, Corex arguments, wide (n = WIDE_N), the strategy and
# optimizer 'auto' must resolve to, whether the chain kernel runs).
DEFAULT_PATHS = [
    ("momentum_f32", {}, False, "gram", "momentum", True),
    ("momentum_int8", dict(matmul_dtype="int8"), False, "gram", "momentum",
     True),
    ("momentum_bf16op", dict(matmul_dtype="bfloat16"), False, "gram",
     "momentum", True),
    ("dtype_bfloat16", dict(dtype="bfloat16"), False, "gram", "momentum",
     True),
    ("dtype_float16", dict(dtype="float16"), False, "gram", "momentum",
     True),
    ("wide_f32", dict(optimizer="auto"), True, "samples", "momentum", True),
    ("wide_int8", dict(optimizer="auto", matmul_dtype="int8"), True,
     "samples", "momentum", True),
    ("overlap_gram", dict(discourage_overlap=False, moment_strategy="gram"),
     False, "gram", "momentum", False),
    ("overlap_samples", dict(discourage_overlap=False,
                             moment_strategy="samples"), False, "samples",
     "momentum", False),
    ("empirical", dict(gaussianize="empirical", optimizer="auto"), False,
     "gram", "fixed_point", True),
    ("stage_subsample", dict(stage_subsample=0.5, moment_strategy="samples",
                             optimizer="auto"), False, "samples",
     "fixed_point", True),
    ("float64", dict(dtype="float64", optimizer="auto"), False, "gram",
     "fixed_point", False),
]
# the rows run a second time in the same process, which must give the
# same bits
DEFAULT_REPEATED = ("momentum_f32", "dtype_bfloat16", "float64")


def half_operand_checks():
    """The chain wrapper on bfloat16 and float16 operands (the dtype
    fits' C_xy, ry and sqz) must be bitwise the kernel on their float32
    casts, one lane at the north-star shape and three lanes at (999, 7).
    Returns the phase line's fields."""
    import torch
    from linearcorex_tpu_torch.ops.cuda_moments import ns_chain

    shapes = []
    for lanes, p, m in (((), P, M), ((3,), 999, 7)):
        ins = [chain_inputs(p, m, seed=1 + lane) for lane in range(
            lanes[0] if lanes else 1)]
        args = tuple(torch.stack(t) if lanes else t[0] for t in zip(*ins))
        for dt in (torch.bfloat16, torch.float16):
            half = tuple(a.to(dt) for a in args)
            got = ns_chain(*half, 1 - 1e-6)
            want = ns_chain(*(a.float() for a in half), 1 - 1e-6)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                check(g.dtype == torch.float32 and torch.equal(g, w),
                      f"ns_chain on {dt} operands at {lanes + (p, m)} is not "
                      f"the kernel on their float32 casts bit for bit")
            shapes.append(dict(shape=list(lanes + (p, m)),
                               dtype=str(dt).removeprefix("torch.")))
    return dict(half_operands_bitwise_float32_casts=shapes)


def default_paths_phase(x, card):
    """Phase default_paths: `DEFAULT_PATHS`, each through
    lct.Corex(n_hidden=512, seed=0, ...).fit at n = p = 10,000 (WIDE_N
    rows for the wide rows), max_iter=DEFAULT_MAX_ITER a stage. Gates:
    TC and W finite, the strategy and optimizer of the row, the kernel
    launched where the row says and nowhere else, the clusters a
    partition of p, a second fit of the DEFAULT_REPEATED rows bitwise the
    first, and the chain wrapper on half operands bitwise the kernel on
    their float32 casts. Reported, not gated: wall, iterations, ms per
    iteration, TC, block share, peak device bytes. Returns {row:
    launches}."""
    import numpy as np
    import torch
    import linearcorex_tpu_torch as lct
    from linearcorex_tpu_torch.models.corex import pick_fit_strategy

    t_phase = time.perf_counter()
    emit("default_paths_operands", card=card, **half_operand_checks())
    launches = {}
    for name, kw, wide, strategy, optimizer, kernel in DEFAULT_PATHS:
        data = x[:WIDE_N] if wide else x
        n = data.shape[0]

        def fit():
            model = lct.Corex(n_hidden=M, seed=0, tol=FIT_TOL,
                              max_iter=DEFAULT_MAX_ITER, device="cuda", **kw)
            return model.fit(data)

        model, ran, secs, msgs = counted(fit)
        peak = torch.cuda.max_memory_allocated()
        got = (pick_fit_strategy(model.config, n, P),
               model.resolved_optimizer_)
        check(got == (strategy, optimizer),
              f"default_paths {name}: resolved {got}, want "
              f"{(strategy, optimizer)}")
        check((ran > 0) == kernel,
              f"default_paths {name}: {ran} kernel launches, want "
              f"{'some' if kernel else 'none'}")
        check(np.isfinite(model.tc) and bool(torch.isfinite(model.ws).all()),
              f"default_paths {name}: TC {model.tc} or W is not finite")
        clusters = model.clusters.cpu()
        check(tuple(clusters.shape) == (P,) and int(clusters.min()) >= 0
              and int(clusters.max()) < M,
              f"default_paths {name}: the clusters are not a partition of "
              f"the {P} variables")
        launches[name] = ran
        fields = dict(
            n=n, p=P, m=M, dtype=str(model.ws.dtype).removeprefix("torch."),
            strategy=got[0], optimizer=got[1], kernel_launches=ran,
            fit_seconds=secs, n_iter=model.n_iter_,
            iters_per_stage=model.diagnostics.iters_per_stage.tolist(),
            wall_ms_per_iter=1e3 * secs / max(model.n_iter_, 1),
            tc=model.tc,
            blocks_whole=blocks_whole(clusters.numpy()), peak_bytes=peak,
            warnings=sorted(set(msgs)))
        if name in DEFAULT_REPEATED:
            again, ran2, secs2, _ = counted(fit)
            same = (torch.equal(again.ws, model.ws)
                    and again.tc == model.tc and torch.equal(
                        again.diagnostics.iters_per_stage,
                        model.diagnostics.iters_per_stage))
            check(same and ran2 == ran,
                  f"default_paths {name}: a second fit in the same process "
                  f"gave other bits")
            fields.update(repeat_bitwise=True, repeat_fit_seconds=secs2)
            del again
        emit("default_paths", path=name, card=card, **fields)
        del model
        torch.cuda.empty_cache()
    emit("default_paths_timing", card=card, **default_paths_timing(x))
    emit("default_paths_total", seconds=time.perf_counter() - t_phase,
         card=card)
    return launches


def default_paths_timing(x):
    """ms per fit_core iteration at the north-star shape (gram, the chain
    kernel, anneal=False, tol=0, TIMED_ITERS iterations; CUDA events, an
    untimed warm-up, the variants in turns): the fixed point against the
    default momentum, in float32, and momentum in dtype='bfloat16'."""
    import numpy as np
    import torch
    from linearcorex_tpu_torch.ops import moments as Mo

    xs = (x - x.mean(0)) / x.std(0, correction=0)
    gram = Mo.compute_gram(xs)
    del xs
    w0 = torch.as_tensor(np.random.RandomState(0).normal(
        scale=1 / np.sqrt(P), size=(M, P)), dtype=torch.float32,
        device=x.device)
    variants = [("fixed_point", "float32"), ("momentum", "float32"),
                ("momentum", "bfloat16")]
    ms = {v: [] for v in variants}
    iters = {}
    for turn in (variants, variants[::-1], variants):
        for optimizer, dtype in turn:
            dt = getattr(torch, dtype)
            run, out = fit_core_runner(gram.to(dt), w0.to(dt), "float32",
                                       "always", TIMED_ITERS,
                                       optimizer=optimizer, dtype=dtype)
            t = time_ms(run, reps=1, warmup=not ms[(optimizer, dtype)])
            n_it = int(out["diag"].iters_per_stage.sum())
            iters[f"{optimizer}/{dtype}"] = n_it
            ms[(optimizer, dtype)].append(t / n_it)
    return dict(p=P, m=M, strategy="gram", iters=iters,
                ms_per_iter={f"{o}/{d}": min(v) for (o, d), v in ms.items()},
                all_turns={f"{o}/{d}": v for (o, d), v in ms.items()})


def float64_card_vs_cpu(card):
    """Phase float64_card_vs_cpu: float64 fits on the card (cuBLAS,
    cuSOLVER) against the same fits on the CPU from one seeded W0, at n =
    2000, p = 1024, m = 32 with 8 planted blocks: the fixed point (gram),
    momentum (gram and samples) and the overlap objective (gram). Those
    three pairs must be step-matched: the same iterations per stage, TC
    and W within F64_TOL. The fixed point is reported with the iteration
    where the pair parts: with 24 surplus factors its m x m LU inverts a
    near-singular matrix, which amplifies the last bits in which two
    LAPACKs differ until an accept flips. The port's float64 CPU fit and
    the JAX package's part the same way on one CPU at this shape (ROADMAP
    Queue 3), so it is not held to it."""
    import numpy as np
    import linearcorex_tpu_torch as lct

    t_phase = time.perf_counter()
    rng = np.random.RandomState(5)
    zs = rng.normal(size=(2000, 8))
    xs = np.repeat(zs, 128, axis=1) * 0.9 + 0.436 * rng.normal(
        size=(2000, 1024))
    ws0 = rng.normal(scale=1 / 32, size=(32, 1024))
    base = dict(n_hidden=32, dtype="float64", max_iter=F64_MAX_ITER)
    cases = [("fixed_point_gram", dict(optimizer="fixed_point",
                                       moment_strategy="gram")),
             ("momentum_gram", dict(moment_strategy="gram")),
             ("momentum_samples", dict(moment_strategy="samples")),
             ("overlap_gram", dict(discourage_overlap=False,
                                   moment_strategy="gram"))]
    for name, kw in cases:
        fits = {}
        for dev in ("cuda", "cpu"):
            t0 = time.perf_counter()
            model = lct.Corex(device=dev, **base, **kw).fit(xs, init_ws=ws0)
            fits[dev] = (model, time.perf_counter() - t0)
        gpu, cpu = fits["cuda"][0], fits["cpu"][0]
        iters = (gpu.diagnostics.iters_per_stage.tolist(),
                 cpu.diagnostics.iters_per_stage.tolist())
        tc_diff = abs(gpu.tc - cpu.tc)
        w_diff = float((gpu.ws.cpu() - cpu.ws).abs().max())
        matched = iters[0] == iters[1] and tc_diff < F64_TOL \
            and w_diff < F64_TOL
        emit("float64_card_vs_cpu", path=name, gated=name in F64_GATED,
             step_matched=matched, iters_per_stage_card=iters[0],
             iters_per_stage_cpu=iters[1], tc_card=gpu.tc, tc_cpu=cpu.tc,
             tc_abs_diff=tc_diff, w_max_abs_diff=w_diff, bound=F64_TOL,
             parts_at=_first_parting(gpu, cpu), card_seconds=fits["cuda"][1],
             cpu_seconds=fits["cpu"][1], card=card)
        check(matched or name not in F64_GATED,
              f"float64 fit '{name}' on the card is not step-matched with "
              f"the CPU fit (iterations {iters}, TC {tc_diff:.3e}, W "
              f"{w_diff:.3e} apart; bound {F64_TOL:g})")
    emit("float64_card_vs_cpu_total", seconds=time.perf_counter() - t_phase,
         card=card)


def _first_parting(a, b):
    """Where two fits' per-iteration TC histories first differ by more than
    F64_TOL: {stage, iteration, largest difference before it}, or None."""
    import numpy as np

    ha, hb = (m.diagnostics.tc_history.cpu().numpy() for m in (a, b))
    ia, ib = (m.diagnostics.iters_per_stage.tolist() for m in (a, b))
    worst = 0.0
    for s, (ka, kb) in enumerate(zip(ia, ib)):
        k = min(ka, kb)
        d = np.abs(ha[s, :k] - hb[s, :k])
        off = np.flatnonzero(d > F64_TOL)
        if off.size:
            return dict(stage=s, iteration=int(off[0]),
                        max_diff_before=max(worst, float(
                            d[:off[0]].max(initial=0.0))))
        worst = max(worst, float(d.max(initial=0.0)))
        if ka != kb:
            return dict(stage=s, iteration=k, max_diff_before=worst)
    return None


def small_streaming(card):
    """Streamed, partial_fit, checkpointed and stacked fits on the card
    (n=2000, p=256, m=8) against the port's float64 CPU results from the
    same W0 (phase small_streaming). Returns {path: launches}."""
    import numpy as np
    import linearcorex_tpu_torch as lct
    from linearcorex_tpu_torch.utils.checkpoint import fit_with_checkpoints

    rng = np.random.RandomState(3)
    xs = np.repeat(rng.normal(size=(2000, 8)), 32, axis=1) * 0.9 \
        + 0.436 * rng.normal(size=(2000, 256))
    ws0 = rng.normal(scale=1 / 16, size=(8, 256))
    # two coarse factors over the eight fine ones, for the stack's layer 2
    coarse = rng.normal(size=(2000, 2))
    fine = 0.8 * np.repeat(coarse, 4, axis=1) + 0.6 * rng.normal(
        size=(2000, 8))
    xh = np.repeat(fine, 32, axis=1) * 0.9 + 0.436 * rng.normal(
        size=(2000, 256))
    small = dict(n_hidden=8, seed=0, max_iter=2000)
    devices = (dict(device="cuda"), dict(device="cpu", dtype="float64"))

    def streamed(dev):
        acc = lct.GramAccumulator(256, dtype=dev.get("dtype", "float32"),
                                  device=dev["device"])
        for i in range(0, 2000, 400):
            acc.update(xs[i:i + 400])
        return [acc.fit(pretrained_weights=ws0, **small)]

    def partial(dev):
        est = lct.Corex(pretrained_weights=ws0, **small, **dev)
        for i in range(0, 2000, 500):
            est.partial_fit(xs[i:i + 500])
        return [est]

    def checkpointed(dev):
        with tempfile.TemporaryDirectory() as tmp:
            return [fit_with_checkpoints(lct.Corex(**small, **dev), xs, tmp,
                                         init_ws=ws0)]

    def stacked(dev):
        kw = {k: v for k, v in small.items() if k != "n_hidden"}
        return lct.StackedCorex([8, 2], **kw, **dev).fit(xh).layers

    launches = {}
    for name, fn in (("streamed", streamed), ("partial_fit", partial),
                     ("checkpointed", checkpointed), ("stacked", stacked)):
        gpu, launches[f"small_{name}"], _, _ = counted(
            lambda: fn(devices[0]))
        cpu = fn(devices[1])
        check(launches[f"small_{name}"] > 0,
              f"small '{name}' never launched the chain kernel")
        for layer, (g, c) in enumerate(zip(gpu, cpu)):
            rel_tc = abs(g.tc - c.tc) / abs(c.tc)
            same = bool(np.array_equal(g.clusters, c.clusters))
            emit("small_streaming", path=name, layer=layer, tc_card=g.tc,
                 tc_cpu_f64=c.tc, tc_rel_diff=rel_tc, clusters_equal=same,
                 n_iter_card=g.n_iter_, n_iter_cpu=c.n_iter_,
                 kernel_launches=launches[f"small_{name}"], card=card)
            check(same and rel_tc < SMALL_TOL_REL,
                  f"small '{name}' fit (layer {layer}) on the card "
                  f"disagrees with the float64 CPU fit")
    return launches


def profiling_phase(data, w0, card):
    """Phase profiling: utils.profiling.iteration_rate against this
    script's own timing of the same run, and a utils.profiling.trace that
    must show the chain kernel by name."""
    import re

    from linearcorex_tpu_torch.utils import profiling

    run, out = fit_core_runner(data, w0, "float32", "always", TIMED_ITERS)

    def run_fn():
        run()
        return None, out["diag"]

    own_ms = time_ms(run, reps=3)
    rate, total, seconds = profiling.iteration_rate(run_fn, reps=3)
    own_rate = total / (own_ms / 1e3)
    check(total == TIMED_ITERS, f"iteration_rate counted {total} iterations")
    check(abs(rate - own_rate) / own_rate < 0.05,
          f"iteration_rate gives {rate:.2f} it/s, this script's CUDA "
          f"events {own_rate:.2f} (more than 5% apart)")
    short, _ = fit_core_runner(data, w0, "float32", "always", 3)
    short()
    with tempfile.TemporaryDirectory() as tmp:
        with profiling.trace(tmp) as prof:
            short()
        files = os.listdir(tmp)
        check(len(files) == 1, f"trace wrote {files}")
        with open(os.path.join(tmp, files[0])) as f:
            text = f.read()
    named = sorted({found.group(0) for e in prof.key_averages()
                    for found in [re.search(r"chain_\w+", e.key)] if found})
    check(named and "chain_gemm_kernel" in text,
          f"the trace holds no kernel of ns_chain.cu (found {named})")
    emit("profiling", iteration_rate_it_per_s=rate,
         iteration_rate_seconds=seconds, own_it_per_s=own_rate,
         rel_diff=abs(rate - own_rate) / own_rate, iters=total,
         trace_bytes=len(text), trace_chain_kernels=named, card=card)


def small_fits(card):
    """Small fits on the card against the port's float64 CPU fit from the
    same W0 (phase 6)."""
    import numpy as np
    import linearcorex_tpu_torch as lct

    rng = np.random.RandomState(3)
    zs = rng.normal(size=(2000, 8))
    xs = np.repeat(zs, 32, axis=1) * 0.9 + 0.436 * rng.normal(
        size=(2000, 256))
    ws0 = rng.normal(scale=1 / 16, size=(8, 256))
    small = dict(n_hidden=8, seed=0, max_iter=2000)
    cases = [("small_reference", dict(use_pallas="always")),
             ("overlap_gram", dict(discourage_overlap=False,
                                   moment_strategy="gram")),
             ("overlap_samples", dict(discourage_overlap=False,
                                      moment_strategy="samples")),
             ("empirical", dict(gaussianize="empirical")),
             ("stage_subsample", dict(stage_subsample=0.5,
                                      moment_strategy="samples"))]
    for name, kw in cases:
        gpu = lct.Corex(device="cuda", **small, **kw).fit(xs, init_ws=ws0)
        cpu = lct.Corex(dtype="float64", device="cpu", **small, **{
            k: v for k, v in kw.items() if k != "use_pallas"}).fit(
            xs, init_ws=ws0)
        rel_tc = abs(gpu.tc - cpu.tc) / abs(cpu.tc)
        same = bool(np.array_equal(gpu.clusters, cpu.clusters))
        fields = dict(tc_card=gpu.tc, tc_cpu_f64=cpu.tc, tc_rel_diff=rel_tc,
                      clusters_equal=same, n_iter_card=gpu.n_iter_,
                      n_iter_cpu=cpu.n_iter_)
        if name == "small_reference":
            emit(name, **fields)
        else:
            emit("small_paths", path=name, **fields)
        check(same and rel_tc < SMALL_TOL_REL,
              f"small fit '{name}' on the card disagrees with the float64 "
              f"CPU fit")


def small_restarts(card):
    """3-lane sweeps on the card against the port's float64 CPU sweep
    (phase small_restarts). The non-overlap lanes of this data reach one
    optimum (TC equal to 1e-9 in float64), so the card's winning lane is
    held to being a best lane on the CPU: its float64 single fit's TC
    within SMALL_TOL_REL of the CPU sweep's. Returns {path: launches}."""
    import numpy as np
    import linearcorex_tpu_torch as lct
    from linearcorex_tpu_torch.ops.cuda_moments import ns_chain

    rng = np.random.RandomState(3)
    xs = np.repeat(rng.normal(size=(2000, 8)), 32, axis=1) * 0.9 \
        + 0.436 * rng.normal(size=(2000, 256))
    launches = {}
    for name, overlap in (("small_restarts", False),
                          ("small_restarts_overlap", True)):
        kw = dict(n_hidden=8, n_restarts=3, seed=0, max_iter=2000,
                  discourage_overlap=not overlap)
        ns_chain.launches = ns_chain.lane_launches = 0
        gpu = lct.Corex(device="cuda", **kw).fit(xs)
        launches[name] = ns_chain.lane_launches
        cpu = lct.Corex(dtype="float64", device="cpu", **kw).fit(xs)
        lane = lct.Corex(dtype="float64", device="cpu", **dict(
            kw, n_restarts=1, seed=gpu.best_restart_)).fit(xs)
        rel_tc = abs(gpu.tc - cpu.tc) / abs(cpu.tc)
        lane_rel = abs(lane.tc - cpu.tc) / abs(cpu.tc)
        same = bool(np.array_equal(gpu.clusters, cpu.clusters))
        emit("small_restarts", path=name, best_restart_card=gpu.best_restart_,
             best_restart_cpu=cpu.best_restart_, tc_card=gpu.tc,
             tc_cpu_f64=cpu.tc, tc_rel_diff=rel_tc, clusters_equal=same,
             card_lane_on_cpu_rel=lane_rel, lane_launches=launches[name],
             card=card)
        check(same and rel_tc < SMALL_TOL_REL and lane_rel < SMALL_TOL_REL,
              f"small sweep '{name}' on the card disagrees with the float64 "
              f"CPU sweep")
        check(overlap or launches[name] > 0,
              f"{name}: the sweep never launched the lane kernel")
    return launches


def selection(dev, card):
    """Phase selection: pick_n_hidden, padded and sequential, under both
    criteria. Returns {path: lane launches}."""
    import torch
    import linearcorex_tpu_torch as lct
    from linearcorex_tpu_torch.ops.cuda_moments import ns_chain

    x = block_data(SEL_N, SEL_P, SEL_BLOCKS, seed=DATA_SEED + 2, dev=dev)
    launches, best, walls = {}, {}, {}
    for criterion in ("tc", "heldout"):
        for padded in (True, False):
            name = f"selection_{criterion}_{'padded' if padded else 'seq'}"
            torch.cuda.synchronize()
            ns_chain.launches = ns_chain.lane_launches = 0
            t0 = time.perf_counter()
            best[name], scores = lct.pick_n_hidden(
                x, repeat=4, max_n_hidden=8, max_iter=2000, seed=0,
                padded_sweep=padded, criterion=criterion, device="cuda")
            torch.cuda.synchronize()
            walls[name] = time.perf_counter() - t0
            launches[name] = ns_chain.lane_launches
            check(launches[name] > 0 and ns_chain.launches == 0,
                  f"{name}: the sweep did not run on the lane kernel")
            emit("selection", path=name, best_n=best[name],
                 planted=SEL_BLOCKS, scores=scores.tolist(),
                 wall_seconds=walls[name], lane_launches=launches[name],
                 card=card)
        pad, seq = (best[f"selection_{criterion}_{k}"]
                    for k in ("padded", "seq"))
        check(pad == seq, f"selection '{criterion}': the padded sweep chose "
              f"{pad}, the sequential loop {seq}")
    emit("selection_summary", n=SEL_N, p=SEL_P, best_n=best,
         found_planted={k: v == SEL_BLOCKS for k, v in best.items()},
         walls=walls, card=card)
    return launches


def warmup_child(spec):
    """One fresh process of phase warmup, started by `warmup_phase` as
    `python3 -c "import chip_smoke as C; C.warmup_child(spec)"` with
    LINEARCOREX_TPU_CACHE_DIR set. Prints one JSON line: the seconds of
    each step (the wall clock around the call and a synchronize), the
    chain kernel's launches and the compiles (`utils.build.COMPILES`)
    within it, and the build directory's files between steps."""
    t0 = time.perf_counter()
    import numpy as np
    import torch

    import linearcorex_tpu_torch as lct
    from linearcorex_tpu_torch.ops.cuda_moments import ns_chain
    from linearcorex_tpu_torch.utils import build

    out = {"import_s": time.perf_counter() - t0}
    cache = os.environ["LINEARCOREX_TPU_CACHE_DIR"]
    dev = torch.device("cuda")

    def files():
        return sorted(os.listdir(cache))

    def timed(fn):
        ns_chain.launches = ns_chain.lane_launches = 0
        done = len(build.COMPILES)
        t = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, dict(s=time.perf_counter() - t, launches=ns_chain.launches,
                         lane_launches=ns_chain.lane_launches,
                         compiles=build.COMPILES[done:])

    _, out["context"] = timed(lambda: torch.zeros(1, device=dev))
    kind = spec["kind"]
    if kind == "fit":
        x, out["data"] = timed(lambda: block_data(N, P, BLOCKS, DATA_SEED,
                                                  dev))
        kw = dict(n_hidden=M, seed=0, tol=FIT_TOL, max_iter=FIT_MAX_ITER,
                  optimizer="auto", matmul_dtype=spec["matmul_dtype"],
                  device="cuda")
        model = lct.Corex(**kw)
        out["files_before"] = files()
        if spec["warm"]:
            _, out["warmup"] = timed(lambda: model.warmup(N, P))
            out["files_after_warmup"] = files()
            check(model.ws is None, "Corex.warmup fitted the model")
        out["fits"] = []
        for i in range(spec["fits"]):
            fitted = model if i == 0 else lct.Corex(**kw)
            _, rec = timed(lambda: fitted.fit(x))
            rec.update(tc=fitted.tc, n_iter=fitted.n_iter_)
            out["fits"].append(rec)
        out["files_after"] = files()
        np.savez(spec["bits"], ws=model.ws.cpu().numpy(),
                 tc=np.float64(model.tc),
                 iters=model.diagnostics.iters_per_stage.cpu().numpy())
        lct.save_corex(model, spec["model"])
        if spec.get("host"):
            _, out["host_build"] = timed(build.build_host)
    elif kind == "serve":
        x, out["data"] = timed(lambda: block_data(
            WARMUP_ROWS, P, BLOCKS, DATA_SEED + 3, dev))
        model, out["load"] = timed(lambda: lct.load_corex(spec["model"],
                                                          device="cuda"))
        _, out["warmup_serving"] = timed(lambda: lct.warmup_serving(
            model, WARMUP_ROWS))
        out["calls"], ys = [], []
        for _ in range(2):
            y, rec_t = timed(lambda: model.transform(x))
            s, rec_s = timed(lambda: model.score(x))
            check(bool(torch.isfinite(y).all()) and np.isfinite(s),
                  "serving after warmup_serving is not finite")
            ys.append(y)
            out["calls"].append(dict(transform=rec_t, score=rec_s))
        out["repeat_bitwise"] = bool(torch.equal(ys[0], ys[1]))
    else:
        x, out["data"] = timed(lambda: block_data(
            SEL_N, SEL_P, SEL_BLOCKS, DATA_SEED + 2, dev))
        kw = warmup_sweep_kwargs()
        _, out["warmup_sweep"] = timed(lambda: lct.warmup_sweep(SEL_N, SEL_P,
                                                               **kw))
        out["sweeps"] = []
        for _ in range(2):
            (best, scores), rec = timed(lambda: lct.pick_n_hidden(x, **kw))
            rec.update(best=best, scores=scores.tolist())
            out["sweeps"].append(rec)
    out["files_end"] = files()
    print(json.dumps(out), flush=True)


def warmup_sweep_kwargs():
    """The pick_n_hidden / warmup_sweep arguments of phase warmup's sweeps:
    the selection phase's padded 'tc' sweep at a cut depth."""
    return dict(repeat=4, max_n_hidden=8, max_iter=WARMUP_SWEEP_MAX_ITER,
                seed=0, padded_sweep=True, criterion="tc", device="cuda")


def warmup_phase(card):
    """Phase warmup (see the module docstring): fresh processes on the
    card, cold, on a warm build directory, and after the warmups; the
    gates hold the warmed calls to the unwarmed ones bit for bit. Returns
    ({path: one-lane launches}, {path: lane launches}) of the warmups and
    the calls after them, counted in those processes."""
    import numpy as np
    import torch

    import linearcorex_tpu_torch as lct

    # the unwarmed sweep (e) is held to: this process never warmed one
    best, scores = lct.pick_n_hidden(
        block_data(SEL_N, SEL_P, SEL_BLOCKS, DATA_SEED + 2,
                   torch.device("cuda")), **warmup_sweep_kwargs())
    sweep_ref = (best, scores.tolist())

    here = os.path.dirname(os.path.abspath(__file__))
    root = tempfile.mkdtemp(prefix="chip_smoke_warmup_")

    def child(spec, cache):
        env = dict(os.environ, LINEARCOREX_TPU_CACHE_DIR=cache)
        env.pop("LINEARCOREX_TPU_NO_COMPILE_CACHE", None)
        t = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c",
             f"import chip_smoke as C; C.warmup_child({spec!r})"],
            cwd=here, env=env, capture_output=True, text=True,
            timeout=WARMUP_CHILD_TIMEOUT)
        check(proc.returncode == 0, f"warmup process {spec} failed:\n"
              f"{proc.stdout[-3000:]}\n{proc.stderr[-5000:]}")
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        rec["process_s"] = time.perf_counter() - t
        return rec

    def compiled(rec):
        return [c["what"] for c in rec["compiles"]]

    def seconds(rec, what):
        return sum(c["seconds"] for c in rec["compiles"]
                   if c["what"].endswith(what))

    launches, lane_launches, models = {}, {}, {}
    t_phase = time.perf_counter()
    # (a) runs once, in float32: (c) on an empty directory times nvcc in
    # each mode, and (b) of int8 runs on the directory (a) filled
    cold = os.path.join(root, "cold")
    os.makedirs(cold)
    try:
        for dt in ("float32", "int8"):
            fresh = os.path.join(root, f"{dt}_warmed")
            os.makedirs(fresh)
            path = {k: os.path.join(root, f"{dt}_{k}") for k in "abc"}
            base = dict(kind="fit", matmul_dtype=dt)
            if dt == "float32":
                a = child(dict(base, warm=False, fits=1, host=True,
                               bits=path["a"] + ".bits.npz",
                               model=path["a"] + ".npz"), cold)
                check(compiled(a["fits"][0]) == ["ns_chain.cu"]
                      and a["fits"][0]["launches"] > 0,
                      f"{dt} (a): the cold first fit built "
                      f"{compiled(a['fits'][0])}, not the kernel alone, "
                      f"or did not run it")
            b = child(dict(base, warm=False, fits=2,
                           bits=path["b"] + ".bits.npz",
                           model=path["b"] + ".npz"), cold)
            c = child(dict(base, warm=True, fits=2,
                           bits=path["c"] + ".bits.npz",
                           model=path["c"] + ".npz"), fresh)
            models[dt] = path["b"] + ".npz"
            check(all(not f["compiles"] for f in b["fits"]),
                  f"{dt} (b): a fit on the warm directory built something")
            check(compiled(c["warmup"]) == ["ns_chain.cu"],
                  f"{dt} (c): the warmup built {compiled(c['warmup'])}")
            check(c["warmup"]["launches"] > 0
                  and c["warmup"]["lane_launches"] == 0,
                  f"{dt} (c): the warmup did not launch the kernel")
            check(all(not f["compiles"] for f in c["fits"])
                  and c["files_after"] == c["files_after_warmup"],
                  f"{dt} (c): the fits after the warmup built something")
            check(all(f["launches"] > 0 for f in b["fits"] + c["fits"]),
                  f"{dt}: a fit did not run the kernel")
            ran = "abc" if dt == "float32" else "bc"
            bits = {k: np.load(path[k] + ".bits.npz") for k in ran}
            same = {k: all(np.array_equal(bits[k][f], bits["b"][f])
                           for f in ("ws", "tc", "iters")) for k in ran}
            check(same["c"], f"{dt} (c): the fit after the warmup differs "
                  f"from the unwarmed process's fit")
            saved = {k: np.load(path[k] + ".npz") for k in "bc"}
            check(sorted(saved["b"].files) == sorted(saved["c"].files)
                  and all(np.array_equal(saved["b"][f], saved["c"][f])
                          for f in saved["b"].files),
                  f"{dt} (c): save_corex of the warmed fit differs")
            suffix = "" if dt == "float32" else "_int8"
            launches["warmup_fit" + suffix] = c["warmup"]["launches"]
            launches["warmed_fit" + suffix] = c["fits"][0]["launches"]
            emit("warmup", matmul_dtype=dt, n=N, p=P, m=M,
                 cold=None if dt != "float32" else dict(
                     first_fit_s=a["fits"][0]["s"],
                     nvcc_s=seconds(a["fits"][0], ".cu"),
                     gxx_s_in_fit=seconds(a["fits"][0], ".cpp"),
                     gxx_alone_s=seconds(a["host_build"], ".cpp"),
                     context_s=a["context"]["s"], import_s=a["import_s"],
                     process_s=a["process_s"],
                     fit_bitwise_warm_dir=same["a"]),
                 warm_dir=dict(first_fit_s=b["fits"][0]["s"],
                               second_fit_s=b["fits"][1]["s"],
                               context_s=b["context"]["s"],
                               process_s=b["process_s"]),
                 warmed=dict(warmup_s=c["warmup"]["s"],
                             warmup_nvcc_s=seconds(c["warmup"], ".cu"),
                             warmup_launches=c["warmup"]["launches"],
                             first_fit_s=c["fits"][0]["s"],
                             second_fit_s=c["fits"][1]["s"],
                             process_s=c["process_s"]),
                 tc=b["fits"][0]["tc"], n_iter=b["fits"][0]["n_iter"],
                 warmed_fit_bitwise=True, saved_model_equal=True,
                 card=card)
        cache = cold
        d = child(dict(kind="serve", model=models["float32"]), cache)
        check(d["repeat_bitwise"], "(d): two transforms differ")
        emit("warmup_serving", rows=WARMUP_ROWS, p=P, m=M,
             load_s=d["load"]["s"], warmup_serving_s=d["warmup_serving"]["s"],
             first_transform_s=d["calls"][0]["transform"]["s"],
             second_transform_s=d["calls"][1]["transform"]["s"],
             first_score_s=d["calls"][0]["score"]["s"],
             second_score_s=d["calls"][1]["score"]["s"],
             process_s=d["process_s"], card=card)
        e = child(dict(kind="sweep"), cache)
        check(e["warmup_sweep"]["lane_launches"] > 0
              and e["warmup_sweep"]["launches"] == 0,
              "(e): warmup_sweep did not run the lane kernel")
        check(all(not r["compiles"] for r in [e["warmup_sweep"]]
                  + e["sweeps"]), "(e): the sweep process built something")
        first = e["sweeps"][0]
        check((first["best"], first["scores"]) == sweep_ref,
              f"(e): the warmed sweep chose {first['best']} with scores "
              f"{first['scores']}, the same sweep in this process "
              f"{sweep_ref}")
        lane_launches["warmup_sweep"] = e["warmup_sweep"]["lane_launches"]
        lane_launches["warmed_sweep"] = first["lane_launches"]
        emit("warmup_sweep", n=SEL_N, p=SEL_P, max_n_hidden=8, repeat=4,
             warmup_sweep_s=e["warmup_sweep"]["s"],
             warmup_lane_launches=e["warmup_sweep"]["lane_launches"],
             max_iter=WARMUP_SWEEP_MAX_ITER, first_sweep_s=first["s"],
             second_sweep_s=e["sweeps"][1]["s"], best_n=first["best"],
             bitwise_unwarmed_sweep=True,
             process_s=e["process_s"], card=card)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit("warmup_summary", phase_s=time.perf_counter() - t_phase,
         launches=launches, lane_launches=lane_launches, card=card)
    return launches, lane_launches


def timed_operands(dev):
    """The north-star operands for the timing and profile phases: the Gram
    matrix of standardized block data in each mode, and a seeded W0."""
    import numpy as np
    import torch
    from linearcorex_tpu_torch.ops import moments as Mo

    x = block_data(N, P, BLOCKS, seed=DATA_SEED + 1, dev=dev)
    x = (x - x.mean(0)) / x.std(0, correction=0)
    gram = Mo.compute_gram(x)
    del x
    w0 = torch.as_tensor(np.random.RandomState(0).normal(
        scale=1 / np.sqrt(P), size=(M, P)), dtype=torch.float32, device=dev)
    return {"float32": gram, "bfloat16": gram.to(torch.bfloat16),
            "int8": Mo.quantize_gram(gram)}, w0


def fit_core_runner(data, w0, matmul_dtype, use_pallas, iters,
                    precision="default", optimizer="fixed_point",
                    dtype="float32"):
    """A closure running `iters` iterations of fit_core (fixed point
    unless `optimizer` says otherwise; `data` and `w0` in `dtype`) at the
    north-star shape (anneal=False, tol=0) at full float32, or in the
    fit's precision scope for another `precision` (matmul_precision); it
    stores the diagnostics. The default needs nothing newer than
    `M.full_f32_matmul`, so compare_chain.py runs it on older checkouts
    of the package too."""
    from linearcorex_tpu_torch.config import CorexConfig
    from linearcorex_tpu_torch.core.solver import fit_core
    from linearcorex_tpu_torch.models.corex import _make_obj_grad
    from linearcorex_tpu_torch.ops import moments as Mo

    cfg = CorexConfig(n_hidden=M, max_iter=iters, tol=0.0, anneal=False,
                      record_history=False, optimizer=optimizer,
                      use_pallas=use_pallas, matmul_dtype=matmul_dtype,
                      matmul_precision=precision, dtype=dtype)
    obj_grad = _make_obj_grad(data, cfg, "gram")
    out = {}

    def scope():
        if precision == "default":
            return Mo.full_f32_matmul()
        from linearcorex_tpu_torch.models.corex import precision_ctx
        return precision_ctx(cfg, w0.device)

    def run():
        with scope():
            out["diag"] = fit_core(obj_grad, w0, cfg)[1]
    return run, out


def profile_iterations(data, w0, mode, card, label=None):
    """torch.profiler over PROFILED_ITERS north-star iterations of one
    operand mode (after an untimed warm-up; W0 (k, m, p) profiles k
    lanes): wall, device-busy and idle ms per iteration and the top
    kernels by device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    run, _ = fit_core_runner(data, w0, mode, "always", PROFILED_ITERS)
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if getattr(e, "device_time_total", 0) > 0
               and e.device_type == torch.autograd.DeviceType.CUDA]
    kernels.sort(key=lambda e: -e.device_time_total)
    # one iteration = one objective evaluation; fit_core runs one more
    evals = PROFILED_ITERS + 1
    busy_ms = sum(e.device_time_total for e in kernels) / 1e3 / evals
    wall_ms = wall * 1e3 / evals
    emit("profile", mode=label or mode, evaluations=evals, wall_ms=wall_ms,
         device_busy_ms=busy_ms, idle_share=1 - busy_ms / wall_ms,
         top=[{"kernel": e.key[:90], "ms": e.device_time_total / 1e3 / evals,
               "calls": e.count / evals} for e in kernels[:10]], card=card)


def main():
    import warnings

    import numpy as np
    import torch

    # 1. env
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False — "
                         "this script runs only on a CUDA card")
    import linearcorex_tpu_torch as lct
    from linearcorex_tpu_torch.ops.cuda_moments import (ns_chain,
                                                        ns_chain_reference)
    from linearcorex_tpu_torch.utils import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    dev = torch.device("cuda")
    emit("env", card=card, torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0],
         device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count())

    # 2. build: the kernel (nvcc) and the host library (g++) together
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=2) as pool:
        kernel_build = pool.submit(build.build, "ns_chain", force=True)
        host_build = pool.submit(build.build_host, force=True)
        rec, host_rec = kernel_build.result(), host_build.result()
    build.load("ns_chain")
    ptxas, hgmma = build_checks(rec)
    emit("build", seconds=rec["seconds"], library=rec["path"],
         spill_bytes=0, hgmma_instructions=hgmma, ptxas=ptxas,
         host_seconds=host_rec["seconds"], host_library=host_rec["path"])

    # 3. kernels
    # the main paths' own shapes first: the north star, a stack's layer 2
    shapes = [(P, M), tuple(STACK), (400, 100), (999, 7), (257, 130),
              (1, 8), (37, 256), (1024, 8), (300, 520), (2000, 1030)]
    max_abs_err = 0.0
    names = ("aa", "hmat", "kappa", "mu", "mi_sums", "sum_log_vi")
    for p, m in shapes:
        cxy, ry, sqz = chain_inputs(p, m)
        got = ns_chain(cxy, ry, sqz, 1 - 1e-6)
        again = ns_chain(cxy, ry, sqz, 1 - 1e-6)
        want = ns_chain_reference(cxy, ry, sqz, 1 - 1e-6)
        torch.cuda.synchronize()
        rel = {}
        for name, g, g2, w in zip(names, got, again, want):
            check(g.shape == w.shape, f"{name} shape {tuple(g.shape)} at "
                  f"({p}, {m}), want {tuple(w.shape)}")
            err = float(torch.max(torch.abs(g - w)))
            max_abs_err = max(max_abs_err, err)
            rel[name] = err / (float(torch.max(torch.abs(w))) + 1e-12)
            check(rel[name] < TOL_REL, f"{name} at ({p}, {m}) is off by "
                  f"{rel[name]:.3e} relative (bound {TOL_REL:g})")
            check(torch.equal(g, g2), f"{name} at ({p}, {m}) differs "
                  f"between two launches on the same inputs")
        emit("kernels", p=p, m=m, rel_err=rel, bound=TOL_REL,
             bitwise_repeatable=True)

    # 3b. the lane entry
    lanes_err = 0.0
    for k, p, m, dead in ((LANES, P, M, 0), (3, 999, 7, 0),
                          (32, SEL_P, 8, 5), (16, SEL_P, 8, 3)):
        lanes_in = [chain_inputs(p, m, seed=1 + lane, dead=dead)
                    for lane in range(k)]
        cxy, ry, sqz = (torch.stack(t) for t in zip(*lanes_in))
        del lanes_in
        got = ns_chain(cxy, ry, sqz, 1 - 1e-6)
        again = ns_chain(cxy, ry, sqz, 1 - 1e-6)
        want = ns_chain_reference(cxy, ry, sqz, 1 - 1e-6)
        torch.cuda.synchronize()
        rel = {}
        for name, g, g2, w in zip(names, got, again, want):
            check(g.shape == w.shape, f"lanes {name} shape {tuple(g.shape)}"
                  f" at ({k}, {p}, {m}), want {tuple(w.shape)}")
            err = float(torch.max(torch.abs(g - w)))
            lanes_err = max(lanes_err, err)
            rel[name] = err / (float(torch.max(torch.abs(w))) + 1e-12)
            check(rel[name] < TOL_REL, f"lanes {name} at ({k}, {p}, {m}) is "
                  f"off by {rel[name]:.3e} relative (bound {TOL_REL:g})")
            check(torch.equal(g, g2), f"lanes {name} at ({k}, {p}, {m}) "
                  f"differs between two launches on the same inputs")
        for lane in range(k):
            one = ns_chain(cxy[lane], ry[lane], sqz[lane], 1 - 1e-6)
            for name, g, o in zip(names, got, one):
                check(torch.equal(g[lane], o), f"lanes {name} at ({k}, {p}, "
                      f"{m}): lane {lane} differs from a one-lane launch")
        if dead:
            check(bool((got[0][:, :, m - dead:] == 0).all())
                  and bool((got[1][:, m - dead:, :] == 0).all())
                  and bool((got[1][:, :, m - dead:] == 0).all()),
                  "zero W rows gave non-zero AA rows or H entries")
        emit("kernels_lanes", lanes=k, p=p, m=m, zero_rows=dead,
             rel_err=rel, bound=TOL_REL, lanes_bitwise_single=True,
             bitwise_repeatable=True)
        del cxy, ry, sqz, got, again, want

    # 4. operands
    for p, m, n in ((P, M, N), (999, 7, 1500)):
        emit("operands", p=p, m=m, n=n, **check_operands(p, m, n, dev))

    # 5. fit: the main paths through the entry points a user calls
    x = block_data(N, P, BLOCKS, seed=DATA_SEED, dev=dev)
    launches = {}
    model_f32, launches["fit"], fit_s, _ = north_star_fit(x,
                                                          optimizer="auto")
    tc_f32 = model_f32.tc
    fit_ref = dict(tc=tc_f32, seconds=fit_s,
                   blocks=blocks_whole(model_f32.clusters.cpu().numpy()))
    emit("fit", n=N, p=P, m=M, data_seed=DATA_SEED, max_iter=FIT_MAX_ITER,
         tol=FIT_TOL, strategy="gram",
         optimizer=model_f32.resolved_optimizer_, fit_seconds=fit_s,
         card=card,
         **check_north_star("fit", model_f32, launches["fit"], x, tc_f32))

    for name, kw in (("fit_int8", dict(matmul_dtype="int8")),
                     ("fit_bf16", dict(matmul_dtype="bfloat16"))):
        model, launches[name], fit_s, msgs = north_star_fit(
            x, optimizer="auto", **kw)
        fields = check_north_star(name, model, launches[name], x, tc_f32)
        guard = [w for w in msgs if "overflow" in w]
        check(not guard, f"{name}: the int8 wrap guard spoke: {guard}")
        emit(name, matmul_dtype=kw["matmul_dtype"], fit_seconds=fit_s,
             warnings=msgs, card=card, **fields)

    thr = lct.Corex(n_hidden=M, preset="throughput", seed=0, device="cuda")
    data, cfg, strategy = thr._prepare_fit(x)
    w0 = thr._resolve_w0(None, data=data, strategy=strategy)
    ortho = float((w0 @ w0.T - torch.eye(M, device=dev)).abs().max())
    del data
    check(cfg.init == "spectral" and not cfg.anneal
          and cfg.matmul_dtype == "int8",
          f"preset='throughput' resolved to init={cfg.init}, anneal="
          f"{cfg.anneal}, matmul_dtype={cfg.matmul_dtype}")
    check(ortho < 1e-3, f"the spectral W0 rows are not orthonormal "
          f"(max |W0·W0ᵀ − I| = {ortho:.3e})")
    model, launches["fit_throughput"], fit_s, msgs = north_star_fit(
        x, preset="throughput")
    fields = check_north_star("fit_throughput", model,
                              launches["fit_throughput"], x, tc_f32)
    check(len(fields["iters_per_stage"]) == 1,
          "preset='throughput' ran more than one anneal stage")
    emit("fit_throughput", init=cfg.init, anneal=cfg.anneal,
         matmul_dtype=cfg.matmul_dtype, tol=cfg.tol, spectral_w0_ortho=ortho,
         fit_seconds=fit_s, warnings=msgs, card=card, **fields)

    plain = lct.Corex(n_hidden=M, seed=0, optimizer="auto", tol=FIT_TOL,
                      max_iter=FIT_MAX_ITER, use_pallas="never",
                      device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain.fit(x)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    check(np.isfinite(plain.tc), "plain-chain TC is not finite")
    emit("fit_plain", tc=plain.tc,
         tc_rel_diff=abs(plain.tc - tc_f32) / abs(tc_f32),
         n_iter=plain.n_iter_,
         blocks_whole=blocks_whole(plain.clusters.cpu().numpy()),
         fit_seconds=plain_s, card=card)
    del model, plain, thr

    lane_launches, sweep_ref = restart_sweeps(x, card)
    serving(model_f32, x, card)
    launches.update(host_outputs_phase(model_f32, x, card))
    del model_f32

    # the mesh forms, in a world of one rank on this card
    mesh_launches, mesh_lane_launches = sharded_phase(x, card, sweep_ref)
    launches.update(mesh_launches)
    lane_launches.update(mesh_lane_launches)
    del sweep_ref
    launches.update(sharded_vars_phase(x, card))
    launches.update(sharded_stream_phase(x, card))
    launches.update(precision_phase(x, card))

    # the moment-input and staged fits, at the same width
    native_phase(x, card)
    launches.update(streaming_phase(x, fit_ref, card))
    launches.update(partial_fit_phase(x, card))
    launches.update(checkpoint_phase(x, fit_ref, card))
    launches.update(stacked_phase(x, card))
    launches.update(default_paths_phase(x, card))
    del x

    # 6. small fits on the card against the port's float64 CPU fit
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        small_fits(card)
        float64_card_vs_cpu(card)
        launches.update(small_streaming(card))
        lane_launches.update(small_restarts(card))
        lane_launches.update(selection(dev, card))

    # the first call of a fresh process, cold, warm and warmed
    torch.cuda.empty_cache()
    warm_launches, warm_lane_launches = warmup_phase(card)
    launches.update(warm_launches)
    lane_launches.update(warm_lane_launches)

    # 7. timing
    operands, w0 = timed_operands(dev)
    variants = [("float32", "never"), ("float32", "always"),
                ("bfloat16", "always"), ("int8", "always")]
    rates = {v: [] for v in variants}
    iters = {}
    for turn in (variants, variants[::-1], variants):
        for mode, use_pallas in turn:
            run, out = fit_core_runner(operands[mode], w0, mode, use_pallas,
                                       TIMED_ITERS)
            # untimed warm-up once per variant, then one timed run per turn
            ms = time_ms(run, reps=1, warmup=not rates[(mode, use_pallas)])
            n_it = int(out["diag"].iters_per_stage.sum())
            iters[f"{mode}/{use_pallas}"] = n_it
            rates[(mode, use_pallas)].append(n_it / (ms / 1e3))
    emit("timing_fit_core", p=P, m=M, strategy="gram",
         optimizer="fixed_point", iters=iters,
         it_per_s_kernel=max(rates[("float32", "always")]),
         it_per_s_plain=max(rates[("float32", "never")]),
         it_per_s_bf16_kernel=max(rates[("bfloat16", "always")]),
         it_per_s_int8_kernel=max(rates[("int8", "always")]),
         all_turns={f"{m}/{u}": r for (m, u), r in rates.items()},
         card=card)

    cxy, ry, sqz = chain_inputs(P, M)
    kernel_ms = plain_ms = float("inf")
    for which in ("plain", "kernel", "kernel", "plain"):
        if which == "kernel":
            kernel_ms = min(kernel_ms, time_ms(
                lambda: ns_chain(cxy, ry, sqz, 1 - 1e-6), inner=20))
        else:
            plain_ms = min(plain_ms, time_ms(
                lambda: ns_chain_reference(cxy, ry, sqz, 1 - 1e-6),
                inner=20))
    bound_ms, bound_cc_ms = chain_bounds_ms(1, P, M)
    products_ms = chain_products_ms(cxy, ry, sqz, 1 - 1e-6)
    emit("timing_kernel", p=P, m=M, kernel_ms=kernel_ms, plain_ms=plain_ms,
         bound_ms=bound_ms, bound_cuda_core_ms=bound_cc_ms,
         bound_by="operations", products_library_ms=products_ms,
         passes_ms=chain_pass_ms((cxy, ry, sqz)), card=card)

    lanes_in = [chain_inputs(P, M, seed=1 + lane) for lane in range(LANES)]
    cxy4, ry4, sqz4 = (torch.stack(t) for t in zip(*lanes_in))
    del lanes_in
    lane_ms = singles_ms = twin_ms = float("inf")
    for which in ("twin", "singles", "lanes", "lanes", "singles", "twin"):
        if which == "lanes":
            lane_ms = min(lane_ms, time_ms(
                lambda: ns_chain(cxy4, ry4, sqz4, 1 - 1e-6), inner=10))
        elif which == "singles":
            singles_ms = min(singles_ms, time_ms(
                lambda: [ns_chain(cxy4[i], ry4[i], sqz4[i], 1 - 1e-6)
                         for i in range(LANES)], inner=10))
        else:
            twin_ms = min(twin_ms, time_ms(
                lambda: ns_chain_reference(cxy4, ry4, sqz4, 1 - 1e-6),
                inner=10))
    lanes_bound_ms, lanes_bound_cc_ms = chain_bounds_ms(LANES, P, M)
    lanes_products_ms = chain_products_ms(cxy4, ry4, sqz4, 1 - 1e-6)
    emit("timing_kernel_lanes", lanes=LANES, p=P, m=M, lanes_ms=lane_ms,
         single_launches_ms=singles_ms, twin_ms=twin_ms,
         bound_ms=lanes_bound_ms, bound_cuda_core_ms=lanes_bound_cc_ms,
         bound_by="operations", products_library_ms=lanes_products_ms,
         passes_ms=chain_pass_ms((cxy4, ry4, sqz4)), card=card)
    del cxy4, ry4, sqz4

    # the kernel against its twin at small m (a use_pallas='auto' gate)
    small_m = []
    for p, m in ((SEL_P, 8), (SEL_P, 64), (SEL_P, 128), (P, 8), (P, 64),
                 (P, 128)):
        args = chain_inputs(p, m)
        k_ms = t_ms = float("inf")
        for which in ("twin", "kernel", "kernel", "twin"):
            if which == "kernel":
                k_ms = min(k_ms, time_ms(
                    lambda: ns_chain(*args, 1 - 1e-6), inner=20))
            else:
                t_ms = min(t_ms, time_ms(
                    lambda: ns_chain_reference(*args, 1 - 1e-6), inner=20))
        small_m.append(dict(p=p, m=m, kernel_ms=k_ms, plain_ms=t_ms,
                            kernel_faster=k_ms < t_ms))
    emit("timing_small_m", cases=small_m, card=card)

    from linearcorex_tpu_torch.parallel.restarts import init_restarts
    w0_lanes = init_restarts(LANES, M, P, 0, torch.float32, dev)
    variants = [(mode, lanes) for mode in ("float32", "int8")
                for lanes in (False, True)]
    rates = {v: [] for v in variants}
    for turn in (variants, variants[::-1], variants):
        for mode, lanes in turn:
            run, out = fit_core_runner(operands[mode],
                                       w0_lanes if lanes else w0, mode,
                                       "always", TIMED_ITERS_LANES)
            ms = time_ms(run, reps=1, warmup=not rates[(mode, lanes)])
            n_it = int(out["diag"].iters_per_stage[..., 0].max())
            rates[(mode, lanes)].append(n_it / (ms / 1e3))
    emit("timing_fit_core_lanes", p=P, m=M, lanes=LANES, strategy="gram",
         optimizer="fixed_point", iters=TIMED_ITERS_LANES,
         it_per_s_single_f32=max(rates[("float32", False)]),
         it_per_s_lanes_f32=max(rates[("float32", True)]),
         lane_it_per_s_f32=LANES * max(rates[("float32", True)]),
         it_per_s_single_int8=max(rates[("int8", False)]),
         it_per_s_lanes_int8=max(rates[("int8", True)]),
         lane_it_per_s_int8=LANES * max(rates[("int8", True)]),
         all_turns={f"{m}/{'lanes' if ln else 'single'}": r
                    for (m, ln), r in rates.items()}, card=card)

    # 8. profile
    for mode in ("float32", "bfloat16", "int8"):
        profile_iterations(operands[mode], w0, mode, card)
    profile_iterations(operands["float32"], w0_lanes, "float32", card,
                       label=f"float32_{LANES}_lanes")
    profiling_phase(operands["float32"], w0, card)

    print(json.dumps({"kernels": [{
        "name": "ns_chain", "route": "cuda",
        "source": "linearcorex_tpu_torch/csrc/ns_chain.cu",
        "replaces": "linearcorex_tpu/ops/pallas_moments.py:114",
        "launches": sum(launches.values()),
        "launches_per_path": launches, "max_abs_err": max_abs_err,
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "operations", "bound_cuda_core_ms": bound_cc_ms,
        "library_ms": None, "products_library_ms": products_ms}, {
        "name": "ns_chain_lanes", "route": "cuda",
        "source": "linearcorex_tpu_torch/csrc/ns_chain.cu",
        "replaces": "linearcorex_tpu/ops/pallas_moments.py:114",
        "launches": sum(lane_launches.values()),
        "launches_per_path": lane_launches, "max_abs_err": lanes_err,
        "ms": lane_ms, "plain_ms": twin_ms, "bound_ms": lanes_bound_ms,
        "bound_by": "operations", "bound_cuda_core_ms": lanes_bound_cc_ms,
        "library_ms": None, "products_library_ms": lanes_products_ms,
        "single_launches_ms": singles_ms}]}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
