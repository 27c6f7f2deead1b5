"""BENCHMARK.json against the contract's shape, and the harness finding a
new configuration, cell, traffic mix, per-layer metric and kernel pattern
each by one new file."""

import json
import re

import pytest

from conftest import ROOT, TINY, add_cell, add_config, add_json, copy_bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CHECKS = ("cxy_gap", "tc_gap", "first_step_gap", "residual_gap",
          "stall_gap")


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "portbench/run.py"]
    assert SPEC["paths"] == ["portbench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("key", ["configs", "workloads", "end_to_end",
                                 "per_layer"])
def test_names_unique_and_well_formed(key):
    names = [e["name"] for e in SPEC[key]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_configs_files_and_reduced():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/configs/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert c["reduced"] == cfg["reduced"] == []
        assert any(w["config"] == c["name"] for w in SPEC["workloads"])


def test_workload_files_agree_with_benchmark_json():
    pairs = set()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        f = json.loads((ROOT / "portbench" / "workloads"
                        / f"{w['name']}.json").read_text())
        assert {k: f[k] for k in ("config", "traffic", "chips", "why")} == \
            {k: w[k] for k in ("config", "traffic", "chips", "why")}
        assert set(f) == {"config", "traffic", "chips", "why", "limits"}
        # the three per-fit numbers, and where the loop ended: a
        # stationary point (momentum) or a window gone past its first step
        assert set(f["limits"]) - {"residual_gap", "stall_gap"} == {
            "cxy_gap", "tc_gap", "first_step_gap"}
        assert len(f["limits"]) == 4
        assert (ROOT / "portbench" / "traffic"
                / f"{w['traffic']}.json").is_file()
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(SPEC["workloads"])


def test_metrics():
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert {"fit_it_per_s", "fit_it_per_s.throughput", "setup_s"} == e2e
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    cells = {w["name"] for w in SPEC["workloads"]}
    reports = {c: {m["name"] for m in SPEC["end_to_end"]
                   if c in m.get("workloads", [c])} for c in cells}
    for c in cells:
        assert "setup_s" in reports[c] and len(reports[c]) >= 2
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        # every cell a per-layer metric lists reports the metric it moves
        assert all(m["moves"] in reports[c] for c in m["workloads"])
        assert UNIT.match(m["unit"])
        base = m["name"].split(".")[0]
        assert (ROOT / "portbench" / "metrics" / f"{base}.py").is_file()
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for cell in cells:
        assert any(cell in m["workloads"] for m in SPEC["per_layer"])


def test_one_new_file_each(tmp_path, dry_run):
    """A configuration, a traffic mix, a cell and a per-layer metric, each
    added by a file of its own (plus their entries in BENCHMARK.json), and
    a kernel pattern added beside the existing file: no file that is there
    is edited."""
    root = copy_bench(tmp_path)
    before = {p: p.read_bytes() for p in (root / "portbench").rglob("*")
              if p.is_file()}
    add_config(root, dict(TINY, name="tiny-new"))
    add_json(root / "portbench" / "traffic" / "fit-gd.json",
             {"generator": "fitloop",
              "estimator_kwargs": {"optimizer": "gd"}})
    add_cell(root, "tiny-new-gd", "tiny-new", "fit-gd")
    (root / "portbench" / "metrics" / "fits_counted.py").write_text(
        "def read(ctx):\n    return float(len(ctx.window.fits))\n")
    add_json(root / "portbench" / "kernels" / "chain.more.json",
             {"patterns": ["a_later_kernel"]})
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["per_layer"].append({"name": "fits_counted", "unit": "fits",
                              "better": "higher", "source": "host_clock",
                              "layer": "Whole fit", "moves": "fit_it_per_s",
                              "workloads": ["tiny-new-gd"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    for p, data in before.items():
        assert p.read_bytes() == data, p
    from portbench.manifest import Manifest
    man = Manifest(root)
    assert len(man.patterns("chain")) == 2
    # a metric split by cell group reads with its base name's reader
    assert man.reader("prep_ms.throughput").__module__ != ""
    rc, res, err = dry_run(root, "tiny-new-gd", trace=1)
    assert rc == 0, err
    assert res["correct"] is True
    assert res["metrics"]["fits_counted"]["value"] >= 1


NUMPY_FIT = '''"""Fits from NumPy input: the fit loop's traffic with the
data handed to each fit as a host array, as a user with NumPy data calls
it."""

from portbench.generators import fitloop


def setup(cell, seed, device):
    state = fitloop.setup(cell, seed, device)
    return state._replace(x=state.x.cpu().numpy())


def measure(state, seconds, seed, trace):
    return fitloop.measure(state, seconds, seed, trace)


def values(state, window):
    return fitloop.values(state, window)


def shape(state):
    return fitloop.shape(state)


def check(state, window):
    import torch
    return fitloop.check(state._replace(x=torch.from_numpy(state.x)),
                         window)
'''


def test_a_new_generator_by_one_file(tmp_path, dry_run):
    """A kind of traffic that the fit loop does not have (NumPy input),
    added as generators/<name>.py with its mix, configuration and cell as
    data files: no file that is there is edited, and the harness finds
    the generator by the name in the mix."""
    root = copy_bench(tmp_path)
    before = {p: p.read_bytes() for p in (root / "portbench").rglob("*")
              if p.is_file()}
    own = {p: p.read_bytes() for p in (ROOT / "portbench").rglob("*.py")}
    add_config(root, dict(TINY, name="tiny-np"))
    gen = root / "portbench" / "generators" / "numpy_fit.py"
    gen.parent.mkdir(parents=True)
    gen.write_text(NUMPY_FIT)
    add_json(root / "portbench" / "traffic" / "fit-numpy.json",
             {"generator": "numpy_fit", "estimator_kwargs": {}})
    add_cell(root, "tiny-np-numpy", "tiny-np", "fit-numpy")
    for p, data in before.items():
        assert p.read_bytes() == data, p
    from portbench.manifest import Manifest
    assert Manifest(root).generator("numpy_fit").__file__ == str(gen)
    for trace in (0, 1):
        rc, res, err = dry_run(root, "tiny-np-numpy", trace=trace)
        assert rc == 0, err
        assert res["correct"] is True
        assert res["attempted"] >= 1 and res["failed"] == 0
    assert {p: p.read_bytes() for p in (ROOT / "portbench").rglob(
        "*.py")} == own


def test_unknown_generator_is_refused(tmp_path):
    from portbench.manifest import Manifest
    man = Manifest(copy_bench(tmp_path))
    for name in ("no_such_generator", "../harness"):
        with pytest.raises(KeyError):
            man.generator(name)


# kernel names an H100 trace showed in the solver loop (torch 2.11.0+cu128)
SEEN = {
    "sigma_gemm": [
        "void cutlass::Kernel2<cutlass_80_simt_sgemm_256x128_8x4_nn_align1>"
        "(cutlass_80_simt_sgemm_256x128_8x4_nn_align1::Params)",
        "sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x8_stage3_"
        "warpsize2x2x1_ffma_aligna4_alignc4_execute_kernel__5x_cublas",
        "void cutlass::Kernel2<cutlass_80_tensorop_i16832gemm_s8_128x128_"
        "128x5_tn_align16>(cutlass_80_tensorop_i16832gemm_s8_128x128_128x5_"
        "tn_align16::Params)",
        "void cublasLt::splitKreduce_kernel<32, 16, int, float, float>"],
    "chain": [
        "void (anonymous namespace)::chain_gemm_kernel<true>(CUtensorMap_st)",
        "(anonymous namespace)::chain_rows_kernel(float const*, float*)",
        "(anonymous namespace)::chain_split_kernel(float const*, float*)",
        "(anonymous namespace)::chain_reduce_kernel(int, int, float*)"],
    "lu": [
        "void getrf_pivot<getrf_params_<float, 512, 1, 512, 512, 1> >(int)",
        "void kernel_trsm_l_mul32<float, 8, true, false, false, false>(int)"],
}
OTHER = ["void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel_"
         "impl_nocast<at::native::CUDAFunctor_add<float> > >", "Memcpy DtoD "
         "(Device -> Device)"]


@pytest.mark.parametrize("layer", sorted(SEEN))
def test_kernel_patterns_pick_their_layer_only(layer):
    from portbench.manifest import Manifest
    man = Manifest(ROOT)
    pats = man.patterns(layer)
    for name in SEEN[layer]:
        assert any(p.search(name) for p in pats), name
    for other, names in SEEN.items():
        if other != layer:
            for name in names + OTHER:
                assert not any(p.search(name) for p in pats), name
