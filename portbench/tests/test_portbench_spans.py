"""The readers of the program's spans (`program_spans.py` and
`metrics/{prepare_ms,init_ms,capture_ms,solve_idle_share}.py`) on
hand-built traces: their values, None on a trace without the program's
ranges (a program older than its spans), and the `.throughput` names
read by the same files."""

import json

import pytest

from conftest import ROOT
from portbench import tracing
from portbench.harness import Context
from portbench.manifest import Manifest

NAMES = ("prepare_ms", "init_ms", "capture_ms", "solve_idle_share")
MS = 1_000_000          # ns


def _op(name, start_ms, end_ms):
    return tracing.Op(name, int(start_ms * MS), int(end_ms * MS))


def _trace(host, device):
    return tracing.Trace(device=sorted(device, key=lambda o: o.start),
                         host=host, loops=[], window=(0, 100 * MS))


def _fit(at, prepare, init, solve, capture=None, final=1.0):
    """A fit's ranges from `at` ms, its phases one after another: the
    host events a traced run gives for one profiled fit."""
    t = at
    host = []
    for name, ms in (("lcx.prepare", prepare), ("lcx.init", init),
                     ("lcx.solve", solve), ("lcx.final", final)):
        host.append(_op(name, t, t + ms))
        if name == "lcx.solve" and capture is not None:
            host.append(_op("lcx.stage", t, t + ms))
            host.append(_op("lcx.capture", t + 0.5, t + 0.5 + capture))
        t += ms
    host.append(_op("lcx.fit", at, t))
    host.append(_op(tracing.FIT_RANGE, at - 0.25, t + 0.25))
    return host


def _read(name, trace):
    ctx = Context(cell={}, shape=None, window=None, trace=trace,
                  patterns=lambda layer: [])
    return Manifest(ROOT).reader(name)(ctx)


# two profiled fits: prepare 3 + 5 ms, init 2 + 4 ms, solve 10 + 10 ms,
# captures 1.5 ms in the first only; the device busy for 4 ms of the
# first solve (two overlapping kernels: a union, not a sum) and 6 ms of
# the second, and outside the solves elsewhere
TWO_FITS = _trace(
    _fit(1.0, 3.0, 2.0, 10.0, capture=1.5)
    + _fit(30.0, 5.0, 4.0, 10.0)
    + [_op("aten::mm", 1.5, 2.0), _op("lcx.init", 90.0, 95.0)],
    [_op("gemm", 7.0, 10.0), _op("gemm", 9.0, 11.0),
     _op("chain", 40.0, 46.0), _op("gemm", 1.5, 2.5),
     _op("gemm", 50.0, 52.0)])


@pytest.mark.parametrize("name,value", [
    ("prepare_ms", (3.0 + 5.0) / 2),
    ("init_ms", (2.0 + 4.0) / 2),
    ("capture_ms", 1.5 / 2),
    # busy 4 + 6 of the solves' 20 ms; the kernels of preparation (1.5 ms)
    # and those after the solves (50 ms) are not the loop's
    ("solve_idle_share", 100.0 * (1 - 10.0 / 20.0)),
])
def test_reader_values(name, value):
    """A range outside every profiled fit (lcx.init at 90 ms) is not
    read."""
    assert _read(name, TWO_FITS) == pytest.approx(value, rel=1e-12)


def test_a_range_clips_the_device_operations():
    """A kernel that starts before a solve and ends inside it counts
    for its part inside."""
    host = _fit(0.0, 1.0, 1.0, 10.0)
    trace = _trace(host, [_op("gemm", 1.5, 4.0)])
    # the solve runs from 2 to 12 ms: busy 2 ms of it
    assert _read("solve_idle_share", trace) == pytest.approx(80.0)


def _parent_trace():
    """What a traced run of a program without spans gives: the profiled
    fits, the portbench loop range, aten events and kernels."""
    host = [_op(tracing.FIT_RANGE, 0.0, 20.0),
            _op(tracing.LOOP_RANGE, 5.0, 15.0),
            _op("aten::mm", 6.0, 7.0), _op("cudaGraphLaunch", 8.0, 8.1)]
    return _trace(host, [_op("gemm", 6.0, 9.0)])


@pytest.mark.parametrize("name", NAMES)
def test_none_without_the_programs_ranges(name):
    assert _read(name, _parent_trace()) is None
    assert _read(name, None) is None


def test_capture_none_where_no_fit_captured():
    trace = _trace(_fit(0.0, 1.0, 1.0, 5.0), [_op("gemm", 3.0, 4.0)])
    assert _read("capture_ms", trace) is None
    assert _read("prepare_ms", trace) == pytest.approx(1.0)


@pytest.mark.parametrize("name", NAMES)
def test_throughput_twin_reads_the_same_file(name):
    man = Manifest(ROOT)
    base = man.reader(name).__code__.co_filename
    twin = man.reader(f"{name}.throughput").__code__.co_filename
    assert base == twin == str(ROOT / "portbench" / "metrics"
                               / f"{name}.py")
    assert _read(f"{name}.throughput", TWO_FITS) == _read(name, TWO_FITS)


def test_benchmark_json_lists_the_span_metrics():
    """Each name and its twin, read from the program's spans, in the
    cells whose fits it reads."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    per = {m["name"]: m for m in spec["per_layer"]}
    for name in NAMES:
        assert per[name]["source"] == per[f"{name}.throughput"]["source"] \
            == "program_span"
        assert per[name]["workloads"] == ["ns-default-f32",
                                          "omics-default-f32",
                                          "omics-restarts8-f32"]
        assert per[name]["moves"] == "fit_it_per_s"
        assert per[f"{name}.throughput"]["workloads"] == [
            "ns-throughput-int8"]
        assert per[f"{name}.throughput"]["moves"] == \
            "fit_it_per_s.throughput"
        assert per[name]["layer"] == per[f"{name}.throughput"]["layer"]
