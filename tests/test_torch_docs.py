"""The port's reference documents held to the code: `docs/API_torch.md`
covers every public name of `linearcorex_tpu_torch` and of its float64
oracle (`linearcorex_tpu_torch.oracle`), every `lct.…` or
`linearcorex_tpu_torch.…` name that the documents and the port's examples
use resolves, and every row of `docs/SCALING_torch.md`'s communication
table equals what `collective_counts()` records for one objective
evaluation of that layout, on ONE four-rank gloo world (spawned once per
run; all layouts inside it).

This module imports neither JAX nor `tests.conftest`: the spawned ranks
import it.
"""

import importlib
import pathlib
import re

import numpy as np
import pytest
import torch

import linearcorex_tpu_torch as lct
from linearcorex_tpu_torch import oracle
from linearcorex_tpu_torch.config import CorexConfig
from linearcorex_tpu_torch.models.corex import _make_obj_grad, resolve_config
from linearcorex_tpu_torch.ops import moments as TM
from linearcorex_tpu_torch.ops import preprocessing as TP
from linearcorex_tpu_torch.parallel import sharding as S
from linearcorex_tpu_torch.parallel.launch import run_world

# One intra-op thread: the suite runs its files in parallel worker
# processes, and an OpenMP pool per process on every core slows the
# small tensors here several times over.
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
API = ROOT / "docs" / "API_torch.md"
SCALING = ROOT / "docs" / "SCALING_torch.md"
# what the name checks read: the two documents and the port's examples
NAMED = [API, SCALING] + sorted((ROOT / "examples").glob("torch_*.py"))
CLASSES = (lct.Corex, lct.StackedCorex, lct.GramAccumulator)
WORLD = 4
WORLD_TIMEOUT = 600.0   # a deadline for a hang: the world takes ~5 s
# the shape the communication table states its bytes at
N, P, M = 512, 64, 8
LANES = 4               # restart lanes of the two restart layouts
OPTIMIZERS = ("fixed_point", "momentum")

VAR = S.ShardingPlan(shard_samples=False, shard_vars=True)
# layout (the table's first column) -> (mesh axes, plan, strategy,
# operand): 'x' the standardized float32 rows, 'int8' their quantized
# operand, 'gram' Σ; a restart layout's plan is None (its lanes split over
# `restarts`, its rows over `data` where the mesh has that axis)
LAYOUTS = {
    "data": ((("data", 4),), S.ShardingPlan(), "samples", "x"),
    "data, int8 operand": ((("data", 4),), S.ShardingPlan(), "samples",
                           "int8"),
    "var": ((("var", 4),), VAR, "samples", "x"),
    "data × model": ((("data", 2), ("model", 2)),
                     S.ShardingPlan(shard_factors=True), "samples", "x"),
    "slice × data": ((("slice", 2), ("data", 2)),
                     S.ShardingPlan(shard_slices=True), "samples", "x"),
    "slice × model": ((("slice", 2), ("model", 2)),
                      S.ShardingPlan(shard_samples=False, shard_slices=True,
                                     shard_factors=True), "samples", "x"),
    "restarts": ((("restarts", 4),), None, "samples", "x"),
    "restarts × data": ((("restarts", 2), ("data", 2)), None, "samples",
                        "x"),
    "var, Σ row blocks": ((("var", 4),), VAR, "gram", "gram"),
}


def _block_data(n, p, m, seed=0, strength=0.9):
    """`tests.conftest.block_data`, copied: that module imports JAX."""
    rng = np.random.RandomState(seed)
    z = rng.normal(size=(n, m))
    k = p // m
    x = np.empty((n, p))
    for j in range(m):
        for i in range(k):
            x[:, j * k + i] = strength * z[:, j] + np.sqrt(
                1.0 - strength ** 2) * rng.normal(size=n)
    return x


def _operand(kind, xp):
    if kind == "int8":
        return TM.quantize_samples(xp)
    if kind == "gram":
        return TM.compute_gram(xp)
    return xp


def _evaluation(mesh, plan, strategy, data, w0, cfg):
    """(this rank's objective, its W) as the fit of `plan` builds them:
    `fit_sharded`'s operands for a plan, `fit_restarts_sharded`'s (this
    group's lanes, rows over `data` where the mesh has it) for None."""
    if plan is not None:
        data, w, model, cfg = S._sharded_operands(
            data, w0, cfg, mesh, plan, strategy, N, False)
        return _make_obj_grad(data, cfg, strategy, model), w
    cfg = resolve_config(cfg, P, mesh.device_type, n_samples=N)
    names = mesh.mesh_dim_names
    axes = (S.mesh_axis(mesh, "data"),) if "data" in names else ()
    lanes = S.mesh_axis(mesh, "restarts")
    per = LANES // lanes.size
    w = torch.as_tensor(np.stack(
        [np.random.RandomState(r).normal(scale=P ** -0.5, size=(M, P))
         for r in range(LANES)]), dtype=torch.float32)
    w = w[lanes.index * per:(lanes.index + 1) * per]
    data = S.shard_samples(data, axes, "cpu")
    return _make_obj_grad(data, cfg, strategy, None), w


def _layout_world(rank):
    """Runs on every rank: for each layout and optimizer, the collectives
    of one objective evaluation, as `collective_counts()` records them."""
    xp = TP.fit_preprocess(torch.as_tensor(_block_data(N, P, M),
                                           dtype=torch.float32),
                           "standard")[0]
    w0 = np.random.RandomState(0).normal(scale=P ** -0.5, size=(M, P))
    eps = torch.zeros((), dtype=torch.float32)
    out = {}
    for name, (axes, plan, strategy, kind) in LAYOUTS.items():
        mesh = S.make_mesh(axes, device="cpu")
        data = _operand(kind, xp)
        for opt in OPTIMIZERS:
            cfg = CorexConfig(n_hidden=M, optimizer=opt,
                              record_history=False,
                              matmul_dtype="int8" if kind == "int8"
                              else "float32")
            obj, w = _evaluation(mesh, plan, strategy, data, w0, cfg)
            S.reset_collective_counts()
            obj(w, eps)
            out[name, opt] = sorted(
                (c.kind, c.op, c.axis, c.dtype, c.bytes, calls)
                for c, calls in S.collective_counts().items())
    return out


@pytest.fixture(scope="module")
def counted():
    """Every rank's counts, in rank order."""
    return run_world(_layout_world, WORLD, backend="gloo",
                     timeout=WORLD_TIMEOUT)


# -- the communication table -------------------------------------------------

ENTRY = re.compile(r"(\w+)(?: (sum|max))? on `(\w+)`: (\d+) × ([\d,]+) B "
                   r"\((\w+)\)")


def _cell(text):
    """The collectives of one table cell, in `_layout_world`'s form."""
    text = text.strip()
    if text == "none":
        return []
    found = []
    for part in text.split(";"):
        got = ENTRY.fullmatch(part.strip())
        assert got, f"unreadable collective {part!r} in the table"
        kind, op, axis, calls, nbytes, dtype = got.groups()
        found.append((kind, op or "", axis, dtype,
                      int(nbytes.replace(",", "")), int(calls)))
    return sorted(found)


def _table():
    """The cells of the communication table of docs/SCALING_torch.md (the
    rows under its header line), the layout's backticks dropped."""
    lines = SCALING.read_text().splitlines()
    head = next(i for i, ln in enumerate(lines)
                if ln.startswith("| layout | mesh | fixed point |"))
    rows = []
    for ln in lines[head + 2:]:
        if not ln.startswith("|"):
            break
        cells = [c.strip() for c in ln.strip().strip("|").split("|")]
        rows.append([cells[0].replace("`", "")] + cells[1:])
    return rows


def table_rows():
    """{(layout, optimizer): collectives} of the communication table."""
    rows = {}
    for layout, _, fixed_point, momentum, *_ in _table():
        rows[layout, "fixed_point"] = _cell(fixed_point)
        rows[layout, "momentum"] = _cell(momentum)
    return rows


def format_cell(found):
    """A table cell from `_layout_world`'s form (how the table was
    written)."""
    if not found:
        return "none"
    return "; ".join(
        f"{kind}{' ' + op if op else ''} on `{axis}`: {calls} × "
        f"{nbytes:,} B ({dtype})"
        for kind, op, axis, dtype, nbytes, calls in found)


def test_the_table_has_a_row_per_layout_with_its_mesh():
    assert {row[0]: row[1] for row in _table()} == {
        name: " × ".join(f"`{axis}` {size}" for axis, size in axes)
        for name, (axes, *_) in LAYOUTS.items()}


def test_every_rank_counts_the_same_collectives(counted):
    assert all(r == counted[0] for r in counted[1:])


@pytest.mark.parametrize("layout,optimizer", [
    (name, opt) for name in LAYOUTS for opt in OPTIMIZERS])
def test_table_row_equals_collective_counts(counted, layout, optimizer):
    assert table_rows()[layout, optimizer] \
        == counted[0][layout, optimizer], \
        format_cell(counted[0][layout, optimizer])


# -- the API reference -------------------------------------------------------

def _code(text):
    """The code of a markdown text: its fenced blocks and code spans."""
    blocks = re.findall(r"^```.*?^```", text, re.S | re.M)
    rest = re.sub(r"^```.*?^```", "", text, flags=re.S | re.M)
    return blocks + re.findall(r"`([^`]+)`", rest)


def _names(code, name):
    word = re.compile(rf"(?<![\w]){re.escape(name)}(?![\w])")
    return any(word.search(c) for c in code)


def _section(text, cls):
    """The text under the heading that names `lct.<cls>`, up to the next
    heading."""
    lines = text.splitlines()
    start = next(i for i, ln in enumerate(lines)
                 if ln.startswith("#") and f"`lct.{cls}`" in ln)
    end = next((i for i in range(start + 1, len(lines))
                if lines[i].startswith("#")), len(lines))
    return "\n".join(lines[start + 1:end])


@pytest.mark.parametrize("name", lct.__all__ + oracle.__all__)
def test_api_reference_names_every_exported_name(name):
    assert _names(_code(API.read_text()), name), name


@pytest.mark.parametrize("cls,member", [
    (c.__name__, m) for c in CLASSES for m in sorted(dir(c))
    if not m.startswith("_")])
def test_api_reference_names_every_public_member(cls, member):
    """Every public method and attribute of `Corex`, `StackedCorex` and
    `GramAccumulator` has an entry in its class's section."""
    assert _names(_code(_section(API.read_text(), cls)), member), \
        f"{cls}.{member}"


def _resolves(dotted):
    """Whether `linearcorex_tpu_torch.<dotted>` names a module or an
    attribute."""
    obj, path = lct, "linearcorex_tpu_torch"
    for part in dotted.split("."):
        path += "." + part
        if hasattr(obj, part):
            obj = getattr(obj, part)
            continue
        try:
            obj = importlib.import_module(path)
        except ModuleNotFoundError:
            return False
    return True


def _dotted(text):
    """The names of the port a text uses: `lct.…`,
    `linearcorex_tpu_torch.…`, and the port's modules by their path in
    the package (`parallel.sharding.make_mesh`, ...)."""
    found = re.findall(r"\blct((?:\.[A-Za-z_]\w*)+)", text)
    found += re.findall(r"\blinearcorex_tpu_torch((?:\.[A-Za-z_]\w*)+)",
                        text)
    found += ["." + n for n in re.findall(
        r"(?<![\w.])((?:core|models|ops|parallel|utils)(?:\.[A-Za-z_]\w*)+)",
        text)]
    return sorted({n[1:] for n in found})


@pytest.mark.parametrize("path", NAMED, ids=lambda p: p.name)
def test_every_name_the_documents_and_examples_use_resolves(path):
    names = _dotted(path.read_text())
    assert names
    assert [n for n in names if not _resolves(n)] == []
