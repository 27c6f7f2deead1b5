"""The port covers the JAX package, and imports none of it.

Every module of `linearcorex_tpu` (found by `pkgutil.walk_packages`) has
a counterpart at the same path in `linearcorex_tpu_torch`, and so has
every public function and class defined in it: the same parameter names,
and where the JAX package gives a default, the same default (a default
that is an object of the package, such as `fit_sharded`'s
`ShardingPlan()`, by `repr`). A class is checked down to `__init__`, its
public methods and its properties. The port may add parameters of its
own (`device=`). What the port leaves out by design is pinned in
EXCEPTIONS with the reason, and nothing else may be missing.

No module of the port, nor chip_smoke.py or compare_chain.py (the
scripts a machine without JAX runs), imports JAX or the JAX package.
"""

import ast
import importlib
import inspect
import pathlib
import pkgutil

import torch

# One intra-op thread: the suite runs its files in parallel worker
# processes, and an OpenMP pool per process on every core slows the
# small tensors here several times over.
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_PACKAGE, PORT = "linearcorex_tpu", "linearcorex_tpu_torch"

# each gap between the packages that is there by design: a module, a
# name in a module, or "name(parameter)"
EXCEPTIONS = {
    "ops.pallas_moments":
        "the Pallas kernel's module; its counterpart is ops.cuda_moments, "
        "the CUDA chain kernel's wrapper",
    "parallel.audit":
        "parses XLA HLO text; on ROADMAP's 'Do not port' list (the port "
        "counts its collectives in parallel.collectives)",
    "models.corex.serving_state_specs":
        "sharding specs of the fitted state for XLA; the port keeps the "
        "fitted state whole on every rank",
    "ops.moments.ns_fp_from_cxy":
        "a JAX-internal helper of parallel/sharding.py's shard_map bodies",
    "models.corex.resolve_config(platform)":
        "TPU-only: the JAX platform name; the port resolves against device=",
    "parallel.sharding.make_mesh(devices)":
        "TPU-only: a list of JAX devices; the port's mesh is one rank per "
        "process, on device=",
    "parallel.sharding.make_hybrid_mesh(devices)":
        "TPU-only: a list of JAX devices, as make_mesh",
    "parallel.sharding.make_hybrid_mesh(process_is_granule)":
        "TPU-only: JAX's mesh_utils granule switch for multi-slice TPUs",
    "ops.preprocessing.rankdata_average(col)":
        "the JAX function ranks one column under jax.vmap; the port's ranks "
        "every column of x at once",
    "utils.profiling.trace(create_perfetto_link)":
        "TPU-only: jax.profiler's Perfetto UI link; torch.profiler writes a "
        "Chrome trace",
}


def _signature(obj):
    try:
        return inspect.signature(obj)
    except (TypeError, ValueError):     # a builtin without one
        return None


def _same_default(want, got):
    try:
        if want == got:
            return True
    except Exception:               # an array or tensor default
        pass
    return repr(want) == repr(got)


def _parameter_gaps(label, jax_obj, port_obj):
    """The JAX function's parameters the port lacks, as 'label(name)',
    and its defaults the port changes."""
    want, got = _signature(jax_obj), _signature(port_obj)
    if want is None:
        return []
    if got is None:
        return [f"{label}: no signature in the port"]
    gaps = []
    for name, param in want.parameters.items():
        if name not in got.parameters:
            gaps.append(f"{label}({name})")
        elif param.default is not inspect.Parameter.empty and not \
                _same_default(param.default, got.parameters[name].default):
            gaps.append(f"{label}({name}): default {param.default!r} in the "
                        f"JAX package, {got.parameters[name].default!r} in "
                        f"the port")
    return gaps


def _members(cls):
    """A class's own __init__, public methods and properties."""
    return {name: value for name, value in vars(cls).items()
            if name == "__init__" or not name.startswith("_")
            and (callable(value) or isinstance(
                value, (staticmethod, classmethod, property)))}


def _gaps():
    """Every gap between the JAX package and the port, by the names of
    EXCEPTIONS."""
    jax_package = importlib.import_module(JAX_PACKAGE)
    names = [JAX_PACKAGE] + [m.name for m in pkgutil.walk_packages(
        jax_package.__path__, JAX_PACKAGE + ".")]
    gaps = []
    for name in names:
        label = name[len(JAX_PACKAGE) + 1:] or "__init__"
        module = importlib.import_module(name)
        try:
            port = importlib.import_module(PORT + name[len(JAX_PACKAGE):])
        except ModuleNotFoundError:
            gaps.append(label)
            continue
        for attr, obj in vars(module).items():
            if attr.startswith("_") or getattr(obj, "__module__", None) \
                    != name or not (inspect.isfunction(obj)
                                    or inspect.isclass(obj)):
                continue
            where = f"{label}.{attr}"
            counterpart = getattr(port, attr, None)
            if counterpart is None:
                gaps.append(where)
                continue
            if inspect.isclass(obj):
                for member, value in _members(obj).items():
                    if not hasattr(counterpart, member):
                        gaps.append(f"{where}.{member}")
                    elif not isinstance(value, property):
                        gaps += _parameter_gaps(
                            f"{where}.{member}", getattr(obj, member),
                            getattr(counterpart, member))
            gaps += _parameter_gaps(where, obj, counterpart)
    return gaps


def test_port_covers_the_jax_package():
    gaps = _gaps()
    assert sorted(set(gaps)) == sorted(gaps), "a gap counted twice"
    assert sorted(gaps) == sorted(EXCEPTIONS), (
        f"not in the port and not pinned: {sorted(set(gaps) - set(EXCEPTIONS))}"
        f"; pinned and no longer a gap: "
        f"{sorted(set(EXCEPTIONS) - set(gaps))}")


def _imported(path):
    """The top-level package of every import in a source file: import
    statements anywhere in it, and importlib.import_module / __import__
    of a literal name."""
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {alias.name.split(".")[0] for alias in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and node.args and isinstance(
                node.args[0], ast.Constant) and isinstance(
                node.args[0].value, str) and getattr(
                node.func, "attr", getattr(node.func, "id", None)) in (
                "import_module", "__import__"):
            roots.add(node.args[0].value.split(".")[0])
    return roots


def test_port_imports_no_jax():
    files = sorted((ROOT / PORT).rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "compare_chain.py"]
    assert len(files) > 20
    found = {str(f.relative_to(ROOT)): sorted(_imported(f) & {
        "jax", "jaxlib", JAX_PACKAGE}) for f in files}
    assert not {f: roots for f, roots in found.items() if roots}
