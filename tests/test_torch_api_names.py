"""Every public top-level name of the JAX package has a counterpart of
the same name in the port's module of the same path, or an exemption
here with its reason.

A module's public names are what it defines at its top level (functions,
classes, assigned names) that do not start with ``_``, plus its
``__all__``; imports are not counted. The port module answers for a
name as an attribute or as a submodule. ``EXEMPT`` lists the names that
stay JAX's or TPU's own, and the kernel entries the port renamed, each
naming its port counterpart. The names ported to close the gaps this
check found have parity cases against the JAX functions below.
"""

import ast
import importlib
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu import dtype as jdt
from spark_rapids_jni_tpu import rows as jrows
from spark_rapids_jni_tpu.column import Column as JColumn
from spark_rapids_jni_tpu.kernels import hashing as jkh
from spark_rapids_jni_tpu.kernels import registry as jreg
from spark_rapids_jni_tpu.ops import keys as jkeys
from spark_rapids_jni_tpu.utils import config as jconfig
from spark_rapids_jni_tpu_torch import dtype as dt
from spark_rapids_jni_tpu_torch import rows
from spark_rapids_jni_tpu_torch.column import Column
from spark_rapids_jni_tpu_torch.kernels import hashing as kh
from spark_rapids_jni_tpu_torch.kernels import registry
from spark_rapids_jni_tpu_torch.ops import keys
from spark_rapids_jni_tpu_torch.runtime_bridge import DISPATCH_OPS
from spark_rapids_jni_tpu_torch.utils import config

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX_PKG = ROOT / "spark_rapids_jni_tpu"
PORT = "spark_rapids_jni_tpu_torch"

#: (JAX module path, name) -> why the port has no name of its own for it
EXEMPT = {
    ("bucketed.py", "dispatch_bucketed_donated"):
        "XLA buffer donation into a fused executable; the port's donate "
        "frees the input id after the op (runtime_bridge._capture_inputs)",
    ("column.py", "encode_storage"):
        "port counterpart: column.host_to_storage (host array -> storage "
        "tensor on a device)",
    ("column.py", "storage_host_view"):
        "port counterpart: column.host_storage_view",
    ("column.py", "x64_downgrade_error"):
        "JAX-only: the jax_enable_x64 downgrade guard; torch keeps 64-bit "
        "dtypes",
    ("kernels/__init__.py", "on_tpu"):
        "TPU-only: the Mosaic backend probe; the port's tier gate asks "
        "for a CUDA tensor",
    ("kernels/__init__.py", "default_interpret"):
        "TPU-only: Pallas interpret mode; a port wrapper runs its plain "
        "version for a CPU tensor",
    ("kernels/__init__.py", "pallas_capability"):
        "TPU-only: the Pallas import probe; the port builds its CUDA "
        "sources with nvcc (kernels.build_all)",
    ("kernels/hashing.py", "TILE"):
        "TPU-only: the Pallas block's VMEM tile; K5 is one thread a row",
    ("kernels/hashing.py", "SUBLANES"):
        "TPU-only: the Pallas block's sublane count",
    ("kernels/hashing.py", "murmur3_table_fused"):
        "renamed kernel entry: kernels.hashing.murmur3_columns (registered "
        "as murmur3_table_fused)",
    ("kernels/registry.py", "SORT_MAX_ROWS"):
        "TPU-only: the bitonic network's VMEM bound; K3 is a radix sort "
        "over device memory",
    ("kernels/registry.py", "SORT_MAX_WORDS"):
        "TPU-only: the bitonic network's VMEM bound",
    ("kernels/row_transpose.py", "TILE_ROWS"):
        "TPU-only: the Pallas transpose tile; K1a/K1b tile in shared memory",
    ("kernels/row_transpose.py", "pack_rows_pallas"):
        "renamed kernel entry: kernels.row_transpose.pack_rows",
    ("kernels/row_transpose.py", "unpack_rows_pallas"):
        "renamed kernel entry: kernels.row_transpose.unpack_rows",
    ("ops/join.py", "FUSED_PROBE_MAX_ROWS"):
        "TPU-only: the fence around an XLA codegen fault in the fused "
        "probe graph; the port's joins run eagerly",
    ("parallel/mesh.py", "shard_map"):
        "JAX-only: the SPMD entry; parallel.mesh.per_shard runs each shard "
        "on its device",
}

JAX_MODULES = sorted(str(p.relative_to(JAX_PKG))
                     for p in JAX_PKG.rglob("*.py"))


def public_names(path: pathlib.Path) -> set:
    tree = ast.parse(path.read_text(), filename=str(path))
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            targets = [e.id for t in node.targets for e in ast.walk(t)
                       if isinstance(e, ast.Name)]
            if "__all__" in targets:
                out.update(ast.literal_eval(node.value))
            out.update(targets)
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            out.add(node.target.id)
    return {n for n in out if not n.startswith("_") or n == "__version__"}


def port_module(rel: str) -> str:
    parts = rel[:-3].split("/")
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join([PORT, *parts])


def has_name(mod, name: str) -> bool:
    """``name`` is an attribute of ``mod`` or, for a package, one of its
    submodules."""
    if hasattr(mod, name):
        return True
    return hasattr(mod, "__path__") and importlib.util.find_spec(
        f"{mod.__name__}.{name}") is not None


@pytest.mark.parametrize("rel", JAX_MODULES)
def test_port_has_every_public_name(rel):
    assert (ROOT / PORT / rel).exists(), f"no port of {rel}"
    mod = importlib.import_module(port_module(rel))
    missing = sorted(n for n in public_names(JAX_PKG / rel)
                     if (rel, n) not in EXEMPT and not has_name(mod, n))
    assert not missing, f"{rel}: the port lacks {missing}"


def test_every_exemption_is_a_real_gap():
    """An exempt name is public in the JAX module and absent from the
    port's, so the map shrinks when a name is ported."""
    for (rel, name), why in EXEMPT.items():
        assert why
        assert name in public_names(JAX_PKG / rel), (rel, name)
        assert not has_name(importlib.import_module(port_module(rel)),
                            name), (rel, name)


# ---------------------------------------------------------------------------
# parity of the names ported to close the gaps
# ---------------------------------------------------------------------------

DTYPE_NAMES = [f"{k}_{u}" for k in ("TIMESTAMP", "DURATION")
               for u in ("DAYS", "SECONDS", "MILLISECONDS", "MICROSECONDS",
                         "NANOSECONDS")]


@pytest.mark.parametrize("name", DTYPE_NAMES)
def test_dtype_singletons_match_jax(name):
    got, want = getattr(dt, name), getattr(jdt, name)
    assert (got.id.value, got.scale, got.itemsize) == (
        want.id.value, want.scale, want.itemsize)


@pytest.mark.parametrize("scale", [0, -2, -38, 5])
def test_decimal128_matches_jax(scale):
    got, want = dt.decimal128(scale), jdt.decimal128(scale)
    assert (got.id.value, got.scale, got.itemsize) == (
        want.id.value, want.scale, want.itemsize)
    assert got == dt.DType(dt.TypeId.DECIMAL128, scale)


def test_package_names_match_jax():
    import spark_rapids_jni_tpu as jpkg
    import spark_rapids_jni_tpu_torch as pkg

    assert pkg.__all__ == jpkg.__all__
    assert pkg.__version__ == jpkg.__version__
    assert pkg.DType is dt.DType and pkg.TypeId is dt.TypeId
    assert pkg.io.__name__ == f"{PORT}.io"
    with pytest.raises(AttributeError):
        pkg.no_such_subpackage


SCHEMA = [jdt.INT64, jdt.INT32, jdt.FLOAT64, jdt.BOOL8, jdt.INT16]


@pytest.mark.parametrize("flat", [False, True])
def test_packed_rows_from_numpy_matches_jax(flat):
    port_schema = [dt.DType(dt.TypeId(d.id.value), d.scale) for d in SCHEMA]
    layout = jrows.compute_fixed_width_layout(SCHEMA)
    data = np.random.default_rng(2).integers(
        0, 256, (7, layout.row_size), dtype=np.uint8)
    host = data.reshape(-1) if flat else data
    want = jrows.packed_rows_from_numpy(host, SCHEMA)
    got = rows.packed_rows_from_numpy(host, port_schema, device="cpu")
    assert got.data.cpu().numpy().tobytes() == np.asarray(
        want.data).tobytes()
    assert got.data.shape == tuple(want.data.shape)
    for field in ("column_offsets", "column_widths", "validity_offset",
                  "validity_bytes", "row_size"):
        assert getattr(got.layout, field) == getattr(want.layout, field)
    for bad in (data[:, :-1], data.reshape(-1)[:-1]):
        with pytest.raises(ValueError):
            jrows.packed_rows_from_numpy(bad, SCHEMA)
        with pytest.raises(ValueError):
            rows.packed_rows_from_numpy(bad, port_schema, device="cpu")


def _key_columns():
    rng = np.random.default_rng(7)
    n = 64
    ints = rng.integers(-3, 3, n).astype(np.int64)
    floats = rng.choice([-0.0, 0.0, 1.5, -2.0, np.inf, np.nan], n)
    words = [["", "a", "ab", "b\x00", "ba"][i] for i in rng.integers(0, 5, n)]
    j = [JColumn.from_numpy(ints), JColumn.from_numpy(floats),
         JColumn.from_strings(words)]
    t = [Column.from_numpy(ints, device="cpu"),
         Column.from_numpy(floats, device="cpu"),
         Column.from_strings(words, device="cpu")]
    return j, t, rng, n


def test_composite_compare_le_and_rows_equal_match_jax():
    j, t, rng, n = _key_columns()
    jk, tk = jkeys.table_order_keys(j), keys.table_order_keys(t)
    a = rng.integers(0, n, 200)
    b = np.concatenate([a[:50], rng.integers(0, n, 150)])
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for fn in ("composite_compare_le", "rows_equal"):
        want = np.asarray(getattr(jkeys, fn)(jk, a, jk, b))
        got = getattr(keys, fn)(tk, ta, tk, tb).numpy()
        assert got.dtype == np.bool_ and (got == want).all(), fn
    assert keys.rows_equal(tk, ta[:50], tk, tb[:50]).all()
    assert keys.composite_compare_le(tk, ta, tk, ta).all()


def test_kernel_for_op_matches_jax():
    for op in sorted(set(DISPATCH_OPS) | {"no_such_op"}):
        got = [s.name for s in registry.kernel_for_op(op)]
        assert got == [s.name for s in jreg.kernel_for_op(op)], op
        assert all(op in s.ops for s in registry.kernel_for_op(op))


def test_hashing_supports_matches_jax():
    j, t, _, _ = _key_columns()
    for pick in ([0], [1], [0, 1], [2], [0, 2], []):
        assert kh.supports([t[i] for i in pick]) == jkh.supports(
            [j[i] for i in pick]), pick


def test_describe_flags_matches_jax(monkeypatch):
    """One line a flag in the JAX layout: the JAX function over the
    port's flags gives the port's table."""
    got = config.describe_flags()
    assert len(got.splitlines()) == len(config._FLAGS)
    monkeypatch.setattr(jconfig, "_FLAGS", config._FLAGS)
    assert jconfig.describe_flags() == got
    assert "SPARK_RAPIDS_TPU_KERNELS" in got
