"""The PyTorch port stands alone and hides no fallback.

* No module of ``spark_rapids_jni_tpu_torch`` and not ``chip_smoke.py``
  imports ``jax``, the JAX package or the JAX repository's
  ``benchmarks``.
* Entry points build on CUDA unless asked for the CPU, and raise when
  CUDA is absent.
* A kernel wrapper takes its plain version only for CPU tensors: other
  devices raise, and on a CUDA tensor it launches the kernel (that test
  needs the card and skips elsewhere).
"""

import ast
import pathlib
import sys

import numpy as np
import pytest
import torch

import inspect

from spark_rapids_jni_tpu_torch import Column, Table, graft_entry, kernels, rows
from spark_rapids_jni_tpu_torch import parallel
from spark_rapids_jni_tpu_torch import dtype as dt
from spark_rapids_jni_tpu_torch import runtime_bridge as rb
from spark_rapids_jni_tpu_torch.kernels import bitonic_sort as bs
from spark_rapids_jni_tpu_torch.kernels import hash_table as ht
from spark_rapids_jni_tpu_torch.kernels import hashing as kh
from spark_rapids_jni_tpu_torch.kernels import row_transpose as rt
from spark_rapids_jni_tpu_torch.kernels import scan16 as sc

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _live_tables() -> tuple:
    """Live tables in the port's registry and, where another test file
    loaded it, the JAX bridge's (this file never imports the JAX
    package: it runs on machines without JAX)."""
    jrb = sys.modules.get("spark_rapids_jni_tpu.runtime_bridge")
    return (len(rb._RESIDENT),
            None if jrb is None else jrb.resident_table_count())


@pytest.fixture(autouse=True)
def _registries_unchanged():
    """A test leaves the resident registries as it found them."""
    before = _live_tables()
    yield
    assert _live_tables() == before
PORT_FILES = sorted((ROOT / "spark_rapids_jni_tpu_torch").rglob("*.py"))


def _imported_modules(path: pathlib.Path) -> set:
    tree = ast.parse(path.read_text(), filename=str(path))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module or "")
    return out


def _forbidden(mod: str) -> bool:
    top = mod.split(".")[0]
    return top in ("jax", "jaxlib", "spark_rapids_jni_tpu", "benchmarks")


@pytest.mark.parametrize(
    "path", PORT_FILES + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_no_jax_imports(path):
    bad = sorted(m for m in _imported_modules(path) if _forbidden(m))
    assert not bad, f"{path.name} imports {bad}"


def test_scan_covers_the_package():
    names = {p.name for p in PORT_FILES}
    assert {"runtime_bridge.py", "registry.py", "hash_table.py",
            "row_transpose.py", "rows.py", "hashing.py", "bitonic_sort.py",
            "partition.py", "groupby_packed.py", "groupby_chunked.py",
            "graft_entry.py", "plancheck.py", "binaryop.py", "unaryop.py",
            "cast.py", "config.py", "metrics.py", "scan16.py",
            "compaction.py", "copying.py", "join.py", "buckets.py",
            "bucketed.py", "factories.py", "sort_packed.py",
            "join_packed.py", "interop.py", "predicates.py", "parquet.py",
            "parquet_device.py", "orc.py", "csv.py", "json.py", "ipc.py",
            "avro.py", "mesh.py", "shuffle.py", "tolerant.py",
            "distributed.py", "planmesh.py", "flight.py", "tracing.py",
            "lockcheck.py", "profiler.py", "planstats.py", "frames.py",
            "client.py", "session.py", "scheduler.py", "durable.py",
            "server.py", "native.py", "ieee754.py", "datagen.py",
            "queries.py", "streams.py"} <= names
    parallel_dir = ROOT / "spark_rapids_jni_tpu_torch" / "parallel"
    assert {p for p in PORT_FILES if p.parent == parallel_dir} == {
        parallel_dir / f for f in ("__init__.py", "mesh.py", "shuffle.py",
                                   "tolerant.py", "distributed.py",
                                   "planmesh.py")}
    tpcds_dir = ROOT / "spark_rapids_jni_tpu_torch" / "tpcds"
    assert {p for p in PORT_FILES if p.parent == tpcds_dir} == {
        tpcds_dir / f for f in ("__init__.py", "datagen.py", "queries.py",
                                "streams.py")}


def test_every_tpu_kernel_has_one_registered_counterpart():
    """Eight functions of the JAX package reach ``pl.pallas_call``; each
    has one hand-written kernel here, counted apart. One more kernel,
    scan16, computes the FLOAT64 cumsum of the JAX package's segment sums
    (``jnp.cumsum``, XLA's scan) in the same add order."""
    assert {k: v.replaces for k, v in kernels.KERNELS.items()} == {
        "scan16": "spark_rapids_jni_tpu/ops/groupby.py:164",
        "pack_rows": "spark_rapids_jni_tpu/kernels/row_transpose.py:149",
        "unpack_rows": "spark_rapids_jni_tpu/kernels/row_transpose.py:219",
        "build_table": "spark_rapids_jni_tpu/kernels/hash_table.py:134",
        "probe_table": "spark_rapids_jni_tpu/kernels/hash_table.py:240",
        "batched_sort_u64_looped":
            "spark_rapids_jni_tpu/kernels/bitonic_sort.py:401",
        "batched_sort_u64": "spark_rapids_jni_tpu/kernels/bitonic_sort.py:116",
        "batched_sort_u32": "spark_rapids_jni_tpu/kernels/bitonic_sort.py:265",
        "murmur3_table_fused": "spark_rapids_jni_tpu/kernels/hashing.py:158",
    }


def test_every_kernel_names_a_built_source():
    """Each kernel's source is one the build compiles; K3, K4a and K4b
    share the radix sort's."""
    for info in kernels.KERNELS.values():
        path = ROOT / info.source
        assert path.is_file() and path.stem in kernels.SOURCES, info
    src = {k: v.source.rsplit("/", 1)[1] for k, v in kernels.KERNELS.items()}
    assert (src["batched_sort_u64_looped"], src["batched_sort_u64"],
            src["batched_sort_u32"]) == (
        "radix_sort.cu", "radix_sort.cu", "radix_sort.cu")


@pytest.mark.parametrize("name", kernels.SOURCES)
def test_csrc_includes_resolve(name):
    """Every quoted include of a source (and of the headers it includes)
    is a file under csrc/, so the build needs nothing else of the repo."""
    seen, todo = set(), [f"{name}.cu"]
    while todo:
        f = todo.pop()
        seen.add(f)
        text = (kernels.CSRC / f).read_text()
        for line in text.splitlines():
            if line.startswith("#include \""):
                inc = line.split('"')[1]
                assert (kernels.CSRC / inc).is_file(), f"{f}: {inc}"
                if inc not in seen:
                    todo.append(inc)


def _fact_wire(n=4):
    offs = (np.arange(n + 1) * 8).astype(np.int32)
    return [24], [5], [offs.tobytes() + bytes(8 * n)], [None], n


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        rb.table_upload_wire(*_fact_wire())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Column.from_numpy(np.arange(3))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Table.from_pydict({"a": np.arange(3)})
    plan = '[{"op": "from_rows", "type_ids": [3], "scales": [0]}]'
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        rb.table_plan_wire(plan, *_fact_wire())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        rb.table_op_wire(plan[1:-1], *_fact_wire())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        graft_entry.entry()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        graft_entry._example_tables()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        parallel.make_mesh()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        parallel.make_mesh(4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        parallel.MeshRunner(4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        graft_entry.dryrun_multichip(4)
    # the CPU is used only when asked for
    tid = rb.table_upload_wire(*_fact_wire(), device="cpu")
    assert rb.table_num_rows(tid) == 4
    rb.table_free(tid)
    assert len(rb.table_plan_wire(plan, *_fact_wire(), device="cpu")) == 5
    assert graft_entry.entry("cpu")[1][0].row_count == 256


def test_native_shim_embeds_the_port():
    """``src/cpp/torch_runtime.cpp`` imports the port's bridge, names no
    module of the JAX package, and carries the loader's marker."""
    src = (ROOT / "src" / "cpp" / "torch_runtime.cpp").read_text()
    assert '"spark_rapids_jni_tpu_torch.runtime_bridge"' in src
    assert "spark_rapids_jni_tpu." not in src
    assert 'return "spark_rapids_jni_tpu_torch";' in src


def test_server_raises_without_cuda(monkeypatch):
    from spark_rapids_jni_tpu_torch import serving

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    srv = serving.Server(port=0)
    assert srv.device.type == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        srv.start()
    assert srv.port is None


@pytest.mark.parametrize("fn", [rb.table_plan_wire, rb.table_op_wire,
                                graft_entry.entry, graft_entry._example_tables,
                                graft_entry.dryrun_multichip],
                         ids=lambda f: f.__name__)
def test_new_entries_default_to_cuda(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def _inputs(device):
    layout = rows.compute_fixed_width_layout([dt.INT64, dt.INT32, dt.BOOL8])
    n = 100
    col_bytes = [torch.zeros((n, w), dtype=torch.uint8, device=device)
                 for w in layout.column_widths]
    valid = torch.ones((n, 3), dtype=torch.uint8, device=device)
    keys = torch.arange(256, dtype=torch.int32, device=device).reshape(2, 128)
    return layout, col_bytes, valid, keys


def _hash_and_sort(keys):
    """One call of each of K5, K3, K4a and K4b on ``keys``' device."""
    cols = [Column(keys.reshape(-1), dt.INT32),
            Column(keys.reshape(-1).to(torch.int64), dt.INT64,
                   keys.reshape(-1) % 3 != 0)]
    kh.murmur3_columns(cols)
    bs.batched_sort_u64_looped(keys.to(torch.int64), keys)
    bs.batched_sort_u64(keys.to(torch.int64), keys)
    bs.batched_sort_u32(keys, keys)


def _counts():
    return {k: v.launches for k, v in kernels.KERNELS.items()}


def _transpose(layout, col_bytes, valid):
    """One call of each entry of K1a and K1b: the JAX-contract matrix
    form and the per-column form rows.py takes."""
    packed = rt.pack_rows(col_bytes, valid, layout)
    rt.unpack_rows(packed, layout)
    rt.pack_rows_columns(
        col_bytes, [valid[:, 0] != 0, None, valid[:, 2].contiguous()], layout)
    rt.unpack_rows_columns(packed, layout)


def test_cpu_tensors_take_the_plain_version_without_a_build():
    before = _counts()
    layout, col_bytes, valid, keys = _inputs("cpu")
    _transpose(layout, col_bytes, valid)
    built = ht.build_table(keys, keys, torch.ones_like(keys), table_slots=256)
    ht.probe_table(keys, keys, torch.ones_like(keys), *built[1:4])
    _hash_and_sort(keys)
    sc.scan_sum16(torch.arange(5000, dtype=torch.float64))
    assert _counts() == before
    assert not kernels._LIBS, "importing or CPU use must not build kernels"


def test_other_devices_raise_instead_of_falling_back():
    layout, col_bytes, valid, keys = _inputs("meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        rt.pack_rows(col_bytes, valid, layout)
    with pytest.raises(ValueError, match="CUDA tensor"):
        rt.unpack_rows(torch.zeros((4, layout.row_size), dtype=torch.uint8,
                                   device="meta"), layout)
    with pytest.raises(ValueError, match="CUDA tensor"):
        rt.pack_rows_columns(col_bytes, [None] * 3, layout)
    with pytest.raises(ValueError, match="CUDA tensor"):
        rt.unpack_rows_columns(torch.zeros((4, layout.row_size),
                                           dtype=torch.uint8, device="meta"),
                               layout)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ht.build_table(keys, keys, torch.ones_like(keys), table_slots=256)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kh.murmur3_columns([Column(keys.reshape(-1), dt.INT32)])
    with pytest.raises(ValueError, match="CUDA tensor"):
        bs.batched_sort_u64_looped(keys.to(torch.int64))
    with pytest.raises(ValueError, match="CUDA tensor"):
        bs.batched_sort_u64(keys.to(torch.int64))
    with pytest.raises(ValueError, match="CUDA tensor"):
        bs.batched_sort_u32(keys)
    with pytest.raises(ValueError, match="CUDA tensor"):
        sc.scan_sum16(torch.zeros(8, dtype=torch.float64, device="meta"))


@pytest.mark.cuda
def test_cuda_wrappers_never_call_the_plain_version(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")

    def boom(*a, **k):
        raise AssertionError("plain version called for a CUDA tensor")

    for mod, name in ((rt, "pack_rows_plain"), (rt, "unpack_rows_plain"),
                      (rt, "pack_rows_columns_plain"),
                      (rt, "unpack_rows_columns_plain"),
                      (ht, "build_table_plain"), (ht, "probe_table_plain"),
                      (kh, "murmur3_plain"), (bs, "batched_sort_plain"),
                      (bs, "batched_sort_u64_plain"),
                      (bs, "batched_sort_u32_plain"),
                      (sc, "scan_sum16_plain")):
        monkeypatch.setattr(mod, name, boom)
    before = _counts()
    layout, col_bytes, valid, keys = _inputs("cuda")
    _transpose(layout, col_bytes, valid)
    built = ht.build_table(keys, keys, torch.ones_like(keys), table_slots=256)
    ht.probe_table(keys, keys, torch.ones_like(keys), *built[1:4])
    _hash_and_sort(keys)
    sc.scan_sum16(torch.arange(5000, dtype=torch.float64, device="cuda"))
    torch.cuda.synchronize()
    after = _counts()
    # the transposes ran through both of their entries
    calls = {rt.PACK.name: 2, rt.UNPACK.name: 2}
    assert all(after[k] == before[k] + calls.get(k, 1) for k in after)


def _one_row_in(x):
    """A copy of ``x`` that starts one element into a bigger buffer."""
    buf = torch.zeros(x.numel() + 1, dtype=x.dtype, device=x.device)
    buf[1:] = x.reshape(-1)
    return buf[1:].view(x.shape)


# (C, T, distinct build keys, null fraction, probe max_probes, queries):
# absent keys, views one row into their buffers, max_probes 1, a ragged
# T, and more chunks than the CUDA grid's y limit (65,535) at a tiny T
CARD_PROBE_CASES = [
    (2, 1024, 700, 0.1, 64, "absent"),
    (3, 512, 400, 0.0, 64, "views"),
    (1, 1001, 800, 0.2, 64, "views"),
    (3, 1001, 900, 0.0, 64, "mixed"),
    (4, 1024, 3000, 0.0, 1, "mixed"),
    (70_000, 3, 50_000, 0.1, 64, "mixed"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("c,t,distinct,nulls,probes,queries",
                         CARD_PROBE_CASES)
def test_probe_cases_on_card(c, t, distinct, nulls, probes, queries):
    """K2b on the card equals its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(c + t + distinct)
    pool = rng.integers(0, 2**32, (2, distinct), dtype=np.uint64)
    pool[0] &= 2**31 - 1  # absent queries set the top bit of lo

    def on_card(a):
        return torch.from_numpy(a.astype(np.uint32).view(np.int32)).cuda()

    def flags(frac):
        return torch.from_numpy(
            (rng.random((c, t)) >= frac).astype(np.int32)).cuda()

    pick = rng.integers(0, distinct, (c, t))
    lo, hi = on_card(pool[0][pick]), on_card(pool[1][pick])
    s = 2 << (t - 1).bit_length()
    tab = ht.build_table_plain(lo, hi, flags(nulls), table_slots=s)[1:4]
    fresh = rng.integers(0, 2**32, (2, c, t), dtype=np.uint64)
    if queries == "absent":
        q = [on_card(fresh[0] | 2**31), on_card(fresh[1])]
    else:
        pick = rng.integers(0, distinct, (c, t))
        old = rng.random((c, t)) < 0.5
        q = [on_card(np.where(old, pool[k][pick], fresh[k])) for k in (0, 1)]
    q.append(flags(nulls))
    if queries == "views":
        q = [_one_row_in(x) for x in q]
    want = ht.probe_table_plain(*q, *tab, max_probes=probes)
    got = ht.probe_table(*q, *tab, max_probes=probes)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)
    if queries == "absent":
        assert not want[0].any()
    if probes == 1:
        assert int(want[2]) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("build_keys,queries", [(20_360, 1 << 20),
                                                (1, 4097), (4096, 3)])
def test_semi_shapes_on_card(build_keys, queries):
    """K2a and K2b at the semi join's shapes (one chunk of the category's
    unique keys, 2 * next_pow2 slots, every probe row valid) equal their
    plain versions on the card, and the membership the registry reads."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(build_keys)
    keys = rng.choice(1 << 40, build_keys, replace=False).astype(np.int64)
    probe = np.where(rng.random(queries) < 0.3,
                     rng.choice(keys, queries), rng.integers(0, 1 << 40,
                                                             queries))

    def halves(a):
        u = torch.from_numpy(a).cuda()
        return (ht._as_i32(u & 0xFFFFFFFF)[None, :],
                ht._as_i32(u >> 32)[None, :])

    blo, bhi = halves(keys)
    slots = 2 << max(build_keys - 1, 0).bit_length()
    bval = torch.ones_like(blo)
    got = ht.build_table(blo, bhi, bval, table_slots=slots)
    want = ht.build_table_plain(blo, bhi, bval, table_slots=slots)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    plo, phi = halves(probe)
    pval = torch.ones_like(plo)
    found = ht.probe_table(plo, phi, pval, *got[1:4])
    plain = ht.probe_table_plain(plo, phi, pval, *want[1:4])
    torch.cuda.synchronize()
    for a, b in zip(found, plain):
        assert torch.equal(a, b)
    member = np.isin(probe, keys)
    np.testing.assert_array_equal(found[0][0].cpu().numpy() != 0, member)


@pytest.mark.cuda
def test_scan16_flushes_subnormals_on_card():
    """scan16 flushes subnormals in what each add reads and returns, bit
    for bit as its plain version and XLA's CPU code."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tiny = np.finfo(np.float64).tiny
    pool = np.array([5e-324, 1e-310, -1e-310, 3 * tiny, -2.5 * tiny, 1.0,
                     -1.0, 1e-300, -0.0])
    rng = np.random.default_rng(5)
    for n in (2, 17, 4097, 70_000):
        v = torch.from_numpy(pool[rng.integers(0, pool.shape[0], n)]).cuda()
        got = sc.scan_sum16(v).view(torch.int64)
        want = sc.scan_sum16_plain(v.cpu()).view(torch.int64)
        assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_scan16_one_pass_at_every_edge_on_card():
    """The one-pass scan reads no tile total too early and leaves no flag
    or ticket behind: bit for bit against its plain version at every
    length ``chip_smoke.py`` checks, on each of 20 calls back to back on
    one stream."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from chip_smoke import SCAN16_CASE_ROWS

    rng = np.random.default_rng(16)
    for n in SCAN16_CASE_ROWS:
        x = rng.standard_normal(n) * 10.0 ** rng.integers(-6, 7, n)
        x[rng.random(n) < 0.05] = -0.0
        v = torch.from_numpy(x).cuda()
        want = sc.scan_sum16_plain(v).view(torch.int64)
        calls = [sc.scan_sum16(v) for _ in range(20)]
        torch.cuda.synchronize()
        bad = [i for i, c in enumerate(calls)
               if not torch.equal(c.view(torch.int64), want)]
        assert not bad, f"{n} elements: calls {bad} differ"


@pytest.mark.cuda
def test_ragged_and_dense_compact_agree_on_card():
    """The two forms of the ragged exchange give the same bytes on a
    mesh of 4 shards of one card (the default form there is ragged),
    and K5 places the rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from spark_rapids_jni_tpu_torch.parallel import shuffle as psh

    n = 1 << 16
    rng = np.random.default_rng(3)
    words = [f"w{i:03d}".encode() for i in range(300)]
    t = Table([Column.from_numpy(rng.zipf(1.3, n) % 5000, rng.random(n) > 0.05),
               Column.from_numpy(rng.standard_normal(n)),
               Column.from_strings([words[i] for i in rng.integers(0, 300, n)])],
              ["k", "f", "s"])
    mesh = parallel.make_mesh(4, devices=[torch.device("cuda", 0)] * 4)
    assert psh._ragged_impl(None, mesh) == "ragged"
    before = kh.MURMUR3.launches
    got = {impl: parallel.shuffle_table_compact(t, ["k"], mesh, impl=impl)
           for impl in ("ragged", "dense_compact")}
    assert kh.MURMUR3.launches > before
    (a, ao, av), (b, bo, bv) = got["ragged"], got["dense_compact"]
    assert torch.equal(ao.concat(), bo.concat()) and torch.equal(av, bv)
    for ca, cb in zip(a.concat().columns, b.concat().columns):
        for x, y in ((ca.data, cb.data), (ca.validity, cb.validity),
                     (ca.lengths, cb.lengths)):
            assert (x is None) == (y is None)
            assert x is None or torch.equal(x, y)
    assert int(ao.concat().sum()) == n
