"""The port's native shim (``src/cpp/torch_runtime.cpp``, built by
``utils/native.py``) on the CPU.

* A module fixture builds ``libspark_rapids_tpu_torch.so``,
  ``native_demo_torch`` and ``jni_harness_torch`` with g++ into a
  temporary directory (never ``build/libspark_rapids_tpu.so``).
* JOIN mode: through the ctypes wrappers, with
  ``SPARK_RAPIDS_TPU_DEVICE=cpu``, ``to_rows``, ``from_rows`` and a
  filter give the JAX ``runtime_bridge.table_op_wire`` bytes, and the
  resident chain upload -> op -> download -> free does too.
* HOST mode: the two native programs run as child processes on the CPU
  and exit 0.
* The loader refuses a library without the port's marker symbol.
"""

import ctypes
import json
import os
import pathlib
import shutil
import subprocess
import sysconfig

import numpy as np
import pytest

from spark_rapids_jni_tpu import runtime_bridge as jrb
from spark_rapids_jni_tpu_torch import runtime_bridge as rb
from spark_rapids_jni_tpu_torch.utils import config, native

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _missing() -> str:
    if shutil.which("g++") is None:
        return "g++"
    inc = pathlib.Path(sysconfig.get_paths()["include"]) / "Python.h"
    if not inc.exists():
        return str(inc)
    libdir = pathlib.Path(sysconfig.get_config_var("LIBDIR") or "")
    name = sysconfig.get_config_var("LDLIBRARY") or "libpython3.so"
    if not (libdir / name).exists():
        return str(libdir / name)
    return ""


_MISSING = _missing()
pytestmark = pytest.mark.skipif(
    bool(_MISSING), reason=f"the shim's build needs {_MISSING}")


@pytest.fixture(scope="module")
def shim(tmp_path_factory):
    paths = native.build(tmp_path_factory.mktemp("torch_native"))
    old = os.environ.get("SPARK_RAPIDS_TPU_DEVICE")
    os.environ["SPARK_RAPIDS_TPU_DEVICE"] = "cpu"
    config.set_flag("NATIVE_LIB", str(paths["lib"]))
    native.reset_for_tests()
    native.jax_init()
    yield paths
    config.clear_flag("NATIVE_LIB")
    native.reset_for_tests()
    if old is None:
        os.environ.pop("SPARK_RAPIDS_TPU_DEVICE", None)
    else:
        os.environ["SPARK_RAPIDS_TPU_DEVICE"] = old


@pytest.fixture(autouse=True)
def _registries_unchanged():
    before = (len(rb._RESIDENT), jrb.resident_table_count())
    yield
    assert (len(rb._RESIDENT), jrb.resident_table_count()) == before


def test_build_writes_only_the_port_files(shim):
    assert {p.name for p in shim.values()} == {
        "libspark_rapids_tpu_torch.so", "native_demo_torch",
        "jni_harness_torch"}
    assert native.runtime_package() == "spark_rapids_jni_tpu_torch"
    assert native.jax_platform() == "cpu"
    assert native.build(shim["lib"].parent) == shim  # built once
    assert native.build_dir().parent == ROOT / "build" / "torch_native"


def _wire(n: int):
    rng = np.random.default_rng(n)
    k = rng.integers(-50, 50, n, dtype=np.int64)
    v = rng.random(n)
    m = (k > 0).astype(np.uint8)
    kv = (np.arange(n) % 7 != 0).astype(np.uint8)
    return [4, 10, 11], [0, 0, 0], [k.tobytes(), v.tobytes(), m.tobytes()], \
        [kv.tobytes(), None, None], n


def _handles(datas, valids):
    hd = [native.buffer_create(d) for d in datas]
    hv = [None if v is None else native.buffer_create(v) for v in valids]
    return hd, hv


def _release(hd, hv):
    for h in list(hd) + [h for h in hv if h]:
        native.buffer_release(h)


def _op_via_shim(op, wire):
    ids, scales, datas, valids, n = wire
    hd, hv = _handles(datas, valids)
    try:
        out = native.jax_table_op(json.dumps(op), ids, scales, hd, hv, n)
    finally:
        _release(hd, hv)
    oids, oscales, od, ov, on = out
    try:
        return (oids, oscales, [native.buffer_bytes(h) for h in od],
                [None if h is None else native.buffer_bytes(h) for h in ov],
                on)
    finally:
        _release(od, ov)


def _norm(w):
    ids, scales, datas, valids, n = w
    return ([int(x) for x in ids], [int(x) for x in scales],
            [bytes(d) for d in datas],
            [None if v is None else bytes(v) for v in valids], int(n))


@pytest.mark.parametrize("n", [1023, 1024, 1025])
def test_join_mode_ops_match_jax(shim, n):
    wire = _wire(n)
    to_rows = {"op": "to_rows"}
    got = _op_via_shim(to_rows, wire)
    assert got == _norm(jrb.table_op_wire(json.dumps(to_rows), *wire))
    from_rows = {"op": "from_rows", "type_ids": wire[0], "scales": wire[1]}
    assert _op_via_shim(from_rows, got) == _norm(
        jrb.table_op_wire(json.dumps(from_rows), *got))
    flt = {"op": "filter", "mask": 2}
    assert _op_via_shim(flt, wire) == _norm(
        jrb.table_op_wire(json.dumps(flt), *wire))
    assert native.live_handle_count() == 0


def test_join_mode_resident_chain_matches_jax(shim):
    wire = _wire(2000)
    ids, scales, datas, valids, n = wire
    hd, hv = _handles(datas, valids)
    before = native.jax_resident_table_count()
    try:
        t = native.jax_table_upload(ids, scales, hd, hv, n)
    finally:
        _release(hd, hv)
    t2 = native.jax_table_op_resident(json.dumps({"op": "to_rows"}), [t])
    assert native.jax_table_num_rows(t2) == n
    oids, oscales, od, ov, on = native.jax_table_download(t2)
    got = (oids, oscales, [native.buffer_bytes(h) for h in od],
           [None if h is None else native.buffer_bytes(h) for h in ov], on)
    _release(od, ov)
    assert native.jax_resident_table_count() == before + 2
    native.jax_table_free(t)
    native.jax_table_free(t2)
    assert native.jax_resident_table_count() == before
    assert got == _norm(jrb.table_op_wire('{"op": "to_rows"}', *wire))
    assert native.live_handle_count() == 0


@pytest.mark.parametrize("prog", ["native_demo", "jni_harness"])
def test_native_programs_run_on_cpu(shim, prog):
    env = dict(os.environ, SPARK_RAPIDS_TPU_DEVICE="cpu",
               SRT_PYTHONPATH=str(ROOT))
    proc = subprocess.run([str(shim[prog])], env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "platform = cpu" in proc.stdout
    assert proc.stdout.rstrip().endswith("ok")


def test_device_variable_is_checked(shim):
    env = dict(os.environ, SPARK_RAPIDS_TPU_DEVICE="tpu",
               SRT_PYTHONPATH=str(ROOT))
    proc = subprocess.run([str(shim["native_demo"])], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "SPARK_RAPIDS_TPU_DEVICE must be cuda or cpu" in proc.stderr


def test_loader_refuses_a_library_without_the_marker(shim, tmp_path):
    """A library on the NATIVE_LIB path that is not the port's shim (the
    JAX package's, which exports the same C ABI) is refused before any
    of its code runs."""
    src = tmp_path / "other.cpp"
    src.write_text('extern "C" int srt_jax_available(void) { return 1; }\n')
    lib = tmp_path / "libspark_rapids_tpu.so"
    subprocess.run(["g++", "-shared", "-fPIC", "-o", str(lib), str(src)],
                   check=True)
    config.set_flag("NATIVE_LIB", str(lib))
    native.reset_for_tests()
    try:
        with pytest.raises(native.NativeLibraryError,
                           match="srt_runtime_package"):
            native.load()
        assert not native.available()
        assert isinstance(ctypes.CDLL(str(lib)).srt_jax_available,
                          ctypes._CFuncPtr)
    finally:
        config.set_flag("NATIVE_LIB", str(shim["lib"]))
        native.reset_for_tests()
    assert native.runtime_package() == "spark_rapids_jni_tpu_torch"


def test_a_failed_build_raises_with_the_compiler_output(monkeypatch,
                                                       tmp_path):
    monkeypatch.setattr(native, "CXX_FLAGS",
                        native.CXX_FLAGS + ("-DSRT_NO_SUCH_HEADER",
                                            "-include", "no_such.h"))
    with pytest.raises(native.NativeBuildError, match="no_such.h"):
        native.build(tmp_path / "broken")
