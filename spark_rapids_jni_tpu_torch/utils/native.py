"""ctypes binding to the port's native runtime shim
(``libspark_rapids_tpu_torch.so``; port of ``utils/native.py``).

The shim is ``src/cpp/torch_runtime.cpp`` with the C ABI's common
sources (``src/cpp/{error,handle_registry,row_format}.cpp``): the C ABI
of ``src/include/spark_rapids_tpu/c_api.h``, whose device entry points
(``srt_jax_*``) embed a CPython interpreter running
``spark_rapids_jni_tpu_torch.runtime_bridge``. The JNI bridge
(``src/jni/``) and ``src/tools/native_demo.cpp`` link against it
unchanged; :func:`build` also links them, as ``jni_harness_torch`` and
``native_demo_torch``.

The loader resolves the ``NATIVE_LIB`` flag first, then
``spark_rapids_jni_tpu_torch/_native/``, then the build tree
``build/torch_native/<hash>/``, which :func:`build` fills at the first
use (``g++``, a few seconds). The flag's variable is the one the JAX
package reads, so a library without the port's marker symbol
(``srt_runtime_package``) is refused with :class:`NativeLibraryError`: a
JAX shim would import the JAX package into this process.

``available()`` says whether a library loads; no entry point takes
another route when it does not: a failed build raises
:class:`NativeBuildError` with the compiler's output.

The device is read by the shim from ``SPARK_RAPIDS_TPU_DEVICE`` at
:func:`jax_init` (``cuda``, the default, or ``cpu``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import sysconfig
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from . import config
from . import lockcheck

PACKAGE = "spark_rapids_jni_tpu_torch"
LIB_NAME = "libspark_rapids_tpu_torch.so"
_REPO = Path(__file__).resolve().parent.parent.parent
_SRC = _REPO / "src"
BUILD_ROOT = _REPO / "build" / "torch_native"
LIB_SOURCES = ("cpp/error.cpp", "cpp/handle_registry.cpp",
               "cpp/row_format.cpp", "cpp/torch_runtime.cpp")
DEMO_SOURCES = ("tools/native_demo.cpp",)
HARNESS_SOURCES = ("tools/jni_harness.cpp", "jni_mock/mock_jni.cpp",
                   "jni/RowConversionJni.cpp", "jni/HostBufferJni.cpp",
                   "jni/DeviceTableJni.cpp")
CXX_FLAGS = ("-std=c++17", "-O2", "-fPIC")

# status codes (src/include/spark_rapids_tpu/c_api.h)
SRT_OK = 0

_lock = lockcheck.make_lock("native.load")
_lib: Optional[ctypes.CDLL] = None


class NativeBuildError(RuntimeError):
    """The shim did not build; the message holds the compiler's output."""


class NativeLibraryError(RuntimeError):
    """A library on the search path is not the port's shim (no
    ``srt_runtime_package``, or it names another package)."""


def _python_flags() -> tuple:
    """(compile flags, link flags) embedding this interpreter."""
    inc = sysconfig.get_paths()["include"]
    libdir = sysconfig.get_config_var("LIBDIR") or ""
    ver = sysconfig.get_config_var("LDVERSION") or sysconfig.get_python_version()
    exe = sys.executable.replace("\\", "\\\\").replace('"', '\\"')
    return ((f"-I{inc}", f'-DSRT_PYTHON_DEFAULT="{exe}"'),
            (f"-L{libdir}", f"-Wl,-rpath,{libdir}", f"-lpython{ver}"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS + sum(_python_flags(), ()))
                       .encode())
    files = [_SRC / p for p in LIB_SOURCES + DEMO_SOURCES + HARNESS_SOURCES]
    for d in ("include/spark_rapids_tpu", "cpp", "jni_mock", "jni/jni_stub"):
        files += sorted(p for p in (_SRC / d).iterdir()
                        if p.suffix in (".h", ".hpp"))
    for p in files:
        h.update(str(p.relative_to(_SRC)).encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    return BUILD_ROOT / _digest()


def _compiler() -> str:
    cxx = shutil.which("g++")
    if cxx is None:
        raise NativeBuildError("g++ not found: the shim is built with g++")
    return cxx


def _run(cmds: list) -> None:
    """Run the compilers together; raise with every failure's output."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    failed = []
    for cmd, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"$ {' '.join(cmd)}\n{out}")
    if failed:
        raise NativeBuildError("native shim build failed:\n"
                               + "\n".join(failed))


def build(out_dir=None) -> dict:
    """Build the shim and its two native callers into ``out_dir``
    (default :func:`build_dir`) unless they are there; returns
    ``{"lib", "native_demo", "jni_harness": path}``. Never writes
    ``build/libspark_rapids_tpu.so`` (the JAX package's library)."""
    if not _SRC.is_dir():
        raise NativeBuildError(
            f"no shim sources at {_SRC}: point SPARK_RAPIDS_TPU_NATIVE_LIB "
            "at a built library")
    out = Path(out_dir) if out_dir is not None else build_dir()
    paths = {"lib": out / LIB_NAME,
             "native_demo": out / "native_demo_torch",
             "jni_harness": out / "jni_harness_torch"}
    if all(p.exists() for p in paths.values()):
        return paths
    cxx = _compiler()
    py_compile, py_link = _python_flags()
    out.mkdir(parents=True, exist_ok=True)
    tmp = out / f"tmp-{os.getpid()}"
    tmp.mkdir(exist_ok=True)
    inc = (f"-I{_SRC / 'include'}", f"-I{_SRC / 'cpp'}")
    _run([[cxx, *CXX_FLAGS, "-shared", *inc, *py_compile,
           *[str(_SRC / p) for p in LIB_SOURCES], *py_link,
           "-o", str(tmp / LIB_NAME)]])
    exe = (*CXX_FLAGS, *inc, f"-L{tmp}", "-lspark_rapids_tpu_torch",
           "-Wl,-rpath,$ORIGIN", *py_link)
    _run([
        [cxx, *[str(_SRC / p) for p in DEMO_SOURCES], *exe,
         "-o", str(tmp / "native_demo_torch")],
        [cxx, "-DSRT_HAVE_JNI=1", f"-I{_SRC / 'jni' / 'jni_stub'}",
         *[str(_SRC / p) for p in HARNESS_SOURCES], *exe,
         "-o", str(tmp / "jni_harness_torch")],
    ])
    for key, p in paths.items():
        os.replace(tmp / p.name, p)
    shutil.rmtree(tmp, ignore_errors=True)
    return paths


def _candidate_paths() -> list:
    here = Path(__file__).resolve().parent.parent
    out = []
    flag = config.get_flag("NATIVE_LIB")
    if flag:
        out.append(str(flag))
    out.append(str(here / "_native" / LIB_NAME))
    if _SRC.is_dir():  # a jar's tree holds the library, not its sources
        out.append(str(build_dir() / LIB_NAME))
    return out


def _open(path: str) -> ctypes.CDLL:
    """dlopen ``path`` and check the marker before anything else runs
    (the JAX shim imports its package only at init, never at load)."""
    lib = ctypes.CDLL(path)
    try:
        marker = lib.srt_runtime_package
    except AttributeError:
        raise NativeLibraryError(
            f"{path} is not the port's native shim: it has no "
            "srt_runtime_package symbol (a JAX package library?); point "
            f"SPARK_RAPIDS_TPU_NATIVE_LIB at {LIB_NAME}")
    marker.restype = ctypes.c_char_p
    got = marker().decode()
    if got != PACKAGE:
        raise NativeLibraryError(
            f"{path} embeds {got!r}, not {PACKAGE!r}")
    return _bind(lib)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.srt_runtime_package.restype = ctypes.c_char_p
    lib.srt_last_error.restype = ctypes.c_char_p
    lib.srt_version.restype = ctypes.c_char_p
    lib.srt_type_width.restype = ctypes.c_int32
    lib.srt_type_width.argtypes = [ctypes.c_int32]
    lib.srt_compute_row_layout.restype = ctypes.c_int
    lib.srt_max_rows_per_batch.restype = ctypes.c_int64
    lib.srt_max_rows_per_batch.argtypes = [ctypes.c_int32]
    lib.srt_pack_rows.restype = ctypes.c_int
    lib.srt_unpack_rows.restype = ctypes.c_int
    lib.srt_buffer_create.restype = ctypes.c_int64
    lib.srt_buffer_create.argtypes = [
        ctypes.c_void_p,
        ctypes.c_int64,
        ctypes.c_char_p,
    ]
    lib.srt_buffer_alloc.restype = ctypes.c_int64
    lib.srt_buffer_alloc.argtypes = [ctypes.c_int64, ctypes.c_char_p]
    lib.srt_buffer_retain.restype = ctypes.c_int
    lib.srt_buffer_retain.argtypes = [ctypes.c_int64]
    lib.srt_buffer_release.restype = ctypes.c_int
    lib.srt_buffer_release.argtypes = [ctypes.c_int64]
    lib.srt_buffer_data.restype = ctypes.c_void_p
    lib.srt_buffer_data.argtypes = [ctypes.c_int64]
    lib.srt_buffer_size.restype = ctypes.c_int64
    lib.srt_buffer_size.argtypes = [ctypes.c_int64]
    lib.srt_set_refcount_debug.argtypes = [ctypes.c_int]
    lib.srt_live_handle_count.restype = ctypes.c_int64
    lib.srt_leak_report.restype = ctypes.c_int64
    lib.srt_leak_report.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    lib.srt_jax_available.restype = ctypes.c_int32
    lib.srt_jax_init.restype = ctypes.c_int
    lib.srt_jax_platform.restype = ctypes.c_int
    lib.srt_jax_platform.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    lib.srt_jax_table_op.restype = ctypes.c_int
    lib.srt_jax_table_op.argtypes = [
        ctypes.c_char_p,                     # op_json
        ctypes.POINTER(ctypes.c_int32),      # type_ids
        ctypes.POINTER(ctypes.c_int32),      # scales
        ctypes.c_int32,                      # num_columns
        ctypes.POINTER(ctypes.c_int64),      # col_data handles
        ctypes.POINTER(ctypes.c_int64),      # col_valid handles
        ctypes.c_int64,                      # num_rows
        ctypes.c_int32,                      # max_out_columns
        ctypes.POINTER(ctypes.c_int32),      # out_type_ids
        ctypes.POINTER(ctypes.c_int32),      # out_scales
        ctypes.POINTER(ctypes.c_int32),      # out_num_columns
        ctypes.POINTER(ctypes.c_int64),      # out_col_data
        ctypes.POINTER(ctypes.c_int64),      # out_col_valid
        ctypes.POINTER(ctypes.c_int64),      # out_num_rows
    ]
    lib.srt_jax_table_upload.restype = ctypes.c_int
    lib.srt_jax_table_upload.argtypes = [
        ctypes.POINTER(ctypes.c_int32),      # type_ids
        ctypes.POINTER(ctypes.c_int32),      # scales
        ctypes.c_int32,                      # num_columns
        ctypes.POINTER(ctypes.c_int64),      # col_data handles
        ctypes.POINTER(ctypes.c_int64),      # col_valid handles
        ctypes.c_int64,                      # num_rows
        ctypes.POINTER(ctypes.c_int64),      # out_table
    ]
    lib.srt_jax_table_op_resident.restype = ctypes.c_int
    lib.srt_jax_table_op_resident.argtypes = [
        ctypes.c_char_p,                     # op_json
        ctypes.POINTER(ctypes.c_int64),      # inputs
        ctypes.c_int32,                      # num_inputs
        ctypes.POINTER(ctypes.c_int64),      # out_table
    ]
    lib.srt_jax_table_download.restype = ctypes.c_int
    lib.srt_jax_table_download.argtypes = [
        ctypes.c_int64,                      # table
        ctypes.c_int32,                      # max_out_columns
        ctypes.POINTER(ctypes.c_int32),      # out_type_ids
        ctypes.POINTER(ctypes.c_int32),      # out_scales
        ctypes.POINTER(ctypes.c_int32),      # out_num_columns
        ctypes.POINTER(ctypes.c_int64),      # out_col_data
        ctypes.POINTER(ctypes.c_int64),      # out_col_valid
        ctypes.POINTER(ctypes.c_int64),      # out_num_rows
    ]
    lib.srt_jax_table_num_rows.restype = ctypes.c_int
    lib.srt_jax_table_num_rows.argtypes = [
        ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
    ]
    lib.srt_jax_table_free.restype = ctypes.c_int
    lib.srt_jax_table_free.argtypes = [ctypes.c_int64]
    lib.srt_jax_resident_table_count.restype = ctypes.c_int
    lib.srt_jax_resident_table_count.argtypes = [
        ctypes.POINTER(ctypes.c_int64),
    ]
    return lib


def load() -> ctypes.CDLL:
    """Idempotent load: the first candidate path that exists, else the
    build tree, built now. Raises :class:`NativeLibraryError` for a
    library that is not the port's, :class:`NativeBuildError` when the
    build fails."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        for path in _candidate_paths():
            if path and os.path.exists(path):
                _lib = _open(path)
                return _lib
        _lib = _open(str(build()["lib"]))
        return _lib


def available() -> bool:
    """Whether the shim loads (building it if needed)."""
    try:
        load()
    except (NativeBuildError, NativeLibraryError, OSError):
        return False
    return True


def reset_for_tests() -> None:
    """Drop the cached library (a test that points NATIVE_LIB elsewhere)."""
    global _lib
    with _lock:
        _lib = None


def _check(status: int) -> None:
    if status != SRT_OK:
        msg = load().srt_last_error().decode()
        raise RuntimeError(f"native error ({status}): {msg}")


def runtime_package() -> str:
    return load().srt_runtime_package().decode()


def version() -> str:
    return load().srt_version().decode()


# ---------------------------------------------------------------------------
# row codec over numpy host buffers
# ---------------------------------------------------------------------------

def compute_row_layout(type_ids: Sequence[int]):
    """-> (offsets, widths, validity_offset, validity_bytes, row_size)."""
    lib = load()
    n = len(type_ids)
    ids = np.asarray(type_ids, dtype=np.int32)
    offs = np.zeros(n, dtype=np.int32)
    widths = np.zeros(n, dtype=np.int32)

    class _Layout(ctypes.Structure):
        _fields_ = [
            ("num_columns", ctypes.c_int32),
            ("validity_offset", ctypes.c_int32),
            ("validity_bytes", ctypes.c_int32),
            ("row_size", ctypes.c_int32),
        ]

    layout = _Layout()
    _check(
        lib.srt_compute_row_layout(
            ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            n,
            offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            widths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ctypes.byref(layout),
        )
    )
    return (
        offs.tolist(),
        widths.tolist(),
        layout.validity_offset,
        layout.validity_bytes,
        layout.row_size,
    )


def pack_rows(
    type_ids: Sequence[int],
    col_data: Sequence[np.ndarray],
    col_valid: Sequence[Optional[np.ndarray]],
) -> np.ndarray:
    """Host columns -> (n, row_size) uint8 packed rows (native codec)."""
    lib = load()
    n_cols = len(type_ids)
    ids = np.asarray(type_ids, dtype=np.int32)
    num_rows = int(col_data[0].shape[0]) if n_cols else 0
    *_, row_size = compute_row_layout(type_ids)

    data_bufs = [np.ascontiguousarray(a) for a in col_data]
    valid_bufs = [
        None if v is None else np.ascontiguousarray(v, dtype=np.uint8)
        for v in col_valid
    ]
    data_ptrs = (ctypes.c_void_p * n_cols)(
        *[b.ctypes.data_as(ctypes.c_void_p).value for b in data_bufs]
    )
    valid_ptrs = (ctypes.POINTER(ctypes.c_uint8) * n_cols)(
        *[
            ctypes.cast(None, ctypes.POINTER(ctypes.c_uint8))
            if v is None
            else v.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
            for v in valid_bufs
        ]
    )
    out = np.zeros((num_rows, row_size), dtype=np.uint8)
    _check(
        lib.srt_pack_rows(
            ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            n_cols,
            data_ptrs,
            valid_ptrs,
            ctypes.c_int64(num_rows),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        )
    )
    return out


def unpack_rows(
    type_ids: Sequence[int], rows: np.ndarray, widths: Sequence[int]
):
    """(n, row_size) uint8 -> ([col bytes buffers], [validity byte arrays])."""
    lib = load()
    n_cols = len(type_ids)
    ids = np.asarray(type_ids, dtype=np.int32)
    rows = np.ascontiguousarray(rows, dtype=np.uint8)
    num_rows = int(rows.shape[0])

    data_out = [np.zeros(num_rows * w, dtype=np.uint8) for w in widths]
    valid_out = [np.zeros(num_rows, dtype=np.uint8) for _ in range(n_cols)]
    data_ptrs = (ctypes.c_void_p * n_cols)(
        *[b.ctypes.data_as(ctypes.c_void_p).value for b in data_out]
    )
    valid_ptrs = (ctypes.POINTER(ctypes.c_uint8) * n_cols)(
        *[v.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)) for v in valid_out]
    )
    _check(
        lib.srt_unpack_rows(
            ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            n_cols,
            rows.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.c_int64(num_rows),
            data_ptrs,
            valid_ptrs,
        )
    )
    return data_out, valid_out


# ---------------------------------------------------------------------------
# handle registry
# ---------------------------------------------------------------------------

def buffer_create(data: bytes, tag: str = "") -> int:
    lib = load()
    h = lib.srt_buffer_create(data, len(data), tag.encode())
    if h == 0:
        _check(1)
    return h


def buffer_release(handle: int) -> None:
    _check(load().srt_buffer_release(handle))


def buffer_retain(handle: int) -> None:
    _check(load().srt_buffer_retain(handle))


def buffer_bytes(handle: int) -> bytes:
    lib = load()
    size = lib.srt_buffer_size(handle)
    if size < 0:
        _check(5)
    if size == 0:
        return b""
    ptr = lib.srt_buffer_data(handle)
    return ctypes.string_at(ptr, size)


def live_handle_count() -> int:
    return load().srt_live_handle_count()


def set_refcount_debug(enabled: bool) -> None:
    load().srt_set_refcount_debug(1 if enabled else 0)


def leak_report() -> str:
    lib = load()
    needed = lib.srt_leak_report(None, 0)
    buf = ctypes.create_string_buffer(int(needed))
    lib.srt_leak_report(buf, needed)
    return buf.value.decode()


# ---------------------------------------------------------------------------
# the embedded device runtime (src/cpp/torch_runtime.cpp)
#
# From this (Python) process the library JOINS the live interpreter, so a
# ctypes round trip through these functions runs the native code path a
# JVM embedder takes, minus the interpreter's start. The names keep the
# JAX module's: their "jax" is the C ABI's name (srt_jax_*).
# ---------------------------------------------------------------------------

def jax_runtime_available() -> bool:
    return available() and load().srt_jax_available() == 1


def jax_init() -> None:
    _check(load().srt_jax_init())


def jax_platform() -> str:
    lib = load()
    buf = ctypes.create_string_buffer(64)
    _check(lib.srt_jax_platform(buf, 64))
    return buf.value.decode()


def jax_table_op(
    op_json: str,
    type_ids: Sequence[int],
    scales: Sequence[int],
    col_data: Sequence[int],
    col_valid: Sequence[Optional[int]],
    num_rows: int,
    max_out_columns: int = 64,
):
    """Dispatch a table op to the device runtime via registry handles
    (on the device ``SPARK_RAPIDS_TPU_DEVICE`` named at init).

    -> (out_type_ids, out_scales, out_data_handles, out_valid_handles,
    out_num_rows); output handles are owned by the caller.
    """
    lib = load()
    n = len(type_ids)
    if not (len(scales) == len(col_data) == len(col_valid) == n):
        # ctypes zero-fills short initializer lists, which would turn a
        # caller bug into silently-wrong scales/validity
        raise ValueError(
            "jax_table_op: type_ids/scales/col_data/col_valid lengths "
            f"differ ({n}/{len(scales)}/{len(col_data)}/{len(col_valid)})"
        )
    ids = (ctypes.c_int32 * n)(*type_ids)
    scl = (ctypes.c_int32 * n)(*scales)
    hd = (ctypes.c_int64 * n)(*col_data)
    hv = (ctypes.c_int64 * n)(*[v or 0 for v in col_valid])
    out_ids = (ctypes.c_int32 * max_out_columns)()
    out_scl = (ctypes.c_int32 * max_out_columns)()
    out_hd = (ctypes.c_int64 * max_out_columns)()
    out_hv = (ctypes.c_int64 * max_out_columns)()
    out_cols = ctypes.c_int32(0)
    out_rows = ctypes.c_int64(0)
    _check(
        lib.srt_jax_table_op(
            op_json.encode(),
            ids,
            scl,
            n,
            hd,
            hv,
            ctypes.c_int64(num_rows),
            max_out_columns,
            out_ids,
            out_scl,
            ctypes.byref(out_cols),
            out_hd,
            out_hv,
            ctypes.byref(out_rows),
        )
    )
    m = out_cols.value
    return (
        list(out_ids[:m]),
        list(out_scl[:m]),
        list(out_hd[:m]),
        [h if h != 0 else None for h in out_hv[:m]],
        out_rows.value,
    )


# ---------------------------------------------------------------------------
# Device-resident table chaining: upload once, chain ops over resident
# table ids, download once (the reference's device-pointer handle model,
# RowConversionJni.cpp:31,54).
# ---------------------------------------------------------------------------

def jax_table_upload(
    type_ids: Sequence[int],
    scales: Sequence[int],
    col_data: Sequence[int],
    col_valid: Sequence[Optional[int]],
    num_rows: int,
) -> int:
    """Host buffer handles -> device-resident table id."""
    lib = load()
    n = len(type_ids)
    if not (len(scales) == len(col_data) == len(col_valid) == n):
        raise ValueError("jax_table_upload: column array lengths differ")
    ids = (ctypes.c_int32 * n)(*type_ids)
    scl = (ctypes.c_int32 * n)(*scales)
    hd = (ctypes.c_int64 * n)(*col_data)
    hv = (ctypes.c_int64 * n)(*[v or 0 for v in col_valid])
    out = ctypes.c_int64(0)
    _check(
        lib.srt_jax_table_upload(
            ids, scl, n, hd, hv, ctypes.c_int64(num_rows),
            ctypes.byref(out),
        )
    )
    return out.value


def jax_table_op_resident(op_json: str, inputs: Sequence[int]) -> int:
    """One device op over resident tables; result stays resident."""
    lib = load()
    n = len(inputs)
    arr = (ctypes.c_int64 * n)(*inputs)
    out = ctypes.c_int64(0)
    _check(
        lib.srt_jax_table_op_resident(
            op_json.encode(), arr, n, ctypes.byref(out)
        )
    )
    return out.value


def jax_table_download(table: int, max_out_columns: int = 64):
    """Resident table -> (ids, scales, data handles, valid handles, rows);
    output handles are owned by the caller."""
    lib = load()
    out_ids = (ctypes.c_int32 * max_out_columns)()
    out_scl = (ctypes.c_int32 * max_out_columns)()
    out_hd = (ctypes.c_int64 * max_out_columns)()
    out_hv = (ctypes.c_int64 * max_out_columns)()
    out_cols = ctypes.c_int32(0)
    out_rows = ctypes.c_int64(0)
    _check(
        lib.srt_jax_table_download(
            ctypes.c_int64(table), max_out_columns, out_ids, out_scl,
            ctypes.byref(out_cols), out_hd, out_hv, ctypes.byref(out_rows),
        )
    )
    m = out_cols.value
    return (
        list(out_ids[:m]),
        list(out_scl[:m]),
        list(out_hd[:m]),
        [h if h != 0 else None for h in out_hv[:m]],
        out_rows.value,
    )


def jax_table_num_rows(table: int) -> int:
    lib = load()
    out = ctypes.c_int64(0)
    _check(lib.srt_jax_table_num_rows(ctypes.c_int64(table), ctypes.byref(out)))
    return out.value


def jax_table_free(table: int) -> None:
    lib = load()
    _check(lib.srt_jax_table_free(ctypes.c_int64(table)))


def jax_resident_table_count() -> int:
    lib = load()
    out = ctypes.c_int64(0)
    _check(lib.srt_jax_resident_table_count(ctypes.byref(out)))
    return out.value
