"""Hand-written Hopper kernels of the port, and their build.

Each TPU kernel of the JAX package (``spark_rapids_jni_tpu/kernels``) on
the port's path has a CUDA C++ counterpart under ``csrc/``, compiled for
``sm_90a`` with ``nvcc`` into a shared library with a plain C interface
and loaded with ``ctypes`` — a few seconds per source, where a build
through PyTorch's extension headers takes minutes.

The build runs at the first CUDA use, never at import: every source is
compiled by its own ``nvcc``, all started together, into
``build/torch_kernels/<hash of the sources and flags>/`` beside the
package. Nothing is downloaded and nothing outside the repository is
used. Where that directory already holds every library (the ``cuda12``
jar ships it prebuilt), nothing is compiled and no ``nvcc`` is needed:

    python -m spark_rapids_jni_tpu_torch.kernels build --out DIR

builds them into ``DIR/build/torch_kernels/<hash>/``, where they load
once the package sits in ``DIR/`` with ``csrc/`` unchanged, and
``... kernels layout`` prints that directory and the libraries' names.

Beside every kernel its module keeps a plain PyTorch version of the same
function. A wrapper runs the plain version only for tensors on the CPU;
for CUDA tensors it launches the kernel or raises. Each wrapper counts
its launches in a :class:`KernelInfo` (:meth:`KernelInfo.count`, under a
lock), so a run can show that its path went through the kernels.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import json
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "torch_kernels"
SOURCES = ("row_transpose", "hash_table", "murmur3", "radix_sort", "scan16")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOCK = threading.Lock()
_LIBS: dict = {}


@dataclasses.dataclass
class KernelInfo:
    """One hand-written kernel: where it lives, which TPU kernel it
    replaces, and how many times its wrapper launched it."""

    name: str
    source: str
    replaces: str
    launches: int = 0

    def count(self) -> None:
        """Count one launch (under a lock: pipeline workers and the
        caller's thread launch kernels at the same time, and ``+= 1`` on
        a shared int can lose one)."""
        with _COUNT_LOCK:
            self.launches += 1


KERNELS: dict = {}
_COUNT_LOCK = threading.Lock()


def register(name: str, source: str, replaces: str) -> KernelInfo:
    info = KERNELS[name] = KernelInfo(name, source, replaces)
    return info


def reset_launches() -> None:
    with _COUNT_LOCK:
        for info in KERNELS.values():
            info.launches = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the port's CUDA kernels are built from csrc/ "
            "with the CUDA toolkit"
        )
    return path


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh", ".h"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build_dir(root=None) -> Path:
    """``<root>/<hash of csrc/ and NVCC_FLAGS>``; ``root`` defaults to
    :data:`BUILD_ROOT`, the one the wrappers load from."""
    return Path(root if root is not None else BUILD_ROOT) / _digest()


def build_all(root=None) -> dict:
    """Compile every source that is not built yet (one ``nvcc`` each, all
    started together) into :func:`build_dir`; returns ``{name: path of
    its .so}``. Where every library is there it writes nothing and never
    looks for ``nvcc``."""
    out_dir = build_dir(root)
    paths = {name: out_dir / f"lib{name}.so" for name in SOURCES}
    todo = [n for n in SOURCES if not paths[n].exists()]
    if not todo:
        return paths
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name in todo:
        tmp = out_dir / f"lib{name}.{os.getpid()}.tmp.so"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )))
    failed = []
    for name, tmp, proc in procs:  # wait for every compiler before raising
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{err}")
        else:
            (out_dir / f"lib{name}.ptxas.txt").write_text(err)
            os.replace(tmp, paths[name])
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return paths


def ptxas_info(name: str) -> str:
    """What ``nvcc -Xptxas -v`` reported when it built ``csrc/<name>.cu``
    (each kernel's registers, shared memory and spills); build_all first."""
    return (build_dir() / f"lib{name}.ptxas.txt").read_text()


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu`` (built on first
    use, together with every other source)."""
    with _LOCK:
        if not _LIBS:
            for n, p in build_all().items():
                _LIBS[n] = ctypes.CDLL(str(p))
        return _LIBS[name]


def check_status(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a C entry point."""
    if rc != 0:
        msg = lib.srt_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc}: {msg}")


def stream_of(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def require_cuda(t: torch.Tensor, name: str, dtype: torch.dtype, shape=None):
    """Validate a tensor handed to a CUDA kernel (on every launch, so it
    reads only attributes that build no Python object: ``is_cuda``, not
    ``device``)."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if shape is not None and t.shape != tuple(shape):
        raise ValueError(f"{name} shape {tuple(t.shape)} != {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def layout() -> dict:
    """Where the libraries load from, relative to the package's parent
    directory, and their file names."""
    return {"dir": str(build_dir().relative_to(_PKG.parent)),
            "libraries": [f"lib{name}.so" for name in SOURCES]}


def main(argv=None) -> int:
    """``build --out DIR``: build every library into
    ``DIR/build/torch_kernels/<hash>/``; ``layout``: print
    :func:`layout`. Each prints one JSON line."""
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m spark_rapids_jni_tpu_torch.kernels",
        description="Build the port's CUDA kernels ahead of their use.")
    sub = ap.add_subparsers(dest="cmd", required=True)
    b = sub.add_parser("build", help="compile csrc/ with nvcc into "
                       "OUT/build/torch_kernels/<hash>/")
    b.add_argument("--out", required=True, type=Path)
    sub.add_parser("layout", help="print the library directory and names")
    args = ap.parse_args(argv)
    if args.cmd == "layout":
        print(json.dumps(layout()))
        return 0
    root = args.out.resolve() / BUILD_ROOT.relative_to(_PKG.parent)
    paths = build_all(root)
    print(json.dumps({"dir": str(build_dir(root)),
                      "libraries": sorted(p.name for p in paths.values())}))
    return 0
