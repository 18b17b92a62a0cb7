#!/usr/bin/env python3
"""Lay out the tree of the ``cuda12`` jar: the PyTorch/CUDA port with its
native shim and its prebuilt sm_90a kernels.

    python3 spark-rapids-tpu-runtime/stage_cuda.py \\
        --lib build/torch_cmake/libspark_rapids_tpu.so \\
        --kernels KDIR --out OUT [--version V] \\
        [--native-demo PATH --jni-harness PATH]

``--lib`` is the shim built with ``SRT_RUNTIME=torch``
(``src/CMakeLists.txt``); it must carry the port's marker
``srt_runtime_package()``. ``KDIR`` is the output of
``python -m spark_rapids_jni_tpu_torch.kernels build --out KDIR``. OUT
gets:

    <os.arch>/<os.name>/libspark_rapids_tpu.so    the NativeDepsLoader path
    python/spark_rapids_jni_tpu_torch/**           .py and csrc/ sources
    python/build/torch_kernels/<hash>/lib*.so      the kernels, prebuilt
    python/env/requirements-pin-cuda.txt
    spark-rapids-tpu-runtime-version-info.properties

and, where given, the two native test programs beside the library (they
load it through ``$ORIGIN``; the jar is built without them). Nothing of
the JAX package is staged. An executor that unpacks ``python/`` and
points ``SRT_PYTHONPATH`` at it loads the kernels without ``nvcc``: the
hash is over the staged ``csrc/``, which is copied byte for byte.

The Maven profile ``cuda``, ``ci/premerge-build-cuda.sh``,
``chip_smoke.py`` (x) and ``tests/test_torch_artifact.py`` all stage
through this script. The last line of its output is one JSON object:
the tree's root, its file count and bytes, and the kernel directory.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import platform
import re
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
PACKAGE = "spark_rapids_jni_tpu_torch"
LIB_NAME = "libspark_rapids_tpu.so"  # what NativeLibraryLoader asks for
PIN_FILE = "env/requirements-pin-cuda.txt"
PROPERTIES = "spark-rapids-tpu-runtime-version-info.properties"
CLASSIFIER = "cuda12"
SM = "90a"
CSRC_SUFFIXES = (".cu", ".cuh", ".h")  # what the kernels' hash reads
JAVA_ARCH = {"x86_64": "amd64"}  # Java's os.arch where it is not uname's


class StageError(RuntimeError):
    """An input of the staging is missing or is not the port's."""


def native_dir() -> str:
    """``${os.arch}/${os.name}`` as a JVM on this machine spells them."""
    machine = platform.machine()
    return f"{JAVA_ARCH.get(machine, machine)}/{platform.system()}"


def check_marker(lib: Path) -> None:
    """The library must be the port's shim: a JAX shim would import the
    JAX package into the executor (``utils/native.py`` refuses it too)."""
    try:
        handle = ctypes.CDLL(str(lib))
        marker = handle.srt_runtime_package
    except (OSError, AttributeError) as e:
        raise StageError(f"{lib} is not the port's native shim: {e}")
    marker.restype = ctypes.c_char_p
    got = marker().decode()
    if got != PACKAGE:
        raise StageError(f"{lib} embeds {got!r}, not {PACKAGE!r}")


def package_files() -> list:
    """The port's sources, relative to the repository root."""
    root = REPO / PACKAGE
    out = []
    for p in sorted(root.rglob("*")):
        rel = p.relative_to(root)
        if not p.is_file() or "__pycache__" in rel.parts:
            continue
        csrc = len(rel.parts) > 1 and rel.parts[0] == "csrc"
        if p.suffix in (CSRC_SUFFIXES if csrc else (".py",)):
            out.append(p.relative_to(REPO))
    return out


def kernel_layout(python_dir: Path) -> dict:
    """The staged package's own answer to where its kernels load from
    (``kernels.layout()``), run on the staged tree alone: its import
    proves the staged sources are whole."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "PYTHONHOME")}
    env["PYTHONPATH"] = str(python_dir)
    env["PYTHONDONTWRITEBYTECODE"] = "1"  # no __pycache__ in the jar
    proc = subprocess.run(
        [sys.executable, "-P", "-m", f"{PACKAGE}.kernels", "layout"],
        cwd=python_dir, env=env, capture_output=True, text=True)
    if proc.returncode != 0:
        raise StageError("the staged package does not import:\n"
                         + proc.stderr[-4000:])
    return json.loads(proc.stdout.strip().splitlines()[-1])


def nvcc_version() -> str:
    """``V12.4.131`` of ``nvcc --version`` -> ``12.4.131``."""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    try:
        out = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True, check=True).stdout
    except (OSError, subprocess.CalledProcessError) as e:
        raise StageError(f"nvcc --version gives cuda_version: {e}")
    m = re.search(r"\bV(\d+\.\d+(?:\.\d+)?)", out) or \
        re.search(r"release (\d+\.\d+)", out)
    if m is None:
        raise StageError(f"no CUDA version in nvcc --version:\n{out}")
    return m.group(1)


def pom_version() -> str:
    text = (REPO / "pom.xml").read_text()
    m = re.search(r"<artifactId>spark-rapids-tpu-parent</artifactId>\s*"
                  r"<version>([^<]+)</version>", text)
    if m is None:
        raise StageError("no version in pom.xml")
    return m.group(1)


def prepare(out: Path) -> None:
    """An empty ``out``; an earlier staging there is replaced, anything
    else is refused."""
    if out.exists() and any(out.iterdir()):
        if not (out / "python" / PACKAGE / "__init__.py").exists():
            raise StageError(f"{out} is not empty and holds no staging")
        shutil.rmtree(out)
    out.mkdir(parents=True, exist_ok=True)


def stage(lib: Path, kernels: Path, out: Path, version: str,
          programs: dict) -> dict:
    check_marker(lib)
    prepare(out)
    python_dir = out / "python"
    for rel in package_files():
        dst = python_dir / rel
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy2(REPO / rel, dst)
    pin = python_dir / PIN_FILE
    pin.parent.mkdir(parents=True)
    shutil.copy2(REPO / PIN_FILE, pin)

    layout = kernel_layout(python_dir)
    src_dir = kernels / layout["dir"]
    missing = [n for n in layout["libraries"] if not (src_dir / n).is_file()]
    if missing:
        raise StageError(f"{src_dir} lacks {missing}: build the kernels "
                         f"of this csrc/ with `python -m {PACKAGE}.kernels "
                         f"build --out {kernels}`")
    dst_dir = python_dir / layout["dir"]
    dst_dir.mkdir(parents=True)
    for name in layout["libraries"]:
        shutil.copy2(src_dir / name, dst_dir / name)
        ptxas = src_dir / name.replace(".so", ".ptxas.txt")
        if ptxas.is_file():
            shutil.copy2(ptxas, dst_dir / ptxas.name)

    lib_dir = out / native_dir()
    lib_dir.mkdir(parents=True)
    shutil.copy2(lib, lib_dir / LIB_NAME)
    for name, path in programs.items():
        shutil.copy2(path, lib_dir / name)

    props = subprocess.run(
        ["bash", str(REPO / "build" / "build-info"), version, str(REPO),
         f"tpu_platform={CLASSIFIER}", "runtime=torch",
         f"cuda_version={nvcc_version()}", f"sm={SM}"],
        capture_output=True, text=True)
    if props.returncode != 0:
        raise StageError("build/build-info failed:\n" + props.stderr)
    (out / PROPERTIES).write_text(props.stdout)

    files = [p for p in out.rglob("*") if p.is_file()]
    return {"out": str(out), "files": len(files),
            "bytes": sum(p.stat().st_size for p in files),
            "lib": str((lib_dir / LIB_NAME).relative_to(out)),
            "kernels_dir": str(dst_dir.relative_to(out))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lib", required=True, type=Path,
                    help="the port's native shim (SRT_RUNTIME=torch)")
    ap.add_argument("--kernels", required=True, type=Path,
                    help="the --out directory of the kernels' build")
    ap.add_argument("--out", required=True, type=Path)
    ap.add_argument("--version", help="default: the root pom's")
    ap.add_argument("--native-demo", type=Path)
    ap.add_argument("--jni-harness", type=Path)
    args = ap.parse_args(argv)
    programs = {name: path for name, path in
                (("native_demo", args.native_demo),
                 ("jni_harness", args.jni_harness)) if path is not None}
    try:
        rec = stage(args.lib.resolve(), args.kernels.resolve(),
                    args.out.resolve(), args.version or pom_version(),
                    programs)
    except StageError as e:
        print(f"stage_cuda: {e}", file=sys.stderr)
        return 1
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
