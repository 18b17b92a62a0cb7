"""The ``cuda12`` jar's tree on the CPU: the native build's runtime
choice (``src/CMakeLists.txt`` ``SRT_RUNTIME``), the staging script
(``spark-rapids-tpu-runtime/stage_cuda.py``), the kernels' build entry,
the ``cuda`` Maven profile, ``ci/deploy.sh`` and the card's premerge
gate.

* A module fixture builds the port's shim with CMake
  (``-DSRT_RUNTIME=torch``, warnings as errors) into a temporary
  directory, never ``build/``, and stages the jar's tree from it. There
  is no ``nvcc`` here, so the kernel directory holds empty stand-ins
  where the kernels' build puts the five libraries (nothing on the CPU
  loads them), and a stand-in ``nvcc`` reports a version for the
  properties.
* The staged ``native_demo``/``jni_harness`` pass in HOST mode on the
  CPU, and a child whose ``sys.path`` holds the staged ``python/`` and
  site-packages alone (``chip_smoke.py --artifact-child``, the child of
  the card's phase (x)) runs (v)'s plan through the staged library: its
  bytes equal the JAX package's ``runtime_bridge.table_op_wire`` in this
  process at 1023/1024/1025 rows.
"""

import ctypes
import json
import os
import pathlib
import shutil
import subprocess
import sys
import sysconfig
import xml.etree.ElementTree as ET

import numpy as np
import pytest

import chip_smoke
from spark_rapids_jni_tpu import runtime_bridge as jrb
from spark_rapids_jni_tpu_torch import kernels
from spark_rapids_jni_tpu_torch import runtime_bridge as rb

ROOT = pathlib.Path(__file__).resolve().parent.parent
STAGE = ROOT / "spark-rapids-tpu-runtime" / "stage_cuda.py"
PORT = "spark_rapids_jni_tpu_torch"
NS = {"m": "http://maven.apache.org/POM/4.0.0"}
NVCC_VERSION = "12.4.131"
ROWS = (1023, 1024, 1025)


def _missing() -> str:
    for tool in ("cmake", "g++"):
        if shutil.which(tool) is None:
            return tool
    inc = pathlib.Path(sysconfig.get_paths()["include"]) / "Python.h"
    return "" if inc.exists() else str(inc)


_MISSING = _missing()
needs_toolchain = pytest.mark.skipif(
    bool(_MISSING), reason=f"the native build needs {_MISSING}")


def _cmake(*args, cwd=None):
    return subprocess.run(["cmake", *map(str, args)], capture_output=True,
                          text=True, cwd=cwd)


@pytest.fixture(autouse=True)
def _registries_unchanged():
    before = (len(rb._RESIDENT), jrb.resident_table_count())
    yield
    assert (len(rb._RESIDENT), jrb.resident_table_count()) == before


@pytest.fixture(scope="module")
def shim(tmp_path_factory):
    """The port's shim, native_demo and jni_harness, built by CMake."""
    if _MISSING:
        pytest.skip(f"the native build needs {_MISSING}")
    out = tmp_path_factory.mktemp("torch_cmake")
    conf = _cmake("-S", ROOT / "src", "-B", out, "-DSRT_RUNTIME=torch",
                  f"-DPython3_EXECUTABLE={sys.executable}")
    assert conf.returncode == 0, conf.stdout + conf.stderr
    build = _cmake("--build", out, "--parallel", "4")
    assert build.returncode == 0, build.stdout + build.stderr
    return {"dir": out, "log": conf.stdout + build.stdout + build.stderr,
            "lib": out / "libspark_rapids_tpu.so",
            "native_demo": out / "native_demo",
            "jni_harness": out / "jni_harness"}


@pytest.fixture(scope="module")
def fake_nvcc(tmp_path_factory):
    """A PATH whose ``nvcc`` prints a version line, as the toolkit's."""
    d = tmp_path_factory.mktemp("fake_nvcc")
    nvcc = d / "nvcc"
    nvcc.write_text("#!/bin/sh\necho 'Cuda compilation tools, release "
                    f"12.4, V{NVCC_VERSION}'\n")
    nvcc.chmod(0o755)
    return f"{d}{os.pathsep}{os.environ.get('PATH', '')}"


def _stand_in_kernels(root: pathlib.Path) -> pathlib.Path:
    """Empty files where ``kernels build --out root`` puts the libraries."""
    lay = kernels.layout()
    d = root / lay["dir"]
    d.mkdir(parents=True)
    for name in lay["libraries"]:
        (d / name).write_bytes(b"")
    return d


def _stage(lib, kdir, out, path, programs=None):
    cmd = [sys.executable, str(STAGE), "--lib", str(lib), "--kernels",
           str(kdir), "--out", str(out)]
    for name, p in (programs or {}).items():
        cmd += [f"--{name.replace('_', '-')}", str(p)]
    return subprocess.run(cmd, capture_output=True, text=True,
                          env=dict(os.environ, PATH=path))


@pytest.fixture(scope="module")
def staged(shim, fake_nvcc, tmp_path_factory):
    kdir = tmp_path_factory.mktemp("kernels")
    _stand_in_kernels(kdir)
    out = tmp_path_factory.mktemp("stage") / "jar"
    proc = _stage(shim["lib"], kdir, out, fake_nvcc,
                  {"native_demo": shim["native_demo"],
                   "jni_harness": shim["jni_harness"]})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    assert pathlib.Path(rec["out"]) == out
    return {"out": out, "rec": rec, "python": out / "python",
            "lib": out / rec["lib"], "lib_dir": (out / rec["lib"]).parent}


# ---------------------------------------------------------------------------
# the native build
# ---------------------------------------------------------------------------

def test_torch_runtime_builds_warning_clean(shim):
    flags = (shim["dir"] / "CMakeFiles" / "spark_rapids_tpu.dir"
             / "flags.make").read_text()
    assert all(f in flags for f in ("-Wall", "-Wextra", "-Werror"))
    assert "warning" not in shim["log"].lower()
    sources = (shim["dir"] / "CMakeFiles" / "spark_rapids_tpu.dir"
               / "build.make").read_text()
    assert "torch_runtime.cpp" in sources
    assert "jax_runtime.cpp" not in sources
    lib = ctypes.CDLL(str(shim["lib"]))
    lib.srt_runtime_package.restype = ctypes.c_char_p
    assert lib.srt_runtime_package().decode() == PORT


@needs_toolchain
def test_default_configure_keeps_the_jax_runtime(tmp_path):
    conf = _cmake("-S", ROOT / "src", "-B", tmp_path)
    assert conf.returncode == 0, conf.stdout + conf.stderr
    sources = (tmp_path / "CMakeFiles" / "spark_rapids_tpu.dir"
               / "build.make").read_text()
    assert "jax_runtime.cpp" in sources
    assert "torch_runtime.cpp" not in sources
    assert "SRT_RUNTIME:STRING=jax" in (tmp_path / "CMakeCache.txt").read_text()


@needs_toolchain
def test_unknown_runtime_is_refused(tmp_path):
    conf = _cmake("-S", ROOT / "src", "-B", tmp_path, "-DSRT_RUNTIME=tpu")
    assert conf.returncode != 0
    assert "SRT_RUNTIME must be jax or torch" in conf.stderr


def test_build_native_refuses_an_unknown_runtime():
    proc = subprocess.run(
        ["bash", "spark-rapids-tpu-runtime/build-native.sh"], cwd=ROOT,
        capture_output=True, text=True,
        env=dict(os.environ, SRT_RUNTIME="tpu"))
    assert proc.returncode == 2
    assert "SRT_RUNTIME must be jax or torch" in proc.stderr


# ---------------------------------------------------------------------------
# the kernels' build entry
# ---------------------------------------------------------------------------

def test_kernel_layout_is_the_build_directory(capsys):
    assert kernels.main(["layout"]) == 0
    lay = json.loads(capsys.readouterr().out)
    assert lay == kernels.layout()
    assert ROOT / lay["dir"] == kernels.build_dir()
    assert lay["dir"].startswith("build/torch_kernels/")
    assert lay["libraries"] == [f"lib{n}.so" for n in kernels.SOURCES]


def test_built_kernels_load_without_nvcc(tmp_path, monkeypatch):
    """Where every library is there, the build compiles nothing, writes
    nothing and never looks for ``nvcc``."""
    d = _stand_in_kernels(tmp_path)
    before = {p.name: p.stat().st_mtime_ns for p in d.iterdir()}

    def no_nvcc():
        raise AssertionError("looked for nvcc")

    monkeypatch.setattr(kernels, "_nvcc", no_nvcc)
    root = tmp_path / "build" / "torch_kernels"
    paths = kernels.build_all(root)
    assert {p.parent for p in paths.values()} == {d}
    assert {p.name: p.stat().st_mtime_ns for p in d.iterdir()} == before
    assert kernels.main(["build", "--out", str(tmp_path)]) == 0


# ---------------------------------------------------------------------------
# the staged tree
# ---------------------------------------------------------------------------

def test_staged_tree_layout(staged):
    out = staged["out"]
    files = {p.relative_to(out).as_posix() for p in out.rglob("*")
             if p.is_file()}
    lib = staged["rec"]["lib"]
    assert lib.endswith("/libspark_rapids_tpu.so")
    if os.uname().machine == "x86_64":
        assert lib == "amd64/Linux/libspark_rapids_tpu.so"
    lib_dir = lib.rsplit("/", 1)[0]
    lay = kernels.layout()
    want = {lib, f"{lib_dir}/native_demo", f"{lib_dir}/jni_harness",
            "python/env/requirements-pin-cuda.txt",
            "spark-rapids-tpu-runtime-version-info.properties"}
    want |= {f"python/{lay['dir']}/{n}" for n in lay["libraries"]}
    port = ROOT / PORT
    sources = {p.relative_to(ROOT).as_posix() for p in port.rglob("*")
               if p.is_file() and "__pycache__" not in p.parts
               and p.suffix in (".py", ".cu", ".cuh", ".h")}
    want |= {f"python/{s}" for s in sources}
    assert files == want
    assert staged["rec"]["files"] == len(want)
    assert staged["rec"]["kernels_dir"] == f"python/{lay['dir']}"
    for s in sources:  # byte for byte: the kernels' hash is over csrc/
        assert (staged["python"] / s).read_bytes() == (ROOT / s).read_bytes()
    assert not any("spark_rapids_jni_tpu" in f.split("/") for f in files)
    assert (staged["python"] / "env" / "requirements-pin-cuda.txt"
            ).read_text() == (ROOT / "env" / "requirements-pin-cuda.txt"
                              ).read_text()


def test_staged_properties(staged):
    props = dict(line.split("=", 1) for line in (
        staged["out"] / "spark-rapids-tpu-runtime-version-info.properties"
    ).read_text().splitlines())
    root = ET.parse(ROOT / "pom.xml").getroot()
    assert props["version"] == root.find("m:version", NS).text
    assert props["tpu_platform"] == "cuda12"
    assert props["runtime"] == "torch"
    assert props["cuda_version"] == NVCC_VERSION
    assert props["sm"] == "90a"


@pytest.mark.parametrize("broken", ["jax_library", "no_kernels"])
def test_staging_refuses_what_is_not_the_port(shim, fake_nvcc, tmp_path,
                                              broken):
    kdir = tmp_path / "kernels"
    kdir.mkdir()
    lib = shim["lib"]
    if broken == "jax_library":  # the C ABI without the port's marker
        _stand_in_kernels(kdir)
        src = tmp_path / "other.cpp"
        src.write_text('extern "C" int srt_jax_available(void) '
                       '{ return 1; }\n')
        lib = tmp_path / "libspark_rapids_tpu.so"
        subprocess.run(["g++", "-shared", "-fPIC", "-o", str(lib), str(src)],
                       check=True)
    proc = _stage(lib, kdir, tmp_path / "jar", fake_nvcc)
    assert proc.returncode == 1
    assert ("not the port's native shim" if broken == "jax_library"
            else "lacks") in proc.stderr


@pytest.mark.parametrize("prog", ["native_demo", "jni_harness"])
def test_staged_programs_run_on_cpu(staged, prog):
    env = chip_smoke.artifact_env(str(staged["python"]), "cpu")
    proc = subprocess.run([str(staged["lib_dir"] / prog)], env=env,
                          cwd=staged["out"], capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "platform = cpu" in proc.stdout
    assert proc.stdout.rstrip().endswith(": ok")


def _fact(n: int) -> dict:
    """(a)'s batch shape at ``n`` rows, from a seed."""
    return chip_smoke.make_query_data(np.random.default_rng(n), n, 100)


@pytest.fixture(scope="module")
def child(staged, tmp_path_factory):
    """One child on the staged tree alone: (v)'s plan op by op and as a
    resident chain at each of ``ROWS``."""
    jobs = []
    for n in ROWS:
        wire = _fact(n)["fact_wire"]
        jobs += [{"name": f"ops{n}", "mode": "ops",
                  "ops": chip_smoke.NATIVE_PLAN, "wire": wire},
                 {"name": f"chain{n}", "mode": "chain",
                  "ops": chip_smoke.NATIVE_PLAN, "wire": wire}]
    rec = chip_smoke.run_artifact_child(
        str(staged["out"]), str(staged["lib"]), "cpu", jobs,
        str(tmp_path_factory.mktemp("child")))
    chip_smoke.check_artifact_child(rec, str(staged["python"]),
                                    str(staged["lib"]), "cpu")
    return rec


@pytest.mark.parametrize("n", ROWS)
def test_staged_child_matches_jax(child, n):
    d = _fact(n)
    ref = [d["fact_wire"]]
    for op in chip_smoke.NATIVE_PLAN:
        ref.append(jrb.table_op_wire(json.dumps(op), *ref[-1]))
    assert ref[-1][4] == int(d["keep"].sum())
    want = [chip_smoke.wire_digest(w) for w in ref[1:]]
    assert child["jobs"][f"ops{n}"]["digests"] == want
    assert child["jobs"][f"chain{n}"]["digests"] == want[-1:]


def test_staged_child_runs_on_the_staged_tree_alone(child, staged):
    assert child["file"] == str(staged["python"] / PORT / "__init__.py")
    assert str(ROOT) not in child["sys_path"]
    assert child["jax_modules"] == []
    # the shim's build tree is not consulted where the sources are absent
    assert not (staged["python"] / "build" / "torch_native").exists()


def test_staged_tree_without_a_library_names_it(staged):
    """On the staged tree alone with no ``SPARK_RAPIDS_TPU_NATIVE_LIB``,
    the loader has no sources to build from and says so."""
    code = ("from spark_rapids_jni_tpu_torch.utils import native\n"
            "try:\n    native.load()\n"
            "except native.NativeBuildError as e:\n    print(e)\n")
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "SPARK_RAPIDS_TPU_NATIVE_LIB")}
    env["PYTHONPATH"] = str(staged["python"])
    proc = subprocess.run([sys.executable, "-P", "-c", code], env=env,
                          cwd=staged["out"], capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "no shim sources" in proc.stdout
    assert "SPARK_RAPIDS_TPU_NATIVE_LIB" in proc.stdout


# ---------------------------------------------------------------------------
# packaging: the Maven profile, deploy.sh, the card's premerge gate
# ---------------------------------------------------------------------------

def _profile(pom: pathlib.Path, pid: str):
    root = ET.parse(pom).getroot()
    for p in root.findall("m:profiles/m:profile", NS):
        if p.find("m:id", NS).text == pid:
            return root, p
    raise AssertionError(f"{pom}: no profile {pid}")


def _executions(node):
    return {e.find("m:id", NS).text: e
            for e in node.iter(f"{{{NS['m']}}}execution")}


def test_cuda_profile_jars_the_staged_tree():
    root, prof = _profile(ROOT / "pom.xml", "cuda")
    assert root.find("m:properties/m:TPU_PLATFORM", NS).text == "v5e"
    assert prof.find("m:properties/m:TPU_PLATFORM", NS).text == "cuda12"

    rt = ROOT / "spark-rapids-tpu-runtime" / "pom.xml"
    _, prof = _profile(rt, "cuda")
    props = {p.tag.split("}")[1]: p.text
             for p in prof.find("m:properties", NS)}
    ex = _executions(prof)
    args = [a.text for a in ex["stage-cuda"].iter(f"{{{NS['m']}}}argument")]
    assert args[0].endswith("/stage_cuda.py")
    out = args[args.index("--out") + 1]
    assert out == "${cuda.stage.dir}"
    assert args[args.index("--kernels") + 1] == "${cuda.kernels.dir}"
    assert args[args.index("--lib") + 1].endswith(
        "/build/torch_cmake/libspark_rapids_tpu.so")
    kargs = [a.text for a in ex["build-kernels"].iter(
        f"{{{NS['m']}}}argument")]
    assert kargs == ["-m", "spark_rapids_jni_tpu_torch.kernels", "build",
                     "--out", "${cuda.kernels.dir}"]
    dirs = [d.text for d in ex["stage-cuda-tree"].iter(
        f"{{{NS['m']}}}directory")]
    assert dirs == [out]
    assert props["cuda.stage.dir"].startswith("${project.build.directory}")
    for off in ("stage-native-and-python", "build-info"):
        assert ex[off].find("m:phase", NS).text == "none"
    # its own build directory: neither jar picks up the other's classes/
    assert prof.find("m:build/m:directory", NS).text == \
        "${project.basedir}/target/cuda12"
    # the inherited python-tests runs the port's card tests, not tests/
    targs = [a.text for a in ex["python-tests"].iter(
        f"{{{NS['m']}}}argument")]
    assert targs[:2] == ["-m", "pytest"] and "tests/" not in targs
    files = [a for a in targs if a.startswith("tests/")]
    assert files and all(a.startswith("tests/test_torch_") for a in files)
    assert all((ROOT / a).is_file() for a in files)
    assert targs[targs.index("-m", 1) + 1] == "cuda"
    env = ex["build-native"].find("m:configuration/m:environmentVariables",
                                  NS)
    assert env.find("m:SRT_RUNTIME", NS).text == "torch"
    assert [a.text for a in ex["dependency-check"].iter(
        f"{{{NS['m']}}}argument")][0].endswith(
            "env/requirements-pin-cuda.txt")

    jni = ET.parse(ROOT / "spark-rapids-tpu-jni" / "pom.xml").getroot()
    classifiers = [c.text for c in jni.iter(f"{{{NS['m']}}}classifier")]
    assert "${TPU_PLATFORM}" in classifiers


def test_deploy_accepts_the_cuda12_classifier(tmp_path):
    """deploy.sh in a stand-in checkout (its pom's version, a built cuda12
    jar, no v5e jar; a stand-in python3 for the wheel): the cuda12 jar
    is copied into dist/ and the missing one is skipped."""
    script = ROOT / "ci" / "deploy.sh"
    assert subprocess.run(["bash", "-n", str(script)]).returncode == 0
    (tmp_path / "ci").mkdir()
    shutil.copy2(script, tmp_path / "ci" / "deploy.sh")
    (tmp_path / "pom.xml").write_text("<project><version>9.9</version>"
                                      "</project>\n")
    target = tmp_path / "spark-rapids-tpu-jni" / "target"
    target.mkdir(parents=True)
    (target / "rapids-4-spark-tpu-9.9-cuda12.jar").write_bytes(b"PK")
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    (bin_dir / "python3").write_text("#!/bin/sh\nexit 0\n")
    (bin_dir / "python3").chmod(0o755)
    env = {k: v for k, v in os.environ.items() if k != "SERVER_URL"}
    env.update(PATH=f"{bin_dir}:{os.environ['PATH']}",
               CLASSIFIERS="v5e,cuda12")
    proc = subprocess.run(["bash", str(tmp_path / "ci" / "deploy.sh")],
                          capture_output=True, text=True, env=env)
    assert proc.returncode == 0, proc.stderr
    assert (tmp_path / "dist" / "rapids-4-spark-tpu-9.9-cuda12.jar"
            ).read_bytes() == b"PK"
    assert "rapids-4-spark-tpu-9.9-v5e.jar not built" in proc.stdout


def test_cuda_premerge_gate():
    script = ROOT / "ci" / "premerge-build-cuda.sh"
    assert os.access(script, os.X_OK)
    assert subprocess.run(["bash", "-n", str(script)]).returncode == 0
    text = script.read_text()
    for step in ("nvidia-smi",
                 "build/dependency-check env/requirements-pin-cuda.txt",
                 "SRT_RUNTIME=torch",
                 "spark_rapids_jni_tpu_torch.kernels build",
                 "stage_cuda.py", "tests/test_torch_*.py",
                 "python3 chip_smoke.py"):
        assert step in text, step
    assert not (ROOT / ".github" / "workflows"
                / "premerge-cuda.yml").exists()


def test_cuda_pins_name_the_port_stack():
    pins = {}
    for line in (ROOT / "env" / "requirements-pin-cuda.txt").read_text(
            ).splitlines():
        if line.strip() and not line.startswith("#"):
            name, _, ver = line.partition("==")
            pins[name] = ver
    assert set(pins) == {"torch", "numpy", "pyarrow"}
    assert all(v and v[0].isdigit() for v in pins.values())
