#!/usr/bin/env bash
# Premerge gate of the cuda12 jar (the PyTorch/CUDA port) — the sibling
# of ci/premerge-build.sh for a node with an NVIDIA H100: gates on the
# GPU (`nvidia-smi`, the reference's premerge-build.sh:20), validates the
# pinned environment of env/requirements-pin-cuda.txt, builds the
# port's native shim (SRT_RUNTIME=torch, warnings as errors), its sm_90a
# kernels and the jar's tree (spark-rapids-tpu-runtime/stage_cuda.py),
# runs the port's tests (JAX on the CPU, as their references) and
# drives the port on the card with chip_smoke.py. It needs cmake, g++,
# the CUDA toolkit and the Python embed files on the node. No GitHub
# workflow runs it: there is no GPU runner.
#
# Env:
#   REQUIRE_GPU=true|false   fail if no NVIDIA GPU is visible (default true)
#   PARALLEL_LEVEL           native build parallelism (default 4)
#   STAGE_DIR                the staged jar tree (default build/cuda-stage)
set -euxo pipefail

repo="$(cd "$(dirname "$0")/.." && pwd)"
cd "$repo"

# Accelerator gate (premerge-build.sh:20 of the reference).
if [[ "${REQUIRE_GPU:-true}" == "true" ]]; then
  nvidia-smi
fi

build/dependency-check env/requirements-pin-cuda.txt

# The port's shim: its own build tree (build/torch_cmake/), forced
# reconfigure on CI as premerge-build.sh does for the JAX library.
SRT_RUNTIME=torch NATIVE_BUILD_CONFIGURE=true SRT_WERROR=ON \
  CPP_PARALLEL_LEVEL="${PARALLEL_LEVEL:-4}" \
  bash spark-rapids-tpu-runtime/build-native.sh

# The kernels ahead of time, then the jar's tree: what `mvn -P cuda
# package` stages, so an executor loads the kernels without nvcc.
kernels_dir="$repo/build/cuda-kernels"
python3 -m spark_rapids_jni_tpu_torch.kernels build --out "$kernels_dir"
python3 spark-rapids-tpu-runtime/stage_cuda.py \
  --lib build/torch_cmake/libspark_rapids_tpu.so \
  --kernels "$kernels_dir" --out "${STAGE_DIR:-$repo/build/cuda-stage}" \
  --native-demo build/torch_cmake/native_demo \
  --jni-harness build/torch_cmake/jni_harness

# The port's tests: each holds the port against the JAX package on the
# CPU, so the node also needs the JAX stack of env/requirements-pin.txt
# (its CPU backend only). Then the `cuda`-marked tests on the card, which
# import no JAX.
JAX_PLATFORMS=cpu python3 -m pytest tests/test_torch_*.py -q -m "not slow"
python3 -m pytest --noconftest -m cuda -q -p no:cacheprovider \
  tests/test_torch_isolation.py tests/test_torch_services_cuda.py \
  tests/test_torch_ops_exports.py

# The port on the card: every kernel against its plain version, every
# cell of the main path, (x) the staged tree on its own.
python3 chip_smoke.py
