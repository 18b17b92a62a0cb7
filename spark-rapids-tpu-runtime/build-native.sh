#!/usr/bin/env bash
# Configure-once native build — the build-libcudf.xml discipline
# (build-libcudf.xml:23-30): only rerun CMake configure when no
# CMakeCache.txt exists or NATIVE_BUILD_CONFIGURE=true, so incremental
# `mvn verify` runs reuse the build tree (CONTRIBUTING.md:46-55
# rationale in the reference).
#
# SRT_RUNTIME picks the embedded device runtime and, with it, the build
# tree: jax (the default) builds the TPU jar's library in build/;
# torch builds the PyTorch/CUDA port's (the cuda12 jar's) in
# build/torch_cmake/, embedding the python3 on PATH.
set -euo pipefail

here="$(cd "$(dirname "$0")" && pwd)"
repo="$(cd "$here/.." && pwd)"
runtime="${SRT_RUNTIME:-jax}"
case "$runtime" in
  jax)   build="$repo/build"; extra=() ;;
  torch) build="$repo/build/torch_cmake"
         extra=(-DSRT_RUNTIME=torch "-DPython3_EXECUTABLE=$(command -v python3)") ;;
  *)     echo "build-native.sh: SRT_RUNTIME must be jax or torch, got '$runtime'" >&2
         exit 2 ;;
esac

if [[ ! -f "$build/CMakeCache.txt" || "${NATIVE_BUILD_CONFIGURE:-false}" == "true" ]]; then
  cmake -S "$repo/src" -B "$build" \
    -DSRT_WERROR="${SRT_WERROR:-ON}" \
    -DCMAKE_BUILD_TYPE=Release ${extra[@]+"${extra[@]}"}
fi
cmake --build "$build" --parallel "${CPP_PARALLEL_LEVEL:-4}"
