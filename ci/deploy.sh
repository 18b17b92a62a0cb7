#!/usr/bin/env bash
# Deploy artifacts — the ci/deploy.sh analog (ci/deploy.sh:32-76):
# package the per-platform jar + python wheel, optionally GPG-sign, and
# publish to the configured repository. Platform classifiers replace the
# reference's per-CUDA classifiers (cuda11 -> v5e/v5p/v4); cuda12 is the
# PyTorch/CUDA port's jar for an NVIDIA H100 (`mvn -P cuda package`).
# Each listed jar is copied (and signed) into dist/; the publish step
# deploys the default build only.
#
# Args:    SIGN_FILE (true|false)
# Env:     CLASSIFIERS (default "v5e"), SERVER_ID, SERVER_URL,
#          GPG_PASSPHRASE (when signing)
#
# No -x: signing runs here, and xtrace would echo secret-bearing
# command lines into the build log (Actions masking is best-effort).
set -euo pipefail

SIGN_FILE="${1:-false}"
CLASSIFIERS="${CLASSIFIERS:-v5e}"

repo="$(cd "$(dirname "$0")/.." && pwd)"
cd "$repo"

version="$(grep -m1 -o '<version>[^<]*</version>' pom.xml | sed 's/<[^>]*>//g')"
out="$repo/dist"
mkdir -p "$out"

# Python wheel of the compute stack.
python3 -m pip wheel --no-deps --wheel-dir "$out" . || \
  python3 setup.py bdist_wheel --dist-dir "$out" || true

# Per-platform jars (requires a JDK + maven node; premerge built them).
IFS=',' read -ra classifiers <<< "$CLASSIFIERS"
for cls in "${classifiers[@]}"; do
  jar="spark-rapids-tpu-jni/target/rapids-4-spark-tpu-${version}-${cls}.jar"
  if [[ -f "$jar" ]]; then
    cp "$jar" "$out/"
    if [[ "$SIGN_FILE" == "true" ]]; then
      # passphrase over fd 3, never argv (argv is visible in /proc)
      gpg --batch --yes --pinentry-mode loopback --passphrase-fd 3 \
        --detach-sign --armor "$out/$(basename "$jar")" \
        3<<<"$GPG_PASSPHRASE"
    fi
  else
    echo "WARNING: $jar not built; skipping classifier $cls"
  fi
done

if [[ -n "${SERVER_URL:-}" ]]; then
  # ci/settings.xml wires a central mirror from MAVEN_MIRROR_URL; only
  # pass it when that variable is set, or the unresolved placeholder
  # would break every dependency download
  mvn ${MAVEN_MIRROR_URL:+-s ci/settings.xml} deploy -DskipTests \
    -DaltDeploymentRepository="${SERVER_ID}::default::${SERVER_URL}"
fi

ls -l "$out"
