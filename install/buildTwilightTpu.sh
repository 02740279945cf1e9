#!/usr/bin/env bash
# Build/install twilight-tpu (reference analogue:
# install/buildTWILIGHT.sh, which cmake-builds the C++/CUDA binary).
# Here the Python package installs via pip; the native host modules (AVX2
# DP kernel, host ops, stdorder) compile on demand via g++ and the CUDA DP
# kernel (ops/talco_cuda.cu) via nvcc; this script does both eagerly and
# verifies the result.
#
# Usage: bash install/buildTwilightTpu.sh [gpu|cpu]
#   gpu (default): jax with its CUDA 12 plugin; needs nvcc (CUDA toolkit,
#                  CUDA_HOME or /usr/local/cuda) for the DP kernel
#   cpu:           plain jax (host-only; --backend native needs no jax)
set -euo pipefail
BUILD_TYPE="${1:-gpu}"
SCRIPT_DIR=$(cd "$(dirname "$0")" && pwd)
REPO_DIR="${SCRIPT_DIR}/.."

command -v g++ >/dev/null || {
    echo "error: g++ is required (native kernels compile via g++)" >&2
    exit 1
}

if ! python3 -c "import jax" 2>/dev/null; then
    if [ "$BUILD_TYPE" = "gpu" ]; then
        pip install "jax[cuda12]"
    else
        pip install jax
    fi
fi

pip install "$REPO_DIR"

# compile the native modules now (first import runs g++)
python3 -c "
from twilight_tpu.ops import talco_host
assert talco_host.available(), 'native host kernel failed to build'
print('native host kernel: OK')
"
if [ "$BUILD_TYPE" = "gpu" ]; then
    python3 -c "
from twilight_tpu.ops import talco_gpu
print('CUDA DP kernel:', talco_gpu.build_library())
"
fi

echo "twilight-tpu installed; try: twilight-tpu --help"
