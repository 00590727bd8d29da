#!/usr/bin/env bash
# Usage: GPUS=N run_test_scannet.sh CONFIG CHECKPOINT [extra tools/test.py args...]
source "$(dirname "$0")/../common.sh"
ROOT=$(repo_root)
CONFIG=${1:-$ROOT/configs/neural_recon/scannet.py}; CKPT=${2:?checkpoint}; shift 2 || true
launch test "$CONFIG" --checkpoint "$CKPT" "$@"
