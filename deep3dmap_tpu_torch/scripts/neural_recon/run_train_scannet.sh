#!/usr/bin/env bash
# Usage: GPUS=N run_train_scannet.sh [CONFIG] [extra tools/train.py args...]
source "$(dirname "$0")/../common.sh"
ROOT=$(repo_root)
CONFIG=${1:-$ROOT/configs/neural_recon/scannet.py}; shift || true
launch train "$CONFIG" --no-validate "$@"
