#!/usr/bin/env bash
# Usage: GPUS=N run_train_prnet.sh [CONFIG] [extra tools/train.py args...]
source "$(dirname "$0")/../common.sh"
ROOT=$(repo_root)
CONFIG=${1:-$ROOT/configs/prnet/prnet_synthetic.py}; shift || true
launch train "$CONFIG" "$@"
