#!/usr/bin/env bash
# Usage: gen_tsdf.sh --datapath D --mode train [...]: one process
source "$(dirname "$0")/../common.sh"
ROOT=$(repo_root)
PYTHONPATH="$ROOT:$PYTHONPATH" python -m deep3dmap_tpu_torch.tools.data_gen_scannet "$@" \
  --device "${DEVICE:-cuda}"
