#!/usr/bin/env bash
# Shared launcher plumbing of the port's workload scripts (the twins of
# scripts/*/run_*.sh): torchrun starts one process per card and the port's
# CLIs take its environment with --launcher pytorch.
#   GPUS=N       processes on this host, one per card (default 1)
#   DEVICE=cpu   run the ranks on the CPU over gloo (default cuda, NCCL)
repo_root() { cd "$(dirname "${BASH_SOURCE[1]}")/../../.." && pwd; }

# launch TOOL [ARGS...]: deep3dmap_tpu_torch.tools.TOOL under torchrun
launch() {
  local tool=$1; shift
  PYTHONPATH="$ROOT:$PYTHONPATH" torchrun --standalone --nproc_per_node "${GPUS:-1}" \
    -m "deep3dmap_tpu_torch.tools.$tool" "$@" --launcher pytorch --device "${DEVICE:-cuda}"
}
