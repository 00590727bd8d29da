"""The data-parallel step on the card at one NCCL rank: bit-equal to the step
with no process group, with the same loss kernel launches (3 forward, 1
backward a step) and one all-reduce of the loss's sums beside the gradient
buckets.

Imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_parallel_cuda.py

Without a CUDA device every test here skips.
"""
import numpy as np
import pytest
import torch

from deep3dmap_tpu_torch.datasets.builder import _stack_samples
from deep3dmap_tpu_torch.datasets.synthetic import make_fragment_sample
from deep3dmap_tpu_torch.models.frameworks.neuralrecon import NeuralRecon
from deep3dmap_tpu_torch.parallel import collectives, make_mesh
from deep3dmap_tpu_torch.runners.optim import build_optimizer
from deep3dmap_tpu_torch.runners.train_state import TrainState, train_step
from deep3dmap_tpu_torch.utils.device import make_deterministic
from deep3dmap_tpu_torch.utils.tracing import counter, reset_counters

CFG = dict(N_LAYER=3, N_VOX=[32, 32, 32], VOXEL_SIZE=0.08, TRAIN_NUM_SAMPLE=[64, 256],
           FUSION=dict(FUSION_ON=True, FULL=True), LW=[1.0, 0.8, 0.64],
           THRESHOLDS=[0, 0, 0], POS_WEIGHT=1.5, BACKBONE2D=dict(ARC="fpn-mnas-0.5"),
           SPARSE_MODE="block", BLOCK_SIZE=8, MAX_BLOCKS=[None, 4, 24])
N_STEPS = 3


@pytest.fixture
def nccl_one_rank(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: NCCL and the loss's Triton kernels")
    import torch.distributed as dist

    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    try:
        yield make_mesh(device="cuda")
    finally:
        dist.destroy_process_group()


def _run(mesh, batches):
    make_deterministic()
    fw = NeuralRecon(CFG, device="cuda")
    if mesh is not None:
        fw.set_mesh(mesh)
    net, ms = fw.init(0, batches[0])
    state = TrainState(net=net, model_state=ms,
                       optimizer=build_optimizer(dict(type="Adam", lr=1e-3), net.parameters(),
                                                 dict(max_norm=1.0)))
    losses, launches, counts = [], [], []
    for b in batches:
        reset_counters("fused_loss.")
        collectives.reset_counts()
        state, logs = train_step(fw, state, b)
        losses.append(logs["loss"].clone())
        launches.append((counter("fused_loss.fwd_launches"),
                         counter("fused_loss.bwd_launches")))
        counts.append(collectives.counts())
    torch.cuda.synchronize()
    return losses, [p.detach().clone() for p in net.parameters()], launches, counts


@pytest.mark.cuda
def test_one_nccl_rank_is_bit_equal(nccl_one_rank):
    batches = []
    for k in range(N_STEPS):
        b = _stack_samples([make_fragment_sample(seed=k, n_views=2, img_size=(64, 64),
                                                 n_vox=32, voxel_size=0.08, device="cuda")])
        b["scene_reset"] = np.full(1, 1.0 if k == 0 else 0.0, np.float32)
        batches.append(b)
    ref = _run(None, batches)
    got = _run(nccl_one_rank, batches)
    for a, b in zip(ref[0], got[0]):
        assert torch.equal(a, b)
    for a, b in zip(ref[1], got[1]):
        assert torch.equal(a, b)
    assert ref[2] == got[2] == [(3, 1)] * N_STEPS
    assert all(c == {} for c in ref[3])
    # the loss's sums, then the gradients in one bucket
    assert got[3] == [{"all_reduce": 2}] * N_STEPS
