"""Where a fresh process's first train_step at the bench config spends its
time: imports, CUDA's start, the fragment, the model's init, then the first
step under torch.profiler (CPU ops by self time, also written to
``chiprun_out/first_step.txt``) and two more steps.  On the card:

    python3 -m deep3dmap_tpu_torch.tools.first_step_profile
"""
import os
import time

T0 = time.perf_counter()

import torch  # noqa: E402

from ..datasets.builder import _stack_samples  # noqa: E402
from ..datasets.synthetic import make_fragment_sample  # noqa: E402
from ..models.frameworks import neuralrecon as nr  # noqa: E402
from ..runners import train_state as tm  # noqa: E402
from ..utils.device import make_deterministic  # noqa: E402

# bench.py:159-179, the production fragment shape (chip_smoke.py's BENCH_CFGS)
BENCH_CFGS = dict(
    N_LAYER=3, N_VOX=[96, 96, 96], VOXEL_SIZE=0.04,
    TRAIN_NUM_SAMPLE=[4096, 16384, 65536],
    FUSION=dict(FUSION_ON=True, FULL=True), LW=[1.0, 0.8, 0.64],
    THRESHOLDS=[0, 0, 0], POS_WEIGHT=1.5, SPARSE_MODE="block", BLOCK_SIZE=8,
    GLOBAL_DTYPE="bfloat16", BLOCK_DTYPE="bfloat16",
    BACKBONE2D=dict(ARC="fpn-mnas-1", DTYPE="bfloat16", MODE="batch",
                    REMAT=False, INFER_MODE="batch"))
ADAM, CLIP = dict(type="Adam", lr=1e-3), dict(max_norm=1.0)   # bench.py:218


def main(out_dir: str = "chiprun_out"):
    from torch.profiler import ProfilerActivity, profile

    print(f"imports {time.perf_counter() - T0:.2f} s", flush=True)
    t = time.perf_counter()
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    print(f"cuda init {time.perf_counter() - t:.2f} s", flush=True)
    torch.backends.cudnn.allow_tf32 = True       # PyTorch's defaults
    torch.backends.cuda.matmul.allow_tf32 = False
    make_deterministic()
    t = time.perf_counter()
    batch = _stack_samples([make_fragment_sample(seed=0, n_views=9, img_size=(480, 640),
                                                 n_vox=96, voxel_size=0.04, device="cuda")])
    print(f"fragment {time.perf_counter() - t:.2f} s", flush=True)
    t = time.perf_counter()
    fw = nr.NeuralRecon(BENCH_CFGS)
    st = [tm.init_train_state(fw, 0, batch, ADAM, CLIP)]
    dev = fw.batch_to_device(batch)
    torch.cuda.synchronize()
    print(f"model init {time.perf_counter() - t:.2f} s", flush=True)

    def step():
        st[0], _ = tm.train_step(fw, st[0], dev)
        torch.cuda.synchronize()

    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step()
    print(f"first step {time.perf_counter() - t:.2f} s (profiled)", flush=True)
    table = prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=40)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "first_step.txt"), "w") as f:
        f.write(table + "\n")
        f.write(prof.key_averages().table(sort_by="cpu_time_total", row_limit=40))
    print(table, flush=True)
    for i in range(2):
        t = time.perf_counter()
        step()
        print(f"step {i + 2} {time.perf_counter() - t:.2f} s", flush=True)


if __name__ == "__main__":
    main()
