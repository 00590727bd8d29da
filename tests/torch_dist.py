"""Rank groups for the port's multi-GPU tests, on the CPU over gloo.

``run_ranks(n, job, tmp_dir, **kw)`` starts ``n`` processes of this file,
one rank each, which meet through a ``file://`` store under ``tmp_dir`` (no
port, so test workers running side by side never collide), run the job of
that name on their rank and save what it returns; the caller gets the
ranks' results in rank order.  Every process has its own timeout, and a
rank that fails fails the call with its stderr.  The jobs import torch and
the port only: the JAX side of a comparison runs in the test's process.
"""
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_ranks(n, job, tmp_dir, timeout=240, **kw):
    tmp_dir = str(tmp_dir)
    init = "file://" + os.path.join(tmp_dir, f"{job}_store")
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), job, str(r), str(n), init, tmp_dir,
         json.dumps(kw)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(n)]
    errs = []
    try:
        for r, p in enumerate(procs):
            _, err = p.communicate(timeout=timeout)
            if p.returncode:
                errs.append(f"rank {r} exited {p.returncode}:\n{err[-4000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert not errs, "\n".join(errs)
    return [torch.load(os.path.join(tmp_dir, f"{job}_rank{r}.pt"), weights_only=False)
            for r in range(n)]


def save_inputs(tmp_dir, name, obj):
    path = os.path.join(str(tmp_dir), name)
    torch.save(obj, path)
    return path


# ---------------------------------------------------------------- the jobs
def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t


def job_ddp_neuralrecon(inputs, n_steps):
    """The data-parallel NeuralRecon step: this rank's share of each global
    batch (``shard_batch(global_batch=True)``), the loss's sums and the
    gradients summed over the ranks.  Returns the first step's loss, logs
    and summed gradients (before the clip), the loss curve of ``n_steps``
    ``train_step``s and the collectives of one step; and each rank's loss
    through a one-rank group of its own against no group."""
    import torch.distributed as dist

    from deep3dmap_tpu_torch.models.frameworks.neuralrecon import NeuralRecon
    from deep3dmap_tpu_torch.parallel import collectives, make_mesh, replicate, shard_batch
    from deep3dmap_tpu_torch.runners.optim import build_optimizer
    from deep3dmap_tpu_torch.runners.train_state import TrainState, train_step
    from deep3dmap_tpu_torch.utils.from_flax import to_flax_grads

    data = torch.load(inputs, weights_only=False)
    fw = NeuralRecon(data["cfg"], device="cpu")
    mesh = make_mesh(device="cpu")
    fw.set_mesh(mesh)
    group = mesh.group("data")
    batches = [shard_batch(b, mesh, global_batch=True) for b in data["batches"]]
    net, _ = fw.init(0, batches[0])
    replicate(net, mesh)
    n_local = batches[0]["imgs"].shape[0]
    state = TrainState(net=net, model_state=fw.init_state(n_local),
                       optimizer=build_optimizer(dict(type="Adam", lr=1e-3), net.parameters(),
                                                 dict(max_norm=1.0)))
    out = {}
    loss, aux = fw.loss_fn(net, state.model_state, batches[0])
    loss.backward()
    collectives.reduce_gradients(net.parameters(), group)
    out["loss"] = float(loss)
    out["logs"] = {k: float(v) for k, v in aux["log_vars"].items()}
    out["grads"] = to_flax_grads(net)
    state.optimizer.zero_grad()
    curve = []
    for b in batches[:n_steps]:
        collectives.reset_counts()
        state, logs = train_step(fw, state, b)
        curve.append(float(logs["loss"]))
        out["counts"] = collectives.counts()
    out["curve"] = curve
    # the group= path at one rank: bit-equal to no group
    own = [dist.new_group([r]) for r in range(dist.get_world_size())][dist.get_rank()]
    fw.loss_group = None
    ref, _ = fw.loss_fn(net, fw.init_state(n_local), batches[0])
    fw.loss_group = own
    one, _ = fw.loss_fn(net, fw.init_state(n_local), batches[0])
    out["one_rank"] = (float(ref), float(one), bool(torch.equal(ref, one)))
    return out


def job_mesh(inputs):
    """The mesh layer on 4 ranks: ``get_dist_info``, ``master_only``, the
    meshes' shapes, coordinates and groups, ``shard_batch`` of a global
    batch over ``data`` on a (4,) and a (2, 2) mesh, ``replicate``; this
    rank's slab of ``tsdf_fuse_frames_sharded`` over a (4,) ``x`` axis and
    ``volume_sharding`` of three meshes."""
    import torch.distributed as dist

    from deep3dmap_tpu_torch.parallel import (get_dist_info, make_mesh, master_only,
                                              replicate, shard_batch)

    batch = torch.load(inputs, weights_only=False)
    out = {"dist_info": get_dist_info(),
           "master_only": master_only(lambda: dist.get_rank() + 10)()}
    for name, axes, shape in (("flat", ("data",), None), ("grid", ("data", "model"), (2, 2)),
                              ("wild", ("data", "model"), (-1, 2))):
        mesh = make_mesh(axes, shape, device="cpu")
        out[name] = dict(shape=mesh.shape, coords={a: mesh.coordinate(a) for a in axes},
                         group_sizes={a: dist.get_world_size(mesh.group(a)) for a in axes},
                         batch={k: _np(v) if not isinstance(v, list) else [_np(x) for x in v]
                                for k, v in shard_batch(batch["batch"], mesh,
                                                        global_batch=True).items()})
    from deep3dmap_tpu_torch.core.tsdf.fusion import TSDFParams
    from deep3dmap_tpu_torch.parallel import tsdf_fuse_frames_sharded, volume_sharding

    fr = batch["frames"]
    xmesh = make_mesh(("x",), device="cpu")
    out["tsdf_slab"] = [_np(v) for v in tsdf_fuse_frames_sharded(
        *(torch.tensor(fr[k]) for k in ("depth", "K", "pose", "origin")),
        TSDFParams(**fr["params"]), xmesh)]
    out["volume_sharding"] = {name: volume_sharding(make_mesh(axes, shape, device="cpu"),
                                                    "model", "data")
                              for name, axes, shape in (("flat", ("data",), None),
                                                        ("grid", ("data", "model"), (2, 2)),
                                                        ("model", ("model",), None))}
    t = torch.full((3,), float(dist.get_rank()))
    net = torch.nn.Linear(2, 2)
    with torch.no_grad():
        net.weight.fill_(dist.get_rank())
    rep = replicate({"t": t, "net": net}, make_mesh(device="cpu"))
    out["replicated"] = (_np(rep["t"]), _np(net.weight))
    return out


def job_halo(inputs):
    """The halo layer on 4 ranks: ``halo_pad`` of ``arange(8)`` over a (4,)
    model axis; the halo ConvGRU over (4,) and over the model axis of a
    (2, 2) mesh (2 ranks), forward and the gradients of a cotangent; the
    spatially sharded NeuralRecon step over the (2, 2) mesh."""
    from deep3dmap_tpu_torch.models.frameworks.neuralrecon import NeuralRecon
    from deep3dmap_tpu_torch.models.modulars.conv_gru3d import ConvGRU3D
    from deep3dmap_tpu_torch.parallel import (conv_gru3d_halo, halo_pad, make_mesh,
                                              shard_batch)
    from deep3dmap_tpu_torch.parallel.collectives import reduce_gradients
    from deep3dmap_tpu_torch.utils.from_flax import load_flax_params, to_flax_grads

    data = torch.load(inputs, weights_only=False)
    flat = make_mesh(("model",), device="cpu")
    grid = make_mesh(("data", "model"), (2, 2), device="cpu")
    out = {}
    r = flat.coordinate("model")
    x = torch.arange(8, dtype=torch.float32).reshape(1, 8, 1, 1, 1)
    out["halo_pad"] = _np(halo_pad(x[:, 2 * r:2 * r + 2], flat.group("model"), 1))
    for case in data["gru"]:
        gru = ConvGRU3D(case["ch"], case["cx"])
        load_flax_params(gru, case["params"])
        for name, mesh in (("4", flat), ("2", grid)):
            n, m = mesh.shape["model"], mesh.coordinate("model")
            k = case["h"].shape[1] // n
            sl = slice(m * k, (m + 1) * k)
            h = torch.tensor(case["h"][:, sl], requires_grad=True)
            xx = torch.tensor(case["x"][:, sl], requires_grad=True)
            gru.zero_grad()
            y = conv_gru3d_halo(gru, h, xx, mesh, axis="model")
            (y * torch.tensor(case["ct"][:, sl])).sum().backward()
            out[f"gru_{case['gx']}_{name}"] = dict(
                y=_np(y), dh=_np(h.grad), dx=_np(xx.grad),
                dw={k2: _np(v.grad) for k2, v in gru.named_parameters()})
    # the spatial NeuralRecon step: data 2 x model 2
    fw = NeuralRecon(data["cfg"], device="cpu")
    assert fw.set_mesh(grid)
    batches = [shard_batch(b, grid, global_batch=True) for b in data["batches"]]
    net, ms = fw.init(0, batches[0])
    load_flax_params(net, data["params"])
    steps = []
    for b in batches:
        net.zero_grad()
        loss, aux = fw.loss_fn(net, ms, b)
        loss.backward()
        reduce_gradients(net.parameters(), grid.group("data"))
        ms = aux["model_state"]
        steps.append(dict(loss=float(loss), grads=to_flax_grads(net),
                          volumes=[_np(v) for v in ms["global_hidden"].volumes]))
    out["spatial"] = steps
    out["volume_bytes"] = sum(v.numel() * v.element_size()
                              for v in ms["global_hidden"].volumes)
    return out


def job_ba(inputs, iters):
    """``lm_solve_sharded`` over 4 ranks in float64: the result of each
    iteration count 1..``iters`` (each a solve from the start) and the
    collectives it issued."""
    from deep3dmap_tpu_torch.core import sfm
    from deep3dmap_tpu_torch.parallel import collectives, make_mesh

    d = torch.load(inputs, weights_only=False)
    mesh = make_mesh(device="cpu")
    res = []
    for n in range(1, iters + 1):
        collectives.reset_counts()
        r = sfm.lm_solve_sharded(mesh, *d["start"], d["prob"], iters=n, huber=d["huber"])
        res.append({k: _np(getattr(r, k)) for k in ("R", "t", "X", "cost", "lam",
                                                     "initial_cost")})
        res[-1]["counts"] = collectives.counts()
    return res


def job_sync_bn_fsdp(inputs):
    """On 2 ranks: ``SyncBatchNorm`` on this rank's half of a batch (train
    mode: outputs, the gradients of a cotangent, the running statistics);
    one step of a toy net under ``fsdp_shard`` and under ``zero_shard``."""
    import torch.distributed as dist

    from deep3dmap_tpu_torch.models.modulars import SyncBatchNorm
    from deep3dmap_tpu_torch.parallel import fsdp_shard, make_mesh, zero_shard
    from deep3dmap_tpu_torch.parallel.collectives import reduce_gradients
    from deep3dmap_tpu_torch.utils.from_flax import load_flax_params

    d = torch.load(inputs, weights_only=False)
    mesh = make_mesh(device="cpu")
    r, n = dist.get_rank(), dist.get_world_size()
    out = {}
    bn = SyncBatchNorm(d["bn_x"].shape[-1], group=mesh.group("data"),
                       use_running_average=False)
    load_flax_params(bn, d["bn_params"])
    k = d["bn_x"].shape[0] // n
    x = torch.tensor(d["bn_x"][r * k:(r + 1) * k], requires_grad=True)
    y = bn(x)
    (y * torch.tensor(d["bn_ct"][r * k:(r + 1) * k])).sum().backward()
    reduce_gradients(bn.parameters(), mesh.group("data"))
    out["bn"] = dict(y=_np(y), dx=_np(x.grad), mean=_np(bn.bn.mean), var=_np(bn.bn.var),
                     dscale=_np(bn.bn.scale.grad), dbias=_np(bn.bn.bias.grad))

    def toy():
        net = ToyNet()
        with torch.no_grad():
            for name, p in net.named_parameters():
                p.copy_(torch.tensor(d["toy"][name]))
        return net

    net = fsdp_shard(toy(), mesh, min_size=1024)
    out["placements"] = {name: str(getattr(p, "placements", "whole"))
                         for name, p in net.named_parameters()}
    opt = torch.optim.Adam(net.parameters(), lr=1e-2)
    loss = net(torch.tensor(d["x"]), torch.tensor(d["y"]))
    loss.backward()
    out["fsdp_grads"] = {name: _np(p.grad.full_tensor() if hasattr(p.grad, "full_tensor")
                                   else p.grad) for name, p in net.named_parameters()}
    opt.step()
    out["fsdp_loss"] = float(loss)
    out["fsdp_params"] = {name: _np(p.full_tensor() if hasattr(p, "full_tensor") else p)
                          for name, p in net.named_parameters()}
    net = toy()
    opt = zero_shard(torch.optim.Adam(net.parameters(), lr=1e-2), mesh, min_size=1024)
    net(torch.tensor(d["x"]), torch.tensor(d["y"])).backward()
    opt.step()
    out["zero_params"] = {name: _np(p) for name, p in net.named_parameters()}
    out["zero_state"] = {tuple(s.shape): tuple(st["exp_avg"].shape)
                         for s, st in opt.state.items()}
    return out


def _tensors(tree):
    """Numpy leaves of nested dicts and lists as tensors."""
    import numpy as np

    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tensors(v) for v in tree]
    return torch.from_numpy(np.array(tree)) if not isinstance(tree, torch.Tensor) else tree


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_numpy(v) for v in tree]
    return _np(tree)


def dp_step(fw, net, mstate, batch, group, names=None, **kw):
    """One data-parallel step of ``fw.loss_fn``: the backward, then the
    gradients of the collections ``names`` (all of ``net`` when None)
    summed over ``group``.  Returns the loss, the logs and those gradients
    in flax layout (by collection when ``names`` is given)."""
    from deep3dmap_tpu_torch.parallel.collectives import reduce_gradients
    from deep3dmap_tpu_torch.utils.from_flax import to_flax_grads

    net.zero_grad(set_to_none=True)
    loss, aux = fw.loss_fn(net, mstate, batch, **kw)
    loss.backward()
    mods = [net] if names is None else [getattr(net, n) for n in names]
    if group is not None:
        reduce_gradients([p for m in mods for p in m.parameters()], group)
    grads = (to_flax_grads(net) if names is None
             else {n: to_flax_grads(m) for n, m in zip(names, mods)})
    return dict(loss=float(loss.detach()),
                logs={k: float(v.detach()) for k, v in aux["log_vars"].items()}, grads=grads)


def own_means_step(fw, net, mstate, batch, group, names=None, **kw):
    """``dp_step`` with the framework's means taken over this rank's shard
    only (its ``loss_group`` None), the gradients still summed: the fault
    the global means prevent."""
    g, fw.loss_group = fw.loss_group, None
    try:
        return dp_step(fw, net, mstate, batch, group, names, **kw)
    finally:
        fw.loss_group = g


def gan2shape_fit(cfg, batch, stage_iters, mesh):
    """A ``Gan2ShapeRunner`` on ``mesh`` fitting one instance: its heads
    after the fit, the stage logs and the step-3 indices it drew."""
    from deep3dmap_tpu_torch.models.frameworks.gan2shape import Gan2Shape
    from deep3dmap_tpu_torch.parallel import collectives
    from deep3dmap_tpu_torch.runners import gan2shape_runner as gr

    fw = Gan2Shape(dict(cfg, raster_mode="hard"), device="cpu")
    runner = gr.Gan2ShapeRunner(fw, dict(type="Adam", lr=1e-4), stage_iters=stage_iters,
                                num_stage=1, mesh=mesh)
    runner.setup(batch)
    drawn, real = [], gr.step3_indices

    def spy(*a):
        drawn.append(real(*a))
        return drawn[-1]
    gr.step3_indices = spy
    collectives.reset_counts()
    try:
        runner.fit_instance(batch)
    finally:
        gr.step3_indices = real
    return dict(heads={k: _np(v) for k, v in runner.net.state_dict().items()},
                logs=runner.logs, step3=drawn, loss_group=fw.loss_group,
                counts=collectives.counts())


def job_ddp_frameworks(inputs):
    """PRNet, imgs2mesh, GNeRF and LERF data-parallel over this rank's share
    of each global batch (``shard_batch(global_batch=True)``), one step of
    each optimize sequence with the given weights and (sliced) draws: the
    loss, the logs and the gradients summed over the ranks, and the same
    with each rank's own means; GNeRF's importance samples and the draws
    ``loss_fn`` takes from a generator; Gan2Shape's runner fitting one
    instance on the mesh and, on rank 1, without one."""
    from deep3dmap_tpu_torch.datasets.nerf_synthetic import SyntheticNerfDataset
    from deep3dmap_tpu_torch.models.frameworks import gnerf as tg
    from deep3dmap_tpu_torch.models.frameworks import lerf as tl
    from deep3dmap_tpu_torch.models.frameworks.imgs2mesh import Imgs2Mesh
    from deep3dmap_tpu_torch.models.frameworks.prnet import FaceImg2UV
    from deep3dmap_tpu_torch.models.modulars import gnerf as tgm
    from deep3dmap_tpu_torch.parallel import make_mesh, shard_batch
    from deep3dmap_tpu_torch.parallel.collectives import rank_slice
    from deep3dmap_tpu_torch.parallel.mesh import Mesh
    from deep3dmap_tpu_torch.utils.from_flax import load_flax_params

    d = torch.load(inputs, weights_only=False)
    mesh = make_mesh(device="cpu")
    group = mesh.group("data")
    out = {}

    def local(b):
        return shard_batch(b, mesh, global_batch=True)

    # PRNet
    c = d["prnet"]
    fw = FaceImg2UV(c["cfg"], device="cpu")
    fw.set_mesh(mesh)
    net = fw.load_flax(c["params"])
    b = local(c["batch"])
    out["prnet"] = dict(step=dp_step(fw, net, {}, b, group),
                        own=own_means_step(fw, net, {}, b, group))

    # imgs2mesh, each state
    c = d["imgs2mesh"]
    fw = Imgs2Mesh(c["cfg"], device="cpu")
    fw.set_mesh(mesh)
    net = fw.load_flax(c["params"])
    b = local(c["batch"])
    out["imgs2mesh"] = {st: dp_step(fw, net, {}, b, group, state=st) for st in c["states"]}
    out["imgs2mesh"]["own"] = own_means_step(fw, net, {}, b, group, state=c["states"][-1])

    # GNeRF, each optimize sequence on JAX's draws, its samples recorded
    c = d["gnerf"]
    fw = tg.GanNerf(c["cfg"], device="cpu")
    fw.set_info_from_datasets([SyntheticNerfDataset(**c["train_ds"]),
                               SyntheticNerfDataset(**c["val_ds"])])
    fw.set_mesh(mesh)
    net, _ = fw.init(0, c["batch"])
    load_flax_params(net, c["params"])
    mstate = _tensors(c["mstate"])
    b = local(c["batch"])
    samples, real_pdf = [], tgm.sample_pdf

    def rec(*a, **kw):
        z = real_pdf(*a, **kw)
        samples.append(_np(z))
        return z
    tgm.sample_pdf = rec
    res = {}
    try:
        for seq in c["seqs"]:
            del samples[:]
            draws = rank_slice(_tensors(c["draws"][seq]), group)
            res[seq] = dp_step(fw, net, mstate, b, group, fw.optseq2netnames(seq),
                               state="A", opt_seq=seq, draws=draws)
            res[seq]["samples"] = list(samples)
        seq = c["seqs"][0]
        res["own"] = own_means_step(fw, net, mstate, b, group, fw.optseq2netnames(seq),
                                    state="A", opt_seq=seq,
                                    draws=rank_slice(_tensors(c["draws"][seq]), group))
    finally:
        tgm.sample_pdf = real_pdf
    out["gnerf"] = res
    # the draws loss_fn takes from a generator: this rank's slice of the global batch's
    kept, real_slice = [], tg.rank_slice

    def keep(tree, g):
        kept.append(real_slice(tree, g))
        return kept[-1]
    tg.rank_slice = keep
    try:
        fw.loss_fn(net, mstate, b, rng=torch.Generator().manual_seed(7), state="A",
                   opt_seq=seq)
    finally:
        tg.rank_slice = real_slice
    out["gnerf_rng_draws"] = _numpy(kept[0])

    # LERF (the hash-grid field)
    c = d["lerf"]
    fw = tl.LERFModel(c["cfg"], device="cpu")
    fw.set_mesh(mesh)
    net, _ = fw.init(0, c["batch"])
    load_flax_params(net, c["params"])
    b = local(c["batch"])
    draws = rank_slice(_tensors(c["draws"]), group)
    out["lerf"] = dict(step=dp_step(fw, net, {}, b, group, draws=draws),
                       own=own_means_step(fw, net, {}, b, group, draws=draws))
    kept, real_slice = [], tl.rank_slice
    tl.rank_slice = keep
    try:
        fw.loss_fn(net, {}, b, rng=torch.Generator().manual_seed(7))
    finally:
        tl.rank_slice = real_slice
    out["lerf_rng_draws"] = _numpy(kept[0])

    # Gan2Shape: replicated on the mesh; on rank 1 also without a mesh
    c = d["gan2shape"]
    out["gan2shape"] = gan2shape_fit(c["cfg"], c["batch"], c["stage_iters"], mesh)
    out["gan2shape"]["loss_group"] = out["gan2shape"]["loss_group"] is None
    if mesh.coordinate("data") == 1:
        one = Mesh(("data",), (1,), None, torch.device("cpu"))
        out["gan2shape_one"] = gan2shape_fit(c["cfg"], c["batch"], c["stage_iters"], one)
        out["gan2shape_one"].pop("loss_group")
    return out


def register_stream_dataset():
    """``StreamScanNetDataset``: the synthetic fragments of one scene in
    order, the recurrent state reset only at the first (the test split of a
    scene, as ``tools/test.py`` streams it).  Registered on first call."""
    from deep3dmap_tpu_torch.datasets.builder import DATASETS
    from deep3dmap_tpu_torch.datasets.synthetic import SyntheticScanNetDataset

    if DATASETS.get("StreamScanNetDataset") is not None:
        return

    @DATASETS.register_module()
    class StreamScanNetDataset(SyntheticScanNetDataset):
        def __getitem__(self, idx):
            import numpy as np

            return dict(super().__getitem__(idx), scene_reset=np.float32(idx == 0))


def record_test_outputs(argv):
    """``tools/test.py``'s main on ``argv`` (a NeuralRecon config); each
    ``forward_test`` call's outputs as host arrays, in order."""
    from deep3dmap_tpu_torch.models.frameworks.neuralrecon import NeuralRecon
    from deep3dmap_tpu_torch.tools import test as test_cli

    register_stream_dataset()
    seen, real = [], NeuralRecon.forward_test

    def rec(self, *a, **kw):
        out, state = real(self, *a, **kw)
        seen.append({k: _np(v) for k, v in out.items()})
        return out, state
    NeuralRecon.forward_test = rec
    try:
        test_cli.main(argv)
    finally:
        NeuralRecon.forward_test = real
    return seen


def spatial_runner(cfg, batch, work_dir, mesh):
    """NeuralRecon on ``EpochBasedRunner`` over ``mesh``, set up on
    ``batch`` with plain Adam (no clip, so the gradients stay as summed)."""
    from deep3dmap_tpu_torch.models.frameworks.neuralrecon import NeuralRecon
    from deep3dmap_tpu_torch.runners.epoch_based_runner import EpochBasedRunner

    runner = EpochBasedRunner(NeuralRecon(cfg, device="cpu"), work_dir=work_dir, mesh=mesh,
                              max_epochs=1)
    runner.setup(batch, optimizer=dict(type="Adam", lr=1e-3))
    return runner


def runner_step(runner, batch):
    """One ``run_iter``: its loss and the gradient it stepped with."""
    from deep3dmap_tpu_torch.utils.from_flax import to_flax_grads

    log = runner.run_iter(batch)
    return dict(loss=float(log["loss"]), grads=to_flax_grads(runner.state.net))


def volumes(runner):
    return [_np(v) for v in runner.state.model_state["global_hidden"].volumes]


def job_ddp_runtime(inputs):
    """The runtime on 2 ranks: (a) NeuralRecon over ("data", "model") =
    (1, 2): a step, a checkpoint of the whole volumes, resumed on the mesh
    (its slabs and the next step) and a one-rank checkpoint resumed on the
    mesh; (b) ``val`` data-parallel on a global batch of 2; (c)
    ``tools/test.py`` on a scene's fragments in order, on ("data",) and on
    ("data", "model") = (1, 2).  A part that raises is recorded as its
    error, and the others still run."""
    import traceback

    import torch.distributed as dist

    from deep3dmap_tpu_torch.parallel import make_mesh, shard_batch
    from deep3dmap_tpu_torch.runners.checkpoint import latest_checkpoint

    d = torch.load(inputs, weights_only=False)
    out = {"errors": {}}

    def part(name, fn):
        try:
            fn()
        except Exception:
            out["errors"][name] = traceback.format_exc()[-2000:]
        dist.barrier()

    grid = make_mesh(("data", "model"), (1, 2), device="cpu")
    frags = d["frags"]

    def checkpoint():
        runner = spatial_runner(d["cfg"], frags[0], d["wd"], grid)
        out["spatial_on"] = runner.framework.spatial_group is not None
        out["step0"] = runner_step(runner, frags[0])
        out["slabs"] = volumes(runner)
        out["saved"] = runner.save_checkpoint()

    def resume_mesh():
        resumed = spatial_runner(d["cfg"], frags[0], d["wd2"], grid)
        resumed.resume(latest_checkpoint(d["wd"]))
        out["resumed_slabs"] = volumes(resumed)
        out["resumed_step"] = runner_step(resumed, frags[1])

    def resume_one():
        from_one = spatial_runner(d["cfg"], frags[0], d["wd2"], grid)
        from_one.resume(d["one_rank_ckpt"])
        out["from_one_slabs"] = volumes(from_one)

    def val():
        flat = make_mesh(device="cpu")
        local = shard_batch(d["pair"], flat, global_batch=True)
        runner = spatial_runner(d["cfg"], local, d["wd2"], flat)
        runner.val([local])
        out["val_loss"] = [float(v) for v in runner.log_buffer.val_history["val_loss"]]

    def test_cli():
        out["test"] = {}
        for name, opts in d["test_runs"].items():
            out["test"][name] = record_test_outputs(
                d["test_argv"] + ["--launcher", "pytorch", "--cfg-options", *opts])

    for name, fn in (("checkpoint", checkpoint), ("resume_mesh", resume_mesh),
                     ("resume_one", resume_one), ("val", val), ("test", test_cli)):
        part(name, fn)
    return out


def job_ddp_cli(runs):
    """``tools/train.py --launcher pytorch`` (and ``tools/test.py`` where a
    run has ``test``) on each run's argv: the runner's type, epoch, step,
    state, mesh and loss group, and the test's result."""
    from deep3dmap_tpu_torch.tools import test as test_cli
    from deep3dmap_tpu_torch.tools import train as train_cli

    out = {}
    for run in runs:
        runner = train_cli.main(run["train"] + ["--launcher", "pytorch"])
        fw = runner.framework
        out[run["name"]] = dict(
            type=type(runner).__name__, epoch=runner.epoch, iter=runner.iter,
            step=runner.state.step, state=getattr(runner, "cur_state", None),
            mesh=dict(runner.mesh.shape), grouped=getattr(fw, "loss_group", None) is not None,
            heads=_numpy({k: v for k, v in runner.state.net.state_dict().items()}))
        if run.get("test"):
            res = test_cli.main(run["test"] + ["--launcher", "pytorch"])
            out[run["name"]]["test"] = None if res is None else {
                k: float(v) for k, v in res.items()}
    return out


class ToyNet(torch.nn.Module):
    """``tests/test_fsdp_amp.py``'s toy: relu(x @ dense + b) @ head, the
    mean squared error against y."""

    def __init__(self):
        super().__init__()
        self.dense_kernel = torch.nn.Parameter(torch.zeros(256, 128))
        self.dense_bias = torch.nn.Parameter(torch.zeros(128))
        self.head_kernel = torch.nn.Parameter(torch.zeros(128, 8))

    def forward(self, x, y):
        h = torch.relu(x @ self.dense_kernel + self.dense_bias)
        return torch.mean((h @ self.head_kernel - y) ** 2)


JOBS = {"ddp_neuralrecon": job_ddp_neuralrecon, "mesh": job_mesh, "halo": job_halo,
        "ba": job_ba, "sync_bn_fsdp": job_sync_bn_fsdp, "ddp_frameworks": job_ddp_frameworks,
        "ddp_runtime": job_ddp_runtime, "ddp_cli": job_ddp_cli}


def main():
    job, rank, world, init, tmp_dir, kw = sys.argv[1:7]
    sys.path.insert(0, ROOT)
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=int(rank),
                            world_size=int(world))
    try:
        out = JOBS[job](**json.loads(kw))
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(tmp_dir, f"{job}_rank{rank}.pt"))


if __name__ == "__main__":
    main()
