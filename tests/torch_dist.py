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
        out["counts"] = dict(collectives.counts)
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
        res[-1]["counts"] = dict(collectives.counts)
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
        "ba": job_ba, "sync_bn_fsdp": job_sync_bn_fsdp}


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
