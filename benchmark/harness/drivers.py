"""The drivers of the two traffic kinds, ``train`` and ``stream``: set-up,
the measured window, the traced window, and the reference's check.

The program (``deep3dmap_tpu_torch``) is imported here and nowhere else in
the harness.  It runs as its runners run it: cuDNN's TF32 on and the
matmuls' off (PyTorch's defaults), cuDNN deterministic
(``make_deterministic``).  The reference runs after the program's state is
freed, in float32 with TF32 off, rounding only the model's gather table.

``fault`` (tests and ``calibrate.py``) breaks the timed path on purpose:
``frozen`` (a step or fragment hands back its state unchanged),
``half_batch`` (each step sees the first half of its batch only),
``altered`` (each streamed answer is changed where it is produced).
"""
from __future__ import annotations

import dataclasses
import gc
import time
from typing import Callable, Dict, List, Optional

import torch

from ..reference import neuralrecon as ref
from ..reference.optim import ClipAdam
from . import check, scene, weights, yardstick
from .cells import Cell
from .trace import Traced


# --------------------------------------------------------------------------
# the program
# --------------------------------------------------------------------------

class Program:
    """The port's entry points, each wrapped by the run's fault, if any."""

    def __init__(self, cell: Cell, seed: int, device, fault: Optional[str] = None):
        from deep3dmap_tpu_torch.models.frameworks.neuralrecon import NeuralRecon
        from deep3dmap_tpu_torch.runners import train_state
        from deep3dmap_tpu_torch.runners.optim import build_optimizer
        from deep3dmap_tpu_torch.utils.device import make_deterministic

        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = False
        make_deterministic()
        self.cfg = cell.config
        self.fault = fault
        self.fw = NeuralRecon(self.cfg["model_cfgs"], device=device)
        self.net = self.fw.net.to(device)
        tree = ref.RefNet(self.cfg["model_cfgs"])
        weights.load(self.net, weights.draw(tree, scene.mix(seed, 0), device))
        self._train_state = train_state
        self._build_optimizer = build_optimizer
        self.captured: List[dict] = []
        self._hook = None

    # -- the per-level outputs of the compared calls ------------------------
    def capture(self, on: bool) -> None:
        """While on, each forward of the net leaves its per-level occupancy
        logits and masks (device tensors) in ``captured``."""
        if on and self._hook is None:
            def hook(_m, _inp, out):
                self.captured.append({
                    "occ": [o.detach()[..., 0] for o in out["occ"]],
                    "mask": [m.detach().bool() for m in out["sparse_mask"]]})
            self._hook = self.net.register_forward_hook(hook)
        elif not on and self._hook is not None:
            self._hook.remove()
            self._hook = None

    def drain(self) -> List[dict]:
        """The captured outputs, copied to the host."""
        out = [{k: [t.cpu() for t in v] for k, v in c.items()} for c in self.captured]
        self.captured = []
        return out

    # -- training ----------------------------------------------------------
    def train_state(self, batch: int):
        opt = self._build_optimizer(dict(self.cfg["optimizer"]), self.net.parameters(),
                                    dict(self.cfg["grad_clip"]))
        return self._train_state.TrainState(net=self.net, optimizer=opt,
                                            model_state=self.fw.init_state(batch))

    def step(self, state, batch):
        ts = self._train_state
        if self.fault == "frozen":
            loss, _ = self.fw.loss_fn(state.net, state.model_state, batch)
            return state, {"loss": loss.detach()}
        if self.fault == "half_batch":
            half = batch["imgs"].shape[0] // 2
            cut = {k: ([x[:half] for x in v] if isinstance(v, list) else v[:half])
                   for k, v in batch.items()}
            vols = state.model_state["global_hidden"].volumes
            ms = dict(state.model_state, global_hidden=state.model_state["global_hidden"]
                      ._replace(volumes=tuple(v[:half] for v in vols)))
            new, log = ts.train_step(self.fw, dataclasses.replace(state, model_state=ms), cut)
            kept = tuple(torch.cat([a, b[half:]]) for a, b in
                         zip(new.model_state["global_hidden"].volumes, vols))
            gh = new.model_state["global_hidden"]._replace(volumes=kept)
            return dataclasses.replace(new, model_state=dict(new.model_state,
                                                             global_hidden=gh)), log
        return ts.train_step(self.fw, state, batch)

    # -- streaming ---------------------------------------------------------
    def stream_state(self):
        return self.fw.init_state(1)

    def fragment(self, state, batch):
        out, new = self.fw.forward_test(self.net, state, batch)
        if self.fault == "frozen":
            return out, state
        if self.fault == "altered":
            out = dict(out, tsdf=out["tsdf"] - 0.05)
        return out, new


def _adam_first_moments(state) -> Dict[str, torch.Tensor]:
    """name -> Adam's first moment of each parameter the optimizer holds."""
    adam = getattr(state.optimizer, "adam", None)
    if adam is None:
        return {}
    return {n: adam.state[p]["exp_avg"] for n, p in state.net.named_parameters()
            if p in adam.state and "exp_avg" in adam.state[p]}


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _settle(device) -> None:
    """Before a measured window: the device idle, the garbage collector's
    survivors moved out of its way (it then walks only what the window
    allocates)."""
    _sync(device)
    gc.collect()
    gc.freeze()


def free_device(device):
    gc.unfreeze()
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def _levels(cfg: dict):
    m = ref.resolve(cfg["model_cfgs"])
    return m["n_vox"], m["voxel_size"], m["n_layers"]


# --------------------------------------------------------------------------
# the reference side
# --------------------------------------------------------------------------

def reference_net(cell: Cell, seed: int, device) -> ref.RefNet:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    net = ref.RefNet(cell.config["model_cfgs"]).to(device)
    weights.load(net, weights.draw(net, scene.mix(seed, 0), device))
    return net


def _ref_inputs(net, b):
    return (ref.normalise_images(net, b["imgs"]), b["proj_matrices"],
            b["vol_origin_partial"], b["world_to_aligned_camera"])


def ref_loss_and_grads(net: ref.RefNet, batch: dict, prec: ref.Precision, chunk: int,
                       params: List[torch.Tensor], follow: List[torch.Tensor],
                       flops: Optional[list] = None):
    """The loss of a training batch and its gradients, the levels' voxels
    decided by ``follow`` (per level the program's occupancy).  Every
    training batch resets its scene, so the hidden windows are zero.  In
    chunks of ``chunk`` fragments, each chunk's share of the loss taken
    against the whole batch's mask counts (the loss is linear in the
    chunks' sums once the counts are fixed).  ``flops``, a list, gets each
    chunk's operations, forward and backward."""
    imgs, proj, origin, w2ac = _ref_inputs(net, batch)
    B = imgs.shape[0]
    c = net.cfg
    L = c["n_layers"]
    dev = imgs.device
    counts = []
    for i in range(L):
        m = ref.level_sets(c, i, follow[i - 1] if i else None, B, dev)[4].float()
        counts.append(torch.stack([m.sum(), (m * batch["occ_list"][L - 1 - i]).sum()]))

    def chunk_pass(sl):
        n = len(range(*sl.indices(B)))
        hid = [torch.zeros((n, ch, d, d, d), device=dev)
               for ch, d in zip(c["channels"], c["dims"])]
        out = ref.forward(net, imgs[sl], proj[sl], origin[sl], w2ac[sl], hid, prec,
                          follow=[f[sl] for f in follow])
        lc = ref.loss(net, out, [t[sl] for t in batch["tsdf_list"]],
                      [o[sl] for o in batch["occ_list"]], counts=counts)
        return lc, torch.autograd.grad(lc, params, allow_unused=True)

    total, grads = 0.0, None
    for lo in range(0, B, chunk):
        sl = slice(lo, min(lo + chunk, B))
        if flops is None:
            lc, gs = chunk_pass(sl)
        else:
            box = {}
            flops.append(yardstick.count_flops(lambda: box.update(r=chunk_pass(sl))))
            lc, gs = box["r"]
        gs = [torch.zeros_like(p) if g is None else g for p, g in zip(params, gs)]
        grads = gs if grads is None else [a + b for a, b in zip(grads, gs)]
        total = total + lc.detach()
        del lc, gs
        free_device(dev)
    return float(total), grads


def reference_train(cell: Cell, seed: int, batches: List[dict],
                    decisions: Optional[List[dict]], device,
                    prec: Optional[ref.Precision] = None, count_flops: bool = False) -> dict:
    """The reference's first steps on ``batches``, each following the
    program's decisions of that step (or, with ``decisions`` None, its own,
    which it then returns as ``decisions``): losses, the first clipped
    gradient's leaf norms, each leaf's change over the steps; with
    ``count_flops`` the operations of the first step (forward and backward,
    no recomputation)."""
    net = reference_net(cell, seed, device)
    prec = prec or ref.Precision.for_reference(cell.config["precision"])
    names = [n for n, _ in net.named_parameters()]
    params = [p for _, p in net.named_parameters()]
    opt_cfg = cell.config["optimizer"]
    opt = ClipAdam(params, opt_cfg["lr"], cell.config["grad_clip"]["max_norm"],
                   tuple(opt_cfg.get("betas", (0.9, 0.999))), opt_cfg.get("eps", 1e-8))
    p0 = {n: p.detach().clone() for n, p in zip(names, params)}
    chunk = cell.traffic["reference_chunk"]
    out = {"losses": [], "flops": None, "decisions": []}
    for k, b in enumerate(batches):
        flops = [] if (k == 0 and count_flops) else None
        if decisions is None:
            with torch.no_grad():
                own = _own_decisions(net, b, prec)
            out["decisions"].append(own)
            follow = _follow(net.cfg, own, device, b["imgs"].shape[0])
        else:
            follow = _follow(net.cfg, decisions[k], device, b["imgs"].shape[0])
        loss, grads = ref_loss_and_grads(net, b, prec, chunk, params, follow, flops)
        if flops is not None:
            out["flops"] = sum(flops)
        clipped = opt.step(grads)
        out["losses"].append(loss)
        if k == 0:
            out["grad_norms"] = check.norms(dict(zip(names, clipped)))
        del grads, clipped
    out["change_norms"] = check.norms({n: p.detach() - p0[n] for n, p in zip(names, params)})
    del net, opt, p0
    free_device(device)
    return out


def _follow(c: dict, captured: dict, device, rows: int = None) -> List[torch.Tensor]:
    """Per level, the occupancy the program's forward decided; rows of the
    batch it did not compute on (a broken program) are followed as empty."""
    occ = [o.to(device) for o in ref.occupancy(c, captured["occ"], captured["mask"])]
    if rows is not None and occ[0].shape[0] < rows:
        occ = [torch.cat([o, o.new_zeros((rows - o.shape[0],) + o.shape[1:])]) for o in occ]
    return occ


def _own_decisions(net: ref.RefNet, b: dict, prec: ref.Precision) -> dict:
    """A training batch's per-level occupancy logits and masks as ``net``
    decides them itself (zero hidden windows: every training batch resets)."""
    c = net.cfg
    B = b["imgs"].shape[0]
    hid = [torch.zeros((B, ch, d, d, d), device=b["imgs"].device)
           for ch, d in zip(c["channels"], c["dims"])]
    o = ref.forward(net, *_ref_inputs(net, b), hid, prec)
    return {"occ": o["occ"], "mask": o["mask"]}


def reference_stream(cell: Cell, seed: int, frags: List[dict],
                     decisions: Optional[List[dict]], device,
                     prec: Optional[ref.Precision] = None, count_flops: bool = False) -> dict:
    """The reference's replay of ``frags`` from zero state, each fragment
    following the program's decisions of that fragment (or, with
    ``decisions`` None, its own, returned as ``decisions``): each answer (the
    last level's tsdf where the decisions mark it occupied, 1 elsewhere, and
    its occupancy) and the global hidden volumes after the last."""
    net = reference_net(cell, seed, device)
    prec = prec or ref.Precision.for_reference(cell.config["precision"])
    vols = ref.zero_volumes(net, 1, device)
    answers, own, flops = [], [], None
    with torch.no_grad():
        for k, b in enumerate(frags):
            starts = ref.window_starts(net, b["vol_origin_partial"], b["vol_origin"])
            hid = ref.read_hidden(net, vols, starts)
            follow = None if decisions is None else _follow(net.cfg, decisions[k], device)
            if k == 0 and count_flops:
                flops = yardstick.count_flops(
                    lambda: ref.forward(net, *_ref_inputs(net, b), hid, prec, follow=follow))
            o = ref.forward(net, *_ref_inputs(net, b), hid, prec, follow=follow)
            if follow is None:
                own.append({"occ": o["occ"], "mask": o["mask"]})
                follow = o["occupied"]
            answers.append({"tsdf": torch.where(follow[-1], o["tsdf"][-1],
                                                torch.ones_like(o["tsdf"][-1])),
                            "occ": torch.sigmoid(o["occ"][-1])})
            vols = ref.write_hidden(net, vols, starts, o["hidden"], prec)
    del net
    return {"answers": answers, "hidden": vols, "flops": flops, "decisions": own}


# --------------------------------------------------------------------------
# training cells
# --------------------------------------------------------------------------

def program_first_steps(prog: Program, state, batches: List[dict]):
    """The window's own step on the first batches (rows that all differ):
    their losses, the first gradient as the optimizer got it (from Adam's
    first moment after one step), each leaf's change over the steps."""
    p0 = {n: p.detach().clone() for n, p in state.net.named_parameters()}
    beta1 = tuple(prog.cfg["optimizer"].get("betas", (0.9, 0.999)))[0]
    losses, decisions = [], []
    first = {}
    prog.capture(True)
    for k, b in enumerate(batches):
        state, log = prog.step(state, b)
        losses.append(log["loss"])
        decisions.extend(prog.drain())
        if k == 0:
            first = {n: m / (1.0 - beta1) for n, m in _adam_first_moments(state).items()}
            first = check.norms(first) if first else {}
    prog.capture(False)
    change = check.norms({n: p.detach() - p0[n] for n, p in state.net.named_parameters()})
    return state, dict(losses=[float(x) for x in losses], grad_norms=first,
                       change_norms=change, decisions=decisions)


def run_train(cell: Cell, seed: int, seconds: float, trace: bool, device, t0: float,
              fault: Optional[str] = None) -> dict:
    tr, cfg = cell.traffic, cell.config
    B, V, hw = cfg["batch"], tr["views"], tuple(tr["image_hw"])
    n_vox, vs, L = _levels(cfg)
    n_check = tr["check_steps"]
    prog = Program(cell, seed, device, fault)
    pool = scene.train_pool(seed, tr["pool_fragments"] // B, B, V, hw, n_vox, vs, L, device)
    state = prog.train_state(B)
    state, prog_first = program_first_steps(prog, state, pool[:n_check])
    _settle(device)
    setup_s = time.perf_counter() - t0

    losses, n = [], 0
    start = time.perf_counter()
    while True:
        state, log = prog.step(state, pool[(n_check + n) % len(pool)])
        losses.append(log["loss"])
        n += 1
        if time.perf_counter() - start >= seconds:
            break
    _sync(device)
    window_s = time.perf_counter() - start
    failed = int((~torch.isfinite(torch.stack(losses))).sum())
    peak = _peak(device)

    traced = None
    if trace:
        k_tr = tr["trace_steps"]
        box = [state]

        def steps():
            for j in range(k_tr):
                box[0], _ = prog.step(box[0], pool[(n_check + n + j) % len(pool)])
            _sync(device)
        traced = Traced(steps)
        state = box[0]
    del state, prog, losses, log
    keep = pool[:n_check]
    del pool
    free_device(device)

    t_check = time.perf_counter()
    ref_first = reference_train(cell, seed, keep, prog_first["decisions"], device,
                                count_flops=trace)
    t_check = time.perf_counter() - t_check
    numbers = check.train_numbers(ref.resolve(cfg["model_cfgs"]), prog_first, ref_first, B)
    ctx = dict(kind="train", trace=traced, units=n, window_s=window_s,
               units_traced=tr["trace_steps"], flops_per_unit=ref_first["flops"],
               peak_flops=yardstick.PEAK_FLOPS[cfg["mfu_peak"]],
               loss_least_s=yardstick.loss_least_seconds(_loss_levels(cfg, B)))
    e2e = {"train_keyframes_per_s": n * B * V / window_s, "peak_mem_gib": peak / 2 ** 30,
           "setup_s": setup_s}
    return _result(cell, numbers, n, failed, e2e, ctx, peak, traced, trace,
                   info=dict(steps=n, window_s=window_s, batch=B, check_s=t_check,
                             losses=prog_first["losses"], ref_losses=ref_first["losses"]))


def _loss_levels(cfg: dict, B: int) -> List[dict]:
    """The loss kernels' inputs per level: the predictions float32 (the
    heads' output), targets float32 (the scene's), the mask bool."""
    m = ref.resolve(cfg["model_cfgs"])
    return [dict(n=B * d ** 3, pred="float32", tsdf_t="float32", occ_t="float32",
                 mask="bool") for d in m["dims"]]


# --------------------------------------------------------------------------
# streaming cells
# --------------------------------------------------------------------------

def program_pass(prog: Program, frags: List[dict]):
    """The path's first pass from zero state, through the timed entry: the
    answers, the per-level decisions and the hidden volumes after it (host
    copies)."""
    state = prog.stream_state()
    answers, decisions = [], []
    prog.capture(True)
    for b in frags:
        out, state = prog.fragment(state, b)
        answers.append({"tsdf": out["tsdf"].cpu(), "occ": out["occ"].cpu()})
        decisions.extend(prog.drain())
    prog.capture(False)
    hidden = [v.cpu() for v in state["global_hidden"].volumes]
    return answers, decisions, hidden


def run_stream(cell: Cell, seed: int, seconds: float, trace: bool, device, t0: float,
               fault: Optional[str] = None) -> dict:
    tr, cfg = cell.traffic, cell.config
    V, hw = tr["views"], tuple(tr["image_hw"])
    n_vox, vs, L = _levels(cfg)
    prog = Program(cell, seed, device, fault)
    frags = scene.stream_path(seed, tr["path_fragments"], V, hw, n_vox, vs, L,
                              tr["scene_m"], tr["spheres"], tr["path_radius_m"], device)
    n_path = len(frags)
    st = prog.stream_state()
    for k in range(tr["warmup_fragments"]):
        _, st = prog.fragment(st, frags[k])
    del st
    free_device(device)
    _settle(device)
    setup_s = time.perf_counter() - t0

    state = prog.stream_state()
    lat, answers, decisions, hidden = [], [], [], None
    bad = torch.zeros((), dtype=torch.int64, device=device)
    paused, k = 0.0, 0
    prog.capture(True)
    start = time.perf_counter()
    while True:
        ts = time.perf_counter()
        out, state = prog.fragment(state, frags[k % n_path])
        _sync(device)
        lat.append(time.perf_counter() - ts)
        bad += (~torch.isfinite(out["tsdf"])).any()
        if k < n_path:
            # the first pass's answers, and the state after it, leave the
            # card with the clock stopped
            tp = time.perf_counter()
            answers.append({"tsdf": out["tsdf"].cpu(), "occ": out["occ"].cpu()})
            decisions.extend(prog.drain())
            if k == n_path - 1:
                hidden = [v.cpu() for v in state["global_hidden"].volumes]
                prog.capture(False)
            paused += time.perf_counter() - tp
        k += 1
        if k >= n_path and time.perf_counter() - start - paused >= seconds:
            break
    _sync(device)
    window_s = time.perf_counter() - start - paused
    failed = int(bad)
    peak = _peak(device)

    traced = None
    if trace:
        box = [state]

        def fragments():
            for j in range(tr["trace_fragments"]):
                _, box[0] = prog.fragment(box[0], frags[(k + j) % n_path])
                _sync(device)
        traced = Traced(fragments)
        del box
    del state, prog, out
    free_device(device)

    t_check = time.perf_counter()
    refd = reference_stream(cell, seed, frags, decisions, device, count_flops=trace)
    t_check = time.perf_counter() - t_check
    numbers = check.stream_numbers(ref.resolve(cfg["model_cfgs"]), answers, decisions,
                                   hidden, refd)
    ctx = dict(kind="stream", trace=traced, units=k, window_s=window_s,
               units_traced=tr["trace_fragments"], flops_per_unit=refd["flops"],
               peak_flops=yardstick.PEAK_FLOPS[cfg["mfu_peak"]])
    lat_ms = [x * 1e3 for x in lat]
    e2e = {"stream_keyframes_per_s": k * V / window_s,
           "stream_fragment_ms_p95": yardstick.percentile(lat_ms, 95),
           "peak_mem_gib": peak / 2 ** 30, "setup_s": setup_s}
    return _result(cell, numbers, k, failed, e2e, ctx, peak, traced, trace,
                   info=dict(fragments=k, window_s=window_s, paused_s=paused, check_s=t_check,
                             fragment_ms_median=yardstick.percentile(lat_ms, 50),
                             fragment_ms_max=max(lat_ms)))


# --------------------------------------------------------------------------
# the result
# --------------------------------------------------------------------------

def _peak(device) -> int:
    if torch.device(device).type == "cuda":
        return int(torch.cuda.max_memory_allocated())
    return 0


def _result(cell: Cell, numbers, attempted, failed, e2e, ctx, peak, traced, trace, info):
    limits = cell.limits
    correct = check.judge(numbers, limits) and failed == 0
    if trace:
        metrics = {}
        for m in cell.per_layer:
            v = m.reader(ctx)
            if v is not None:
                metrics[m.name] = {"value": v, "unit": m.unit}
    else:
        metrics = {m.name: {"value": e2e[m.name], "unit": m.unit} for m in cell.end_to_end}
    device = {"platform": "gpu", "kind": _device_name(), "count": cell.chips,
              "memory_peak_bytes": peak}
    result = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
              "metrics": metrics, "device": device}
    if traced is not None:
        device["busy_s"] = traced.busy_s
        device["window_s"] = traced.window_s
        result["breakdown"] = {"device_ops": traced.device_ops,
                               "idle_gaps": traced.idle_gaps}
    result["checks"] = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    return {"result": result, "info": info, "numbers": numbers}


def _device_name() -> str:
    return torch.cuda.get_device_name(0) if torch.cuda.is_available() else "cpu"


DRIVERS: Dict[str, Callable] = {"train": run_train, "stream": run_stream}


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device, t0: float,
             fault: Optional[str] = None) -> dict:
    return DRIVERS[cell.traffic["driver"]](cell, seed, seconds, trace, device, t0, fault)
