#!/usr/bin/env python
"""Training CLI (port of ``tools/train.py``): datasets, framework and runner
from a Python config file, the training hooks, the workflow.  Usage:

    python -m deep3dmap_tpu_torch.tools.train configs/neural_recon/scannet_synthetic.py \\
        [--work-dir D] [--resume-from auto|PATH] [--seed N] [--max-epochs N] \\
        [--cfg-options k=v ...] [--device cuda|cpu]

It trains on the card (``--device cuda``, the default), and raises on a
machine without one unless ``--device cpu`` is given.  The config's
``runner.type`` picks the loop: ``EpochBasedRunner`` (NeuralRecon, and
PRNet's ``FaceImg2UV`` on ``SyntheticFaceUVDataset`` or
``ThreeHundredWLPDataset``, ``configs/prnet/``), ``Gan2ShapeRunner``
(``configs/gan2shape/``: one instance an epoch, its mask from the parsing
model when ``use_mask`` is set) or ``StateMachineRunner`` (imgs2mesh,
``configs/pt3d_demos/``: ``Imgs2Mesh`` on ``SyntheticFaceTupleDataset`` or
``MultiPIEFaceTupleDataset``, the state switching by epoch; GNeRF,
``configs/gnerf/``: ``GanNerf`` on ``SyntheticNerfDataset``,
``BlenderDataset`` or ``DTUDataset`` through the states ``A``, ``ABAB``,
``B``, sized by ``need_info_from_datasets``) or ``IterBasedRunner`` (LERF,
``configs/lerf/``: ``LERFModel`` on ``LERFRayDataset``, a fixed
``runner_cfgs.max_iters``, raised with ``--cfg-options`` to resume further).  A config's
``evaluation`` is ignored, as the JAX CLI ignores it (``custom_hooks`` take
an ``EvalHook``).  With ``D3M_HEARTBEAT_FILE`` set (the elastic supervisor,
``tools/run_elastic.py``, sets it) a ``HeartbeatHook`` writes there every
``D3M_HEARTBEAT_INTERVAL`` iterations (10).

More than one card: ``--launcher pytorch`` under ``torchrun`` (the twin of
JAX's ``--launcher jax``), one process per card:

    torchrun --nproc_per_node N -m deep3dmap_tpu_torch.tools.train CONFIG \
        --launcher pytorch [--work-dir D]

Each rank's loader yields its own batches (``DistributedSampler``; LERF's
ray batches are alike on every rank, which keeps its slice), the mesh
comes from ``cfg.mesh`` (``axes`` and ``shape``, JAX's keys; all ranks on
``data`` by default) and the runner takes it (``BaseRunner``): every
framework's batch reductions are the global batch's and the gradients are
summed over ``data``; Gan2Shape's one instance runs whole on every rank.
Rank 0 logs and saves.  ``--device cpu`` runs the ranks on gloo.  Every
workload has a launcher script, ``deep3dmap_tpu_torch/scripts/<workload>/
run_*.sh`` (``GPUS=N``).
"""
import argparse
import os
import os.path as osp

from ..utils.config import DictAction


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Train a 3D reconstruction model")
    parser.add_argument("config", help="config file path")
    parser.add_argument("--work-dir", help="dir to save logs and checkpoints")
    parser.add_argument("--resume-from", help="checkpoint to resume from ('auto' = latest)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--max-epochs", type=int, default=None, help="override epochs")
    parser.add_argument("--no-validate", action="store_true")
    parser.add_argument("--launcher", choices=["none", "pytorch"], default="none",
                        help="pytorch: torchrun's environment, one process per card")
    parser.add_argument("--cfg-options", nargs="+", action=DictAction,
                        help="override config entries: key=value")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; raises without a GPU) or cpu")
    return parser.parse_args(argv)


def training_datasets(cfg, device, validate: bool = True):
    """The train split, and the val split when the workflow has more than
    one entry (JAX's ``tools/train.py``)."""
    from ..datasets.builder import build_dataset

    datasets = [build_dataset(cfg.data["train"], default_args=dict(device=device))]
    if len(cfg.get("workflow", [("train", 1)])) > 1 and "val" in cfg.data and validate:
        datasets.append(build_dataset(cfg.data["val"], default_args=dict(device=device)))
    return datasets


def main(argv=None):
    """Runs the training and returns the runner."""
    args = parse_args(argv)

    from ..datasets.builder import build_dataloader
    from ..models.builder import build_reconstruction
    from ..parallel.mesh import get_dist_info, init_dist, make_mesh
    from ..runners.builder import build_runner
    from ..utils.config import Config
    from ..utils.device import make_deterministic, resolve_device
    from ..utils.logging import get_root_logger

    cfg = Config.fromfile(args.config)
    if args.cfg_options:
        cfg.merge_from_dict(args.cfg_options)
    if args.launcher == "pytorch":
        init_dist(device=args.device)
    rank, world = get_dist_info()
    device = resolve_device(args.device)
    make_deterministic()

    work_dir = args.work_dir or cfg.get("work_dir", "./work_dir")
    os.makedirs(work_dir, exist_ok=True)
    logger = get_root_logger(log_file=osp.join(work_dir, "train.log"), rank=rank)
    logger.info(f"Config: {args.config}  device={device}  rank={rank}/{world}")
    mesh_cfg = cfg.get("mesh", {})
    mesh = make_mesh(axes=mesh_cfg.get("axes", ("data",)), shape=mesh_cfg.get("shape"),
                     device=device)

    datasets = training_datasets(cfg, device, validate=not args.no_validate)
    workflow = [tuple(w) for w in cfg.get("workflow", [("train", 1)])]
    framework = build_reconstruction(cfg.model, device=device)
    if cfg.get("need_info_from_datasets") and hasattr(framework, "set_info_from_datasets"):
        framework.set_info_from_datasets(datasets)
    # a framework with set_mesh takes its rank's share of the samples; one
    # without runs every batch whole on every rank (JAX's replicated batch)
    loaders = [build_dataloader(ds, samples_per_gpu=cfg.data.get("samples_per_gpu", 1),
                                workers_per_gpu=cfg.data.get("workers_per_gpu", 0),
                                dist=world > 1 and hasattr(framework, "set_mesh"),
                                shuffle=True, seed=args.seed)
               for ds in datasets]

    runner_cfg = dict(cfg.runner)
    runner_type = runner_cfg.pop("type", "EpochBasedRunner")
    runner_cfgs = dict(runner_cfg.pop("runner_cfgs", {}))
    if args.max_epochs is not None:
        runner_cfgs["max_epochs"] = args.max_epochs
    runner = build_runner(dict(type=runner_type, **runner_cfg),
                          default_args=dict(framework=framework, work_dir=work_dir,
                                            mesh=mesh, seed=args.seed,
                                            runner_cfgs=runner_cfgs))

    sample_batch = next(iter(loaders[0]))
    runner.setup(sample_batch,
                 optimizer=runner_cfgs.get("optimizer"),
                 lr_config=cfg.get("lr_config"),
                 optimizer_config=cfg.get("optimizer_config"),
                 iters_per_epoch=len(loaders[0]))
    runner.register_training_hooks(
        checkpoint_config=cfg.get("checkpoint_config"),
        log_config=cfg.get("log_config"))
    for hook_cfg in cfg.get("custom_hooks", []):
        runner.register_hook_from_cfg(dict(hook_cfg))
    # the elastic supervisor's liveness beacon (tools/run_elastic.py sets it)
    hb = os.environ.get("D3M_HEARTBEAT_FILE")
    if hb:
        runner.register_hook_from_cfg(dict(
            type="HeartbeatHook", path=hb,
            interval=int(os.environ.get("D3M_HEARTBEAT_INTERVAL", "10"))))

    if args.resume_from:
        runner.resume(None if args.resume_from == "auto" else args.resume_from)
    elif cfg.get("resume_from"):
        runner.resume(cfg.resume_from)

    runner.run(loaders, workflow)
    logger.info("Training finished.")
    return runner


if __name__ == "__main__":
    main()
