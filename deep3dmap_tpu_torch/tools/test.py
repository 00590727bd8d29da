#!/usr/bin/env python
"""Evaluation CLI (port of ``tools/test.py``): load a checkpoint, stream the
test split through ``forward_test`` with the recurrent state carried, build
scene meshes (``core/utils/scene_assembler.py``), save them as ``.ply`` and
print ``dataset.evaluate(...)`` as the last line.  Usage:

    python -m deep3dmap_tpu_torch.tools.test CONFIG [--checkpoint auto|PATH] \\
        [--work-dir D] [--out DIR] [--eval depth_mesh] [--cfg-options k=v ...] \\
        [--device cuda|cpu]

Gan2Shape's test split goes through the same loop: ``forward_test`` from
the checkpoint's heads, no scenes, and no ``evaluate`` (its datasets have
none).  So do the face workloads: PRNet (``configs/prnet/``, ``FaceImg2UV``
on ``SyntheticFaceUVDataset`` or ``ThreeHundredWLPDataset``, ``--eval nme``)
and imgs2mesh (``configs/pt3d_demos/``, ``Imgs2Mesh`` on
``SyntheticFaceTupleDataset`` or ``MultiPIEFaceTupleDataset``, whose
per-view outputs are collected as (V, B, ...) arrays; no ``evaluate``).  Without a checkpoint (none given and none in the work dir) it
evaluates the seeded initial weights.  ``--launcher pytorch`` under
``torchrun``: every rank streams the whole split in order, with the
recurrent state carried, as JAX's jitted forward does over its mesh
(``cfg.mesh``, as ``tools/train.py`` reads it): a batch whose size divides
over ``data`` is split over it and its outputs gathered back, one that
does not runs whole on every rank (``runners/forward_engine.py``'s
``local_batch``/``global_outputs``, ``shard_batch``'s rule); with a
``model`` axis NeuralRecon's global volumes are sharded as in training.
Rank 0 assembles the scenes and evaluates.  It runs on the card (``--device cuda``, the
default) and raises on a machine without one unless ``--device cpu`` is
given.

GNeRF (``configs/gnerf/``, ``GanNerf`` on ``SyntheticNerfDataset``,
``BlenderDataset`` or ``DTUDataset``) renders the test split at the learned
val poses (``forward_test``, the test items' indices into them) and
collects ``rgb`` and ``depth``; no ``evaluate``.  Its nets are sized by the
training datasets (``need_info_from_datasets``: the intrinsics and the
numbers of train and val poses), so the CLI builds the datasets
``tools/train.py`` builds from the same config and hands them to
``set_info_from_datasets`` before the checkpoint loads.  (JAX's
``tools/test.py`` does not, and its GNeRF cannot render without
intrinsics.)
"""
import argparse
import os.path as osp

import numpy as np
import torch

from ..utils.config import DictAction


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Test a 3D reconstruction model")
    parser.add_argument("config")
    parser.add_argument("--checkpoint", help="checkpoint path ('auto' = latest in work_dir)")
    parser.add_argument("--work-dir")
    parser.add_argument("--out", help="directory for saved meshes/results")
    parser.add_argument("--eval", nargs="+", help="evaluation metrics, e.g. depth_mesh")
    parser.add_argument("--cfg-options", nargs="+", action=DictAction)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; raises without a GPU) or cpu")
    parser.add_argument("--launcher", choices=["none", "pytorch"], default="none",
                        help="pytorch: torchrun's environment, one process per card")
    return parser.parse_args(argv)


def _numeric(v) -> bool:
    leaves = v if isinstance(v, (list, tuple)) else [v]
    return bool(leaves) and all(
        isinstance(x, (int, float, np.number))
        or (isinstance(x, np.ndarray) and x.dtype.kind in "bifuc") for x in leaves)


def _to_host(v):
    """Tensors, and lists of them (imgs2mesh's per-view outputs), as numpy."""
    if isinstance(v, torch.Tensor):
        return v.float().cpu().numpy()
    if isinstance(v, (list, tuple)) and v and all(isinstance(x, torch.Tensor) for x in v):
        return [x.float().cpu().numpy() for x in v]
    return v


def _stacked_shape(batches):
    """The shape of per-batch arrays stacked along their first axis, or None
    where they are not arrays of one trailing shape."""
    if not all(isinstance(x, np.ndarray) and x.ndim for x in batches) \
            or len({x.shape[1:] for x in batches}) != 1:
        return None
    return (sum(len(x) for x in batches),) + batches[0].shape[1:]


def split_meta(batch):
    """Numeric entries go to the device; strings and objects stay on the
    host."""
    dev, meta = {}, {}
    for k, v in batch.items():
        (dev if _numeric(v) else meta)[k] = v
    return dev, meta


def main(argv=None):
    """Runs the evaluation and returns ``dataset.evaluate``'s dict (None
    without ``--eval``)."""
    args = parse_args(argv)

    from ..datasets.builder import build_dataloader, build_dataset
    from ..models.builder import build_reconstruction
    from ..parallel.mesh import get_dist_info, init_dist, make_mesh
    from ..runners.checkpoint import latest_checkpoint
    from ..runners.forward_engine import global_outputs, load_for_test, local_batch
    from .train import training_datasets
    from ..utils.config import Config
    from ..utils.device import resolve_device
    from ..utils.logging import get_root_logger

    cfg = Config.fromfile(args.config)
    if args.cfg_options:
        cfg.merge_from_dict(args.cfg_options)
    if args.launcher == "pytorch":
        init_dist(device=args.device)
    rank, world = get_dist_info()
    device = resolve_device(args.device)
    work_dir = args.work_dir or cfg.get("work_dir", "./work_dir")
    logger = get_root_logger(rank=rank)

    dataset = build_dataset(cfg.data["test"], default_args=dict(device=device))
    loader = build_dataloader(dataset, samples_per_gpu=cfg.data.get("samples_per_gpu", 1),
                              workers_per_gpu=cfg.data.get("workers_per_gpu", 0),
                              shuffle=False)
    framework = build_reconstruction(cfg.model, device=device)
    if cfg.get("need_info_from_datasets") and hasattr(framework, "set_info_from_datasets"):
        framework.set_info_from_datasets(training_datasets(cfg, device))
    mesh = None
    spatial = False
    if world > 1:
        mesh_cfg = cfg.get("mesh", {})
        mesh = make_mesh(axes=mesh_cfg.get("axes", ("data",)), shape=mesh_cfg.get("shape"),
                         device=device)
        spatial = bool(hasattr(framework, "set_mesh") and framework.set_mesh(mesh))

    batch0, _ = split_meta(next(iter(loader)))
    net, mstate = framework.init(0, local_batch(batch0, mesh))

    ckpt = args.checkpoint
    if ckpt in (None, "auto"):
        ckpt = latest_checkpoint(work_dir)
    if ckpt:
        mstate = load_for_test(ckpt, net, mstate, device, mesh, spatial)
        logger.info(f"Loaded checkpoint {ckpt}")

    assembler = None
    if cfg.model.get("model_cfgs", {}).get("save_scene"):
        from ..core.utils.scene_assembler import SceneAssembler
        assembler = SceneAssembler(
            voxel_size=cfg.model["model_cfgs"].get("VOXEL_SIZE", 0.04),
            save_dir=args.out or osp.join(work_dir, "meshes"))

    batches = []
    for i, raw in enumerate(loader):
        batch, meta = split_meta(raw)
        out, mstate = framework.forward_test(net, mstate, local_batch(batch, mesh))
        out = global_outputs(out, batch, mesh)
        batches.append(({k: _to_host(v) for k, v in out.items()}, meta))
        logger.info(f"batch {i + 1}/{len(loader)} done")
    if rank != 0:
        return None

    outputs = {}
    for i, (out, meta) in enumerate(batches):
        for k, v in out.items():
            outputs.setdefault(k, []).append(np.asarray(v))
        if assembler is not None and "tsdf" in out:
            scenes = meta.get("scene", [f"scene{i}"] * len(out["tsdf"]))
            for b in range(len(out["tsdf"])):
                assembler.update(str(scenes[b]), out["tsdf"][b], out["origin"][b])

    if assembler is not None:
        scene_names = list(assembler.scenes)
        paths = assembler.save_all()
        logger.info(f"Saved {len(paths)} scene meshes")
        outputs["scene_name"] = scene_names
        outputs["mesh_path"] = paths

    logger.info("collected " + ", ".join(
        f"{k} {shape}" for k, shape in ((k, _stacked_shape(v)) for k, v in outputs.items())
        if shape is not None))
    results = None
    if args.eval and hasattr(dataset, "evaluate"):
        results = dataset.evaluate(outputs, metric=args.eval[0])
        logger.info(f"Evaluation: {results}")
        print(results, flush=True)
    return results


if __name__ == "__main__":
    main()
