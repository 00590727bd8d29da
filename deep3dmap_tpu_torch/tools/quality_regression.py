#!/usr/bin/env python
"""Train -> checkpoint -> eval quality regression and the GRU-fusion ablation
(port of ``tools/quality_regression.py``).

On the generated fixture scene it

  1. trains with the port's ``tools/train.py`` (tiny shapes, ``--epochs``),
  2. evaluates with the port's ``tools/test.py``, untrained against trained,
     through inference -> SceneAssembler -> .ply -> ``ScanNetDataset.evaluate``,
  3. repeats the training with ``FUSION_ON=False`` to measure what the
     ConvGRU fusion adds on the multi-fragment scene,
  4. writes the numbers to a JSON artifact with the JAX tool's keys.

An overfit regression (train and eval on the same scene): it certifies that
the optimisation and eval loop learns the scene, not generalisation.  It
passes when the trained fusion model beats the untrained one by 0.05 in
F-score and has a lower AbsRel (an untrained mesh that covers no GT pixel
has no depth metrics, NaN, and counts as worse than any finite AbsRel);
otherwise it exits with code 2.

The tools run in this process.  It trains on the card (``--device cuda``, the
default; it raises without a GPU): the JAX tool's ``--platform cpu`` default
is this one's ``--device cuda``, and ``--device cpu`` runs it here.  Usage:

    python -m deep3dmap_tpu_torch.tools.quality_regression --out QUALITY_port.json \\
        [--epochs 120] [--workdir DIR] [--keep] [--device cuda|cpu]
"""
import argparse
import json
import math
import os
import os.path as osp
import shutil
import sys
import tempfile

CONFIG_TMPL = """
N_VIEWS = 5
VOXEL_SIZE = 0.08
N_VOX = 24
work_dir = {work_dir!r}

pipeline = [
    dict(type="SeqResizeImage", size=(64, 48), depth_key="depth"),
    dict(type="SeqRandomTransformSpace", voxel_dim=(N_VOX, N_VOX, N_VOX),
         voxel_size=VOXEL_SIZE, random_rotation=False,
         random_translation=False, n_layers=3),
    dict(type="SeqIntrinsicsPoseToProjection", n_views=N_VIEWS, stride=4),
    dict(type="SeqNormalizeImages", mean=[127.5] * 3, std=[127.5] * 3),
]

data = dict(
    samples_per_gpu=1,
    train=dict(type="ScanNetDataset", datapath={datapath!r}, mode="train",
               nviews=N_VIEWS, n_scales=2, img_size=(64, 48), n_vox=N_VOX,
               voxel_size=VOXEL_SIZE, pipeline=pipeline),
    test=dict(type="ScanNetDataset", datapath={datapath!r}, mode="test",
              nviews=N_VIEWS, n_scales=2, img_size=(64, 48), n_vox=N_VOX,
              voxel_size=VOXEL_SIZE, pipeline=pipeline),
)

model = dict(
    type="NeuralRecon",
    model_cfgs=dict(
        save_scene=True,
        N_LAYER=3,
        N_VOX=[N_VOX, N_VOX, N_VOX],
        VOXEL_SIZE=VOXEL_SIZE,
        TRAIN_NUM_SAMPLE=[512, 2048, 8192],
        BACKBONE2D=dict(ARC="fpn-mnas-0.5", INFER_MODE="batch"),
        FUSION=dict(FUSION_ON={fusion}, FULL=True),
        LW=[1.0, 0.8, 0.64],
        THRESHOLDS=[0, 0, 0],
        POS_WEIGHT=1.5,
    ),
)

checkpoint_config = dict(interval=40)
log_config = dict(interval=20, hooks=[dict(type="TextLoggerHook")])
optimizer_config = dict(grad_clip=dict(max_norm=1.0))
lr_config = dict(policy="step", gamma=0.5, step=[60, 90])
workflow = [("train", 1)]
runner = dict(
    type="EpochBasedRunner",
    runner_cfgs=dict(
        optimizer=dict(type="Adam", lr=1e-3, betas=(0.9, 0.999),
                       weight_decay=0.0),
        max_epochs={epochs},
    ),
)
"""


def config_text(work_dir: str, datapath: str, fusion: bool, epochs: int) -> str:
    """The config of one arm, the JAX tool's template filled in."""
    return CONFIG_TMPL.format(work_dir=work_dir, datapath=datapath, fusion=fusion,
                              epochs=epochs)


def learns_reconstruction(trained: dict, untrained: dict) -> bool:
    """The pass rule: F-score up by more than 0.05 and AbsRel lower, an
    untrained NaN AbsRel (no GT pixel covered) counting as worse than any
    finite one."""
    absrel_lower = trained["AbsRel"] < untrained["AbsRel"] or (
        math.isnan(untrained["AbsRel"]) and math.isfinite(trained["AbsRel"]))
    return bool(trained["fscore"] > untrained["fscore"] + 0.05 and absrel_lower)


def summarize(results: dict) -> dict:
    """The artifact's derived keys from its four evaluations."""
    tr, un = results["trained_fusion"], results["untrained_fusion"]
    results["fscore_gain_vs_untrained"] = round(tr["fscore"] - un["fscore"], 4)
    results["absrel_drop_vs_untrained"] = round(un["AbsRel"] - tr["AbsRel"], 4)
    results["fusion_delta_fscore"] = round(
        tr["fscore"] - results["trained_nofusion"]["fscore"], 4)
    results["learns_reconstruction"] = learns_reconstruction(tr, un)
    return results


def main(argv=None) -> dict:
    """Runs both arms and returns the artifact's dict; raises
    ``SystemExit(2)`` when the trained model does not pass."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="QUALITY_port.json")
    ap.add_argument("--epochs", type=int, default=120,
                    help="epochs (2 fragment steps each) per arm")
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--keep", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)

    from ..datasets.synthetic import write_scannet_fixture
    from ..utils.device import resolve_device
    from . import data_gen_scannet, test, train

    device = resolve_device(args.device)
    wd = args.workdir or tempfile.mkdtemp(prefix="d3m_quality_")
    root = osp.join(wd, "data")
    os.makedirs(root, exist_ok=True)
    dev = ["--device", device.type]

    print("[1/5] fixture scene + data-gen", flush=True)
    write_scannet_fixture(root, splits=("train", "test"), n_frames=10, device=device)
    for mode in ("train", "test"):
        data_gen_scannet.main(["--datapath", root, "--mode", mode, "--n-views", "5",
                               "--min-angle", "1", "--min-distance", "0.01",
                               "--n-proc", "1"] + dev)

    results = {"round": None, "epochs": args.epochs,
               "note": "overfit regression on the synthetic fixture scene "
                       "(train==eval scene); certifies the train->checkpoint"
                       "->eval loop learns reconstructions, not "
                       "generalization"}
    for fusion in (True, False):
        tag = "fusion" if fusion else "nofusion"
        vdir = osp.join(wd, tag)
        cfg_path = osp.join(wd, f"cfg_{tag}.py")
        with open(cfg_path, "w") as f:
            f.write(config_text(vdir, root, fusion, args.epochs))
        print(f"[2/5] untrained eval ({tag})", flush=True)
        results[f"untrained_{tag}"] = test.main(
            [cfg_path, "--out", osp.join(wd, f"meshes_untrained_{tag}"),
             "--eval", "depth_mesh"] + dev)
        print(f"[3/5] train {args.epochs} epochs ({tag})", flush=True)
        train.main([cfg_path, "--work-dir", vdir] + dev)
        print(f"[4/5] trained eval ({tag})", flush=True)
        results[f"trained_{tag}"] = test.main(
            [cfg_path, "--out", osp.join(wd, f"meshes_trained_{tag}"),
             "--eval", "depth_mesh", "--checkpoint", "auto"] + dev)

    summarize(results)
    print("[5/5] writing", args.out, flush=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print(json.dumps({k: v for k, v in results.items() if not isinstance(v, dict)},
                     indent=1), flush=True)
    if not args.keep:
        shutil.rmtree(wd, ignore_errors=True)
    if not results["learns_reconstruction"]:
        sys.stderr.write("quality regression FAILED: trained model does not "
                         "beat the untrained baseline\n")
        raise SystemExit(2)
    return results


if __name__ == "__main__":
    main()
