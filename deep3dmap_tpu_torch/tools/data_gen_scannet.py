#!/usr/bin/env python
"""ScanNet fragment metadata and TSDF GT generation (port of
``tools/data_gen/scannet.py``).

Keyframes where the pose turned by more than ``--min-angle`` degrees or moved
by more than ``--min-distance`` metres since the last keyframe; fragments of
``--n-views`` keyframes; ``fragments_<mode>.pkl`` listing them.
``--save-tsdf`` also fuses each scene's full TSDF from its keyframes with
the port's ``core/tsdf/fusion.py`` on ``--device`` (the card unless
``cpu`` is given) into ``<scene>/full_tsdf.npz``.  Usage:

    python -m deep3dmap_tpu_torch.tools.data_gen_scannet --datapath data/scannet \\
        --mode train [--n-proc 4] [--save-tsdf [--device cpu]]
"""
import argparse
import os
import os.path as osp
import pickle
from multiprocessing import get_context

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--datapath", required=True)
    p.add_argument("--mode", default="train", choices=["train", "val", "test"])
    p.add_argument("--n-views", type=int, default=9)
    p.add_argument("--min-angle", type=float, default=15.0)
    p.add_argument("--min-distance", type=float, default=0.1)
    p.add_argument("--voxel-size", type=float, default=0.04)
    p.add_argument("--save-tsdf", action="store_true",
                   help="also fuse and save full-scene TSDF volumes")
    p.add_argument("--device", default="cuda",
                   help="device of the --save-tsdf fusion (cuda or cpu)")
    p.add_argument("--n-proc", type=int, default=2)
    p.add_argument("--max-scenes", type=int, default=0)
    return p.parse_args(argv)


def select_keyframes(pose_dir, min_angle, min_distance):
    """Frames whose rotation or translation since the last keyframe exceeds
    the thresholds; frames with a non-finite pose are skipped."""
    frame_ids = sorted(int(f[:-4]) for f in os.listdir(pose_dir))
    keyframes = []
    last_pose = None
    for fid in frame_ids:
        pose = np.loadtxt(osp.join(pose_dir, f"{fid}.txt"))
        if not np.isfinite(pose).all():
            continue
        if last_pose is None:
            keyframes.append(fid)
            last_pose = pose
            continue
        rel = np.linalg.inv(last_pose) @ pose
        angle = np.rad2deg(np.arccos(np.clip((np.trace(rel[:3, :3]) - 1) / 2, -1, 1)))
        dist = np.linalg.norm(rel[:3, 3])
        if angle > min_angle or dist > min_distance:
            keyframes.append(fid)
            last_pose = pose
    return keyframes


def process_scene(job):
    scene_dir, scene, args_d = job
    args = argparse.Namespace(**args_d)
    pose_dir = osp.join(scene_dir, "pose")
    if not osp.isdir(pose_dir):
        return []
    keyframes = select_keyframes(pose_dir, args.min_angle, args.min_distance)
    metas = []
    for i in range(0, len(keyframes) - args.n_views + 1, args.n_views):
        ids = keyframes[i:i + args.n_views]
        metas.append(dict(scene=scene, fragment_id=i // args.n_views,
                          image_ids=ids, vol_origin=np.zeros(3, np.float32),
                          scene_reset=(i == 0)))
    if args.save_tsdf and metas:
        save_scene_tsdf(scene_dir, keyframes, args.voxel_size, args.device)
    return metas


def save_scene_tsdf(scene_dir, keyframes, voxel_size, device):
    """Fuse the keyframes' depths into one volume over the cameras' bounds
    plus 3 m, its sides rounded up to multiples of 8 voxels."""
    import torch

    from ..core.tsdf.fusion import TSDFParams, tsdf_fuse_frames
    from ..utils.device import resolve_device
    from ..utils.image_io import imread

    dev = resolve_device(device)
    intr = np.loadtxt(osp.join(scene_dir, "intrinsic", "intrinsic_depth.txt"))[:3, :3]
    depths = np.stack([imread(osp.join(scene_dir, "depth", f"{fid}.png"))
                       .astype(np.float32) / 1000.0 for fid in keyframes])
    poses = np.stack([np.loadtxt(osp.join(scene_dir, "pose", f"{fid}.txt"))
                      for fid in keyframes]).astype(np.float32)
    cams = poses[:, :3, 3]
    lo = cams.min(0) - 3.0
    hi = cams.max(0) + 3.0
    dims = np.ceil((hi - lo) / voxel_size / 8).astype(int) * 8
    params = TSDFParams(dim=tuple(int(d) for d in dims), voxel_size=voxel_size)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    tsdf, weight = tsdf_fuse_frames(
        t(depths), t(np.stack([intr] * len(depths))), t(poses), t(lo), params)
    np.savez_compressed(osp.join(scene_dir, "full_tsdf.npz"),
                        tsdf=tsdf.cpu().numpy(), weight=weight.cpu().numpy(),
                        origin=lo, voxel_size=voxel_size)


def main(argv=None):
    args = parse_args(argv)
    sub = "scans_test" if args.mode == "test" else "scans"
    root = osp.join(args.datapath, sub)
    scenes = sorted(os.listdir(root)) if osp.isdir(root) else []
    if args.max_scenes:
        scenes = scenes[: args.max_scenes]

    jobs = [(osp.join(root, s), s, vars(args)) for s in scenes]
    if args.n_proc > 1 and len(jobs) > 1:
        with get_context("spawn").Pool(args.n_proc) as pool:
            all_metas = pool.map(process_scene, jobs)
    else:
        all_metas = [process_scene(j) for j in jobs]

    metas = [m for ms in all_metas for m in ms]
    out = osp.join(args.datapath, f"fragments_{args.mode}.pkl")
    with open(out, "wb") as f:
        pickle.dump(metas, f)
    print(f"Wrote {len(metas)} fragments from {len(scenes)} scenes to {out}")
    return out


if __name__ == "__main__":
    main()
