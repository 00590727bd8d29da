#!/usr/bin/env python
"""Real-time NeuralRecon streaming demo (port of ``demos/demo_neucon.py``):
stream fragments through ``forward_test`` with the recurrent state carried
on the device, assemble and save the scene mesh as it grows, refresh a mesh
preview every N fragments, and report keyframes/s.

    python -m deep3dmap_tpu_torch.demos.demo_neucon [--n-fragments 8] [--n-views 9] \\
        [--n-vox 48] [--img 128] [--out results/demo_neucon] [--scannet DATAPATH] \\
        [--checkpoint PATH] [--preview-every 1] [--device cuda|cpu]

Synthetic fragments by default; ``--scannet`` reads the test split of a
ScanNet export (``fragments_test.pkl`` from ``tools/data_gen_scannet.py``)
at 640x480 through the test pipeline.  ``--checkpoint`` is a port
checkpoint (``work_dir/checkpoints/ckpt_<step>``) of the demo's model:
the JAX demo's fixed config (dense levels, ``fpn-mnas-1``, fusion on).
Each fragment makes one host copy, of its tsdf and origin together; the
batch goes up from pinned memory before ``forward_test``, which waits for
nothing.  It runs on the card unless ``--device cpu`` is given.
"""
import argparse
import os.path as osp
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--n-fragments", type=int, default=8)
    p.add_argument("--n-views", type=int, default=9)
    p.add_argument("--n-vox", type=int, default=48)
    p.add_argument("--img", type=int, default=128)
    p.add_argument("--out", default="results/demo_neucon")
    p.add_argument("--scannet", help="ScanNet datapath (optional)")
    p.add_argument("--checkpoint")
    p.add_argument("--preview-every", type=int, default=1,
                   help="refresh the live mesh preview every N fragments (0 = off); "
                        "open3d window when available, PNG snapshots under "
                        "<out>/preview otherwise")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a GPU) or cpu")
    return p.parse_args(argv)


def model_cfgs(n_vox: int, voxel_size: float) -> dict:
    """The JAX demo's model: dense levels, MNASNet 1.0, fusion on."""
    return dict(N_LAYER=3, N_VOX=[n_vox] * 3, VOXEL_SIZE=voxel_size,
                TRAIN_NUM_SAMPLE=[4096, 16384, 65536],
                FUSION=dict(FUSION_ON=True, FULL=True),
                BACKBONE2D=dict(ARC="fpn-mnas-1", INFER_MODE="batch"))


def scannet_pipeline(n_vox: int, voxel_size: float, n_views: int, img_hw=(480, 640)):
    """The test pipeline of ``configs/neural_recon/`` at ``img_hw``."""
    h, w = img_hw
    return [dict(type="SeqResizeImage", size=(w, h), depth_key="depth"),
            dict(type="SeqRandomTransformSpace", voxel_dim=(n_vox,) * 3,
                 voxel_size=voxel_size, random_rotation=False, random_translation=False,
                 n_layers=3),
            dict(type="SeqIntrinsicsPoseToProjection", n_views=n_views, stride=4),
            dict(type="SeqNormalizeImages", mean=[127.5] * 3, std=[127.5] * 3)]


def main(argv=None) -> dict:
    """Streams the fragments; returns the saved mesh paths, the previews
    and the keyframes/s."""
    args = parse_args(argv)
    import numpy as np
    import torch

    from ..core.utils.scene_assembler import SceneAssembler
    from ..datasets.builder import _stack_samples, upload_batch
    from ..models.frameworks.neuralrecon import NeuralRecon
    from ..utils.device import resolve_device

    device = resolve_device(args.device)
    voxel_size = 0.04 if args.scannet else 0.08
    fw = NeuralRecon(model_cfgs(args.n_vox, voxel_size), device=device)

    if args.scannet:
        from ..datasets.scannet import ScanNetDataset
        ds = ScanNetDataset(args.scannet, mode="test", nviews=args.n_views, n_vox=args.n_vox,
                            voxel_size=voxel_size,
                            pipeline=scannet_pipeline(args.n_vox, voxel_size, args.n_views),
                            device=device)
        frags = [ds[i] for i in range(min(len(ds), args.n_fragments))]
    else:
        from ..datasets.synthetic import make_fragment_sample
        frags = [make_fragment_sample(seed=i, n_views=args.n_views,
                                      img_size=(args.img, args.img), n_vox=args.n_vox,
                                      voxel_size=voxel_size, scene_reset=(i == 0),
                                      device=device)
                 for i in range(args.n_fragments)]
    if not frags:
        raise ValueError(f"no fragments in {args.scannet}")

    def batch_of(frag):
        batch = _stack_samples([frag])
        meta = {k: v for k, v in batch.items() if isinstance(v, list)
                and not all(isinstance(x, np.ndarray) for x in v)}
        dev = {k: v for k, v in batch.items() if k not in meta}
        return upload_batch(dev, device, non_blocking=True)

    net, mstate = fw.init(0, _stack_samples([frags[0]]))
    if args.checkpoint:
        from ..runners.checkpoint import load_checkpoint_raw
        net.load_state_dict(load_checkpoint_raw(args.checkpoint, map_location=device)["net"])

    assembler = SceneAssembler(voxel_size=voxel_size, save_dir=args.out)
    viewer = None
    if args.preview_every:
        from ..core.visualize.mesh_viewer import LiveMeshViewer
        viewer = LiveMeshViewer(save_dir=osp.join(args.out, "preview"))

    def host_copy(out):
        """The fragment's tsdf and origin in one device -> host copy."""
        tsdf = out["tsdf"][0]
        flat = torch.cat([tsdf.reshape(-1).float(), out["origin"][0].reshape(-1).float()])
        flat = flat.cpu().numpy()
        return flat[:tsdf.numel()].reshape(tuple(tsdf.shape)), flat[tsdf.numel():]

    with torch.no_grad():
        # warm-up on the first fragment (kernel builds, cuDNN plans); the
        # stream's first fragment resets the scene
        out, mstate = fw.forward_test(net, mstate, batch_of(frags[0]))
        host_copy(out)
        previews = []
        if device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.time()
        for i, frag in enumerate(frags):
            out, mstate = fw.forward_test(net, mstate, batch_of(frag))
            tsdf, origin = host_copy(out)
            scene = str(frag.get("scene", "demo_scene"))
            assembler.update(scene, tsdf, origin)
            if viewer is not None and (i + 1) % args.preview_every == 0:
                verts, faces = assembler.get_mesh(scene)
                snap = viewer.update(verts, faces)
                if snap:
                    previews.append(snap)
                print(f"fragment {i + 1}/{len(frags)} done"
                      + (f" preview={snap}" if snap else ""), flush=True)
            else:
                print(f"fragment {i + 1}/{len(frags)} done", flush=True)
        duration = time.time() - t0

    if viewer is not None:
        viewer.close()
    paths = assembler.save_all()
    n_key = len(frags) * args.n_views
    print(f"Saved meshes: {paths}")
    print(f"Total time: {duration:.2f}s for {n_key} keyframes")
    print(f"Average keyframes/sec: {n_key / duration:.2f}", flush=True)
    return dict(meshes=paths, previews=previews, keyframes=n_key, seconds=duration,
                keyframes_per_s=n_key / duration)


if __name__ == "__main__":
    main()
