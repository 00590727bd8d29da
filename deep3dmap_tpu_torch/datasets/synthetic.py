"""Synthetic ScanNet-like fragments: SDF scenes ray-marched to depth.

The port's own copy of ``deep3dmap_tpu/datasets/synthetic.py``: scenes are a
floor plane plus random spheres; depth is sphere-traced per camera (numpy);
the GT TSDF pyramid is fused from those depths with ``core/tsdf/fusion.py``.
Projection matrices follow SeqIntrinsicsPoseToProjection (per-level scaled
intrinsics) plus the world_to_aligned_camera rotation from the middle view.
The same seed gives the same fragment as the JAX package's generator.

``write_scannet_fixture`` lays such a scene out in ScanNet's on-disk layout
for ``ScanNetDataset`` and the data-gen tool; ``write_blender_fixture`` and
``write_dtu_fixture`` lay GNeRF's posed views (``render_nerf_view``) out in
the NeRF-synthetic and DTU layouts for ``BlenderDataset`` and
``DTUDataset``.  Its colour frames are PNG
(lossless, decoded without OpenCV by ``utils/image_io.py``) under ScanNet's
``<i>.jpg`` names: readers pick the decoder by content, as ``cv2.imread``
does.  The JAX package writes JPEG there.  ``write_detection_fixture`` writes
a COCO-like ``CustomDataset`` (PNG frames and an annotation pickle) for the
detection data path.
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..core.tsdf.fusion import tsdf_pyramid_from_depths
from ..utils.device import resolve_device
from .builder import DATASETS


# ---------------------------------------------------------------------------
# scene SDF + rendering
# ---------------------------------------------------------------------------

def scene_sdf(pts: np.ndarray, spheres: np.ndarray, floor_z: float) -> np.ndarray:
    """pts (..., 3); spheres (K, 4) = (cx, cy, cz, r).  Returns (...)."""
    d = pts[..., 2] - floor_z
    for s in spheres:
        ds = np.linalg.norm(pts - s[:3], axis=-1) - s[3]
        d = np.minimum(d, ds)
    return d


TRACE_ROWS = 32     # image rows marched together: their arrays stay in cache


def _march_rows(dirs, origin, spheres, floor_z, max_depth, iters):
    """``sphere_trace_depth``'s march over a block of rows, one array per
    coordinate: per element the same operations in the same order as
    ``scene_sdf`` on stacked points (``np.linalg.norm`` sums the squares
    left to right), so the same bits, without the strided (..., 3) arrays.
    Returns the ray parameters and the hit mask."""
    dx, dy, dz = dirs
    ox, oy, oz = origin[0:1], origin[1:2], origin[2:3]
    centres = [(s[0:1], s[1:2], s[2:3], s[3]) for s in spheres]

    def sdf(t):
        px, py, pz = ox + dx * t, oy + dy * t, oz + dz * t
        d = pz - floor_z
        for cx, cy, cz, r in centres:
            ex, ey, ez = px - cx, py - cy, pz - cz
            d = np.minimum(d, np.sqrt(ex * ex + ey * ey + ez * ez) - r)
        return d

    t = np.full(dx.shape, 0.05, np.float32)
    for _ in range(iters):
        d = sdf(t).astype(np.float32)
        t = np.minimum(t + np.maximum(d, 1e-4), max_depth * 2)
    return t, sdf(t) < 2e-2


def sphere_trace_depth(intr: np.ndarray, cam_pose: np.ndarray, H: int, W: int,
                       spheres: np.ndarray, floor_z: float, max_depth: float = 6.0,
                       iters: int = 48) -> np.ndarray:
    """Ray-march the scene SDF.  cam_pose is camera-to-world.  Returns (H, W)
    metric depth along the camera z axis (0 where no hit)."""
    fx, fy, cx, cy = intr[0, 0], intr[1, 1], intr[0, 2], intr[1, 2]
    u, v = np.meshgrid(np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32))
    dirs_cam = np.stack([(u - cx) / fx, (v - cy) / fy, np.ones_like(u)], axis=-1)
    dirs_world = dirs_cam @ cam_pose[:3, :3].T
    origin = cam_pose[:3, 3]
    dirs = [np.ascontiguousarray(dirs_world[..., i]) for i in range(3)]
    blocks = [_march_rows([c[r:r + TRACE_ROWS] for c in dirs], origin, spheres, floor_z,
                          max_depth, iters) for r in range(0, H, TRACE_ROWS)]
    t = np.concatenate([b[0] for b in blocks])
    hit = np.concatenate([b[1] for b in blocks])
    # camera-z depth = t * z-component of the unit-z camera ray param
    depth = t  # dirs_cam has z == 1, so t parameterizes camera depth directly
    depth = np.where(hit & (depth < max_depth), depth, 0.0)
    return depth.astype(np.float32)


NERF_SPHERES = np.array([[0.0, 0.0, 0.25, 0.35], [0.3, 0.2, 0.1, 0.18]], np.float32)


def circle_eye(radius: float, elev_deg: float, angle: float) -> np.ndarray:
    """A camera centre on the circle at ``radius`` and ``elev_deg`` above the
    xy plane, ``angle`` around z."""
    elev = np.deg2rad(elev_deg)
    return np.array([radius * np.cos(angle) * np.cos(elev),
                     radius * np.sin(angle) * np.cos(elev),
                     radius * np.sin(elev)], np.float32)


def render_nerf_view(K: np.ndarray, pose: np.ndarray, H: int, W: int, spheres: np.ndarray,
                     radius: float, color_mode: str = "shade"):
    """One view of the spheres (no floor) for GNeRF's data: (H, W, 3) colour
    in [0, 1] and (H, W) depth (0 where no surface).  ``"shade"`` colours by
    camera distance, ``"position"`` by the hit point's world position; the
    background is black.  The JAX ``SyntheticNerfDataset``'s arithmetic."""
    depth = sphere_trace_depth(K, pose, H, W, spheres, floor_z=-10.0, max_depth=2 * radius)
    if color_mode == "position":
        u, v = np.meshgrid(np.arange(W), np.arange(H))
        dirs = np.stack([(u - K[0, 2]) / K[0, 0], (v - K[1, 2]) / K[1, 1],
                         np.ones_like(u, np.float32)], -1)
        dirs = dirs @ pose[:3, :3].T
        dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
        pts = pose[:3, 3] + dirs * depth[..., None]
        img = 0.5 + 0.5 * np.sin(pts * np.array([3.0, 4.0, 5.0]) + np.array([0.0, 1.3, 2.1]))
        img = np.where(depth[..., None] > 0, img, 0.0).astype(np.float32)
    else:
        shade = np.where(depth > 0, 1.0 - depth / (2 * radius), 0.0)
        img = np.stack([shade, shade * 0.8, shade * 0.6], -1).astype(np.float32)
    return img, depth


def write_blender_fixture(root, splits=(("train", 4), ("val", 2), ("test", 2)),
                          img_wh=(800, 800), radius: float = 4.0, elev_deg: float = 30.0,
                          scene_scale: float = 2.0):
    """GNeRF's sphere scene in the NeRF-synthetic (Blender) layout:
    ``transforms_<split>.json`` (``camera_angle_x`` and OpenGL camera-to-
    world ``transform_matrix`` per frame) and ``<split>/r_<i>.png`` RGBA
    renders (alpha 0 off the surface, colour by position), for
    ``BlenderDataset``.  Views circle the scene at ``radius``; the spheres
    are scaled by ``scene_scale``."""
    import json
    import os
    import os.path as osp

    from ..utils.image_io import imwrite_png

    W, H = img_wh
    K = np.array([[W, 0, W / 2], [0, W, H / 2], [0, 0, 1]], np.float32)
    spheres = NERF_SPHERES * scene_scale
    for s_i, (split, n) in enumerate(splits):
        os.makedirs(osp.join(root, split), exist_ok=True)
        frames = []
        for i in range(n):
            eye = circle_eye(radius, elev_deg, 2 * np.pi * (i + 0.37 * s_i) / n)
            pose = look_at_pose(eye, np.zeros(3, np.float32))
            img, depth = render_nerf_view(K, pose, H, W, spheres, radius, "position")
            rgba = np.concatenate([img[..., ::-1], (depth > 0)[..., None]], -1)
            imwrite_png(osp.join(root, split, f"r_{i}.png"),
                        np.rint(rgba * 255).astype(np.uint8))
            gl = np.eye(4)
            gl[:3, :4] = np.stack([pose[:3, 0], -pose[:3, 1], -pose[:3, 2], pose[:3, 3]], 1)
            frames.append(dict(file_path=f"./{split}/r_{i}", transform_matrix=gl.tolist()))
        with open(osp.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump(dict(camera_angle_x=float(2 * np.arctan(W / (2 * K[0, 0]))),
                           frames=frames), f)
    return root


def write_dtu_fixture(root, scan: str = "scan1", n_views: int = 9, img_wh=(400, 300),
                      radius: float = 5.0, elev_deg: float = 70.0, trans_scale: float = 200.0):
    """GNeRF's sphere scene in DTU's layout for ``DTUDataset``:
    ``Rectified/<scan>/rect_<i+1:03d>_3_r5000.png`` RGB views and
    ``Cameras/train/<i:08d>_cam.txt`` (``extrinsic``: world-to-camera 4x4
    with translation times ``trans_scale``; ``intrinsic``: 3x3 at a quarter
    of the image size).  Returns the scan directory (the config's
    ``data_dir``)."""
    import os
    import os.path as osp

    from ..utils.image_io import imwrite_png

    W, H = img_wh
    K = np.array([[W, 0, W / 2], [0, W, H / 2], [0, 0, 1]], np.float32)
    spheres = NERF_SPHERES * 2.0
    scan_dir = osp.join(root, "Rectified", scan)
    cam_dir = osp.join(root, "Cameras", "train")
    os.makedirs(scan_dir, exist_ok=True)
    os.makedirs(cam_dir, exist_ok=True)
    for i in range(n_views):
        pose = look_at_pose(circle_eye(radius, elev_deg, 2 * np.pi * i / n_views),
                            np.zeros(3, np.float32))
        img, _ = render_nerf_view(K, pose, H, W, spheres, radius, "position")
        imwrite_png(osp.join(scan_dir, f"rect_{i + 1:03d}_3_r5000.png"),
                    np.rint(img[..., ::-1] * 255).astype(np.uint8))
        E = np.linalg.inv(pose.astype(np.float64))
        E[:3, 3] *= trans_scale
        Kq = K.astype(np.float64).copy()
        Kq[:2] /= 4.0
        with open(osp.join(cam_dir, f"{i:08d}_cam.txt"), "w") as f:
            f.write("extrinsic\n")
            f.writelines(" ".join(repr(float(v)) for v in row) + "\n" for row in E)
            f.write("\nintrinsic\n")
            f.writelines(" ".join(repr(float(v)) for v in row) + "\n" for row in Kq)
            f.write("\n425.0 2.5\n")
    return scan_dir


def _rodrigues(axis: np.ndarray, theta: float) -> np.ndarray:
    axis = axis / (np.linalg.norm(axis) + 1e-12)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)


def look_at_pose(eye: np.ndarray, target: np.ndarray, up=(0, 0, 1)) -> np.ndarray:
    """Camera-to-world with +z forward, +x right, +y down (vision convention)."""
    f = target - eye
    f = f / np.linalg.norm(f)
    up = np.asarray(up, np.float32)
    r = np.cross(f, up)
    r = r / (np.linalg.norm(r) + 1e-12)
    d = np.cross(f, r)  # image down
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 0], pose[:3, 1], pose[:3, 2], pose[:3, 3] = r, d, f, eye
    return pose


def align_xyplane_rotation(middle_pose: np.ndarray) -> np.ndarray:
    """Rotation taking world +z into camera -y for the middle view (parity:
    transforms_seq.py:64-72 rotate_view_to_align_xyplane)."""
    z_c = (np.linalg.inv(middle_pose) @ np.array([0, 0, 1, 0.0]))[:3]
    axis = np.cross(z_c, np.array([0, -1, 0.0]))
    n = np.linalg.norm(axis)
    if n < 1e-8:
        return np.eye(3, dtype=np.float32)
    theta = np.arccos(np.clip(-z_c[1] / np.linalg.norm(z_c), -1, 1))
    return _rodrigues(axis / n, theta).astype(np.float32)


def build_proj_matrices(intr: np.ndarray, poses: Sequence[np.ndarray], n_scales: int,
                        stride: int = 4) -> np.ndarray:
    """(V, n_scales, 4, 4) combined K[R|t] per level (transforms_seq.py:81-93)."""
    out = []
    for pose in poses:
        w2c = np.linalg.inv(pose)
        view = []
        for s in range(n_scales):
            K = intr.copy() / (stride * 2 ** s)
            K[2, 2] = 1.0
            P = w2c.copy()
            P[:3, :4] = K @ w2c[:3, :4]
            view.append(P)
        out.append(np.stack(view))
    return np.stack(out).astype(np.float32)


# ---------------------------------------------------------------------------
# fragment sample
# ---------------------------------------------------------------------------

def make_fragment_sample(seed: int = 0, n_views: int = 9, img_size=(64, 64),
                         n_vox: int = 24, voxel_size: float = 0.08,
                         n_layers: int = 3, scene_reset: bool = True,
                         spheres: Optional[np.ndarray] = None,
                         device=None) -> Dict:
    """One ScanNet-style fragment dict (unbatched) of numpy arrays.  The GT
    TSDF pyramid is fused with ``core/tsdf/fusion.py`` on ``device``."""
    dev = resolve_device(device)
    rs = np.random.RandomState(seed)
    H, W = img_size
    extent = n_vox * voxel_size
    center = np.array([extent / 2, extent / 2, 0.35 * extent], np.float32)
    floor_z = 0.1 * extent
    if spheres is None:
        k = rs.randint(2, 4)
        spheres = np.stack([
            np.concatenate([
                center[:2] + rs.uniform(-0.2, 0.2, 2) * extent,
                [floor_z + rs.uniform(0.15, 0.4) * extent],
                [rs.uniform(0.1, 0.22) * extent]])
            for _ in range(k)]).astype(np.float32)

    intr = np.array([[W, 0, W / 2], [0, W, H / 2], [0, 0, 1]], np.float32)

    radius = 1.1 * extent
    angles = np.linspace(0, 0.9 * np.pi, n_views) + rs.uniform(0, 0.1)
    poses, depths, imgs = [], [], []
    for a in angles:
        eye = center + np.array([radius * np.cos(a), radius * np.sin(a), 0.45 * extent])
        pose = look_at_pose(eye, center)
        depth = sphere_trace_depth(intr, pose, H, W, spheres, floor_z,
                                   max_depth=3.0 * extent)
        img = np.where(depth > 0, 1.0 - depth / (3.0 * extent), 0.0)
        imgs.append(np.stack([img] * 3, axis=-1).astype(np.float32))
        poses.append(pose)
        depths.append(depth)

    vol_origin = np.zeros(3, np.float32)
    vol_origin_partial = vol_origin.copy()

    rot = align_xyplane_rotation(poses[n_views // 2])
    w2ac = np.eye(4, dtype=np.float32)
    w2ac[:3, :3] = rot
    w2ac = w2ac @ np.linalg.inv(poses[n_views // 2])

    proj = build_proj_matrices(intr, poses, n_layers)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    tsdf_list, occ_list = tsdf_pyramid_from_depths(
        t(np.stack(depths)), t(np.stack([intr] * n_views)), t(np.stack(poses)),
        t(vol_origin_partial), n_vox, voxel_size, n_levels=n_layers)
    tsdf_list = [x.cpu().numpy() for x in tsdf_list]
    occ_list = [o.cpu().numpy().astype(np.float32) for o in occ_list]

    return dict(
        imgs=np.stack(imgs),                       # (V, H, W, 3)
        depth=np.stack(depths),                    # (V, H, W)
        intrinsics=np.stack([intr] * n_views),
        extrinsics=np.stack(poses),
        proj_matrices=proj,                        # (V, L, 4, 4)
        vol_origin=vol_origin,
        vol_origin_partial=vol_origin_partial,
        world_to_aligned_camera=w2ac.astype(np.float32),
        tsdf_list=tsdf_list,                       # level l: (n_vox/2^l)^3
        occ_list=occ_list,
        scene_reset=np.float32(scene_reset),
    )


@DATASETS.register_module()
class SyntheticScanNetDataset:
    """Map-style synthetic fragment dataset (tests, benchmarks, demos); the
    GT pyramid of each sample is fused on ``device``."""

    def __init__(self, n_samples: int = 4, n_views: int = 9, img_size=(64, 64),
                 n_vox: int = 24, voxel_size: float = 0.08, n_layers: int = 3,
                 seed: int = 0, pipeline=None, device=None):
        self.n_samples = n_samples
        self.kwargs = dict(n_views=n_views, img_size=tuple(img_size), n_vox=n_vox,
                           voxel_size=voxel_size, n_layers=n_layers,
                           device=resolve_device(device))
        self.seed = seed
        self._cache: Dict[int, Dict] = {}

    def __len__(self):
        return self.n_samples

    def __getitem__(self, idx: int) -> Dict:
        if idx not in self._cache:
            self._cache[idx] = make_fragment_sample(seed=self.seed + idx, **self.kwargs)
        return self._cache[idx]


def write_scannet_fixture(root, scene: str = "scene0707_00", n_frames: int = 10,
                          splits=("test",), seed: int = 0, n_vox: int = 24,
                          voxel_size: float = 0.08, img_size=(48, 64), device=None):
    """Write the synthetic SDF scene in ScanNet's on-disk layout.

    Per frame ``color/<i>.jpg`` (PNG content, BGR as ``cv2`` writes it),
    ``depth/<i>.png`` (uint16 millimetres), ``pose/<i>.txt``, and
    ``intrinsic/intrinsic_depth.txt`` under ``scans[_test]/<scene>`` for each
    split, plus the GT mesh ``<scene>_vh_clean_2.ply`` from the scene's GT
    TSDF.  Returns the fragment sample it drew."""
    import os
    import os.path as osp

    from ..core.utils.io_ply import write_ply
    from ..core.utils.marching_cubes import tsdf_to_mesh
    from ..utils.image_io import imwrite_png

    s = make_fragment_sample(seed=seed, n_views=n_frames, img_size=img_size,
                             n_vox=n_vox, voxel_size=voxel_size, device=device)
    for split in splits:
        sub = "scans_test" if split == "test" else "scans"
        d = osp.join(root, sub, scene)
        for name in ("color", "depth", "pose", "intrinsic"):
            os.makedirs(osp.join(d, name), exist_ok=True)
        K4 = np.eye(4)
        K4[:3, :3] = s["intrinsics"][0]
        np.savetxt(osp.join(d, "intrinsic", "intrinsic_depth.txt"), K4)
        for i in range(n_frames):
            imwrite_png(osp.join(d, "color", f"{i}.jpg"),
                        (s["imgs"][i] * 255).astype(np.uint8))
            imwrite_png(osp.join(d, "depth", f"{i}.png"),
                        (s["depth"][i] * 1000).astype(np.uint16))
            np.savetxt(osp.join(d, "pose", f"{i}.txt"), s["extrinsics"][i])
        verts, faces = tsdf_to_mesh(np.asarray(s["tsdf_list"][0]),
                                    origin=np.asarray(s["vol_origin"]),
                                    voxel_size=voxel_size)
        if len(verts) == 0:
            raise RuntimeError("write_scannet_fixture: the GT TSDF holds no surface")
        write_ply(osp.join(d, f"{scene}_vh_clean_2.ply"), verts, faces)
    return s


def seeded_mnasnet_state_dict(seed: int = 0, alpha: float = 1.0) -> Dict[str, np.ndarray]:
    """A seeded state dict in torchvision's MNASNet key layout (``layers.0``
    to ``layers.10``: the stem and the three stages NeuralRecon keeps),
    float32 numpy, for ``import_mnasnet_trunk``: convs scaled by
    1/sqrt(fan-in), BatchNorm scales near 1 and running variances in
    [0.5, 2], so the folded trunk keeps activations of order one."""
    from ..models.backbones.fpn2d import _depths

    rs = np.random.RandomState(seed)
    d = _depths(alpha)
    sd: Dict[str, np.ndarray] = {}

    def conv(key, o, i, k, groups=1):
        sd[f"{key}.weight"] = (rs.randn(o, i // groups, k, k)
                               / np.sqrt(i // groups * k * k)).astype(np.float32)

    def bn(key, n):
        sd[f"{key}.weight"] = (1 + 0.1 * rs.randn(n)).astype(np.float32)
        sd[f"{key}.bias"] = (0.1 * rs.randn(n)).astype(np.float32)
        sd[f"{key}.running_mean"] = (0.1 * rs.randn(n)).astype(np.float32)
        sd[f"{key}.running_var"] = rs.uniform(0.5, 2.0, n).astype(np.float32)
        sd[f"{key}.num_batches_tracked"] = np.zeros((), np.int64)

    conv("layers.0", d[0], 3, 3)
    bn("layers.1", d[0])
    conv("layers.3", d[0], d[0], 3, groups=d[0])
    bn("layers.4", d[0])
    conv("layers.6", d[1], d[0], 1)
    bn("layers.7", d[1])
    for layer, (cin, cout, k, exp) in zip((8, 9, 10), ((d[1], d[2], 3, 3), (d[2], d[3], 5, 3),
                                                       (d[3], d[4], 5, 6))):
        for block in range(3):
            c_in = cin if block == 0 else cout
            mid, p = c_in * exp, f"layers.{layer}.{block}.layers"
            conv(f"{p}.0", mid, c_in, 1)
            bn(f"{p}.1", mid)
            conv(f"{p}.3", mid, mid, k, groups=mid)
            bn(f"{p}.4", mid)
            conv(f"{p}.6", cout, mid, 1)
            bn(f"{p}.7", cout)
    return sd


def write_300wlp_fixture(root, n_images: int = 16, img_size: int = 450, seed: int = 0,
                         n_shape: int = 199, n_exp: int = 29):
    """``n_images`` 300W-LP inputs for ``tools/data_gen_prnet.py``: seeded
    noise images of ``img_size``² (PNG bytes under ``<name>.jpg``) and
    ``<name>.mat`` files holding ``Pose_Para`` (1, 7) (small rotations, the
    face at the image centre, scale 1e-3: the synthetic BFM's 1e5-radius
    mean shape about 100 px across), ``Shape_Para`` (n_shape, 1) and
    ``Exp_Para`` (n_exp, 1).  Returns the image paths."""
    import scipy.io as sio

    from ..utils.image_io import imwrite_png

    os.makedirs(root, exist_ok=True)
    rs = np.random.RandomState(seed)
    paths = []
    for i in range(n_images):
        path = os.path.join(root, f"IBUG_image_{i:03d}_{i % 4}.jpg")
        imwrite_png(path, rs.randint(0, 256, (img_size, img_size, 3)).astype(np.uint8))
        pose = np.concatenate([rs.uniform(-0.3, 0.3, 3),
                               [img_size / 2 + rs.uniform(-10, 10),
                                img_size / 2 + rs.uniform(-10, 10), 0.0,
                                1e-3 * rs.uniform(0.9, 1.1)]])
        sio.savemat(path[:-4] + ".mat", {
            "Pose_Para": pose[None].astype(np.float32),
            "Shape_Para": (50 * rs.randn(n_shape, 1)).astype(np.float32),
            "Exp_Para": (50 * rs.randn(n_exp, 1)).astype(np.float32)})
        paths.append(path)
    return paths


def write_aflw2000_fixture(root, n_images: int = 4, img_size: int = 450, seed: int = 0):
    """An AFLW2000-3D-shaped evaluation set for ``AFLW2000Dataset``: seeded
    noise images (PNG bytes under ``image<k>.jpg``), ``image<k>.mat`` files
    holding ``pt3d_68`` (3, 68) landmarks spread over a face-sized box at
    the image centre, and ``list.txt`` naming the images.  Returns the list
    file's path."""
    import scipy.io as sio

    from ..utils.image_io import imwrite_png

    os.makedirs(root, exist_ok=True)
    rs = np.random.RandomState(seed)
    names = []
    for i in range(n_images):
        name = f"image{i:05d}.jpg"
        imwrite_png(os.path.join(root, name),
                    rs.randint(0, 256, (img_size, img_size, 3)).astype(np.uint8))
        c = img_size / 2 + rs.uniform(-20, 20, 2)
        half = rs.uniform(60, 110)
        pts = np.stack([c[0] + rs.uniform(-half, half, 68), c[1] + rs.uniform(-half, half, 68),
                        rs.uniform(-50, 50, 68)])
        sio.savemat(os.path.join(root, name[:-4] + ".mat"),
                    {"pt3d_68": pts.astype(np.float32)})
        names.append(name)
    list_path = os.path.join(root, "list.txt")
    with open(list_path, "w") as f:
        f.write("\n".join(names) + "\n")
    return list_path


def _stylegan2_channels(cm: int) -> Dict[int, int]:
    return {4: 512, 8: 512, 16: 512, 32: 512, 64: 256 * cm, 128: 128 * cm, 256: 64 * cm,
            512: 32 * cm, 1024: 16 * cm}


def seeded_stylegan2_state_dict(seed: int = 0, size: int = 128, style_dim: int = 512,
                                n_mlp: int = 8, channel_multiplier: int = 2) -> Dict:
    """A seeded checkpoint in rosinality stylegan2-pytorch's layout,
    ``{"g_ema": generator, "d": discriminator}`` state dicts of float32
    numpy, for ``import_weights.py stylegan2``.  Weights are drawn as that
    code draws them (``randn``, the mapping's divided by its lr multiplier
    0.01, the modulations' biases 1), so the equalised layers keep unit
    scale; the blur kernels and noise buffers are there, as in a published
    checkpoint."""
    rs = np.random.RandomState(seed)
    ch = _stylegan2_channels(channel_multiplier)
    log_size = int(np.log2(size))
    blur = (np.outer([1, 3, 3, 1], [1, 3, 3, 1]) / 64.0).astype(np.float32)

    def randn(*shape, scale=1.0):
        return (rs.randn(*shape) * scale).astype(np.float32)

    g: Dict[str, np.ndarray] = {}
    for i in range(n_mlp):
        g[f"style.{i + 1}.weight"] = randn(style_dim, style_dim, scale=100.0)
        g[f"style.{i + 1}.bias"] = np.zeros(style_dim, np.float32)
    g["input.input"] = randn(1, ch[4], 4, 4)

    def styled(prefix, cin, cout, up):
        g[f"{prefix}.conv.weight"] = randn(1, cout, cin, 3, 3)
        g[f"{prefix}.conv.modulation.weight"] = randn(cin, style_dim)
        g[f"{prefix}.conv.modulation.bias"] = np.ones(cin, np.float32)
        if up:
            g[f"{prefix}.conv.blur.kernel"] = blur * 4
        g[f"{prefix}.noise.weight"] = np.zeros(1, np.float32)
        g[f"{prefix}.activate.bias"] = np.zeros(cout, np.float32)

    def to_rgb(prefix, cin, up):
        if up:
            g[f"{prefix}.upsample.kernel"] = blur * 4
        g[f"{prefix}.conv.weight"] = randn(1, 3, cin, 1, 1)
        g[f"{prefix}.conv.modulation.weight"] = randn(cin, style_dim)
        g[f"{prefix}.conv.modulation.bias"] = np.ones(cin, np.float32)
        g[f"{prefix}.bias"] = np.zeros((1, 3, 1, 1), np.float32)

    styled("conv1", ch[4], ch[4], False)
    to_rgb("to_rgb1", ch[4], False)
    cin = ch[4]
    for j, i in enumerate(range(3, log_size + 1)):
        cout = ch[2 ** i]
        styled(f"convs.{2 * j}", cin, cout, True)
        styled(f"convs.{2 * j + 1}", cout, cout, False)
        to_rgb(f"to_rgbs.{j}", cout, True)
        cin = cout
    for k in range(2 * (log_size - 2) + 1):
        res = 2 ** ((k + 5) // 2)
        g[f"noises.noise_{k}"] = randn(1, 1, res, res)

    d: Dict[str, np.ndarray] = {"convs.0.0.weight": randn(ch[size], 3, 1, 1),
                                "convs.0.1.bias": np.zeros(ch[size], np.float32)}
    cin = ch[size]
    for n, i in enumerate(range(log_size, 2, -1)):
        cout = ch[2 ** (i - 1)]
        p = f"convs.{n + 1}"
        d[f"{p}.conv1.0.weight"] = randn(cin, cin, 3, 3)
        d[f"{p}.conv1.1.bias"] = np.zeros(cin, np.float32)
        d[f"{p}.conv2.0.kernel"] = blur
        d[f"{p}.conv2.1.weight"] = randn(cout, cin, 3, 3)
        d[f"{p}.conv2.2.bias"] = np.zeros(cout, np.float32)
        d[f"{p}.skip.0.kernel"] = blur
        d[f"{p}.skip.1.weight"] = randn(cout, cin, 1, 1)
        cin = cout
    d["final_conv.0.weight"] = randn(ch[4], cin + 1, 3, 3)
    d["final_conv.1.bias"] = np.zeros(ch[4], np.float32)
    d["final_linear.0.weight"] = randn(ch[4], ch[4] * 16)
    d["final_linear.0.bias"] = np.zeros(ch[4], np.float32)
    d["final_linear.1.weight"] = randn(1, ch[4])
    d["final_linear.1.bias"] = np.zeros(1, np.float32)
    return {"g_ema": g, "d": d}


def seeded_vgg16_state_dict(seed: int = 0) -> Dict[str, np.ndarray]:
    """A seeded state dict in torchvision VGG16's ``features.N`` layout
    (the 13 convs the perceptual loss keeps; the 124M-parameter classifier
    is left out), He-scaled, for ``import_weights.py vgg16``."""
    rs = np.random.RandomState(seed)
    chans = (64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512)
    sd: Dict[str, np.ndarray] = {}
    cin = 3
    for idx, cout in zip((0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28), chans):
        sd[f"features.{idx}.weight"] = (rs.randn(cout, cin, 3, 3)
                                        * np.sqrt(2.0 / (cin * 9))).astype(np.float32)
        sd[f"features.{idx}.bias"] = (0.01 * rs.randn(cout)).astype(np.float32)
        cin = cout
    return sd


def seeded_bisenet_state_dict(seed: int = 0, n_classes: int = 19) -> Dict[str, np.ndarray]:
    """A seeded state dict in face-parsing.PyTorch's BiSeNet layout (the
    ``cp.resnet`` ResNet-18, the attention refinements, the feature fusion,
    ``conv_out`` and the aux heads ``conv_out16``/``conv_out32``), convs
    scaled by 1/sqrt(fan-in), BatchNorm statistics near 1, for
    ``import_weights.py bisenet``."""
    rs = np.random.RandomState(seed)
    sd: Dict[str, np.ndarray] = {}

    def conv(key, o, i, k, bias=False):
        sd[f"{key}.weight"] = (rs.randn(o, i, k, k) / np.sqrt(i * k * k)).astype(np.float32)
        if bias:
            sd[f"{key}.bias"] = (0.1 * rs.randn(o)).astype(np.float32)

    def bn(key, n):
        sd[f"{key}.weight"] = (1 + 0.1 * rs.randn(n)).astype(np.float32)
        sd[f"{key}.bias"] = (0.1 * rs.randn(n)).astype(np.float32)
        sd[f"{key}.running_mean"] = (0.1 * rs.randn(n)).astype(np.float32)
        sd[f"{key}.running_var"] = rs.uniform(0.5, 2.0, n).astype(np.float32)
        sd[f"{key}.num_batches_tracked"] = np.zeros((), np.int64)

    conv("cp.resnet.conv1", 64, 3, 7)
    bn("cp.resnet.bn1", 64)
    chans = {1: 64, 2: 128, 3: 256, 4: 512}
    for L in (1, 2, 3, 4):
        c, prev = chans[L], chans.get(L - 1, 64)
        for B in range(2):
            p = f"cp.resnet.layer{L}.{B}"
            conv(f"{p}.conv1", c, prev if (B == 0 and L > 1) else c, 3)
            bn(f"{p}.bn1", c)
            conv(f"{p}.conv2", c, c, 3)
            bn(f"{p}.bn2", c)
            if L > 1 and B == 0:
                conv(f"{p}.downsample.0", c, prev, 1)
                bn(f"{p}.downsample.1", c)
    for arm, cin in (("arm16", 256), ("arm32", 512)):
        conv(f"cp.{arm}.conv.conv", 128, cin, 3)
        bn(f"cp.{arm}.conv.bn", 128)
        conv(f"cp.{arm}.conv_atten", 128, 128, 1)
        bn(f"cp.{arm}.bn_atten", 128)
    conv("cp.conv_avg.conv", 128, 512, 1)
    bn("cp.conv_avg.bn", 128)
    for head in ("conv_head16", "conv_head32"):
        conv(f"cp.{head}.conv", 128, 128, 3)
        bn(f"cp.{head}.bn", 128)
    conv("ffm.convblk.conv", 256, 256, 1)
    bn("ffm.convblk.bn", 256)
    conv("ffm.conv1", 64, 256, 1)
    conv("ffm.conv2", 256, 64, 1)
    for head, cin, mid in (("conv_out", 256, 256), ("conv_out16", 128, 64),
                           ("conv_out32", 128, 64)):
        conv(f"{head}.conv.conv", mid, cin, 3)
        bn(f"{head}.conv.bn", mid)
        conv(f"{head}.conv_out", n_classes, mid, 1)
    return sd


def seeded_clip_state_dict(seed: int = 0, width: int = 768, layers: int = 12, patch: int = 16,
                           image: int = 224, text_width: int = 512, text_layers: int = 12,
                           embed: int = 512, vocab: int = 49408, ctx: int = 77
                           ) -> Dict[str, np.ndarray]:
    """A seeded state dict in the published OpenAI CLIP ViT key layout
    (ViT-B/16 by default), float32 numpy, for ``import_clip``: LayerNorm
    scales near 1, projections scaled by 1/sqrt(fan-in)."""
    rs = np.random.RandomState(seed)
    sd: Dict[str, np.ndarray] = {}

    def lin(o, i):
        return (rs.randn(o, i) / np.sqrt(i)).astype(np.float32)

    def vec(n, s=0.02):
        return (rs.randn(n) * s).astype(np.float32)

    def blocks(prefix, d, n):
        for i in range(n):
            p = f"{prefix}transformer.resblocks.{i}"
            sd[f"{p}.ln_1.weight"], sd[f"{p}.ln_1.bias"] = 1 + vec(d), vec(d)
            sd[f"{p}.attn.in_proj_weight"], sd[f"{p}.attn.in_proj_bias"] = lin(3 * d, d), vec(3 * d)
            sd[f"{p}.attn.out_proj.weight"], sd[f"{p}.attn.out_proj.bias"] = lin(d, d), vec(d)
            sd[f"{p}.ln_2.weight"], sd[f"{p}.ln_2.bias"] = 1 + vec(d), vec(d)
            sd[f"{p}.mlp.c_fc.weight"], sd[f"{p}.mlp.c_fc.bias"] = lin(4 * d, d), vec(4 * d)
            sd[f"{p}.mlp.c_proj.weight"], sd[f"{p}.mlp.c_proj.bias"] = lin(d, 4 * d), vec(d)

    sd["visual.conv1.weight"] = (rs.randn(width, 3, patch, patch)
                                 / np.sqrt(3 * patch * patch)).astype(np.float32)
    sd["visual.class_embedding"] = vec(width)
    sd["visual.positional_embedding"] = (rs.randn((image // patch) ** 2 + 1, width)
                                         * 0.02).astype(np.float32)
    sd["visual.ln_pre.weight"], sd["visual.ln_pre.bias"] = 1 + vec(width), vec(width)
    blocks("visual.", width, layers)
    sd["visual.ln_post.weight"], sd["visual.ln_post.bias"] = 1 + vec(width), vec(width)
    sd["visual.proj"] = lin(embed, width).T.copy()
    sd["token_embedding.weight"] = (rs.randn(vocab, text_width) * 0.02).astype(np.float32)
    sd["positional_embedding"] = (rs.randn(ctx, text_width) * 0.01).astype(np.float32)
    blocks("", text_width, text_layers)
    sd["ln_final.weight"], sd["ln_final.bias"] = 1 + vec(text_width), vec(text_width)
    sd["text_projection"] = lin(embed, text_width).T.copy()
    sd["logit_scale"] = np.array(np.log(100.0), np.float32)
    return sd


def seeded_dino_state_dict(seed: int = 0, dim: int = 384, depth: int = 12, patch: int = 8,
                           grid: int = 28) -> Dict[str, np.ndarray]:
    """A seeded state dict in facebookresearch/dino's ViT key layout (ViT-S/8
    by default), float32 numpy, for ``import_dino``."""
    rs = np.random.RandomState(seed)
    sd: Dict[str, np.ndarray] = {}

    def lin(o, i):
        return (rs.randn(o, i) / np.sqrt(i)).astype(np.float32)

    def vec(n, s=0.02):
        return (rs.randn(n) * s).astype(np.float32)

    sd["cls_token"] = (rs.randn(1, 1, dim) * 0.02).astype(np.float32)
    sd["pos_embed"] = (rs.randn(1, grid * grid + 1, dim) * 0.02).astype(np.float32)
    sd["patch_embed.proj.weight"] = (rs.randn(dim, 3, patch, patch)
                                     / np.sqrt(3 * patch * patch)).astype(np.float32)
    sd["patch_embed.proj.bias"] = vec(dim)
    for i in range(depth):
        p = f"blocks.{i}"
        sd[f"{p}.norm1.weight"], sd[f"{p}.norm1.bias"] = 1 + vec(dim), vec(dim)
        sd[f"{p}.attn.qkv.weight"], sd[f"{p}.attn.qkv.bias"] = lin(3 * dim, dim), vec(3 * dim)
        sd[f"{p}.attn.proj.weight"], sd[f"{p}.attn.proj.bias"] = lin(dim, dim), vec(dim)
        sd[f"{p}.norm2.weight"], sd[f"{p}.norm2.bias"] = 1 + vec(dim), vec(dim)
        sd[f"{p}.mlp.fc1.weight"], sd[f"{p}.mlp.fc1.bias"] = lin(4 * dim, dim), vec(4 * dim)
        sd[f"{p}.mlp.fc2.weight"], sd[f"{p}.mlp.fc2.bias"] = lin(dim, 4 * dim), vec(dim)
    sd["norm.weight"], sd["norm.bias"] = 1 + vec(dim), vec(dim)
    return sd


def write_detection_fixture(root, n_images: int = 64, img_wh=(640, 480), n_classes: int = 80,
                            mean_boxes: float = 7.3, seed: int = 0) -> str:
    """A COCO-like ``CustomDataset`` fixture under ``root``: ``n_images`` PNG
    frames (smooth backgrounds with textured boxes) and ``ann.pkl`` (written
    by ``utils/fileio.dump``), ``1 + Poisson(mean_boxes - 1)`` boxes a frame
    of log-uniform sizes from 8 to 400 pixels over ``n_classes`` labels.
    Each info holds the frame's absolute ``filename`` and its boxes under
    ``bboxes``/``labels`` and, for the pipelines' ``GetKeysFromDict``, under
    ``gt_bboxes``/``gt_labels`` too.  Returns the annotation file's path."""
    import os

    from ..utils import fileio
    from ..utils.image_io import imwrite_png

    os.makedirs(root, exist_ok=True)
    rs = np.random.RandomState(seed)
    W, H = img_wh
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    infos = []
    for i in range(n_images):
        fx, fy, ph = rs.uniform(0.005, 0.03, 2).tolist() + [rs.uniform(0, 6.3)]
        base = 128 + 60 * np.sin(fx * xx + ph)[..., None] * np.cos(fy * yy)[..., None] \
            * rs.uniform(0.5, 1.0, 3)
        img = base + rs.normal(0, 6, (H, W, 3))
        n = min(1 + rs.poisson(mean_boxes - 1), 30)
        wh = np.exp(rs.uniform(np.log(8), np.log(400), (n, 2)))
        wh = np.minimum(wh, [W - 1, H - 1])
        xy = rs.uniform(0, 1, (n, 2)) * ([W, H] - wh)
        boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
        labels = rs.randint(0, n_classes, n).astype(np.int64)
        for (x1, y1, x2, y2), c in zip(boxes.astype(int), rs.uniform(0, 255, (n, 3))):
            img[y1:y2, x1:x2] = c + rs.normal(0, 12, (y2 - y1, x2 - x1, 3))
        path = os.path.join(os.path.abspath(root), f"{i:06d}.png")
        imwrite_png(path, np.clip(img, 0, 255).astype(np.uint8))
        infos.append(dict(filename=path, width=W, height=H,
                          ann=dict(bboxes=boxes, labels=labels, gt_bboxes=boxes, gt_labels=labels)))
    ann_file = os.path.join(root, "ann.pkl")
    fileio.dump(infos, ann_file)
    return ann_file
