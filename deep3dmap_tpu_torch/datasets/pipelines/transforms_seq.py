"""Sequence (fragment) transforms of NeuralRecon's pipelines (port of
``deep3dmap_tpu/datasets/pipelines/transforms_seq.py``).

Host-side numpy, as in the JAX package, except the GT TSDF pyramid of
``SeqRandomTransformSpace``: it is fused with the port's
``core/tsdf/fusion.py`` on an explicit ``device`` (the card unless the
caller asks for the CPU, as JAX fuses on its default device) and handed back
as host arrays.  Images are read through ``utils/image_io.py``
and resized through ``utils/image_ops.py``.
"""
from __future__ import annotations

import numpy as np
import torch

from ...core.tsdf.fusion import tsdf_pyramid_from_depths
from ...utils.device import resolve_device
from ...utils.image_ops import resize
from ..builder import PIPELINES
from ..synthetic import align_xyplane_rotation, build_proj_matrices


@PIPELINES.register_module()
class SeqToTensor:
    """Stack per-view lists into float32 arrays (NHWC, no CHW transpose)."""

    def __init__(self, imgslike_keys=("imgs",), common_keys=("extrinsics",),
                 iter_keys=("tsdf_list_full",)):
        self.imgslike_keys = imgslike_keys
        self.common_keys = common_keys
        self.iter_keys = iter_keys

    def __call__(self, data):
        for key in self.imgslike_keys:
            if key in data and isinstance(data[key], (list, tuple)):
                data[key] = np.stack(
                    [np.asarray(v, np.float32) for v in data[key]])
        for key in self.common_keys:
            if key in data:
                data[key] = np.asarray(data[key], np.float32)
        for key in self.iter_keys:
            if key in data and isinstance(data[key], (list, tuple)):
                data[key] = [np.asarray(v, np.float32) for v in data[key]]
        return data


@PIPELINES.register_module(name=["SeqResizeImage", "SeqResizeImage968x1296"])
class SeqResizeImage:
    """Resize each view and rescale its intrinsics; 1296x968 ScanNet frames
    are padded to 4:3 first."""

    def __init__(self, size=(640, 480), imgs_key="imgs", intrinsics_key="intrinsics",
                 depth_key=None):
        self.size = tuple(size)
        self.imgs_key = imgs_key
        self.intrinsics_key = intrinsics_key
        self.depth_key = depth_key

    def __call__(self, data):
        out_imgs = []
        for i, im in enumerate(data[self.imgs_key]):
            im = np.asarray(im)
            K = np.asarray(data[self.intrinsics_key][i], np.float32).copy()
            h, w = im.shape[:2]
            if (w, h) == (1296, 968):  # pad to 4:3 (pad_scannet)
                im = np.pad(im, ((2, 2), (0, 0)) + ((0, 0),) * (im.ndim - 2))
                K[1, 2] += 2
                h += 4
            K[0, :] /= w / self.size[0]
            K[1, :] /= h / self.size[1]
            out_imgs.append(resize(im, self.size).astype(np.float32))
            data[self.intrinsics_key][i] = K
        data[self.imgs_key] = out_imgs
        if self.depth_key and self.depth_key in data:
            data[self.depth_key] = [resize(np.asarray(d), self.size, nearest=True)
                                    for d in data[self.depth_key]]
        return data


@PIPELINES.register_module()
class SeqNormalizeImages:
    def __init__(self, mean, std, keys=("imgs",), to_rgb=False):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.keys = keys
        self.to_rgb = to_rgb

    def __call__(self, data):
        for key in self.keys:
            imgs = []
            for im in data[key]:
                im = np.asarray(im, np.float32)
                if self.to_rgb:
                    im = im[..., ::-1]
                imgs.append((im - self.mean) / self.std)
            data[key] = np.stack(imgs)
        return data


@PIPELINES.register_module()
class SeqIntrinsicsPoseToProjection:
    """Per-scale K[R|t] matrices and the world -> aligned-camera transform."""

    def __init__(self, n_views: int, stride: int = 4, scale: int = 3,
                 in_intrinsics_key="intrinsics", in_extrinsics_key="extrinsics",
                 out_world2camera_key="world_to_aligned_camera",
                 out_matrix_key="proj_matrices"):
        self.n_views = n_views
        self.stride = stride
        self.scale = scale
        self.in_intrinsics_key = in_intrinsics_key
        self.in_extrinsics_key = in_extrinsics_key
        self.out_world2camera_key = out_world2camera_key
        self.out_matrix_key = out_matrix_key

    def __call__(self, data):
        poses = [np.asarray(p, np.float32) for p in data[self.in_extrinsics_key]]
        middle = poses[self.n_views // 2]
        rot = align_xyplane_rotation(middle)
        w2ac = np.eye(4, dtype=np.float32)
        w2ac[:3, :3] = rot
        data[self.out_world2camera_key] = (w2ac @ np.linalg.inv(middle)).astype(np.float32)
        # per-view intrinsics may differ: build per view
        projs = [build_proj_matrices(np.asarray(K, np.float32), [pose], self.scale,
                                     stride=self.stride)[0]
                 for K, pose in zip(data[self.in_intrinsics_key], poses)]
        data[self.out_matrix_key] = np.stack(projs)
        data.pop(self.in_intrinsics_key, None)
        data.pop(self.in_extrinsics_key, None)
        return data


@PIPELINES.register_module()
class SeqRandomTransformSpace:
    """Random world-frame rotation/translation, the partial volume's origin
    from the views' frustum hull, and the GT TSDF/occupancy pyramid.

    With ``fuse_from_depth`` (the default) the pyramid is fused from the
    fragment's depths on ``device``; otherwise ``tsdf_list_full`` is
    resampled with scipy's ``map_coordinates``."""

    def __init__(self, voxel_dim=(96, 96, 96), voxel_size: float = 0.04,
                 random_rotation: bool = True, random_translation: bool = True,
                 paddingXY: float = 0.1, paddingZ: float = 0.025,
                 max_epoch: int = 999, max_depth: float = 3.0,
                 fuse_from_depth: bool = True, n_layers: int = 3, seed: int = 0,
                 device=None):
        self.voxel_dim = tuple(voxel_dim)
        self.voxel_size = voxel_size
        self.random_rotation = random_rotation
        self.random_translation = random_translation
        self.padding_start = np.array([paddingXY, paddingXY, paddingZ])
        self.padding_end = np.array([paddingXY, paddingXY, 0.0])
        self.max_depth = max_depth
        self.fuse_from_depth = fuse_from_depth
        self.n_layers = n_layers
        rs = np.random.RandomState(seed)
        self.random_r = rs.rand(max_epoch)
        self.random_t = rs.rand(max_epoch, 3)
        self.device = resolve_device(device) if fuse_from_depth else None

    def _frustum_bounds(self, data):
        bnds = np.stack([np.full(3, np.inf), np.full(3, -np.inf)], 1)
        for i in range(len(data["extrinsics"])):
            K = np.asarray(data["intrinsics"][i])
            pose = np.asarray(data["extrinsics"][i])
            h, w = np.asarray(data["imgs"][i]).shape[:2]
            corners = np.array([[0, 0, 0], [0, 0, 1], [0, h, 1], [w, 0, 1], [w, h, 1]],
                               np.float64)
            pts = []
            for (u, v, on) in corners:
                d = self.max_depth * on
                x = (u - K[0, 2]) * d / K[0, 0]
                y = (v - K[1, 2]) * d / K[1, 1]
                p = pose @ np.array([x, y, d, 1.0])
                pts.append(p[:3])
            pts = np.stack(pts)
            bnds[:, 0] = np.minimum(bnds[:, 0], pts.min(0))
            bnds[:, 1] = np.maximum(bnds[:, 1], pts.max(0))
        return bnds

    def __call__(self, data):
        epoch = int(np.asarray(data.get("epoch", [0]))[0]) % len(self.random_r)
        origin = np.asarray(data.get("vol_origin", np.zeros(3)), np.float64)

        T = np.eye(4)
        if self.random_rotation or self.random_translation:
            r = self.random_r[epoch] * 2 * np.pi if self.random_rotation else 0.0
            R = np.array([[np.cos(r), -np.sin(r)], [np.sin(r), np.cos(r)]])
            dims_m = np.asarray(self.voxel_dim) * self.voxel_size
            t = self.random_t[epoch] if self.random_translation else np.full(3, 0.5)
            shift = t * (-self.padding_start) + (1 - t) * (dims_m * 0 + self.padding_end)
            T[:2, :2] = R
            T[:3, 3] = -shift
        for i in range(len(data["extrinsics"])):
            data["extrinsics"][i] = (T @ np.asarray(data["extrinsics"][i])).astype(np.float32)

        # partial volume origin from the view-frustum hull
        bnds = self._frustum_bounds(data)
        center = (np.array([(bnds[0, 1] + bnds[0, 0]) / 2,
                            (bnds[1, 1] + bnds[1, 0]) / 2, -0.2]) - origin) / self.voxel_size
        center[:2] = np.round(center[:2] / 8) * 8
        center[2] = np.floor(center[2] / 8) * 8
        start = np.zeros(3)
        start[:2] = center[:2] - np.asarray(self.voxel_dim[:2]) // 2
        start[2] = center[2]
        vol_origin_partial = (start * self.voxel_size + origin).astype(np.float32)
        data["vol_origin_partial"] = vol_origin_partial
        data["vol_origin"] = origin.astype(np.float32)

        if self.fuse_from_depth and "depth" in data:
            def dev(key):
                return torch.from_numpy(np.stack(
                    [np.asarray(v, np.float32) for v in data[key]])).to(self.device)

            tsdf_list, occ_list = tsdf_pyramid_from_depths(
                dev("depth"), dev("intrinsics"), dev("extrinsics"),
                torch.from_numpy(vol_origin_partial).to(self.device),
                self.voxel_dim[0], self.voxel_size, n_levels=self.n_layers)
            data["tsdf_list"] = [t.cpu().numpy() for t in tsdf_list]
            data["occ_list"] = [o.cpu().numpy().astype(np.float32) for o in occ_list]
        elif "tsdf_list_full" in data:
            from scipy.ndimage import map_coordinates

            inv_T = np.linalg.inv(T)
            data["tsdf_list"], data["occ_list"] = [], []
            for l, tsdf_s in enumerate(data["tsdf_list_full"]):
                tsdf_s = np.asarray(tsdf_s, np.float32)
                dim_l = np.asarray(self.voxel_dim) // (2 ** l)
                vs = self.voxel_size * (2 ** l)
                g = np.stack(np.meshgrid(*[np.arange(d) for d in dim_l],
                                         indexing="ij"), 0).reshape(3, -1)
                world = g * vs + vol_origin_partial[:, None]
                world = inv_T[:3, :3] @ world + inv_T[:3, 3:4]
                coords = (world - origin[:, None]) / vs
                vals = map_coordinates(tsdf_s, coords, order=1, cval=1.0)
                vol = vals.reshape(dim_l)
                data["tsdf_list"].append(vol.astype(np.float32))
                data["occ_list"].append((np.abs(vol) < 0.999).astype(np.float32))
            data.pop("tsdf_list_full")
        return data
