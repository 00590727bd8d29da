"""Basel Face Model (3DMM) parameters -> vertices (port of
``deep3dmap_tpu/core/all3dmm/bfm_tools.py``).

``BFMModel`` holds the model as tensors; ``load_bfm_mat`` (the published
``.mat`` files) and ``make_synthetic_bfm`` (a seeded stand-in of the same
structure) build it on the host, and ``BFMModel.to`` moves it to a device.
``make_synthetic_bfm`` draws JAX's ``RandomState(seed)`` values in JAX's
order, so both packages build the same model from one seed.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class BFMModel(NamedTuple):
    mu_shape: torch.Tensor    # (3N, 1)
    w_shape: torch.Tensor     # (3N, n_shape)
    sigma: torch.Tensor       # (n_shape, 1)
    w_exp: torch.Tensor       # (3N, n_exp)
    sigma_exp: torch.Tensor   # (n_exp, 1)
    triangles: torch.Tensor   # (T, 3) int64
    keypoints: torch.Tensor   # (68,) int64 landmark vertex indices

    @property
    def n_verts(self):
        return self.mu_shape.shape[0] // 3

    @property
    def n_shape(self):
        return self.w_shape.shape[1]

    @property
    def n_exp(self):
        return self.w_exp.shape[1]

    def to(self, device) -> "BFMModel":
        return BFMModel(*(t.to(device) for t in self))


def _model(mu, w_shape, sigma, w_exp, sigma_exp, triangles, keypoints) -> BFMModel:
    f32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32))  # noqa: E731
    return BFMModel(
        mu_shape=f32(mu).reshape(-1, 1), w_shape=f32(w_shape),
        sigma=f32(sigma).reshape(-1, 1), w_exp=f32(w_exp),
        sigma_exp=f32(sigma_exp).reshape(-1, 1),
        triangles=torch.from_numpy(np.asarray(triangles, np.int64)),
        keypoints=torch.from_numpy(np.asarray(keypoints, np.int64)))


def load_bfm_mat(shape_param_path: str, exp_param_path: str,
                 other_param_path: str) -> BFMModel:
    """The model from the published ``Model_Shape.mat``,
    ``Model_Expression.mat`` and ``sigma_exp.mat`` (JAX :44-58)."""
    import scipy.io as sio

    shape = sio.loadmat(shape_param_path)
    exp = sio.loadmat(exp_param_path)
    other = sio.loadmat(other_param_path)
    return _model(shape["mu_shape"], shape["w"], shape["sigma"], exp["w_exp"],
                  other["sigma_exp"], np.asarray(shape["tri"]).T - 1,
                  shape["keypoints"][0])


def make_synthetic_bfm(n_verts: int = 512, n_shape: int = 199, n_exp: int = 29,
                       n_tri: int = 900, seed: int = 0) -> BFMModel:
    """A random model of the BFM's structure: the mean shape on a sphere at
    the BFM's micrometre scale, smooth random bases (JAX :61-82)."""
    rs = np.random.RandomState(seed)
    theta = rs.uniform(0, np.pi, n_verts)
    phi = rs.uniform(0, 2 * np.pi, n_verts)
    mu = np.stack([np.sin(theta) * np.cos(phi), np.sin(theta) * np.sin(phi),
                   np.cos(theta)], axis=-1) * 1e5
    w_shape = rs.randn(3 * n_verts, n_shape) * 10.0
    w_exp = rs.randn(3 * n_verts, n_exp) * 10.0
    tris = rs.randint(0, n_verts, (n_tri, 3))
    kpts = rs.choice(n_verts, 68, replace=n_verts < 68)
    # JAX draws sigma and then sigma_exp as it builds its BFMModel
    sigma = np.abs(rs.randn(n_shape, 1)) * 1e3
    sigma_exp = np.abs(rs.randn(n_exp, 1)) + 0.1
    return _model(mu, w_shape, sigma, w_exp, sigma_exp, tris, kpts)


def param2points_bfm(model: BFMModel, preds: torch.Tensor):
    """preds (B, >= n_shape + n_exp + 7): shape, expression, then the pose
    (scale, three Euler angles, three translations).  Returns (face_shape
    (B, N, 3), pose (B, 7)); the sum runs in JAX's order, shape basis, then
    expression basis, then the mean."""
    ns, ne = model.n_shape, model.n_exp
    alpha = preds[:, :ns, None] * model.sigma[None]
    beta = preds[:, ns:ns + ne, None] / (1000.0 * model.sigma_exp[None])
    shape = (torch.einsum("vs,bsi->bvi", model.w_shape, alpha)
             + torch.einsum("ve,bei->bvi", model.w_exp, beta)
             + model.mu_shape[None])
    return shape.reshape(preds.shape[0], -1, 3), preds[:, ns + ne:ns + ne + 7]
