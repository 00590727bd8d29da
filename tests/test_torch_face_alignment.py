"""FAN face alignment (``models/face_alignment.py``) against the JAX module.

- ``FAN`` at its defaults (2 modules, 68 landmarks, 128 features, depth-3
  hourglasses) on 2 crops of 64², the flax parameters carried over by
  ``utils/from_flax.py``: heatmaps within 1e-5 (measured ~1e-6; heatmaps
  are of order one).
- The host helpers on ``tests/test_face_alignment.py``'s cases and random
  ones: ``transform_point``, ``draw_gaussian`` and
  ``get_preds_from_heatmaps`` bit-equal; ``crop_face`` bit-equal too, its
  resize being ``utils/image_ops.resize`` (OpenCV's ``INTER_LINEAR``;
  ``tests/test_torch_image_ops.py`` holds it to ``cv2``).
- ``FaceAlignment.get_landmarks_from_image`` at 64² crops on two boxes, the
  same flax parameters: landmarks within 1e-3 px (a heatmap argmax tie
  broken otherwise would move one by a whole heatmap pixel, 4 px here).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deep3dmap_tpu.models import face_alignment as J
from deep3dmap_tpu_torch.models import face_alignment as T
from deep3dmap_tpu_torch.utils.from_flax import load_flax_params

torch.set_num_threads(2)

HM_ATOL = 1e-5
LMK_ATOL = 1e-3


@pytest.fixture(scope="module")
def fan():
    net = J.FAN()
    x = np.random.RandomState(0).rand(2, 64, 64, 3).astype(np.float32)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(net.init)(jax.random.PRNGKey(0),
                                                                  jnp.asarray(x)))
    return net, params, x


def test_fan_matches_flax(fan):
    net, params, x = fan
    want = np.asarray(jax.jit(net.apply)(params, jnp.asarray(x)))
    tnet = load_flax_params(T.FAN(), params)
    got = tnet(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape == (2, 2, 16, 16, 68)
    np.testing.assert_allclose(got, want, atol=HM_ATOL * max(1.0, np.abs(want).max()), rtol=0)


def test_host_helpers_bit_equal():
    rs = np.random.RandomState(1)
    for _ in range(5):
        p, c = rs.rand(2) * 100, rs.rand(2) * 100
        s, res = rs.uniform(0.3, 2.0), float(rs.choice([64, 256]))
        for inv in (False, True):
            np.testing.assert_array_equal(T.transform_point(p, c, s, res, inv),
                                          J.transform_point(p, c, s, res, inv))
    for point, sigma in (([20, 30], 2.0), ([-50, -50], 1.0), ([62.7, 1.2], 1.5)):
        a, b = np.zeros((64, 64)), np.zeros((64, 64))
        np.testing.assert_array_equal(T.draw_gaussian(a, point, sigma),
                                      J.draw_gaussian(b, point, sigma))
    hm = rs.rand(2, 16, 16, 5).astype(np.float32)
    hm[0, 3, 7, 0] = 2.0
    centers, scales = rs.rand(2, 2) * 100, rs.uniform(0.5, 1.5, 2)
    for args in ((), (centers, scales)):
        for a, b in zip(T.get_preds_from_heatmaps(hm, *args),
                        J.get_preds_from_heatmaps(hm, *args)):
            np.testing.assert_array_equal(a, b)
    img = np.ones((40, 40, 3), np.float32)
    out = T.crop_face(img, center=[5.0, 5.0], scale=0.5, resolution=32)
    assert out.shape == (32, 32, 3) and out.min() == 0.0 and out.max() == 1.0
    img = rs.rand(50, 60, 3).astype(np.float32)
    for center, scale, res in (([5.0, 5.0], 0.5, 32), ([30.0, 25.0], 0.2, 64),
                               ([58.0, 3.0], 0.37, 48)):
        np.testing.assert_array_equal(T.crop_face(img, center, scale, res),
                                      J.crop_face(img, center, scale, res))


def test_get_landmarks_from_image_matches_jax(fan):
    _, params, _ = fan
    img = (np.random.RandomState(2).rand(96, 120, 3) * 255).astype(np.uint8)
    boxes = [[10, 10, 70, 80], [40, 5, 110, 90]]
    want = J.FaceAlignment(params=params, resolution=64).get_landmarks_from_image(img, boxes)
    fa = T.FaceAlignment(params=params, resolution=64, device="cpu")
    got = fa.get_landmarks_from_image(img, boxes)
    assert len(got) == 2 and got[0].shape == (68, 2)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=LMK_ATOL, rtol=0)
    # the seeded init gives a working net too
    seeded = T.FaceAlignment(n_modules=1, n_landmarks=5, resolution=64, device="cpu")
    assert np.isfinite(seeded.get_landmarks_from_image(img, boxes[:1])[0]).all()
