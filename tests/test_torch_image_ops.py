"""The port's OpenCV-free image operations (``deep3dmap_tpu_torch/utils/
image_ops.py``) against ``cv2`` as the JAX package's transforms call it.

Measured with OpenCV 5.0.0's x86-64 AVX2 dispatch (the vector layout the
port copies; ``image_ops``' docstring): every ``uint8`` resize, every
``warpAffine`` (``INTER_LINEAR`` and ``INTER_NEAREST``, ``uint8`` and
``float32``, 1/3/4 channels, vector blocks and row tails), both HSV
conversions (all 180 x 256 x 256 HSV codes, a third of all RGB codes per
axis), ``INTER_NEAREST`` resizes and ``getRotationMatrix2D`` are bit-equal.
``float32`` ``INTER_LINEAR`` resizes are bit-equal too: at the pipelines'
sizes (640x480 to 1333x800 and to 666x400, 2x shrinks, 317x203 both ways),
over random shapes whose source has at least 2 pixels a side (positions a
hair from an integer, wide edge runs before the first and past the last
source column), and from a source of one row or one column.
``getAffineTransform`` solves the same 6 x 6 system with LAPACK: 7.1e-15.
"""
import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from deep3dmap_tpu_torch.utils import image_ops  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _cv2_build():
    """The targets are one build's vector paths (``image_ops``' docstring):
    print the ``cv2`` at hand, so that a failure on another host shows it."""
    print(f"cv2 {cv2.__version__}; CPU features {cv2.getCPUFeaturesLine()}; "
          f"AVX2 {cv2.checkHardwareSupport(11)}, AVX512_SKX {cv2.checkHardwareSupport(256)}")

SIZES = [((640, 480), (1333, 800)), ((640, 480), (666, 400)), ((640, 480), (320, 240)),
         ((317, 203), (640, 480)), ((640, 480), (317, 203)), ((64, 48), (133, 80))]


def _img(rs, w, h, c, dtype):
    a = rs.rand(h, w, c) * 255
    a = a.astype(dtype)
    return a[..., 0] if c == 1 else a


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("src,dst", SIZES)
def test_resize_pipeline_sizes_bit_equal(src, dst, dtype):
    rs = np.random.RandomState(0)
    for c in (1, 3):
        img = _img(rs, *src, c, dtype)
        ref = cv2.resize(img, dst, interpolation=cv2.INTER_LINEAR)
        out = image_ops.resize(img, dst)
        assert out.dtype == ref.dtype and out.shape == ref.shape
        np.testing.assert_array_equal(out, ref)


def test_resize_uint8_random_shapes_bit_equal():
    rs = np.random.RandomState(1)
    for _ in range(150):
        w, h = rs.randint(1, 90, 2)
        W, H = (w // 2 or 1, h // 2 or 1) if rs.rand() < 0.2 else tuple(rs.randint(1, 200, 2))
        img = _img(rs, w, h, rs.choice([1, 3, 4]), np.uint8)
        np.testing.assert_array_equal(image_ops.resize(img, (W, H)),
                                      cv2.resize(img, (int(W), int(H)),
                                                 interpolation=cv2.INTER_LINEAR))


def test_resize_float32_random_shapes_within_bound():
    """The bound is 0: every value equal to ``cv2``'s."""
    rs = np.random.RandomState(2)
    for _ in range(150):
        w, h = rs.randint(2, 90, 2)
        W, H = rs.randint(1, 200, 2)
        img = _img(rs, w, h, rs.choice([1, 3, 4]), np.float32)
        ref = cv2.resize(img, (int(W), int(H)), interpolation=cv2.INTER_LINEAR)
        np.testing.assert_array_equal(image_ops.resize(img, (W, H)), ref)


@pytest.mark.parametrize("seed", [5, 7])
def test_resize_float32_edge_runs_bit_equal(seed):
    """Enlargements of narrow sources: runs of 1-48 edge columns on either
    side (``image_ops._unfused_columns``), and positions near an integer."""
    rs = np.random.RandomState(seed)
    for _ in range(60):
        w, h = rs.randint(2, 14), rs.randint(2, 90)
        W, H = rs.randint(2, 200), rs.randint(1, 200)
        img = _img(rs, w, h, rs.choice([1, 3, 4]), np.float32)
        np.testing.assert_array_equal(image_ops.resize(img, (W, H)),
                                      cv2.resize(img, (int(W), int(H)),
                                                 interpolation=cv2.INTER_LINEAR))


def test_resize_float32_one_row_or_column_bit_equal():
    rs = np.random.RandomState(4)
    for t in range(80):
        n = rs.randint(1, 90)
        w, h = (1, n) if t % 2 else (n, 1)
        W, H = rs.randint(1, 200, 2)
        img = _img(rs, w, h, rs.choice([1, 3, 4]), np.float32)
        np.testing.assert_array_equal(image_ops.resize(img, (W, H)),
                                      cv2.resize(img, (int(W), int(H)),
                                                 interpolation=cv2.INTER_LINEAR))


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.float32])
def test_resize_nearest_bit_equal(dtype):
    rs = np.random.RandomState(3)
    for _ in range(60):
        w, h = rs.randint(1, 120, 2)
        W, H = rs.randint(1, 250, 2)
        img = (rs.rand(h, w) * 200).astype(dtype)
        np.testing.assert_array_equal(
            image_ops.resize(img, (W, H), nearest=True),
            cv2.resize(img, (int(W), int(H)), interpolation=cv2.INTER_NEAREST))


def _affine(kind, rs, w, h):
    if kind == "shear_h":
        return np.array([[1, rs.uniform(-0.3, 0.3), 0], [0, 1, 0]], np.float64)
    if kind == "shear_v":
        return np.array([[1, 0, 0], [rs.uniform(-0.3, 0.3), 1, 0]], np.float64)
    if kind == "rotate":        # about an off-centre point, as Rotate's centre option
        return cv2.getRotationMatrix2D((float(rs.uniform(0, w / 3)), float(rs.uniform(0, h))),
                                       float(rs.uniform(-30, 30)), 1.0)
    return np.array([[1, 0, rs.randint(-80, 80)], [0, 1, rs.randint(-60, 60)]], np.float64)


@pytest.mark.parametrize("nearest", [False, True])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("kind", ["shear_h", "shear_v", "rotate", "translate"])
def test_warp_affine_bit_equal(kind, dtype, nearest):
    rs = np.random.RandomState(4)
    flags = cv2.INTER_NEAREST if nearest else cv2.INTER_LINEAR
    for (w, h), c in (((640, 480), 3), ((317, 203), 3), ((133, 80), 1), ((45, 31), 4)):
        img = _img(rs, w, h, c, dtype)
        M = _affine(kind, rs, w, h)
        border = (128, 64, 32) if c != 1 else 255
        ref = cv2.warpAffine(img, M, (w, h), flags=flags, borderValue=border)
        out = image_ops.warp_affine(img, M, (w, h), nearest=nearest, border_value=border)
        assert out.dtype == ref.dtype and out.shape == ref.shape
        np.testing.assert_array_equal(out, ref)


def test_warp_affine_other_output_size_and_scalar_border():
    rs = np.random.RandomState(5)
    img = _img(rs, 100, 70, 3, np.float32)
    M = cv2.getRotationMatrix2D((40.0, 20.0), 17.0, 0.8)
    np.testing.assert_array_equal(image_ops.warp_affine(img, M, (64, 96), border_value=7),
                                  cv2.warpAffine(img, M, (64, 96), borderValue=7))


def test_rotation_matrix_and_affine_transform():
    rs = np.random.RandomState(6)
    for _ in range(50):
        c = (rs.uniform(0, 600), rs.uniform(0, 400))
        a, s = rs.uniform(-40, 40), rs.uniform(0.5, 1.5)
        np.testing.assert_array_equal(image_ops.get_rotation_matrix_2d(c, a, s),
                                      cv2.getRotationMatrix2D(c, a, s))
    src = np.float32([[10, 12], [10, 80], [70, 12]])
    dst = np.float32([[0, 0], [0, 255], [255, 0]])
    np.testing.assert_allclose(image_ops.get_affine_transform(src, dst),
                               cv2.getAffineTransform(src, dst), rtol=0, atol=1e-12)


def test_rgb_to_hsv_bit_equal():
    v = np.arange(0, 256, 3)
    rgb = np.stack(np.meshgrid(v, v, v, indexing="ij"), -1).reshape(len(v) ** 2, len(v), 3)
    rgb = rgb.astype(np.uint8)
    np.testing.assert_array_equal(image_ops.rgb_to_hsv(rgb), cv2.cvtColor(rgb, cv2.COLOR_RGB2HSV))


@pytest.mark.parametrize("width", [256, 40, 133])
def test_hsv_to_rgb_every_code_bit_equal(width):
    """Rows of 256 pixels are vector blocks only; 40 and 133 leave a tail."""
    h, s, v = np.meshgrid(np.arange(180), np.arange(256), np.arange(256), indexing="ij")
    hsv = np.stack([h, s, v], -1).reshape(-1, 3)
    hsv = hsv[: len(hsv) // width * width].reshape(-1, width, 3).astype(np.uint8)
    np.testing.assert_array_equal(image_ops.hsv_to_rgb(hsv), cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB))


def test_hsv_round_trip_as_photometric_distortion_does():
    rs = np.random.RandomState(7)
    img = (rs.rand(203, 317, 3) * 255).astype(np.uint8)
    hsv = image_ops.rgb_to_hsv(img)
    np.testing.assert_array_equal(hsv, cv2.cvtColor(img, cv2.COLOR_RGB2HSV))
    jit = hsv.astype(np.float32)
    jit[..., 1] *= 1.3
    jit[..., 0] = (jit[..., 0] + 11.5) % 180
    jit[..., 1:] = np.clip(jit[..., 1:], 0, 255)
    jit = jit.astype(np.uint8)
    np.testing.assert_array_equal(image_ops.hsv_to_rgb(jit), cv2.cvtColor(jit, cv2.COLOR_HSV2RGB))


def test_image_io_resize_goes_through_image_ops():
    """The readers' linear resizes (``image_io.resize_float(area=False)``)
    and the sequence pipeline's are ``image_ops.resize``: bit-equal to
    ``cv2`` at these sizes."""
    from deep3dmap_tpu_torch.datasets.pipelines import transforms_seq
    from deep3dmap_tpu_torch.utils import image_io

    assert transforms_seq.resize is image_ops.resize
    rs = np.random.RandomState(8)
    img = _img(rs, 64, 48, 3, np.uint8)
    np.testing.assert_array_equal(transforms_seq.resize(img, (133, 80)),
                                  cv2.resize(img, (133, 80), interpolation=cv2.INTER_LINEAR))
    depth = rs.rand(48, 64).astype(np.float32)
    np.testing.assert_array_equal(transforms_seq.resize(depth, (32, 24), nearest=True),
                                  cv2.resize(depth, (32, 24), interpolation=cv2.INTER_NEAREST))
    uv = (rs.rand(64, 64, 3) * 255).astype(np.float32)
    np.testing.assert_array_equal(image_io.resize_float(uv, (128, 128), area=False),
                                  cv2.resize(uv, (128, 128), interpolation=cv2.INTER_LINEAR))
