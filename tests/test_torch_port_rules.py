"""Rules of the PyTorch port that hold for every slice.

- ``deep3dmap_tpu_torch/`` (the CLIs included) and ``chip_smoke.py`` import
  no ``jax``, ``flax``, ``optax``, ``orbax`` or ``deep3dmap_tpu`` (an AST
  scan of every import statement);
- entry points (the frameworks, the renderer, the perceptual loss, the
  StyleGAN2 generator and discriminator, the Gan2Shape runner, the parsers,
  the data path's GT fusion, the fixture writer, the data-gen, the face
  frameworks and the UV sampler's tables, GNeRF's framework and ray
  sampler and readers) default to CUDA and raise on a machine without a
  GPU unless the caller asks for ``device="cpu"`` (the CLIs on a
  NeuralRecon config: ``tests/test_torch_cli.py``; on a Gan2Shape or GNeRF
  config: here; on the face configs: ``tests/test_torch_face_cli.py``);
- the evaluation's worker processes import no torch.
"""
import ast
import os

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "deep3dmap_tpu")


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "deep3dmap_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return files


def _imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_port_imports_no_jax():
    files = _port_files()
    assert len(files) > 10 and os.path.exists(files[0])
    bad = [(os.path.relpath(f, ROOT), m) for f in files
           for m in _imported_roots(f) if m in FORBIDDEN]
    assert not bad, f"port files import the JAX side: {bad}"


def _no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CUDA default does not raise here")


def test_entry_points_raise_without_gpu():
    _no_gpu()
    from deep3dmap_tpu_torch.core.renderer.renderer_nr import NrRenderer
    from deep3dmap_tpu_torch.datasets.synthetic import make_fragment_sample
    from deep3dmap_tpu_torch.models.frameworks.gan2shape import Gan2Shape
    from deep3dmap_tpu_torch.models.losses.perceptual_loss import PerceptualLoss
    from deep3dmap_tpu_torch.models.frameworks.neuralrecon import NeuralRecon
    from deep3dmap_tpu_torch.utils.device import resolve_device

    with pytest.raises(RuntimeError, match="device='cpu'"):
        NeuralRecon(dict(N_VOX=[24] * 3, BACKBONE2D=dict(ARC="fpn-mnas-0.5")))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_fragment_sample(n_views=2, img_size=(16, 16), n_vox=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Gan2Shape(dict(image_size=32, nf=8, raster_mode="hard"))
    assert Gan2Shape(dict(image_size=32, nf=8), device="cpu").device == \
        torch.device("cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        NrRenderer(dict(min_depth=0.9, max_depth=1.1), 16)
    assert NrRenderer(dict(min_depth=0.9, max_depth=1.1), 16,
                      device="cpu").K.device == torch.device("cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PerceptualLoss(seed=0)
    assert next(PerceptualLoss(seed=0, device="cpu").net.parameters()).device \
        == torch.device("cpu")
    with pytest.raises(RuntimeError):
        resolve_device("cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")

    # the face workloads: the frameworks and the UV tables default to CUDA;
    # their datasets are host readers that take the CLIs' ``device`` keyword
    # and give numpy items, on any machine
    from deep3dmap_tpu_torch.core.renderer.uv_sampler import precompute_uv_rasterization
    from deep3dmap_tpu_torch.datasets.face_tuple import SyntheticFaceTupleDataset
    from deep3dmap_tpu_torch.datasets.face_uv import SyntheticFaceUVDataset
    from deep3dmap_tpu_torch.models.frameworks.imgs2mesh import Imgs2Mesh
    from deep3dmap_tpu_torch.models.frameworks.prnet import FaceImg2UV
    for make in (lambda: FaceImg2UV(dict(resolution=32, base_channels=4)),
                 lambda: Imgs2Mesh(dict(image_size=32, n_verts=64)),
                 lambda: Imgs2Mesh(dict(image_size=32, n_verts=64), device="cuda"),
                 lambda: precompute_uv_rasterization(np.zeros((3, 2)), [[0, 1, 2]], 8)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    fw = Imgs2Mesh(dict(image_size=32, n_verts=64, use_sampling=True, texture_size=8),
                   device="cpu")
    assert {fw.bfm.w_shape.device, fw.rast.bary.device, fw.lookview.device} == \
        {torch.device("cpu")}
    assert FaceImg2UV(dict(resolution=32, base_channels=4), device="cpu").weight_mask.device \
        == torch.device("cpu")
    for ds in (SyntheticFaceUVDataset(n_samples=1, resolution=16),
               SyntheticFaceTupleDataset(n_samples=1, tuplesize=2, image_size=16, n_verts=64,
                                         device="cuda")):
        assert all(isinstance(v, np.ndarray) for v in ds[0].values())

    from deep3dmap_tpu_torch.models.modulars.stylegan2 import (Generator,
                                                               StyleDiscriminator)
    from deep3dmap_tpu_torch.runners.gan2shape_runner import Gan2ShapeRunner
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Generator(size=16, style_dim=32, n_mlp=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StyleDiscriminator(size=16)
    assert Generator(16, 32, 2, device="cpu").input_const.device == torch.device("cpu")
    assert StyleDiscriminator(16, device="cpu").fc_b.device == torch.device("cpu")
    small = dict(image_size=32, gan_size=16, z_dim=32, n_mlp=2, nf=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Gan2ShapeRunner(Gan2Shape(small))
    runner = Gan2ShapeRunner(Gan2Shape(small, device="cpu"))
    net, state = runner.setup({"input_im": np.zeros((1, 32, 32, 3), np.float32)})
    assert runner.rng.device == torch.device("cpu")
    assert {p.device.type for p in net.parameters()} == {"cpu"}
    assert state["center_w"].device == torch.device("cpu")


def test_uint8_images_normalised_on_device():
    """uint8 images with IMG_NORM give the same forward as the float images
    they quantise (the normalisation runs inside the framework)."""
    from deep3dmap_tpu_torch.datasets.builder import _stack_samples
    from deep3dmap_tpu_torch.datasets.synthetic import make_fragment_sample
    from deep3dmap_tpu_torch.models.frameworks.neuralrecon import NeuralRecon

    torch.set_num_threads(2)
    cfg = dict(N_LAYER=3, N_VOX=[16] * 3, VOXEL_SIZE=0.08,
               BACKBONE2D=dict(ARC="fpn-mnas-0.5"), IMG_NORM=(0.5, 0.25))
    fw = NeuralRecon(cfg, device="cpu")
    batch = _stack_samples([make_fragment_sample(
        seed=0, n_views=2, img_size=(32, 32), n_vox=16, device="cpu")])
    q = np.rint(np.clip(batch["imgs"], 0, 1) * 255).astype(np.uint8)
    net, state = fw.init(0, batch)
    out_q, _ = fw.forward_test(net, state, dict(batch, imgs=q))
    ref = (q.astype(np.float32) / 255.0 - 0.5) / 0.25
    out_f, _ = fw.forward_test(net, state, dict(batch, imgs=ref))
    np.testing.assert_allclose(out_q["tsdf"].numpy(), out_f["tsdf"].numpy(),
                               atol=1e-6)


def test_training_entry_points_run_on_the_framework_device():
    """``runners/`` takes its device from the framework: a framework built
    with the default (CUDA) raises here before a train state exists, and one
    built with ``device="cpu"`` trains on the CPU, its Adam moments there
    too."""
    from deep3dmap_tpu_torch.datasets.builder import _stack_samples
    from deep3dmap_tpu_torch.datasets.synthetic import make_fragment_sample
    from deep3dmap_tpu_torch.models.frameworks.neuralrecon import NeuralRecon
    from deep3dmap_tpu_torch.runners.train_state import init_train_state, train_step

    torch.set_num_threads(2)
    cfg = dict(N_LAYER=3, N_VOX=[16] * 3, VOXEL_SIZE=0.08,
               BACKBONE2D=dict(ARC="fpn-mnas-0.5"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            NeuralRecon(cfg)
    batch = _stack_samples([make_fragment_sample(
        seed=0, n_views=2, img_size=(32, 32), n_vox=16, device="cpu")])
    fw = NeuralRecon(cfg, device="cpu")
    state = init_train_state(fw, 0, batch, dict(type="Adam", lr=1e-3),
                             dict(max_norm=1.0))
    state, log = train_step(fw, state, batch)
    assert state.step == 1 and state.net.training
    assert {v.device.type for v in log.values()} == {"cpu"}
    moments = [s["exp_avg"] for s in state.optimizer.adam.state.values()]
    assert moments and {m.device.type for m in moments} == {"cpu"}
    assert np.isfinite(float(log["loss"])) and float(log["grad_norm"]) > 0


def test_data_path_entry_points_raise_without_gpu(tmp_path):
    """The data path's device users -- the GT fusion of
    ``SeqRandomTransformSpace`` (directly or through ``ScanNetDataset``'s
    pipeline), ``SyntheticScanNetDataset``, ``write_scannet_fixture`` and the
    data-gen's ``--save-tsdf`` -- default to CUDA like every entry point."""
    _no_gpu()
    from deep3dmap_tpu_torch.datasets.pipelines.transforms_seq import SeqRandomTransformSpace
    from deep3dmap_tpu_torch.datasets.scannet import ScanNetDataset
    from deep3dmap_tpu_torch.datasets.synthetic import (SyntheticScanNetDataset,
                                                        write_scannet_fixture)
    from deep3dmap_tpu_torch.tools.data_gen_scannet import save_scene_tsdf

    fuse = dict(type="SeqRandomTransformSpace", voxel_dim=(8, 8, 8))
    for make in (lambda: SeqRandomTransformSpace(), lambda: SyntheticScanNetDataset(),
                 lambda: ScanNetDataset(str(tmp_path), pipeline=[fuse]),
                 lambda: write_scannet_fixture(str(tmp_path), n_frames=2),
                 lambda: save_scene_tsdf(str(tmp_path), [], 0.04, "cuda")):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    assert SeqRandomTransformSpace(device="cpu").device == torch.device("cpu")
    assert ScanNetDataset(str(tmp_path), pipeline=[fuse], device="cpu") \
        .pipeline.transforms[0].device == torch.device("cpu")
    assert SeqRandomTransformSpace(fuse_from_depth=False).device is None


def test_eval_workers_import_no_torch():
    """``ScanNetDataset.evaluate``'s spawned workers import the scene
    evaluation and the host C++ op only: no torch, so no CUDA context."""
    import subprocess
    import sys
    code = ("import sys; import deep3dmap_tpu_torch.core.evaluation.scene_eval, "
            "deep3dmap_tpu_torch.ops.native; "
            "assert 'torch' not in sys.modules, sorted(m for m in sys.modules if 'torch' in m)")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr


def test_gan2shape_entry_points_raise_without_gpu():
    """The parsers, the parse mask of a framework on the CPU, the runner
    from the registry, and both CLIs on ``configs/gan2shape/celeba_synthetic.py``."""
    _no_gpu()
    from deep3dmap_tpu_torch.models.frameworks.gan2shape import Gan2Shape
    from deep3dmap_tpu_torch.models.parsing import FaceParser, SceneParser
    from deep3dmap_tpu_torch.runners.builder import build_runner
    from deep3dmap_tpu_torch.tools import test as test_cli
    from deep3dmap_tpu_torch.tools import train as train_cli

    torch.set_num_threads(2)
    for make in (FaceParser, lambda: SceneParser(n_classes=150)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    assert next(FaceParser(device="cpu").net.parameters()).device == torch.device("cpu")
    assert next(SceneParser(device="cpu").net.parameters()).device == torch.device("cpu")
    fw = Gan2Shape(dict(image_size=32, gan_size=16, z_dim=32, n_mlp=2, nf=8, use_mask=True,
                        category="car"), device="cpu")
    mask = fw.parse_mask(np.zeros((1, 32, 32, 3), np.float32))
    assert mask.shape == (1, 32, 32, 1) and mask.device == torch.device("cpu")
    runner = build_runner(dict(type="Gan2ShapeRunner"), default_args=dict(framework=fw))
    net, _ = runner.setup({"input_im": np.zeros((1, 32, 32, 3), np.float32)})
    assert runner.rng.device == torch.device("cpu")
    assert {o.params[0].device.type for o in runner.optimizers.values()} == {"cpu"}
    cfg = os.path.join(ROOT, "configs", "gan2shape", "celeba_synthetic.py")
    for cli in (train_cli, test_cli):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli.main([cfg])


def test_gnerf_entry_points_raise_without_gpu(tmp_path):
    """``GanNerf``, ``RaySampler`` and GNeRF's readers
    (``SyntheticNerfDataset``, ``BlenderDataset``, ``DTUDataset``) default to
    CUDA; with ``device="cpu"`` the readers give numpy items; both CLIs on
    ``configs/gnerf/gnerf_synthetic.py`` raise without ``--device cpu``."""
    _no_gpu()
    from deep3dmap_tpu_torch.core.renderer.samples.ray_sampler import RaySampler
    from deep3dmap_tpu_torch.datasets.nerf_synthetic import SyntheticNerfDataset
    from deep3dmap_tpu_torch.datasets.real_files import BlenderDataset, DTUDataset
    from deep3dmap_tpu_torch.datasets.synthetic import (write_blender_fixture,
                                                        write_dtu_fixture)
    from deep3dmap_tpu_torch.models.frameworks.gnerf import GanNerf
    from deep3dmap_tpu_torch.tools import test as test_cli
    from deep3dmap_tpu_torch.tools import train as train_cli

    cfg = dict(img_wh=(16, 16), fc_depth=2, fc_dim=16, N_samples=4, N_importance=4, ndf=8,
               inv_depth=1)
    ray = dict(near=0.5, far=4.0, azim_range=(0, 360), elev_range=(0, 60), radius=(1, 2))
    for make in (lambda: GanNerf(cfg), lambda: GanNerf(cfg, device="cuda"),
                 lambda: RaySampler(**ray)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    fw = GanNerf(cfg, device="cpu")
    assert fw.ray_sampler.device == torch.device("cpu")
    batch = {"imgs": np.zeros((2, 16, 16, 3), np.float32), "img_idx": np.arange(2)}
    net, state = fw.init(0, batch)
    assert {p.device.type for p in net.parameters()} == {"cpu"}
    assert state["it"].device == torch.device("cpu")
    blender = write_blender_fixture(str(tmp_path / "lego"), splits=(("train", 2),),
                                    img_wh=(8, 8))
    dtu = write_dtu_fixture(str(tmp_path / "dtu"), n_views=2, img_wh=(8, 6))
    readers = (lambda **kw: SyntheticNerfDataset(n_images=1, img_wh=(8, 8), **kw),
               lambda **kw: BlenderDataset(blender, img_wh=(8, 8), **kw),
               lambda **kw: DTUDataset(dtu, img_wh=(8, 6), **kw))
    for make in readers:
        for kw in ({}, {"device": "cuda"}):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                make(**kw)
        ds = make(device="cpu")
        assert all(isinstance(v, np.ndarray) or np.isscalar(v) for v in ds[0].values())
    config = os.path.join(ROOT, "configs", "gnerf", "gnerf_synthetic.py")
    for cli in (train_cli, test_cli):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli.main([config, "--work-dir", str(tmp_path / "wd")])
