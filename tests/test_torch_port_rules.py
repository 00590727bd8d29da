"""Rules of the PyTorch port that hold for every slice.

- ``deep3dmap_tpu_torch/`` (the CLIs included) and ``chip_smoke.py`` import
  no ``jax``, ``flax``, ``optax``, ``orbax`` or ``deep3dmap_tpu`` (an AST
  scan of every import statement);
- entry points (the frameworks, the renderer, the perceptual loss, the
  StyleGAN2 generator and discriminator, the Gan2Shape runner, the parsers,
  the data path's GT fusion, the fixture writer, the data-gen, the face
  frameworks and the UV sampler's tables, GNeRF's framework and ray
  sampler and readers; the streaming demo, the quality twin, the elastic
  supervisor and ``import_weights.py mnasnet``; the SfM tool
  ``benchmark_ba.py``, its problem builder and ``from_jax_tuple``) default to CUDA and raise
  on a machine without a GPU unless the caller asks for ``device="cpu"`` (the CLIs on a
  NeuralRecon config: ``tests/test_torch_cli.py``; on a Gan2Shape or GNeRF
  config: here; on the face configs: ``tests/test_torch_face_cli.py``);
- the evaluation's worker processes import no torch;
- the detection data path's modules import no ``cv2`` or ``PIL``, and its
  box ops put numpy inputs on the card unless ``device="cpu"`` is passed;
- the port's ``ops`` exports every name of the JAX package's
  ``ops.__all__`` and its ``BACKBONES`` every name JAX registers; the op
  zoo puts numpy inputs on the card unless ``device="cpu"`` is passed, and
  ``ops/host.py`` imports no torch;
- every package exports its JAX twin's names (lazily), the ``parallel``
  package and ``SyncBatchNorm`` / ``lm_solve_sharded`` among them, and
  fills its registries as JAX's import does; the async producers' path
  and the torch-free utilities import no torch;
  ``FaceAlignment`` defaults to the card;
- every launcher under ``scripts/`` has a twin under
  ``deep3dmap_tpu_torch/scripts/`` that runs the port's CLIs (under
  ``torchrun`` with ``--launcher pytorch`` where it trains or tests) and
  names no JAX and nothing of the JAX package.
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
    parallel = os.path.join(ROOT, "deep3dmap_tpu_torch", "parallel")
    assert {os.path.join(parallel, f"{m}.py") for m in
            ("__init__", "mesh", "fsdp", "spatial", "collectives")} <= set(files)
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


def test_lerf_entry_points_raise_without_gpu(tmp_path):
    """``LERFModel``, ``LERFRayDataset``, ``CLIPEncoder``, ``CLIPViT`` and
    ``DinoExtractor`` default to CUDA; with ``device="cpu"`` their tensors
    stay on the CPU; ``IterBasedRunner`` through both CLIs on
    ``configs/lerf/lerf_synthetic.py`` raises without ``--device cpu``.  The
    import rule above walks these modules too."""
    _no_gpu()
    from deep3dmap_tpu_torch.datasets.lerf_rays import LERFRayDataset
    from deep3dmap_tpu_torch.models.frameworks.lerf import LERFModel
    from deep3dmap_tpu_torch.models.modulars.clip_encoder import CLIPEncoder
    from deep3dmap_tpu_torch.models.modulars.clip_vit import CLIPViT
    from deep3dmap_tpu_torch.models.modulars.dino_vit import DinoExtractor
    from deep3dmap_tpu_torch.tools import test as test_cli
    from deep3dmap_tpu_torch.tools import train as train_cli

    new = {os.path.relpath(f, ROOT) for f in _port_files()}
    assert {os.path.join("deep3dmap_tpu_torch", p) for p in (
        "models/frameworks/lerf.py", "datasets/lerf_rays.py", "runners/iter_based_runner.py",
        "models/modulars/hashgrid.py", "models/modulars/dino_vit.py",
        "utils/torch_import.py", "tools/import_weights.py")} <= new
    cfg = dict(clip_n_dims=16, dino_n_dims=8, N_samples=4, N_importance=4, num_lerf_samples=2,
               fc_depth=1, fc_dim=8, grid_layers=(1, 1), grid_sizes=(6, 6), hidden=8)
    vision = dict(patch=8, width=16, layers=1, heads=1, embed_dim=8, image_size=16)
    text = dict(vocab_size=32, ctx_len=8, width=16, layers=1, heads=1, embed_dim=8)
    rays = dict(rays_per_batch=8, n_batches=1, clip_n_dims=16, dino_n_dims=8,
                image_dataset=dict(type="SyntheticNerfDataset", n_images=1, img_wh=(16, 16)))
    for make in (lambda **kw: LERFModel(cfg, **kw), lambda **kw: CLIPEncoder(16, **kw),
                 lambda **kw: CLIPViT(vision, text, **kw),
                 lambda **kw: DinoExtractor(cfg=dict(dim=8, heads=1, depth=1), **kw),
                 lambda **kw: LERFRayDataset(**rays, **kw)):
        for kw in ({}, {"device": "cuda"}):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                make(**kw)
    fw = LERFModel(cfg, device="cpu")
    assert fw.image_encoder.neg_embeds.device == torch.device("cpu")
    ds = LERFRayDataset(**rays, image_encoder=fw.image_encoder, device="cpu")
    batch = next(iter(ds))
    assert all(isinstance(v, np.ndarray) for v in batch.values())
    net, _ = fw.init(0, batch)
    assert {p.device.type for p in net.parameters()} == {"cpu"}
    config = os.path.join(ROOT, "configs", "lerf", "lerf_synthetic.py")
    for cli in (train_cli, test_cli):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli.main([config, "--work-dir", str(tmp_path / "wd")])


def test_runtime_entry_points_raise_without_gpu(tmp_path):
    """The streaming demo, the quality twin, the elastic supervisor and the
    MNASNet importer default to the card (``--device cpu`` runs them here:
    ``tests/test_torch_demo_quality.py``, ``tests/test_torch_elastic.py``)."""
    _no_gpu()
    from deep3dmap_tpu_torch.demos import demo_neucon
    from deep3dmap_tpu_torch.tools import import_weights, quality_regression, run_elastic

    cfg = tmp_path / "cfg.py"
    cfg.write_text("model = dict(type='NeuralRecon')\n")
    calls = [lambda: demo_neucon.main(["--out", str(tmp_path / "demo")]),
             lambda: quality_regression.main(["--workdir", str(tmp_path / "q")]),
             lambda: run_elastic.main(["--", str(cfg)]),
             lambda: import_weights.main(["mnasnet", str(tmp_path / "none.pth"),
                                          str(tmp_path / "out.npz")])]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert not (tmp_path / "q").exists() and not (tmp_path / "out.npz").exists()


def test_sfm_entry_points_raise_without_gpu():
    """The SfM layer's tool and problem builders default to the card: the
    tool's ``main`` and ``make_problem``, and ``from_jax_tuple`` (how the
    tests and the tool carry a JAX problem across).  The functions on
    tensors follow their inputs' device (``lm_solve_sharded`` too, with
    the observations split over its ranks)."""
    _no_gpu()
    from deep3dmap_tpu_torch.core import sfm
    from deep3dmap_tpu_torch.core.sfm.ba import BAProblem
    from deep3dmap_tpu_torch.tools import benchmark_ba
    from deep3dmap_tpu_torch.utils.from_flax import from_jax_tuple

    rng = np.random.RandomState(0)
    for call in (lambda: benchmark_ba.main(["--cams", "4", "--pts", "8", "--obs-per-pt", "2"]),
                 lambda: benchmark_ba.main(["--device", "cuda"]),
                 lambda: benchmark_ba.make_problem(rng, 4, 8, 2)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    K, Rs, ts, X, prob = benchmark_ba.make_problem(rng, 4, 8, 2, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        from_jax_tuple(BAProblem, prob)
    assert from_jax_tuple(BAProblem, prob, device="cpu").uv.device == torch.device("cpu")
    res = sfm.lm_solve(Rs, ts, X, prob, iters=1)
    assert {v.device.type for v in res} == {"cpu"}
    import deep3dmap_tpu_torch.core.sfm as port
    assert set(port.__all__) == {
        "BAProblem", "BAResult", "lm_solve", "lm_solve_sharded", "project",
        "reprojection_residuals", "Keypoints",
        "Matches", "detect_keypoints", "extract_descriptors", "harris_response",
        "match_descriptors", "match_images", "PoseGraph", "compose_chain", "edge_residual",
        "graph_cost", "odometry_graph", "optimize", "se3_compose", "se3_exp", "se3_inverse",
        "se3_log", "se3_retract", "so3_exp", "so3_log", "transform_points",
        "essential_eight_point", "normalize_points", "recover_pose", "relative_pose",
        "triangulate", "triangulate_two_view", "essential_ransac", "sampson_distance"}


DETECTION_MODULES = (
    "utils/fileio.py", "utils/structures.py", "utils/mask_structures.py", "utils/message_hub.py",
    "utils/meters.py", "utils/image_ops.py", "ops/bbox.py", "core/evaluation/mean_ap.py",
    "core/evaluation/recall.py", "core/evaluation/evaluator.py", "datasets/custom.py",
    "datasets/pipelines/loading.py", "datasets/pipelines/formating.py",
    "datasets/pipelines/transforms.py", "datasets/pipelines/auto_augment.py",
    "datasets/pipelines/test_time_aug.py", "datasets/pipelines/transforms_seq.py")


def test_detection_path_imports_no_cv2_or_pil():
    bad = [(m, r) for m in DETECTION_MODULES
           for r in _imported_roots(os.path.join(ROOT, "deep3dmap_tpu_torch", m))
           if r in ("cv2", "PIL")]
    assert not bad, f"the detection path imports OpenCV or PIL: {bad}"


def test_box_ops_raise_without_gpu():
    """Numpy boxes go to the card unless the caller asks for the CPU; a
    tensor stays on its own device."""
    _no_gpu()
    from deep3dmap_tpu_torch.ops import bbox

    rs = np.random.RandomState(0)
    xy = rs.rand(8, 2) * 50
    boxes = np.concatenate([xy, xy + 10], 1).astype(np.float32)
    rboxes = np.concatenate([xy, np.full((8, 2), 5.0), np.zeros((8, 1))], 1).astype(np.float32)
    scores = rs.rand(8).astype(np.float32)
    dets = np.concatenate([boxes, scores[:, None]], 1)
    calls = [lambda **kw: bbox.bbox_overlaps(boxes, boxes, **kw),
             lambda **kw: bbox.nms(boxes, scores, 0.5, **kw),
             lambda **kw: bbox.batched_nms(boxes, scores, np.arange(8) % 3, 0.5, **kw),
             lambda **kw: bbox.soft_nms(boxes, scores, **kw),
             lambda **kw: bbox.nms_match(dets, 0.5, **kw),
             lambda **kw: bbox.box_iou_rotated(rboxes, rboxes, **kw),
             lambda **kw: bbox.nms_rotated(rboxes, scores, 0.5, **kw)]
    for call in calls:
        for kw in ({}, {"device": "cuda"}):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call(**kw)
        out = call(device="cpu")
        leaves = out if isinstance(out, (tuple, list)) else [out]
        assert leaves and {t.device.type for t in leaves} == {"cpu"}
    assert bbox.nms(torch.from_numpy(boxes), torch.from_numpy(scores), 0.5)[1].device.type == "cpu"


def test_ops_exports_cover_jax_and_backbones_registry():
    """Every name of the JAX package's ``ops.__all__`` imports from the
    port's ``ops``, and the port's ``BACKBONES`` holds every name JAX's
    registers."""
    import importlib

    import deep3dmap_tpu.models  # noqa: F401  (register)
    import deep3dmap_tpu.models.modulars.inversion_net  # noqa: F401
    import deep3dmap_tpu.models.parsing  # noqa: F401
    import deep3dmap_tpu.ops as jops
    from deep3dmap_tpu.models.builder import BACKBONES as JAX_BACKBONES
    from deep3dmap_tpu_torch.models.builder import BACKBONES, build_backbone

    ops = importlib.import_module("deep3dmap_tpu_torch.ops")
    assert set(jops.__all__) <= set(dir(ops)) and set(jops.__all__) <= set(ops.__all__)
    for name in jops.__all__:
        assert callable(getattr(ops, name)), name
    from deep3dmap_tpu_torch.ops import roi_align
    assert callable(roi_align) and not isinstance(roi_align, type(ops))
    build_backbone(dict(type="Encoder", cout=4, nf=4))
    assert set(JAX_BACKBONES.module_dict) <= set(BACKBONES.module_dict)


def test_op_zoo_raises_without_gpu():
    """Numpy inputs go to the card unless ``device="cpu"`` is passed; the
    result then lies on the CPU."""
    _no_gpu()
    import deep3dmap_tpu_torch.ops as ops

    rs = np.random.RandomState(0)
    f32 = lambda *s: rs.rand(*s).astype(np.float32)  # noqa: E731
    feat, rois = f32(1, 2, 8, 8), np.array([[0, 1, 1, 5, 6]], np.float32)
    pts, boxes = f32(1, 20, 3), np.array([[[0.5, 0.5, 0, 1, 1, 1, 0]]], np.float32)
    calls = [
        lambda **kw: ops.sigmoid_focal_loss(f32(4, 3), rs.randint(0, 3, 4), **kw),
        lambda **kw: ops.softmax_focal_loss(f32(4, 3), rs.randint(0, 3, 4), **kw),
        lambda **kw: ops.roi_align(feat, rois, 2, **kw),
        lambda **kw: ops.roi_pool(feat, rois, 2, **kw),
        lambda **kw: ops.roi_align_rotated(feat, np.array([[0, 4, 4, 3, 3, 0.3]], np.float32), 2,
                                           **kw),
        lambda **kw: ops.deform_conv2d(feat, np.zeros((1, 18, 6, 6), np.float32),
                                       f32(3, 2, 3, 3), **kw),
        lambda **kw: ops.modulated_deform_conv2d(feat, np.zeros((1, 18, 6, 6), np.float32),
                                                 np.ones((1, 9, 6, 6), np.float32),
                                                 f32(3, 2, 3, 3), **kw),
        lambda **kw: ops.deform_roi_pool(feat, rois, None, 2, **kw),
        lambda **kw: ops.ms_deform_attn(f32(1, 5, 1, 2), [(1, 5)], [0], f32(1, 3, 1, 1, 2, 2),
                                        f32(1, 3, 1, 1, 2), **kw),
        lambda **kw: ops.square_distance(pts, pts, **kw),
        lambda **kw: ops.knn(3, pts, pts, **kw),
        lambda **kw: ops.ball_query(0.5, 4, pts, pts, **kw),
        lambda **kw: ops.furthest_point_sample(pts, 4, **kw),
        lambda **kw: ops.gather_points(f32(1, 2, 20), np.zeros((1, 3), np.int64), **kw),
        lambda **kw: ops.group_points(f32(1, 2, 20), np.zeros((1, 3, 2), np.int64), **kw),
        lambda **kw: ops.three_nn(pts, pts, **kw),
        lambda **kw: ops.three_interpolate(f32(1, 2, 20), np.zeros((1, 5, 3), np.int64),
                                           f32(1, 5, 3), **kw),
        lambda **kw: ops.three_interpolate_weights(pts, pts, **kw),
        lambda **kw: ops.voxelize(f32(30, 4), (0.5, 0.5, 0.5), (0, 0, 0, 1, 1, 1), 4, 8, **kw),
        lambda **kw: ops.voxelize_host(f32(30, 4), (0.5, 0.5, 0.5), (0, 0, 0, 1, 1, 1), 4, 8,
                                       **kw),
        lambda **kw: ops.dynamic_scatter(f32(10, 2), rs.randint(0, 3, (10, 3)), **kw),
        lambda **kw: ops.points_in_boxes(pts, boxes, **kw),
        lambda **kw: ops.boxes_iou_bev(boxes[0], boxes[0], **kw),
        lambda **kw: ops.boxes_overlap_bev(boxes[0], boxes[0], **kw),
        lambda **kw: ops.boxes_iou3d(boxes[0], boxes[0], **kw),
        lambda **kw: ops.nms3d(boxes[0], np.ones(1, np.float32), 0.5, **kw),
        lambda **kw: ops.nms3d_normal(boxes[0], np.ones(1, np.float32), 0.5, **kw),
        lambda **kw: ops.roiaware_pool3d(boxes[0], pts[0], f32(20, 2), (2, 2, 2), **kw),
        lambda **kw: ops.roipoint_pool3d(pts, f32(1, 20, 2), boxes, 4, **kw),
        lambda **kw: ops.carafe(feat, f32(1, 25, 16, 16), **kw),
        lambda **kw: ops.carafe_naive(feat, f32(1, 25, 16, 16), **kw),
        lambda **kw: ops.masked_conv2d(feat, f32(1, 8, 8), f32(3, 2, 3, 3), **kw),
        lambda **kw: ops.correlation(feat, feat, **kw),
        lambda **kw: ops.tin_shift(f32(1, 4, 4, 3), np.ones((1, 2), np.int64), **kw),
        lambda **kw: ops.psamask(f32(1, 9, 4, 4), "collect", 3, 3, **kw),
        lambda **kw: ops.border_align(f32(1, 8, 8, 8), np.array([[[1, 1, 5, 5]]], np.float32),
                                      **kw),
        lambda **kw: ops.corner_pool(feat, "top", **kw),
    ]
    for call in calls:
        for kw in ({}, {"device": "cuda"}):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call(**kw)
        out = call(device="cpu")
        leaves = out if isinstance(out, (tuple, list)) else [out]
        assert {t.device.type if isinstance(t, torch.Tensor) else "host"
                for t in leaves} <= {"cpu", "host"}


def test_host_ops_import_no_torch():
    """``ops/host.py`` (text detection's post-processing) runs in a process
    without torch, and takes numpy there."""
    import subprocess
    import sys
    code = ("import sys, numpy as np; from deep3dmap_tpu_torch.ops import host; "
            "lab = np.zeros((6, 6), np.int32); lab[2:4, 2:4] = 1; "
            "assert host.contour_expand(np.ones((2, 6, 6), np.uint8), lab, 1, 2)[0][0] == 1; "
            "assert 'torch' not in sys.modules, sorted(m for m in sys.modules if 'torch' in m)")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr


# names of the JAX package still waiting for a later slice: none since the
# multi-GPU slice
MULTI_GPU = {}
PACKAGES = ("datasets", "models", "models.frameworks", "models.losses", "models.modulars",
            "models.function_utils", "runners", "utils", "core.all3dmm", "core.all3dtrans",
            "core.renderer", "core.tsdf", "core.utils", "ops", "core.evaluation", "core.sfm",
            "datasets.pipelines", "parallel")


@pytest.mark.parametrize("pkg", PACKAGES)
def test_package_exports_cover_jax(pkg):
    """Every name of the JAX package's ``__all__`` and every name its
    ``__init__`` imports (modules aside) imports from the port's twin; the
    port's ``__all__`` holds JAX's."""
    import importlib
    import types

    jax_pkg = importlib.import_module(f"deep3dmap_tpu.{pkg}")
    port = importlib.import_module(f"deep3dmap_tpu_torch.{pkg}")
    waiting = MULTI_GPU.get(pkg, set())
    imported = {n for n in dir(jax_pkg) if not n.startswith("_")
                and not isinstance(getattr(jax_pkg, n), types.ModuleType)}
    assert set(jax_pkg.__all__) - waiting <= set(port.__all__), \
        set(jax_pkg.__all__) - waiting - set(port.__all__)
    missing = [n for n in sorted((imported | set(jax_pkg.__all__)) - waiting)
               if not hasattr(port, n)]
    assert not missing, f"{pkg}: {missing}"


def test_registries_cover_jax():
    """Importing a package fills its registries with every name the JAX
    package's import registers: ``DATASETS``, ``PIPELINES``, ``RUNNERS``,
    ``HOOKS``, ``BACKBONES``, ``LOSSES``, ``RECONSTRUCTORS``, ``METRICS``
    and the optimizers of ``runners/optim.py``."""
    import deep3dmap_tpu.core.evaluation.evaluator as jeval
    import deep3dmap_tpu.datasets as jd
    import deep3dmap_tpu.models as jm
    import deep3dmap_tpu.runners as jr
    import deep3dmap_tpu_torch.core.evaluation.evaluator as teval
    import deep3dmap_tpu_torch.datasets as td
    import deep3dmap_tpu_torch.models as tm
    import deep3dmap_tpu_torch.runners as tr

    pairs = [(jd.DATASETS, td.DATASETS), (jd.PIPELINES, td.PIPELINES),
             (jr.RUNNERS, tr.RUNNERS), (jr.HOOKS, tr.HOOKS), (jm.BACKBONES, tm.BACKBONES),
             (jm.LOSSES, tm.LOSSES), (jm.RECONSTRUCTORS, tm.RECONSTRUCTORS),
             (jeval.METRICS, teval.METRICS)]
    for want, got in pairs:
        # the package's own names: other tests register toys into JAX's
        # registries in this process
        names = {k for k, v in want.module_dict.items()
                 if getattr(v, "__module__", "").startswith("deep3dmap_tpu.")}
        assert names and names <= set(got.module_dict), (want.name, names - set(got.module_dict))
    assert set(jr.OPTIMIZERS.module_dict) <= set(tr.OPTIMIZERS)
    from deep3dmap_tpu_torch.runners import EpochBasedRunner
    from deep3dmap_tpu_torch.utils import Config, fileio
    from deep3dmap_tpu_torch.models import build_backbone
    from deep3dmap_tpu_torch.models.losses import L1Loss
    from deep3dmap_tpu_torch.datasets import build_dataset
    assert tr.RUNNERS.get("EpochBasedRunner") is EpochBasedRunner
    assert callable(build_backbone) and callable(build_dataset) and L1Loss and Config and fileio


def test_torch_free_modules_import_no_torch():
    """The package exports are lazy: the async producers' path (the
    datasets package, its builder, the async datasets, the face-UV and
    real-file readers), the utilities' registry and config, and the
    multipie tool's index step run without torch."""
    import subprocess
    import sys
    code = ("import sys\n"
            "import deep3dmap_tpu_torch.datasets as d, deep3dmap_tpu_torch.utils\n"
            "from deep3dmap_tpu_torch.datasets import async_producer, face_uv, real_files\n"
            "from deep3dmap_tpu_torch.utils import registry, config\n"
            "from deep3dmap_tpu_torch.tools import data_gen_multipie\n"
            "import deep3dmap_tpu_torch.models, deep3dmap_tpu_torch.runners\n"
            "import deep3dmap_tpu_torch.core.all3dtrans, deep3dmap_tpu_torch.core.utils\n"
            "d.build_dataset(dict(type='SyntheticFaceUVDataset', n_samples=1, resolution=8))[0]\n"
            "assert 'torch' not in sys.modules, sorted(m for m in sys.modules if 'torch' in m)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr


def test_face_leftovers_raise_without_gpu(tmp_path):
    """``FaceAlignment`` defaults to the card; the data-gen tools, the
    importers' host kinds and the async producers use no card."""
    _no_gpu()
    from deep3dmap_tpu_torch.models.face_alignment import FaceAlignment
    from deep3dmap_tpu_torch.tools import import_weights

    for kw in ({}, {"device": "cuda"}):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            FaceAlignment(n_modules=1, n_landmarks=5, resolution=64, **kw)
    fa = FaceAlignment(n_modules=1, n_landmarks=5, resolution=64, device="cpu")
    assert {p.device.type for p in fa.net.parameters()} == {"cpu"}
    from deep3dmap_tpu_torch.datasets.synthetic import seeded_vgg16_state_dict
    torch.save({k: torch.from_numpy(v) for k, v in seeded_vgg16_state_dict().items()},
               tmp_path / "vgg.pth")
    import_weights.main(["vgg16", str(tmp_path / "vgg.pth"), str(tmp_path / "vgg.npz")])
    assert (tmp_path / "vgg.npz").exists()


def test_new_exports_match_jax():
    """The names the exports brought in: ``parse_losses``, the one-sample
    global-volume windows and the landmark pose helpers, against JAX's on
    the same inputs (float32 rounding: 1e-6; the host numpy helpers
    bit-equal)."""
    import jax.numpy as jnp

    from deep3dmap_tpu.core import all3dtrans as jtrans
    from deep3dmap_tpu.models.frameworks import parse_losses as jparse
    from deep3dmap_tpu.models.modulars import read_window as jread, write_window as jwrite
    from deep3dmap_tpu_torch.core import all3dtrans as ttrans
    from deep3dmap_tpu_torch.models.frameworks import parse_losses
    from deep3dmap_tpu_torch.models.modulars import read_window, write_window

    rs = np.random.RandomState(0)
    losses = {"loss_a": rs.rand(3).astype(np.float32), "acc": rs.rand(2).astype(np.float32),
              "loss_b": np.float32(0.25)}
    jl, jlog = jparse({k: jnp.asarray(v) for k, v in losses.items()})
    tl, tlog = parse_losses({k: torch.from_numpy(np.asarray(v)) for k, v in losses.items()})
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    assert sorted(tlog) == sorted(jlog)
    vol = rs.randn(8, 8, 8, 2).astype(np.float32)
    win = rs.randn(4, 4, 4, 2).astype(np.float32)
    origin = np.array([1.4, 5.6, -2.0], np.float32)
    np.testing.assert_array_equal(
        read_window(torch.from_numpy(vol), torch.from_numpy(origin), 4).numpy(),
        np.asarray(jread(jnp.asarray(vol), jnp.asarray(origin), 4)))
    np.testing.assert_array_equal(
        write_window(torch.from_numpy(vol), torch.from_numpy(win), torch.from_numpy(origin)).numpy(),
        np.asarray(jwrite(jnp.asarray(vol), jnp.asarray(win), jnp.asarray(origin))))
    lmk, tpl = rs.rand(68, 2) * 200, rs.randn(68, 3) * 50
    for a, b in zip(ttrans.project_param(lmk, tpl), jtrans.project_param(lmk, tpl)):
        np.testing.assert_array_equal(a, b)
    R = jtrans.P2sRt(jtrans.estimate_affine_matrix_3d22d(tpl[:10], lmk[:10]))[1]
    for a, b in zip(ttrans.R2radangle(R), jtrans.R2radangle(R)):
        np.testing.assert_array_equal(a, b)
    five = list(rs.rand(10) * 100)
    assert ttrans.face_orientation(five) == jtrans.face_orientation(five)
    assert ttrans.is_rotation_matrix(np.eye(3)) and not ttrans.is_rotation_matrix(2 * np.eye(3))


def test_launcher_twins_run_the_port():
    jax_root = os.path.join(ROOT, "scripts")
    twin_root = os.path.join(ROOT, "deep3dmap_tpu_torch", "scripts")
    jax_scripts = sorted(os.path.relpath(os.path.join(d, n), jax_root)
                         for d, _, names in os.walk(jax_root) for n in names
                         if n.endswith(".sh"))
    twins = sorted(os.path.relpath(os.path.join(d, n), twin_root)
                   for d, _, names in os.walk(twin_root) for n in names if n.endswith(".sh"))
    assert jax_scripts and twins == jax_scripts
    for rel in twins:
        text = open(os.path.join(twin_root, rel)).read()
        words = text.replace("deep3dmap_tpu_torch", "")
        assert "jax" not in words.lower() and "deep3dmap_tpu" not in words, rel
        assert "$ROOT/tools" not in text and "XLA" not in text, rel
        if "run_" in rel:
            assert "launch train" in text or "launch test" in text, rel
    common = open(os.path.join(twin_root, "common.sh")).read()
    assert "torchrun" in common and "--launcher pytorch" in common
    assert "deep3dmap_tpu_torch.tools." in common
