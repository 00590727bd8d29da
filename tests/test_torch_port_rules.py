"""Rules of the PyTorch port that hold for every slice.

- ``deep3dmap_tpu_torch/`` (the CLIs included) and ``chip_smoke.py`` import
  no ``jax``, ``flax``, ``optax``, ``orbax`` or ``deep3dmap_tpu`` (an AST
  scan of every import statement);
- entry points (the frameworks, the renderer, the perceptual loss, the
  StyleGAN2 generator and discriminator, the Gan2Shape runner, the data
  path's GT fusion, the fixture writer, the data-gen) default to CUDA and
  raise on a machine without a GPU unless the caller asks for
  ``device="cpu"`` (the CLIs: ``tests/test_torch_cli.py``);
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
