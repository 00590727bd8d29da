#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``deep3dmap_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                  # the check: needs one CUDA card
    python3 chip_smoke.py --profile DIR    # also a torch.profiler pass at full
                                           # width, its tables into DIR

Phases; any error ends the run with a nonzero exit and no result line:

1. device: the card's name and power limit (``nvidia-smi``).
2. kernel vs plain: the fused TSDF/occupancy loss (one Triton kernel)
   against its plain PyTorch version on the card, at the three level sizes
   of the bench pyramid (1x24³, 1x48³, 1x96³, the dtypes ``val_fn`` gives
   it), a ragged size, an empty target, an all-zero mask, bf16 predictions,
   and two sizes called back to back (a ticket left unreset would show).
   Device time of the call (torch.profiler, inputs cold in the L2) and the
   time of one call with its host launch cost (CUDA events), beside the
   memory-rate bound.
3. CPU vs card: the small block config at float32 with TF32 off, same
   seeded weights, ``forward_test`` over 2 fragments with carried state and
   ``val_fn`` on the CPU and on the card; identical block ids.
4. full width: the ``bench.py`` NeuralRecon config (9 views at 480x640, 96³,
   block-sparse levels, bf16) with seeded weights; 2 warm-up plus 10 timed
   fragments through ``forward_test`` with carried state, then ``val_fn``,
   whose loss must launch the kernel exactly 3 times.
5. kernel vs plain (raster): the hard z-buffer raster (CUDA C++, built by
   ``nvcc`` from ``deep3dmap_tpu_torch/ops/csrc/raster_hard.cu`` into
   ``deep3dmap_tpu_torch/ops/_build/``) against its plain PyTorch version on
   the card: celeba's 128² renderer under seeded views at B = 1 and 4, a
   ragged 37x53 grid, vertices behind the camera with degenerate triangles,
   two sheets, a view with every pixel background, a zoomed grid whose
   triangles take the overflow path, a celeba view with vertices pulled
   near the camera (both paths), and a 128² mesh folded into a few pixels
   (atomic contention).  Equal bit for bit; the overflow count against the
   plain box rule; device times of every op the wrapper issues beside the
   bound.
6. CPU vs card (Gan2Shape): the small config at float32 with TF32 off, the
   same seeded weights, ``forward_test`` (hard raster) and the step-1 loss
   on the CPU and on the card.
7. full width (Gan2Shape): celeba's model config (128², nf 32, z_dim 512) in
   hard raster mode with seeded weights, one synthetic face: 3 warm-up and
   20 timed ``forward_test`` calls (one raster launch each, no host sync)
   in turns with the same model in splat mode, peak memory,
   ``forward_step1``, and the raster kernel against its plain version on
   this path's own inputs.

8. kernel vs plain (loss backward), run after phase 2: the Triton
   ``loss_bwd_kernel`` (one launch for up to three levels) against
   ``fused_tsdf_occ_loss_bwd_plain`` on each level, on the card, given the
   same sums (from the forward kernel) and cotangents: each of the three
   level sizes alone and all three in one launch, in the dtypes ``loss_fn``
   hands it (bool mask) and with the float32 mask it handed over before, a
   ragged size with bf16 predictions, ragged levels of three dtype sets in
   one launch, four levels (two launches), an empty target, an all-zero
   mask, bf16 predictions at 96³, each of g_total, g_occ and g_tsdf alone,
   and the three levels once through autograd (3 forward launches, 1
   backward).  Device time (the L2 flushed before each call) against the
   bytes bound.
9. CPU vs card (training), run after phase 3: the small block config at
   float32 with TF32 off, the same seeded weights, two ``train_step`` calls
   (clip + Adam) on the CPU and on the card; identical block ids, losses,
   every parameter's gradient, the parameters after the two steps.
10. full width (training), run after phase 4: the bench config with seeded
   weights, ``Adam(1e-3)`` after ``clip(1.0)`` as ``bench.py:218`` has it,
   the fragment and the state carried from step to step: 2 warm-up, 5 timed
   back to back and 5 synced steps; 3 loss forward launches and 1 backward
   launch (every level) per step, finite gradients, parameters that moved,
   no host sync, and the backward kernel against its plain version on this
   path's own inputs, its device time per step (the L2 flushed before each
   call) beside the bytes bound.
11. CPU vs card (Gan2Shape training), run after phase 7: the small config
   with batchsize 4, hard raster, float32, TF32 off, the same seeded
   weights, host-drawn lights, views and generator noise (its strength set
   to 0.1): two ``train_step`` calls of each mode (one Adam per head) and a
   ``fit_instance`` of stage_iters (2, 2, 2); logs, every head's gradient,
   the heads after the steps and after the instance; the raster on step 2's
   B = 4 input against its plain version.
12. full width (Gan2Shape training): celeba's model (128², z_dim 512,
   n_mlp 8, nf 32, batchsize 4, Adam 1e-4) in hard raster mode with seeded
   weights: 2 warm-up and 6 synced ``train_step`` calls per mode (raster
   launches 1 / 1 / 2 per step), only the mode's heads move, finite
   gradients, one ``fit_instance`` at cut stage_iters, the peak memory, the
   frozen generator and discriminator bitwise unchanged, one step of each
   mode under ``set_sync_debug_mode("error")``, and the raster against its
   plain version on step 2's and step 3's inputs; ``--profile DIR`` adds
   ``gan2shape_train_kernels.txt``.

13. determinism: two identical 3-step trainings on the card, bitwise equal
   after them (every parameter, and NeuralRecon's recurrent state): the
   small block NeuralRecon config through ``train_step`` and each Gan2Shape
   mode through ``Gan2ShapeRunner.train_step`` (hard raster), with the
   runners' cuDNN flags; a probe step of each under
   ``use_deterministic_algorithms(warn_only=True)`` lists any op PyTorch
   knows to be nondeterministic.
14. the CLIs at full width: a 480x640 fixture scene (27 frames, 3 fragments
   of 9 keyframes) through the port's data-gen, ``tools/train.py`` at the
   ``bench.py`` config on ``ScanNetDataset`` for one epoch (the runner's
   synced step time beside phase 10's bare step, the loader's time per
   sample, 3 + 1 loss launches per step, peak memory, no host sync in a
   step that does not log, the checkpoint), then ``tools/test.py`` on that
   checkpoint with ``evaluate`` (the host C++ op built and used).
15. learning check: the port's quality twin
   (``deep3dmap_tpu_torch/tools/quality_regression.py``: the JAX tool's
   template, fixture and both arms, FUSION_ON True and False) at 12
   epochs each (the tool's default 120); the trained fusion model must beat
   the untrained one by its
   condition (F-score + 0.05, AbsRel lower, an untrained NaN AbsRel
   worse than any finite one); ``fusion_delta_fscore`` beside
   ``QUALITY_r05.json``'s 0.466.
16. Gan2Shape through the CLIs at full width: seeded ``stylegan2``,
   ``bisenet`` and PSPNet ``.npz`` files in ``tools/import_weights.py``'s
   layouts and 4 synthetic 128² faces in CelebA's layout (PNG, ``.npy``
   latents); ``tools/train.py`` on ``configs/gan2shape/celeba.py`` as
   published but for the paths, stage_iters (10, 10, 10) x 1 stage and the
   hard raster (use_mask with BiSeNet at 512², nf 32, z_dim 512, batchsize
   4): 2 epochs, then ``--resume-from auto`` for a third; the runner's
   synced step per mode beside phase 12's bare step, raster launches 1 / 1 /
   2 per step and 86 per instance, the instance mask (1, 128, 128, 1) on the
   card, the instance wall, peak memory; ``tools/test.py`` on the
   checkpoint (its heads in ``forward_test``); ``parse_mask`` of
   celeba/car/church (BiSeNet at 512², PSPNet at 473² with 21 and 150
   classes) timed on the card and held against the CPU at TF32 off under
   the near-tie rule.

17. PRNet at ``configs/prnet/prnet_300wlp.py``'s model (R 256, base 16,
   B 16): ``forward_test`` and ``loss_fn`` on the CPU and on the card from
   the same seeded weights at TF32 off; 2 warm-up and 3 synced bare
   ``train_step`` calls (Adam 1e-4) and synced ``forward_test`` calls, with
   launches, device time and busy share from torch.profiler and the peak
   memory; then ``tools/train.py`` on the config for 2 epochs over a
   300W-LP-layout fixture (48 crops at 256² as PNG bytes named
   ``*_inp.jpg``, smooth ``.npy`` UV maps, the lists, ``uv_kpt_ind.txt``
   from ``uv_kpt_ind_from_bfm``; ``--cfg-options`` for the data paths only)
   and ``tools/test.py --eval nme`` on its checkpoint.
18. imgs2mesh at ``configs/pt3d_demos/imgs2face_multipie.py``'s model
   (256², V 3, B 2, n_verts 512, texture 64, sampling on): ``loss_fn`` in
   ``sup`` (with a supplied ``uvtex``) and ``sup_unsup`` on the CPU and on
   the card at TF32 off, every log var; 2 warm-up and 3 synced steps per
   state through ``StateMachineRunner.run_iter``, launches, busy share and
   peak memory; then the CLIs on a MultiPIE-layout fixture (4 identities x
   4 views at 256², pickled indexes, 512-vertex ``.obj`` scans) with
   ``use_sampling=False`` (the published ``sup`` state reads a ``uvtex``
   the reader does not give, in JAX as here) and ``state_steps=[0,1]`` for
   2 epochs, the state switch read from the log, and ``tools/test.py``.
   Neither face path launches a kernel of the repo: the counts stay as
   phase 16 left them.

19. CPU vs card (GNeRF): ``configs/gnerf/gnerf_synthetic.py``'s model
   (32², a 4x64 MLP, 16 + 16 samples, ndf 32, B 2) at float32 with TF32
   off, the same seeded weights and host-drawn randomness: one loss and
   backward of each ``ABAB`` sequence from the same weights, then
   ``forward_test`` at two random val poses.  The importance samples the
   CPU drew are replayed on the card (``sample_pdf`` jumps where a bin's
   cdf step meets its eps, so a summation order moves a sample by up to a
   bin): losses, logs and the spectral-norm state within 1e-4, maps within
   1e-3, the worst gradient leaf of each sequence printed (within 1e-2);
   the card's own samples printed beside them.
20. full width (GNeRF): ``configs/gnerf/blender.py``'s model (400², patch
   64, inv 64, 8x256 MLP, 64 + 64 samples, ndf 64, inv_depth 5, B 2, Adam
   2e-4 with betas (0, 0.99)) on a Blender-layout fixture written at 800²
   RGBA (the reader composites and resizes): 2 warm-up and 3 synced
   steps of each of the seven sequences through ``StateMachineRunner``
   (five Adams), the generator step again with TF32 matmuls, launches,
   device ms and busy share from torch.profiler over 2 ``ABAB``
   iterations, the peak bytes, ``forward_test`` per 400² view in chunks,
   and one ``ABAB`` iteration under ``set_sync_debug_mode("error")``; the
   matmul precision printed beside the numbers.
21. GNeRF through the CLIs: ``tools/train.py`` on ``blender.py`` and the
   fixture with ``state_steps=[0,1,2]`` (A, ABAB, B, the switches read
   from the log), a resumed fourth epoch, ``tools/test.py`` rendering the
   test split at 400²; ``dtu.py`` for one epoch on a 16-view DTU-layout
   fixture at 400x300 and its ``tools/test.py``; the learning check of
   ``tests/test_convergence.py:28-121`` (the refine fit raises PSNR by 3
   dB or more, the recovered rotation error halves) at 300 and 180 steps
   (the protocol's 500 and 300, cut to fit the time limit).
   No GNeRF phase launches a kernel of the repo.  Phase 19 also runs the
   generator step in float64 on the card against the CPU's float64 (a rule
   that differs would show there; rounding alone stays at float64's).

22. CPU vs card (LERF): ``configs/lerf/lerf_synthetic.py``'s model (the
   MLP RGB field) and the small hash-grid config of
   ``tests/test_lerf.py:113-133``, float32 with TF32 off, the same seeded
   weights and host-drawn uniforms: one ``loss_fn`` and backward (the MLP
   path's importance samples replayed from the CPU, as phase 19 does),
   then ``forward_test`` with two positives on weights where a later scale
   wins; losses within 1e-4, maps within 1e-3, best scales equal, the
   worst gradient leaf printed beside the CPU's float32 and the card's
   against the CPU's float64.
23. full width (LERF): ``configs/lerf/lerf.py``'s model and data as
   published but the paths (hash-grid RGB field 12 x 2^19 x 4, 96 + 48
   samples, 24 LERF samples, 30 scales, CLIP 512, DINO 384, 4,096 rays,
   Adam 1e-2 after the clip with the cosine schedule) on phase 20's
   Blender fixture at 400² (7 tile scales, 881 crops per image), with
   seeded ViT-B/16 and ViT-S/8 checkpoints written in their published
   layouts and converted by the port's importers: the pyramid and DINO
   precompute per image, 2 warm-up and 10 synced steps through
   ``IterBasedRunner.run_iter``, launches, device ms, busy share, the top
   device kernels and the hash grids' shares from torch.profiler over 2
   steps (each kernel counted once, by the range or autograd node that
   launched it), the peak bytes, ``forward_test`` with two positives per 4,096
   rays, one step and one ``forward_test`` under
   ``set_sync_debug_mode("error")``; ``--profile DIR`` adds
   ``lerf_train_kernels.txt``.
24. LERF through the CLIs: ``tools/train.py`` on ``lerf_synthetic.py``
   (16 iterations, checkpoints at 8 and 16, the cosine lr read from the
   JSON log), ``--resume-from auto`` to 24, ``tools/test.py``; ``lerf.py``
   for 80 iterations on the fixture with the seeded ``.npz`` files (the
   learning check: its RGB and CLIP losses fall) and ``tools/test.py`` on
   a test split given by ``--cfg-options`` (``lerf.py`` deletes
   ``data.test``).  Phase 13 trains LERF's small hash-grid config twice
   too.  No LERF phase launches a kernel of the repo.

25. the training runtime at full width under the supervisor: the
   ``bench.py`` model with ``BACKBONE2D.CKPT`` pointing at a ``.npz`` that
   ``tools/import_weights.py mnasnet`` wrote from a seeded torchvision-layout
   trunk (``NORM="none"``, ``TORCH_PAD``), on phase 14's fixture through
   ``tools/run_elastic.py``: ``RepeatDataset(times=2)``, a val split with
   ``workflow=[("train", 1), ("val", 1)]``, AdamW with ``paramwise_cfg``
   (norm and bias decay 0), ``poly`` with a linear warmup, the clip and
   ``cumulative_iters=2``, ``EMAHook``, ``EvalHook(save_best="loss")`` and a
   ``ClosureHook`` that raises once in the middle of epoch 2; 2 epochs.
   Exit 0 after exactly one restart, "Resumed from" in the log, the
   heartbeat at epoch 2, ``best/`` written, the grafted trunk equal to the
   ``.npz`` before the first step, 3 + 1 loss launches per micro-step,
   every loss finite; the runner's micro-step (median, max), the restart's
   wall time and the peak bytes.  A probe hook in the config writes each
   child's numbers to a JSON-lines file (its launch counters are its own
   process's).
26. the streaming demo at full width: two training steps of the demo's
   own model (the JAX demo's dense config at 96³; phase 25's checkpoint
   has the import-mode trunk and does not load into it, the reason is
   printed), then ``demos/demo_neucon.py --scannet`` on phase 14's fixture
   (9 views at 640x480, preview every fragment) and on synthetic
   fragments without the preview, from that checkpoint: meshes and PNGs
   written and non-empty, ``forward_test`` under
   ``set_sync_debug_mode("error")`` (the per-fragment host copy outside
   it), keyframes/s of both runs.

27. the SfM layer (``deep3dmap_tpu_torch/core/sfm/``), float32 with TF32
   off unless float64 is named: (a) the port on the CPU against the port on
   the card on ``tests/test_sfm.py``'s ring scene (6 cameras, 64 points,
   0.5 px of noise, a perturbed start), float64 and float32: 20 LM
   iterations with and without Huber, 15 pose-graph iterations on a
   12-node chain with a loop closure, RANSAC with 30% outliers on uniforms
   drawn once on the host and replayed on both; float64 states within 1e-9
   relative and the same accept sequence while the decisions are above
   rounding (past the cost's floor both sides compare two costs equal to
   ~1e-15 and either may take a step of rounding's size: then the cost
   within 1e-9, the states within 1e-6), float32 costs within 1e-3 and
   rotations within 1e-4 rad, the inliers equal but where a Sampson
   distance lies within 1e-3 of the threshold; (b) LM at
   ``tools/benchmark_ba.py``'s default problem (24 cameras, 4,096 points,
   32,768 observations) and at the capacity ``ba.py:29-32`` names (64,
   16,384, 131,072), 30 iterations each under
   ``set_sync_debug_mode("error")``: iterations/s and observations/s (CUDA
   events), the final cost within 5% of sigma^2 (2M - 6C - 3P) / 2, the
   peak bytes, two runs bitwise equal; the port's tool run as a user runs
   it, its JSON line read back; (c) ``match_images`` on two 640x480 frames
   (k 512: the share of matches that recover the shift), RANSAC of 256
   hypotheses over 2,048 correspondences (30% outliers) and
   ``recover_pose`` (rotation error below 1 degree), ms per call and the
   host syncs counted (``eigh``'s); (d) ``optimize`` on a 64-node chain
   with 8 loop closures, 15 iterations, sync-free, the anchor unchanged,
   ms per iteration; (e) torch.profiler over 2 LM iterations at capacity:
   launches per iteration, device ms, the busy share and the top 5 device
   ops.  No SfM op launches a kernel of the repo.

28. the detection data path (``configs/detection/coco_custom.py``,
   mmdetection's published COCO defaults): (a) a fixture written at run
   time (32 PNG frames at 640x480, ~7.3 COCO-like boxes a frame over 80
   classes, the annotation pickle through ``utils/fileio.dump``),
   ``CustomDataset`` through ``build_dataset`` and ``build_dataloader``
   (``GroupSampler`` from its ``flag``), the train pipeline (load, Resize
   to 1333x800, RandomFlip, PhotoMetricDistortion, AutoAugment with one
   policy each of Shear, Rotate, Translate, Color, Equalize, Brightness and
   Contrast, Normalize, Pad 32, ToTensor, Collect) uploaded by
   ``prefetch_to_device``: ms per sample, the first sample equal to the
   host's bit for bit; (b) the test pipeline's ``MultiScaleFlipAug`` (two
   scales, a flip): ms per sample; (c) the box ops on the card against the
   port's CPU run of the same inputs -- ``bbox_overlaps`` 5,000 x 5,000,
   ``batched_nms`` on 1,000 and 5,000 scored boxes over 80 classes,
   ``soft_nms`` linear and gaussian on 1,000, ``box_iou_rotated`` and
   ``nms_rotated`` on 1,000 rotated boxes: equal keep sets, scores and IoUs
   within 1e-5; ms per call (median of 5 after warm-up, CUDA events),
   launches and device ms per call (torch.profiler over 2 calls), host
   syncs of a call after a warm-up one, the top device ops; (d) detections made from the fixture's GT
   (jittered copies and false positives) through ``batched_nms`` on the
   card, the top 100 an image, ``evaluate`` for mAP at IoU 0.5 and 0.75
   (perfect detections give 1.0; the jittered mAP equals the CPU's) and
   for recall at (100, 300, 1000) proposals: seconds per evaluation.  No
   op of the path launches a kernel of the repo.

29. the op zoo (``deep3dmap_tpu_torch/ops/``), TF32 off, each op at the
   size of a published model that uses it: mask_rcnn_r50_fpn_1x_coco's P2
   (2 x 256 x 200 x 336) with 1,024 RoIs for ``roi_align`` (7x7, sampling
   0, aligned), ``roi_pool``, ``roi_align_rotated`` and ``deform_roi_pool``
   (gamma 0.1); DCNv2 (``modulated_deform_conv2d`` 128 at 100x168 and 256
   at 50x84, ``deform_conv2d`` 256, B 2); Deformable DETR's encoder
   (``ms_deform_attn``, 22,223 queries, 8 heads, 4 levels, 4 points, B 2);
   CARAFE (k 5, 256 channels, 100x168 -> 200x336); GA-RPN's
   ``masked_conv2d``; PWC-Net's ``correlation``; PSANet's ``psamask``
   (97x97 at 64x128); CornerNet's ``corner_pool`` (4 modes); TIN's
   ``tin_shift``; BorderDet's ``border_align``; RetinaNet's focal losses
   (403,200 anchors x 80 / 81 classes); pointnet2_ssg on ScanNet (8,192
   points, B 16: furthest point sampling to 1,024, ball query, gather and
   group, knn 16, three-NN interpolation at 128 channels); PointPillars'
   ``voxelize`` (120,000 points, 16,000 and 40,000 voxels), dv_second's
   ``dynamic_scatter`` (mean, max), ``points_in_boxes`` with 50 boxes;
   the BEV and 3D IoUs and ``nms3d``/``nms3d_normal`` on 1,000 boxes,
   PartA2's ``roiaware_pool3d`` (out 14, max and avg, 128 RoIs on 16,384
   points) and PointRCNN's ``roipoint_pool3d`` (512 points); PANet's
   ``pixel_group`` and PSENet's ``contour_expand`` at 640x640; the
   ``ResFCN256Cls`` backbone at 256² with B 16 (forward and backward, its
   FLOPs from ``utils/analysis.py``), ``grid_sample_3d`` on a 96³ x 32
   volume and ``back_project_dense`` at the bench fragment's first level.
   For each: the card's result against the port's own CPU run of the same
   function on the same inputs (a cut, named, where the CPU would take
   long): index outputs equal, floats within 1e-4 and gradients within 1e-3
   of the largest CPU value; ms per call (median of 3 after warm-up, CUDA
   events), forward and forward plus backward; launches, device ms and the
   top device ops of one call (torch.profiler); host syncs of one call;
   peak bytes.  No op of the zoo launches a kernel of the repo.

30. NeuralRecon's published training config and ``BP_GRAD_FRAC``: (a)
   ``configs/neural_recon/scannet.py``'s model as published (fpn-mnas-1,
   float32, dense, ``GLOBAL_DIMS`` [64, 128, 256], ``BACKBONE2D.MODE``
   "scan" and ``REMAT`` by default: the port runs the views as one
   checkpointed batch) on the bench fragment (9 x 480x640, 96³), TF32 off:
   1 warm-up and 2 timed ``train_step`` calls, then the same with
   ``REMAT=False`` from the same weights and fragment; every step's loss
   and the first step's worst gradient leaf within 1e-5 relative
   (bit-equal expected), ms per step (CUDA events, median and max) and
   ``max_memory_allocated`` of each; (b) the ``bench.py`` config with
   ``BP_GRAD_FRAC`` 0.25 (a no-op in the port), two ``train_step`` calls
   twice against the same steps without it: gradients within 1e-6 (float32
   summation order; bit-equal expected), the two runs bitwise equal, ms
   per step.
31. the face leftovers and the importers: (a) seeded StyleGAN2 (celeba.py's
   generator: 128², z 512, 8 mapping layers, channel multiplier 1), VGG16
   ``features`` and 19-class BiSeNet checkpoints in their published
   layouts through ``python -m deep3dmap_tpu_torch.tools.import_weights``,
   then Gan2Shape ``forward_test`` on the card with that ``gan_ckpt`` (hard
   raster, one launch a call) and ``parse_mask`` with that
   ``parsing_ckpt``, ``PerceptualLoss`` with that ``weights_path``: finite
   outputs, ms per call; (b) ``FaceAlignment`` at its defaults (2 modules,
   68 landmarks, 256²) on 8 face boxes, the card against the port's CPU run
   with the same weights and TF32 off: heatmaps within 1e-4, decoded
   landmarks within 1e-3 px but where the CPU's heatmap has a near-tie
   (argmax lead or a sub-pixel neighbour difference within 2e-4), ms per
   batch; (c) ``data_gen_prnet --synthetic-bfm`` on 16 300W-LP-layout
   images, ``tools/train.py`` on ``configs/prnet/prnet_300wlp.py`` with its
   output for one epoch, ``tools/test.py`` on an AFLW2000 fixture given by
   ``--cfg-options`` (the NME); (d) ``FaceTexUVAsyncDataset`` with 2
   producers over (c)'s maps, in a process whose main module imports no
   torch: batches/s over 20 ``get()`` calls, then ``FaceImagesAsyncDataset``
   with one (state ``sup_unsup``), and no producer held torch; (e)
   ``data_gen_multipie organize`` on a 64-line label file (the indexes),
   and ``get-lmk`` failing with the FAN quirk's ``TypeError``, as JAX's.

32. multi-GPU on ``torch.distributed`` (``deep3dmap_tpu_torch/parallel/``),
   (a) in this process, (b)'s ranks spawned as processes of this script
   (``--phase32-rank``), which reuse the kernels already built: (a) one
   NCCL rank at the bench
   config, 3 ``train_step``s from the seeded weights through the
   data-parallel path (the loss's sums and the gradients all-reduced)
   against the same 3 with no process group: losses and parameters
   bit-equal, 3 + 1 loss launches and the all-reduces counted per step,
   ms per step both ways (median, CUDA events), no host sync in a
   distributed step; (b) two gloo ranks sharing the card (gloo's
   collectives copy through pinned host memory): the data-parallel step
   on a global batch of 2 bench fragments against one rank on the same
   batch, at the bench config's bf16 (the loss within 1e-3, the whole
   gradient within 0.25, the loss's masks compared) and all float32 (the
   loss within 1e-5, the whole gradient 2e-3, its worst leaf 2e-2: a
   backward fed a rank's own sums is ~1 off), and on each rank the
   backward kernel on its level inputs and the all-reduced sums against
   plain; ``configs/neural_recon/scannet.py``'s dense model over
   ("data", "model") = (1, 2): the halo ConvGRU at the finest window
   against the whole cell within 2e-5 (TF32 off), each rank's
   global-volume bytes half of one rank's, one spatial ``train_step``
   against the unsharded step (the loss, the gradient within 1e-4 whole
   and 1e-3 a leaf, the weights after it printed); ``lm_solve_sharded`` against
   ``lm_solve`` at phase 27's ring scene in float64.  Then on the same two
   ranks: (c) PRNet (``prnet_300wlp.py``'s model, B 16), imgs2mesh
   (``imgs2face_multipie.py``'s, B 2, ``use_sampling=False``, both
   states), GNeRF (``blender.py``'s, B 2, the seven sequences of ``ABAB``)
   and LERF (``lerf.py``'s, 4,096 rays from the seeded ViTs' targets) on
   their full-width phases' first batches (17, 18, 20, 23), each batch
   split over ``data``, one step per sequence against one rank on the whole
   batch (GNeRF's importance samples, the ranks', replayed into it): the
   loss within 1e-5, the gradient 2e-3 whole and 2e-2 a leaf (TF32 off),
   and a backward fed each rank's own means far off; (d) ``celeba.py``'s
   Gan2Shape replicated (``fit_instance`` at one step a mode, hard raster):
   the ranks' heads bit-equal to each other and to one rank's, 1 / 1 / 2
   raster launches per mode on each rank, no collective; (e)
   ``scannet.py``'s spatial checkpoint: whole volumes in the file, each
   rank's slabs back on the mesh, the resumed step's 3 + 1 loss launches,
   one rank's resumed step within 1e-3 / 1e-4 of the mesh's; (f) ``val`` on
   the ``data`` axis (the f32 arm): the global batch's loss within 1e-5 of
   one rank's, 3 forward launches; (g) ``tools/test.py --launcher pytorch``
   on 3 fragments of a scene in order against one rank (in (a)'s process)
   within 1e-6.  The cuts: one step per mode for Gan2Shape without the
   parsing mask, and (g) at ``scannet_synthetic.py``'s size.

The raster's launches in the kernels line are phases 7's, 12's, 16's,
31's and 32 (d)'s main paths together; the fused loss's are phase 4's
(forward) or phase 10's (backward), phase 14's, phase 25's (both
attempts, train and val), phase 26's two training steps, phase 30's steps
and phase 32's distributed steps ((a)'s NCCL arm, (b)'s ranks: the
data-parallel and spatial steps, (e)'s steps and (f)'s ``val``).  The backward's ms, plain_ms and bound_ms are per
train step on phase 10's own inputs: its one launch over the three levels.
Before the last line it prints one
``{"kernels": [...]}`` line; the last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import gc
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from deep3dmap_tpu_torch.utils.tracing import counter, reset_counters


def loss_launches():
    """(forward, backward) fused-loss kernel launches since the last reset."""
    return counter("fused_loss.fwd_launches"), counter("fused_loss.bwd_launches")


HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
F32_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
# fused loss, per element: 5 loads converted, softplus (abs, neg, exp, add,
# log), two slogs (sign 4, abs, add, log, mul each), five masked accumulates
LOSS_OPS_PER_ELEM = 45

TOL_LOSS = dict(rtol=1e-4, atol=1e-6)   # kernel vs plain: f32 sums, other order
TOL_SLICE = 2e-3                        # CPU vs card, float32 (see phase 3)
TOL_VAL_RTOL = 1e-4
# raster kernel vs plain: the same float32 ops in the same order (phase 5)
TOL_RASTER = 1e-6
# Gan2Shape CPU vs card (phase 6), the slice tests' tolerances
# (tests/test_torch_gan2shape.py): heads 1e-5, normals 4e-5 (they divide
# depth differences by the pixel spacing), rendered outputs 1e-4, losses
# 1e-4 relative
TOL_G2S = dict(depth=1e-5, albedo=1e-5, normal=4e-5, recon_depth=1e-4,
               recon_im=1e-4)
TOL_G2S_LOSS_RTOL = 1e-4

BLOCK_CFGS = dict(N_LAYER=3, N_VOX=[32, 32, 32], VOXEL_SIZE=0.08,
                  TRAIN_NUM_SAMPLE=[64, 256],
                  FUSION=dict(FUSION_ON=True, FULL=True), LW=[1.0, 0.8, 0.64],
                  THRESHOLDS=[0, 0, 0], POS_WEIGHT=1.5,
                  BACKBONE2D=dict(ARC="fpn-mnas-0.5"), SPARSE_MODE="block",
                  BLOCK_SIZE=8, MAX_BLOCKS=[None, 4, 24])

# bench.py:159-179, the production fragment shape
BENCH_CFGS = dict(
    N_LAYER=3, N_VOX=[96, 96, 96], VOXEL_SIZE=0.04,
    TRAIN_NUM_SAMPLE=[4096, 16384, 65536],
    FUSION=dict(FUSION_ON=True, FULL=True), LW=[1.0, 0.8, 0.64],
    THRESHOLDS=[0, 0, 0], POS_WEIGHT=1.5, SPARSE_MODE="block", BLOCK_SIZE=8,
    GLOBAL_DTYPE="bfloat16", BLOCK_DTYPE="bfloat16",
    BACKBONE2D=dict(ARC="fpn-mnas-1", DTYPE="bfloat16", MODE="batch",
                    REMAT=False, INFER_MODE="batch"))
N_VIEWS, IMG_HW, N_VOX = 9, (480, 640), 96
WARMUP, TIMED = 2, 10
TRAIN_WARMUP, TRAIN_TIMED = 2, 5
ADAM, CLIP = dict(type="Adam", lr=1e-3), dict(max_norm=1.0)   # bench.py:218


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str):
    if not cond:
        fail(msg)


_T0 = time.perf_counter()


def phase(name: str):
    print(f"== {name} (at {time.perf_counter() - _T0:.1f} s)", flush=True)


def set_tf32(cudnn: bool, matmul: bool):
    torch.backends.cudnn.allow_tf32 = cudnn
    torch.backends.cuda.matmul.allow_tf32 = matmul
    print(f"tf32: cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")


# ---------------------------------------------------------------- phase 1 --
def device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()
    check(bool(out), "nvidia-smi printed nothing")
    return out[0].strip()


# ---------------------------------------------------------------- phase 2 --
L2_BYTES = 50e6
WINDOWS = 3          # profiler windows per device time
PLAIN_REPS = 16      # calls per window of a plain loss (~20 launches a call)
TRITON_STAGES = ("loss_kernel",)   # ops/fused_loss.py


def device_kernels(prof, names=None):
    """The CUDA kernels of a torch.profiler profile (averaged by name),
    without the device-side copies of ranges (``span:`` ones and torch's
    ``Optimizer.step``); only those whose name holds one of ``names`` when
    given."""
    from torch.autograd import DeviceType
    if not hasattr(prof, "_chip_smoke_averages"):   # parsed once per profile
        prof._chip_smoke_averages = prof.key_averages()
    return [e for e in prof._chip_smoke_averages
            if e.device_type == DeviceType.CUDA
            and not e.key.startswith(("span:", "Optimizer."))
            and (names is None or any(n in e.key for n in names))]


def kernel_us(prof, names=None) -> float:
    """Summed device time of those kernels, µs."""
    return sum(e.self_device_time_total for e in device_kernels(prof, names))


def cold_copies(args):
    """Copies of one input set that together exceed the L2 twice (at most
    64), so a call that cycles over them finds its inputs cold, as
    ``val_fn``'s loss finds the batch's targets."""
    nbytes = sum(a.numel() * a.element_size() for a in args)
    n = int(min(64, max(2, -(-2 * L2_BYTES // nbytes))))
    return [tuple(a.clone() for a in args) for _ in range(n)]


_FLUSH = []


def l2_flushed(fn):
    """``fn`` after a read of twice the L2 (one ``reduce_kernel``, which a
    ``names`` filter leaves out of the device time).  Cycling over cold
    copies does not cool the inputs of a kernel whose loads carry
    ``evict_first``: its own lines leave the L2 first, so the copies that
    ``clone`` last wrote stay there from call to call."""
    if not _FLUSH:
        _FLUSH.append(torch.zeros(int(2 * L2_BYTES) // 4, device="cuda"))

    def run(*a):
        _FLUSH[0].sum()
        return fn(*a)
    return run


def _profile_window(fn, arg_sets, reps: int) -> dict:
    from torch.profiler import ProfilerActivity, profile as tprofile
    for a in arg_sets:
        fn(*a)
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
        for r in range(reps):
            fn(*arg_sets[r % len(arg_sets)])
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / reps / 1e3
            for e in device_kernels(prof)}


def device_ops_ms(fn, arg_sets, reps: int = 64) -> dict:
    """Device time of one call by device op (kernels and memsets, by name):
    what ``reps`` calls issue, summed by torch.profiler, over ``reps``; of
    ``WINDOWS`` such windows the one with the median total (one window read
    0.011 and another 0.0066 ms for the same loss call)."""
    ws = [_profile_window(fn, arg_sets, reps) for _ in range(WINDOWS)]
    return sorted(ws, key=lambda d: sum(d.values()))[WINDOWS // 2]


def device_ms(fn, arg_sets, names=None, reps: int = 64, windows: int = WINDOWS) -> float:
    """Device time of one call: the device ops (those whose name holds one
    of ``names``, or all) that ``reps`` calls issue, over ``reps``; the
    median of ``windows`` windows."""
    sums = [sum(v for k, v in _profile_window(fn, arg_sets, reps).items()
                if names is None or any(n in k for n in names))
            for _ in range(windows)]
    return statistics.median(sums)


def call_ms(fn, arg_sets, reps: int = 64) -> float:
    """Median time of one call as its caller sees it, host launch cost
    included: CUDA events around each call, synchronised after each."""
    times = []
    for r in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*arg_sets[r % len(arg_sets)])
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def loss_inputs(gen, shape, pred_dtype=torch.float32, target_dtype=torch.float32,
                empty_target=False, zero_mask=False):
    dev = "cuda"

    def u(lo, hi):
        return torch.rand(shape, generator=gen, device=dev) * (hi - lo) + lo
    tsdf = u(-1, 1).to(pred_dtype)
    occ = torch.randn(shape, generator=gen, device=dev).to(pred_dtype)
    tsdf_t = u(-1, 1)
    occ_t = u(0, 1) > 0.7
    if empty_target:
        occ_t = torch.zeros_like(occ_t)
    mask = u(0, 1) > 0.3
    if zero_mask:
        mask = torch.zeros_like(mask)
    return tsdf, occ, tsdf_t, occ_t.to(target_dtype), mask


def loss_bound_ms(args) -> float:
    n = args[0].numel()
    nbytes = sum(a.numel() * a.element_size() for a in args) + 5 * 4
    return max(nbytes / HBM_BYTES_PER_S, n * LOSS_OPS_PER_ELEM / F32_OPS_PER_S) * 1e3


def phase_kernel_vs_plain(fused_loss):
    phase("kernel vs plain: fused_tsdf_occ_loss (Triton) vs plain PyTorch")
    set_tf32(cudnn=False, matmul=False)
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16, b = torch.bfloat16, torch.bool
    cases = [(f"level{i}_{d}^3", (1, d, d, d), dict()) for i, d in
             enumerate((24, 48, 96))]
    cases += [("ragged_1000003_bf16", (1000003,),
               dict(pred_dtype=bf16, target_dtype=b)),
              ("empty_target_48^3", (1, 48, 48, 48), dict(empty_target=True)),
              ("zero_mask_48^3", (1, 48, 48, 48), dict(zero_mask=True)),
              ("bf16_pred_96^3", (1, 96, 96, 96),
               dict(pred_dtype=bf16, target_dtype=b))]
    max_err = 0.0
    timed = {}
    for name, shape, kw in cases:
        args = loss_inputs(gen, shape, **kw)
        before = counter("fused_loss.fwd_launches")
        got = torch.stack(fused_loss.fused_tsdf_occ_loss(*args, pos_weight=1.5))
        again = torch.stack(fused_loss.fused_tsdf_occ_loss(*args, pos_weight=1.5))
        want = torch.stack(fused_loss.fused_tsdf_occ_loss_plain(*args,
                                                                pos_weight=1.5))
        torch.cuda.synchronize()
        check(counter("fused_loss.fwd_launches") == before + 2,
              f"{name}: the wrapper did not launch the kernel")
        check(torch.isfinite(got).all().item(), f"{name}: non-finite loss {got}")
        check(torch.equal(got, again), f"{name}: two runs differ: {got} {again}")
        err = (got - want).abs().max().item()
        check(torch.allclose(got, want, **TOL_LOSS),
              f"{name}: kernel {got.tolist()} vs plain {want.tolist()}")
        if "empty_target" in name or "zero_mask" in name:
            check(got[0].item() == 0.0, f"{name}: total loss should be 0")
        max_err = max(max_err, err)
        line = (f"fused_loss {name}: n={args[0].numel()} dtypes="
                f"{[str(a.dtype).replace('torch.', '') for a in args]} "
                f"kernel={got.tolist()} plain={want.tolist()} abs_err={err:.3g}")
        if name.startswith("level"):
            sets = cold_copies(args)

            def kern(*a):
                return fused_loss.fused_tsdf_occ_loss(*a, pos_weight=1.5)

            def plain(*a):
                return fused_loss.fused_tsdf_occ_loss_plain(*a, pos_weight=1.5)
            # ms: the Triton kernel; wrapper_ms: every device op of the
            # call (the same: the wrapper issues nothing else); plain_ms:
            # the whole plain loss, sums and combine
            t = dict(ms=device_ms(kern, sets, names=TRITON_STAGES),
                     plain_ms=device_ms(plain, sets, reps=PLAIN_REPS),
                     bound_ms=loss_bound_ms(args),
                     wrapper_ms=device_ms(kern, sets),
                     call_ms=call_ms(kern, sets),
                     plain_call_ms=call_ms(plain, sets))
            for k, v in t.items():
                timed[k] = timed.get(k, 0.0) + v
            line += " " + " ".join(f"{k}={v:.6f}" for k, v in t.items())
            line += f" input_copies={len(sets)}"
        print(line, flush=True)
    print("fused_loss per val_fn (3 levels): " + " ".join(
        f"{k}={v:.6f}" for k, v in timed.items()) + " (ms: device time of "
          "the kernel; wrapper_ms: of every device op of the call; plain_ms: "
          "of the whole plain loss; call_ms: one call with its host launch "
          f"cost; bound: bytes over {HBM_BYTES_PER_S / 1e12} TB/s)", flush=True)
    max_err = max(max_err, loss_back_to_back(fused_loss, gen))
    return dict(timed, max_abs_err=max_err)


def loss_back_to_back(fused_loss, gen) -> float:
    """Two sizes (528 and 7 programs) called in turns without a sync: each
    result equals its size's first bit for bit and the plain version within
    TOL_LOSS, so the last program reset the ticket every time."""
    sizes = {"96^3": loss_inputs(gen, (1, 96, 96, 96)),
             "24^3": loss_inputs(gen, (1, 24, 24, 24))}
    order = ["96^3", "24^3", "24^3", "96^3", "24^3", "96^3"]
    before = counter("fused_loss.fwd_launches")
    outs = [torch.stack(fused_loss.fused_tsdf_occ_loss(*sizes[k], pos_weight=1.5))
            for k in order]
    torch.cuda.synchronize()
    n = counter("fused_loss.fwd_launches") - before
    check(n == len(order), f"back to back: {n} launches for {len(order)} calls")
    err = 0.0
    for k, args in sizes.items():
        want = torch.stack(fused_loss.fused_tsdf_occ_loss_plain(*args, pos_weight=1.5))
        got = [o for o, name in zip(outs, order) if name == k]
        for g in got:
            check(torch.equal(g, got[0]), f"back to back {k}: {g.tolist()} vs "
                  f"{got[0].tolist()}")
        check(torch.allclose(got[0], want, **TOL_LOSS),
              f"back to back {k}: kernel {got[0].tolist()} vs plain {want.tolist()}")
        err = max(err, (got[0] - want).abs().max().item())
    print(f"fused_loss back to back {order}: every call equals its size's first "
          f"bit for bit, abs_err={err:.3g} against the plain version", flush=True)
    return err


# ---------------------------------------------------------------- phase 8 --
# backward kernel vs plain: the same elementwise ops in the same order, but
# exp, log and the FMAs Triton forms may differ by an ulp; a bf16 gradient
# may round that ulp to the next bf16 value
TOL_LOSS_BWD = {torch.float32: dict(rtol=1e-5, atol=1e-12),
                torch.bfloat16: dict(rtol=2 ** -7, atol=1e-12)}
BWD_STAGES = ("loss_bwd_kernel",)   # ops/fused_loss.py


def loss_bwd_bound_ms(args) -> float:
    """The five inputs read and d_tsdf, d_occ written (plus the 5 sums and 3
    cotangents) over the memory rate; a few dozen flops per element are far
    below the float32 rate."""
    t, x = args[0], args[1]
    nbytes = (sum(a.numel() * a.element_size() for a in args[:5])
              + t.numel() * t.element_size() + x.numel() * x.element_size() + 8 * 4)
    return nbytes / HBM_BYTES_PER_S * 1e3


def forward_sums(fused_loss, levels) -> torch.Tensor:
    """The forward kernel's five floats of each level, as rows of one (L, 8)
    tensor: what the levels' autograd Function hands its backward."""
    sums = torch.empty((len(levels), 8), device="cuda", dtype=torch.float32)
    for row, args in zip(sums, levels):
        fused_loss.fused_tsdf_occ_loss_cuda(*args, pos_weight=1.5, out=row)
    return sums


def compare_loss_bwd(fused_loss, name, levels, g):
    """The backward kernel on a set of levels (one launch for up to
    ``_BWD_LEVELS`` of them) against the plain version on each level, given
    the forward kernel's sums and the (L, 3) cotangents ``g``; returns the
    max abs difference and the kernel's [(d_tsdf, d_occ), ...]."""
    sums = forward_sums(fused_loss, levels)
    n_launch = -(-len(levels) // fused_loss._BWD_LEVELS)
    before = counter("fused_loss.bwd_launches")
    got = fused_loss.fused_tsdf_occ_loss_bwd_cuda(levels, sums, g, 1.5)
    again = fused_loss.fused_tsdf_occ_loss_bwd_cuda(levels, sums, g, 1.5)
    torch.cuda.synchronize()
    n = counter("fused_loss.bwd_launches") - before
    check(n == 2 * n_launch, f"{name}: {n} backward launches for two "
          f"calls on {len(levels)} levels, expected {2 * n_launch}")
    err = 0.0
    for i, (args, pair, pair2) in enumerate(zip(levels, got, again)):
        want = fused_loss.fused_tsdf_occ_loss_bwd_plain(*args, sums[i, 3:5], g[i], 1.5)
        for what, a, b, c in zip(("d_tsdf", "d_occ"), pair, pair2, want):
            where = f"{name} level {i} {what}"
            check(a.dtype == c.dtype and a.shape == c.shape,
                  f"{where}: {a.dtype} {tuple(a.shape)} vs {c.dtype} {tuple(c.shape)}")
            check(torch.equal(a, b), f"{where}: two runs differ")
            check(torch.isfinite(a).all().item(), f"{where}: non-finite")
            tol = TOL_LOSS_BWD[a.dtype]
            check(torch.allclose(a.float(), c.float(), **tol),
                  f"{where}: kernel vs plain max abs diff "
                  f"{(a.float() - c.float()).abs().max().item()} (tol {tol})")
            err = max(err, (a.float() - c.float()).abs().max().item())
    return err, got


def _dtypes(args) -> str:
    return str([str(a.dtype).replace("torch.", "") for a in args])


def phase_loss_bwd(fused_loss):
    phase("kernel vs plain: fused_tsdf_occ_loss backward (Triton) vs plain PyTorch")
    set_tf32(cudnn=False, matmul=False)
    gen = torch.Generator(device="cuda").manual_seed(1)
    bf16, b, f32 = torch.bfloat16, torch.bool, torch.float32
    sides = (24, 48, 96)

    def rows(*r):
        return torch.tensor(r, device="cuda", dtype=f32)

    def f32_mask(args):     # the mask loss_fn handed over before: float32
        return args[:4] + (args[4].to(f32),)
    first = rows([1.0, 0.0, 0.0])
    lw = rows([1.0, 0.0, 0.0], [0.8, 0.0, 0.0], [0.64, 0.0, 0.0])  # loss_fn's
    # one level per launch, in loss_fn's dtypes (float32 predictions and
    # targets, a bool mask)
    cases = [(f"level{i}_{d}^3", [loss_inputs(gen, (1, d, d, d))], first)
             for i, d in enumerate(sides)]
    # the three levels in one launch, as a train step runs them
    cases += [("levels_24_48_96", [loss_inputs(gen, (1, d, d, d)) for d in sides], lw),
              ("levels_24_48_96_f32_mask",
               [f32_mask(loss_inputs(gen, (1, d, d, d))) for d in sides], lw)]
    cases += [("ragged_1000003_bf16", [loss_inputs(gen, (1000003,), pred_dtype=bf16,
                                                   target_dtype=b)], first),
              ("empty_target_48^3", [loss_inputs(gen, (1, 48, 48, 48),
                                                 empty_target=True)],
               rows([1.0, 0.5, 0.25])),
              ("zero_mask_48^3", [loss_inputs(gen, (1, 48, 48, 48), zero_mask=True)],
               rows([1.0, 0.5, 0.25])),
              ("bf16_pred_96^3", [loss_inputs(gen, (1, 96, 96, 96), pred_dtype=bf16,
                                              target_dtype=b)], first),
              # ragged levels of three dtype sets, cotangents that differ per
              # level, in one launch
              ("ragged_levels", [loss_inputs(gen, (1000003,), pred_dtype=bf16,
                                             target_dtype=b),
                                 loss_inputs(gen, (4097,)),
                                 f32_mask(loss_inputs(gen, (1, 7, 9, 11)))],
               rows([0.7, -0.3, 2.0], [1.0, 0.5, 0.25], [0.0, 1.0, 0.0])),
              # more levels than one launch takes: two launches
              ("four_levels", [loss_inputs(gen, (1, d, d, d)) for d in (8, 24, 48, 96)],
               rows([1.0, 0.0, 0.0], [0.8, 0.1, 0.0], [0.64, 0.0, 0.3],
                    [0.5, 0.2, 0.1]))]
    alone = loss_inputs(gen, (1, 48, 48, 48))
    for k, gname in enumerate(("g_total", "g_occ", "g_tsdf")):
        cases.append((f"{gname}_alone_48^3", [alone],
                      torch.eye(3, device="cuda")[k:k + 1].contiguous()))
    max_err, per_level = 0.0, {}
    for name, levels, g in cases:
        err, got = compare_loss_bwd(fused_loss, name, levels, g)
        max_err = max(max_err, err)
        if name.startswith("zero_mask"):
            check(not any(d.any().item() for d in got[0]), f"{name}: nonzero gradient")
        if name.startswith("empty_target"):
            check(not got[0][0].any().item(), f"{name}: nonzero tsdf gradient")
        line = (f"fused_loss_bwd {name}: n={[lv[0].numel() for lv in levels]} "
                f"dtypes={_dtypes(levels[0])} g={g.tolist()} abs_err={err:.3g}")
        if name.startswith("level"):
            t = time_loss_bwd(fused_loss, levels, g)
            if len(levels) == 1:
                for k, v in t.items():
                    per_level[k] = per_level.get(k, 0.0) + v
            line += " " + " ".join(f"{k}={v:.6f}" for k, v in t.items())
            line += f" bound_share={t['bound_ms'] / t['ms']:.6f}"
        print(line, flush=True)
    print("fused_loss_bwd the 3 levels one launch each (3 launches): " + " ".join(
        f"{k}={v:.6f}" for k, v in per_level.items()) + " (ms: device time of "
          "loss_bwd_kernel, the L2 flushed before each call; plain_ms: of the plain backward; "
          "call_ms: one call with its host launch; bound: bytes over "
          f"{HBM_BYTES_PER_S / 1e12} TB/s; tolerances {TOL_LOSS_BWD})", flush=True)
    max_err = max(max_err, loss_bwd_through_autograd(fused_loss, gen))
    return dict(max_abs_err=max_err)


def time_loss_bwd(fused_loss, levels, g) -> dict:
    """Device times of one backward call over ``levels`` (after an L2 flush)
    and of the plain backward on each level (on cold copies), and the bytes
    bound summed over the levels."""
    sums = forward_sums(fused_loss, levels)
    n_lv = len(levels)
    sets = cold_copies(tuple(a for lv in levels for a in lv) + (sums, g))

    def kern(*a):
        return fused_loss.fused_tsdf_occ_loss_bwd_cuda(
            [a[5 * i:5 * i + 5] for i in range(n_lv)], a[-2], a[-1], 1.5)

    def plain(*a):
        return [fused_loss.fused_tsdf_occ_loss_bwd_plain(
            *a[5 * i:5 * i + 5], a[-2][i, 3:5], a[-1][i], 1.5) for i in range(n_lv)]
    return dict(ms=device_ms(l2_flushed(kern), sets, names=BWD_STAGES),
                plain_ms=device_ms(plain, sets, reps=PLAIN_REPS),
                bound_ms=sum(loss_bwd_bound_ms(lv) for lv in levels),
                call_ms=call_ms(kern, sets))


def loss_bwd_through_autograd(fused_loss, gen) -> float:
    """``fused_tsdf_occ_loss_levels`` over the three level sizes,
    differentiated by autograd as ``loss_fn`` weights them: one forward
    launch per level, one backward launch, and the direct backward call's
    bits."""
    levels = [loss_inputs(gen, (1, d, d, d)) for d in (24, 48, 96)]
    ins = [(lv[0].clone().requires_grad_(), lv[1].clone().requires_grad_(), *lv[2:])
           for lv in levels]
    lw = (1.0, 0.8, 0.64)
    before = loss_launches()
    losses = fused_loss.fused_tsdf_occ_loss_levels(ins, pos_weight=1.5)
    total = sum(w * losses[i, 0] for i, w in enumerate(lw))
    got = torch.autograd.grad(total, [p for lv in ins for p in lv[:2]])
    torch.cuda.synchronize()
    n = [a - b for a, b in zip(loss_launches(), before)]
    check(n == [3, 1], "autograd: expected three forward launches and one backward "
          f"launch, got {n[0]} and {n[1]}")
    g = torch.tensor([[w, 0.0, 0.0] for w in lw], device="cuda")
    err, direct = compare_loss_bwd(fused_loss, "autograd_levels", levels, g)
    for a, b in zip(got, [d for pair in direct for d in pair]):
        check(torch.equal(a, b), "autograd: the Function's gradient differs from "
              "the direct backward call")
    print(f"fused_loss_bwd through autograd (24^3, 48^3, 96^3): 3 forward + 1 "
          f"backward launch, equal to the direct call bit for bit, abs_err={err:.3g}",
          flush=True)
    return err


# ---------------------------------------------------------------- phase 3 --
def _record_block_ids(nr_module):
    """Wrap the framework's ``select_blocks`` so every chosen block set is
    kept; returns (ids list, restore function)."""
    ids, orig = [], nr_module.select_blocks

    def rec(*a, **kw):
        bset = orig(*a, **kw)
        ids.append(bset.ids.cpu())
        return bset
    nr_module.select_blocks = rec

    def restore():
        nr_module.select_blocks = orig
    return ids, restore


def _stream(nr_module, fw, frags):
    ids, restore = _record_block_ids(nr_module)
    net = fw.net
    o1, m1 = fw.forward_test(net, fw.init_state(2), frags[0])
    o2, m2 = fw.forward_test(net, m1, frags[1])
    val = fw.val_fn(net, m1, frags[1])["log_vars"]["loss"]
    restore()
    host = lambda t: t.float().cpu()   # noqa: E731
    return dict(o1={k: host(v) for k, v in o1.items()},
                o2={k: host(v) for k, v in o2.items()},
                hidden=[host(v) for v in m2["global_hidden"].volumes],
                val=float(val), ids=ids)


def phase_cpu_vs_card(nr_module, stack, make_sample):
    phase("CPU vs card: small block config, float32, 2 fragments + val_fn")
    set_tf32(cudnn=False, matmul=False)
    frags = []
    for k, pair in enumerate(((0, 1), (2, 3))):
        b = stack([make_sample(seed=s, n_views=3, img_size=(64, 64), n_vox=32,
                               voxel_size=0.08, device="cpu") for s in pair])
        b["scene_reset"] = np.full(2, 1.0 if k == 0 else 0.0, np.float32)
        frags.append(b)
    cpu_fw = nr_module.NeuralRecon(BLOCK_CFGS, device="cpu")
    gpu_fw = nr_module.NeuralRecon(BLOCK_CFGS)
    cpu_fw.init(0, frags[0])
    gpu_fw.init(0, frags[0])
    for (k, a), (_, g) in zip(cpu_fw.net.state_dict().items(),
                              gpu_fw.net.state_dict().items()):
        check(torch.equal(a, g.cpu()), f"seeded weights differ at {k}")
    c = _stream(nr_module, cpu_fw, frags)
    g = _stream(nr_module, gpu_fw, frags)
    check(len(c["ids"]) == len(g["ids"]) == 6, "expected 6 block selections")
    for lvl, (a, b) in enumerate(zip(c["ids"], g["ids"])):
        check(torch.equal(a, b), f"block ids differ at selection {lvl}")
    worst = 0.0
    for frag in ("o1", "o2"):
        for k in ("tsdf", "occ", "origin"):
            d = (c[frag][k] - g[frag][k]).abs().max().item()
            worst = max(worst, d)
            check(d <= TOL_SLICE, f"{frag}/{k}: CPU vs card differ by {d}")
    for lvl, (a, b) in enumerate(zip(c["hidden"], g["hidden"])):
        d = (a - b).abs().max().item()
        worst = max(worst, d)
        check(d <= TOL_SLICE, f"hidden level {lvl}: CPU vs card differ by {d}")
    rel = abs(c["val"] - g["val"]) / max(abs(c["val"]), 1e-12)
    check(rel <= TOL_VAL_RTOL, f"val_fn: CPU {c['val']} vs card {g['val']}")
    print(f"cpu_vs_card: block ids identical ({len(g['ids'])} selections), "
          f"max abs diff {worst:.3g} (tol {TOL_SLICE}: the bf16 "
          f"back-projection table turns float32 sum-order differences into "
          f"occasional one-ulp bf16 steps), val cpu={c['val']!r} "
          f"card={g['val']!r} rel={rel:.3g}", flush=True)


# ---------------------------------------------------------------- phase 9 --
# CPU vs card, training.  The backward is sensitive to its forward: a ReLU
# input within the forward's float32 difference of 0 passes or blocks its
# gradient and GroupNorm spreads that over its group, so gradients agree
# to the tolerances measured between the port and JAX on the CPU
# (tests/test_torch_neuralrecon_train.py), not to float32 rounding.  Two Adam
# steps move a weight by at most ~1.0014 lr each, so two runs whose
# gradients differ in sign end at most 4.006 lr apart; the two runs' updates
# differed by 0.103 of their norm on an H100 (0.6% of the weights more than
# lr apart).
TOL_TRAIN = dict(loss_rtol=1e-4, leaf=5e-2, backbone_leaf=1e-1, whole=2e-2,
                 param_abs=4.006 * ADAM["lr"], update=0.25)


def _leaf_rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a.double() - b.double()).norm() / b.double().norm().clamp_min(1e-30)).item()


def _train_two_steps(nr_module, train_mod, fw, frags):
    state = train_mod.init_train_state(fw, 0, frags[0], ADAM, CLIP)
    net = state.net
    ids, restore = _record_block_ids(nr_module)
    logs, grads = [], None
    for b in frags:
        state, log = train_mod.train_step(fw, state, b)
        logs.append({k: float(v) for k, v in log.items()})
        if grads is None:      # the first step's (clipped) gradients
            grads = {n: p.grad.detach().cpu().clone() for n, p in net.named_parameters()}
    restore()
    return dict(ids=ids, logs=logs, grads=grads,
                params={n: p.detach().cpu().clone() for n, p in net.named_parameters()})


def phase_train_cpu_vs_card(nr_module, train_mod, stack, make_sample):
    phase("CPU vs card: small block config, float32, 2 train steps (clip + Adam)")
    set_tf32(cudnn=False, matmul=False)
    frags = []
    for k, pair in enumerate(((0, 1), (2, 3))):
        b = stack([make_sample(seed=s, n_views=3, img_size=(64, 64), n_vox=32,
                               voxel_size=0.08, device="cpu") for s in pair])
        b["scene_reset"] = np.full(2, 1.0 if k == 0 else 0.0, np.float32)
        frags.append(b)
    cpu_fw = nr_module.NeuralRecon(BLOCK_CFGS, device="cpu")
    gpu_fw = nr_module.NeuralRecon(BLOCK_CFGS)
    c = _train_two_steps(nr_module, train_mod, cpu_fw, frags)
    g = _train_two_steps(nr_module, train_mod, gpu_fw, frags)
    # the seeded init, recomputed: both sides start from these weights
    cpu_fw.init(0, frags[0])
    p0 = {n: p.detach().clone() for n, p in cpu_fw.net.named_parameters()}
    check(len(c["ids"]) == len(g["ids"]) == 4, "expected 4 block selections")
    for k, (a, b) in enumerate(zip(c["ids"], g["ids"])):
        check(torch.equal(a, b), f"block ids differ at selection {k}")

    def rel(step, k):
        a, b = c["logs"][step][k], g["logs"][step][k]
        return abs(a - b) / max(abs(a), 1e-12)
    losses = [k for k in c["logs"][0] if k != "grad_norm"]
    loss1 = max(rel(0, k) for k in losses)
    loss2 = max(rel(1, k) for k in losses)
    names = list(c["grads"])
    leaf = {n: _leaf_rel(g["grads"][n], c["grads"][n]) for n in names}
    flat = lambda d: torch.cat([d[n].reshape(-1) for n in names])   # noqa: E731
    whole = _leaf_rel(flat(g["grads"]), flat(c["grads"]))
    gn_rel = rel(0, "grad_norm")
    p_abs = max((g["params"][n] - c["params"][n]).abs().max().item() for n in names)
    moved = sum(int((c["params"][n] != p0[n]).sum()) for n in names)
    apart = sum(int(((g["params"][n] - c["params"][n]).abs() > ADAM["lr"]).sum())
                for n in names)
    upd = _leaf_rel(flat(g["params"]) - flat(p0), flat(c["params"]) - flat(p0))
    print(f"train_cpu_vs_card: block ids identical ({len(g['ids'])} selections), "
          f"step-1 losses rel {loss1:.3g}, step-2 losses rel {loss2:.3g}, "
          f"grad norm cpu={c['logs'][0]['grad_norm']!r} "
          f"card={g['logs'][0]['grad_norm']!r}, gradients: max leaf rel "
          f"{max(leaf.values()):.3g} (off backbone2d "
          f"{max(v for n, v in leaf.items() if not n.startswith('backbone2d')):.3g}), "
          f"whole {whole:.3g}; parameters after 2 steps: max abs diff {p_abs:.3g}, "
          f"{apart} of {moved} moved weights more than lr apart, update rel {upd:.3g} "
          f"(tolerances {TOL_TRAIN})", flush=True)
    check(loss1 <= TOL_TRAIN["loss_rtol"], f"step-1 losses CPU vs card off by {loss1}")
    bad = {n: v for n, v in leaf.items() if v > TOL_TRAIN[
        "backbone_leaf" if n.startswith("backbone2d") else "leaf"]}
    check(not bad, f"gradients off per leaf: {bad}")
    check(whole <= TOL_TRAIN["whole"] and gn_rel <= TOL_TRAIN["whole"],
          f"whole gradient off by {whole}, its norm by {gn_rel}")
    check(p_abs <= TOL_TRAIN["param_abs"] and upd <= TOL_TRAIN["update"],
          f"parameters after 2 steps differ by {p_abs}, their updates by {upd}")


# ---------------------------------------------------------------- phase 4 --
def phase_full_width(nr_module, stack, make_sample, card, profile_dir=None):
    phase("full width: bench.py config, 9x480x640, 96^3, block, bf16")
    # PyTorch's defaults, which a user of the port runs with (the port
    # flips no flag): TF32 for float32 convs, full float32 for matmuls
    set_tf32(cudnn=True, matmul=False)
    t0 = time.perf_counter()
    batch = stack([make_sample(seed=0, n_views=N_VIEWS, img_size=IMG_HW,
                               n_vox=N_VOX, voxel_size=0.04, device="cuda")])
    fw = nr_module.NeuralRecon(BENCH_CFGS)
    net, state = fw.init(0, batch)
    dev = fw.batch_to_device(batch)
    first = dict(dev, scene_reset=torch.ones(1, device=fw.device))
    cont = dict(dev, scene_reset=torch.zeros(1, device=fw.device))
    torch.cuda.synchronize()
    print(f"set-up (synthetic fragment, init) {time.perf_counter() - t0:.3f} s")

    reset_counters("fused_loss.fwd_launches")     # the main path starts here
    torch.cuda.reset_peak_memory_stats()
    out, state = fw.forward_test(net, state, first)
    for _ in range(WARMUP - 1):
        out, state = fw.forward_test(net, state, cont)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED):
        out, state = fw.forward_test(net, state, cont)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / TIMED
    lat = []
    for _ in range(TIMED):                        # one fragment at a time
        t0 = time.perf_counter()
        out, state = fw.forward_test(net, state, cont)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    val = fw.val_fn(net, state, cont)["log_vars"]["loss"]
    torch.cuda.synchronize()
    launches = counter("fused_loss.fwd_launches")  # ... and ends here
    peak = torch.cuda.max_memory_allocated()

    check(launches == 3, f"val_fn launched the fused loss {launches} times, "
          "expected 3 (one per level)")
    check(tuple(out["tsdf"].shape) == (1, N_VOX, N_VOX, N_VOX),
          f"tsdf shape {tuple(out['tsdf'].shape)}")
    for k in ("tsdf", "occ"):
        check(torch.isfinite(out[k]).all().item(), f"non-finite {k}")
    for v in state["global_hidden"].volumes:
        check(torch.isfinite(v).all().item(), "non-finite hidden state")
    check(bool(np.isfinite(float(val))), f"non-finite val loss {val}")
    occupied = int((out["tsdf"] != 1.0).sum().item())
    print(f"full_width: card={card!r} ms_per_fragment={dt * 1e3:.6f} "
          f"keyframes_per_s={N_VIEWS / dt:.6f} fragments_timed={TIMED} "
          f"synced_fragment_ms_median={statistics.median(lat):.6f} "
          f"synced_fragment_ms_max={max(lat):.6f} "
          f"max_memory_allocated_bytes={peak} val_loss={float(val)!r} "
          f"occupied_voxels={occupied} fused_loss_launches={launches} "
          f"max_blocks={fw.max_blocks}",
          flush=True)
    # no step of a fragment or of val_fn waits for the device: any
    # synchronising call (.item(), nonzero, a copy to the host) raises here
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    _, state = fw.forward_test(net, state, cont)
    fw.val_fn(net, state, cont)
    torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print("host syncs: none in forward_test and val_fn "
          "(torch.cuda.set_sync_debug_mode('error'))", flush=True)
    if profile_dir:
        st = [state]

        def fragment():
            st[0] = fw.forward_test(net, st[0], cont)[1]
        # the program's own spans (the trunk, each level's layers, gather_halo)
        profile("profile", "fragment", fragment, PROFILED_FRAGMENTS, [], [],
                os.path.join(profile_dir, "kernels.txt"))
    return launches


# ---------------------------------------------------------------- phase 10 --
def phase_train_full_width(nr_module, fused_loss, train_mod, stack,
                           make_sample, card, make_deterministic, profile_dir=None):
    phase("full width: training, bench.py config, 9x480x640, 96^3, clip + Adam")
    set_tf32(cudnn=True, matmul=False)   # PyTorch's defaults, as in phase 4
    make_deterministic()                 # as the runners and the CLIs set it
    t0 = time.perf_counter()
    batch = stack([make_sample(seed=0, n_views=N_VIEWS, img_size=IMG_HW,
                               n_vox=N_VOX, voxel_size=0.04, device="cuda")])
    fw = nr_module.NeuralRecon(BENCH_CFGS)
    state = train_mod.init_train_state(fw, 0, batch, ADAM, CLIP)
    net = state.net
    dev = fw.batch_to_device(batch)      # pinned on the card, as bench.py
    p0 = [p.detach().clone() for p in net.parameters()]
    torch.cuda.synchronize()
    print(f"set-up (synthetic fragment, init) {time.perf_counter() - t0:.3f} s")
    per_step, st = [], [state]

    def step():
        f0, b0 = loss_launches()
        st[0], log = train_mod.train_step(fw, st[0], dev)
        f1, b1 = loss_launches()
        per_step.append((f1 - f0, b1 - b0))
        return log

    reset_counters("fused_loss.")                 # the main path starts here
    torch.cuda.reset_peak_memory_stats()
    for _ in range(TRAIN_WARMUP):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TRAIN_TIMED):
        log = step()
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / TRAIN_TIMED
    lat = []
    for _ in range(TRAIN_TIMED):                  # one step at a time
        t0 = time.perf_counter()
        log = step()
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    launches = loss_launches()                    # ... and ends here
    peak = torch.cuda.max_memory_allocated()

    n_steps = TRAIN_WARMUP + 2 * TRAIN_TIMED
    check(per_step == [(3, 1)] * n_steps,
          f"loss (forward, backward) launches per step: {per_step}, expected (3, 1)")
    check(launches == (3 * n_steps, n_steps), f"loss launches {launches}")
    log = {k: float(v) for k, v in log.items()}
    check(all(np.isfinite(v) for v in log.values()), f"non-finite log {log}")
    for n, p in net.named_parameters():
        check(p.grad is not None and torch.isfinite(p.grad).all().item(),
              f"missing or non-finite gradient at {n}")
    moved = sum(int((p.detach() != q).sum().item()) for p, q in zip(net.parameters(), p0))
    n_params = sum(p.numel() for p in p0)
    check(moved > 0.5 * n_params, f"only {moved} of {n_params} weights moved")
    for v in st[0].model_state["global_hidden"].volumes:
        check(torch.isfinite(v).all().item(), "non-finite hidden state")
    print(f"train_full_width: card={card!r} train_step_ms_median="
          f"{statistics.median(lat):.6f} train_step_ms_max={max(lat):.6f} "
          f"back_to_back_ms_per_step={dt * 1e3:.6f} "
          f"train_keyframes_per_s={N_VIEWS / dt:.6f} steps={n_steps} "
          f"max_memory_allocated_bytes={peak} "
          + " ".join(f"{k}={v!r}" for k, v in log.items())
          + f" loss_fwd_launches_per_step={launches[0] / n_steps} "
          f"loss_bwd_launches_per_step={launches[1] / n_steps} "
          f"weights_moved={moved}/{n_params}", flush=True)

    # no op of a step waits for the device, the backward's and Adam's
    # included: any synchronising call raises here
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    step()
    torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print("host syncs: none in train_step "
          "(torch.cuda.set_sync_debug_mode('error'))", flush=True)

    # the backward kernel against its plain version on this path's inputs:
    # the one call of a step, every level in it
    seen = []
    orig = fused_loss.fused_tsdf_occ_loss_bwd_cuda

    def spy(levels, sums, g, *a, **kw):
        seen.append(([tuple(x.detach().clone() for x in lv) for lv in levels],
                     sums.detach().clone(), g.detach().clone()))
        return orig(levels, sums, g, *a, **kw)
    fused_loss.fused_tsdf_occ_loss_bwd_cuda = spy
    step()
    fused_loss.fused_tsdf_occ_loss_bwd_cuda = orig
    check(len(seen) == 1 and len(seen[0][0]) == 3,
          f"{len(seen)} backward calls in one step, on "
          f"{[len(c[0]) for c in seen]} levels; expected one call on 3")
    levels, sums, g = seen[0]
    check(torch.equal(sums[:, :5], forward_sums(fused_loss, levels)[:, :5]),
          "main path: the step's forward sums differ from the kernel's on its inputs")
    err, _ = compare_loss_bwd(fused_loss, "main_path", levels, g)
    for i, args in enumerate(levels):
        print(f"fused_loss_bwd main_path level {i}: n={args[0].numel()} "
              f"dtypes={_dtypes(args)} g={g[i].tolist()} "
              f"bound_ms={loss_bwd_bound_ms(args):.6f}", flush=True)
    timed = time_loss_bwd(fused_loss, levels, g)
    print("fused_loss_bwd main path per step (3 levels, 1 launch): " + " ".join(
        f"{k}={v:.6f}" for k, v in timed.items())
          + f" bound_share={timed['bound_ms'] / timed['ms']:.6f} abs_err={err:.3g}",
          flush=True)
    if profile_dir:
        profile("train profile", "step", step, PROFILED_FRAGMENTS, [], [],
                os.path.join(profile_dir, "train_kernels.txt"))
    return dict(timed, launches=launches[1], max_abs_err=err,
                step_ms_median=statistics.median(lat))


PROFILED_FRAGMENTS = 3


def _span_hooks(wraps, modules):
    """Profiler spans around the functions that ``wraps`` names, as
    (namespace, name) or (namespace, name, span label) tuples, and around
    the forward of each (name, module) of ``modules``.  Returns a function
    that removes them."""
    from torch.profiler import record_function
    undo = []
    for ns, name, *label in wraps:
        f, own = getattr(ns, name), name in vars(ns)

        def spanned(*a, _f=f, _n=(label or [name])[0], **kw):
            with record_function("span:" + _n):
                return _f(*a, **kw)
        setattr(ns, name, spanned)
        # a method found on the class goes back to it; an attribute of the
        # namespace itself is put back
        undo.append(lambda ns=ns, n=name, f=f, own=own:
                    setattr(ns, n, f) if own else delattr(ns, n))
    open_spans = {}

    def pre(mod, inp, name):
        open_spans[name] = record_function("span:" + name)
        open_spans[name].__enter__()

    def post(mod, inp, out, name):
        open_spans.pop(name).__exit__(None, None, None)
    for name, m in modules:
        h1 = m.register_forward_pre_hook(lambda mod, inp, n=name: pre(mod, inp, n))
        h2 = m.register_forward_hook(lambda mod, inp, out, n=name: post(mod, inp, out, n))
        undo += [h1.remove, h2.remove]

    def remove():
        for u in reversed(undo):
            u()
    return remove


def profile(label, unit, call, n, wraps, modules, out_path, append=False):
    """torch.profiler over ``n`` calls of ``call`` (each one ``unit``): the
    device's busy share, kernel launches per unit, host and device time per
    ``span:`` range (the program's own, and those ``_span_hooks(wraps,
    modules)`` adds), and device time by kernel.
    Writes the tables to ``out_path`` (after what it holds, ``append``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    remove = _span_hooks(wraps, modules)
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            call()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    remove()
    avg = prof.key_averages()
    kernels = sorted(device_kernels(prof), key=lambda e: e.self_device_time_total,
                     reverse=True)
    busy_ms = kernel_us(prof) / 1e3
    n_launch = sum(e.count for e in kernels)
    lines = [f"{label}: {n} {unit}s, host wall {wall_ms / n:.3f} ms per "
             f"{unit} (profiler on), device kernel time {busy_ms / n:.3f} "
             f"ms per {unit} = {100 * busy_ms / wall_ms:.2f}% busy, "
             f"{n_launch / n:.1f} kernel launches per {unit}",
             f"spans (per {unit}): host ms incl. children | device ms | calls"]
    spans = sorted((e for e in avg if e.key.startswith("span:")
                    and e.device_type == DeviceType.CPU),
                   key=lambda e: e.cpu_time_total, reverse=True)
    for e in spans:
        lines.append(f"  {e.key[5:]:28s} {e.cpu_time_total / 1e3 / n:10.3f} "
                     f"{e.device_time_total / 1e3 / n:10.3f} {e.count / n:8.1f}")
    lines.append(f"kernels (per {unit}): device ms | share | launches")
    for e in kernels[:30]:
        lines.append(f"  {e.self_device_time_total / 1e3 / n:10.3f} "
                     f"{100 * e.self_device_time_total / 1e3 / busy_ms:6.2f}% "
                     f"{e.count / n:8.1f} {e.key[:100]}")
    with open(out_path, "a" if append else "w") as f:
        f.write("\n".join(lines) + "\n")
    print("\n".join(lines), flush=True)


# ---------------------------------------------------------------- phase 5 --
# ops/csrc/raster_hard.cu: the device ops of one call (two memsets, three
# kernels); its time counts them all
RASTER_KERNELS = ("tri_kernel", "big_kernel", "finalize_kernel")
# per pixel-triangle test: dx2, dy2, two products,
# a sum and a product for each of l0 and l1, two subtractions for l2, three
# compares and an and
RASTER_OPS_PER_TEST = 15
# configs/gan2shape/celeba.py:26-37, with the checkpoint paths (gan_ckpt,
# parsing_ckpt; not in the repository) dropped and raster_mode="hard" added
CELEBA_MODEL_CFGS = dict(
    image_size=128, gan_size=128, z_dim=512, n_mlp=8, nf=32,
    channel_multiplier=1, batchsize=4,
    min_depth=0.9, max_depth=1.1,
    xyz_rotation_range=60, xy_translation_range=0.1, z_translation_range=0.1,
    lam_perc=1.0, lam_smooth=0.01, lam_regular=0.01,
    use_mask=True, category="face",
    raster_mode="hard")
G2S_SMALL_CFG = dict(image_size=32, gan_size=32, z_dim=32, n_mlp=4, nf=8,
                     batchsize=2, channel_multiplier=1, raster_mode="hard")


def raster_tests(points3d, K) -> float:
    """Pixel-triangle tests the function needs on these inputs, whatever
    the kernel's design: the pixel centres inside each valid triangle's
    bounding box (clipped to the image), summed over triangles.  Valid is
    the inside test's own ``ok``: a nonzero area and every z > EPS."""
    from deep3dmap_tpu_torch.ops.raster import (EPS, grid_mesh_triangles,
                                                project)
    px, py, z = project(points3d.float(), K.float())
    B, H, W = z.shape
    xs, ys, zs = grid_mesh_triangles(torch.stack([px, py], -1), z)
    x0, x1, x2 = xs.unbind(1)
    y0, y1, y2 = ys.unbind(1)
    denom = (y1 - y2) * (x0 - x2) + (x2 - x1) * (y0 - y2)
    ok = (denom.abs() > 1e-9) & (zs > EPS).all(1)

    def centres(a, n):   # integer pixel centres in [min, max] within [0, n-1]
        lo = torch.ceil(a.amin(1)).clamp(0, n)
        hi = torch.floor(a.amax(1)).clamp(-1, n - 1)
        return torch.nan_to_num(hi - lo + 1).clamp(min=0).double()
    return float((centres(xs, W) * centres(ys, H) * ok).sum())


def raster_bound(points3d, tests: float):
    """(bound ms, what bounds it): three float32 input grids read and one
    output written (16 B per pixel) over the memory rate, against the
    needed tests' operations over the float32 rate."""
    B, H, W, _ = points3d.shape
    bytes_ms = 16 * B * H * W / HBM_BYTES_PER_S * 1e3
    ops_ms = tests * RASTER_OPS_PER_TEST / F32_OPS_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def _np_grid_points(rng, B, H, W, jitter, f=8.0):
    K = np.array([[f, 0, (W - 1) / 2], [0, f, (H - 1) / 2], [0, 0, 1]], np.float32)
    z = 1.0 + jitter * rng.rand(B, H, W).astype(np.float32)
    ys, xs = np.meshgrid(np.arange(H, dtype=np.float32),
                         np.arange(W, dtype=np.float32), indexing="ij")
    g = np.stack([xs, ys, np.ones_like(xs)], -1) @ np.linalg.inv(K).T
    return (g[None] * z[..., None]).astype(np.float32), K


def _celeba_views(renderer_mod, B, seed):
    """Warped points of celeba's 128² renderer: a face-like canonical depth
    in [0.9, 1.1] under seeded views scaled as Gan2Shape scales them."""
    r = renderer_mod.NrRenderer(CELEBA_MODEL_CFGS, 128, device="cuda")
    rs = np.random.RandomState(seed)
    yy, xx = np.meshgrid(np.linspace(-1, 1, 128), np.linspace(-1, 1, 128),
                         indexing="ij")
    amp = rs.uniform(0.08, 0.15, (B, 1, 1))
    depth = 1.05 - amp * np.exp(-2 * (xx ** 2 + yy ** 2))
    depth = depth + rs.uniform(0, 0.003, (B, 128, 128))
    view = rs.uniform(-1, 1, (B, 6)) * np.array(
        [np.pi / 3] * 3 + [0.1] * 3)
    R, t = renderer_mod.get_transform_matrices(
        torch.from_numpy(view.astype(np.float32)).cuda())
    pts = r.get_warped_3d_grid(torch.from_numpy(depth.astype(np.float32)).cuda(),
                               R, t)
    return pts, r.K, r.max_depth


def raster_cases(renderer_mod):
    dev = "cuda"
    cases = []
    for B, seed in ((1, 0), (4, 1)):
        pts, K, bg = _celeba_views(renderer_mod, B, seed)
        cases.append((f"celeba_128^2_B{B}", pts, K, bg))

    def host(name, pts, K, bg=2.0):
        cases.append((name, torch.from_numpy(np.ascontiguousarray(pts)).to(dev),
                      torch.from_numpy(K).to(dev), bg))
    rng = np.random.RandomState(0)
    host("ragged_37x53", *_np_grid_points(rng, 1, 37, 53, jitter=0.3))
    pts, K = _np_grid_points(rng, 1, 40, 48, jitter=0.2)
    pts[0, 3:9, 4:12, 2] = -0.5          # behind the camera
    pts[0, 20, 10, 2] = 0.0              # on the camera plane
    pts[0, 25] = pts[0, 24]              # a collapsed row: zero-area quads
    pts[0, 30:33, 5:9] = pts[0, 30, 5]   # a collapsed patch
    pts[0, 35, 6:30] = pts[0, 35, 6] + np.linspace(0, 1, 24)[:, None] * \
        (pts[0, 35, 29] - pts[0, 35, 6])  # a row of collinear vertices
    host("behind_camera_degenerate_40x48", pts, K)
    sheet, K = _np_grid_points(rng, 1, 32, 32, jitter=0.0, f=16.0)
    host("two_sheet_64x32", np.concatenate([sheet, sheet * 1.5], axis=1), K)
    off, K = _np_grid_points(rng, 1, 64, 64, jitter=0.1)
    off[..., 0] += 100.0                 # the whole mesh off screen
    host("all_background_64^2", off, K)
    # a 128² grid seen 20x magnified: its on-screen triangles are ~20 pixels
    # wide, so their boxes exceed the fast path's and take the overflow path
    zoom, K = _np_grid_points(rng, 1, 128, 128, jitter=0.05)
    K = K.copy()
    K[0, 0] = K[1, 1] = 8.0 * 20
    host("zoomed_grid_128^2", zoom, K)
    # a celeba view with three patches of vertices pulled near the camera
    # (z > EPS): their triangles reach far and overflow, the rest stay fast
    pts, K, bg = _celeba_views(renderer_mod, 1, 2)
    pts = pts.clone()
    for r, c in ((30, 40), (64, 64), (90, 20)):
        pts[0, r:r + 3, c:c + 3, 2] = 0.02
    cases.append(("celeba_near_camera_128^2", pts, K, bg))
    # a 128² mesh folded into a 5x5-pixel patch: every pixel centre there is
    # covered by many triangles, whose hits contend for its word
    H = W = 128
    f, cx = 8.0, (W - 1) / 2
    rr, cc = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    u = 62.0 + 2.0 * np.sin(0.37 * cc) + 0.01 * rr
    v = 62.0 + 2.0 * np.sin(0.29 * rr) + 0.01 * cc
    z = 1.0 + 0.2 * rng.rand(H, W)
    fold = np.stack([(u - cx) / f * z, (v - cx) / f * z, z], -1)[None]
    K = np.array([[f, 0, cx], [0, f, cx], [0, 0, 1]], np.float32)
    host("folded_128^2", fold.astype(np.float32), K)
    return cases


def compare_raster(raster, name, pts, K, bg):
    """Kernel vs plain on one input, bit for bit; returns the max abs diff
    and the number of triangles that took the overflow path."""
    before = counter("raster.launches")
    got, n_big = raster.raster_grid_depth_hard_cuda(pts, K, bg, overflow=True)
    again = raster.raster_grid_depth_hard(pts, K, bg)
    want = raster.raster_grid_depth_hard_plain(pts, K, bg)
    torch.cuda.synchronize()
    check(counter("raster.launches") == before + 2,
          f"{name}: the wrapper did not launch the kernel")
    check(torch.equal(got, again), f"{name}: two runs differ")
    cov_g, cov_w = got != bg, want != bg
    n_diff = int((got != want).sum().item())
    err = (got - want).abs().max().item()
    check(torch.equal(cov_g, cov_w),
          f"{name}: coverage differs at {int((cov_g != cov_w).sum().item())} pixels")
    check(err <= TOL_RASTER, f"{name}: max abs diff {err} > {TOL_RASTER}")
    check(n_diff == 0, f"{name}: {n_diff} pixels differ from the plain version")
    n_big, n_plain = int(n_big.item()), int(raster.overflow_triangles_plain(pts, K))
    check(n_big == n_plain, f"{name}: {n_big} triangles took the overflow path, "
          f"the box rule gives {n_plain}")
    T = 2 * pts.shape[0] * (pts.shape[1] - 1) * (pts.shape[2] - 1)
    print(f"raster {name}: shape={tuple(pts.shape)} covered={int(cov_g.sum().item())}"
          f"/{got.numel()} unequal_pixels={n_diff} max_abs_diff={err:.3g} "
          f"coverage identical overflow_triangles={n_big}/{T}", flush=True)
    return err, n_big


def time_raster(raster, pts, K, bg):
    """Kernel and plain device times, the bound and what bounds it."""
    sets = [(pts.clone(), K, bg) for _ in range(4)]
    tests = raster_tests(pts, K)
    bound_ms, bound_by = raster_bound(pts, tests)
    ops = device_ops_ms(raster.raster_grid_depth_hard, sets)
    for k in RASTER_KERNELS:
        check(any(k in name for name in ops), f"raster: no {k} among {sorted(ops)}")
    other = [k for k in ops if not any(n in k for n in RASTER_KERNELS + ("Memset",))]
    check(not other, f"raster: the call issued device ops beside its own: {other}")
    print("raster device ops per call (ms): " + " ".join(
        f"{k[:40]!r}={v:.6f}" for k, v in sorted(ops.items())), flush=True)
    return dict(ms=sum(ops.values()),
                call_ms=call_ms(raster.raster_grid_depth_hard, sets),
                # thousands of launches a call: the profile's parse costs more
                # than the calls, and a call's time varies by <0.1%
                plain_ms=device_ms(raster.raster_grid_depth_hard_plain, sets[:2],
                                   reps=2, windows=1),
                bound_ms=bound_ms, bound_by=bound_by, tests=tests)


def phase_raster(raster, renderer_mod, cuda_build):
    phase("kernel vs plain: raster_grid_depth_hard (CUDA C++) vs plain PyTorch")
    set_tf32(cudnn=False, matmul=False)
    t0 = time.perf_counter()
    so = cuda_build.build("raster_hard")
    print(f"built {os.path.relpath(so)} in {time.perf_counter() - t0:.3f} s (set-up)")
    with open(so[:-3] + ".log") as f:
        print("ptxas: " + " | ".join(ln.strip() for ln in f
                                       if "registers" in ln or "spill" in ln))
    max_err = 0.0
    for name, pts, K, bg in raster_cases(renderer_mod):
        max_err = max(max_err, compare_raster(raster, name, pts, K, bg)[0])
        if name.startswith("celeba"):
            t = time_raster(raster, pts, K, bg)
            T = 2 * (pts.shape[1] - 1) * (pts.shape[2] - 1)
            print(f"raster {name} timing: " + " ".join(
                f"{k}={v:.6f}" if isinstance(v, float) else f"{k}={v}"
                for k, v in t.items()) + f" unculled_tests="
                f"{pts.shape[0] * pts.shape[1] * pts.shape[2] * T} (ms: device "
                "time of every op of the call, memsets included; call_ms: one "
                "call with its host launch)", flush=True)
    return max_err


# ---------------------------------------------------------------- phase 6 --
def _g2s_outputs(fw, net, batch):
    out, _ = fw.forward_test(net, {}, batch)
    total, log, _ = fw.forward_step1(net, {}, batch)
    res = {k: v.detach().float().cpu() for k, v in out.items()}
    res["loss"] = float(total.detach())
    res.update({k: float(v.detach()) for k, v in log.items()})
    return res


def phase_g2s_cpu_vs_card(g2s_module, dataset_cls):
    phase("CPU vs card: Gan2Shape small config (32², nf 8), hard raster, float32")
    set_tf32(cudnn=False, matmul=False)
    batch = dataset_cls(n_samples=1, image_size=32, z_dim=32).setup_input(0)
    cpu_fw = g2s_module.Gan2Shape(G2S_SMALL_CFG, device="cpu")
    gpu_fw = g2s_module.Gan2Shape(G2S_SMALL_CFG)
    cnet, _ = cpu_fw.init(0, batch)
    gnet, _ = gpu_fw.init(0, batch)
    for (k, a), (_, g) in zip(cnet.state_dict().items(), gnet.state_dict().items()):
        check(torch.equal(a, g.cpu()), f"seeded weights differ at {k}")
    c = _g2s_outputs(cpu_fw, cnet, batch)
    g = _g2s_outputs(gpu_fw, gnet, batch)
    bg = cpu_fw.max_depth
    check(torch.equal(c["recon_depth"] != bg, g["recon_depth"] != bg),
          "recon_depth coverage differs between the CPU and the card")
    diffs = {}
    for k, tol in TOL_G2S.items():
        d = (c[k] - g[k]).abs().max().item()
        diffs[k] = d
        check(d <= tol, f"{k}: CPU vs card differ by {d} > {tol}")
    for k in ("loss", "loss_l1", "loss_perc", "loss_smooth"):
        rel = abs(c[k] - g[k]) / max(abs(c[k]), 1e-12)
        diffs[k + "_rel"] = rel
        check(rel <= TOL_G2S_LOSS_RTOL, f"{k}: CPU {c[k]!r} vs card {g[k]!r}")
    print("g2s_cpu_vs_card: coverage identical, " + " ".join(
        f"{k}={v:.3g}" for k, v in diffs.items()) + f" (tolerances {TOL_G2S}, "
          f"losses rel {TOL_G2S_LOSS_RTOL})", flush=True)


# ---------------------------------------------------------------- phase 7 --
G2S_WARMUP, G2S_TIMED, G2S_STEP1_TIMED = 3, 20, 10
# the renderer's steps, each a span of the --profile pass
G2S_SPAN_METHODS = ("warp_canon_depth", "raster_depth", "get_normal_from_depth",
                    "get_inv_warped_2d_grid", "_grid_sample_images")
G2S_PROFILED = 3


def phase_g2s_full_width(g2s_module, raster, dataset_cls, card, profile_dir=None):
    phase("full width: Gan2Shape, configs/gan2shape/celeba.py model, 128², hard raster")
    # PyTorch's defaults, as a user of the port runs: TF32 for float32
    # convs, full float32 for matmuls
    set_tf32(cudnn=True, matmul=False)
    t0 = time.perf_counter()
    data = dataset_cls(n_samples=1, image_size=128, z_dim=512).setup_input(0)
    fw = g2s_module.Gan2Shape(CELEBA_MODEL_CFGS)
    net, state = fw.init(0, data)
    batch = fw.batch_to_device(data)
    torch.cuda.synchronize()
    print(f"set-up (synthetic face, init) {time.perf_counter() - t0:.3f} s")

    splat_fw = g2s_module.Gan2Shape(dict(CELEBA_MODEL_CFGS, raster_mode="splat"))
    splat_net, _ = splat_fw.init(0, data)
    splat_net.load_state_dict(net.state_dict())

    def splat():
        return splat_fw.forward_test(splat_net, state, batch)[0]
    per_call = []

    def hard():
        before = counter("raster.launches")
        out, _ = fw.forward_test(net, state, batch)
        per_call.append(counter("raster.launches") - before)
        return out

    def synced_ms(fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, out

    # the main path, hard mode, with splat mode's calls between its calls
    # (splat launches no raster kernel): the two modes are timed in turns,
    # hard first on even turns and splat first on odd ones, since the
    # host-bound call time drifts within a run
    reset_counters("raster.")                     # the main path starts here
    for _ in range(G2S_WARMUP):
        out = hard()
        splat()
    torch.cuda.synchronize()
    lat, splat_lat = [], []
    for i in range(G2S_TIMED):
        for mode in (("hard", "splat") if i % 2 == 0 else ("splat", "hard")):
            if mode == "hard":
                ms, out = synced_ms(hard)
                lat.append(ms)
            else:
                splat_lat.append(synced_ms(splat)[0])
    launches = counter("raster.launches")         # ... and ends here
    check(all(n == 1 for n in per_call),
          f"raster launches per forward_test: {per_call} (expected 1 each)")
    check(launches == G2S_WARMUP + G2S_TIMED, f"raster launched {launches} times")
    S = CELEBA_MODEL_CFGS["image_size"]
    for k, shape in (("depth", (1, S, S)), ("albedo", (1, S, S, 3)),
                     ("normal", (1, S, S, 3)), ("recon_im", (1, S, S, 3)),
                     ("recon_depth", (1, S, S))):
        check(tuple(out[k].shape) == shape, f"{k} shape {tuple(out[k].shape)}")
        check(torch.isfinite(out[k]).all().item(), f"non-finite {k}")
    covered = int((out["recon_depth"] != fw.max_depth).sum().item())
    check(covered > 0, "the hard raster covered no pixel")

    # peak over one call, total and above what was allocated before it
    # (both models' weights stay allocated throughout)
    peaks = {}
    for name, fn in (("hard", hard), ("splat", splat)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        fn()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        peaks[name] = f"max_memory_allocated_bytes={peak} call_peak_bytes={peak - held}"
    weight_bytes = sum(p.numel() * p.element_size() for m in (net, fw.perceptual.net)
                       for p in m.parameters())
    t0 = time.perf_counter()
    for _ in range(G2S_TIMED):
        fw.forward_test(net, state, batch)
    torch.cuda.synchronize()
    b2b_ms = (time.perf_counter() - t0) * 1e3 / G2S_TIMED

    step1 = lambda: fw.forward_step1(net, state, batch)   # noqa: E731
    for _ in range(G2S_WARMUP):
        step1()
    step1_lat = [synced_ms(step1)[0] for _ in range(G2S_STEP1_TIMED)]
    loss = float(step1()[0].detach())
    check(np.isfinite(loss), f"non-finite step-1 loss {loss}")

    med = statistics.median(lat)
    print(f"g2s_full_width: card={card!r} raster_mode=hard B=1 S={S} "
          f"forward_test_ms_median={med:.6f} forward_test_ms_max={max(lat):.6f} "
          f"instances_per_s={1e3 / med:.6f} back_to_back_ms={b2b_ms:.6f} "
          f"forward_step1_ms_median={statistics.median(step1_lat):.6f} "
          f"forward_step1_ms_max={max(step1_lat):.6f} step1_loss={loss!r} "
          f"{peaks['hard']} weight_bytes_per_model={weight_bytes} "
          f"raster_launches={launches} covered_pixels={covered}", flush=True)
    print(f"g2s_full_width: raster_mode=splat forward_test_ms_median="
          f"{statistics.median(splat_lat):.6f} forward_test_ms_max={max(splat_lat):.6f} "
          f"instances_per_s={1e3 / statistics.median(splat_lat):.6f} "
          f"{peaks['splat']} (timed in turns with hard "
          f"mode, {G2S_TIMED} calls each)", flush=True)

    # no step of forward_test waits for the device
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    fw.forward_test(net, state, batch)
    torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print("host syncs: none in Gan2Shape forward_test "
          "(torch.cuda.set_sync_debug_mode('error'))", flush=True)

    # the raster kernel against its plain version on this path's own input
    seen = []
    orig = fw.renderer.raster_depth
    fw.renderer.raster_depth = lambda p: (seen.append(p.detach().clone()), orig(p))[1]
    fw.forward_test(net, state, batch)
    del fw.renderer.raster_depth                 # back to the class's method
    pts = seen[0]
    err, n_big = compare_raster(raster, "main_path_celeba_128^2_B1", pts,
                                fw.renderer.K, fw.max_depth)
    t = time_raster(raster, pts, fw.renderer.K, fw.max_depth)
    print("raster main_path timing: " + " ".join(
        f"{k}={v:.6f}" if isinstance(v, float) else f"{k}={v}"
        for k, v in t.items()), flush=True)
    if profile_dir:
        # the heads and the renderer's steps
        profile("gan2shape profile", "call",
                lambda: fw.forward_test(net, state, batch), G2S_PROFILED,
                [(fw.renderer, n) for n in G2S_SPAN_METHODS],
                list(net.named_children()),
                os.path.join(profile_dir, "gan2shape_kernels.txt"))
    return dict(t, launches=launches, max_abs_err=err, overflow=n_big)


# ---------------------------------------------------------------- phase 11 --
# Gan2Shape training, CPU vs card: tests/test_gan2shape.py:22-23's config
# with celeba's batchsize 4 (step 2's raster input is then B = 4, as at full
# width), hard raster, float32, TF32 off.  The gradients are measured as
# phase 9 measures them; the step-3 gradient is ill-conditioned (the port's
# own moves by up to 4e-3 per leaf when its input is scaled by 1 + 1e-6,
# tests/test_torch_gan2shape_train.py).  Adam moves a weight by about lr
# per step whatever its gradient's size, so after n steps two runs end at
# most ~2n lr apart where a gradient's sign differs, and a loss read after
# such a step differs more.  On an H100 (two runs): each mode's first step
# within 1.1e-6, step 2's second within 1.2e-3 (its latent norm, a mean of
# small squares), the fit's stage means within 3.0e-3 and 4.9e-3 (the
# card's scatter-adds use atomics: its runs differ); gradients per leaf
# within 3.4e-4, whole 2.2e-4; the heads after 6 steps 1.9e-4 apart
# (update rel 0.014), after the fit 2.8e-4 (0.042).
G2S_ADAM = dict(type="Adam", lr=1e-4)          # configs/gan2shape/celeba.py:41
G2S_MODES = ("step1", "step2", "step3")
G2S_TRAIN_SMALL_CFG = dict(G2S_SMALL_CFG, batchsize=4)
G2S_SMALL_FIT = (2, 2, 2)
TOL_G2S_TRAIN = dict(loss_rtol=1e-5, curve_rtol=3e-2, leaf=1e-2, whole=5e-3,
                     param_abs=2.01 * 12 * G2S_ADAM["lr"], update=0.25)


def _host_drawn(fw, cpu_fw, seed: int):
    """Make ``fw`` draw its pseudo images' lights and views and its
    generator's noise from CPU generators seeded from ``seed`` (copied to
    its device), so the CPU and the card get the same draws.  Returns a
    function that undoes it."""
    gd = torch.Generator().manual_seed(seed)
    gn = torch.Generator().manual_seed(seed + 1)
    make_noise, draws = type(fw.generator).make_noise, type(cpu_fw).pseudo_draws
    fw.pseudo_draws = lambda rng, b: {
        k: v.to(fw.device) for k, v in draws(cpu_fw, gd, b).items()}
    fw.generator.make_noise = lambda batch, gen: [
        n.to(fw.device) for n in make_noise(fw.generator, batch, gn)]

    def undo():
        del fw.pseudo_draws
        del fw.generator.make_noise
    return undo


def _spy_raster(fw, step):
    """The raster inputs of one ``step()``, and what it returned."""
    seen, orig = [], fw.renderer.raster_depth
    fw.renderer.raster_depth = lambda p: (seen.append(p.detach().clone()), orig(p))[1]
    try:
        out = step()
    finally:
        del fw.renderer.raster_depth
    return seen, out


def _g2s_snapshot(net):
    return {n: p.detach().cpu().clone() for n, p in net.named_parameters()}


def _g2s_train_run(runner_mod, raster, fw, cpu_fw, data):
    """Two steps of each mode, then one ``fit_instance``; host-drawn
    randomness and ``noise_strength`` 0.1, so the noise enters."""
    undo = _host_drawn(fw, cpu_fw, 11)
    r = runner_mod.Gan2ShapeRunner(fw, G2S_ADAM, stage_iters=G2S_SMALL_FIT, num_stage=1)
    net, state = r.setup(data)
    with torch.no_grad():
        for m in fw.generator.modules():
            if hasattr(m, "noise_strength"):
                m.noise_strength.fill_(0.1)
    p0 = _g2s_snapshot(net)
    dev = fw.batch_to_device(data)
    b2 = dict(dev, **r._collect_canon(dev))
    proj, mask = r._collect_pool(b2)
    batches = dict(step1=dev, step2=b2, step3=dict(dev, proj_im=proj[:4],
                                                   proj_mask=mask[:4]))
    logs, grads, seen = {}, {}, []
    for mode in G2S_MODES:
        for k in range(2):
            if fw.device.type == "cuda" and (mode, k) == ("step2", 0):
                seen, log = _spy_raster(fw, lambda: r.train_step(mode, batches[mode]))
            else:
                log = r.train_step(mode, batches[mode])
            logs[mode, k] = {n: float(v) for n, v in log.items()}
            if k == 0:
                grads[mode] = {n: p.grad.detach().cpu().clone()
                               for n, p in net.named_parameters() if p.grad is not None}
    params = _g2s_snapshot(net)
    r.fit_instance(data)
    undo()
    return dict(p0=p0, logs=logs, grads=grads, params=params, fit=_g2s_snapshot(net),
                fit_logs=r.logs[-1], seen=seen)


def phase_g2s_train_cpu_vs_card(g2s_module, runner_mod, raster, dataset_cls):
    phase("CPU vs card: Gan2Shape training, small config (32², nf 8, B 4), "
          "hard raster, float32, 2 steps per mode + fit_instance")
    set_tf32(cudnn=False, matmul=False)
    data = dataset_cls(n_samples=1, image_size=32, z_dim=32).setup_input(0)
    cpu_fw = g2s_module.Gan2Shape(G2S_TRAIN_SMALL_CFG, device="cpu")
    gpu_fw = g2s_module.Gan2Shape(G2S_TRAIN_SMALL_CFG)
    c = _g2s_train_run(runner_mod, raster, cpu_fw, cpu_fw, data)
    g = _g2s_train_run(runner_mod, raster, gpu_fw, cpu_fw, data)
    for n in c["p0"]:
        check(torch.equal(c["p0"][n], g["p0"][n]), f"seeded weights differ at {n}")

    def rel(a, b):
        return abs(a - b) / max(abs(a), 1e-12)
    loss_rel = {f"{m}.{k}": max(rel(c["logs"][m, k][n], g["logs"][m, k][n])
                                for n in c["logs"][m, k])
                for m in G2S_MODES for k in range(2)}
    fit_rel = max(rel(v, g["fit_logs"][n]) for n, v in c["fit_logs"].items()
                  if isinstance(v, float))
    leaf, whole = {}, {}
    for m in G2S_MODES:
        names = sorted(c["grads"][m])
        check(names == sorted(g["grads"][m]), f"{m}: gradients reach other leaves")
        leaf[m] = max(_leaf_rel(g["grads"][m][n], c["grads"][m][n]) for n in names)
        whole[m] = _leaf_rel(torch.cat([g["grads"][m][n].reshape(-1) for n in names]),
                             torch.cat([c["grads"][m][n].reshape(-1) for n in names]))
    names = list(c["p0"])
    flat = lambda d: torch.cat([d[n].reshape(-1) for n in names])   # noqa: E731
    p_abs = {k: max((g[k][n] - c[k][n]).abs().max().item() for n in names)
             for k in ("params", "fit")}
    upd = {k: _leaf_rel(flat(g[k]) - flat(c["p0"]), flat(c[k]) - flat(c["p0"]))
           for k in ("params", "fit")}
    print("g2s_train_cpu_vs_card: logs rel by step " + " ".join(
        f"{k}={v:.3g}" for k, v in loss_rel.items()) + f" fit_instance stage means "
          f"rel {fit_rel:.3g}; gradients max leaf rel " + " ".join(
        f"{m}={v:.3g}" for m, v in leaf.items()) + " whole " + " ".join(
        f"{m}={v:.3g}" for m, v in whole.items()) + "; parameters after the 6 steps: "
          f"max abs diff {p_abs['params']:.3g} update rel {upd['params']:.3g}; after "
          f"fit_instance {G2S_SMALL_FIT}: max abs diff {p_abs['fit']:.3g} update rel "
          f"{upd['fit']:.3g} (tolerances {TOL_G2S_TRAIN})", flush=True)
    first = max(v for k, v in loss_rel.items() if k.endswith(".0"))
    check(first <= TOL_G2S_TRAIN["loss_rtol"]
          and max(max(loss_rel.values()), fit_rel) <= TOL_G2S_TRAIN["curve_rtol"],
          f"losses CPU vs card off: {loss_rel}, fit_instance {fit_rel}")
    check(max(leaf.values()) <= TOL_G2S_TRAIN["leaf"]
          and max(whole.values()) <= TOL_G2S_TRAIN["whole"],
          f"gradients off: per leaf {leaf}, whole {whole}")
    check(max(p_abs.values()) <= TOL_G2S_TRAIN["param_abs"]
          and max(upd.values()) <= TOL_G2S_TRAIN["update"],
          f"parameters off: {p_abs}, updates {upd}")
    # the raster on step 2's B = 4 input, against its plain version
    check(len(g["seen"]) == 1 and g["seen"][0].shape[0] == 4,
          f"step 2 rasterised {[tuple(p.shape) for p in g['seen']]}")
    compare_raster(raster, "step2_small_B4", g["seen"][0], gpu_fw.renderer.K,
                   gpu_fw.max_depth)


# ---------------------------------------------------------------- phase 12 --
G2S_TRAIN_WARMUP, G2S_TRAIN_TIMED = 2, 6
G2S_FIT_ITERS = (20, 20, 20)        # celeba: (600, 600, 400) x 4 stages
RASTER_PER_STEP = dict(step1=1, step2=1, step3=2)
# the configuration without use_mask, whose mask comes from the parsing model
CELEBA_TRAIN_CFGS = dict(CELEBA_MODEL_CFGS, use_mask=False)


def phase_g2s_train_full_width(g2s_module, runner_mod, raster, dataset_cls, card,
                               profile_dir=None):
    phase("full width: Gan2Shape training, configs/gan2shape/celeba.py model, 128², "
          "hard raster, Adam 1e-4")
    set_tf32(cudnn=True, matmul=False)   # PyTorch's defaults, as in phase 7
    print(f"left out: gan_ckpt and parsing_ckpt (the files are not in the "
          f"repository: seeded weights instead), use_mask (needs the parsing "
          f"model); stage_iters cut from (600, 600, 400) x 4 stages to "
          f"{G2S_FIT_ITERS} x 1 stage", flush=True)
    t0 = time.perf_counter()
    data = dataset_cls(n_samples=1, image_size=128, z_dim=512).setup_input(0)
    fw = g2s_module.Gan2Shape(CELEBA_TRAIN_CFGS)
    r = runner_mod.Gan2ShapeRunner(fw, G2S_ADAM, stage_iters=G2S_FIT_ITERS, num_stage=1)
    net, state = r.setup(data)
    frozen = {f"{k}.{n}": t.clone() for k, m in (("g", fw.generator), ("d", fw.discriminator))
              for n, t in m.state_dict().items()}
    dev = fw.batch_to_device(data)
    torch.cuda.synchronize()
    print(f"set-up (synthetic face, init) {time.perf_counter() - t0:.3f} s")

    per_step = {m: [] for m in G2S_MODES}
    batches = dict(step1=dev)

    def step(mode):
        before = counter("raster.launches")
        log = r.train_step(mode, batches[mode])
        per_step[mode].append(counter("raster.launches") - before)
        return log

    reset_counters("raster.")                     # the main path starts here
    torch.cuda.reset_peak_memory_stats()
    batches["step2"] = dict(dev, **r._collect_canon(dev))
    with torch.no_grad():
        _, _, o = fw.forward_step2(net, state, batches["step2"], r.rng)
    batches["step3"] = dict(dev, proj_im=o["proj_im"], proj_mask=o["mask"])
    lat, logs = {}, {}
    for mode in G2S_MODES:
        for _ in range(G2S_TRAIN_WARMUP):
            step(mode)
        torch.cuda.synchronize()
        lat[mode] = []
        for _ in range(G2S_TRAIN_TIMED):
            t1 = time.perf_counter()
            step(mode)
            torch.cuda.synchronize()
            lat[mode].append((time.perf_counter() - t1) * 1e3)
        # one more step: only the mode's heads move, their gradients finite
        before = _g2s_snapshot(net)
        logs[mode] = {k: float(v) for k, v in step(mode).items()}
        check(all(np.isfinite(v) for v in logs[mode].values()),
              f"{mode}: non-finite log {logs[mode]}")
        for name, head in net.named_children():
            trains = name in runner_mod.MODE_NETS[mode]
            ps = dict(head.named_parameters())
            moved = [n for n, p in ps.items()
                     if not torch.equal(p.detach().cpu(), before[f"{name}.{n}"])]
            if trains:
                check(bool(moved), f"{mode}: {name} did not move")
                for n, p in ps.items():
                    check(p.grad is not None and torch.isfinite(p.grad).all().item(),
                          f"{mode}: missing or non-finite gradient at {name}.{n}")
            else:
                check(not moved, f"{mode}: {name} moved ({moved[:3]})")
                check(all(p.grad is None for p in ps.values()),
                      f"{mode}: a gradient reached {name}")
    t1 = time.perf_counter()
    before = counter("raster.launches")
    r.fit_instance(data)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t1
    fit_launches = counter("raster.launches") - before
    launches = counter("raster.launches")         # ... and ends here
    peak = torch.cuda.max_memory_allocated()

    for mode, n in RASTER_PER_STEP.items():
        check(per_step[mode] == [n] * len(per_step[mode]),
              f"{mode}: raster launches per step {per_step[mode]}, expected {n}")
    s1, s2, s3 = G2S_FIT_ITERS
    want = 1 + s1 + s2 + max(s2 // 4, 1) + 2 * s3     # + the canon snapshot, the pool
    check(fit_launches == want, f"fit_instance launched the raster {fit_launches} "
          f"times, expected {want}")
    for k, m in (("g", fw.generator), ("d", fw.discriminator)):
        for n, t in m.state_dict().items():
            check(torch.equal(t, frozen[f"{k}.{n}"]), f"frozen {k}.{n} changed")
    fit_logs = r.logs[-1]
    check(all(np.isfinite(v) for v in fit_logs.values() if isinstance(v, float)),
          f"non-finite fit_instance logs {fit_logs}")
    print(f"g2s_train_full_width: card={card!r} B={fw.batchsize} S={fw.image_size} "
          + " ".join(f"g2s_{m}_ms_median={statistics.median(lat[m]):.6f} "
                     f"g2s_{m}_ms_max={max(lat[m]):.6f}" for m in G2S_MODES)
          + f" synced_steps_per_mode={G2S_TRAIN_TIMED} fit_instance_s={fit_s:.6f} "
          f"stage_iters={G2S_FIT_ITERS} num_stage=1 max_memory_allocated_bytes={peak} "
          + " ".join(f"raster_launches_per_{m}={per_step[m][0]}" for m in G2S_MODES)
          + f" fit_instance_raster_launches={fit_launches} raster_launches={launches}",
          flush=True)
    print("g2s_train_full_width logs: " + " ".join(
        f"{m}.{k}={v!r}" for m in G2S_MODES for k, v in logs[m].items()), flush=True)
    print("g2s_train_full_width fit_instance stage means: " + " ".join(
        f"{k}={v!r}" for k, v in fit_logs.items()), flush=True)
    print("frozen generator and discriminator: bitwise unchanged", flush=True)

    # no op of a step waits for the device, in any mode
    for mode in G2S_MODES:
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        step(mode)
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print("host syncs: none in train_step step1/step2/step3 "
          "(torch.cuda.set_sync_debug_mode('error'))", flush=True)

    # the raster on this path's own B = 4 inputs (step 2's pseudo images,
    # step 3's projected samples) against its plain version, bit for bit
    res = {}
    for mode in ("step2", "step3"):
        for pts in _spy_raster(fw, lambda: step(mode))[0]:
            name = f"main_path_{mode}_B{pts.shape[0]}"
            err, n_big = compare_raster(raster, name, pts, fw.renderer.K, fw.max_depth)
            res[name] = dict(time_raster(raster, pts, fw.renderer.K, fw.max_depth),
                             max_abs_err=err)
            print(f"raster {name} timing: " + " ".join(
                f"{k}={v:.6f}" if isinstance(v, float) else f"{k}={v}"
                for k, v in res[name].items()), flush=True)
    if profile_dir:
        spans = ([(fw.renderer, n) for n in G2S_SPAN_METHODS]
                 + [(fw.discriminator, "features", "discriminator"),
                    (torch.Tensor, "backward", "backward")]
                 + [(o, "step", "optimizer") for o in r.optimizers.values()])
        modules = list(net.named_children()) + [
            ("generator", fw.generator), ("vgg", fw.perceptual.net)]
        for i, mode in enumerate(G2S_MODES):
            profile(f"gan2shape train profile {mode}", "step", lambda: step(mode),
                    G2S_PROFILED, spans, modules,
                    os.path.join(profile_dir, "gan2shape_train_kernels.txt"),
                    append=i > 0)
    return dict(launches=launches, max_abs_err=max(v["max_abs_err"] for v in res.values()),
                step_ms={m: statistics.median(lat[m]) for m in G2S_MODES})


# ---------------------------------------------------------------- phase 13 --
DET_STEPS = 3


def _nondeterministic_ops(step):
    """The ops that PyTorch names as having no deterministic implementation
    while ``step()`` runs under ``use_deterministic_algorithms(warn_only)``
    (a probe: the mode swaps some kernels, so its step is not the path's)."""
    import warnings
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            step()
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
    return sorted({str(w.message).split(".")[0] for w in caught
                   if "deterministic" in str(w.message)})


def phase_determinism(nr_module, train_mod, g2s_module, runner_mod, stack, make_sample,
                      dataset_cls, make_deterministic):
    phase(f"determinism: two identical {DET_STEPS}-step trainings on the card, bitwise "
          "(NeuralRecon small block config; each Gan2Shape mode, hard raster; LERF's small "
          "hash-grid config)")
    set_tf32(cudnn=True, matmul=False)   # PyTorch's defaults, as a user runs
    make_deterministic()                 # as the runners and the CLIs do
    frags = []
    for k, pair in enumerate(((0, 1), (2, 3))):
        b = stack([make_sample(seed=s, n_views=3, img_size=(64, 64), n_vox=32,
                               voxel_size=0.08, device="cuda") for s in pair])
        b["scene_reset"] = np.full(2, 1.0 if k == 0 else 0.0, np.float32)
        frags.append(b)

    def nr_run(probe=False):
        fw = nr_module.NeuralRecon(BLOCK_CFGS)
        st = [train_mod.init_train_state(fw, 0, frags[0], ADAM, CLIP)]

        def step(k):
            st[0], _ = train_mod.train_step(fw, st[0], frags[min(k, 1)])
        for k in range(DET_STEPS):
            step(k)
        out = {f"param.{n}": p.detach().clone() for n, p in st[0].net.named_parameters()}
        out.update({f"hidden.{i}": v.clone() for i, v in
                    enumerate(st[0].model_state["global_hidden"].volumes)})
        return out, (_nondeterministic_ops(lambda: step(1)) if probe else None)

    def g2s_run(mode, probe=False):
        data = dataset_cls(n_samples=1, image_size=32, z_dim=32).setup_input(0)
        fw = g2s_module.Gan2Shape(G2S_TRAIN_SMALL_CFG)
        cpu_fw = g2s_module.Gan2Shape(G2S_TRAIN_SMALL_CFG, device="cpu")
        undo = _host_drawn(fw, cpu_fw, 11)
        r = runner_mod.Gan2ShapeRunner(fw, G2S_ADAM, stage_iters=G2S_SMALL_FIT, num_stage=1)
        net, _ = r.setup(data)
        dev = fw.batch_to_device(data)
        b2 = dict(dev, **r._collect_canon(dev))
        proj, mask = r._collect_pool(b2)
        batch = dict(step1=dev, step2=b2,
                     step3=dict(dev, proj_im=proj[:4], proj_mask=mask[:4]))[mode]
        for _ in range(DET_STEPS):
            r.train_step(mode, batch)
        out = {n: p.detach().clone() for n, p in net.named_parameters()}
        ops = _nondeterministic_ops(lambda: r.train_step(mode, batch)) if probe else None
        undo()
        return out, ops

    def lerf_run(probe=False):
        from deep3dmap_tpu_torch.datasets.builder import upload_batch
        from deep3dmap_tpu_torch.datasets.lerf_rays import LERFRayDataset
        from deep3dmap_tpu_torch.models.frameworks.lerf import LERFModel
        from deep3dmap_tpu_torch.runners.iter_based_runner import IterBasedRunner

        fw = LERFModel(LERF_HASH_SMALL)
        ds = LERFRayDataset(rays_per_batch=256, n_batches=1, clip_n_dims=64, dino_n_dims=32,
                            image_encoder=fw.image_encoder)
        batch = upload_batch(next(iter(ds)), "cuda")
        r = IterBasedRunner(fw, runner_cfgs=dict(optimizer=dict(type="Adam", lr=1e-2),
                                                 max_iters=DET_STEPS))
        r.setup(batch, lr_config=dict(policy="cosineannealing", min_lr=1e-5),
                optimizer_config=dict(grad_clip=dict(max_norm=1.0)))
        for _ in range(DET_STEPS):
            r.run_iter(batch)
        out = {n: p.detach().clone() for n, p in r.state.net.named_parameters()}
        return out, (_nondeterministic_ops(lambda: r.run_iter(batch)) if probe else None)

    results, probes = {}, {}
    for name, run in [("neuralrecon", nr_run)] + [
            (f"gan2shape_{m}", lambda probe=False, m=m: g2s_run(m, probe))
            for m in G2S_MODES] + [("lerf_hashgrid", lerf_run)]:
        a, probes[name] = run(probe=True)
        b, _ = run()
        differ = [k for k in a if not torch.equal(a[k], b[k])]
        results[name] = (len(a), differ)
        print(f"determinism {name}: {len(a)} tensors after {DET_STEPS} steps, "
              f"{len(differ)} differ between two runs {differ[:3]}; ops without a "
              f"deterministic implementation (use_deterministic_algorithms probe): "
              f"{probes[name] or 'none'}", flush=True)
    for name, (n, differ) in results.items():
        check(not differ, f"{name}: two identical trainings differ at {differ[:5]}")


# ---------------------------------------------------------------- phase 14 --
CLI_FRAMES = 27            # 3 fragments of 9 keyframes at 480x640
CLI_LOG_INTERVAL = 50      # no logging iteration inside the epoch


def _cli_config(datapath, work_dir, model_cfgs, n_views, img_hw, n_vox, voxel_size,
                epochs, checkpoint_interval, log_interval, lr_config=None,
                custom_hooks=()):
    """A NeuralRecon config file in the shape of configs/neural_recon/ and
    tools/quality_regression.py:40-94, the quality pipeline at ``img_hw``."""
    h, w = img_hw
    return f"""
pipeline = [
    dict(type="SeqResizeImage", size=({w}, {h}), depth_key="depth"),
    dict(type="SeqRandomTransformSpace", voxel_dim=({n_vox}, {n_vox}, {n_vox}),
         voxel_size={voxel_size}, random_rotation=False, random_translation=False,
         n_layers=3),
    dict(type="SeqIntrinsicsPoseToProjection", n_views={n_views}, stride=4),
    dict(type="SeqNormalizeImages", mean=[127.5] * 3, std=[127.5] * 3),
]
work_dir = {work_dir!r}
data = dict(
    samples_per_gpu=1,
    train=dict(type="ScanNetDataset", datapath={datapath!r}, mode="train",
               nviews={n_views}, n_scales=2, img_size=({w}, {h}), n_vox={n_vox},
               voxel_size={voxel_size}, pipeline=pipeline),
    test=dict(type="ScanNetDataset", datapath={datapath!r}, mode="test",
              nviews={n_views}, n_scales=2, img_size=({w}, {h}), n_vox={n_vox},
              voxel_size={voxel_size}, pipeline=pipeline),
)
model = dict(type="NeuralRecon", model_cfgs={dict(model_cfgs, save_scene=True)!r})
checkpoint_config = dict(interval={checkpoint_interval})
log_config = dict(interval={log_interval}, hooks=[dict(type="TextLoggerHook")])
optimizer_config = dict(grad_clip=dict(max_norm=1.0))
lr_config = {lr_config!r}
workflow = [("train", 1)]
runner = dict(type="EpochBasedRunner", runner_cfgs=dict(
    optimizer=dict(type="Adam", lr=1e-3, betas=(0.9, 0.999), weight_decay=0.0),
    max_epochs={epochs}))
custom_hooks = {list(custom_hooks)!r}
"""


def _fixture(write_fixture, data_gen, root, n_views, **kw):
    """The fixture scene in ScanNet's layout (train and test splits) and the
    port's data-gen over it; every frame is a keyframe."""
    t0 = time.perf_counter()
    write_fixture(root, splits=("train", "test"), device="cuda", **kw)
    for mode in ("train", "test"):
        data_gen.main(["--datapath", root, "--mode", mode, "--n-views", str(n_views),
                       "--min-angle", "1", "--min-distance", "0.01", "--n-proc", "1"])
    return time.perf_counter() - t0


def _timed_evaluate(scannet_mod):
    """Wraps ``ScanNetDataset.evaluate`` to record its wall seconds."""
    orig, took = scannet_mod.ScanNetDataset.evaluate, []

    def timed(self, *a, **kw):
        t0 = time.perf_counter()
        out = orig(self, *a, **kw)
        took.append(time.perf_counter() - t0)
        return out
    scannet_mod.ScanNetDataset.evaluate = timed
    return took, lambda: setattr(scannet_mod.ScanNetDataset, "evaluate", orig)


def phase_cli_full_width(train_mod, card, work, bare_step_ms, tools, hooks_mod,
                         scannet_mod, native, write_fixture, checkpoint_mod):
    phase("CLIs at full width: 480x640 fixture, data-gen, train (bench.py config, "
          "ScanNetDataset, 96^3, 1 epoch), test + evaluate")
    set_tf32(cudnn=True, matmul=False)   # PyTorch's defaults
    root, wd = os.path.join(work, "data"), os.path.join(work, "train")
    fix_s = _fixture(write_fixture, tools.data_gen_scannet, root, N_VIEWS,
                     n_frames=CLI_FRAMES, n_vox=N_VOX, voxel_size=0.04, img_size=IMG_HW)
    probe = {}

    @hooks_mod.HOOKS.register_module(force=True)
    class ChipSmokeProbe(hooks_mod.Hook):
        """Per step: synced wall time, fused-loss launches, the host gap
        before it; one step (not a logging one) under sync debug mode."""
        PRIORITY = 1

        def before_run(self, runner):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            probe.update(step_ms=[], launches=[], gap_ms=[], t=time.perf_counter())

        def before_train_iter(self, runner):
            torch.cuda.synchronize()
            now = time.perf_counter()
            probe["gap_ms"].append((now - probe["t"]) * 1e3)
            probe["t"], probe["l0"] = now, loss_launches()
            if runner.inner_iter == 1:
                torch.cuda.set_sync_debug_mode("error")

        def after_train_iter(self, runner):
            torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
            now = time.perf_counter()
            probe["step_ms"].append((now - probe["t"]) * 1e3)
            probe["launches"].append(tuple(a - b for a, b in zip(loss_launches(),
                                                                   probe["l0"])))
            probe["t"] = now

        def after_run(self, runner):
            probe["peak"] = torch.cuda.max_memory_allocated()

    cfg = os.path.join(work, "cfg_full_width.py")
    with open(cfg, "w") as f:
        f.write(_cli_config(root, wd, BENCH_CFGS, N_VIEWS, IMG_HW, N_VOX, 0.04, epochs=1,
                            checkpoint_interval=1, log_interval=CLI_LOG_INTERVAL,
                            custom_hooks=[dict(type="ChipSmokeProbe")]))
    t0 = time.perf_counter()
    reset_counters("fused_loss.")                 # the main path starts here
    runner = tools.train.main([cfg])
    launches = loss_launches()                    # ... and ends here
    train_s = time.perf_counter() - t0
    n_steps = len(probe["step_ms"])
    check(launches == (3 * n_steps, n_steps), f"fused loss launches {launches}")
    check(n_steps == CLI_FRAMES // N_VIEWS, f"{n_steps} train steps, expected "
          f"{CLI_FRAMES // N_VIEWS}")
    check(probe["launches"] == [(3, 1)] * n_steps,
          f"fused loss (forward, backward) launches per step {probe['launches']}")
    ckpt = checkpoint_mod.latest_checkpoint(wd)
    check(ckpt is not None and ckpt.endswith(f"ckpt_{n_steps}")
          and os.path.exists(os.path.join(ckpt, "state.pt")), f"checkpoint {ckpt}")
    check(runner.state.step == n_steps, f"runner at step {runner.state.step}")
    # the bare train_step (phase 10's measure) on this run's own batches and
    # state, to hold the runner's step against the same work
    bare_ms = []
    for batch in runner.prefetch(runner.cur_loader):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        runner.state, _ = train_mod.train_step(runner.framework, runner.state, batch)
        torch.cuda.synchronize()
        bare_ms.append((time.perf_counter() - t1) * 1e3)
    # loader: one sample built from disk (9 PNG frames decoded, GT pyramid
    # fused on the card), synced
    ds = runner.cur_loader.dataset
    load_ms = []
    for i in range(len(ds)):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ds[i]
        torch.cuda.synchronize()
        load_ms.append((time.perf_counter() - t1) * 1e3)

    check(native.available(), "the host C++ op (ops/csrc/native.cpp) did not build")
    took, restore = _timed_evaluate(scannet_mod)
    t1 = time.perf_counter()
    res = tools.test.main([cfg, "--checkpoint", "auto", "--out",
                           os.path.join(work, "meshes"), "--eval", "depth_mesh"])
    test_s = time.perf_counter() - t1
    restore()
    check(isinstance(res, dict) and np.isfinite(res.get("fscore", np.nan)),
          f"evaluate returned {res}")
    print(f"cli_full_width: card={card!r} fixture_and_data_gen_s={fix_s:.3f} "
          f"train_cli_s={train_s:.3f} steps={n_steps} "
          f"runner_step_ms_median={statistics.median(probe['step_ms']):.6f} "
          f"runner_step_ms_max={max(probe['step_ms']):.6f} "
          f"runner_step_ms={[round(v, 3) for v in probe['step_ms']]} "
          f"bare_train_step_ms_median_phase10={bare_step_ms:.6f} "
          f"bare_train_step_ms_same_batches={[round(v, 3) for v in bare_ms]} "
          f"loader_ms_per_sample_median={statistics.median(load_ms):.6f} "
          f"loader_ms_per_sample_max={max(load_ms):.6f} "
          f"host_gap_ms_before_step={[round(v, 3) for v in probe['gap_ms']]} "
          f"fused_loss_launches_per_step={probe['launches'][0]} "
          f"max_memory_allocated_bytes={probe['peak']} checkpoint={os.path.basename(ckpt)} "
          f"test_cli_s={test_s:.3f} evaluate_s_per_scene={took[0]:.3f} "
          f"native_cpp=True", flush=True)
    print(f"cli_full_width evaluate (trained {n_steps} steps): {res}", flush=True)
    print("host syncs: none in the runner's step 2 (set_sync_debug_mode('error'), "
          "not a logging iteration)", flush=True)
    return launches


# ---------------------------------------------------------------- phase 15 --
# the port's quality twin (tools/quality_regression.py's template, fixture
# and pass rule): both arms, FUSION_ON True and False, in this process, at 40
# epochs each (the JAX tool's default is 120: both arms at 120 took 111.1 s,
# at 80 92.5 s; 40 keeps the whole script's slowest run under ~1,050 s)
QUALITY_EPOCHS = 12


def phase_learning(card, work, quality_mod):
    phase(f"learning check: the quality twin (tools/quality_regression.py), both arms, "
          f"{QUALITY_EPOCHS} epochs")
    set_tf32(cudnn=True, matmul=False)
    t0 = time.perf_counter()
    try:
        res = quality_mod.main(["--out", os.path.join(work, "quality.json"),
                                "--epochs", str(QUALITY_EPOCHS),
                                "--workdir", os.path.join(work, "quality")])
    except SystemExit as e:
        fail(f"the quality twin exited with {e.code}: the trained model does not beat "
             f"the untrained one")
    took = time.perf_counter() - t0
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "QUALITY_r05.json")) as f:
        ref = json.load(f)
    keys = ("fscore", "prec", "recal", "AbsRel", "complete")
    arms = ("trained_fusion", "untrained_fusion", "trained_nofusion", "untrained_nofusion")
    print(f"learning: card={card!r} epochs={res['epochs']} arms=2 phase_s={took:.3f} "
          + " ".join(f"{arm}_{k}={res[arm][k]!r}" for arm in arms for k in keys)
          + f" fusion_delta_fscore={res['fusion_delta_fscore']!r} (QUALITY_r05.json: "
          f"{ref['fusion_delta_fscore']!r}, the JAX package on the CPU) "
          f"fscore_gain_vs_untrained={res['fscore_gain_vs_untrained']!r} "
          f"absrel_drop_vs_untrained={res['absrel_drop_vs_untrained']!r} | QUALITY_r05.json: "
          + " ".join(f"{arm}_{k}={ref[arm][k]!r}" for arm in arms for k in keys)
          + f" | learns_reconstruction={res['learns_reconstruction']}", flush=True)
    check(res["learns_reconstruction"], "the trained model does not beat the untrained one")


# ---------------------------------------------------------------- phase 16 --
# configs/gan2shape/celeba.py through the CLIs: the file as published but for
# the data and checkpoint paths, stage_iters, num_stage and the epochs, and
# raster_mode="hard" (the repo's TPU kernel's path; the config's default is
# the soft splat)
G2S_CLI_ITERS = (10, 10, 10)         # celeba: (600, 600, 400) x 4 stages
G2S_CLI_EPOCHS = 2                   # then resumed for a third
G2S_CLI_FACES, G2S_CLI_TEST_FACES = 4, 2
PARSE_WARMUP, PARSE_TIMED = 3, 20
# card vs CPU parse at TF32 off (tests/test_torch_parsing.py's rule): logits
# within 1e-3 abs or 2e-5 of their largest magnitude (PSPNet's GroupNorm
# variance E[x²] - E[x]² cancels on smooth inputs, so two summation orders
# differ by ~3e-4); class maps equal where the CPU's top-2 margin exceeds
# 1e-3 (or twice 2e-5 of the largest logit); other pixels at most 0.1%
TOL_PARSE = dict(atol=1e-3, rel_of_max=2e-5, margin=1e-3, max_tie_share=1e-3)
SCENES = (("car", 21), ("church", 150))      # configs/gan2shape/{car,church}.py


def _seeded_npz(work):
    """Seeded weights in tools/import_weights.py's layouts, in place of the
    published checkpoints: ``stylegan2`` (g and d trees) at celeba's width,
    ``bisenet`` and the two PSPNets (a ``params`` tree each)."""
    from deep3dmap_tpu_torch.models.layers import init_flax_defaults
    from deep3dmap_tpu_torch.models.modulars.stylegan2 import (Generator,
                                                               StyleDiscriminator,
                                                               init_stylegan2)
    from deep3dmap_tpu_torch.models.parsing import BiSeNetFP, PSPNet
    from deep3dmap_tpu_torch.utils.from_flax import to_flax_params

    gen, out = torch.Generator().manual_seed(16), {}
    g = Generator(128, 512, 8, channel_multiplier=1, device="cpu")
    d = StyleDiscriminator(128, channel_multiplier=1, device="cpu")
    init_stylegan2(g, gen)
    init_stylegan2(d, gen)
    out["gan"] = os.path.join(work, "stylegan2_celeba.npz")
    np.savez(out["gan"], g=np.array(to_flax_params(g), dtype=object),
             d=np.array(to_flax_params(d), dtype=object))
    for key, net in (("face", BiSeNetFP()), ("car", PSPNet(21)), ("church", PSPNet(150))):
        init_flax_defaults(net, gen)
        out[key] = os.path.join(work, f"parsing_{key}.npz")
        np.savez(out[key], params=np.array({"params": to_flax_params(net)}, dtype=object))
    return out


def _celeba_fixture(root, dataset_cls, imwrite_png):
    """Synthetic faces at 128² in CelebA's layout: ``images/*.png``,
    ``latents/*.npy``, ``list.txt`` (training) and ``list_val.txt``."""
    for d in ("images", "latents"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    n = G2S_CLI_FACES + G2S_CLI_TEST_FACES
    ds = dataset_cls(n_samples=n, image_size=128, z_dim=512)
    names = []
    for i in range(n):
        item = ds[i]
        rgb = np.rint((item["input_im"] + 1) / 2 * 255).clip(0, 255).astype(np.uint8)
        imwrite_png(os.path.join(root, "images", f"face_{i}.png"), rgb[..., ::-1])
        np.save(os.path.join(root, "latents", f"face_{i}.npy"), item["latent_w"])
        names.append(f"face_{i}.png")
    for name, part in (("list.txt", names[:G2S_CLI_FACES]),
                       ("list_val.txt", names[G2S_CLI_FACES:])):
        with open(os.path.join(root, name), "w") as f:
            f.write("\n".join(part) + "\n")


def _celeba_options(root, npz, category="face"):
    opts = [f"data.{split}.{k}={os.path.join(root, v)}"
            for split, lst in (("train", "list.txt"), ("test", "list_val.txt"))
            for k, v in (("img_list_path", lst), ("img_root", "images"),
                         ("latent_root", "latents"))]
    return opts + [f"model.model_cfgs.gan_ckpt={npz['gan']}",
                   f"model.model_cfgs.parsing_ckpt={npz[category]}",
                   "model.model_cfgs.raster_mode=hard",
                   f"runner.stage_iters={G2S_CLI_ITERS}", "runner.num_stage=1",
                   "custom_hooks=[{'type': 'ChipSmokeG2SProbe'}]"]


def _synced_ms(fn, warmup: int, timed: int) -> list:
    for _ in range(warmup):
        fn()
    out = []
    for _ in range(timed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def _parse_card_vs_cpu(parser, cpu_parser, images, category, resize_bilinear):
    """The card's logits and mask against the CPU's (same weights, TF32
    off) under the near-tie rule; returns the numbers it compared."""
    size = 512 if category in ("face", "synface") else 473
    x = resize_bilinear(images, size)
    if category in ("car", "cat"):
        x = (x / 2 + 0.5 - x.new_tensor((0.485, 0.456, 0.406))) \
            / x.new_tensor((0.229, 0.224, 0.225))
    with torch.no_grad():
        card = parser.net(x).cpu()
        ref = cpu_parser.net(x.cpu())
    scaled = TOL_PARSE["rel_of_max"] * float(ref.abs().max())
    err = float((card - ref).abs().max())
    check(err <= max(TOL_PARSE["atol"], scaled),
          f"parse {category}: card vs CPU logits differ by {err}")
    top2 = torch.topk(ref, 2, dim=-1).values
    sure = top2[..., 0] - top2[..., 1] > max(TOL_PARSE["margin"], 2 * scaled)
    ccls, rcls = card.argmax(-1), ref.argmax(-1)
    check(torch.equal(ccls[sure], rcls[sure]),
          f"parse {category}: the class maps differ beyond the near-tie margin")
    share = float((ccls != rcls).float().mean())
    check(share <= TOL_PARSE["max_tie_share"], f"parse {category}: {share} of the "
          f"pixels change class")
    mask_err = float((parser.parse_mask(images, category, 128).cpu()
                      - cpu_parser.parse_mask(images.cpu(), category, 128)).abs().max())
    if share == 0:
        check(mask_err <= 1e-6, f"parse {category}: masks differ by {mask_err}")
    return dict(logit_max_abs_err=err, logit_scale=float(ref.abs().max()),
                near_tie_share=share, mask_max_abs_err=mask_err,
                classes=int(rcls.unique().numel()))


def phase_g2s_cli(card, work, tools, hooks_mod, dataset_cls, g2s_bare_ms):
    phase("Gan2Shape through the CLIs at full width: configs/gan2shape/celeba.py "
          "(use_mask, BiSeNet at 512², hard raster), train 2 epochs, resume a third, "
          "test; car.py and church.py parse_mask (PSPNet at 473²)")
    set_tf32(cudnn=True, matmul=False)   # PyTorch's defaults
    from deep3dmap_tpu_torch.models.builder import build_reconstruction
    from deep3dmap_tpu_torch.models.frameworks import gan2shape as g2s_module
    from deep3dmap_tpu_torch.models.parsing import FaceParser, SceneParser
    from deep3dmap_tpu_torch.ops.resize import resize_bilinear
    from deep3dmap_tpu_torch.utils.config import Config
    from deep3dmap_tpu_torch.utils.image_io import imwrite_png

    print(f"cut: stage_iters (600, 600, 400) x 4 stages -> {G2S_CLI_ITERS} x 1, "
          f"{G2S_CLI_EPOCHS} epochs + 1 resumed; seeded stylegan2/bisenet/pspnet .npz in "
          f"place of the published checkpoints; {G2S_CLI_FACES} synthetic 128² faces "
          f"in place of CelebA; raster_mode=hard", flush=True)
    t0 = time.perf_counter()
    npz = _seeded_npz(work)
    root, wd = os.path.join(work, "celeba"), os.path.join(work, "g2s_train")
    _celeba_fixture(root, dataset_cls, imwrite_png)
    setup_s = time.perf_counter() - t0
    cfg = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "configs", "gan2shape", "celeba.py")
    probe = {}

    @hooks_mod.HOOKS.register_module(force=True)
    class ChipSmokeG2SProbe(hooks_mod.Hook):
        """Times each step of a run's first epoch (synced), the instance
        wall of the others; raster launches per step and per instance; the
        instance's mask; the peak memory."""
        PRIORITY = 1

        def before_run(self, runner):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            probe.update(step_ms={m: [] for m in G2S_MODES}, step_launches={m: [] for m in G2S_MODES},
                         fit_s=[], fit_launches=[], masks=[], first=runner.epoch)
            fit, step = runner.fit_instance, runner.train_step

            def timed_step(mode, batch):
                if runner.epoch != probe["first"]:
                    return step(mode, batch)
                torch.cuda.synchronize()
                t1, l0 = time.perf_counter(), counter("raster.launches")
                out = step(mode, batch)
                torch.cuda.synchronize()
                probe["step_ms"][mode].append((time.perf_counter() - t1) * 1e3)
                probe["step_launches"][mode].append(counter("raster.launches") - l0)
                return out

            def timed_fit(batch):
                m = batch["input_mask"]
                probe["masks"].append((tuple(m.shape), m.device.type, float(m.min()),
                                       float(m.max())))
                torch.cuda.synchronize()
                t1, l0 = time.perf_counter(), counter("raster.launches")
                out = fit(batch)
                torch.cuda.synchronize()
                probe["fit_s"].append(time.perf_counter() - t1)
                probe["fit_launches"].append(counter("raster.launches") - l0)
                return out
            runner.train_step, runner.fit_instance = timed_step, timed_fit

        def after_run(self, runner):
            probe["peak"] = torch.cuda.max_memory_allocated()

    opts = _celeba_options(root, npz)
    reset_counters("raster.")                     # the main path starts here
    t1 = time.perf_counter()
    runner = tools.train.main([cfg, "--work-dir", wd, "--max-epochs", str(G2S_CLI_EPOCHS),
                               "--cfg-options", *opts])
    train_s = time.perf_counter() - t1
    first = dict(probe)
    fw = runner.framework
    trained = (type(runner).__name__, fw.use_mask, fw.renderer.raster_mode, runner.epoch,
               runner.step)
    del runner, fw          # the resumed run's peak memory is its own (the
    gc.collect()            # probe's wrappers and the runner form a cycle)
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    resumed = tools.train.main([cfg, "--work-dir", wd, "--resume-from", "auto",
                                "--max-epochs", str(G2S_CLI_EPOCHS + 1), "--cfg-options", *opts])
    resume_s = time.perf_counter() - t1
    seen, orig = [], g2s_module.Gan2Shape.forward_test

    def spy(self, net, state, batch):
        seen.append(torch.equal(net.depth_head.Conv_0.weight,
                                resumed.net.depth_head.Conv_0.weight))
        return orig(self, net, state, batch)
    g2s_module.Gan2Shape.forward_test = spy
    try:
        t1 = time.perf_counter()
        res = tools.test.main([cfg, "--work-dir", wd, "--checkpoint", "auto",
                               "--cfg-options", *opts[:-1]])
        test_s = time.perf_counter() - t1
    finally:
        g2s_module.Gan2Shape.forward_test = orig
    launches = counter("raster.launches")         # ... and ends here

    s1, s2, s3 = G2S_CLI_ITERS
    per_instance = 1 + s1 + s2 + max(s2 // 4, 1) + 2 * s3   # + the canon snapshot, the pool
    check(trained == ("Gan2ShapeRunner", True, "hard", G2S_CLI_EPOCHS,
                      G2S_CLI_EPOCHS * (s1 + s2 + s3)), f"the train CLI's run: {trained}")
    check((resumed.epoch, resumed.step) == (G2S_CLI_EPOCHS + 1,
                                            (G2S_CLI_EPOCHS + 1) * (s1 + s2 + s3)),
          f"resumed to epoch {resumed.epoch}, step {resumed.step}")
    for name, pr in (("train", first), ("resume", probe)):
        for mode, n in RASTER_PER_STEP.items():
            check(pr["step_launches"][mode] == [n] * len(pr["step_launches"][mode])
                  and len(pr["step_launches"][mode]) == G2S_CLI_ITERS[G2S_MODES.index(mode)],
                  f"{name} {mode}: raster launches per step {pr['step_launches'][mode]}")
        check(pr["fit_launches"] == [per_instance] * len(pr["fit_launches"]),
              f"{name}: raster launches per instance {pr['fit_launches']}")
        # in [0, 1] up to the resize's rounding (its weights sum to 1 +- an ulp)
        check(all(m[:2] == ((1, 128, 128, 1), "cuda") and -1e-6 <= m[2] <= m[3] <= 1 + 1e-6
                  for m in pr["masks"]), f"{name}: instance masks {pr['masks']}")
    check(res is None and seen == [True] * G2S_CLI_TEST_FACES,
          f"test CLI: {len(seen)} forward_test calls, checkpoint heads {seen}")
    want = (G2S_CLI_EPOCHS + 1) * per_instance + G2S_CLI_TEST_FACES
    check(launches == want, f"raster launches {launches} on the path, expected {want}")
    # each run's first step of a mode holds the first-use costs (the raster's
    # build, cuDNN's algorithm choice): reported apart
    steps = {m: first["step_ms"][m][1:] + probe["step_ms"][m][1:] for m in G2S_MODES}
    first_steps = {m: (first["step_ms"][m][0], probe["step_ms"][m][0]) for m in G2S_MODES}
    fw = resumed.framework

    # parse_mask per parser on the card (synced), then against the CPU
    from deep3dmap_tpu_torch.datasets.real_files import CelebaDataset
    face = CelebaDataset(os.path.join(root, "list.txt"), os.path.join(root, "images"),
                         os.path.join(root, "latents")).setup_input(0)["input_im"]
    images = torch.from_numpy(face).cuda()
    frameworks, cpu_parsers = {"face": fw}, {"face": FaceParser(npz["face"], device="cpu")}
    for category, n_classes in SCENES:
        scfg = Config.fromfile(os.path.join(os.path.dirname(cfg), f"{category}.py")).model
        model = dict(scfg, model_cfgs=dict(scfg["model_cfgs"], parsing_ckpt=npz[category]))
        frameworks[category] = build_reconstruction(model)
        cpu_parsers[category] = SceneParser(npz[category], n_classes=n_classes, device="cpu")
    parse_ms = {}
    for category, f in frameworks.items():
        parse_ms[category] = _synced_ms(lambda: f.parse_mask(images), PARSE_WARMUP, PARSE_TIMED)
        mask = f.parse_mask(images)
        check(tuple(mask.shape) == (1, 128, 128, 1) and mask.is_cuda,
              f"parse_mask {category}: {tuple(mask.shape)} on {mask.device}")
    for category, n_classes in SCENES:
        got = frameworks[category]._parser.net.Conv_6.weight.shape[0]
        check(got == n_classes, f"{category}: PSPNet with {got} classes")
    set_tf32(cudnn=False, matmul=False)
    compare = {c: _parse_card_vs_cpu(frameworks[c]._parser, cpu_parsers[c], images, c,
                                     resize_bilinear) for c in frameworks}
    set_tf32(cudnn=True, matmul=False)

    fit_ms = statistics.median(first["fit_s"][1:]) * 1e3
    print(f"g2s_cli: card={card!r} setup_s={setup_s:.3f} train_cli_s={train_s:.3f} "
          f"resume_cli_s={resume_s:.3f} test_cli_s={test_s:.3f} "
          + " ".join(f"runner_{m}_ms_median={statistics.median(steps[m]):.6f} "
                     f"runner_{m}_ms_max={max(steps[m]):.6f} "
                     f"bare_{m}_ms_median_phase12={g2s_bare_ms[m]:.6f}" for m in G2S_MODES)
          + f" synced_steps_per_mode={len(steps['step1'])} "
          f"first_step_ms_per_run={first_steps} "
          f"fit_instance_s={[round(v, 6) for v in first['fit_s'] + probe['fit_s']]} "
          f"fit_instance_ms_unsynced_median={fit_ms:.6f} "
          + " ".join(f"parse_mask_{c}_ms_median={statistics.median(v):.6f} "
                     f"parse_mask_{c}_ms_max={max(v):.6f}" for c, v in parse_ms.items())
          + f" parse_share_of_instance={statistics.median(parse_ms['face']) / fit_ms:.6f} "
          f"max_memory_allocated_bytes_train={first['peak']} "
          f"max_memory_allocated_bytes_resume={probe['peak']} "
          + " ".join(f"raster_launches_per_{m}={n}" for m, n in RASTER_PER_STEP.items())
          + f" raster_launches_per_instance={per_instance} raster_launches={launches} "
          f"stage_iters={G2S_CLI_ITERS} num_stage=1 epochs={resumed.epoch} "
          f"instance_mask={first['masks'][0]}", flush=True)
    print("g2s_cli parse card vs CPU (TF32 off): " + " ".join(
        f"{c}.{k}={v!r}" for c, d in compare.items() for k, v in d.items()), flush=True)
    return dict(launches=launches)


# ---------------------------------------------------------------- phase 17 --
# the face workloads run none of the repo's kernels: PRNet is convs,
# GroupNorm and L1 losses, imgs2mesh's UV sampler gathers from tables made
# once on the host.  Their CPU-vs-card checks run at TF32 off; ResFCN256's
# ~40 GroupNorms each add ~1e-6 relative in float32 (tests/test_torch_prnet.py:
# port vs JAX 7e-5 on maps in [0, 1] at R 64), so maps within 1e-3 abs and
# the losses (means over the maps) within 1e-4 relative
PRNET_CFG = os.path.join("configs", "prnet", "prnet_300wlp.py")
PRNET_TRAIN, PRNET_VAL = 32, 16      # fixture crops: 2 steps an epoch at B 16
FACE_CLI_EPOCHS = 2
FACE_WARMUP, FACE_TIMED, FACE_PROFILED = 2, 3, 2
FWD_WARMUP, FWD_TIMED = 2, 5
TOL_FACE_MAP = 1e-3
TOL_FACE_LOSS_RTOL = 1e-4


def _launch_stats(call, n) -> dict:
    """torch.profiler over ``n`` calls: device ops launched per call, their
    device time per call, the host wall per call with the profiler on, and
    the device's busy share of that wall."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            call()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms = kernel_us(prof) / 1e3
    return dict(launches=sum(e.count for e in device_kernels(prof)) / n,
                device_ms=busy_ms / n, busy=busy_ms / wall_ms, wall_ms=wall_ms / n)


def _smooth_image(rs, S) -> np.ndarray:
    """A smooth face-like uint8 BGR image: a shaded disc with noise."""
    yy, xx = np.meshgrid(np.linspace(-1, 1, S), np.linspace(-1, 1, S), indexing="ij")
    cx, cy = rs.uniform(-0.2, 0.2, 2)
    shade = np.clip(1.1 - (xx - cx) ** 2 - (yy - cy) ** 2, 0, 1)[..., None]
    img = shade * rs.uniform(0.4, 1.0, 3) + rs.uniform(0, 0.1, (S, S, 3))
    return np.rint(np.clip(img, 0, 1) * 255).astype(np.uint8)


def _prnet_fixture(root, S, n_train, n_val, imwrite_png, kpt_ind):
    """300W-LP's layout: ``f<i>_inp.jpg`` crops (lossless PNG bytes: the
    card's machine has no JPEG decoder, and the reader picks the format from
    the bytes), smooth ``.npy`` UV position maps in pixels, ``list.txt``,
    ``list_val.txt`` and ``uv_kpt_ind.txt``."""
    os.makedirs(root, exist_ok=True)
    rs = np.random.RandomState(17)
    yy, xx = np.meshgrid(np.arange(float(S)), np.arange(float(S)), indexing="ij")
    names = []
    for i in range(n_train + n_val):
        imwrite_png(os.path.join(root, f"f{i}_inp.jpg"), _smooth_image(rs, S))
        z = S / 8 * (1 + np.cos((xx - S / 2) / S * np.pi) * np.cos((yy - S / 2) / S * np.pi))
        uv = np.stack([xx, yy, z + rs.uniform(0, 2)], -1)
        np.save(os.path.join(root, f"f{i}.npy"), uv.astype(np.float32))
        names.append(f"f{i}.jpg")
    for name, part in (("list.txt", names[:n_train]), ("list_val.txt", names[n_train:])):
        with open(os.path.join(root, name), "w") as f:
            f.write("\n".join(part) + "\n")
    np.savetxt(os.path.join(root, "uv_kpt_ind.txt"), kpt_ind)


def phase_prnet(card, work, tools):
    phase("face: PRNet, configs/prnet/prnet_300wlp.py's model (R 256, base 16, B 16), "
          "CPU vs card, bare steps, the CLIs")
    from deep3dmap_tpu_torch.datasets.builder import (NumpyLoader, build_dataset,
                                                      upload_batch)
    from deep3dmap_tpu_torch.models.frameworks.prnet import FaceImg2UV, uv_kpt_ind_from_bfm
    from deep3dmap_tpu_torch.runners.train_state import init_train_state, train_step
    from deep3dmap_tpu_torch.utils.config import Config
    from deep3dmap_tpu_torch.utils.image_io import imwrite_png

    t0 = time.perf_counter()
    cfg_path, S, n_train = PRNET_CFG, 256, PRNET_TRAIN
    cfg = Config.fromfile(cfg_path)
    root = os.path.join(work, "300wlp")
    _prnet_fixture(root, S, n_train, PRNET_VAL, imwrite_png, uv_kpt_ind_from_bfm(None, S))
    kpt = os.path.join(root, "uv_kpt_ind.txt")
    paths = dict(train=("list.txt", "train"), test=("list_val.txt", "test"))
    data_opts = [f"data.{split}.{k}={v}" for split, (lst, _) in paths.items()
                 for k, v in (("datapath", os.path.join(root, lst)), ("img_prefix", root),
                              ("uv_kpt_ind_file", kpt))]
    data_opts.append(f"model.model_cfgs.uv_kpt_ind_file={kpt}")
    cfg.merge_from_dict(tools.train.parse_args([cfg_path, "--cfg-options", *data_opts])
                        .cfg_options)
    model_cfgs = cfg.model["model_cfgs"]
    B = cfg.data["samples_per_gpu"]
    batch = next(iter(NumpyLoader(build_dataset(cfg.data["train"]), batch_size=B)))
    _ARM_BATCHES["prnet"] = dict(batch=batch, model_cfgs=dict(
        cfg.model["model_cfgs"], uv_kpt_ind=np.loadtxt(kpt).astype(np.int32),
        uv_kpt_ind_file=None))
    print(f"set-up (fixture of {n_train + PRNET_VAL} crops at {S}², config) "
          f"{time.perf_counter() - t0:.3f} s card={card!r}", flush=True)

    # 1. CPU vs card on the same seeded weights, TF32 off
    set_tf32(cudnn=False, matmul=False)
    cpu_fw, fw = FaceImg2UV(model_cfgs, device="cpu"), FaceImg2UV(model_cfgs)
    cpu_net, _ = cpu_fw.init(0, batch)
    net, _ = fw.init(0, batch)
    with torch.no_grad():
        outs = [f.forward_test(n, {}, batch)[0] for f, n in ((cpu_fw, cpu_net), (fw, net))]
        losses = [f.loss_fn(n, {}, batch)[1]["log_vars"] for f, n in ((cpu_fw, cpu_net),
                                                                       (fw, net))]
    err = {k: float((outs[0][k] - outs[1][k].cpu()).abs().max()) for k in ("uvpos", "kpt")}
    rel = {k: abs(float(losses[0][k]) - float(losses[1][k])) / abs(float(losses[0][k]))
           for k in losses[0]}
    print(f"prnet card vs CPU (TF32 off, B {B}): card={card!r} " + " ".join(
        f"{k}_max_abs_err={v:.3e}" for k, v in err.items()) + " " + " ".join(
        f"{k}_rel_err={v:.3e} ({float(losses[0][k])!r})" for k, v in rel.items()), flush=True)
    check(all(v <= TOL_FACE_MAP for v in err.values()), f"prnet card vs CPU maps: {err}")
    check(all(v <= TOL_FACE_LOSS_RTOL for v in rel.values()), f"prnet card vs CPU losses: {rel}")
    set_tf32(cudnn=True, matmul=False)     # PyTorch's defaults, as the CLIs run
    del cpu_fw, cpu_net, outs

    # 2. bare train_step calls and forward_test at full width
    optimizer = cfg.runner["runner_cfgs"]["optimizer"]
    state = init_train_state(fw, 0, batch, optimizer)
    dbatch = upload_batch(batch, "cuda")
    box = [state]

    def step():
        box[0], log = train_step(fw, box[0], dbatch)
        return log
    torch.cuda.reset_peak_memory_stats()
    before = {k: v.clone() for k, v in net.state_dict().items()}
    step_ms = _synced_ms(step, FACE_WARMUP, FACE_TIMED)
    logs = {k: float(v) for k, v in step().items()}
    check(all(np.isfinite(v) for v in logs.values()), f"prnet step log {logs}")
    check(all(not torch.equal(v, before[k]) for k, v in net.state_dict().items()),
          "prnet: a parameter did not move")
    stats = _launch_stats(step, FACE_PROFILED)
    peak = torch.cuda.max_memory_allocated()
    fwd_ms = _synced_ms(lambda: fw.forward_test(net, {}, dbatch), FWD_WARMUP, FWD_TIMED)
    fwd_stats = _launch_stats(lambda: fw.forward_test(net, {}, dbatch), FACE_PROFILED)

    # 3. the CLIs: 2 epochs of the config on the fixture, then --eval nme
    wd = os.path.join(work, "prnet_wd")
    t1 = time.perf_counter()
    runner = tools.train.main([cfg_path, "--work-dir", wd, "--max-epochs", str(FACE_CLI_EPOCHS),
                               "--cfg-options", *data_opts])
    train_s = time.perf_counter() - t1
    per_epoch = n_train // B
    check((type(runner).__name__, runner.epoch, runner.state.step)
          == ("EpochBasedRunner", FACE_CLI_EPOCHS, FACE_CLI_EPOCHS * per_epoch),
          f"prnet train CLI: {type(runner).__name__} epoch {runner.epoch} step "
          f"{runner.state.step}")
    t1 = time.perf_counter()
    res = tools.test.main([cfg_path, "--work-dir", wd, "--checkpoint", "auto", "--eval", "nme",
                           "--cfg-options", *data_opts])
    test_s = time.perf_counter() - t1
    check(res is not None and np.isfinite(res["nme"]), f"prnet test CLI: {res}")
    print(f"prnet: card={card!r} R={S} base={fw.base_channels} B={B} "
          f"train_step_ms_median={statistics.median(step_ms):.6f} "
          f"train_step_ms_max={max(step_ms):.6f} synced_steps={FACE_TIMED} "
          f"train_launches_per_step={stats['launches']:.1f} "
          f"train_device_ms_per_step={stats['device_ms']:.6f} "
          f"train_busy_share={stats['busy']:.6f} "
          f"train_profiled_wall_ms_per_step={stats['wall_ms']:.6f} "
          f"forward_test_ms_median={statistics.median(fwd_ms):.6f} "
          f"forward_test_ms_max={max(fwd_ms):.6f} "
          f"forward_test_launches={fwd_stats['launches']:.1f} "
          f"forward_test_busy_share={fwd_stats['busy']:.6f} "
          f"max_memory_allocated_bytes={peak} train_cli_s={train_s:.3f} "
          f"test_cli_s={test_s:.3f} cli_epochs={runner.epoch} cli_steps={runner.state.step} "
          f"nme={res['nme']!r}", flush=True)
    print(f"prnet step log: card={card!r} " + " ".join(f"{k}={v!r}" for k, v in logs.items()),
          flush=True)
    return dict(step_ms=statistics.median(step_ms))


# ---------------------------------------------------------------- phase 18 --
I2F_CFG = os.path.join("configs", "pt3d_demos", "imgs2face_multipie.py")
MPIE_IDS, MPIE_VIEWS = 4, 4          # 2 batches an epoch at B 2
I2F_STATES = ("sup", "sup_unsup")


def _multipie_fixture(root, S, n_verts, imwrite_png, euler):
    """MultiPIE's layout as ``tools/data_gen/multipie.py organize`` writes
    it: ``images/*.png`` at S², the two pickled indexes and registered
    ``objs/<id>_<sess>_<rec>.obj`` scans of ``n_verts`` vertices."""
    import pickle
    for d in ("images", "objs"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    rs = np.random.RandomState(18)
    poses = ["05_1", "14_0", "13_0", "04_1"]
    uvtex2poseimgs, aux = {}, {}
    for i in range(MPIE_IDS):
        key = f"{i + 1:03d}_01_01"
        pose2imgs = {}
        for v in range(MPIE_VIEWS):
            name = f"{key}_{poses[v]}_10.png"
            imwrite_png(os.path.join(root, "images", name), _smooth_image(rs, S))
            pose2imgs.setdefault(poses[v], []).append(name)
            ang = rs.uniform(-0.3, 0.3, 3).astype(np.float32)
            aux[name] = dict(lm68=(rs.rand(68, 2) * S).astype(np.float32),
                             s=float(1e-3 + rs.rand() * 1e-3),
                             R=euler(torch.from_numpy(ang)).numpy().astype(np.float64),
                             t=rs.uniform(0.2 * S, 0.8 * S, 3))
        uvtex2poseimgs[f"{key}.npy"] = pose2imgs
        with open(os.path.join(root, "objs", f"{key}.obj"), "w") as f:
            for v3 in rs.randn(n_verts, 3) * 0.1:
                f.write(f"v {v3[0]:.5f} {v3[1]:.5f} {v3[2]:.5f}\n")
    for name, obj in (("multipie_uvtex2poseimgs.pkl", uvtex2poseimgs),
                      ("multipie_imgpath2auxinfo.pkl", aux)):
        with open(os.path.join(root, name), "wb") as f:
            pickle.dump(obj, f)


def phase_imgs2mesh(card, work, tools):
    phase("face: imgs2mesh, configs/pt3d_demos/imgs2face_multipie.py's model (256², V 3, "
          "B 2, sampling on), CPU vs card, bare steps per state, the CLIs")
    import logging
    from deep3dmap_tpu_torch.core.all3dtrans.rotations import euler_angles_to_matrix
    from deep3dmap_tpu_torch.datasets.builder import NumpyLoader, build_dataset, upload_batch
    from deep3dmap_tpu_torch.models.frameworks.imgs2mesh import Imgs2Mesh
    from deep3dmap_tpu_torch.runners.builder import build_runner
    from deep3dmap_tpu_torch.utils.config import Config
    from deep3dmap_tpu_torch.utils.image_io import imwrite_png

    t0 = time.perf_counter()
    cfg_path = I2F_CFG
    cfg = Config.fromfile(cfg_path)
    model_cfgs = cfg.model["model_cfgs"]
    S, V, NV = model_cfgs["image_size"], model_cfgs["tuplesize"], model_cfgs["n_verts"]
    root = os.path.join(work, "multipie")
    _multipie_fixture(root, S, NV, imwrite_png, euler_angles_to_matrix)
    data_opts = [f"data.{split}.{k}={os.path.join(root, v)}" for split in ("train", "test")
                 for k, v in (("datadir", ""), ("imgdir", "images"), ("objroot", "objs"))]
    cfg.merge_from_dict(tools.train.parse_args([cfg_path, "--cfg-options", *data_opts])
                        .cfg_options)
    B = cfg.data["samples_per_gpu"]
    batch = next(iter(NumpyLoader(build_dataset(cfg.data["train"]), batch_size=B)))
    tex = model_cfgs.get("texture_size", 64)
    batch["uvtex"] = np.random.RandomState(5).rand(B, tex, tex, 3).astype(np.float32)
    _ARM_BATCHES["imgs2mesh"] = dict(batch=batch, model_cfgs=dict(model_cfgs,
                                                                 use_sampling=False))
    print(f"set-up (fixture of {MPIE_IDS} identities x {MPIE_VIEWS} views at {S}², "
          f"config) {time.perf_counter() - t0:.3f} s card={card!r}", flush=True)

    # 1. CPU vs card, TF32 off, the same seeded weights: each state's log vars
    set_tf32(cudnn=False, matmul=False)
    cpu_fw, fw = Imgs2Mesh(model_cfgs, device="cpu"), Imgs2Mesh(model_cfgs)
    cpu_net, _ = cpu_fw.init(0, batch)
    net, _ = fw.init(0, batch)
    errs, pairs = {}, []
    for state in I2F_STATES:
        with torch.no_grad():
            (cl, ca), (_, ga) = (f.loss_fn(n, {}, batch, state=state)
                                  for f, n in ((cpu_fw, cpu_net), (fw, net)))
        check(set(ca["log_vars"]) == set(ga["log_vars"]), f"{state}: log vars differ")
        for k, v in ca["log_vars"].items():
            want, got = float(v), float(ga["log_vars"][k])
            # of the value plus the state's loss: the scale consistency is
            # 2000 x |s_0 - s_1| of two near-equal scales, whose rounding
            # shows in it (tests/test_torch_state_machine_runner.py)
            errs[f"{state}.{k}"] = abs(got - want) / (abs(want) + abs(float(cl)))
            pairs.append(f"{state}.{k}: cpu={want!r} card={got!r}")
    print(f"imgs2mesh card vs CPU (TF32 off, B {B}): card={card!r} " + " ".join(pairs)
          + " " + " ".join(f"{k}_err={v:.3e}" for k, v in errs.items()), flush=True)
    check(all(v <= TOL_FACE_LOSS_RTOL for v in errs.values()),
          f"imgs2mesh card vs CPU log vars: {errs}")
    check({"texloss", "tex_consistent_loss"} <= {k.split(".")[1] for k in errs},
          "imgs2mesh: the sampling losses are missing")
    set_tf32(cudnn=True, matmul=False)
    del cpu_fw, cpu_net

    # 2. bare steps per state through the runner's step (the sampling path)
    runner_cfg = dict(cfg.runner)
    r = build_runner(dict(type="StateMachineRunner", state_seq=runner_cfg["state_seq"],
                          state_steps=[0, 1]),
                     default_args=dict(framework=fw, runner_cfgs=runner_cfg["runner_cfgs"]))
    r.setup(batch)
    dbatch = upload_batch(batch, "cuda")
    per_state = {}
    for epoch, state in enumerate(I2F_STATES):
        r.epoch = epoch
        r.state_switch()
        check(r.cur_state == fw.state == state, f"runner in {r.cur_state}, want {state}")
        torch.cuda.reset_peak_memory_stats()
        ms = _synced_ms(lambda: r.run_iter(dbatch), FACE_WARMUP, FACE_TIMED)
        logs = {k: float(v) for k, v in r.run_iter(dbatch).items()}
        check(all(np.isfinite(v) for v in logs.values()), f"imgs2mesh {state} log {logs}")
        stats = _launch_stats(lambda: r.run_iter(dbatch), FACE_PROFILED)
        per_state[state] = dict(ms=ms, logs=logs, stats=stats,
                                peak=torch.cuda.max_memory_allocated())

    # 3. the CLIs: use_sampling off (the published config's sup state reads
    # a uvtex that MultiPIE's reader does not give, in JAX as here), the
    # switch after the first epoch
    wd = os.path.join(work, "imgs2mesh_wd")
    cli_opts = [*data_opts, "model.model_cfgs.use_sampling=False", "runner.state_steps=[0,1]"]
    seen = []
    handler = logging.Handler()
    handler.emit = lambda rec: seen.append(rec.getMessage())
    logging.getLogger("deep3dmap_tpu_torch").addHandler(handler)
    try:
        t1 = time.perf_counter()
        runner = tools.train.main([cfg_path, "--work-dir", wd, "--max-epochs",
                                   str(FACE_CLI_EPOCHS), "--cfg-options", *cli_opts])
        train_s = time.perf_counter() - t1
    finally:
        logging.getLogger("deep3dmap_tpu_torch").removeHandler(handler)
    per_epoch = MPIE_IDS // B
    check((type(runner).__name__, runner.epoch, runner.state.step, runner.cur_state)
          == ("StateMachineRunner", FACE_CLI_EPOCHS, FACE_CLI_EPOCHS * per_epoch, "sup_unsup"),
          f"imgs2mesh train CLI: {type(runner).__name__} epoch {runner.epoch} step "
          f"{runner.state.step} state {runner.cur_state}")
    check("state switch: sup -> sup_unsup" in seen, "imgs2mesh: no state switch in the log")
    t1 = time.perf_counter()
    res = tools.test.main([cfg_path, "--work-dir", wd, "--cfg-options", *cli_opts])
    test_s = time.perf_counter() - t1
    check(res is None, f"imgs2mesh test CLI: {res}")
    print(f"imgs2mesh: card={card!r} S={S} V={V} B={B} n_verts={NV} texture={tex} "
          f"use_sampling={fw.use_sampling} " + " ".join(
              f"{st}_step_ms_median={statistics.median(d['ms']):.6f} "
              f"{st}_step_ms_max={max(d['ms']):.6f} "
              f"{st}_launches_per_step={d['stats']['launches']:.1f} "
              f"{st}_device_ms_per_step={d['stats']['device_ms']:.6f} "
              f"{st}_busy_share={d['stats']['busy']:.6f} "
              f"{st}_profiled_wall_ms_per_step={d['stats']['wall_ms']:.6f} "
              f"{st}_max_memory_allocated_bytes={d['peak']}" for st, d in per_state.items())
          + f" synced_steps_per_state={FACE_TIMED} train_cli_s={train_s:.3f} "
          f"test_cli_s={test_s:.3f} cli_epochs={runner.epoch} cli_steps={runner.state.step} "
          f"cli_state={runner.cur_state} state_switch_logged=True", flush=True)
    print(f"imgs2mesh step logs: card={card!r} " + " ".join(
        f"{st}.{k}={v!r}" for st, d in per_state.items() for k, v in d["logs"].items()),
        flush=True)
    return dict(step_ms={st: statistics.median(d["ms"]) for st, d in per_state.items()})



# ------------------------------------------------------------ phases 19-21 --
GNERF_SYN_CFG = os.path.join("configs", "gnerf", "gnerf_synthetic.py")
GNERF_BLENDER_CFG = os.path.join("configs", "gnerf", "blender.py")
GNERF_DTU_CFG = os.path.join("configs", "gnerf", "dtu.py")
GNERF_WARMUP, GNERF_TIMED, GNERF_PROFILED = 2, 3, 2
GNERF_VIEW_WARMUP, GNERF_VIEW_TIMED = 1, 1
BLENDER_FIXTURE = (("train", 4), ("test", 2))   # 2 steps an epoch at B 2
BLENDER_SRC_WH = (800, 800)            # NeRF-synthetic's size: the reader resizes
DTU_VIEWS, DTU_WH = 16, (400, 300)     # 2 views in the val (and test) split
# CPU vs card (phase 19): the face phases' limits; the sampled depths that
# a summation order can move (sample_pdf's jumps) are shared, so the rest
# of the step is held (the near-tie rule of tests/test_torch_gnerf.py).
# Gradients: at 32² with a random D the generator step sums cancelling
# terms; its worst leaf on an H100 (700 W) sat 3.0e-2 from the CPU's
# float64 evaluation where the CPU's float32 sat 2.9e-3 (both printed
# beside).  The same step in float64 on the card sits 5.1e-14 from the
# CPU's float64, so no rule differs: the float32 gap is rounding of the
# cancelling sums in cuBLAS's order.  TOL_GNERF_GRAD is 3.3x that measured
# card gap; TOL_GNERF_GRAD64 holds the float64 pair to where a differing
# rule would show.
TOL_GNERF_LOSS_RTOL = 1e-4
TOL_GNERF_MAP = 1e-3
TOL_GNERF_GRAD = 1e-1
TOL_GNERF_GRAD64 = 1e-6      # the generator step in float64, card vs CPU


class _Samples:
    """Records ``sample_pdf``'s importance samples as ``modulars/gnerf.py``
    calls them, or replays recorded ones in call order (on ``device``)."""

    def __init__(self, module):
        self.module, self.orig, self.z = module, module.sample_pdf, []

    def record(self):
        def rec(*a, **kw):
            z = self.orig(*a, **kw)
            self.z.append(z.detach().cpu())
            return z
        self.module.sample_pdf = rec
        return self

    def replay(self, device):
        queue = list(self.z)
        self.module.sample_pdf = lambda *a, **kw: queue.pop(0).to(device)
        return self

    def restore(self):
        self.module.sample_pdf = self.orig


def _grad_rel(a: torch.nn.Module, b: torch.nn.Module) -> dict:
    """Per-parameter ||g_b - g_a|| / ||g_a|| (a zero gradient read against
    1e-2 of the module's largest)."""
    ga = {n: (p.grad if p.grad is not None else torch.zeros_like(p)).double().cpu()
          for n, p in a.named_parameters()}
    gb = {n: (p.grad if p.grad is not None else torch.zeros_like(p)).double().cpu()
          for n, p in b.named_parameters()}
    floor = 1e-2 * max(float(g.norm()) for g in ga.values())
    return {n: float((gb[n] - g).norm()) / max(float(g.norm()), floor, 1e-30)
            for n, g in ga.items()}


def _to_double(tree):
    if isinstance(tree, dict):
        return {k: _to_double(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_double(v) for v in tree]
    return tree.double() if tree.is_floating_point() else tree


def phase_gnerf_cpu_vs_card(card):
    phase("CPU vs card: GNeRF, configs/gnerf/gnerf_synthetic.py's model (32², 4x64 MLP, "
          "16 + 16 samples, ndf 32), float32, TF32 off: each ABAB sequence, forward_test")
    import copy
    import deep3dmap_tpu_torch.models.modulars.gnerf as render_mod
    from deep3dmap_tpu_torch.datasets.builder import NumpyLoader, build_dataset
    from deep3dmap_tpu_torch.models.frameworks.gnerf import GanNerf
    from deep3dmap_tpu_torch.models.modulars.embeddings import pose_to_d9
    from deep3dmap_tpu_torch.utils.config import Config

    set_tf32(cudnn=False, matmul=False)
    cfg = Config.fromfile(GNERF_SYN_CFG)
    mc = cfg.model["model_cfgs"]
    B = cfg.data["samples_per_gpu"]
    ds = build_dataset(cfg.data["train"], default_args=dict(device="cpu"))
    val = build_dataset(cfg.data["val"], default_args=dict(device="cpu"))
    batch = next(iter(NumpyLoader(ds, batch_size=B)))
    batch64 = dict(batch, imgs=batch["imgs"].astype(np.float64))
    cpu_fw, fw = GanNerf(mc, device="cpu"), GanNerf(mc)
    for f in (cpu_fw, fw):
        f.set_info_from_datasets([ds, val])
    cpu_net, cpu_state = cpu_fw.init(0, batch)
    net, state = fw.init(0, batch)
    check(all(torch.equal(a, b.cpu()) for a, b in zip(cpu_net.parameters(), net.parameters())),
          "GNeRF: the seeded weights differ between the CPU and the card")
    # float64 on the CPU: how far float32 rounding alone moves each step
    net64, state64 = copy.deepcopy(cpu_net).double(), _to_double(cpu_state)
    gen = torch.Generator().manual_seed(7)
    rows, errs, unshared = [], {}, {}
    for seq in cpu_fw.setup_optimize_sequences("ABAB"):
        draws = cpu_fw.draws(gen, seq, B, device="cpu")
        samples = _Samples(render_mod).record()
        try:
            cpu_net.zero_grad(set_to_none=True)
            cl, ca = cpu_fw.loss_fn(cpu_net, cpu_state, batch, state="ABAB", opt_seq=seq,
                                    draws=draws)
            cl.backward()
            recorded = list(samples.z)
            samples.z = [z.double() for z in recorded]
            samples.replay("cpu")
            net64.zero_grad(set_to_none=True)
            torch.set_default_dtype(torch.float64)   # the samplers' grids too
            try:
                cpu_fw.loss_fn(net64, state64, batch64, state="ABAB", opt_seq=seq,
                               draws=_to_double(draws))[0].backward()
            finally:
                torch.set_default_dtype(torch.float32)
            samples.z = recorded
            samples.replay("cuda")
            net.zero_grad(set_to_none=True)
            gl, ga = fw.loss_fn(net, state, batch, state="ABAB", opt_seq=seq, draws=draws)
            gl.backward()
        finally:
            samples.restore()
        if seq == "generator_trainstep":
            # the same step in float64 on the card: splits the card's float32
            # gap into rounding and a rule that differs from the CPU's
            net64c = copy.deepcopy(net64).cuda()
            net64c.zero_grad(set_to_none=True)
            samples.z = [z.double() for z in recorded]
            samples.replay("cuda")
            torch.set_default_dtype(torch.float64)
            try:
                fw.loss_fn(net64c, _to_double(state), batch64, state="ABAB", opt_seq=seq,
                           draws=_to_double(draws))[0].backward()
            finally:
                torch.set_default_dtype(torch.float32)
                samples.restore()
            gen64 = {n: _grad_rel(getattr(net64, n), getattr(net64c, n))
                     for n in cpu_fw.optseq2netnames(seq)}
            gen64 = {f"{n}.{k}": v for n, d in gen64.items() for k, v in d.items()}
            k64 = max(gen64, key=gen64.get)
            rows.append(f"{seq}: card_float64_vs_cpu_float64_worst_leaf={k64}:{gen64[k64]:.3e}")
            check(gen64[k64] <= TOL_GNERF_GRAD64,
                  f"GNeRF {seq}: the card's float64 gradient is not the CPU's: {k64}")
        with torch.no_grad():   # the card's own importance samples
            own = float(fw.loss_fn(net, state, batch, state="ABAB", opt_seq=seq,
                                   draws=draws)[0])
        want, got = float(cl.detach()), float(gl.detach())
        errs[seq] = abs(got - want) / abs(want)
        unshared[seq] = abs(own - want) / abs(want)
        check(set(ca["log_vars"]) == set(ga["log_vars"]), f"{seq}: log vars differ")
        for k, v in ca["log_vars"].items():
            errs[f"{seq}.{k}"] = (abs(float(ga["log_vars"][k].detach()) - float(v.detach()))
                                  / abs(float(v.detach())))
        check(int(ga["model_state"]["it"]) == int(ca["model_state"]["it"]), f"{seq}: it")
        for (k, a), (_, b) in zip(_flat(ca["model_state"]["disc_stats"]),
                                  _flat(ga["model_state"]["disc_stats"])):
            errs[f"{seq}.{k}"] = float((b.cpu().double() - a.double()).norm()
                                       / max(float(a.double().norm()), 1e-30))
        worst, f32 = {}, {}
        for name in cpu_fw.optseq2netnames(seq):
            g = _grad_rel(getattr(cpu_net, name), getattr(net, name))
            r = _grad_rel(getattr(net64, name), getattr(cpu_net, name))
            c = _grad_rel(getattr(net64, name), getattr(net, name))
            k = max(g, key=g.get)
            worst[f"{name}.{k}"] = g[k]
            f32[f"{name}.{k}"] = (r[k], c[k])
            check(all(np.isfinite(v) for v in g.values()), f"{seq}: gradient not finite")
        rows.append(f"{seq}: loss cpu={want!r} card={got!r} own_samples={own!r} "
                    "worst_grad_leaf_card_vs_cpu=" + ",".join(
                        f"{k}:{v:.3e}" for k, v in worst.items())
                    + " that_leaf_vs_cpu_float64=" + ",".join(
                        f"cpu:{a:.3e}/card:{b:.3e}" for a, b in f32.values()))
        check(all(v <= TOL_GNERF_GRAD for v in worst.values()),
              f"GNeRF {seq}: gradients card vs CPU {worst} (float32 vs float64 {f32})")
    # forward_test at two random val poses (the init's are all one pose)
    poses = cpu_fw.ray_sampler.random_poses(cpu_fw.ray_sampler.pose_draws(gen, 2))
    with torch.no_grad():
        cpu_net.val_poses.poses_embed.copy_(pose_to_d9(poses))
        net.val_poses.poses_embed.copy_(pose_to_d9(poses).cuda())
    tb = dict(batch, val_idx=np.arange(2))
    samples = _Samples(render_mod).record()
    try:
        cout, _ = cpu_fw.forward_test(cpu_net, cpu_state, tb)
        samples.replay("cuda")
        gout, _ = fw.forward_test(net, state, tb)
    finally:
        samples.restore()
    own, _ = fw.forward_test(net, state, tb)
    maps = {k: float((gout[k].cpu() - cout[k]).abs().max()) for k in ("rgb", "depth")}
    own_maps = {k: float((own[k].cpu() - cout[k]).abs().max()) for k in ("rgb", "depth")}
    print(f"GNeRF card vs CPU (TF32 off, B {B}, samples shared): card={card!r} "
          + " ".join(rows) + " " + " ".join(f"{k}_err={v:.3e}" for k, v in errs.items())
          + " forward_test " + " ".join(f"{k}_max_abs={v:.3e}" for k, v in maps.items())
          + "; with the card's own samples: " + " ".join(
              f"{k}_loss_err={v:.3e}" for k, v in unshared.items())
          + " " + " ".join(f"{k}_max_abs={v:.3e}" for k, v in own_maps.items()), flush=True)
    check(all(v <= TOL_GNERF_LOSS_RTOL for v in errs.values()), f"GNeRF losses: {errs}")
    check(all(v <= TOL_GNERF_MAP for v in maps.values()), f"GNeRF forward_test maps: {maps}")
    check(all(np.isfinite(v) for v in list(unshared.values()) + list(own_maps.values())),
          "GNeRF: the card's own samples gave a non-finite result")
    set_tf32(cudnn=True, matmul=False)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k], f"{prefix}{k}/")]
    return [(prefix.rstrip("/"), tree)]


def phase_gnerf_full_width(card, work, profile_dir=None):
    phase("full width: GNeRF, configs/gnerf/blender.py's model (400², patch 64, inv 64, "
          "8x256 MLP, 64 + 64 samples, ndf 64, inv_depth 5, B 2), every sequence")
    from deep3dmap_tpu_torch.datasets.builder import NumpyLoader, build_dataset, upload_batch
    from deep3dmap_tpu_torch.datasets.synthetic import write_blender_fixture
    from deep3dmap_tpu_torch.models.frameworks.gnerf import GanNerf
    from deep3dmap_tpu_torch.runners.builder import build_runner
    from deep3dmap_tpu_torch.utils.config import Config

    t0 = time.perf_counter()
    root = write_blender_fixture(os.path.join(work, "lego"), splits=BLENDER_FIXTURE,
                                 img_wh=BLENDER_SRC_WH)
    fixture_s = time.perf_counter() - t0
    cfg = Config.fromfile(GNERF_BLENDER_CFG)
    mc = cfg.model["model_cfgs"]
    B = cfg.data["samples_per_gpu"]
    t0 = time.perf_counter()
    ds = build_dataset(dict(cfg.data["train"], data_dir=root), default_args=dict(device="cuda"))
    read_s = time.perf_counter() - t0
    check(ds[0]["imgs"].shape == (400, 400, 3), f"Blender reader: {ds[0]['imgs'].shape}")
    batch = next(iter(NumpyLoader(ds, batch_size=B)))
    _ARM_BATCHES["gnerf"] = dict(batch=batch, model_cfgs=dict(mc),
                                 intrinsics=np.asarray(ds.intrinsics), n_train=len(ds))
    fw = GanNerf(mc)
    fw.set_info_from_datasets([ds])
    runner_cfg = dict(cfg.runner)
    r = build_runner(dict(type="StateMachineRunner", state_seq=runner_cfg["state_seq"],
                          state_steps=runner_cfg["state_steps"]),
                     default_args=dict(framework=fw, runner_cfgs=runner_cfg["runner_cfgs"]))
    r.setup(batch)
    check(list(r.state.optimizer) == ["generator", "discriminator", "inv_net", "train_poses",
                                      "val_poses"], f"GNeRF optimizers {list(r.state.optimizer)}")
    r.epoch = runner_cfg["state_steps"][1]
    r.state_switch()
    check(r.cur_state == "ABAB", f"state {r.cur_state}")
    dbatch = upload_batch(batch, "cuda")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    per_seq = {}
    torch.cuda.reset_peak_memory_stats()
    for seq in fw.setup_optimize_sequences("ABAB"):
        names = fw.optseq2netnames(seq)
        ms = _synced_ms(lambda: r._step(dbatch, names, state="ABAB", opt_seq=seq),
                        GNERF_WARMUP, GNERF_TIMED)
        logs = {k: float(v) for k, v in
                r._step(dbatch, names, state="ABAB", opt_seq=seq).items()}
        check(all(np.isfinite(v) for v in logs.values()), f"GNeRF {seq}: {logs}")
        per_seq[seq] = dict(ms=ms, loss=logs["loss"])
    peak = torch.cuda.max_memory_allocated()
    # the generator step with TF32 matmuls, beside the float32 one
    torch.backends.cuda.matmul.allow_tf32 = True
    names = fw.optseq2netnames("generator_trainstep")
    tf32_ms = _synced_ms(lambda: r._step(dbatch, names, state="ABAB",
                                         opt_seq="generator_trainstep"),
                         GNERF_WARMUP, GNERF_TIMED)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    stats = _launch_stats(lambda: r.run_multi_iter(dbatch), GNERF_PROFILED)
    it_ms = _synced_ms(lambda: r.run_multi_iter(dbatch), 1, 3)
    torch.cuda.set_sync_debug_mode("error")
    try:
        r.run_multi_iter(dbatch)
        torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    view = dict(dbatch, val_idx=torch.zeros(1, dtype=torch.int64, device="cuda"))
    out = {}

    def render():
        out["o"] = fw.forward_test(r.state.net, r.state.model_state, view)[0]
    view_ms = _synced_ms(render, GNERF_VIEW_WARMUP, GNERF_VIEW_TIMED)
    check(tuple(out["o"]["rgb"].shape) == (1, 400, 400, 3)
          and bool(torch.isfinite(out["o"]["rgb"]).all()), "GNeRF forward_test output")
    if profile_dir:
        from torch.profiler import ProfilerActivity, profile as tprofile
        os.makedirs(profile_dir, exist_ok=True)
        with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            r.run_multi_iter(dbatch)
            torch.cuda.synchronize()
        with open(os.path.join(profile_dir, "gnerf_abab_kernels.txt"), "w") as f:
            f.write(f"{card}\n" + prof.key_averages().table(
                sort_by="self_device_time_total", row_limit=40))
    print(f"GNeRF full width: card={card!r} matmul_tf32={tf32} B={B} patch={fw.patch_size} "
          f"img_wh={fw.img_wh} " + " ".join(
              f"{seq}_ms_median={statistics.median(d['ms']):.6f} "
              f"{seq}_ms_max={max(d['ms']):.6f}" for seq, d in per_seq.items())
          + f" generator_trainstep_tf32_ms_median={statistics.median(tf32_ms):.6f} "
          f"generator_trainstep_tf32_ms_max={max(tf32_ms):.6f} "
          f"abab_iteration_ms_median={statistics.median(it_ms):.6f} "
          f"abab_launches_per_iteration={stats['launches']:.1f} "
          f"abab_device_ms_per_iteration={stats['device_ms']:.6f} "
          f"abab_busy_share={stats['busy']:.6f} "
          f"abab_profiled_wall_ms_per_iteration={stats['wall_ms']:.6f} "
          f"max_memory_allocated_bytes={peak} "
          f"forward_test_ms_per_400sq_view_median={statistics.median(view_ms):.6f} "
          f"forward_test_ms_per_400sq_view_max={max(view_ms):.6f} "
          f"synced_steps_per_sequence={GNERF_TIMED} fixture_s={fixture_s:.3f} "
          f"reader_s={read_s:.3f} host_syncs_in_abab_iteration=none", flush=True)
    print("GNeRF step losses: " + " ".join(f"{s}={d['loss']!r}" for s, d in per_seq.items()),
          flush=True)
    return root


def _so3_exp(w: np.ndarray) -> np.ndarray:
    """Rotation matrices of axis-angle vectors (N, 3) (Rodrigues)."""
    out = []
    for v in w:
        th = np.linalg.norm(v)
        k = v / max(th, 1e-12)
        K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
        out.append(np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K)
    return np.stack(out).astype(np.float32)


def gnerf_learning_check(device="cuda", stage1=300, stage2=180) -> dict:
    """``tests/test_convergence.py:28-121``'s protocol on the port: the
    refine loss fits the field at the ground-truth poses (PSNR + 3 dB), then,
    the field frozen, recovers poses perturbed by 0.05 rad and 0.03 (the
    rotation error halves, PSNR above the perturbed poses')."""
    from deep3dmap_tpu_torch.datasets.nerf_synthetic import SyntheticNerfDataset
    from deep3dmap_tpu_torch.models.frameworks.gnerf import GanNerf
    from deep3dmap_tpu_torch.models.modulars.embeddings import pose_to_d9
    from deep3dmap_tpu_torch.runners.optim import build_optimizer

    n, wh = 5, (24, 24)
    ds = SyntheticNerfDataset(n_images=n, img_wh=wh, radius=2.0, color_mode="position",
                              device=device)
    fw = GanNerf(dict(img_wh=wh, patch_size=16, inv_size=16, pose_mode="6d", fc_depth=3,
                      fc_dim=48, N_samples=16, N_importance=8, ndf=8, inv_depth=2,
                      n_train_images=n, n_val_images=1, near=0.8, far=4.0), device=device)
    fw.ray_sampler.set_start_intrinsics(ds.intrinsics)
    imgs = torch.from_numpy(np.stack(ds.images)).to(device)
    idx = torch.arange(n, device=device)
    batch = dict(imgs=imgs, img_idx=idx)
    net, mstate = fw.init(0, batch)
    gt = np.stack([np.stack([p[:3, 0], -p[:3, 1], -p[:3, 2], p[:3, 3]], 1) for p in ds.poses])
    gt = torch.from_numpy(gt.astype(np.float32)).to(device)
    rs = np.random.RandomState(3)
    R0 = torch.from_numpy(_so3_exp(rs.randn(n, 3) * 0.05)).to(device) @ gt[:, :, :3]
    t0 = gt[:, :, 3] + torch.from_numpy((rs.randn(n, 3) * 0.03).astype(np.float32)).to(device)
    noisy = pose_to_d9(torch.cat([R0, t0[..., None]], -1))

    def psnr():
        with torch.no_grad():
            poses = net.train_poses(idx)
            coords, _ = fw.full_img_sampler(n, wh, device)
            rays = fw.ray_sampler.get_rays(coords, poses, wh).reshape(-1, 8)
            rgb = net.generator(rays, None, perturb=0.0)["fine"]["rgb"].reshape(imgs.shape)
            return float(10 * torch.log10(4.0 / torch.clamp(((rgb - imgs) ** 2).mean(), 1e-12)))

    def rot_err():
        with torch.no_grad():
            dR = net.train_poses(idx)[:, :, :3] @ gt[:, :, :3].transpose(1, 2)
            cos = (dR.diagonal(dim1=1, dim2=2).sum(-1) - 1) / 2
            return float(torch.rad2deg(torch.arccos(torch.clamp(cos, -1, 1))).mean())

    def fit(module, lr, steps, seed):
        for p in net.parameters():
            p.requires_grad_(False)
        for p in module.parameters():
            p.requires_grad_(True)
        opt = build_optimizer(dict(type="Adam", lr=lr), module.parameters())
        gen = torch.Generator(device=device).manual_seed(seed)
        losses = []
        for _ in range(steps):
            opt.zero_grad()
            loss, _ = fw.loss_fn(net, mstate, batch, rng=gen, state="B",
                                 opt_seq="training_refine_step")
            loss.backward()
            opt.step()
            losses.append(loss.detach())
        return torch.stack(losses).cpu().numpy()

    with torch.no_grad():
        net.train_poses.poses_embed.copy_(pose_to_d9(gt))
    psnr0 = psnr()
    t = time.perf_counter()
    l1 = fit(net.generator, 5e-3, stage1, 7)
    psnr1 = psnr()
    with torch.no_grad():
        net.train_poses.poses_embed.copy_(noisy)
    rot0, psnr_noisy = rot_err(), psnr()
    l2 = fit(net.train_poses, 1e-2, stage2, 11)
    rot1, psnr2 = rot_err(), psnr()
    for p in net.parameters():
        p.requires_grad_(True)
    return dict(psnr0=psnr0, psnr1=psnr1, rot0=rot0, rot1=rot1, psnr_noisy=psnr_noisy,
                psnr2=psnr2, loss_first=float(l1[:20].mean()), loss_last=float(l1[-20:].mean()),
                finite=bool(np.isfinite(l1).all() and np.isfinite(l2).all()),
                seconds=time.perf_counter() - t)


def phase_gnerf_cli(card, work, tools, root):
    phase("GNeRF through the CLIs: configs/gnerf/blender.py on the 800² Blender fixture "
          "(A, ABAB, B, a resumed epoch, tools/test.py), dtu.py on a 400x300 DTU fixture, "
          "the learning check")
    import logging
    from deep3dmap_tpu_torch.datasets.synthetic import write_dtu_fixture

    seen = []
    handler = logging.Handler()
    handler.emit = lambda rec: seen.append(rec.getMessage())
    logger = logging.getLogger("deep3dmap_tpu_torch")
    logger.addHandler(handler)
    try:
        wd = os.path.join(work, "gnerf_blender_wd")
        opts = [f"data.{s}.data_dir={root}" for s in ("train", "val", "test")]
        opts += ["runner.state_steps=[0,1,2]"]
        t = time.perf_counter()
        runner = tools.train.main([GNERF_BLENDER_CFG, "--work-dir", wd, "--max-epochs", "3",
                                   "--cfg-options", *opts])
        train_s = time.perf_counter() - t
        per_epoch = dict(BLENDER_FIXTURE)["train"] // 2
        steps = per_epoch * (5 + 7 + 2)
        check((runner.epoch, runner.cur_state, runner.state.step) == (3, "B", steps),
              f"GNeRF train CLI: epoch {runner.epoch} state {runner.cur_state} "
              f"step {runner.state.step}")
        check({"state switch: A -> ABAB", "state switch: ABAB -> B"} <= set(seen),
              "GNeRF: the state switches are not in the log")
        t = time.perf_counter()
        resumed = tools.train.main([GNERF_BLENDER_CFG, "--work-dir", wd, "--resume-from",
                                    "auto", "--max-epochs", "4", "--cfg-options", *opts])
        resume_s = time.perf_counter() - t
        check((resumed.epoch, resumed.cur_state, resumed.state.step)
              == (4, "B", steps + per_epoch * 2), f"GNeRF resume: {resumed.epoch} "
              f"{resumed.cur_state} {resumed.state.step}")
        del seen[:]
        t = time.perf_counter()
        tools.test.main([GNERF_BLENDER_CFG, "--work-dir", wd, "--cfg-options", *opts])
        test_s = time.perf_counter() - t
        n_test = dict(BLENDER_FIXTURE)["test"]
        check(f"collected rgb ({n_test}, 400, 400, 3), depth ({n_test}, 400, 400)" in seen,
              f"GNeRF test CLI: {[m for m in seen if m.startswith('collected')]}")

        dtu = write_dtu_fixture(os.path.join(work, "dtu"), n_views=DTU_VIEWS, img_wh=DTU_WH)
        dwd = os.path.join(work, "gnerf_dtu_wd")
        dopts = [f"data.{s}.data_dir={dtu}" for s in ("train", "val", "test")]
        t = time.perf_counter()
        drun = tools.train.main([GNERF_DTU_CFG, "--work-dir", dwd, "--max-epochs", "1",
                                 "--cfg-options", *dopts])
        dtu_s = time.perf_counter() - t
        n_train = DTU_VIEWS - DTU_VIEWS // 8
        check((drun.epoch, drun.cur_state, drun.state.step) == (1, "A", n_train // 2 * 5),
              f"GNeRF dtu.py: {drun.epoch} {drun.cur_state} {drun.state.step}")
        del seen[:]
        tools.test.main([GNERF_DTU_CFG, "--work-dir", dwd, "--cfg-options", *dopts])
        check("collected rgb (2, 300, 400, 3), depth (2, 300, 400)" in seen,
              f"GNeRF dtu test CLI: {[m for m in seen if m.startswith('collected')]}")
    finally:
        logger.removeHandler(handler)
    learn = gnerf_learning_check("cuda")
    print(f"GNeRF CLIs: card={card!r} blender_train_3_epochs_s={train_s:.3f} "
          f"blender_resume_epoch_s={resume_s:.3f} blender_test_s={test_s:.3f} "
          f"dtu_train_epoch_s={dtu_s:.3f} cli_steps={resumed.state.step} "
          "state_switches_logged=True learning: " + " ".join(
              f"{k}={v!r}" for k, v in learn.items()), flush=True)
    check(learn["finite"], "GNeRF learning check: a loss is not finite")
    check(learn["loss_last"] < 0.5 * learn["loss_first"], f"GNeRF refine loss: {learn}")
    check(learn["psnr1"] > learn["psnr0"] + 3.0, f"GNeRF PSNR: {learn}")
    check(learn["rot0"] > 2.0 and learn["rot1"] < 0.5 * learn["rot0"], f"GNeRF poses: {learn}")
    check(learn["psnr2"] > learn["psnr_noisy"], f"GNeRF PSNR after pose recovery: {learn}")


# ---------------------------------------------------------------- phase 22 --
LERF_SYN_CFG = os.path.join("configs", "lerf", "lerf_synthetic.py")
LERF_PUB_CFG = os.path.join("configs", "lerf", "lerf.py")
# the small hash-grid config of tests/test_lerf.py:113-133
LERF_HASH_SMALL = dict(clip_n_dims=64, dino_n_dims=32, N_samples=8, N_importance=16,
                       num_lerf_samples=4, fc_depth=2, fc_dim=32, grid_layers=(2, 2),
                       grid_sizes=(10, 10), grid_resolutions=((4, 16), (16, 32)), hidden=32,
                       rgb_field_type="hashgrid", N_proposal=16, rgb_grid_levels=4,
                       rgb_grid_log2=10, rgb_grid_end=64, rgb_hidden=32)
LERF_PHRASES = ("a chair", "a red sphere")
LERF_WARMUP, LERF_TIMED, LERF_PROFILED = 2, 10, 2
LERF_VIEW_WARMUP, LERF_VIEW_TIMED = 1, 5
LERF_FIT_ITERS = 80
LERF_SCALE_SEED = 1
# CPU vs card (phase 22): losses and maps as phase 19's limits.  Gradients:
# the worst leaf on an H100 (700 W) sat 3.5e-7 (MLP, samples shared) and
# 7.1e-6 (hash grid) from the CPU's float32, where both sit up to 2.2e-4 /
# 2.3e-3 from the CPU's float64 on their worst leaves alike (printed
# beside); TOL_LERF_GRAD is 14x the larger
TOL_LERF_LOSS_RTOL = 1e-4
TOL_LERF_MAP = 1e-3
TOL_LERF_GRAD = 1e-4


def _lerf_relevancy_inputs(fws, nets, seed=LERF_SCALE_SEED):
    """The same seeded relevancy inputs on every (framework, net): CLIP-head
    biases N(0, 0.1), language-grid tables U[-1, 1), and unit positive and
    negative text embeddings (the phrases' own come from Python's salted
    ``hash()``, so they change from process to process).  With the seeded
    init (zero biases, tables near 0) the CLIP head is positively
    homogeneous in the scale, every scale above 0 ties and the first wins;
    with these, on both phase-22 configs, a later scale wins for a phrase
    (the phase checks it and prints the margin of each best scale)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for n, p in nets[0].lerf_field.named_parameters():
            if n.startswith("clip_") and n.endswith("bias"):
                v = torch.randn(p.shape, generator=gen) * 0.1
            elif n.endswith("tables"):
                v = torch.rand(p.shape, generator=gen) * 2 - 1
            else:
                continue
            for net in nets:
                net.lerf_field.get_parameter(n).copy_(v)
        enc = fws[0].image_encoder
        for attr, k in (("pos_embeds", len(enc.positives)), ("neg_embeds", len(enc.negatives))):
            v = torch.randn(k, enc.neg_embeds.shape[-1], generator=gen)
            v = v / v.norm(dim=-1, keepdim=True)
            for fw in fws:
                setattr(fw.image_encoder, attr, v.to(getattr(fw.image_encoder, attr).device))


def phase_lerf_cpu_vs_card(card):
    phase("CPU vs card: LERF, configs/lerf/lerf_synthetic.py's model (mlp) and the small "
          "hash-grid config, float32, TF32 off: loss_fn and backward, forward_test")
    import copy
    import deep3dmap_tpu_torch.models.frameworks.lerf as lerf_mod
    from deep3dmap_tpu_torch.datasets.builder import build_dataset
    from deep3dmap_tpu_torch.utils.config import Config

    set_tf32(cudnn=False, matmul=False)
    cfg = Config.fromfile(LERF_SYN_CFG)
    rows, errs = [], {}
    for name, mc in (("mlp", dict(cfg.model["model_cfgs"])), ("hashgrid", LERF_HASH_SMALL)):
        cpu_fw, fw = lerf_mod.LERFModel(mc, device="cpu"), lerf_mod.LERFModel(mc)
        ds = build_dataset(dict(cfg.data["train"], clip_n_dims=mc["clip_n_dims"],
                                dino_n_dims=mc["dino_n_dims"]),
                           default_args=dict(device="cpu", image_encoder=cpu_fw.image_encoder))
        batch = next(iter(ds))
        batch64 = {k: v.astype(np.float64) for k, v in batch.items()}
        cpu_net, _ = cpu_fw.init(0, batch)
        net, _ = fw.init(0, batch)
        check(all(torch.equal(a, b.cpu()) for a, b in zip(cpu_net.parameters(),
                                                          net.parameters())),
              f"LERF {name}: the seeded weights differ between the CPU and the card")
        net64 = copy.deepcopy(cpu_net).double()
        draws = cpu_fw.draws(torch.Generator().manual_seed(7), len(batch["rays_o"]),
                             device="cpu")
        samples = _Samples(lerf_mod)
        if name == "mlp":
            samples.record()
        try:
            cl, ca = cpu_fw.loss_fn(cpu_net, {}, batch, draws=draws)
            cl.backward()
            recorded = list(samples.z)
            if name == "mlp":
                samples.z = [z.double() for z in recorded]
                samples.replay("cpu")
            torch.set_default_dtype(torch.float64)
            try:
                cpu_fw.loss_fn(net64, {}, batch64,
                               draws={k: v.double() for k, v in draws.items()})[0].backward()
            finally:
                torch.set_default_dtype(torch.float32)
            if name == "mlp":
                samples.z = recorded
                samples.replay("cuda")
            gl, ga = fw.loss_fn(net, {}, batch, draws={k: v.cuda() for k, v in draws.items()})
            gl.backward()
        finally:
            samples.restore()
        cl, gl = float(cl.detach()), float(gl.detach())
        for k, v in ca["log_vars"].items():
            errs[f"{name}.{k}"] = (abs(float(ga["log_vars"][k].detach()) - float(v.detach()))
                                   / max(abs(float(v.detach())), 1e-12))
        errs[f"{name}.loss"] = abs(gl - cl) / abs(cl)
        g = _grad_rel(cpu_net, net)
        r = _grad_rel(net64, cpu_net)
        c = _grad_rel(net64, net)
        k = max(g, key=g.get)
        check(all(np.isfinite(v) for v in g.values()), f"LERF {name}: a gradient is not finite")
        rows.append(f"{name}: loss cpu={cl!r} card={gl!r} worst_grad_leaf="
                    f"{k}:{g[k]:.3e} that_leaf_vs_cpu_float64=cpu:{r[k]:.3e}/card:{c[k]:.3e} "
                    f"worst_card_vs_float64={max(c.values()):.3e} "
                    f"worst_cpu_vs_float64={max(r.values()):.3e}")
        check(g[k] <= TOL_LERF_GRAD, f"LERF {name}: gradients card vs CPU {k}={g[k]} "
              f"(float64: cpu {r[k]}, card {c[k]})")
        # forward_test with two positives, on inputs where the scale choice
        # is made (see _lerf_relevancy_inputs)
        for f in (cpu_fw, fw):
            f.image_encoder.set_positives(LERF_PHRASES)
        _lerf_relevancy_inputs((cpu_fw, fw), (cpu_net, net))
        samples = _Samples(lerf_mod)
        if name == "mlp":
            samples.record()
        peaks, relevancy = [], cpu_fw.image_encoder.get_relevancy

        def peak(emb, i):
            r = relevancy(emb, i)
            peaks.append(float(r[..., 0].max()))
            return r
        cpu_fw.image_encoder.get_relevancy = peak
        try:
            cout, _ = cpu_fw.forward_test(cpu_net, {}, batch)
            if name == "mlp":
                samples.replay("cuda")
            gout, _ = fw.forward_test(net, {}, batch)
        finally:
            samples.restore()
            del cpu_fw.image_encoder.get_relevancy
        # per phrase, the best scale's peak relevancy over the runner-up's
        top2 = np.sort(np.array(peaks).reshape(-1, len(LERF_PHRASES)).T, 1)[:, -2:]
        margin = float((top2[:, 1] - top2[:, 0]).min())
        maps = {f"{name}.{k}": float((gout[k].cpu() - cout[k]).abs().max())
                for k in ("rgb", "depth", "raw_relevancy")}
        rows.append(f"{name}: best_scales cpu={cout['best_scales'].tolist()} "
                    f"card={gout['best_scales'].cpu().tolist()} "
                    f"cpu_best_scale_margin={margin:.3e} " + " ".join(
                        f"{k}_max_abs={v:.3e}" for k, v in maps.items()))
        check(all(v <= TOL_LERF_MAP for v in maps.values()), f"LERF maps: {maps}")
        check(torch.equal(gout["best_scales"].cpu(), cout["best_scales"]),
              f"LERF {name}: best scales card {gout['best_scales'].tolist()} "
              f"vs CPU {cout['best_scales'].tolist()}")
        check(bool((cout["best_scales"] > 0).any()),
              f"LERF {name}: every phrase peaked at the first scale, no choice was made")
    print(f"LERF card vs CPU (TF32 off): card={card!r} " + " ".join(rows) + " "
          + " ".join(f"{k}_err={v:.3e}" for k, v in errs.items()), flush=True)
    check(all(v <= TOL_LERF_LOSS_RTOL for v in errs.values()), f"LERF losses: {errs}")
    set_tf32(cudnn=True, matmul=False)


# ---------------------------------------------------------------- phase 23 --
def seeded_lerf_checkpoints(work) -> dict:
    """Seeded ViT-B/16 CLIP and ViT-S/8 DINO state dicts in their published
    layouts, converted by the port's importers into ``work`` (the paths
    and the seconds each took)."""
    from deep3dmap_tpu_torch.datasets.synthetic import (seeded_clip_state_dict,
                                                        seeded_dino_state_dict)
    from deep3dmap_tpu_torch.utils.torch_import import import_npz_entries

    out = {}
    for kind, make, name in (("clip", seeded_clip_state_dict, "clip_vitb16.npz"),
                             ("dino", seeded_dino_state_dict, "dino_vits8.npz")):
        path = os.path.join(work, name)
        t = time.perf_counter()
        if not os.path.exists(path):
            np.savez(path, **import_npz_entries(kind, make(0)))
        out[kind], out[f"{kind}_s"] = path, time.perf_counter() - t
    return out


def _lerf_pub_options(root, ckpts):
    return [f"data.train.image_dataset.data_dir={root}",
            f"data.train.clip_npz={ckpts['clip']}", f"data.train.dino_npz={ckpts['dino']}",
            f"model.model_cfgs.clip_weights={ckpts['clip']}"]


HASH_SPAN = "span:lerf.hashgrid"


def _hash_attribution(prof) -> dict:
    """Each device kernel's µs once, by the op that launched it: inside a
    ``span:lerf.hashgrid`` range (the hash grids' forward, the program's own
    span), under an autograd node of an op from such a range (their
    backward; ``scatter`` is its ``IndexBackward0``, the sorted
    ``index_put_`` of the table rows), or elsewhere.  A backward node is matched to its forward op by sequence
    number; the nearest range or node decides.  ``total`` is every kernel
    counted this way."""
    events = prof.events()

    def chain(e):
        while e is not None:
            yield e
            e = e.cpu_parent
    in_span = {e.sequence_nr for e in events if e.sequence_nr >= 0
               and any(a.name == HASH_SPAN for a in chain(e))}
    out = dict(total=0.0, forward=0.0, backward=0.0, scatter=0.0)
    node = "autograd::engine::evaluate_function: "
    for e in events:
        for k in e.kernels:
            if k.name.startswith(("span:", "Optimizer.")):
                continue
            out["total"] += k.duration
            for a in chain(e):
                if a.name == HASH_SPAN:
                    out["forward"] += k.duration
                    break
                if a.name.startswith(node):
                    if a.sequence_nr in in_span:
                        out["backward"] += k.duration
                        if a.name == node + "IndexBackward0":
                            out["scatter"] += k.duration
                    break
    return out


def _lerf_profile(step, n):
    """torch.profiler over ``n`` steps: launches, device ms and busy share
    per step, the top device kernels, and the hash grids' forward,
    backward and backward-scatter shares of the device time
    (``_hash_attribution``: no kernel counts twice, so the shares add up
    to at most the attributed total, which is checked against the busy
    time)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = device_kernels(prof)
    busy_us = sum(e.self_device_time_total for e in kernels)
    att = _hash_attribution(prof)
    shares = {k: att[k] / max(busy_us, 1e-9) for k in ("total", "forward", "backward",
                                                        "scatter")}
    # the attributed kernels are the busy time's, summed another way
    check(abs(shares["total"] - 1.0) <= 1e-3
          and shares["forward"] + shares["backward"] <= shares["total"] + 1e-9
          and shares["scatter"] <= shares["backward"] + 1e-9,
          f"LERF profile: the kernels' attribution does not add up: {shares}")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    return dict(launches=sum(e.count for e in kernels) / n, device_ms=busy_us / 1e3 / n,
                busy=busy_us / 1e3 / wall_ms, wall_ms=wall_ms / n, shares=shares,
                top=[(e.key[:60], e.self_device_time_total / max(busy_us, 1e-9), e.count / n)
                     for e in top], prof=prof)


def phase_lerf_full_width(card, work, root, profile_dir=None):
    phase("full width: LERF, configs/lerf/lerf.py's model and data (hash grid 12 x 2^19 x 4, "
          "96 + 48 samples, 4096 rays, ViT-B/16 CLIP, ViT-S/8 DINO, 400² Blender fixture)")
    from deep3dmap_tpu_torch.datasets.builder import build_dataset, upload_batch
    from deep3dmap_tpu_torch.models.frameworks.lerf import LERFModel
    from deep3dmap_tpu_torch.runners.builder import build_runner
    from deep3dmap_tpu_torch.utils.config import Config

    ckpts = seeded_lerf_checkpoints(work)
    cfg = Config.fromfile(LERF_PUB_CFG)
    cfg.merge_from_dict(dict(o.split("=", 1) for o in _lerf_pub_options(root, ckpts)))
    mc = cfg.model["model_cfgs"]
    check((mc["rgb_field_type"], mc["rgb_grid_levels"], mc["rgb_grid_log2"], mc["N_proposal"],
           mc["N_importance"], mc["num_lerf_samples"], mc["n_scales"])
          == ("hashgrid", 12, 19, 96, 48, 24, 30), f"lerf.py model: {mc}")
    ds = build_dataset(cfg.data["train"], default_args=dict(device="cuda"))
    imgs = ds.images01()
    n_img = len(imgs)
    torch.cuda.synchronize()
    t = time.perf_counter()
    ds.build_pyramid(imgs)
    torch.cuda.synchronize()
    pyramid_s = time.perf_counter() - t
    t = time.perf_counter()
    ds.build_dino(imgs)
    dino_s = time.perf_counter() - t
    crops = sum(lv.n_crops for lv in ds._pyramid.levels)
    check(imgs[0].shape == (400, 400, 3) and crops == 881 and ds.dino_pretrained
          and ds._dino_maps.shape == (n_img, 50, 50, 384),
          f"LERF data: {imgs[0].shape} {crops} crops, dino {ds._dino_maps.shape}")
    batches = iter(ds)
    batch = next(batches)
    # the step needs no CLIP encoder (its file goes with this phase's work dir)
    _ARM_BATCHES["lerf"] = dict(batch=batch, model_cfgs=dict(mc, clip_weights=None))
    fw = LERFModel(mc)
    check(fw.image_encoder._vit is not None, "LERF: clip_weights did not load the ViT")
    runner_cfg = dict(cfg.runner["runner_cfgs"])
    r = build_runner(dict(type="IterBasedRunner"),
                     default_args=dict(framework=fw, runner_cfgs=runner_cfg))
    r.setup(batch, optimizer=runner_cfg["optimizer"], lr_config=cfg.lr_config,
            optimizer_config=cfg.optimizer_config, iters_per_epoch=len(ds))
    tables = 12 * 2 ** 19 * 4 * 4
    check(r.state.net.rgb_field.grid.tables.numel() * 4 == tables, "LERF: RGB tables' size")
    dbatch = upload_batch(batch, "cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    logs = {}

    def step():
        logs["v"] = r.run_iter(dbatch)
    step_ms = _synced_ms(step, LERF_WARMUP, LERF_TIMED)
    peak = torch.cuda.max_memory_allocated()
    vals = {k: float(v) for k, v in logs["v"].items()}
    check(all(np.isfinite(v) for v in vals.values()), f"LERF step logs: {vals}")
    stats = _lerf_profile(step, LERF_PROFILED)
    fw.image_encoder.set_positives(LERF_PHRASES)
    out = {}

    def query():
        out["o"] = fw.forward_test(r.state.net, {}, dbatch)[0]
    view_ms = _synced_ms(query, LERF_VIEW_WARMUP, LERF_VIEW_TIMED)
    o = out["o"]
    check(tuple(o["raw_relevancy"].shape) == (2, 4096) and tuple(o["best_scales"].shape) == (2,)
          and bool(torch.isfinite(o["raw_relevancy"]).all())
          and bool(torch.isfinite(o["rgb"]).all()), "LERF forward_test output")
    torch.cuda.set_sync_debug_mode("error")
    try:
        step()
        fw.forward_test(r.state.net, {}, dbatch)
        torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    if profile_dir:
        os.makedirs(profile_dir, exist_ok=True)
        with open(os.path.join(profile_dir, "lerf_train_kernels.txt"), "w") as f:
            f.write(f"{card}\n" + stats["prof"].key_averages().table(
                sort_by="self_device_time_total", row_limit=40))
    print(f"LERF full width: card={card!r} matmul_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"rays={len(batch['rays_o'])} images={n_img} crops_per_image={crops} "
          f"clip_import_s={ckpts['clip_s']:.3f} dino_import_s={ckpts['dino_s']:.3f} "
          f"pyramid_s_per_image={pyramid_s / n_img:.6f} dino_s_per_image={dino_s / n_img:.6f} "
          f"step_ms_median={statistics.median(step_ms):.6f} step_ms_max={max(step_ms):.6f} "
          f"launches_per_step={stats['launches']:.1f} device_ms_per_step={stats['device_ms']:.6f} "
          f"busy_share={stats['busy']:.6f} profiled_wall_ms_per_step={stats['wall_ms']:.6f} "
          f"attributed_share={stats['shares']['total']:.6f} "
          f"hash_forward_share={stats['shares']['forward']:.6f} "
          f"hash_backward_share={stats['shares']['backward']:.6f} "
          f"hash_backward_scatter_share={stats['shares']['scatter']:.6f} "
          f"max_memory_allocated_bytes={peak} rgb_tables_bytes={tables} "
          f"forward_test_ms_per_4096_rays_median={statistics.median(view_ms):.6f} "
          f"forward_test_ms_per_4096_rays_max={max(view_ms):.6f} "
          f"best_scales={o['best_scales'].tolist()} host_syncs_in_step_and_forward_test=none "
          f"synced_steps={LERF_TIMED}", flush=True)
    print("LERF top device kernels per step (share of device time, launches): " + "; ".join(
        f"{k}={s:.4f}/{c:.0f}" for k, s, c in stats["top"]), flush=True)
    print("LERF step logs: " + " ".join(f"{k}={v!r}" for k, v in vals.items()), flush=True)
    return ckpts


# ---------------------------------------------------------------- phase 24 --
def _json_log(wd):
    recs = []
    for name in sorted(os.listdir(wd)):
        if name.endswith(".log.json"):
            with open(os.path.join(wd, name)) as f:
                recs += [json.loads(line) for line in f]
    return recs


def phase_lerf_cli(card, work, tools, root, ckpts):
    phase("LERF through the CLIs: lerf_synthetic.py (16 iterations, resume to 24, "
          "tools/test.py), lerf.py on the 400² fixture with the seeded ViTs, the learning check")
    import logging
    from deep3dmap_tpu_torch.runners.optim import build_lr_schedule

    seen = []
    handler = logging.Handler()
    handler.emit = lambda rec: seen.append(rec.getMessage())
    logger = logging.getLogger("deep3dmap_tpu_torch")
    logger.addHandler(handler)
    try:
        wd = os.path.join(work, "lerf_syn_wd")
        t = time.perf_counter()
        runner = tools.train.main([LERF_SYN_CFG, "--work-dir", wd])
        syn_s = time.perf_counter() - t
        ck = set(os.listdir(os.path.join(wd, "checkpoints")))
        check(runner.state.step == 16 and {"ckpt_8", "ckpt_16"} <= ck,
              f"LERF synthetic CLI: step {runner.state.step}, {sorted(ck)}")
        sched = build_lr_schedule("cosineannealing", 1e-3, 16, min_lr=1e-5)
        recs = _json_log(wd)
        check([x["lr"] for x in recs] == [sched(k) for k in (4, 8, 12, 16)],
              f"LERF: the logged lr is not the cosine schedule's: {[x['lr'] for x in recs]}")
        t = time.perf_counter()
        resumed = tools.train.main([LERF_SYN_CFG, "--work-dir", wd, "--resume-from", "auto",
                                    "--cfg-options", "runner.runner_cfgs.max_iters=24"])
        resume_s = time.perf_counter() - t
        check(resumed.state.step == 24, f"LERF resume: step {resumed.state.step}")
        del seen[:]
        tools.test.main([LERF_SYN_CFG, "--work-dir", wd, "--checkpoint", "auto"])
        check("collected rgb (512, 3), depth (512,)" in seen,
              f"LERF test CLI: {[m for m in seen if m.startswith('collected')]}")

        pwd = os.path.join(work, "lerf_pub_wd")
        opts = _lerf_pub_options(root, ckpts) + [
            f"runner.runner_cfgs.max_iters={LERF_FIT_ITERS}", "log_config.interval=10",
            "checkpoint_config.interval=100"]
        t = time.perf_counter()
        pub = tools.train.main([LERF_PUB_CFG, "--work-dir", pwd, "--cfg-options", *opts])
        pub_s = time.perf_counter() - t
        check(pub.state.step == LERF_FIT_ITERS and pub.framework.rgb_field_type == "hashgrid",
              f"LERF lerf.py CLI: step {pub.state.step}")
        fit = _json_log(pwd)
        first, last = fit[:3], fit[-3:]
        learn = {k: (float(np.mean([x[k] for x in first])), float(np.mean([x[k] for x in last])))
                 for k in ("rgb_loss", "clip_loss", "dino_loss", "prop_loss", "loss")}
        test_opts = [o.replace("data.train", "data.test") for o in opts if o.startswith("data.")]
        test_opts += ["data.test.type=LERFRayDataset", "data.test.image_dataset.type="
                      "BlenderDataset", "data.test.image_dataset.split=test",
                      "data.test.image_dataset.img_wh=(400,400)", "data.test.rays_per_batch=4096",
                      "data.test.n_batches=2", "data.test.clip_n_dims=512",
                      "data.test.dino_n_dims=384", "data.test.tile_size_range=(0.05,0.5)",
                      "data.test.tile_size_res=7", "data.test.seed=9"]
        del seen[:]
        t = time.perf_counter()
        tools.test.main([LERF_PUB_CFG, "--work-dir", pwd, "--checkpoint", "auto",
                         "--cfg-options", *[o for o in opts if not o.startswith("data.")],
                         *test_opts])
        test_s = time.perf_counter() - t
        check("collected rgb (8192, 3), depth (8192,)" in seen,
              f"LERF lerf.py test CLI: {[m for m in seen if m.startswith('collected')]}")
    finally:
        logger.removeHandler(handler)
    print(f"LERF CLIs: card={card!r} synthetic_16_iters_s={syn_s:.3f} "
          f"synthetic_resume_to_24_s={resume_s:.3f} lerf_py_{LERF_FIT_ITERS}_iters_s={pub_s:.3f} "
          f"lerf_py_test_s={test_s:.3f} learning (first 3 logs -> last 3 logs, 10 iterations "
          "each): " + " ".join(f"{k}={a!r}->{b!r}" for k, (a, b) in learn.items()), flush=True)
    check(all(np.isfinite(v) for ab in learn.values() for v in ab), f"LERF fit: {learn}")
    check(learn["rgb_loss"][1] < learn["rgb_loss"][0]
          and learn["clip_loss"][1] < learn["clip_loss"][0], f"LERF learning check: {learn}")


# ---------------------------------------------------------------- phase 25 --
# the training runtime at full width under the elastic supervisor: the
# bench.py model with the grafted MNASNet trunk, phase 14's fixture,
# RepeatDataset(times=2), AdamW + paramwise, poly with a linear warmup,
# MultiSteps(2), EMAHook, EvalHook(save_best), one injected crash
RUNTIME_EPOCHS, RUNTIME_REPEAT, RUNTIME_K = 2, 2, 2
RUNTIME_CRASH = (1, 1)        # (epoch index, inner iteration): the middle of epoch 2


def _runtime_config(root, wd, npz, probe, marker):
    """The phase's config file: a probe hook and the crash as a ClosureHook
    are defined in it (the child registers them when it loads the file)."""
    model_cfgs = dict(BENCH_CFGS, BACKBONE2D=dict(BENCH_CFGS["BACKBONE2D"], NORM="none",
                                                  TORCH_PAD=True, CKPT=npz))
    return _cli_config(root, wd, model_cfgs, N_VIEWS, IMG_HW, N_VOX, 0.04,
                       epochs=RUNTIME_EPOCHS, checkpoint_interval=1,
                       log_interval=CLI_LOG_INTERVAL) + f"""
import json
import os
import time

import numpy as np
import torch

from deep3dmap_tpu_torch.runners.hooks import HOOKS, Hook
from deep3dmap_tpu_torch.utils.from_flax import to_flax_params
from deep3dmap_tpu_torch.utils.tracing import counter

PROBE, MARKER, NPZ = {probe!r}, {marker!r}, {npz!r}
FPN_HEAD = ("Conv_3", "Conv_4", "Conv_5", "Conv_6", "Conv_7")


def loss_launches():
    return counter("fused_loss.fwd_launches"), counter("fused_loss.bwd_launches")


def _record(**kw):
    with open(PROBE, "a") as f:
        f.write(json.dumps(kw) + "\\n")


def _flat(tree, prefix=""):
    out = {{}}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@HOOKS.register_module(force=True)
class RuntimeProbe(Hook):
    \"\"\"Per micro-step: synced wall time, fused-loss launches, the loss,
    the peak bytes; the grafted trunk against the npz before the first
    step.\"\"\"
    PRIORITY = 1

    def before_run(self, runner):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        rec = dict(kind="start", time=time.time(), iter=runner.iter, epoch=runner.epoch)
        if runner.iter == 0:
            with np.load(NPZ, allow_pickle=True) as d:
                want = _flat(d["params"].item()["params"])
            got = _flat(to_flax_params(runner.state.net.backbone2d.fpn))
            trunk = [k for k in want if k.split("/")[0] not in FPN_HEAD]
            rec["graft_leaves"] = len(trunk)
            rec["graft_max_abs"] = max(float(np.abs(got[k] - want[k]).max()) for k in trunk)
        _record(**rec)

    def before_train_iter(self, runner):
        torch.cuda.synchronize()
        self.t = time.perf_counter()
        self.l0 = loss_launches()

    def after_train_iter(self, runner):
        torch.cuda.synchronize()
        ms = (time.perf_counter() - self.t) * 1e3
        _record(kind="step", iter=runner.iter, epoch=runner.epoch, ms=ms,
                launches=[a - b for a, b in zip(loss_launches(), self.l0)],
                totals=list(loss_launches()),
                loss=float(runner.log_buffer.val_history["loss"][-1]),
                lr=runner.current_lr(), peak=torch.cuda.max_memory_allocated(),
                time=time.time())

    def after_val_epoch(self, runner):
        _record(kind="val", epoch=runner.epoch,
                totals=list(loss_launches()))


def _crash_once(runner):
    if (runner.epoch, runner.inner_iter) == {RUNTIME_CRASH!r} and not os.path.exists(MARKER):
        open(MARKER, "w").write("x")
        _record(kind="crash", time=time.time(), iter=runner.iter)
        raise RuntimeError("injected crash (chip_smoke phase 25)")


data["train"] = dict(type="RepeatDataset", times={RUNTIME_REPEAT}, dataset=data["train"])
data["val"] = dict(data["test"])
workflow = [("train", 1), ("val", 1)]
optimizer_config = dict(grad_clip=dict(max_norm=1.0), cumulative_iters={RUNTIME_K})
lr_config = dict(policy="poly", power=0.9, min_lr=1e-5, by_epoch=False,
                 warmup="linear", warmup_iters=2, warmup_ratio=0.1)
runner = dict(type="EpochBasedRunner", runner_cfgs=dict(
    optimizer=dict(type="AdamW", lr=1e-3, weight_decay=1e-2,
                   paramwise_cfg=dict(norm_decay_mult=0.0, bias_decay_mult=0.0)),
    max_epochs={RUNTIME_EPOCHS}))
custom_hooks = [dict(type="RuntimeProbe"), dict(type="EMAHook", momentum=0.01, warm_up=4),
                dict(type="EvalHook", interval=1, save_best="loss", rule="less"),
                dict(type="ClosureHook", fn_name="after_train_iter", fn=_crash_once)]
"""


def phase_runtime(card, work, run_elastic, import_weights, seeded_mnasnet, checkpoint_mod):
    phase("the training runtime at full width under the supervisor: bench.py model with "
          "a grafted MNASNet trunk, RepeatDataset, AdamW + paramwise, poly + warmup, "
          "MultiSteps(2), EMA, EvalHook, one injected crash")
    set_tf32(cudnn=True, matmul=False)
    import contextlib
    import io

    root, wd = os.path.join(work, "data"), os.path.join(work, "runtime")
    os.makedirs(wd, exist_ok=True)
    pth, npz = os.path.join(wd, "mnasnet.pth"), os.path.join(wd, "mnasnet_fpn.npz")
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in seeded_mnasnet(seed=0).items()},
               pth)
    import_weights.main(["mnasnet", pth, npz])
    probe, marker, hb = (os.path.join(wd, n) for n in ("probe.jsonl", "crashed", "hb.json"))
    cfg = os.path.join(wd, "cfg_runtime.py")
    with open(cfg, "w") as f:
        f.write(_runtime_config(root, os.path.join(wd, "train"), npz, probe, marker))
    os.environ["D3M_HEARTBEAT_INTERVAL"] = "2"
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = run_elastic.main(["--max-restarts", "2", "--stall-timeout", "600", "--poll", "0.5",
                               "--backoff", "0", "--heartbeat-file", hb, "--", cfg])
    wall = time.perf_counter() - t0
    sup = out.getvalue()
    print(sup, end="", flush=True)
    check(rc == 0, f"run_elastic exited {rc}")
    check("restart 1/2" in sup and "restart 2/2" not in sup,
          "the supervisor did not restart exactly once")
    with open(os.path.join(wd, "train", "train.log")) as f:
        log = f.read()
    check("Resumed from" in log, "the restarted trainer did not resume")
    with open(hb) as f:
        beat = json.load(f)
    check(beat["epoch"] == RUNTIME_EPOCHS, f"heartbeat {beat}")
    best = checkpoint_mod.latest_checkpoint(os.path.join(wd, "train", "best"))
    check(best is not None, "EvalHook wrote no best/ checkpoint")
    with open(probe) as f:
        recs = [json.loads(line) for line in f]
    starts = [r for r in recs if r["kind"] == "start"]
    steps = [r for r in recs if r["kind"] == "step"]
    crash = [r for r in recs if r["kind"] == "crash"]
    check(len(starts) == 2 and len(crash) == 1, f"{len(starts)} starts, {len(crash)} crashes")
    check(starts[0].get("graft_max_abs") == 0.0 and starts[0]["graft_leaves"] > 0,
          f"the grafted trunk differs from the npz: {starts[0]}")
    per_epoch = RUNTIME_REPEAT * (CLI_FRAMES // N_VIEWS)
    crash_iter = crash[0]["iter"]
    # the crashed attempt ran to the crash; the resumed one from epoch 2's start
    check(len(steps) == crash_iter + 1 + (RUNTIME_EPOCHS - 1) * per_epoch,
          f"{len(steps)} micro-steps recorded")
    check(all(r["launches"] == [3, 1] for r in steps),
          f"fused loss launches per micro-step {[r['launches'] for r in steps]}")
    check(all(np.isfinite(r["loss"]) for r in steps), "a loss is not finite")
    resumed = next(i for i, r in enumerate(steps) if i > 0 and r["iter"] <= steps[i - 1]["iter"])
    ends, attempt = {}, 0
    for r in recs:      # each attempt's counters are its own process's
        attempt += r["kind"] == "start"
        if "totals" in r:
            ends[attempt] = r["totals"]
    launches = tuple(sum(t[j] for t in ends.values()) for j in range(2))
    ms = [r["ms"] for r in steps]
    print(f"runtime: card={card!r} supervisor_wall_s={wall:.3f} restarts=1 "
          f"micro_steps={len(steps)} updates_per_epoch={per_epoch // RUNTIME_K} "
          f"runner_micro_step_ms_median={statistics.median(ms):.6f} "
          f"runner_micro_step_ms_max={max(ms):.6f} "
          f"restart_wall_s_crash_to_resumed_start={starts[1]['time'] - crash[0]['time']:.3f} "
          f"restart_wall_s_crash_to_first_resumed_step="
          f"{steps[resumed]['time'] - crash[0]['time']:.3f} "
          f"max_memory_allocated_bytes={max(r['peak'] for r in steps)} "
          f"fused_loss_launches_per_micro_step={steps[0]['launches']} "
          f"fused_loss_launches_both_attempts={list(launches)} "
          f"graft_leaves={starts[0]['graft_leaves']} graft_max_abs=0.0 "
          f"lr_first={steps[0]['lr']!r} lr_last={steps[-1]['lr']!r} "
          f"loss_first={steps[0]['loss']:.6f} loss_last={steps[-1]['loss']:.6f} "
          f"heartbeat_epoch={beat['epoch']} best={os.path.basename(best)}", flush=True)
    return dict(launches=launches, train_dir=os.path.join(wd, "train"))


# ---------------------------------------------------------------- phase 26 --
# the streaming demo at full width: phase 14's fixture through --scannet
# (9 views at 640x480, 96^3, the JAX demo's dense model), then synthetic
# fragments without the preview
DEMO_SYN_FRAGMENTS = 4


def phase_demo(card, work, demo_mod, nr_module, train_mod, runtime_dir):
    phase("the streaming demo at full width: --scannet on phase 14's fixture (9 x 640x480, "
          "96^3, dense), preview every fragment; synthetic fragments, no preview")
    set_tf32(cudnn=True, matmul=False)
    from deep3dmap_tpu_torch.datasets.builder import _stack_samples
    from deep3dmap_tpu_torch.datasets.scannet import ScanNetDataset
    from deep3dmap_tpu_torch.runners.checkpoint import (latest_checkpoint, load_checkpoint_raw,
                                                        save_checkpoint)
    from deep3dmap_tpu_torch.runners.train_state import init_train_state

    root = os.path.join(work, "data")
    cfgs = demo_mod.model_cfgs(N_VOX, 0.04)
    fw = nr_module.NeuralRecon(cfgs, device="cuda")
    ds = ScanNetDataset(root, mode="train", nviews=N_VIEWS, n_vox=N_VOX, voxel_size=0.04,
                        pipeline=demo_mod.scannet_pipeline(N_VOX, 0.04, N_VIEWS),
                        device="cuda")
    batch = _stack_samples([ds[0]])
    # phase 25's checkpoint against the demo's model: its trunk is the
    # grafted import mode (bias convs, no GroupNorm)
    want = {k: tuple(v.shape) for k, v in fw.net.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in
           load_checkpoint_raw(latest_checkpoint(runtime_dir), "cpu")["net"].items()}
    missing, extra = sorted(set(want) - set(got)), sorted(set(got) - set(want))
    shapes = [k for k in set(want) & set(got) if want[k] != got[k]]
    why = (f"{len(missing)} keys missing (e.g. {missing[:2]}), {len(extra)} unexpected "
           f"(e.g. {extra[:2]}), {len(shapes)} of another shape"
           if missing or extra or shapes else None)
    print(f"demo: phase 25's checkpoint into the demo's model: "
          f"{'loads' if why is None else 'refused: ' + why}", flush=True)
    # two training steps of the demo's own config, their checkpoint loaded
    l0 = loss_launches()
    state = init_train_state(fw, 0, batch, ADAM, CLIP)
    for i in range(2):
        state, log = train_mod.train_step(fw, state, _stack_samples([ds[i]]))
    check(bool(torch.isfinite(log["loss"])), "the demo config's training loss is not finite")
    launches = tuple(a - b for a, b in zip(loss_launches(), l0))
    check(launches == (6, 2), f"fused loss launches {launches} in 2 steps")
    ckpt = save_checkpoint(os.path.join(work, "demo_train"), state)

    # the demo's forward_test under sync debug mode "error"; the per-fragment
    # host copy stays outside it
    orig = nr_module.NeuralRecon.forward_test

    def no_sync(self, *a, **kw):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return orig(self, *a, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    nr_module.NeuralRecon.forward_test = no_sync
    try:
        sc = demo_mod.main(["--scannet", root, "--n-views", str(N_VIEWS), "--n-vox", str(N_VOX),
                            "--n-fragments", "8", "--checkpoint", ckpt,
                            "--out", os.path.join(work, "demo_scannet"), "--preview-every", "1"])
        syn = demo_mod.main(["--n-fragments", str(DEMO_SYN_FRAGMENTS), "--n-views",
                             str(N_VIEWS), "--n-vox", str(N_VOX), "--checkpoint", ckpt,
                             "--out", os.path.join(work, "demo_syn"), "--preview-every", "0"])
    finally:
        nr_module.NeuralRecon.forward_test = orig
    for run in (sc, syn):
        check(run["meshes"] and all(os.path.getsize(p) > 0 for p in run["meshes"]),
              f"demo meshes {run['meshes']}")
    n_frag = sc["keyframes"] // N_VIEWS
    check(len(sc["previews"]) == n_frag and all(os.path.getsize(p) > 0 for p in sc["previews"]),
          f"{len(sc['previews'])} previews for {n_frag} fragments")
    print(f"demo: card={card!r} scannet_fragments={n_frag} "
          f"scannet_keyframes_per_s={sc['keyframes_per_s']:.6f} "
          f"scannet_seconds={sc['seconds']:.6f} previews={len(sc['previews'])} "
          f"synthetic_fragments={DEMO_SYN_FRAGMENTS} "
          f"synthetic_keyframes_per_s={syn['keyframes_per_s']:.6f} "
          f"synthetic_seconds={syn['seconds']:.6f} meshes={len(sc['meshes'])}+"
          f"{len(syn['meshes'])} train_launches={list(launches)}", flush=True)
    print("host syncs: none in the demo's forward_test (set_sync_debug_mode('error'))",
          flush=True)
    return launches


# --------------------------------------------------------------- phase 27 --
# tools/benchmark_ba.py's default problem, and the capacity that
# deep3dmap_tpu/core/sfm/ba.py:29-32 names: (cameras, points, views a point)
SFM_SIZES = (("default", (24, 4096, 8)), ("capacity", (64, 16384, 8)))
SFM_ITERS, SFM_REPS, SFM_SIGMA = 30, 3, 0.5
SFM_EXPECT_TOL = 0.05         # final cost against sigma^2 (2M - 6C - 3P) / 2
TOL_SFM64 = 1e-9              # CPU vs card, float64: states, relative
TOL_SFM64_END = 1e-6          # ... after the cost's floor (rounding-sized steps)
TOL_SFM32_COST, TOL_SFM32_ROT = 1e-3, 1e-4
TOL_SFM32_THRESH = 1e-3       # a Sampson distance this near thresh may flip
SFM_DECIDED = 1e-12           # a cost change below this (relative) is rounding
SFM_IMG_HW, SFM_K, SFM_SHIFT = (480, 640), 512, 6
SFM_RANSAC = (256, 2048, 0.3)       # hypotheses, correspondences, outliers
SFM_GRAPH = (64, 8, 15)             # nodes, loop closures, iterations
SFM_PROFILED = 2                    # LM iterations in the profile window


def _rodrigues(w) -> np.ndarray:
    w = np.asarray(w, np.float64)
    th = np.linalg.norm(w, axis=-1)[..., None, None]
    W = np.zeros(w.shape[:-1] + (3, 3))
    W[..., 0, 1], W[..., 0, 2], W[..., 1, 2] = -w[..., 2], w[..., 1], -w[..., 0]
    W = W - np.swapaxes(W, -1, -2)
    safe = np.where(th < 1e-12, 1.0, th)
    A = np.where(th < 1e-12, 1.0, np.sin(safe) / safe)
    B = np.where(th < 1e-12, 0.5, (1.0 - np.cos(safe)) / (safe * safe))
    return np.eye(3) + A * W + B * (W @ W)


def _ring_scene(rng, n_cams, n_pts, noise):
    """``tests/test_sfm.py:82-107``'s scene in numpy: (K, Rs, ts, X, cam_idx,
    pt_idx, uv) with ``noise`` px on the observations."""
    X = rng.randn(n_pts, 3) * 0.6
    K = np.tile(np.array([320.0, 320.0, 160.0, 120.0]), (n_cams, 1))
    Rs, ts = [], []
    for i in range(n_cams):
        ang = 0.4 * i / max(n_cams - 1, 1)
        R = _rodrigues([0.0, ang, 0.0])
        Rs.append(R)
        ts.append(-R @ np.array([2.5 * np.sin(ang), 0.1 * i, -2.5 * np.cos(ang)]))
    Rs, ts = np.stack(Rs), np.stack(ts)
    cam_idx = np.repeat(np.arange(n_cams), n_pts)
    pt_idx = np.tile(np.arange(n_pts), n_cams)
    Xc = np.einsum("nij,nj->ni", Rs[cam_idx], X[pt_idx]) + ts[cam_idx]
    uv = K[cam_idx, :2] * Xc[:, :2] / Xc[:, 2:] + K[cam_idx, 2:]
    return K, Rs, ts, X, cam_idx, pt_idx, uv + noise * rng.randn(*uv.shape)


def _pose_ring(rng, N, loops, noise=0.03):
    """Ground-truth poses, noisy odometry edges and exact loop closures
    (``tests/test_sfm.py:251-276``), the start integrated from the
    odometry: (R0, t0, (i, j, Rz, tz, w))."""
    Rg, tg = _rodrigues(rng.randn(N, 3) * 0.3), rng.randn(N, 3)
    pairs = [(a, a + 1) for a in range(N - 1)] + list(loops)
    Rz = np.stack([Rg[a].T @ Rg[b] for a, b in pairs])
    tz = np.stack([Rg[a].T @ (tg[b] - tg[a]) for a, b in pairs])
    Rz[:N - 1] = _rodrigues(rng.randn(N - 1, 3) * noise) @ Rz[:N - 1]
    tz[:N - 1] += rng.randn(N - 1, 3) * noise
    R0, t0 = [Rg[0]], [tg[0]]
    for k in range(N - 1):
        Rk, tk = R0[-1], t0[-1]
        R0.append(Rk @ Rz[k])
        t0.append(Rk @ tz[k] + tk)
    i, j = (np.array(p, np.int64) for p in zip(*pairs))
    return np.stack(R0), np.stack(t0), (i, j, Rz, tz, np.ones(len(pairs)))


def _on(dev, dtype, *arrays):
    """numpy arrays as tensors on ``dev``: floating ones in ``dtype``."""
    out = []
    for a in arrays:
        t = torch.as_tensor(np.asarray(a))
        out.append(t.to(dev, dtype) if t.is_floating_point() else t.to(dev))
    return out


def _recorded(mod, name, solve):
    """``solve()`` with every call of ``mod.<name>`` (a solver's cost
    function: the start's cost, then each iteration's candidate) recorded
    as a float; (result, costs)."""
    seen, orig = [], getattr(mod, name)

    def spy(*a):
        c = orig(*a)
        seen.append(float(c))
        return c
    setattr(mod, name, spy)
    try:
        return solve(), seen
    finally:
        setattr(mod, name, orig)


def _decisions(seen):
    """(accepts, the number of leading iterations decided above rounding)
    from a recorded run: an iteration whose candidate is within
    ``SFM_DECIDED`` of the cost it meets is decided by rounding alone, and
    so, on either device, may be every later one."""
    cost, accepts, n = seen[0], [], None
    for k, new in enumerate(seen[1:]):
        if n is None and abs(new - cost) <= SFM_DECIDED * abs(cost):
            n = k
        accepts.append(new < cost)
        cost = min(cost, new)
    return accepts, len(accepts) if n is None else n


def _rel(a, b) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).abs().max() / a.abs().max().clamp_min(1e-300))


def _rot_err(Ra, Rb, so3_log) -> float:
    """Largest angle (rad) between matching rotations of two stacks."""
    return float(so3_log((Ra.double().cpu().transpose(-1, -2) @ Rb.double().cpu()))
                 .norm(dim=-1).max())


def _solver_cpu_vs_card(label, run, mod, cost_name, n_states, iters, dtype, so3_log):
    """``run(dev, iters)`` (an LM solve: a result whose first ``n_states``
    entries are the states, rotations first, and ``mod.<cost_name>`` its
    cost function) on the CPU and on the card.  float64: the same accepts while the decisions
    are above rounding, the states after those iterations within 1e-9,
    after all of them the cost within 1e-9 and the states within 1e-6;
    float32: the cost within 1e-3, the rotations within 1e-4 rad."""
    runs = {dev: _recorded(mod, cost_name, lambda: run(dev, iters)) for dev in ("cpu", "cuda")}
    (rc, sc), (rg, sg) = runs["cpu"], runs["cuda"]
    cost_rel = abs(min(sc) - min(sg)) / min(sc)
    if dtype == torch.float64:
        (ac, n), (ag, _) = _decisions(sc), _decisions(sg)
        check(n >= 3 and ac[:n] == ag[:n], f"{label} float64: accepts {ac} (CPU) {ag} (card), "
              f"decided to iteration {n}")
        mid = {dev: run(dev, n) for dev in ("cpu", "cuda")}
        err_n = max(_rel(a, b) for a, b in zip(mid["cpu"][:n_states], mid["cuda"][:n_states]))
        err_end = max(_rel(a, b) for a, b in zip(rc[:n_states], rg[:n_states]))
        check(err_n < TOL_SFM64 and cost_rel < TOL_SFM64 and err_end < TOL_SFM64_END,
              f"{label} float64 CPU vs card: states {err_n:.3e} after the {n} decided "
              f"iterations, {err_end:.3e} after {iters}, cost {cost_rel:.3e}")
        print(f"sfm (a) {label} float64: decided={n} accepts_cpu="
              f"{''.join('AR'[not a] for a in ac)} accepts_card="
              f"{''.join('AR'[not a] for a in ag)} state_rel_at_decided={err_n:.3e} "
              f"state_rel_at_{iters}={err_end:.3e} cost_rel={cost_rel:.3e}", flush=True)
    else:
        rot = _rot_err(rc[0], rg[0], so3_log)
        check(cost_rel < TOL_SFM32_COST and rot < TOL_SFM32_ROT,
              f"{label} float32 CPU vs card: cost {cost_rel:.3e}, rotation {rot:.3e}")
        print(f"sfm (a) {label} float32: cost_cpu={min(sc):.6f} cost_card={min(sg):.6f} "
              f"cost_rel={cost_rel:.3e} rot_rad={rot:.3e}", flush=True)
    return rc


def _sfm_cpu_vs_card(sfm, ba_mod, pg_mod, tri_mod):
    """(a): the port on the CPU against the port on the card, float64 and
    float32: LM with and without Huber, the pose graph, RANSAC with the
    uniforms drawn once on the host and replayed on both."""
    rng = np.random.RandomState(0)
    K, Rs, ts, X, ci, pi, uv = _ring_scene(rng, 6, 64, SFM_SIGMA)
    xi = rng.randn(6, 6) * 0.02
    xi[:2] = 0.0
    dR = _rodrigues(xi[:, 3:])
    start = (dR @ Rs, np.einsum("nij,nj->ni", dR, ts) + xi[:, :3], X + rng.randn(*X.shape) * 0.05)
    uv_out = uv.copy()
    uv_out[::37] += 80.0                  # gross outliers for the Huber run
    gR0, gt0, graph = _pose_ring(rng, 12, loops=[(0, 11)])
    for dtype in (torch.float64, torch.float32):
        tag = str(dtype).split(".")[-1]

        def on(dev, *arrays):
            return _on(dev, dtype, *arrays)

        for name, obs, huber in (("l2", uv, None), ("huber", uv_out, 2.0)):
            def lm(dev, iters):
                K_, uv_, w = on(dev, K, obs, np.ones(len(ci)))
                prob = ba_mod.BAProblem(K_, *on(dev, ci, pi), uv_, w, *on(dev, np.arange(6) < 2))
                return sfm.lm_solve(*on(dev, *start), prob, iters=iters, huber=huber)
            _solver_cpu_vs_card(f"lm {name}", lm, ba_mod, "robust_cost", 3, 20, dtype,
                                sfm.so3_log)

        def pose_graph(dev, iters):
            return sfm.optimize(*on(dev, gR0, gt0), pg_mod.PoseGraph(*on(dev, *graph)),
                                iters=iters)
        R, t, cost, c0 = _solver_cpu_vs_card("pose graph", pose_graph, pg_mod, "graph_cost",
                                             2, 15, dtype, sfm.so3_log)
        check(float(cost) < 0.5 * float(c0), f"pose graph {tag}: cost {cost} from {c0}")

        # RANSAC, the host's uniforms replayed on both devices
        n_pts = 200
        Kr, *_, uvr = _ring_scene(np.random.RandomState(1), 2, n_pts, 0.0)
        uv1, uv2 = uvr[:n_pts], uvr[n_pts:].copy()
        bad = rng.rand(n_pts) < 0.3
        uv2[bad] += rng.randn(bad.sum(), 2) * 40 + 20
        x1 = (uv1 - Kr[0, 2:]) / Kr[0, :2]
        x2 = (uv2 - Kr[1, 2:]) / Kr[1, :2]
        gen = torch.Generator().manual_seed(0)
        g = tri_mod._hypothesis_uniforms(gen, SFM_RANSAC[0], torch.zeros(n_pts, dtype=dtype))
        res = {}
        with _replayed_uniforms(tri_mod, g):
            for dev in ("cpu", "cuda"):
                a, b = on(dev, x1, x2)
                E, inl = sfm.essential_ransac(a, b, None, n_hypotheses=SFM_RANSAC[0],
                                              thresh=1e-4)
                R, _ = sfm.recover_pose(E, a[inl], b[inl])
                res[dev] = (E.cpu(), inl.cpu(), R.cpu())
        (Ec, ic, Rc), (Eg, ig, Rg_) = res["cpu"], res["cuda"]
        sign = torch.sign((Ec * Eg).sum())
        e_err = float((Ec - sign * Eg).abs().max())
        differ = (ic != ig).nonzero().flatten()
        d = sfm.sampson_distance(Ec, *on("cpu", x1, x2))
        near = bool(((d[differ] - 1e-4).abs() <= TOL_SFM32_THRESH * 1e-4).all())
        rot = _rot_err(Rc[None], Rg_[None], sfm.so3_log)
        if dtype == torch.float64:
            check(len(differ) == 0 and e_err < 1e-9 and rot < 1e-9,
                  f"RANSAC float64 CPU vs card: {len(differ)} inliers differ, E {e_err:.3e}, "
                  f"rotation {rot:.3e}")
        else:
            check(near and rot < TOL_SFM32_ROT,
                  f"RANSAC float32 CPU vs card: {len(differ)} inliers differ (near thresh: "
                  f"{near}), rotation {rot:.3e}")
        print(f"sfm (a) ransac {tag}: inliers={int(ic.sum())} differ={len(differ)} "
              f"E_abs_up_to_sign={e_err:.3e} rot_rad={rot:.3e}", flush=True)


@contextlib.contextmanager
def _replayed_uniforms(tri_mod, g):
    """RANSAC's draw (``triangulate._hypothesis_uniforms``) returns ``g`` on
    the inputs' device inside the block."""
    orig = tri_mod._hypothesis_uniforms
    tri_mod._hypothesis_uniforms = lambda gen, H, like: g.to(like.device, like.dtype)
    try:
        yield
    finally:
        tri_mod._hypothesis_uniforms = orig


def _count_syncs(fn):
    """(fn(), the host syncs it made): ``set_sync_debug_mode("warn")``'s
    warnings, counted."""
    import warnings
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # the mode's own one-time notice ("... does not yet detect all
    # synchronizing operations") is not a sync
    return out, sum("called a synchronizing" in str(w.message) for w in caught)


def _no_sync(fn):
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")


def _events_ms(fn, reps: int) -> float:
    """Best of ``reps`` calls, CUDA events, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def _sfm_ba_full_width(sfm, bench):
    """(b): the tool's default problem and the capacity, 30 iterations."""
    out = {}
    for name, (C, P, V) in SFM_SIZES:
        rng = np.random.RandomState(0)
        K, Rs, ts, X, prob = bench.make_problem(rng, C, P, V, device="cuda")
        start = bench.perturbed_start(rng, Rs, ts, X)
        M = prob.uv.shape[0]

        def solve():
            return sfm.lm_solve(*start, prob, iters=SFM_ITERS)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        first = _no_sync(solve)                  # the whole solve, no host sync
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        ms = _events_ms(solve, SFM_REPS)
        again = solve()
        same = all(torch.equal(a, b) for a, b in zip(first, again))
        check(same, f"BA {name}: two runs of the same problem differ")
        expect = SFM_SIGMA ** 2 * (2 * M - 6 * C - 3 * P) / 2
        c0, c = float(first.initial_cost), float(first.cost)
        check(abs(c - expect) <= SFM_EXPECT_TOL * expect,
              f"BA {name}: final cost {c} against its expectation {expect}")
        ips = SFM_ITERS / (ms / 1e3)
        out[name] = dict(C=C, P=P, M=M, ms=ms, iters_per_s=ips, obs_per_s=ips * M,
                         initial_cost=c0, final_cost=c, expect=expect, peak_bytes=peak)
        print(f"sfm (b) ba {name}: cams={C} points={P} observations={M} iters={SFM_ITERS} "
              f"solve_ms={ms:.6f} lm_iters_per_s={ips:.6f} obs_per_s={ips * M:.1f} "
              f"initial_cost={c0:.6f} final_cost={c:.6f} expected={expect:.1f} "
              f"({(c - expect) / expect:+.4%}) peak_bytes={peak} U_bytes={P * C * 18 * 4} "
              f"bitwise_repeat={same} host_syncs=0", flush=True)
    return out


def _sfm_tool(card, default):
    """The port's tool as a user runs it, its JSON line read back."""
    tool = os.path.join(os.path.dirname(os.path.abspath(__file__)), "deep3dmap_tpu_torch",
                        "tools", "benchmark_ba.py")
    r = subprocess.run([sys.executable, tool], capture_output=True, text=True, timeout=300)
    check(r.returncode == 0, f"benchmark_ba.py exit {r.returncode}: {r.stderr[-2000:]}")
    line = json.loads(r.stdout.strip().splitlines()[-1])
    want = {"report", "cams", "points", "observations", "lm_iters_per_s", "obs_per_s",
            "initial_cost", "final_cost", "device", "power_limit_w"}
    check(set(line) == want and line["device"] == torch.cuda.get_device_name(0)
          and line["observations"] == default["M"]
          and abs(line["final_cost"] - default["final_cost"]) <= 1e-6 * default["final_cost"],
          f"benchmark_ba.py printed {line}")
    print(f"sfm (b) tool: {json.dumps(line)} card={card!r}", flush=True)


def _shifted_frames(rng, H, W, shift):
    img = rng.rand(H, W)
    pad = np.pad(img, 2)
    img = (sum(pad[dy:dy + H, dx:dx + W] for dy in range(5) for dx in range(5)) / 25.0)
    img = img.astype(np.float32)
    return img, np.roll(img, shift, axis=1)


def _sfm_two_view(sfm):
    """(c): ``match_images`` on two 640x480 frames, RANSAC over 2,048
    correspondences and ``recover_pose``."""
    H, W = SFM_IMG_HW
    img1, img2 = (torch.tensor(a, device="cuda")
                  for a in _shifted_frames(np.random.RandomState(2), H, W, SFM_SHIFT))
    (k1, k2, m), match_syncs = _count_syncs(lambda: sfm.match_images(img1, img2, k=SFM_K))
    sel = m.valid.cpu().numpy()
    dx = k2.xy[m.idx2].cpu().numpy()[sel, 0] - k1.xy.cpu().numpy()[sel, 0]
    share = float(np.mean(np.abs(((dx - SFM_SHIFT) + W // 2) % W - W // 2) <= 1))
    check(sel.sum() >= 50 and share > 0.7, f"match_images: {sel.sum()} matches, "
          f"{share:.3f} recover the shift")
    match_ms = _events_ms(lambda: sfm.match_images(img1, img2, k=SFM_K), 10)

    Hh, N, out_share = SFM_RANSAC
    rng = np.random.RandomState(3)
    K, Rs, *_, uv = _ring_scene(rng, 2, N, 0.0)
    uv2 = uv[N:].copy()
    bad = rng.rand(N) < out_share
    uv2[bad] += rng.randn(bad.sum(), 2) * 40 + 20
    x1 = torch.tensor((uv[:N] - K[0, 2:]) / K[0, :2], dtype=torch.float32, device="cuda")
    x2 = torch.tensor((uv2 - K[1, 2:]) / K[1, :2], dtype=torch.float32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)

    # the inliers vote in recover_pose through its weights: a boolean index
    # would be a host sync of the caller's own
    def two_view():
        E, inl = sfm.essential_ransac(x1, x2, gen, n_hypotheses=Hh, thresh=1e-4)
        return E, inl, sfm.recover_pose(E, x1, x2, inl.to(x1.dtype))
    (E, inl, (R, t)), syncs = _count_syncs(two_view)
    Rt = torch.tensor(Rs[1] @ Rs[0].T, dtype=torch.float32)
    rot_deg = float(np.degrees(_rot_err(R[None], Rt[None], sfm.so3_log)))
    inl_np = inl.cpu().numpy()
    check(rot_deg < 1.0 and inl_np[~bad].mean() > 0.95 and inl_np[bad].mean() < 0.15,
          f"two-view: rotation error {rot_deg:.4f} deg, clean kept {inl_np[~bad].mean():.3f}, "
          f"outliers kept {inl_np[bad].mean():.3f}")
    # which calls sync: eigh at the shapes the two-view path gives it
    eigh_syncs = {}
    for shape in ((Hh, 9, 9), (Hh, 3, 3), (9, 9), (3, 3)):
        A = torch.randn(*shape, device="cuda")
        A = A @ A.transpose(-1, -2)
        eigh_syncs["x".join(map(str, shape))] = _count_syncs(lambda: torch.linalg.eigh(A))[1]
    ransac_ms = _events_ms(lambda: sfm.essential_ransac(x1, x2, gen, n_hypotheses=Hh,
                                                        thresh=1e-4), 10)
    pose_ms = _events_ms(lambda: sfm.recover_pose(E, x1, x2, inl.to(x1.dtype)), 10)
    print(f"sfm (c) two-view: match_images {H}x{W} k={SFM_K} ms={match_ms:.6f} "
          f"matches={int(sel.sum())} shift_share={share:.4f} host_syncs={match_syncs}; "
          f"essential_ransac H={Hh} N={N} outliers={int(bad.sum())} ms={ransac_ms:.6f} "
          f"inliers={int(inl_np.sum())}; recover_pose ms={pose_ms:.6f} rot_err_deg={rot_deg:.6f}; "
          f"host syncs in RANSAC + recover_pose: {syncs} (eigh, 2 + 2 + 1 calls, by shape: "
          f"{eigh_syncs})", flush=True)


def _sfm_pose_graph(sfm, pg_mod):
    """(d): a 64-node noisy odometry chain with 8 loop closures."""
    N, L, iters = SFM_GRAPH
    rng = np.random.RandomState(4)
    loops = [(a, a + N // 2) for a in range(0, N // 2, N // (2 * L))]
    R0, t0, graph = _pose_ring(rng, N, loops=loops)
    R0, t0 = _on("cuda", torch.float32, R0, t0)
    g = pg_mod.PoseGraph(*_on("cuda", torch.float32, *graph))
    R, t, cost, c0 = _no_sync(lambda: sfm.optimize(R0, t0, g, iters=iters))
    check(float(cost) < 0.5 * float(c0), f"pose graph: cost {float(cost)} from {float(c0)}")
    check(torch.equal(R[0], R0[0]) and torch.equal(t[0], t0[0]), "pose graph: the anchor moved")
    ms = _events_ms(lambda: sfm.optimize(R0, t0, g, iters=iters), 3)
    print(f"sfm (d) pose graph: nodes={N} edges={len(graph[0])} loops={L} iters={iters} "
          f"cost {float(c0):.6f} -> {float(cost):.6f} ms_per_iter={ms / iters:.6f} "
          f"host_syncs=0 anchor_unchanged=True", flush=True)


def _sfm_profile(sfm, bench):
    """(e): torch.profiler over ``SFM_PROFILED`` LM iterations of the
    capacity problem."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile
    C, P, V = dict(SFM_SIZES)["capacity"]
    rng = np.random.RandomState(0)
    K, Rs, ts, X, prob = bench.make_problem(rng, C, P, V, device="cuda")
    start = bench.perturbed_start(rng, Rs, ts, X)

    def solve():
        return sfm.lm_solve(*start, prob, iters=SFM_PROFILED)
    # the wall unprofiled (the profiler's own host cost would count as idle)
    wall_ms = _events_ms(solve, SFM_REPS)
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        solve()
        torch.cuda.synchronize()
    ks = device_kernels(prof)
    dev_ms = sum(e.self_device_time_total for e in ks) / 1e3
    top = sorted(ks, key=lambda e: -e.self_device_time_total)[:5]
    launches = sum(e.count for e in ks) / SFM_PROFILED
    print(f"sfm (e) profile: capacity, {SFM_PROFILED} LM iterations: "
          f"launches_per_iter={launches:.1f} device_ms_per_iter={dev_ms / SFM_PROFILED:.6f} "
          f"wall_ms_per_iter={wall_ms / SFM_PROFILED:.6f} (unprofiled, CUDA events) "
          f"busy={dev_ms / wall_ms:.4f}", flush=True)
    for e in top:
        print(f"sfm (e)   {e.self_device_time_total / 1e3 / SFM_PROFILED:10.6f} ms/iter "
              f"{e.self_device_time_total / 1e3 / dev_ms:7.2%} x{e.count // SFM_PROFILED} "
              f"{e.key[:110]}", flush=True)


def phase_sfm(card):
    """Phase 27: the SfM layer on the card (no kernel of the repo)."""
    phase("the SfM layer: CPU vs card (float64, float32); BA at the tool's default and at "
          "capacity; two-view at 640x480; a 64-node pose graph; one profile")
    set_tf32(cudnn=False, matmul=False)
    import importlib
    from deep3dmap_tpu_torch.core import sfm
    from deep3dmap_tpu_torch.tools import benchmark_ba as bench
    ba_mod = importlib.import_module("deep3dmap_tpu_torch.core.sfm.ba")
    pg_mod = importlib.import_module("deep3dmap_tpu_torch.core.sfm.pose_graph")
    tri_mod = importlib.import_module("deep3dmap_tpu_torch.core.sfm.triangulate")
    t0 = time.perf_counter()
    _sfm_cpu_vs_card(sfm, ba_mod, pg_mod, tri_mod)
    ba = _sfm_ba_full_width(sfm, bench)
    _sfm_tool(card, ba["default"])
    _sfm_two_view(sfm)
    _sfm_pose_graph(sfm, pg_mod)
    _sfm_profile(sfm, bench)
    print(f"sfm: phase 27 took {time.perf_counter() - t0:.3f} s card={card!r}", flush=True)


# --------------------------------------------------------------- phase 28 --
# mmdetection's published COCO defaults (configs/_base_/datasets/
# coco_detection.py, the Faster R-CNN test_cfg): img_scale (1333, 800), 80
# classes, test NMS IoU 0.5 with max_per_img 100, proposal_nums (100, 300,
# 1000); COCO's ~7.3 instances an image
DET_CONFIG = os.path.join("configs", "detection", "coco_custom.py")
DET_FIXTURE = dict(n_images=32, img_wh=(640, 480), n_classes=80, mean_boxes=7.3)
DET_TEST_IMAGES = 16
DET_NMS_IOU, DET_MAX_PER_IMG = 0.5, 100
DET_PROPOSALS = (100, 300, 1000)
DET_REPS = 5                  # timed calls per box op (median), after 2 warm-up
DET_PROFILE_REPS = 2          # calls per profiler window (soft_nms: ~8,000 launches a call)
TOL_DET = 1e-5                # scores and IoUs, card against the CPU


def _det_boxes(rs, n, W=1333, H=800):
    """COCO-like xyxy boxes: log-uniform sides from 8 to 400 pixels."""
    wh = np.exp(rs.uniform(np.log(8), np.log(400), (n, 2)))
    xy = rs.uniform(0, 1, (n, 2)) * np.maximum([W, H] - wh, 1)
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def _det_candidates(rs, n, n_objects, W=1333, H=800):
    """``n`` scored detections clustered on ``n_objects`` objects, as a
    detector's raw output is (each object seen by several anchors), the
    rest scattered: boxes, scores, labels over 80 classes."""
    obj = _det_boxes(rs, n_objects, W, H)
    pick = rs.randint(0, n_objects, n)
    size = (obj[pick, 2:] - obj[pick, :2]).repeat(2, 1)
    boxes = obj[pick] + rs.normal(0, 0.08, (n, 4)).astype(np.float32) * size
    stray = rs.rand(n) < 0.2
    boxes[stray] = _det_boxes(rs, int(stray.sum()), W, H)
    labels = rs.randint(0, 80, n_objects)[pick]
    labels[stray] = rs.randint(0, 80, int(stray.sum()))
    return boxes, rs.rand(n).astype(np.float32), labels


def _det_rotated(rs, n, n_objects, W=1333, H=800):
    b, s, _ = _det_candidates(rs, n, n_objects, W, H)
    c, wh = (b[:, :2] + b[:, 2:]) / 2, np.abs(b[:, 2:] - b[:, :2]) + 1
    ang = rs.uniform(-np.pi / 2, np.pi / 2, (n, 1))
    return np.concatenate([c, wh, ang], 1).astype(np.float32), s


def _median_ms(fn, reps=DET_REPS, warmup=2) -> float:
    """Median of ``reps`` calls, CUDA events around each, after ``warmup``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _device_ops(fn, reps: int = 5, pad: int = 128):
    """(launches of one call, its device ms, its top device ops): the CUDA
    events (kernels, copies, memsets) torch.profiler records over ``reps``
    calls, over ``reps``.  Late in a long process a window lost ~56 events
    at its edge (phase 28 of a whole run: 0 of bbox_overlaps' 20), so
    ``pad`` sleep kernels on each side absorb the loss and are left out."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile
    fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(pad):
            torch.cuda._sleep(1)
        for _ in range(reps):
            fn()
        for _ in range(pad):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
    ks = [e for e in device_kernels(prof) if "spin_kernel" not in e.key]
    dev = sum(e.self_device_time_total for e in ks) / 1e3 / reps
    top = sorted(ks, key=lambda e: -e.self_device_time_total)[:3]
    return (sum(e.count for e in ks) / reps, dev,
            [(e.key[:70], e.count / reps, e.self_device_time_total / 1e3 / reps) for e in top])


def _det_keep_equal(name, card_out, cpu_out):
    (dc, kc), (dh, kh) = card_out, cpu_out
    check(torch.equal(kc.cpu(), kh), f"{name}: the card keeps {kc.numel()} boxes, the CPU "
          f"{kh.numel()}, or another order")
    err = float((dc.cpu() - dh).abs().max()) if dh.numel() else 0.0
    check(err <= TOL_DET, f"{name}: dets differ by {err}")
    return err


def _det_ops(bbox):
    """(c): each box op on the card against the port's own CPU run of the
    same inputs, given as tensors on each device (a detector's outputs are
    on the card); ms, launches, syncs, top device ops."""
    rs = np.random.RandomState(28)

    def on(dev, *arrays):
        return [torch.from_numpy(np.asarray(a)).to(dev) for a in arrays]
    cases = []
    ab = (_det_boxes(rs, 5000), _det_boxes(rs, 5000))
    cases.append(("bbox_overlaps 5000x5000", ab, lambda a, b: bbox.bbox_overlaps(a, b), "iou"))
    for n in (1000, 5000):
        cases.append((f"batched_nms {n} boxes 80 classes iou {DET_NMS_IOU}",
                      _det_candidates(rs, n, n // 10),
                      lambda bx, sc, lab: bbox.batched_nms(bx, sc, lab, DET_NMS_IOU), "keep"))
    cand = _det_candidates(rs, 1000, 100)[:2]
    for method in ("linear", "gaussian"):
        cases.append((f"soft_nms {method} 1000", cand, lambda bx, sc, m=method: bbox.soft_nms(
            bx, sc, iou_threshold=0.3, sigma=0.5, min_score=1e-3, method=m), "keep"))
    rb, rsc = _det_rotated(rs, 1000, 100)
    cases.append(("box_iou_rotated 1000x1000", (rb,), lambda b: bbox.box_iou_rotated(b, b), "iou"))
    cases.append(("nms_rotated 1000", (rb, rsc),
                  lambda b, sc: bbox.nms_rotated(b, sc, DET_NMS_IOU), "keep"))
    out = {}
    for name, arrays, fn, kind in cases:
        host = fn(*on("cpu", *arrays))
        args = on("cuda", *arrays)
        fn(*args)                 # warm-up: the allocator's first growth
        torch.cuda.synchronize()
        card, syncs = _count_syncs(lambda: fn(*args))
        torch.cuda.synchronize()
        if kind == "iou":
            err = float((card.cpu() - host).abs().max())
            check(err <= TOL_DET, f"{name}: IoUs differ by {err}")
            what = f"max_abs_err={err:.3e}"
        else:
            err = _det_keep_equal(name, card, host)
            what = f"kept={host[1].numel()} keep_sets_equal=True max_abs_err={err:.3e}"
        ms = _median_ms(lambda: fn(*args))
        launches, dev_ms, top = _device_ops(lambda: fn(*args), reps=DET_PROFILE_REPS)
        out[name] = dict(ms=ms, launches=launches, syncs=syncs, device_ms=dev_ms)
        print(f"det (c) {name}: ms={ms:.6f} (median of {DET_REPS}, CUDA events) "
              f"launches={launches:g} device_ms={dev_ms:.6f} host_syncs={syncs} {what}", flush=True)
        for key, count, t in top:
            print(f"det (c)   {t:10.6f} ms x{count:g} {key}", flush=True)
    return out


def _det_train(card, cfg, ann, builder):
    """(a): CustomDataset from the config through build_dataset and
    build_dataloader (GroupSampler from ``flag``), uploaded with
    prefetch_to_device."""
    from deep3dmap_tpu_torch.datasets.samplers import GroupSampler
    ds = builder.build_dataset(dict(cfg.data["train"], ann_file=ann))
    check(len(ds) == DET_FIXTURE["n_images"] and len(ds.flag) == len(ds),
          f"CustomDataset: {len(ds)} images")
    # the uploaded sample is the host pipeline's, bit for bit: a second
    # dataset from the same config (its transforms' own generators fresh)
    ref = builder.build_dataset(dict(cfg.data["train"], ann_file=ann))
    np.random.seed(0)
    host = ref[0]
    np.random.seed(0)
    up = builder.upload_batch(builder._stack_samples([ds[0]]), "cuda")
    check(torch.equal(up["img"][0].cpu(), torch.from_numpy(host["img"]))
          and torch.equal(up["gt_bboxes"][0].cpu(), torch.from_numpy(host["gt_bboxes"])),
          "the uploaded sample differs from the host pipeline's")
    loader = builder.build_dataloader(ds, samples_per_gpu=cfg.data["samples_per_gpu"],
                                      workers_per_gpu=cfg.data["workers_per_gpu"], seed=0)
    check(isinstance(loader.sampler, GroupSampler), f"sampler {type(loader.sampler)}")
    np.random.seed(0)
    ok = torch.ones((), dtype=torch.bool, device="cuda")
    n, boxes, flips = 0, 0, 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for batch in builder.prefetch_to_device(loader, "cuda"):
        img = batch["img"]
        ok &= torch.isfinite(img).all()
        check(img.device.type == "cuda" and tuple(img.shape) == (1, 800, 1344, 3)
              and img.dtype == torch.float32, f"train batch img {tuple(img.shape)} {img.dtype}")
        n += img.shape[0]
        boxes += batch["gt_bboxes"].shape[1]
        flips += int(batch["flipped"].sum())
    torch.cuda.synchronize()
    took = time.perf_counter() - t0
    check(bool(ok) and n == len(ds), f"train path: {n} samples, finite {bool(ok)}")
    print(f"det (a) train: CustomDataset {n} images {DET_FIXTURE['img_wh'][0]}x"
          f"{DET_FIXTURE['img_wh'][1]} -> (1, 800, 1344, 3) float32 on the card, {boxes} boxes "
          f"after AutoAugment, {flips} flipped, loader threads "
          f"{cfg.data['workers_per_gpu']}: ms_per_sample={took / n * 1e3:.3f} "
          f"(host wall, prefetch_to_device, synced at the end) card={card!r}", flush=True)
    return ds


def _det_transform_ms(card, ds, n: int = 8):
    """(a): where a train sample's host time goes: each transform of the
    pipeline timed alone on ``n`` samples, in this thread."""
    totals = {}
    for i in range(n):
        data = dict(img_info=ds.data_infos[i], ann_info=ds.get_ann_info(i))
        ds.pre_pipeline(data)
        for j, t in enumerate(ds.pipeline.transforms):
            t0 = time.perf_counter()
            data = t(data)
            key = f"{j}:{type(t).__name__}"
            totals[key] = totals.get(key, 0.0) + time.perf_counter() - t0
            check(data is not None, f"{key} dropped sample {i}")
    total = sum(totals.values()) / n * 1e3
    parts = ", ".join(f"{k} {v / n * 1e3:.3f}" for k, v in totals.items())
    print(f"det (a) per transform, ms a sample (host wall, one thread, {n} samples, "
          f"sum {total:.3f}): {parts} card={card!r}", flush=True)


def _det_test(card, cfg, ann, builder):
    """(b): MultiScaleFlipAug (two scales, flip) through the loader."""
    ds = builder.build_dataset(dict(cfg.data["test"], ann_file=ann))
    loader = builder.build_dataloader(ds, samples_per_gpu=cfg.data["samples_per_gpu"],
                                      workers_per_gpu=cfg.data["workers_per_gpu"], shuffle=False)
    n = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for batch in builder.prefetch_to_device(loader, "cuda"):
        imgs, flips = batch["img"], [bool(f[0]) for f in batch["flip"]]
        check(len(imgs) == 4 and all(tuple(i.shape) == (1, 800, 1344, 3) for i in imgs)
              and flips == [False, True, False, True],
              f"test batch: {[tuple(i.shape) for i in imgs]} flips {flips}")
        n += 1
        if n == DET_TEST_IMAGES:
            break
    torch.cuda.synchronize()
    took = time.perf_counter() - t0
    print(f"det (b) test: MultiScaleFlipAug scales (1333, 800), (666, 400) x flip: {n} images, "
          f"4 copies each at (1, 800, 1344, 3) (JAX's Resize ignores the scale key): "
          f"ms_per_sample={took / n * 1e3:.3f} card={card!r}", flush=True)
    return ds


def _det_results(bbox, ds, device, jitter):
    """Per-image per-class detections from the fixture's GT: with
    ``jitter``, 10 jittered copies of each GT box and 200 false positives
    through ``batched_nms`` on ``device``, the top 100 kept; else the GT
    with score 1.  Also per-image proposals (for recall)."""
    rs = np.random.RandomState(7)
    results, proposals = [], []
    for i in range(len(ds)):
        ann = ds.get_ann_info(i)
        gt, lab = ann["bboxes"], np.asarray(ann["labels"])
        if not jitter:
            dets = np.concatenate([gt, np.ones((len(gt), 1), np.float32)], 1)
            labels = lab
        else:
            size = (gt[:, 2:] - gt[:, :2]).repeat(2, 1)
            cand = (np.repeat(gt, 10, 0) + rs.normal(0, 0.06, (10 * len(gt), 4))
                    * np.repeat(size, 10, 0)).astype(np.float32)
            fp = _det_boxes(rs, 200, 640, 480)
            boxes = np.concatenate([cand, fp])
            scores = np.concatenate([rs.uniform(0.3, 1.0, len(cand)),
                                     rs.uniform(0.0, 0.6, 200)]).astype(np.float32)
            labels = np.concatenate([np.repeat(lab, 10), rs.randint(0, 80, 200)])
            d, keep = bbox.batched_nms(boxes, scores, labels, DET_NMS_IOU, device=device)
            d, keep = d[:DET_MAX_PER_IMG].cpu().numpy(), keep[:DET_MAX_PER_IMG].cpu().numpy()
            dets, labels = d, labels[keep]
            # proposals: class-agnostic, 1000 a frame
            props = np.concatenate([boxes, scores[:, None]], 1)
            proposals.append(np.concatenate([props, np.concatenate(
                [_det_boxes(rs, 1000 - len(props), 640, 480), rs.rand(1000 - len(props), 1) * 0.3],
                1)]).astype(np.float32))
        results.append([dets[labels == c] for c in range(80)])
    return results, proposals


def _det_eval(card, bbox, ds):
    """(d): mAP at IoU 0.5 and 0.75 and recall at (100, 300, 1000)."""
    perfect, _ = _det_results(bbox, ds, "cuda", jitter=False)
    t0 = time.perf_counter()
    ev = ds.evaluate(perfect, metric="mAP", iou_thr=[0.5, 0.75])
    perfect_s = time.perf_counter() - t0
    check(ev["mAP"] == 1.0, f"perfect detections: {ev}")
    card_res, props = _det_results(bbox, ds, "cuda", jitter=True)
    cpu_res, _ = _det_results(bbox, ds, "cpu", jitter=True)
    t0 = time.perf_counter()
    ev_card = ds.evaluate(card_res, metric="mAP", iou_thr=[0.5, 0.75])
    map_s = time.perf_counter() - t0
    ev_cpu = ds.evaluate(cpu_res, metric="mAP", iou_thr=[0.5, 0.75])
    check(ev_card == ev_cpu, f"jittered mAP: card {ev_card}, CPU {ev_cpu}")
    check(0.2 < ev_card["mAP"] < 1.0, f"jittered mAP {ev_card}")
    t0 = time.perf_counter()
    rec = ds.evaluate(props, metric="recall", proposal_nums=DET_PROPOSALS, iou_thr=[0.5, 0.75])
    rec_s = time.perf_counter() - t0
    check(all(0 < v <= 1 for v in rec.values()), f"recall {rec}")
    print(f"det (d) eval: {len(ds)} images, perfect mAP {ev['mAP']} "
          f"({perfect_s:.4f} s); jittered after batched_nms on the card "
          f"(top {DET_MAX_PER_IMG}): {json.dumps({k: float(v) for k, v in ev_card.items()})} "
          f"equal to the CPU's; s_per_eval mAP={map_s:.4f} "
          f"recall={rec_s:.4f}; recall {json.dumps({k: float(v) for k, v in rec.items()})} "
          f"card={card!r}", flush=True)


def phase_detection(card, work):
    """Phase 28: the detection data path (no kernel of the repo)."""
    phase("the detection data path: CustomDataset at COCO scale, the train and test pipelines, "
          "the box ops against the CPU, mAP and recall")
    from deep3dmap_tpu_torch.datasets import builder
    from deep3dmap_tpu_torch.datasets.synthetic import write_detection_fixture
    from deep3dmap_tpu_torch.ops import bbox
    from deep3dmap_tpu_torch.utils.config import Config
    t0 = time.perf_counter()
    cfg = Config.fromfile(os.path.join(os.path.dirname(os.path.abspath(__file__)), DET_CONFIG))
    ann = write_detection_fixture(os.path.join(work, "detection"), **DET_FIXTURE)
    fixture_s = time.perf_counter() - t0
    ds = _det_train(card, cfg, ann, builder)
    _det_transform_ms(card, ds)
    _det_test(card, cfg, ann, builder)
    ops = _det_ops(bbox)
    _det_eval(card, bbox, ds)
    print(f"det: phase 28 took {time.perf_counter() - t0:.3f} s (fixture {fixture_s:.3f} s) "
          f"card={card!r}", flush=True)
    return ops


# --------------------------------------------------------------- phase 29 --
# The op zoo at the sizes of the published models that use each op
# (mmdetection / mmdetection3d / mmcv configs named in each case's label).
ZOO_REPS = 3                  # timed calls per op (median), after 2 warm-up
ZOO_HOST_REPS = 3             # for the host ops (numpy breadth-first searches),
                              # warmed by the comparison's call
# calls per profiler window, and sleep kernels on each side of it: late in
# the whole run a window of one call with 128 of them lost every event of
# some ops (launches 0 where 83 were made)
ZOO_PROFILE_REPS, ZOO_PROFILE_PAD = 3, 1024
TOL_ZOO, TOL_ZOO_GRAD = 1e-4, 1e-3   # relative to the largest |CPU value|
ZOO_SEED = 29
# mask_rcnn_r50_fpn_1x_coco: P2 of a 1333x800 batch padded to 32, stride 4;
# the R-CNN sampler's 512 RoIs an image
ZOO_P2, ZOO_ROIS = (2, 256, 200, 336), 1024
# Deformable DETR's encoder: strides 8/16/32/64 of 1333x800
ZOO_MSDA_SHAPES = ((100, 167), (50, 84), (25, 42), (13, 21))
# PointPillars (hv_pointpillars_secfpn_6x8_160e_kitti-3d-3class) and
# dv_second_secfpn_6x8_80e_kitti-3d-car
ZOO_PP_VOXEL, ZOO_PP_RANGE = (0.16, 0.16, 4.0), (0.0, -39.68, -3.0, 69.12, 39.68, 1.0)
ZOO_DV_VOXEL, ZOO_DV_RANGE = (0.05, 0.05, 0.1), (0.0, -40.0, -3.0, 70.4, 40.0, 1.0)
ZOO_LIDAR_POINTS = 120_000


def _zoo_leaves(out):
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (tuple, list)) and out and all(isinstance(o, torch.Tensor) for o in out):
        return list(out)
    return None


def _zoo_rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    if b.numel() == 0:
        return 0.0
    return float((a - b).abs().max() / max(float(b.abs().max()), 1e-30))


def _zoo_tree_rel(card, host):
    """Gradients as one vector: (max difference over the largest |host
    value|, the worst leaf by its own scale, that leaf's error)."""
    scale = max(float(v.abs().max()) for v in host.values())
    err = max(float((card[k].double() - host[k].double()).abs().max()) for k in host) / scale
    leaf = max(host, key=lambda k: _zoo_rel(card[k], host[k]))
    return err, leaf, _zoo_rel(card[leaf], host[leaf])


def _zoo_call(fn, args, grads, cot=None):
    """``fn(*args)``; with ``grads`` (argument positions), the first output's
    backward under ``cot`` (seeded when None).  -> (outputs, gradients)."""
    args = [a.detach().requires_grad_() if i in grads else a for i, a in enumerate(args)]
    out = fn(*args)
    gs = []
    if grads:
        first = out if isinstance(out, torch.Tensor) else out[0]
        if cot is None:
            cot = torch.randn(first.shape, generator=torch.Generator().manual_seed(ZOO_SEED))
        first.backward(cot.to(first.device))
        gs = [args[i].grad for i in grads]
        out = [o.detach() for o in _zoo_leaves(out)]
    return out, gs


def _zoo_compare(name, card, host):
    """Index outputs equal, float outputs within TOL_ZOO relative; host
    results (lists) equal.  -> the worst relative error."""
    cl, hl = _zoo_leaves(card), _zoo_leaves(host)
    if cl is None:
        check(card == host, f"zoo {name}: the card's inputs give another result than the CPU's")
        return 0.0
    check(len(cl) == len(hl), f"zoo {name}: {len(cl)} outputs on the card, {len(hl)} on the CPU")
    worst = 0.0
    for i, (c, h) in enumerate(zip(cl, hl)):
        check(c.shape == h.shape and c.dtype == h.dtype,
              f"zoo {name}: output {i} is {tuple(c.shape)} {c.dtype} on the card, "
              f"{tuple(h.shape)} {h.dtype} on the CPU")
        if c.is_floating_point():
            err = _zoo_rel(c, h)
            check(err <= TOL_ZOO, f"zoo {name}: output {i} differs by {err:.3e} relative")
            worst = max(worst, err)
        else:
            check(torch.equal(c.cpu(), h), f"zoo {name}: index output {i} differs "
                  f"({int((c.cpu() != h).sum())} of {h.numel()} values)")
    return worst


def _zoo_peak(fn) -> int:
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del out
    return int(peak)


def _zoo_case(name, shapes, fn, args, grads=(), cut=None, cut_desc="none", reps=ZOO_REPS,
              warmup=2):
    """One op: the card against the port's CPU run of the same function on
    the same inputs (or on ``cut(args)``, the same cut on both), forward and
    the gradients of ``grads``; then at full size: ms per call (forward, and
    forward plus backward), launches, device ms and top device ops of one
    call, host syncs of one call, peak bytes."""
    t0 = time.perf_counter()
    cmp_args = cut(args) if cut is not None else args
    host_args = [a.cpu() if isinstance(a, torch.Tensor) else a for a in cmp_args]
    host, host_g = _zoo_call(fn, host_args, grads)
    cpu_s = time.perf_counter() - t0
    card, card_g = _zoo_call(fn, cmp_args, grads)
    err = _zoo_compare(name, card, host)
    gerr = 0.0
    for i, (c, h) in enumerate(zip(card_g, host_g)):
        e = _zoo_rel(c, h)
        check(e <= TOL_ZOO_GRAD, f"zoo {name}: gradient {i} differs by {e:.3e} relative")
        gerr = max(gerr, e)
    del card, card_g, host, host_g
    call = lambda: fn(*args)              # noqa: E731
    ms = _median_ms(call, reps=reps, warmup=warmup)
    _, syncs = _count_syncs(call)
    launches, dev_ms, top = _device_ops(call, reps=ZOO_PROFILE_REPS, pad=ZOO_PROFILE_PAD)
    peak = _zoo_peak(call)
    bwd = ""
    if grads:
        leaves = [a.detach().requires_grad_() if i in grads else a for i, a in enumerate(args)]
        first = fn(*leaves)
        first = first if isinstance(first, torch.Tensor) else first[0]
        cot = torch.randn(first.shape, device="cuda")
        del first

        def step():
            for i in grads:
                leaves[i].grad = None
            out = fn(*leaves)
            (out if isinstance(out, torch.Tensor) else out[0]).backward(cot)
        fb_ms = _median_ms(step, reps=ZOO_REPS)
        fb_peak = _zoo_peak(step)
        bwd = f" fwd_bwd_ms={fb_ms:.6f} fwd_bwd_peak_bytes={fb_peak} grad_rel_err={gerr:.3e}"
        del leaves, cot
    print(f"zoo {name}: {shapes}; cut={cut_desc} fwd_ms={ms:.6f} (median of {reps} after "
          f"{warmup} warm-up, "
          f"CUDA events) launches={launches:g} device_ms={dev_ms:.6f} host_syncs={syncs} "
          f"peak_bytes={peak} max_rel_err={err:.3e}{bwd} cpu_s={cpu_s:.3f} "
          f"wall_s={time.perf_counter() - t0:.3f}", flush=True)
    for key, count, t in top:
        print(f"zoo   {t:10.6f} ms x{count:g} {key}", flush=True)
    return dict(ms=ms, launches=launches, syncs=syncs, device_ms=dev_ms, peak=peak)


def _zoo_boxes(g, n, W, H, lo=16.0, hi=512.0):
    """xyxy boxes with log-uniform sides in [lo, hi] pixels, centred in the
    image."""
    wh = torch.exp(torch.empty(n, 2, device="cuda").uniform_(np.log(lo), np.log(hi), generator=g))
    c = torch.rand(n, 2, device="cuda", generator=g) * torch.tensor([W, H], device="cuda")
    return torch.cat([c - wh / 2, c + wh / 2], 1)


def _zoo_detection(ops, g):
    """Two-stage heads, DCNv2, Deformable DETR, CARAFE, masked conv and the
    dense-prediction ops."""
    N, C, H, W = ZOO_P2
    feat = torch.randn(ZOO_P2, device="cuda", generator=g)
    half = ZOO_ROIS // 2
    b = torch.arange(ZOO_ROIS, device="cuda") // half
    rois = torch.cat([b[:, None].float(), _zoo_boxes(g, ZOO_ROIS, 1333, 800)], 1)
    cut_rois = lambda a: [a[0], torch.cat([a[1][:64], a[1][half:half + 64]])] + a[2:]  # noqa: E731
    heads = f"P2 {tuple(ZOO_P2)}, {ZOO_ROIS} RoIs (512 an image), scale 1/4, out 7x7"
    _zoo_case("roi_align (mask_rcnn_r50_fpn_1x_coco)", heads + ", sampling 0, aligned",
              lambda f, r: ops.roi_align(f, r, 7, 0.25, 0, True), [feat, rois], grads=(0,),
              cut=cut_rois, cut_desc="128 RoIs")
    _zoo_case("roi_pool", heads, lambda f, r: ops.roi_pool(f, r, 7, 0.25), [feat, rois],
              grads=(0,), cut=cut_rois, cut_desc="128 RoIs")
    xyxy = rois[:, 1:]
    rrois = torch.cat([b[:, None].float(), (xyxy[:, :2] + xyxy[:, 2:]) / 2, xyxy[:, 2:] - xyxy[:, :2],
                       (torch.rand(ZOO_ROIS, 1, device="cuda", generator=g) - 0.5) * np.pi], 1)
    _zoo_case("roi_align_rotated", heads + ", sampling 2",
              lambda f, r: ops.roi_align_rotated(f, r, 7, 0.25, 2, True), [feat, rrois],
              grads=(0,), cut=cut_rois, cut_desc="128 RoIs")
    off = torch.randn(ZOO_ROIS, 2, 7, 7, device="cuda", generator=g) * 0.1
    _zoo_case("deform_roi_pool (faster_rcnn_r50_fpn_dpool_1x_coco)", heads + ", gamma 0.1",
              lambda f, r, o: ops.deform_roi_pool(f, r, o, 7, 0.25, 2, 0.1), [feat, rois, off],
              grads=(0, 2), cut=lambda a: [a[0], torch.cat([a[1][:64], a[1][half:half + 64]]),
                                          torch.cat([a[2][:64], a[2][half:half + 64]])],
              cut_desc="128 RoIs")
    del feat, rois, rrois, off

    # DCNv2 in mask_rcnn_r50_fpn_mdconv_c3-c5_1x_coco: 3x3, one deform group
    for ch, (h, w) in ((128, (100, 168)), (256, (50, 84))):
        x = torch.randn(2, ch, h, w, device="cuda", generator=g)
        offset = torch.randn(2, 18, h, w, device="cuda", generator=g)
        mask = torch.rand(2, 9, h, w, device="cuda", generator=g)
        wt = torch.randn(ch, ch, 3, 3, device="cuda", generator=g) * (2 / (9 * ch)) ** 0.5
        bias = torch.randn(ch, device="cuda", generator=g) * 0.1
        crop = lambda a: [t[:1, :, :24, :40] for t in a[:3]] + a[3:]  # noqa: E731
        _zoo_case(f"modulated_deform_conv2d {ch}->{ch}", f"x (2, {ch}, {h}, {w}), 3x3, pad 1, dg 1",
                  lambda x_, o, m, w_, b_: ops.modulated_deform_conv2d(x_, o, m, w_, b_, padding=1),
                  [x, offset, mask, wt, bias], grads=(0, 1, 2, 3, 4), cut=crop,
                  cut_desc="B 1, a 24x40 crop")
        if ch == 256:
            _zoo_case("deform_conv2d 256->256", f"x (2, 256, {h}, {w}), 3x3, pad 1, dg 1",
                      lambda x_, o, w_: ops.deform_conv2d(x_, o, w_, padding=1),
                      [x, offset, wt], grads=(0, 1, 2),
                      cut=lambda a: [t[:1, :, :24, :40] for t in a[:2]] + a[2:],
                      cut_desc="B 1, a 24x40 crop")
        del x, offset, mask, wt, bias

    # Deformable DETR's encoder: d_model 256, 8 heads, 4 levels, 4 points
    lv = sum(hh * ww for hh, ww in ZOO_MSDA_SHAPES)
    starts = np.cumsum([0] + [hh * ww for hh, ww in ZOO_MSDA_SHAPES[:-1]]).tolist()
    value = torch.randn(2, lv, 8, 32, device="cuda", generator=g)
    loc = torch.rand(2, lv, 8, 4, 4, 2, device="cuda", generator=g)
    attn = torch.softmax(torch.randn(2, lv, 8, 16, device="cuda", generator=g), -1).reshape(
        2, lv, 8, 4, 4)
    _zoo_case("ms_deform_attn (Deformable DETR encoder)",
              f"value (2, {lv}, 8, 32), {lv} queries, levels {ZOO_MSDA_SHAPES}, 4 points",
              lambda v, l_, a: ops.ms_deform_attn(v, ZOO_MSDA_SHAPES, starts, l_, a),
              [value, loc, attn], grads=(0, 1, 2),
              cut=lambda a: [a[0][:1], a[1][:1, :2048], a[2][:1, :2048]],
              cut_desc="B 1, 2048 queries")
    del value, loc, attn

    # faster_rcnn_r50_fpn_carafe_1x_coco's upsampler: k 5, group 1, scale 2
    f = torch.randn(2, 256, 100, 168, device="cuda", generator=g)
    m = torch.softmax(torch.randn(2, 25, 200, 336, device="cuda", generator=g), 1)
    _zoo_case("carafe (faster_rcnn_r50_fpn_carafe_1x_coco)", "(2, 256, 100, 168) -> 200x336, k 5",
              lambda a, b_: ops.carafe(a, b_, 5, 1, 2), [f, m], grads=(0, 1),
              cut=lambda a: [a[0][:1, :, :25, :42], a[1][:1, :, :50, :84]],
              cut_desc="B 1, a 25x42 crop")
    del f, m
    # GA-RPN's masked conv: 3x3, 256 channels, a third of the mask set
    x = torch.randn(2, 256, 200, 336, device="cuda", generator=g)
    mk = (torch.rand(2, 200, 336, device="cuda", generator=g) < 1 / 3).float()
    wt = torch.randn(256, 256, 3, 3, device="cuda", generator=g) * (2 / (9 * 256)) ** 0.5
    bias = torch.randn(256, device="cuda", generator=g) * 0.1
    _zoo_case("masked_conv2d (ga_rpn)", "(2, 256, 200, 336), 3x3, a third masked in",
              lambda a, mm, w_, b_: ops.masked_conv2d(a, mm, w_, b_, 1), [x, mk, wt, bias],
              grads=(0, 2), cut=lambda a: [a[0][:1, :, :48, :64], a[1][:1, :48, :64]] + a[2:],
              cut_desc="B 1, a 48x64 crop")
    del x, mk, wt, bias

    # PWC-Net's correlation: 1/4 of a 384x448 crop, 32 channels, B 8
    a1 = torch.randn(8, 32, 96, 112, device="cuda", generator=g)
    a2 = torch.randn(8, 32, 96, 112, device="cuda", generator=g)
    _zoo_case("correlation (PWC-Net)", "(8, 32, 96, 112), max displacement 4, kernel 1",
              lambda p, q: ops.correlation(p, q, 1, 4), [a1, a2], grads=(0, 1),
              cut=lambda a: [t[:2] for t in a], cut_desc="B 2")
    del a1, a2
    # PSANet: mask 97x97 at 1/8 of 512x1024
    psa = torch.randn(2, 97 * 97, 64, 128, device="cuda", generator=g)
    for kind in ("collect", "distribute"):
        _zoo_case(f"psamask {kind} (PSANet)", "(2, 9409, 64, 128) -> (2, 8192, 64, 128)",
                  lambda p, k=kind: ops.psamask(p, k, 97, 97), [psa],
                  cut=lambda a: [a[0][:1]], cut_desc="B 1")
    del psa
    # CornerNet's corner pool: 128x128, 256 channels
    cp = torch.randn(2, 256, 128, 128, device="cuda", generator=g)
    for mode in ("top", "bottom", "left", "right"):
        _zoo_case(f"corner_pool {mode} (CornerNet)", "(2, 256, 128, 128)",
                  lambda p, md=mode: ops.corner_pool(p, md), [cp])
    del cp
    # TIN: 8 segments, shift_div 4 (a quarter of ResNet-50's 256 channels
    # at 56x56 shifted, in 2 groups)
    x = torch.randn(4, 8, 64, 56 * 56, device="cuda", generator=g)
    shift = torch.randint(-3, 4, (4, 2), device="cuda", generator=g)
    _zoo_case("tin_shift (TIN)", "(4, 8, 64, 3136), 2 groups", lambda p, s: ops.tin_shift(p, s),
              [x, shift])
    del x, shift
    # BorderDet's border align at P3 (stride 8) of 1333x800, 256 channels,
    # pool 10, 1,000 boxes an image
    inp = torch.randn(2, 1024, 100, 168, device="cuda", generator=g)
    bx = torch.stack([_zoo_boxes(g, 1000, 168, 100, 2, 64) for _ in range(2)])
    _zoo_case("border_align (BorderDet)", "(2, 1024, 100, 168), 1000 boxes an image, pool 10",
              lambda p, q: ops.border_align(p, q, 10), [inp, bx], grads=(0,),
              cut=lambda a: [a[0], a[1][:, :200]], cut_desc="200 boxes an image")
    del inp, bx


def _zoo_loss_and_points(ops, g):
    # RetinaNet: 9 anchors a location on P3-P7 of 1333x800, 2 images, 80
    # classes; most anchors background (class id 80)
    n = 2 * 9 * sum(h * w for h, w in ((100, 168), (50, 84), (25, 42), (13, 21), (7, 11)))
    pred = torch.randn(n, 80, device="cuda", generator=g) * 2
    tgt = torch.where(torch.rand(n, device="cuda", generator=g) < 0.02,
                      torch.randint(0, 80, (n,), device="cuda", generator=g), 80)
    num_pos = 0.02 * n
    cut = lambda a: [a[0][:100_800], a[1][:100_800]]  # noqa: E731
    _zoo_case("sigmoid_focal_loss (retinanet_r50_fpn_1x_coco)", f"({n}, 80), avg_factor {num_pos:g}",
              lambda p, t: ops.sigmoid_focal_loss(p, t, avg_factor=num_pos), [pred, tgt],
              grads=(0,), cut=cut, cut_desc="100800 anchors")
    pred = torch.randn(n, 81, device="cuda", generator=g) * 2
    _zoo_case("softmax_focal_loss", f"({n}, 81)",
              lambda p, t: ops.softmax_focal_loss(p, t, avg_factor=num_pos), [pred, tgt],
              grads=(0,), cut=cut, cut_desc="100800 anchors")
    del pred, tgt

    # pointnet2_ssg on ScanNet segmentation: 8,192 points a 1.5 x 1.5 x 3 m
    # block, B 16; SA1: 1,024 centres, radius 0.1, 32 samples
    B, N, S = 16, 8192, 1024
    xyz = torch.rand(B, N, 3, device="cuda", generator=g) * torch.tensor([1.5, 1.5, 3.0],
                                                                        device="cuda")
    b2 = lambda a: [t[:2] if isinstance(t, torch.Tensor) else t for t in a]  # noqa: E731
    _zoo_case("furthest_point_sample (pointnet2_ssg)", f"({B}, {N}, 3) -> {S}",
              lambda p: ops.furthest_point_sample(p, S), [xyz], cut=b2, cut_desc="B 2")
    idx = ops.furthest_point_sample(xyz, S)
    new_xyz = xyz[torch.arange(B, device="cuda")[:, None], idx]
    _zoo_case("ball_query", f"{S} centres in ({B}, {N}, 3), r 0.1, 32 samples",
              lambda p, q: ops.ball_query(0.1, 32, p, q), [xyz, new_xyz], cut=b2, cut_desc="B 2")
    grp = ops.ball_query(0.1, 32, xyz, new_xyz)
    feats = torch.cat([xyz, torch.rand(B, N, 3, device="cuda", generator=g)], -1).transpose(1, 2)
    feats = feats.contiguous()
    _zoo_case("gather_points", f"({B}, 6, {N}) at {S}", lambda f, i: ops.gather_points(f, i),
              [feats, idx], grads=(0,))
    _zoo_case("group_points", f"({B}, 6, {N}) at ({B}, {S}, 32)",
              lambda f, i: ops.group_points(f, i), [feats, grp], grads=(0,))
    _zoo_case("knn", f"k 16, {S} queries in ({B}, {N}, 3)", lambda p, q: ops.knn(16, p, q),
              [xyz, new_xyz], cut=b2, cut_desc="B 2")
    _zoo_case("three_nn (FP1)", f"({B}, {N}, 3) in ({B}, {S}, 3)", lambda u, k: ops.three_nn(u, k),
              [xyz, new_xyz], cut=b2, cut_desc="B 2")
    nn_idx, w = ops.three_interpolate_weights(xyz, new_xyz)
    f128 = torch.randn(B, 128, S, device="cuda", generator=g)
    _zoo_case("three_interpolate (FP1)", f"({B}, 128, {S}) -> {N}",
              lambda f, i, ww: ops.three_interpolate(f, i, ww), [f128, nn_idx, w], grads=(0, 2))
    del xyz, new_xyz, idx, grp, feats, nn_idx, w, f128


def _zoo_lidar(ops, g):
    """KITTI-like points: uniform over and around the range, 5% in a 0.3 m
    cluster (voxels past ``max_points``)."""
    n = ZOO_LIDAR_POINTS
    lo = torch.tensor([-5.0, -45.0, -3.5, 0.0], device="cuda")
    hi = torch.tensor([75.0, 45.0, 1.5, 1.0], device="cuda")
    pts = lo + (hi - lo) * torch.rand(n, 4, device="cuda", generator=g)
    k = n // 20
    pts[:k, :3] = torch.tensor([10.0, 0.0, -1.0], device="cuda") + 0.3 * torch.rand(
        k, 3, device="cuda", generator=g)
    for mv in (16000, 40000):
        _zoo_case(f"voxelize (hv_pointpillars_secfpn_6x8_160e_kitti-3d-3class) max_voxels {mv}",
                  f"({n}, 4), voxel {ZOO_PP_VOXEL}, 32 points a voxel",
                  lambda p, m=mv: ops.voxelize(p, ZOO_PP_VOXEL, ZOO_PP_RANGE, 32, m), [pts])
    vs = torch.tensor(ZOO_DV_VOXEL, device="cuda")
    rlo = torch.tensor(ZOO_DV_RANGE[:3], device="cuda")
    grid = torch.round((torch.tensor(ZOO_DV_RANGE[3:], device="cuda") - rlo) / vs)
    c = torch.floor((pts[:, :3] - rlo) / vs)
    inside = ((c >= 0) & (c < grid)).all(1, keepdim=True)
    coors = torch.where(inside, c, -1.0).flip(1).int()                 # zyx, -1 outside
    f64 = torch.randn(n, 64, device="cuda", generator=g)
    for op, feats in (("mean", pts), ("max", f64)):
        _zoo_case(f"dynamic_scatter {op} (dv_second_secfpn_6x8_80e_kitti-3d-car)",
                  f"({n}, {feats.shape[1]}), voxel {ZOO_DV_VOXEL}, capacity {n}",
                  lambda f, cc, o=op: ops.dynamic_scatter(f, cc, o, n), [feats, coors],
                  grads=(0,))
    boxes = torch.cat([torch.rand(50, 2, device="cuda", generator=g)
                       * torch.tensor([60.0, 70.0], device="cuda") + torch.tensor(
                           [5.0, -35.0], device="cuda"),
                       torch.full((50, 1), -1.7, device="cuda"),
                       torch.tensor([3.9, 1.6, 1.56], device="cuda") * (
                           0.8 + 0.4 * torch.rand(50, 3, device="cuda", generator=g)),
                       (torch.rand(50, 1, device="cuda", generator=g) - 0.5) * 2 * np.pi], 1)
    _zoo_case("points_in_boxes", f"(1, {n}, 3), 50 boxes",
              lambda p, bb: ops.points_in_boxes(p, bb), [pts[None, :, :3].contiguous(), boxes[None]])
    del pts, coors, f64

    # 1,000 KITTI car boxes for the IoUs and NMS
    bx = torch.cat([torch.rand(1000, 2, device="cuda", generator=g)
                    * torch.tensor([70.0, 80.0], device="cuda") - torch.tensor([0.0, 40.0],
                                                                               device="cuda"),
                    torch.full((1000, 1), -1.0, device="cuda"),
                    torch.tensor([3.9, 1.6, 1.56], device="cuda") * (
                        0.8 + 0.4 * torch.rand(1000, 3, device="cuda", generator=g)),
                    (torch.rand(1000, 1, device="cuda", generator=g) - 0.5) * 2 * np.pi], 1)
    bx[500:, :2] = bx[:500, :2] + 0.5 * torch.randn(500, 2, device="cuda", generator=g)
    sc = torch.rand(1000, device="cuda", generator=g)
    first = lambda a: [t[:500] for t in a]  # noqa: E731
    _zoo_case("boxes_iou_bev", "1000 x 1000", lambda a: ops.boxes_iou_bev(a, a), [bx],
              cut=first, cut_desc="500 boxes")
    _zoo_case("boxes_iou3d", "1000 x 1000", lambda a: ops.boxes_iou3d(a, a), [bx],
              cut=first, cut_desc="500 boxes")
    _zoo_case("nms3d", "1000 boxes, iou 0.5", lambda a, s: ops.nms3d(a, s, 0.5), [bx, sc],
              cut=first, cut_desc="500 boxes")
    _zoo_case("nms3d_normal", "1000 boxes, iou 0.5", lambda a, s: ops.nms3d_normal(a, s, 0.5),
              [bx, sc])
    del bx, sc

    # PartA2's RoI-aware pooling (out 14) and PointRCNN's RoI point pooling
    # (512 points), on 16,384 points
    pts = torch.rand(2, 16384, 3, device="cuda", generator=g) * torch.tensor(
        [40.0, 40.0, 3.0], device="cuda") - torch.tensor([0.0, 20.0, 2.0], device="cuda")
    centre = pts[:, torch.randint(0, 16384, (128,), device="cuda", generator=g)]
    rois = torch.cat([centre, torch.tensor([3.9, 1.6, 1.56], device="cuda").expand(2, 128, 3) * 1.5,
                      (torch.rand(2, 128, 1, device="cuda", generator=g) - 0.5) * np.pi], -1)
    pf = torch.randn(2, 16384, 128, device="cuda", generator=g)
    for mode, ch in (("max", 128), ("avg", 4)):
        _zoo_case(f"roiaware_pool3d {mode} (PartA2)", f"128 RoIs, (16384, {ch}), out 14",
                  lambda r, p, f, md=mode: ops.roiaware_pool3d(r, p, f, (14, 14, 14), 128, md),
                  [rois[0], pts[0], pf[0, :, :ch].contiguous()],
                  cut=lambda a: [a[0][:16]] + a[1:], cut_desc="16 RoIs")
    _zoo_case("roipoint_pool3d (PointRCNN)", "(2, 16384, 3), 128 features, 128 boxes, 512 points",
              lambda p, f, r: ops.roipoint_pool3d(p, f, r, 512), [pts, pf, rois])
    del pts, pf, rois, centre


def _zoo_text(ops):
    """PANet's and PSENet's post-processing at 640x640 (7 kernels), on the
    host: the card's tensors (one copy each) against the same maps on the
    CPU."""
    rs = np.random.RandomState(ZOO_SEED)
    H = W = 640
    label = np.zeros((H, W), np.int32)
    kernels = np.zeros((7, H, W), np.uint8)
    for i in range(1, 13):
        y, x = rs.randint(20, H - 60), rs.randint(20, W - 160)
        h, w = rs.randint(14, 26), rs.randint(40, 120)
        for k in range(7):                            # kernel 0 the largest
            s = 6 - k
            kernels[k, max(y - 2 * s, 0):y + h + 2 * s, max(x - 2 * s, 0):x + w + 2 * s] = 1
        label[y + 6:y + h - 6, x + 12:x + w - 12] = i
    mask = kernels[0] > 0
    score = rs.rand(H, W).astype(np.float32)
    emb = (rs.randn(H, W, 4) * 0.2).astype(np.float32)
    contour = np.zeros((H, W), np.uint8)
    contour[1:-1, 1:-1] = ((label[1:-1, 1:-1] > 0) & ((label[:-2, 1:-1] == 0) |
                                                       (label[2:, 1:-1] == 0)))
    arrays = [torch.from_numpy(a).cuda() for a in (score, mask, emb, label, contour)]
    _zoo_case("pixel_group (PANet)", "640x640, 4-d embedding, 13 regions",
              lambda s, m, e, l_, c: ops.pixel_group(s, m, e, l_, c, 13, 0.8), arrays,
              reps=ZOO_HOST_REPS, warmup=0)
    arrays = [torch.from_numpy(a).cuda() for a in (kernels, label)]
    _zoo_case("contour_expand (PSENet)", "7 kernels at 640x640, min area 16",
              lambda k, l_: ops.contour_expand(k, l_, 16, 7), arrays, reps=ZOO_HOST_REPS,
              warmup=0)


def _zoo_backbone_and_utils(ops, g, card):
    from deep3dmap_tpu_torch.datasets.synthetic import make_fragment_sample
    from deep3dmap_tpu_torch.models.backbones.resnet_v1 import ResFCN256Cls
    from deep3dmap_tpu_torch.models.layers import init_flax_defaults
    from deep3dmap_tpu_torch.utils.analysis import get_model_complexity_info

    net = ResFCN256Cls(num_classes=1000)
    init_flax_defaults(net, torch.Generator().manual_seed(ZOO_SEED))
    cpu_net = ResFCN256Cls(num_classes=1000)
    cpu_net.load_state_dict(net.state_dict())
    net = net.cuda()
    x = torch.rand(16, 256, 256, 3, device="cuda", generator=g)
    cot = torch.randn(2, 1000, generator=torch.Generator().manual_seed(ZOO_SEED))
    outs = []
    for m, xx in ((cpu_net, x[:2].cpu()), (net, x[:2])):
        m.zero_grad()
        out = m(xx)
        out.backward(cot.to(xx.device))
        outs.append((out.detach().cpu(), {k: p.grad.cpu() for k, p in m.named_parameters()}))
    err = _zoo_rel(outs[1][0], outs[0][0])
    # float32 gradients move with the rounding of the forward at ReLU kinks
    # (stage 4 is 8x8 at B 2: one flip is ~1% of a leaf); in float64 the two
    # devices compute the same function's gradient
    f32_g = _zoo_tree_rel(outs[1][1], outs[0][1])
    outs64 = []
    for dev in ("cpu", "cuda"):
        m = copy.deepcopy(cpu_net).double().to(dev)
        out = m(x[:2].double().to(dev))
        out.backward(cot.double().to(dev))
        outs64.append((out.detach().cpu(), {k: p.grad.cpu() for k, p in m.named_parameters()}))
        del m, out
    err64 = _zoo_rel(outs64[1][0], outs64[0][0])
    gerr, leaf, leaf_err = _zoo_tree_rel(outs64[1][1], outs64[0][1])
    check(err <= TOL_ZOO and err64 <= TOL_ZOO and gerr <= TOL_ZOO_GRAD,
          f"zoo ResFCN256Cls: the card differs from the CPU by {err:.3e} (float32 output), "
          f"{err64:.3e} (float64 output), {gerr:.3e} (float64 gradients)")
    full_cot = torch.randn(16, 1000, device="cuda")

    def step():
        net.zero_grad(set_to_none=True)
        net(x).backward(full_cot)
    step_ms = _median_ms(step, reps=ZOO_REPS)
    fwd_ms = _median_ms(lambda: net(x), reps=ZOO_REPS)
    info = get_model_complexity_info(lambda m, v: m(v), net, x)
    launches, dev_ms, top = _device_ops(step, reps=1, pad=ZOO_PROFILE_PAD)
    peak = _zoo_peak(step)
    print(f"zoo ResFCN256Cls: (16, 256, 256, 3), 1000 classes; cut=B 2 for the CPU "
          f"fwd_ms={fwd_ms:.6f} fwd_bwd_ms={step_ms:.6f} (median of {ZOO_REPS}, CUDA events) "
          f"flops_fwd={info['flops']:.6g} ({info['flops_readable']}) params={info['params']} "
          f"fwd_tflops_per_s={info['flops'] / fwd_ms / 1e9:.3f} launches_fwd_bwd={launches:g} "
          f"device_ms={dev_ms:.6f} peak_bytes={peak} max_rel_err={err:.3e} "
          f"float64: max_rel_err={err64:.3e} grad_rel_err={gerr:.3e} (worst leaf {leaf} "
          f"{leaf_err:.3e}); float32 grad_rel_err={f32_g[0]:.3e} (worst leaf {f32_g[1]} "
          f"{f32_g[2]:.3e}) card={card!r}", flush=True)
    for key, count, t in top:
        print(f"zoo   {t:10.6f} ms x{count:g} {key}", flush=True)
    del net, cpu_net, x, outs

    vol = torch.randn(96, 96, 96, 32, device="cuda", generator=g)
    co = [torch.rand(96 ** 3, device="cuda", generator=g) * 98 - 1 for _ in range(3)]
    _zoo_case("grid_sample_3d", "(96, 96, 96, 32) at 96^3 points, bilinear",
              lambda v, a, b_, c: ops.grid_sample_3d(v, a, b_, c), [vol] + co,
              grads=(0, 1, 2, 3), cut=lambda a: [a[0]] + [t[:100_000] for t in a[1:]],
              cut_desc="100000 points")
    del vol, co
    # the bench fragment's first level: 9 views at 480x640, 96^3 at 0.04 m,
    # level 0 = 24^3 voxels at interval 4 over the stride-16 features (80 ch)
    # the fragment phases 4 and 10 build (seed 0), shared
    s = shared_samples(make_fragment_sample)(seed=0, n_views=N_VIEWS, img_size=IMG_HW,
                                             n_vox=N_VOX, voxel_size=0.04, device="cuda")
    proj = torch.from_numpy(s["proj_matrices"][:, 2]).cuda()
    origin = torch.from_numpy(s["vol_origin_partial"]).cuda()
    feats = torch.randn(9, 30, 40, 80, device="cuda", generator=g)
    _zoo_case("back_project_dense (bench fragment, level 0)", "9 x (30, 40, 80) -> 24^3",
              lambda f, p, o: ops.back_project_dense(f, p, o, 24, 0.04, 4), [feats, proj, origin],
              grads=(0,))


def phase_zoo(card):
    """Phase 29: the op zoo (no kernel of the repo)."""
    phase("the op zoo: each op at the size of a published model that uses it, the card "
          "against the CPU (TF32 off), ms, launches, syncs, peak bytes")
    set_tf32(cudnn=False, matmul=False)
    import deep3dmap_tpu_torch.ops as ops
    t0 = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(ZOO_SEED)
    _zoo_detection(ops, g)
    _zoo_loss_and_points(ops, g)
    _zoo_lidar(ops, g)
    _zoo_text(ops)
    _zoo_backbone_and_utils(ops, g, card)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"zoo: phase 29 took {time.perf_counter() - t0:.3f} s card={card!r}", flush=True)


# ---------------------------------------------------------------- phase 30 --
SCANNET_CFG = os.path.join("configs", "neural_recon", "scannet.py")
TRUNK_WARMUP, TRUNK_TIMED = 1, 2      # train_steps per trunk setting
# REMAT against none from the same weights, every step's loss and the first
# step's gradient: the recompute runs the forward's deterministic cuDNN
# algorithms on the same inputs, so bit-equal is expected; 1e-5 is the bound
TOL_REMAT_RTOL = 1e-5
# BP_GRAD_FRAC against none: a no-op in the port, so bit-equal is expected;
# the bound is float32 summation order
TOL_FRAC_GRAD_RTOL = 1e-6


def _events_step(step) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    step()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def _nr_train_run(nr_module, train_mod, cfg, batch, n_steps, grads_at=(0,)):
    """``n_steps`` train_steps of a fresh framework (seed 0) on one device
    batch: per step the loss, the CUDA-event ms and, at ``grads_at``, every
    parameter's gradient (host copies); the peak bytes from the framework's
    build on."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fw = nr_module.NeuralRecon(cfg)
    state = train_mod.init_train_state(fw, 0, batch, ADAM, CLIP)
    dev = fw.batch_to_device(batch)
    box, losses, ms, grads = [state], [], [], {}
    for i in range(n_steps):
        log = {}

        def step():
            box[0], out = train_mod.train_step(fw, box[0], dev)
            log.update(out)
        ms.append(_events_step(step))
        losses.append(float(log["loss"]))
        if i in grads_at:
            grads[i] = {n: p.grad.detach().cpu().clone()
                        for n, p in box[0].net.named_parameters()}
    peak = torch.cuda.max_memory_allocated()
    return dict(fw=fw, losses=losses, ms=ms, grads=grads, peak=peak)


def _worst_leaf(a: dict, b: dict):
    """The leaf of ``b`` farthest from ``a`` (relative to ``a``'s norm), its
    error, the whole gradient's error, and whether every leaf is equal."""
    rel = {n: float((a[n].double() - b[n].double()).norm()
                    / max(float(a[n].double().norm()), 1e-30)) for n in a}
    name = max(rel, key=rel.get)
    flat_a = torch.cat([a[n].double().ravel() for n in a])
    flat_b = torch.cat([b[n].double().ravel() for n in a])
    whole = float((flat_a - flat_b).norm() / flat_a.norm())
    return name, rel[name], whole, all(torch.equal(a[n], b[n]) for n in a)


def phase_published_trunk(nr_module, train_mod, stack, make_sample, card,
                          make_deterministic):
    phase("NeuralRecon's published training config (configs/neural_recon/scannet.py: "
          "fpn-mnas-1, fp32, dense, MODE scan, REMAT) against REMAT off, and BP_GRAD_FRAC "
          "at the bench config; 9x480x640, 96^3")
    from deep3dmap_tpu_torch.utils.config import Config

    t_phase = time.perf_counter()
    make_deterministic()
    set_tf32(cudnn=False, matmul=False)   # the two settings compared at float32
    batch = stack([make_sample(seed=0, n_views=N_VIEWS, img_size=IMG_HW, n_vox=N_VOX,
                               voxel_size=0.04, device="cuda")])
    cfg = dict(Config.fromfile(SCANNET_CFG).model["model_cfgs"])
    bb = dict(cfg["BACKBONE2D"])
    check("MODE" not in bb and "REMAT" not in bb and "DTYPE" not in bb
          and cfg.get("SPARSE_MODE", "dense") == "dense",
          f"{SCANNET_CFG} changed: {cfg}")
    reset_counters("fused_loss.")                 # this path starts here
    runs = {}
    # the config as published (the defaults: MODE "scan", REMAT on), then
    # REMAT off from the same weights and fragment
    for remat, mcfg in ((True, cfg), (False, dict(cfg, BACKBONE2D=dict(bb, REMAT=False)))):
        r = _nr_train_run(nr_module, train_mod, mcfg, batch, TRUNK_WARMUP + TRUNK_TIMED)
        check(r["fw"].net.backbone_remat == remat,
              f"REMAT={remat}: the framework runs {r['fw'].net.backbone_remat}")
        check(all(np.isfinite(v) for v in r["losses"]), f"REMAT={remat}: losses {r['losses']}")
        del r["fw"]
        runs[remat] = r
        timed = r["ms"][TRUNK_WARMUP:]
        print(f"trunk30 (a) REMAT={remat}: card={card!r} train_step_ms_median="
              f"{statistics.median(timed):.6f} train_step_ms_max={max(timed):.6f} "
              f"(CUDA events, {TRUNK_TIMED} steps after {TRUNK_WARMUP}) "
              f"max_memory_allocated_bytes={r['peak']} losses={r['losses']!r}", flush=True)
    on, off = runs[True], runs[False]
    rel = [abs(a - b) / abs(b) for a, b in zip(on["losses"], off["losses"])]
    name, worst, whole, equal = _worst_leaf(off["grads"][0], on["grads"][0])
    print(f"trunk30 (a) REMAT on against off: card={card!r} loss_rel_err={rel!r} "
          f"(bound {TOL_REMAT_RTOL}) losses_bitwise_equal={on['losses'] == off['losses']} "
          f"first_step_worst_grad_leaf={name} rel={worst:.3e} whole_grad_rel={whole:.3e} "
          f"(bound {TOL_REMAT_RTOL}) grads_bitwise_equal={equal} "
          f"peak_bytes remat/no_remat={on['peak']}/{off['peak']}", flush=True)
    check(max(rel) <= TOL_REMAT_RTOL, f"REMAT on against off, losses: {rel}")
    check(worst <= TOL_REMAT_RTOL, f"REMAT on against off, gradient {name}: {worst}")
    del runs, on, off

    # (b) BP_GRAD_FRAC at the bench config against none from the same
    # weights, and twice for repeatability
    set_tf32(cudnn=True, matmul=False)    # PyTorch's defaults, as phase 10
    plain = _nr_train_run(nr_module, train_mod, BENCH_CFGS, batch, 2, grads_at=(0, 1))
    fracs = [_nr_train_run(nr_module, train_mod, dict(BENCH_CFGS, BP_GRAD_FRAC=0.25), batch,
                           2, grads_at=(0, 1)) for _ in range(2)]
    for r in [plain] + fracs:
        del r["fw"]
    for i in (0, 1):
        name, worst, _, equal = _worst_leaf(plain["grads"][i], fracs[0]["grads"][i])
        repeat = _worst_leaf(fracs[0]["grads"][i], fracs[1]["grads"][i])[3]
        print(f"trunk30 (b) BP_GRAD_FRAC=0.25 step {i}: card={card!r} "
              f"worst_grad_leaf_vs_none={name} rel={worst:.3e} (bound {TOL_FRAC_GRAD_RTOL}) "
              f"bitwise_equal_to_none={equal} two_runs_bitwise_equal={repeat} "
              f"loss={fracs[0]['losses'][i]!r} loss_without={plain['losses'][i]!r}", flush=True)
        check(worst <= TOL_FRAC_GRAD_RTOL, f"BP_GRAD_FRAC step {i}: {name} {worst}")
        check(repeat, f"BP_GRAD_FRAC step {i}: two runs differ")
    print(f"trunk30 (b) BP_GRAD_FRAC=0.25: card={card!r} train_step_ms="
          f"{[r['ms'] for r in fracs]!r} without_ms={plain['ms']!r} "
          f"max_memory_allocated_bytes={fracs[0]['peak']} (without {plain['peak']})",
          flush=True)
    launches = loss_launches()                    # ... and ends here
    print(f"trunk30: phase 30 took {time.perf_counter() - t_phase:.3f} s; loss launches "
          f"(forward, backward) {launches} card={card!r}", flush=True)
    return launches


# ---------------------------------------------------------------- phase 31 --
FAN_B, FAN_BOXES_SEED = 8, 31
TOL_FAN_HEATMAP = 1e-4
TOL_FAN_LMK_PX = 1e-3
FAN_TIMED = 5
PRNET_DATAGEN_IMAGES, AFLW_IMAGES = 16, 8
ASYNC_GETS = 20
MULTIPIE_LABELS = 64


def _run_modules(arg_lists, timeout=600) -> list:
    """``python -m`` of each argument list, all at once; each one's wall
    seconds (to its own exit)."""
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-m", *args], cwd=os.path.dirname(
        os.path.abspath(__file__)), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for args in arg_lists]
    walls = []
    for args, p in zip(arg_lists, procs):
        try:
            out, err = p.communicate(timeout=max(1.0, timeout - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        walls.append(time.perf_counter() - t0)
        check(p.returncode == 0, f"python -m {' '.join(args)}: exit {p.returncode}\n"
              f"{out[-2000:]}\n{err[-4000:]}")
    return walls


def _multipie_tools(mp):
    """Phase 31 (e): a 64-line MultiPIE label file under ``mp``, then
    ``data_gen_multipie organize`` and ``get-lmk`` over it, started at once;
    returns a call that waits for both: (organize's wall seconds, get-lmk's
    completed process)."""
    import atexit

    os.makedirs(mp, exist_ok=True)
    rs = np.random.RandomState(31)
    labels, uvtex = [], []
    for _ in range(MULTIPIE_LABELS):
        fid, sess = rs.randint(1, 9), rs.choice(["01", "02", "03", "04"])
        rec, cam, illum = f"0{rs.randint(1, 4)}", rs.randint(0, 13), rs.choice(["10", "05"])
        labels.append(f"images/{fid:03d}_{sess}_{rec}_{cam:02d}_{illum}.png {fid - 1} {cam}")
        uvtex.append(f"uv/{fid:03d}_{sess}_{rec}.png")
    for name, lines in (("labels.txt", labels), ("uvtex.txt", uvtex[::4])):
        with open(os.path.join(mp, name), "w") as f:
            f.write("\n".join(lines) + "\n")
    tool = [sys.executable, "-m", "deep3dmap_tpu_torch.tools.data_gen_multipie"]
    cwd, t0 = os.path.dirname(os.path.abspath(__file__)), time.perf_counter()
    org = subprocess.Popen(tool + ["organize", "--labels", os.path.join(mp, "labels.txt"),
                                   "--uvtex-list", os.path.join(mp, "uvtex.txt"), "--out", mp],
                           cwd=cwd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    lmk = subprocess.Popen(tool + ["get-lmk", "--list", os.path.join(mp, "labels.txt"),
                                   "--out", mp],
                           cwd=cwd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def stop():                       # a failed phase exits: stop them too
        for p in (org, lmk):
            if p.poll() is None:
                p.kill()
                p.communicate()
    atexit.register(stop)

    def wait():
        try:
            out, err = org.communicate(timeout=300)
            org_s = time.perf_counter() - t0
            check(org.returncode == 0, f"data_gen_multipie organize: exit {org.returncode}\n"
                  f"{out[-2000:]}\n{err[-4000:]}")
            out, err = lmk.communicate(timeout=300)
        finally:
            stop()
        return org_s, subprocess.CompletedProcess(lmk.args, lmk.returncode, out, err)
    return wait


def _lmk_near_tie(hm, b, lm, tol) -> bool:
    """Whether landmark ``lm`` of crop ``b`` is decided within ``tol`` on
    the heatmap: the argmax's lead over the runner-up, and the sub-pixel
    step's two neighbour differences."""
    m = hm[b, :, :, lm]
    flat = np.sort(m.ravel())
    if flat[-1] - flat[-2] <= tol:
        return True
    y, x = np.unravel_index(int(m.argmax()), m.shape)
    H, W = m.shape
    return ((0 < x < W - 1 and abs(m[y, x + 1] - m[y, x - 1]) <= tol)
            or (0 < y < H - 1 and abs(m[y + 1, x] - m[y - 1, x]) <= tol))


def phase_face_leftovers(card, work, tools, g2s_module):
    phase("the face leftovers and the importers: stylegan2/vgg16/bisenet through "
          "import_weights into Gan2Shape and PerceptualLoss; FaceAlignment card vs CPU; "
          "data_gen_prnet, PRNet's CLIs and AFLW2000; FaceTexUVAsyncDataset")
    from deep3dmap_tpu_torch.datasets.gan_faces import SyntheticGanFaceDataset
    from deep3dmap_tpu_torch.datasets.synthetic import (seeded_bisenet_state_dict,
                                                        seeded_stylegan2_state_dict,
                                                        seeded_vgg16_state_dict,
                                                        write_300wlp_fixture,
                                                        write_aflw2000_fixture)
    from deep3dmap_tpu_torch.models import face_alignment as fa_mod
    from deep3dmap_tpu_torch.models.losses.perceptual_loss import PerceptualLoss

    t_phase = time.perf_counter()
    root = os.path.join(work, "face31")
    os.makedirs(root, exist_ok=True)

    # (a) the importers, as a user runs them, into their consumers
    g = CELEBA_MODEL_CFGS
    ckpts = dict(
        stylegan2=seeded_stylegan2_state_dict(0, size=g["gan_size"], style_dim=g["z_dim"],
                                              n_mlp=g["n_mlp"],
                                              channel_multiplier=g["channel_multiplier"]),
        vgg16=seeded_vgg16_state_dict(1), bisenet=seeded_bisenet_state_dict(2))
    # (c)'s data-gen input, so that the tool runs beside the importers
    wlp_in, wlp = os.path.join(root, "300wlp_in"), os.path.join(root, "300wlp")
    write_300wlp_fixture(wlp_in, n_images=PRNET_DATAGEN_IMAGES, seed=31)
    npz, imports = {}, {}
    for kind, sd in ckpts.items():
        src = os.path.join(root, f"{kind}.pth")
        tens = {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()} \
            if kind != "stylegan2" else {
                part: {k: torch.from_numpy(v) for k, v in d.items()} for part, d in sd.items()}
        torch.save(tens, src)
        npz[kind] = os.path.join(root, f"{kind}.npz")
        flags = (["--size", str(g["gan_size"]), "--n-mlp", str(g["n_mlp"]),
                  "--channel-multiplier", str(g["channel_multiplier"]),
                  "--style-dim", str(g["z_dim"])] if kind == "stylegan2" else [])
        imports[kind] = ["deep3dmap_tpu_torch.tools.import_weights", kind, src, npz[kind],
                         *flags]
    # the three conversions and (c)'s data-gen as four users' processes, at once
    walls = _run_modules(list(imports.values()) + [[
        "deep3dmap_tpu_torch.tools.data_gen_prnet", "-i", wlp_in, "-o", wlp,
        "--synthetic-bfm"]])
    import_s, gen_s = dict(zip(imports, walls)), walls[-1]
    data = SyntheticGanFaceDataset(n_samples=1, image_size=128, z_dim=512).setup_input(0)
    fw = g2s_module.Gan2Shape(dict(g, gan_ckpt=npz["stylegan2"], parsing_ckpt=npz["bisenet"]))
    net, state = fw.init(0, data)
    batch = fw.batch_to_device(data)
    reset_counters("raster.")                     # this path starts here
    outs = []
    g2s_ms = _synced_ms(lambda: outs.append(fw.forward_test(net, state, batch)[0]),
                        FWD_WARMUP, FWD_TIMED)
    g2s_launches = counter("raster.launches")     # ... and ends here
    check(g2s_launches == FWD_WARMUP + FWD_TIMED,
          f"forward_test with the imported gan_ckpt: {g2s_launches} raster launches")
    check(all(torch.isfinite(v).all().item() for v in outs[-1].values()
              if isinstance(v, torch.Tensor)), "non-finite Gan2Shape output")
    with torch.no_grad():
        w = fw.generator.mapping(torch.zeros((1, g["z_dim"]), device="cuda"))
    check(torch.isfinite(w).all().item(), "the imported mapping gives non-finite styles")
    mask_ms = _synced_ms(lambda: fw.parse_mask(data["input_im"]), 1, FWD_TIMED)
    mask = fw.parse_mask(data["input_im"])
    check(mask.shape == (1, 128, 128, 1) and torch.isfinite(mask).all().item(),
          f"parse_mask with the imported BiSeNet: {tuple(mask.shape)}")
    perc = PerceptualLoss(weights_path=npz["vgg16"])
    gen = torch.Generator(device="cuda").manual_seed(0)
    a, b = (torch.rand((4, 128, 128, 3), device="cuda", generator=gen) * 2 - 1
            for _ in range(2))
    perc_ms = _synced_ms(lambda: perc(a, b), 2, FWD_TIMED)
    d = perc(a, b)
    check(d.shape == (4,) and torch.isfinite(d).all().item() and bool((d > 0).all()),
          f"PerceptualLoss with the imported VGG16: {d}")
    print(f"face31 (a) importers: card={card!r} import_s={import_s!r} "
          f"g2s_forward_test_ms_median={statistics.median(g2s_ms):.6f} "
          f"g2s_forward_test_ms_max={max(g2s_ms):.6f} raster_launches={g2s_launches} "
          f"parse_mask_ms_median={statistics.median(mask_ms):.6f} "
          f"perceptual_ms_median={statistics.median(perc_ms):.6f} (B 4, 128²) "
          f"perceptual={d.tolist()!r}", flush=True)
    del fw, net, state, perc, outs

    # (b) FaceAlignment at its defaults, the card against the CPU, TF32 off
    set_tf32(cudnn=False, matmul=False)
    rs = np.random.RandomState(FAN_BOXES_SEED)
    img = rs.rand(480, 640, 3).astype(np.float32)
    boxes = []
    for _ in range(FAN_B):
        x1, y1, s = rs.uniform(40, 400), rs.uniform(40, 240), rs.uniform(100, 200)
        boxes.append([x1, y1, x1 + s, y1 + s])
    fa, fa_cpu = fa_mod.FaceAlignment(), fa_mod.FaceAlignment(device="cpu")
    crops, centers, scales = [], [], []
    for (x1, y1, x2, y2) in boxes:
        c = np.array([(x1 + x2) / 2.0, (y1 + y2) / 2.0 - (y2 - y1) * 0.12])
        s = (x2 - x1 + y2 - y1) / 195.0
        crops.append(fa_mod.crop_face(img, c, s, fa.resolution))
        centers.append(c)
        scales.append(s)
    crops = np.stack(crops)
    hm = fa.heatmaps(crops).float().cpu().numpy()
    hm_cpu = fa_cpu.heatmaps(crops).numpy()
    fan_ms = _synced_ms(lambda: fa.heatmaps(crops), 2, FAN_TIMED)
    hm_err = float(np.abs(hm - hm_cpu).max())
    _, lmk = fa_mod.get_preds_from_heatmaps(hm, centers, scales)
    _, lmk_cpu = fa_mod.get_preds_from_heatmaps(hm_cpu, centers, scales)
    diff = np.abs(lmk - lmk_cpu).max(axis=-1)                       # (B, 68)
    off = [(b_, lm) for b_, lm in zip(*np.nonzero(diff > TOL_FAN_LMK_PX))]
    ties = [k for k in off if _lmk_near_tie(hm_cpu, *k, 2 * TOL_FAN_HEATMAP)]
    decided = diff[diff <= TOL_FAN_LMK_PX]
    print(f"face31 (b) FaceAlignment (2 modules, 68 landmarks, 256², B {FAN_B}, TF32 off): "
          f"card={card!r} heatmap_max_abs_err={hm_err:.3e} (bound {TOL_FAN_HEATMAP}) "
          f"landmark_max_px_err={float(decided.max()) if decided.size else 0.0:.3e} "
          f"(bound {TOL_FAN_LMK_PX}) landmarks_off={len(off)} of {diff.size} "
          f"(near-ties of the CPU heatmap: {len(ties)}) heatmaps_ms_median="
          f"{statistics.median(fan_ms):.6f} heatmaps_ms_max={max(fan_ms):.6f}", flush=True)
    check(hm_err <= TOL_FAN_HEATMAP, f"FAN heatmaps card vs CPU {hm_err}")
    check(len(ties) == len(off), f"landmarks off beyond the near-tie rule: {off}")
    lms = fa.get_landmarks_from_image((img * 255).astype(np.uint8), boxes[:2])
    check(len(lms) == 2 and all(np.isfinite(x).all() and x.shape == (68, 2) for x in lms),
          "get_landmarks_from_image")
    set_tf32(cudnn=True, matmul=False)
    del fa, fa_cpu

    # (e)'s two tool runs start here, beside (c)'s training and test
    mp_procs = _multipie_tools(os.path.join(root, "multipie"))

    # (c) the PRNet data path: data-gen (run with (a)'s importers), one
    # epoch of the config, AFLW2000
    names = open(os.path.join(wlp, "list.txt")).read().split()
    check(len(names) == PRNET_DATAGEN_IMAGES and all(
        np.load(os.path.join(wlp, n.replace(".jpg", ".npy"))).shape == (256, 256, 3)
        for n in names), f"data_gen_prnet wrote {names}")
    kpt = os.path.join(wlp, "uv_kpt_ind.txt")
    split = {s: [f"data.{s}.{k}={v}" for k, v in (
        ("datapath", os.path.join(wlp, "list.txt")), ("img_prefix", wlp),
        ("uv_kpt_ind_file", kpt))] for s in ("train", "test")}
    opts = split["train"] + split["test"] + [f"model.model_cfgs.uv_kpt_ind_file={kpt}"]
    wd = os.path.join(root, "prnet_wd")
    t0 = time.perf_counter()
    runner = tools.train.main([PRNET_CFG, "--work-dir", wd, "--max-epochs", "1",
                               "--cfg-options", *opts])
    train_s = time.perf_counter() - t0
    check(runner.epoch == 1 and runner.state.step == 1,
          f"PRNet on the data-gen's output: epoch {runner.epoch} step {runner.state.step}")
    aflw = write_aflw2000_fixture(os.path.join(root, "aflw2000"), n_images=AFLW_IMAGES, seed=31)
    # the test split replaced whole, the batch the fixture's size (the
    # loader drops a last partial batch)
    aflw_opts = [f"data.samples_per_gpu={AFLW_IMAGES}",
                 "data.test._delete_=True", "data.test.type=AFLW2000Dataset",
                 f"data.test.datapath={aflw}", f"data.test.img_prefix={os.path.dirname(aflw)}",
                 "data.test.pipeline=[{'type': 'FaceLandmarkCrop', 'resolution_inp': 256}]"]
    t0 = time.perf_counter()
    res = tools.test.main([PRNET_CFG, "--work-dir", wd, "--checkpoint", "auto", "--eval", "nme",
                           "--cfg-options", *split["train"],
                           f"model.model_cfgs.uv_kpt_ind_file={kpt}", *aflw_opts])
    test_s = time.perf_counter() - t0
    check(res is not None and np.isfinite(res["nme"]), f"AFLW2000 NME: {res}")
    print(f"face31 (c) PRNet data path: card={card!r} data_gen_prnet_s={gen_s:.3f} "
          f"({PRNET_DATAGEN_IMAGES} images at 450², synthetic BFM, 256² maps) "
          f"train_cli_s={train_s:.3f} (1 epoch, 1 step at B 16) test_cli_s={test_s:.3f} "
          f"aflw2000_images={AFLW_IMAGES} nme={res['nme']!r}", flush=True)

    # (d) the async producers over the face-UV data, in a process whose main
    # module imports no torch (spawned producers re-import the parent's main)
    code = (
        "import json, sys, time\n"
        "from deep3dmap_tpu_torch.datasets import build_dataset\n"
        "ds = build_dataset(dict(type='FaceTexUVAsyncDataset', batch_size=4, nthread=2,\n"
        f"    n_slots=4, dataset=dict(type='ThreeHundredWLPDataset', datapath={os.path.join(wlp, 'list.txt')!r},\n"
        f"    img_prefix={wlp!r}, resolution=256)))\n"
        "ds.get()\n"
        "t0 = time.perf_counter()\n"
        f"shapes = [ds.get()['faceimg'].shape for _ in range({ASYNC_GETS})]\n"
        "dt = time.perf_counter() - t0\n"
        "flags = ds.producers_imported_torch()\n"
        "ds.close()\n"
        "img = build_dataset(dict(type='FaceImagesAsyncDataset', batch_size=2, nthread=1,\n"
        "    n_slots=2, dataset=ds._cfg))\n"
        "img_shape, img_state = list(img.get()['faceimg'].shape), img.state\n"
        "flags += img.producers_imported_torch()\n"
        "img.close()\n"
        "print(json.dumps(dict(batches_per_s=len(shapes) / dt, shape=list(shapes[0]),\n"
        "    images_shape=img_shape, images_state=img_state, producers_imported_torch=flags,\n"
        "    main_imported_torch='torch' in sys.modules)))\n")
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-c", code], cwd=os.path.dirname(os.path.abspath(
        __file__)), capture_output=True, text=True, timeout=300)
    check(r.returncode == 0, f"the async producers: {r.stderr[-4000:]}")
    out = json.loads(r.stdout.strip().splitlines()[-1])
    print(f"face31 (d) FaceTexUVAsyncDataset (2 producers, B 4, 256² 300W-LP maps): "
          f"card={card!r} batches_per_s={out['batches_per_s']:.6f} over {ASYNC_GETS} get()s "
          f"producers_imported_torch={out['producers_imported_torch']} "
          f"main_imported_torch={out['main_imported_torch']} process_s="
          f"{time.perf_counter() - t0:.3f}", flush=True)
    check(out["shape"] == [4, 256, 256, 3] and out["images_shape"] == [2, 256, 256, 3]
          and out["images_state"] == "sup_unsup"
          and out["producers_imported_torch"] == [False, False, False]
          and not out["main_imported_torch"], f"the async producers: {out}")

    # (e) MultiPIE's indexes through the tool (started with (c)'s data-gen),
    # and its FAN step failing as JAX's does
    mp = os.path.join(root, "multipie")
    org_s, r = mp_procs()
    import pickle
    with open(os.path.join(mp, "multipie_idillumexp2poseimgpaths.pkl"), "rb") as f:
        index = pickle.load(f)
    with open(os.path.join(mp, "multipie_uvtex2poseimgs.pkl"), "rb") as f:
        uv_index = pickle.load(f)
    n_paths = sum(len(v) for ill in index.values() for ex in ill.values() for po in ex.values()
                  for v in po.values())
    quirk = r.returncode != 0 and "TypeError" in r.stderr and "no weights_path" in r.stderr
    print(f"face31 (e) data_gen_multipie: card={card!r} organize_s={org_s:.3f} "
          f"ids={len(index)} image_paths={n_paths} uvtex_keys={len(uv_index)} "
          f"get_lmk_exit={r.returncode} fan_quirk_raised={quirk}", flush=True)
    check(n_paths == MULTIPIE_LABELS and len(uv_index) > 0 and quirk,
          f"data_gen_multipie: {n_paths} paths, {len(uv_index)} uvtex keys, "
          f"get-lmk exit {r.returncode}: {r.stderr[-2000:]}")
    print(f"face31: phase 31 took {time.perf_counter() - t_phase:.3f} s card={card!r}",
          flush=True)
    return g2s_launches


# ---------------------------------------------------------------- phase 32 --
_SAMPLES = {}
# the full-width phases' first batches and model configs (17, 18, 20, 23),
# which phase 32 (c) trains data-parallel
_ARM_BATCHES = {}


def shared_samples(make_sample):
    """``make_sample`` with its results kept: phases that build the same
    seeded fragment share one build (a bench fragment traces 9 views at
    480x640 on the host, ~15 s).  Each call gets its own dict of the
    shared (read-only) arrays."""
    def call(**kw):
        key = tuple(sorted(kw.items()))
        if key not in _SAMPLES:
            _SAMPLES[key] = make_sample(**kw)
        return dict(_SAMPLES[key])
    return call


P32_STEPS = 3            # train_steps per arm of (a)
P32_BA_ITERS = 20
TOL_P32_HALO = 2e-5      # the halo cell against the whole cell: JAX's own bound
                         # (tests/test_halo_fusion.py:48-50), TF32 off
P32_TIMEOUT = 240        # seconds for each rank group
# (b)'s data-parallel step against one rank on the same global batch, TF32
# off.  The float32 arm (the back-projection's gather table too) holds the
# gradient: its loss, whole gradient and worst leaf (relative to the leaf's
# norm); on an H100 (700 W) 1.0e-7, 3.5e-4 and 4.9e-3.  A backward fed each
# rank's own sums in place of the global ones is ~1 off (each rank's mask
# count is about half the global one), far past these bounds.  With the
# model's bf16 gather table the float32 arm's gradient sat 7.0e-3 / 6.8e-2
# off: cuDNN rounds a batch of one and of two differently, and a bf16 cast
# turns some of those last-bit differences into whole bf16 steps.
TOL_P32_DP_F32 = dict(loss=1e-5, whole=2e-3, leaf=2e-2)
# The bf16 arm (the bench config as bench.py runs it): its bf16 block convs
# move some occupancy logits across the threshold as well, so the finest
# level's mask differs from one rank's in a few hundred of ~36,000 voxels
# (printed) and the gradient by 9.7e-2 (its worst leaf 1.1); the loss
# within 1e-3, the whole gradient within 0.25 (the own-sums fault is ~1)
TOL_P32_DP_BF16 = dict(loss=1e-3, whole=0.25)
# the spatial step's gradient against the unsharded step's (the halo conv
# sums the GRU's weight gradient over two slabs): whole and worst leaf
TOL_P32_SPATIAL_GRAD = dict(whole=1e-4, leaf=1e-3)
# (b)'s data parallel arms (name, config, whether the back-projection's
# gather table is float32 rather than the model's bf16): the bench config
# as it is, and at float32
_P32_F32 = dict(BENCH_CFGS, GLOBAL_DTYPE="float32", BLOCK_DTYPE="float32",
                BACKBONE2D=dict(BENCH_CFGS["BACKBONE2D"], DTYPE="float32"))
P32_DP_ARMS = (("bf16", BENCH_CFGS, False), ("f32", _P32_F32, True))
TOL_P32_DP = {"bf16": TOL_P32_DP_BF16, "f32": TOL_P32_DP_F32}


def _p32_framework(nr, cfg, f32_gather):
    fw = nr.NeuralRecon(cfg)
    if f32_gather:
        fw.net.bp_gather_dtype = None
    return fw


@contextlib.contextmanager
def _p32_capture(nr):
    """The level inputs (detached) and ``pos_weight`` of every fused loss
    call ``NeuralRecon.loss_fn`` makes inside the block."""
    seen, real = [], nr.fused_tsdf_occ_loss_levels

    def capture(levels, pos_weight=1.0, group=None):
        seen.append(([tuple(a.detach() for a in lv) for lv in levels], pos_weight))
        return real(levels, pos_weight, group)
    nr.fused_tsdf_occ_loss_levels = capture
    try:
        yield seen
    finally:
        nr.fused_tsdf_occ_loss_levels = real


def _p32_bwd_check(fused_loss, collectives, levels, pos_weight, group):
    """The backward kernel on this rank's level inputs from the data-parallel
    step, fed the all-reduced sums (as the step feeds it), against the plain
    backward on the same sums, at phase 8's tolerances.  Returns the max abs
    difference, and how far (relative to the gradient's largest value) the
    plain backward fed this rank's own sums lands from it: the fault the
    all-reduce prevents, which the gradient bounds must see."""
    loc = torch.stack([fused_loss.fused_tsdf_occ_loss_cuda(*lv, pos_weight=pos_weight)
                       for lv in levels])
    glob = torch.cat([loc[:, :3], collectives.all_reduce(loc[:, 3:8].contiguous(), group)], 1)
    gen = torch.Generator(device="cuda").manual_seed(32)
    g = torch.rand((len(levels), 3), generator=gen, device="cuda") + 0.5
    got = fused_loss.fused_tsdf_occ_loss_bwd_cuda(levels, glob, g, pos_weight)
    err, fault = 0.0, 0.0
    for i, (lv, pair, gl) in enumerate(zip(levels, got, g)):
        want = fused_loss.fused_tsdf_occ_loss_bwd_plain(*lv, glob[i, 3:5], gl, pos_weight)
        own = fused_loss.fused_tsdf_occ_loss_bwd_plain(*lv, loc[i, 3:5], gl, pos_weight)
        for what, a, c, f in zip(("d_tsdf", "d_occ"), pair, want, own):
            tol = TOL_LOSS_BWD[a.dtype]
            a, c, f = a.float(), c.float(), f.float()
            check(torch.allclose(a, c, **tol),
                  f"(b) level {i} {what}: the backward kernel on the global sums vs plain, "
                  f"max abs diff {(a - c).abs().max().item()} (tol {tol})")
            err = max(err, (a - c).abs().max().item())
            fault = max(fault, ((f - c).abs().max() / c.abs().max().clamp_min(1e-30)).item())
    return err, fault


def _p32_nccl_one(rank, work):
    """(a): the bench config's train_step, ``P32_STEPS`` times from the seeded
    weights with no process group, then the same steps through the
    data-parallel path at one NCCL rank; one more step under the sync
    debug mode."""
    from deep3dmap_tpu_torch.models.frameworks import neuralrecon as nr
    from deep3dmap_tpu_torch.parallel import collectives, make_mesh
    from deep3dmap_tpu_torch.runners import train_state as tm
    from deep3dmap_tpu_torch.utils.device import make_deterministic

    set_tf32(cudnn=True, matmul=False)    # PyTorch's defaults, as phase 10
    make_deterministic()
    batch = torch.load(os.path.join(work, "p32_bench.pt"), weights_only=False)
    mesh = make_mesh(device="cuda")
    out, kept, t0 = {"s": {}}, {}, time.perf_counter()
    for arm, m in (("no_group", None), ("nccl", mesh)):
        fw = nr.NeuralRecon(BENCH_CFGS)
        if m is not None:
            fw.set_mesh(m)
        box = [tm.init_train_state(fw, 0, batch, ADAM, CLIP)]
        dev = fw.batch_to_device(batch)
        losses, ms, launches, counts = [], [], [], []
        for _ in range(P32_STEPS):
            reset_counters("fused_loss.")
            collectives.reset_counts()
            log = {}

            def step():
                box[0], o = tm.train_step(fw, box[0], dev)
                log.update(o)
            ms.append(_events_step(step))
            losses.append(log["loss"].detach().clone())
            launches.append(list(loss_launches()))
            counts.append(collectives.counts())
        kept[arm] = (losses, [p.detach().clone() for p in box[0].net.parameters()])
        out[arm] = dict(losses=[float(x) for x in losses], ms=ms, launches=launches,
                        counts=counts)
        if m is not None:
            def one():
                box[0], _ = tm.train_step(fw, box[0], dev)
            out["syncs"] = _count_syncs(one)[1]
            torch.cuda.synchronize()
        del fw, box, dev
        gc.collect()
        torch.cuda.empty_cache()
        out["s"][arm] = time.perf_counter() - t0
        t0 = time.perf_counter()
    a, b = kept["no_group"], kept["nccl"]
    out["losses_equal"] = all(torch.equal(x, y) for x, y in zip(a[0], b[0]))
    out["params_equal"] = all(torch.equal(x, y) for x, y in zip(a[1], b[1]))
    del kept, a, b
    # (a)'s timed steps are done: (b)'s ranks take the card now, and its
    # references run beside their data-parallel arms: one rank, no group,
    # on (b)'s global batch of 2, TF32 off as (b) runs; each arm's loss,
    # gradient and the loss's masks
    open(os.path.join(work, "p32_go"), "w").close()
    set_tf32(cudnn=False, matmul=False)
    pair = torch.load(os.path.join(work, "p32_gloo.pt"), weights_only=False)["pair"]
    refs = {}
    for arm, cfg, f32_gather in P32_DP_ARMS:
        fw = _p32_framework(nr, cfg, f32_gather)
        net, ms = fw.init(0, pair)
        with _p32_capture(nr) as seen:
            loss, _ = fw.loss_fn(net, ms, pair)
        loss.backward()
        refs[arm] = dict(loss=float(loss), grads=_p32_grads(net),
                         masks=[lv[4].cpu() for lv in seen[0][0]],
                         val=float(fw.val_fn(net, ms, pair)["log_vars"]["loss"]))
        del fw, net, ms, seen, loss
        gc.collect()
        torch.cuda.empty_cache()
    torch.save(refs, os.path.join(work, "p32_dp_ref.tmp"))
    os.replace(os.path.join(work, "p32_dp_ref.tmp"), os.path.join(work, "p32_dp_ref.pt"))
    out["s"]["dp_ref"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    # (g)'s one rank: tools/test.py on the scene's fragments in order
    ref = _p32_test_outputs([SCANNET_SYN_CFG, "--work-dir", os.path.join(work, "p32_test_one"),
                             "--device", P32_DEVICE, "--cfg-options", *P32_TEST_OPTS])
    torch.save(ref, os.path.join(work, "p32_test_ref.tmp"))
    os.replace(os.path.join(work, "p32_test_ref.tmp"), os.path.join(work, "p32_test_ref.pt"))
    out["s"]["test_ref"] = time.perf_counter() - t0
    return out


def _p32_grads(net) -> dict:
    return {n: p.grad.detach().cpu().clone() for n, p in net.named_parameters()}


def _p32_gloo_two(rank, work):
    """(b) on each of two gloo ranks sharing the card: the data-parallel
    step on a global batch of 2 at each of ``P32_DP_ARMS`` against (a)'s one
    rank on the whole (the gradient, the loss's masks), the backward kernel
    on the rank's level inputs and the global sums against plain;
    scannet.py's dense model over ("data", "model") = (1, 2): the halo GRU
    at the finest window against the whole cell, the global volumes' bytes,
    one spatial train_step (and on rank 0 the unsharded one);
    ``lm_solve_sharded`` (and on rank 0 ``lm_solve``) at phase 27's ring."""
    from deep3dmap_tpu_torch.core import sfm
    from deep3dmap_tpu_torch.models.frameworks import neuralrecon as nr
    from deep3dmap_tpu_torch.ops import fused_loss
    from deep3dmap_tpu_torch.parallel import (collectives, conv_gru3d_halo, make_mesh,
                                              shard_batch)
    from deep3dmap_tpu_torch.runners import train_state as tm
    from deep3dmap_tpu_torch.runners.optim import build_optimizer
    from deep3dmap_tpu_torch.utils.config import Config
    from deep3dmap_tpu_torch.utils.device import make_deterministic

    set_tf32(cudnn=False, matmul=False)   # the comparisons are at float32
    make_deterministic()
    data = torch.load(os.path.join(work, "p32_gloo.pt"), weights_only=False)
    out = {"launches": [0, 0], "s": {}}
    t0 = [time.perf_counter()]

    def lap(name):
        torch.cuda.synchronize()
        out["s"][name] = time.perf_counter() - t0[0]
        t0[0] = time.perf_counter()

    def count(fn):
        reset_counters("fused_loss.")
        r = fn()
        out["launches"][0] += counter("fused_loss.fwd_launches")
        out["launches"][1] += counter("fused_loss.bwd_launches")
        return r

    # data parallel, the bench config as it is and at float32, one fragment
    # a rank, against (a)'s one rank on the same global batch
    mesh = make_mesh(device="cuda")
    group = mesh.group("data")
    local = shard_batch(data["pair"], mesh, global_batch=True)
    out["dp"], mine = {}, {}
    for arm, cfg, f32_gather in P32_DP_ARMS:
        fw = _p32_framework(nr, cfg, f32_gather)
        fw.set_mesh(mesh)
        net, ms = fw.init(0, local)

        def dp():
            loss, _ = fw.loss_fn(net, ms, local)
            loss.backward()
            collectives.reduce_gradients(net.parameters(), group)
            return loss
        with _p32_capture(nr) as seen:
            loss = float(count(dp))
        levels, pos_weight = seen[0]
        bwd_err, fault = _p32_bwd_check(fused_loss, collectives, levels, pos_weight, group)
        out["dp"][arm] = dict(loss=loss, bwd_err=bwd_err, own_sums_rel=fault)
        # (f) val on the mesh: the global batch's loss, three forward launches
        launched = list(out["launches"])
        collectives.reset_counts()
        out["dp"][arm]["val"] = float(count(
            lambda: fw.val_fn(net, ms, local)["log_vars"]["loss"]))
        out["dp"][arm]["val_launches"] = [a - b for a, b in zip(out["launches"], launched)]
        out["dp"][arm]["val_counts"] = collectives.counts()
        mine[arm] = (_p32_grads(net), [lv[4][0].cpu() for lv in levels])
        del fw, net, ms, seen, levels
        gc.collect()
        torch.cuda.empty_cache()
    lap("dp")
    refs = torch.load(_p32_wait_file(os.path.join(work, "p32_dp_ref.pt")),
                      weights_only=False)
    for arm, (grads, masks) in mine.items():
        ref = refs[arm]
        name, worst, whole, _ = _worst_leaf(ref["grads"], grads)
        out["dp"][arm].update(
            ref_loss=ref["loss"], ref_val=ref["val"], worst_leaf=name, worst_rel=worst,
            whole_rel=whole,
            mask_voxels=[int(m[rank].sum()) for m in ref["masks"]],
            mask_diff=[int((m0 != m[rank]).sum()) for m0, m in zip(masks, ref["masks"])])
    del refs, mine
    lap("dp_vs_one_rank")

    # the spatial path: scannet.py's dense model, the volumes in X slabs
    cfg = dict(Config.fromfile(SCANNET_CFG).model["model_cfgs"])
    mesh2 = make_mesh(("data", "model"), (1, 2), device="cuda")
    fw = nr.NeuralRecon(cfg)
    out["spatial_on"] = fw.set_mesh(mesh2)
    net, ms = fw.init(0, data["frag"])
    vols = ms["global_hidden"].volumes
    out["volume_bytes"] = sum(v.numel() * v.element_size() for v in vols)
    out["whole_volume_bytes"] = sum(g ** 3 * c * vols[0].element_size()
                                    for g, c in zip(fw.global_dims, fw.out_channels))
    gru, w = net.gru2, fw._window_dims()[-1]
    gen = torch.Generator(device="cuda").manual_seed(32)
    h = torch.randn((1, w, w, w, gru.hidden_dim), generator=gen, device="cuda")
    x = torch.randn((1, w, w, w, gru.hidden_dim), generator=gen, device="cuda")
    r, k = mesh2.coordinate("model"), w // 2
    with torch.no_grad():
        y = conv_gru3d_halo(gru, h[:, r * k:(r + 1) * k], x[:, r * k:(r + 1) * k], mesh2)
        spatial, gru.spatial = gru.spatial, None
        whole = gru(h, x)
        gru.spatial = spatial
    out["halo_err"] = float((y - whole[:, r * k:(r + 1) * k]).abs().max())
    del h, x, y, whole
    lap("spatial_init_halo")
    state = tm.TrainState(net=net, model_state=ms,
                          optimizer=build_optimizer(ADAM, net.parameters(), CLIP))
    dev = fw.batch_to_device(data["frag"])
    collectives.reset_counts()
    box, log = [state], {}
    lap("spatial_state")

    def spatial_step():
        box[0], o = tm.train_step(fw, box[0], dev)
        log.update(o)
    out["spatial_ms"] = count(lambda: _events_step(spatial_step))
    out["spatial_loss"] = float(log["loss"])
    out["spatial_counts"] = collectives.counts()
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    # the gradient the step took (summed over the model axis) and the weights after it
    sp_grads = _p32_grads(net)
    sp_params = {n: p.detach().cpu().clone() for n, p in net.named_parameters()}
    lap("spatial_step")
    # (e): this state's checkpoint through the runner's save (every rank
    # gathers its slabs over "model", rank 0 writes the whole volumes)
    from deep3dmap_tpu_torch.runners.epoch_based_runner import EpochBasedRunner

    saver = EpochBasedRunner(fw, work_dir=os.path.join(work, "p32_ckpt"), mesh=mesh2,
                             max_epochs=1)
    saver.state, saver.spatial = box[0], True
    ckpt_slabs = [v.detach().cpu().clone()
                  for v in box[0].model_state["global_hidden"].volumes]
    saver.save_checkpoint()
    lap("spatial_save")
    del fw, net, ms, state, box, saver
    gc.collect()
    torch.cuda.empty_cache()
    lap("spatial_free")
    if rank == 0:
        ref = nr.NeuralRecon(cfg)
        st = tm.init_train_state(ref, 0, data["frag"], ADAM, CLIP)
        st, rlog = tm.train_step(ref, st, ref.batch_to_device(data["frag"]))
        out["spatial_ref_loss"] = float(rlog["loss"])
        name, worst, whole, equal = _worst_leaf(_p32_grads(st.net), sp_grads)
        out.update(spatial_grad_worst_leaf=name, spatial_grad_worst_rel=worst,
                   spatial_grad_whole_rel=whole, spatial_grad_equal=equal,
                   spatial_param_max_abs=max(
                       float((p.detach().cpu() - sp_params[n]).abs().max())
                       for n, p in st.net.named_parameters()))
        del ref, st
        gc.collect()
        torch.cuda.empty_cache()
    lap("spatial_ref")

    # the sharded LM at phase 27's ring scene, float64
    rng = np.random.RandomState(0)
    K, Rs, ts, X, ci, pi, uv = _ring_scene(rng, 6, 64, SFM_SIGMA)
    xi = rng.randn(6, 6) * 0.02
    xi[:2] = 0.0
    dR = _rodrigues(xi[:, 3:])
    start = _on("cuda", torch.float64, dR @ Rs, np.einsum("nij,nj->ni", dR, ts) + xi[:, :3],
                X + rng.randn(*X.shape) * 0.05)
    K_, uv_, w_ = _on("cuda", torch.float64, K, uv, np.ones(len(ci)))
    prob = sfm.BAProblem(K=K_, cam_idx=torch.as_tensor(ci, device="cuda"),
                         pt_idx=torch.as_tensor(pi, device="cuda"), uv=uv_, w=w_,
                         cam_fixed=torch.arange(6, device="cuda") < 2)
    collectives.reset_counts()
    res = sfm.lm_solve_sharded(mesh, *start, prob, iters=P32_BA_ITERS)
    out["ba_counts"] = collectives.counts()
    out["ba_cost"] = float(res.cost)
    if rank == 0:
        want = sfm.lm_solve(*start, prob, iters=P32_BA_ITERS)
        out["ba_ref_cost"] = float(want.cost)
        out["ba_rel"] = max(_rel(getattr(want, f), getattr(res, f))
                            for f in ("R", "t", "X", "cost"))
    lap("ba")

    # (c) the other frameworks data-parallel against one rank
    out["fw"] = _p32_fw_arms(rank, work, mesh)
    lap("frameworks")
    # (d) Gan2Shape replicated on the mesh; rank 1 also without one
    from deep3dmap_tpu_torch.parallel.mesh import Mesh

    g2s_batch = torch.load(os.path.join(work, "p32_arms.pt"), weights_only=False)["gan2shape"]
    g2s, heads = _p32_g2s_fit(mesh, g2s_batch)
    g2s["heads_sha1"] = _sha1(heads)
    out["raster_launches"] = g2s["launches"]["fit"]
    if rank == 1:
        one, one_heads = _p32_g2s_fit(Mesh(("data",), (1,), None, torch.device("cuda")),
                                      g2s_batch)
        g2s["one_rank_equal"] = (all(torch.equal(heads[n], one_heads[n]) for n in heads)
                                 and one["logs"] == g2s["logs"]
                                 and one["step3"] == g2s["step3"])
    out["g2s"] = g2s
    del heads
    lap("gan2shape")
    # (e) the spatial path's checkpoint of whole volumes, resumed on the mesh and on one rank
    out["ckpt"] = count(lambda: _p32_ckpt_arm(rank, work, data["frag"], ckpt_slabs))
    lap("checkpoint")
    # (g) tools/test.py on both ranks, the scene's fragments in order
    got = _p32_test_outputs([SCANNET_SYN_CFG, "--work-dir", os.path.join(work, "p32_test"),
                             "--device", P32_DEVICE, "--launcher", "pytorch",
                             "--cfg-options", *P32_TEST_OPTS])
    ref = torch.load(_p32_wait_file(os.path.join(work, "p32_test_ref.pt")),
                     weights_only=False)
    out["test"] = dict(n=[len(got), len(ref)], max_abs=max(
        float((g[k] - r[k]).abs().max()) for g, r in zip(got, ref) for k in r)
        if len(got) == len(ref) else None, keys=sorted(got[0]) if got else [])
    lap("test_cli")
    return out


def _sha1(tensors: dict) -> str:
    import hashlib

    h = hashlib.sha1()
    for n in sorted(tensors):
        h.update(n.encode())
        h.update(tensors[n].contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


# (c)'s frameworks, TF32 off.  Against the same shards stepped one after
# another in one process (``_p32_split_step``: the data-parallel step's
# arithmetic without its collectives): the loss and gradients to float32
# rounding of the sums' order.  Against one rank on the whole batch: the
# float32 bounds of (b)'s NeuralRecon arm, or no farther than twice the
# same shards in one process are (cuDNN picks other algorithms for a
# batch of 8 than of 16: on an H100 (700 W) PRNet's whole gradient sits
# 2.05e-3 from one rank's, past the flat 2e-3, and its shards in one
# process exactly as far); a backward fed each rank's own means is ~1 off.
TOL_P32_SPLIT = dict(loss=1e-6, whole=1e-5, leaf=1e-4)
TOL_P32_FW = dict(loss=1e-5, whole=2e-3, leaf=2e-2)
P32_FW = ("prnet", "imgs2mesh", "gnerf", "lerf")
P32_DEVICE = "cuda"                        # (c)-(e)'s device ("cpu" rehearses them)
G2S_CELEBA_CFG = os.path.join("configs", "gan2shape", "celeba.py")
SCANNET_SYN_CFG = os.path.join("configs", "neural_recon", "scannet_synthetic.py")
P32_GNERF_STATE = "ABAB"                   # blender.py's second state: every sequence
P32_G2S_ITERS = (1, 1, 1)                  # one step per mode; celeba: (600, 600, 400)
TOL_P32_VAL = 1e-5
# tools/test.py over 2 ranks on a scene's fragments in order against one rank
P32_TEST_FRAGMENTS = 3
P32_TEST_OPTS = ["data.test.type=ChipSmokeSceneStream",
                 f"data.test.n_samples={P32_TEST_FRAGMENTS}",
                 "model.model_cfgs.save_scene=False"]


def _register_scene_stream():
    """``ChipSmokeSceneStream``: the synthetic fragments of one scene in
    order, the recurrent state reset only at the first."""
    from deep3dmap_tpu_torch.datasets.builder import DATASETS
    from deep3dmap_tpu_torch.datasets.synthetic import SyntheticScanNetDataset

    if DATASETS.get("ChipSmokeSceneStream") is not None:
        return

    @DATASETS.register_module()
    class ChipSmokeSceneStream(SyntheticScanNetDataset):
        def __getitem__(self, idx):
            return dict(super().__getitem__(idx), scene_reset=np.float32(idx == 0))


def _p32_test_outputs(argv):
    """tools/test.py's main on ``argv``: each batch's global outputs, on the host."""
    from deep3dmap_tpu_torch.runners import forward_engine
    from deep3dmap_tpu_torch.tools import test as test_cli

    _register_scene_stream()
    seen, real = [], forward_engine.global_outputs

    def rec(out, batch, mesh=None):
        out = real(out, batch, mesh)
        seen.append({k: v.detach().float().cpu() for k, v in out.items()})
        return out
    forward_engine.global_outputs = rec
    try:
        test_cli.main(argv)
    finally:
        forward_engine.global_outputs = real
    return seen


def _p32_worst(a: dict, b: dict, floor_frac: float = 1e-2):
    """``_worst_leaf`` with each leaf's error relative to at least
    ``floor_frac`` of the largest leaf's norm (a leaf whose gradient is zero
    up to rounding, as GNeRF's attention key bias, is measured against it)."""
    floor = floor_frac * max(float(a[n].double().norm()) for n in a)
    rel = {n: float((a[n].double() - b[n].double()).norm()
                    / max(float(a[n].double().norm()), floor)) for n in a}
    name = max(rel, key=rel.get)
    flat_a = torch.cat([a[n].double().ravel() for n in a])
    flat_b = torch.cat([b[n].double().ravel() for n in a])
    return name, rel[name], float((flat_a - flat_b).norm() / flat_a.norm())


def _p32_build(name, arm):
    """The framework of arm ``name`` at its published model width, its
    seeded net and model state."""
    from deep3dmap_tpu_torch.models.frameworks.gnerf import GanNerf
    from deep3dmap_tpu_torch.models.frameworks.imgs2mesh import Imgs2Mesh
    from deep3dmap_tpu_torch.models.frameworks.lerf import LERFModel
    from deep3dmap_tpu_torch.models.frameworks.prnet import FaceImg2UV

    cls = dict(prnet=FaceImg2UV, imgs2mesh=Imgs2Mesh, gnerf=GanNerf, lerf=LERFModel)[name]
    fw = cls(arm["model_cfgs"], device=P32_DEVICE)
    if name == "gnerf":
        fw.ray_sampler.set_start_intrinsics(arm["intrinsics"])
        fw.n_train_images, fw.n_val_images = arm["n_train"], 1
    net, ms = fw.init(0, arm["batch"])
    return fw, net, ms


def _p32_steps(name, fw):
    """(label, loss_fn keywords, the collections it updates) of each step
    of arm ``name``: GNeRF's every sequence of ABAB, imgs2mesh's states."""
    if name == "gnerf":
        return [(seq, dict(state=P32_GNERF_STATE, opt_seq=seq), fw.optseq2netnames(seq))
                for seq in fw.setup_optimize_sequences(P32_GNERF_STATE)]
    if name == "imgs2mesh":
        return [(st, dict(state=st), None) for st in I2F_STATES]
    return [("step", {}, None)]


def _p32_fw_step(fw, net, ms, batch, kw, names, group, seed):
    """One step: the backward, the gradients of ``names`` (all when None)
    summed over ``group``; the loss, logs and gradients (host copies)."""
    from deep3dmap_tpu_torch.parallel import collectives

    net.zero_grad(set_to_none=True)
    mods = [net] if names is None else [getattr(net, n) for n in names]
    extra = {}
    if hasattr(fw, "draws"):
        extra["rng"] = torch.Generator(device=P32_DEVICE).manual_seed(seed)
    loss, aux = fw.loss_fn(net, ms, batch, **kw, **extra)
    loss.backward()
    if group is not None:
        collectives.reduce_gradients([p for m in mods for p in m.parameters()], group)
    grads = {f"{i}.{n}": (p.grad if p.grad is not None else torch.zeros_like(p))
             .detach().cpu().clone() for i, m in enumerate(mods)
             for n, p in m.named_parameters()}
    return dict(loss=float(loss.detach()),
                logs={k: float(v.detach()) for k, v in aux["log_vars"].items()}), grads


def _p32_slice(tree, r: int, n: int):
    """Shard ``r`` of ``n`` along dim 0 of every tensor or array of ``tree``
    whose leading dim divides (``shard_batch``'s rule); others whole."""
    if isinstance(tree, dict):
        return {k: _p32_slice(v, r, n) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_p32_slice(v, r, n) for v in tree]
    if isinstance(tree, (torch.Tensor, np.ndarray)) and tree.ndim and tree.shape[0] % n == 0:
        k = tree.shape[0] // n
        return tree[r * k:(r + 1) * k]
    return tree


def _p32_split_step(name, fw, net, ms, batch, kw, names, seed, n, glob_samples):
    """The data-parallel step's arithmetic in one process: the global
    batch's ``n`` shards one after another with no group, each with its
    slice of the global batch's draws and importance samples, its loss
    scaled by 1 / n, the gradients accumulated.  Equal shards make that the
    global mean's gradient; the step's own collectives are what it leaves
    out.  Returns (loss, gradients) as ``_p32_fw_step`` does."""
    from deep3dmap_tpu_torch.models.modulars import gnerf as gnerf_mod

    net.zero_grad(set_to_none=True)
    mods = [net] if names is None else [getattr(net, m) for m in names]
    draws = None
    if name == "gnerf":
        draws = fw.draws(torch.Generator(device=P32_DEVICE).manual_seed(seed),
                         kw["opt_seq"], len(batch["imgs"]))
    elif name == "lerf":
        draws = fw.draws(torch.Generator(device=P32_DEVICE).manual_seed(seed),
                         len(batch["rays_o"]))
    real_pdf, total = gnerf_mod.sample_pdf, 0.0
    for r in range(n):
        queue = [_p32_slice(z, r, n) for z in glob_samples]
        gnerf_mod.sample_pdf = lambda *a, **kws: queue.pop(0)
        try:
            extra = {} if draws is None else {"draws": _p32_slice(draws, r, n)}
            loss, _ = fw.loss_fn(net, ms, _p32_slice(batch, r, n), **kw, **extra)
            (loss / n).backward()
            total += float(loss.detach()) / n
        finally:
            gnerf_mod.sample_pdf = real_pdf
    grads = {f"{i}.{k}": (p.grad if p.grad is not None else torch.zeros_like(p))
             .detach().cpu().clone() for i, m in enumerate(mods)
             for k, p in m.named_parameters()}
    return total, grads


def _p32_fw_arms(rank, work, mesh):
    """(c): PRNet, imgs2mesh, GNeRF and LERF data-parallel at their
    published model widths on their full-width phases' first batches, this
    rank's share of each (``shard_batch(global_batch=True)``), one step of
    each optimize sequence with draws from a seeded generator (the global
    batch's, sliced); the same with this rank's own means (the fault);
    then rank ``k % 2`` computes arm k's one rank on the whole batch (GNeRF
    replaying the ranks' importance samples) and compares."""
    from deep3dmap_tpu_torch.models.modulars import gnerf as gnerf_mod
    from deep3dmap_tpu_torch.parallel import collectives, shard_batch

    arms = torch.load(os.path.join(work, "p32_arms.pt"), weights_only=False)
    group = mesh.group("data")
    out = {}
    for k, name in enumerate(P32_FW):
        t0 = time.perf_counter()
        arm = arms[name]
        fw, net, ms = _p32_build(name, arm)
        fw.set_mesh(mesh)
        local = shard_batch(arm["batch"], mesh, global_batch=True)
        samples, real_pdf = {}, gnerf_mod.sample_pdf
        dp, mine = {}, {}
        for i, (label, kw, names) in enumerate(_p32_steps(name, fw)):
            seen = samples.setdefault(label, [])

            def rec(*a, **kws):
                z = real_pdf(*a, **kws)
                seen.append(z.detach())
                return z
            gnerf_mod.sample_pdf = rec
            try:
                dp[label], mine[label] = _p32_fw_step(fw, net, ms, local, kw, names, group,
                                                      100 + i)
            finally:
                gnerf_mod.sample_pdf = real_pdf
        label, kw, names = _p32_steps(name, fw)[0]
        g, fw.loss_group = fw.loss_group, None
        try:
            _, own = _p32_fw_step(fw, net, ms, local, kw, names, group, 100)
        finally:
            fw.loss_group = g
        # the global batch's importance samples, the ranks' put together
        glob = {lb: [collectives.gather_rows(z, group, 0) for z in zs]
                for lb, zs in samples.items()}
        res = dict(dp=dp, checksum=float(sum(float(v.double().abs().sum())
                                             for m in mine.values() for v in m.values())))
        if k % 2 == rank:
            batch, fw.loss_group = arm["batch"], None      # one rank: no group
            n = mesh.shape["data"]
            worst = {}
            for i, (label, kw, names) in enumerate(_p32_steps(name, fw)):
                queue = list(glob[label])
                gnerf_mod.sample_pdf = lambda *a, **kws: queue.pop(0)
                try:
                    ref, ref_grads = _p32_fw_step(fw, net, ms, batch, kw, names, None,
                                                  100 + i)
                finally:
                    gnerf_mod.sample_pdf = real_pdf
                split_loss, split_grads = _p32_split_step(name, fw, net, ms, batch, kw, names,
                                                          100 + i, n, glob[label])
                leaf, leaf_rel, whole = _p32_worst(ref_grads, mine[label])
                s_leaf, s_leaf_rel, s_whole = _p32_worst(split_grads, mine[label])
                r_leaf, r_leaf_rel, r_whole = _p32_worst(ref_grads, split_grads)
                logs_rel = max([abs(dp[label]["logs"][x] - v) / max(abs(v), 1e-12)
                                for x, v in ref["logs"].items()] or [0.0])
                worst[label] = dict(
                    ref_loss=ref["loss"], loss_rel=abs(dp[label]["loss"] - ref["loss"])
                    / abs(ref["loss"]), logs_rel=logs_rel, whole_rel=whole, worst_leaf=leaf,
                    worst_rel=leaf_rel, split_loss_rel=abs(dp[label]["loss"] - split_loss)
                    / abs(split_loss), split_whole_rel=s_whole, split_worst_leaf=s_leaf,
                    split_worst_rel=s_leaf_rel, split_vs_one_whole_rel=r_whole,
                    split_vs_one_worst_rel=r_leaf_rel)
                if i == 0:
                    res["own_whole_rel"] = _p32_worst(ref_grads, own)[2]
            res["vs_one_rank"] = worst
        res["s"] = time.perf_counter() - t0
        out[name] = res
        del fw, net, ms, local, mine, own, glob, samples
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _p32_g2s_fit(mesh, batch):
    """celeba.py's Gan2Shape on ``Gan2ShapeRunner`` over ``mesh``: one step
    of each mode (``fit_instance`` at ``P32_G2S_ITERS``, one stage); the
    heads after it, its logs, its step-3 indices and the raster's launches
    per mode."""
    from deep3dmap_tpu_torch.models.frameworks.gan2shape import Gan2Shape
    from deep3dmap_tpu_torch.parallel import collectives
    from deep3dmap_tpu_torch.runners import gan2shape_runner as gr
    from deep3dmap_tpu_torch.utils.config import Config

    mc = dict(Config.fromfile(G2S_CELEBA_CFG).model["model_cfgs"], gan_ckpt=None,
              parsing_ckpt=None, use_mask=False, raster_mode="hard")
    fw = Gan2Shape(mc, device=P32_DEVICE)
    runner = gr.Gan2ShapeRunner(fw, G2S_ADAM, stage_iters=P32_G2S_ITERS, num_stage=1,
                                mesh=mesh)
    runner.setup(batch)
    drawn, launches, real_idx, real_step = [], {}, gr.step3_indices, runner.train_step

    def idx(*a):
        drawn.append(real_idx(*a).tolist())
        return real_idx(*a)

    def step(mode, b):
        n = counter("raster.launches")
        log = real_step(mode, b)
        launches[mode] = launches.get(mode, 0) + counter("raster.launches") - n
        return log
    gr.step3_indices, runner.train_step = idx, step
    collectives.reset_counts()
    n0 = counter("raster.launches")
    try:
        runner.fit_instance(batch)
    finally:
        gr.step3_indices = real_idx
    launches["fit"] = counter("raster.launches") - n0
    heads = {n: p.detach().cpu().clone() for n, p in runner.net.state_dict().items()}
    out = dict(logs=runner.logs, step3=drawn, launches=launches, grouped=fw.loss_group
               is not None, counts=collectives.counts())
    del runner, fw
    gc.collect()
    torch.cuda.empty_cache()
    return out, heads


def _p32_ckpt_arm(rank, work, frag, mine):
    """(e): (b)'s spatial checkpoint (``scannet.py``'s dense model over
    ("data", "model") = (1, 2) after its step; ``mine`` this rank's slabs
    then): whole volumes in the file, resumed on the mesh (each rank's
    slabs back, the next step's loss-kernel launches) and, on rank 0, on
    one rank (whole volumes, the next step against the mesh's)."""
    import torch.distributed as dist

    from deep3dmap_tpu_torch.models.frameworks import neuralrecon as nr
    from deep3dmap_tpu_torch.parallel import make_mesh
    from deep3dmap_tpu_torch.parallel.mesh import Mesh
    from deep3dmap_tpu_torch.runners.checkpoint import latest_checkpoint, load_checkpoint_raw
    from deep3dmap_tpu_torch.runners.epoch_based_runner import EpochBasedRunner
    from deep3dmap_tpu_torch.utils.config import Config

    cfg = dict(Config.fromfile(SCANNET_CFG).model["model_cfgs"])
    mesh2 = make_mesh(("data", "model"), (1, 2), device=P32_DEVICE)

    def runner(mesh, d):
        r = EpochBasedRunner(nr.NeuralRecon(cfg, device=P32_DEVICE), work_dir=d, mesh=mesh,
                             max_epochs=1)
        r.setup(frag, optimizer=ADAM, optimizer_config=dict(grad_clip=CLIP))
        return r

    def step(r):
        n = loss_launches()
        log = r.run_iter(frag)
        grads = {n: p.grad.detach().cpu().clone() for n, p in r.state.net.named_parameters()}
        return float(log["loss"]), grads, [counter("fused_loss.fwd_launches") - n[0],
                                           counter("fused_loss.bwd_launches") - n[1]]

    def slabs(r):
        return [v.detach().cpu().clone() for v in r.state.model_state["global_hidden"].volumes]

    dist.barrier()
    path = latest_checkpoint(os.path.join(work, "p32_ckpt"))
    whole = load_checkpoint_raw(path, "cpu")["model_state"]
    out = dict(saved_is_whole=all(w.shape[1] == w.shape[2] == 2 * m.shape[1]
                                  for w, m in zip(whole, mine)),
               saved_has_my_slabs=all(
                   torch.equal(w[:, rank * m.shape[1]:(rank + 1) * m.shape[1]], m)
                   for w, m in zip(whole, mine)))
    r = runner(mesh2, os.path.join(work, "p32_ckpt_mesh"))
    out["spatial_on"] = r.spatial
    r.resume(path)
    out["resumed_slabs_equal"] = all(torch.equal(a, b) for a, b in zip(slabs(r), mine))
    loss, grads, launches = step(r)
    out.update(resumed_loss=loss, resumed_launches=launches)
    del r
    gc.collect()
    torch.cuda.empty_cache()
    if rank == 0:
        one = Mesh(("data",), (1,), None, torch.device(P32_DEVICE))
        r = runner(one, os.path.join(work, "p32_ckpt_one"))
        r.resume(path)
        out["one_rank_whole"] = all(torch.equal(a, b) for a, b in zip(slabs(r), whole))
        ref_loss, ref_grads, _ = step(r)
        name, worst, whole_rel, _ = _worst_leaf(ref_grads, grads)
        out.update(one_rank_loss=ref_loss, grad_whole_rel=whole_rel, grad_worst_leaf=name,
                   grad_worst_rel=worst)
        del r
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _p32_wait_file(path):
    t0 = time.perf_counter()
    while not os.path.exists(path):
        if time.perf_counter() - t0 > P32_TIMEOUT:
            raise TimeoutError(f"{os.path.basename(path)} did not come")
        time.sleep(0.2)
    return path


def _phase32_rank(job, rank, world, init, work):
    """One of (b)'s ranks (``--phase32-rank``): it starts while (a) runs,
    imports what it needs and waits for (a)'s go file, written when (a)'s
    timed steps are done, before it touches the card."""
    import torch.distributed as dist

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    rank, world = int(rank), int(world)
    import deep3dmap_tpu_torch.core.sfm  # noqa: F401
    import deep3dmap_tpu_torch.models.frameworks.gan2shape  # noqa: F401
    import deep3dmap_tpu_torch.models.frameworks.gnerf  # noqa: F401
    import deep3dmap_tpu_torch.models.frameworks.imgs2mesh  # noqa: F401
    import deep3dmap_tpu_torch.models.frameworks.lerf  # noqa: F401
    import deep3dmap_tpu_torch.models.frameworks.neuralrecon  # noqa: F401
    import deep3dmap_tpu_torch.models.frameworks.prnet  # noqa: F401
    import deep3dmap_tpu_torch.parallel.spatial  # noqa: F401
    import deep3dmap_tpu_torch.tools.test  # noqa: F401
    _p32_wait_file(os.path.join(work, "p32_go"))
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
    try:
        out = _p32_gloo_two(rank, work)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(work, f"p32_{job}_{rank}.json"), "w") as f:
        json.dump(out, f)


def _p32_nccl_here(work) -> dict:
    """(a) in this process, which phase 10 already warmed for the bench
    config's step: one NCCL rank; its result as (b)'s ranks report theirs
    (through JSON)."""
    import torch.distributed as dist

    dist.init_process_group("nccl", init_method="file://" + os.path.join(
        work, "p32_nccl1_store"), rank=0, world_size=1)
    try:
        return json.loads(json.dumps(_p32_nccl_one(0, work)))
    finally:
        dist.destroy_process_group()


def _p32_start(job, world, work) -> list:
    """``world`` ranks of ``job`` as processes of this script."""
    init = "file://" + os.path.join(work, f"p32_{job}_store")
    return [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--phase32-rank",
                              job, str(r), str(world), init, work],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(world)]


def _p32_wait(job, procs, work) -> list:
    """Each rank's exit (a failure or the timeout ends the run); their JSON."""
    errs = []
    try:
        for r, p in enumerate(procs):
            try:
                _, err = p.communicate(timeout=P32_TIMEOUT)
            except subprocess.TimeoutExpired:
                errs.append(f"rank {r} of {job} passed {P32_TIMEOUT} s")
                continue
            if p.returncode:
                errs.append(f"rank {r} of {job} exited {p.returncode}: {err[-3000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    check(not errs, "; ".join(errs))
    outs = []
    for r in range(len(procs)):
        with open(os.path.join(work, f"p32_{job}_{r}.json")) as f:
            outs.append(json.load(f))
    return outs


def _p32_check_a(card, a):
    """(a)'s line and checks."""
    ng, nc = a["no_group"], a["nccl"]
    print(f"multi32 (a) one NCCL rank: card={card!r} train_step_ms_median nccl="
          f"{statistics.median(nc['ms']):.6f} no_group={statistics.median(ng['ms']):.6f} "
          f"(CUDA events, {P32_STEPS} steps each from the seeded weights) "
          f"losses={nc['losses']!r} losses_bitwise_equal={a['losses_equal']} "
          f"params_bitwise_equal={a['params_equal']} loss_launches_per_step={nc['launches']!r} "
          f"collectives_per_step={nc['counts']!r} host_syncs={a['syncs']}", flush=True)
    check(a["losses_equal"] and a["params_equal"],
          "(a) one NCCL rank differs from no group")
    check(nc["launches"] == ng["launches"] == [[3, 1]] * P32_STEPS,
          f"(a) loss launches {nc['launches']} / {ng['launches']}")
    check(all(c.get("all_reduce", 0) >= 2 and set(c) == {"all_reduce"} for c in nc["counts"])
          and all(c == {} for c in ng["counts"]), f"(a) collectives {nc['counts']}")
    check(a["syncs"] == 0, f"(a) {a['syncs']} host syncs in the distributed step")


def _p32_prebuild(root: str):
    """Phase 32's second bench fragment (seed 1; its host ray marching takes
    ~15-23 s) built by a child process of lower priority, on the CPU,
    while the phases before 32 run; its path and process."""
    import atexit

    path = os.path.join(root, "p32_seed1.pt")
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--p32-fragment", path],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def stop():                       # a failed phase exits: stop the child too
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    atexit.register(stop)
    return path, proc


def _p32_build_fragment(path: str):
    """The child of ``_p32_prebuild`` (``--p32-fragment``)."""
    os.nice(10)
    torch.set_num_threads(1)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from deep3dmap_tpu_torch.datasets.synthetic import make_fragment_sample

    sample = make_fragment_sample(seed=1, n_views=N_VIEWS, img_size=IMG_HW, n_vox=N_VOX,
                                  voxel_size=0.04, device="cpu")
    torch.save(sample, path + ".tmp")
    os.replace(path + ".tmp", path)


def phase_multi_gpu(card, stack, make_sample, work, prebuilt=None):
    phase("multi-GPU on torch.distributed: (a) the bench config's step at one NCCL rank "
          "against no group; (b) two gloo ranks on the card: data parallel, scannet.py's "
          "spatial path over (data, model) = (1, 2), the sharded LM")
    t_phase = time.perf_counter()
    samples = [make_sample(seed=0, n_views=N_VIEWS, img_size=IMG_HW, n_vox=N_VOX,
                           voxel_size=0.04, device="cuda")]
    if prebuilt is None:
        samples.append(make_sample(seed=1, n_views=N_VIEWS, img_size=IMG_HW, n_vox=N_VOX,
                                   voxel_size=0.04, device="cuda"))
    else:
        path, proc = prebuilt
        _, err = proc.communicate(timeout=P32_TIMEOUT)
        check(proc.returncode == 0, f"the seed-1 fragment's build exited {proc.returncode}: "
              f"{err[-2000:]}")
        samples.append(torch.load(path, weights_only=False))
    walls = {"fragments": time.perf_counter() - t_phase}
    frag, pair = stack(samples[:1]), stack(samples)
    torch.save(frag, os.path.join(work, "p32_bench.pt"))
    torch.save(dict(pair=pair, frag=frag), os.path.join(work, "p32_gloo.pt"))
    from deep3dmap_tpu_torch.datasets.gan_faces import SyntheticGanFaceDataset

    missing = [n for n in P32_FW if n not in _ARM_BATCHES]
    check(not missing, f"phase 32 (c) needs the batches of phases 17, 18, 20 and 23: "
          f"{missing} missing")
    torch.save(dict(_ARM_BATCHES, gan2shape=SyntheticGanFaceDataset(
        n_samples=1, image_size=128, z_dim=512, device="cuda").setup_input(0)),
        os.path.join(work, "p32_arms.pt"))
    walls["saved"] = time.perf_counter() - t_phase - sum(walls.values())

    b_procs = _p32_start("gloo2", 2, work)      # import while (a) runs
    try:
        a = _p32_nccl_here(work)
        walls["a"] = time.perf_counter() - t_phase - sum(walls.values())
        _p32_check_a(card, a)
    except BaseException:                       # a failed check exits: stop (b)
        for p in b_procs:
            p.kill()
            p.communicate()
        raise

    b = _p32_wait("gloo2", b_procs, work)
    walls["b"] = time.perf_counter() - t_phase - sum(walls.values())
    b0 = b[0]
    for arm, _, _ in P32_DP_ARMS:
        d = [r["dp"][arm] for r in b]
        dp_rel = abs(d[0]["loss"] - d[0]["ref_loss"]) / abs(d[0]["ref_loss"])
        print(f"multi32 (b) data parallel, 2 gloo ranks on the card, bench config at {arm}, "
              f"global batch 2: card={card!r} loss={d[0]['loss']!r} one_rank_loss="
              f"{d[0]['ref_loss']!r} rel={dp_rel:.3e} worst_grad_leaf={d[0]['worst_leaf']} "
              f"rel={d[0]['worst_rel']:.3e} whole_grad_rel={d[0]['whole_rel']:.3e} "
              f"loss_mask_voxels_per_level={[r['mask_voxels'] for r in d]} "
              f"differing_from_one_rank={[r['mask_diff'] for r in d]} "
              f"backward_kernel_on_global_sums_vs_plain_max_abs="
              f"{[r['bwd_err'] for r in d]} own_sums_backward_rel="
              f"{[round(r['own_sums_rel'], 4) for r in d]} (TF32 off)", flush=True)
        check(all(r["loss"] == d[0]["loss"] for r in d), f"(b) {arm}: the ranks' losses differ")
        check(all(r["worst_rel"] == d[0]["worst_rel"] for r in d),
              f"(b) {arm}: the ranks' summed gradients differ")
        tol = TOL_P32_DP[arm]
        check(min(r["own_sums_rel"] for r in d) > 2 * tol["whole"],
              f"(b) {arm}: a backward fed one rank's own sums is only "
              f"{[r['own_sums_rel'] for r in d]} off the global one")
        check(dp_rel <= tol["loss"], f"(b) {arm}: data parallel loss {dp_rel} from one "
              f"rank's (bound {tol['loss']})")
        check(d[0]["whole_rel"] <= tol["whole"], f"(b) {arm}: data parallel gradient "
              f"{d[0]['whole_rel']} from one rank's (bound {tol['whole']})")
        check(d[0]["worst_rel"] <= tol.get("leaf", np.inf), f"(b) {arm}: gradient leaf "
              f"{d[0]['worst_leaf']} {d[0]['worst_rel']} from one rank's (bound {tol})")
    sp_rel = abs(b0["spatial_loss"] - b0["spatial_ref_loss"]) / abs(b0["spatial_ref_loss"])
    print(f"multi32 (b) {SCANNET_CFG} spatial over (data, model) = (1, 2): card={card!r} "
          f"spatial_on={[r['spatial_on'] for r in b]} halo_gru_max_abs_err="
          f"{[r['halo_err'] for r in b]} (bound {TOL_P32_HALO}) global_volume_bytes_per_rank="
          f"{[r['volume_bytes'] for r in b]} one_rank={b0['whole_volume_bytes']} "
          f"train_step_ms={[r['spatial_ms'] for r in b]} loss={b0['spatial_loss']!r} "
          f"unsharded_loss={b0['spatial_ref_loss']!r} rel={sp_rel:.3e} "
          f"grad_whole_rel={b0['spatial_grad_whole_rel']:.3e} worst_grad_leaf="
          f"{b0['spatial_grad_worst_leaf']} rel={b0['spatial_grad_worst_rel']:.3e} "
          f"grads_bitwise_equal={b0['spatial_grad_equal']} params_after_step_max_abs_diff="
          f"{b0['spatial_param_max_abs']:.3e} "
          f"collectives_per_step={b0['spatial_counts']!r} "
          f"peak_bytes={[r['peak_bytes'] for r in b]}", flush=True)
    check(all(r["spatial_on"] for r in b), "(b) the spatial path did not switch on")
    check(max(r["halo_err"] for r in b) <= TOL_P32_HALO, "(b) halo GRU off the whole cell")
    check(all(2 * r["volume_bytes"] == b0["whole_volume_bytes"] for r in b),
          "(b) a rank holds more than half the global volumes")
    check(sp_rel <= 1e-3, f"(b) spatial step's loss {sp_rel} from the unsharded step's")
    check(b0["spatial_grad_whole_rel"] <= TOL_P32_SPATIAL_GRAD["whole"]
          and b0["spatial_grad_worst_rel"] <= TOL_P32_SPATIAL_GRAD["leaf"],
          f"(b) spatial step's gradient from the unsharded step's: whole "
          f"{b0['spatial_grad_whole_rel']}, {b0['spatial_grad_worst_leaf']} "
          f"{b0['spatial_grad_worst_rel']} (bounds {TOL_P32_SPATIAL_GRAD})")
    print(f"multi32 (b) lm_solve_sharded over 2 ranks, phase 27's ring (6 cameras, 64 "
          f"points, float64, {P32_BA_ITERS} iterations): card={card!r} cost="
          f"{b0['ba_cost']!r} lm_solve_cost={b0['ba_ref_cost']!r} max_rel={b0['ba_rel']:.3e} "
          f"collectives={b0['ba_counts']!r}", flush=True)
    check(all(r["ba_cost"] == b0["ba_cost"] for r in b), "(b) the ranks' LM results differ")
    check(b0["ba_rel"] <= 1e-8, f"(b) lm_solve_sharded {b0['ba_rel']} from lm_solve")
    launches = [sum(a["nccl"]["launches"][i][j] for i in range(P32_STEPS)) + sum(
        r["launches"][j] for r in b) for j in (0, 1)]
    raster_launches = sum(r["raster_launches"] for r in b)
    print(f"multi32: phase 32 took {time.perf_counter() - t_phase:.3f} s (walls "
          f"{ {k: round(v, 1) for k, v in walls.items()} }, (a)'s arms "
          f"{ {k: round(v, 1) for k, v in a['s'].items()} }, (b)'s parts "
          f"{[{k: round(v, 1) for k, v in r['s'].items()} for r in b]}); loss launches "
          f"(forward, backward) {launches} raster launches {raster_launches} card={card!r}",
          flush=True)
    _p32_check_new_arms(card, b)
    return launches + [raster_launches]


def _p32_rounded(tree):
    return {k: {x: (float(f"{v:.6e}") if isinstance(v, float) else v) for x, v in w.items()}
            for k, w in tree.items()}


def _p32_check_new_arms(card, b):
    """(c)-(g)'s lines, every one printed before the first check fails."""
    checks = []
    for name in P32_FW:
        d = [r["fw"][name] for r in b]
        ref = next(r["vs_one_rank"] for r in d if "vs_one_rank" in r)
        own = next(r["own_whole_rel"] for r in d if "own_whole_rel" in r)
        print(f"multi32 (c) {name} data parallel, 2 gloo ranks on the card, "
              f"published model width, global batch split over data: card={card!r} "
              f"per_step={_p32_rounded(ref)} own_means_whole_rel={own:.3e} "
              f"seconds={[round(r['s'], 1) for r in d]} (TF32 off)", flush=True)
        checks.append((all(r["dp"] == d[0]["dp"] for r in d)
                       and d[0]["checksum"] == d[1]["checksum"],
                       f"(c) {name}: the ranks' losses or summed gradients differ"))
        for label, w in ref.items():
            checks.append((w["split_loss_rel"] <= TOL_P32_SPLIT["loss"]
                           and w["split_whole_rel"] <= TOL_P32_SPLIT["whole"]
                           and w["split_worst_rel"] <= TOL_P32_SPLIT["leaf"],
                           f"(c) {name} {label}: against its shards in one process: loss "
                           f"{w['split_loss_rel']}, gradient {w['split_whole_rel']}, "
                           f"{w['split_worst_leaf']} {w['split_worst_rel']} "
                           f"(bounds {TOL_P32_SPLIT})"))
            checks.append((w["loss_rel"] <= TOL_P32_FW["loss"]
                           and w["logs_rel"] <= TOL_P32_FW["loss"],
                           f"(c) {name} {label}: loss {w['loss_rel']} / logs {w['logs_rel']} "
                           f"from one rank's (bound {TOL_P32_FW['loss']})"))
            whole_bound = max(TOL_P32_FW["whole"], 2 * w["split_vs_one_whole_rel"])
            leaf_bound = max(TOL_P32_FW["leaf"], 2 * w["split_vs_one_worst_rel"])
            checks.append((w["whole_rel"] <= whole_bound and w["worst_rel"] <= leaf_bound,
                           f"(c) {name} {label}: gradient whole {w['whole_rel']}, "
                           f"{w['worst_leaf']} {w['worst_rel']} from one rank's (bounds "
                           f"{whole_bound}, {leaf_bound})"))
        checks.append((own > 2 * TOL_P32_FW["whole"],
                       f"(c) {name}: a backward fed each rank's own means is only {own} off"))
    g = [r["g2s"] for r in b]
    print(f"multi32 (d) Gan2Shape replicated, celeba.py model (128², hard raster), 2 gloo "
          f"ranks, one step per mode: card={card!r} raster_launches_per_rank="
          f"{[x['launches'] for x in g]} heads_sha1={[x['heads_sha1'][:12] for x in g]} "
          f"one_rank_bitwise_equal={g[1].get('one_rank_equal')} step3_indices="
          f"{g[0]['step3']} collectives_in_fit={[x['counts'] for x in g]} "
          f"loss_group={[x['grouped'] for x in g]}", flush=True)
    checks += [
        (all({m: x["launches"][m] for m in G2S_MODES} == {"step1": 1, "step2": 1, "step3": 2}
             for x in g),
         f"(d) raster launches per mode {[x['launches'] for x in g]} (want 1 / 1 / 2)"),
        (g[0]["heads_sha1"] == g[1]["heads_sha1"] and g[0]["logs"] == g[1]["logs"]
         and g[0]["step3"] == g[1]["step3"], "(d) the ranks' Gan2Shape fits differ"),
        (g[1].get("one_rank_equal") is True, "(d) the mesh's fit differs from one rank's"),
        (not any(x["grouped"] for x in g) and all(x["counts"] == {} for x in g),
         "(d) Gan2Shape reduced across ranks")]
    c = [r["ckpt"] for r in b]
    c0 = c[0]
    sp = abs(c0["resumed_loss"] - c0["one_rank_loss"]) / abs(c0["one_rank_loss"])
    print(f"multi32 (e) {SCANNET_CFG} over (data, model) = (1, 2): checkpoint of whole "
          f"volumes card={card!r} spatial_on={[x['spatial_on'] for x in c]} saved_whole="
          f"{[x['saved_is_whole'] for x in c]} holds_each_rank_slabs="
          f"{[x['saved_has_my_slabs'] for x in c]} resumed_slabs_equal="
          f"{[x['resumed_slabs_equal'] for x in c]} resumed_step_loss_launches="
          f"{[x['resumed_launches'] for x in c]} one_rank_whole={c0['one_rank_whole']} "
          f"loss={c0['resumed_loss']!r} one_rank_loss={c0['one_rank_loss']!r} rel={sp:.3e} "
          f"grad_whole_rel={c0['grad_whole_rel']:.3e} worst_grad_leaf="
          f"{c0['grad_worst_leaf']} rel={c0['grad_worst_rel']:.3e}", flush=True)
    checks += [
        (all(x["spatial_on"] and x["saved_is_whole"] and x["saved_has_my_slabs"]
             and x["resumed_slabs_equal"] for x in c), "(e) the checkpoint is not whole, or "
         "a rank's resumed slabs differ from its own"),
        (all(x["resumed_launches"] == [3, 1] for x in c),
         f"(e) the resumed step's loss launches {[x['resumed_launches'] for x in c]}"),
        (c0["one_rank_whole"], "(e) one rank's resumed volumes are not the whole ones"),
        (sp <= 1e-3 and c0["grad_whole_rel"] <= TOL_P32_SPATIAL_GRAD["whole"]
         and c0["grad_worst_rel"] <= TOL_P32_SPATIAL_GRAD["leaf"],
         f"(e) the resumed spatial step from one rank's: loss {sp}, gradient whole "
         f"{c0['grad_whole_rel']}, leaf {c0['grad_worst_rel']}")]
    v = [r["dp"]["f32"] for r in b]
    val_rel = abs(v[0]["val"] - v[0]["ref_val"]) / abs(v[0]["ref_val"])
    print(f"multi32 (f) val on the data axis, bench config at f32, global batch 2: "
          f"card={card!r} val={[x['val'] for x in v]} one_rank_val={v[0]['ref_val']!r} "
          f"rel={val_rel:.3e} forward_launches={[x['val_launches'] for x in v]} "
          f"collectives={[x['val_counts'] for x in v]}", flush=True)
    checks += [
        (v[0]["val"] == v[1]["val"] and val_rel <= TOL_P32_VAL,
         f"(f) val {[x['val'] for x in v]} from one rank's {v[0]['ref_val']}"),
        (all(x["val_launches"] == [3, 0] for x in v),
         f"(f) val's loss launches {[x['val_launches'] for x in v]}")]
    t = [r["test"] for r in b]
    print(f"multi32 (g) tools/test.py on 2 gloo ranks, {P32_TEST_FRAGMENTS} fragments of a "
          f"scene in order, against one rank: card={card!r} batches={[x['n'] for x in t]} "
          f"max_abs_diff={[x['max_abs'] for x in t]} keys={t[0]['keys']}", flush=True)
    checks.append((all(x["n"] == [P32_TEST_FRAGMENTS] * 2 and x["max_abs"] is not None
                       and x["max_abs"] <= 1e-6 for x in t),
                   f"(g) tools/test.py at 2 ranks differs from one rank: {t}"))
    for cond, msg in checks:
        check(cond, msg)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="also profile the full-width NeuralRecon stream, its "
                         "training step, Gan2Shape forward_test, each "
                         "Gan2Shape training mode, a GNeRF ABAB iteration "
                         "and LERF's training steps into DIR")
    ap.add_argument("--phase32-rank", nargs=5, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--p32-fragment", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.phase32_rank:
        return _phase32_rank(*args.phase32_rank)
    if args.p32_fragment:
        return _p32_build_fragment(args.p32_fragment)

    phase("device")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this check needs a CUDA GPU")
    card = device_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count "
          f"{torch.cuda.device_count()}", flush=True)

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import deep3dmap_tpu_torch.models.frameworks.neuralrecon as nr_module
    from deep3dmap_tpu_torch.datasets.builder import _stack_samples
    from deep3dmap_tpu_torch.datasets.synthetic import make_fragment_sample
    from deep3dmap_tpu_torch.ops import fused_loss
    from deep3dmap_tpu_torch.runners import train_state as train_mod
    make_fragment_sample = shared_samples(make_fragment_sample)

    import deep3dmap_tpu_torch.core.renderer.renderer_nr as renderer_mod
    import deep3dmap_tpu_torch.models.frameworks.gan2shape as g2s_module
    from deep3dmap_tpu_torch.datasets.gan_faces import SyntheticGanFaceDataset
    from deep3dmap_tpu_torch.ops import _cuda, raster
    from deep3dmap_tpu_torch.runners import gan2shape_runner as g2s_runner

    import deep3dmap_tpu_torch.datasets.scannet as scannet_mod
    import deep3dmap_tpu_torch.runners.checkpoint as checkpoint_mod
    import deep3dmap_tpu_torch.runners.hooks as hooks_mod
    import deep3dmap_tpu_torch.tools.data_gen_scannet  # noqa: F401
    import deep3dmap_tpu_torch.tools.test  # noqa: F401
    import deep3dmap_tpu_torch.tools.train  # noqa: F401
    from deep3dmap_tpu_torch import tools
    from deep3dmap_tpu_torch.datasets.synthetic import write_scannet_fixture
    from deep3dmap_tpu_torch.ops import native
    from deep3dmap_tpu_torch.utils.device import make_deterministic

    from deep3dmap_tpu_torch.datasets.synthetic import seeded_mnasnet_state_dict
    from deep3dmap_tpu_torch.demos import demo_neucon
    from deep3dmap_tpu_torch.tools import import_weights, quality_regression, run_elastic

    t0 = time.perf_counter()
    loss = phase_kernel_vs_plain(fused_loss)
    loss_bwd = phase_loss_bwd(fused_loss)
    phase_cpu_vs_card(nr_module, _stack_samples, make_fragment_sample)
    phase_train_cpu_vs_card(nr_module, train_mod, _stack_samples,
                            make_fragment_sample)
    launches = phase_full_width(nr_module, _stack_samples, make_fragment_sample, card,
                                args.profile)
    bwd = phase_train_full_width(nr_module, fused_loss, train_mod,
                                 _stack_samples, make_fragment_sample, card,
                                 make_deterministic, args.profile)
    raster_err = phase_raster(raster, renderer_mod, _cuda)
    phase_g2s_cpu_vs_card(g2s_module, SyntheticGanFaceDataset)
    g2s = phase_g2s_full_width(g2s_module, raster, SyntheticGanFaceDataset,
                               card, args.profile)
    phase_g2s_train_cpu_vs_card(g2s_module, g2s_runner, raster, SyntheticGanFaceDataset)
    g2s_train = phase_g2s_train_full_width(g2s_module, g2s_runner, raster,
                                           SyntheticGanFaceDataset, card, args.profile)
    phase_determinism(nr_module, train_mod, g2s_module, g2s_runner, _stack_samples,
                      make_fragment_sample, SyntheticGanFaceDataset, make_deterministic)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        cli_launches = phase_cli_full_width(
            train_mod, card, work, bwd["step_ms_median"], tools, hooks_mod,
            scannet_mod, native, write_scannet_fixture, checkpoint_mod)
        phase_learning(card, work, quality_regression)
        g2s_cli = phase_g2s_cli(card, work, tools, hooks_mod, SyntheticGanFaceDataset,
                                g2s_train["step_ms"])
        # the face workloads, GNeRF and LERF launch none of the repo's kernels
        counts = loss_launches() + (counter("raster.launches"),)
        phase_prnet(card, work, tools)
        phase_imgs2mesh(card, work, tools)
        phase_gnerf_cpu_vs_card(card)
        root = phase_gnerf_full_width(card, work, args.profile)
        phase_gnerf_cli(card, work, tools, root)
        phase_lerf_cpu_vs_card(card)
        ckpts = phase_lerf_full_width(card, work, root, args.profile)
        phase_lerf_cli(card, work, tools, root, ckpts)
        check(loss_launches() + (counter("raster.launches"),) == counts,
              "a face, GNeRF or LERF phase launched a kernel of the NeuralRecon or "
              "Gan2Shape paths")
        # phase 25 trains in the supervisor's child processes: their own
        # counters, reported by the probe hook and summed here
        runtime = phase_runtime(card, work, run_elastic, import_weights,
                                seeded_mnasnet_state_dict, checkpoint_mod)
        reset_counters("fused_loss.")
        demo_launches = phase_demo(card, work, demo_neucon, nr_module, train_mod,
                                   runtime["train_dir"])
        check(loss_launches() == demo_launches,
              "the demo's streaming launched a loss kernel")
    # phase 32's second fragment builds in the background from here on
    p32_dir = tempfile.mkdtemp(prefix="chip_smoke_p32_")
    p32_prebuilt = _p32_prebuild(p32_dir)
    # the SfM layer and the detection data path launch none of the repo's kernels
    counts = loss_launches() + (counter("raster.launches"),)
    phase_sfm(card)
    check(loss_launches() + (counter("raster.launches"),) == counts,
          "the SfM phase launched a kernel of the repo")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_det_") as work:
        phase_detection(card, work)
    check(loss_launches() + (counter("raster.launches"),) == counts,
          "the detection phase launched a kernel of the repo")
    phase_zoo(card)
    check(loss_launches() + (counter("raster.launches"),) == counts,
          "the op zoo launched a kernel of the repo")
    trunk_launches = phase_published_trunk(nr_module, train_mod, _stack_samples,
                                           make_fragment_sample, card, make_deterministic)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_face_") as work:
        counts = loss_launches()
        face_launches = phase_face_leftovers(card, work, tools, g2s_module)
        check(loss_launches() == counts,
              "the face leftovers launched a loss kernel")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_multi_") as work:
        try:
            multi_launches = phase_multi_gpu(card, _stack_samples, make_fragment_sample, work,
                                             p32_prebuilt)
        finally:
            if p32_prebuilt[1].poll() is None:
                p32_prebuilt[1].kill()
                p32_prebuilt[1].communicate()
            shutil.rmtree(p32_dir, ignore_errors=True)
    print(f"phases took {time.perf_counter() - t0:.3f} s", flush=True)

    print(json.dumps({"kernels": [{
        "name": "fused_tsdf_occ_loss",
        "route": "triton",
        "source": "deep3dmap_tpu_torch/ops/fused_loss.py",
        "replaces": "deep3dmap_tpu/ops/pallas_loss.py:32",
        "launches": (launches + cli_launches[0] + runtime["launches"][0] + demo_launches[0]
                     + trunk_launches[0] + multi_launches[0]),
        "max_abs_err": loss["max_abs_err"],
        "ms": loss["ms"],
        "plain_ms": loss["plain_ms"],
        "bound_ms": loss["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
    }, {
        "name": "fused_tsdf_occ_loss_bwd",
        "route": "triton",
        "source": "deep3dmap_tpu_torch/ops/fused_loss.py",
        "replaces": "deep3dmap_tpu/ops/pallas_loss.py:112",
        "launches": (bwd["launches"] + cli_launches[1] + runtime["launches"][1]
                     + demo_launches[1] + trunk_launches[1] + multi_launches[1]),
        "max_abs_err": max(loss_bwd["max_abs_err"], bwd["max_abs_err"]),
        "ms": bwd["ms"],
        "plain_ms": bwd["plain_ms"],
        "bound_ms": bwd["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
    }, {
        "name": "raster_grid_depth_hard",
        "route": "cuda",
        "source": "deep3dmap_tpu_torch/ops/csrc/raster_hard.cu",
        "replaces": "deep3dmap_tpu/ops/raster_pallas.py:76",
        "launches": (g2s["launches"] + g2s_train["launches"] + g2s_cli["launches"]
                     + face_launches + multi_launches[2]),
        "max_abs_err": max(raster_err, g2s["max_abs_err"], g2s_train["max_abs_err"]),
        "ms": g2s["ms"],
        "plain_ms": g2s["plain_ms"],
        "bound_ms": g2s["bound_ms"],
        "bound_by": g2s["bound_by"],
        "library_ms": None,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
