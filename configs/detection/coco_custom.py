# The JAX package's detection transforms driven at mmdetection's published
# COCO scale (configs/_base_/datasets/coco_detection.py: img_scale
# (1333, 800), flip ratio 0.5, the ImageNet mean/std in RGB, pad to 32; 80
# classes), on a CustomDataset annotation file.  This is not mmdetection's
# training pipeline and its labels do not line up with its images:
# - Resize stretches to 1333x800 (mmdetection keeps the ratio, 1067x800 for
#   a 640x480 image);
# - there is no LoadAnnotations in the JAX package: GetKeysFromDict hoists
#   the file name (absolute in the annotation file) and the boxes (stored
#   under gt_bboxes/gt_labels beside bboxes/labels);
# - Resize and RandomFlip leave gt_bboxes alone, so the boxes stay in the
#   source frame and unflipped; only AutoAugment's geometric policies move
#   them (ROADMAP.md, "Reference quirks the port keeps", the detection
#   pipelines');
# - PhotoMetricDistortion and AutoAugment are added to drive every
#   transform.
# Set data.*.ann_file to the annotation file
# (deep3dmap_tpu_torch.datasets.synthetic.write_detection_fixture writes one).
img_scale = (1333, 800)
img_norm_cfg = dict(mean=[123.675, 116.28, 103.53], std=[58.395, 57.12, 57.375],
                    to_rgb=True)
policies = [
    [dict(type="Shear", level=6, prob=0.6)],
    [dict(type="Rotate", level=5, prob=0.6)],
    [dict(type="Translate", level=4, prob=0.6)],
    [dict(type="ColorTransform", level=6, prob=0.6)],
    [dict(type="EqualizeTransform", prob=0.6)],
    [dict(type="BrightnessTransform", level=6, prob=0.6)],
    [dict(type="ContrastTransform", level=6, prob=0.6)],
]
train_pipeline = [
    dict(type="GetKeysFromDict", in_dict_key="img_info", out_keys=("filename",)),
    dict(type="GetKeysFromDict", in_dict_key="ann_info", out_keys=("gt_bboxes", "gt_labels")),
    dict(type="LoadImageFromFile", path_key="filename"),
    dict(type="Resize", size=img_scale),
    dict(type="RandomFlip", prob=0.5, seed=0),
    dict(type="PhotoMetricDistortion", seed=0),
    dict(type="AutoAugment", policies=policies),
    dict(type="Normalize", **img_norm_cfg),
    dict(type="Pad", size_divisor=32),
    dict(type="ToTensor", keys=("img",)),
    dict(type="Collect", keys=("img", "gt_bboxes", "gt_labels"), meta_keys=("flipped",)),
]
test_pipeline = [
    dict(type="GetKeysFromDict", in_dict_key="img_info", out_keys=("filename",)),
    dict(type="LoadImageFromFile", path_key="filename"),
    dict(type="MultiScaleFlipAug", img_scale=[img_scale, (666, 400)], flip=True, transforms=[
        dict(type="Resize", size=img_scale),
        dict(type="RandomFlip", prob=0.5),
        dict(type="Normalize", **img_norm_cfg),
        dict(type="Pad", size_divisor=32),
        dict(type="ToTensor", keys=("img",)),
        dict(type="Collect", keys=("img",), meta_keys=("scale", "flip")),
    ]),
]
data = dict(
    samples_per_gpu=1,
    workers_per_gpu=2,
    train=dict(type="CustomDataset", ann_file="", pipeline=train_pipeline),
    test=dict(type="CustomDataset", ann_file="", pipeline=test_pipeline, test_mode=True),
)
evaluation = dict(metric="mAP", iou_thr=[0.5, 0.75], proposal_nums=(100, 300, 1000))
test_cfg = dict(nms=dict(type="nms", iou_threshold=0.5), max_per_img=100)
