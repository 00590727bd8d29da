"""The data pipelines (the port's copy of
``deep3dmap_tpu/datasets/pipelines/``): the single-image transforms of the
detection path and NeuralRecon's sequence transforms.  Importing this
package registers every transform in ``PIPELINES``, as JAX's does."""
from .compose import Compose
from .formating import Collect, ToFloat32, ImageToArray
from .loading import LoadImageFromFile, LoadArrayUsingNp, LoadMatDictUsingSio
from .transforms import Resize, Normalize, RandomFlip, Pad, CenterCrop
from .auto_augment import (AutoAugment, BrightnessTransform, ColorTransform,
                           ContrastTransform, EqualizeTransform, Rotate,
                           Shear, Translate)
from .test_time_aug import MultiScaleFlipAug
from .transforms_seq import (
    SeqResizeImage,
    SeqNormalizeImages,
    SeqIntrinsicsPoseToProjection,
    SeqRandomTransformSpace,
)

__all__ = [
    "Compose", "Collect", "ToFloat32", "ImageToArray",
    "LoadImageFromFile", "LoadArrayUsingNp", "LoadMatDictUsingSio",
    "Resize", "Normalize", "RandomFlip", "Pad", "CenterCrop",
    "AutoAugment", "Shear", "Rotate", "Translate", "ColorTransform",
    "EqualizeTransform", "BrightnessTransform", "ContrastTransform",
    "MultiScaleFlipAug",
    "SeqResizeImage", "SeqNormalizeImages",
    "SeqIntrinsicsPoseToProjection", "SeqRandomTransformSpace",
]
