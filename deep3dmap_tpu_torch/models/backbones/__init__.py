"""The port's backbones; importing the package registers each in
``models/builder.py::BACKBONES`` under the JAX package's names."""
from . import (encoder, encoder_decoder, fpn2d, nerf, resfcn256,  # noqa: F401  (register)
               resnet_v1, shape_encoder, vgg)
