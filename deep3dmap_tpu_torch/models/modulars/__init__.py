"""The port's modulars (the names of
``deep3dmap_tpu/models/modulars/__init__.py``), exported lazily;
``SyncBatchNorm`` (``norm.py``) takes its batch statistics across ranks."""
from ..._lazy import export

_MODULES = {
    "dense3d": ("ConvBlock3D", "ResBlock3D", "UNet3D"),
    "conv_gru3d": ("ConvGRU3D",),
    "global_volume": ("GlobalVolumeState", "read_window", "write_window", "reset_volumes"),
    "gnerf": ("GNeRFRender",),
    "dynamic_patch_discriminator": ("Discriminator",),
    "inversion_net": ("InversionNet",),
    "embeddings": ("PoseParameters", "high_dim_embedding", "r6d2mat", "pose_to_d9"),
    "norm": ("SyncBatchNorm",),
}
__all__, __getattr__, __dir__ = export(__name__, _MODULES)
