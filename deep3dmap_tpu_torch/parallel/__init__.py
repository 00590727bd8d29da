"""The port's multi-GPU layer on ``torch.distributed`` (the names of
``deep3dmap_tpu/parallel/__init__.py``), exported lazily: the rank mesh and
batch placement (``mesh.py``), FSDP / ZeRO placement (``fsdp.py``) and the
spatially sharded volume with its halo ConvGRU (``spatial.py``).  The
collectives they issue are counted in ``collectives.py``."""
from .._lazy import export

_MODULES = {
    "mesh": ("MeshSpec", "make_mesh", "get_dist_info", "init_dist", "shard_batch",
             "replicate", "data_spec", "master_only"),
    "fsdp": ("fsdp_spec", "fsdp_specs", "fsdp_shard", "zero_specs", "zero_shard",
             "separate_group_specs"),
    "spatial": ("conv_gru3d_halo", "halo_pad", "shard_global_volumes",
                "tsdf_fuse_frames_sharded", "volume_sharding"),
}
__all__, __getattr__, __dir__ = export(__name__, _MODULES)
