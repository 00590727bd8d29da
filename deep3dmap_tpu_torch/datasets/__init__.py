"""The port's datasets (the names of ``deep3dmap_tpu/datasets/__init__.py``),
exported lazily: the async producers' processes import this package and
stay without torch.  ``DATASETS`` and ``PIPELINES`` come filled with every
name the JAX package registers."""
from .._lazy import export

_MODULES = {
    "builder": ("DATASETS", "PIPELINES", "build_dataset", "build_dataloader"),
    "synthetic": ("SyntheticScanNetDataset", "make_fragment_sample"),
    "face_tuple": ("SyntheticFaceTupleDataset", "MultiPIEFaceTupleDataset"),
    "nerf_synthetic": ("SyntheticNerfDataset",),
    "face_uv": ("SyntheticFaceUVDataset",),
    "gan_faces": ("SyntheticGanFaceDataset",),
    "lerf_rays": ("LERFRayDataset",),
    "scannet": ("ScanNetDataset",),
    "real_files": ("BlenderDataset", "CelebaDataset", "DTUDataset", "ThreeHundredWLPDataset",
                   "AFLW2000Dataset"),
    "async_producer": ("AsyncProducerDataset", "FaceImagesAsyncDataset",
                       "FaceTexUVAsyncDataset"),
    "custom": ("CustomDataset",),
    "wrappers": ("ClassBalancedDataset", "ConcatDataset", "MultiImageMixDataset",
                 "RepeatDataset"),
    "samplers": ("DistributedGroupSampler", "DistributedSampler", "DistributedVideoSampler",
                 "GroupSampler"),
}
# the submodules that register into DATASETS and PIPELINES: every one above
# but the registries' and the samplers', and the pipelines
_REGISTERING = tuple(m for m in _MODULES if m not in ("builder", "samplers")) + ("pipelines",)

__all__, __getattr__, __dir__ = export(__name__, _MODULES, ("DATASETS", "PIPELINES"),
                                       _REGISTERING)
