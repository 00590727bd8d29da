"""The runner registry (port of ``deep3dmap_tpu/runners/builder.py``)."""
from ..utils.registry import Registry

RUNNERS = Registry("runner")


def build_runner(cfg, default_args=None):
    from . import epoch_based_runner, gan2shape_runner, state_machine_runner  # noqa: F401

    return RUNNERS.build(dict(cfg), **(default_args or {}))
