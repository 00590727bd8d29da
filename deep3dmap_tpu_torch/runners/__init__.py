"""The port's runners (the names of ``deep3dmap_tpu/runners/__init__.py``),
exported lazily.  ``RUNNERS`` and ``HOOKS`` come filled with every name the
JAX package registers; ``OPTIMIZERS`` names every optimizer of the
factory."""
from .._lazy import export

_MODULES = {
    "builder": ("RUNNERS", "build_runner"),
    "optim": ("OPTIMIZERS", "build_optimizer", "build_lr_schedule"),
    "train_state": ("TrainState",),
    "hooks": ("HOOKS", "Hook", "TextLoggerHook", "CheckpointHook", "IterTimerHook",
              "EvalHook", "build_hook"),
    "base_runner": ("BaseRunner",),
    "epoch_based_runner": ("EpochBasedRunner",),
    "iter_based_runner": ("IterBasedRunner",),
    "state_machine_runner": ("StateMachineRunner",),
    "gan2shape_runner": ("Gan2ShapeRunner",),
    "checkpoint": ("save_checkpoint", "load_checkpoint"),
}
_REGISTERING = ("epoch_based_runner", "iter_based_runner", "state_machine_runner",
                "gan2shape_runner", "hooks", "hooks_extra")

__all__, __getattr__, __dir__ = export(__name__, _MODULES, ("RUNNERS", "HOOKS"), _REGISTERING)
