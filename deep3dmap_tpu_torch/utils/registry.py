"""Registry: string-name -> class lookup used by the config system (the
port's copy of ``deep3dmap_tpu/utils/registry.py``).

Components register under a name, configs say ``dict(type='Name', ...)``, and
``build_from_cfg`` instantiates them.  Registries may have a parent, so a
child's names are found from the parent and the other way round.
"""
from __future__ import annotations

import inspect
from typing import Any, Callable, Dict, Optional


def build_from_cfg(cfg: dict, registry: "Registry", default_args: Optional[dict] = None) -> Any:
    """Instantiate an object from a config dict.

    Args:
        cfg: must contain the key ``type`` naming a registered class (or a
            class object directly).
        registry: the Registry to look the name up in.
        default_args: fallback kwargs merged in (cfg wins).
    """
    if not isinstance(cfg, dict):
        raise TypeError(f"cfg must be a dict, got {type(cfg)}")
    if "type" not in cfg:
        if default_args is None or "type" not in default_args:
            raise KeyError(f"`cfg` or `default_args` must contain the key 'type', got {cfg}")
    if not isinstance(registry, Registry):
        raise TypeError(f"registry must be a Registry, got {type(registry)}")

    args = dict(cfg)
    if default_args is not None:
        for name, value in default_args.items():
            args.setdefault(name, value)

    obj_type = args.pop("type")
    if isinstance(obj_type, str):
        obj_cls = registry.get(obj_type)
        if obj_cls is None:
            raise KeyError(f"{obj_type} is not in the {registry.name} registry")
    elif inspect.isclass(obj_type) or inspect.isfunction(obj_type):
        obj_cls = obj_type
    else:
        raise TypeError(f"type must be a str or class, got {type(obj_type)}")

    try:
        return obj_cls(**args)
    except Exception as e:  # re-raise with class context for debuggability
        raise type(e)(f"{obj_cls.__name__}: {e}") from e


class Registry:
    """A name -> class map with optional hierarchical scopes."""

    def __init__(self, name: str, build_func: Optional[Callable] = None,
                 parent: Optional["Registry"] = None):
        self._name = name
        self._module_dict: Dict[str, Any] = {}
        self._children: Dict[str, "Registry"] = {}
        self.build_func = build_func or build_from_cfg
        self.parent = parent
        if parent is not None:
            parent._children[name] = self

    def __len__(self):
        return len(self._module_dict)

    def __contains__(self, key):
        return self.get(key) is not None

    def __repr__(self):
        return f"Registry(name={self._name}, items={list(self._module_dict)})"

    @property
    def name(self):
        return self._name

    @property
    def module_dict(self):
        return self._module_dict

    def get(self, key: str) -> Optional[Any]:
        """Look up, checking self then children then parent."""
        if key in self._module_dict:
            return self._module_dict[key]
        for child in self._children.values():
            if key in child._module_dict:
                return child._module_dict[key]
        if self.parent is not None:
            return self.parent.get(key)
        return None

    def build(self, cfg: dict, **default_args) -> Any:
        return self.build_func(cfg, self, default_args=default_args or None)

    def _register(self, cls, name=None, force=False):
        if name is None:
            name = cls.__name__
        names = [name] if isinstance(name, str) else list(name)
        for n in names:
            if not force and n in self._module_dict:
                raise KeyError(f"{n} is already registered in {self._name}")
            self._module_dict[n] = cls
        return cls

    def register_module(self, name=None, force=False, module=None):
        """Use as ``@REG.register_module()`` or ``REG.register_module(module=C)``."""
        if module is not None:
            return self._register(module, name=name, force=force)

        def _decorator(cls):
            return self._register(cls, name=name, force=force)

        return _decorator
