"""Lazy package exports, shared by the port's ``__init__.py`` files.

A package lists the names it exports by the submodule that defines each;
a name is imported from its submodule at first use.  So importing one
submodule alone imports none of its siblings: the evaluation's spawned
workers, the host ops and the async producers' processes stay without
torch.  A registry the package exports comes filled, as the JAX package's
eager imports fill it: its first lookup imports every submodule that
registers into it.
"""
from __future__ import annotations

import importlib
import sys
import types
from typing import Dict, Sequence


class _LazyPackage(types.ModuleType):
    def __setattr__(self, name, value):
        # importing a submodule binds it on the package; where an exported
        # function has the submodule's name (``ops.roi_align``), keep the
        # function there, as the JAX package's eager import does (the
        # module stays in ``sys.modules``)
        home = self.__dict__.get("_HOME", {})
        if (isinstance(value, types.ModuleType) and name in home
                and value.__name__ == f"{self.__name__}.{name}"):
            value = getattr(value, name)
        super().__setattr__(name, value)


def export(package: str, modules: Dict[str, Sequence[str]],
           registries: Sequence[str] = (), register: Sequence[str] = ()):
    """Make ``package`` (its ``__name__``) export ``modules``' names
    ({submodule: names}) lazily.  The first lookup of a name in
    ``registries`` first imports each submodule of ``register``.  Returns
    the package's ``__all__``, ``__getattr__`` and ``__dir__``."""
    pkg = sys.modules[package]
    home = {name: mod for mod, names in modules.items() for name in names}
    pkg._HOME = home
    pkg.__class__ = _LazyPackage

    def __getattr__(name):
        if name in home:
            if name in registries:
                for mod in register:
                    importlib.import_module(f"{package}.{mod}")
            value = getattr(importlib.import_module(f"{package}.{home[name]}"), name)
            setattr(pkg, name, value)                  # cached
            return value
        try:                                           # a submodule, as after an eager import
            return importlib.import_module(f"{package}.{name}")
        except ModuleNotFoundError as e:
            if e.name != f"{package}.{name}":
                raise
        raise AttributeError(f"module {package!r} has no attribute {name!r}")

    def __dir__():
        return sorted(set(vars(pkg)) | set(home))

    return list(home), __getattr__, __dir__
