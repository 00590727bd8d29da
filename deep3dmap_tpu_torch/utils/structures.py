"""Data-element containers: ``BaseDataElement``, ``InstanceData`` and
``PixelData`` (the port's copy of ``deep3dmap_tpu/utils/structures.py``).

A container keeps *metainfo* (image shape, scale factor, ...) apart from
*data* (labels, boxes, masks), with dict-style access, ``new``/``clone`` and
conversions.  Leaves may be numpy arrays or torch tensors: ``numpy()`` gives
host arrays, ``to(device)``, ``cpu()`` and ``cuda()`` tensors (the JAX
package's ``jax(device)``); ``InstanceData`` indexes its fields with ints,
slices, index arrays or tensors and boolean masks, and ``cat`` joins tensor
leaves with ``torch.cat``.  torch is imported where a tensor is made, so the
module imports without it.
"""
from __future__ import annotations

from typing import Any, Iterator, List, Optional, Tuple

import numpy as np

__all__ = ["BaseDataElement", "InstanceData", "PixelData"]


def _is_tensor(x) -> bool:
    return type(x).__module__.startswith("torch") and hasattr(x, "detach")


def _to_numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if _is_tensor(x) else np.asarray(x)


def _index_for(leaf, item):
    """``item`` in the kind ``leaf`` takes: host arrays for a numpy leaf, a
    tensor on the leaf's device for a tensor leaf."""
    if isinstance(item, (slice, int, np.integer)):
        return item
    if _is_tensor(leaf):
        import torch
        if not _is_tensor(item):
            item = torch.as_tensor(np.asarray(item))
        return item.to(leaf.device)
    return _to_numpy(item)


class BaseDataElement:
    def __init__(self, *, metainfo: Optional[dict] = None, **kwargs):
        object.__setattr__(self, "_metainfo_fields", set())
        object.__setattr__(self, "_data_fields", set())
        if metainfo is not None:
            self.set_metainfo(metainfo)
        if kwargs:
            self.set_data(kwargs)

    # -- setting ------------------------------------------------------------
    def set_metainfo(self, metainfo: dict) -> None:
        assert isinstance(metainfo, dict)
        for k, v in metainfo.items():
            if k in self._data_fields:
                raise AttributeError(f"`{k}` is already a data field")
            self._metainfo_fields.add(k)
            object.__setattr__(self, k, v)

    def set_data(self, data: dict) -> None:
        assert isinstance(data, dict)
        for k, v in data.items():
            setattr(self, k, v)

    def update(self, instance: "BaseDataElement") -> None:
        assert isinstance(instance, BaseDataElement)
        self.set_metainfo(dict(instance.metainfo_items()))
        self.set_data(dict(instance.items()))

    def __setattr__(self, name: str, value: Any):
        if name in ("_metainfo_fields", "_data_fields"):
            raise AttributeError(f"{name} is a private attribute")
        if name in self._metainfo_fields:
            raise AttributeError(
                f"`{name}` is a metainfo field; use set_metainfo to change it")
        self._set_field(name, value)

    def _set_field(self, name: str, value: Any):
        self._data_fields.add(name)
        object.__setattr__(self, name, value)

    def __delattr__(self, item: str):
        if item in ("_metainfo_fields", "_data_fields"):
            raise AttributeError(f"{item} is a private attribute")
        object.__delattr__(self, item)
        self._metainfo_fields.discard(item)
        self._data_fields.discard(item)

    __delitem__ = __delattr__

    def __getitem__(self, name: str):
        if isinstance(name, str):
            return getattr(self, name)
        raise TypeError(f"invalid key {name!r}")

    def get(self, key, default=None):
        return getattr(self, key, default)

    def pop(self, key, default=None):
        if key in self._data_fields or key in self._metainfo_fields:
            value = getattr(self, key)
            delattr(self, key)
            return value
        return default

    def __contains__(self, item: str) -> bool:
        return item in self._data_fields or item in self._metainfo_fields

    # -- views --------------------------------------------------------------
    def keys(self) -> List[str]:
        return list(self._data_fields)

    def metainfo_keys(self) -> List[str]:
        return list(self._metainfo_fields)

    def values(self) -> List[Any]:
        return [getattr(self, k) for k in self.keys()]

    def metainfo_values(self) -> List[Any]:
        return [getattr(self, k) for k in self.metainfo_keys()]

    def all_keys(self) -> List[str]:
        return self.metainfo_keys() + self.keys()

    def items(self) -> Iterator[Tuple[str, Any]]:
        for k in self.keys():
            yield k, getattr(self, k)

    def metainfo_items(self) -> Iterator[Tuple[str, Any]]:
        for k in self.metainfo_keys():
            yield k, getattr(self, k)

    def all_items(self) -> Iterator[Tuple[str, Any]]:
        for k in self.all_keys():
            yield k, getattr(self, k)

    @property
    def metainfo(self) -> dict:
        return dict(self.metainfo_items())

    # -- copies -------------------------------------------------------------
    def new(self, *, metainfo: Optional[dict] = None, **kwargs
            ) -> "BaseDataElement":
        new_data = self.__class__()
        new_data.set_metainfo(metainfo if metainfo is not None
                              else dict(self.metainfo_items()))
        new_data.set_data(kwargs if kwargs else dict(self.items()))
        return new_data

    def clone(self) -> "BaseDataElement":
        clone = self.__class__()
        clone.set_metainfo(dict(self.metainfo_items()))
        for k, v in self.items():
            if isinstance(v, np.ndarray):
                v = v.copy()
            elif _is_tensor(v):
                v = v.clone()
            clone.set_data({k: v})
        return clone

    # -- conversions --------------------------------------------------------
    def _map(self, fn) -> "BaseDataElement":
        out = self.new()
        for k, v in self.items():
            if hasattr(v, "shape"):
                out.set_data({k: fn(v)})
            elif isinstance(v, BaseDataElement):
                out.set_data({k: v._map(fn)})
        return out

    def numpy(self) -> "BaseDataElement":
        return self._map(_to_numpy)

    def to(self, device) -> "BaseDataElement":
        """Every array leaf as a tensor on ``device`` (numpy leaves are
        uploaded)."""
        import torch

        def put(x):
            t = x if _is_tensor(x) else torch.from_numpy(np.ascontiguousarray(x))
            return t.to(device)
        return self._map(put)

    def cpu(self) -> "BaseDataElement":
        return self.to("cpu")

    def cuda(self) -> "BaseDataElement":
        return self.to("cuda")

    def to_dict(self) -> dict:
        return {k: (v.to_dict() if isinstance(v, BaseDataElement) else v)
                for k, v in self.all_items()}

    def __repr__(self) -> str:
        def fmt(v):
            return (f"array{tuple(v.shape)}" if hasattr(v, "shape") else repr(v))

        meta = ", ".join(f"{k}={fmt(v)}" for k, v in self.metainfo_items())
        data = ", ".join(f"{k}={fmt(v)}" for k, v in self.items())
        return f"<{self.__class__.__name__}(metainfo: {meta}) {data}>"


class InstanceData(BaseDataElement):
    """Per-instance fields (boxes, labels, scores) with a shared length;
    supports int/slice/bool-mask indexing and concatenation."""

    def _set_field(self, name: str, value: Any):
        if hasattr(value, "__len__") and len(self._data_fields):
            n = len(self)
            if n is not None and len(value) != n:
                raise ValueError(
                    f"field `{name}` has length {len(value)}, but "
                    f"InstanceData holds instances of length {n}")
        super()._set_field(name, value)

    def __len__(self) -> Optional[int]:
        for k in self._data_fields:
            v = getattr(self, k)
            if hasattr(v, "__len__"):
                return len(v)
        return 0

    def __getitem__(self, item):
        """A field by name, or the instances an int, a slice, an index array
        or tensor, or a boolean mask selects (each leaf indexed in its own
        kind: a tensor index on a numpy leaf goes through the host, a numpy
        index on a tensor leaf to the tensor's device)."""
        if isinstance(item, str):
            return getattr(self, item)
        out = self.__class__(metainfo=dict(self.metainfo_items()))
        for k, v in self.items():
            out.set_data({k: v[_index_for(v, item)]})
        return out

    @classmethod
    def cat(cls, instances: List["InstanceData"]) -> "InstanceData":
        assert len(instances) > 0
        out = cls(metainfo=dict(instances[0].metainfo_items()))
        for k in instances[0].keys():
            vals = [inst[k] for inst in instances]
            if _is_tensor(vals[0]):
                import torch
                out.set_data({k: torch.cat(vals, dim=0)})
            else:
                out.set_data({k: np.concatenate([_to_numpy(v) for v in vals], axis=0)})
        return out


class PixelData(BaseDataElement):
    """Per-pixel fields ((C, H, W) or (H, W)) with a shared spatial shape."""

    def _set_field(self, name: str, value: Any):
        if hasattr(value, "shape"):
            shp = tuple(value.shape[-2:])
            cur = self.shape
            if cur is not None and shp != cur:
                raise ValueError(
                    f"field `{name}` has spatial shape {shp}, expected {cur}")
        super()._set_field(name, value)

    @property
    def shape(self) -> Optional[Tuple[int, int]]:
        for k in self._data_fields:
            v = getattr(self, k)
            if hasattr(v, "shape"):
                return tuple(v.shape[-2:])
        return None
