"""``MessageHub`` and ``HistoryBuffer``: a store of scalar histories and
runtime info shared between components (the port's copy of
``deep3dmap_tpu/utils/message_hub.py``); ``get_instance`` keeps one hub per
name.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, Optional

import numpy as np


class HistoryBuffer:
    """Ring-ish scalar history with windowed statistics."""

    def __init__(self, max_length: int = 1_000_000):
        self.max_length = max_length
        self._data: list = []
        self._counts: list = []

    def update(self, value: float, count: int = 1):
        self._data.append(float(value))
        self._counts.append(int(count))
        if len(self._data) > self.max_length:
            self._data = self._data[-self.max_length:]
            self._counts = self._counts[-self.max_length:]

    @property
    def data(self):
        return np.asarray(self._data), np.asarray(self._counts)

    def current(self) -> float:
        if not self._data:
            raise ValueError("empty HistoryBuffer")
        return self._data[-1]

    def mean(self, window_size: Optional[int] = None) -> float:
        d = np.asarray(self._data[-window_size:] if window_size else self._data)
        c = np.asarray(self._counts[-window_size:] if window_size else self._counts)
        return float((d * c).sum() / max(c.sum(), 1))

    def max(self, window_size: Optional[int] = None) -> float:
        d = self._data[-window_size:] if window_size else self._data
        return float(np.max(d))

    def min(self, window_size: Optional[int] = None) -> float:
        d = self._data[-window_size:] if window_size else self._data
        return float(np.min(d))


class MessageHub:
    """Named scalar histories + arbitrary runtime info, with a global
    instance registry (message_hub.py get_current_instance pattern)."""

    _instances: Dict[str, "MessageHub"] = {}

    def __init__(self, name: str = ""):
        self.name = name
        self.log_scalars: "OrderedDict[str, HistoryBuffer]" = OrderedDict()
        self.runtime_info: "OrderedDict[str, Any]" = OrderedDict()

    @classmethod
    def get_instance(cls, name: str = "default") -> "MessageHub":
        if name not in cls._instances:
            cls._instances[name] = cls(name)
        return cls._instances[name]

    @classmethod
    def get_current_instance(cls) -> "MessageHub":
        return cls.get_instance("default")

    def update_scalar(self, key: str, value, count: int = 1):
        self.log_scalars.setdefault(key, HistoryBuffer()).update(float(value), count)

    def update_scalars(self, d: dict, count: int = 1):
        for k, v in d.items():
            self.update_scalar(k, v, count)

    def get_scalar(self, key: str) -> HistoryBuffer:
        return self.log_scalars[key]

    def update_info(self, key: str, value: Any):
        self.runtime_info[key] = value

    def get_info(self, key: str, default: Any = None) -> Any:
        return self.runtime_info.get(key, default)
