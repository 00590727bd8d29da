"""Python-file config system (the port's copy of ``deep3dmap_tpu/utils/config.py``).

Configs are plain ``.py`` files exec'd into an attribute-dict, with
``_base_`` inheritance, ``_delete_`` keys, nested-key CLI overrides
(``DictAction``, ``merge_from_dict``) and round-trip ``dump``.  It reads the
repo's ``configs/`` unchanged and gives the JAX package's ``to_dict()``.
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import os.path as osp
import tempfile
import types
from typing import Any, Optional

BASE_KEY = "_base_"
DELETE_KEY = "_delete_"
RESERVED_KEYS = ("filename", "text")


class ConfigDict(dict):
    """dict with attribute access; missing attrs raise AttributeError."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(f"'ConfigDict' object has no attribute '{name}'")

    def __setattr__(self, name, value):
        self[name] = value

    def __delattr__(self, name):
        try:
            del self[name]
        except KeyError:
            raise AttributeError(name)

    @staticmethod
    def _wrap(value):
        if isinstance(value, dict) and not isinstance(value, ConfigDict):
            return ConfigDict({k: ConfigDict._wrap(v) for k, v in value.items()})
        if isinstance(value, (list, tuple)):
            return type(value)(ConfigDict._wrap(v) for v in value)
        return value

    def __init__(self, *args, **kwargs):
        super().__init__()
        for d in args:
            if d is None:
                continue
            for k, v in dict(d).items():
                self[k] = ConfigDict._wrap(v)
        for k, v in kwargs.items():
            self[k] = ConfigDict._wrap(v)

    def get(self, key, default=None):
        return super().get(key, default)


def _merge_a_into_b(a: dict, b: dict) -> dict:
    """Merge dict ``a`` into ``b`` (a wins); ``_delete_`` in a discards b's value."""
    b = copy.deepcopy(b)
    for key, val in a.items():
        if isinstance(val, dict) and key in b and not val.pop(DELETE_KEY, False):
            if not isinstance(b[key], dict):
                raise TypeError(
                    f"Cannot merge dict into non-dict for key `{key}` "
                    f"(base is {type(b[key])}); add `_delete_=True` to override")
            b[key] = _merge_a_into_b(val, b[key])
        else:
            b[key] = copy.deepcopy(val)
    return b


def _file_to_dict(filename: str) -> tuple:
    filename = osp.abspath(osp.expanduser(filename))
    if not osp.isfile(filename):
        raise FileNotFoundError(f"Config file not found: {filename}")
    ext = osp.splitext(filename)[1]
    if ext == ".py":
        with open(filename, "r") as f:
            content = f.read()
        mod = types.ModuleType("_cfg_")
        mod.__file__ = filename
        exec(compile(content, filename, "exec"), mod.__dict__)
        cfg_dict = {
            k: v for k, v in mod.__dict__.items()
            if not k.startswith("__") and not isinstance(v, (types.ModuleType, types.FunctionType, type))
        }
    elif ext == ".json":
        with open(filename, "r") as f:
            cfg_dict = json.load(f)
        content = json.dumps(cfg_dict, indent=2)
    else:
        raise OSError(f"Only .py/.json configs are supported, got {ext}")

    # handle _base_ inheritance
    if BASE_KEY in cfg_dict:
        cfg_dir = osp.dirname(filename)
        base_files = cfg_dict.pop(BASE_KEY)
        if isinstance(base_files, str):
            base_files = [base_files]
        base_dict: dict = {}
        base_text = []
        for bf in base_files:
            _d, _t = _file_to_dict(osp.join(cfg_dir, bf))
            dup = set(base_dict) & set(_d)
            if dup:
                raise KeyError(f"Duplicate keys between _base_ files: {dup}")
            base_dict.update(_d)
            base_text.append(_t)
        cfg_dict = _merge_a_into_b(cfg_dict, base_dict)
        content = "\n".join(base_text + [content])
    return cfg_dict, content


class Config:
    """Wraps a ConfigDict with file loading/merging/dumping."""

    def __init__(self, cfg_dict: Optional[dict] = None, cfg_text: str = "",
                 filename: Optional[str] = None):
        if cfg_dict is None:
            cfg_dict = {}
        if not isinstance(cfg_dict, dict):
            raise TypeError(f"cfg_dict must be a dict, got {type(cfg_dict)}")
        for key in cfg_dict:
            if key in RESERVED_KEYS:
                raise KeyError(f"{key} is a reserved key")
        super().__setattr__("_cfg_dict", ConfigDict(cfg_dict))
        super().__setattr__("_filename", filename)
        super().__setattr__("_text", cfg_text)

    # -- constructors ------------------------------------------------------
    @staticmethod
    def fromfile(filename: str) -> "Config":
        cfg_dict, cfg_text = _file_to_dict(filename)
        return Config(cfg_dict, cfg_text=cfg_text, filename=filename)

    @staticmethod
    def fromstring(cfg_str: str, file_format: str = ".py") -> "Config":
        with tempfile.NamedTemporaryFile("w", suffix=file_format, delete=False) as f:
            f.write(cfg_str)
            fname = f.name
        try:
            cfg = Config.fromfile(fname)
        finally:
            os.remove(fname)
        return cfg

    # -- attribute plumbing ------------------------------------------------
    @property
    def filename(self):
        return self._filename

    @property
    def text(self):
        return self._text

    def __getattr__(self, name):
        return getattr(self._cfg_dict, name)

    def __getitem__(self, name):
        return self._cfg_dict[name]

    def __setattr__(self, name, value):
        self._cfg_dict[name] = ConfigDict._wrap(value)

    def __setitem__(self, name, value):
        self._cfg_dict[name] = ConfigDict._wrap(value)

    def __contains__(self, name):
        return name in self._cfg_dict

    def __iter__(self):
        return iter(self._cfg_dict)

    def __len__(self):
        return len(self._cfg_dict)

    def __repr__(self):
        return f"Config (path: {self._filename}): {self._cfg_dict!r}"

    def get(self, key, default=None):
        return self._cfg_dict.get(key, default)

    def keys(self):
        return self._cfg_dict.keys()

    def items(self):
        return self._cfg_dict.items()

    def copy(self):
        return Config(copy.deepcopy(dict(self._cfg_dict)), cfg_text=self._text,
                      filename=self._filename)

    def to_dict(self) -> dict:
        def _plain(v):
            if isinstance(v, dict):
                return {k: _plain(x) for k, x in v.items()}
            if isinstance(v, (list, tuple)):
                return type(v)(_plain(x) for x in v)
            return v
        return _plain(dict(self._cfg_dict))

    # -- merging / dumping -------------------------------------------------
    def merge_from_dict(self, options: dict):
        """Merge flat dotted-key options, e.g. {'model.lr': 0.1}."""
        nested: dict = {}
        for full_key, v in options.items():
            d = nested
            parts = full_key.split(".")
            for k in parts[:-1]:
                d = d.setdefault(k, {})
            d[parts[-1]] = v
        merged = _merge_a_into_b(nested, dict(self._cfg_dict))
        super().__setattr__("_cfg_dict", ConfigDict(merged))

    def dump(self, file: Optional[str] = None) -> Optional[str]:
        def _fmt(v, indent=0):
            pad = " " * indent
            if isinstance(v, dict):
                items = ", ".join(f"{k!r}: {_fmt(x)}" for k, x in v.items())
                return "{" + items + "}"
            if isinstance(v, (list, tuple)):
                inner = ", ".join(_fmt(x) for x in v)
                return ("[" + inner + "]") if isinstance(v, list) else "(" + inner + ("," if len(v) == 1 else "") + ")"
            return repr(v)

        lines = [f"{k} = {_fmt(v)}" for k, v in self._cfg_dict.items()]
        out = "\n".join(lines) + "\n"
        if file is None:
            return out
        with open(file, "w") as f:
            f.write(out)
        return None


class DictAction(argparse.Action):
    """argparse action parsing ``KEY=VALUE`` pairs with python-literal values.

    ``--cfg-options model.lr=0.01 data.shuffle=True list.vals=1,2,3``.
    """

    @staticmethod
    def _parse_value(val: str) -> Any:
        import ast
        try:
            return ast.literal_eval(val)
        except (ValueError, SyntaxError):
            pass
        low = val.lower()
        if low in ("true", "false"):
            return low == "true"
        if low in ("none", "null"):
            return None
        return val

    def __call__(self, parser, namespace, values, option_string=None):
        options = {}
        for kv in values:
            key, sep, val = kv.partition("=")
            if not sep:
                raise ValueError(f"Invalid option '{kv}', expected KEY=VALUE")
            # literal_eval first: handles tuples/lists/dicts with brackets
            # ("(16,16)", "[0,1]") and bare comma tuples ("1,2,3");
            # only split manually when the value isn't a python literal
            # (e.g. "a,b" string lists)
            parsed = DictAction._parse_value(val)
            if isinstance(parsed, str) and "," in val:
                parsed = [DictAction._parse_value(v)
                          for v in val.split(",") if v != ""]
            options[key] = parsed
        setattr(namespace, self.dest, options)
