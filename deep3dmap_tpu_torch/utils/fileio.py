"""Pluggable file IO: backends and format handlers (the port's copy of
``deep3dmap_tpu/utils/fileio.py``).

``load``/``dump`` handle json, yaml and pickle (and ``load`` npy) through a
backend chosen by the path's prefix: local files, http, and the lmdb,
memcached and petrel stores, which raise ``ImportError`` where their client
package is missing, as in the JAX package.
"""
from __future__ import annotations

import json
import os.path as osp
import pickle
from io import BytesIO
from typing import Any, Optional

from .registry import Registry

BACKENDS = Registry("fileio_backend")


@BACKENDS.register_module(name="local")
class LocalBackend:
    def get(self, path: str) -> bytes:
        with open(path, "rb") as f:
            return f.read()

    def get_text(self, path: str) -> str:
        with open(path, "r") as f:
            return f.read()

    def put(self, data: bytes, path: str):
        with open(path, "wb") as f:
            f.write(data)

    def exists(self, path: str) -> bool:
        return osp.exists(path)


@BACKENDS.register_module(name="http")
class HTTPBackend:
    def get(self, url: str) -> bytes:
        from urllib.request import urlopen

        with urlopen(url) as r:
            return r.read()

    def get_text(self, url: str) -> str:
        return self.get(url).decode()

    def exists(self, url: str) -> bool:
        try:
            self.get(url)
            return True
        except Exception:
            return False


@BACKENDS.register_module(name="lmdb")
class LmdbBackend:
    """LMDB key-value backend; needs the ``lmdb`` package."""

    def __init__(self, db_path: str, readonly: bool = True, lock: bool = False,
                 readahead: bool = False, **kwargs):
        try:
            import lmdb  # noqa: F401
        except ImportError as e:
            raise ImportError("LmdbBackend requires the lmdb package") from e
        self.db_path = str(db_path)
        self._kwargs = dict(readonly=readonly, lock=lock,
                            readahead=readahead, **kwargs)
        self._client = None

    @property
    def client(self):
        if self._client is None:
            import lmdb

            self._client = lmdb.open(self.db_path, **self._kwargs)
        return self._client

    def get(self, key: str) -> bytes:
        with self.client.begin(write=False) as txn:
            return bytes(txn.get(str(key).encode("ascii")))

    def get_text(self, key: str) -> str:
        return self.get(key).decode()

    def exists(self, key: str) -> bool:
        with self.client.begin(write=False) as txn:
            return txn.get(str(key).encode("ascii")) is not None


@BACKENDS.register_module(name="memcached")
class MemcachedBackend:
    """Memcached backend; needs the ``mc`` client package."""

    def __init__(self, server_list_cfg: str, client_cfg: str, sys_path=None):
        if sys_path is not None:
            import sys

            sys.path.append(sys_path)
        try:
            import mc
        except ImportError as e:
            raise ImportError("MemcachedBackend requires the mc package") from e
        self._client = mc.MemcachedClient.GetInstance(server_list_cfg,
                                                      client_cfg)
        self._mc = mc

    def get(self, path: str) -> bytes:
        value = self._mc.pyvector()
        self._client.Get(str(path), value)
        return self._mc.ConvertBuffer(value)

    def get_text(self, path: str) -> str:
        return self.get(path).decode()


@BACKENDS.register_module(name="petrel")
class PetrelBackend:
    """Petrel (S3-like) backend with path mapping; needs the
    ``petrel_client`` package."""

    def __init__(self, path_mapping: Optional[dict] = None,
                 enable_mc: bool = True, conf_path: Optional[str] = None):
        try:
            from petrel_client.client import Client
        except ImportError as e:
            raise ImportError(
                "PetrelBackend requires the petrel_client package") from e
        self._client = Client(conf_path=conf_path, enable_mc=enable_mc)
        assert isinstance(path_mapping, dict) or path_mapping is None
        self.path_mapping = path_mapping

    def _map_path(self, path: str) -> str:
        path = str(path)
        if self.path_mapping is not None:
            for k, v in self.path_mapping.items():
                path = path.replace(k, v, 1)
        return path

    def get(self, path: str) -> bytes:
        return bytes(memoryview(self._client.Get(self._map_path(path))))

    def get_text(self, path: str) -> str:
        return self.get(path).decode()

    def put(self, data: bytes, path: str):
        self._client.put(self._map_path(path), data)

    def exists(self, path: str) -> bool:
        return bool(self._client.contains(self._map_path(path)))


_PREFIX_BACKENDS = {
    "s3://": "petrel", "petrel://": "petrel",
    "memcached://": "memcached", "lmdb://": "lmdb",
}


def get_backend(path: str, backend: Optional[str] = None):
    if backend:
        return BACKENDS.get(backend)()
    path = str(path)
    if path.startswith(("http://", "https://")):
        return HTTPBackend()
    for prefix, name in _PREFIX_BACKENDS.items():
        if path.startswith(prefix):
            return BACKENDS.get(name)()
    return LocalBackend()


def load(path: str, file_format: Optional[str] = None, backend: Optional[str] = None) -> Any:
    fmt = file_format or osp.splitext(str(path))[1].lstrip(".")
    raw = get_backend(path, backend).get(path)
    if fmt == "json":
        return json.loads(raw)
    if fmt in ("yml", "yaml"):
        import yaml

        return yaml.safe_load(raw)
    if fmt in ("pkl", "pickle"):
        return pickle.loads(raw)
    if fmt == "npy":
        import numpy as np

        return np.load(BytesIO(raw), allow_pickle=False)
    raise ValueError(f"unsupported format {fmt}")


def dump(obj: Any, path: str, file_format: Optional[str] = None):
    fmt = file_format or osp.splitext(str(path))[1].lstrip(".")
    if fmt == "json":
        data = json.dumps(obj).encode()
    elif fmt in ("yml", "yaml"):
        import yaml

        data = yaml.safe_dump(obj).encode()
    elif fmt in ("pkl", "pickle"):
        data = pickle.dumps(obj)
    else:
        raise ValueError(f"unsupported format {fmt}")
    LocalBackend().put(data, path)
