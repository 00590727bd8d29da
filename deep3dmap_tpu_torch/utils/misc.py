"""Misc utilities (port of ``deep3dmap_tpu/utils/misc.py``).
``maybe_force_platform`` picks a JAX backend and has no meaning here: the
port's entry points take ``device=``."""
from __future__ import annotations


def machine_cache_dir(prefix: str) -> str:
    """Per-machine cache path: ``prefix`` keyed by a fingerprint of the
    host's CPU flags, so that a cache directory that outlives a move to
    another host (and holds code compiled for that host's CPU features)
    is not reached."""
    import hashlib

    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    fp = hashlib.sha1(line.encode()).hexdigest()[:10]
                    break
            else:
                fp = "generic"
    except OSError:
        import platform

        fp = hashlib.sha1(platform.processor().encode()).hexdigest()[:10]
    return f"{prefix}_{fp}"
