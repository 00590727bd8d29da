"""Per-process logger (the port's copy of ``deep3dmap_tpu/utils/logging.py``):
rank 0 logs at the requested level, other processes log only errors."""
from __future__ import annotations

import logging
from typing import Optional

_initialized: dict = {}


def get_logger(name: str, log_file: Optional[str] = None,
               log_level: int = logging.INFO, rank: int = 0) -> logging.Logger:
    logger = logging.getLogger(name)
    if name in _initialized:
        return logger
    for root_name in _initialized:
        if name.startswith(root_name):
            return logger

    handlers: list = [logging.StreamHandler()]
    if log_file is not None and rank == 0:
        handlers.append(logging.FileHandler(log_file, "w"))

    fmt = logging.Formatter("%(asctime)s - %(name)s - %(levelname)s - %(message)s")
    for h in handlers:
        h.setFormatter(fmt)
        h.setLevel(log_level if rank == 0 else logging.ERROR)
        logger.addHandler(h)
    logger.setLevel(log_level if rank == 0 else logging.ERROR)
    logger.propagate = False
    _initialized[name] = True
    return logger


def get_root_logger(log_file: Optional[str] = None, log_level: int = logging.INFO,
                    rank: int = 0) -> logging.Logger:
    return get_logger("deep3dmap_tpu_torch", log_file=log_file,
                      log_level=log_level, rank=rank)


def print_log(msg, logger=None, level: int = logging.INFO):
    if logger is None:
        print(msg)
    elif isinstance(logger, logging.Logger):
        logger.log(level, msg)
    elif logger == "silent":
        pass
    elif isinstance(logger, str):
        get_logger(logger).log(level, msg)
    else:
        raise TypeError(f"logger must be a Logger, str, 'silent' or None, got {type(logger)}")
