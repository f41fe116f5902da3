"""Rank-aware colored logging (reference: ``ponder/utils/logger.py``)."""

from __future__ import annotations

import logging
import os
import sys
from typing import Optional

_LOGGERS = {}

_COLORS = {
    logging.DEBUG: "\x1b[38;20m",
    logging.INFO: "\x1b[32;20m",
    logging.WARNING: "\x1b[33;20m",
    logging.ERROR: "\x1b[31;20m",
    logging.CRITICAL: "\x1b[31;1m",
}
_RESET = "\x1b[0m"


class _ColorFormatter(logging.Formatter):
    def format(self, record):
        color = _COLORS.get(record.levelno, "")
        fmt = f"{color}[%(asctime)s %(levelname)s]{_RESET} %(message)s"
        return logging.Formatter(fmt, datefmt="%Y-%m-%d %H:%M:%S").format(record)


def get_root_logger(
    log_file: Optional[str] = None,
    log_level: int = logging.INFO,
    name: str = "ponderv2_tpu",
) -> logging.Logger:
    """Create (or fetch) the root framework logger.

    Only process 0 logs at ``log_level``; other processes log errors only, mirroring
    the rank-aware behaviour of the reference logger.
    """
    if name in _LOGGERS:
        return _LOGGERS[name]

    logger = logging.getLogger(name)
    logger.setLevel(log_level)
    logger.propagate = False

    from . import comm

    rank = comm.get_rank()
    stream = logging.StreamHandler(sys.stdout)
    stream.setFormatter(_ColorFormatter())
    stream.setLevel(log_level if rank == 0 else logging.ERROR)
    logger.addHandler(stream)

    if log_file is not None and rank == 0:
        os.makedirs(os.path.dirname(os.path.abspath(log_file)), exist_ok=True)
        fh = logging.FileHandler(log_file, mode="a")
        fh.setFormatter(
            logging.Formatter(
                "[%(asctime)s %(levelname)s] %(message)s", datefmt="%Y-%m-%d %H:%M:%S"
            )
        )
        fh.setLevel(log_level)
        logger.addHandler(fh)

    _LOGGERS[name] = logger
    return logger
