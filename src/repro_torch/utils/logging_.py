"""Logging setup shared by the launcher, benchmarks and tests."""
from __future__ import annotations

import logging
import os
import sys

_FMT = "%(asctime)s %(levelname).1s %(name)s: %(message)s"


def get_logger(name: str = "repro") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FMT, datefmt="%H:%M:%S"))
        logger.addHandler(handler)
        logger.setLevel(os.environ.get("REPRO_LOGLEVEL", "INFO").upper())
        logger.propagate = False
    return logger
