"""The port's copy of ``vit_ocm_wmsegmentation_tpu/utils/logger.py``.

Process-aware logging: colored console on the main process, per-process
append-mode files (``log_rank{N}.txt``) for multi-host runs.

Capability-parity with the reference's create_logger (logger.py:16-42), with
a different construction: a single level-aware formatter class instead of
two format strings, and handlers attached idempotently so repeated calls
with the same name don't duplicate output.
"""

from __future__ import annotations

import functools
import logging
import os
import sys

_FILE_FMT = "[%(asctime)s %(name)s] (%(filename)s %(lineno)d): %(levelname)s %(message)s"
_DATE_FMT = "%Y-%m-%d %H:%M:%S"


class _ConsoleFormatter(logging.Formatter):
    """Colors the prefix (green timestamp/name, yellow location) when
    termcolor is available; plain text otherwise."""

    def __init__(self):
        super().__init__(fmt=_FILE_FMT, datefmt=_DATE_FMT)
        try:
            from termcolor import colored

            self._head = colored("[%(asctime)s %(name)s]", "green") + colored(
                "(%(filename)s %(lineno)d)", "yellow"
            )
        except ImportError:
            self._head = "[%(asctime)s %(name)s](%(filename)s %(lineno)d)"

    def format(self, record):
        formatter = logging.Formatter(
            fmt=self._head + ": %(levelname)s %(message)s", datefmt=_DATE_FMT
        )
        return formatter.format(record)


@functools.lru_cache()
def create_logger(output_dir: str = "", dist_rank: int = 0, name: str = "") -> logging.Logger:
    """Console handler on rank 0 only; file handler per rank when output_dir
    is given. Cached per argument tuple (idempotent)."""
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    logger.propagate = False

    # FileHandler subclasses StreamHandler — exclude it, or a logger that
    # already carries a file handler silently loses its console output
    has_console = any(isinstance(h, logging.StreamHandler)
                      and not isinstance(h, logging.FileHandler)
                      for h in logger.handlers)
    if dist_rank == 0 and not has_console:
        console = logging.StreamHandler(sys.stdout)
        console.setLevel(logging.DEBUG)
        console.setFormatter(_ConsoleFormatter())
        logger.addHandler(console)

    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        path = os.path.join(output_dir, f"log_rank{dist_rank}.txt")
        if not any(getattr(h, "baseFilename", None) == os.path.abspath(path) for h in logger.handlers):
            fh = logging.FileHandler(path, mode="a")
            fh.setLevel(logging.DEBUG)
            fh.setFormatter(logging.Formatter(fmt=_FILE_FMT, datefmt=_DATE_FMT))
            logger.addHandler(fh)

    return logger
