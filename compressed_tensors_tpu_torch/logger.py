"""Logging configuration (stdlib logging).

Counterpart of ``compressed_tensors_tpu/logger.py``, read from the same
variables with ``CT_TORCH_`` in place of ``CT_TPU_``:

- CT_TORCH_LOG_DISABLED=1  disable logging
- CT_TORCH_LOG_LEVEL       console level (default WARNING)
- CT_TORCH_LOG_FILE        optional JSON-lines log file
- CT_TORCH_LOG_FILE_LEVEL  file level (defaults to CT_TORCH_LOG_LEVEL)
"""

from __future__ import annotations

import json
import logging
import os

__all__ = ["logger", "log_once", "configure_logger"]

logger = logging.getLogger("compressed_tensors_tpu_torch")

_LOGGED_ONCE: set[str] = set()


def log_once(level: int, message: str, *args) -> None:
    """Log a message only the first time it is seen."""
    key = message % args if args else message
    if key in _LOGGED_ONCE:
        return
    _LOGGED_ONCE.add(key)
    logger.log(level, message, *args)


class _JsonFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        return json.dumps({
            "time": self.formatTime(record),
            "level": record.levelname,
            "name": record.name,
            "message": record.getMessage(),
        })


def configure_logger() -> None:
    if os.environ.get("CT_TORCH_LOG_DISABLED", "") == "1":
        logger.disabled = True
        return

    level_name = os.environ.get("CT_TORCH_LOG_LEVEL", "WARNING").upper()
    level = getattr(logging, level_name, logging.WARNING)
    logger.setLevel(level)

    if not logger.handlers:
        console = logging.StreamHandler()
        console.setLevel(level)
        console.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)s %(name)s: %(message)s"))
        logger.addHandler(console)

        log_file = os.environ.get("CT_TORCH_LOG_FILE")
        if log_file:
            file_level_name = os.environ.get(
                "CT_TORCH_LOG_FILE_LEVEL", level_name).upper()
            fh = logging.FileHandler(log_file)
            fh.setLevel(getattr(logging, file_level_name, level))
            fh.setFormatter(_JsonFormatter())
            logger.addHandler(fh)


configure_logger()
