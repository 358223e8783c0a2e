"""Leveled, coloured, timestamped logging (the JAX package's
``utils/logging.py``): a process-wide facade over Python's ``logging``,
three levels (Information, Warning, Critical), ``HH:MM:SS.mmm``-stamped
console lines coloured by level, and an exception overload.
"""

from __future__ import annotations

import logging
import sys
import time

# The three levels, mapped onto the stdlib levels.
INFORMATION = logging.INFO
WARNING = logging.WARNING
CRITICAL = logging.CRITICAL

_COLORS = {
    logging.DEBUG: "\x1b[2m",      # dim
    logging.INFO: "\x1b[90m",      # gray
    logging.WARNING: "\x1b[33m",   # yellow
    logging.CRITICAL: "\x1b[31m",  # red
    logging.ERROR: "\x1b[31m",
}
_RESET = "\x1b[0m"

_LEVEL_NAMES = {
    logging.DEBUG: "Debug",
    logging.INFO: "Information",
    logging.WARNING: "Warning",
    logging.ERROR: "Error",
    logging.CRITICAL: "Critical",
}


class _ConsoleFormatter(logging.Formatter):
    """`[HH:MM:SS.mmm] [Level] message` with per-level color and a
    level-padded prefix."""

    def __init__(self, color: bool) -> None:
        super().__init__()
        self._color = color

    def format(self, record: logging.LogRecord) -> str:
        ts = time.strftime("%H:%M:%S", time.localtime(record.created))
        ms = int(record.msecs)
        level = _LEVEL_NAMES.get(record.levelno, record.levelname.title())
        msg = record.getMessage()
        if record.exc_info:
            msg = f"{msg}\n{self.formatException(record.exc_info)}"
        line = f"[{ts}.{ms:03d}] [{level:<11}] {msg}"
        if self._color:
            return f"{_COLORS.get(record.levelno, '')}{line}{_RESET}"
        return line


_logger: logging.Logger | None = None


def get_logger() -> logging.Logger:
    """The process-wide logger (the facade)."""
    global _logger
    if _logger is None:
        _logger = logging.getLogger("pathtracing_tpu_torch")
        _logger.setLevel(logging.INFO)
        if not _logger.handlers:
            handler = logging.StreamHandler(sys.stderr)
            handler.setFormatter(_ConsoleFormatter(color=sys.stderr.isatty()))
            _logger.addHandler(handler)
        _logger.propagate = False
    return _logger


def set_level(level: int) -> None:
    get_logger().setLevel(level)


def log_information(msg: str, *args) -> None:
    get_logger().info(msg, *args)


def log_warning(msg: str, *args) -> None:
    get_logger().warning(msg, *args)


def log_critical(msg: str, *args, exc_info=None) -> None:
    """Critical, with an optional exception."""
    get_logger().critical(msg, *args, exc_info=exc_info)
