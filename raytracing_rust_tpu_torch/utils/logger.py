"""File logger: `render --log PATH`.

Counterpart of `raytracing_rust_tpu/utils/logger.py`, which mirrors the
reference's (src/logger.rs): each message is appended to the file as
`"{Y-m-d H:M:S} [LEVEL] - msg\n"`. As in the JAX package, the file's
directory is created, and a message below the logger's level is dropped
(the reference logs every message and stamps the logger's level).
"""

from __future__ import annotations

import datetime
import enum
import os


class LogLevel(enum.IntEnum):
    DEBUG = 0
    INFO = 1
    WARNING = 2
    ERROR = 3


class Logger:
    def __init__(self, path: str, level: LogLevel = LogLevel.INFO):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path
        self.level = level

    def set_level(self, level: LogLevel) -> None:
        self.level = level

    def write(self, msg: str, level: LogLevel | None = None) -> None:
        """Append msg at level (default: the logger's own), unless level is
        below the logger's."""
        level = self.level if level is None else level
        if level < self.level:
            return
        stamp = datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S")
        with open(self.path, "a") as f:
            f.write(f"{stamp} [{level.name}] - {msg}\n")
