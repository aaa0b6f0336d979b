"""Logging for Luminary-TPU.

Mirrors the reference's leveled, buffered logger (reference: src/luminary/log.c,
include/luminary/log.h:42-79): messages are kept in an in-memory ring and can be
dumped with :func:`write_log`. Volatile (UI status line) messages are dropped
from the persistent buffer like the reference does.
"""

from __future__ import annotations

import sys
import threading
import time
from dataclasses import dataclass, field
from enum import IntEnum
from typing import List


class LogLevel(IntEnum):
    MESSAGE = 0
    INFO = 1
    WARN = 2
    ERROR = 3
    CRASH = 4


@dataclass
class _LogRecord:
    level: LogLevel
    wall_time: float
    text: str


@dataclass
class _Logger:
    records: List[_LogRecord] = field(default_factory=list)
    lock: threading.Lock = field(default_factory=threading.Lock)
    verbosity: LogLevel = LogLevel.WARN
    t0: float = field(default_factory=time.monotonic)

    def log(self, level: LogLevel, text: str) -> None:
        rec = _LogRecord(level, time.monotonic() - self.t0, text)
        with self.lock:
            self.records.append(rec)
        if level >= self.verbosity:
            stream = sys.stderr if level >= LogLevel.WARN else sys.stdout
            print(f"[luminary-tpu:{level.name.lower()}] {text}", file=stream)

    def dump(self) -> str:
        with self.lock:
            return "\n".join(
                f"[{r.wall_time:12.6f}][{r.level.name:<7}] {r.text}" for r in self.records
            )


_LOGGER = _Logger()


def set_verbosity(level: LogLevel) -> None:
    _LOGGER.verbosity = level


def log_message(fmt: str, *args) -> None:
    _LOGGER.log(LogLevel.MESSAGE, fmt % args if args else fmt)


def info_message(fmt: str, *args) -> None:
    _LOGGER.log(LogLevel.INFO, fmt % args if args else fmt)


def warn_message(fmt: str, *args) -> None:
    _LOGGER.log(LogLevel.WARN, fmt % args if args else fmt)


def error_message(fmt: str, *args) -> None:
    _LOGGER.log(LogLevel.ERROR, fmt % args if args else fmt)


def write_log(path: str) -> None:
    """Dump the in-memory log to a file (reference: luminary_write_log)."""
    with open(path, "w") as f:
        f.write(_LOGGER.dump())
        f.write("\n")
