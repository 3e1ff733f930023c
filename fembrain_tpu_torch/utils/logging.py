"""Event logging (reference `EventLogger` singleton, src/base/Logger.h:51-53):
severity/source/timestamp-flagged messages with screen + file sinks.

Counterpart of fembrain_tpu/utils/logging.py, host Python, the same
classes.
"""
from __future__ import annotations

import datetime
import sys
from enum import IntEnum
from pathlib import Path


class Severity(IntEnum):
    INFO = 0
    WARNING = 1
    ERROR = 2
    PROFILE = 3


class EventLogger:
    def __init__(self, write_to_screen: bool = True,
                 file_path: str | Path | None = None,
                 show_timestamp: bool = True, show_source: bool = False):
        self.write_to_screen = write_to_screen
        self.show_timestamp = show_timestamp
        self.show_source = show_source
        self._fh = open(file_path, "a") if file_path else None
        self.events: list[tuple[Severity, str]] = []

    def log(self, severity: Severity, message: str, source: str = "") -> None:
        parts = []
        if self.show_timestamp:
            parts.append(datetime.datetime.now().strftime("%H:%M:%S"))
        parts.append(severity.name)
        if self.show_source and source:
            parts.append(source)
        line = " ".join(parts) + ": " + message
        self.events.append((severity, message))
        if self.write_to_screen:
            out = sys.stderr if severity >= Severity.ERROR else sys.stdout
            print(line, file=out)
        if self._fh:
            self._fh.write(line + "\n")
            self._fh.flush()

    def info(self, msg: str, source: str = "") -> None:
        self.log(Severity.INFO, msg, source)

    def warning(self, msg: str, source: str = "") -> None:
        self.log(Severity.WARNING, msg, source)

    def error(self, msg: str, source: str = "") -> None:
        self.log(Severity.ERROR, msg, source)

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None


_the_logger: EventLogger | None = None


def the_logger() -> EventLogger:
    """Singleton accessor (reference TheEventLogger)."""
    global _the_logger
    if _the_logger is None:
        _the_logger = EventLogger()
    return _the_logger
