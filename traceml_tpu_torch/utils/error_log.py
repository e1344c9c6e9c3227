"""File-backed, never-raising error logger
(reference: src/traceml_ai/loggers/error_log.py:16-115).

Instrumentation must never break user training; every internal failure is
appended to ``logs/<session>/[component_]error.log`` with a ``[TraceML]``
prefix and swallowed.
"""

from __future__ import annotations

import datetime
import os
import threading
import traceback
from pathlib import Path
from typing import Optional

_PREFIX = "[TraceML]"


class ErrorLog:
    def __init__(self, path: Optional[os.PathLike] = None, component: str = "runtime"):
        self._path = Path(path) if path else None
        self._component = component
        self._lock = threading.Lock()
        self._fallback_count = 0

    def set_path(self, path: os.PathLike) -> None:
        with self._lock:
            self._path = Path(path)

    @property
    def path(self) -> Optional[Path]:
        return self._path  # tracelint: unguarded(single ref read; set_path happens once at startup and a stale None only delays first log line)

    def error(self, message: str, exc: Optional[BaseException] = None) -> None:
        self._write("ERROR", message, exc)

    def warning(self, message: str, exc: Optional[BaseException] = None) -> None:
        self._write("WARN", message, exc)

    def info(self, message: str) -> None:
        self._write("INFO", message, None)

    def _write(self, level: str, message: str, exc: Optional[BaseException]) -> None:
        try:
            ts = datetime.datetime.now().isoformat(timespec="milliseconds")
            lines = [f"{_PREFIX} {ts} {level} [{self._component}] {message}"]
            if exc is not None:
                lines.append(
                    "".join(
                        traceback.format_exception(type(exc), exc, exc.__traceback__)
                    ).rstrip()
                )
            text = "\n".join(lines) + "\n"
            with self._lock:
                if self._path is None:
                    self._fallback_count += 1
                    return
                self._path.parent.mkdir(parents=True, exist_ok=True)
                with open(self._path, "a", encoding="utf-8") as fh:
                    fh.write(text)
        except Exception:
            # Never raise from the error logger itself.
            pass


_global_log = ErrorLog()


def get_error_log() -> ErrorLog:
    return _global_log
