"""stdout/stderr tee.

Counterpart of ``traceml_tpu/runtime/stdout_capture.py`` (copied).
stderr is teed unless ``capture_stderr`` is off (``--no-capture-stderr``,
``TRACEML_CAPTURE_STDERR=0``): then it stays the process's own stream
and none of its lines reach the display or ``stdout.log``.  The runtime
installs it in the live modes only, ``CAPTURE_MODES`` (the JAX runtime's
``("cli", "dashboard")``): the rank-0 output panel of the CLI display
and of the browser dashboard, and each rank's ``stdout.log``, are fed
from its buffer.
"""

from __future__ import annotations

import sys
import threading
from typing import List, Optional, Tuple

#: the modes whose live display shows rank 0's output
CAPTURE_MODES = ("cli", "dashboard")


class StreamCapture:
    """Tees sys.stdout/sys.stderr into a bounded in-memory buffer while
    passing everything through to the original streams."""

    def __init__(self, max_lines: int = 2000, capture_stderr: bool = True) -> None:
        self._max = max_lines
        self._lock = threading.Lock()
        self._lines: List[Tuple[str, str]] = []  # (stream, line)
        self._orig_stdout: Optional[object] = None
        self._orig_stderr: Optional[object] = None
        self._capture_stderr = capture_stderr

    class _Tee:
        def __init__(self, orig, cap: "StreamCapture", label: str) -> None:
            self._orig = orig
            self._cap = cap
            self._label = label
            self._partial = ""

        def write(self, data: str) -> int:
            try:
                n = self._orig.write(data)
            except Exception:
                n = len(data)
            try:
                self._partial += data
                while "\n" in self._partial:
                    line, self._partial = self._partial.split("\n", 1)
                    self._cap._add(self._label, line)
            except Exception:
                pass
            return n if isinstance(n, int) else len(data)

        def flush(self) -> None:
            try:
                self._orig.flush()
            except Exception:
                pass

        def isatty(self) -> bool:
            try:
                return self._orig.isatty()
            except Exception:
                return False

        def fileno(self) -> int:
            return self._orig.fileno()

        @property
        def encoding(self):
            return getattr(self._orig, "encoding", "utf-8")

        def __getattr__(self, name):
            # Proxy everything else (buffer, writable, readable, mode, …)
            # so user code poking sys.stdout keeps working under capture.
            return getattr(self._orig, name)

    def _add(self, label: str, line: str) -> None:
        with self._lock:
            self._lines.append((label, line))
            if len(self._lines) > self._max:
                del self._lines[: len(self._lines) - self._max]

    def start(self) -> None:
        if self._orig_stdout is not None:
            return
        self._orig_stdout = sys.stdout
        sys.stdout = self._Tee(sys.stdout, self, "stdout")
        if self._capture_stderr:
            self._orig_stderr = sys.stderr
            sys.stderr = self._Tee(sys.stderr, self, "stderr")

    def stop(self) -> None:
        if self._orig_stdout is not None:
            sys.stdout = self._orig_stdout
            self._orig_stdout = None
        if self._orig_stderr is not None:
            sys.stderr = self._orig_stderr
            self._orig_stderr = None

    def drain(self) -> List[Tuple[str, str]]:
        with self._lock:
            out, self._lines = self._lines, []
        return out
