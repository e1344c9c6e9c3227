"""Process supervision utilities.

Counterpart of ``traceml_tpu/launcher/process.py`` (copied).  Beyond
bare spawn/terminate, the launcher keeps a bounded STDERR RING per
supervised child: stderr is teed through to the launcher's own stderr
(live visibility unchanged) while the last 64 KiB are retained in
memory.  When a child dies abnormally — including signal deaths
(segfault, OOM-kill) that bypass every in-process crash hook — the ring
is flushed to ``<session>/rank_<r>/crash_stderr.log`` so the death is
diagnosable from artifacts alone.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

from traceml_tpu_torch.utils.atomic_io import read_json

STDERR_RING_LIMIT = 64 * 1024


class StderrRing:
    """Drain a child's stderr on a daemon thread: tee every chunk to
    ``sink`` and retain the newest ``limit`` bytes."""

    def __init__(self, stream, limit: int = STDERR_RING_LIMIT, sink=None):
        self._stream = stream
        self._limit = int(limit)
        self._buf = bytearray()
        self._lock = threading.Lock()
        self._sink = sink
        self.truncated = False
        self._thread = threading.Thread(
            target=self._drain, name="traceml-stderr-ring", daemon=True
        )
        self._thread.start()

    def _drain(self) -> None:
        sink = self._sink
        if sink is None:
            sink = getattr(sys.stderr, "buffer", None)
        try:
            for chunk in iter(lambda: self._stream.read1(8192), b""):
                with self._lock:
                    self._buf.extend(chunk)
                    if len(self._buf) > self._limit:
                        del self._buf[: len(self._buf) - self._limit]
                        self.truncated = True
                if sink is not None:
                    try:
                        sink.write(chunk)
                        sink.flush()
                    except (OSError, ValueError):
                        sink = None  # parent stderr gone; keep ringing
        except (OSError, ValueError):
            pass  # child closed / killed mid-read

    def join(self, timeout: float = 5.0) -> None:
        self._thread.join(timeout)

    def tail(self) -> bytes:
        with self._lock:
            return bytes(self._buf)


class SupervisedChild:
    """A spawned child plus its stderr ring and crash-log writer."""

    def __init__(self, proc: subprocess.Popen, label: str):
        self.proc = proc
        self.label = label
        self.ring = StderrRing(proc.stderr) if proc.stderr else None
        self._crash_written: Optional[Path] = None

    def poll(self):
        return self.proc.poll()

    @property
    def returncode(self):
        return self.proc.returncode

    def describe_exit(self) -> str:
        rc = self.proc.returncode
        if rc is not None and rc < 0:
            try:
                name = signal.Signals(-rc).name
            except ValueError:
                name = f"signal {-rc}"
            return f"killed by {name}"
        return f"exit code {rc}"

    def write_crash_log(self, session_dir: Path) -> Optional[Path]:
        """Flush the ring to ``<session>/<label>/crash_stderr.log``
        (idempotent; written even when the ring is empty — a silent
        SIGKILL still deserves an artifact naming the signal)."""
        if self._crash_written is not None:
            return self._crash_written
        if self.ring is not None:
            self.ring.join(timeout=2.0)
        path = Path(session_dir) / self.label / "crash_stderr.log"
        tail = self.ring.tail() if self.ring is not None else b""
        header = (
            f"# {self.label} died abnormally: {self.describe_exit()}\n"
            f"# captured {len(tail)} bytes of stderr"
            f"{' (ring truncated to newest 64 KiB)' if self.ring is not None and self.ring.truncated else ''}\n"
        ).encode()
        try:
            path.parent.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(".tmp")
            tmp.write_bytes(header + tail)
            os.replace(tmp, path)
        except OSError:
            return None
        self._crash_written = path
        return path


def spawn_supervised(
    argv: List[str],
    label: str,
    env: Optional[Dict[str, str]] = None,
    cwd: Optional[str] = None,
) -> SupervisedChild:
    """Spawn with a stderr ring (see module docstring)."""
    proc = spawn(argv, env=env, cwd=cwd, stderr=subprocess.PIPE)
    return SupervisedChild(proc, label)


def spawn(
    argv: List[str],
    env: Optional[Dict[str, str]] = None,
    cwd: Optional[str] = None,
    stdout=None,
    stderr=None,
) -> subprocess.Popen:
    """Start a child in its own process group so we can terminate the
    whole tree."""
    full_env = dict(os.environ)
    if env:
        full_env.update(env)
    kwargs = {}
    if os.name == "posix":
        kwargs["start_new_session"] = True
    return subprocess.Popen(
        argv,
        env=full_env,
        cwd=cwd,
        stdout=stdout,
        stderr=stderr,
        **kwargs,
    )


def terminate(proc: subprocess.Popen, grace_sec: float = 10.0) -> int:
    """SIGTERM the process group, escalate to SIGKILL after the grace
    period; returns the exit code."""
    if proc.poll() is not None:
        return proc.returncode
    try:
        if os.name == "posix":
            os.killpg(os.getpgid(proc.pid), signal.SIGTERM)
        else:  # pragma: no cover
            proc.terminate()
    except (ProcessLookupError, PermissionError):
        pass
    deadline = time.monotonic() + grace_sec
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            return proc.returncode
        time.sleep(0.1)
    try:
        if os.name == "posix":
            os.killpg(os.getpgid(proc.pid), signal.SIGKILL)
        else:  # pragma: no cover
            proc.kill()
    except (ProcessLookupError, PermissionError):
        pass
    proc.wait(timeout=10)
    return proc.returncode


def wait_for_ready_file(path: Path, timeout: float = 30.0) -> Optional[dict]:
    """Poll the aggregator's ready file for the bound port (the file
    carries the ephemeral port, which a connect probe cannot discover)."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        data = read_json(path)
        if data and data.get("port"):
            return data
        time.sleep(0.1)
    return None


def python_argv(module: str) -> List[str]:
    return [sys.executable, "-m", module]
