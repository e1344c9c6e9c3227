"""stdout/stderr sampler.

Counterpart of ``traceml_tpu/samplers/stdout_stderr_sampler.py``.  Drains
the :class:`StreamCapture` buffer into ``stdout_stderr`` rows (the live
display shows the global primary rank's output) and appends every rank's
lines to its ``stdout.log``.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Optional

from traceml_tpu_torch.runtime.stdout_capture import StreamCapture
from traceml_tpu_torch.samplers.base_sampler import BaseSampler

TABLE = "stdout_stderr"


class StdoutStderrSampler(BaseSampler):
    name = "stdout_stderr"

    def __init__(self, capture: StreamCapture, log_path: Path, mirror_to_db: bool,
                 disk_backup_dir: Optional[Path] = None) -> None:
        super().__init__(disk_backup_dir)
        self._capture = capture
        self._log_path = Path(log_path)
        self._mirror = mirror_to_db

    def _sample(self) -> None:
        lines = self._capture.drain()
        if not lines:
            return
        ts = time.time()
        self._log_path.parent.mkdir(parents=True, exist_ok=True)
        with open(self._log_path, "a", encoding="utf-8") as fh:
            for stream, line in lines:
                fh.write(f"[{stream}] {line}\n")
        if self._mirror:
            self.db.add_records(
                TABLE,
                [
                    {"timestamp": ts, "stream": stream, "line": line[:4096]}
                    for stream, line in lines
                ],
            )
