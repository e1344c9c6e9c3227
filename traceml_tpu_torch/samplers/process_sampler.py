"""Process sampler: this rank's host and GPU footprint.

Counterpart of ``traceml_tpu/samplers/process_sampler.py``.  Per tick:
process CPU %, RSS, VMS and thread count (psutil) into ``process``, and
this process's caching-allocator bytes per GPU (in use, the run's peak,
capacity; ``utils/step_memory.device_memory_rows``) into
``process_device``.  The device rows wait until the process has
initialized CUDA itself: the sampler thread never initializes it.
"""

from __future__ import annotations

import time
from typing import Any

from traceml_tpu_torch.samplers.base_sampler import BaseSampler
from traceml_tpu_torch.utils.step_memory import device_memory_rows

TABLE = "process"
TABLE_DEVICE = "process_device"


class ProcessSampler(BaseSampler):
    name = "process"

    def __init__(self, memory_backend: Any = None) -> None:
        super().__init__()
        self._backend_holder = {"backend": memory_backend}
        try:
            import psutil

            self._proc = psutil.Process()
            self._proc.cpu_percent(interval=None)
        except Exception:
            self._proc = None

    def _sample(self) -> None:
        ts = time.time()
        if self._proc is not None:
            with self._proc.oneshot():
                mem = self._proc.memory_info()
                row = {
                    "timestamp": ts,
                    "pid": self._proc.pid,
                    "cpu_pct": self._proc.cpu_percent(interval=None),
                    "rss_bytes": mem.rss,
                    "vms_bytes": mem.vms,
                    "num_threads": self._proc.num_threads(),
                }
            self.db.add_record(TABLE, row)
        rows = device_memory_rows(self._backend_holder, ts)
        if rows:
            self.db.add_records(TABLE_DEVICE, rows)
