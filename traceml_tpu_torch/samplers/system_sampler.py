"""System sampler: host and GPU counters, on the node's primary rank only.

Counterpart of ``traceml_tpu/samplers/system_sampler.py``.  Tables:

* ``system``         — psutil host CPU %, RAM used/total, load average;
* ``system_device``  — per GPU of this process: allocator bytes in use,
  the run's peak and the capacity (``utils/step_memory.device_memory_rows``),
  with ``utilization_pct``, ``temperature_c`` and ``power_w`` from NVML
  (``utils/nvml.py``), read by the GPU's UUID.

One-time ``system_manifest.json``: hostname, OS, Python, CPU count, host
memory and, once this process has initialized CUDA, each visible GPU's
name, UUID, total memory and enforced power limit.  A process that never
initializes CUDA within ``_MANIFEST_WAIT_SEC`` gets the manifest with a
``topology_unavailable`` note, as in JAX; a later initialization upgrades
it.

The sampler thread never initializes CUDA: every ``torch.cuda`` call
waits for ``cuda_is_initialized()``, and NVML needs no CUDA context.  A
failure is the JAX package's fail-open: NVML unavailable (no library, no
init) is latched once and its columns stay ``None``; a failed read gives
``None`` for that sample.  Neither takes the step off the GPU.
"""

from __future__ import annotations

import os
import platform
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

from traceml_tpu_torch.runtime.identity import cuda_is_initialized
from traceml_tpu_torch.samplers.base_sampler import BaseSampler
from traceml_tpu_torch.utils.atomic_io import atomic_write_json
from traceml_tpu_torch.utils.error_log import get_error_log
from traceml_tpu_torch.utils.step_memory import device_memory_rows

TABLE_HOST = "system"
TABLE_DEVICE = "system_device"
_NVML_COLUMNS = ("utilization_pct", "temperature_c", "power_w")


def build_system_manifest(nvml: Any = None, include_devices: bool = True) -> Dict[str, Any]:
    """``include_devices=False`` leaves out the GPU inventory, whose
    properties query would initialize CUDA."""
    manifest: Dict[str, Any] = {
        "hostname": platform.node(),
        "os": platform.platform(),
        "python": platform.python_version(),
        "pid": os.getpid(),
        "created_at": time.time(),
    }
    try:
        import psutil

        manifest["cpu_count"] = psutil.cpu_count()
        manifest["host_memory_total_bytes"] = psutil.virtual_memory().total
    except Exception:
        pass
    if not include_devices:
        manifest["platform"] = "unknown"
        return manifest
    try:
        import torch

        manifest["platform"] = "cuda"
        manifest["torch"] = torch.__version__
        manifest["cuda"] = torch.version.cuda
        manifest["local_device_count"] = torch.cuda.device_count()
        devices = []
        for i in range(torch.cuda.device_count()):
            props = torch.cuda.get_device_properties(i)
            entry = {"id": i, "kind": props.name, "uuid": f"GPU-{props.uuid}",
                     "memory_total_bytes": int(props.total_memory)}
            if nvml:
                entry.update(nvml.info(i))
            devices.append(entry)
        manifest["devices"] = devices
    except Exception as exc:
        manifest["platform"] = "unknown"
        get_error_log().warning("system manifest device probe failed", exc)
    manifest["utilization_probe"] = (
        {"status": "available", "source": "nvml"} if nvml
        else {"status": "unavailable", "reason": "libnvidia-ml.so.1 did not load or init"}
    )
    return manifest


class SystemSampler(BaseSampler):
    name = "system"

    #: how long to wait for the traced process to initialize CUDA before
    #: writing the manifest without the GPU inventory
    _MANIFEST_WAIT_SEC = 30.0

    def __init__(self, manifest_path: Optional[Path] = None, memory_backend: Any = None,
                 disk_backup_dir: Optional[Path] = None) -> None:
        super().__init__(disk_backup_dir)
        self._manifest_path = manifest_path
        self._manifest_written = False
        self._manifest_degraded = False
        self._manifest_wait_started = time.monotonic()
        self._backend_holder = {"backend": memory_backend}
        self._nvml: Any = None  # None = untried, False = unavailable
        try:
            import psutil

            self._psutil = psutil
            psutil.cpu_percent(interval=None)  # prime the delta
        except Exception:
            self._psutil = None

    def _gpu_nvml(self) -> Any:
        """The NVML reader, made once CUDA is initialized (the UUIDs come
        from ``torch.cuda``); ``None`` before that, and for good once it
        failed to construct (no library, ``nvmlInit`` failed, an unknown
        UUID): those do not change within a run."""
        if self._nvml is None and cuda_is_initialized():
            from traceml_tpu_torch.utils.nvml import NvmlError, NvmlReader, torch_device_uuids

            try:
                self._nvml = NvmlReader(torch_device_uuids())
            except NvmlError as exc:
                get_error_log().warning("NVML unavailable; GPU counters left empty", exc)
                self._nvml = False
        return self._nvml or None

    def _ensure_manifest(self) -> None:
        if self._manifest_path is None:
            return
        if self._manifest_written and not self._manifest_degraded:
            return
        manifest: Optional[Dict[str, Any]] = None
        if cuda_is_initialized():
            manifest = build_system_manifest(self._gpu_nvml())
            self._manifest_degraded = False
        elif self._manifest_written:
            return  # the note is on disk; keep waiting for CUDA
        elif time.monotonic() - self._manifest_wait_started >= self._MANIFEST_WAIT_SEC:
            manifest = build_system_manifest(include_devices=False)
            manifest["topology_unavailable"] = {
                "reason": (
                    "CUDA was never initialized by the traced process within "
                    f"{self._MANIFEST_WAIT_SEC:.0f}s; GPU inventory omitted (the "
                    "sampler never initializes CUDA from its thread)"
                ),
                "waited_sec": round(time.monotonic() - self._manifest_wait_started, 1),
            }
            self._manifest_degraded = True
        if manifest is None:
            return
        try:
            atomic_write_json(self._manifest_path, manifest)
            self._manifest_written = True
        except Exception as exc:
            get_error_log().warning("system manifest write failed", exc)

    def _device_rows(self, ts: float) -> List[Dict[str, Any]]:
        rows = device_memory_rows(self._backend_holder, ts)
        nvml = self._gpu_nvml() if rows else None
        for r in rows:
            r.update(nvml.sample(r["device_id"]) if nvml else dict.fromkeys(_NVML_COLUMNS))
        return rows

    def _sample(self) -> None:
        self._ensure_manifest()
        ts = time.time()
        if self._psutil is not None:
            vm = self._psutil.virtual_memory()
            try:
                load1, load5, load15 = os.getloadavg()
            except OSError:
                load1 = load5 = load15 = None
            self.db.add_record(
                TABLE_HOST,
                {
                    "timestamp": ts,
                    "cpu_pct": self._psutil.cpu_percent(interval=None),
                    "memory_used_bytes": vm.used,
                    "memory_total_bytes": vm.total,
                    "memory_pct": vm.percent,
                    "load_1m": load1,
                    "load_5m": load5,
                    "load_15m": load15,
                },
            )
        rows = self._device_rows(ts)
        if rows:
            self.db.add_records(TABLE_DEVICE, rows)
