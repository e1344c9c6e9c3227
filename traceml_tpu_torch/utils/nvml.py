"""GPU counters from NVML, through ``ctypes`` on ``libnvidia-ml.so.1``.

Counterpart of ``traceml_tpu/utils/tpu_metrics.py`` (libtpu's duty-cycle
reader): the system sampler's source of utilization, temperature and
power per GPU.  ``pynvml`` is not needed; the functions are bound here.

* Construction loads the library, calls ``nvmlInit_v2`` and looks up one
  handle per torch device, and raises :class:`NvmlError` when any of it
  fails: the caller latches the counters as unavailable.
* NVML enumerates every GPU of the host and ignores
  ``CUDA_VISIBLE_DEVICES``, so NVML index *i* need not be torch device
  *i*.  Each torch device is mapped to its handle by UUID
  (``torch.cuda.get_device_properties(i).uuid``), never by position.
* A read that fails gives ``None`` for that counter in that sample.
* NVML needs no CUDA context, and nothing here touches ``torch.cuda``.
"""

from __future__ import annotations

import ctypes
from typing import Any, Dict, List, Optional, Sequence

NVML_SUCCESS = 0
NVML_TEMPERATURE_GPU = 0  # the GPU die sensor
_NAME_LEN = 96  # NVML_DEVICE_NAME_V2_BUFFER_SIZE


class NvmlError(RuntimeError):
    pass


class _Utilization(ctypes.Structure):
    _fields_ = [("gpu", ctypes.c_uint), ("memory", ctypes.c_uint)]


_UINT_P = ctypes.POINTER(ctypes.c_uint)
_SIGNATURES = {
    "nvmlInit_v2": [],
    "nvmlDeviceGetHandleByUUID": [ctypes.c_char_p, ctypes.POINTER(ctypes.c_void_p)],
    "nvmlDeviceGetUtilizationRates": [ctypes.c_void_p, ctypes.POINTER(_Utilization)],
    "nvmlDeviceGetTemperature": [ctypes.c_void_p, ctypes.c_int, _UINT_P],
    "nvmlDeviceGetPowerUsage": [ctypes.c_void_p, _UINT_P],
    "nvmlDeviceGetEnforcedPowerLimit": [ctypes.c_void_p, _UINT_P],
    "nvmlDeviceGetName": [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint],
}


def _load_library() -> Any:
    try:
        lib = ctypes.CDLL("libnvidia-ml.so.1")
    except OSError as exc:
        raise NvmlError(f"libnvidia-ml.so.1 not loadable: {exc}") from exc
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def torch_device_uuids() -> List[str]:
    """NVML's UUID string of every visible torch device, in torch order.
    Call only once CUDA is initialized: the properties query would
    initialize it otherwise."""
    import torch

    return [f"GPU-{torch.cuda.get_device_properties(i).uuid}" for i in range(torch.cuda.device_count())]


class NvmlReader:
    """Counters of the given devices, ``uuids[i]`` being torch device *i*."""

    def __init__(self, uuids: Sequence[str]) -> None:
        self._lib = _load_library()
        rc = self._lib.nvmlInit_v2()
        if rc != NVML_SUCCESS:
            raise NvmlError(f"nvmlInit_v2 returned {rc}")
        self._uuids = list(uuids)
        self._handles = []
        for uuid in self._uuids:
            handle = ctypes.c_void_p()
            rc = self._lib.nvmlDeviceGetHandleByUUID(uuid.encode(), ctypes.pointer(handle))
            if rc != NVML_SUCCESS:
                raise NvmlError(f"nvmlDeviceGetHandleByUUID({uuid}) returned {rc}")
            self._handles.append(handle)

    def _uint(self, fn: str, index: int, *args: Any) -> Optional[int]:
        out = ctypes.c_uint()
        rc = getattr(self._lib, fn)(self._handles[index], *args, ctypes.pointer(out))
        return out.value if rc == NVML_SUCCESS else None

    def sample(self, index: int) -> Dict[str, Optional[float]]:
        """Utilization (% of the last sample period with a kernel running),
        GPU temperature (°C) and power draw (W) of torch device ``index``."""
        util = _Utilization()
        rc = self._lib.nvmlDeviceGetUtilizationRates(self._handles[index], ctypes.pointer(util))
        temp = self._uint("nvmlDeviceGetTemperature", index, NVML_TEMPERATURE_GPU)
        power_mw = self._uint("nvmlDeviceGetPowerUsage", index)
        return {
            "utilization_pct": float(util.gpu) if rc == NVML_SUCCESS else None,
            "temperature_c": float(temp) if temp is not None else None,
            "power_w": power_mw / 1000.0 if power_mw is not None else None,
        }

    def info(self, index: int) -> Dict[str, Any]:
        """The manifest's entry: NVML's name, the UUID and the enforced
        power limit (W) of torch device ``index``."""
        name = ctypes.create_string_buffer(_NAME_LEN)
        rc = self._lib.nvmlDeviceGetName(self._handles[index], name, _NAME_LEN)
        limit_mw = self._uint("nvmlDeviceGetEnforcedPowerLimit", index)
        return {
            "nvml_name": name.value.decode() if rc == NVML_SUCCESS else None,
            "uuid": self._uuids[index],
            "power_limit_w": limit_mw / 1000.0 if limit_mw is not None else None,
        }
