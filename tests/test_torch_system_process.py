"""System and process telemetry: the port against the JAX package.

* ``resolve_runtime_identity`` on torchrun environments equals the JAX
  one on the fields both have.
* The system and process diagnoses equal the JAX ``diagnose`` on the same
  numpy-seeded rows, with the actions and summaries put through the
  advice table (``test_torch_advice.py``): healthy; high host CPU and
  memory; device memory at 95%; NVML utilization at 20% and at 50%; 90 °C;
  RSS imbalance across ranks; process CPU; device-memory imbalance and
  overhang.  Every NVML column is filled.
* ``device_memory_rows`` equals the JAX one on a scripted backend, and
  carries the run's peak: never below a step-memory row's peak, though
  the CUDA backend resets the allocator's peak at every step start.
* The NVML reader against a fake ``libnvidia-ml``: torch devices map to
  NVML handles by UUID, power in mW becomes W, a failed read gives
  ``None``; without the library it latches unavailable.
* The samplers call nothing in ``torch.cuda`` while CUDA is not
  initialized.
"""

import json
import os

import numpy as np
import pytest

from tests.test_torch_advice import port_advice
from traceml_tpu.diagnostics.process.api import diagnose as jax_process_diagnose
from traceml_tpu.diagnostics.system.api import diagnose as jax_system_diagnose
from traceml_tpu.runtime.identity import resolve_runtime_identity as jax_identity
from traceml_tpu.utils.step_memory import FakeMemoryBackend as JaxFake
from traceml_tpu.utils.step_memory import device_memory_rows as jax_device_memory_rows
from traceml_tpu_torch.diagnostics.process.api import diagnose as process_diagnose
from traceml_tpu_torch.diagnostics.system.api import diagnose as system_diagnose
from traceml_tpu_torch.runtime.identity import resolve_runtime_identity
from traceml_tpu_torch.utils.step_memory import FakeMemoryBackend, device_memory_rows

GiB = 1 << 30
H100 = "NVIDIA H100 80GB HBM3"
N_ROWS = 40


def _jitter(rng, value, spread, n=N_ROWS):
    return [float(v) for v in value + rng.normal(0.0, spread, n)]


def _host(rng, cpu=30.0, mem_frac=0.4, total=1024 * GiB, node=0):
    cpu_vals = _jitter(rng, cpu, 1.0)
    return [{"timestamp": 1000.0 + i, "node_rank": node, "hostname": f"host-{node}",
             "cpu_pct": c, "memory_used_bytes": int(total * mem_frac * rng.uniform(0.99, 1.01)),
             "memory_total_bytes": total, "memory_pct": mem_frac * 100.0, "load_1m": 2.0,
             "load_5m": 1.5, "load_15m": 1.0} for i, c in enumerate(cpu_vals)]


def _gpu(rng, used_frac=0.3, util=95.0, temp=60.0, power=420.0, peak_frac=None, total=80 * GiB):
    util_vals = np.clip(_jitter(rng, util, 2.0), 0.0, 100.0)
    temp_vals, power_vals = _jitter(rng, temp, 0.5), _jitter(rng, power, 5.0)
    return [{"timestamp": 1000.0 + i, "device_id": 0, "device_kind": H100,
             "memory_used_bytes": int(total * used_frac * rng.uniform(0.99, 1.0)),
             "memory_peak_bytes": int(total * (peak_frac or used_frac)),
             "memory_total_bytes": total, "utilization_pct": float(u), "temperature_c": t,
             "power_w": p} for i, (u, t, p) in enumerate(zip(util_vals, temp_vals, power_vals))]


SYSTEM_SCENARIOS = {
    "healthy": lambda rng: ({0: _host(rng)}, {(0, 0): _gpu(rng)}),
    "host_cpu_and_memory": lambda rng: (
        {0: _host(rng, cpu=88.0, mem_frac=0.9), 1: _host(rng, cpu=97.0, mem_frac=0.96, node=1)},
        {(0, 0): _gpu(rng), (1, 0): _gpu(rng)}),
    "device_memory_95": lambda rng: ({0: _host(rng)}, {(0, 0): _gpu(rng, used_frac=0.95)}),
    "utilization_20": lambda rng: ({0: _host(rng)}, {(0, 0): _gpu(rng, util=20.0)}),
    "utilization_50": lambda rng: ({0: _host(rng)}, {(0, 0): _gpu(rng, util=50.0)}),
    "temperature_90": lambda rng: ({0: _host(rng)}, {(0, 0): _gpu(rng, temp=90.0, power=690.0)}),
}
SYSTEM_KINDS = {
    "healthy": {"HEALTHY"},
    "host_cpu_and_memory": {"HIGH_HOST_CPU", "HIGH_HOST_MEMORY"},
    "device_memory_95": {"HIGH_DEVICE_MEMORY"},
    "utilization_20": {"LOW_DEVICE_UTILIZATION"},
    "utilization_50": {"MODERATE_DEVICE_UTILIZATION"},
    "temperature_90": {"HIGH_DEVICE_TEMPERATURE"},
}


def _proc(rng, rank, rss=4 * GiB, cpu=110.0):
    cpu_vals = _jitter(rng, cpu, 3.0)
    return [{"timestamp": 1000.0 + i, "global_rank": rank, "pid": 100 + rank,
             "hostname": "host-0", "cpu_pct": c, "rss_bytes": int(rss * rng.uniform(0.99, 1.01)),
             "vms_bytes": int(3 * rss), "num_threads": 24} for i, c in enumerate(cpu_vals)]


def _proc_gpu(rng, used_frac=0.3, peak_frac=None):
    rows = _gpu(rng, used_frac=used_frac, peak_frac=peak_frac)
    return [{k: r[k] for k in ("timestamp", "device_id", "device_kind", "memory_used_bytes",
                               "memory_peak_bytes", "memory_total_bytes")} for r in rows]


PROCESS_SCENARIOS = {
    "healthy": lambda rng: ({r: _proc(rng, r) for r in range(2)},
                            {(r, 0): _proc_gpu(rng) for r in range(2)}),
    "rss_imbalance": lambda rng: ({0: _proc(rng, 0), 1: _proc(rng, 1, rss=60 * GiB),
                                   2: _proc(rng, 2)},
                                  {(r, 0): _proc_gpu(rng) for r in range(3)}),
    "process_cpu": lambda rng: ({0: _proc(rng, 0, cpu=420.0)}, {(0, 0): _proc_gpu(rng)}),
    "device_memory_imbalance": lambda rng: (
        {r: _proc(rng, r) for r in range(3)},
        {(0, 0): _proc_gpu(rng, 0.55), (1, 0): _proc_gpu(rng, 0.56), (2, 0): _proc_gpu(rng, 0.8)}),
    "overhang": lambda rng: ({0: _proc(rng, 0)}, {(0, 0): _proc_gpu(rng, 0.1, peak_frac=0.45)}),
}
PROCESS_KINDS = {
    "healthy": {"HEALTHY"},
    "rss_imbalance": {"HIGH_PROCESS_RSS"},
    "process_cpu": {"HIGH_PROCESS_CPU"},
    "device_memory_imbalance": {"RANK_DEVICE_MEMORY_IMBALANCE"},
    "overhang": {"DEVICE_MEMORY_OVERHANG"},
}


def _seed(name, table):
    return np.random.default_rng(sorted(table).index(name))


@pytest.mark.parametrize("scenario", sorted(SYSTEM_SCENARIOS))
def test_system_diagnosis_equals_jax(scenario):
    host, devices = SYSTEM_SCENARIOS[scenario](_seed(scenario, SYSTEM_SCENARIOS))
    ours, theirs = system_diagnose(host, devices), jax_system_diagnose(host, devices)
    assert {i.kind for i in ours.issues} == SYSTEM_KINDS[scenario]
    assert ours.to_dict() == port_advice(theirs.to_dict())


@pytest.mark.parametrize("scenario", sorted(PROCESS_SCENARIOS))
def test_process_diagnosis_equals_jax(scenario):
    procs, devices = PROCESS_SCENARIOS[scenario](_seed(scenario, PROCESS_SCENARIOS))
    ours, theirs = process_diagnose(procs, devices), jax_process_diagnose(procs, devices)
    assert {i.kind for i in ours.issues} == PROCESS_KINDS[scenario]
    assert ours.to_dict() == port_advice(theirs.to_dict())


# -- identity ------------------------------------------------------------------

TORCHRUN_ENVS = [
    {"RANK": "0", "WORLD_SIZE": "1"},
    {"RANK": "3", "WORLD_SIZE": "8", "LOCAL_RANK": "3", "LOCAL_WORLD_SIZE": "4", "GROUP_RANK": "0"},
    {"RANK": "6", "WORLD_SIZE": "8", "LOCAL_RANK": "2", "LOCAL_WORLD_SIZE": "4", "NODE_RANK": "1"},
    {"RANK": "5", "WORLD_SIZE": "8"},
    {"RANK": "x", "WORLD_SIZE": "8"},
    {},
]
SHARED_FIELDS = ("global_rank", "local_rank", "world_size", "local_world_size", "node_rank",
                 "hostname", "pid", "source", "is_global_primary", "is_node_primary")


@pytest.mark.parametrize("env", TORCHRUN_ENVS, ids=lambda e: ",".join(f"{k}={v}" for k, v in e.items()) or "empty")
def test_identity_equals_jax_on_torchrun_envs(env):
    ours, theirs = resolve_runtime_identity(env), jax_identity(env)
    for field in SHARED_FIELDS:
        assert getattr(ours, field) == getattr(theirs, field), field
    sender = ours.to_sender_identity("s")
    assert sender.to_meta()["global_rank"] == ours.global_rank
    assert (sender.node_rank, sender.local_world_size) == (ours.node_rank, ours.local_world_size)


def test_identity_drops_the_tpu_sources():
    env = {"TPU_WORKER_ID": "2", "TPU_WORKER_HOSTNAMES": "a,b,c", "MEGASCALE_SLICE_ID": "1"}
    assert jax_identity(env).source == "env:tpu_worker"
    ours = resolve_runtime_identity(env)
    assert (ours.source, ours.global_rank, ours.world_size) == ("defaults", 0, 1)


# -- device memory rows ----------------------------------------------------------


def _sample(current, peak, device=0):
    return [{"device_id": device, "device_kind": H100, "current_bytes": current,
             "peak_bytes": peak, "limit_bytes": 80 * GiB}]


def test_device_memory_rows_equal_jax_on_a_scripted_backend():
    script = [_sample(100, 150), _sample(120, 300), _sample(90, 300)]
    ours_holder = {"backend": FakeMemoryBackend(script)}
    theirs_holder = {"backend": JaxFake(script)}
    for ts in (1.0, 2.0, 3.0):
        assert device_memory_rows(ours_holder, ts) == jax_device_memory_rows(theirs_holder, ts)


class _ResettingBackend(FakeMemoryBackend):
    """Peaks since the last reset, as after torch.cuda.reset_peak_memory_stats."""

    def reset_peak(self):
        pass


def test_device_memory_rows_carry_the_run_peak():
    """The step-memory tracker and the samplers share the CUDA backend,
    which resets the allocator's peak at every step start: the samplers'
    rows must still carry the run's peak so far."""
    from traceml_tpu_torch.utils.step_memory import StepMemoryTracker
    from traceml_tpu_torch.utils.timing import drain_step_memory_rows

    # the tracker's first start sample, then per step its end sample and
    # one sampler tick (the next step's start edge is the previous end)
    script = [_sample(100, 100), _sample(110, 900), _sample(105, 400),
              _sample(100, 300), _sample(120, 500)]
    backend = _ResettingBackend(script)
    tracker = StepMemoryTracker(backend, min_sample_interval_s=0)
    holder = {"backend": backend, "tracker": tracker}
    tracker.reset(1)
    step_rows = tracker.record(1)
    sampled = [device_memory_rows(holder, 1.0)]
    tracker.reset(2)
    step_rows += tracker.record(2)
    sampled.append(device_memory_rows(holder, 2.0))
    drain_step_memory_rows()
    assert [r["step_peak_bytes"] for r in step_rows] == [900, 300]
    # the ticks read the allocator's peaks since the last reset (400, 500)
    assert [r["memory_peak_bytes"] for r in sum(sampled, [])] == [900, 900]
    assert [r["memory_used_bytes"] for r in sum(sampled, [])] == [105, 120]


# -- NVML --------------------------------------------------------------------------


class _FakeNvml:
    """libnvidia-ml as ctypes calls it: two GPUs, listed by NVML in the
    reverse of the torch order below, so a map by position would swap
    them.  Outputs come back through the pointers the reader passes."""

    def __init__(self):
        # uuid -> (handle, temperature °C, utilization %, power mW, limit mW, name)
        self.gpus = {b"GPU-bbbb": (1, 81, 40, 612345, 700000, b"NVIDIA H100 80GB HBM3"),
                     b"GPU-aaaa": (2, 37, 77, 95123, 650000, b"NVIDIA H100 80GB HBM3")}
        self.fail_util = False
        self.inits = 0

    def _gpu(self, handle):
        return next(g for g in self.gpus.values() if g[0] == handle.value)

    def nvmlInit_v2(self):
        self.inits += 1
        return 0

    def nvmlDeviceGetHandleByUUID(self, uuid, handle_p):
        if uuid not in self.gpus:
            return 13  # NVML_ERROR_NOT_FOUND
        handle_p.contents.value = self.gpus[uuid][0]
        return 0

    def nvmlDeviceGetUtilizationRates(self, handle, util_p):
        if self.fail_util:
            return 999  # NVML_ERROR_UNKNOWN
        util_p.contents.gpu, util_p.contents.memory = self._gpu(handle)[2], 5
        return 0

    def nvmlDeviceGetTemperature(self, handle, sensor, out_p):
        assert sensor == 0  # NVML_TEMPERATURE_GPU
        out_p.contents.value = self._gpu(handle)[1]
        return 0

    def nvmlDeviceGetPowerUsage(self, handle, out_p):
        out_p.contents.value = self._gpu(handle)[3]
        return 0

    def nvmlDeviceGetEnforcedPowerLimit(self, handle, out_p):
        out_p.contents.value = self._gpu(handle)[4]
        return 0

    def nvmlDeviceGetName(self, handle, buf, size):
        buf.value = self._gpu(handle)[5]
        return 0


@pytest.fixture
def fake_nvml(monkeypatch):
    from traceml_tpu_torch.utils import nvml

    lib = _FakeNvml()
    monkeypatch.setattr(nvml, "_load_library", lambda: lib)
    return lib


def test_nvml_reader_maps_devices_by_uuid(fake_nvml):
    from traceml_tpu_torch.utils.nvml import NvmlReader

    # torch device 0 is GPU-aaaa, device 1 GPU-bbbb: NVML lists them the other way round
    reader = NvmlReader(["GPU-aaaa", "GPU-bbbb"])
    assert fake_nvml.inits == 1
    assert reader.sample(0) == {"utilization_pct": 77.0, "temperature_c": 37.0, "power_w": 95.123}
    assert reader.sample(1) == {"utilization_pct": 40.0, "temperature_c": 81.0, "power_w": 612.345}
    assert reader.info(0) == {"nvml_name": H100, "uuid": "GPU-aaaa", "power_limit_w": 650.0}


def test_nvml_failed_read_gives_none(fake_nvml):
    from traceml_tpu_torch.utils.nvml import NvmlReader

    fake_nvml.fail_util = True
    reader = NvmlReader(["GPU-aaaa"])
    assert reader.sample(0) == {"utilization_pct": None, "temperature_c": 37.0, "power_w": 95.123}
    fake_nvml.fail_util = False
    assert reader.sample(0)["utilization_pct"] == 77.0


def test_nvml_unknown_uuid_raises(fake_nvml):
    from traceml_tpu_torch.utils.nvml import NvmlError, NvmlReader

    with pytest.raises(NvmlError):
        NvmlReader(["GPU-cccc"])


def test_nvml_absent_latches_unavailable(monkeypatch):
    """No ``libnvidia-ml.so.1`` on this machine: construction raises, and
    the system sampler latches the counters as unavailable once CUDA is
    up (faked here) and leaves their columns empty."""
    from traceml_tpu_torch.samplers import system_sampler
    from traceml_tpu_torch.utils import nvml

    with pytest.raises(nvml.NvmlError):
        nvml.NvmlReader(["GPU-aaaa"])
    sampler = system_sampler.SystemSampler(memory_backend=FakeMemoryBackend([_sample(100, 150)]))
    assert sampler._gpu_nvml() is None and sampler._nvml is None  # CUDA not initialized: untried
    monkeypatch.setattr(system_sampler, "cuda_is_initialized", lambda: True)
    monkeypatch.setattr(nvml, "torch_device_uuids", lambda: ["GPU-aaaa"])
    assert sampler._gpu_nvml() is None and sampler._nvml is False
    sampler.sample()
    row = sampler.db.tail("system_device")[-1]
    assert (row["utilization_pct"], row["temperature_c"], row["power_w"]) == (None, None, None)
    assert row["memory_used_bytes"] == 100


def test_system_sampler_fills_the_nvml_columns(fake_nvml, monkeypatch):
    from traceml_tpu_torch.samplers import system_sampler
    from traceml_tpu_torch.utils import nvml

    monkeypatch.setattr(system_sampler, "cuda_is_initialized", lambda: True)
    monkeypatch.setattr(nvml, "torch_device_uuids", lambda: ["GPU-aaaa"])
    sampler = system_sampler.SystemSampler(memory_backend=FakeMemoryBackend([_sample(100, 150)]))
    sampler.sample()
    row = sampler.db.tail("system_device")[-1]
    assert (row["utilization_pct"], row["temperature_c"], row["power_w"]) == (77.0, 37.0, 95.123)
    assert sampler.sample_errors == 0 and fake_nvml.inits == 1


# -- the samplers on the CPU ----------------------------------------------------------


def test_samplers_never_touch_cuda_before_it_is_initialized(monkeypatch, tmp_path):
    import torch

    from traceml_tpu_torch.samplers.process_sampler import ProcessSampler
    from traceml_tpu_torch.samplers.system_sampler import SystemSampler

    calls = []
    for name in ("device_count", "current_device", "get_device_name", "get_device_properties",
                 "memory_stats", "memory_stats_as_nested_dict", "memory_reserved", "mem_get_info",
                 "max_memory_allocated", "memory_allocated"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, _n=name, **k: calls.append(_n))
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    system = SystemSampler(manifest_path=tmp_path / "system_manifest.json")
    system._MANIFEST_WAIT_SEC = 0.0
    process = ProcessSampler()
    for _ in range(3):
        system.sample()
        process.sample()
    assert calls == []
    assert system.sample_errors == process.sample_errors == 0
    host, proc = system.db.tail("system"), process.db.tail("process")
    assert len(host) == len(proc) == 3
    assert system.db.tail("system_device") == process.db.tail("process_device") == []
    assert proc[-1]["pid"] == os.getpid() and proc[-1]["rss_bytes"] > 0
    manifest = json.loads((tmp_path / "system_manifest.json").read_text())
    assert "topology_unavailable" in manifest and "devices" not in manifest
