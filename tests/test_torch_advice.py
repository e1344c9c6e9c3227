"""The port's advice texts: PyTorch/CUDA remedies where the JAX rules name
JAX and TPU ones.

``ACTIONS`` is the one-to-one table from each JAX action the port rewrote
to the port's action, and ``SUMMARIES`` the same for the summary phrases
it rewrote (patterns, since summaries carry numbers).  The parity tests
(``test_torch_diagnosis.py``, ``test_torch_final_report.py``,
``test_torch_system_process.py``) put the JAX output through
``port_advice`` and then compare ``action`` and ``summary`` exactly, so
neither field leaves the comparison.

Then every rule of every port pack (step time, step memory, system,
process, liveness) is made to fire on seeded rows or snapshots, and no ``action`` or ``summary``
it writes may name JAX, XLA, the MXU, the TPU, ``device_put``, remat,
donation or the ``traceml-tpu`` command; the port's own package name,
``traceml_tpu_torch`` (in the PERF_REGRESSION action's ``python -m
traceml_tpu_torch compare``), is not such a name.
"""

import re

import numpy as np
import pytest

from traceml_tpu.analytics import baselines as jax_baselines
from traceml_tpu.diagnostics.liveness import rules as jax_liveness_rules
from traceml_tpu.diagnostics.process import rules as jax_process_rules
from traceml_tpu.diagnostics.step_memory import rules as jax_memory_rules
from traceml_tpu.diagnostics.step_time import rules as jax_step_rules
from traceml_tpu.diagnostics.system import rules as jax_system_rules

ACTIONS = {
    # step time: INPUT_BOUND
    "Speed up the input pipeline: more dataloader workers / host prefetch, cache or "
    "pre-tokenize the dataset, overlap host input with device compute (double-buffer "
    "device_put).":
    "Speed up the input pipeline: more DataLoader workers (num_workers) with "
    "pin_memory=True, cache or pre-tokenize the dataset, overlap host input with device "
    "compute (non_blocking=True copies from pinned memory, prefetch the next batch).",
    # step time: RESIDUAL_HEAVY
    "Look for untimed host work between phases: logging, metric syncs (device→host "
    "reads), checkpoint writes, Python overhead; on TPU also check for hidden host-device "
    "round trips forcing early sync.":
    "Look for untimed host work between phases: logging, metric syncs (device→host reads "
    "such as .item() or .cpu()), checkpoint writes, Python overhead; also check for hidden "
    "host-device round trips forcing early sync (torch.cuda.synchronize, printing a CUDA "
    "tensor).",
    # step time: COMPUTE_BOUND
    "To go faster: larger per-chip batch, bf16 everywhere, remat tuning, or scale out over "
    "more chips.":
    "To go faster: larger per-GPU batch, bf16 autocast and TF32 for f32 matmuls, "
    "activation checkpointing (torch.utils.checkpoint) tuned to fit that batch, or scale "
    "out over more GPUs.",
    # step time: COMPILE_BOUND
    "Eliminate recompiles: pad/bucket batch shapes to a fixed set, avoid "
    "Python-value-dependent jit branches, check for dtype or sharding churn between steps.":
    "Eliminate recompiles: pad/bucket batch shapes to a fixed set, mark dynamic dimensions "
    "(torch._dynamo.mark_dynamic), remove graph breaks and Python-value-dependent branches "
    "under torch.compile (TORCH_LOGS=recompiles,graph_breaks names them), check for dtype "
    "or device churn between steps.",
    # step time: LOW_MFU and MODERATE_MFU
    "Feed the MXU: bf16 matmuls (jax.default_matmul_precision), larger per-chip batch/seq "
    "so matmul tiles fill the systolic array, check for fusion breaks and tiny ops with "
    "`traceml-tpu profile`, consider remat to enable bigger batches.":
    "Feed the tensor cores: bf16 autocast (torch.autocast) and TF32 for f32 matmuls "
    '(torch.backends.cuda.matmul.fp32_precision = "tf32"), larger per-GPU batch/seq so GEMM '
    "tiles fill the SMs, find tiny kernels and launch gaps with torch.profiler, consider "
    "activation checkpointing (torch.utils.checkpoint) to enable bigger batches.",
    # step memory: HIGH_MEMORY_PRESSURE
    "Reduce per-chip footprint: smaller microbatch, jax.checkpoint/remat, optimizer-state "
    "sharding (ZeRO-style), bf16 activations, or shard the model further.":
    "Reduce per-GPU footprint: smaller microbatch, activation checkpointing "
    "(torch.utils.checkpoint), optimizer-state sharding (ZeRO-style, FSDP), bf16 "
    "activations, or shard the model further.",
    # step memory: MEMORY_CREEP_EARLY and MEMORY_CREEP_CONFIRMED
    "Hunt Python-side references to device arrays (growing metric lists, retained "
    "batches), check for per-step recompiles creating executables, and confirm donated "
    "buffers are actually donated.":
    "Hunt Python-side references to CUDA tensors (growing metric lists, losses kept "
    "without .item() or .detach(), retained batches), check for autograd graphs kept alive "
    "across steps, and read torch.cuda.memory_stats(): a reserve that grows while "
    "allocated bytes stay flat is caching-allocator fragmentation "
    "(PYTORCH_CUDA_ALLOC_CONF=expandable_segments:True; torch.cuda.empty_cache() returns "
    "cached blocks).",
    # system: HIGH_DEVICE_MEMORY
    "One allocation spike from OOM: add remat, reduce microbatch, or rebalance sharding.":
    "One allocation spike from OOM: activation checkpointing (torch.utils.checkpoint), a "
    "smaller microbatch or rebalanced sharding; "
    "PYTORCH_CUDA_ALLOC_CONF=expandable_segments:True cuts allocator fragmentation.",
    # system: LOW_DEVICE_UTILIZATION and MODERATE_DEVICE_UTILIZATION
    "Feed the chip: prefetch input, increase per-step work, check for host-side stalls in "
    "the phase table.":
    "Feed the GPU: DataLoader prefetch with pinned memory, increase per-step work, check "
    "for host-side stalls in the phase table.",
    # process: DEVICE_MEMORY_OVERHANG
    "Find the spike (often eval/checkpoint or the first compiled step) and shave it: remat "
    "the spiky computation or stage it.":
    "Find the spike (often eval/checkpoint or the first step's allocations) and shave it: "
    "activation checkpointing (torch.utils.checkpoint) of the spiky computation, or stage "
    "it; torch.cuda.empty_cache() then returns the cached blocks.",
    # liveness: RANK_LOST, LIKELY_PREEMPTED, WORLD_STALE
    "Check the lost ranks' hosts/logs for OOM kills, preemption notices, or crashes; "
    "cross-rank metrics after the loss point cover survivors only.":
    "Check the lost ranks' GPU hosts: the kernel log for the OOM killer or NVIDIA Xid errors, "
    "the scheduler's preemption notices, and each rank's crash_stderr.log; cross-rank metrics "
    "after the loss point cover survivors only.",
    "Check the scheduler/cloud console for preemption or eviction events on these hosts; if "
    "preemptible capacity, consider checkpointing more frequently.":
    "Check the scheduler (Slurm, Kubernetes) or the cloud console for preemption or eviction of "
    "these GPU hosts; on preemptible capacity, checkpoint more often and let torchrun's elastic "
    "restarts resume the job.",
    "Check aggregator host load and the network path between ranks and the aggregator; "
    "individual rank verdicts are unreliable while most of the world is silent.":
    "Check the aggregator host's load and the network path from the GPU hosts to it; individual "
    "rank verdicts are unreliable while most of the world is silent.",
    # cross-run baselines: PERF_REGRESSION names the port's own command
    "diff this run against the baseline sessions (traceml compare) and check the attributed ranks' "
    "hosts before trusting new code":
    "diff this run against the baseline sessions (python -m traceml_tpu_torch compare) and check the "
    "attributed ranks' hosts before trusting new code",
}

# (JAX pattern, port replacement) over summaries
SUMMARIES = (
    (r"^XLA re-compilation consumes ", "Re-compilation consumes "),
    (r"^(Node \d+|Rank \d+) chip (\d+)", r"\1 GPU \2"),
    (r" duty cycle at ", " NVML utilization at "),
)

FORBIDDEN = re.compile(r"jax|xla|mxu|tpu|device_put|remat|donat|traceml-tpu", re.IGNORECASE)
PORT_PACKAGE = "traceml_tpu_torch"  # the port's own name, which its advice may give


def names_jax_remedy(text):
    """A FORBIDDEN word in ``text`` outside the port's own package name."""
    return FORBIDDEN.search((text or "").replace(PORT_PACKAGE, ""))


def port_summary(text):
    for pattern, repl in SUMMARIES:
        text = re.sub(pattern, repl, text)
    return text


def port_advice(obj):
    """A JAX payload (issue, result or report section, nested) with its
    actions and summaries as the port writes them."""
    if isinstance(obj, list):
        return [port_advice(v) for v in obj]
    if not isinstance(obj, dict):
        return obj
    out = {}
    for key, value in obj.items():
        if key == "action" and isinstance(value, str):
            out[key] = ACTIONS.get(value, value)
        elif key == "summary" and isinstance(value, str):
            out[key] = port_summary(value)
        else:
            out[key] = port_advice(value)
    return out


def test_the_table_is_one_to_one_and_names_no_jax_remedy():
    assert len(set(ACTIONS.values())) == len(ACTIONS)
    assert len({p for p, _ in SUMMARIES}) == len({r for _, r in SUMMARIES}) == len(SUMMARIES)
    for jax_text, port_text in ACTIONS.items():
        assert jax_text != port_text and not names_jax_remedy(port_text), port_text
    # every JAX action the table names is a text some JAX rule writes
    sources = "".join(
        open(m.__file__, encoding="utf-8").read()
        for m in (jax_step_rules, jax_memory_rules, jax_system_rules, jax_process_rules,
                  jax_liveness_rules, jax_baselines)
    )
    flat = re.sub(r'"\s*\n\s*(f?)"', "", sources)
    for jax_text in ACTIONS:
        assert jax_text in flat, jax_text


# -- every rule of every port pack, made to fire -----------------------------

GiB = 1 << 30


def _step_rows(rng, n_steps, step_ms, input_ms, compute_ms, compile_ms=0.0, device_compute=None,
               clock="device"):
    from traceml_tpu_torch.utils import timing as T

    rows = []
    for i in range(n_steps):
        j = rng.normal(0.0, 0.3, 4)
        comp = max(0.0, compute_ms + j[2])
        events = {
            T.STEP_TIME: {"cpu_ms": step_ms + j[0], "device_ms": step_ms + j[0], "count": 1},
            T.DATALOADER_NEXT: {"cpu_ms": max(0.0, input_ms + j[1]), "device_ms": None, "count": 1},
            T.COMPUTE_TIME: {"cpu_ms": comp, "count": 1,
                             "device_ms": comp if device_compute is None else device_compute + j[2]},
        }
        if compile_ms:
            events[T.COMPILE_TIME] = {"cpu_ms": compile_ms + j[3], "device_ms": None, "count": 1}
        rows.append({"step": i + 1, "timestamp": 1000.0 + i, "clock": clock, "events": events})
    return rows


def _step_time_issues(rng):
    from traceml_tpu_torch.diagnostics.step_time.api import diagnose_rank_rows, diagnose_window
    from traceml_tpu_torch.utils.step_time_window import build_step_time_window

    healthy = {0: _step_rows(rng, 60, 100.0, 2.0, 95.0)}
    straggler = {r: _step_rows(rng, 60, 100.0, 3.0, 94.0) for r in range(4)}
    straggler[2] = _step_rows(rng, 60, 160.0, 3.0, 154.0)
    scenarios = [
        healthy,
        {0: _step_rows(rng, 60, 100.0, 55.0, 43.0)},
        straggler,
        {0: _step_rows(rng, 60, 100.0, 4.0, 90.0, device_compute=8.0, clock="host")},
        {0: _step_rows(rng, 60, 100.0, 2.0, 45.0)},
        {0: _step_rows(rng, 60, 100.0, 2.0, 58.0, compile_ms=38.0)},
    ]
    issues = [i for s in scenarios for i in diagnose_rank_rows(s).issues]
    window = build_step_time_window(healthy)
    for mfu in (0.05, 0.2):
        eff = {"mfu_median": mfu, "achieved_tflops_median": 989.0 * mfu, "peak_tflops": 989.0,
               "device_kind": "NVIDIA H100 80GB HBM3"}
        issues += diagnose_window(window, efficiency=eff).issues
    return issues


def _memory_rows(rng, n, start_frac, end_frac, limit=80 * GiB):
    fracs = np.linspace(start_frac, end_frac, n) * rng.uniform(0.999, 1.001, n)
    return [{"step": 5 * (i + 1), "timestamp": 1000.0 + i, "device_id": 0,
             "device_kind": "NVIDIA H100 80GB HBM3", "current_bytes": int(f * limit),
             "peak_bytes": int(f * limit), "step_peak_bytes": int(f * limit), "limit_bytes": limit}
            for i, f in enumerate(fracs)]


def _step_memory_issues(rng):
    from traceml_tpu_torch.diagnostics.step_memory.api import diagnose_rank_rows

    scenarios = [
        {0: _memory_rows(rng, 40, 0.5, 0.5), 1: _memory_rows(rng, 40, 0.95, 0.95)},
        # 900 rows (the creep rules need 800): +1 GiB at 18% growth is early,
        # +3.2 GiB confirmed
        {0: _memory_rows(rng, 900, 0.06, 0.072)},
        {0: _memory_rows(rng, 900, 0.10, 0.14)},
    ]
    return [i for s in scenarios for i in diagnose_rank_rows(s).issues]


def _system_process_issues(rng):
    from tests.test_torch_system_process import PROCESS_SCENARIOS, SYSTEM_SCENARIOS
    from traceml_tpu_torch.diagnostics.process.api import diagnose as process_diagnose
    from traceml_tpu_torch.diagnostics.system.api import diagnose as system_diagnose
    from traceml_tpu_torch.diagnostics.system.rules import SystemPolicy

    issues = []
    for build in SYSTEM_SCENARIOS.values():
        host, devices = build(rng)
        issues += system_diagnose(host, devices).issues
        # the power rule needs a rated power, which the default policy lacks
        issues += system_diagnose(host, devices, SystemPolicy(device_power_rated_w=700.0)).issues
    for build in PROCESS_SCENARIOS.values():
        issues += process_diagnose(*build(rng)).issues
    return issues


def _liveness_issues(rng):
    from tests.test_torch_liveness import SNAPSHOTS
    from traceml_tpu_torch.diagnostics.liveness import diagnose_rank_status

    return [i for snap in SNAPSHOTS.values() for i in diagnose_rank_status(snap).issues]


RULE_KINDS = {
    "step_time": {
        "CleanStragglerRule": {"COMPUTE_STRAGGLER"}, "InputBoundRule": {"INPUT_BOUND"},
        "CompileBoundRule": {"COMPILE_BOUND"}, "ResidualHeavyRule": {"RESIDUAL_HEAVY"},
        "LowDeviceOccupancyRule": {"LOW_DEVICE_UTILIZATION"},
        "LowMfuRule": {"LOW_MFU", "MODERATE_MFU"}, "ComputeBoundRule": {"COMPUTE_BOUND"},
    },
    "step_memory": {
        "HighPressureRule": {"HIGH_MEMORY_PRESSURE"}, "ImbalanceRule": {"MEMORY_IMBALANCE"},
        "CreepEarlyRule": {"MEMORY_CREEP_EARLY"}, "CreepConfirmedRule": {"MEMORY_CREEP_CONFIRMED"},
    },
    "system": {
        "HighHostCPURule": {"HIGH_HOST_CPU"}, "HighHostMemoryRule": {"HIGH_HOST_MEMORY"},
        "HighDeviceMemoryRule": {"HIGH_DEVICE_MEMORY"},
        "LowDeviceUtilizationCounterRule": {"LOW_DEVICE_UTILIZATION", "MODERATE_DEVICE_UTILIZATION"},
        "HighDeviceTemperatureRule": {"HIGH_DEVICE_TEMPERATURE"},
        "HighDevicePowerRule": {"HIGH_DEVICE_POWER"},
    },
    "process": {
        "HighProcessRSSRule": {"HIGH_PROCESS_RSS"}, "HighProcessCPURule": {"HIGH_PROCESS_CPU"},
        "RankDeviceMemoryImbalanceRule": {"RANK_DEVICE_MEMORY_IMBALANCE"},
        "DeviceMemoryOverhangRule": {"DEVICE_MEMORY_OVERHANG"},
    },
    "liveness": {
        "RankLostRule": {"RANK_LOST"}, "LikelyPreemptedRule": {"LIKELY_PREEMPTED"},
        "WorldStaleRule": {"WORLD_STALE"},
    },
}


@pytest.mark.parametrize("pack", sorted(RULE_KINDS))
def test_every_rule_fires_and_names_no_jax_remedy(pack):
    import importlib

    rules = importlib.import_module(f"traceml_tpu_torch.diagnostics.{pack}.rules")
    assert sorted(type(r).__name__ for r in rules.DEFAULT_RULES) == sorted(RULE_KINDS[pack])
    collect = {"step_time": _step_time_issues, "step_memory": _step_memory_issues,
               "system": _system_process_issues, "process": _system_process_issues,
               "liveness": _liveness_issues}[pack]
    issues = collect(np.random.default_rng(7))
    kinds = {i.kind for i in issues}
    for rule, rule_kinds in RULE_KINDS[pack].items():
        assert kinds & rule_kinds, f"{rule} never fired: {sorted(kinds)}"
    for issue in issues:
        for text in (issue.action, issue.summary):
            assert not names_jax_remedy(text), (issue.kind, text)
