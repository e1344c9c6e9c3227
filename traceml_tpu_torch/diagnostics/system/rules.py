"""System (host + GPU) rules.

Counterpart of ``traceml_tpu/diagnostics/system/rules.py``: the same
policy, thresholds, kinds, severities, metrics and scores.  The three
counter rules (utilization, temperature, power) fire on whatever the rows
hold; the port's system sampler fills those columns from NVML.  The
summaries say GPU where the JAX texts say chip, and the actions name
PyTorch/CUDA remedies.  ``device_power_rated_w`` stays 0, as in JAX, so
HIGH_DEVICE_POWER is off.
"""

from __future__ import annotations

import dataclasses
import statistics
from typing import Any, Dict, List, Mapping, Sequence

from traceml_tpu_torch.diagnostics.common import (
    confidence_from,
    SEVERITY_CRITICAL,
    SEVERITY_INFO,
    SEVERITY_WARNING,
    DiagnosticIssue,
)
from traceml_tpu_torch.utils.formatting import fmt_bytes


@dataclasses.dataclass(frozen=True)
class SystemPolicy:
    host_cpu_warn: float = 80.0  # %
    host_cpu_critical: float = 95.0
    host_mem_warn: float = 0.85
    host_mem_critical: float = 0.95
    device_mem_warn: float = 0.92
    device_mem_critical: float = 0.97
    # data-gated device-counter rules: these columns are null where NVML
    # does not answer
    device_util_low_warn: float = 30.0  # %
    device_util_moderate: float = 70.0  # % — below this is "moderate"
    device_temp_warn: float = 85.0  # °C
    device_temp_critical: float = 95.0
    device_power_warn_frac: float = 0.95  # of rated, when rated known
    device_power_rated_w: float = 0.0  # 0 = unknown → absolute threshold off


DEFAULT_POLICY = SystemPolicy()


@dataclasses.dataclass
class SystemContext:
    # node_rank → host sample rows
    host: Dict[int, List[Dict[str, Any]]]
    # (node_rank, device_id) → device sample rows
    devices: Dict[tuple, List[Dict[str, Any]]]
    policy: SystemPolicy = DEFAULT_POLICY


def build_system_context(
    host_rows: Mapping[int, Sequence[Mapping[str, Any]]],
    device_rows: Mapping[tuple, Sequence[Mapping[str, Any]]],
    policy: SystemPolicy = DEFAULT_POLICY,
) -> SystemContext:
    return SystemContext(
        host={int(k): list(v) for k, v in host_rows.items()},
        devices={k: list(v) for k, v in device_rows.items()},
        policy=policy,
    )


def _recent_mean(rows: List[Dict[str, Any]], key: str, n: int = 30):
    vals = [float(r[key]) for r in rows[-n:] if r.get(key) is not None]
    return statistics.mean(vals) if vals else None


class HighHostCPURule:
    def evaluate(self, ctx: SystemContext) -> List[DiagnosticIssue]:
        issues = []
        p = ctx.policy
        for node, rows in ctx.host.items():
            cpu = _recent_mean(rows, "cpu_pct")
            if cpu is None or cpu < p.host_cpu_warn:
                continue
            severity = (
                SEVERITY_CRITICAL if cpu >= p.host_cpu_critical else SEVERITY_WARNING
            )
            issues.append(
                DiagnosticIssue(
                    kind="HIGH_HOST_CPU",
                    severity=severity,
                    summary=f"Node {node} host CPU at {cpu:.0f}% (recent mean).",
                    action=(
                        "Host CPU saturation starves the input pipeline and "
                        "dispatch: reduce dataloader workers' work per sample, "
                        "move preprocessing offline, or get more host cores."
                    ),
                    metric="host_cpu_pct",
                    score=cpu / 100.0,
                    confidence=confidence_from(cpu, p.host_cpu_warn),
                    ranks=[node],
                )
            )
        return issues


class HighHostMemoryRule:
    def evaluate(self, ctx: SystemContext) -> List[DiagnosticIssue]:
        issues = []
        p = ctx.policy
        for node, rows in ctx.host.items():
            if not rows:
                continue
            last = rows[-1]
            used, total = last.get("memory_used_bytes"), last.get("memory_total_bytes")
            if not used or not total:
                continue
            frac = float(used) / float(total)
            if frac < p.host_mem_warn:
                continue
            severity = (
                SEVERITY_CRITICAL if frac >= p.host_mem_critical else SEVERITY_WARNING
            )
            issues.append(
                DiagnosticIssue(
                    kind="HIGH_HOST_MEMORY",
                    severity=severity,
                    summary=(
                        f"Node {node} host RAM at {frac * 100:.0f}% "
                        f"({fmt_bytes(used)} / {fmt_bytes(total)})."
                    ),
                    action=(
                        "OOM-killer risk: shrink host-side caches/prefetch "
                        "buffers, fewer dataloader workers, stream instead of "
                        "materializing datasets."
                    ),
                    metric="host_mem_pct",
                    score=frac,
                    share_pct=frac,
                    confidence=confidence_from(frac, p.host_mem_warn),
                    ranks=[node],
                )
            )
        return issues


class HighDeviceMemoryRule:
    def evaluate(self, ctx: SystemContext) -> List[DiagnosticIssue]:
        issues = []
        p = ctx.policy
        for (node, dev), rows in ctx.devices.items():
            if not rows:
                continue
            last = rows[-1]
            used, total = last.get("memory_used_bytes"), last.get("memory_total_bytes")
            if not used or not total:
                continue
            frac = float(used) / float(total)
            if frac < p.device_mem_warn:
                continue
            severity = (
                SEVERITY_CRITICAL
                if frac >= p.device_mem_critical
                else SEVERITY_WARNING
            )
            issues.append(
                DiagnosticIssue(
                    kind="HIGH_DEVICE_MEMORY",
                    severity=severity,
                    summary=(
                        f"Node {node} GPU {dev} HBM at {frac * 100:.0f}% "
                        f"({fmt_bytes(used)} / {fmt_bytes(total)})."
                    ),
                    action=(
                        "One allocation spike from OOM: activation "
                        "checkpointing (torch.utils.checkpoint), a smaller "
                        "microbatch or rebalanced sharding; "
                        "PYTORCH_CUDA_ALLOC_CONF=expandable_segments:True "
                        "cuts allocator fragmentation."
                    ),
                    metric="device_mem_pct",
                    score=frac,
                    share_pct=frac,
                    confidence=confidence_from(frac, p.device_mem_warn),
                    ranks=[node],
                    evidence={"device_id": dev},
                )
            )
        return issues


class LowDeviceUtilizationCounterRule:
    """Counter-based low utilization — fires where the rows hold
    ``utilization_pct`` (NVML's share of the sample period with a kernel
    running; the step-time domain's LOW_DEVICE_UTILIZATION reads the
    timing core's occupancy instead)."""

    def evaluate(self, ctx: SystemContext) -> List[DiagnosticIssue]:
        issues = []
        p = ctx.policy
        for (node, dev), rows in ctx.devices.items():
            util = _recent_mean(rows, "utilization_pct")
            if util is None or util >= p.device_util_moderate:
                continue
            if util < p.device_util_low_warn:
                kind, severity = "LOW_DEVICE_UTILIZATION", SEVERITY_WARNING
                summary = (
                    f"Node {node} GPU {dev} NVML utilization at {util:.0f}% "
                    "(recent mean) — the accelerator is mostly idle."
                )
            else:  # the 30–70% band (reference: MODERATE_GPU_UTILIZATION)
                kind, severity = "MODERATE_DEVICE_UTILIZATION", SEVERITY_INFO
                summary = (
                    f"Node {node} GPU {dev} NVML utilization at {util:.0f}% "
                    "(recent mean) — headroom left on the accelerator."
                )
            issues.append(
                DiagnosticIssue(
                    kind=kind,
                    severity=severity,
                    summary=summary,
                    action=(
                        "Feed the GPU: DataLoader prefetch with pinned "
                        "memory, increase per-step work, check for host-side "
                        "stalls in the phase table."
                    ),
                    metric="device_utilization_pct",
                    score=1.0 - util / 100.0,
                    share_pct=util / 100.0,
                    ranks=[node],
                    evidence={"device_id": dev},
                )
            )
        return issues


class HighDeviceTemperatureRule:
    def evaluate(self, ctx: SystemContext) -> List[DiagnosticIssue]:
        issues = []
        p = ctx.policy
        for (node, dev), rows in ctx.devices.items():
            temp = _recent_mean(rows, "temperature_c", n=10)
            if temp is None or temp < p.device_temp_warn:
                continue
            severity = (
                SEVERITY_CRITICAL
                if temp >= p.device_temp_critical
                else SEVERITY_WARNING
            )
            issues.append(
                DiagnosticIssue(
                    kind="HIGH_DEVICE_TEMPERATURE",
                    severity=severity,
                    summary=(
                        f"Node {node} GPU {dev} at {temp:.0f}°C — thermal "
                        "throttling territory."
                    ),
                    action=(
                        "Sustained heat throttles the clock and skews this "
                        "rank: check cooling/airflow, and expect stragglers "
                        "attributed to this host."
                    ),
                    metric="device_temperature_c",
                    score=temp / 100.0,
                    ranks=[node],
                    evidence={"device_id": dev},
                )
            )
        return issues


class HighDevicePowerRule:
    def evaluate(self, ctx: SystemContext) -> List[DiagnosticIssue]:
        issues = []
        p = ctx.policy
        if p.device_power_rated_w <= 0:
            return []  # no rated power known → absolute rule disabled
        for (node, dev), rows in ctx.devices.items():
            power = _recent_mean(rows, "power_w", n=10)
            if power is None:
                continue
            frac = power / p.device_power_rated_w
            if frac < p.device_power_warn_frac:
                continue
            issues.append(
                DiagnosticIssue(
                    kind="HIGH_DEVICE_POWER",
                    severity=SEVERITY_WARNING,
                    summary=(
                        f"Node {node} GPU {dev} drawing {power:.0f}W "
                        f"({frac * 100:.0f}% of rated) — power-limit "
                        "throttling possible."
                    ),
                    action=(
                        "Near the power cap the clock drops under sustained "
                        "load; expect per-rank slowdowns on this host."
                    ),
                    metric="device_power_w",
                    score=frac,
                    ranks=[node],
                    evidence={"device_id": dev},
                )
            )
        return issues


DEFAULT_RULES = (
    HighHostCPURule(),
    HighHostMemoryRule(),
    HighDeviceMemoryRule(),
    LowDeviceUtilizationCounterRule(),
    HighDeviceTemperatureRule(),
    HighDevicePowerRule(),
)
