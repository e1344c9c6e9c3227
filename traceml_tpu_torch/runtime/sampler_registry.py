"""Declarative sampler registry.

Counterpart of ``traceml_tpu/runtime/sampler_registry.py`` for the
samplers the port has: system (one per node), process, step_time and
step_memory.  Each spec says whether the sampler runs on the node's
primary rank only and whether it drains when recording stops
(``--trace-max-steps``: step_time and step_memory, as in JAX).  With
``disk_backup`` every sampler keeps its backup under the rank's
``data`` directory.  The JAX package's collectives and serving samplers
come with ROADMAP queue 1 items 5 and 6: they are not registered yet.
As in JAX, the stdout/stderr sampler is wired apart from the registry,
in the ``cli`` and ``dashboard`` modes only, because it needs the
runtime's :class:`StreamCapture`: it writes every rank's ``stdout.log``
and ships rows from the global primary rank alone.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Callable, Dict, List, Optional

from traceml_tpu_torch.runtime.identity import RuntimeIdentity
from traceml_tpu_torch.runtime.settings import TraceMLSettings
from traceml_tpu_torch.runtime.stdout_capture import CAPTURE_MODES, StreamCapture
from traceml_tpu_torch.samplers.base_sampler import BaseSampler


@dataclasses.dataclass(frozen=True)
class SamplerSpec:
    key: str
    factory: Callable[..., BaseSampler]
    node_primary_only: bool = False
    drain_on_recording_stop: bool = False


SAMPLER_REGISTRY: Dict[str, SamplerSpec] = {}


def register_default_samplers() -> None:
    """Register the port's samplers, in the JAX registry's order."""
    from traceml_tpu_torch.samplers.process_sampler import ProcessSampler
    from traceml_tpu_torch.samplers.step_memory_sampler import StepMemorySampler
    from traceml_tpu_torch.samplers.step_time_sampler import StepTimeSampler
    from traceml_tpu_torch.samplers.system_sampler import SystemSampler

    specs = [
        SamplerSpec("system", SystemSampler, node_primary_only=True),
        SamplerSpec("process", ProcessSampler),
        SamplerSpec("step_time", StepTimeSampler, drain_on_recording_stop=True),
        SamplerSpec("step_memory", StepMemorySampler, drain_on_recording_stop=True),
    ]
    for spec in specs:
        SAMPLER_REGISTRY.setdefault(spec.key, spec)


def build_samplers(
    settings: TraceMLSettings, identity: RuntimeIdentity, capture: Optional[StreamCapture] = None
) -> List[BaseSampler]:
    """Instantiate the samplers this rank should run; each carries its
    spec as ``_spec``."""
    register_default_samplers()
    backup_dir: Optional[Path] = None
    if settings.disk_backup:
        backup_dir = settings.rank_dir(identity.global_rank) / "data"
    out: List[BaseSampler] = []
    for key, spec in SAMPLER_REGISTRY.items():
        if spec.node_primary_only and not identity.is_node_primary:
            continue
        kwargs: dict = {"disk_backup_dir": backup_dir}
        if key == "system":
            kwargs["manifest_path"] = settings.session_dir / "system_manifest.json"
        sampler = spec.factory(**kwargs)
        sampler._spec = spec
        out.append(sampler)
    if capture is not None and settings.mode in CAPTURE_MODES:
        from traceml_tpu_torch.samplers.stdout_stderr_sampler import StdoutStderrSampler

        sampler = StdoutStderrSampler(
            capture,
            log_path=settings.rank_dir(identity.global_rank) / "stdout.log",
            mirror_to_db=identity.is_global_primary,
            disk_backup_dir=backup_dir,
        )
        sampler._spec = SamplerSpec("stdout_stderr", StdoutStderrSampler)
        out.append(sampler)
    return out
