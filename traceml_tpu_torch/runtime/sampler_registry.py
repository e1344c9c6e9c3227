"""Declarative sampler registry.

Counterpart of ``traceml_tpu/runtime/sampler_registry.py`` for the
samplers the port has: system (one per node), process, step_time and
step_memory.  Each spec says whether the sampler runs on the node's
primary rank only.  The JAX spec's ``drain_on_recording_stop`` has no
counterpart yet: the port has no recording stop (``--trace-max-steps``),
so every sampler drains once, at shutdown, as the step-time and
step-memory samplers did before this registry.  The JAX package's
collectives and serving samplers come with ROADMAP queue 1 items 5 and 6,
its stdout/stderr sampler with the ``cli`` mode (queue 1 item 3c): they
are not registered yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List

from traceml_tpu_torch.runtime.identity import RuntimeIdentity
from traceml_tpu_torch.runtime.settings import TraceMLSettings
from traceml_tpu_torch.samplers.base_sampler import BaseSampler


@dataclasses.dataclass(frozen=True)
class SamplerSpec:
    key: str
    factory: Callable[..., BaseSampler]
    node_primary_only: bool = False


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
        SamplerSpec("step_time", StepTimeSampler),
        SamplerSpec("step_memory", StepMemorySampler),
    ]
    for spec in specs:
        SAMPLER_REGISTRY.setdefault(spec.key, spec)


def build_samplers(settings: TraceMLSettings, identity: RuntimeIdentity) -> List[BaseSampler]:
    """Instantiate the samplers this rank should run."""
    register_default_samplers()
    out: List[BaseSampler] = []
    for key, spec in SAMPLER_REGISTRY.items():
        if spec.node_primary_only and not identity.is_node_primary:
            continue
        kwargs = {}
        if key == "system":
            kwargs["manifest_path"] = settings.session_dir / "system_manifest.json"
        out.append(spec.factory(**kwargs))
    return out
