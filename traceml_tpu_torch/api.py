"""Public API surface, resolved lazily through ``traceml_tpu_torch.__getattr__``."""

from __future__ import annotations

from traceml_tpu_torch.instrumentation.dataloader import wrap_dataloader  # noqa: F401
from traceml_tpu_torch.runtime.lifecycle import start_runtime, stop_runtime  # noqa: F401
from traceml_tpu_torch.sdk.flops import estimate_step_flops, set_step_flops  # noqa: F401
from traceml_tpu_torch.sdk.initial import init  # noqa: F401
from traceml_tpu_torch.sdk.instrumentation import trace_step, trace_time  # noqa: F401
from traceml_tpu_torch.sdk.step_fn import wrap_step_fn  # noqa: F401
from traceml_tpu_torch.sdk.summary_client import live_metrics  # noqa: F401
from traceml_tpu_torch.sdk.wrappers import (  # noqa: F401
    wrap_backward,
    wrap_forward,
    wrap_h2d,
    wrap_optimizer,
)
