"""Public API surface, resolved lazily through ``traceml_tpu_torch.__getattr__``."""

from __future__ import annotations

from traceml_tpu_torch.instrumentation.collectives import (  # noqa: F401
    instrument_collective,
    patch_dist_collectives,
)
from traceml_tpu_torch.instrumentation.dataloader import wrap_dataloader  # noqa: F401
from traceml_tpu_torch.parallel.mesh import make_mesh  # noqa: F401
from traceml_tpu_torch.runtime.lifecycle import start_runtime, stop_runtime  # noqa: F401
from traceml_tpu_torch.sdk.flops import estimate_step_flops, set_step_flops  # noqa: F401
from traceml_tpu_torch.sdk.initial import init  # noqa: F401
from traceml_tpu_torch.sdk.instrumentation import trace_step, trace_time  # noqa: F401
from traceml_tpu_torch.sdk.step_fn import wrap_step_fn  # noqa: F401
from traceml_tpu_torch.sdk.summary_client import final_summary, live_metrics, summary  # noqa: F401
from traceml_tpu_torch.sdk.wrappers import (  # noqa: F401
    wrap_backward,
    wrap_collective,
    wrap_forward,
    wrap_h2d,
    wrap_optimizer,
)


def set_step_tokens(tokens: float) -> None:
    """Declare the tokens consumed by ONE training step (global batch ×
    sequence length): the tokens/s numerator.  Optional and independent
    of ``set_step_flops``; with it declared, the step-time ``efficiency``
    block reports ``tokens_per_sec_median``."""
    from traceml_tpu_torch.sdk.state import get_state

    get_state().tokens_per_step = float(tokens)
