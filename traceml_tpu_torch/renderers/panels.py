"""The panel renderers under one name.

Counterpart of ``traceml_tpu/renderers/panels.py``: the renderers live in
the per-domain package ``traceml_tpu_torch.renderers.cli``; the CLI
display driver imports the dashboard from here, as the JAX one does.
"""

from traceml_tpu_torch.renderers.cli import (  # noqa: F401
    cluster_panel,
    dashboard,
    diagnostics_panel,
    process_panel,
    stdout_panel,
    step_memory_panel,
    step_time_panel,
    system_panel,
)
