"""Per-domain Rich renderers for the live CLI.

Counterpart of ``traceml_tpu/renderers/cli/``: each domain module renders
the typed view from ``renderers/views.py``; no metric math happens at
render time.
"""

from traceml_tpu_torch.renderers.cli.dashboard import dashboard  # noqa: F401
from traceml_tpu_torch.renderers.cli.diagnostics import diagnostics_panel  # noqa: F401
from traceml_tpu_torch.renderers.cli.memory import step_memory_panel  # noqa: F401
from traceml_tpu_torch.renderers.cli.output import stdout_panel  # noqa: F401
from traceml_tpu_torch.renderers.cli.process import process_panel  # noqa: F401
from traceml_tpu_torch.renderers.cli.step_time import step_time_panel  # noqa: F401
from traceml_tpu_torch.renderers.cli.system import cluster_panel, system_panel  # noqa: F401
