"""Collectives diagnosis: compute/comm overlap rules
(COMM_BOUND / POOR_OVERLAP / ALLREDUCE_QUANTIZABLE)."""

from traceml_tpu_torch.diagnostics.collectives.api import (  # noqa: F401
    diagnose_collectives_window,
)
