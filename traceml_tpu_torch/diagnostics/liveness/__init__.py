from traceml_tpu_torch.diagnostics.liveness.api import (
    DOMAIN,
    diagnose_rank_status,
)

__all__ = ["DOMAIN", "diagnose_rank_status"]
