"""Per-rank in-memory row store."""

from traceml_tpu_torch.database.database import Database  # noqa: F401
