"""Per-rank in-memory row store and its optional disk backup."""

from traceml_tpu_torch.database.database import Database  # noqa: F401
from traceml_tpu_torch.database.database_writer import DatabaseWriter  # noqa: F401
