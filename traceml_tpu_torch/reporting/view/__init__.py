"""``python -m traceml_tpu_torch view``."""
