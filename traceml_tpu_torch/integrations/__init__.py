"""Framework integrations (counterpart of ``traceml_tpu/integrations/``):
the Hugging Face ``Trainer`` callback.  Each imports its framework
lazily."""
