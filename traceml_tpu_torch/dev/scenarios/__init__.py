"""Stress scenarios on the ViT and on Hugging Face BERT
(counterpart of ``traceml_tpu/dev/scenarios/``)."""
