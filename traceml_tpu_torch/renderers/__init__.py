"""Live display: typed views, their per-tick computation and the Rich
CLI panels (counterpart of ``traceml_tpu/renderers/``)."""
