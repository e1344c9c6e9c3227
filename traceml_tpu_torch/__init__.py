"""traceml-tpu-torch — the PyTorch/CUDA port of traceml-tpu.

Wraps a PyTorch loop on an NVIDIA GPU: ``trace_step`` splits each step
into phases (input wait, h2d, forward, backward, optimizer or one
compute phase, residual) timed against CUDA events, per-step memory
comes from the CUDA caching allocator, and the rows turn into a
step-time verdict (INPUT_BOUND, COMPUTE_BOUND, LOW_MFU, …).
``init(mode="auto")`` patches the DataLoader, ``nn.Module.__call__``,
``backward`` and ``Optimizer.step``; ``estimate_step_flops`` or
``set_step_flops`` gives the MFU numerator.
``python -m traceml_tpu_torch run --mode summary script.py`` runs a
script under tracing: the ranks ship their rows over TCP to an
aggregator, which stores them in SQLite and writes ``final_summary.json``.

The JAX package ``traceml_tpu`` is the reference; this package imports
neither it nor JAX.  The public API is a lazy facade, so importing the
package imports nothing heavy.
"""

__version__ = "0.1.0"

_API_SYMBOLS = (
    "init",
    "trace_step",
    "trace_time",
    "wrap_step_fn",
    "wrap_dataloader",
    "wrap_forward",
    "wrap_backward",
    "wrap_optimizer",
    "wrap_h2d",
    "set_step_flops",
    "estimate_step_flops",
    "live_metrics",
    "start_runtime",
    "stop_runtime",
)

__all__ = list(_API_SYMBOLS) + ["__version__"]


def __getattr__(name):
    if name in _API_SYMBOLS:
        from traceml_tpu_torch import api

        return getattr(api, name)
    raise AttributeError(f"module 'traceml_tpu_torch' has no attribute {name!r}")


def __dir__():
    return sorted(list(globals().keys()) + list(_API_SYMBOLS))
