"""traceml-tpu-torch — the PyTorch/CUDA port of traceml-tpu.

Wraps a PyTorch loop on an NVIDIA GPU: ``trace_step`` splits each step
into phases (input wait, h2d, forward, backward, optimizer or one
compute phase, residual) timed against CUDA events, per-step memory
comes from the CUDA caching allocator, and the rows turn into a
step-time verdict (INPUT_BOUND, COMPUTE_BOUND, LOW_MFU, …).
``init(mode="auto")`` patches ``Tensor.to``/``.cuda`` (host→device
copies), the DataLoader, ``nn.Module.__call__``, ``backward``,
``Optimizer.step``, and ``torch.save`` and DCP's ``save`` (the
``checkpoint`` phase; ``wrap_checkpoint`` for another saver), and turns
dynamo's compiles into ``compile_time`` events (COMPILE_BOUND);
``wrap_step_fn``'s first in-step call,
``estimate_step_flops`` or ``set_step_flops`` gives the MFU numerator,
``set_step_tokens`` the tokens/s one.
``python -m traceml_tpu_torch run script.py`` runs a script under
tracing: the ranks ship their rows to an aggregator (through a
shared-memory ring on one host, else a Unix socket or TCP), which
stores them in SQLite, draws the live display from them (``--mode cli``,
the default; ``--mode summary`` prints the verdict at the end instead),
tracks each rank's liveness and writes ``final_summary.json``;
``final_summary()`` asks for it from inside the script.
``make_mesh`` builds a ``DeviceMesh`` whose placement each rank ships
once (so findings can be attributed to a host, a mesh axis or one side
of a node boundary); ``instrument_collective`` times a gradient sync as
the ``collective`` phase and records it in the collectives domain
(COMM_BOUND, POOR_OVERLAP, ALLREDUCE_QUANTIZABLE), and
``patch_dist_collectives`` does the same for the eager
``torch.distributed`` collectives; ``enable_ici_stats`` all-gathers each
rank's step stats over the mesh every N steps for a cross-rank verdict
without the aggregator.  ``request_profile(session_dir)`` (or
``python -m traceml_tpu_torch profile``) has a running job record a
``torch.profiler`` trace of its next steps.

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
    "wrap_collective",
    "wrap_checkpoint",
    "instrument_collective",
    "patch_dist_collectives",
    "make_mesh",
    "enable_ici_stats",
    "set_step_flops",
    "set_step_tokens",
    "estimate_step_flops",
    "final_summary",
    "summary",
    "live_metrics",
    "request_profile",
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
