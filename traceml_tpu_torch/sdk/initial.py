"""``init``/``start`` — patch policy and the trace's device.

Counterpart of ``traceml_tpu/sdk/initial.py``.  Modes:

* ``auto``      — apply every patch: ``torch_dataloader``
  (``DataLoader.__iter__``), ``torch_forward`` (``nn.Module.__call__``),
  ``torch_backward`` (``Tensor.backward``, ``torch.autograd.backward``)
  and ``torch_optimizer`` (global ``Optimizer.step`` hooks);
  ``patch_*=False`` narrows the set, ``traced_model=`` limits forward
  timing to one model;
* ``manual``    — none; the user calls the wrappers,
* ``selective`` — explicit per-patch booleans (as ``auto``, read the same
  way).

``st.patches`` records what was installed.  The JAX package's other
patches (jax h2d, orbax, torch-xla ``mark_step``, the compile tracker)
have no counterpart here.  ``device`` sets the trace's device: CUDA by
default, raising without CUDA (before any patch is installed);
``device="cpu"`` runs on the CPU.

Idempotent; a re-``init`` with a *conflicting* mode raises.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from traceml_tpu_torch.sdk.state import get_state
from traceml_tpu_torch.utils.error_log import get_error_log

VALID_MODES = ("auto", "manual", "selective")


@dataclasses.dataclass(frozen=True)
class TraceMLInitConfig:
    mode: str = "auto"
    patch_dataloader: bool = True
    patch_forward: bool = True
    patch_backward: bool = True
    patch_optimizer: bool = True
    patch_h2d: bool = True
    patch_checkpoint: bool = True
    traced_model: object = None


class TraceMLInitError(RuntimeError):
    pass


def init(mode: str = "auto", device: Any = None, **kwargs) -> TraceMLInitConfig:
    """Apply the requested patch policy on the given device.  Safe to
    call more than once with the same mode; a conflicting re-init raises."""
    if mode not in VALID_MODES:
        raise TraceMLInitError(f"mode must be one of {VALID_MODES}, got {mode!r}")
    st = get_state()
    if st.initialized:
        if st.patch_mode != mode:
            raise TraceMLInitError(
                f"traceml already initialized with mode={st.patch_mode!r}; "
                f"re-init with mode={mode!r} conflicts"
            )
        return TraceMLInitConfig(mode=mode, **kwargs)
    cfg = TraceMLInitConfig(mode=mode, **kwargs)
    st.set_device(device)
    applied = []
    if mode != "manual":
        from traceml_tpu_torch.instrumentation.dataloader import patch_torch_dataloader
        from traceml_tpu_torch.instrumentation.patches.torch_patches import (
            install_torch_optimizer_hooks,
            patch_torch_backward,
            patch_torch_forward,
            set_traced_model,
        )

        for flag, name, install in (
            (cfg.patch_dataloader, "torch_dataloader", patch_torch_dataloader),
            (cfg.patch_forward, "torch_forward", patch_torch_forward),
            (cfg.patch_backward, "torch_backward", patch_torch_backward),
            (cfg.patch_optimizer, "torch_optimizer", install_torch_optimizer_hooks),
        ):
            if flag and install():
                applied.append(name)
        if cfg.traced_model is not None:
            set_traced_model(cfg.traced_model)
    st.patches = applied
    st.initialized = True
    st.patch_mode = mode
    get_error_log().info(f"traceml init mode={mode} device={st.device} patches={st.patches}")
    return cfg


# alias (the reference exposes both init and start)
start = init


def shutdown_patches() -> None:
    """Remove every auto-patch and forget the init (tests, clean embedding)."""
    from traceml_tpu_torch.instrumentation.dataloader import unpatch_torch_dataloader
    from traceml_tpu_torch.instrumentation.patches.torch_patches import unpatch_all_torch

    unpatch_torch_dataloader()
    unpatch_all_torch()
    st = get_state()
    st.initialized = False
    st.patch_mode = None
    st.patches = []
