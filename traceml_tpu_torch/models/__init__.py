"""Reference workloads: the flagship DecoderLM, the ViT encoder and the
tiny MLP of the fault scenarios (counterpart of
``traceml_tpu/models/__init__.py``).  Importing this package imports the
modules below and torch, nothing else of the port."""

from traceml_tpu_torch.models.mlp import TinyMLP  # noqa: F401
from traceml_tpu_torch.models.transformer import (  # noqa: F401
    DecoderLM,
    ModelConfig,
    init_train_state,
    make_train_step,
    param_shardings,
)
from traceml_tpu_torch.models.vit import ViT, ViTConfig  # noqa: F401
