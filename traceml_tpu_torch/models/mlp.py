"""Tiny MLP, the model of the fault-scenario library (``dev/demo/``).

Counterpart of ``traceml_tpu/models/mlp.py``: ``depth`` × (Linear →
tanh), then a Linear, all f32 with biases.  Flax infers the input width
from the first call; a torch module needs it up front (``in_features``,
64 as the scenarios feed it).

``make_mlp_train_step(model, lr)`` returns ``(init, train_step)`` as the
JAX function does, here closures over the module and its optimizer:
``init(seed)`` draws the weights from a ``torch.Generator`` seeded with
``seed`` (or loads a ``state_dict``) and resets Adam; ``train_step(x,
y)`` takes one Adam step on the MSE loss and returns the loss.  Torch's
``Adam(lr, eps=1e-8)`` computes optax's ``adam(lr)`` update, ``p ← p −
lr·m̂/(√v̂+ε)``.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping, Optional, Tuple

import torch
from torch import nn

from traceml_tpu_torch.utils.device import resolve_device


class TinyMLP(nn.Module):
    """``TinyMLP(hidden, depth, out, in_features, device=...)``; the
    device defaults to CUDA (``device="cpu"`` to run on the CPU)."""

    def __init__(self, hidden: int = 128, depth: int = 2, out: int = 1, in_features: int = 64, *,
                 device: Any = "cuda") -> None:
        super().__init__()
        dev = resolve_device(device)
        widths = [in_features] + [hidden] * depth
        self.layers = nn.ModuleList(nn.Linear(a, b, device=dev) for a, b in zip(widths, widths[1:]))
        self.head = nn.Linear(widths[-1], out, device=dev)
        self.reset_parameters(0)

    def reset_parameters(self, seed: int) -> None:
        """Weights ~ N(0, 1/fan_in), biases 0 (flax ``Dense``'s init up
        to its truncation), drawn on the CPU from ``seed`` so a seed gives
        the same weights on every device."""
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for lin in (*self.layers, self.head):
                w = torch.randn(lin.weight.shape, generator=gen) * lin.in_features ** -0.5
                lin.weight.copy_(w)
                lin.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for lin in self.layers:
            x = torch.tanh(lin(x))
        return self.head(x)


def make_mlp_train_step(model: TinyMLP, learning_rate: float = 1e-3) -> Tuple[Callable, Callable]:
    """``(init, train_step)``: ``init(seed=0, state_dict=None)`` sets the
    weights and returns a fresh Adam; ``train_step(x, y)`` is one Adam
    step on ``mean((model(x) − y)²)`` and returns the loss, detached and
    unsynchronized."""
    optimizer = torch.optim.Adam(model.parameters(), lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)

    def init(seed: int = 0, state_dict: Optional[Mapping[str, torch.Tensor]] = None) -> torch.optim.Adam:
        if state_dict is not None:
            model.load_state_dict(state_dict)
        else:
            model.reset_parameters(seed)
        optimizer.state.clear()
        return optimizer

    def train_step(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        loss = ((model(x) - y) ** 2).mean()
        loss.backward()
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)
        return loss.detach()

    return init, train_step
