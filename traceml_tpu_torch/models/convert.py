"""Flax ``DecoderLM`` params → a ``state_dict`` for the PyTorch ``DecoderLM``.

Flax ``Dense`` kernels are (in, out) and torch ``Linear`` weights are
(out, in), so every kernel is transposed.  The input is the flax params
tree with numpy leaves (``jax.tree_util.tree_map(np.asarray, params)``);
nothing here imports JAX.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

_ATTN = ("wq", "wk", "wv", "wo")
_MLP = ("w_gate", "w_up", "w_down")


def _tensor(x: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def params_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Map every flax leaf to its torch name; raise on a leaf left over or
    missing, so a mismatched tree never loads half its weights."""
    consumed = set()

    def take(*path: str) -> Any:
        node: Any = params
        for key in path:
            node = node[key]
        consumed.add(path)
        return node

    sd: Dict[str, torch.Tensor] = {"embed.weight": _tensor(take("embed", "embedding"))}
    n_layers = sum(1 for name in params if name.startswith("layer_"))
    for i in range(n_layers):
        layer = f"layer_{i}"
        prefix = f"layers.{i}"
        for norm in ("attn_norm", "mlp_norm"):
            sd[f"{prefix}.{norm}.scale"] = _tensor(take(layer, norm, "scale"))
        for name in _ATTN:
            sd[f"{prefix}.attn.{name}.weight"] = _tensor(take(layer, "attn", name, "kernel")).T.contiguous()
        for name in _MLP:
            sd[f"{prefix}.mlp.{name}.weight"] = _tensor(take(layer, "mlp", name, "kernel")).T.contiguous()
    sd["final_norm.scale"] = _tensor(take("final_norm", "scale"))
    sd["lm_head.weight"] = _tensor(take("lm_head", "kernel")).T.contiguous()

    def leaves(node: Any, path: tuple) -> list:
        if isinstance(node, Mapping):
            out = []
            for key, child in node.items():
                out.extend(leaves(child, path + (key,)))
            return out
        return [path]

    left = [p for p in leaves(params, ()) if p not in consumed]
    if left:
        raise ValueError(f"flax params not mapped: {['/'.join(p) for p in left]}")
    return sd
