"""Flax params → ``state_dict``s for the port's modules, and each rank's
slice of a whole ``state_dict``.

* :func:`params_from_jax`: the flax ``DecoderLM``.  Flax ``Dense``
  kernels are (in, out) and torch ``Linear`` weights are (out, in), so
  every kernel is transposed.
* :func:`moe_params_from_jax`: the flax ``MoEBlock``
  (``models/moe.py``); its einsum weights keep their layout.
* :func:`stage_params_from_jax`: the stacked params of the pipeline's
  linear stages (``parallel/pipeline.py``).
* :func:`vit_params_from_jax`: the flax ``ViT`` (``models/vit.py``); its
  HWIO patch kernel becomes the (hidden, p·p·C) weight of ``PatchEmbed``.
* :func:`mlp_params_from_jax`: the flax ``TinyMLP`` (``models/mlp.py``).
* :func:`local_state_dict`: this rank's piece of a whole ``state_dict``
  under DTensor placements, cut on the mesh axes named (``tensor`` for
  the tensor-parallel DecoderLM, ``expert`` for the MoE block's experts).

The input of a converter is the flax params tree with numpy leaves
(``jax.tree_util.tree_map(np.asarray, params)``); nothing here imports
JAX.  Each raises on a leaf left over or missing, so a mismatched tree
never loads half its weights.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Mapping, Sequence, Tuple

import numpy as np
import torch

_ATTN = ("wq", "wk", "wv", "wo")
_MLP = ("w_gate", "w_up", "w_down")


def _tensor(x: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def _leaves(node: Any, path: Tuple[str, ...] = ()) -> list:
    if isinstance(node, Mapping):
        out = []
        for key, child in node.items():
            out.extend(_leaves(child, path + (key,)))
        return out
    return [path]


class _Reader:
    """Reads leaves of a params tree by path and, at the end, raises on
    the leaves no read consumed."""

    def __init__(self, params: Mapping[str, Any]) -> None:
        self.params = params
        self.consumed = set()

    def take(self, *path: str) -> Any:
        node: Any = self.params
        for key in path:
            node = node[key]
        self.consumed.add(path)
        return node

    def check(self) -> None:
        left = [p for p in _leaves(self.params) if p not in self.consumed]
        if left:
            raise ValueError(f"flax params not mapped: {['/'.join(p) for p in left]}")


def params_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Map every flax ``DecoderLM`` leaf to its torch name."""
    tree = _Reader(params)
    take = tree.take
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
    tree.check()
    return sd


def moe_params_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Map every flax ``MoEBlock`` leaf (``norm_scale`` and ``MoEFFN_0``'s
    ``router`` (H, E), ``w_in`` (E, H, F), ``w_out`` (E, F, H)) to the
    port's names: ``norm_scale`` and ``ffn.{router,w_in,w_out}``."""
    tree = _Reader(params)
    sd = {"norm_scale": _tensor(tree.take("norm_scale"))}
    for name in ("router", "w_in", "w_out"):
        sd[f"ffn.{name}"] = _tensor(tree.take("MoEFFN_0", name))
    tree.check()
    return sd


def stage_params_from_jax(stacked: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Stacked ``linear_stage_apply`` params (``w`` (S, W, W) and ``b``
    (S, W), a leading stage dim on each) → one tensor per leaf."""
    tree = _Reader(stacked)
    sd = {name: _tensor(tree.take(name)) for name in ("w", "b")}
    tree.check()
    return sd


def _dense(tree: _Reader, sd: Dict[str, torch.Tensor], name: str, *path: str) -> None:
    """A flax ``Dense`` at ``path``: its (in, out) kernel as the (out, in)
    ``name.weight``, and its bias, when it has one, as ``name.bias``."""
    node = tree.params
    for key in path:
        node = node[key]
    sd[f"{name}.weight"] = _tensor(tree.take(*path, "kernel")).T.contiguous()
    if "bias" in node:
        sd[f"{name}.bias"] = _tensor(tree.take(*path, "bias"))


def vit_params_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Map every flax ``ViT`` leaf to its torch name.  The patch
    embedding's ``Conv`` kernel (p, p, C, hidden) is read row-major as
    (p·p·C, hidden), the order in which ``PatchEmbed`` flattens a patch,
    then transposed."""
    tree = _Reader(params)
    take = tree.take
    kernel = _tensor(take("patch_embed", "kernel"))
    sd: Dict[str, torch.Tensor] = {
        "patch_embed.weight": kernel.reshape(-1, kernel.shape[-1]).T.contiguous(),
        "patch_embed.bias": _tensor(take("patch_embed", "bias")),
        "pos_embed": _tensor(take("pos_embed")),
    }
    n_layers = sum(1 for name in params if name.startswith("layer_"))
    for i in range(n_layers):
        layer, prefix = f"layer_{i}", f"layers.{i}"
        for norm in ("attn_norm", "mlp_norm"):
            sd[f"{prefix}.{norm}.scale"] = _tensor(take(layer, norm, "scale"))
        for name in _ATTN + ("w_up", "w_down"):
            _dense(tree, sd, f"{prefix}.{name}", layer, name)
    sd["final_norm.scale"] = _tensor(take("final_norm", "scale"))
    _dense(tree, sd, "head", "head")
    tree.check()
    return sd


def mlp_params_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Map every flax ``TinyMLP`` leaf (``Dense_0`` … ``Dense_depth``) to
    the port's names: ``layers.{i}`` for the hidden layers, ``head`` for
    the last."""
    tree = _Reader(params)
    depth = sum(1 for name in params if name.startswith("Dense_")) - 1
    sd: Dict[str, torch.Tensor] = {}
    for i in range(depth):
        _dense(tree, sd, f"layers.{i}", f"Dense_{i}")
    _dense(tree, sd, "head", f"Dense_{depth}")
    tree.check()
    return sd


def local_state_dict(state_dict: Mapping[str, torch.Tensor], specs: Mapping[str, Sequence[Any]], mesh,
                     axes: Iterable[str]) -> Dict[str, torch.Tensor]:
    """This rank's piece of the whole ``state_dict``: each tensor cut by
    its placements ``specs[name]`` (one per mesh dim) on the mesh dims
    named in ``axes``, and left whole on the others (FSDP2 shards those
    after the load).  No communication: every rank holds the whole
    ``state_dict``."""
    from torch.distributed.tensor import Replicate

    from traceml_tpu_torch.parallel.mesh import local_shard

    axes = set(axes)
    names = list(mesh.mesh_dim_names or ())
    out = {}
    for name, t in state_dict.items():
        placements = tuple(pl if names[i] in axes else Replicate() for i, pl in enumerate(specs[name]))
        out[name] = local_shard(t, mesh, placements)
    return out
