"""Device-mesh construction helpers.

Counterpart of ``traceml_tpu/parallel/mesh.py``.  The demos and the
flagship model need one way to build a mesh over the ranks that exist and
to split batches over it.  Here the mesh is a
``torch.distributed.device_mesh.DeviceMesh`` built by ``init_device_mesh``
over the default process group, with ``mesh_dim_names`` the JAX axis
names:

* ``data``    — pure data parallelism (batch dim)
* ``fsdp``    — parameter/optimizer sharding (ZeRO-ish), also batch
* ``tensor``  — tensor parallelism (heads / ffn dims)
* ``context`` — sequence/context parallelism (ring attention)

Non-canonical axes (``expert`` for MoE expert parallelism, ``stage`` for
pipeline parallelism) are accepted too: pass them in ``shape`` and the
mesh uses exactly the axes given, in order.  The shape rules (missing axes
get 1, one axis may be ``-1``, everything on ``fsdp`` when no shape is
given and the canonical one does not fit) and their ``ValueError`` texts
are the JAX ones.  ``batch_sharding`` and ``replicated`` are not here:
their PyTorch counterparts are DTensor placements, which come with the
sharded workloads.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

AXES = ("data", "fsdp", "tensor", "context")
EXTRA_AXES = ("expert", "stage")  # MoE ep / pipeline pp (see docstring)
#: the axes that carry the batch dim
BATCH_AXES = ("data", "fsdp")


def resolve_mesh_shape(shape: Optional[Dict[str, int]], n: int) -> Tuple[Tuple[str, ...], List[int]]:
    """``(axis names, sizes)`` of the mesh ``make_mesh`` builds over ``n``
    ranks; raises ``ValueError`` for an unknown axis or a shape that does
    not fit."""
    shape = dict(shape or {})
    # extra axes (expert/stage): the mesh is exactly the axes given.
    # Anything else is rejected so a typo'd canonical axis ('fdsp')
    # fails HERE, not as a confusing missing-axis error downstream.
    unknown = [ax for ax in shape if ax not in AXES + EXTRA_AXES]
    if unknown:
        raise ValueError(
            f"unknown mesh axes {unknown}; known: {AXES + EXTRA_AXES} "
            "(build a torch DeviceMesh directly for fully custom layouts)"
        )
    if shape and any(ax in EXTRA_AXES for ax in shape):
        axes = tuple(shape.keys())
    else:
        axes = AXES
    sizes = []
    wild = None
    for ax in axes:
        v = int(shape.get(ax, 1))
        if v == -1:
            wild = ax
            sizes.append(-1)
        else:
            sizes.append(v)
    fixed = int(np.prod([s for s in sizes if s != -1]))
    if wild is not None:
        if n % fixed:
            raise ValueError(f"{n} devices not divisible by fixed axes {fixed}")
        sizes[sizes.index(-1)] = n // fixed
    total = int(np.prod(sizes))
    if total != n:
        # default: put everything on the fsdp axis
        if shape:
            raise ValueError(
                f"mesh shape {dict(zip(axes, sizes))} needs {total} devices, "
                f"have {n}"
            )
        sizes = [n if ax == "fsdp" else 1 for ax in axes]
    return axes, sizes


def make_mesh(shape: Optional[Dict[str, int]] = None, device_type: Optional[str] = None):
    """Build a ``DeviceMesh`` over the default process group's ranks;
    ``shape`` maps axis name → size (missing axes get 1; one axis may be
    -1 to absorb the remaining ranks).  ``device_type`` is ``"cuda"``
    unless the caller asks for ``"cpu"``; without CUDA it raises.  The
    process group must be initialized (``torch.distributed
    .init_process_group``)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from traceml_tpu_torch.utils.device import resolve_device

    dev_type = resolve_device(device_type).type
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs an initialized process group "
            "(torch.distributed.init_process_group)"
        )
    axes, sizes = resolve_mesh_shape(shape, dist.get_world_size())
    mesh = init_device_mesh(dev_type, tuple(sizes), mesh_dim_names=tuple(axes))
    try:
        # remember the mesh for the topology attribution layer (the
        # runtime ships it once as a mesh_topology control message) —
        # fail-open, mesh construction must never depend on observability
        from traceml_tpu_torch.utils.topology import record_mesh

        record_mesh(mesh)
    except Exception:
        pass
    return mesh


def local_batch_size(global_batch: int, mesh) -> Tuple[int, int]:
    """``(per-replica batch, data-parallel degree)`` over ``BATCH_AXES``."""
    names = list(mesh.mesh_dim_names or ())
    dp = int(np.prod([mesh.mesh.shape[names.index(ax)] for ax in BATCH_AXES if ax in names]))
    if global_batch % dp:
        raise ValueError(f"global batch {global_batch} not divisible by dp={dp}")
    return global_batch // dp, dp
