"""Stat-vector all-gather over the mesh: the collective rank source.

Counterpart of ``traceml_tpu/parallel/ici_stats.py`` (the module keeps
its name so that a reader finds it).  Each rank contributes one
fixed-layout :class:`StatVector` (step duration, phase sums, memory) per
aggregation; one ``dist.all_gather_into_tensor`` over the mesh's ranks
(NCCL on CUDA, gloo on the CPU) hands every rank the full
``(n_participants, N_FIELDS)`` f32 matrix.  Row ``i`` is the mesh's
participant ``i`` in mesh-linear (first-axis-major) order, the order the
JAX chain of gathers leaves its rows in.

The gathered matrix lives on the device of the mesh; bringing it to the
host is a sync point, as the JAX ``device_get`` is.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

# fixed field layout (order matters: it IS the wire format of the gather)
STAT_FIELDS = (
    "step",
    "step_ms",
    "input_ms",
    "h2d_ms",
    "compute_ms",
    "optimizer_ms",
    "compile_ms",
    "collective_ms",
    "checkpoint_ms",
    "residual_ms",
    "memory_current_bytes",
    "memory_peak_bytes",
)
N_FIELDS = len(STAT_FIELDS)


@dataclasses.dataclass
class StatVector:
    values: Dict[str, float]

    def to_array(self) -> np.ndarray:
        return np.asarray(
            [float(self.values.get(f, 0.0)) for f in STAT_FIELDS],
            dtype=np.float32,
        )

    @classmethod
    def from_array(cls, arr: Sequence[float]) -> "StatVector":
        return cls({f: float(v) for f, v in zip(STAT_FIELDS, arr)})


class IciStatAggregator:
    """All-gather per-rank stat vectors over a ``DeviceMesh`` (all of its
    dims by default, or one named ``axis``)."""

    def __init__(self, mesh=None, axis: Optional[str] = None) -> None:
        if mesh is None:
            import torch.distributed as dist

            from traceml_tpu_torch.parallel.mesh import make_mesh

            mesh = make_mesh({"fsdp": dist.get_world_size()})
        self.mesh = mesh
        names = tuple(mesh.mesh_dim_names or ())
        # default: gather over ALL mesh axes (every rank contributes)
        self.axes = (axis,) if axis else names
        self._group = self._build()

    def _build(self):
        """The process group whose rank order is the participants' order."""
        from traceml_tpu_torch.parallel.mesh import mesh_group

        if len(self.axes) == 1 and self.mesh.ndim > 1:
            return self.mesh.get_group(self.axes[0])
        return mesh_group(self.mesh)

    @property
    def n_participants(self) -> int:
        names = tuple(self.mesh.mesh_dim_names or ())
        n = 1
        for ax in self.axes:
            n *= self.mesh.size(names.index(ax))
        return n

    def _gather(self, row: np.ndarray) -> np.ndarray:
        import torch
        import torch.distributed as dist

        device = "cuda" if self.mesh.device_type == "cuda" else "cpu"
        local = torch.as_tensor(row, dtype=torch.float32).reshape(1, N_FIELDS).to(device)
        out = torch.empty((self.n_participants, N_FIELDS), dtype=torch.float32, device=device)
        dist.all_gather_into_tensor(out, local, group=self._group)
        return out.cpu().numpy()

    def aggregate(self, stats: StatVector) -> np.ndarray:
        """Contribute this rank's vector; returns the gathered
        ``(n_participants, N_FIELDS)`` matrix (host numpy)."""
        return self._gather(stats.to_array())

    def aggregate_many(self, stats: Sequence[StatVector]) -> np.ndarray:
        """Every rank passes the same list of DISTINCT per-participant
        vectors (len must equal n_participants) and contributes its own
        entry; the gathered matrix is the list, in participant order, as
        the JAX single-controller variant returns it."""
        import torch.distributed as dist

        n = self.n_participants
        if len(stats) != n:
            raise ValueError(f"need {n} vectors, got {len(stats)}")
        me = dist.get_rank(self._group)
        return self._gather(stats[me].to_array())

    def rank_skew(self, gathered: np.ndarray, field: str) -> Dict[str, float]:
        """Cross-rank skew for one field: (worst − median) / median."""
        idx = STAT_FIELDS.index(field)
        col = np.asarray(gathered)[:, idx]
        med = float(np.median(col))
        worst = int(np.argmax(col))
        skew = (float(col[worst]) - med) / med if med > 0 else 0.0
        return {
            "median": med,
            "worst": float(col[worst]),
            "worst_rank": worst,
            "skew_pct": skew,
        }


def gathered_to_stat_vectors(gathered: np.ndarray) -> List[StatVector]:
    return [StatVector.from_array(row) for row in np.asarray(gathered)]
