"""Mesh topology capture and axis-group attribution engine.

Counterpart of ``traceml_tpu/utils/topology.py``.  The diagnosis packs end
every finding in a rank list; at fleet scale the actionable unit is
physical structure: a host, one side of a node boundary, a model-axis
shard.  This module owns the three pieces the attribution layer shares:

* **capture**: :func:`record_mesh` (called by ``parallel/mesh.py``) keeps
  the last ``torch.distributed.device_mesh.DeviceMesh`` built in-process;
  :func:`capture_local_topology` turns it (or the ``TRACEML_MESH``
  override, for meshes built outside the helper) into THIS rank's
  topology payload: axis names and sizes, each axis's interconnect kind,
  and this rank's mesh coordinates (``DeviceMesh.get_coordinate()``).
  The kinds keep the JAX wire values: on GPUs an axis is ``dcn`` when
  moving along it changes the node (``rank // LOCAL_WORLD_SIZE``, the
  torchrun contract: the link leaves the NVLink domain for the network)
  and ``ici`` when it stays inside one node.
* **axis reduction**: :func:`reduce_cube` reshapes a (rank x step) cube
  into (group x step) aggregates (sum/count/mean/min/max) with the exact
  accumulation order of :func:`reduce_cube_reference`, the scalar
  left-fold in rank order (``np.add.at`` applies updates in first-axis
  element order), so the two are bit-equal.
* **attribution**: :func:`attribute_ranks` scores candidate groupings
  (host / per-axis coordinate / node-boundary side) by the share of
  cross-rank anomaly variance each explains (eta squared, between-group
  over total sum of squares) and names the outlier group when the best
  grouping clears the explanation threshold; otherwise it returns None
  and callers keep their flat rank lists.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from traceml_tpu_torch.runtime.settings import mesh_spec

#: minimum share of anomaly variance a grouping must explain before a
#: finding is attributed to it (below: flat rank list, no false blame)
EXPLAIN_THRESHOLD = 0.6

KIND_ICI = "ici"
KIND_DCN = "dcn"


@dataclasses.dataclass
class AxisInfo:
    name: str
    size: int
    kind: str = KIND_ICI  # "ici" | "dcn"

    def to_dict(self) -> Dict[str, Any]:
        return {"name": self.name, "size": int(self.size), "kind": self.kind}


@dataclasses.dataclass
class MeshTopology:
    """The merged, aggregator-side view: global axes + per-rank placement."""

    axes: List[AxisInfo]
    rank_coords: Dict[int, Tuple[int, ...]]
    rank_hosts: Dict[int, int] = dataclasses.field(default_factory=dict)
    rank_hostnames: Dict[int, str] = dataclasses.field(default_factory=dict)
    source: str = "mesh"

    @property
    def axis_names(self) -> List[str]:
        return [a.name for a in self.axes]

    def summary(self) -> Dict[str, Any]:
        """The compact ``mesh`` block of ``meta.topology``: axes, source,
        rank and host counts."""
        return {
            "axes": [a.to_dict() for a in self.axes],
            "source": self.source,
            "ranks": len(self.rank_coords),
            "hosts": len(set(self.rank_hosts.values())),
        }

    def to_payload(self) -> Dict[str, Any]:
        return {
            "axes": [a.to_dict() for a in self.axes],
            "source": self.source,
            "ranks": {
                str(r): {
                    "coords": list(c),
                    "host": self.rank_hosts.get(r),
                    "hostname": self.rank_hostnames.get(r),
                }
                for r, c in sorted(self.rank_coords.items())
            },
        }

    @classmethod
    def from_payload(cls, payload: Mapping[str, Any]) -> Optional["MeshTopology"]:
        axes = parse_axes(payload.get("axes"))
        if not axes:
            return None
        coords: Dict[int, Tuple[int, ...]] = {}
        hosts: Dict[int, int] = {}
        hostnames: Dict[int, str] = {}
        for rank_s, info in (payload.get("ranks") or {}).items():
            try:
                rank = int(rank_s)
            except (TypeError, ValueError):
                continue
            if not isinstance(info, Mapping):
                continue
            c = info.get("coords")
            if isinstance(c, (list, tuple)) and len(c) == len(axes):
                coords[rank] = tuple(int(v) for v in c)
            if info.get("host") is not None:
                try:
                    hosts[rank] = int(info["host"])
                except (TypeError, ValueError):
                    pass
            if info.get("hostname"):
                hostnames[rank] = str(info["hostname"])
        if not coords:
            return None
        return cls(
            axes=axes,
            rank_coords=coords,
            rank_hosts=hosts,
            rank_hostnames=hostnames,
            source=str(payload.get("source") or "mesh"),
        )


def parse_axes(raw: Any) -> List[AxisInfo]:
    """Validate an axes list (``[{"name","size","kind"}, ...]``)."""
    out: List[AxisInfo] = []
    if not isinstance(raw, (list, tuple)):
        return out
    for a in raw:
        if not isinstance(a, Mapping):
            return []
        try:
            name = str(a["name"])
            size = int(a["size"])
        except (KeyError, TypeError, ValueError):
            return []
        if size < 1:
            return []
        kind = str(a.get("kind") or KIND_ICI)
        out.append(
            AxisInfo(name=name, size=size, kind=kind if kind == KIND_DCN else KIND_ICI)
        )
    return out


# -- capture (rank side) -------------------------------------------------

_RECORDED: Dict[str, Any] = {"mesh": None}


def record_mesh(mesh: Any) -> None:
    """Remember the last mesh built in this process (fail-open hook
    called by ``parallel/mesh.make_mesh``; users building their own
    ``DeviceMesh`` can call this directly or set ``TRACEML_MESH``)."""
    _RECORDED["mesh"] = mesh


def recorded_mesh() -> Any:
    return _RECORDED["mesh"]


def reset_recorded_mesh_for_tests() -> None:
    _RECORDED["mesh"] = None


def parse_mesh_spec(spec: str) -> List[AxisInfo]:
    """``TRACEML_MESH`` grammar: ``name:size[@kind],...`` — e.g.
    ``data:4@dcn,fsdp:8``.  Returns [] on any malformed entry (the
    override must be all-or-nothing, a half-parsed mesh would
    mis-place every rank)."""
    axes: List[AxisInfo] = []
    for part in str(spec).split(","):
        part = part.strip()
        if not part:
            continue
        name, _, rest = part.partition(":")
        size_s, _, kind = rest.partition("@")
        try:
            size = int(size_s)
        except (TypeError, ValueError):
            return []
        if not name or size < 1:
            return []
        kind = (kind or KIND_ICI).strip().lower()
        if kind not in (KIND_ICI, KIND_DCN):
            return []
        axes.append(AxisInfo(name=name.strip(), size=size, kind=kind))
    return axes


def _coords_for_rank(rank: int, sizes: Sequence[int]) -> List[int]:
    """Row-major placement (matches the rank grid ``init_device_mesh``
    lays out, ``arange(world).view(sizes)``)."""
    total = 1
    for s in sizes:
        total *= int(s)
    return [int(v) for v in np.unravel_index(int(rank) % max(total, 1), tuple(sizes))]


def _local_world_size(world_size: int) -> int:
    """Ranks per node from the torchrun contract (``LOCAL_WORLD_SIZE``);
    without it every rank counts as one node's."""
    try:
        return max(1, int(os.environ["LOCAL_WORLD_SIZE"]))
    except (KeyError, ValueError):
        return max(1, int(world_size))


def _axis_kinds_from_grid(ranks: np.ndarray, local_world_size: int) -> List[str]:
    """ICI vs DCN per mesh axis, probed from the rank grid: moving along
    an axis that changes the node (``rank // local_world_size``) crosses
    the network between nodes; staying within one node is ICI (the
    node's NVLink domain)."""
    kinds: List[str] = []
    lws = max(1, int(local_world_size))
    for axis in range(ranks.ndim):
        index: List[Any] = [0] * ranks.ndim
        index[axis] = slice(None)
        line = ranks[tuple(index)].ravel()
        nodes = {int(r) // lws for r in line}
        kinds.append(KIND_DCN if len(nodes) > 1 else KIND_ICI)
    return kinds


def _topology_from_mesh(mesh: Any) -> Optional[Dict[str, Any]]:
    """THIS rank's payload from a ``DeviceMesh``: its rank grid and axis
    names, and this rank's coordinates from ``get_coordinate()`` (None
    when the rank is not in the mesh)."""
    ranks = np.asarray(mesh.mesh.cpu().numpy(), dtype=np.int64)
    names = [str(n) for n in (mesh.mesh_dim_names or [f"dim{i}" for i in range(ranks.ndim)])]
    kinds = _axis_kinds_from_grid(ranks, _local_world_size(ranks.size))
    coord = mesh.get_coordinate()
    if coord is None:
        return None
    axes = [AxisInfo(name=n, size=int(s), kind=k) for n, s, k in zip(names, ranks.shape, kinds)]
    return {
        "axes": [a.to_dict() for a in axes],
        "coords": [int(v) for v in coord],
        "source": "mesh",
    }


def capture_local_topology(
    global_rank: int, world_size: int
) -> Optional[Dict[str, Any]]:
    """THIS rank's mesh-topology payload, or None when no mesh is
    discoverable yet (callers retry on later ticks; never initializes
    CUDA or a process group).  Precedence: ``TRACEML_MESH`` env override
    (CI, meshes built outside the helper), then the recorded mesh."""
    spec = mesh_spec()
    if spec:
        axes = parse_mesh_spec(spec)
        if axes:
            return {
                "axes": [a.to_dict() for a in axes],
                "coords": _coords_for_rank(global_rank, [a.size for a in axes]),
                "source": "env",
            }
    mesh = _RECORDED["mesh"]
    if mesh is None:
        return None
    try:
        return _topology_from_mesh(mesh)
    except Exception:
        return None


# -- axis reduction ------------------------------------------------------


def reduce_cube(
    cube: np.ndarray,
    group_index: np.ndarray,
    n_groups: int,
    mask: Optional[np.ndarray] = None,
) -> Dict[str, np.ndarray]:
    """(rank × step) → (group × step) aggregates.

    ``cube`` is (R, S) float64; ``group_index`` maps row r to its group;
    ``mask`` (R, S) bool marks present entries (ragged windows / missing
    ranks) — absent entries contribute nothing.  Accumulation uses the
    unbuffered ``np.*.at`` ufuncs, which apply updates in first-axis
    element order, i.e. the same left-fold in ascending-rank order as
    :func:`reduce_cube_reference` — the two are bit-equal by contract.

    Returns ``sum``/``count``/``mean``/``min``/``max``, each (G, S);
    ``mean`` is NaN and min/max ±inf where a group has no entries.
    """
    cube = np.asarray(cube, dtype=np.float64)
    group_index = np.asarray(group_index, dtype=np.int64)
    r, s = cube.shape
    if mask is None:
        mask = np.ones((r, s), dtype=bool)
    else:
        mask = np.asarray(mask, dtype=bool)
    sums = np.zeros((n_groups, s), dtype=np.float64)
    counts = np.zeros((n_groups, s), dtype=np.int64)
    mins = np.full((n_groups, s), np.inf, dtype=np.float64)
    maxs = np.full((n_groups, s), -np.inf, dtype=np.float64)
    np.add.at(sums, group_index, np.where(mask, cube, 0.0))
    np.add.at(counts, group_index, mask.astype(np.int64))
    np.minimum.at(mins, group_index, np.where(mask, cube, np.inf))
    np.maximum.at(maxs, group_index, np.where(mask, cube, -np.inf))
    with np.errstate(invalid="ignore", divide="ignore"):
        means = sums / counts
    return {"sum": sums, "count": counts, "mean": means, "min": mins, "max": maxs}


def reduce_cube_reference(
    cube: np.ndarray,
    group_index: Sequence[int],
    n_groups: int,
    mask: Optional[np.ndarray] = None,
) -> Dict[str, np.ndarray]:
    """Scalar reference fold for :func:`reduce_cube`: plain Python
    loops, ranks in ascending row order — the accumulation-order
    authority the vectorized path must match bit-for-bit."""
    cube = np.asarray(cube, dtype=np.float64)
    r, s = cube.shape
    if mask is None:
        mask = np.ones((r, s), dtype=bool)
    sums = np.zeros((n_groups, s), dtype=np.float64)
    counts = np.zeros((n_groups, s), dtype=np.int64)
    mins = np.full((n_groups, s), np.inf, dtype=np.float64)
    maxs = np.full((n_groups, s), -np.inf, dtype=np.float64)
    for row in range(r):
        g = int(group_index[row])
        for col in range(s):
            if not mask[row, col]:
                continue
            v = float(cube[row, col])
            sums[g, col] = sums[g, col] + v
            counts[g, col] += 1
            if v < mins[g, col]:
                mins[g, col] = v
            if v > maxs[g, col]:
                maxs[g, col] = v
    with np.errstate(invalid="ignore", divide="ignore"):
        means = sums / counts
    return {"sum": sums, "count": counts, "mean": means, "min": mins, "max": maxs}


# -- attribution ---------------------------------------------------------


@dataclasses.dataclass
class Grouping:
    kind: str  # "host" | "axis" | "dcn_side"
    label: str  # e.g. "host", "axis data"
    axis: Optional[str]  # axis name for axis/dcn_side groupings
    groups: Dict[Any, List[int]]  # group key → member ranks


@dataclasses.dataclass
class Attribution:
    kind: str  # "host" | "axis" | "dcn_side"
    label: str  # human phrase naming the structure
    group: str  # the outlier group's key, stringified
    axis: Optional[str]
    ranks: List[int]
    explained: float  # η² of the winning grouping, 0..1

    def to_dict(self) -> Dict[str, Any]:
        return {
            "kind": self.kind,
            "label": self.label,
            "group": self.group,
            "axis": self.axis,
            "ranks": list(self.ranks),
            "explained": round(float(self.explained), 4),
        }


# grouping-memo counters, surfaced through the tick profiler: the memo
# lives on the MeshTopology instance and the snapshot store caches ONE
# instance per topology version, so a hit means "same (topology
# version, rank set) as an earlier diagnose call", a warm tick that
# skipped the per-call host and axis scans
_GROUPING_CACHE_STATS: Dict[str, int] = {"hits": 0, "misses": 0}


def grouping_cache_counts() -> Dict[str, int]:
    return dict(_GROUPING_CACHE_STATS)


def candidate_groupings(
    topo: MeshTopology, ranks: Sequence[int]
) -> List[Grouping]:
    """Host grouping (from identity node_rank) + one grouping per mesh
    axis of size > 1 (DCN axes become boundary-side groupings).  Only
    ranks present in ``ranks`` participate.

    Memoized per (topology instance, rank tuple) when the vectorized
    diagnosis arm is on — groupings depend on nothing else, and every
    window domain asks with the same rank set tick after tick.  The
    callers only read the returned Grouping objects."""
    from traceml_tpu_torch.utils.columnar import vector_diagnosis_enabled

    key: Optional[Tuple[int, ...]] = None
    cache: Optional[Dict[Tuple[int, ...], List[Grouping]]] = None
    if vector_diagnosis_enabled():
        key = tuple(int(r) for r in ranks)
        cache = topo.__dict__.get("_groupings_cache")
        if cache is not None and key in cache:
            _GROUPING_CACHE_STATS["hits"] += 1
            return cache[key]
    out: List[Grouping] = []
    hosts: Dict[Any, List[int]] = {}
    for r in ranks:
        h = topo.rank_hosts.get(int(r))
        if h is not None:
            hosts.setdefault(int(h), []).append(int(r))
    if len(hosts) > 1:
        out.append(Grouping(kind="host", label="host", axis=None, groups=hosts))
    for i, axis in enumerate(topo.axes):
        if axis.size <= 1:
            continue
        groups: Dict[Any, List[int]] = {}
        for r in ranks:
            c = topo.rank_coords.get(int(r))
            if c is None or i >= len(c):
                continue
            groups.setdefault(int(c[i]), []).append(int(r))
        if len(groups) > 1:
            out.append(
                Grouping(
                    kind="dcn_side" if axis.kind == KIND_DCN else "axis",
                    label=f"axis {axis.name}",
                    axis=axis.name,
                    groups=groups,
                )
            )
    if key is not None:
        if cache is None:
            cache = topo.__dict__["_groupings_cache"] = {}
        elif len(cache) >= 8:  # rank-set churn: keep the memo bounded
            cache.clear()
        cache[key] = out
        _GROUPING_CACHE_STATS["misses"] += 1
    return out


def _eta_squared(
    values: Mapping[int, float], groups: Mapping[Any, List[int]]
) -> Optional[Tuple[float, Any]]:
    """(η², outlier group key): share of total variance explained by
    the grouping, and the group whose mean sits farthest from the
    grand mean.  None when degenerate (no spread, singleton-only
    groups, fewer members than groups).

    Deviation ties (exact with two equal-size groups — both sit the
    same distance from the grand mean) break toward the HIGHER group
    mean: every pack's anomaly value is higher-is-worse (step ms,
    exposed comm ms, bytes used, lost/stale flag), so the slow side is
    the outlier, never the fast one."""
    members = [r for g in groups.values() for r in g]
    if len(members) <= len(groups):
        return None  # singleton groups explain anything — meaningless
    vals = np.array([float(values[r]) for r in members], dtype=np.float64)
    grand = float(vals.mean())
    ss_total = float(((vals - grand) ** 2).sum())
    if ss_total <= 0.0:
        return None
    ss_between = 0.0
    worst_key, worst_dev, worst_mean = None, -1.0, -np.inf
    for key in sorted(groups, key=str):
        gvals = np.array(
            [float(values[r]) for r in groups[key]], dtype=np.float64
        )
        gmean = float(gvals.mean())
        dev = abs(gmean - grand)
        ss_between += len(gvals) * (gmean - grand) ** 2
        if dev > worst_dev or (dev == worst_dev and gmean > worst_mean):
            worst_dev, worst_key, worst_mean = dev, key, gmean
    return ss_between / ss_total, worst_key


def _phrase(kind: str, axis: Optional[str], key: Any, ranks: List[int],
            topo: MeshTopology) -> str:
    n = len(ranks)
    if kind == "host":
        name = topo.rank_hostnames.get(ranks[0]) if ranks else None
        host = f"host {key}" + (f" ({name})" if name else "")
        return f"all {n} ranks of {host}" if n > 1 else f"rank {ranks[0]} on {host}"
    if kind == "dcn_side":
        return (
            f"one side of the DCN boundary on axis '{axis}' "
            f"({axis}={key}, {n} rank{'s' if n != 1 else ''})"
        )
    return (
        f"'{axis}'-axis shard imbalance "
        f"({axis}={key}, {n} rank{'s' if n != 1 else ''})"
    )


def attribute_ranks(
    per_rank_values: Mapping[int, float],
    topo: Optional[MeshTopology],
    threshold: float = EXPLAIN_THRESHOLD,
) -> Optional[Attribution]:
    """Score every candidate grouping on the per-rank anomaly values
    and return the best one clearing ``threshold``, or None (callers
    then keep the flat rank list).  Deterministic: ties break toward
    the earlier grouping in ``candidate_groupings`` order (host first,
    then axes in mesh order)."""
    if topo is None or not per_rank_values or len(per_rank_values) < 3:
        return None
    ranks = sorted(
        int(r) for r in per_rank_values
        if int(r) in topo.rank_coords or int(r) in topo.rank_hosts
    )
    if len(ranks) < 3:
        return None
    values = {r: float(per_rank_values[r]) for r in ranks}
    best: Optional[Attribution] = None
    for grouping in candidate_groupings(topo, ranks):
        scored = _eta_squared(values, grouping.groups)
        if scored is None:
            continue
        eta, key = scored
        if eta < threshold:
            continue
        if best is not None and eta <= best.explained:
            continue
        members = sorted(grouping.groups[key])
        best = Attribution(
            kind=grouping.kind,
            label=_phrase(grouping.kind, grouping.axis, key, members, topo),
            group=str(key),
            axis=grouping.axis,
            ranks=members,
            explained=eta,
        )
    return best


# -- convenience for DB round-trips --------------------------------------


def topology_from_rank_rows(
    rows: Sequence[Mapping[str, Any]],
) -> Optional[MeshTopology]:
    """Merge per-rank ``mesh_topology`` DB rows (keep-latest per rank —
    rows must be in insertion order) into one :class:`MeshTopology`."""
    axes: List[AxisInfo] = []
    ranks: Dict[str, Dict[str, Any]] = {}
    source = "mesh"
    for r in rows:
        try:
            parsed = parse_axes(json.loads(r["axes_json"] or "[]"))
            coords = json.loads(r["coords_json"] or "null")
        except (KeyError, TypeError, ValueError):
            continue
        if not parsed or not isinstance(coords, list):
            continue
        axes = parsed  # later rows win (restart with a new mesh)
        source = str(r["source"] or source) if "source" in r.keys() else source
        rank = int(r["global_rank"])
        ranks[str(rank)] = {
            "coords": coords,
            "host": r["node_rank"] if "node_rank" in r.keys() else None,
            "hostname": r["hostname"] if "hostname" in r.keys() else None,
        }
    if not axes or not ranks:
        return None
    return MeshTopology.from_payload(
        {"axes": [a.to_dict() for a in axes], "ranks": ranks, "source": source}
    )
