"""The mesh, the topology capture and the attribution engine: the port
against the JAX package on the same inputs.

* ``make_mesh``: for every shape spec and rank count, the port's axes,
  sizes and ``ValueError`` texts equal the JAX ``make_mesh``'s over as
  many virtual CPU devices (the texts with the PyTorch mesh named where
  JAX names ``jax.sharding.Mesh``); a one-rank gloo group builds a real
  ``DeviceMesh`` whose captured payload equals the JAX capture of a
  one-device mesh.  The axis kinds of a multi-node rank grid
  (``rank // LOCAL_WORLD_SIZE``) equal the JAX kinds of a device grid
  whose ``slice_index`` is that node.
* ``parse_mesh_spec``, ``capture_local_topology`` under ``TRACEML_MESH``,
  ``reduce_cube`` (bit for bit against both reference folds and the JAX
  ``reduce_cube``), ``candidate_groupings``, ``attribute_ranks`` on the
  JAX test's fixtures (host outlier, DCN side, model-axis imbalance, flat
  fallback on noise, ties), ``attach_attribution`` and
  ``reduce_window_by_grouping``: equal, exactly.
* The diagnoses: each ``diagnose_*`` that takes a topology (step time,
  step memory over rows and over rings, liveness), with and without one:
  equal to JAX once the JAX texts go through the advice table; without a
  topology byte-identical to its output before the topology argument
  existed, with one only ``attribution`` added.
* The store and the loader merge the ``mesh_topology`` rows as JAX does.
"""

import json
import random
import time

import jax
import numpy as np
import pytest

from tests.test_torch_advice import port_advice
from traceml_tpu.diagnostics import attribution as jax_attr
from traceml_tpu.diagnostics.liveness.api import diagnose_rank_status as jax_liveness
from traceml_tpu.diagnostics.step_memory.api import diagnose_columns as jax_memory_columns
from traceml_tpu.diagnostics.step_memory.api import diagnose_rank_rows as jax_memory
from traceml_tpu.diagnostics.step_time.api import diagnose_rank_rows as jax_step_time
from traceml_tpu.parallel import mesh as jax_mesh
from traceml_tpu.reporting.loaders import load_mesh_topology as jax_load_mesh
from traceml_tpu.reporting.snapshot_store import LiveSnapshotStore as JaxStore
from traceml_tpu.utils import columnar as jax_columnar
from traceml_tpu.utils import topology as jax_topo
from traceml_tpu_torch.aggregator.sqlite_writer import SQLiteWriter
from traceml_tpu_torch.diagnostics.attribution import attach_attribution
from traceml_tpu_torch.diagnostics.common import SEVERITY_WARNING, STATUS_ISSUE, DiagnosticIssue
from traceml_tpu_torch.diagnostics.liveness.api import diagnose_rank_status
from traceml_tpu_torch.diagnostics.step_memory.api import diagnose_columns, diagnose_rank_rows as memory_rows
from traceml_tpu_torch.diagnostics.step_time.api import diagnose_rank_rows
from traceml_tpu_torch.parallel import mesh as port_mesh
from traceml_tpu_torch.reporting.loaders import load_mesh_topology
from traceml_tpu_torch.reporting.snapshot_store import LiveSnapshotStore
from traceml_tpu_torch.telemetry.envelope import SenderIdentity, TelemetryEnvelope
from traceml_tpu_torch.utils import columnar
from traceml_tpu_torch.utils import timing as T
from traceml_tpu_torch.utils import topology as topo
from traceml_tpu_torch.utils.step_time_window import STEP_KEY, build_step_time_window

SHAPES = [
    None,
    {},
    {"fsdp": -1},
    {"data": 2, "fsdp": -1},
    {"data": -1, "tensor": 2},
    {"data": 2, "fsdp": 2, "tensor": 2},
    {"data": 4},
    {"expert": 2, "fsdp": -1},
    {"stage": 2, "data": 2},
    {"fdsp": 2},
    {"data": 3, "fsdp": -1},
]


def _jax_outcome(shape, n):
    try:
        m = jax_mesh.make_mesh(shape, devices=jax.devices()[:n])
    except ValueError as exc:
        return "error", str(exc).replace("jax.sharding.Mesh", "a torch DeviceMesh")
    return tuple(m.axis_names), [int(m.shape[a]) for a in m.axis_names]


def _port_outcome(shape, n):
    try:
        axes, sizes = port_mesh.resolve_mesh_shape(shape, n)
    except ValueError as exc:
        return "error", str(exc)
    return tuple(axes), [int(s) for s in sizes]


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "none" if s is None else json.dumps(s))
def test_mesh_shape_and_errors_equal_jax(shape, n):
    assert _port_outcome(shape, n) == _jax_outcome(shape, n)


@pytest.fixture
def gloo_world_1():
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()
        topo.reset_recorded_mesh_for_tests()
        jax_topo.reset_recorded_mesh_for_tests()


def test_make_mesh_on_a_one_rank_group_captures_the_jax_payload(gloo_world_1, monkeypatch):
    monkeypatch.delenv("TRACEML_MESH", raising=False)
    mesh = port_mesh.make_mesh(device_type="cpu")
    assert tuple(mesh.mesh_dim_names) == port_mesh.AXES and tuple(mesh.mesh.shape) == (1, 1, 1, 1)
    assert topo.recorded_mesh() is mesh
    assert port_mesh.local_batch_size(8, mesh) == (8, 1)
    ours = topo.capture_local_topology(0, 1)
    jax_topo.record_mesh(jax_mesh.make_mesh(None, devices=jax.devices()[:1]))
    theirs = jax_topo.capture_local_topology(0, 1)
    assert ours == theirs == {
        "axes": [{"name": a, "size": 1, "kind": "ici"} for a in port_mesh.AXES],
        "coords": [0, 0, 0, 0],
        "source": "mesh",
    }
    extra = port_mesh.make_mesh({"expert": 1, "stage": 1}, device_type="cpu")
    assert tuple(extra.mesh_dim_names) == ("expert", "stage")
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        port_mesh.make_mesh({"data": 2}, device_type="cpu")


def test_make_mesh_needs_cuda_or_an_explicit_cpu_and_a_group():
    import torch

    from traceml_tpu_torch.utils.device import DeviceUnavailableError

    if not torch.cuda.is_available():
        with pytest.raises(DeviceUnavailableError):
            port_mesh.make_mesh()
    with pytest.raises(RuntimeError, match="initialized process group"):
        port_mesh.make_mesh(device_type="cpu")


class _Dev:
    def __init__(self, rank, per_node):
        self.id = rank
        self.slice_index = rank // per_node
        self.process_index = rank


@pytest.mark.parametrize("sizes, per_node", [((2, 4), 4), ((4, 2), 4), ((2, 2, 2), 2), ((8,), 8), ((8,), 2),
                                             ((1, 8), 4)])
def test_axis_kinds_of_a_node_grid_equal_jax_slice_kinds(sizes, per_node):
    n = int(np.prod(sizes))
    ranks = np.arange(n).reshape(sizes)
    devs = np.array([_Dev(r, per_node) for r in range(n)], dtype=object).reshape(sizes)
    assert topo._axis_kinds_from_grid(ranks, per_node) == jax_topo._axis_kinds_from_mesh(devs)


@pytest.mark.parametrize("spec", ["data:4@dcn, fsdp:8", "data:4,bogus", "data:0", "data:4@wat", "",
                                  "a:2@ICI,b:3@DcN,c:1", " x:5 ", "data:2@dcn,fsdp:2,tensor:2"])
def test_parse_mesh_spec_equals_jax(spec):
    ours = [a.to_dict() for a in topo.parse_mesh_spec(spec)]
    assert ours == [a.to_dict() for a in jax_topo.parse_mesh_spec(spec)]


@pytest.mark.parametrize("spec", ["data:2@dcn,fsdp:2", "data:2,fsdp:2,tensor:2", "broken"])
def test_capture_under_traceml_mesh_equals_jax(monkeypatch, spec):
    topo.reset_recorded_mesh_for_tests()
    jax_topo.reset_recorded_mesh_for_tests()
    monkeypatch.setenv("TRACEML_MESH", spec)
    for rank in range(8):
        assert topo.capture_local_topology(rank, 8) == jax_topo.capture_local_topology(rank, 8)
    if spec == "data:2@dcn,fsdp:2":
        assert topo.capture_local_topology(3, 4)["coords"] == [1, 1]


def _assert_bitwise(a, b):
    for key in ("sum", "count", "mean", "min", "max"):
        assert np.array_equal(a[key], b[key], equal_nan=True), key
        assert a[key].dtype == b[key].dtype


@pytest.mark.parametrize("seed", [1234, 7, 99])
def test_reduce_cube_bitwise_against_both_references(seed):
    rng = np.random.default_rng(seed)
    r, s, g = 17, 23, 5
    cube = rng.uniform(1.0, 250.0, size=(r, s))
    cube[5] *= 1e12  # magnitudes where the fold order shows
    group_index = rng.integers(0, g, size=r)
    mask = rng.random((r, s)) > 0.2
    mask[3, :] = False
    mask[:, 7] = False
    for m in (mask, None):
        ours = topo.reduce_cube(cube, group_index, g, mask=m)
        _assert_bitwise(ours, topo.reduce_cube_reference(cube, group_index, g, mask=m))
        _assert_bitwise(ours, jax_topo.reduce_cube(cube, group_index, g, mask=m))


def _mesh(mod, spec, world, hosts_of=None, hostnames=None):
    axes = mod.parse_mesh_spec(spec)
    sizes = [a.size for a in axes]
    return mod.MeshTopology(
        axes=axes,
        rank_coords={r: tuple(mod._coords_for_rank(r, sizes)) for r in range(world)},
        rank_hosts={r: (hosts_of(r) if hosts_of else 0) for r in range(world)},
        rank_hostnames=hostnames or {},
        source="env",
    )


def _noise():
    rng = random.Random(7)
    values = {r: 100.0 + rng.uniform(-1, 1) for r in range(8)}
    values[5] = 180.0
    return values


# (spec, world, hosts_of, hostnames, values, expected kind or None)
ATTRIBUTION_CASES = {
    "host_outlier": ("data:2,fsdp:4", 8, lambda r: r // 4, {4: "gpu-host-b"},
                     {r: 100.0 + (35.0 if r >= 4 else 0.0) for r in range(8)}, "host"),
    "dcn_side": ("data:2@dcn,fsdp:4", 8, None, None,
                 {r: 100.0 + (35.0 if r >= 4 else 0.0) for r in range(8)}, "dcn_side"),
    "model_axis_imbalance": ("data:2,model:4", 8, None, None,
                             {r: 160.0 if r in (2, 6) else 100.0 for r in range(8)}, "axis"),
    "flat_fallback_on_noise": ("data:2@dcn,fsdp:4", 8, lambda r: r // 4, None, _noise(), None),
    "tie_breaks_toward_host": ("data:2@dcn,fsdp:4", 8, lambda r: r // 4, None,
                               {r: 100.0 + (35.0 if r >= 4 else 0.0) for r in range(8)}, "host"),
    "too_few_ranks": ("data:2,fsdp:2", 4, None, None, {0: 1.0, 1: 2.0}, None),
    "no_spread": ("data:2,fsdp:2", 4, None, None, {r: 5.0 for r in range(4)}, None),
}


@pytest.mark.parametrize("case", sorted(ATTRIBUTION_CASES))
def test_attribute_ranks_equals_jax(case):
    spec, world, hosts_of, hostnames, values, kind = ATTRIBUTION_CASES[case]
    ours_t = _mesh(topo, spec, world, hosts_of, hostnames)
    jax_t = _mesh(jax_topo, spec, world, hosts_of, hostnames)
    ours = topo.attribute_ranks(values, ours_t)
    theirs = jax_topo.attribute_ranks(values, jax_t)
    assert (ours is None) == (theirs is None) == (kind is None)
    if kind is not None:
        assert ours.kind == kind
        assert ours.to_dict() == theirs.to_dict()
    ranks = sorted(values)
    assert [(g.kind, g.label, g.axis, g.groups) for g in topo.candidate_groupings(ours_t, ranks)] == [
        (g.kind, g.label, g.axis, g.groups) for g in jax_topo.candidate_groupings(jax_t, ranks)
    ]
    assert topo.attribute_ranks(values, None) is None


def test_host_outlier_label_and_payload_round_trip():
    t = _mesh(topo, "data:2,fsdp:4", 8, lambda r: r // 4, {4: "gpu-host-b"})
    attr = topo.attribute_ranks({r: 100.0 + (35.0 if r >= 4 else 0.0) for r in range(8)}, t)
    assert attr.label == "all 4 ranks of host 1 (gpu-host-b)" and attr.explained >= 0.99
    back = topo.MeshTopology.from_payload(t.to_payload())
    assert back.to_payload() == jax_topo.MeshTopology.from_payload(t.to_payload()).to_payload() == t.to_payload()


def _result(mod_common, ranks):
    return mod_common.DiagnosticResult(
        domain="step_time",
        issues=[mod_common.DiagnosticIssue(kind="COMPUTE_STRAGGLER", severity=SEVERITY_WARNING,
                                           status=STATUS_ISSUE, summary="Rank skew detected",
                                           ranks=list(ranks))],
    )


@pytest.mark.parametrize("ranks", [[4, 5, 6, 7], [0]], ids=["inside_the_group", "outside_the_group"])
def test_attach_attribution_equals_jax(ranks):
    from traceml_tpu.diagnostics import common as jax_common
    from traceml_tpu_torch.diagnostics import common as port_common

    values = {r: 100.0 + (35.0 if r >= 4 else 0.0) for r in range(8)}
    ours = attach_attribution(_result(port_common, ranks), _mesh(topo, "data:2@dcn,fsdp:4", 8), values)
    theirs = jax_attr.attach_attribution(_result(jax_common, ranks), _mesh(jax_topo, "data:2@dcn,fsdp:4", 8),
                                         values)
    assert ours.to_dict() == theirs.to_dict()
    assert (ours.diagnosis.attribution is not None) == (ranks == [4, 5, 6, 7])


def test_attach_attribution_without_a_topology_is_the_identity():
    from traceml_tpu_torch.diagnostics import common as port_common

    result = _result(port_common, [1, 2])
    before = json.dumps(result.to_dict(), sort_keys=True)
    assert attach_attribution(result, None, {1: 2.0, 2: 3.0}) is result
    assert json.dumps(result.to_dict(), sort_keys=True) == before
    assert "attribution" not in DiagnosticIssue(kind="X", summary="s").to_dict()


def _step_row(step, ms):
    return {"step": step, "timestamp": 100.0 + step, "clock": "host",
            "events": {T.STEP_TIME: {"cpu_ms": ms, "count": 1}}}


def _step_rank_rows(slow):
    rng = random.Random(11)
    return {r: [_step_row(s, 100.0 + (45.0 if slow(r) else 0.0) + rng.uniform(0, 1)) for s in range(1, 61)]
            for r in range(4)}


@pytest.mark.parametrize("slow", ["rank_3", "dcn_side"])
def test_step_time_diagnosis_with_and_without_a_topology_equals_jax(slow):
    rank_rows = _step_rank_rows((lambda r: r == 3) if slow == "rank_3" else (lambda r: r >= 2))
    flat = diagnose_rank_rows(rank_rows, mode="summary")
    assert json.dumps(flat.to_dict(), sort_keys=True) == json.dumps(
        diagnose_rank_rows(rank_rows, mode="summary", topology=None).to_dict(), sort_keys=True)
    assert flat.to_dict() == port_advice(jax_step_time(rank_rows, mode="summary").to_dict())
    ours = diagnose_rank_rows(rank_rows, mode="summary", topology=_mesh(topo, "data:2@dcn,fsdp:2", 4))
    theirs = jax_step_time(rank_rows, mode="summary", topology=_mesh(jax_topo, "data:2@dcn,fsdp:2", 4))
    assert ours.to_dict() == port_advice(theirs.to_dict())
    attributed = [i for i in ours.issues if i.attribution]
    assert bool(attributed) == (slow == "dcn_side")
    # stripping the attribution recovers the flat result exactly
    stripped = json.loads(json.dumps(ours.to_dict()))
    for issue in [stripped["diagnosis"], *stripped["issues"]]:
        if "attribution" in issue:
            label = issue.pop("attribution")["label"]
            assert issue["summary"].endswith(f" — {label}.")
            issue["summary"] = issue["summary"][: -len(f" — {label}.")]
    assert json.dumps(stripped, sort_keys=True) == json.dumps(flat.to_dict(), sort_keys=True)


def _memory_rank_rows():
    limit = 80 << 30
    rng = np.random.default_rng(5)
    out = {}
    for r in range(4):
        frac = 0.93 if r >= 2 else 0.4
        out[r] = [{"step": s, "timestamp": 1.7e9 + s, "device_id": 0, "device_kind": "NVIDIA H100 80GB HBM3",
                   "current_bytes": int(limit * frac * rng.uniform(0.97, 0.99)),
                   "peak_bytes": int(limit * frac), "step_peak_bytes": int(limit * frac),
                   "limit_bytes": limit, "backend": "cuda_memory_stats"} for s in range(5, 205, 5)]
    return out


def _rings(mod, rank_rows):
    out = {}
    for r, rows in rank_rows.items():
        ring = out[r] = mod.MemoryColumns(len(rows))
        for row in rows:
            ring.append(row)
    return out


@pytest.mark.parametrize("with_topology", [False, True])
def test_step_memory_diagnoses_with_and_without_a_topology_equal_jax(with_topology):
    rows = _memory_rank_rows()
    ours_t = _mesh(topo, "data:2@dcn,fsdp:2", 4) if with_topology else None
    jax_t = _mesh(jax_topo, "data:2@dcn,fsdp:2", 4) if with_topology else None
    ours = memory_rows(rows, topology=ours_t)
    assert ours.to_dict() == port_advice(jax_memory(rows, topology=jax_t).to_dict())
    cols = diagnose_columns(_rings(columnar, rows), topology=ours_t)
    assert cols.to_dict() == port_advice(jax_memory_columns(_rings(jax_columnar, rows), topology=jax_t).to_dict())
    assert any(i.attribution for i in ours.issues) == with_topology
    if not with_topology:
        assert json.dumps(ours.to_dict(), sort_keys=True) == json.dumps(memory_rows(rows).to_dict(), sort_keys=True)


def _rank_status():
    ranks = {str(r): {"state": "lost" if r >= 4 else "active", "last_seen": 1.7e9 - (90 if r >= 4 else 1),
                      "last_progress": 1.7e9 - (95 if r >= 4 else 1), "finished": False} for r in range(8)}
    return {"ts": 1.7e9, "thresholds": {"stale_after_sec": 10.0, "lost_after_sec": 30.0},
            "expected_world_size": 8, "ranks": ranks}


@pytest.mark.parametrize("with_topology", [False, True])
def test_liveness_diagnosis_with_and_without_a_topology_equals_jax(with_topology):
    snap = _rank_status()
    hosts = lambda r: r // 4  # noqa: E731
    ours_t = _mesh(topo, "data:2@dcn,fsdp:4", 8, hosts) if with_topology else None
    jax_t = _mesh(jax_topo, "data:2@dcn,fsdp:4", 8, hosts) if with_topology else None
    ours = diagnose_rank_status(snap, topology=ours_t)
    assert ours.to_dict() == port_advice(jax_liveness(snap, topology=jax_t).to_dict())
    assert ours.diagnosis.kind == "RANK_LOST"
    assert (ours.diagnosis.attribution is not None) == with_topology
    if with_topology:
        assert ours.diagnosis.attribution["kind"] == "host" and ours.diagnosis.attribution["ranks"] == [4, 5, 6, 7]


@pytest.mark.parametrize("columnar_window", [False, True], ids=["scalar_window", "columnar_window"])
def test_reduce_window_by_grouping_equals_jax(columnar_window):
    rank_rows = {r: [_step_row(s, 100.0 + (40.0 if r >= 2 else 0.0) + 0.1 * s * r) for s in range(8)]
                 for r in range(4)}
    if columnar_window:
        def cols(mod):
            out = {}
            for r, rows in rank_rows.items():
                ring = out[r] = mod.StepTimeColumns(len(rows))
                for row in rows:
                    ring.append(row)
            return mod.build_columnar_step_time_window(out, 8)
        ours_w, jax_w = cols(columnar), cols(jax_columnar)
    else:
        from traceml_tpu.utils.step_time_window import build_step_time_window as jax_build

        ours_w, jax_w = build_step_time_window(rank_rows, max_steps=8), jax_build(rank_rows, max_steps=8)
    ours_t, jax_t = _mesh(topo, "data:2@dcn,fsdp:2", 4), _mesh(jax_topo, "data:2@dcn,fsdp:2", 4)
    ours_g = topo.candidate_groupings(ours_t, list(range(4)))
    jax_g = jax_topo.candidate_groupings(jax_t, list(range(4)))
    for a, b in zip(ours_g, jax_g):
        ours = columnar.reduce_window_by_grouping(ours_w, a, key=STEP_KEY)
        assert ours == jax_columnar.reduce_window_by_grouping(jax_w, b, key=STEP_KEY)
    dcn = next(g for g in ours_g if g.kind == "dcn_side")
    out = columnar.reduce_window_by_grouping(ours_w, dcn, key=STEP_KEY)
    assert [g["ranks"] for g in out["groups"]] == [[0, 1], [2, 3]] and min(out["dispersion"]) >= 40.0
    ranks, cube = columnar.window_series_cube(ours_w, STEP_KEY)
    jranks, jcube = jax_columnar.window_series_cube(jax_w, STEP_KEY)
    assert ranks == jranks and np.array_equal(cube, jcube)


# -- the store and the loader ------------------------------------------------

_AXES_2X2 = [{"name": "data", "size": 2, "kind": "dcn"}, {"name": "fsdp", "size": 2, "kind": "ici"}]


def _mesh_envelope(rank, coords, node):
    """The aggregator's re-wrap of a rank's mesh_topology message."""
    meta = SenderIdentity(session_id="s1", global_rank=rank, local_rank=rank % 2, world_size=4,
                          local_world_size=2, node_rank=node, hostname=f"host-{node}", pid=100 + rank).to_meta()
    meta.pop("seq", None)
    meta["sampler"] = "mesh_topology"
    row = {"timestamp": time.time(), "source": "mesh", "axes_json": json.dumps(_AXES_2X2),
           "coords_json": json.dumps(coords)}
    return TelemetryEnvelope(meta=meta, tables={"mesh_topology": [row]})


def test_store_and_loader_merge_mesh_rows_as_jax_does(tmp_path):
    db = tmp_path / "t.sqlite"
    w = SQLiteWriter(db)
    w.start()
    meta = SenderIdentity(session_id="s1", global_rank=0, local_rank=0, world_size=4, hostname="host-0",
                          pid=1).to_meta()
    meta.update({"sampler": "step_time", "seq": 1})
    w.ingest(TelemetryEnvelope(meta=meta, tables={"step_time": [_step_row(s, 100.0) for s in range(5)]}))
    assert w.force_flush()
    store, jax_store = LiveSnapshotStore(db, window_steps=20), JaxStore(db, window_steps=20)
    try:
        store.refresh()
        assert "mesh" not in store.topology() and store.mesh_topology() is None
        for rank in range(4):
            w.ingest(_mesh_envelope(rank, topo._coords_for_rank(rank, [2, 2]), node=rank // 2))
        w.ingest(_mesh_envelope(0, [0, 0], node=0))  # a replay: the latest row wins
        assert w.force_flush()
        store.refresh()
        jax_store.refresh()
        ours = store.mesh_topology()
        assert ours.to_payload() == jax_store.mesh_topology().to_payload()
        assert ours.rank_hosts == {0: 0, 1: 0, 2: 1, 3: 1} and ours.rank_coords[3] == (1, 1)
        assert store.topology() == jax_store.topology()
        assert store.topology()["mesh"] == {"axes": _AXES_2X2, "source": "mesh", "ranks": 4, "hosts": 2}
    finally:
        store.close()
        jax_store.close()
        w.finalize()
    assert load_mesh_topology(db).to_payload() == jax_load_mesh(db).to_payload()


def test_topology_from_rank_rows_skips_malformed_rows_as_jax_does():
    rows = [
        {"global_rank": 0, "node_rank": 0, "hostname": "h0", "source": "env",
         "axes_json": json.dumps(_AXES_2X2), "coords_json": json.dumps([0, 0])},
        {"global_rank": 1, "node_rank": 0, "hostname": "h0", "source": "env",
         "axes_json": "not json", "coords_json": "[0,1]"},
    ]
    ours = topo.topology_from_rank_rows(rows)
    assert sorted(ours.rank_coords) == [0]
    assert ours.to_payload() == jax_topo.topology_from_rank_rows(rows).to_payload()


@pytest.mark.parametrize("slow", ["dcn_side", "one_rank"])
def test_cross_run_regression_attribution_equals_jax(slow):
    from traceml_tpu.analytics import baselines as jax_baselines
    from traceml_tpu_torch.analytics import baselines

    moved = {2, 3} if slow == "dcn_side" else {1}
    base = {r: 100.0 + r * 0.1 for r in range(4)}
    runs = [{"stats": {"steady_step_ms": 100.15 + k, "per_rank_step_ms": {str(r): v + k * 0.05 for r, v in base.items()}}}
            for k in range(3)]
    cur = {str(r): v + (60.0 if r in moved else 0.0) for r, v in base.items()}
    stats = {"steady_step_ms": 130.0, "per_rank_step_ms": cur}
    ours = baselines.evaluate(stats, runs, topology=_mesh(topo, "data:2@dcn,fsdp:2", 4))
    theirs = jax_baselines.evaluate(stats, runs, topology=_mesh(jax_topo, "data:2@dcn,fsdp:2", 4))
    assert ours == port_advice(theirs)
    (issue,) = [i for i in ours["issues"] if i["metric"] == "steady_step_ms"]
    assert ("attribution" in issue) == (slow == "dcn_side")
    if slow == "dcn_side":
        assert issue["attribution"]["kind"] == "dcn_side" and issue["attribution"]["ranks"] == [2, 3]
    assert "attribution" not in baselines.evaluate(stats, runs)["issues"][0]
