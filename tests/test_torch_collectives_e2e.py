"""The collectives domain and the multi-node launch end to end, on the CPU.

``python -m traceml_tpu_torch run --nprocs 2`` of ``dev/train_script.py``
with the 2-layer DecoderLM on the CPU, both ranks in a gloo process group
with ``make_mesh()`` (everything on ``fsdp``: the mesh is 1 × 2 × 1 × 1):

* a gradient sync whose cost is rank 1's alone (``--grad-sync local``,
  120 ms on rank 1): COLLECTIVE_STRAGGLER on rank 1.  A real all-reduce
  would make rank 0 wait for rank 1 inside its own sync, and the
  straggler rule rightly reads a wait as no one's fault; the JAX
  ``collective_straggler`` scenario's sync is rank-local too;
* both ranks' gradients all-reduced over gloo with a 150 ms host stall
  inside the sync: COMM_BOUND in the collectives section, the group size
  2, and both ranks' mesh rows in the database.

Then the two tests of the JAX ``tests/launcher/test_multinode_e2e.py``:
two launcher calls on localhost with ``--nnodes 2 --node-rank 0/1
--aggregator-port`` and one session id, rank 1's input slowed; one report
on node 0 with both ranks, INPUT_STRAGGLER on rank 1, and (with separate
roots and a connect address apart from the bind address) two ranks a node,
the report on node 0 only, and each rank's node in its identity.
"""

import json
import os
import socket
import sqlite3
import subprocess
import sys
import time
from pathlib import Path

import pytest

pytest.importorskip("torch")

REPO = Path(__file__).resolve().parent.parent
SCRIPT = REPO / "traceml_tpu_torch" / "dev" / "train_script.py"


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env(extra=None, clean=False):
    env = {k: v for k, v in os.environ.items()
           if not (clean and k.startswith(("TRACEML_", "RANK", "WORLD_", "LOCAL_R", "MASTER_")))}
    env.update({"PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1", "JAX_PLATFORMS": "cpu"})
    env.update(extra or {})
    return env


def _run(tmp_path, script_args, nprocs=2, timeout=240):
    logs = tmp_path / "logs"
    env = _env({"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port())})
    proc = subprocess.run(
        [sys.executable, "-m", "traceml_tpu_torch", "run", "--mode", "summary", "--nprocs", str(nprocs),
         "--logs-dir", str(logs), "--sampler-interval", "0.25", "--finalize-timeout", "40", str(SCRIPT), "--",
         "--device", "cpu", "--tiny", *script_args],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=timeout,
    )
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    session = next(p for p in logs.iterdir() if p.is_dir())
    return session, json.loads((session / "final_summary.json").read_text()), proc.stdout


def _mesh_rows(session):
    conn = sqlite3.connect(session / "telemetry.sqlite")
    try:
        return conn.execute(
            "SELECT global_rank, source, axes_json, coords_json FROM mesh_topology ORDER BY global_rank"
        ).fetchall()
    finally:
        conn.close()


def _check_mesh(session, summary):
    rows = _mesh_rows(session)
    assert [r[0] for r in rows] == [0, 1] and {r[1] for r in rows} == {"mesh"}
    axes = json.loads(rows[0][2])
    assert [(a["name"], a["size"], a["kind"]) for a in axes] == [
        ("data", 1, "ici"), ("fsdp", 2, "ici"), ("tensor", 1, "ici"), ("context", 1, "ici")]
    assert [json.loads(r[3]) for r in rows] == [[0, 0, 0, 0], [0, 1, 0, 0]]
    assert summary["meta"]["topology"]["mesh"]["ranks"] == 2


def test_a_slow_sync_on_one_rank_is_a_collective_straggler(tmp_path):
    session, summary, _ = _run(tmp_path, ["--steps", "60", "--mesh", "--grad-sync", "local",
                                          "--sync-sleep-ms", "120", "--sync-sleep-rank", "1"])
    issues = summary["sections"]["step_time"]["issues"]
    straggler = [i for i in issues if i["kind"] == "COLLECTIVE_STRAGGLER"]
    assert straggler and straggler[0]["ranks"] == [1], [(i["kind"], i.get("ranks")) for i in issues]
    assert summary["primary_diagnosis"]["kind"] == "COLLECTIVE_STRAGGLER"
    coll = summary["sections"]["collectives"]
    assert coll["status"] == "OK" and coll["global"]["per_op"]["all_reduce"]["count"] == 120
    per_rank = coll["global"]["per_rank"]
    assert per_rank["1"]["exposed_ms"] > 60 * 100.0 > per_rank["0"]["exposed_ms"]
    _check_mesh(session, summary)


def test_an_exposed_all_reduce_over_gloo_is_comm_bound(tmp_path):
    session, summary, _ = _run(tmp_path, ["--steps", "60", "--mesh", "--grad-sync", "all_reduce",
                                          "--sync-sleep-ms", "150"])
    coll = summary["sections"]["collectives"]
    assert coll["status"] == "OK", coll
    g = coll["global"]
    assert g["group_size"] == 2 and g["per_op"]["all_reduce"]["count"] == 120
    # the stall against a ~25 ms step: past the 0.25 warning line even on a host loaded 4x
    assert g["exposed_share_of_step"] > 0.25 and g["overlap_efficiency"] == 0.0
    assert "COMM_BOUND" in {i["kind"] for i in coll["issues"]}, coll["issues"]
    assert coll["card"].startswith("60 steps · group size 2")
    _check_mesh(session, summary)


def _node(argv, env, cwd):
    return subprocess.Popen(argv, env=env, cwd=str(cwd), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def _launcher(logs, nprocs, node_rank, port, host, run_name):
    return [
        sys.executable, "-m", "traceml_tpu_torch", "run", "--mode", "summary", "--logs-dir", str(logs),
        "--run-name", run_name, "--nnodes", "2", "--nprocs", str(nprocs), "--node-rank", str(node_rank),
        "--aggregator-host", host, "--aggregator-port", str(port), "--sampler-interval", "0.25",
        "--finalize-timeout", "60", str(SCRIPT), "--", "--device", "cpu", "--tiny", "--steps", "60",
        "--delay-ms", "120", "--delay-rank", "1",
    ]


def test_two_node_localhost(tmp_path):
    logs, port = tmp_path / "logs", _free_port()
    env = _env({"TRACEML_SESSION_ID": "mn-shared"})
    node0 = _node(_launcher(logs, 1, 0, port, "127.0.0.1", "mn"), env, tmp_path)
    time.sleep(2.0)  # let node 0 bind the port
    node1 = _node(_launcher(logs, 1, 1, port, "127.0.0.1", "mn"), env, tmp_path)
    out1, _ = node1.communicate(timeout=240)
    out0, _ = node0.communicate(timeout=240)
    assert node0.returncode == 0, out0[-3000:]
    assert node1.returncode == 0, out1[-3000:]
    session = logs / "mn-shared"
    payload = json.loads((session / "final_summary.json").read_text())
    topo = payload["meta"]["topology"]
    assert topo["world_size"] == 2 and sorted(topo["ranks_seen"]) == [0, 1]
    assert topo["mode"] == "multi_node"
    primary = payload["primary_diagnosis"]
    assert primary["kind"] == "INPUT_STRAGGLER" and primary["ranks"] == [1], primary
    # node 1's rank has no aggregator on its node: it took TCP
    stats = json.loads((session / "ingest_stats.json").read_text())
    assert stats["transports"]["ranks"]["1"]["transport"] == "tcp"
    assert stats["transports"]["ranks"]["0"]["transport"] == "shm"
    manifest = json.loads((session / "manifest.json").read_text())
    assert manifest["world_size"] == 2 and manifest["status"] == "completed"


def test_two_node_two_rank_distinct_hosts(tmp_path):
    port = _free_port()
    nodes = {}
    for node_rank in (0, 1):
        root = tmp_path / f"host{node_rank}"
        (root / "tmp").mkdir(parents=True)
        env = _env({"TRACEML_SESSION_ID": "mn2-shared", "TMPDIR": str(root / "tmp")}, clean=True)
        nodes[node_rank] = (root, env)
    root0, env0 = nodes[0]
    # node 0 binds 0.0.0.0; every rank dials the 127.0.0.2 loopback alias
    node0 = _node(_launcher(root0 / "logs", 2, 0, port, "127.0.0.2", "mn2"), env0, root0)
    time.sleep(2.0)
    root1, env1 = nodes[1]
    node1 = _node(_launcher(root1 / "logs", 2, 1, port, "127.0.0.2", "mn2"), env1, root1)
    out1, _ = node1.communicate(timeout=300)
    out0, _ = node0.communicate(timeout=300)
    assert node0.returncode == 0, out0[-3000:]
    assert node1.returncode == 0, out1[-3000:]
    session0 = root0 / "logs" / "mn2-shared"
    assert (session0 / "final_summary.json").exists()
    assert not any((p / "final_summary.json").exists() for p in (root1 / "logs").iterdir())
    payload = json.loads((session0 / "final_summary.json").read_text())
    topo = payload["meta"]["topology"]
    assert topo["world_size"] == 4 and sorted(topo["ranks_seen"]) == [0, 1, 2, 3]
    assert topo["mode"] == "multi_node" and topo["nodes"] == 2
    cards = payload["sections"]["step_time"]["global"]["per_rank"]
    node_of = {int(r): int(c["identity"]["node_rank"]) for r, c in cards.items() if c.get("identity")}
    assert node_of == {0: 0, 1: 0, 2: 1, 3: 1}, node_of
    primary = payload["primary_diagnosis"]
    assert primary["kind"] == "INPUT_STRAGGLER" and primary["ranks"] == [1], primary
