"""The port's scenario library under ``run`` on the CPU (continued):
``recompile`` (COMPILE_BOUND: the compile tracker's events, after the
warm-up steps), ``memory_creep`` (growth above 20 MiB; on the CPU the
scenario reads the resident set), ``checkpoint_stall`` (a ``checkpoint``
phase with a positive mean, from the auto-patched ``torch.save``) and
``comm_bound`` (the collectives section, COMM_BOUND), with the
assertions of ``tests/launcher/test_scenarios_e2e.py``.
"""

import pytest
pytest.importorskip("torch")  # a checkout without torch still collects

from torch_scenarios import run


def test_recompile_storm_detected(tmp_path):
    payload = run(tmp_path, "recompile", steps=60)
    kinds = {i["kind"] for i in payload["sections"]["step_time"]["issues"]}
    assert "COMPILE_BOUND" in kinds, kinds
    compile_phase = payload["sections"]["step_time"]["global"]["phases"]["compile"]
    assert compile_phase["mean_ms"] > 0, compile_phase


def test_memory_creep_scenario_grows(tmp_path):
    payload = run(tmp_path, "memory_creep", steps=80)
    sm = payload["sections"]["step_memory"]
    assert sm["status"] == "OK"
    rank0 = sm["global"]["per_rank"]["0"]
    assert (rank0["growth_bytes"] or 0) > 20 << 20, rank0


def test_checkpoint_stall_phase_measured(tmp_path):
    payload = run(tmp_path, "checkpoint_stall", steps=40)
    phases = payload["sections"]["step_time"]["global"]["phases"]
    ckpt = phases.get("checkpoint")
    assert ckpt and ckpt["median_ms"] is not None, phases.keys()
    assert ckpt["mean_ms"] > 0, ckpt


def test_comm_bound_collectives_section(tmp_path):
    payload = run(tmp_path, "comm_bound", steps=40)
    sec = payload["sections"]["collectives"]
    assert sec["status"] == "OK", sec
    g = sec["global"]
    assert g["n_steps"] >= 10, g
    assert g["overlap_efficiency"] < 0.5, g
    assert "all_reduce" in g["per_op"], g["per_op"].keys()
    series = g["overlap_efficiency_series"]
    assert series and len(series) == len(g["series_steps"])
    assert all(0.0 <= v <= 1.0 for v in series)
    assert sec["diagnosis"]["kind"] == "COMM_BOUND", sec["diagnosis"]
    assert sec["diagnosis"]["severity"] in ("warning", "critical")
