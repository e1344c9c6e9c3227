"""The port's scenario library under ``run`` on the CPU: the verdicts
``tests/launcher/test_scenarios_e2e.py`` asserts of the JAX scenarios.

This file: the 4-rank ``input_straggler`` (INPUT_STRAGGLER on rank 3,
four ranks seen), ``input_bound`` (INPUT_BOUND, the occupancy below 0.9)
and ``healthy`` (no injected-fault verdict), and the port harness's
tables against the JAX harness's.  The other scenarios are in
``test_torch_scenarios_e2e_faults.py`` and
``test_torch_scenarios_e2e_stress.py`` (``--dist loadfile`` runs a file
on one worker).
"""

import pytest
pytest.importorskip("torch")  # a checkout without torch still collects

from torch_scenarios import run

INJECTED_FAULT_KINDS = (
    "INPUT_BOUND", "INPUT_STRAGGLER", "COMPUTE_STRAGGLER", "COMPILE_BOUND", "MEMORY_CREEP_EARLY",
    "MEMORY_CREEP_CONFIRMED", "COMM_BOUND", "POOR_OVERLAP", "RANK_LOST", "LIKELY_PREEMPTED",
)


def test_input_straggler_four_ranks(tmp_path):
    payload = run(tmp_path, "input_straggler", steps=60, nprocs=4)
    primary = payload["primary_diagnosis"]
    assert primary["kind"] == "INPUT_STRAGGLER", primary
    assert primary["ranks"] == [3]
    assert payload["meta"]["topology"]["world_size"] == 4
    assert sorted(payload["meta"]["topology"]["ranks_seen"]) == [0, 1, 2, 3]


def test_input_bound_single_rank(tmp_path):
    payload = run(tmp_path, "input_bound", steps=50)
    st = payload["sections"]["step_time"]
    assert st["diagnosis"]["kind"] == "INPUT_BOUND", st["diagnosis"]
    occ = st["global"]["median_occupancy"]
    assert occ is None or occ < 0.9
    assert "flash_attention.launches 0" in payload["_stdout"]


def test_healthy_not_misdiagnosed(tmp_path):
    payload = run(tmp_path, "healthy", steps=60)
    primary = payload["primary_diagnosis"]
    assert primary["kind"] not in INJECTED_FAULT_KINDS, primary
    st_primary = payload["sections"]["step_time"]["diagnosis"]
    assert st_primary["kind"] in (
        "COMPUTE_BOUND", "NO_CLEAR_PERFORMANCE_BOTTLENECK", "RESIDUAL_HEAVY", "HEALTHY",
        "INSUFFICIENT_STEP_TIME_DATA",
    ), st_primary


def test_harness_tables_match_jax():
    from traceml_tpu.dev import precision_harness as jax_harness
    from traceml_tpu_torch.dev import precision_harness as harness
    from traceml_tpu_torch.dev.demo import scenarios

    assert list(harness.SCENARIOS) == list(jax_harness.SCENARIOS)
    assert {n: s[:2] + s[3:] for n, s in harness.SCENARIOS.items()} == {
        n: s[:2] + s[3:] for n, s in jax_harness.SCENARIOS.items()}
    assert harness.EXPECTED_KINDS == jax_harness.EXPECTED_KINDS
    assert harness._FAULT_KINDS == jax_harness._FAULT_KINDS
    assert set(harness.SCENARIOS) <= set(scenarios.NAMES)
    payload = {"primary_diagnosis": {"kind": "INPUT_STRAGGLER", "ranks": [3]},
               "sections": {"step_time": {"issues": [{"kind": "INPUT_BOUND", "confidence_label": "high"}]}}}
    for name, (_, _, detector, _) in harness.SCENARIOS.items():
        assert detector(payload) == jax_harness.SCENARIOS[name][2](payload), name
    assert harness._collect_fault_findings(payload) == jax_harness._collect_fault_findings(payload)
