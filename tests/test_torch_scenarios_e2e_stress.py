"""The port's 4-rank ``collective_straggler`` under ``run`` on the CPU
(the collective phase measured, COLLECTIVE_STRAGGLER on rank 3, as
``tests/launcher/test_scenarios_e2e.py`` asserts), and the stress
scenarios as ``tests/launcher/test_stress_scenarios_smoke.py`` runs
them: ``vit_stress`` and ``bert_stress`` for 6 steps, ``vit_stress`` with
its ``input_bound`` fault; and ``vit_stress input_bound`` under ``run``,
INPUT_BOUND.
"""

import pytest
pytest.importorskip("torch")  # a checkout without torch still collects

from torch_scenarios import run, run_module


def test_collective_straggler_four_ranks(tmp_path):
    payload = run(tmp_path, "collective_straggler", steps=60, nprocs=4)
    st = payload["sections"]["step_time"]
    coll = (st["global"]["phases"] or {}).get("collective")
    assert coll and coll["median_ms"] > 5.0, st["global"]["phases"].keys()
    kinds = {i["kind"] for i in st["issues"]}
    assert "COLLECTIVE_STRAGGLER" in kinds, (st["diagnosis"], kinds)
    issue = next(i for i in st["issues"] if i["kind"] == "COLLECTIVE_STRAGGLER")
    assert issue["ranks"] == [3]


@pytest.mark.parametrize("module", [
    "traceml_tpu_torch.dev.scenarios.vit_stress",
    "traceml_tpu_torch.dev.scenarios.bert_stress",
])
def test_stress_scenario_runs(module):
    if module.endswith("bert_stress"):
        pytest.importorskip("transformers")
        proc = run_module(module, "6", "--device", "cpu")
    else:
        proc = run_module(module, "6", "none", "--device", "cpu")
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "stress done" in proc.stdout


def test_vit_stress_with_fault():
    proc = run_module("traceml_tpu_torch.dev.scenarios.vit_stress", "6", "input_bound", "--device", "cpu")
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "vit stress done (input_bound)" in proc.stdout and "flash_attention.launches 0" in proc.stdout


def test_vit_stress_input_bound_under_run(tmp_path):
    payload = run(tmp_path, "vit_input_bound", steps=60, script="scenarios/vit_stress.py",
                  script_args=["60", "input_bound"])
    assert payload["primary_diagnosis"]["kind"] == "INPUT_BOUND", payload["primary_diagnosis"]
