"""The MFU path of the port against the JAX package's.

* ``build_efficiency``: the port's and the JAX formula on the same
  per-rank declarations and step times give the same block (exactly:
  the same arithmetic in the same order).
* ``load_model_stats``: both loaders read the same DB (written by the
  port's SQLite writer) the same way.
* ``peak_flops_for``: the H100's dense bf16 peaks by device name, None
  for the CPU and for names it does not know.
* The step-time sampler publishes one ``model_stats`` row per change of
  the declaration, with the peak of the declared device.
* ``set_step_tokens``: the row and the tokens/s it gives equal the JAX
  package's on the same declarations.
"""

import pytest

from tests.test_torch_sqlite import model_stats_rows, step_rows, wire_payloads, write
from traceml_tpu.analytics.efficiency import build_efficiency as jax_build_efficiency
from traceml_tpu.reporting.loaders import load_model_stats as jax_load_model_stats
from traceml_tpu_torch.aggregator.sqlite_writer import SQLiteWriter
from traceml_tpu_torch.analytics.efficiency import build_efficiency
from traceml_tpu_torch.reporting.loaders import load_model_stats
from traceml_tpu_torch.telemetry.envelope import normalize_telemetry_envelope
from traceml_tpu_torch.utils.chip_specs import peak_flops_for

H100 = {"flops_per_step": 9.0e12, "flops_source": "flop_counter", "device_kind": "NVIDIA H100 80GB HBM3",
        "peak_flops": 989e12, "device_count": 1}
CASES = {
    "one_rank": ({0: H100}, {0: 130.8}),
    "str_rank_ids": ({0: H100, 1: dict(H100, flops_per_step=8.5e12)}, {"0": 130.8, "1": 140.2}),
    "undeclared_rank_falls_back": ({0: H100}, {0: 130.8, 1: 150.0}),
    "two_devices_per_rank": ({0: dict(H100, device_count=2)}, {0: 70.0}),
    "no_peak": ({0: dict(H100, device_kind="cpu", peak_flops=None)}, {0: 52.6}),
    "tokens_only": ({0: {"flops_per_step": None, "tokens_per_step": 8192.0, "device_kind": "cpu"}}, {0: 52.6}),
    "tokens_and_flops": ({0: dict(H100, tokens_per_step=8192.0)}, {0: 130.8}),
    "zero_step_time": ({0: H100}, {0: 0.0}),
    "nothing_declared": ({}, {0: 130.8}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_build_efficiency_matches_jax(case):
    stats, step_ms = CASES[case]
    assert build_efficiency(stats, step_ms) == jax_build_efficiency(stats, step_ms)


def test_build_efficiency_mfu_on_the_h100():
    eff = build_efficiency({0: H100}, {0: 130.8})
    assert eff["peak_tflops"] == 989.0
    assert eff["mfu_median"] == pytest.approx(9.0e12 / 0.1308 / 989e12)
    assert eff["achieved_tflops_median"] == round(9.0e12 / 0.1308 / 1e12, 3)


@pytest.mark.parametrize(
    "name, peak",
    [("NVIDIA H100 80GB HBM3", 989e12), ("NVIDIA H100 PCIe", 756e12), ("nvidia h100 80gb hbm3", 989e12),
     ("cpu", None), ("NVIDIA A100-SXM4-80GB", None), ("", None), (None, None)],
)
def test_peak_flops_for(name, peak):
    assert peak_flops_for(name) == peak


def test_load_model_stats_matches_jax(tmp_path):
    db = tmp_path / "telemetry.sqlite"
    payloads = wire_payloads(
        {0: step_rows(0, 4, 1.0, 18.0), 1: step_rows(1, 4, 1.0, 18.0), 2: step_rows(2, 4, 1.0, 18.0)}, {},
        rank_model_stats={
            0: model_stats_rows(9.0e12) + model_stats_rows(9.2e12) + model_stats_rows(9.1e12, tokens=8192.0),
            1: model_stats_rows(8.0e12, device_kind="cpu", peak=None),
            2: model_stats_rows(None, tokens=4096.0),
        },
    )
    write(SQLiteWriter(db), normalize_telemetry_envelope, payloads)
    ours = load_model_stats(db)
    assert ours == jax_load_model_stats(db)
    assert ours[0]["flops_per_step"] == 9.1e12 and ours[0]["tokens_per_step"] == 8192.0
    assert ours[1]["peak_flops"] is None and ours[2]["tokens_per_step"] == 4096.0


def test_load_model_stats_without_the_table(tmp_path):
    db = tmp_path / "telemetry.sqlite"
    import sqlite3

    sqlite3.connect(db).close()
    assert load_model_stats(db) == jax_load_model_stats(db) == {}


def test_sampler_publishes_one_row_per_declaration_change():
    from traceml_tpu_torch.samplers.step_time_sampler import MODEL_STATS_TABLE, StepTimeSampler
    from traceml_tpu_torch.sdk.flops import set_step_flops
    from traceml_tpu_torch.sdk.state import reset_state_for_tests

    reset_state_for_tests(device="cpu")
    try:
        sampler = StepTimeSampler()
        sampler.sample()
        assert sampler.db.tail(MODEL_STATS_TABLE) == []  # nothing declared
        set_step_flops(9.0e12, device_kind="NVIDIA H100 80GB HBM3")
        sampler.sample()
        sampler.sample()
        set_step_flops(9.0e12)  # the device kind stays the declared one
        sampler.sample()
        set_step_flops(9.0e12, device_count=2)
        sampler.sample()
        rows = sampler.db.tail(MODEL_STATS_TABLE)
        assert len(rows) == 2
        assert rows[0]["flops_per_step"] == 9.0e12 and rows[0]["peak_flops"] == 989e12
        assert (rows[0]["flops_source"], rows[0]["device_count"]) == ("manual", 1)
        assert rows[1]["device_count"] == 2 and rows[1]["tokens_per_step"] is None
    finally:
        reset_state_for_tests()


def test_set_step_flops_defaults_to_the_trace_device():
    from traceml_tpu_torch.sdk.flops import set_step_flops
    from traceml_tpu_torch.sdk.state import get_state, reset_state_for_tests

    reset_state_for_tests(device="cpu")
    try:
        set_step_flops(1e9)
        st = get_state()
        assert (st.flops_per_step, st.flops_source, st.flops_device_kind, st.flops_device_count) == (
            1e9, "manual", "cpu", 1)
        assert peak_flops_for(st.flops_device_kind) is None
    finally:
        reset_state_for_tests()


def test_set_step_tokens_to_tokens_per_sec_as_jax():
    """``set_step_tokens`` → the sampler's ``model_stats`` row → the
    ``efficiency`` block: the port's row and tokens/s against the JAX
    package's ``set_step_tokens``, sampler and ``build_efficiency`` on the
    same declarations (to 1e-9), with FLOPs declared and without."""
    import traceml_tpu.sdk.state as jax_state
    from traceml_tpu.api import set_step_flops as jax_set_step_flops
    from traceml_tpu.api import set_step_tokens as jax_set_step_tokens
    from traceml_tpu.samplers.step_time_sampler import MODEL_STATS_TABLE as JAX_TABLE
    from traceml_tpu.samplers.step_time_sampler import StepTimeSampler as JaxSampler
    from traceml_tpu_torch.api import set_step_tokens
    from traceml_tpu_torch.samplers.step_time_sampler import MODEL_STATS_TABLE, StepTimeSampler
    from traceml_tpu_torch.sdk.flops import set_step_flops
    from traceml_tpu_torch.sdk.state import reset_state_for_tests

    # the peak is each package's own chip table (the JAX one knows TPUs)
    keys = ("flops_per_step", "flops_source", "device_kind", "device_count", "tokens_per_step")
    for flops in (None, 9.0e12):
        reset_state_for_tests(device="cpu")
        jax_state.reset_state_for_tests()
        try:
            ours, theirs = StepTimeSampler(), JaxSampler()
            set_step_tokens(8 * 1024)
            jax_set_step_tokens(8 * 1024)
            if flops is not None:
                set_step_flops(flops, device_kind="NVIDIA H100 80GB HBM3", device_count=1)
                jax_set_step_flops(flops, device_kind="NVIDIA H100 80GB HBM3", device_count=1)
            for sampler in (ours, theirs):
                sampler.sample()
                sampler.sample()  # unchanged: no second row
            (row,), (jax_row,) = ours.db.tail(MODEL_STATS_TABLE), theirs.db.tail(JAX_TABLE)
        finally:
            reset_state_for_tests()
            jax_state.reset_state_for_tests()
        assert {k: row[k] for k in keys} == {k: jax_row[k] for k in keys}
        assert row["tokens_per_step"] == 8192.0
        step_ms = {0: 137.25, 1: 141.5}
        eff = build_efficiency({0: row}, step_ms)
        want = jax_build_efficiency({0: jax_row}, step_ms)
        same = ("tokens_per_step", "tokens_per_sec_median", "flops_per_step", "achieved_tflops_median")
        assert {k: eff[k] for k in same} == {k: want[k] for k in same}
        assert eff["tokens_per_sec_median"] == pytest.approx(want["tokens_per_sec_median"], rel=1e-9, abs=0)
        assert eff["tokens_per_sec_median"] == round(
            (8192 / 0.13725 + 8192 / 0.1415) / 2, 1)
