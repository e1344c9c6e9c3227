"""The port's stdout capture against the JAX package's.

The same writes (whole lines, a line split over three writes, several
lines in one write, stderr, a line longer than the 4096-character row
cap) go through the JAX and the port ``StreamCapture``: both pass every
byte through unchanged and drain the same ``(stream, line)`` list, and
with a bound of 3 lines both keep the same newest 3.  The JAX and the
port ``StdoutStderrSampler`` drain captures holding the same lines: the
same ``stdout_stderr`` rows (all but the timestamp, which is each
sampler's clock) and byte-identical ``stdout.log`` files, with and
without the DB mirror.  The same ``stdout_stderr`` envelopes, in both
table encodings, give the same ``stdout_samples`` table through both
``SQLiteWriter``s, ids included.  The runtime installs the capture and
its sampler in the ``cli`` mode only, as the JAX ``build_samplers`` does.
All comparisons are exact (tolerance 0): both sides are the same
string handling.
"""

import io
import sys

import pytest

from tests.test_torch_sqlite import dump, write
from traceml_tpu.aggregator.sqlite_writer import SQLiteWriter as JaxWriter
from traceml_tpu.runtime.stdout_capture import StreamCapture as JaxCapture
from traceml_tpu.samplers.stdout_stderr_sampler import StdoutStderrSampler as JaxSampler
from traceml_tpu.telemetry.envelope import normalize_telemetry_envelope as jax_normalize
from traceml_tpu_torch.aggregator.sqlite_writer import SQLiteWriter
from traceml_tpu_torch.runtime.stdout_capture import StreamCapture
from traceml_tpu_torch.samplers.stdout_stderr_sampler import StdoutStderrSampler
from traceml_tpu_torch.telemetry.envelope import (
    SenderIdentity,
    normalize_telemetry_envelope,
    rows_to_columns,
)

WRITES = (
    ("stdout", "step 1 loss 5.9\n"),
    ("stdout", "step 2 "),
    ("stdout", "loss 5.1"),
    ("stderr", "warning: slow input\n"),
    ("stdout", "\n"),
    ("stdout", "a\nb\nc\n"),
    ("stdout", "x" * 5000 + "\n"),
    ("stderr", "Traceback (most recent call last):\n  File ...\n"),
    ("stdout", "final_summary {\"kind\": \"INPUT_BOUND\", \"n_steps\": 60}\n"),
    ("stdout", "no newline yet"),
)


def _run_writes(capture_cls, monkeypatch, **kw):
    out, err = io.StringIO(), io.StringIO()
    monkeypatch.setattr(sys, "stdout", out)
    monkeypatch.setattr(sys, "stderr", err)
    cap = capture_cls(**kw)
    cap.start()
    try:
        for stream, data in WRITES:
            assert (sys.stdout if stream == "stdout" else sys.stderr).write(data) == len(data)
        assert sys.stdout.isatty() is False and sys.stdout.encoding == out.encoding
        sys.stdout.flush()
    finally:
        cap.stop()
    assert sys.stdout is out and sys.stderr is err
    return out.getvalue(), err.getvalue(), cap.drain()


@pytest.mark.parametrize("max_lines", [2000, 3])
def test_capture_tees_drains_and_bounds_as_jax(monkeypatch, max_lines):
    jax = _run_writes(JaxCapture, monkeypatch, max_lines=max_lines)
    port = _run_writes(StreamCapture, monkeypatch, max_lines=max_lines)
    assert port == jax
    out, err, lines = port
    assert out == "".join(d for s, d in WRITES if s == "stdout")  # passed through whole
    assert err == "".join(d for s, d in WRITES if s == "stderr")
    if max_lines == 3:  # the newest three whole lines
        assert lines == [("stderr", "Traceback (most recent call last):"), ("stderr", "  File ..."),
                         ("stdout", WRITES[-2][1].rstrip("\n"))]
    else:
        assert lines[:3] == [("stdout", "step 1 loss 5.9"), ("stderr", "warning: slow input"),
                             ("stdout", "step 2 loss 5.1")]
        assert ("stdout", "no newline yet") not in lines  # a partial line waits for its newline


class _Filled:
    """A capture that drains the given lines once."""

    def __init__(self, lines):
        self._lines = list(lines)

    def drain(self):
        out, self._lines = self._lines, []
        return out


LINES = [("stdout", "step 1"), ("stderr", "careful"), ("stdout", "y" * 5000), ("stdout", "done")]


@pytest.mark.parametrize("mirror", [True, False])
def test_sampler_rows_and_log_as_jax(tmp_path, mirror):
    jax = JaxSampler(_Filled(LINES), log_path=tmp_path / "jax" / "stdout.log", mirror_to_db=mirror)
    port = StdoutStderrSampler(_Filled(LINES), log_path=tmp_path / "port" / "stdout.log", mirror_to_db=mirror)
    for sampler in (jax, port):
        sampler.sample()
        sampler.sample()  # nothing new: no row, no log line
    assert port.name == jax.name == "stdout_stderr"
    jax_rows, port_rows = jax.db.tail("stdout_stderr"), port.db.tail("stdout_stderr")
    assert [{k: v for k, v in r.items() if k != "timestamp"} for r in port_rows] == \
        [{k: v for k, v in r.items() if k != "timestamp"} for r in jax_rows]
    assert len(port_rows) == (4 if mirror else 0)
    assert all(len(r["line"]) <= 4096 for r in port_rows)
    log = (tmp_path / "port" / "stdout.log").read_bytes()
    assert log == (tmp_path / "jax" / "stdout.log").read_bytes()
    assert log.decode().splitlines()[:2] == ["[stdout] step 1", "[stderr] careful"]


def _stdout_payloads(columnar):
    """``stdout_stderr`` envelopes from two ranks in the rank sender's
    shape (``seq`` monotonic per rank)."""
    out = []
    for rank in (0, 1):
        ident = SenderIdentity(session_id="s", global_rank=rank, local_rank=rank, world_size=2,
                               local_world_size=2, hostname=f"host-{rank}", pid=100 + rank)
        for seq in (1, 2):
            rows = [{"timestamp": 1.7e9 + seq + i * 0.01, "stream": "stderr" if i == 2 else "stdout",
                     "line": f"rank {rank} envelope {seq} line {i}" + ("z" * 5000 if i == 1 else "")}
                    for i in range(3)]
            meta = ident.to_meta()
            meta.update({"schema": 2 if columnar else 1, "sampler": "stdout_stderr",
                         "timestamp": 1.7e9, "seq": seq})
            out.append({"meta": meta, "body": {"tables": {
                "stdout_stderr": rows_to_columns(rows) if columnar else rows}}})
    return out


@pytest.mark.parametrize("columnar", [True, False], ids=["schema2", "schema1"])
def test_writer_stores_the_same_table_as_jax(tmp_path, columnar):
    payloads = _stdout_payloads(columnar)
    write(JaxWriter(tmp_path / "jax.sqlite"), jax_normalize, payloads)
    port = SQLiteWriter(tmp_path / "port.sqlite")
    write(port, normalize_telemetry_envelope, payloads)
    cols_j, rows_j = dump(tmp_path / "jax.sqlite", "stdout_samples")
    cols_p, rows_p = dump(tmp_path / "port.sqlite", "stdout_samples")
    assert cols_p == cols_j
    assert rows_p == rows_j and len(rows_p) == 12
    assert (port.written, port.dropped) == (12, 0)
    assert max(len(r[-1]) for r in rows_p) == 4096


@pytest.mark.parametrize("mode", ["cli", "summary", "dashboard"])
def test_runtime_wires_the_capture_in_cli_mode_only(tmp_path, mode):
    """As in JAX, the capture and its sampler are wired in the live modes,
    ``cli`` and ``dashboard`` (whose page shows rank 0's output too), and
    not in ``summary``."""
    from traceml_tpu_torch.runtime.runtime import TraceMLRuntime
    from traceml_tpu_torch.runtime.settings import TraceMLSettings
    from traceml_tpu_torch.sdk.state import reset_state_for_tests

    reset_state_for_tests()
    before = sys.stdout
    rt = TraceMLRuntime(TraceMLSettings(mode=mode, logs_dir=tmp_path, session_id="s", sampler_interval_sec=0.05))
    rt.start()
    try:
        teed = sys.stdout is not before
        print("hello from the script")
    finally:
        rt.stop()
        reset_state_for_tests()
    assert sys.stdout is before  # restored at stop
    names = [s.name for s in rt.samplers]
    log = tmp_path / "s" / "rank_0" / "stdout.log"
    if mode in ("cli", "dashboard"):
        assert teed and names[-1] == "stdout_stderr"
        assert "[stdout] hello from the script" in log.read_text().splitlines()
    else:
        assert not teed and "stdout_stderr" not in names and not log.exists()


def test_build_samplers_adds_the_stdout_sampler_as_jax(tmp_path):
    """The samplers ``cli`` adds over ``summary``: the JAX registry and
    the port's agree (the stdout sampler, only with a capture)."""
    from traceml_tpu.runtime.identity import RuntimeIdentity as JaxIdentity
    from traceml_tpu.runtime.sampler_registry import build_samplers as jax_build
    from traceml_tpu.runtime.settings import TraceMLSettings as JaxSettings
    from traceml_tpu_torch.runtime.identity import RuntimeIdentity
    from traceml_tpu_torch.runtime.sampler_registry import build_samplers
    from traceml_tpu_torch.runtime.settings import TraceMLSettings

    def added(build, settings_cls, identity, capture):
        names = {m: [s.name for s in build(settings_cls(mode=m, logs_dir=tmp_path), identity, capture)]
                 for m in ("cli", "summary")}
        return [n for n in names["cli"] if n not in names["summary"]]

    jax_id, port_id = JaxIdentity(), RuntimeIdentity()
    assert added(jax_build, JaxSettings, jax_id, JaxCapture()) == ["stdout_stderr"]
    assert added(build_samplers, TraceMLSettings, port_id, StreamCapture()) == ["stdout_stderr"]
    assert added(jax_build, JaxSettings, jax_id, None) == added(build_samplers, TraceMLSettings, port_id, None) == []
