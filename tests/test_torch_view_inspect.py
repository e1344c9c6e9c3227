"""The port's ``view`` and ``inspect`` commands and the bounded-run
settings against the JAX package's.

* ``view``: on a session the port's report wrote from the pruned
  database of ``tests/test_torch_history.py``, the JAX ``run_view`` and
  the port's print the same stdout with ``--format text`` and ``json``,
  from the session dir and from its ``final_summary.json``, and the same
  message and exit code for a path with no summary.
* ``inspect``: a rank's ``data`` dir holding each sampler's v2 envelope
  backup (rank 0's envelopes of the retention stream, encoded by the port
  publisher's codec and written by the port's writer) and one v1 per-row
  file written by the JAX writer (the port writes none): the JAX ``run_inspect`` and
  the port's print the same stdout and return the same code for the
  default dump, ``--domain step_time`` (with ``--limit``), a domain with
  no rows, ``--domain rollup`` on the session (and on a database with no
  tiers), ``--domain topology`` and ``--domain serving`` (tables the port
  does not write: the JAX messages for a session without them), and an
  empty directory.  The ``run`` command line parses the four new options
  and reaches both commands.
* Settings: the port's ``settings_to_env`` read back by the JAX
  ``settings_from_env`` and the other way round keep
  ``trace_max_steps``, ``disk_backup``, ``capture_stderr`` and
  ``summary_window_rows`` under the JAX names, and the launchers'
  ``resolve_settings`` resolve them alike from the command line and the
  environment.

Exact comparison of strings and values.
"""

import json
import shutil

import pytest

from test_torch_history import pruned_db  # noqa: F401  (the module fixture)
from test_torch_retention import _stream
from traceml_tpu.database import database_writer as jax_dw
from traceml_tpu.database.database import Database as JaxDatabase
from traceml_tpu_torch.database.database_writer import DatabaseWriter
from traceml_tpu_torch.utils import msgpack_codec


@pytest.fixture(scope="module")
def session(pruned_db, tmp_path_factory):  # noqa: F811
    from traceml_tpu_torch.reporting.final import generate_summary
    from traceml_tpu_torch.runtime.settings import TraceMLSettings

    sdir = tmp_path_factory.mktemp("logs") / "sess"
    sdir.mkdir()
    shutil.copy(pruned_db, sdir / "telemetry.sqlite")
    assert generate_summary(sdir / "telemetry.sqlite", sdir, TraceMLSettings(session_id="sess", mode="summary"))
    data = sdir / "rank_0" / "data"
    writers = {}
    for tick in _stream():
        for p in tick:
            if p["meta"]["global_rank"] != 0:
                continue
            name = p["meta"]["sampler"]
            w = writers.setdefault(name, DatabaseWriter(name, data))
            w.append_envelope(msgpack_codec.preencode(p))
    for w in writers.values():
        w.flush(force=True)
    db = JaxDatabase()
    db.add_records("stdout_stderr", [{"timestamp": 1.7e9, "stream": "stdout", "line": f"line {i}"} for i in range(3)])
    jax_dw.DatabaseWriter("stdout_stderr", db, data).flush(force=True)
    return sdir


def _both(capsys, jax_fn, port_fn, *args, **kw):
    out = []
    for fn in (jax_fn, port_fn):
        code = fn(*args, **kw)
        out.append((code, capsys.readouterr().out))
    return out


@pytest.mark.parametrize("fmt", ["text", "json"])
@pytest.mark.parametrize("target", ["dir", "json"])
def test_view_prints_what_jax_prints(session, capsys, fmt, target):
    from traceml_tpu.reporting.view.command import run_view as jax_view
    from traceml_tpu_torch.reporting.view.command import run_view

    path = session if target == "dir" else session / "final_summary.json"
    (jc, jout), (pc, pout) = _both(capsys, jax_view, run_view, path, fmt=fmt)
    assert (pc, pout) == (jc, jout) and pc == 0
    if fmt == "json":
        assert json.loads(pout) == json.loads((session / "final_summary.json").read_text())
    else:
        assert pout == (session / "final_summary.txt").read_text() + "\n" and "History:" in pout


def test_view_without_a_summary(tmp_path, capsys):
    from traceml_tpu.reporting.view.command import run_view as jax_view
    from traceml_tpu_torch.reporting.view.command import run_view

    (jc, jout), (pc, pout) = _both(capsys, jax_view, run_view, tmp_path)
    assert (pc, pout) == (jc, jout) == (1, f"no readable summary at {tmp_path / 'final_summary.json'}\n")


@pytest.mark.parametrize("where, kw", [
    ("data", {}),
    ("data", {"domain": "step_time", "limit": 3}),
    ("data", {"domain": "stdout_stderr"}),
    ("data", {"domain": "no_such_table"}),
    ("session", {"domain": "rollup", "limit": 4}),
    ("session", {"domain": "topology"}),
    ("session", {"domain": "serving"}),
    ("empty", {}),
    ("empty", {"domain": "rollup"}),
], ids=["default", "step_time", "v1_file", "no_rows", "rollup", "topology", "serving", "empty", "empty_rollup"])
def test_inspect_prints_what_jax_prints(session, tmp_path, capsys, where, kw):
    from traceml_tpu.launcher.inspect_cmd import run_inspect as jax_inspect
    from traceml_tpu_torch.launcher.inspect_cmd import run_inspect

    path = {"data": session / "rank_0" / "data", "session": session, "empty": tmp_path}[where]
    (jc, jout), (pc, pout) = _both(capsys, jax_inspect, run_inspect, path, **kw)
    assert (pc, pout) == (jc, jout)
    if where == "data" and kw.get("domain") in (None, "step_time"):
        assert pc == 0 and '"table": "step_time"' in pout
    if kw.get("domain") == "rollup" and where == "session":
        assert pc == 0 and "step_time.step_ms" in pout and "step_memory.current_bytes" in pout


def test_inspect_rollup_without_tiers(tmp_path, capsys):
    from traceml_tpu.launcher.inspect_cmd import run_inspect as jax_inspect
    from traceml_tpu_torch.aggregator.sqlite_writer import SQLiteWriter
    from traceml_tpu_torch.launcher.inspect_cmd import run_inspect

    w = SQLiteWriter(tmp_path / "telemetry.sqlite")
    w.start()
    assert w.finalize()
    (jc, jout), (pc, pout) = _both(capsys, jax_inspect, run_inspect, tmp_path, domain="rollup")
    assert (pc, pout) == (jc, jout) and pc == 1 and "no rollup tiers" in pout


def test_command_line_reaches_view_and_inspect(session, capsys):
    from traceml_tpu_torch.launcher import cli

    args = cli._build_parser().parse_args(
        ["run", "--trace-max-steps", "3", "--summary-window-rows", "4", "--disk-backup", "--no-capture-stderr",
         "train.py", "--", "--steps", "9"])
    assert (args.trace_max_steps, args.summary_window_rows, args.disk_backup, args.capture_stderr) == (3, 4, True, False)
    assert args.script_args[-2:] == ["--steps", "9"]
    defaults = cli._build_parser().parse_args(["run", "train.py"])
    assert (defaults.trace_max_steps, defaults.disk_backup, defaults.capture_stderr) == (None, None, None)
    assert cli.main(["view", str(session), "--format", "json"]) == 0
    assert json.loads(capsys.readouterr().out)["schema"]
    assert cli.main(["inspect", str(session / "rank_0" / "data"), "--domain", "process", "--limit", "1"]) == 0
    assert '"table": "process"' in capsys.readouterr().out


ENV_CASES = [
    {},
    {"trace_max_steps": 340, "disk_backup": True, "capture_stderr": False, "summary_window_rows": 40},
    {"trace_max_steps": 0, "capture_stderr": True, "summary_window_rows": 7},
]


@pytest.mark.parametrize("fields", ENV_CASES, ids=["defaults", "bounded", "zero_cap"])
def test_settings_round_trip_through_the_env_as_jax(fields):
    from traceml_tpu.runtime import settings as jax_settings
    from traceml_tpu_torch.runtime import settings

    keys = ("trace_max_steps", "disk_backup", "capture_stderr", "summary_window_rows")
    ours = settings.TraceMLSettings(session_id="s", mode="summary", **fields)
    theirs = jax_settings.TraceMLSettings(session_id="s", mode="summary", **fields)
    port_env, jax_env = settings.settings_to_env(ours), jax_settings.settings_to_env(theirs)
    assert {k: v for k, v in port_env.items() if k in jax_env} == {k: jax_env[k] for k in port_env}
    for env in (port_env, jax_env):
        back, jax_back = settings.settings_from_env(env), jax_settings.settings_from_env(env)
        assert {k: getattr(back, k) for k in keys} == {k: getattr(jax_back, k) for k in keys} == {
            k: getattr(ours, k) for k in keys}
    assert settings.ENV_MAX_STEPS == jax_settings.ENV_MAX_STEPS == "TRACEML_TRACE_MAX_STEPS"
    assert settings.ENV_SUMMARY_WINDOW_ROWS == jax_settings.ENV_SUMMARY_WINDOW_ROWS
    assert settings.ENV_DISK_BACKUP == jax_settings.ENV_DISK_BACKUP
    assert settings.ENV_CAPTURE_STDERR == jax_settings.ENV_CAPTURE_STDERR


@pytest.mark.parametrize("cli, env", [
    ({}, {}),
    ({"trace_max_steps": 5, "disk_backup": True, "capture_stderr": False, "summary_window_rows": 9}, {}),
    ({}, {"TRACEML_TRACE_MAX_STEPS": "12", "TRACEML_DISK_BACKUP": "1", "TRACEML_CAPTURE_STDERR": "0",
          "TRACEML_SUMMARY_WINDOW_ROWS": "33"}),
    ({"summary_window_rows": 2}, {"TRACEML_SUMMARY_WINDOW_ROWS": "33", "TRACEML_DISK_BACKUP": "no"}),
], ids=["defaults", "cli", "env", "cli_over_env"])
def test_resolve_settings_as_jax(cli, env, monkeypatch, tmp_path):
    from traceml_tpu.launcher.commands import resolve_settings as jax_resolve
    from traceml_tpu_torch.launcher.commands import resolve_settings

    monkeypatch.chdir(tmp_path)  # no yaml config around
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    keys = ("trace_max_steps", "disk_backup", "capture_stderr", "summary_window_rows")
    ours, theirs = resolve_settings(dict(cli)), jax_resolve(dict(cli))
    assert {k: getattr(ours, k) for k in keys} == {k: getattr(theirs, k) for k in keys}
