"""Canonical artifact paths of a session.

Counterpart of ``traceml_tpu/sdk/protocol.py``, trimmed to the final
summary's paths (the worker-side summary request/response files come
with the aggregator's summary service).
"""

from __future__ import annotations

from pathlib import Path

SUMMARY_JSON = "final_summary.json"
SUMMARY_TXT = "final_summary.txt"


def get_final_summary_json_path(session_dir: Path) -> Path:
    return Path(session_dir) / SUMMARY_JSON


def get_final_summary_txt_path(session_dir: Path) -> Path:
    return Path(session_dir) / SUMMARY_TXT
