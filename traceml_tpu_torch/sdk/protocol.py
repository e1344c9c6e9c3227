"""The final summary's file protocol.

Counterpart of ``traceml_tpu/sdk/protocol.py`` (copied).  A rank and the aggregator share
only the session directory: the final-summary request and response are a
pair of atomic JSON files in ``<session>/control/``, and the artifacts
live at canonical paths.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Any, Dict, Optional

from traceml_tpu_torch.utils.atomic_io import atomic_write_json, read_json

REQUEST_FILE = "final_summary_request.json"
RESPONSE_FILE = "final_summary_response.json"
SUMMARY_JSON = "final_summary.json"
SUMMARY_TXT = "final_summary.txt"
SUMMARY_HTML = "final_summary.html"


def control_dir(session_dir: Path) -> Path:
    return Path(session_dir) / "control"


def request_path(session_dir: Path) -> Path:
    return control_dir(session_dir) / REQUEST_FILE


def response_path(session_dir: Path) -> Path:
    return control_dir(session_dir) / RESPONSE_FILE


def get_final_summary_json_path(session_dir: Path) -> Path:
    return Path(session_dir) / SUMMARY_JSON


def get_final_summary_txt_path(session_dir: Path) -> Path:
    return Path(session_dir) / SUMMARY_TXT


def get_final_summary_html_path(session_dir: Path) -> Path:
    return Path(session_dir) / SUMMARY_HTML


def write_summary_request(session_dir: Path, requester_rank: int = 0) -> None:
    atomic_write_json(
        request_path(session_dir),
        {"requested_at": time.time(), "requester_rank": requester_rank},
    )


def read_summary_request(session_dir: Path) -> Optional[Dict[str, Any]]:
    return read_json(request_path(session_dir))


def write_summary_response(session_dir: Path, ok: bool, error: Optional[str] = None) -> None:
    atomic_write_json(
        response_path(session_dir),
        {"completed_at": time.time(), "ok": ok, "error": error},
    )


def read_summary_response(session_dir: Path) -> Optional[Dict[str, Any]]:
    return read_json(response_path(session_dir))


def clear_request(session_dir: Path) -> None:
    try:
        request_path(session_dir).unlink()
    except OSError:
        pass
