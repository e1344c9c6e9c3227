"""The run manifest.

Counterpart of the run-manifest half of ``traceml_tpu/launcher/manifest.py``
(the code manifest and its AST scan come later).  ``manifest.json`` in
the session directory records what was launched and how the run ended:
``status`` (starting → running → completed | failed) and
``telemetry_status`` (ok | degraded).
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Any, Dict, Optional

from traceml_tpu_torch.utils.atomic_io import atomic_write_json, read_json

STATUS_STARTING = "starting"
STATUS_RUNNING = "running"
STATUS_COMPLETED = "completed"
STATUS_FAILED = "failed"


def manifest_path(session_dir: Path) -> Path:
    return Path(session_dir) / "manifest.json"


def write_run_manifest(
    session_dir: Path,
    *,
    session_id: str,
    script: str,
    mode: str,
    world_size: int,
    status: str = STATUS_STARTING,
    extra: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    data = {
        "schema": 1,
        "session_id": session_id,
        "script": script,
        "mode": mode,
        "world_size": world_size,
        "status": status,
        "telemetry_status": "ok",
        "created_at": time.time(),
        "updated_at": time.time(),
        "artifacts": {
            "final_summary_json": str(Path(session_dir) / "final_summary.json"),
            "final_summary_txt": str(Path(session_dir) / "final_summary.txt"),
            "telemetry_db": str(Path(session_dir) / "telemetry.sqlite"),
        },
    }
    if extra:
        data.update(extra)
    atomic_write_json(manifest_path(session_dir), data)
    return data


def update_run_manifest(session_dir: Path, **fields: Any) -> None:
    data = read_json(manifest_path(session_dir), default={}) or {}
    data.update(fields)
    data["updated_at"] = time.time()
    atomic_write_json(manifest_path(session_dir), data)
