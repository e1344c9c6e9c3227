"""``python -m traceml_tpu_torch view``.

Counterpart of ``traceml_tpu/reporting/view/command.py`` (copied): print
a finished run's summary, the stored ``final_summary.txt`` (re-rendered
from the JSON when the text is missing) or, with ``--format json``, the
JSON.  The path is a session directory or its ``final_summary.json``.
"""

from __future__ import annotations

import json
from pathlib import Path

from traceml_tpu_torch.reporting.final import render_text_summary
from traceml_tpu_torch.utils.atomic_io import read_json


def _resolve_summary_path(path: Path) -> Path:
    path = Path(path)
    if path.is_dir():
        return path / "final_summary.json"
    return path


def run_view(path: Path, fmt: str = "text") -> int:
    target = _resolve_summary_path(path)
    data = read_json(target)
    if data is None:
        print(f"no readable summary at {target}")
        return 1
    if fmt == "json":
        print(json.dumps(data, indent=2))
        return 0
    txt = target.with_suffix(".txt")
    if txt.exists():
        print(txt.read_text())
    else:
        print(render_text_summary(data))
    return 0
