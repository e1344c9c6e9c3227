"""Session id generation.

Counterpart of ``traceml_tpu/runtime/session.py`` (copied).
"""

from __future__ import annotations

import datetime
import os
import re


def generate_session_id(run_name: str | None = None) -> str:
    ts = datetime.datetime.now().strftime("%Y%m%d_%H%M%S")
    suffix = os.urandom(2).hex()
    if run_name:
        safe = re.sub(r"[^A-Za-z0-9_.-]+", "-", run_name)[:48]
        return f"{safe}_{ts}_{suffix}"
    return f"session_{ts}_{suffix}"
