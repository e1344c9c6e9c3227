"""Final-summary request service.

Counterpart of ``traceml_tpu/aggregator/summary_service.py`` (copied).
Polled from the aggregator loop: when a rank drops
``control/final_summary_request.json``, settle the telemetry in flight
(drain and commit), generate the summary, write the response file.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

from traceml_tpu_torch.runtime.settings import TraceMLSettings
from traceml_tpu_torch.sdk import protocol
from traceml_tpu_torch.utils.error_log import get_error_log


class FinalSummaryService:
    def __init__(
        self,
        settings: TraceMLSettings,
        generate: Callable[[], bool],
        settle: Optional[Callable[[], None]] = None,
        poll_interval: float = 0.5,
    ) -> None:
        self._settings = settings
        self._generate = generate
        self._settle = settle
        self._poll_interval = poll_interval
        self._last_poll = 0.0
        self.requests_served = 0

    def poll(self) -> None:
        now = time.monotonic()
        if now - self._last_poll < self._poll_interval:
            return
        self._last_poll = now
        session_dir = self._settings.session_dir
        req = protocol.read_summary_request(session_dir)
        if req is None:
            return
        try:
            if self._settle is not None:
                self._settle()
            ok = self._generate()
            protocol.write_summary_response(session_dir, ok=ok)
            self.requests_served += 1
        except Exception as exc:
            get_error_log().error("final summary generation failed", exc)
            try:
                protocol.write_summary_response(session_dir, ok=False, error=str(exc))
            except Exception:
                pass
        finally:
            protocol.clear_request(session_dir)
