"""Display-driver protocol.

Counterpart of ``traceml_tpu/aggregator/display_drivers/base.py``
(copied).
"""

from __future__ import annotations

from typing import Any, Optional


class BaseDisplayDriver:
    """start/tick/stop; tick is rate-limited by the aggregator loop."""

    def start(self, context: Optional[Any] = None) -> None: ...

    def tick(self, context: Optional[Any] = None) -> None: ...

    def stop(self) -> None: ...


class SummaryDisplayDriver(BaseDisplayDriver):
    """No live UI (the summary mode)."""
