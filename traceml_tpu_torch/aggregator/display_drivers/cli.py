"""Rich Live CLI display driver.

Counterpart of ``traceml_tpu/aggregator/display_drivers/cli.py``.  Runs
inside the aggregator process, whose stdout is the launcher's: each
``tick`` recomputes the live payload from the session SQLite
(``LiveComputer``) and updates a Rich ``Live`` group.  On a terminal Rich
redraws it in place; on any other stdout Rich holds the frames and
prints the last one at ``stop``.  ``stop`` also closes the snapshot
store's read connection.
"""

from __future__ import annotations

from typing import Any, Optional

from traceml_tpu_torch.aggregator.display_drivers.base import BaseDisplayDriver
from traceml_tpu_torch.utils.error_log import get_error_log


class CLIDisplayDriver(BaseDisplayDriver):
    def __init__(self) -> None:
        self._live = None
        self._computer = None
        self._session = ""

    def start(self, context: Optional[Any] = None) -> None:
        try:
            from rich.console import Console
            from rich.live import Live

            from traceml_tpu_torch.renderers.compute import LiveComputer

            if context is not None:
                self._computer = LiveComputer(context.db_path)
                self._session = context.settings.session_id
            self._live = Live(console=Console(stderr=False), refresh_per_second=4, transient=False)
            self._live.start()
        except Exception as exc:
            get_error_log().warning("cli display start failed", exc)
            self._live = None

    def tick(self, context: Optional[Any] = None) -> None:
        if self._live is None or self._computer is None:
            return
        try:
            from traceml_tpu_torch.renderers.panels import dashboard

            payload = self._computer.payload()
            self._live.update(dashboard(payload, self._session))
        except Exception as exc:
            get_error_log().warning("cli display tick failed", exc)

    def stop(self) -> None:
        if self._live is not None:
            try:
                self._live.stop()
            except Exception:
                pass
            self._live = None
        if self._computer is not None:
            try:
                self._computer.close()  # release the store's read connection
            except Exception:
                pass
            self._computer = None
