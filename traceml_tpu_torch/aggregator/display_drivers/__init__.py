"""Display drivers.

Counterpart of ``traceml_tpu/aggregator/display_drivers/``: ``cli`` is
the live Rich display, ``dashboard`` the browser dashboard, and any other
mode has no live UI.
"""

from traceml_tpu_torch.aggregator.display_drivers.base import (  # noqa: F401
    BaseDisplayDriver,
    SummaryDisplayDriver,
)


def resolve_display_driver(mode: str):
    """cli → the live Rich display; dashboard → the browser server;
    summary and any other mode → no live UI."""
    if mode == "cli":
        try:
            from traceml_tpu_torch.aggregator.display_drivers.cli import CLIDisplayDriver

            return CLIDisplayDriver()
        except Exception:
            return SummaryDisplayDriver()
    if mode == "dashboard":
        try:
            from traceml_tpu_torch.aggregator.display_drivers.browser import BrowserDisplayDriver

            return BrowserDisplayDriver()
        except Exception:
            return SummaryDisplayDriver()
    return SummaryDisplayDriver()
