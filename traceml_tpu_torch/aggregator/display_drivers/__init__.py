"""Display drivers.

Counterpart of ``traceml_tpu/aggregator/display_drivers/``.  The browser
driver of the ``dashboard`` mode comes in a later slice (ROADMAP queue 1
item 2), so ``dashboard`` resolves to no live UI here.
"""

from traceml_tpu_torch.aggregator.display_drivers.base import (  # noqa: F401
    BaseDisplayDriver,
    SummaryDisplayDriver,
)


def resolve_display_driver(mode: str):
    """cli → the live Rich display; summary and any other mode → no
    live UI."""
    if mode == "cli":
        try:
            from traceml_tpu_torch.aggregator.display_drivers.cli import CLIDisplayDriver

            return CLIDisplayDriver()
        except Exception:
            return SummaryDisplayDriver()
    return SummaryDisplayDriver()
