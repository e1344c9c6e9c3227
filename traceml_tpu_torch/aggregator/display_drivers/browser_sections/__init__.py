"""The dashboard's section system.

Counterpart of ``traceml_tpu/aggregator/display_drivers/browser_sections/``
(copied): each section is a module contributing a static HTML fragment,
a JS render function and a declared payload contract; ``pages.py``
assembles them once, at import, into the single self-contained page the
stdlib server ships.  The contract (the payload paths the JS reads) is
what the contract tests hold against a real ``build_web_payload``, so a
renamed payload key breaks a test, not the page.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple


@dataclass(frozen=True)
class Section:
    """One dashboard section: static fragment + render fn + contract."""

    id: str                      # DOM id of the section root
    title: str                   # card title
    html: str                    # static HTML fragment (placed by pages)
    js: str                      # JS: defines render_<id>(d) (d = payload)
    contract: Tuple[str, ...] = field(default_factory=tuple)
    # payload paths the JS reads, dot-separated ("step_time.phases");
    # verified against build_web_payload by the contract tests


def render_call(section: Section) -> str:
    """The JS call pages.py emits for one section per tick."""
    return f"render_{section.id}(d);"
