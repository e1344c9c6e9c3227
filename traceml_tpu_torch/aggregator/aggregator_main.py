"""Standalone aggregator process entry.

Counterpart of ``traceml_tpu/aggregator/aggregator_main.py``.  Launched
as ``python -m traceml_tpu_torch.aggregator.aggregator_main`` with the
``TRACEML_*`` environment: binds the TCP server (port 0 → ephemeral,
advertised in ``aggregator_ready.json`` with the dashboard's HTTP port
in ``dashboard`` mode), then runs until SIGTERM or
SIGINT, or until its parent dies, and finalizes on the way out.  A fatal
error lands in ``aggregator_error.log``.
"""

from __future__ import annotations

import signal
import sys
import threading
import traceback

from traceml_tpu_torch.aggregator.trace_aggregator import TraceMLAggregator, write_ready_file
from traceml_tpu_torch.runtime.settings import settings_from_env
from traceml_tpu_torch.utils.error_log import get_error_log
from traceml_tpu_torch.utils.orphan_watch import arm_parent_death_watch


def main() -> int:
    settings = settings_from_env()
    stop_evt = threading.Event()

    def _on_signal(signum, frame):  # noqa: ANN001
        stop_evt.set()

    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)
    # a launcher that dies without signalling must not leave this
    # process looping forever: parent death counts as SIGTERM
    arm_parent_death_watch(stop_evt.set)
    get_error_log().set_path(settings.session_dir / "aggregator_error.log")
    try:
        agg = TraceMLAggregator(settings)
        agg.start()
        write_ready_file(settings, agg.port, display_port=getattr(agg.display, "port", None))
        while not stop_evt.wait(0.25):
            pass
        agg.stop()
        return 0
    except Exception as exc:
        get_error_log().error("aggregator fatal", exc)
        try:
            path = settings.session_dir / "aggregator_error.log"
            path.parent.mkdir(parents=True, exist_ok=True)
            with open(path, "a", encoding="utf-8") as fh:
                fh.write("".join(traceback.format_exception(type(exc), exc, exc.__traceback__)))
        except OSError:
            pass
        return 1


if __name__ == "__main__":
    sys.exit(main())
