"""``python -m traceml_tpu_torch`` → the command line."""

import sys

from traceml_tpu_torch.launcher.cli import main

if __name__ == "__main__":
    sys.exit(main())
