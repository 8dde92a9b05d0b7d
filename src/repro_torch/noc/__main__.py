"""``python -m repro_torch.noc`` — dispatch to the CLI (repro_torch.noc.cli)."""

import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
