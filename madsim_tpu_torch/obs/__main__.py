"""``python -m madsim_tpu_torch.obs``: the observability CLI (obs/cli.py)."""
import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
