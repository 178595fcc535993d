"""``python -m madsim_tpu_torch.analysis``: the analysis CLI (analysis/cli.py)."""
import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
