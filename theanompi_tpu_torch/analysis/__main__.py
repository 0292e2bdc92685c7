"""``python -m theanompi_tpu_torch.analysis`` — see ``cli.py``."""

import sys

from theanompi_tpu_torch.analysis.cli import main

if __name__ == "__main__":
    sys.exit(main())
