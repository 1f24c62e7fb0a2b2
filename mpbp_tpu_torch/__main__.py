"""`python -m mpbp_tpu_torch` - CLI entry (see mpbp_tpu_torch/cli.py)."""

import sys

from mpbp_tpu_torch.cli import main

sys.exit(main())
