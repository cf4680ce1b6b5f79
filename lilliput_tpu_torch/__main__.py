"""``python -m lilliput_tpu_torch``: the port's command line (cli.py)."""

import sys

from .cli import main

sys.exit(main())
