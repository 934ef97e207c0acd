"""``python -m tpu_cooccurrence_torch`` runs the CLI."""

import sys

from .cli import main

sys.exit(main())
