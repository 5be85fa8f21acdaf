"""``python -m repro_torch.analysis`` — the lint CLI (see `lint.main`)."""
import sys

from .lint import main

sys.exit(main())
