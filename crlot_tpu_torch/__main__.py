"""`python -m crlot_tpu_torch` runs the demo showcase."""

import sys

from .demo import main

sys.exit(main())
