"""``python -m repro_torch.audit`` — run the static invariant audit."""
import sys

from .runner import main

sys.exit(main())
