"""``python -m retina_tpu_torch`` → the retina-tpu-torch CLI."""

import sys

from retina_tpu_torch.cli import main

sys.exit(main())
