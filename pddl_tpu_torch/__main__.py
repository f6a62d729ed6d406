"""``python -m pddl_tpu_torch`` — the CLI entry (see :mod:`pddl_tpu_torch.run`)."""

import sys

from pddl_tpu_torch.run import main

sys.exit(main())
