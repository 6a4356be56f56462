"""``python3 -m lbmbench``: the start of the process's set-up is taken
here, before anything heavy is imported."""

import time

T0 = time.perf_counter()

import sys  # noqa: E402

from lbmbench.run import main  # noqa: E402

sys.exit(main(sys.argv[1:], t0=T0))
