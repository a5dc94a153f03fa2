"""Entry point of the port's benchmark; see `harness.py`.

    python3 benchmark/run.py --workload CELL --seed N --seconds S --trace 0|1
"""

import time

T_START = time.time()

import os  # noqa: E402
import sys  # noqa: E402

# the checkout's root, not this folder, leads the import path: the port and
# the `benchmark` package are found there, and no module of this folder can
# shadow a library module of the same name
sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(t_start=T_START))
