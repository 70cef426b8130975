"""Run one cell of the benchmark of oceanbase_tpu_torch.

    python3 obbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for.  The last line of standard output is the result; see
``obbench/harness.py``.
"""

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# the checkout's root, not this folder, is where imports start
sys.path[0] = str(ROOT)

from obbench import guard  # noqa: E402

guard.pin_caches(ROOT)

from obbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
