"""The benchmark's command: one run of one cell (see `harness.py`).

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

Run from the root of a checkout of the repository.
"""

import time

STARTED = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

if __name__ == "__main__":
    # the checkout's root in place of this directory, so that the
    # benchmark's modules are found as `portbench.*` only
    root = Path(__file__).resolve().parent.parent
    sys.path[0] = str(root)
    from portbench import harness
    sys.exit(harness.run(sys.argv[1:], root=root, started=STARTED))
