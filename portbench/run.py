"""Run one cell of the port's benchmark once, on the cards of this machine.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. ``BENCHMARK.json`` names the cells. Build and
kernel caches stay in the checkout's ``build/``.
"""

import time

T_PROCESS = time.monotonic()

import sys  # noqa: E402

from harness import env  # noqa: E402

if __name__ == "__main__":
    env.prepare()
    from harness.cli import main

    sys.exit(main(sys.argv[1:], T_PROCESS))
