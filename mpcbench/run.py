#!/usr/bin/env python3
"""Run one cell of the benchmark of ``indy7_mpc_tpu_torch`` on the card.

    python3 mpcbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout; see ``mpcbench/harness.py``.
"""
import time

T0 = time.perf_counter()  # set-up is timed from here

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mpcbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t0=T0))
