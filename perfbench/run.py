#!/usr/bin/env python3
"""Run one cell of the port's benchmark (``BENCHMARK.json``) once.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints one JSON line on stdout (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, in a traced run ``breakdown``, and last
``checks``: each number compared with its limit) and the checks as the
last lines of stderr; exits non-zero, printing no line, without a CUDA
device or when a JAX module is loaded.  See ``harness.py``.
"""

import sys
import time
from pathlib import Path

_NOW = time.perf_counter()
ROOT = Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)

from perfbench import harness  # noqa: E402

if __name__ == "__main__":
    # the process's start on the perf_counter clock
    started = min(_NOW, time.perf_counter() - harness.process_age_s())
    sys.exit(harness.main(sys.argv[1:], started=started))
