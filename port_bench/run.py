#!/usr/bin/env python3
"""Run one cell of the port's benchmark on the card this process sees:

    python3 port_bench/run.py --workload <cell> --seed <n> \\
        --seconds <s> --trace <0|1>

Prints one JSON line (`correct`, `attempted`, `failed`, `metrics`,
`device`, with `--trace 1` also `breakdown`, and last `checks`: each
compared number beside its limit, as the last lines of stderr too).
Exits 2 without a result when no CUDA card is found, 3 when JAX or the
JAX package was loaded. See `port_bench/__init__.py`.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

# the checkout's root, not this folder, on the path: the benchmark's
# modules are `port_bench.*` and shadow no other module
sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from port_bench import core  # noqa: E402

if __name__ == "__main__":
    sys.exit(core.main(sys.argv[1:], T_START, core.process_age_s()
                       - (time.perf_counter() - T_START)))
