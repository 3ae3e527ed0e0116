"""Test-only entry: one run of a tiny cut of a cell on the CPU, through the
harness's code and the port's plain kernel versions. Its line names the
CPU and carries no device metric.

    python3 perfbench/tests/cpu_run.py <cell> <seed> <seconds>
"""

import os
import sys
import time

T_START = time.perf_counter()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def main(argv) -> int:
    from perfbench import harness
    from perfbench.tests.tiny import tiny_cell

    name, seed, seconds = argv[0], int(argv[1]), float(argv[2])
    result = harness.run_cell(name, seed, seconds, True, "cpu", T_START,
                              cell=tiny_cell(name))
    return harness.emit(result)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
