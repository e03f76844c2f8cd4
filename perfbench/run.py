"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``; ``breakdown`` with
``--trace 1``; ``checks`` last); the numbers that decide ``correct`` go
to standard error as its last lines. Without enough CUDA cards the run
exits with 2 and prints no result.
"""

import time

T_START = time.monotonic()

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# the script's own folder is no place to import from: its sub-folders
# would shadow top-level modules of the same name
sys.path[:] = [ROOT] + [p for p in sys.path
                        if os.path.abspath(p or os.curdir) not in (HERE, ROOT)]

from perfbench.lib.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(ROOT, T_START))
