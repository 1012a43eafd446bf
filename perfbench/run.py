"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

See perfbench/README.md.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# one process on four fixed cores of the eight an H100 machine gives, past
# the first two (where the system's own work lands): the server's and the
# harness's threads hand the interpreter to each other on fewer cores, and
# a served cell runs faster and steadier so (PERF.md, section 6)
CPUS = sorted(os.sched_getaffinity(0))
if len(CPUS) >= 6:
    os.sched_setaffinity(0, CPUS[2:6])
# every cache of the program inside the checkout, at fixed paths
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "perfbench" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "perfbench" / "torch_extensions")
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench.harness.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
