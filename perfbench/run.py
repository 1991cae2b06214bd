"""One run of one cell of the port's benchmark.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout that holds BENCHMARK.json, perfbench/ and
the port (lsenerf_tpu_torch/). It needs a CUDA card (exit 2 without one)
and prints its result as the last line of standard output
(perfbench/harness/core.py)."""

import os
import sys
import time

T0 = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path[0] != ROOT:
    sys.path.insert(0, ROOT)

if __name__ == "__main__":
    from pathlib import Path

    from perfbench.harness import core, env

    env.set_caches(Path(ROOT))
    sys.exit(core.main(t0=T0))
