"""Run one cell of the benchmark of zkvm_tpu_torch on this machine's card(s).

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

See `benchmark/harness/core.py`; the cells are listed in BENCHMARK.json.
"""

import sys
import time

T_START = time.monotonic()

if __name__ == "__main__":
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from benchmark.harness.core import main

    sys.exit(main(T_START))
