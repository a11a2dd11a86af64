"""Run one benchmark cell once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Runs from the root of a checkout on a machine with the cards the cell
asks for; exits non-zero, printing no result, without them. The last
line on standard output is the result (JSON); the last lines on standard
error are the numbers the correctness check compared, each with its
limit. See ``benchmark/harness.py``.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# kernel caches at fixed paths inside the checkout, so that only a
# checkout's first run builds
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = os.path.join(ROOT, ".bench_cache", sub)
sys.path[0] = ROOT   # not benchmark/: its modules are a package

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
