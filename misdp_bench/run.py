"""Run one cell of the benchmark of ``scipsdp_tpu_torch`` on this machine.

    python3 misdp_bench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout that holds the package; ``BENCHMARK.json``
names the cells.  Exits 2 without a result where the machine has fewer
CUDA cards than the cell asks for, and 3 where a JAX module was loaded.
The program's build caches stay inside the checkout (``build/``).
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

# one process with few threads: steadier host timings; caches at fixed
# paths inside the checkout
for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ.setdefault(var, "4")
os.environ["TORCH_EXTENSIONS_DIR"] = (
    str(ROOT / "build" / "torch_extensions"))
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    sys.path.insert(0, str(ROOT))
    from misdp_bench import harness

    return harness.main(args, T_START)


if __name__ == "__main__":
    sys.exit(main())
