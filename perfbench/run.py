"""Run one cell of BENCHMARK.json on the card and print one JSON line.

    python3 perfbench/run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

From the root of a checkout.  Exits non-zero, with no result, where
there is no card, too few cards, or the port is missing.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _paths() -> None:
    """The checkout's root (for ``perfbench``) and ``src`` (for the
    port) on ``sys.path``; every cache of a build inside the checkout;
    one host thread for PyTorch's CPU operations."""
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    cache = ROOT / "build" / "perfbench"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(cache / "torch_extensions"))
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")


if __name__ == "__main__":
    _paths()
    from perfbench.harness import main

    sys.exit(main(sys.argv[1:], T_START))
