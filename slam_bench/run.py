"""The benchmark's one command: one run of one cell of ``BENCHMARK.json``.

    python3 slam_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It makes the cell's world and sequence from the seed, warms up one short
session, replays missions through the port's offline stepper for
``--seconds`` and prints one JSON line: the cell's end-to-end metrics
(``--trace 0``) or its per-layer metrics (``--trace 1``), whether the
window's answers agree with the plain reference, and the device.  Without
a CUDA device it exits with 2 and prints no result.
"""
import os
import pathlib
import sys
import time

T0 = time.perf_counter()
ROOT = pathlib.Path(__file__).resolve().parents[1]
# Caches live at fixed places inside the checkout.
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton_cache"))
sys.path[0] = str(ROOT)

from slam_bench import harness  # noqa: E402

if __name__ == "__main__":
    age = harness.process_age_s()
    started = time.perf_counter() - age if age is not None else T0
    sys.exit(harness.main(sys.argv[1:], started))
