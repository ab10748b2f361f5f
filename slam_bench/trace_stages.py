"""One traced run of a cell, with what the result line does not carry yet:
the idle gaps by the program's own stages, the check that the program's
spans and the device's events share a clock, and the tracer's cost.

    python3 slam_bench/trace_stages.py --workload <cell> --seed <n> --seconds <s> [--out <file>]

It runs the harness's traced run (``--trace 1``: the same window, readers
and check), keeps the run's device timeline, and prints one JSON line: the
result line's object, plus ``idle_gaps_by_stage`` (``stages.py``) beside the
breakdown's two keys, ``clock_check``, the port tracer's ``spans_per_scan``
and its cost a span (``span_us`` on, ``noop_us`` off), and ``run_s``, the
run's length.  ``--out`` writes the tracer's summary table there too.
Like ``run.py``, it exits with 2 and prints no result without a CUDA
device, and prints none if the process holds a forbidden module.
"""
import argparse
import json
import os
import pathlib
import sys
import time

T0 = time.perf_counter()
ROOT = pathlib.Path(__file__).resolve().parents[1]
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton_cache"))
sys.path[0] = str(ROOT)

from slam_bench import harness, spec, stages  # noqa: E402


def span_cost_us(timing, n: int = 100000):
    """Mean µs of one empty span with the tracer on, and with it off."""
    out = []
    for on in (True, False):
        (timing.enable if on else timing.disable)()
        t = time.perf_counter()
        for _ in range(n):
            with timing.span("cost"):
                pass
        out.append((time.perf_counter() - t) / n * 1e6)
    timing.disable()
    return out


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"trace_stages: {args.workload} needs {cell.chips} CUDA device(s)",
              file=sys.stderr)
        return 2
    from open3d_slam_advanced_rss_2024_public_tpu_torch.utils import timing

    kept = {}
    measure = harness.measure

    def keeping(*a, **k):
        kept["m"] = measure(*a, **k)
        return kept["m"]

    harness.measure = keeping
    result = harness.run_cell(cell, args.seed, args.seconds, True, "cuda", T0)
    m, rec = kept["m"], timing.records()
    result["breakdown"]["idle_gaps_by_stage"] = stages.idle_gaps_by_stage(m.timeline, rec)
    result["clock_check"] = stages.clock_check(m.timeline, rec, m.calls.start.get("nn", 0))
    result["spans_per_scan"] = len(rec["spans"]) / max(len(m.window.step_s), 1)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(timing.summary() + "\n")
    timing.reset()
    result["span_us"], result["noop_us"] = span_cost_us(timing)
    timing.reset()
    result["run_s"] = time.perf_counter() - T0
    found = harness.forbidden_modules()
    if found:
        print(f"trace_stages: the process holds {found}; no result", file=sys.stderr)
        return 4
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
