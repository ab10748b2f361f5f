"""Readings for the limits of ``correct``: for each seed, one window of the
cell and then the same comparison read twice, once of the program's answers
and once of the control's (the reference with the configuration's guarantee
broken: every registration and solve returns its starting value), the
numbers of the configuration's extensions among them.  One JSON line a seed
on standard output.  Not part of a benchmark run.

    python3 slam_bench/control.py --workload <cell> --seeds 11,12,13 --seconds 40
"""
import argparse
import gc
import json
import pathlib
import shutil
import sys
import time

if __name__ == "__main__":
    sys.path[0] = str(pathlib.Path(__file__).resolve().parents[1])

from slam_bench import checking, harness, spec  # noqa: E402


def read_seed(cell: spec.Cell, seed: int, seconds: float, device: str,
              data_root: str = None) -> dict:
    """One seed's row: a window of the cell, then the program's and the
    control's readings of its samples."""
    m = harness.measure(cell, seed, seconds, False, device, time.perf_counter(), data_root)
    details = []
    t0 = time.perf_counter()
    program = checking.judge(m.capture, m.seq, cell.config, device, details=details)
    judge_s = time.perf_counter() - t0
    row = {"workload": cell.name, "seed": seed, "scans": len(m.window.step_s),
           "missions": m.window.missions, "setup_s": m.setup_s, "judge_s": judge_s,
           "why_not": [x.why_not for x in m.capture.scans if x.why_not],
           "program": program,
           "control": checking.judge(m.capture, m.seq, cell.config, device, control=True),
           "details": details,
           "mission_stats": [{k: v for k, v in x.items() if k != "trajectory"}
                             for x in m.capture.missions],
           "closures": [x["closures"] for x in m.capture.missions if x["complete"]],
           "ate_m": [harness.ate_m(x["trajectory"], m.seq.truth)
                     for x in m.capture.missions if x["complete"]]}
    shutil.rmtree(m.data_dir, ignore_errors=True)
    return row


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated whole numbers")
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("control.py needs a CUDA device", file=sys.stderr)
        return 2
    cell = spec.cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(read_seed(cell, seed, args.seconds, "cuda")), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
