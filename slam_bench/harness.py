"""One run of one cell: set-up, the measured window, the check against the
plain reference, and the result line.  ``run.py`` is the entry point."""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from typing import Optional

import numpy as np

from . import checking, session, spec, tracing, traffic_gen

FORBIDDEN = ("jax", "jaxlib", "flax", "open3d_slam_advanced_rss_2024_public_tpu")
# One call in this many keeps its inputs for the roofline: K1 runs every
# ICP trip, K2 about once a scan.
SAMPLE_EVERY = {"nn": 64, "moments": 4}


class Context:
    """What the metric readers read."""

    def __init__(self, window, setup_s, spans=None, timeline=None, calls=None):
        self.window, self.setup_s = window, setup_s
        self.spans, self.timeline, self.calls = spans, timeline, calls

    def layer_ms(self, layer: str) -> Optional[float]:
        if self.spans is None or not self.spans.calls.get(layer) or not self.window.step_s:
            return None
        return self.spans.seconds[layer] / len(self.window.step_s) * 1e3

    def busy_s(self) -> float:
        return tracing.busy_seconds(self.timeline)

    def roofline_pct(self, kernel: str) -> Optional[float]:
        if self.timeline is None or self.calls is None:
            return None
        return tracing.roofline_pct(self.timeline, self.calls, kernel)


def process_age_s() -> Optional[float]:
    """Seconds since this process started, from /proc (None elsewhere)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return None


def power_limit_w() -> Optional[float]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=30, check=True).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def ate_m(trajectory: np.ndarray, truth: np.ndarray) -> float:
    """Translation RMSE with the first poses aligned."""
    A = truth[0] @ np.linalg.inv(trajectory[0])
    est = np.einsum("ij,njk->nik", A, trajectory)[:, :3, 3]
    return float(np.sqrt(((est - truth[:len(est), :3, 3]) ** 2).sum(-1).mean()))


@dataclasses.dataclass
class Measured:
    window: object
    capture: session.Capture
    seq: traffic_gen.Sequence
    setup_s: float
    peak_bytes: int
    data_dir: str
    spans: object = None
    timeline: object = None
    calls: object = None


def measure(cell: spec.Cell, seed: int, seconds: float, trace: bool, device: str,
            t0: float, data_root: Optional[str] = None) -> Measured:
    """Set-up and the window: the world and sequence from the seed (with
    what the configuration's extensions prepare), the warm-up, missions for
    ``seconds`` (traced: spans, sampled kernel calls and the profiler), then
    the peak memory read and the program's missions freed."""
    import torch

    from open3d_slam_advanced_rss_2024_public_tpu_torch.utils.config import load_parameters

    cuda = device != "cpu"
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.reset_peak_memory_stats()
    config, traffic = cell.config, cell.traffic
    params = load_parameters(config["parameters"])
    exts = spec.extensions(config, cell.root)
    data_dir = os.path.join(data_root or tempfile.gettempdir(), "slam_bench", cell.name)
    seq = traffic_gen.generate(config, traffic, seed, data_dir, device, exts)
    s_pick = traffic_gen.seeds(seed, 4)[traffic_gen.CHECK_STREAM]
    picks = np.random.default_rng(s_pick).choice(np.arange(2, len(seq.truth)),
                                                 size=traffic["check_scans"], replace=False)
    capture = session.Capture(picks, exts)
    session.warm_up(params, seq, config, device, traffic["warmup_scans"], exts)
    spans = calls = prof = None
    if trace:
        spans = session.Spans(traced=True)
        calls = tracing.KernelCalls(SAMPLE_EVERY, int(s_pick.generate_state(1)[0]))
        calls.install()
        prof = tracing.profiler()
    setup = {}

    def start():
        if prof is not None:
            prof.start()
            session.sync(device)
        setup["s"] = time.perf_counter() - t0

    window = session.run_window(params, seq, config, device, seconds, spans, capture,
                                on_start=start)
    timeline = None
    if prof is not None:
        t_read = time.perf_counter()
        prof.stop()
        t_stop = time.perf_counter()
        timeline = tracing.timeline(prof, window.window_s, spans.marks)
        print(f"trace: {len(timeline.device)} device events; profiler stop "
              f"{t_stop - t_read:.1f} s, read {time.perf_counter() - t_stop:.1f} s",
              file=sys.stderr)
    peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return Measured(window, capture, seq, setup["s"], peak, data_dir, spans, timeline, calls)


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, device: str,
             t0: float, data_root: Optional[str] = None) -> dict:
    """The whole run after the look for a chip; returns the result line's
    object (``correct`` false where a compared number is past its limit)."""
    import torch

    m = measure(cell, seed, seconds, trace, device, t0, data_root)
    window, capture, seq, timeline = m.window, m.capture, m.seq, m.timeline
    ctx = Context(window, m.setup_s, m.spans, timeline, m.calls)
    metrics = spec.read_metrics(cell.per_layer if trace else cell.end_to_end, ctx, cell.root)
    readings = checking.judge(capture, seq, cell.config, device)
    correct, rows = checking.verdict(readings, cell.config["limits"])
    for mission in capture.missions:
        if mission["complete"]:
            print(f"mission {mission['mission']}: {len(mission['trajectory'])} scans, "
                  f"{mission['closures']} closures, {mission['submaps']} submaps, "
                  f"ATE {ate_m(mission['trajectory'], seq.truth):.4f} m", file=sys.stderr)
    print("samples: " + ", ".join(f"{x.mission}/{x.index} {x.why_not or 'judged'}"
                                  for x in capture.scans), file=sys.stderr)
    if len(window.step_s) >= 2:
        cuts = statistics.quantiles([1e3 * x for x in window.step_s], n=100)
        print("step ms: " + ", ".join(f"p{q} {cuts[q - 1]:.1f}" for q in (50, 75, 90, 95, 99))
              + f", max {1e3 * max(window.step_s):.1f}", file=sys.stderr)
    print(f"window: {len(window.step_s)} scans in {window.window_s} s over "
          f"{window.missions} missions; sequence {seq.bytes_written} bytes", file=sys.stderr)
    shutil.rmtree(m.data_dir, ignore_errors=True)
    cuda = device != "cpu"
    result = {"correct": bool(correct), "attempted": window.attempted, "failed": window.failed,
              "metrics": metrics}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": m.peak_bytes,
           "power_limit_w": power_limit_w() if cuda else None}
    if timeline is not None:
        dev["busy_s"] = tracing.busy_seconds(timeline)
        dev["window_s"] = timeline.window_s
        result["breakdown"] = tracing.breakdown(timeline)
    result["device"] = dev
    result["check"] = {name: {"value": value, "limit": limit} for name, value, limit in rows}
    for name, value, limit in rows:
        bound = "at least" if name == "scans_judged" else "at most"
        print(f"check {name} {value!r} {bound} {limit!r}", file=sys.stderr)
    return result


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv, t0: float) -> int:
    ap = argparse.ArgumentParser(description="One run of one benchmark cell.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"slam_bench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", t0)
    found = forbidden_modules()
    if found:
        print(f"slam_bench: the process holds {found}; no result", file=sys.stderr)
        return 4
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
