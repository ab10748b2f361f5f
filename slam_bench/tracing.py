"""The traced run: the profiler's device timeline, reduced to what the
per-layer readers and the breakdown read, and the sampled calls of the two
hand-written kernels whose least work the rooflines compare with their
device time.
"""
from __future__ import annotations

import bisect
import collections
import dataclasses
from typing import Dict, List, Optional

import torch

from . import roofline

# Kernel names in the device trace: each sweep, and the tile kernels that
# plan for it (attributed to the next sweep on the stream).
SWEEPS = {"nn": "nn_sweep_kernel", "moments": "moments_sweep_kernel"}
TILE_KERNELS = ("tile_plan_kernel", "tile_prepare_kernel")


@dataclasses.dataclass
class Call:
    kernel: str
    sweep: int            # index of the call's first sweep launch in the window
    sweeps: int           # sweep launches the call enqueued
    inputs: tuple


class KernelCalls:
    """Wraps the entry points of K1 (``ops.cuda_nn.nn``) and K2
    (``ops.cuda_moments.radius_moments``) and keeps the inputs of every
    ``every[kernel]``-th call, counted from ``offset``.  A program without
    them leaves the roofline readers silent."""

    def __init__(self, every: Dict[str, int], offset: int):
        self.every, self.offset = every, offset
        self.calls: List[Call] = []
        self.start: Dict[str, int] = {}
        self.present: Dict[str, bool] = {}
        self._modules: Dict[str, object] = {}

    def install(self) -> None:
        from open3d_slam_advanced_rss_2024_public_tpu_torch.ops import cuda_moments, cuda_nn

        self._wrap(cuda_nn, "nn", "nn", lambda a, k: (a[0], getattr(a[1], "points", a[1]),
                                                      a[2] if len(a) > 2 else k.get("max_dist", 0.5)))
        self._wrap(cuda_moments, "radius_moments", "moments", lambda a, k: (a[0], a[1], a[2]))

    def _wrap(self, module, attr: str, kernel: str, keep) -> None:
        fn = getattr(module, attr, None)
        self.present[kernel] = fn is not None and hasattr(module, "launches")
        if not self.present[kernel]:
            return
        self.start[kernel] = module.launches
        count = [0]

        def wrapped(*args, **kwargs):
            i = count[0]
            count[0] += 1
            before = module.launches
            out = fn(*args, **kwargs)
            if (i + self.offset) % self.every[kernel] == 0:
                self.calls.append(Call(kernel, before - self.start[kernel],
                                       module.launches - before, keep(args, kwargs)))
            return out

        setattr(module, attr, wrapped)
        self._modules[kernel] = module

    def launches(self, kernel: str) -> int:
        return self._modules[kernel].launches - self.start[kernel]


def _ns(e, what: str) -> float:
    for name, scale in ((f"{what}_ns", 1.0), (f"{what}_us", 1e3)):
        f = getattr(e, name, None)
        if f is not None:
            return float(f()) * scale
    raise AttributeError(what)


@dataclasses.dataclass
class Timeline:
    device: List[tuple]          # (start_ns, end_ns, name), by start
    spans: List[tuple]           # host layer spans (start_ns, end_ns, layer), by start
    window_s: float


def profiler():
    """The device's activity alone: kernels, copies and fills.  The layer
    spans come from the benchmark's own clock (``session.Spans.marks``), so
    the profiler records no host operations, the bulk of a window's events
    and of the time it takes to read them."""
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])


def timeline(prof, window_s: float, marks: List[tuple]) -> Timeline:
    device = []
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != cuda:
            continue
        name = e.name()
        start = _ns(e, "start")
        device.append((start, start + _ns(e, "duration"), name))
    device.sort()
    return Timeline(device, sorted(marks), window_s)


def busy(tl: Timeline):
    """Merged busy intervals of the device."""
    merged = []
    for s, e, _ in tl.device:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def busy_seconds(tl: Timeline) -> float:
    return sum(e - s for s, e in busy(tl)) * 1e-9


def breakdown(tl: Timeline, top: int = 10) -> dict:
    by_op = collections.defaultdict(float)
    for s, e, name in tl.device:
        by_op[name] += (e - s) * 1e-9
    starts = [s for s, _, _ in tl.spans]
    by_host = collections.defaultdict(float)
    merged = busy(tl)
    for (_, a), (b, _) in zip(merged, merged[1:]):
        mid = (a + b) / 2
        i = bisect.bisect_right(starts, mid) - 1
        layer = tl.spans[i][2] if i >= 0 and tl.spans[i][1] >= mid else "outside the layer spans"
        by_host[layer] += (b - a) * 1e-9
    rank = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": rank(by_op), "idle_gaps": rank(by_host)}


def sweep_times(tl: Timeline) -> Dict[str, List[float]]:
    """Device seconds of each sweep launch in stream order, with the tile
    kernels launched since the previous sweep."""
    out = {k: [] for k in SWEEPS}
    pending = 0.0
    for s, e, name in tl.device:
        if any(t in name for t in TILE_KERNELS):
            pending += (e - s) * 1e-9
            continue
        for kernel, sweep in SWEEPS.items():
            if sweep in name:
                out[kernel].append((e - s) * 1e-9 + pending)
                pending = 0.0
    return out


def roofline_pct(tl: Timeline, calls: KernelCalls, kernel: str) -> Optional[float]:
    """100 x the sampled calls' least seconds over their device seconds;
    None where the trace does not hold one sweep event per launch."""
    if not calls.present.get(kernel):
        return None
    times = sweep_times(tl)[kernel]
    if not times or len(times) != calls.launches(kernel):
        return None
    least = device = 0.0
    for c in calls.calls:
        if c.kernel != kernel or c.sweeps == 0:
            continue
        work = roofline.nn_work(*c.inputs) if kernel == "nn" else roofline.moments_work(*c.inputs)
        least += roofline.least_seconds(*work)
        device += sum(times[c.sweep:c.sweep + c.sweeps])
    return 100.0 * least / device if device > 0 else None
