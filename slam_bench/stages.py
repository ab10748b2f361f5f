"""The program's own spans and counters (the port's ``utils/timing.py``),
read against the profiler's device timeline.

The port's tracer records while a torch profiler session records, so a
traced run's window leaves its spans and counter totals in the process: a
span is (name, parent, scan, thread, start_ns, end_ns, launches) on the
wall clock of the profiler's device events.  ``records(ctx)`` takes them
from the ``Context`` where it carries them, else from the port's tracer; a
program without that tracer leaves every reader here silent.

- ``idle_gaps_by_stage``: each idle gap between the device's busy intervals
  goes to the innermost span open on the stepping thread at the gap's
  midpoint; where that is ``mapper/flush_wait`` (the stepping thread waits
  for the Mapper's reader thread), to the innermost span open on the
  reader thread instead; where neither thread has one open, to
  ``OUTSIDE``.
- ``clock_check``: each K1 sweep is paired, by its launch index, with the
  span that enqueued it (the spans that note ``cuda_nn.launches``); no
  sweep may start before that span's start.
"""
from __future__ import annotations

import collections
import importlib
import statistics
from typing import Dict, List, Optional

from . import tracing

PORT_TIMING = "open3d_slam_advanced_rss_2024_public_tpu_torch.utils.timing"
READER_THREAD = "mapper-readback"   # the Mapper's reader thread
FLUSH_WAIT = "mapper/flush_wait"
OUTSIDE = "outside the program spans"
ENQUEUE = ("mapper/dispatch", "odometry/register")


def records(ctx) -> Optional[dict]:
    """``{"spans": [...], "counts": {...}}``, or None where there is none."""
    rec = getattr(ctx, "records", None)
    if rec is None:
        try:
            fn = getattr(importlib.import_module(PORT_TIMING), "records", None)
        except ImportError:
            fn = None
        rec = fn() if fn is not None else None
    if not rec or not (rec.get("spans") or rec.get("counts")):
        return None
    return rec


def span_ms_per_scan(ctx, name: str) -> Optional[float]:
    """Mean ms a scan of the window in the spans called ``name``."""
    rec = records(ctx)
    if rec is None or not ctx.window.step_s:
        return None
    ns = [s[5] - s[4] for s in rec["spans"] if s[0] == name]
    if not ns:
        return None
    return sum(ns) * 1e-6 / len(ctx.window.step_s)


def active_trips_pct(ctx, layer: str) -> Optional[float]:
    """100 x the ICP trips that moved the pose over the trips enqueued."""
    rec = records(ctx)
    if rec is None:
        return None
    dispatched = rec["counts"].get(f"{layer}/icp_trips_dispatched", 0)
    if not dispatched:
        return None
    return 100.0 * rec["counts"].get(f"{layer}/icp_trips_active", 0) / dispatched


def idle_gaps(tl) -> List[tuple]:
    """The device's idle gaps between its busy intervals, in order."""
    merged = tracing.busy(tl)
    return [(a, b) for (_, a), (b, _) in zip(merged, merged[1:])]


def _merged(intervals) -> List[list]:
    out: List[list] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def idle_in_spans_pct(tl, spans, names) -> Optional[float]:
    """100 x the idle time inside the union of the spans called ``names``
    over all the idle time between busy intervals."""
    gaps = idle_gaps(tl)
    total = sum(b - a for a, b in gaps)
    if total <= 0:
        return None
    union = _merged([(s[4], s[5]) for s in spans if s[0] in names])
    inside, j = 0, 0
    for a, b in gaps:
        while j < len(union) and union[j][1] <= a:
            j += 1
        k = j
        while k < len(union) and union[k][0] < b:
            inside += min(b, union[k][1]) - max(a, union[k][0])
            k += 1
    return 100.0 * inside / total


def _innermost(spans) -> List[tuple]:
    """One thread's spans as (start, end, name) segments of the innermost
    span open, in order."""
    events = []
    for i, s in enumerate(spans):
        events.append((s[4], 1, -s[5], i))
        events.append((s[5], 0, 0, i))
    events.sort()
    segments, stack, last = [], [], None
    for t, opening, _, i in events:
        if stack and last is not None and t > last:
            segments.append((last, t, spans[stack[-1]][0]))
        if opening:
            stack.append(i)
        elif i in stack:
            stack.remove(i)
        last = t
    return segments


class _Cursor:
    """The innermost span at increasing times over one thread's segments."""

    def __init__(self, segments):
        self.segments, self.i = segments, 0

    def at(self, t) -> Optional[str]:
        seg = self.segments
        while self.i < len(seg) and seg[self.i][1] <= t:
            self.i += 1
        if self.i < len(seg) and seg[self.i][0] <= t:
            return seg[self.i][2]
        return None


def idle_gaps_by_stage(tl, rec: dict, top: int = 20) -> List[list]:
    """[[stage, idle seconds], ...], most first (module docstring)."""
    by_thread: Dict[str, list] = collections.defaultdict(list)
    for s in rec["spans"]:
        by_thread[s[3]].append(s)
    reader = _Cursor(_innermost(by_thread.pop(READER_THREAD, [])))
    stepping = [_Cursor(_innermost(sp)) for _, sp in
                sorted(by_thread.items(), key=lambda kv: -len(kv[1]))]
    out: Dict[str, float] = collections.defaultdict(float)
    for a, b in idle_gaps(tl):
        mid = (a + b) / 2
        stage = None
        for c in stepping:
            name = c.at(mid)
            if name is not None and stage is None:
                stage = name
        if stage is None or stage == FLUSH_WAIT:
            stage = reader.at(mid) or stage
        out[stage or OUTSIDE] += (b - a) * 1e-9
    return [[k, v] for k, v in sorted(out.items(), key=lambda kv: -kv[1])[:top]]


def clock_check(tl, rec: dict, first_launch: int) -> dict:
    """Pairs each K1 sweep in the timeline (stream order; the first is
    launch ``first_launch``) with the span that enqueued it; counts the
    sweeps checked, those that start before their span does, and the
    median lag from a span's start to its first sweep's start."""
    starts = [s for s, _, name in tl.device if tracing.SWEEPS["nn"] in name]
    checked = early = 0
    lags = []
    for s in rec["spans"]:
        if s[6] is None:
            continue
        a, b = s[6][0] - first_launch, s[6][1] - first_launch
        if b <= a or a < 0 or b > len(starts):
            continue
        for j in range(a, b):
            checked += 1
            early += starts[j] < s[4]
        lags.append((starts[a] - s[4]) * 1e-6)
    return {"sweeps_in_trace": len(starts), "sweeps_checked": checked,
            "sweeps_before_their_span": early,
            "median_lag_ms": statistics.median(lags) if lags else None}
