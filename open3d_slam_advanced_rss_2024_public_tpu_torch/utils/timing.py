"""A stopwatch timer and the port's tracer: named spans and counters.

``Timer`` ≙ the reference's o3d_slam::Timer (open3d_slam/src/time.cpp:35-60:
stopwatch, running average, optional print-on-destruct).

The tracer records where the host spends a scan.  It is off by default:
``span()`` then returns one shared no-op context object and ``count()``
returns at once, so neither reads a clock nor allocates.  It is on after
``enable()``, and while a ``torch.profiler`` session records, as
``torch.profiler.record_function`` is: a profiled run gets the host's spans
without a further switch, on the wall clock (``time.time_ns()``) that the
profiler's device events carry too.  The tracer never synchronises the
device and records no CUDA event: the device's time per stage is read from
the profiler's timeline, against the spans.

A span keeps its name, the enclosing span's name on the same thread, the
scan id of its thread (``set_scan``: ``SlamWrapper`` numbers the scans it
takes, the Mapper's reader thread takes its block's first), the thread's
name, its start and end, and optionally a launch counter read when it opens
and closes.  Spans and counter totals stay in memory until ``reset()``;
``records()`` hands them out and ``summary()`` prints per-name totals.

    from open3d_slam_advanced_rss_2024_public_tpu_torch.utils import timing
    timing.enable()
    ...  # run scans
    print(timing.summary())
"""
from __future__ import annotations

import functools
import threading
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch


class Timer:
    def __init__(self, name: str = "", print_on_exit: bool = False):
        self.name = name
        self.print_on_exit = print_on_exit
        self._start = None
        self.total_ms = 0.0
        self.count = 0
        self.last_ms = 0.0

    def start(self) -> None:
        self._start = time.perf_counter()

    def stop(self) -> float:
        if self._start is None:
            return 0.0
        self.last_ms = (time.perf_counter() - self._start) * 1e3
        self.total_ms += self.last_ms
        self.count += 1
        self._start = None
        return self.last_ms

    @property
    def avg_ms(self) -> float:
        return self.total_ms / max(self.count, 1)

    @property
    def hz(self) -> float:
        return 1e3 / max(self.avg_ms, 1e-9)

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        if self.print_on_exit:
            print(f"[timer] {self.name}: {self.last_ms:.2f} ms "
                  f"(avg {self.avg_ms:.2f} ms over {self.count})")


class Span(NamedTuple):
    name: str
    parent: Optional[str]        # the enclosing span on the same thread
    scan: Optional[int]          # the thread's scan id when the span opened
    thread: str
    start_ns: int                # time.time_ns(), the profiler's clock
    end_ns: int
    launches: Optional[Tuple[int, int]]  # the span's launch counter at open, at close


_enabled = False
_spans: List[Span] = []
_counts: Dict[str, int] = {}
_count_lock = threading.Lock()
_local = threading.local()
_profiler = torch.autograd.profiler


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def active() -> bool:
    """On after ``enable()``, or while a torch profiler session records."""
    return _enabled or getattr(_profiler, "_is_profiler_enabled", False)


def reset() -> None:
    """Forget every span and counter total."""
    with _count_lock:
        _spans.clear()
        _counts.clear()


def set_scan(scan_id: Optional[int]) -> None:
    """The scan this thread works on: its later spans carry the id."""
    _local.scan = scan_id


def current_scan() -> Optional[int]:
    return getattr(_local, "scan", None)


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NO_SPAN = _NoSpan()


class _OpenSpan:
    __slots__ = ("name", "launches", "parent", "scan", "start", "opened_at")

    def __init__(self, name: str, launches: Optional[Callable[[], int]]):
        self.name, self.launches = name, launches

    def __enter__(self):
        st = _stack()
        self.parent = st[-1].name if st else None
        st.append(self)
        self.scan = current_scan()
        self.opened_at = self.launches() if self.launches is not None else None
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        st = _stack()
        if st and st[-1] is self:
            st.pop()
        launches = None if self.launches is None else (self.opened_at, self.launches())
        _spans.append(Span(self.name, self.parent, self.scan,
                           threading.current_thread().name, self.start, end, launches))
        return False


def span(name: str, launches: Optional[Callable[[], int]] = None):
    """A context manager recording one span of ``name`` while the tracer is
    on; ``launches`` (a launch counter, read without arguments) is noted
    when the span opens and closes."""
    if not active():
        return NO_SPAN
    return _OpenSpan(name, launches)


def traced(name: str):
    """A decorator: each call of the function in a span of ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def iterate(name: str, iterable):
    """``iterable``'s items, each ``next()`` in a span of ``name`` that
    closes before the item is handed on (so it never covers the consumer)."""
    it = iter(iterable)
    while True:
        with span(name):
            try:
                item = next(it)
            except StopIteration:
                return
        yield item


def count(name: str, n: int = 1) -> None:
    if not active():
        return
    with _count_lock:
        _counts[name] = _counts.get(name, 0) + int(n)


def count_in_layer(name: str, n: int, layers: Tuple[str, ...]) -> None:
    """``count`` under the layer of the innermost span open on this thread
    (``mapper/dispatch`` -> ``mapper/<name>``), where that layer is one of
    ``layers``; nothing is counted outside them or outside any span."""
    if not active():
        return
    st = _stack()
    layer = st[-1].name.split("/", 1)[0] if st else None
    if layer in layers:
        count(f"{layer}/{name}", n)


def records() -> dict:
    """``{"spans": [Span, ...], "counts": {name: total}}``, copies."""
    with _count_lock:
        return {"spans": list(_spans), "counts": dict(_counts)}


def summary() -> str:
    """Per span name: calls, total and mean ms; then each counter's total."""
    rec = records()
    totals: Dict[str, List[float]] = {}
    for s in rec["spans"]:
        t = totals.setdefault(s.name, [0, 0.0])
        t[0] += 1
        t[1] += (s.end_ns - s.start_ns) * 1e-6
    width = max([len(k) for k in list(totals) + list(rec["counts"])] + [7])
    lines = [f"{'span':<{width}} {'calls':>8} {'total ms':>12} {'mean ms':>10}"]
    for name in sorted(totals):
        n, ms = totals[name]
        lines.append(f"{name:<{width}} {n:>8d} {ms:>12.3f} {ms / n:>10.4f}")
    if rec["counts"]:
        lines.append(f"{'counter':<{width}} {'total':>8}")
        for name in sorted(rec["counts"]):
            lines.append(f"{name:<{width}} {rec['counts'][name]:>8d}")
    return "\n".join(lines)
