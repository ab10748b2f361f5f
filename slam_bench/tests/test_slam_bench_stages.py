"""The readers of the program's own spans and counters, ``idle_gaps_by_stage``
and the clock check, on a hand-built ``Context``: known spans on the stepping
thread and on the Mapper's reader thread, known counters and device
intervals (nanoseconds on one clock)."""
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from slam_bench import harness, spec, stages, tracing  # noqa: E402

MAIN, READER = "MainThread", stages.READER_THREAD
SPANS = [
    # name, parent, scan, thread, start_ns, end_ns, launches
    ("mapper", None, 1, MAIN, 0, 1000, None),
    ("mapper/dispatch", "mapper", 1, MAIN, 0, 400, (10, 12)),
    ("mapper/flush_wait", "mapper", 1, MAIN, 400, 1000, None),
    ("mapper/readback_wait", None, 1, READER, 400, 700, None),
    ("mapper/bookkeeping", None, 1, READER, 700, 1000, None),
    ("mapper/post_insert", "mapper/bookkeeping", 1, READER, 800, 900, None),
    ("odometry", None, 2, MAIN, 1100, 1600, None),
    ("odometry/register", "odometry", 2, MAIN, 1200, 1500, (12, 13)),
]
COUNTS = {"mapper/icp_trips_dispatched": 100, "mapper/icp_trips_active": 20,
          "odometry/icp_trips_dispatched": 50, "odometry/icp_trips_active": 30}
DEVICE = [(50, 100, "nn_sweep_kernel"), (150, 200, "nn_sweep_kernel"), (300, 350, "gemm"),
          (600, 650, "reduce"), (850, 860, "fill"), (1250, 1300, "nn_sweep_kernel"),
          (1650, 1800, "copy")]
# Idle gaps: (100, 150) and (200, 300) in the dispatch; (350, 600) in the
# flush wait while the reader waits for the readback; (650, 850) in the
# flush wait during the bookkeeping (its post_insert child opens at 800);
# (860, 1250) with no span open at its midpoint on either thread;
# (1300, 1650) in the odometry's register.
BY_STAGE = {"mapper/dispatch": 150, "mapper/readback_wait": 250, "mapper/bookkeeping": 200,
            stages.OUTSIDE: 390, "odometry/register": 350}
IDLE_NS = sum(BY_STAGE.values())
IN_ENQUEUE_NS = 50 + 100 + 50 + 50 + 200


def context(spans=SPANS, counts=COUNTS, device=DEVICE):
    window = type("W", (), {"step_s": [0.1, 0.1], "window_s": 1.0})()
    ctx = harness.Context(window, 1.0, timeline=tracing.Timeline(sorted(device), [], 1.0))
    ctx.records = {"spans": list(spans), "counts": dict(counts)}
    return ctx


def read(name, ctx):
    return spec.reader(name)(ctx)


def test_the_span_readers_give_ms_a_scan():
    ctx = context()
    assert read("mapper_enqueue_ms", ctx) == pytest.approx(400e-6 / 2)
    assert read("mapper_wait_ms", ctx) == pytest.approx(600e-6 / 2)


def test_the_counter_readers_give_the_active_share():
    ctx = context()
    assert read("mapper_active_trips_pct", ctx) == pytest.approx(20.0)
    assert read("odometry_active_trips_pct", ctx) == pytest.approx(60.0)


def test_idle_in_enqueue_is_the_idle_time_inside_dispatch_and_register():
    assert read("idle_in_enqueue_pct", context()) == pytest.approx(
        100.0 * IN_ENQUEUE_NS / IDLE_NS)


def test_idle_gaps_by_stage_hands_the_flush_wait_to_the_reader_thread():
    ctx = context()
    got = stages.idle_gaps_by_stage(ctx.timeline, ctx.records)
    assert {k: round(v * 1e9) for k, v in got} == BY_STAGE
    assert [k for k, _ in got][0] == stages.OUTSIDE  # most first
    assert sum(v for _, v in got) == pytest.approx(IDLE_NS * 1e-9)


def test_a_flush_wait_with_the_reader_idle_keeps_its_own_name():
    spans = [s for s in SPANS if s[3] != READER]
    ctx = context(spans)
    got = dict(stages.idle_gaps_by_stage(ctx.timeline, ctx.records))
    assert round(got[stages.FLUSH_WAIT] * 1e9) == 250 + 200


@pytest.mark.parametrize("name", ["mapper_enqueue_ms", "mapper_wait_ms",
                                  "mapper_active_trips_pct", "odometry_active_trips_pct",
                                  "idle_in_enqueue_pct"])
def test_a_program_without_the_spans_leaves_the_readers_silent(name):
    assert read(name, context([], {})) is None
    if name.startswith("odometry"):
        assert read(name, context(SPANS, {"mapper/icp_trips_dispatched": 3})) is None


def test_the_readers_fall_back_to_the_ports_own_tracer():
    from open3d_slam_advanced_rss_2024_public_tpu_torch.utils import timing

    ctx = context()
    del ctx.records
    timing.reset()
    assert read("mapper_enqueue_ms", ctx) is None
    timing.enable()
    try:
        with timing.span("mapper/dispatch"):
            pass
        timing.count("mapper/icp_trips_dispatched", 4)
        timing.count("mapper/icp_trips_active", 1)
    finally:
        timing.disable()
    assert read("mapper_enqueue_ms", ctx) >= 0
    assert read("mapper_active_trips_pct", ctx) == pytest.approx(25.0)
    timing.reset()


def test_the_clock_check_pairs_each_sweep_with_its_span():
    ctx = context()
    got = stages.clock_check(ctx.timeline, ctx.records, first_launch=10)
    assert got == {"sweeps_in_trace": 3, "sweeps_checked": 3, "sweeps_before_their_span": 0,
                   "median_lag_ms": pytest.approx(50e-6)}
    # A sweep that starts before the span that enqueued it is caught.
    late = [s if s[0] != "odometry/register" else s[:4] + (1280, 1500, s[6]) for s in SPANS]
    got = stages.clock_check(ctx.timeline, {"spans": late, "counts": {}}, first_launch=10)
    assert got["sweeps_checked"] == 3 and got["sweeps_before_their_span"] == 1
