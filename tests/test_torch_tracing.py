"""The port's tracer (``utils/timing.py``) on the CPU: off, it is a shared
no-op that records nothing; on, spans nest with their parents, threads and
scan ids, the Mapper's reader thread carries its block's scan id, and the
ICP trip counters of the Mapper and the odometry agree with the
registrations' own ``iterations``.

The SLAM runs take the sizes of ``test_torch_slam.py`` (2048-point scans,
16 scans of the 48-scan loop, 8 m submaps, so the Mapper rolls over), with
the package's differential checker left on so that trips stop moving the
pose before ``max_n_iter``."""
import threading
import types

import numpy as np
import pytest
import torch

from open3d_slam_advanced_rss_2024_public_tpu_torch.frontends import synthetic
from open3d_slam_advanced_rss_2024_public_tpu_torch.frontends.kitti import kitti_sequence
from open3d_slam_advanced_rss_2024_public_tpu_torch.models import pipeline
from open3d_slam_advanced_rss_2024_public_tpu_torch.models.slam import SlamWrapper
from open3d_slam_advanced_rss_2024_public_tpu_torch.ops.registration import icp
from open3d_slam_advanced_rss_2024_public_tpu_torch.utils import timing
from open3d_slam_advanced_rss_2024_public_tpu_torch.utils.config import load_parameters

N = 2048
S = 16
MAPPER_TRIPS = 15
ODOMETRY_TRIPS = 12


def _params(**extra):
    over = {"mapper": {
        "mapper_localizer": {
            "is_print_timing_information": False,
            "is_attempt_loop_closures": False,
            "scan_to_map_registration": {
                "min_refinement_fitness": 0.25,
                "scan_to_map_refinement_type": "PointToPlaneIcp",
                "icp": {"max_n_iter": MAPPER_TRIPS, "max_correspondence_dist": 0.6},
                "scan_processing": {
                    "voxel_size": 0.15, "point_capacity": N,
                    "scan_cropping": {"cropping_radius_max": 18.0,
                                      "cropping_radius_min": 0.5}},
                "map_patch_capacity": 4096}},
        "submaps": {"point_capacity": 8192, "submap_size": 8.0,
                    "min_num_range_data": 3, "submaps_num_scan_overlap": 3},
        "map_builder": {"map_voxel_size": 0.12},
        "place_recognition": {"feature_point_capacity": 1024,
                              "overlap_point_capacity": 2048,
                              "ransac_batch_size": 512}}}
    over.update(extra)
    return load_parameters(over)


@pytest.fixture(scope="module")
def scene():
    world = synthetic.cluttered_world(11, extent=34.0, n_objects=50, device="cpu")
    gt = synthetic.loop_trajectory(48, radius=10.0, center=(17.0, 0.0), z=1.0)[:S]
    odom = synthetic.perturb_odometry(gt, drift_per_step=0.015, yaw_drift_per_step=0.002,
                                      seed=3)
    g = torch.Generator().manual_seed(0)
    scans = [synthetic.render_scan(world, gt[i], g, n_points=N, max_range=18.0, noise=0.004)
             for i in range(S)]
    return gt, odom, scans


@pytest.fixture
def tracer():
    timing.disable()
    timing.reset()
    yield timing
    timing.disable()
    timing.reset()


def _run(slam, scans, poses, first):
    slam.set_initial_transform(first)
    for i, scan in enumerate(scans):
        slam.use_pair_for_registration(scan, None if poses is None else poses[i], 0.1 * i)
    slam.finish_processing()


def test_off_the_tracer_is_a_shared_no_op_and_records_nothing(tracer, scene):
    _, odom, scans = scene
    assert not timing.active()
    assert timing.span("mapper") is timing.NO_SPAN is timing.span("odometry")
    timing.count("mapper/icp_trips_dispatched", 5)
    timing.count_in_layer("icp_trips_dispatched", 5, ("mapper",))
    _run(SlamWrapper(_params(), device="cpu"), scans[:4], odom, odom[0])
    assert timing.records() == {"spans": [], "counts": {}}


def test_spans_nest_with_parents_threads_and_scan_ids(tracer):
    timing.enable()
    timing.set_scan(7)
    launches = iter([3, 5])
    with timing.span("mapper"):
        with timing.span("mapper/dispatch", launches=lambda: next(launches)):
            timing.count_in_layer("icp_trips_dispatched", 50, ("mapper", "odometry"))
        timing.count("mapper/icp_trips_active", 11)
    with timing.span("loop_closure/candidates"):
        timing.count_in_layer("icp_trips_dispatched", 30, ("mapper", "odometry"))

    def other():
        timing.set_scan(9)
        with timing.span("mapper/readback_wait"):
            pass

    t = threading.Thread(target=other, name="mapper-readback")
    t.start()
    t.join()
    timing.count_in_layer("icp_trips_dispatched", 2, ("mapper", "odometry"))
    rec = timing.records()
    by_name = {s.name: s for s in rec["spans"]}
    outer, inner, wait = by_name["mapper"], by_name["mapper/dispatch"], by_name[
        "mapper/readback_wait"]
    assert (outer.parent, inner.parent, wait.parent) == (None, "mapper", None)
    assert outer.thread == inner.thread == threading.current_thread().name
    assert wait.thread == "mapper-readback"
    assert (outer.scan, inner.scan, wait.scan) == (7, 7, 9)
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns
    assert inner.launches == (3, 5) and outer.launches is None
    # Outside the named layers, and outside any span, nothing is counted.
    assert rec["counts"] == {"mapper/icp_trips_dispatched": 50, "mapper/icp_trips_active": 11}
    text = timing.summary()
    assert "mapper/dispatch" in text and "mapper/icp_trips_active" in text
    timing.reset()
    assert timing.records() == {"spans": [], "counts": {}}


def test_mapper_trip_counters_and_the_reader_threads_scan_ids(tracer, scene, monkeypatch):
    _, odom, scans = scene
    results = []

    def register(*args, **kwargs):
        res = icp.register(*args, **kwargs)
        results.append(res)
        return res

    # The Mapper's own registrations alone (the submaps' constraint
    # builders call icp.register too).
    monkeypatch.setattr(pipeline, "icp_mod", types.SimpleNamespace(
        register=register, prepare_reference=icp.prepare_reference,
        POLL_EVERY=icp.POLL_EVERY))
    timing.enable()
    slam = SlamWrapper(_params(), device="cpu")
    _run(slam, scans, odom, odom[0])
    rec = timing.records()
    counts = rec["counts"]
    iterations = sum(int(r.iterations.sum()) for r in results)
    assert len(results) == S and len(slam.mapper.submaps.submaps) >= 2
    # The polled done flag stops the loops early (strictly fewer trips than
    # the fixed-trip loops), never before the trips that moved the pose.
    assert iterations <= counts["mapper/icp_trips_dispatched"] < MAPPER_TRIPS * len(results)
    assert counts["mapper/icp_trips_active"] == iterations
    assert 0 < counts["mapper/icp_trips_active"] <= counts["mapper/icp_trips_dispatched"]

    spans = rec["spans"]
    names = {s.name for s in spans}
    assert {"mapper", "mapper/dispatch", "mapper/preprocess", "mapper/reference",
            "mapper/icp", "mapper/insert", "mapper/flush_wait", "mapper/readback_wait",
            "mapper/bookkeeping", "mapper/post_insert", "mapper/rollover_rebuild",
            "loop_closure", "loop_closure/features"} <= names
    dispatch_scans = [s.scan for s in spans if s.name == "mapper/dispatch"]
    assert dispatch_scans == list(range(2, S + 1))  # the first scan is inserted directly
    for s in spans:
        if s.name in ("mapper/readback_wait", "mapper/bookkeeping"):
            assert s.thread == "mapper-readback" and s.parent is None
            assert s.scan in dispatch_scans
        elif s.name in ("mapper/post_insert", "mapper/rollover_rebuild", "mapper/evict"):
            assert s.parent == "mapper/bookkeeping" and s.thread == "mapper-readback"
        else:
            assert s.thread == threading.current_thread().name
    parents = {s.name: s.parent for s in spans}
    assert parents["mapper/dispatch"] == "mapper"
    assert parents["mapper/flush_wait"] == "mapper"
    assert parents["mapper/icp"] == "mapper/dispatch"
    assert parents["loop_closure/features"] == "loop_closure"
    # Each block's reader spans follow the dispatch of its first scan.
    dispatched_at = {s.scan: s.start_ns for s in spans if s.name == "mapper/dispatch"}
    for s in spans:
        if s.name == "mapper/bookkeeping":
            assert s.start_ns >= dispatched_at[s.scan]


def test_odometry_trip_counters(tracer, scene):
    gt, _, scans = scene
    n = 6
    timing.enable()
    slam = SlamWrapper(_params(odometry={
        "scan_matching": {"cloud_registration_type": "PointToPlaneIcp",
                          "icp": {"max_n_iter": ODOMETRY_TRIPS}},
        "scan_processing": {"voxel_size": 0.15, "point_capacity": N}}), device="cpu")
    _run(slam, scans[:n], None, gt[0])
    counts = timing.records()["counts"]
    active, dispatched = counts["odometry/icp_trips_active"], counts[
        "odometry/icp_trips_dispatched"]
    assert 0 < active <= dispatched <= ODOMETRY_TRIPS * (n - 1)
    spans = timing.records()["spans"]
    register = [s for s in spans if s.name == "odometry/register"]
    assert len(register) == n - 1 and all(s.parent == "odometry" for s in register)
    assert all(s.launches is not None and s.launches[1] >= s.launches[0] for s in register)
    assert [s.scan for s in spans if s.name == "odometry/readback_wait"] == list(
        range(2, n + 1))


def test_the_frontend_span_closes_before_each_frame_is_handed_on(tracer, tmp_path):
    velo = tmp_path / "sequences" / "00" / "velodyne"
    velo.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for i in range(3):
        rng.standard_normal((100, 4)).astype(np.float32).tofile(velo / f"{i:06d}.bin")
    timing.enable()
    frames = 0
    for _ in kitti_sequence(str(tmp_path), capacity=128, device="cpu"):
        with timing.span("consumer"):
            frames += 1
    spans = timing.records()["spans"]
    front = [s for s in spans if s.name == "frontend"]
    consumer = [s for s in spans if s.name == "consumer"]
    # One a frame, and one for the call that finds the end.
    assert frames == 3 and len(front) == 4 and len(consumer) == 3
    assert all(s.parent is None for s in front + consumer)
    for f, c in zip(front, consumer):
        assert f.end_ns <= c.start_ns
