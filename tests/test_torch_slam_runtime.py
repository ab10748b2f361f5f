"""The port's SLAM runtime on the CPU, on its own: the cases of the JAX
package's ``tests/test_full_slam.py`` at a small size (2048-point scans,
1024 feature points, 2048 overlap points, 512 RANSAC hypotheses).

A 24-scan loop closed on its first pose with drifting odometry must find the
closure and pull the trajectory back; the saved artifacts load again; the
online workers keep the feature pass off the map worker; and the stepper
runs on the scan-to-scan odometry, with motion compensation, with a dense
map, and against a prebuilt map.
"""
import json
import time

import numpy as np
import pytest
import torch

from open3d_slam_advanced_rss_2024_public_tpu_torch.frontends import synthetic
from open3d_slam_advanced_rss_2024_public_tpu_torch.models.slam import SlamWrapper
from open3d_slam_advanced_rss_2024_public_tpu_torch.utils import io
from open3d_slam_advanced_rss_2024_public_tpu_torch.utils.config import load_parameters

N = 2048
LOOP_SCANS = 24


def loop_params(**extra):
    over = {"mapper": {
        "mapper_localizer": {
            "is_print_timing_information": False,
            "is_attempt_loop_closures": True,
            "scan_to_map_registration": {
                "min_refinement_fitness": 0.25,
                "scan_to_map_refinement_type": "PointToPlaneIcp",
                "icp": {"max_n_iter": 15, "max_correspondence_dist": 0.6},
                "scan_processing": {
                    "voxel_size": 0.15, "point_capacity": N,
                    "scan_cropping": {"cropping_radius_max": 18.0,
                                      "cropping_radius_min": 0.5}},
                "map_patch_capacity": 4096}},
        "submaps": {"point_capacity": 8192, "submap_size": 8.0,
                    "min_num_range_data": 3, "submaps_num_scan_overlap": 3},
        "map_builder": {"map_voxel_size": 0.12},
        "place_recognition": {
            "feature_voxel_size": 0.4,
            "feature_map_normal_estimation_radius": 1.2,
            "feature_radius": 1.8,
            "ransac_min_corresondence_set_size": 20,
            "min_icp_refinement_fitness": 0.4,
            "max_icp_correspondence_distance": 0.5,
            "loop_closure_search_radius": 12.0,
            "min_submaps_between_loop_closures": 0,
            "feature_point_capacity": 1024,
            "overlap_point_capacity": 2048,
            "ransac_batch_size": 512}}}
    over["mapper"]["mapper_localizer"].update(extra.pop("mapper_localizer", {}))
    over.update(extra)
    return load_parameters(over)


def _scans(world, gt, seed, max_range):
    g = torch.Generator().manual_seed(seed)
    return [synthetic.render_scan(world, T, g, n_points=N, max_range=max_range, noise=0.004)
            for T in gt]


@pytest.fixture(scope="module")
def closed_loop():
    n = LOOP_SCANS
    world = synthetic.cluttered_world(11, extent=34.0, n_objects=50, device="cpu")
    gt = synthetic.loop_trajectory(n, radius=7.5, center=(17.0, 0.0), z=1.0)
    gt.append(gt[0])  # close the loop physically
    odom = synthetic.perturb_odometry(gt, drift_per_step=0.015, yaw_drift_per_step=0.002,
                                      seed=3)
    slam = SlamWrapper(loop_params(), device="cpu")
    slam.set_initial_transform(gt[0])
    for i, scan in enumerate(_scans(world, gt, 0, 18.0)):
        assert slam.use_pair_for_registration(scan, odom[i], 0.1 * i)
    slam.finish_processing()
    return slam, gt, odom


def test_loop_closure_improves_trajectory(closed_loop):
    slam, gt, odom = closed_loop
    est = np.stack(slam.trajectory_poses)
    assert est.shape == (LOOP_SCANS + 1, 4, 4) and np.isfinite(est).all()
    ate_est = io.ate_rmse(est, np.stack(gt), align=False)
    ate_odom = io.ate_rmse(np.stack(odom), np.stack(gt), align=False)
    assert len(slam.mapper.submaps.submaps) >= 3
    assert ate_est < ate_odom, f"SLAM {ate_est:.3f} vs odom {ate_odom:.3f}"
    assert ate_est < 0.5, f"ATE {ate_est:.3f} too high"
    assert slam.loop_closure_count >= 1
    # Applied closures turned into odometry-grade edges; none is pending.
    assert slam.optimization.loop_closure_constraints == []
    assert sum(abs(c.source_id - c.target_id) > 1
               for c in slam.optimization.odometry_constraints) >= 1
    assert not slam.optimized_graph_available and slam._pending_increments is None
    assert all(not s.keys_stale for s in [slam.mapper.submaps.active_submap])


def test_offline_replay_artifacts(closed_loop, tmp_path):
    slam = closed_loop[0]
    traj = str(tmp_path / "slam_poses")
    slam.save_trajectory(traj)
    times, poses = io.load_tum_trajectory(traj)
    assert len(times) == LOOP_SCANS + 1
    np.testing.assert_allclose(poses[3][:3, 3], slam.trajectory_poses[3][:3, 3], atol=1e-4)
    assert "map.pcd" in slam.save_map(str(tmp_path / "map.pcd"))
    reloaded = io.load_pcd(str(tmp_path / "map.pcd"), device="cpu")
    assert int(reloaded.count()) == int(slam.mapper.get_assembled_map().count()) > 1000
    n_sub = len(slam.mapper.submaps.submaps)
    assert str(n_sub) in slam.save_submaps(str(tmp_path / "submaps"))
    assert sorted(p.name for p in (tmp_path / "submaps").iterdir()) == \
        sorted(f"submap_{i}.pcd" for i in range(n_sub))
    slam.save_pose_graph(str(tmp_path / "pose_graph.json"))
    d = json.loads((tmp_path / "pose_graph.json").read_text())
    assert len(d["odometry_constraints"]) == len(slam.optimization.odometry_constraints)
    slam.mission_end_autosave(str(tmp_path / "mission"))
    assert (tmp_path / "mission" / "slam_poses").exists()
    assert not (tmp_path / "mission" / "map.pcd").exists()  # save_map is off by default


def test_online_workers_keep_features_off_the_map_worker():
    n = 12
    world = synthetic.cluttered_world(14, extent=24.0, n_objects=24, device="cpu")
    # Travel farther than submap_size (8 m): at least one submap finishes.
    gt = synthetic.straight_trajectory(n, step=1.1, start=(2.0, 0.0, 1.0))
    scans = _scans(world, gt, 3, 14.0)
    slam = SlamWrapper(loop_params(), device="cpu")
    slam.set_initial_transform(gt[0])
    seen = []
    slam.start_workers()
    slam.start_pose_stream(lambda t, T: seen.append((t, T.copy())), rate_hz=100.0)
    try:
        for i in range(n):
            slam.add_odometry_pose(0.1 * i, gt[i])
            while not slam.add_range_scan(scans[i], 0.1 * i):
                time.sleep(0.002)
            if i % 4 == 3:  # bursty feed: let the queues drain
                time.sleep(0.15)
        deadline = time.time() + 120
        while time.time() < deadline and (len(slam.trajectory_poses) < n
                                          or slam.mapper.submaps.finished_queue):
            time.sleep(0.02)
        online_threads = list(slam._feature_compute_threads)
        slam.finish_processing()
    finally:
        slam.stop_workers()
    assert len(slam.trajectory_poses) == slam._scans_accepted == n
    assert (np.diff(np.asarray(slam.trajectory_times)) > 0).all()
    assert len(slam.mapper.submaps.submaps) >= 2, "no rollover happened"
    assert online_threads and all(t == "slam-features" for t in online_threads)
    assert any(s.features is not None for s in slam.mapper.submaps.submaps)
    assert max(np.linalg.norm(p[:3, 3] - gt[i][:3, 3])
               for i, p in enumerate(slam.trajectory_poses)) < 0.1
    assert seen and np.isfinite(seen[-1][1]).all()
    assert not slam._workers


@pytest.mark.parametrize("undistort", [False, True])
def test_stepper_on_its_own_odometry(undistort):
    """No odometry pose is handed in: the scan-to-scan ``LidarOdometry``
    feeds the mapper's prior; with motion compensation on, the twist comes
    from the odometry buffer."""
    n = 6
    world = synthetic.cluttered_world(12, extent=20.0, n_objects=25, device="cpu")
    gt = synthetic.straight_trajectory(n, step=0.4, start=(2.0, 0.0, 1.0))
    slam = SlamWrapper(loop_params(
        motion_compensation={"is_undistort_scan": undistort, "scan_duration": 0.01},
        odometry={"scan_matching": {"cloud_registration_type": "PointToPlaneIcp"},
                  "scan_processing": {"voxel_size": 0.15, "point_capacity": N}}),
        device="cpu")
    slam.set_initial_transform(gt[0])
    for i, scan in enumerate(_scans(world, gt, 1, 15.0)):
        slam.use_pair_for_registration(scan, None, 0.1 * i)
    slam.finish_processing()
    assert not slam.use_external_odometry
    assert len(slam.trajectory_poses) == n
    assert np.linalg.norm(slam.odometry.odom_to_range_sensor[:3, 3] - gt[-1][:3, 3]) < 0.1
    assert np.linalg.norm(slam.trajectory_poses[-1][:3, 3] - gt[-1][:3, 3]) < 0.05


def test_dense_map_and_initial_map():
    n = 5
    world = synthetic.cluttered_world(12, extent=20.0, n_objects=25, device="cpu")
    gt = synthetic.straight_trajectory(n, step=0.4, start=(2.0, 0.0, 1.0))
    scans = _scans(world, gt, 1, 15.0)
    slam = SlamWrapper(loop_params(mapper_localizer={"is_build_dense_map": True}), device="cpu")
    slam.set_initial_transform(gt[0])
    for i in range(n):
        slam.use_pair_for_registration(scans[i], gt[i], 0.1 * i)
    slam.finish_processing()
    active = slam.mapper.submaps.active_submap
    assert active.dense_map is not None and int(active.dense_map.count()) > 1000
    # Localization against that map: the prebuilt map is the first submap
    # and scans register to it without growing it.
    built = slam.mapper.get_assembled_map()
    loc = SlamWrapper(loop_params(), device="cpu")
    loc.set_initial_transform(gt[1])
    loc.set_initial_map(built)
    assert loc.mapper.is_use_initial_map and loc.mapper.submaps.is_localization_mode
    before = int(loc.mapper.submaps.active_submap.map.count())
    assert before > 1000
    # The pose just set is trusted for the first scan; the next one, with
    # its odometry 9 cm off, is registered against the prebuilt map.
    off = gt[2].copy()
    off[:3, 3] += [0.08, -0.05, 0.0]
    loc.use_pair_for_registration(scans[1], gt[1], 0.0)
    loc.use_pair_for_registration(scans[2], off, 0.1)
    loc.finish_processing()
    np.testing.assert_array_equal(loc.trajectory_poses[0], gt[1])
    assert np.linalg.norm(loc.trajectory_poses[-1][:3, 3] - gt[2][:3, 3]) < 0.03
    assert len(loc.mapper.submaps.submaps) == 1
    assert int(loc.mapper.submaps.active_submap.map.count()) == before


def test_unported_viewer_raises_with_its_roadmap_item(closed_loop, tmp_path):
    # The viewer is ported: its worker renders the closed loop's bundle
    # (every submap in its color, the trajectory tubes, the submap axes).
    slam = closed_loop[0]
    published = []
    slam.start_visualization(str(tmp_path), rate_hz=20.0, publish_fn=published.append)
    try:
        deadline = time.time() + 60
        while time.time() < deadline and not published:
            time.sleep(0.05)
    finally:
        slam.stop_workers()
    assert published and slam.viz_publisher.publish_count >= 1
    assert not slam._workers
    submaps = slam.mapper.submaps
    back = io.load_ply(str(tmp_path / "submaps_colored.ply"), device="cpu")
    assert int(back.count()) == submaps.total_num_points() > 1000
    axes = io.load_ply(str(tmp_path / "submap_origins.ply"), device="cpu")
    assert int(axes.count()) == 60 * len(submaps.submaps)
    for name in ("trajectory_tube.pcd", "best_guess_tube.pcd"):
        assert int(io.load_pcd(str(tmp_path / name), device="cpu").count()) > 0, name
