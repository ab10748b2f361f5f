"""The PyTorch port's SlamWrapper against the JAX package's (CPU).

Both runtimes take the same numpy scans and the same drifting odometry
through ``use_pair_for_registration`` ... ``finish_processing`` with the same
parameters: a third of the 48-scan loop (16 scans, 2048 points), 8 m submaps,
so that the run rolls over twice and computes features, odometry constraints
and candidates for three submaps.  The search radius keeps every pair of
submaps out of loop-closure range: RANSAC draws differ between the two
packages by construction, and the loop-closure stages have their own parity
tests with the draws handed over (``test_torch_loop_closure.py``).

As in ``test_torch_mapper.py`` the JAX package runs its radius-moments kernel
in interpret mode and hands the same moments to the port, so that the
comparison isolates the runtime (the two kernels differ at the radius by
design); a second run goes through the port's own twin.  Both are held to
5 mm, the bound that ICP's amplification over such sparse scans sets.
"""
import dataclasses

import numpy as np
import pytest
import torch

from open3d_slam_advanced_rss_2024_public_tpu.models.slam import SlamWrapper as JSlamWrapper
from open3d_slam_advanced_rss_2024_public_tpu.utils.config import load_parameters as jload
from open3d_slam_advanced_rss_2024_public_tpu.utils.pointcloud import make_cloud as jmake
from open3d_slam_advanced_rss_2024_public_tpu_torch.frontends import synthetic
from open3d_slam_advanced_rss_2024_public_tpu_torch.models.slam import SlamWrapper
from open3d_slam_advanced_rss_2024_public_tpu_torch.ops import cuda_moments
from open3d_slam_advanced_rss_2024_public_tpu_torch.utils import convert

from test_torch_mapper import _jax_radius_moments, _tcloud

N = 2048
S = 16


def _overrides():
    return {"mapper": {
        "mapper_localizer": {
            "is_print_timing_information": False,
            "is_attempt_loop_closures": True,
            "scan_to_map_registration": {
                "min_refinement_fitness": 0.25,
                "scan_to_map_refinement_type": "PointToPlaneIcp",
                "matcher": "bruteforce",
                "icp": {"max_n_iter": 15, "max_correspondence_dist": 0.6},
                # Both sides run ICP to its fixed point (see test_torch_mapper.py).
                "min_diff_rot": 0.0, "min_diff_trans": 0.0,
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
            "loop_closure_search_radius": 6.0,
            "min_submaps_between_loop_closures": 0,
            "feature_point_capacity": 1024,
            "overlap_point_capacity": 2048,
            "ransac_batch_size": 512}}}


@pytest.fixture(scope="module")
def scene():
    world = synthetic.cluttered_world(11, extent=34.0, n_objects=50, device="cpu")
    gt = synthetic.loop_trajectory(48, radius=10.0, center=(17.0, 0.0), z=1.0)[:S]
    odom = synthetic.perturb_odometry(gt, drift_per_step=0.015, yaw_drift_per_step=0.002,
                                      seed=3)
    g = torch.Generator().manual_seed(0)
    scans = [synthetic.render_scan(world, gt[i], g, n_points=N, max_range=18.0, noise=0.004)
             for i in range(S)]
    return gt, odom, [(s.xyz.numpy(), s.mask.numpy()) for s in scans]


def _run(slam, scans, odom, make):
    slam.set_initial_transform(odom[0])
    for i, (xyz, mask) in enumerate(scans):
        slam.use_pair_for_registration(make(xyz, mask), odom[i], 0.1 * i)
    slam.finish_processing()
    return np.stack(slam.trajectory_poses)


@pytest.fixture(scope="module")
def jax_run(scene):
    _, odom, scans = scene
    js = JSlamWrapper(jload(_overrides()))
    js.mapper.pipe_cfg = dataclasses.replace(js.mapper.pipe_cfg,
                                             normal_engine="moments_interpret")
    return js, _run(js, scans, odom, lambda x, m: jmake(x, mask=m))


@pytest.fixture(scope="module")
def both_runs(scene, jax_run):
    _, odom, scans = scene
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cuda_moments, "radius_moments", _jax_radius_moments)
        ts = SlamWrapper(convert.params_from_dict(_overrides()), device="cpu")
        tposes = _run(ts, scans, odom, _tcloud)
    return jax_run[0], jax_run[1], ts, tposes


def test_slam_trajectory_matches_jax(scene, both_runs):
    gt = scene[0]
    _, jposes, _, tposes = both_runs
    assert tposes.shape == jposes.shape == (S, 4, 4)
    # 5 mm, the bound test_torch_mapper.py sets for ICP over these sparse
    # scans: measured 1.1 mm and less, but for 2.9 mm at the first scan
    # matched against a fresh submap.
    assert np.abs(tposes[:, :3, 3] - jposes[:, :3, 3]).max() < 5e-3
    assert np.abs(tposes[:, :3, :3] - jposes[:, :3, :3]).max() < 1e-3
    # Scan matching removed the odometry's drift (0.2 m by the last scan).
    assert max(np.linalg.norm(tposes[i, :3, 3] - gt[i][:3, 3]) for i in range(S)) < 0.05


def test_slam_submaps_and_features_match_jax(both_runs):
    js, _, ts, _ = both_runs
    jsubs, tsubs = js.mapper.submaps.submaps, ts.mapper.submaps.submaps
    assert len(tsubs) == len(jsubs) == 3  # two rollovers
    assert ts.mapper.submaps.active_idx == js.mapper.submaps.active_idx
    assert [(s.submap_id, s.parent_id, s.n_scans) for s in tsubs] == \
        [(s.submap_id, s.parent_id, s.n_scans) for s in jsubs]
    # Every finished submap (the last one force-finished) has its feature
    # cloud and descriptors, over the same points.
    finished = [s.submap_id for s in tsubs if s.features is not None]
    assert finished == [s.submap_id for s in jsubs if s.features is not None] == [0, 1, 2]
    for a, b in zip(jsubs, tsubs):
        assert b.features.shape == tuple(a.features.shape) == (1024, 33)
        na, nb = int(np.asarray(a.feature_cloud.mask).sum()), int(b.feature_cloud.mask.sum())
        assert nb > 200 and abs(na - nb) <= 0.01 * na
        assert abs(int(b.map.count()) - int(a.map.count())) <= 0.002 * int(a.map.count())
        np.testing.assert_allclose(b.pose, a.pose, atol=1e-3)
        # The centroid of a few thousand voxel means up to 18 m away: the
        # 0.2% of voxels that differ move it by up to 2 cm.
        np.testing.assert_allclose(b.center(), a.center(), atol=3e-2)
    assert not ts.mapper.submaps.finished_queue
    assert ts._feature_compute_threads and len(ts._feature_compute_threads) == \
        len(js._feature_compute_threads)


def _rotation_angle(R):
    return float(np.arccos(np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)))


def test_slam_odometry_constraints_match_jax(both_runs):
    js, _, ts, _ = both_runs
    jcons, tcons = js.optimization.odometry_constraints, ts.optimization.odometry_constraints
    assert [(c.source_id, c.target_id) for c in tcons] == \
        [(c.source_id, c.target_id) for c in jcons]
    assert len(tcons) >= 2 and all(c.is_odometry for c in tcons)
    for a, b in zip(jcons, tcons):
        Ta, Tb = np.asarray(a.T_source_target), np.asarray(b.T_source_target)
        assert np.abs(Ta[:3, 3] - Tb[:3, 3]).max() < 2e-3
        assert _rotation_angle(Ta[:3, :3].T @ Tb[:3, :3]) < 1e-3
        Ia, Ib = np.asarray(a.information), np.asarray(b.information)
        assert np.abs(Ia - Ib).max() <= 0.02 * np.abs(Ia).max()
    # No pair of submaps was within the search radius: no closure on either side.
    assert ts.loop_closure_count == js.loop_closure_count == 0
    assert ts.optimization.loop_closure_constraints == []


def test_slam_assembled_map_matches_jax(both_runs):
    js, _, ts, _ = both_runs
    a, b = js.mapper.get_assembled_map(), ts.mapper.get_assembled_map()
    na, nb = int(np.asarray(a.mask).sum()), int(b.mask.sum())
    assert nb > 3000 and abs(na - nb) <= 0.002 * na


def test_slam_with_its_own_moments_twin(scene, jax_run):
    gt, odom, scans = scene
    js, jposes = jax_run
    ts = SlamWrapper(convert.params_from_dict(_overrides()), device="cpu")
    tposes = _run(ts, scans, odom, _tcloud)
    assert np.abs(tposes[:, :3, 3] - jposes[:, :3, 3]).max() < 5e-3
    assert len(ts.mapper.submaps.submaps) == len(js.mapper.submaps.submaps)
    assert [(c.source_id, c.target_id) for c in ts.optimization.odometry_constraints] == \
        [(c.source_id, c.target_id) for c in js.optimization.odometry_constraints]
