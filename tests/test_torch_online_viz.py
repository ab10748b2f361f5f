"""The port's online processor, IMU buffer, visualization bundle, visualizer
node and adjacency example, against the JAX package where it computes the
same thing (CPU).

The cases of ``tests/test_online_calibration.py``, ``test_components.py``'s
IMU case, ``test_io_viz.py``'s viz export (the files equal JAX's for the
same submaps, carried across with ``utils.convert``) and the four cases of
``test_live_viz.py``, with HTTP on a free loopback port.
"""
import contextlib
import io as text_io
import json
import os
import time as _t
import urllib.request

import jax.numpy as jnp
import numpy as np
import torch

from open3d_slam_advanced_rss_2024_public_tpu.frontends import adjacency_example as jadj
from open3d_slam_advanced_rss_2024_public_tpu.frontends import viz as jviz
from open3d_slam_advanced_rss_2024_public_tpu.models.imu import ImuBuffer as JImuBuffer
from open3d_slam_advanced_rss_2024_public_tpu.models.submap import Submap as JSubmap
from open3d_slam_advanced_rss_2024_public_tpu.ops import voxel_map as jvm
from open3d_slam_advanced_rss_2024_public_tpu.utils import pointcloud as jpc
from open3d_slam_advanced_rss_2024_public_tpu.utils import se3 as jse3
from open3d_slam_advanced_rss_2024_public_tpu.utils.frames import (
    StaticTransformBuffer as JStaticTransformBuffer)
from open3d_slam_advanced_rss_2024_public_tpu_torch.frontends import (adjacency_example,
                                                                      synthetic, viz,
                                                                      visualizer_node)
from open3d_slam_advanced_rss_2024_public_tpu_torch.frontends.online import (
    OnlineRangeDataProcessor)
from open3d_slam_advanced_rss_2024_public_tpu_torch.models.imu import ImuBuffer
from open3d_slam_advanced_rss_2024_public_tpu_torch.models.mapper import Mapper
from open3d_slam_advanced_rss_2024_public_tpu_torch.models.slam import SlamWrapper
from open3d_slam_advanced_rss_2024_public_tpu_torch.models.submap import Submap
from open3d_slam_advanced_rss_2024_public_tpu_torch.utils import convert, io
from open3d_slam_advanced_rss_2024_public_tpu_torch.utils.config import load_parameters
from open3d_slam_advanced_rss_2024_public_tpu_torch.utils.frames import StaticTransformBuffer
from open3d_slam_advanced_rss_2024_public_tpu_torch.utils.pointcloud import make_cloud


def _rot_z(a):
    c, s = np.cos(a), np.sin(a)
    T = np.eye(4, dtype=np.float32)
    T[:2, :2] = [[c, -s], [s, c]]
    return T


# ------------------------------------------------------------ calibration

def test_static_transform_buffer_paths_match_jax():
    a, b = JStaticTransformBuffer(), StaticTransformBuffer()
    assert b.lookup("a", "b") is None and a.lookup("a", "b") is None
    T_ab = _rot_z(0.3)
    T_ab[:3, 3] = [1.0, 2.0, 0.5]
    T_bc = _rot_z(-0.1)
    T_bc[0, 3] = 4.0
    for tf in (a, b):
        tf.set_transform("a", "b", T_ab)
        tf.set_transform("b", "c", T_bc)
    for target, source in (("a", "b"), ("b", "a"), ("a", "c"), ("c", "a"), ("c", "c")):
        np.testing.assert_array_equal(b.lookup(target, source), a.lookup(target, source))
    np.testing.assert_allclose(b.lookup("a", "c"), T_ab @ T_bc, atol=1e-5)


def test_online_calibration_lookup_with_retry():
    slam = SlamWrapper(load_parameters(None), device="cpu")
    tf = StaticTransformBuffer()
    proc = OnlineRangeDataProcessor(slam, tf, odometry_frame="base",
                                    range_sensor_frame="default")
    err = text_io.StringIO()
    with contextlib.redirect_stderr(err):
        # No cloud yet -> sensor frame unknown -> retry, with one warning.
        assert not proc.read_static_transformation_if_needed()
        assert proc.cloud_callback(make_cloud(np.zeros((8, 3), np.float32), device="cpu"),
                                   0.0, frame_id="lidar")
    assert "delaying calibration lookup" in err.getvalue()
    assert proc.range_sensor_frame == "lidar" and not proc.calibration_set
    T_base_imu = _rot_z(0.2)
    T_imu_lidar = _rot_z(0.5)
    T_imu_lidar[:3, 3] = [0.1, 0.0, 0.3]
    tf.set_transform("base", "imu", T_base_imu)
    tf.set_transform("imu", "lidar", T_imu_lidar)
    assert proc.read_static_transformation_if_needed() and proc.calibration_set
    np.testing.assert_allclose(slam.mapper.calibration,
                               np.linalg.inv(T_base_imu @ T_imu_lidar), atol=1e-5)
    slam2 = SlamWrapper(load_parameters(None), device="cpu")
    proc2 = OnlineRangeDataProcessor(slam2, StaticTransformBuffer(), odometry_frame="lidar",
                                     range_sensor_frame="lidar")
    assert proc2.read_static_transformation_if_needed()
    np.testing.assert_allclose(slam2.mapper.calibration, np.eye(4), atol=1e-7)


def test_mapper_consumes_nonidentity_calibration():
    """Odometry of a body frame 60 degrees from the sensor, with an offset:
    with the calibration installed the Mapper tracks the truth
    (test_online_calibration.py:81-121, its shapes and its 0.06 m bar)."""
    world = synthetic.corridor_world(55, length=20.0, device="cpu")
    n = 6
    gt = synthetic.straight_trajectory(n, step=0.5)
    T_cal = _rot_z(np.pi / 3.0)
    T_cal[:3, 3] = [0.2, -0.1, 0.0]
    params = load_parameters({"mapper": {
        "mapper_localizer": {"scan_to_map_registration": {
            "scan_to_map_refinement_type": "PointToPlaneIcp",
            "icp": {"max_n_iter": 12, "max_correspondence_dist": 0.6},
            "scan_processing": {"voxel_size": 0.15, "point_capacity": 2048,
                                "scan_cropping": {"cropping_radius_max": 18.0,
                                                  "cropping_radius_min": 0.5}},
            "map_patch_capacity": 8192}},
        "submaps": {"point_capacity": 16384}}})
    mapper = Mapper(params, device="cpu")
    mapper.set_map_to_range_sensor(gt[0])
    mapper.calibration = T_cal
    g = torch.Generator().manual_seed(56)
    est = []
    for i in range(n):
        scan = synthetic.render_scan(world, gt[i], g, n_points=2048, noise=0.003)
        mapper.odom_buffer.push(0.1 * i, gt[i] @ T_cal)
        mapper.add_range_measurement(scan, 0.1 * i)
        mapper.flush()
        est.append(mapper.map_to_range_sensor.copy())
    ate = io.ate_rmse(np.stack(est), np.stack(gt), align=False)
    assert ate < 0.06, f"calibrated odometry tracking ATE {ate:.3f}"


def test_deskew_twist_takes_the_calibration():
    """With external odometry of a body frame, the deskewing twist is the
    cloud frame's motion: the port conjugates the buffer's motion by the
    calibration, as the Mapper's initial guess does; with the identity it
    is the JAX package's twist of the same buffer."""
    from open3d_slam_advanced_rss_2024_public_tpu.models import motion_compensation as jmc
    from open3d_slam_advanced_rss_2024_public_tpu.utils.timebuf import (
        TransformInterpolationBuffer as JBuffer)
    from open3d_slam_advanced_rss_2024_public_tpu_torch.models import motion_compensation
    from open3d_slam_advanced_rss_2024_public_tpu_torch.utils.timebuf import (
        TransformInterpolationBuffer)

    T_cal = _rot_z(np.pi / 3.0)  # cloud <- odometry body
    T_cal[:3, 3] = [0.2, -0.1, 0.0]
    sensor = synthetic.loop_trajectory(40, radius=12.0, center=(0.0, 0.0), z=1.7)[:4]
    body, cloud = TransformInterpolationBuffer(), JBuffer()
    jbody = JBuffer()
    for i, S in enumerate(sensor):
        body.push(0.1 * i, S @ T_cal)
        jbody.push(0.1 * i, S @ T_cal)
        cloud.push(0.1 * i, S)
    got = motion_compensation.estimate_twist_from_buffer(body, 0.1, 3, calibration=T_cal)
    np.testing.assert_allclose(got, jmc.estimate_twist_from_buffer(cloud, 0.1, 3), atol=1e-5)
    assert np.linalg.norm(got[3:]) > 0.5  # the lap's 0.75 m a sweep
    same = motion_compensation.estimate_twist_from_buffer(body, 0.1, 3,
                                                          calibration=np.eye(4))
    np.testing.assert_allclose(same, jmc.estimate_twist_from_buffer(jbody, 0.1, 3), atol=1e-5)
    # The body frame's twist points 60 degrees off: what the port no longer takes.
    assert np.linalg.norm(same[3:] - got[3:]) > 0.5


def test_imu_gravity_alignment_matches_jax():
    # test_components.py:86: a tilted IMU at rest.
    tilt = np.asarray(jse3.so3_exp(jnp.asarray([0.3, 0.1, 0.0], jnp.float32)))
    g_meas = tilt.T @ np.array([0.0, 0.0, 9.81])
    a, b = JImuBuffer(lowpass_alpha=1.0), ImuBuffer(lowpass_alpha=1.0)
    for i in range(50):
        for buf in (a, b):
            buf.push(0.01 * i, g_meas, [0.01, -0.02, 0.005])
    (Ra, ba), (Rb, bb) = a.estimate_attitude(), b.estimate_attitude()
    np.testing.assert_allclose(Rb, Ra, atol=1e-6)
    np.testing.assert_array_equal(bb, ba)
    np.testing.assert_allclose(Rb @ (g_meas / np.linalg.norm(g_meas)), [0, 0, 1], atol=1e-3)
    assert len(b) == 50 and b.latest()[0] == a.latest()[0]
    # A second, filtered buffer: the low-pass state as JAX's.
    a, b = JImuBuffer(size_limit=8, lowpass_alpha=0.3), ImuBuffer(size_limit=8,
                                                                   lowpass_alpha=0.3)
    rng = np.random.default_rng(9)
    for i in range(20):
        acc, gyro = rng.normal(size=3) + [0, 0, 9.81], rng.normal(size=3) * 0.01
        a.push(0.01 * i, acc, gyro)
        b.push(0.01 * i, acc, gyro)
    (Ra, ba), (Rb, bb) = a.estimate_attitude(), b.estimate_attitude()
    np.testing.assert_allclose(Rb, Ra, atol=1e-6)
    np.testing.assert_allclose(bb, ba, atol=1e-7)
    assert len(b) == len(a) == 8


# ----------------------------------------------------------------- viz

def test_viz_export_files_equal_jax(tmp_path):
    """test_io_viz.py:175's submaps: three 100-point clouds fused at 0.2 m,
    2 m apart; both packages write their bundle files from the same tables
    (the port's carried across from JAX's)."""
    jsms, tsms = [], []
    for i in range(3):
        rng = np.random.default_rng(i)
        xyz = rng.uniform(-1, 1, (100, 3)).astype(np.float32)
        vm = jvm.insert(jvm.empty(512), jpc.make_cloud(xyz), 0.2)
        pose = np.eye(4, dtype=np.float32)
        pose[:3, 3] = [2.0 * i, 0.0, 0.0]
        jsms.append(JSubmap(submap_id=i, parent_id=max(i - 1, 0), creation_time=0.0, map=vm,
                            pose=pose, n_scans=1))
        tsms.append(Submap(submap_id=i, parent_id=max(i - 1, 0), creation_time=0.0,
                           map=convert.voxel_map_from_arrays(vm.ptable, vm.origin, vm.acc,
                                                             vm.cell, vm.dropped,
                                                             device="cpu"),
                           pose=pose, n_scans=1))
    poses = [np.eye(4, dtype=np.float32) for _ in range(5)]
    for i, p in enumerate(poses):
        p[:3, 3] = [i * 1.0, 0.1 * i, 0.0]
    for name, jfn, tfn, arg in (
            ("sub.ply", jviz.save_colored_submaps, viz.save_colored_submaps, (jsms, tsms)),
            ("tube.pcd", jviz.save_trajectory_tube, viz.save_trajectory_tube, (poses, poses)),
            ("axes.ply", jviz.save_submap_origins, viz.save_submap_origins, (jsms, tsms))):
        na = jfn(str(tmp_path / ("jax_" + name)), arg[0])
        nb = tfn(str(tmp_path / ("port_" + name)), arg[1])
        assert nb == na > 0
        assert (tmp_path / ("port_" + name)).read_bytes() == (
            tmp_path / ("jax_" + name)).read_bytes()
        back = io.load_cloud(str(tmp_path / ("port_" + name)), device="cpu")
        assert int(back.count()) == nb
    xa, na_, ca = jviz.colored_submap_assembly(jsms)
    xb, nb_, cb = viz.colored_submap_assembly(tsms)
    np.testing.assert_array_equal(xb, xa)
    np.testing.assert_array_equal(cb, ca)
    assert viz.save_submap_origins(str(tmp_path / "o.ply"), tsms) == 3 * 3 * 20


def _viz_params():
    return load_parameters({"mapper": {
        "mapper_localizer": {
            "is_print_timing_information": False,
            "is_attempt_loop_closures": False,
            "scan_to_map_registration": {
                "min_refinement_fitness": 0.25,
                "icp": {"max_n_iter": 8, "max_correspondence_dist": 0.6},
                "scan_processing": {
                    "voxel_size": 0.2, "point_capacity": 1024,
                    "scan_cropping": {"cropping_radius_max": 12.0,
                                      "cropping_radius_min": 0.5}},
                "map_patch_capacity": 4096}},
        "submaps": {"point_capacity": 8192, "submap_size": 20.0},
        "map_builder": {"map_voxel_size": 0.2},
    }})


def test_live_viz_publishes_and_updates(tmp_path):
    world = synthetic.cluttered_world(2, extent=14.0, n_objects=12, device="cpu")
    gt = synthetic.straight_trajectory(4, step=0.5, start=(1.0, 0.0, 1.0))
    slam = SlamWrapper(_viz_params(), device="cpu")
    slam.set_initial_transform(gt[0])
    out = str(tmp_path / "viz")
    pub = viz.LiveVisualizationPublisher(out)
    published = []
    pub.publish_fn = lambda paths: published.append(dict(paths))
    g = torch.Generator().manual_seed(4)
    for i in range(4):
        scan = synthetic.render_scan(world, gt[i], g, n_points=1024, max_range=10.0)
        slam.use_pair_for_registration(scan, gt[i], 0.1 * i)
        # Every other tick renders on the publisher's own thread.
        written = pub.tick(slam, wait=i % 2 == 0)
        if i % 2:
            written = written.result(timeout=60)
        assert set(written) == {"submaps_colored", "trajectory_tube", "best_guess_tube",
                                "submap_origins"}
    pub.close()
    n_pub = pub.publish_count
    assert pub.tick(slam) is None and pub.publish_count == n_pub == 4
    assert len(published) == 4
    for name in ("submaps_colored.ply", "trajectory_tube.pcd", "submap_origins.ply"):
        p = os.path.join(out, name)
        assert os.path.getsize(p) > 0, name
        base, ext = os.path.splitext(p)
        assert not os.path.exists(base + ".tmp" + ext)
    # The bundle holds the map the wrapper holds.
    back = io.load_ply(os.path.join(out, "submaps_colored.ply"), device="cpu")
    assert int(back.count()) == slam.mapper.submaps.total_num_points() > 500


def test_visualizer_node_serves_bundle(tmp_path):
    d = tmp_path / "bundle"
    d.mkdir()
    (d / "map.pcd").write_bytes(b"# fake pcd payload")
    server = visualizer_node.serve(str(d), port=0, background=True)
    try:
        host, port = server.server_address[:2]
        assert host == "127.0.0.1"
        idx = urllib.request.urlopen(f"http://127.0.0.1:{port}/", timeout=5).read().decode()
        assert "map.pcd" in idx
        body = urllib.request.urlopen(f"http://127.0.0.1:{port}/map.pcd", timeout=5).read()
        assert body == b"# fake pcd payload"
    finally:
        server.shutdown()
        server.server_close()


def test_slamwrapper_viz_worker(tmp_path):
    """The worker thread publishes while the online workers run."""
    world = synthetic.cluttered_world(3, extent=14.0, n_objects=12, device="cpu")
    gt = synthetic.straight_trajectory(3, step=0.5, start=(1.0, 0.0, 1.0))
    slam = SlamWrapper(_viz_params(), device="cpu")
    slam.set_initial_transform(gt[0])
    out = str(tmp_path / "live")
    slam.start_workers()
    slam.start_visualization(out, rate_hz=20.0)
    g = torch.Generator().manual_seed(5)
    try:
        for i in range(3):
            scan = synthetic.render_scan(world, gt[i], g, n_points=1024, max_range=10.0)
            slam.add_odometry_pose(0.1 * i, gt[i])
            while not slam.add_range_scan(scan, 0.1 * i):
                _t.sleep(0.01)
        deadline = _t.time() + 120
        while _t.time() < deadline and slam.viz_publisher.publish_count == 0:
            _t.sleep(0.05)
    finally:
        slam.stop_workers()
    assert not any(t.is_alive() for t in slam._workers)
    assert slam.viz_publisher.publish_count >= 1
    assert os.path.exists(os.path.join(out, "trajectory_tube.pcd"))


def test_http_initial_pose_endpoint(tmp_path):
    d = tmp_path / "bundle"
    d.mkdir()
    slam = SlamWrapper(_viz_params(), device="cpu")
    server = visualizer_node.serve(str(d), port=0, background=True, slam=slam)
    try:
        port = server.server_address[1]

        def post(path, payload):
            req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                         data=json.dumps(payload).encode(),
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=5) as r:
                return r.status, json.loads(r.read())

        st, _ = post("/initialpose", {"x": 2.0, "y": -1.0, "z": 0.5, "yaw": 90.0})
        assert st == 200
        T = slam.mapper.map_to_range_sensor
        np.testing.assert_allclose(T[:3, 3], [2.0, -1.0, 0.5], atol=1e-5)
        np.testing.assert_allclose(T[0, 1], -1.0, atol=1e-5)
        saved = json.loads((d / "initial_pose.json").read_text())
        np.testing.assert_allclose(saved["map_to_range_sensor"], T, atol=1e-7)
        M = np.eye(4, dtype=np.float32)
        M[:3, 3] = [7.0, 8.0, 9.0]
        st, _ = post("/initialpose", {"matrix": M.ravel().tolist()})
        assert st == 200
        np.testing.assert_allclose(slam.mapper.map_to_range_sensor[:3, 3], [7, 8, 9], atol=1e-6)
        st, out = post("/initialize_slam", {})
        assert st == 200
        np.testing.assert_allclose(np.asarray(out["pose"])[:3, 3], [7.0, 8.0, 9.0], atol=1e-6)
    finally:
        server.shutdown()
        server.server_close()


def test_adjacency_example_matches_jax():
    a, b = jadj.create_toy_example(), adjacency_example.create_toy_example()
    assert b._adj == a._adj
    for node in (0, 1, 7, 5, 3, 8, 11):
        assert b.bfs_distance(node, {10, 2}) == a.bfs_distance(node, {10, 2})
    out = text_io.StringIO()
    with contextlib.redirect_stdout(out):
        adjacency_example.main()
    assert "distance from 0 to nearest loop-closure submap" in out.getvalue()
