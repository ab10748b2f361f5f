"""The port's rosbag frontend against the JAX package's (CPU).

Bags are written in-process from seeded clouds: by both writers (the bytes
must be equal), and as hand-packed messages in the Ouster OS1's 48-byte
point layout with a u32 nanosecond time channel.  Then both readers decode
the same bags, ``rosbag_sequence`` pairs the same frames, and the port's
command line runs ``tests/test_bag_to_ate.py``'s bag and parameters on
the CPU to its bars.
"""
import bz2
import dataclasses
import json
import os
import struct

import numpy as np
import pytest
import torch

from open3d_slam_advanced_rss_2024_public_tpu.frontends import rosbag as jrb
from open3d_slam_advanced_rss_2024_public_tpu.utils import pointcloud as jpc
from open3d_slam_advanced_rss_2024_public_tpu_torch.frontends import cli, synthetic
from open3d_slam_advanced_rss_2024_public_tpu_torch.frontends import rosbag as rb
from open3d_slam_advanced_rss_2024_public_tpu_torch.utils import io
from open3d_slam_advanced_rss_2024_public_tpu_torch.utils import pointcloud as pc


def _arrays(seed, n=96):
    rng = np.random.default_rng(seed)
    xyz = rng.normal(size=(n, 3)).astype(np.float32) * 5.0
    attrs = {"intensity": rng.uniform(0, 200, n).astype(np.float32),
             "t": np.sort(rng.uniform(0, 0.1, n)).astype(np.float32),
             "r": rng.uniform(0, 1, n).astype(np.float32),
             "g": rng.uniform(0, 1, n).astype(np.float32),
             "b": rng.uniform(0, 1, n).astype(np.float32)}
    mask = np.arange(n) % 11 != 3
    return xyz, mask, attrs


def _pose(seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(-np.pi, np.pi)
    T = np.eye(4, dtype=np.float32)
    T[:2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
    T[:3, 3] = rng.normal(size=3)
    return T


def _write_both(path_jax, path_port, n_scans=3):
    jw, tw = jrb.RosbagWriter(path_jax), rb.RosbagWriter(path_port)
    for i in range(n_scans):
        xyz, mask, attrs = _arrays(i)
        jc = jpc.make_cloud(xyz, mask=mask, attrs=attrs)
        tc = pc.make_cloud(torch.from_numpy(xyz), mask=torch.from_numpy(mask),
                           attrs={k: torch.from_numpy(v) for k, v in attrs.items()})
        for w, c in ((jw, jc), (tw, tc)):
            w.write_odometry("/odom", _pose(10 + i), stamp=0.1 * i + 0.05)
            w.write_pointcloud("/points", c, stamp=0.1 * (i + 1), frame_id="os_sensor")
    jw.close()
    tw.close()


def test_writers_write_the_same_bytes_and_readers_agree(tmp_path):
    pj, pt = str(tmp_path / "jax.bag"), str(tmp_path / "port.bag")
    _write_both(pj, pt)
    assert open(pt, "rb").read() == open(pj, "rb").read()
    jm = list(jrb.RosbagReader(pj).read_messages())
    tm = list(rb.RosbagReader(pj).read_messages())
    assert [(m.topic, m.datatype, m.time) for m in tm] == [
        (m.topic, m.datatype, m.time) for m in jm]
    assert rb.RosbagReader(pj).topics() == jrb.RosbagReader(pj).topics()
    for a, b in zip(jm, tm):
        if a.topic == "/odom":
            np.testing.assert_array_equal(b.message.pose, a.message.pose)
            continue
        # Normals are always written (has_normals), then the channels; a
        # channel 't' goes out as the field 'time'.
        assert [f.name for f in b.message.fields][:6] == ["x", "y", "z", "normal_x",
                                                          "normal_y", "normal_z"]
        ca, cb = a.message.to_pointcloud(capacity=128), b.message.to_pointcloud(capacity=128,
                                                                                device="cpu")
        assert cb.attr_names == ca.attr_names == ("intensity", "t", "r", "g", "b")
        np.testing.assert_array_equal(cb.xyz.numpy(), np.asarray(ca.xyz))
        np.testing.assert_array_equal(cb.mask.numpy(), np.asarray(ca.mask))
        np.testing.assert_array_equal(cb.attrs.numpy(), np.asarray(ca.attrs))


def test_reads_a_bz2_bag_and_refuses_what_is_not_a_bag(tmp_path):
    # test_rosbag.py:93: the JAX writer's bag with its chunk recompressed.
    path = str(tmp_path / "plain.bag")
    w = jrb.RosbagWriter(path)
    xyz, mask, _ = _arrays(4, n=32)
    w.write_pointcloud("/points", jpc.make_cloud(xyz, mask=mask), stamp=1.0)
    w.write_pointcloud("/other", jpc.make_cloud(xyz), stamp=2.0)
    w.close()
    body, out, pos = open(path, "rb").read()[len(jrb._MAGIC):], bytearray(jrb._MAGIC), 0
    while pos < len(body):
        header, data, pos = jrb._read_record(body, pos)
        if header.get(b"op", b"\x00")[0] == jrb._OP_CHUNK:
            header = {b"op": bytes([jrb._OP_CHUNK]), b"compression": b"bz2",
                      b"size": struct.pack("<I", len(data))}
            data = bz2.compress(data)
        hdr = jrb._encode_header(header)
        out += struct.pack("<I", len(hdr)) + hdr + struct.pack("<I", len(data)) + data
    p2 = tmp_path / "bz2.bag"
    p2.write_bytes(bytes(out))
    msgs = list(rb.RosbagReader(str(p2)).read_messages(topics=["/points"]))
    assert len(msgs) == 1 and msgs[0].message.width == int(mask.sum())
    cloud = msgs[0].message.to_pointcloud(device="cpu")
    np.testing.assert_array_equal(cloud.xyz.numpy(), xyz[mask])
    bad = tmp_path / "x.bag"
    bad.write_bytes(b"garbage file")
    with pytest.raises(ValueError, match="not a rosbag"):
        rb.RosbagReader(str(bad))


def test_tf_imu_and_clock_decode_like_jax():
    # test_rosbag.py:133's messages.
    tf = bytearray(struct.pack("<I", 1) + struct.pack("<I", 0) + struct.pack("<II", 5, 0))
    tf += struct.pack("<I", 3) + b"map" + struct.pack("<I", 4) + b"base"
    tf += struct.pack("<3d", 1.0, 2.0, 3.0) + struct.pack("<4d", 0.1, 0.2, 0.3, 0.9)
    a, b = jrb._deserialize_tf(bytes(tf)), rb._deserialize_tf(bytes(tf))
    assert [x.child_frame_id for x in b] == [x.child_frame_id for x in a] == ["base"]
    np.testing.assert_array_equal(b[0].transform, a[0].transform)
    assert dataclasses.astuple(b[0].header) == dataclasses.astuple(a[0].header)
    imu = bytearray(struct.pack("<I", 0) + struct.pack("<II", 7, 500000000))
    imu += struct.pack("<I", 3) + b"imu"
    imu += struct.pack("<4d", 0, 0, 0, 1) + np.zeros(9).tobytes()
    imu += struct.pack("<3d", 0.1, 0.2, 0.3) + np.zeros(9).tobytes()
    imu += struct.pack("<3d", 0.0, 0.0, 9.81) + np.zeros(9).tobytes()
    a, b = jrb._deserialize_imu(bytes(imu)), rb._deserialize_imu(bytes(imu))
    assert b.header.stamp == a.header.stamp == pytest.approx(7.5)
    for f in ("orientation", "angular_velocity", "linear_acceleration"):
        np.testing.assert_array_equal(getattr(b, f), getattr(a, f))
    clock = struct.pack("<II", 3, 250000000)
    assert rb._deserialize_clock(clock).clock == jrb._deserialize_clock(clock).clock == 3.25
    T = _pose(3)
    wire = rb.serialize_odometry(T, 3.25, "odom", "base")
    assert wire == jrb.serialize_odometry(T, 3.25, "odom", "base")
    assert rb._matrix_to_quat(T) == jrb._matrix_to_quat(T)
    np.testing.assert_allclose(rb._deserialize_odometry(wire).pose, T, atol=1e-6)


# The Ouster OS1 point layout: 48 bytes a point.
OUSTER_FIELDS = [("x", 0, 7), ("y", 4, 7), ("z", 8, 7), ("intensity", 16, 7), ("t", 20, 6),
                 ("reflectivity", 24, 4), ("ring", 26, 4), ("ambient", 28, 4),
                 ("range", 32, 6)]


def ouster_message(xyz, t, intensity, stamp, frame_id="os_sensor", t_type="u4"):
    """A PointCloud2 in the Ouster layout, packed by hand (one row a
    channel of 1024 columns, or one row where ``n`` is no multiple of
    1024), with ``t`` in the given wire type."""
    n = xyz.shape[0]
    t_code = {"u4": 6, "f4": 7}[t_type]
    fields = [(name, off, t_code if name == "t" else code) for name, off, code in OUSTER_FIELDS]
    dt = np.dtype({"names": [f[0] for f in fields],
                   "formats": ["f4", "f4", "f4", "f4", t_type, "u2", "u2", "u2", "u4"],
                   "offsets": [f[1] for f in fields], "itemsize": 48})
    rec = np.zeros(n, dt)
    rec["x"], rec["y"], rec["z"] = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    rec["intensity"], rec["t"] = intensity, t
    rec["ring"] = np.arange(n) // 1024
    rec["range"] = (np.linalg.norm(np.nan_to_num(xyz), axis=1) * 1000).astype(np.uint32)
    body = rec.tobytes()
    secs, nsecs = jrb._split_ros_time(stamp)
    out = bytearray(struct.pack("<III", 0, secs, nsecs))
    out += struct.pack("<I", len(frame_id)) + frame_id.encode()
    height = n // 1024 if n % 1024 == 0 else 1
    out += struct.pack("<II", height, n // height) + struct.pack("<I", len(fields))
    for name, off, code in fields:
        out += struct.pack("<I", len(name)) + name.encode() + struct.pack("<IBI", off, code, 1)
    out += struct.pack("<B", 0) + struct.pack("<II", 48, 48 * n // height)
    out += struct.pack("<I", len(body)) + body + struct.pack("<B", 1)
    return bytes(out)


@pytest.mark.parametrize("t_type,scale", [("u4", 1e9), ("u4", 1e6), ("f4", 1.0)])
def test_time_channel_normalised_like_jax(t_type, scale):
    # Ouster's u32 ns, a sensor's u32 us and Velodyne's f32 s: seconds from
    # the first finite point, as JAX's rosbag.py:244-253.
    rng = np.random.default_rng(7)
    n = 2048
    xyz = rng.normal(size=(n, 3)).astype(np.float32) * 10.0
    xyz[::97] = np.nan
    t = 0.5 + np.arange(n) / n * 0.1
    wire = ouster_message(xyz, (t * scale).astype(t_type), rng.uniform(0, 100, n), 12.5,
                          t_type=t_type)
    a = jrb._deserialize_pointcloud2(wire).to_pointcloud(capacity=4096)
    b = rb._deserialize_pointcloud2(wire).to_pointcloud(capacity=4096, device="cpu")
    assert b.attr_names == a.attr_names == ("intensity", "t")
    np.testing.assert_array_equal(b.mask.numpy(), np.asarray(a.mask))
    np.testing.assert_array_equal(b.attr("t").numpy(), np.asarray(a.attr("t")))
    valid = b.mask.numpy()
    assert abs(b.attr("t").numpy()[valid].max() - 0.1) < 1e-3


def test_ouster_layout_decodes_to_jax_arrays():
    rng = np.random.default_rng(8)
    n = 4096
    xyz = rng.normal(size=(n, 3)).astype(np.float32) * 20.0
    t = (np.arange(n) % 1024 * 97656).astype(np.uint32)  # 1024 columns in 0.1 s
    wire = ouster_message(xyz, t, rng.uniform(0, 3000, n).astype(np.float32), 3.0)
    a, b = jrb._deserialize_pointcloud2(wire), rb._deserialize_pointcloud2(wire)
    assert (b.height, b.width, b.point_step) == (a.height, a.width, a.point_step) == (4, 1024, 48)
    ca, cb = a.to_arrays(), b.to_arrays()
    assert list(cb) == list(ca) == [f[0] for f in OUSTER_FIELDS]
    for k in ca:
        assert cb[k].dtype == ca[k].dtype
        np.testing.assert_array_equal(cb[k], ca[k])
    pa, pb = a.to_pointcloud(), b.to_pointcloud(device="cpu")
    np.testing.assert_array_equal(pb.xyz.numpy(), np.asarray(pa.xyz))
    np.testing.assert_array_equal(pb.attrs.numpy(), np.asarray(pa.attrs))


def test_rosbag_sequence_matches_jax_and_raises_beyond_its_lanes(tmp_path):
    pj, pt = str(tmp_path / "jax.bag"), str(tmp_path / "port.bag")
    _write_both(pj, pt, n_scans=4)
    a = list(jrb.rosbag_sequence(pj, "/points", odometry_topic="/odom", capacity=256))
    b = list(rb.rosbag_sequence(pt, "/points", odometry_topic="/odom", capacity=256,
                                device="cpu"))
    assert [f.time for f in b] == [f.time for f in a] and len(b) == 4
    for fa, fb in zip(a, b):
        np.testing.assert_array_equal(fb.scan.xyz.numpy(), np.asarray(fa.scan.xyz))
        np.testing.assert_array_equal(fb.scan.attrs.numpy(), np.asarray(fa.scan.attrs))
        np.testing.assert_allclose(fb.odom_pose, fa.odom_pose, atol=1e-6)
    # The JAX CLI's lanes: a scan of 32769 points raises in both.
    w = rb.RosbagWriter(str(tmp_path / "big.bag"))
    w.write("/points", "sensor_msgs/PointCloud2", 1.0, ouster_message(
        np.ones((32769, 3), np.float32), np.zeros(32769, np.uint32),
        np.zeros(32769, np.float32), 1.0))
    w.close()
    with pytest.raises(ValueError, match="capacity 32768 < points 32769"):
        list(jrb.rosbag_sequence(str(tmp_path / "big.bag"), "/points"))
    with pytest.raises(ValueError, match="capacity 32768 < points 32769"):
        list(rb.rosbag_sequence(str(tmp_path / "big.bag"), "/points", device="cpu"))


def _write_synthetic_bag(path, n_steps=10, drift=0.004):
    """test_bag_to_ate.py's bag: corridor scans along a straight run and a
    drifting odometry 10 ms before and after each cloud."""
    world = synthetic.corridor_world(77, length=25.0, device="cpu")
    gt = synthetic.straight_trajectory(n_steps, step=0.4)
    odom = synthetic.perturb_odometry(gt, drift_per_step=drift, seed=3)
    g = torch.Generator().manual_seed(78)
    w = rb.RosbagWriter(path)
    for i in range(n_steps):
        t = 0.1 * (i + 1)
        scan = synthetic.render_scan(world, gt[i], g, n_points=2048, noise=0.003)
        w.write_odometry("/odom", odom[i], stamp=t - 0.01)
        w.write_pointcloud("/points", scan, stamp=t)
        w.write_odometry("/odom", odom[i], stamp=t + 0.01)
    w.close()
    return gt


def test_cli_replays_a_bag_to_its_ate_bar(tmp_path):
    bag, out = str(tmp_path / "run.bag"), str(tmp_path / "out")
    gt = _write_synthetic_bag(bag)
    params = {"mapper": {
        "mapper_localizer": {"scan_to_map_registration": {
            "scan_to_map_refinement_type": "PointToPlaneIcp",
            "icp": {"max_n_iter": 12, "max_correspondence_dist": 0.6},
            "scan_processing": {"voxel_size": 0.15, "point_capacity": 2048,
                                "scan_cropping": {"cropping_radius_max": 18.0,
                                                  "cropping_radius_min": 0.5}},
            "map_patch_capacity": 8192}},
        "submaps": {"point_capacity": 16384}}}
    params_file = tmp_path / "params.json"
    params_file.write_text(json.dumps(params))
    rc = cli.main(["--dataset", "rosbag", "--bag", bag, "--cloud-topic", "/points",
                   "--odometry-topic", "/odom", "--params", str(params_file),
                   "--output", out, "--device", "cpu"])
    assert rc == 0
    assert os.path.exists(os.path.join(out, "pose_graph.json"))
    times, poses = io.load_tum_trajectory(os.path.join(out, "slam_poses"))
    assert len(times) == len(gt) == 10
    ate = io.ate_rmse(np.asarray(poses), np.stack(gt), align=False)
    assert ate < 0.08, f"bag->SLAM->ATE regression: {ate:.3f} m"
    map_cloud = io.load_pcd(os.path.join(out, "map.pcd"), capacity=65536, device="cpu")
    assert int(map_cloud.mask.sum()) > 1500
