"""The port's core API beside the rosbag path, against the JAX package (CPU).

The new ``se3`` functions, the two repaired faults (the per-point time
phase of ``motion_compensation.undistort`` and the quaternion sign of the
TUM writer), ``pipeline.init_state``, ``mapper_step_delta``,
``chain_insert`` and ``run_sequence``, ``synthetic.corridor_world``,
``PointCloud.has_normals`` and ``SubmapCollection.total_num_points``.
Inputs are made with numpy from a seed and fed to both sides.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open3d_slam_advanced_rss_2024_public_tpu.frontends import synthetic as jsyn
from open3d_slam_advanced_rss_2024_public_tpu.models import motion_compensation as jmc
from open3d_slam_advanced_rss_2024_public_tpu.models import pipeline as jpipe
from open3d_slam_advanced_rss_2024_public_tpu.models.submap_collection import (
    SubmapCollection as JSubmaps)
from open3d_slam_advanced_rss_2024_public_tpu.ops import voxel_map as jvm
from open3d_slam_advanced_rss_2024_public_tpu.ops.registration import ICPConfig as JICPConfig
from open3d_slam_advanced_rss_2024_public_tpu.utils import io as jio
from open3d_slam_advanced_rss_2024_public_tpu.utils import pointcloud as jpc
from open3d_slam_advanced_rss_2024_public_tpu.utils import se3 as jse3
from open3d_slam_advanced_rss_2024_public_tpu.utils.config import load_parameters as jload
from open3d_slam_advanced_rss_2024_public_tpu_torch.frontends import synthetic
from open3d_slam_advanced_rss_2024_public_tpu_torch.models import motion_compensation, pipeline
from open3d_slam_advanced_rss_2024_public_tpu_torch.models.submap_collection import (
    SubmapCollection)
from open3d_slam_advanced_rss_2024_public_tpu_torch.ops import voxel_map as vm
from open3d_slam_advanced_rss_2024_public_tpu_torch.ops.registration import ICPConfig
from open3d_slam_advanced_rss_2024_public_tpu_torch.utils import io, se3
from open3d_slam_advanced_rss_2024_public_tpu_torch.utils import pointcloud as pc
from open3d_slam_advanced_rss_2024_public_tpu_torch.utils.config import load_parameters


def _poses(seed, n):
    """Random rigid transforms, float32 (test_se3.py's random_pose: a
    Gaussian rotation vector of scale 2 and a Gaussian translation)."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(n, 3)).astype(np.float32) * 2.0
    t = rng.normal(size=(n, 3)).astype(np.float32) * 3.0
    R = np.asarray(jse3.so3_exp(jnp.asarray(w)))
    return np.asarray(jse3.make_transform(jnp.asarray(R), jnp.asarray(t)))


def _yaw(deg, t=(0.0, 0.0, 0.0)):
    a = np.deg2rad(deg)
    T = np.eye(4, dtype=np.float32)
    T[:2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
    T[:3, 3] = t
    return T


# ------------------------------------------------------------------- se3

def test_se3_quaternions_and_interpolation_match_jax():
    # float32 rounding of the same formulas: within 1e-6.
    T0, T1 = _poses(2, 16).copy(), _poses(3, 16).copy()
    a = np.random.default_rng(4).uniform(0.0, 1.0, 16).astype(np.float32)
    t0, t1, ta = torch.from_numpy(T0), torch.from_numpy(T1), torch.from_numpy(a)
    j0, j1, ja = jnp.asarray(T0), jnp.asarray(T1), jnp.asarray(a)
    np.testing.assert_array_equal(se3.identity().numpy(), np.asarray(jse3.identity()))
    q0 = se3.quat_from_matrix(t0[:, :3, :3]).numpy()
    np.testing.assert_allclose(q0, np.asarray(jse3.quat_from_matrix(j0[:, :3, :3])), atol=1e-6)
    assert (q0[:, 0] >= 0).all()
    q1 = se3.quat_from_matrix(t1[:, :3, :3])
    slerp = se3.quat_slerp(torch.from_numpy(q0), q1, ta[:, None]).numpy()
    np.testing.assert_allclose(slerp, np.asarray(jse3.quat_slerp(
        jnp.asarray(q0), jnp.asarray(q1.numpy()), ja[:, None])), atol=1e-6)
    # Batched alpha (JAX's takes a scalar: one call per pose), the
    # endpoints and the midpoint's translation (test_se3.py:63-79).
    np.testing.assert_allclose(se3.interpolate(t0, t1, ta).numpy(), np.stack([
        np.asarray(jse3.interpolate(j0[i], j1[i], ja[i])) for i in range(16)]), atol=1e-6)
    for alpha in (0.0, 0.5, 1.0):
        got = se3.interpolate(t0[0], t1[0], alpha).numpy()
        np.testing.assert_allclose(got, np.asarray(
            jse3.interpolate(j0[0], j1[0], jnp.float32(alpha))), atol=1e-6)
    np.testing.assert_allclose(se3.interpolate(t0[0], t1[0], 0.0).numpy(), T0[0], atol=1e-5)
    np.testing.assert_allclose(se3.interpolate(t0[0], t1[0], 1.0).numpy(), T1[0], atol=1e-5)
    for alpha in (0.0, 1.0, 2.0, 0.3):
        got = se3.extrapolate(t0[0], t1[0], alpha).numpy()
        np.testing.assert_allclose(got, np.asarray(
            jse3.extrapolate(j0[0], j1[0], jnp.float32(alpha))), atol=1e-5)
    step = torch.from_numpy(_yaw(0.0, (1.0, 0.0, 0.0)))
    np.testing.assert_allclose(se3.translation(se3.extrapolate(se3.identity(), step, 2.0)),
                               [2.0, 0.0, 0.0], atol=1e-6)


# ----------------------------------------------------------- the repairs

def test_undistort_takes_the_time_channel_like_jax():
    # 256 points swept over 0.1 s under a twist of 0.3 rad and 1 m a sweep:
    # the azimuth phase the port took before put it up to 2.77 m from JAX.
    rng = np.random.default_rng(5)
    xyz = rng.uniform(-8.0, 8.0, (256, 3)).astype(np.float32)
    t = np.sort(rng.uniform(0.0, 0.1, 256)).astype(np.float32)
    mask = np.arange(256) % 9 != 0
    twist = np.array([0.0, 0.0, 0.3, 1.0, 0.0, 0.0], np.float32)
    jc = jpc.make_cloud(xyz, mask=mask, attrs={"t": t})
    tc = pc.make_cloud(torch.from_numpy(xyz), mask=torch.from_numpy(mask),
                       attrs={"t": torch.from_numpy(t)})
    a = np.asarray(jmc.undistort(jc, jnp.asarray(twist)).xyz)
    b = motion_compensation.undistort(tc, torch.from_numpy(twist)).xyz.numpy()
    np.testing.assert_allclose(b[mask], a[mask], atol=1e-5)
    # The oldest valid point moves by about a whole sweep, the newest not.
    first, last = np.nonzero(mask)[0][[0, -1]]
    assert np.linalg.norm(b[first] - xyz[first]) > 0.5
    assert np.linalg.norm(b[last] - xyz[last]) < 1e-4
    # Without the channel, the azimuth phase as before.
    jn = jpc.make_cloud(xyz, mask=mask)
    a = np.asarray(jmc.undistort(jn, jnp.asarray(twist)).xyz)
    b = motion_compensation.undistort(tc.without_attrs(), torch.from_numpy(twist)).xyz.numpy()
    np.testing.assert_allclose(b[mask], a[mask], atol=1e-5)


def test_tum_file_equals_jax_over_a_turn_of_yaw(tmp_path):
    yaws = list(range(-180, 181, 10)) + [-150, -179, 200]
    poses = [_yaw(y, (0.1 * i, -0.2 * i, 0.01 * i)) for i, y in enumerate(yaws)]
    times = [0.1 * i for i in range(len(poses))]
    io.save_tum_trajectory(str(tmp_path / "port"), times, poses)
    jio.save_tum_trajectory(str(tmp_path / "jax"), times, poses)
    port = (tmp_path / "port").read_bytes()
    assert port == (tmp_path / "jax").read_bytes()
    _, back = io.load_tum_trajectory(str(tmp_path / "port"))
    np.testing.assert_allclose(back, np.stack(poses), atol=1e-5)


# --------------------------------------------------------------- pipeline

N = 2048
_COMMON = dict(scan_voxel_size=0.15, scan_capacity=N, crop_min_radius=0.5,
               crop_max_radius=20.0, map_patch_capacity=8192, map_voxel_size=0.1,
               min_refinement_fitness=0.3)
JCFG = jpipe.PipelineConfig(icp=JICPConfig(matcher="bruteforce", max_iterations=12,
                                           max_correspondence_dist=0.6),
                            normal_engine="moments_interpret", **_COMMON)
TCFG = pipeline.PipelineConfig(icp=ICPConfig(matcher="bruteforce", max_iterations=12,
                                             max_correspondence_dist=0.6), **_COMMON)
STEPS = 4


@pytest.fixture(scope="module")
def corridor():
    """test_pipeline.py's scene and run_sequence deltas: a 30 m corridor, a
    straight run of 0.35 m steps with the true motion as odometry; here 4
    scans of 2048 points."""
    world = synthetic.corridor_world(11, length=30.0, device="cpu")
    gt = synthetic.straight_trajectory(STEPS, step=0.35)
    g = torch.Generator().manual_seed(5)
    scans = [synthetic.render_scan(world, T, g, n_points=N, noise=0.003) for T in gt]
    deltas = [np.eye(4, dtype=np.float32)] + [
        (np.linalg.inv(gt[i - 1]) @ gt[i]).astype(np.float32) for i in range(1, STEPS)]
    return gt, [(s.xyz.numpy(), s.normals.numpy(), s.mask.numpy()) for s in scans], deltas


def _jcloud(a):
    return jpc.PointCloud(xyz=jnp.asarray(a[0]), normals=jnp.asarray(a[1]),
                          mask=jnp.asarray(a[2]))


def _tcloud(a):
    return pc.PointCloud(torch.from_numpy(a[0]), torch.from_numpy(a[1]), torch.from_numpy(a[2]))


def test_init_state_and_run_sequence_match_jax(corridor):
    gt, arrays, deltas = corridor
    js = jpipe.init_state(1 << 14, jnp.asarray(gt[0]))
    ts = pipeline.init_state(1 << 14, gt[0], device="cpu")
    assert ts.map.capacity == js.map.capacity and int(ts.map.count()) == 0
    np.testing.assert_array_equal(ts.pose.numpy(), np.asarray(js.pose))
    np.testing.assert_array_equal(ts.last_insertion_pose.numpy(),
                                  np.asarray(js.last_insertion_pose))
    assert pipeline.init_state(64, device="cpu").pose.equal(torch.eye(4))
    # JAX's run_sequence equals its per-scan loop (test_pipeline.py:99);
    # the port's run_sequence against that loop.
    jposes = []
    for i, a in enumerate(arrays):
        js, _ = jpipe.mapper_step(js, _jcloud(a), js.pose @ jnp.asarray(deltas[i]), JCFG)
        jposes.append(np.asarray(js.pose))
    ts, tposes = pipeline.run_sequence(ts, pc.stack([_tcloud(a) for a in arrays]),
                                       torch.from_numpy(np.stack(deltas)), TCFG)
    assert tposes.shape == (STEPS, 4, 4)
    # The bounds of test_pipeline.py:118-122 for two programs of the same
    # math: the corridor constrains x weakly, so ICP turns the normals'
    # rounding (f32 against JAX's bf16 distances on the radius) into
    # millimetres; voxels within 1%, and each pose within
    # test_pipeline.py:64's 0.08 m of the truth.
    np.testing.assert_allclose(tposes.numpy(), np.stack(jposes), atol=5e-3)
    assert max(np.linalg.norm(tposes[i, :3, 3].numpy() - gt[i][:3, 3])
               for i in range(STEPS)) < 0.08
    na, nb = int(js.map.count()), int(ts.map.count())
    assert abs(na - nb) <= 0.01 * na and na > 1000


def test_mapper_step_delta_and_chain_insert(corridor):
    gt, arrays, deltas = corridor
    st = pipeline.init_state(1 << 14, gt[0], device="cpu")
    st, _ = pipeline.mapper_step(st, _tcloud(arrays[0]), st.pose, TCFG)
    a, out_a = pipeline.mapper_step(st, _tcloud(arrays[1]),
                                    st.pose @ torch.from_numpy(deltas[1]), TCFG)
    b, out_b = pipeline.mapper_step_delta(st, _tcloud(arrays[1]), torch.from_numpy(deltas[1]),
                                          TCFG)
    assert torch.equal(a.pose, b.pose) and torch.equal(a.map.acc, b.map.acc)
    assert torch.equal(out_a.inserted, out_b.inserted)
    # chain_insert against JAX's on one table: the same voxels and sums;
    # the pose chain untouched.
    cloud = arrays[2]
    js = jpipe.init_state(1 << 14, jnp.asarray(gt[2]))
    ts = pipeline.init_state(1 << 14, gt[2], device="cpu")
    js = jpipe.chain_insert(js, _jcloud(cloud), 0.1)
    ts = pipeline.chain_insert(ts, _tcloud(cloud), 0.1)
    assert int(ts.map.count()) == int(js.map.count()) > 500
    np.testing.assert_array_equal(ts.pose.numpy(), gt[2])
    ka = np.sort(np.asarray(js.map.ptable)[np.asarray(js.map.cloud.mask)])
    kb = np.sort(ts.map.ptable.numpy()[ts.map.cloud.mask.numpy()])
    np.testing.assert_array_equal(kb, ka)


# ------------------------------------------------------ world and clouds

def test_corridor_world_matches_jax_geometry():
    import jax

    length, width, height = 25.0, 8.0, 4.0
    a = jsyn.corridor_world(jax.random.PRNGKey(77), length=length)
    b = synthetic.corridor_world(77, length=length, device="cpu")
    xa, xb = np.asarray(a.xyz), b.xyz.numpy()
    assert xb.shape == xa.shape and bool(b.mask.all())
    # The same bounding box (the walls' thickness is 0.02 m)...
    np.testing.assert_allclose(xb.min(0), xa.min(0), atol=0.05)
    np.testing.assert_allclose(xb.max(0), xa.max(0), atol=0.05)
    # ... and the same share of points on each plane, the pillars the rest.
    planes = [(2, 0.0), (2, height), (1, -width / 2), (1, width / 2)]
    for axis, level in planes:
        sa = float((np.abs(xa[:, axis] - level) <= 0.021).mean())
        sb = float((np.abs(xb[:, axis] - level) <= 0.021).mean())
        assert abs(sa - sb) < 0.01, (axis, level, sa, sb)
    np.testing.assert_allclose(np.linalg.norm(b.normals.numpy(), axis=1), 1.0, atol=1e-5)


def test_has_normals_and_total_num_points():
    rng = np.random.default_rng(6)
    xyz = rng.uniform(-3, 3, (500, 3)).astype(np.float32)
    # The JAX rule: every cloud has normals (zeros when none were given).
    assert jpc.make_cloud(xyz).has_normals
    assert pc.make_cloud(torch.from_numpy(xyz)).has_normals
    jcol = JSubmaps(jload({"mapper": {"submaps": {"point_capacity": 1024}}}).mapper)
    tcol = SubmapCollection(load_parameters({"mapper": {"submaps": {"point_capacity": 1024}}})
                            .mapper, device="cpu")
    assert tcol.total_num_points() == jcol.total_num_points() == 0
    for k in range(2):
        pts = xyz + np.float32(4.0 * k)
        jcol._create_new_submap(np.eye(4, dtype=np.float32), 0.1 * k)
        tcol._create_new_submap(np.eye(4, dtype=np.float32), 0.1 * k)
        jcol.submaps[-1].map = jvm.insert(jcol.submaps[-1].map, jpc.make_cloud(pts), 0.3)
        tcol.submaps[-1].map = vm.insert(tcol.submaps[-1].map,
                                         pc.make_cloud(torch.from_numpy(pts)), 0.3)
    assert tcol.total_num_points() == jcol.total_num_points() > 100
