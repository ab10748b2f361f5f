"""The rest of the ICP surface of the PyTorch port against the JAX package
(CPU): every outlier filter, every minimizer and the solution covariances,
``register`` for each minimizer, kNN matching, an outlier chain and the
bound checker, ``register_with_covariance``, and the GICP scan-to-scan
odometry that the package's default parameters select.

Each registration runs the JAX package's brute-force matcher against the
port on its brute-force matcher and on kernel K1's twin (what "auto"
resolves to), from the same numpy scene.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_icp import _pose_gap, _scene

from open3d_slam_advanced_rss_2024_public_tpu.models.odometry import LidarOdometry as JOdometry
from open3d_slam_advanced_rss_2024_public_tpu.ops import hashgrid as jhashgrid
from open3d_slam_advanced_rss_2024_public_tpu.ops.registration import icp as jicp
from open3d_slam_advanced_rss_2024_public_tpu.ops.registration import minimizers as jmin
from open3d_slam_advanced_rss_2024_public_tpu.ops.registration import outliers as jout
from open3d_slam_advanced_rss_2024_public_tpu.utils.config import load_parameters as jload
from open3d_slam_advanced_rss_2024_public_tpu.utils.pointcloud import make_cloud as jmake
from open3d_slam_advanced_rss_2024_public_tpu_torch.frontends import synthetic
from open3d_slam_advanced_rss_2024_public_tpu_torch.models import odometry
from open3d_slam_advanced_rss_2024_public_tpu_torch.models.odometry import LidarOdometry
from open3d_slam_advanced_rss_2024_public_tpu_torch.ops import hashgrid
from open3d_slam_advanced_rss_2024_public_tpu_torch.ops.registration import icp
from open3d_slam_advanced_rss_2024_public_tpu_torch.ops.registration import minimizers, outliers
from open3d_slam_advanced_rss_2024_public_tpu_torch.utils import convert
from open3d_slam_advanced_rss_2024_public_tpu_torch.utils import pointcloud as pc


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _j(x):
    return jnp.asarray(x)


@pytest.fixture(scope="module")
def match_set():
    rng = np.random.default_rng(21)
    n = 2001
    d2 = rng.exponential(0.05, n).astype(np.float32)
    found = rng.uniform(size=n) > 0.2
    slot = found | (rng.uniform(size=n) > 0.5)
    pp = (d2 * rng.uniform(0.0, 1.0, n)).astype(np.float32)
    return d2, found, slot, pp


@pytest.mark.parametrize("name,params", [
    ("max_dist", (0.3,)), ("min_dist", (0.05,)), ("median", (1.5,)), ("median", (0.7,)),
    ("var_trimmed", (0.05, 0.99, 0.95)), ("var_trimmed", (0.3, 0.9, 0.8)),
])
def test_zero_one_filters_equal_jax(match_set, name, params):
    d2, found, slot, _ = match_set
    fn = {"max_dist": "max_dist_weights", "min_dist": "min_dist_weights",
          "median": "median_dist_weights", "var_trimmed": "var_trimmed_dist_weights"}[name]
    kw = {"slot_mask": slot} if name == "median" else {}
    a = getattr(jout, fn)(_j(d2), _j(found), *params, **{k: _j(v) for k, v in kw.items()})
    b = getattr(outliers, fn)(_t(d2), _t(found), *params, **{k: _t(v) for k, v in kw.items()})
    np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert 0 < int(b.sum()) < int(found.sum()) or name == "min_dist"


@pytest.mark.parametrize("n", [1, 2, 7, 8, 1000, 1001])
def test_nanmedian_and_nanstd_have_numpy_semantics(n):
    rng = np.random.default_rng(n)
    x = rng.normal(size=(3, 1024)).astype(np.float32)
    x[:, n:] = np.nan
    x[2] = np.nan  # a row with no value left
    med, std = outliers.nanmedian(_t(x)).numpy(), outliers.nanstd(_t(x)).numpy()
    with np.errstate(all="ignore"), pytest.warns(RuntimeWarning):
        np.testing.assert_allclose(med, np.nanmedian(x, axis=-1), rtol=1e-6)
        np.testing.assert_allclose(std, np.nanstd(x, axis=-1), rtol=1e-5)
    np.testing.assert_allclose(med[:2], np.asarray(jnp.nanmedian(_j(x[:2]), axis=-1)), rtol=1e-6)


@pytest.mark.parametrize("kind", ["cauchy", "welsch", "switchable", "gemanmcclure", "tukey",
                                  "huber", "l1", "student"])
def test_robust_weights_match_jax(match_set, kind):
    d2, found, _, pp = match_set
    for scale in ("none", "mad", "std", "berg"):
        for dist_type, approx in (("point2point", float("inf")), ("point2plane", 0.6)):
            args = dict(scale_estimator=scale, distance_type=dist_type, approximation=approx)
            a = jout.robust_weights(_j(d2), _j(found), kind, 2.0, p2plane_sq=_j(pp), **args)
            b = outliers.robust_weights(_t(d2), _t(found), kind, 2.0, p2plane_sq=_t(pp), **args)
            np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6, rtol=1e-6)
    for scale in ("mad", "std", "berg"):
        np.testing.assert_allclose(
            outliers.robust_scale(_t(d2), _t(found), scale).numpy(),
            np.asarray(jout.robust_scale(_j(d2), _j(found), scale)), rtol=1e-6)


@pytest.fixture(scope="module")
def pairs():
    """Correspondences in a de-meaned frame: src, ref a little moved,
    normals, covariances of both disks and weights."""
    rng = np.random.default_rng(6)
    n = 2000
    src = rng.normal(scale=3.0, size=(n, 3)).astype(np.float32)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    ref = (src + rng.normal(scale=0.03, size=(n, 3))).astype(np.float32)
    w = (rng.uniform(size=n) > 0.3).astype(np.float32)
    nrm2 = nrm + rng.normal(scale=0.05, size=(n, 3)).astype(np.float32)
    nrm2 /= np.linalg.norm(nrm2, axis=1, keepdims=True)
    cov = lambda v: np.eye(3, dtype=np.float32) - 0.999 * v[:, :, None] * v[:, None, :]
    return src, ref, nrm, w, cov(nrm), cov(nrm2)


def _close(a, b):
    # xi within 1e-5 absolute or 1e-4 relative.
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("case", ["plane", "plane4dof", "plane2d", "point", "umeyama",
                                  "similarity", "gicp", "cov_plane", "cov_point"])
def test_minimizers_match_jax(pairs, case):
    src, ref, nrm, w, cs, cr = pairs
    J, T = (_j(src), _j(ref), _j(nrm), _j(w)), (_t(src), _t(ref), _t(nrm), _t(w))
    if case.startswith("plane"):
        kw = {"force4dof": case == "plane4dof", "force2d": case == "plane2d"}
        a, b = jmin.point_to_plane_step(*J, **kw), minimizers.point_to_plane_step(*T, **kw)
    elif case == "point":
        a = jmin.point_to_point_step(J[0], J[1], J[3])
        b = minimizers.point_to_point_step(T[0], T[1], T[3])
    elif case in ("umeyama", "similarity"):
        scaled = (ref * np.float32(1.02)).astype(np.float32)
        s = case == "similarity"
        a = jmin.point_to_point_umeyama(J[0], _j(scaled), J[3], with_scale=s)
        b = minimizers.point_to_point_umeyama(T[0], _t(scaled), T[3], with_scale=s)
    elif case == "gicp":
        a = jmin.gicp_step(J[0], J[1], _j(cs), _j(cr), J[3])
        b = minimizers.gicp_step(T[0], T[1], _t(cs), _t(cr), T[3])
    elif case == "cov_plane":
        a = (jmin.point_to_plane_covariance(J[0], J[2], J[3]),)
        b = (minimizers.point_to_plane_covariance(T[0], T[2], T[3]),)
    else:
        a = (jmin.point_to_point_covariance(J[0], J[3]),)
        b = (minimizers.point_to_point_covariance(T[0], T[3]),)
    for x, y in zip(a, b):
        if case.startswith("cov"):
            np.testing.assert_allclose(y.numpy(), np.asarray(x), rtol=1e-4,
                                       atol=1e-4 * float(np.abs(np.asarray(x)).max()))
        else:
            _close(x, y.numpy())


_FULL = {"min_diff_rot": 0.0, "min_diff_trans": 0.0}
_CHAIN = (("median", 3.0), ("robust", "cauchy", 1.0, "mad", "point2point", float("inf")),
          ("surface_normal", 1.2), ("min_dist", 0.0), ("null",))


_CFGS = {
    "point": dict(minimizer="point_to_point", max_iterations=8, **_FULL),
    "gicp": dict(minimizer="gicp", use_normal_gate=False),
    "gicp_full": dict(minimizer="gicp", use_normal_gate=False, max_iterations=10, **_FULL),
    "similarity": dict(minimizer="similarity", max_iterations=8, **_FULL),
    "identity": dict(minimizer="identity", max_iterations=4),
    "4dof": dict(force4dof=True, max_iterations=10, **_FULL),
    "2d": dict(force2d=True, max_iterations=10, **_FULL),
    "knn3": dict(knn=3, max_iterations=10, **_FULL),
    "chain": dict(outlier_chain=_CHAIN, max_iterations=10, **_FULL),
    "var_trimmed": dict(outlier_chain=(("var_trimmed", 0.1, 0.95, 0.9), ("max_dist", 0.4)),
                        max_iterations=8, **_FULL),
    "bound": dict(bound_max_trans=0.03, bound_max_rot=0.2, max_iterations=10),
}


@pytest.fixture(scope="module")
def register_scene():
    """The scene, and the JAX package's result per configuration (computed
    once, for both of the port's matchers)."""
    scene = _scene(3, [0.06, -0.04, 0.02], [0.004, -0.003, 0.012])
    (mx, mn), (sx, sn, sm), _, init = scene
    jgrid = jhashgrid.passthrough(jmake(mx, normals=mn, mask=np.abs(mx[:, 0]) < 1e7), 0.5)
    results = {}

    def jax_result(name):
        if name not in results:
            results[name] = jicp.register(jmake(sx, normals=sn, mask=sm), jgrid, _j(init),
                                          jicp.ICPConfig(matcher="bruteforce", **_CFGS[name]))
        return results[name]
    return scene, jax_result


@pytest.mark.parametrize("matcher", ["bruteforce", "cuda"])
@pytest.mark.parametrize("name", list(_CFGS))
def test_register_matches_jax(register_scene, name, matcher):
    scene, jax_result = register_scene
    (mx, mn), (sx, sn, sm), _, init = scene
    cfg = _CFGS[name]
    jres = jax_result(name)
    grid = hashgrid.passthrough(pc.PointCloud(_t(mx), _t(mn), _t(np.abs(mx[:, 0]) < 1e7)), 0.5)
    tres = icp.register(pc.PointCloud(_t(sx), _t(sn), _t(sm)), grid, _t(init),
                        icp.ICPConfig(matcher=matcher, **cfg))
    assert int(tres.iterations) == int(jres.iterations)
    assert bool(tres.converged) == bool(jres.converged)
    assert bool(tres.diverged) == bool(jres.diverged)
    assert bool(tres.diverged) == ("bound_max_trans" in cfg)
    dt, da = _pose_gap(jres.transform, tres.transform.numpy())
    assert dt < 1e-4 and da < 1e-4, (dt, da)
    np.testing.assert_allclose(float(tres.match_ratio), float(jres.match_ratio), atol=2e-3)


def test_register_with_covariance_and_evaluation_match_jax():
    (mx, mn), (sx, sn, sm), _, init = _scene(4, [0.05, -0.03, 0.0], [0.0, 0.0, 0.01])
    for minimizer in ("point_to_plane", "point_to_point"):
        cfg = dict(minimizer=minimizer, max_iterations=8, **_FULL)
        jref = jmake(mx, normals=mn, mask=np.abs(mx[:, 0]) < 1e7)
        jres, jcov = jicp.register_with_covariance(
            jmake(sx, normals=sn, mask=sm), jhashgrid.passthrough(jref, 0.5), _j(init),
            jicp.ICPConfig(matcher="bruteforce", **cfg))
        grid = hashgrid.passthrough(pc.PointCloud(_t(mx), _t(mn), _t(np.abs(mx[:, 0]) < 1e7)),
                                    0.5)
        src = pc.PointCloud(_t(sx), _t(sn), _t(sm))
        tres, tcov = icp.register_with_covariance(src, grid, _t(init),
                                                  icp.ICPConfig(matcher="cuda", **cfg))
        assert int(tres.iterations) == int(jres.iterations)
        np.testing.assert_allclose(tcov.numpy(), np.asarray(jcov), rtol=1e-4,
                                   atol=1e-4 * float(np.abs(np.asarray(jcov)).max()))
        fit_j = jicp.evaluate_registration(jmake(sx, normals=sn, mask=sm),
                                           jhashgrid.passthrough(jref, 0.5), jres.transform, 0.3)
        fit_t = icp.evaluate_registration(src, grid, tres.transform, 0.3)
        np.testing.assert_allclose([float(x) for x in fit_t], [float(x) for x in fit_j],
                                   rtol=1e-3)


def test_register_clouds_builds_the_hashed_grid():
    # One-shot registration builds the hashed grid of the reference and
    # matches it by brute force; the JAX package does the same.
    (mx, mn), (sx, sn, sm), pose, init = _scene(7, [0.04, 0.02, 0.0], [0.0, 0.002, 0.008])
    cfg = dict(max_iterations=10, **_FULL)
    jres = jicp.register_clouds(jmake(sx, normals=sn, mask=sm),
                                jmake(mx, normals=mn, mask=np.abs(mx[:, 0]) < 1e7), _j(init),
                                jicp.ICPConfig(**cfg))
    tres = icp.register_clouds(pc.PointCloud(_t(sx), _t(sn), _t(sm)),
                               pc.PointCloud(_t(mx), _t(mn), _t(np.abs(mx[:, 0]) < 1e7)),
                               _t(init), icp.ICPConfig(**cfg))
    dt, da = _pose_gap(jres.transform, tres.transform.numpy())
    assert dt < 1e-4 and da < 1e-4
    assert _pose_gap(pose, tres.transform.numpy())[0] < 0.03


ODOM_SCANS = 6


def _odometry_overrides(registration):
    return {"odometry": {"scan_matching": {"cloud_registration_type": registration,
                                           "icp": {"max_n_iter": 20}},
                         # Every voxel of the 2048-point scans fits.
                         "scan_processing": {"voxel_size": 0.15, "point_capacity": 2048}}}


@pytest.mark.parametrize("registration", ["GeneralizedIcp", "PointToPlaneIcp"])
def test_lidar_odometry_matches_jax(registration):
    # The package default, GICP, and point-to-plane, on both sides with kNN
    # normals (the JAX package's engine on the CPU).  Point-to-point is held
    # to the JAX package in ``test_register_matches_jax``.
    world = synthetic.cluttered_world(3, extent=24.0, n_objects=30, device="cpu")
    gt = synthetic.straight_trajectory(ODOM_SCANS, step=0.35, yaw_rate=0.02,
                                       start=(4.0, 0.0, 1.0))
    g = torch.Generator().manual_seed(4)
    scans = [synthetic.render_scan(world, gt[i], g, n_points=2048, max_range=14.0,
                                   noise=0.003) for i in range(ODOM_SCANS)]
    # GICP within 1 mm and 1 mrad a step.  Point-to-plane within 5: its
    # normal gate and the differential checker's 1 cm step test turn 1e-7
    # differences into a trip more or less (2.1 mm measured at scan 4), as
    # ``test_torch_mapper.py`` sets out for the Mapper.
    tol = 1e-3 if registration == "GeneralizedIcp" else 5e-3
    over = _odometry_overrides(registration)
    jodo = JOdometry(jload(over))
    todo = LidarOdometry(convert.params_from_dict(over), device="cpu")
    assert todo.icp_cfg.minimizer == jodo.icp_cfg.minimizer
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(odometry.scan_processing, "preprocess_scan",
                   functools.partial(odometry.scan_processing.preprocess_scan,
                                     normal_engine="knn"))
        for i, s in enumerate(scans):
            assert jodo.add_range_scan(jmake(s.xyz.numpy(), mask=s.mask.numpy()), 0.1 * i)
            assert todo.add_range_scan(s, 0.1 * i)
            dt, da = _pose_gap(jodo.odom_to_range_sensor, todo.odom_to_range_sensor)
            assert dt < tol and da < tol, (i, dt, da)
    assert todo.rejected_jumps == todo.low_fitness == 0
    rel = np.linalg.inv(gt[0]) @ gt[-1]
    assert np.linalg.norm(todo.odom_to_range_sensor[:3, 3] - rel[:3, 3]) < 0.05


def test_default_parameters_select_gicp_on_the_kernel_matcher():
    todo = LidarOdometry(convert.params_from_dict({}), device="cpu")
    assert todo.icp_cfg.minimizer == "gicp" and todo.icp_cfg.matcher == "cuda"
    icp.check_supported(todo.icp_cfg)
