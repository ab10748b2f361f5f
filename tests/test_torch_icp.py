"""ICP of the PyTorch port against the JAX package (CPU).

The same numpy scene (map cloud + normals, source scan + normals, initial
guess) goes through ``icp.register`` on both sides with the brute-force
matcher; the port's fixed-trip loop with on-device stopping must give the
while loop's iteration count and transform.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open3d_slam_advanced_rss_2024_public_tpu.ops import hashgrid as jhashgrid
from open3d_slam_advanced_rss_2024_public_tpu.ops.registration import icp as jicp
from open3d_slam_advanced_rss_2024_public_tpu.ops.registration import minimizers as jmin
from open3d_slam_advanced_rss_2024_public_tpu.ops.registration import outliers as jout
from open3d_slam_advanced_rss_2024_public_tpu.utils import se3 as jse3
from open3d_slam_advanced_rss_2024_public_tpu.utils.pointcloud import make_cloud as jmake
from open3d_slam_advanced_rss_2024_public_tpu_torch.frontends import synthetic
from open3d_slam_advanced_rss_2024_public_tpu_torch.ops import filters, hashgrid, normals
from open3d_slam_advanced_rss_2024_public_tpu_torch.ops.registration import icp
from open3d_slam_advanced_rss_2024_public_tpu_torch.ops.registration import minimizers, outliers
from open3d_slam_advanced_rss_2024_public_tpu_torch.utils import pointcloud as pc
from open3d_slam_advanced_rss_2024_public_tpu_torch.utils import se3


def _scene(seed, err_t, err_w, n_src=2048, n_map=4096):
    """numpy arrays: Morton-sorted map (xyz, normals) in world frame, a
    source scan (xyz, normals, mask) in sensor frame, its true pose and
    an initial guess off by (err_w, err_t)."""
    world = synthetic.cluttered_world(seed, extent=20.0, n_objects=20, device="cpu")
    g = torch.Generator().manual_seed(seed)
    pose_map = np.eye(4, dtype=np.float32)
    pose_map[:3, 3] = [10.0, 0.0, 1.0]
    scan = synthetic.render_scan(world, pose_map, g, n_points=n_map, max_range=15.0,
                                 noise=0.002).transform(torch.from_numpy(pose_map))
    mp = filters.voxel_downsample(scan, 0.1, n_map)
    mp = hashgrid.morton_sort(normals.estimate_normals_radius(
        mp, 0.5, sensor_origin=pose_map[:3, 3]), 0.5)
    pose_src = pose_map.copy()
    pose_src[:3, 3] += [0.3, -0.2, 0.05]
    src = synthetic.render_scan(world, pose_src, g, n_points=n_src, max_range=15.0,
                                noise=0.003)
    src = hashgrid.morton_sort(normals.estimate_normals_radius(
        filters.voxel_downsample(src, 0.1, n_src), 0.5), 0.5)
    T_err = jse3.make_transform(jse3.so3_exp(jnp.asarray(err_w, jnp.float32)),
                                jnp.asarray(err_t, jnp.float32))
    init = (pose_src @ np.asarray(T_err)).astype(np.float32)
    return ((mp.xyz.numpy(), mp.normals.numpy()),
            (src.xyz.numpy(), src.normals.numpy(), src.mask.numpy()), pose_src, init)


def _register_both(scene, matcher="bruteforce", **cfg):
    (mx, mn), (sx, sn, sm), _, init = scene
    jgrid = jhashgrid.passthrough(jmake(mx, normals=mn, mask=np.abs(mx[:, 0]) < 1e7), 0.5)
    jres = jicp.register(jmake(sx, normals=sn, mask=sm), jgrid, jnp.asarray(init),
                         jicp.ICPConfig(matcher="bruteforce", **cfg))
    tgrid = hashgrid.passthrough(pc.PointCloud(torch.from_numpy(mx), torch.from_numpy(mn),
                                               torch.from_numpy(np.abs(mx[:, 0]) < 1e7)), 0.5)
    tres = icp.register(pc.PointCloud(torch.from_numpy(sx), torch.from_numpy(sn),
                                      torch.from_numpy(sm)),
                        tgrid, torch.from_numpy(init), icp.ICPConfig(matcher=matcher, **cfg))
    return jres, tres


def _pose_gap(a, b):
    """(translation gap m, rotation gap rad); the angle from
    ||Ra - Rb||_F = 2 sqrt(2) sin(theta / 2), which stays accurate at small
    angles where arccos of the trace loses it."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    fro = np.linalg.norm(a[:3, :3] - b[:3, :3])
    return np.linalg.norm(a[:3, 3] - b[:3, 3]), 2 * np.arcsin(min(fro / (2 * np.sqrt(2)), 1.0))


# JAX ranks candidates by |q|^2+|p|^2-2q.p, the port by the exact float32
# sum of squares: where two candidates lie within ~1e-6 m^2 the two may pick
# differently, and at a corner the two candidates' normals differ.  One
# flipped correspondence moves the transform of an iteration by up to
# ~1.2e-4 m (measured over seeds 0-9); later iterations pull both back to
# the same fixed point (1e-7).  So runs over the full iteration budget are
# held to 1e-4 m, runs the differential checker stops early to 2e-4 m.
_FULL = {"min_diff_rot": 0.0, "min_diff_trans": 0.0}


@pytest.mark.parametrize("seed,err_t,err_w,cfg,tol_m", [
    (0, [0.06, -0.04, 0.02], [0.005, -0.004, 0.01], _FULL, 1e-4),
    (1, [0.10, 0.05, -0.03], [0.0, 0.0, 0.02], _FULL, 1e-4),
    (2, [0.03, 0.02, 0.0], [0.002, 0.0, -0.01], dict(_FULL, trimmed_ratio=0.8), 1e-4),
    (3, [0.05, 0.05, 0.0], [0.0, 0.0, 0.01], {}, 2e-4),
    (9, [0.06, -0.04, 0.02], [0.005, -0.004, 0.01], {"max_iterations": 8}, 2e-4),
])
def test_register_matches_jax(seed, err_t, err_w, cfg, tol_m):
    scene = _scene(seed, err_t, err_w)
    jres, tres = _register_both(scene, **cfg)
    # The while loop and the fixed-trip loop stop at the same iteration.
    assert int(tres.iterations) == int(jres.iterations)
    assert bool(tres.converged) == bool(jres.converged)
    dt, da = _pose_gap(jres.transform, tres.transform.numpy())
    assert dt < tol_m and da < 1e-4, (dt, da)
    np.testing.assert_allclose(float(tres.match_ratio), float(jres.match_ratio), atol=2e-3)
    # And both recover the true pose to ICP accuracy.
    assert _pose_gap(scene[2], tres.transform.numpy())[0] < 0.03


def test_register_kernel_matcher_on_cpu_equals_bruteforce():
    # On CPU tensors the kernel matcher ("cuda", alias "pallas") runs K1's
    # twin, which is the brute-force sweep: identical results.
    scene = _scene(4, [0.05, -0.03, 0.0], [0.0, 0.0, 0.01])
    _, a = _register_both(scene, matcher="bruteforce")
    _, b = _register_both(scene, matcher="pallas")
    assert torch.equal(a.transform, b.transform)
    assert int(a.iterations) == int(b.iterations)


@pytest.mark.parametrize("matcher", ["cuda", "bruteforce"])
def test_register_with_prepared_reference_returns_the_same_result(matcher):
    # What the matcher derives from the reference is prepared once for all
    # registrations against a grid; handing it in changes nothing.
    (mx, mn), (sx, sn, sm), _, init = _scene(6, [0.05, 0.02, -0.01], [0.0, 0.003, 0.01])
    grid = hashgrid.passthrough(pc.PointCloud(torch.from_numpy(mx), torch.from_numpy(mn),
                                              torch.from_numpy(np.abs(mx[:, 0]) < 1e7)), 0.5)
    src = pc.PointCloud(torch.from_numpy(sx), torch.from_numpy(sn), torch.from_numpy(sm))
    cfg = icp.ICPConfig(matcher=matcher)
    nn_ref = icp.prepare_reference(cfg, grid)
    assert (nn_ref is None) == (matcher == "bruteforce")
    if nn_ref is not None:
        assert nn_ref.points is grid.points
    a = icp.register(src, grid, torch.from_numpy(init), cfg)
    b = icp.register(src, grid, torch.from_numpy(init), cfg, nn_ref)
    for f in ("transform", "iterations", "converged", "match_ratio", "rmse", "diverged"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert int(a.iterations) >= 3


def test_outlier_weights_match_jax():
    rng = np.random.default_rng(5)
    n = 3000
    d2 = rng.exponential(0.05, n).astype(np.float32)
    found = rng.uniform(size=n) > 0.2
    slot = found | (rng.uniform(size=n) > 0.5)
    for ratio in (0.5, 0.9, 1.0):
        a = jout.trimmed_dist_weights(jnp.asarray(d2), jnp.asarray(found), ratio,
                                      slot_mask=jnp.asarray(slot))
        b = outliers.trimmed_dist_weights(torch.from_numpy(d2), torch.from_numpy(found), ratio,
                                          slot_mask=torch.from_numpy(slot))
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))  # a sort and a compare: exact
    sn = rng.normal(size=(n, 3)).astype(np.float32)
    rn = rng.normal(size=(n, 3)).astype(np.float32)
    sn[::10] = 0.0
    a = jout.surface_normal_weights(jnp.asarray(sn), jnp.asarray(rn), jnp.asarray(found), 1.0)
    b = outliers.surface_normal_weights(torch.from_numpy(sn), torch.from_numpy(rn),
                                        torch.from_numpy(found), 1.0)
    np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_point_to_plane_step_matches_jax():
    rng = np.random.default_rng(6)
    n = 2000
    src = rng.normal(scale=5.0, size=(n, 3)).astype(np.float32)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    ref = (src + rng.normal(scale=0.05, size=(n, 3))).astype(np.float32)
    w = (rng.uniform(size=n) > 0.3).astype(np.float32)
    xa, ma = jmin.point_to_plane_step(jnp.asarray(src), jnp.asarray(ref), jnp.asarray(nrm),
                                      jnp.asarray(w))
    xb, mb = minimizers.point_to_plane_step(torch.from_numpy(src), torch.from_numpy(ref),
                                            torch.from_numpy(nrm), torch.from_numpy(w))
    # A 6x6 float32 solve of sums over 2000 terms in another order.
    np.testing.assert_allclose(xb.numpy(), np.asarray(xa), atol=2e-5)
    np.testing.assert_allclose(float(mb), float(ma), rtol=1e-5)
    A = rng.normal(size=(6, 6)).astype(np.float32)
    A = A @ A.T
    b = rng.normal(size=6).astype(np.float32)
    np.testing.assert_allclose(minimizers.solve_6x6(torch.from_numpy(A), torch.from_numpy(b))
                               .numpy(), np.asarray(jmin.solve_6x6(jnp.asarray(A),
                                                                   jnp.asarray(b))),
                               rtol=1e-3, atol=1e-4)


def test_se3_exp_and_orthonormalize_feed_register_consistently():
    # The transform returned by register is a proper rotation.
    scene = _scene(5, [0.04, 0.0, 0.0], [0.0, 0.0, 0.005])
    _, tres = _register_both(scene)
    R = tres.transform[:3, :3].double()
    torch.testing.assert_close(R @ R.T, torch.eye(3, dtype=torch.float64), atol=1e-6, rtol=0)
    assert abs(float(se3.det_3x3(R)) - 1.0) < 1e-6
