"""The hashed matcher grid and space carving of the PyTorch port against the
JAX package (CPU): ``build``'s CSR layout, the three queries,
``occupied_voxel_lookup``, ``carve``, the information matrix and ICP over
the hashed grid, and the Mapper with ``matcher="hashgrid"`` and carving on.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_icp import _pose_gap, _scene
from test_torch_mapper import LAG, _jax_radius_moments, _overrides, _run, _tcloud

from open3d_slam_advanced_rss_2024_public_tpu.models.mapper import Mapper as JMapper
from open3d_slam_advanced_rss_2024_public_tpu.ops import hashgrid as jhashgrid
from open3d_slam_advanced_rss_2024_public_tpu.ops import voxel_map as jvoxel_map
from open3d_slam_advanced_rss_2024_public_tpu.ops.registration import icp as jicp
from open3d_slam_advanced_rss_2024_public_tpu.ops.registration import ransac as jransac
from open3d_slam_advanced_rss_2024_public_tpu.utils.config import load_parameters as jload
from open3d_slam_advanced_rss_2024_public_tpu.utils.pointcloud import make_cloud as jmake
from open3d_slam_advanced_rss_2024_public_tpu_torch.frontends import synthetic
from open3d_slam_advanced_rss_2024_public_tpu_torch.models import scan_processing
from open3d_slam_advanced_rss_2024_public_tpu_torch.models.mapper import Mapper
from open3d_slam_advanced_rss_2024_public_tpu_torch.ops import cuda_moments, hashgrid, voxel_map
from open3d_slam_advanced_rss_2024_public_tpu_torch.ops.registration import icp, ransac
from open3d_slam_advanced_rss_2024_public_tpu_torch.utils import convert
from open3d_slam_advanced_rss_2024_public_tpu_torch.utils import pointcloud as pc


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.fixture(scope="module")
def cloud():
    """A clustered cloud (dense buckets, so the per-bucket budget matters),
    with invalid lanes, and queries around it (some far from everything)."""
    rng = np.random.default_rng(31)
    centers = rng.uniform(-6.0, 6.0, size=(60, 3))
    xyz = (centers[rng.integers(0, 60, 2048)] + rng.normal(scale=0.4, size=(2048, 3)))
    nrm = rng.normal(size=(2048, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    mask = rng.uniform(size=2048) > 0.1
    q = np.concatenate([xyz[rng.integers(0, 2048, 4500)] + rng.normal(scale=0.3, size=(4500, 3)),
                        rng.uniform(-9.0, 9.0, size=(500, 3))])
    qmask = rng.uniform(size=5000) > 0.05
    f32 = np.float32
    return xyz.astype(f32), nrm.astype(f32), mask, q.astype(f32), qmask


def _grids(cloud, cell, table_size):
    xyz, nrm, mask, _, _ = cloud
    jc = jmake(xyz, normals=nrm, mask=mask)
    jg = jhashgrid.build(jc, cell, table_size=table_size)
    tc = convert.cloud_from_arrays(jc.xyz, jc.normals, jc.mask, device="cpu")
    return jg, hashgrid.build(tc, cell, table_size=table_size)


@pytest.mark.parametrize("cell,table_size", [(0.5, 1 << 8), (1.0, 1 << 12)])
def test_build_matches_jax(cloud, cell, table_size):
    jg, tg = _grids(cloud, cell, table_size)
    assert tg.table_size == table_size
    for name in ("points", "normals", "perm", "start", "count"):
        np.testing.assert_array_equal(getattr(tg, name).numpy(), np.asarray(getattr(jg, name)),
                                      err_msg=name)
    # The bucket ids themselves, negative voxel coordinates included.
    key = _t(np.array([[-3, 7, -1], [0, 0, 0], [-1000, 2, 999]], np.int32))
    np.testing.assert_array_equal(hashgrid.hash_key(key, table_size).numpy(),
                                  np.asarray(jhashgrid.hash_key(jnp.asarray(key.numpy()),
                                                                table_size)))
    with pytest.raises(ValueError):
        hashgrid.build(pc.PointCloud(_t(cloud[0]), _t(cloud[1]), _t(cloud[2])), cell,
                       table_size=1000)


@pytest.mark.parametrize("max_per_bucket", [8, 32])
def test_queries_match_jax(cloud, max_per_bucket):
    # 5000 queries: two row chunks on both sides.
    _, _, _, q, qmask = cloud
    jg, tg = _grids(cloud, 0.6, 1 << 8)
    jq, tq = (jnp.asarray(q), jnp.asarray(qmask)), (_t(q), _t(qmask))
    ji, jd, jf = jhashgrid.query_nn(jg, *jq, 0.6, max_per_bucket=max_per_bucket)
    ti, td, tf = hashgrid.query_nn(tg, *tq, 0.6, max_per_bucket=max_per_bucket)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    assert 0.5 * len(q) < int(tf.sum()) < len(q)
    f = tf.numpy()
    np.testing.assert_array_equal(ti.numpy()[f], np.asarray(ji)[f])
    np.testing.assert_allclose(td.numpy()[f], np.asarray(jd)[f], atol=1e-6, rtol=0)

    ji, jd, jok = jhashgrid.query_knn(jg, *jq, 0.6, k=4, max_per_bucket=max_per_bucket)
    ti, td, tok = hashgrid.query_knn(tg, *tq, 0.6, k=4, max_per_bucket=max_per_bucket)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    ok = tok.numpy()
    np.testing.assert_array_equal(ti.numpy()[ok], np.asarray(ji)[ok])
    np.testing.assert_allclose(td.numpy()[ok], np.asarray(jd)[ok], atol=1e-6, rtol=0)

    jc = jhashgrid.query_radius_count(jg, *jq, 0.45, max_per_bucket=max_per_bucket)
    tc = hashgrid.query_radius_count(tg, *tq, 0.45, max_per_bucket=max_per_bucket)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert tc.dtype == torch.int32 and int(tc.max()) > 4


def test_occupied_voxel_lookup_and_overlap_mask_match_jax(cloud):
    xyz, nrm, mask, q, qmask = cloud
    jg, tg = _grids(cloud, 0.25, 1 << 10)
    a = jhashgrid.occupied_voxel_lookup(jg, jnp.asarray(q), jnp.asarray(qmask))
    b = hashgrid.occupied_voxel_lookup(tg, _t(q), _t(qmask))
    np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert 0 < int(b.sum()) < int(qmask.sum())
    other = pc.PointCloud(_t(q), _t(np.zeros_like(q)), _t(qmask))
    np.testing.assert_array_equal(voxel_map.overlap_mask(tg, other).numpy(), b.numpy())


@pytest.fixture(scope="module")
def carve_scene():
    """A voxel map of two scans of a synthetic world and a third scan from
    elsewhere, whose rays cross the map's free space."""
    world = synthetic.cluttered_world(8, extent=24.0, n_objects=30, device="cpu")
    g = torch.Generator().manual_seed(9)
    poses = [np.eye(4, dtype=np.float32) for _ in range(3)]
    for T, t in zip(poses, ([8.0, 0.0, 1.2], [10.0, 1.0, 1.2], [13.0, -2.0, 1.2])):
        T[:3, 3] = t
    scans = [synthetic.render_scan(world, T, g, n_points=2048, max_range=14.0, noise=0.003)
             .transform(_t(T)) for T in poses]
    jmap = jvoxel_map.empty(1 << 13)
    for s in scans[:2]:
        jmap = jvoxel_map.insert(jmap, jmake(s.xyz.numpy(), mask=s.mask.numpy()), 0.15)
    return jmap, scans[2], poses[2][:3, 3]


def _tombstones(acc, ptable):
    return set(np.nonzero((np.asarray(ptable) != 0x7FFFFFFF)
                          & (np.asarray(acc)[:, 6] == 0.0))[0].tolist())


def test_carve_matches_jax(carve_scene):
    jmap, scan, origin = carve_scene
    kw = dict(carve_voxel_size=0.2, truncation_distance=0.3, max_ray_length=20.0)
    jout = jvoxel_map.carve(jmap, jmake(scan.xyz.numpy(), mask=scan.mask.numpy()),
                            jnp.asarray(origin), **kw)
    tout = voxel_map.carve(convert.voxel_map_from_jax(jmap, device="cpu"), scan, _t(origin), **kw)
    before = _tombstones(jmap.acc, jmap.ptable)
    carved_j, carved_t = _tombstones(jout.acc, jout.ptable), _tombstones(tout.acc, tout.ptable)
    assert carved_t == carved_j
    assert len(carved_t - before) > 20
    np.testing.assert_array_equal(tout.ptable.numpy(), np.asarray(jout.ptable))
    np.testing.assert_array_equal(tout.acc.numpy(), np.asarray(jout.acc))


def test_information_matrix_over_the_hashed_grid_matches_jax(cloud):
    xyz, nrm, mask, q, qmask = cloud
    jg, tg = _grids(cloud, 0.3, 1 << 10)
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = [0.02, -0.01, 0.0]
    jinfo, jn = jransac.information_matrix_from_point_clouds(
        jnp.asarray(q), jnp.asarray(qmask), jg, jnp.asarray(T), 0.3)
    info, n = ransac.information_matrix_from_point_clouds(_t(q), _t(qmask), tg, _t(T), 0.3,
                                                          matcher="hashgrid")
    assert int(n) == int(jn) > 1000
    np.testing.assert_allclose(info.numpy(), np.asarray(jinfo), rtol=1e-4,
                               atol=1e-4 * float(np.abs(np.asarray(jinfo)).max()))


def test_register_on_the_hashed_grid_matches_jax():
    (mx, mn), (sx, sn, sm), pose, init = _scene(5, [0.05, -0.03, 0.02], [0.0, 0.003, 0.01])
    cfg = dict(matcher="hashgrid", max_iterations=10, min_diff_rot=0.0, min_diff_trans=0.0)
    mmask = np.abs(mx[:, 0]) < 1e7
    jgrid = jhashgrid.build(jmake(mx, normals=mn, mask=mmask), 0.5, table_size=1 << 12)
    jres = jicp.register(jmake(sx, normals=sn, mask=sm), jgrid, jnp.asarray(init),
                         jicp.ICPConfig(**cfg))
    tgrid = convert.hash_grid_from_jax(jgrid, device="cpu")
    tres = icp.register(pc.PointCloud(_t(sx), _t(sn), _t(sm)), tgrid, _t(init),
                        icp.ICPConfig(**cfg))
    assert int(tres.iterations) == int(jres.iterations)
    dt, da = _pose_gap(jres.transform, tres.transform.numpy())
    assert dt < 1e-4 and da < 1e-4, (dt, da)
    assert _pose_gap(pose, tres.transform.numpy())[0] < 0.03


S = 8


def _hashgrid_overrides():
    over = _overrides(3.0)
    reg = over["mapper"]["mapper_localizer"]["scan_to_map_registration"]
    reg["matcher"] = "hashgrid"
    over["mapper"]["map_builder"].update(
        {"is_carving_enabled": True,
         "space_carving": {"carve_space_every_n_scans": 1.0, "voxel_size": 0.2}})
    return over


@pytest.fixture(scope="module")
def hashgrid_scene():
    world = synthetic.cluttered_world(5, extent=30.0, n_objects=40, device="cpu")
    gt = synthetic.loop_trajectory(40, radius=9.0, center=(15.0, 0.0))[:S]
    g = torch.Generator().manual_seed(6)
    scans = [synthetic.render_scan(world, gt[i], g, n_points=2048, max_range=12.0,
                                   noise=0.004) for i in range(S)]
    odom = [gt[0]]
    bias = np.eye(4, dtype=np.float32)
    bias[:3, 3] = [0.02, -0.01, 0.0]
    for i in range(1, S):
        odom.append((odom[-1] @ np.linalg.inv(gt[i - 1]) @ gt[i] @ bias).astype(np.float32))
    return gt, odom, [(s.xyz.numpy(), s.mask.numpy()) for s in scans]


def test_mapper_on_the_hashed_grid_with_carving_matches_jax(hashgrid_scene):
    gt, odom, scans = hashgrid_scene
    over = _hashgrid_overrides()
    jm = JMapper(jload(over))
    jm.pipe_cfg = dataclasses.replace(jm.pipe_cfg, normal_engine="moments_interpret")
    builds, carves, jcarves = [], [], []
    with pytest.MonkeyPatch.context() as mp:
        real_jcarve = jvoxel_map.carve
        mp.setattr(jvoxel_map, "carve",
                   lambda *a, **k: jcarves.append(1) or real_jcarve(*a, **k))
        jposes = _run(jm, scans, odom, lambda x, m: jmake(x, mask=m))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cuda_moments, "radius_moments", _jax_radius_moments)
        real_build, real_carve = hashgrid.build, voxel_map.carve
        mp.setattr(hashgrid, "build", lambda *a, **k: builds.append(1) or real_build(*a, **k))
        mp.setattr(voxel_map, "carve", lambda *a, **k: carves.append(1) or real_carve(*a, **k))
        tm = Mapper(convert.params_from_dict(over), device="cpu")
        assert tm.pipe_cfg.icp.matcher == jm.pipe_cfg.icp.matcher == "hashgrid"
        tposes = _run(tm, scans, odom, _tcloud)
    # The hashed grid was built for every lag block's reference, as the JAX
    # package builds it, and the submap was carved as often as there.
    assert len(builds) >= S // LAG
    assert len(carves) == len(jcarves) >= 2
    assert np.abs(tposes[:, :3, 3] - jposes[:, :3, 3]).max() < 1e-3
    assert np.abs(tposes[:, :3, :3] - jposes[:, :3, :3]).max() < 1e-3
    assert np.linalg.norm(tposes[-1, :3, 3] - gt[-1][:3, 3]) < 0.02
    for sa, sb in zip(jm.submaps.submaps, tm.submaps.submaps):
        assert abs(int(sb.map.count()) - int(sa.map.count())) <= 0.002 * int(sa.map.count())
        assert sb.n_scans == sa.n_scans


def test_crop_submap_builds_the_hashed_grid_for_the_hashed_matcher():
    # The reference patch of the hashed matcher is a CSR grid of table_size
    # buckets; the other matchers get the Morton-sorted passthrough.
    rng = np.random.default_rng(3)
    xyz = rng.uniform(-10.0, 10.0, size=(3000, 3)).astype(np.float32)
    cloud = pc.make_cloud(_t(xyz), device="cpu")
    kw = dict(min_radius=0.0, max_radius=8.0, match_dist=0.5, capacity=2048)
    patch, grid = scan_processing.crop_submap_and_index(cloud, _t(np.zeros(3, np.float32)),
                                                        table_size=1 << 12, **kw)
    assert grid.table_size == 1 << 12 and int(grid.count.sum()) == int(patch.mask.sum())
    _, flat = scan_processing.crop_submap_and_index(cloud, _t(np.zeros(3, np.float32)),
                                                    build_hash=False, **kw)
    assert flat.table_size == 1
