"""The port's loop-closure building blocks against the JAX package (CPU).

The same numpy inputs, made from a seed, go through the JAX function and
its counterpart in the port: se3 logs and Jacobians, the k-nearest search,
kNN normals, the hashed occupancy test, the content-only voxel-map
transform and re-keying, FPFH, mutual correspondences, the RANSAC core
(given the JAX package's own random draws), the information matrix,
overlap restriction, motion compensation and the scan-to-scan odometry.
Two repairs of the port are held here too: the information matrix never
reads the gathered point of a query without a match, whichever matcher
answered, and ICP's polled early stop returns the fixed-trip result.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from open3d_slam_advanced_rss_2024_public_tpu.models import motion_compensation as jmc
from open3d_slam_advanced_rss_2024_public_tpu.models import place_recognition as jpr
from open3d_slam_advanced_rss_2024_public_tpu.models.odometry import LidarOdometry as JOdometry
from open3d_slam_advanced_rss_2024_public_tpu.ops import bruteforce as jbf
from open3d_slam_advanced_rss_2024_public_tpu.ops import fpfh as jfpfh
from open3d_slam_advanced_rss_2024_public_tpu.ops import hashgrid as jhashgrid
from open3d_slam_advanced_rss_2024_public_tpu.ops import normals as jnormals
from open3d_slam_advanced_rss_2024_public_tpu.ops import voxel_map as jvm
from open3d_slam_advanced_rss_2024_public_tpu.ops.registration import ransac as jransac
from open3d_slam_advanced_rss_2024_public_tpu.utils import se3 as jse3
from open3d_slam_advanced_rss_2024_public_tpu.utils.config import load_parameters as jload
from open3d_slam_advanced_rss_2024_public_tpu.utils.pointcloud import make_cloud as jmake
from open3d_slam_advanced_rss_2024_public_tpu_torch.frontends import synthetic
from open3d_slam_advanced_rss_2024_public_tpu_torch.models import motion_compensation as mc
from open3d_slam_advanced_rss_2024_public_tpu_torch.models import place_recognition as pr
from open3d_slam_advanced_rss_2024_public_tpu_torch.models.odometry import LidarOdometry
from open3d_slam_advanced_rss_2024_public_tpu_torch.ops import (bruteforce, cuda_nn, filters,
                                                                fpfh, hashgrid, normals,
                                                                voxel_map)
from open3d_slam_advanced_rss_2024_public_tpu_torch.ops.registration import icp, ransac
from open3d_slam_advanced_rss_2024_public_tpu_torch.utils import convert, se3
from open3d_slam_advanced_rss_2024_public_tpu_torch.utils import pointcloud as pc
from open3d_slam_advanced_rss_2024_public_tpu_torch.utils.config import load_parameters


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _scene_cloud(seed, n, extent=8.0):
    """Points on a floor, two walls and a few blobs: non-degenerate
    neighbourhoods for normals and descriptors."""
    rng = np.random.default_rng(seed)
    k = n // 4
    floor = np.c_[rng.uniform(0, extent, (k, 2)), 0.02 * rng.standard_normal(k)]
    wall1 = np.c_[rng.uniform(0, extent, k), 0.02 * rng.standard_normal(k) + extent,
                  rng.uniform(0, 2.5, k)]
    wall2 = np.c_[0.02 * rng.standard_normal(k), rng.uniform(0, extent, k),
                  rng.uniform(0, 2.5, k)]
    blobs = rng.uniform(1, extent - 1, (4, 3)) * [1, 1, 0.2] + [0, 0, 0.5]
    blob = blobs[rng.integers(0, 4, n - 3 * k)] + 0.3 * rng.standard_normal((n - 3 * k, 3))
    xyz = np.concatenate([floor, wall1, wall2, blob]).astype(np.float32)
    return xyz[rng.permutation(n)]


def _both(xyz, mask=None, normals_=None):
    mask = np.ones(len(xyz), bool) if mask is None else mask
    return (jmake(xyz, normals=normals_, mask=mask),
            pc.make_cloud(_t(xyz), normals=None if normals_ is None else _t(normals_),
                          mask=_t(mask)))


# -- se3 ----------------------------------------------------------------------

@pytest.mark.parametrize("scale", [1e-4, 3e-3, 0.5, 2.5, 3.1410])
def test_se3_logs_match_jax(scale):
    rng = np.random.default_rng(3)
    w = rng.standard_normal((64, 3)).astype(np.float32)
    w = w / np.linalg.norm(w, axis=-1, keepdims=True) * scale * rng.uniform(0.5, 1.0, (64, 1))
    xi = np.concatenate([w, rng.uniform(-3, 3, (64, 3))], -1).astype(np.float32)
    T = np.asarray(jse3.se3_exp(jnp.asarray(xi)))
    # f32 parity breaks first near 0 and near pi, where the log divides by
    # sin(theta): looser there, as the JAX function's own error is.
    tol = 2e-3 if scale > 3.0 else 2e-5
    np.testing.assert_allclose(_np(se3.so3_log(_t(T[:, :3, :3]))),
                               np.asarray(jse3.so3_log(jnp.asarray(T[:, :3, :3]))), atol=tol)
    np.testing.assert_allclose(_np(se3.se3_log(_t(T))), np.asarray(jse3.se3_log(jnp.asarray(T))),
                               atol=5 * tol)
    if scale < 3.0:
        np.testing.assert_allclose(_np(se3.se3_log(_t(T))), xi, atol=2e-4)


def test_se3_adjoint_jacobian_rpy_match_jax():
    rng = np.random.default_rng(4)
    xi = rng.uniform(-1, 1, (32, 6)).astype(np.float32)
    T = np.asarray(jse3.se3_exp(jnp.asarray(xi)))
    for name in ("adjoint", "matrix_to_rpy"):
        arg = T if name == "adjoint" else T[:, :3, :3]
        np.testing.assert_allclose(_np(getattr(se3, name)(_t(arg))),
                                   np.asarray(getattr(jse3, name)(jnp.asarray(arg))), atol=1e-6)
    np.testing.assert_allclose(_np(se3.log_right_jacobian_inv(_t(xi))),
                               np.asarray(jse3.log_right_jacobian_inv(jnp.asarray(xi))),
                               atol=1e-6)
    np.testing.assert_allclose(_np(se3.skew(_t(xi[:, :3]))),
                               np.asarray(jse3.skew(jnp.asarray(xi[:, :3]))), atol=0)
    np.testing.assert_allclose(_np(se3.compose(_t(T), _t(T[::-1].copy()))),
                               np.asarray(jse3.compose(jnp.asarray(T), jnp.asarray(T[::-1]))),
                               atol=1e-6)


# -- neighbours and normals -----------------------------------------------------

def _assert_knn_equal(idx, d2, ok, jidx, jd2, jok):
    """Indices equal and d2 within 1e-5, except that two neighbours whose
    distances tie within the ranking's rounding may swap places."""
    np.testing.assert_allclose(d2, jd2, atol=1e-5)
    np.testing.assert_array_equal(ok, jok)
    # Positions whose distances agree but whose indices differ are such
    # ties (their d2 was compared above); they must be rare.
    assert (idx != jidx).mean() < 1e-3


@pytest.mark.parametrize("k,radius", [(8, 0.5), (16, 1.0)])
def test_knn_matches_jax(k, radius):
    xyz = _scene_cloud(5, 1024)
    mask = np.ones(1024, bool)
    mask[1000:] = False
    jc, tc = _both(xyz, mask)
    jidx, jd2, jok = (np.asarray(a) for a in jbf.knn(jc.xyz, jc.mask, jc.xyz, radius, k=k))
    idx, d2, ok = (_np(a) for a in bruteforce.knn(tc.xyz, tc.mask, tc.xyz, radius, k=k))
    assert idx.dtype == np.int64 and idx.shape == (1024, k)
    np.testing.assert_array_equal(ok, jok)   # no lane of an invalid query is ok
    m = mask                                  # whose neighbours are arbitrary
    _assert_knn_equal(idx[m], d2[m], ok[m], jidx[m], jd2[m], jok[m])


def test_knn_approx_is_the_exact_knn():
    xyz = _scene_cloud(6, 1024)
    _, tc = _both(xyz)
    a = bruteforce.knn_approx(tc.xyz, tc.mask, tc.xyz, 0.8, k=16)
    b = bruteforce.knn(tc.xyz, tc.mask, tc.xyz, 0.8, k=16)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    # ... and the JAX package's approximate search returns nearly this set.
    jc, _ = _both(xyz)
    jidx = np.asarray(jbf.knn_approx(jc.xyz, jc.mask, jc.xyz, 0.8, k=16)[0])
    recall = np.mean([len(set(r) & set(s)) / 16 for r, s in zip(jidx, _np(b[0]))])
    assert recall > 0.9


def test_knn_normals_match_jax():
    xyz = _scene_cloud(7, 1024)
    jc, tc = _both(xyz)
    origin = np.array([4.0, 4.0, 1.5], np.float32)
    jn = np.asarray(jnormals.estimate_normals(jc, radius=0.8, k=12, sensor_origin=origin).normals)
    tn = _np(normals.estimate_normals(tc, radius=0.8, k=12, sensor_origin=origin).normals)
    # Compare where the plane is well defined: blobs and edges have
    # near-equal eigenvalues, where the smallest eigenvector is not.
    idx, _, ok = bruteforce.knn(tc.xyz, tc.mask, tc.xyz, 0.8, k=12)
    nbr = tc.xyz[idx]
    w = ok.float()[..., None]
    mean = (nbr * w).sum(1) / w.sum(1)
    d = (nbr - mean[:, None]) * w
    ev = torch.linalg.eigvalsh(torch.einsum("nki,nkj->nij", d, d) / w.sum(1)[..., None])
    planar = _np((ev[:, 0] < 0.2 * ev[:, 1]) & (ok.sum(-1) >= 6))
    assert planar.sum() > 400
    dots = np.abs((jn * tn).sum(-1))[planar]
    assert (1.0 - dots).max() < 1e-4           # same line ...
    assert ((jn * tn).sum(-1)[planar] > 0).all()  # ... and the same orientation
    np.testing.assert_array_equal((np.abs(jn).sum(-1) > 0), (np.abs(tn).sum(-1) > 0))


def test_knn_normal_engine_in_preprocessing():
    from open3d_slam_advanced_rss_2024_public_tpu.models import scan_processing as jsp
    from open3d_slam_advanced_rss_2024_public_tpu_torch.models import scan_processing as sp

    xyz = _scene_cloud(8, 2048) - np.array([4.0, 4.0, 1.0], np.float32)
    jc, tc = _both(xyz)
    a = jsp.preprocess_scan(jc, 0.5, 20.0, 0.2, 1.0, 1024, normal_radius=0.8, normal_knn=10,
                            normal_engine="knn")
    b = sp.preprocess_scan(tc, 0.5, 20.0, 0.2, 1.0, 1024, normal_radius=0.8, normal_knn=10,
                           normal_engine="knn")
    np.testing.assert_array_equal(np.asarray(a.mask), _np(b.mask))
    np.testing.assert_allclose(np.asarray(a.xyz), _np(b.xyz), atol=1e-5)
    agree = np.abs((np.asarray(a.normals) * _np(b.normals)).sum(-1))[_np(b.mask)]
    assert np.mean(agree > 1 - 1e-4) > 0.97


# -- occupancy, overlap, voxel-map transforms --------------------------------------

@pytest.mark.parametrize("cell,table", [(0.4, 1 << 12), (2.4, 1 << 15)])
def test_occupancy_lookup_matches_jax(cell, table):
    ref = _scene_cloud(9, 2048)
    qry = _scene_cloud(10, 1024) + np.array([3.0, 0.5, 0.0], np.float32)
    rm, qm = np.ones(2048, bool), np.ones(1024, bool)
    rm[1500:] = False
    qm[::7] = False
    (jr, tr), (jq, tq) = _both(ref, rm), _both(qry, qm)
    a = np.asarray(jhashgrid.occupancy_lookup(jr.xyz, jr.mask, jq.xyz, jq.mask, cell,
                                              table_size=table))
    b = _np(hashgrid.occupancy_lookup(tr.xyz, tr.mask, tq.xyz, tq.mask, cell, table_size=table))
    np.testing.assert_array_equal(a, b)
    assert 0 < b.sum() < qm.sum()


def test_overlap_clouds_match_jax():
    a = _scene_cloud(11, 2048)
    b = _scene_cloud(12, 2048) + np.array([4.0, 0.0, 0.0], np.float32)
    (ja, ta), (jb, tb) = _both(a), _both(b)
    T = np.asarray(jse3.se3_exp(jnp.asarray([0.0, 0.0, 0.05, 0.2, -0.1, 0.0], jnp.float32)))
    ja_ov, jb_ov = jpr.overlap_clouds(ja, jb, 1.0, 1024, T_a=jnp.asarray(T))
    ta_ov, tb_ov = pr.overlap_clouds(ta, tb, 1.0, 1024, T_a=_t(T))
    for j, t in ((ja_ov, ta_ov), (jb_ov, tb_ov)):
        np.testing.assert_array_equal(np.asarray(j.mask), _np(t.mask))
        np.testing.assert_allclose(np.asarray(j.xyz), _np(t.xyz), atol=0)
    assert 0 < int(ta_ov.mask.sum()) <= 1024


def _key_mean_weight(vm_obj, as_np):
    occ = as_np(vm_obj.ptable) != 0x7FFFFFFF
    acc = as_np(vm_obj.acc)
    w = acc[:, 6]
    keep = occ & (w > 0)
    return {int(k): (acc[i, :3] / w[i], w[i]) for i, k in enumerate(as_np(vm_obj.ptable))
            if keep[i]}


def test_transform_content_and_rekey_match_jax():
    xyz = _scene_cloud(13, 2048)
    nrm = np.tile(np.array([0, 0, 1.0], np.float32), (2048, 1))
    jc, tc = _both(xyz, normals_=nrm)
    jmap = jvm.insert(jvm.empty(4096), jc, 0.2)
    tmap = convert.voxel_map_from_jax(jmap, device="cpu")
    T = np.asarray(jse3.se3_exp(jnp.asarray([0.02, -0.01, 0.3, 1.5, -0.7, 0.1], jnp.float32)))
    jmoved, tmoved = jvm.transform_content(jmap, jnp.asarray(T)), \
        voxel_map.transform_content(tmap, _t(T))
    np.testing.assert_array_equal(np.asarray(jmoved.ptable), _np(tmoved.ptable))  # keys stale
    np.testing.assert_allclose(np.asarray(jmoved.acc), _np(tmoved.acc), rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(np.asarray(jmoved.cloud.normals), _np(tmoved.cloud.normals),
                               atol=1e-6)
    jre, tre = jvm.rekey(jmoved), voxel_map.rekey(tmoved)
    a, b = _key_mean_weight(jre, np.asarray), _key_mean_weight(tre, _np)
    assert a.keys() == b.keys() and len(a) > 500
    for k in a:
        np.testing.assert_allclose(a[k][0], b[k][0], atol=1e-5)
        assert abs(a[k][1] - b[k][1]) < 1e-5
    assert int(tre.count()) == int(jre.count())
    # The full transform (move and re-key in one) agrees with both.
    c = _key_mean_weight(voxel_map.transform(tmap, _t(T)), _np)
    assert c.keys() == b.keys()


# -- FPFH and correspondences ---------------------------------------------------------

@pytest.fixture(scope="module")
def feature_clouds():
    """A 1024-point scene with kNN normals, and the same scene moved, in
    both packages; FPFH of both from the JAX package."""
    xyz = _scene_cloud(14, 1024)
    T = np.asarray(jse3.se3_exp(jnp.asarray([0.0, 0.0, 0.4, 1.0, -2.0, 0.1], jnp.float32)))
    rng = np.random.default_rng(15)
    moved = (xyz @ T[:3, :3].T + T[:3, 3] + 0.002 * rng.standard_normal(xyz.shape)).astype(
        np.float32)
    out = []
    for pts in (xyz, moved):
        jc = jnormals.estimate_normals(jmake(pts), radius=0.8, k=12,
                                       sensor_origin=np.array([4, 4, 8.0], np.float32))
        tc = convert.cloud_from_arrays(jc.xyz, jc.normals, jc.mask, device="cpu")
        out.append((jc, tc, jfpfh.compute_fpfh(jc, radius=1.2, k=16)))
    return out, T


def test_fpfh_matches_jax_given_its_neighbours(feature_clouds):
    (jc, tc, jf), _ = feature_clouds[0][0], None
    jidx, jd2, jok = jbf.knn_approx(jc.xyz, jc.mask, jc.xyz, 1.2, k=16)
    tf = fpfh.fpfh_from_neighbors(tc, _t(np.asarray(jidx)).long(), _t(np.asarray(jd2)),
                                  _t(np.asarray(jok)))
    jf = np.asarray(jf)
    assert tf.shape == (1024, 33) and np.isfinite(_np(tf)).all()
    # A point's own SPFH enters its FPFH with weight 1 / 1e-6 (both
    # packages: the self match is not masked at d = 0), so the descriptors
    # are ~1e7 large; 1e-3 is relative to that scale.
    np.testing.assert_allclose(_np(tf), jf, rtol=1e-3, atol=1e-3 * np.abs(jf).max())
    # The port's own neighbour search gives the same descriptors for all
    # but the few points whose k-th neighbour the approximate search missed.
    own = _np(fpfh.compute_fpfh(tc, radius=1.2, k=16))
    close = np.isclose(own, jf, rtol=1e-3, atol=1e-3 * np.abs(jf).max()).all(-1)
    assert close.mean() > 0.8


def test_mutual_correspondences_match_jax(feature_clouds):
    # Well-separated descriptors: the assignment and its mask are equal.
    rng = np.random.default_rng(24)
    fa = rng.uniform(0, 100, (1024, 33)).astype(np.float32)
    perm = rng.permutation(1024)
    fb = (fa[perm] + 0.5 * rng.standard_normal((1024, 33))).astype(np.float32)
    ma, mb = np.ones(1024, bool), np.ones(1024, bool)
    ma[::9] = False
    mb[::11] = False
    jab, jok = jfpfh.mutual_nearest_correspondences(jnp.asarray(fa), jnp.asarray(ma),
                                                    jnp.asarray(fb), jnp.asarray(mb))
    tab, tok = fpfh.mutual_nearest_correspondences(_t(fa), _t(ma), _t(fb), _t(mb))
    np.testing.assert_array_equal(np.asarray(jok), _np(tok))
    np.testing.assert_array_equal(np.asarray(jab)[np.asarray(jok)], _np(tab)[_np(tok)])
    # Nearly every mutual pair is the planted one (a masked partner sends a
    # lane to its next-best match).
    planted = _t(perm)[tab[tok]] == torch.nonzero(tok)[:, 0]
    assert int(tok.sum()) > 700 and float(planted.float().mean()) > 0.95
    np.testing.assert_allclose(_np(fpfh.feature_distance_matrix(_t(fa), _t(fb))),
                               np.asarray(jfpfh.feature_distance_matrix(jnp.asarray(fa),
                                                                        jnp.asarray(fb))),
                               rtol=1e-4, atol=0.5)
    # Real FPFH descriptors are ~1e7 large (see above), so the expansion
    # |a|^2 + |b|^2 - 2ab cancels to a few digits and near-ties fall either
    # way with the order of the product's sums: nearly all lanes agree.
    ((ja, ta, fa), (jb, tb, fb)), _ = feature_clouds
    jab, jok = jfpfh.mutual_nearest_correspondences(fa, ja.mask, fb, jb.mask)
    tab, tok = fpfh.mutual_nearest_correspondences(_t(np.asarray(fa)), ta.mask,
                                                   _t(np.asarray(fb)), tb.mask)
    assert (np.asarray(jok) == _np(tok)).mean() > 0.98
    assert int(tok.sum()) > 100


# -- RANSAC -----------------------------------------------------------------------------

def _jax_draws(key, mask, batch, score_subset):
    """The draws ``jransac.ransac_from_correspondences`` makes from ``key``."""
    M = mask.shape[0]
    p = mask.astype(jnp.float32)
    p = p / jnp.maximum(jnp.sum(p), 1.0)
    k_pick, k_sub = jax.random.split(key)
    picks = jax.random.choice(k_pick, M, shape=(batch, 3), p=p)
    sub = jax.random.choice(k_sub, M, shape=(score_subset,), p=p)
    return np.asarray(picks), np.asarray(sub)


@pytest.mark.parametrize("seed,score_subset", [(0, 256), (1, 256), (2, 0)])
def test_ransac_core_matches_jax_given_its_picks(feature_clouds, seed, score_subset):
    ((ja, ta, fa), (jb, tb, fb)), T_true = feature_clouds
    jab, jok = jfpfh.mutual_nearest_correspondences(fa, ja.mask, fb, jb.mask)
    key = jax.random.PRNGKey(seed)
    corr_src = jnp.arange(1024, dtype=jnp.int32)
    jT, jn, jin = jransac.ransac_from_correspondences(
        ja.xyz, jb.xyz, corr_src, jab, jok, key, batch=512, score_subset=score_subset)
    picks, sub = _jax_draws(key, jok, 512, max(score_subset, 1))
    T, n, inl, best = ransac.ransac_core(
        ta.xyz, tb.xyz, torch.arange(1024), _t(np.asarray(jab)).long(), _t(np.asarray(jok)),
        _t(picks).long(), _t(sub).long() if score_subset else None)
    assert int(n) == int(jn) and int(n) >= 20
    np.testing.assert_allclose(_np(T), np.asarray(jT), atol=1e-4)
    np.testing.assert_array_equal(_np(inl), np.asarray(jin))
    assert 0 <= int(best) < 512
    # The winning 3-point hypothesis is near the true motion (ICP refines it).
    np.testing.assert_allclose(_np(T), T_true, atol=0.25)


def test_kabsch_and_quaternions_match_jax():
    rng = np.random.default_rng(16)
    src = rng.uniform(-2, 2, (256, 3, 3)).astype(np.float32)
    xi = rng.uniform(-1, 1, (256, 6)).astype(np.float32)
    T = np.asarray(jse3.se3_exp(jnp.asarray(xi)))
    dst = np.einsum("bij,bkj->bki", T[:, :3, :3], src) + T[:, None, :3, 3]
    jR, jt = jransac._kabsch_3pt(jnp.asarray(src), jnp.asarray(dst))
    R, t = ransac._kabsch_3pt(_t(src), _t(dst))
    np.testing.assert_allclose(_np(R), np.asarray(jR), atol=1e-4)
    np.testing.assert_allclose(_np(t), np.asarray(jt), atol=1e-4)
    q = rng.standard_normal((64, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    np.testing.assert_allclose(_np(ransac._quat_to_rot(_t(q))),
                               np.asarray(jransac._quat_to_rot(jnp.asarray(q))), atol=1e-6)


def test_ransac_wrapper_draws_from_valid_correspondences_only(feature_clouds):
    ((ja, ta, fa), (jb, tb, fb)), T_true = feature_clouds
    g = torch.Generator().manual_seed(5)
    mask = torch.zeros(1024, dtype=torch.bool)
    mask[100:400] = True
    picks, sub = ransac.draw_picks(mask, 128, 64, g)
    assert picks.shape == (128, 3) and sub.shape == (64,)
    assert bool(mask[picks].all()) and bool(mask[sub].all())
    g2 = torch.Generator().manual_seed(5)
    picks2, _ = ransac.draw_picks(mask, 128, 64, g2)
    assert torch.equal(picks, picks2)
    # Every draw is the first valid lane among the generator's tries for it
    # (what makes the draws the same on any device), else the next valid
    # lane after the last try, cyclically.
    tries = torch.randint(0, 1024, (ransac.DRAW_TRIES, 128 * 3 + 64),
                          generator=torch.Generator().manual_seed(5)).numpy()
    valid = np.nonzero(mask.numpy())[0]
    want = []
    for col in tries.T:
        hits = [j for j in col if mask[j]]
        after = valid[valid >= col[-1]]
        want.append(hits[0] if hits else (after[0] if len(after) else valid[0]))
    np.testing.assert_array_equal(np.r_[_np(picks).ravel(), _np(sub)], want)
    assert sum(not mask[col].any() for col in tries.T) > 5      # the fallback was taken
    # A mask that differs in one lane moves only the draws that touch it.
    lane = int(picks[0, 0])
    mask1 = mask.clone()
    mask1[lane] = False
    picks1, _ = ransac.draw_picks(mask1, 128, 64, torch.Generator().manual_seed(5))
    assert bool(((picks1 == picks) | (picks == lane)).all()) and not bool((picks1 == lane).any())
    # No valid pair: drawn from every lane; no subset when it would not be smaller.
    picks0, sub0 = ransac.draw_picks(torch.zeros(64, dtype=torch.bool), 256, 64, g)
    assert sub0 is None and int(picks0.min()) == 0 and int(picks0.max()) == 63
    T, n, *_ = ransac.register_features(ta.xyz, ta.mask, _t(np.asarray(fa)), tb.xyz, tb.mask,
                                        _t(np.asarray(fb)), torch.Generator().manual_seed(7),
                                        batch=512)
    assert int(n) >= 20
    np.testing.assert_allclose(_np(T), T_true, atol=0.4)


# -- information matrix (and the unfound-lane repair) ---------------------------------------

def test_information_matrix_matches_jax():
    a = _scene_cloud(17, 2048)
    b = (a + 0.01 * np.random.default_rng(18).standard_normal(a.shape)).astype(np.float32)
    (ja, ta), (jb, tb) = _both(a), _both(b)
    T = np.asarray(jse3.se3_exp(jnp.asarray([0.0, 0.0, 0.01, 0.03, 0.0, 0.0], jnp.float32)))
    jinfo, jn = jransac.information_matrix_from_point_clouds(
        ja.xyz, ja.mask, jhashgrid.passthrough(jb, 0.3), jnp.asarray(T), 0.3,
        matcher="bruteforce")
    for matcher in ("cuda", "bruteforce"):
        info, n = ransac.information_matrix_from_point_clouds(
            ta.xyz, ta.mask, hashgrid.passthrough(tb, 0.3), _t(T), 0.3, matcher=matcher)
        assert int(n) == int(jn) > 1000
        np.testing.assert_allclose(_np(info), np.asarray(jinfo), rtol=1e-3,
                                   atol=1e-3 * float(np.abs(np.asarray(jinfo)).max()))


def test_information_matrix_ignores_queries_without_a_match(monkeypatch):
    """Queries with no reference within max_dist: the twin answers with the
    nearest reference at any distance, the kernel with index 0 and d2 =
    +inf.  Both answers must give the same matrix, and it must be the
    matrix of the matched queries alone."""
    a = _scene_cloud(19, 1024)
    _, tb = _both(a)
    far = a.copy()
    far[::3] += 40.0
    _, ta = _both(far)
    grid = hashgrid.passthrough(tb, 0.3)
    eye = torch.eye(4)
    twin, n_twin = ransac.information_matrix_from_point_clouds(ta.xyz, ta.mask, grid, eye, 0.3,
                                                               matcher="cuda")

    def kernel_like(query, ref, max_dist):
        idx, d2 = cuda_nn.nn_plain(query, ref.points if isinstance(ref, cuda_nn.NNRef) else ref,
                                   max_dist)
        none = d2 > max_dist ** 2
        return torch.where(none, 0, idx), torch.where(none, float("inf"), d2)
    monkeypatch.setattr(cuda_nn, "nn", kernel_like)
    kern, n_kern = ransac.information_matrix_from_point_clouds(ta.xyz, ta.mask, grid, eye, 0.3,
                                                               matcher="cuda")
    assert int(n_twin) == int(n_kern) == 1024 - len(far[::3])
    assert torch.equal(twin, kern)
    keep = np.ones(1024, bool)
    keep[::3] = False
    _, tk = _both(far, keep)
    only, _ = ransac.information_matrix_from_point_clouds(tk.xyz, tk.mask, grid, eye, 0.3,
                                                          matcher="bruteforce")
    np.testing.assert_allclose(_np(twin), _np(only), rtol=1e-6)


# -- ICP's polled early stop ------------------------------------------------------------------

@pytest.mark.parametrize("poll_every", [1, 3, 5])
def test_icp_polled_stop_equals_fixed_trips(poll_every):
    xyz = _scene_cloud(20, 2048)
    _, ref = _both(xyz)
    ref = normals.estimate_normals(ref, 0.8, k=12, sensor_origin=np.array([4, 4, 8.0], np.float32))
    T = np.asarray(jse3.se3_exp(jnp.asarray([0.0, 0.0, 0.02, 0.05, -0.04, 0.01], jnp.float32)))
    src = ref.transform(_t(np.linalg.inv(T).astype(np.float32)))
    grid = hashgrid.passthrough(ref, 0.5)
    cfg = icp.ICPConfig(max_iterations=40, max_correspondence_dist=0.5, matcher="cuda")
    calls = {"n": 0}
    step = icp.iteration_step

    def counting(*args, **kwargs):
        calls["n"] += 1
        return step(*args, **kwargs)
    icp.iteration_step = counting
    try:
        fixed = icp.register(src, grid, torch.eye(4), cfg)
        n_fixed, calls["n"] = calls["n"], 0
        polled = icp.register(src, grid, torch.eye(4), cfg, poll_every=poll_every)
    finally:
        icp.iteration_step = step
    assert n_fixed == 40 and bool(fixed.converged)
    assert int(fixed.iterations) < 20
    # Stopped within poll_every trips of convergence ...
    assert int(fixed.iterations) <= calls["n"] <= int(fixed.iterations) + poll_every + 1
    # ... with the fixed-trip result, bit for bit.
    for f in dataclasses.fields(icp.ICPResult):
        assert torch.equal(getattr(fixed, f.name), getattr(polled, f.name)), f.name
    np.testing.assert_allclose(_np(polled.transform), T, atol=5e-3)


# -- motion compensation ------------------------------------------------------------------------

@pytest.mark.parametrize("clockwise", [True, False])
def test_motion_compensation_matches_jax(clockwise):
    xyz = _scene_cloud(21, 1024) - np.array([4.0, 4.0, 1.0], np.float32)
    mask = np.ones(1024, bool)
    mask[900:] = False
    nrm = np.tile(np.array([0, 0, 1.0], np.float32), (1024, 1))
    jc, tc = _both(xyz, mask, nrm)
    twist = np.array([0.01, -0.02, 0.15, 0.4, 0.05, -0.02], np.float32)
    a = jmc.undistort(jc, jnp.asarray(twist), clockwise)
    b = mc.undistort(tc, _t(twist), clockwise)
    np.testing.assert_allclose(np.asarray(a.xyz), _np(b.xyz), atol=1e-5)
    np.testing.assert_allclose(np.asarray(a.normals), _np(b.normals), atol=1e-5)
    np.testing.assert_allclose(np.asarray(jmc.compute_phase(jc.xyz, clockwise)),
                               _np(mc.compute_phase(tc.xyz, clockwise)), atol=1e-6)


def test_twist_from_buffer_matches_jax():
    from open3d_slam_advanced_rss_2024_public_tpu.utils.timebuf import (
        TransformInterpolationBuffer as JBuf)
    from open3d_slam_advanced_rss_2024_public_tpu_torch.utils.timebuf import (
        TransformInterpolationBuffer as TBuf)

    jb, tb = JBuf(), TBuf()
    assert np.all(mc.estimate_twist_from_buffer(tb, 0.1) == 0)
    for i, T in enumerate(synthetic.straight_trajectory(5, step=0.3, yaw_rate=0.05)):
        jb.push(0.1 * i, T)
        tb.push(0.1 * i, T)
    np.testing.assert_allclose(mc.estimate_twist_from_buffer(tb, 0.1, 3),
                               jmc.estimate_twist_from_buffer(jb, 0.1, 3), atol=1e-5)


# -- scan-to-scan odometry ------------------------------------------------------------------------

def test_lidar_odometry_matches_jax_after_four_scans():
    over = {"odometry": {
        "scan_matching": {"cloud_registration_type": "PointToPlaneIcp",
                          "icp": {"max_n_iter": 20, "max_correspondence_dist": 0.6}},
        "scan_processing": {"voxel_size": 0.15, "point_capacity": 2048,
                            "scan_cropping": {"cropping_radius_max": 15.0,
                                              "cropping_radius_min": 0.5}}}}
    world = synthetic.cluttered_world(22, extent=20.0, n_objects=25, device="cpu")
    gt = synthetic.straight_trajectory(4, step=0.3, start=(3.0, 0.0, 1.0))
    g = torch.Generator().manual_seed(23)
    scans = [synthetic.render_scan(world, T, g, n_points=2048, max_range=15.0, noise=0.003)
             for T in gt]
    jo, to = JOdometry(jload(over)), LidarOdometry(load_parameters(over), device="cpu")
    # The JAX package picks kNN normals on the CPU; so does the port here.
    import open3d_slam_advanced_rss_2024_public_tpu_torch.models.scan_processing as sp
    real = sp.preprocess_scan
    sp_knn = lambda *a, **k: real(*a, **{**k, "normal_engine": "knn"})  # noqa: E731
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sp, "preprocess_scan", sp_knn)
        for o, T in ((jo, gt[0]), (to, gt[0])):
            o.set_initial_transform(T)
        for i, s in enumerate(scans):
            assert to.add_range_scan(s, 0.1 * i)
            assert jo.add_range_scan(jmake(s.xyz.numpy(), mask=s.mask.numpy()), 0.1 * i)
    assert to.rejected_jumps == jo.rejected_jumps == 0 and to.low_fitness == 0
    # Within 2 mm of the JAX package's pose after four scans.
    assert np.abs(to.odom_to_range_sensor[:3, 3] - jo.odom_to_range_sensor[:3, 3]).max() < 2e-3
    assert np.abs(to.odom_to_range_sensor[:3, :3] - jo.odom_to_range_sensor[:3, :3]).max() < 1e-3
    assert np.linalg.norm(to.odom_to_range_sensor[:3, 3] - gt[3][:3, 3]) < 0.05
    assert len(to.buffer) == 4
