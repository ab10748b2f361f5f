"""Descriptor channels through the port's core types and the modules this
slice completes, against the JAX package (CPU): the cloud's channel API,
the filters, croppers and generators, the local-PCA descriptors, the hashed
grid's descriptor, the voxel map's descriptor sums, the Mapper's pad scan,
and the ICP pieces that read channels (``generic_desc``, ``max_dist_field``).

Channels must match by name and order; values are exact where the
arithmetic is the same lane for lane, and within 1e-6 where sums run in
another order (voxel means, descriptor sums), 2e-5 (and 1e-5 relative)
for the window-PCA descriptors and 5e-5 for the kNN-PCA eigenvalue ratios
(the float32 rounding of a small eigenvalue).  The random filters run on JAX's own draws.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open3d_slam_advanced_rss_2024_public_tpu.ops import croppers as jcroppers
from open3d_slam_advanced_rss_2024_public_tpu.ops import filters as jfilters
from open3d_slam_advanced_rss_2024_public_tpu.ops import hashgrid as jhashgrid
from open3d_slam_advanced_rss_2024_public_tpu.ops import normals as jnormals
from open3d_slam_advanced_rss_2024_public_tpu.ops import voxel_map as jvm
from open3d_slam_advanced_rss_2024_public_tpu.ops.registration import icp as jicp
from open3d_slam_advanced_rss_2024_public_tpu.utils import pointcloud as jpc
from open3d_slam_advanced_rss_2024_public_tpu.utils import se3 as jse3
from open3d_slam_advanced_rss_2024_public_tpu_torch.models.mapper import _make_pad_scan
from open3d_slam_advanced_rss_2024_public_tpu_torch.models.scan_processing import preprocess_scan
from open3d_slam_advanced_rss_2024_public_tpu_torch.ops import (croppers, filters, generators,
                                                                hashgrid, normals)
from open3d_slam_advanced_rss_2024_public_tpu_torch.ops import voxel_map as vm
from open3d_slam_advanced_rss_2024_public_tpu_torch.ops.registration import icp
from open3d_slam_advanced_rss_2024_public_tpu_torch.utils import convert
from open3d_slam_advanced_rss_2024_public_tpu_torch.utils import pointcloud as pc

N = 1536


def _arrays(seed, n=N, extent=4.0):
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-extent, extent, (n, 3)).astype(np.float32)
    nrm = rng.standard_normal((n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    mask = rng.uniform(size=n) > 0.1
    attrs = {"intensity": rng.uniform(0, 1, n).astype(np.float32),
             "t": rng.uniform(0, 0.1, n).astype(np.float32)}
    return xyz, nrm, mask, attrs


def _both(seed=0, **kw):
    xyz, nrm, mask, attrs = _arrays(seed, **kw)
    jc = jpc.make_cloud(jnp.asarray(xyz), normals=jnp.asarray(nrm), mask=jnp.asarray(mask),
                        attrs={k: jnp.asarray(v) for k, v in attrs.items()})
    tc = pc.make_cloud(xyz, normals=nrm, mask=mask, device="cpu", attrs=attrs)
    return jc, tc


def _same(jc, tc, atol=0.0, rtol=0.0):
    """Lane for lane: mask, points, normals, channels by name and value
    (channels also within ``rtol`` of their value)."""
    np.testing.assert_array_equal(tc.mask.numpy(), np.asarray(jc.mask))
    np.testing.assert_allclose(tc.xyz.numpy(), np.asarray(jc.xyz), atol=atol, rtol=0)
    np.testing.assert_allclose(tc.normals.numpy(), np.asarray(jc.normals), atol=atol, rtol=0)
    assert tc.attr_names == tuple(jc.attr_names)
    if jc.attrs is None:
        assert tc.attrs is None
    else:
        np.testing.assert_allclose(tc.attrs.numpy(), np.asarray(jc.attrs), atol=atol,
                                   rtol=rtol)


def test_cloud_channel_api_matches_jax():
    jc, tc = _both(1)
    _same(jc, tc)
    assert tc.has_attr("t") and not tc.has_attr("r")
    with pytest.raises(KeyError):
        tc.attr("r")
    v = np.linspace(0, 1, N, dtype=np.float32)
    _same(jc.with_attr("t", jnp.asarray(v)), tc.with_attr("t", torch.from_numpy(v)))
    _same(jc.with_attr("range", jnp.asarray(v)), tc.with_attr("range", torch.from_numpy(v)))
    _same(jc.without_attrs(), tc.without_attrs())
    m = np.arange(N) % 3 > 0
    _same(jc.with_mask(jnp.asarray(m)), tc.with_mask(torch.from_numpy(m)))
    idx = np.random.default_rng(2).permutation(N)[:700]
    _same(jc.take(jnp.asarray(idx)), tc.take(torch.from_numpy(idx)))
    _same(jpc.compact(jc, 2000), pc.compact(tc, 2000))
    _same(jpc.compact(jc, 1000), pc.compact(tc, 1000))
    T = jse3.make_transform(jse3.so3_exp(jnp.asarray([0.1, -0.2, 0.3])), jnp.asarray([1.0, 2, 3]))
    _same(jc.transform(T), tc.transform(torch.from_numpy(np.asarray(T))), atol=1e-6)
    sel = tc.select(("t", "intensity"))
    assert sel.attr_names == ("t", "intensity")
    assert torch.equal(sel.attr("intensity"), tc.attr("intensity"))
    xyz, nrm = pc.to_numpy(tc)
    np.testing.assert_array_equal(xyz, np.asarray(jpc.to_numpy(jc)[0]))
    e = pc.empty_cloud(8, device="cpu", attr_names=("a", "b"))
    assert e.attrs.shape == (8, 2) and not bool(e.mask.any())


def test_concatenate_aligns_channels_like_jax():
    ja, ta = _both(3)
    jb, tb = _both(4)
    jb, tb = jb.with_attr("extra", jb.attr("t")), tb.with_attr("extra", tb.attr("t"))
    jb = jb.with_attr("t", jb.attr("t") * 0)  # same names, another order below
    tb = tb.with_attr("t", tb.attr("t") * 0)
    jb2 = jpc.PointCloud(jb.xyz, jb.normals, jb.mask, jb.attrs[:, ::-1],
                         tuple(reversed(jb.attr_names)))
    tb2 = pc.PointCloud(tb.xyz, tb.normals, tb.mask, tb.attrs.flip(-1),
                        tuple(reversed(tb.attr_names)))
    _same(jpc.concatenate(ja, jb2, 2500), pc.concatenate(ta, tb2, 2500))
    _same(jpc.concatenate(ja, ja.without_attrs()), pc.concatenate(ta, ta.without_attrs()))
    _same(jpc.concatenate(ja, jb), pc.concatenate(ta, tb))


def test_limits_and_random_filters_match_jax():
    jc, tc = _both(5)
    _same(jfilters.distance_limit(jc, 1.5, 4.5), filters.distance_limit(tc, 1.5, 4.5))
    for invert in (False, True):
        lo, hi = [-2.0, -1.0, -3.0], [2.0, 3.0, 0.5]
        _same(jfilters.bounding_box(jc, jnp.asarray(lo), jnp.asarray(hi), invert),
              filters.bounding_box(tc, lo, hi, invert))
    key = jax.random.PRNGKey(7)
    u = torch.from_numpy(np.array(jax.random.uniform(key, (N,))))
    _same(jfilters.random_sampling(jc, key, 0.4), filters.random_sampling(tc, u, 0.4))
    for count in (300, 5000):
        _same(jfilters.max_point_count(jc, key, count), filters.max_point_count(tc, u, count))
    # The port's own draws: a seed gives the same uniforms on every call.
    a, b = filters.uniform(3, 64, "cpu"), filters.uniform(3, 64, "cpu")
    assert torch.equal(a, b) and not torch.equal(a, filters.uniform(4, 64, "cpu"))
    assert filters.fold_in(0, 1) != filters.fold_in(0, 2) != filters.fold_in(1, 1)


@pytest.mark.parametrize("order", ["lex", "morton"])
def test_voxel_downsample_averages_channels_like_jax(order):
    jc, tc = _both(6)
    j = jfilters.voxel_downsample(jc, 0.5, 1024, order=order)
    t = filters.voxel_downsample(tc, 0.5, 1024, order=order)
    _same(j, t, atol=1e-6)
    vol = np.asarray(jc.xyz)[:, 2] < 1.0
    _same(jfilters.voxel_downsample_within_volume(jc, 0.5, jnp.asarray(vol), 1024),
          filters.voxel_downsample_within_volume(tc, 0.5, torch.from_numpy(vol), 1024),
          atol=1e-6)
    _same(jfilters.remove_duplicate_points_in_voxels(jc, 0.5),
          filters.remove_duplicate_points_in_voxels(tc, 0.5))


def test_croppers_match_jax():
    jc, tc = _both(8)
    pose = np.asarray(jse3.make_transform(jse3.so3_exp(jnp.asarray([0.0, 0.0, 0.4])),
                                          jnp.asarray([0.5, -0.5, 0.2])))
    for kind in ("maxradius", "minradius", "minmaxradius", "cylinder"):
        for invert in (False, True):
            jv = jcroppers.cropper_from_config(kind, 1.5, 3.5, jnp.asarray(pose), invert)
            tv = croppers.cropper_from_config(kind, 1.5, 3.5, torch.from_numpy(pose), invert)
            np.testing.assert_array_equal(tv.crop_mask(tc).numpy(), np.asarray(jv.crop_mask(jc)))
            _same(jv.crop(jc), tv.crop(tc))
            moved_j, moved_t = jv.with_pose(jnp.eye(4)), tv.with_pose(torch.eye(4))
            _same(moved_j.crop(jc), moved_t.crop(tc))
    with pytest.raises(ValueError):
        croppers.cropper_from_config("box", 1.0, 2.0)


def test_generators_room_scan_and_noise():
    """The port draws from a torch generator (JAX from jax.random): the same
    room geometry, the same seed giving the same scan."""
    g = torch.Generator().manual_seed(0)
    room, sensor = (8.0, 6.0, 3.0), (0.0, 0.0, 1.0)
    c = generators.lidar_room_scan(g, n=4096, room=room, sensor=sensor, device="cpu")
    c2 = generators.lidar_room_scan(torch.Generator().manual_seed(0), n=4096, room=room,
                                    sensor=sensor, device="cpu")
    assert torch.equal(c.xyz, c2.xyz) and int(c.count()) == 4096
    p = c.xyz.numpy() + np.asarray(sensor, np.float32)
    he = np.asarray(room) / 2
    on_face = np.isclose(np.abs(p), he, atol=1e-5)
    assert on_face.any(-1).all() and (np.abs(p) <= he + 1e-5).all()
    # Normals face inward; faces drawn by area, as in the JAX package.
    n = c.normals.numpy()
    assert ((n * p).sum(-1) < 0).all()
    floor_share = (n[:, 2] > 0.5).mean()
    assert abs(floor_share - (8 * 6) / (2 * (8 * 6 + 8 * 3 + 6 * 3))) < 0.03
    noisy = generators.add_noise(torch.Generator().manual_seed(1), c, 0.01)
    assert abs(float((noisy.xyz - c.xyz).std()) - 0.01) < 1e-3


def test_surface_descriptors_match_jax():
    jc, tc = _both(9)
    j = np.asarray(jnormals.surface_descriptors(jc, 1.2, k=12))
    t = normals.surface_descriptors(tc, 1.2, k=12).numpy()
    # Eigenvalue ratios: float32 rounding of a near-zero eigenvalue moves
    # them by up to 2e-5.
    np.testing.assert_allclose(t, j, atol=5e-5)


def test_organized_surface_normals_match_jax():
    rows, cols = 16, 32
    u = np.linspace(-1, 1, cols, dtype=np.float32)
    v = np.linspace(-1, 1, rows, dtype=np.float32)
    uu, vv = np.meshgrid(u, v)
    rng = np.random.default_rng(1)
    # A noisy plane: on an exact one the smallest eigenvalue is rounding
    # noise, which the sqrt-eigenvalue descriptors magnify.
    pts = np.stack([uu, vv, 0.3 * uu + 0.1 * vv + 2.0 + 0.01 * rng.standard_normal(uu.shape)],
                   -1).reshape(-1, 3).astype(np.float32)
    mask = rng.uniform(size=rows * cols) > 0.05
    jc = jpc.make_cloud(jnp.asarray(pts), mask=jnp.asarray(mask))
    tc = pc.make_cloud(pts, mask=mask, device="cpu")
    for md in (float("inf"), 0.2):
        _same(jnormals.organized_surface_normals(jc, rows, cols, knn=5, max_dist=md),
              normals.organized_surface_normals(tc, rows, cols, knn=5, max_dist=md),
              atol=2e-5, rtol=1e-5)


def test_hash_grid_carries_the_descriptor_like_jax():
    jc, tc = _both(10)
    jg = jhashgrid.build(jc, 0.5, table_size=1 << 10, desc_channel="intensity")
    tg = hashgrid.build(tc, 0.5, table_size=1 << 10, desc_channel="intensity")
    np.testing.assert_array_equal(tg.desc.numpy(), np.asarray(jg.desc))
    np.testing.assert_array_equal(tg.perm.numpy(), np.asarray(jg.perm))
    jp = jhashgrid.passthrough(jc, 0.5, desc_channel="t")
    tp = hashgrid.passthrough(tc, 0.5, desc_channel="t")
    np.testing.assert_array_equal(tp.desc.numpy(), np.asarray(jp.desc))
    assert hashgrid.passthrough(tc, 0.5).desc is None
    np.testing.assert_array_equal(convert.hash_grid_from_jax(jg, "cpu").desc.numpy(),
                                  np.asarray(jg.desc))


def _key_dict(ptable, acc, sums):
    ptable, acc = np.asarray(ptable), np.asarray(acc)
    occ = ptable != 0x7FFFFFFF
    full = np.concatenate([acc, np.asarray(sums)], -1)
    return {int(k): full[i] for i, k in zip(np.nonzero(occ)[0], ptable[occ])}


def _same_maps(jmap, tmap):
    """Same keys; per key the sums (positions, normals, weight and channel
    sums) within 1e-6 relative (float32 sums in another order)."""
    assert tmap.attr_names == tuple(jmap.attr_names)
    a = _key_dict(jmap.ptable, jmap.acc, jmap.sum_attrs)
    b = _key_dict(tmap.ptable.numpy(), tmap.acc.numpy(), tmap.sum_attrs.numpy())
    assert set(a) == set(b)
    keys = sorted(a)
    np.testing.assert_allclose(np.stack([b[k] for k in keys]), np.stack([a[k] for k in keys]),
                               rtol=1e-6, atol=1e-6)


def test_voxel_map_sums_channels_like_jax():
    jmap, tmap = jvm.empty(4096), vm.empty(4096, device="cpu")
    assert tmap.sum_attrs is None
    for s in range(3):
        jc, tc = _both(20 + s, n=1200, extent=3.0)
        if s == 1:  # the scan's channels in another order: aligned to the map's
            jc = jpc.PointCloud(jc.xyz, jc.normals, jc.mask, jc.attrs[:, ::-1],
                                tuple(reversed(jc.attr_names)))
            tc = pc.PointCloud(tc.xyz, tc.normals, tc.mask, tc.attrs.flip(-1),
                               tuple(reversed(tc.attr_names)))
        if s == 2:  # a channel missing: the scan adds zeros
            jc = jpc.PointCloud(jc.xyz, jc.normals, jc.mask, jc.attrs[:, :1], jc.attr_names[:1])
            tc = tc.select(tc.attr_names[:1])
        jmap, tmap = jvm.insert(jmap, jc, 0.25), vm.insert(tmap, tc, 0.25)
        _same_maps(jmap, tmap)
    jcl, tcl = jmap.cloud, tmap.cloud
    assert tcl.attr_names == ("intensity", "t")
    order_j = np.argsort(np.asarray(jmap.ptable))
    order_t = np.argsort(tmap.ptable.numpy())
    np.testing.assert_allclose(tcl.attrs.numpy()[order_t], np.asarray(jcl.attrs)[order_j],
                               rtol=1e-5, atol=1e-6)
    # Whole-map moves, rebuilds and evictions keep the channels.
    T = jse3.make_transform(jse3.so3_exp(jnp.asarray([0.0, 0.0, 0.2])), jnp.asarray([0.3, 0, 0]))
    tT = torch.from_numpy(np.asarray(T))
    _same_maps(jvm.transform(jmap, T), vm.transform(tmap, tT))
    _same_maps(jvm.rekey(jvm.transform_content(jmap, T)), vm.rekey(vm.transform_content(tmap, tT)))
    _same_maps(jvm.evict_low_weight(jmap, 0.5), vm.evict_low_weight(tmap, 0.5))
    # Carving zeroes the channel sums of the voxels it clears.
    jscan, tscan = _both(30, n=600, extent=3.0)
    origin = np.asarray([0.0, 0.0, 5.0], np.float32)
    jcarved = jvm.carve(jmap, jscan, jnp.asarray(origin), 0.25, 0.1, 10.0)
    tcarved = vm.carve(tmap, tscan, torch.from_numpy(origin), 0.25, 0.1, 10.0)
    _same_maps(jcarved, tcarved)
    cleared = (tcarved.weight == 0) & tmap.occupied & (tmap.weight > 0)
    assert bool(cleared.any()) and not bool(tcarved.sum_attrs[cleared].any())


def test_pad_scan_carries_the_template_channels():
    _, tc = _both(11)
    pad = _make_pad_scan(tc)
    assert pad.attr_names == tc.attr_names and pad.attrs.shape == tc.attrs.shape
    assert not bool(pad.mask.any()) and not bool(pad.attrs.any())


def test_random_downsampling_in_preprocessing():
    """The scan path's random stage (downsampling_ratio < 1): the host draws
    of ``seed`` after the voxel grid and the normals."""
    rng = np.random.default_rng(12)
    xyz = rng.uniform(-8, 8, (4096, 3)).astype(np.float32)
    scan = pc.make_cloud(xyz, device="cpu")
    kw = dict(wide_min_radius=0.5, wide_max_radius=12.0, voxel_size=0.4, capacity=4096,
              normal_engine="knn")
    full = preprocess_scan(scan, downsampling_ratio=1.0, **kw)
    half = preprocess_scan(scan, downsampling_ratio=0.5, seed=5, **kw)
    keep = full.mask & (filters.uniform(5, 4096, "cpu") < 0.5)
    assert torch.equal(half.mask, keep) and 0.4 < float(keep.sum() / full.mask.sum()) < 0.6
    assert torch.equal(half.xyz[keep], full.xyz[keep])


def test_icp_descriptor_gates_match_jax():
    """``generic_desc`` weights (hard, both sides, and soft) and the
    ``max_dist_field`` gate (knn 1 and 3), lane for lane."""
    rng = np.random.default_rng(13)
    n = 900
    d2 = rng.exponential(0.05, n).astype(np.float32)
    found = rng.uniform(size=n) > 0.2
    desc = rng.uniform(0, 1, n).astype(np.float32)
    for soft, larger in ((False, True), (False, False), (True, True)):
        chain = (("generic_desc", soft, larger, 0.4),)
        jw = jicp._weights(jicp.ICPConfig(outlier_chain=chain), jnp.asarray(d2),
                           jnp.asarray(found), None, None, ref_desc=jnp.asarray(desc))
        tw = icp._weights(icp.ICPConfig(outlier_chain=chain), torch.from_numpy(d2),
                          torch.from_numpy(found), None, None, None, None,
                          ref_desc=torch.from_numpy(desc))
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6)
    with pytest.raises(ValueError, match="desc_channel"):
        icp._weights(icp.ICPConfig(outlier_chain=(("generic_desc", False, True, 0.4),)),
                     torch.from_numpy(d2), torch.from_numpy(found), None, None, None, None)
    jc, tc = _both(14, n=300)
    vd = rng.uniform(0, 0.4, 300).astype(np.float32)
    jc, tc = jc.with_attr("maxSearchDist", jnp.asarray(vd)), tc.with_attr(
        "maxSearchDist", torch.from_numpy(vd))
    for knn in (1, 3):
        dd = rng.exponential(0.05, 300 * knn).astype(np.float32)
        ff = rng.uniform(size=300 * knn) > 0.1
        jcfg = jicp.ICPConfig(max_dist_field="maxSearchDist", knn=knn)
        tcfg = icp.ICPConfig(max_dist_field="maxSearchDist", knn=knn)
        jf, jp = jicp._vardist_gate(jcfg, jc, jnp.asarray(dd), jnp.asarray(ff),
                                    jnp.asarray(ff.reshape(300, knn).any(-1)))
        tf, tp = icp._vardist_gate(tcfg, tc, torch.from_numpy(dd), torch.from_numpy(ff),
                                   torch.from_numpy(ff.reshape(300, knn).any(-1)))
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


def test_knn_registration_with_a_per_point_radius_matches_jax():
    """``icp.register`` with kNN matching (knn 3) and ``max_dist_field`` on
    both sides: transform within 1e-4, same iterations and match ratio."""
    rng = np.random.default_rng(15)
    ref_xyz = rng.uniform(-3, 3, (1024, 3)).astype(np.float32)
    ref_xyz[:, 2] = 0.2 * np.sin(ref_xyz[:, 0]) + 0.1 * ref_xyz[:, 1]
    jref = jnormals.estimate_normals(jpc.make_cloud(jnp.asarray(ref_xyz)), radius=0.8, k=12)
    T = jse3.make_transform(jse3.so3_exp(jnp.asarray([0.0, 0.0, 0.01])),
                            jnp.asarray([0.05, -0.03, 0.02]))
    jsrc = jref.transform(jse3.inverse(T))
    vd = np.where(np.arange(1024) % 4 == 0, 1e-3, 0.5).astype(np.float32)
    jsrc = jsrc.with_attr("maxSearchDist", jnp.asarray(vd))
    tref, tsrc = convert.cloud_from_jax(jref, "cpu"), convert.cloud_from_jax(jsrc, "cpu")
    kw = dict(max_dist_field="maxSearchDist", knn=3, minimizer="point_to_plane",
              max_correspondence_dist=0.5)
    jres = jicp.register(jsrc, jhashgrid.passthrough(jref, 1.0), jnp.eye(4),
                         jicp.ICPConfig(**kw))
    tres = icp.register(tsrc, hashgrid.passthrough(tref, 1.0), torch.eye(4),
                        icp.ICPConfig(**kw))
    np.testing.assert_allclose(tres.transform.numpy(), np.asarray(jres.transform), atol=1e-4)
    assert int(tres.iterations) == int(jres.iterations)
    np.testing.assert_allclose(float(tres.match_ratio), float(jres.match_ratio), atol=1e-3)
    assert float(tres.match_ratio) < 0.8
