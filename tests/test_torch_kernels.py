"""K1 (nearest neighbour) and K2 (radius moments) of the PyTorch port.

On the CPU each wrapper runs its plain twin; these tests hold the twins,
and the host-side tiling the kernels share, against the JAX package
(``bruteforce.nn``, ``nn_pallas``/``radius_moments`` in interpret mode) and
against float64 numpy.  The CUDA kernels are held against these twins
on the card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open3d_slam_advanced_rss_2024_public_tpu.ops import bruteforce as jbf
from open3d_slam_advanced_rss_2024_public_tpu.ops import hashgrid as jhashgrid
from open3d_slam_advanced_rss_2024_public_tpu.ops import normals as jnormals
from open3d_slam_advanced_rss_2024_public_tpu.ops import pallas_moments, pallas_nn
from open3d_slam_advanced_rss_2024_public_tpu.utils.pointcloud import make_cloud as jmake
from open3d_slam_advanced_rss_2024_public_tpu_torch.ops import (cuda_moments, cuda_nn, cuda_tiles,
                                                                normals)
from open3d_slam_advanced_rss_2024_public_tpu_torch.utils import pointcloud as pc


def _morton(xyz, cell=0.5):
    return np.array(jhashgrid.morton_sort(jmake(xyz), cell).xyz)


def _pts(seed, n, extent):
    return np.random.default_rng(seed).uniform(0, extent, (n, 3)).astype(np.float32)


# --- K1 --------------------------------------------------------------------

@pytest.mark.parametrize("seed,m,n,extent,max_dist,prepared", [
    (0, 600, 6000, 8.0, 0.5, False), (1, 1000, 4000, 6.0, 0.5, False),
    (2, 131, 777, 5.0, 10.0, False), (3, 2048, 4096, 20.0, 0.5, False),
    (30, 700, 3000, 8.0, 0.5, True)])
def test_nn_twin_matches_jax_bruteforce(seed, m, n, extent, max_dist, prepared):
    q = _morton(_pts(seed, m, extent))
    p = _morton(_pts(seed + 100, n, extent))
    p[::9] = 1.0e8  # invalid refs (the sentinel)
    ji, jd2, jfound = jbf.nn(jnp.asarray(q), jnp.ones(m, bool), jnp.asarray(p), max_dist)
    ti, td2 = cuda_nn.nn(torch.from_numpy(q), torch.from_numpy(p), max_dist)
    if prepared:
        # The reference handed over as an NNRef, as ICP hands it (on the CPU
        # it carries the points alone): the same result as the raw tensor.
        ref = cuda_nn.prepare_ref(torch.from_numpy(p))
        assert isinstance(ref, cuda_nn.NNRef) and ref.soa is None
        ri, rd2 = cuda_nn.nn(torch.from_numpy(q), ref, max_dist)
        assert torch.equal(ri, ti) and torch.equal(rd2, td2)
        ti, td2 = ri, rd2
    ji, jd2, jfound = np.asarray(ji), np.asarray(jd2), np.asarray(jfound)
    ti, td2 = ti.numpy(), td2.numpy()
    within = jfound
    assert within.mean() > 0.1  # the radius gate does real work
    # d2 of the same exact problem after de-meaning by a centroid summed in
    # another order: float32 rounding of coordinates <= 20 m -> 1e-6.
    np.testing.assert_allclose(td2[within], jd2[within], atol=1e-6)
    # Same index except on ties: JAX ranks by |q|^2+|p|^2-2q.p, whose
    # rounding can swap candidates closer than 1e-6 m^2.
    differ = within & (ti != ji)
    assert (np.abs(td2 - jd2)[differ] <= 1e-6).all()
    assert (ti[within] == ji[within]).mean() > 0.99


@pytest.mark.parametrize("case", ["full_radius", "within_radius", "self_match",
                                  "nonmultiple", "masked_lanes"])
def test_nn_twin_matches_nn_pallas_interpret(case):
    # The cases of tests/test_pallas_nn.py.  The port is exact; the TPU
    # kernel's packed-mantissa argmin may pick a candidate up to 2.4e-4 m^2
    # farther, so the port's d2 is never worse than that.
    rng = np.random.default_rng(5)
    qmask = None
    if case == "full_radius":
        q, p, r = rng.uniform(0, 30, (700, 3)), rng.uniform(0, 30, (5000, 3)), 60.0
    elif case == "within_radius":
        q, p, r = _morton(_pts(6, 600, 8.0)), _morton(_pts(7, 6000, 8.0)), 0.5
    elif case == "self_match":
        q = p = rng.uniform(0, 10, (300, 3))
        r = 1.0
    elif case == "nonmultiple":
        q, p, r = rng.uniform(0, 5, (131, 3)), rng.uniform(0, 5, (777, 3)), 10.0
    else:
        q, p, r = rng.uniform(0, 6, (512, 3)), rng.uniform(0, 6, (4096, 3)), 0.5
        qmask = np.arange(512) % 3 != 0
        q = np.where(qmask[:, None], q, 1.0e8)
    q, p = q.astype(np.float32), p.astype(np.float32)
    ji, jd2 = pallas_nn.nn_pallas(jnp.asarray(q), jnp.asarray(p), max_dist=r, interpret=True)
    ti, td2 = cuda_nn.nn(torch.from_numpy(q), torch.from_numpy(p), r)
    jd2, td2 = np.asarray(jd2), td2.numpy()
    within = jd2 <= r * r
    if qmask is not None:
        within &= qmask
    assert within.any()
    assert (td2[within] <= jd2[within] + 2.4e-4).all()
    assert (ti.numpy()[within] == np.asarray(ji)[within]).mean() > 0.97
    assert ti.numpy().max() < p.shape[0]


def test_tile_lists_match_jax():
    # The host-side tiling feeding both kernels: same AABBs, same admissible
    # ref-tile lists in the same (stable) order.
    p = _morton(_pts(8, 12 * cuda_tiles.TP, 40.0))
    q = p[: 4 * cuda_tiles.TQ] + 0.05
    valid_q = np.ones(q.shape[0], bool)
    valid_q[5::11] = False
    jq = pallas_nn._tile_aabbs(jnp.pad(jnp.asarray(q), ((0, 0), (0, 5))).T,
                               jnp.asarray(valid_q), 4, cuda_tiles.TQ)
    jp = pallas_nn._tile_aabbs(jnp.pad(jnp.asarray(p), ((0, 0), (0, 5))).T,
                               jnp.ones(p.shape[0], bool), 12, cuda_tiles.TP)
    tq = cuda_tiles.tile_aabbs(torch.from_numpy(q), torch.from_numpy(valid_q), cuda_tiles.TQ)
    tp = cuda_tiles.tile_aabbs(torch.from_numpy(p), torch.ones(p.shape[0], dtype=torch.bool),
                             cuda_tiles.TP)
    for a, b in zip(jq + jp, tq + tp):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    jl, jc = pallas_nn._admissible_lists(*jq, *jp, 0.5)
    tl, tc = cuda_tiles.admissible_lists(*tq, *tp, 0.5)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc)[:, 0])
    for row in range(4):
        k = int(tc[row])
        np.testing.assert_array_equal(tl[row, :k].numpy(), np.asarray(jl)[row, :k])


@pytest.mark.parametrize("tq,tp", [(cuda_tiles.TQ, cuda_tiles.TP), (128, 256), (256, 1024)])
def test_tile_plan_plain_matches_jax_lists(tq, tp):
    # The plan kernel's plain version at the CUDA kernels' tile sizes (and
    # at the JAX kernels' own): boxes over the valid lanes of the de-meaned
    # clouds, and the lists pallas_nn._admissible_lists gives for the same
    # boxes.  Neither side is a multiple of its tile; both hold sentinels.
    p = _morton(_pts(18, 5 * tp + 37, 30.0))
    q = (p[: 3 * tq + 11] + 0.05).copy()
    p[3::7] = 1.0e8
    q[5::11] = 1.0e8
    tp_, tq_ = torch.from_numpy(p), torch.from_numpy(q)
    center = cuda_tiles.centroid(tp_, tp_[:, 0].abs() < 1e7)
    soa, p_min, p_max = cuda_tiles.tile_prepare_plain(tp_[None], None, center[None], tp)
    tl, tc, q_min, q_max = cuda_tiles.tile_plan_plain(tq_[None], None, center[None], p_min,
                                                      p_max, 0.5, tq)
    # The rows are K1's de-meaned refs, transposed and padded with FAR.
    _, r, _ = cuda_nn._demean(tq_, tp_)
    assert soa.shape == (1, 3, -(-p.shape[0] // tp) * tp)
    assert torch.equal(soa[0, :, :p.shape[0]], r.T)
    assert bool((soa[0, :, p.shape[0]:] == cuda_tiles.FAR).all())
    # An invalid lane takes no part in a box.
    qd = (tq_ - center).numpy()
    ok = np.abs(q[:, 0]) < 1e7
    lo = np.stack([qd[i:i + tq][ok[i:i + tq]].min(0) for i in range(0, len(q), tq)])
    np.testing.assert_array_equal(q_min[0].numpy(), lo)
    jl, jc = pallas_nn._admissible_lists(*(jnp.asarray(t[0].numpy())
                                           for t in (q_min, q_max, p_min, p_max)), 0.5)
    np.testing.assert_array_equal(tc[0].numpy(), np.asarray(jc)[:, 0])
    assert 0 < int(tc.sum()) < tc.numel() * p_min.shape[1]  # the gate does real work
    for row in range(tc.shape[1]):
        k = int(tc[0, row])
        np.testing.assert_array_equal(tl[0, row, :k].numpy(), np.asarray(jl)[row, :k])


def test_tile_plan_plain_admits_no_empty_tile_at_infinite_max_dist():
    # At maxDist inf (KDTreeMatcher's default) every gap passes, the
    # infinite gap of an empty box too: a query tile that holds only
    # sentinels, or a ref tile of padding, must still admit nothing, and
    # every other tile pair is admitted.  K1's answers stay the twin's.
    tq, tp = cuda_tiles.TQ, cuda_tiles.TP
    p = _morton(_pts(40, 3 * tp + 17, 10.0))
    p[tp:2 * tp] = 1.0e8                      # ref tile 1: sentinels only
    q = _morton(_pts(41, 4 * tq, 10.0))
    q[2 * tq:3 * tq] = 1.0e8                  # query tile 2: sentinels only
    q[3 * tq + 5::3] = 1.0e8                  # query tile 3: mixed
    tp_, tq_ = torch.from_numpy(p), torch.from_numpy(q)
    center = cuda_tiles.centroid(tp_, tp_[:, 0].abs() < 1e7)
    _, p_min, p_max = cuda_tiles.tile_prepare_plain(tp_[None], None, center[None])
    tl, tc, _, _ = cuda_tiles.tile_plan_plain(tq_[None], None, center[None], p_min, p_max,
                                              float("inf"))
    assert tc[0].tolist() == [3, 3, 0, 3]
    for row in (0, 1, 3):
        assert tl[0, row, :3].tolist() == [0, 2, 3]
    idx, d2 = cuda_nn.nn_plain(tq_, tp_, float("inf"))
    ok = np.abs(q[:, 0]) < 1e7
    ref = p[np.abs(p[:, 0]) < 1e7]
    want = ((q[ok, None, :].astype(np.float64) - ref[None]) ** 2).sum(-1).min(-1)
    np.testing.assert_allclose(d2[ok].numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case", ["random", "tied", "tied_across_blocks"])
def test_merge_key_minimum_is_least_d2_then_lowest_index(case):
    # The sweep's blocks merge their winners by an atomic minimum on the
    # 64-bit key (bits of d2 << 32 | index).  For d2 >= 0 the float's bits
    # order as the float does, so the least key is the least d2 and, among
    # equal d2, the lowest index - in whatever order the candidates arrive.
    rng = np.random.default_rng(21)
    m, n = 64, 500
    d2 = rng.uniform(0, 4, (m, n)).astype(np.float32) ** 2
    if case != "random":
        d2 = np.round(d2 * 4) / 4  # many exact ties, zeros among them
    if case == "tied_across_blocks":
        d2[:, n // 2:] = d2[:, :n // 2]  # every minimum twice, 250 apart
    idx = np.broadcast_to(np.arange(n, dtype=np.uint64), (m, n))
    keys = (d2.view(np.uint32).astype(np.uint64) << np.uint64(32)) | idx
    order = rng.permutation(n)  # the order the blocks happen to finish in
    best = np.minimum.reduce(keys[:, order], axis=1)
    want_idx = np.argmin(d2, axis=1)  # numpy's argmin returns the first minimum
    np.testing.assert_array_equal(best & np.uint64(0xFFFFFFFF), want_idx.astype(np.uint64))
    got_d2 = (best >> np.uint64(32)).astype(np.uint32).view(np.float32)
    np.testing.assert_array_equal(got_d2, d2.min(axis=1))
    # Every key is below the "no candidate" key, +inf included.
    inf_key = np.uint64(np.float32(np.inf).view(np.uint32)) << np.uint64(32)
    assert inf_key < np.uint64(0xFFFFFFFFFFFFFFFF)


def test_kernel_wrappers_raise_off_cuda():
    # A non-CPU, non-CUDA tensor reaches the kernel path, which refuses it
    # rather than fall back to the twin.
    q = torch.empty((8, 3), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        cuda_nn.nn(q, q, 0.5)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_moments.radius_moments(q, torch.empty((8,), dtype=torch.bool, device="meta"), 0.5)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_nn.prepare_ref(q)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_tiles.tile_prepare(q[None], None, q[None, 0])
    with pytest.raises(ValueError, match="CUDA"):
        cuda_tiles.tile_plan(q[None], None, q[None, 0], q[None], q[None], 0.5)


# --- K2 --------------------------------------------------------------------

def _numpy_moments(pts, mask, r):
    d2 = ((pts[:, None].astype(np.float64) - pts[None].astype(np.float64)) ** 2).sum(-1)
    adj = (d2 <= r * r) & mask[None, :]
    count = adj.sum(1)
    cov = np.zeros((len(pts), 3, 3))
    for i in range(len(pts)):
        nb = pts[adj[i]].astype(np.float64)
        if len(nb):
            cov[i] = np.cov(nb.T, bias=True)
    return count, cov, np.abs(np.sqrt(d2) - r)


@pytest.mark.parametrize("seed,n,extent,r", [(0, 500, 4.0, 0.7), (1, 700, 3.0, 0.6),
                                             (2, 1200, 12.0, 0.5)])
def test_moments_twin_matches_float64(seed, n, extent, r):
    pts = _pts(seed, n, extent)
    mask = np.arange(n) % 4 != 0
    count, cov = cuda_moments.radius_moments(torch.from_numpy(np.where(mask[:, None], pts, 1e8)
                                                              .astype(np.float32)),
                                             torch.from_numpy(mask), r)
    ref_count, ref_cov, gap = _numpy_moments(pts, mask, r)
    count, cov = count.numpy(), cov.numpy()
    # Counts exact except for a neighbour within 1e-5 of the radius, where
    # float32 and float64 distances may fall on either side.
    near = ((gap < 1e-5) & mask[None, :]).any(1)
    ok = mask & ~near
    np.testing.assert_array_equal(count[ok], ref_count[ok])
    # Covariance from float32 sums of offsets <= r: within 1e-5.
    np.testing.assert_allclose(cov[ok], ref_cov[ok], atol=1e-5)


def test_moments_twin_matches_radius_moments_interpret():
    rng = np.random.default_rng(3)
    pts = rng.uniform(0, 4, (500, 3)).astype(np.float32)
    mask = np.arange(500) % 5 != 0
    jc, jcov = pallas_moments.radius_moments(jnp.asarray(pts), jnp.asarray(mask), 0.7,
                                             interpret=True)
    tc, tcov = cuda_moments.radius_moments(torch.from_numpy(pts), torch.from_numpy(mask), 0.7)
    jc, tc = np.asarray(jc)[mask], tc.numpy()[mask]
    # JAX forms d2 from a bf16 hi/lo product: boundary points may flip, by
    # at most 2 (tests/test_moments_normals.py:24).
    assert (np.abs(tc - jc) <= 2).all()
    same = tc == jc
    assert same.mean() > 0.98
    # Same neighbour set -> same covariance; JAX sums map-frame moments in
    # float32 (cancellation), the port offsets from the query: 2e-4.
    np.testing.assert_allclose(tcov.numpy()[mask][same], np.asarray(jcov)[mask][same], atol=2e-4)


def _cov_from_acc(acc):
    """Count and covariance from the ten sums, each row of the matrix
    stacked on its own (the way the sums were first turned into a
    covariance, outside the kernel)."""
    count = acc[..., 0]
    denom = torch.clamp(count, min=1.0)[..., None]
    mean = acc[..., 1:4] / denom
    s = acc[..., 4:10] / denom
    m2 = torch.stack([
        torch.stack([s[..., 0], s[..., 1], s[..., 2]], -1),
        torch.stack([s[..., 1], s[..., 3], s[..., 4]], -1),
        torch.stack([s[..., 2], s[..., 4], s[..., 5]], -1),
    ], dim=-2)
    return count, m2 - mean[..., :, None] * mean[..., None, :]


def test_moments_count_and_covariance_formed_directly_match_cov_from_acc():
    pts = torch.from_numpy(_pts(40, 600, 3.0))
    mask = torch.from_numpy(np.arange(600) % 7 != 0)
    x, p, _ = cuda_nn._demean(pts[None], pts[None], mask[None])
    acc = cuda_moments.moments_plain(x, p, cuda_tiles.r2_of(0.5))
    assert float(acc[..., 0].max()) > 3  # neighbourhoods with several points
    acc[0, :5] = 0.0  # and some with none: count 0 divides by 1
    count, cov = cuda_moments._count_cov(acc)
    want_count, want_cov = _cov_from_acc(acc)
    assert torch.equal(count, want_count) and torch.equal(cov, want_cov)
    assert torch.equal(cov, cov.transpose(-1, -2))
    got = cuda_moments.radius_moments(pts, mask, 0.5)
    assert torch.equal(got[0][5:], count[0, 5:]) and torch.equal(got[1][5:], cov[0, 5:])


def test_moments_batched_rows_match_unbatched():
    rows = [_pts(10 + k, 400, 3.0) for k in range(3)]
    masks = [np.arange(400) % (k + 2) != 0 for k in range(3)]
    bc, bcov = cuda_moments.radius_moments(torch.from_numpy(np.stack(rows)),
                                           torch.from_numpy(np.stack(masks)), 0.5)
    for k in range(3):
        c, cov = cuda_moments.radius_moments(torch.from_numpy(rows[k]),
                                             torch.from_numpy(masks[k]), 0.5)
        assert torch.equal(bc[k], c)
        torch.testing.assert_close(bcov[k], cov)


def test_estimate_normals_radius_matches_jax_interpret():
    from open3d_slam_advanced_rss_2024_public_tpu_torch.frontends import synthetic

    world = synthetic.cluttered_world(2, extent=10.0, n_objects=8, device="cpu")
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [3.0, 0.0, 1.0]
    g = torch.Generator().manual_seed(3)
    scan = synthetic.render_scan(world, pose, g, n_points=1024, max_range=12.0, noise=0.002)
    xyz, mask = scan.xyz.numpy(), scan.mask.numpy()
    a = jnormals.estimate_normals_radius(jmake(xyz, mask=mask), 0.5, interpret=True)
    b = normals.estimate_normals_radius(scan, 0.5)
    jc, _ = pallas_moments.radius_moments(jnp.asarray(xyz), jnp.asarray(mask), 0.5,
                                          interpret=True)
    tc, tcov = cuda_moments.radius_moments(scan.xyz, scan.mask, 0.5)
    # Where both sides admit the same neighbours (JAX's bf16 d2 may flip a
    # point on the radius boundary), count >= 3 and the plane is defined:
    # the same normal.  JAX sums map-frame moments in float32, whose
    # cancellation leaves ~1e-7 in the covariance; that tilts a normal by
    # ~1e-7 / (e1 - e0), so neighbourhoods with an eigen-gap under 1e-4 m^2
    # (near-collinear triples) are ill-defined on both sides and skipped.
    ev = np.linalg.eigvalsh(tcov.double().numpy())
    same = (mask & (np.asarray(jc) == tc.numpy()) & (tc.numpy() >= 3)
            & (ev[:, 1] - ev[:, 0] > 1e-4))
    assert same.sum() > 0.7 * mask.sum()
    dots = np.abs((np.asarray(a.normals) * b.normals.numpy()).sum(1))
    assert (dots[same] >= 0.999).all()
