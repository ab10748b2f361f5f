"""The PyTorch port's pipeline step against the JAX package (CPU).

Both sides start from the same map (built by the JAX package, carried
across with ``utils.convert``) and take the same numpy scans and odometry
deltas.  The JAX package runs radius-moments normals in interpret mode
(``normal_engine="moments_interpret"``) and the brute-force matcher, so
the two run the same algorithm.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open3d_slam_advanced_rss_2024_public_tpu.models import pipeline as jpipe
from open3d_slam_advanced_rss_2024_public_tpu.models import scan_processing as jsp
from open3d_slam_advanced_rss_2024_public_tpu.ops.registration import ICPConfig as JICPConfig
from open3d_slam_advanced_rss_2024_public_tpu.utils.pointcloud import PointCloud as JCloud
from open3d_slam_advanced_rss_2024_public_tpu_torch.frontends import synthetic
from open3d_slam_advanced_rss_2024_public_tpu_torch.models import pipeline, scan_processing
from open3d_slam_advanced_rss_2024_public_tpu_torch.models.mapper import _make_pad_scan
from open3d_slam_advanced_rss_2024_public_tpu_torch.ops.registration import ICPConfig
from open3d_slam_advanced_rss_2024_public_tpu_torch.ops.registration import icp
from open3d_slam_advanced_rss_2024_public_tpu_torch.utils import convert, timing
from open3d_slam_advanced_rss_2024_public_tpu_torch.utils import pointcloud as pc

N = 2048
K = 4
_COMMON = dict(scan_voxel_size=0.1, scan_capacity=N, crop_min_radius=0.7,
               crop_max_radius=20.0, map_patch_capacity=4096, map_voxel_size=0.1,
               min_refinement_fitness=0.3)
JCFG = jpipe.PipelineConfig(icp=JICPConfig(matcher="bruteforce", max_iterations=15,
                                           max_correspondence_dist=0.5),
                            normal_engine="moments_interpret", **_COMMON)
TCFG = pipeline.PipelineConfig(icp=ICPConfig(matcher="bruteforce", max_iterations=15,
                                             max_correspondence_dist=0.5), **_COMMON)


@pytest.fixture(scope="module")
def scene():
    world = synthetic.cluttered_world(3, extent=30.0, n_objects=40, device="cpu")
    gt = synthetic.loop_trajectory(40, radius=9.0, center=(15.0, 0.0))[:K + 2]
    g = torch.Generator().manual_seed(4)
    scans = [synthetic.render_scan(world, gt[i], g, n_points=N, max_range=25.0, noise=0.004)
             for i in range(K + 2)]
    arrays = [(s.xyz.numpy(), s.normals.numpy(), s.mask.numpy()) for s in scans]
    # Odometry with a small per-step bias that ICP must remove.
    bias = np.eye(4, dtype=np.float32)
    bias[:3, 3] = [0.03, -0.02, 0.0]
    deltas = [(np.linalg.inv(gt[i - 1]) @ gt[i] @ bias).astype(np.float32)
              for i in range(1, K + 2)]
    return gt, arrays, deltas


def _jcloud(a):
    return JCloud(xyz=jnp.asarray(a[0]), normals=jnp.asarray(a[1]), mask=jnp.asarray(a[2]))


def _tcloud(a):
    return pc.PointCloud(torch.from_numpy(a[0]), torch.from_numpy(a[1]), torch.from_numpy(a[2]))


def _start(gt, arrays):
    """Both sides' state after the JAX package fuses the first two scans."""
    st = jpipe.init_state(1 << 14, jnp.asarray(gt[0]))
    st, _ = jpipe.mapper_step(st, _jcloud(arrays[0]), jnp.asarray(gt[0]), JCFG)
    st, _ = jpipe.mapper_step(st, _jcloud(arrays[1]), jnp.asarray(gt[1]), JCFG)
    m = st.map
    tst = convert.map_state_from_arrays(m.ptable, m.origin, m.acc, m.cell, m.dropped,
                                        st.pose, st.last_insertion_pose, device="cpu")
    return st, tst


def test_preprocess_matches_jax(scene):
    _, arrays, _ = scene
    a = jsp.preprocess_scan(_jcloud(arrays[2]), 0.7, 20.0, 0.1, 1.0, N,
                            normal_engine="moments_interpret")
    b = scan_processing.preprocess_scan(_tcloud(arrays[2]), 0.7, 20.0, 0.1, 1.0, N)
    # Same voxels in the same Morton order; means to float32 rounding.
    np.testing.assert_array_equal(b.mask.numpy(), np.asarray(a.mask))
    np.testing.assert_allclose(b.xyz.numpy(), np.asarray(a.xyz), atol=1e-5)
    # Normals: where both sides admit the same neighbours (JAX's bf16 d2
    # flips points on the radius boundary) and count >= 3, the same plane.
    from open3d_slam_advanced_rss_2024_public_tpu.ops import pallas_moments
    from open3d_slam_advanced_rss_2024_public_tpu_torch.ops import cuda_moments

    jc, _ = pallas_moments.radius_moments(a.xyz, a.mask, 0.5, interpret=True)
    tc, tcov = cuda_moments.radius_moments(b.xyz, b.mask, 0.5)
    # (Near-collinear neighbourhoods with an eigen-gap under 1e-4 m^2 have
    # no defined plane; see test_torch_kernels.py.)
    ev = np.linalg.eigvalsh(tcov.double().numpy())
    same = (np.asarray(a.mask) & (np.asarray(jc) == tc.numpy()) & (tc.numpy() >= 3)
            & (ev[:, 1] - ev[:, 0] > 1e-4))
    assert same.sum() > 0.5 * np.asarray(a.mask).sum()  # sparse scan: some lanes < 3 nbrs
    dots = np.abs((np.asarray(a.normals) * b.normals.numpy()).sum(1))
    assert (dots[same] >= 0.999).all()


def test_crop_submap_matches_jax(scene):
    gt, arrays, _ = scene
    st, tst = _start(gt, arrays)
    pos = np.asarray(gt[1][:3, 3])
    pa, ga = jsp.crop_submap_and_index(st.map.cloud, jnp.asarray(pos), 0.0, 8.0, 0.5,
                                       capacity=4096, build_hash=False)
    pb, gb = scan_processing.crop_submap_and_index(tst.map.cloud, torch.from_numpy(pos),
                                                   0.0, 8.0, 0.5, capacity=4096,
                                                   build_hash=False)
    np.testing.assert_array_equal(pb.mask.numpy(), np.asarray(pa.mask))
    np.testing.assert_allclose(gb.points.numpy(), np.asarray(ga.points), atol=1e-6)


def test_block_shared_ref_matches_jax(scene):
    gt, arrays, deltas = scene
    st, tst = _start(gt, arrays)
    blk = arrays[2:2 + K]
    jscans = JCloud(xyz=jnp.stack([a[0] for a in blk]), normals=jnp.stack([a[1] for a in blk]),
                    mask=jnp.stack([a[2] for a in blk]))
    en = np.array([True, True, False, True])
    jst, jout = jpipe.mapper_step_block_shared_ref(st, jscans, jnp.asarray(np.stack(deltas[1:])),
                                                   jnp.asarray(en), JCFG)
    tst2, tout = pipeline.mapper_step_block_shared_ref(
        tst, pc.stack([_tcloud(a) for a in blk]), torch.from_numpy(np.stack(deltas[1:])),
        torch.from_numpy(en), TCFG)
    jp, tp = np.asarray(jout.pose), tout.pose.numpy()
    # Per-scan poses within 1 mm (and the ICP recovered the truth).
    assert np.abs(tp[:, :3, 3] - jp[:, :3, 3]).max() < 1e-3
    assert np.abs(tp[:, :3, :3] - jp[:, :3, :3]).max() < 1e-3
    assert max(np.linalg.norm(tp[k, :3, 3] - gt[2 + k][:3, 3]) for k in range(K)) < 0.03
    np.testing.assert_array_equal(tout.inserted.numpy(), np.asarray(jout.inserted))
    np.testing.assert_array_equal(tout.res.iterations.numpy(), np.asarray(jout.res.iterations))
    # One fused insert: the same voxels (counts within the few boundary
    # voxels a sub-mm pose difference can move).
    assert abs(int(tst2.map.count()) - int(jst.map.count())) <= 0.002 * int(jst.map.count())
    np.testing.assert_allclose(tst2.last_insertion_pose.numpy(),
                               np.asarray(jst.last_insertion_pose), atol=1e-3)


def test_block_per_scan_matches_jax(scene):
    gt, arrays, deltas = scene
    st, tst = _start(gt, arrays)
    blk = arrays[2:4]
    jscans = JCloud(xyz=jnp.stack([a[0] for a in blk]), normals=jnp.stack([a[1] for a in blk]),
                    mask=jnp.stack([a[2] for a in blk]))
    en = np.array([True, True])
    _, jout = jpipe.mapper_step_block(st, jscans, jnp.asarray(np.stack(deltas[1:3])),
                                      jnp.asarray(en), JCFG)
    _, tout = pipeline.mapper_step_block(tst, pc.stack([_tcloud(a) for a in blk]),
                                         torch.from_numpy(np.stack(deltas[1:3])),
                                         torch.from_numpy(en), TCFG)
    assert np.abs(tout.pose.numpy()[:, :3, 3] - np.asarray(jout.pose)[:, :3, 3]).max() < 1e-3
    np.testing.assert_array_equal(tout.map_count.numpy() > 0, np.asarray(jout.map_count) > 0)


def test_chain_insert_block_matches_jax(scene):
    gt, arrays, _ = scene
    st, tst = _start(gt, arrays)
    merged = [np.asarray(jsp.preprocess_scan(_jcloud(a), 0.7, 20.0, 0.1, 1.0, N,
                                             normal_engine="moments_interpret")
                         .transform(jnp.asarray(gt[2 + k])).xyz) for k, a in
              enumerate(arrays[2:4])]
    masks = [np.abs(m[:, 0]) < 1e7 for m in merged]
    rec = np.array([True, False])
    jm = JCloud(xyz=jnp.asarray(np.stack(merged)), normals=jnp.zeros((2, N, 3)),
                mask=jnp.asarray(np.stack(masks)))
    tm = pc.PointCloud(torch.from_numpy(np.stack(merged)), torch.zeros((2, N, 3)),
                       torch.from_numpy(np.stack(masks)))
    a = jpipe.chain_insert_block(st, jm, jnp.asarray(rec), 0.1)
    b = pipeline.chain_insert_block(tst, tm, torch.from_numpy(rec), 0.1)
    assert int(b.map.count()) == int(a.map.count())
    ca, cb = a.map.cloud, b.map.cloud
    ka = np.sort(np.asarray(a.map.ptable)[np.asarray(ca.mask)])
    kb = np.sort(b.map.ptable.numpy()[cb.mask.numpy()])
    np.testing.assert_array_equal(kb, ka)


def _mapper_run(tst, arrays, deltas):
    """One scan through ``mapper_step``, then a full lag-4 block and a
    padded one (three scans and the Mapper's pad scan) through
    ``mapper_step_block_shared_ref``; the outputs and the Mapper's
    dispatched ICP trips."""
    timing.reset()
    timing.enable()
    try:
        st, out = pipeline.mapper_step(tst, _tcloud(arrays[2]),
                                       tst.pose @ torch.from_numpy(deltas[1]), TCFG)
        runs = [(st, out)]
        full = pc.stack([_tcloud(a) for a in arrays[2:2 + K]])
        runs.append(pipeline.mapper_step_block_shared_ref(
            tst, full, torch.from_numpy(np.stack(deltas[1:1 + K])),
            torch.ones(K, dtype=torch.bool), TCFG))
        real = [_tcloud(a) for a in arrays[3:2 + K]]
        padded = pc.stack(real + [_make_pad_scan(real[0])] * (K - len(real)))
        pad_deltas = deltas[2:1 + K] + [np.eye(4, dtype=np.float32)] * (K - len(real))
        en = torch.tensor([True] * len(real) + [False] * (K - len(real)))
        runs.append(pipeline.mapper_step_block_shared_ref(
            st, padded, torch.from_numpy(np.stack(pad_deltas)), en, TCFG))
        return runs, timing.records()["counts"]["mapper/icp_trips_dispatched"]
    finally:
        timing.disable()
        timing.reset()


def test_polled_mapper_loops_give_the_fixed_trip_results(scene, monkeypatch):
    gt, arrays, deltas = scene
    _, tst = _start(gt, arrays)
    polled, polled_trips = _mapper_run(tst, arrays, deltas)
    with monkeypatch.context() as m:
        m.setattr(pipeline, "icp_mod", types.SimpleNamespace(
            register=icp.register, prepare_reference=icp.prepare_reference, POLL_EVERY=0))
        fixed, fixed_trips = _mapper_run(tst, arrays, deltas)
    # Four registrations of 15 trips on each side: 1 + K + K.
    assert fixed_trips == 15 * (1 + 2 * K)
    assert polled_trips < fixed_trips
    for (pst, pout), (fst, fout) in zip(polled, fixed):
        for name in ("transform", "iterations", "converged", "match_ratio", "rmse"):
            np.testing.assert_array_equal(getattr(pout.res, name).numpy(),
                                          getattr(fout.res, name).numpy(), err_msg=name)
        np.testing.assert_array_equal(pout.pose.numpy(), fout.pose.numpy())
        np.testing.assert_array_equal(pout.inserted.numpy(), fout.inserted.numpy())
        np.testing.assert_array_equal(pst.pose.numpy(), fst.pose.numpy())
        pc_, fc = pst.map.cloud, fst.map.cloud
        np.testing.assert_array_equal(pc_.mask.numpy(), fc.mask.numpy())
        np.testing.assert_array_equal(pc_.xyz.numpy(), fc.xyz.numpy())
        np.testing.assert_array_equal(pc_.normals.numpy(), fc.normals.numpy())
    # Every real scan was inserted, and the pad scan was not.
    assert bool(polled[0][1].inserted) and polled[2][1].inserted.tolist() == [True] * 3 + [False]
