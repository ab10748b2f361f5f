"""The PyTorch port's CUDA kernels against their plain twins, on the card.

Every test here is marked ``cuda`` and skips where no CUDA device is
present.  The file imports neither jax nor the JAX package, so that it
runs on a machine with the card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda

(``--noconftest``: the suite's ``conftest.py`` sets JAX up.)
"""
import numpy as np
import pytest
import torch

from open3d_slam_advanced_rss_2024_public_tpu_torch.ops import (cuda_moments, cuda_nn, cuda_tiles,
                                                                hashgrid)
from open3d_slam_advanced_rss_2024_public_tpu_torch.utils import pointcloud as pc


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _morton(seed, n, extent, device):
    xyz = np.random.default_rng(seed).uniform(0, extent, (n, 3)).astype(np.float32)
    return hashgrid.morton_sort(pc.make_cloud(xyz, device=device), 0.5).xyz


@pytest.mark.cuda
def test_nn_kernel_matches_twin_on_cuda(cuda_device):
    q = _morton(20, 3000, 20.0, cuda_device)
    p = _morton(21, 9000, 20.0, cuda_device)
    cuda_nn.reset_launches()
    cuda_tiles.reset_launches()
    ki, kd2 = cuda_nn.nn(q, p, 0.5)
    # Counted where the kernels are enqueued: the reference's tile_prepare,
    # then tile_plan and the sweep from inside K1's launch function.
    assert cuda_nn.launches == 1
    assert (cuda_tiles.prepare_launches, cuda_tiles.plan_launches) == (1, 1)
    pi, pd2 = cuda_nn.nn_plain(q, p, 0.5)
    within = pd2 <= 0.25
    assert torch.equal(ki[within], pi[within])  # bit-identical d2, same tie rule
    assert torch.equal(kd2[within], pd2[within])


@pytest.mark.cuda
def test_nn_kernel_handles_invalid_and_ragged_inputs(cuda_device):
    # Neither side a multiple of its tile; a third of the queries and refs
    # carry the invalid-point sentinel.
    q = _morton(22, 1000, 10.0, cuda_device).clone()
    p = _morton(23, 5000, 10.0, cuda_device).clone()
    q[::3] = pc.SENTINEL
    p[1::3] = pc.SENTINEL
    ki, kd2 = cuda_nn.nn(q, p, 0.5)
    pi, pd2 = cuda_nn.nn_plain(q, p, 0.5)
    within = (pd2 <= 0.25) & (q[:, 0].abs() < 1e7)
    assert within.sum() > 500
    assert torch.equal(ki[within], pi[within])
    assert bool((p[ki[within], 0].abs() < 1e7).all())


@pytest.mark.cuda
def test_nn_kernel_merges_split_lists_with_the_twins_tie_rule(cuda_device):
    # Queries in random order: every query tile spans the scene, admits
    # every ref tile, and its list is cut over many blocks.  The refs twice
    # over: every query has two exact nearest neighbours 6000 indices apart,
    # swept by different blocks; the atomic merge must keep the lower index.
    p = _morton(24, 6000, 12.0, cuda_device)
    q = _morton(25, 2000, 12.0, cuda_device)
    q = q[torch.randperm(q.shape[0], device=cuda_device)]
    twice = torch.cat([p, p])
    ref = cuda_nn.prepare_ref(twice)
    _, count, _, _ = cuda_tiles.tile_plan(q[None], None, ref.center[None], ref.p_min[None],
                                          ref.p_max[None], 0.5)
    longest = int(count.max())
    assert longest > cuda_nn.tiles_per_block(longest, ref.p_min.shape[0])  # several blocks
    cuda_nn.reset_launches()
    for _ in range(3):  # one prepared reference serves every call
        ki, kd2 = cuda_nn.nn(q, ref, 0.5)
    assert cuda_nn.launches == 3
    pi, pd2 = cuda_nn.nn_plain(q, twice, 0.5)
    within = pd2 <= 0.25
    assert within.sum() > 500
    assert torch.equal(ki[within], pi[within])
    assert bool((ki[within] < p.shape[0]).all())  # the lower of the two tied indices
    assert torch.equal(kd2[within], pd2[within])


@pytest.mark.cuda
def test_nn_kernel_gives_no_candidate_an_infinite_distance(cuda_device):
    # A query far from every ref tile, and an invalid one: index 0, d2 = +inf.
    p = _morton(26, 3000, 10.0, cuda_device)
    q = _morton(27, 300, 10.0, cuda_device).clone()
    q[:64] += 500.0
    q[100] = pc.SENTINEL
    ki, kd2 = cuda_nn.nn(q, p, 0.5)
    assert bool(torch.isinf(kd2[:64]).all()) and bool((ki[:64] == 0).all())
    assert bool(torch.isinf(kd2[100])) and int(ki[100]) == 0
    assert ki.dtype == torch.int64 and int(ki.max()) < p.shape[0]


@pytest.mark.cuda
def test_tile_kernels_match_their_plain_versions_on_cuda(cuda_device):
    xyz = torch.stack([_morton(40 + k, 1500, 12.0, cuda_device) for k in range(2)])
    mask = torch.ones(xyz.shape[:2], dtype=torch.bool, device=cuda_device)
    mask[:, 2::5] = False
    xyz[0, 7::9] = pc.SENTINEL
    center = cuda_tiles.centroid(xyz, mask & (xyz[..., 0].abs() < 1e7))
    cuda_tiles.reset_launches()
    k_prep = cuda_tiles.tile_prepare(xyz, mask, center)
    k_plan = cuda_tiles.tile_plan(xyz, mask, center, k_prep[1], k_prep[2], 0.5)
    assert (cuda_tiles.prepare_launches, cuda_tiles.plan_launches) == (1, 1)
    p_prep = cuda_tiles.tile_prepare_plain(xyz, mask, center)
    p_plan = cuda_tiles.tile_plan_plain(xyz, mask, center, p_prep[1], p_prep[2], 0.5)
    for a, b in zip(k_prep + k_plan[2:], p_prep + p_plan[2:]):
        assert torch.equal(a, b)  # rows and boxes: exact
    # Lists: ascending, and every tile the plain version admits.
    n_tiles = k_plan[0].shape[-1]
    slot = torch.arange(n_tiles, device=cuda_device)
    for (lst, cnt), strict in ((k_plan[:2], True), (p_plan[:2], False)):
        used = slot < cnt[..., None]
        if strict:
            assert bool(((lst[..., 1:] > lst[..., :-1]) | ~used[..., 1:]).all())
        adm = torch.zeros(lst.shape, dtype=torch.int32, device=cuda_device)
        adm.scatter_add_(-1, torch.where(used, lst, 0).long(), used.int())
        if strict:
            k_adm = adm
        else:
            assert bool((k_adm >= adm).all()) and int(adm.max()) == 1
            assert int(k_adm.sum()) - int(adm.sum()) <= 2  # only on the rounding edge


@pytest.mark.cuda
def test_moments_kernel_matches_twin_on_cuda(cuda_device):
    rng = np.random.default_rng(30)
    xyz = torch.from_numpy(rng.uniform(0, 10.0, (3, 2000, 3)).astype(np.float32)).to(cuda_device)
    mask = torch.ones(xyz.shape[:2], dtype=torch.bool, device=cuda_device)
    mask[:, ::6] = False
    cuda_moments.reset_launches()
    cuda_tiles.reset_launches()
    kc, kcov = cuda_moments.radius_moments(xyz, mask, 0.5)
    assert cuda_moments.launches == 1  # one launch for the whole block
    assert (cuda_tiles.prepare_launches, cuda_tiles.plan_launches) == (1, 1)
    pc_, pcov = cuda_moments.radius_moments_plain(xyz, mask, 0.5)
    assert torch.equal(kc[mask], pc_[mask])  # same admitted neighbours
    # Sums of up to ~100 terms of <= 0.25 m^2 in another order (and FMAs).
    torch.testing.assert_close(kcov[mask], pcov[mask], atol=1e-5, rtol=0)


@pytest.mark.cuda
def test_moments_kernel_handles_ragged_and_sentinel_inputs(cuda_device):
    # M is no multiple of either tile; a third of the lanes are masked out,
    # some of them at the sentinel, some at real coordinates; one scan of the
    # block is wholly masked.
    xyz = torch.stack([_morton(50 + k, 1931, 8.0, cuda_device) for k in range(3)])
    mask = torch.ones(xyz.shape[:2], dtype=torch.bool, device=cuda_device)
    mask[:, ::3] = False
    xyz[:, ::6] = pc.SENTINEL
    mask[2] = False
    kc, kcov = cuda_moments.radius_moments(xyz, mask, 0.5)
    pc_, pcov = cuda_moments.radius_moments_plain(xyz, mask, 0.5)
    assert kc.shape == mask.shape and kcov.shape == mask.shape + (3, 3)
    assert float(pc_[mask].max()) > 5
    assert torch.equal(kc[mask], pc_[mask])
    torch.testing.assert_close(kcov[mask], pcov[mask], atol=1e-5, rtol=0)
    assert bool(torch.isfinite(kcov).all())
    # An unbatched call is the batched call's row.
    c0, cov0 = cuda_moments.radius_moments(xyz[0], mask[0], 0.5)
    assert torch.equal(c0, kc[0]) and torch.equal(cov0, kcov[0])


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    q = torch.zeros((8, 3), device=cuda_device)
    with pytest.raises(TypeError):
        cuda_nn.nn(q.double(), q.double(), 0.5)
    with pytest.raises(ValueError):
        cuda_nn.nn(q, q.cpu(), 0.5)
    with pytest.raises(ValueError):
        cuda_moments.radius_moments(q[None], torch.ones((1, 7), dtype=torch.bool,
                                                        device=cuda_device), 0.5)


def _mapper_scene():
    # Twelve 2048-point scans, lag-4 blocks and a 3 m submap size, so that
    # the Mapper rolls over.
    from open3d_slam_advanced_rss_2024_public_tpu_torch.frontends import synthetic
    from open3d_slam_advanced_rss_2024_public_tpu_torch.utils.config import load_parameters

    params = load_parameters({"mapper": {
        "mapper_localizer": {"pose_readback_lag": 4, "scan_to_map_registration": {
            "scan_processing": {"voxel_size": 0.1, "point_capacity": 2048,
                                "scan_cropping": {"cropping_radius_max": 25.0,
                                                  "cropping_radius_min": 0.7}},
            "map_patch_capacity": 4096}},
        "submaps": {"point_capacity": 1 << 14, "submap_size": 3.0},
        "map_builder": {"map_voxel_size": 0.1}}})
    world = synthetic.cluttered_world(0, extent=30.0, n_objects=40, device="cpu")
    gt = synthetic.loop_trajectory(100, radius=9.0, center=(15.0, 0.0), z=1.2)[:12]
    g = torch.Generator().manual_seed(6)
    scans = [synthetic.render_scan(world, gt[i], g, n_points=2048, max_range=25.0, noise=0.004)
             for i in range(12)]
    return params, gt, scans


def _run_mapper(params, gt, scans, dev):
    """The scans through a Mapper on ``dev``; its poses, one a scan."""
    from open3d_slam_advanced_rss_2024_public_tpu_torch.models.mapper import Mapper

    m = Mapper(params, device=dev)
    m.set_map_to_range_sensor(gt[0])
    for i, s in enumerate(scans):
        m.odom_buffer.push(0.1 * i, gt[i])
        m.add_range_measurement(s, 0.1 * i)
    m.flush()
    assert len(m.submaps.submaps) > 1
    assert int(m.get_assembled_map().mask.sum()) > 0
    return np.stack([p for _, p in m.map_to_range_sensor_buffer.items()])


@pytest.mark.cuda
def test_mapper_on_cuda_rolls_over_and_matches_the_cpu_twin_path(cuda_device):
    # The kernels, the CUDA-event readbacks and the rollover/tail re-fusion
    # all run on the card; the same scans through the plain twins on the CPU.
    params, gt, scans = _mapper_scene()
    poses = {dev.type: _run_mapper(params, gt, scans, dev)
             for dev in (cuda_device, torch.device("cpu"))}
    assert np.isfinite(poses["cuda"]).all()
    err = np.linalg.norm(poses["cuda"][:, :3, 3] - np.stack(gt)[:, :3, 3], axis=-1)
    assert err.max() < 0.03
    # ICP over sparse scans turns rounding differences (the order of the
    # index_add_ sums) into mm-level pose differences.
    assert np.abs(poses["cuda"][:, :3, 3] - poses["cpu"][:, :3, 3]).max() < 0.01


@pytest.mark.cuda
def test_mapper_on_cuda_stops_its_icp_loops_early_with_the_fixed_trip_poses(cuda_device,
                                                                            monkeypatch):
    # The polled done flag lands on the card while the host still enqueues,
    # so most of the Mapper's trips are never dispatched; forcing
    # poll_every=0 gives the fixed-trip loops on the same scans.
    import types

    from open3d_slam_advanced_rss_2024_public_tpu_torch.models import pipeline
    from open3d_slam_advanced_rss_2024_public_tpu_torch.models.mapper import icp_config_from_params
    from open3d_slam_advanced_rss_2024_public_tpu_torch.ops.registration import icp
    from open3d_slam_advanced_rss_2024_public_tpu_torch.utils import timing

    params, gt, scans = _mapper_scene()
    dispatched, poses = {}, {}
    for mode in ("polled", "fixed"):
        with monkeypatch.context() as m:
            if mode == "fixed":
                m.setattr(pipeline, "icp_mod", types.SimpleNamespace(
                    register=icp.register, prepare_reference=icp.prepare_reference,
                    POLL_EVERY=0))
            timing.reset()
            timing.enable()
            try:
                poses[mode] = _run_mapper(params, gt, scans, cuda_device)
                dispatched[mode] = timing.records()["counts"]["mapper/icp_trips_dispatched"]
            finally:
                timing.disable()
                timing.reset()
    # The order of the index_add_ sums differs from run to run on the card.
    assert np.abs(poses["polled"][:, :3, 3] - poses["fixed"][:, :3, 3]).max() < 0.01
    max_trips = icp_config_from_params(params).max_iterations
    assert dispatched["polled"] < 0.5 * max_trips * len(scans) < dispatched["fixed"]
