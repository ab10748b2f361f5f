"""Parity of the PyTorch port's core modules with the JAX package (CPU).

Inputs are made with numpy from a seed and fed to both sides; each
tolerance states its reason.  Covers utils/pointcloud, utils/se3,
ops/hashgrid, ops/croppers, ops/filters, ops/voxel_map, utils/convert and
the rule that the port imports neither jax nor the JAX package.
"""
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open3d_slam_advanced_rss_2024_public_tpu.ops import filters as jfilters
from open3d_slam_advanced_rss_2024_public_tpu.ops import hashgrid as jhashgrid
from open3d_slam_advanced_rss_2024_public_tpu.ops import voxel_map as jvm
from open3d_slam_advanced_rss_2024_public_tpu.utils import pointcloud as jpc
from open3d_slam_advanced_rss_2024_public_tpu.utils import se3 as jse3
from open3d_slam_advanced_rss_2024_public_tpu_torch.ops import croppers, filters, hashgrid
from open3d_slam_advanced_rss_2024_public_tpu_torch.ops import voxel_map as vm
from open3d_slam_advanced_rss_2024_public_tpu_torch.utils import convert, se3
from open3d_slam_advanced_rss_2024_public_tpu_torch.utils import pointcloud as pc

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = "open3d_slam_advanced_rss_2024_public_tpu_torch"


def _scan_arrays(seed, n=1500, extent=10.0, invalid_every=7):
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-extent, extent, (n, 3)).astype(np.float32)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    mask = np.arange(n) % invalid_every != 0
    return xyz, nrm, mask


def _both_clouds(xyz, nrm=None, mask=None):
    return (jpc.make_cloud(xyz, normals=nrm, mask=mask),
            pc.make_cloud(torch.from_numpy(xyz),
                          normals=None if nrm is None else torch.from_numpy(nrm),
                          mask=None if mask is None else torch.from_numpy(mask)))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_compact_matches_jax_and_is_stable():
    xyz, nrm, mask = _scan_arrays(0, n=300)
    jc, tc = _both_clouds(xyz, nrm, mask)
    for cap in (100, 300, 400):  # truncate, exact, pad
        a, b = jpc.compact(jc, cap), pc.compact(tc, cap)
        np.testing.assert_array_equal(_np(a.mask), _np(b.mask))
        np.testing.assert_array_equal(_np(a.xyz), _np(b.xyz))  # a pure gather: exact
        np.testing.assert_array_equal(_np(a.normals), _np(b.normals))


def test_compact_batched_rows_match_unbatched():
    xyz, nrm, mask = _scan_arrays(1, n=200)
    clouds = [pc.make_cloud(torch.from_numpy(xyz + k), mask=torch.from_numpy(np.roll(mask, k)))
              for k in range(3)]
    out = pc.compact(pc.stack(clouds), 150)
    for k, c in enumerate(clouds):
        ref = pc.compact(c, 150)
        assert torch.equal(out.xyz[k], ref.xyz) and torch.equal(out.mask[k], ref.mask)


def test_se3_matches_jax():
    rng = np.random.default_rng(2)
    xi = rng.normal(scale=[0.5, 0.5, 0.5, 3.0, 3.0, 3.0], size=(16, 6)).astype(np.float32)
    xi[0, :3] = 1e-4  # the small-angle Taylor branch
    Tj, Tt = jse3.se3_exp(jnp.asarray(xi)), se3.se3_exp(torch.from_numpy(xi))
    # float32 transcendental functions differ in the last ulps between XLA
    # and torch: 1e-6 absolute on unit-scale rotations, 1e-5 on translations.
    np.testing.assert_allclose(_np(Tt), _np(Tj), atol=1e-5)
    np.testing.assert_allclose(_np(se3.inverse(Tt)), _np(jse3.inverse(Tj)), atol=1e-5)
    pts = rng.normal(size=(16, 50, 3)).astype(np.float32)
    np.testing.assert_allclose(_np(se3.apply(Tt, torch.from_numpy(pts))),
                               _np(jse3.apply(Tj, jnp.asarray(pts))), atol=1e-4)
    np.testing.assert_allclose(_np(se3.rotation_angle(Tt)),
                               _np(jse3.rotation_angle(Tj)), atol=2e-3)


def test_orthonormalize_matches_jax_svd():
    # Newton's polar iteration vs the JAX package's SVD: both return the
    # nearest rotation; drift of 1e-3 is far beyond what ICP accumulates.
    rng = np.random.default_rng(3)
    T = np.asarray(jse3.se3_exp(jnp.asarray(rng.normal(size=(8, 6)).astype(np.float32))))
    T = T.copy()
    T[:, :3, :3] += rng.normal(scale=1e-3, size=(8, 3, 3)).astype(np.float32)
    a = _np(jse3.orthonormalize(jnp.asarray(T)))
    b = _np(se3.orthonormalize(torch.from_numpy(T)))
    np.testing.assert_allclose(b, a, atol=2e-6)
    R = b[:, :3, :3]
    np.testing.assert_allclose(R @ R.transpose(0, 2, 1), np.broadcast_to(np.eye(3), R.shape),
                               atol=1e-6)


@pytest.mark.parametrize("cell", [0.1, 0.5])
def test_morton_sort_same_order_as_jax(cell):
    # Same codes and the same stable order: the kernel's tile layout
    # depends on it.
    xyz, nrm, mask = _scan_arrays(4, n=2000, extent=20.0)
    jc, tc = _both_clouds(xyz, nrm, mask)
    np.testing.assert_array_equal(_np(hashgrid.morton_code(tc.xyz, tc.mask, cell)),
                                  _np(jhashgrid.morton_code(jc.xyz, jc.mask, cell)))
    a, b = jhashgrid.morton_sort(jc, cell), hashgrid.morton_sort(tc, cell)
    np.testing.assert_array_equal(_np(b.xyz), _np(a.xyz))


def test_crop_and_non_finite_match_jax():
    from open3d_slam_advanced_rss_2024_public_tpu.ops import croppers as jcroppers

    xyz, nrm, mask = _scan_arrays(5, n=1000)
    xyz[3] = np.nan
    xyz[10, 1] = np.inf
    jc, tc = _both_clouds(xyz, nrm, mask)
    jc, tc = jfilters.remove_non_finite(jc), filters.remove_non_finite(tc)
    np.testing.assert_array_equal(_np(tc.mask), _np(jc.mask))
    jm = jcroppers.min_max_radius_cropper(2.0, 9.0).contains(jc.xyz)
    tm = croppers.min_max_radius_cropper(2.0, 9.0).contains(tc.xyz)
    np.testing.assert_array_equal(_np(tm), _np(jm))


@pytest.mark.parametrize("extent,voxel", [(10.0, 0.1), (15.0, 0.3), (60.0, 0.05)])
def test_voxel_downsample_morton_matches_jax(extent, voxel):
    # Same voxel set, same Z-order, same means.  (60 m at 5 cm spans more
    # than 1024 cells: the coarse-major second sort.)  Means: float32 sums
    # of a few points in possibly different order -> 1e-5 absolute.
    xyz, nrm, mask = _scan_arrays(6, n=3000, extent=extent)
    xyz = np.round(xyz / voxel * 4) * voxel / 4  # several points per voxel
    jc, tc = _both_clouds(xyz, nrm, mask)
    cap = 2500
    a = jfilters.voxel_downsample(jc, voxel, cap, order="morton")
    b = filters.voxel_downsample(tc, voxel, cap, order="morton")
    np.testing.assert_array_equal(_np(b.mask), _np(a.mask))
    np.testing.assert_allclose(_np(b.xyz), _np(a.xyz), atol=1e-5)
    np.testing.assert_allclose(_np(b.normals), _np(a.normals), atol=1e-5)


def test_voxel_downsample_batched_rows_match_unbatched():
    rows = [pc.make_cloud(torch.from_numpy(_scan_arrays(7 + k, n=800)[0]),
                          mask=torch.from_numpy(_scan_arrays(7 + k, n=800)[2]))
            for k in range(3)]
    out = filters.voxel_downsample(pc.stack(rows), 0.5, 600)
    for k, c in enumerate(rows):
        ref = filters.voxel_downsample(c, 0.5, 600)
        assert torch.equal(out.mask[k], ref.mask)
        torch.testing.assert_close(out.xyz[k], ref.xyz)


def test_mix32_matches_jax_uint32():
    rng = np.random.default_rng(8)
    keys = rng.integers(0, 2 ** 31 - 1, 4096).astype(np.int32)
    keys[:3] = [0, 0x7FFFFFFF, 1]
    a = np.asarray(jvm._mix32(jnp.asarray(keys))).astype(np.int64)
    b = vm._mix32(torch.from_numpy(keys)).numpy()
    np.testing.assert_array_equal(b, a)  # integer hash: bit-exact


def _table_dict(ptable, acc):
    ptable, acc = np.asarray(ptable), np.asarray(acc)
    occ = ptable != 0x7FFFFFFF
    return {int(k): acc[i] for i, k in zip(np.nonzero(occ)[0], ptable[occ])}


def _assert_same_tables(a_ptable, a_acc, b_ptable, b_acc):
    # Same set of packed keys; slot layout may differ (scatter order).  Sums
    # per key within 1e-6 relative: float32 sums of the same points in
    # another order.
    da, db = _table_dict(a_ptable, a_acc), _table_dict(b_ptable, b_acc)
    assert set(da) == set(db)
    keys = sorted(da)
    np.testing.assert_allclose(np.stack([db[k] for k in keys]),
                               np.stack([da[k] for k in keys]), rtol=1e-6, atol=1e-6)


def test_voxel_map_insert_matches_jax():
    rng = np.random.default_rng(9)
    jmap, tmap = jvm.empty(4096), vm.empty(4096, device="cpu")
    for s in range(3):
        xyz = (rng.uniform(-3, 3, (1200, 3)) + [s * 0.5, 0, 0]).astype(np.float32)
        mask = rng.uniform(size=1200) > 0.1
        jc, tc = _both_clouds(xyz, None, mask)
        jmap = jvm.insert(jmap, jc, 0.25)
        tmap = vm.insert(tmap, tc, 0.25)
    _assert_same_tables(jmap.ptable, jmap.acc, tmap.ptable.numpy(), tmap.acc.numpy())
    np.testing.assert_array_equal(tmap.origin.numpy(), np.asarray(jmap.origin))
    assert int(tmap.count()) == int(jmap.count())
    assert float(tmap.dropped) == float(jmap.dropped)


def test_voxel_map_overflow_drops_and_evicts_like_jax():
    # A table too small for the scan: same drop count, then both eviction
    # policies keep the same voxels.
    rng = np.random.default_rng(10)
    xyz = rng.uniform(-4, 4, (3000, 3)).astype(np.float32)
    jc, tc = _both_clouds(xyz)
    jmap = jvm.insert(jvm.empty(512), jc, 0.5)
    tmap = vm.insert(vm.empty(512, device="cpu"), tc, 0.5)
    assert float(tmap.dropped) == float(jmap.dropped) > 0
    _assert_same_tables(jmap.ptable, jmap.acc, tmap.ptable.numpy(), tmap.acc.numpy())
    a, b = jvm.evict_low_weight(jmap, 0.5), vm.evict_low_weight(tmap, 0.5)
    assert int(b.count()) == int(a.count())
    center = np.array([1.0, -1.0, 0.5], np.float32)
    a = jvm.evict_far(jmap, jnp.asarray(center), 0.5)
    b = vm.evict_far(tmap, torch.from_numpy(center), 0.5)
    _assert_same_tables(a.ptable, a.acc, b.ptable.numpy(), b.acc.numpy())


def test_convert_carries_a_jax_map_across():
    rng = np.random.default_rng(11)
    jc, _ = _both_clouds(rng.uniform(-3, 3, (900, 3)).astype(np.float32))
    jmap = jvm.insert(jvm.empty(2048), jc, 0.2)
    tmap = convert.voxel_map_from_arrays(jmap.ptable, jmap.origin, jmap.acc, jmap.cell,
                                         jmap.dropped, device="cpu")
    np.testing.assert_allclose(tmap.cloud.xyz.numpy(), np.asarray(jmap.cloud.xyz), rtol=1e-6)
    # Inserting into the carried map keeps the two in step.
    jc2, tc2 = _both_clouds(rng.uniform(-3, 3, (700, 3)).astype(np.float32))
    jmap, tmap = jvm.insert(jmap, jc2, 0.2), vm.insert(tmap, tc2, 0.2)
    _assert_same_tables(jmap.ptable, jmap.acc, tmap.ptable.numpy(), tmap.acc.numpy())
    params = convert.params_from_dict({"mapper": {"submaps": {"submap_size": 7.0}}})
    assert params.mapper.submaps.submap_size == 7.0
    with pytest.raises(KeyError):
        convert.params_from_dict({"mapper": {"no_such_key": 1}})


def test_port_imports_neither_jax_nor_the_jax_package():
    # Every module of the port, and chip_smoke.py, imported with jax made
    # unimportable; then no module of the JAX package may be loaded.
    code = f"""
import importlib, pathlib, sys
sys.modules["jax"] = None
root = pathlib.Path({str(REPO)!r})
sys.path.insert(0, str(root))
for p in sorted((root / {PORT!r}).rglob("*.py")):
    rel = p.relative_to(root).with_suffix("")
    parts = [x for x in rel.parts if x != "__init__"]
    importlib.import_module(".".join(parts))
importlib.import_module("chip_smoke")
# The command-line path's, the ICP chain's, the rosbag path's and the
# multi-chip path's modules among them, none of which may fall back on the
# JAX package's pure-Python copies; and none may start a process group.
for name in ("frontends.cli", "frontends.replay", "frontends.kitti", "native",
             "utils.lua_config", "utils.yaml_config", "utils.frames",
             "models.map_initializer", "ops.filters_extra", "ops.registration.chain",
             "ops.registration.sequence", "ops.registration.inspectors",
             "ops.registration.loggers", "ops.registration.parametrizable",
             "frontends.rosbag", "frontends.online", "frontends.viz",
             "frontends.visualizer_node", "frontends.adjacency_example", "models.imu",
             "parallel", "parallel.mesh", "parallel.sharded_icp", "parallel.sharded_map",
             "parallel.sharded_slam", "parallel.sharded_session",
             "parallel.distributed_pose_graph"):
    assert {PORT!r} + "." + name in sys.modules, name
assert "yaml" not in sys.modules  # imported by the YAML loader when it loads
import torch.distributed
assert not torch.distributed.is_initialized()
bad = [m for m in sys.modules if m == "jax" and sys.modules[m] is not None
       or m == "open3d_slam_advanced_rss_2024_public_tpu"
       or m.startswith("open3d_slam_advanced_rss_2024_public_tpu.")
       or m.startswith("jax.") or m.startswith("jaxlib")]
assert not bad, bad
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=str(REPO))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_mapper_without_cpu_device_raises_where_no_cuda():
    from open3d_slam_advanced_rss_2024_public_tpu_torch.models.mapper import Mapper
    from open3d_slam_advanced_rss_2024_public_tpu_torch.utils.config import load_parameters

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        Mapper(load_parameters())
    assert Mapper(load_parameters(), device="cpu").device.type == "cpu"


def test_unported_surface_raises_not_implemented():
    # Nothing stays unported.  The sharded matcher (ROADMAP item 19), the
    # last part that raised here, now runs where a mesh is registered under
    # its axis (``test_torch_parallel.py``) and raises ValueError where none
    # is.  The hashed grid, GICP and the other minimizers, carving, and the
    # parts of ICP that need descriptor channels (item 17), which raised
    # here before, run (``test_torch_registration.py``,
    # ``test_torch_hashgrid.py``, ``test_torch_chain.py``).
    import torch.distributed as dist

    from open3d_slam_advanced_rss_2024_public_tpu_torch.models import scan_processing
    from open3d_slam_advanced_rss_2024_public_tpu_torch.models.submap_collection import (
        SubmapCollection)
    from open3d_slam_advanced_rss_2024_public_tpu_torch.ops.registration import icp
    from open3d_slam_advanced_rss_2024_public_tpu_torch.parallel import mesh as pmesh
    from open3d_slam_advanced_rss_2024_public_tpu_torch.parallel.sharded_slam import (
        init_distributed)
    from open3d_slam_advanced_rss_2024_public_tpu_torch.utils.config import load_parameters

    sharded = (icp.ICPConfig(matcher="sharded", shard_axis="map"), icp.ICPConfig(shard_axis="map"))
    for cfg in sharded:
        with pytest.raises(ValueError, match="no mesh has the axis 'map'"):
            icp.check_supported(cfg)
    init_distributed(device="cpu")  # a world of one on a local store
    try:
        pmesh.make_mesh(device="cpu", axis="map")
        for cfg in sharded:
            icp.check_supported(cfg)
    finally:
        dist.destroy_process_group()
    # The mesh goes with its process group.
    for cfg in sharded:
        with pytest.raises(ValueError, match="no mesh has the axis 'map'"):
            icp.check_supported(cfg)
    assert "map" not in pmesh._MESHES
    with pytest.raises(ValueError, match="needs shard_axis"):
        icp.check_supported(icp.ICPConfig(matcher="sharded"))
    # No module refuses a part of the surface, naming a ROADMAP item.
    assert not any("ROADMAP §1 item" in p.read_text() for p in (REPO / PORT).rglob("*.py"))
    for cfg in (icp.ICPConfig(matcher="hashgrid", minimizer="gicp", knn=3),
                icp.ICPConfig(outlier_chain=(("robust", "cauchy", 1.0, "mad", "point2point",
                                              float("inf")),), bound_max_rot=0.2),
                icp.ICPConfig(max_dist_field="maxSearchDist"),
                icp.ICPConfig(outlier_chain=(("generic_desc", False, True, 0.5),))):
        icp.check_supported(cfg)
    with pytest.raises(ValueError):
        icp.check_supported(icp.ICPConfig(matcher="kdtree"))
    assert scan_processing.resolve_normal_engine("knn") == "knn"  # ported with the SLAM runtime
    p = load_parameters({"mapper": {"map_builder": {"is_carving_enabled": True}}})
    assert SubmapCollection(p.mapper, device="cpu").params.map_builder.is_carving_enabled
