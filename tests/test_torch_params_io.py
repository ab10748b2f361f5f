"""The parameter loaders, cloud file formats, native host decoder and KITTI
reader of the PyTorch port against the JAX package (CPU).

The port keeps its own copies of ``lua_config``, ``yaml_config``,
``frames`` and ``native``: the same files go through both packages and must
give the same parameters, warnings and exceptions, the same arrays and the
same scans.
"""
import textwrap
import threading

import numpy as np
import pytest
import torch
from test_yaml_config import LEGACY

from open3d_slam_advanced_rss_2024_public_tpu import native as jnative
from open3d_slam_advanced_rss_2024_public_tpu.frontends import kitti as jkitti
from open3d_slam_advanced_rss_2024_public_tpu.utils import config as jconfig
from open3d_slam_advanced_rss_2024_public_tpu.utils import frames as jframes
from open3d_slam_advanced_rss_2024_public_tpu.utils import io as jio
from open3d_slam_advanced_rss_2024_public_tpu.utils import lua_config as jlua
from open3d_slam_advanced_rss_2024_public_tpu.utils import yaml_config as jyaml
from open3d_slam_advanced_rss_2024_public_tpu.utils.pointcloud import make_cloud as jmake
from open3d_slam_advanced_rss_2024_public_tpu_torch import native
from open3d_slam_advanced_rss_2024_public_tpu_torch.frontends import kitti
from open3d_slam_advanced_rss_2024_public_tpu_torch.utils import config, frames
from open3d_slam_advanced_rss_2024_public_tpu_torch.utils import io as tio
from open3d_slam_advanced_rss_2024_public_tpu_torch.utils import lua_config, yaml_config
from open3d_slam_advanced_rss_2024_public_tpu_torch.utils import pointcloud as pc

# -- Lua and legacy YAML parameters -----------------------------------------

_BASE = """
    function deepcopy(orig, copies)
        copies = copies or {}
        if type(orig) == 'table' then
            for k, v in next, orig, nil do end
        end
        return copy
    end
    DEFAULT_PARAMETERS = { odometry = { scan_matching = { icp = { max_n_iter = 30 } } },
                           map_builder = { map_voxel_size = 0.2 }, submap = {},
                           map_initializer = { init_pose = { x = 0.0 } } }
"""

# name -> (files, the file to load, loader, search dirs) where "*" marks
# files that go into the include directory.
_LUA_CASES = {
    "literals": ({"a.lua": """
        T = { num = 1.5, int = 7, neg = -50.0, flag = true, -- a comment
              off = false, name = "hello world", nested = { x = 1, y = { z = 2 } } }
        return T
        """}, "a.lua", "evaluate", False),
    "include_dotted": ({"base.lua": _BASE, "top.lua": """
        include "base.lua"
        params = deepcopy(DEFAULT_PARAMETERS)
        params.odometry.scan_matching.icp.max_n_iter = 12
        params.map_builder.is_carving_enabled = true
        params.map_initializer.init_pose.yaw = 90.0
        return params
        """}, "top.lua", "load", False),
    "search_dir": ({"*shared.lua": _BASE, "uses.lua": """
        include "shared.lua"
        params = deepcopy(DEFAULT_PARAMETERS)
        params.submap.submap_size = 9.0
        return params
        """}, "uses.lua", "load", True),
    "unused_keys_warn": ({"defaults.lua": "DEFAULT_PARAMETERS = { odometry = {} }\n",
                          "cfg.lua": """
        include "defaults.lua"
        params = deepcopy(DEFAULT_PARAMETERS)
        params.odometry.is_publish_odometry_msgs = true
        params.bogus_block = 1
        return params
        """}, "cfg.lua", "load", False),
    "strict_raises": ({"defaults.lua": "DEFAULT_PARAMETERS = { odometry = {} }\n",
                       "cfg.lua": """
        include "defaults.lua"
        params = deepcopy(DEFAULT_PARAMETERS)
        params.bogus_block = 1
        return params
        """}, "cfg.lua", "strict", False),
    "missing_include": ({"bad.lua": 'include "nope.lua"\nreturn {}'}, "bad.lua", "evaluate",
                        False),
    "undefined_variable": ({"bad.lua": "x = NOT_DEFINED\nreturn {}"}, "bad.lua", "evaluate",
                           False),
    "unknown_nested_key": ({"cfg.lua": """
        params = { odometry = { not_a_real_key = 1 } }
        return params
        """}, "cfg.lua", "load", False),
}


def _run_lua(mod, cfg_mod, path, how, search_dirs):
    """(kind, value): the result or the exception's type."""
    try:
        if how == "evaluate":
            return "ok", mod.evaluate_lua_file(path, search_dirs=search_dirs)
        params, warnings = mod.load_lua_parameters(path, search_dirs=search_dirs,
                                                   strict=how == "strict")
        return "ok", (cfg_mod.to_dict(params), warnings)
    except Exception as e:  # the type is what is compared
        return "raised", type(e).__name__


@pytest.mark.parametrize("case", sorted(_LUA_CASES))
def test_lua_loader_matches_jax(tmp_path, case):
    files, top, how, with_dir = _LUA_CASES[case]
    inc = tmp_path / "inc"
    inc.mkdir()
    for name, text in files.items():
        target = inc / name[1:] if name.startswith("*") else tmp_path / name
        target.write_text(textwrap.dedent(text))
    dirs = [str(inc)] if with_dir else []
    a = _run_lua(jlua, jconfig, str(tmp_path / top), how, dirs)
    b = _run_lua(lua_config, config, str(tmp_path / top), how, dirs)
    assert b == a
    if case == "include_dotted":
        d, warnings = b[1]
        assert warnings == []
        assert d["odometry"]["scan_matching"]["icp"]["max_n_iter"] == 12
        assert d["mapper"]["map_builder"]["is_carving_enabled"] is True
        assert d["mapper"]["map_initializer"]["init_pose"]["yaw"] == 90.0
    if case == "unused_keys_warn":
        assert any("bogus_block" in w for w in b[1][1])
    if case in ("missing_include", "undefined_variable", "strict_raises",
                "unknown_nested_key"):
        assert b[0] == "raised"


def test_legacy_yaml_matches_jax(tmp_path):
    f = tmp_path / "legacy.yaml"
    f.write_text(LEGACY)
    assert (config.to_dict(yaml_config.load_legacy_yaml(str(f)))
            == jconfig.to_dict(jyaml.load_legacy_yaml(str(f))))
    for doc in ({"mapping": {"no_such_thing": 1}}, {"mystery_section": {}}):
        with pytest.raises(ValueError, match="unknown legacy YAML keys"):
            yaml_config.overrides_from_legacy_yaml(doc)
    ov = {"mapping": {"submaps": {"size": 9.0}}}
    assert (yaml_config.overrides_from_legacy_yaml(ov)
            == jyaml.overrides_from_legacy_yaml(ov))


def test_frames_registry_matches_jax():
    rng = np.random.default_rng(2)
    edges = []
    for parent, child in (("base", "lidar"), ("base", "imu"), ("odom", "base")):
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0] * np.sign(
            np.linalg.det(np.linalg.qr(rng.normal(size=(3, 3)))[0]))
        T[:3, 3] = rng.normal(size=3)
        edges.append((parent, child, T))
    bufs = [jframes.StaticTransformBuffer(), frames.StaticTransformBuffer()]
    for b in bufs:
        for e in edges:
            b.set_transform(*e)
    for target, source in (("lidar", "imu"), ("odom", "lidar"), ("imu", "odom"),
                           ("lidar", "lidar"), ("lidar", "camera")):
        a, b = (buf.lookup(target, source) for buf in bufs)
        assert (a is None) == (b is None) == (source == "camera")
        if a is not None:
            np.testing.assert_array_equal(b, a)
        assert bufs[1].can_transform(target, source) == (a is not None)


# -- cloud files --------------------------------------------------------------

@pytest.fixture(scope="module")
def arrays():
    rng = np.random.default_rng(12)
    xyz = rng.normal(scale=5.0, size=(700, 3)).astype(np.float32)
    nrm = rng.normal(size=(700, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return xyz, nrm


def _jcloud(xyz, nrm):
    return jmake(xyz, normals=nrm)


def _tcloud(xyz, nrm):
    return pc.make_cloud(torch.from_numpy(xyz), normals=torch.from_numpy(nrm), device="cpu")


def _jread(path):
    c = jio.load_cloud(path)
    m = np.asarray(c.mask)
    return np.asarray(c.xyz)[m], np.asarray(c.normals)[m]


def _tread(path):
    c = tio.load_cloud(path, device="cpu")
    m = c.mask.numpy()
    return c.xyz.numpy()[m], c.normals.numpy()[m]


@pytest.mark.parametrize("ext,binary", [(".pcd", True), (".pcd", False), (".ply", True),
                                        (".ply", False), (".vtk", True)])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cloud_files_cross_read(tmp_path, arrays, ext, binary, writer):
    xyz, nrm = arrays
    path = str(tmp_path / f"cloud{ext}")
    if writer == "jax":
        jio.save_cloud(path, _jcloud(xyz, nrm), binary=binary)
    else:
        tio.save_cloud(path, _tcloud(xyz, nrm), binary=binary)
    (jx, jn), (tx, tn) = _jread(path), _tread(path)
    np.testing.assert_array_equal(tx, jx)
    np.testing.assert_array_equal(tn, jn)
    np.testing.assert_allclose(tx, xyz, atol=1e-5)


@pytest.mark.parametrize("header", [None, "x,y,z,nx,ny,nz", "nz,x,y,z,nx,ny"])
def test_csv_clouds_match_jax(tmp_path, arrays, header):
    xyz, nrm = arrays
    data = np.hstack([xyz, nrm])
    if header == "nz,x,y,z,nx,ny":
        data = data[:, [5, 0, 1, 2, 3, 4]]
    path = tmp_path / "cloud.csv"
    np.savetxt(path, data, delimiter=",", fmt="%.6f", header=header or "", comments="")
    (jx, jn), (tx, tn) = _jread(str(path)), _tread(str(path))
    np.testing.assert_array_equal(tx, jx)
    np.testing.assert_array_equal(tn, jn)
    np.testing.assert_allclose(tn, nrm, atol=1e-5)


def test_ply_colors_cross_read(tmp_path, arrays):
    xyz, nrm = arrays
    colors = (np.arange(len(xyz) * 3) % 256).astype(np.uint8).reshape(-1, 3)
    path = str(tmp_path / "rgb.ply")
    jio.save_ply(path, _jcloud(xyz, nrm), colors=colors)
    c = tio.load_ply(path, device="cpu")
    np.testing.assert_allclose(c.attrs.numpy()[:len(xyz)], colors / 255.0, atol=1e-7)
    assert c.attr_names == ("r", "g", "b")
    tio.save_ply(path, c)
    j = jio.load_ply(path)
    np.testing.assert_allclose(np.asarray(j.attr("g")), colors[:, 1] / 255.0, atol=1e-7)


def test_unknown_cloud_formats_raise_as_in_jax(tmp_path, arrays):
    for mod_load in (jio.load_cloud, lambda p: tio.load_cloud(p, device="cpu")):
        with pytest.raises(ValueError):
            mod_load(str(tmp_path / "cloud.las"))
    with pytest.raises(ValueError):
        tio.save_cloud(str(tmp_path / "cloud.las"), _tcloud(*arrays))


# -- the native decoder and ring buffer ----------------------------------------

def test_native_library_builds_outside_the_package():
    assert native.get_lib() is not None and native.backend() == "native"
    assert native.BUILD_DIR.name == "native" and native.BUILD_DIR.parent.name == "build"


@pytest.mark.parametrize("backend", ["native", "numpy"])
def test_native_decode_matches_jax(tmp_path, monkeypatch, backend):
    if backend == "numpy":
        monkeypatch.setattr(native, "get_lib", lambda: None)
        assert native.backend() == "numpy"
    data = np.random.RandomState(0).randn(1000, 4).astype(np.float32)
    path = str(tmp_path / "scan.bin")
    data.tofile(path)
    np.testing.assert_array_equal(native.decode_f32_file(path), jnative.decode_f32_file(path))
    np.testing.assert_array_equal(native.decode_f32_file(path, max_floats=40),
                                  data.reshape(-1)[:40])


@pytest.mark.parametrize("backend", ["native", "numpy"])
def test_native_ring_buffer_behaves_as_in_jax(monkeypatch, backend):
    if backend == "numpy":
        monkeypatch.setattr(native, "get_lib", lambda: None)
    rb = native.NativeRingBuffer(n_slots=3, slot_floats=16)
    assert rb.pop() is None
    assert rb.push(np.arange(8, dtype=np.float32), 1.5)
    assert rb.push(np.arange(4, dtype=np.float32) + 100, 2.5)
    assert len(rb) == 2
    payload, stamp = rb.pop()
    np.testing.assert_array_equal(payload, np.arange(8, dtype=np.float32))
    assert stamp == 1.5
    payload, stamp = rb.pop()
    assert stamp == 2.5 and payload.size == 4
    full = native.NativeRingBuffer(n_slots=2, slot_floats=8)
    assert full.push(np.zeros(4, np.float32), 0.0) and full.push(np.zeros(4, np.float32), 1.0)
    assert not full.push(np.zeros(4, np.float32), 2.0)  # full -> dropped
    # One producer, one consumer thread: every item, in order.
    rb = native.NativeRingBuffer(n_slots=8, slot_floats=64)
    received = []

    def consumer():
        while len(received) < 100:
            item = rb.pop()
            if item is not None:
                received.append(item[1])

    t = threading.Thread(target=consumer)
    t.start()
    i = 0
    while i < 100:
        if rb.push(np.full(32, i, np.float32), float(i)):
            i += 1
    t.join(timeout=10)
    assert received == [float(i) for i in range(100)]


# -- the KITTI reader ----------------------------------------------------------

_TR = ("Tr: 4.276802e-04 -9.999672e-01 -8.084491e-03 -1.198459e-02 "
       "-7.210626e-03 8.081198e-03 -9.999413e-01 -5.403984e-02 "
       "9.999738e-01 4.859485e-04 -7.206933e-03 -2.921968e-01\n")


def write_kitti(root, n_scans=3, n_points=500, seed=0):
    """A KITTI odometry layout: velodyne scans, calib.txt, camera-frame poses."""
    rng = np.random.default_rng(seed)
    velo = root / "sequences" / "00" / "velodyne"
    velo.mkdir(parents=True)
    for i in range(n_scans):
        rng.normal(scale=8.0, size=(n_points, 4)).astype(np.float32).tofile(velo / f"{i:06d}.bin")
    (root / "sequences" / "00" / "calib.txt").write_text("P0: " + " ".join(["0"] * 12) + "\n"
                                                         + _TR)
    (root / "poses").mkdir()
    rows = []
    for i in range(n_scans):
        T = np.eye(4)
        T[:3, 3] = [0.1 * i, 0.0, 1.0 * i]
        rows.append(" ".join(f"{v:.6e}" for v in T[:3, :4].reshape(-1)))
    (root / "poses" / "00.txt").write_text("\n".join(rows) + "\n")
    return root


def test_kitti_reader_matches_jax(tmp_path):
    root = write_kitti(tmp_path)
    calib = str(root / "sequences" / "00" / "calib.txt")
    np.testing.assert_array_equal(kitti.read_calib(calib), jkitti.read_calib(calib))
    Tr = kitti.read_calib(calib)
    np.testing.assert_array_equal(kitti.read_poses(str(root / "poses" / "00.txt"), Tr),
                                  jkitti.read_poses(str(root / "poses" / "00.txt"), Tr))
    np.testing.assert_array_equal(kitti.kitti_ground_truth(str(root)),
                                  jkitti.kitti_ground_truth(str(root)))
    for use_gt in (False, True):
        a = list(jkitti.kitti_sequence(str(root), capacity=600, use_gt_as_odometry=use_gt))
        b = list(kitti.kitti_sequence(str(root), capacity=600, use_gt_as_odometry=use_gt,
                                      device="cpu"))
        assert len(a) == len(b) == 3
        for fa, fb in zip(a, b):
            assert fa.time == fb.time
            np.testing.assert_array_equal(fb.scan.xyz.numpy(), np.asarray(fa.scan.xyz))
            np.testing.assert_array_equal(fb.scan.mask.numpy(), np.asarray(fa.scan.mask))
            assert (fa.odom_pose is None) == (fb.odom_pose is None) == (not use_gt)
            if use_gt:
                np.testing.assert_array_equal(fb.odom_pose, fa.odom_pose)
    assert len(list(kitti.kitti_sequence(str(root), max_frames=2, device="cpu"))) == 2
    assert kitti.kitti_ground_truth(str(tmp_path / "nowhere")) is None
