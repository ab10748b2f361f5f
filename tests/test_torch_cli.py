"""The port's command-line entry point on the CPU (``--device cpu``), at a
small size: a 6-scan PCD directory without odometry, so that the
scan-to-scan GICP odometry of the package defaults runs, and a 6-scan
directory in KITTI's layout with ground truth for ``--eval-ate``.  Each run
writes the TUM poses, ``map.pcd`` and ``pose_graph.json``; a saved map then
starts a localization run through ``--initial-map``.
"""
import json
import os

import numpy as np
import pytest
import torch

from open3d_slam_advanced_rss_2024_public_tpu_torch.frontends import cli, synthetic
from open3d_slam_advanced_rss_2024_public_tpu_torch.models.map_initializer import (
    SlamMapInitializer)
from open3d_slam_advanced_rss_2024_public_tpu_torch.models.slam import SlamWrapper
from open3d_slam_advanced_rss_2024_public_tpu_torch.utils import io
from open3d_slam_advanced_rss_2024_public_tpu_torch.utils.config import load_parameters

N = 2048
SCANS = 6
# KITTI's velodyne -> camera-0 calibration of sequence 00.
TR = np.array([[4.276802e-04, -9.999672e-01, -8.084491e-03, -1.198459e-02],
               [-7.210626e-03, 8.081198e-03, -9.999413e-01, -5.403984e-02],
               [9.999738e-01, 4.859485e-04, -7.206933e-03, -2.921968e-01],
               [0.0, 0.0, 0.0, 1.0]])

# Small capacities and a short scan-to-map ICP for the CPU; the
# registration types stay the package defaults (GICP odometry,
# point-to-plane scan-to-map).
SMALL = {
    "odometry": {"scan_processing": {"voxel_size": 0.15, "point_capacity": N}},
    "mapper": {
        "mapper_localizer": {
            "is_print_timing_information": False,
            "scan_to_map_registration": {
                "icp": {"max_n_iter": 10},
                "scan_processing": {"voxel_size": 0.15, "point_capacity": N},
                "map_patch_capacity": 4096}},
        "submaps": {"point_capacity": 4096, "submap_size": 8.0, "min_num_range_data": 3},
        "map_builder": {"map_voxel_size": 0.12},
        "place_recognition": {"feature_point_capacity": 1024, "overlap_point_capacity": 2048,
                              "ransac_batch_size": 512}}}


@pytest.fixture(scope="module")
def sequence():
    world = synthetic.cluttered_world(11, extent=30.0, n_objects=45, device="cpu")
    gt = synthetic.straight_trajectory(SCANS, step=0.3, yaw_rate=0.02, start=(8.0, 0.0, 1.0))
    g = torch.Generator().manual_seed(2)
    scans = [synthetic.render_scan(world, T, g, n_points=N, max_range=16.0, noise=0.003)
             for T in gt]
    return gt, [s.xyz[s.mask].numpy() for s in scans]


@pytest.fixture(scope="module")
def params_file(tmp_path_factory):
    p = tmp_path_factory.mktemp("params") / "small.json"
    p.write_text(json.dumps(SMALL))
    return str(p)


def _artifacts(out):
    poses = np.loadtxt(os.path.join(out, "slam_poses"), ndmin=2)
    graph = json.load(open(os.path.join(out, "pose_graph.json")))
    cloud = io.load_pcd(os.path.join(out, "map.pcd"), device="cpu")
    return poses, graph, cloud


def test_cli_on_a_pcd_directory_runs_the_gicp_odometry(tmp_path, sequence, params_file,
                                                       monkeypatch):
    gt, scans = sequence
    d = tmp_path / "scans"
    for i, xyz in enumerate(scans):
        io.save_pcd(str(d / f"{i:04d}.pcd"), io.make_cloud(xyz, device="cpu"))
    seen = {}
    real_init = SlamWrapper.__init__

    def spy(self, *a, **k):
        real_init(self, *a, **k)
        seen["slam"] = self

    monkeypatch.setattr(SlamWrapper, "__init__", spy)
    out = str(tmp_path / "out")
    assert cli.main(["--dataset", "pcd-dir", "--pcd-dir", str(d), "--params", params_file,
                     "--output", out, "--device", "cpu"]) == 0
    slam = seen["slam"]
    odo = slam.odometry
    assert odo.icp_cfg.minimizer == "gicp"
    assert odo.rejected_jumps == odo.low_fitness == 0
    poses, graph, cloud = _artifacts(out)
    assert poses.shape == (SCANS, 8)
    assert isinstance(graph, dict) and int(cloud.mask.sum()) > 1000
    # The scan-to-scan odometry followed the true motion.
    rel = np.linalg.inv(gt[0]) @ gt[-1]
    assert np.linalg.norm(poses[-1, 1:4] - rel[:3, 3]) < 0.05


def write_kitti(root, gt, scans):
    velo = root / "sequences" / "00" / "velodyne"
    velo.mkdir(parents=True)
    for i, xyz in enumerate(scans):
        rec = np.zeros((len(xyz), 4), np.float32)
        rec[:, :3] = xyz
        rec.tofile(velo / f"{i:06d}.bin")
    (root / "sequences" / "00" / "calib.txt").write_text(
        "Tr: " + " ".join(f"{v:.6e}" for v in TR[:3].reshape(-1)) + "\n")
    (root / "poses").mkdir()
    cam = [T.astype(np.float64) @ np.linalg.inv(TR) for T in gt]
    (root / "poses" / "00.txt").write_text(
        "\n".join(" ".join(f"{v:.9e}" for v in T[:3].reshape(-1)) for T in cam) + "\n")
    return root


def test_cli_on_a_kitti_directory_reports_the_ate(tmp_path, sequence, params_file, capsys):
    gt, scans = sequence
    root = write_kitti(tmp_path / "kitti", gt, scans)
    out = str(tmp_path / "out")
    assert cli.main(["--dataset", "kitti", "--kitti-root", str(root), "--params", params_file,
                     "--output", out, "--eval-ate", "--device", "cpu"]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    result = json.loads(last)
    assert result["frames"] == SCANS and result["ate_rmse_m"] < 0.03
    poses, graph, cloud = _artifacts(out)
    assert poses.shape == (SCANS, 8) and int(cloud.mask.sum()) > 1000

    # Localization from the saved map: the map initializer loads it into
    # the first submap, and three more scans register against it.
    loc = str(tmp_path / "loc")
    root2 = write_kitti(tmp_path / "kitti2", gt[:3], scans[:3])
    assert cli.main(["--dataset", "kitti", "--kitti-root", str(root2), "--params", params_file,
                     "--initial-map", os.path.join(out, "map.pcd"), "--output", loc,
                     "--eval-ate", "--device", "cpu"]) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["frames"] == 3


def test_map_initializer_seeds_the_first_submap(tmp_path, sequence):
    gt, scans = sequence
    path = str(tmp_path / "map.pcd")
    world_pts = [xyz @ T[:3, :3].T + T[:3, 3] for xyz, T in zip(scans[:3], gt[:3])]
    io.save_pcd(path, io.make_cloud(np.concatenate(world_pts), device="cpu"))
    params = load_parameters(SMALL)
    slam = SlamWrapper(params, device="cpu")
    mi = params.mapper.map_initializer
    init = SlamMapInitializer(slam, mi)
    init.initialize(map_cloud=io.load_pcd(path, capacity=8192, device="cpu"))
    assert len(slam.mapper.submaps.submaps) == 1
    assert int(slam.mapper.submaps.active_submap.map.count()) > 500
    # A rough pose refined against the map by ICP.
    rough = gt[1].copy()
    rough[:3, 3] += [0.1, -0.05, 0.0]
    scan = io.make_cloud(scans[1], device="cpu")
    refined = init.align_first_scan(scan, rough)
    assert np.linalg.norm(refined[:3, 3] - gt[1][:3, 3]) < 0.05


def test_cli_refuses_what_is_not_ported(tmp_path, sequence, params_file):
    # Nothing of the command line is refused any more: a bag replays on
    # the CPU and writes the live visualization bundle.  Without CUDA the
    # default device still raises.
    from open3d_slam_advanced_rss_2024_public_tpu_torch.frontends import rosbag

    gt, scans = sequence
    bag = str(tmp_path / "run.bag")
    w = rosbag.RosbagWriter(bag)
    for i in range(3):
        t = 0.1 * (i + 1)
        w.write_odometry("/odom", gt[i], stamp=t - 0.01)
        w.write_pointcloud("/points", io.make_cloud(scans[i], device="cpu"), stamp=t)
        w.write_odometry("/odom", gt[i], stamp=t + 0.01)
    w.close()
    out, viz = tmp_path / "o", tmp_path / "viz"
    assert cli.main(["--dataset", "rosbag", "--bag", bag, "--cloud-topic", "/points",
                     "--odometry-topic", "/odom", "--params", params_file,
                     "--output", str(out), "--viz-dir", str(viz), "--viz-every", "1",
                     "--device", "cpu"]) == 0
    poses, _, cloud = _artifacts(str(out))
    assert poses.shape[0] == 3 and int(cloud.mask.sum()) > 500
    assert np.abs(poses[:, 1:4] - np.stack([T[:3, 3] for T in gt[:3]])).max() < 0.05
    for name in ("submaps_colored.ply", "trajectory_tube.pcd", "submap_origins.ply"):
        assert (viz / name).stat().st_size > 0, name
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(["--dataset", "synthetic", "--steps", "1",
                      "--output", str(tmp_path / "o")])


def test_cli_refuses_an_initial_map_beyond_its_bound(tmp_path, monkeypatch):
    # As the JAX CLI, which pads the prior map to 262144 lanes: a larger
    # map raises with a message instead of an unbounded kNN-normal pass.
    assert cli.MAX_INITIAL_MAP_POINTS == 262144
    monkeypatch.setattr(cli, "MAX_INITIAL_MAP_POINTS", 1000)
    path = str(tmp_path / "big.pcd")
    rng = np.random.default_rng(3)
    io.save_pcd(path, io.make_cloud(rng.uniform(-5.0, 5.0, (1001, 3)).astype(np.float32),
                                    device="cpu"))
    with pytest.raises(ValueError, match="1000 < points 1001"):
        cli.main(["--dataset", "synthetic", "--steps", "1", "--initial-map", path,
                  "--output", str(tmp_path / "o"), "--device", "cpu"])
