"""Runs of a tiny cell on the CPU past the look for a chip: the shape of the
result line, the check on a sound run, and the check with the timed path
broken underneath (a registration that returns its start, half of each
sweep left out, a pose altered where it is produced, a table that drops
voxels) and with the control
in the program's place.  The exchange between chips is no fault these
one-chip cells can have."""
import dataclasses
import json
import subprocess
import sys
import time

import pytest
import torch

from slam_bench import checking, harness
from slam_bench.tests import tiny_cell

SEED = 2 ** 31 + 12345  # past 32 signed bits: a run takes any whole number


def run(tmp_path, kind="rosbag", seconds=60.0, cell=None):
    return harness.run_cell(cell or tiny_cell.cell(kind), SEED, seconds, False, "cpu",
                            time.perf_counter(), data_root=str(tmp_path))


def test_the_result_line_has_the_contract_keys(tmp_path):
    r = run(tmp_path)
    assert list(r)[-1] == "check"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(r)
    assert set(r["metrics"]) == {"scans_per_s", "step_ms_p90", "setup_s"}
    assert all(set(v) == {"value", "unit"} for v in r["metrics"].values())
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(r["device"])
    assert all(set(v) == {"value", "limit"} for v in r["check"].values())
    json.dumps(r)
    assert r["correct"] is True, r["check"]


def test_the_kitti_layout_and_its_odometry_check(tmp_path):
    r = run(tmp_path, "kitti")
    assert "odom_gap_mm" in r["check"]
    assert r["correct"] is True, r["check"]


def test_a_registration_that_returns_its_start_is_not_correct(tmp_path, monkeypatch):
    from open3d_slam_advanced_rss_2024_public_tpu_torch.ops.registration import icp

    real = icp.register

    def frozen(source, grid, T0, *args, **kwargs):
        return dataclasses.replace(real(source, grid, T0, *args, **kwargs), transform=T0)

    monkeypatch.setattr(icp, "register", frozen)
    r = run(tmp_path)
    assert r["correct"] is False
    assert r["check"]["scan_gap_mm"]["value"] > r["check"]["scan_gap_mm"]["limit"]


def test_half_of_each_sweep_left_out_is_not_correct(tmp_path, monkeypatch):
    from open3d_slam_advanced_rss_2024_public_tpu_torch.frontends import rosbag

    real = rosbag.PointCloud2.to_pointcloud

    def half(self, *args, **kwargs):
        cloud = real(self, *args, **kwargs)
        keep = torch.arange(cloud.mask.shape[0]) % 2 == 0
        return cloud.with_mask(cloud.mask & keep.to(cloud.mask.device))

    monkeypatch.setattr(rosbag.PointCloud2, "to_pointcloud", half)
    r = run(tmp_path)
    assert r["correct"] is False
    assert r["check"]["decode_lanes_off"]["value"] > 0


def test_a_pose_altered_where_it_is_produced_is_not_correct(tmp_path, monkeypatch):
    from open3d_slam_advanced_rss_2024_public_tpu_torch.models import pipeline

    real = pipeline._gate

    def shifted(*args, **kwargs):
        T, ok = real(*args, **kwargs)
        T = T.clone()
        T[0, 3] += 0.1
        return T, ok

    monkeypatch.setattr(pipeline, "_gate", shifted)
    r = run(tmp_path)
    assert r["correct"] is False
    assert r["check"]["scan_gap_mm"]["value"] > r["check"]["scan_gap_mm"]["limit"]


def test_a_table_that_drops_voxels_is_not_correct(tmp_path):
    c = tiny_cell.cell()
    c.config["parameters"]["mapper"]["submaps"]["point_capacity"] = 1024
    r = run(tmp_path, cell=c)
    assert r["correct"] is False
    assert r["check"]["voxels_dropped"]["value"] > 0


def test_the_control_is_not_correct(tmp_path):
    c = tiny_cell.cell()
    m = harness.measure(c, SEED, 60.0, False, "cpu", time.perf_counter(), str(tmp_path))
    program = checking.judge(m.capture, m.seq, c.config, "cpu")
    control = checking.judge(m.capture, m.seq, c.config, "cpu", control=True)
    assert checking.verdict(program, c.config["limits"])[0]
    assert not checking.verdict(control, c.config["limits"])[0]
    assert control["scan_gap_mm"] >= 3 * program["scan_gap_mm"]


def test_without_a_card_the_command_fails_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    p = subprocess.run([sys.executable, str(tiny_cell.ROOT / "slam_bench" / "run.py"),
                        "--workload", "os1-32-loop", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
