"""KITTI odometry dataset adapter.

Counterpart of the JAX package's ``frontends/kitti.py``: streams velodyne
.bin scans (with ground-truth poses and calibration where present) as
ReplayFrames.  Layout (standard KITTI odometry):
  <root>/sequences/<seq>/velodyne/000000.bin ...
  <root>/sequences/<seq>/calib.txt            (Tr: velodyne -> camera)
  <root>/poses/<seq>.txt                      (camera-frame GT poses)
"""
from __future__ import annotations

import os
from typing import Iterator, Optional

import numpy as np

from .. import native
from ..utils import timing
from ..utils.pointcloud import PointCloud, make_cloud
from .replay import ReplayFrame


def read_velodyne_bin(path: str, capacity: Optional[int] = None, device="cuda") -> PointCloud:
    """KITTI velodyne scan: float32 x, y, z, reflectance records, decoded
    on the host (the native reader where it builds) and uploaded through
    pinned memory."""
    data = native.decode_f32_file(path).reshape(-1, 4)
    return make_cloud(data[:, :3], capacity=capacity, device=device)


def read_calib(path: str) -> np.ndarray:
    """Tr (velodyne -> camera0) as 4x4."""
    with open(path) as f:
        for line in f:
            if line.startswith("Tr"):
                T = np.eye(4)
                T[:3, :4] = np.array([float(v) for v in line.split()[1:]]).reshape(3, 4)
                return T
    return np.eye(4)


def read_poses(path: str, Tr: np.ndarray) -> np.ndarray:
    """GT poses (camera frame) in the velodyne frame: T_w_velo = T_w_cam @ Tr."""
    poses = []
    for r in np.loadtxt(path, ndmin=2):
        T = np.eye(4)
        T[:3, :4] = r.reshape(3, 4)
        poses.append((T @ Tr).astype(np.float32))
    return np.stack(poses)


def kitti_sequence(root: str, sequence: str = "00", capacity: int = 131072,
                   max_frames: Optional[int] = None, rate_hz: float = 10.0,
                   use_gt_as_odometry: bool = False, device="cuda") -> Iterator[ReplayFrame]:
    """The sequence's scans as ReplayFrames, each read in a ``frontend``
    span of the tracer."""
    yield from timing.iterate("frontend", _frames(root, sequence, capacity, max_frames,
                                                  rate_hz, use_gt_as_odometry, device))


def _frames(root, sequence, capacity, max_frames, rate_hz, use_gt_as_odometry, device):
    seq_dir = os.path.join(root, "sequences", sequence)
    velo_dir = os.path.join(seq_dir, "velodyne")
    files = sorted(f for f in os.listdir(velo_dir) if f.endswith(".bin"))
    if max_frames:
        files = files[:max_frames]
    poses = None
    pose_file = os.path.join(root, "poses", f"{sequence}.txt")
    if use_gt_as_odometry and os.path.isfile(pose_file):
        poses = read_poses(pose_file, read_calib(os.path.join(seq_dir, "calib.txt")))
    for i, f in enumerate(files):
        scan = read_velodyne_bin(os.path.join(velo_dir, f), capacity=capacity, device=device)
        pose = poses[i] if poses is not None and i < len(poses) else None
        yield ReplayFrame(time=i / rate_hz, scan=scan, odom_pose=pose)


def kitti_ground_truth(root: str, sequence: str = "00") -> Optional[np.ndarray]:
    pose_file = os.path.join(root, "poses", f"{sequence}.txt")
    if not os.path.isfile(pose_file):
        return None
    return read_poses(pose_file, read_calib(os.path.join(root, "sequences", sequence,
                                                         "calib.txt")))
