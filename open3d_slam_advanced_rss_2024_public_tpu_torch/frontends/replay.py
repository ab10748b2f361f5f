"""Deterministic offline replay — the benchmarking and regression path.

Counterpart of the JAX package's ``frontends/replay.py`` (reference
RosbagRangeDataProcessorRos.cpp:28-1162): iterate a recorded sequence, pair
each cloud with its odometry pose where there is one, drive the offline
single-step workers, and write the TUM pose log, the map and the pose
graph.  Sequences come from dataset adapters (KITTI, PCD directories,
synthetic worlds) with the same iterator protocol.
"""
from __future__ import annotations

import dataclasses
import os
import sys
from typing import Iterable, Iterator, Optional

import numpy as np
import torch

from ..models.slam import SlamWrapper
from ..utils import io as io_utils
from ..utils import pointcloud as pc
from ..utils.config import SlamParameters
from ..utils.pointcloud import PointCloud
from ..utils.timing import Timer


@dataclasses.dataclass
class ReplayFrame:
    time: float
    scan: PointCloud
    odom_pose: Optional[np.ndarray] = None  # external odometry (None = scan to scan)


def accumulate_range_data(frames: Iterable[ReplayFrame],
                          num_accumulated: int = 1) -> Iterator[ReplayFrame]:
    """Merge every ``num_accumulated`` consecutive scans into one frame
    stamped at the last scan's time, with the last frame's odometry pose
    (≙ DataProcessorRos scan accumulation, DataProcessorRos.cpp:21-56)."""
    if num_accumulated <= 1:
        yield from frames
        return
    buf: list = []

    def merged() -> ReplayFrame:
        cloud = buf[0].scan
        for f in buf[1:]:
            cloud = pc.concatenate(cloud, f.scan)
        return ReplayFrame(time=buf[-1].time, scan=cloud, odom_pose=buf[-1].odom_pose)

    for frame in frames:
        buf.append(frame)
        if len(buf) == num_accumulated:
            yield merged()
            buf = []
    if buf:
        yield merged()


class ReplayRunner:
    """``device`` as ``SlamWrapper`` takes it: ``cuda`` unless the caller
    asks for the CPU.  With ``viz_dir``, the live visualization bundle is
    published there every ``viz_every`` frames: the tables' copies are
    enqueued on this thread and rendered on the publisher's own."""

    def __init__(self, params: Optional[SlamParameters] = None,
                 output_dir: Optional[str] = None, print_progress: bool = True,
                 num_accumulated_range_data: int = 1, device=None,
                 viz_dir: Optional[str] = None, viz_every: int = 25):
        self.slam = SlamWrapper(params, device=device)
        self.output_dir = output_dir
        self.print_progress = print_progress
        self.num_accumulated_range_data = num_accumulated_range_data
        self.timer = Timer("scan")
        self.viz_every = max(int(viz_every), 1)
        self._viz = None
        if viz_dir:
            from .viz import LiveVisualizationPublisher

            self._viz = LiveVisualizationPublisher(viz_dir)

    def run(self, frames: Iterable[ReplayFrame],
            initial_pose: Optional[np.ndarray] = None) -> SlamWrapper:
        slam = self.slam
        if self.num_accumulated_range_data > 1:
            frames = accumulate_range_data(frames, self.num_accumulated_range_data)
        for i, frame in enumerate(frames):
            if i == 0:
                init = initial_pose if initial_pose is not None else (
                    frame.odom_pose if frame.odom_pose is not None
                    else np.eye(4, dtype=np.float32))
                slam.set_initial_transform(init)
            with self.timer:
                slam.use_pair_for_registration(frame.scan, frame.odom_pose, frame.time)
            if self._viz is not None and i % self.viz_every == 0:
                self._viz.tick(slam, wait=False)
            if self.print_progress and i % 25 == 0:
                p = slam.mapper.map_to_range_sensor[:3, 3]
                print(f"[replay] frame {i:5d} t={frame.time:8.2f} "
                      f"pos=({p[0]:7.2f},{p[1]:7.2f},{p[2]:6.2f}) "
                      f"avg {self.timer.avg_ms:.1f} ms/scan "
                      f"submaps={len(slam.mapper.submaps.submaps)} "
                      f"lc={slam.loop_closure_count}", file=sys.stderr)
        if self._viz is not None:
            self._viz.close()
        slam.finish_processing()
        if self.output_dir:
            os.makedirs(self.output_dir, exist_ok=True)
            slam.save_trajectory(os.path.join(self.output_dir, "slam_poses"))
            slam.save_map(os.path.join(self.output_dir, "map.pcd"))
            slam.save_pose_graph(os.path.join(self.output_dir, "pose_graph.json"))
        return slam


def synthetic_sequence(seed: int = 0, n_steps: int = 100, world_extent: float = 40.0,
                       trajectory: str = "loop", n_points: int = 8192,
                       odom_drift: float = 0.01, noise: float = 0.004,
                       device="cuda") -> Iterator[ReplayFrame]:
    """A deterministic synthetic sequence (the hermetic stand-in for the
    reference's sample rosbags): the world from ``seed``, the scans from a
    ``torch.Generator`` seeded with ``seed + 1`` on ``device``."""
    from . import synthetic

    world = synthetic.cluttered_world(seed, extent=world_extent,
                                      n_objects=int(world_extent * 1.5), device=device)
    if trajectory == "loop":
        gt = synthetic.loop_trajectory(n_steps, radius=world_extent / 3,
                                       center=(world_extent / 2, 0.0), z=1.2)
    else:
        gt = synthetic.straight_trajectory(n_steps, step=world_extent / (n_steps + 4))
    odom = synthetic.perturb_odometry(gt, drift_per_step=odom_drift, seed=0)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    for i in range(n_steps):
        scan = synthetic.render_scan(world, gt[i], gen, n_points=n_points, noise=noise)
        yield ReplayFrame(time=0.1 * i, scan=scan, odom_pose=odom[i])


def pcd_directory_sequence(directory: str, capacity: int = 32768,
                           trajectory_file: Optional[str] = None,
                           device="cuda") -> Iterator[ReplayFrame]:
    """Replay a directory of PCD scans (sorted by file name), with the poses
    of a TUM odometry file where one is given."""
    files = sorted(f for f in os.listdir(directory) if f.endswith(".pcd"))
    poses = times = None
    if trajectory_file:
        times, poses = io_utils.load_tum_trajectory(trajectory_file)
    for i, f in enumerate(files):
        cloud = io_utils.load_pcd(os.path.join(directory, f), capacity=capacity, device=device)
        t = float(times[i]) if times is not None and i < len(times) else 0.1 * i
        pose = poses[i] if poses is not None and i < len(poses) else None
        yield ReplayFrame(time=t, scan=cloud, odom_pose=pose)
