"""Scan-to-scan LiDAR odometry (optional front end).

Counterpart of the JAX package's ``models/odometry.py`` (reference
Odometry.cpp:17-136): preprocess = crop -> voxelize -> normals (:22-27),
register against the previous scan (:45-55), jump rejection > 0.8 m
(:58-63), fitness gate > 0.1 (:66), cumulative pose integration (:83-92);
bypassed when an external odometry source feeds the pose buffer (:40-43).

The registration type selects the minimizer as in the JAX package
(``odometry.py:35-45``): the package default ``GeneralizedIcp`` runs GICP,
``PointToPointIcp`` and ``PointToPlaneIcp`` the other two.  The matcher
resolves through ``mapper.resolve_matcher("auto")``: kernel K1 on CUDA
tensors, its plain twin on the CPU.  The JAX package builds the hashed grid
of the previous scan (``odometry.py:74``, ``:93``) but matches it by brute
force, which reads only the grid's points and normals (in the grid's
bucket order); the port hands the previous scan over as a passthrough grid
in its own Morton order instead, with K1's reference prepared once.  The
same points, another order: only exact distance ties could pick another
neighbour.  The pose and fitness of each registration are read
back through one pinned copy and its event: odometry integrates on the host
and cannot run ahead of its own result.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops import cuda_nn, hashgrid
from ..ops.registration import icp as icp_mod
from ..ops.registration.icp import ICPConfig
from ..utils import timing
from ..utils.config import SlamParameters
from ..utils.device import HostCopy, resolve_device
from ..utils.pointcloud import PointCloud
from ..utils.timebuf import TransformInterpolationBuffer
from . import scan_processing
from .mapper import resolve_matcher

# Magic constants from the reference (magic.hpp / Odometry.cpp:58-66).
ODOMETRY_JUMP_THRESHOLD_M = 0.8
ODOMETRY_MIN_FITNESS = 0.1


class LidarOdometry:
    def __init__(self, params: SlamParameters, device=None):
        self.device = resolve_device(device)
        self.params = params
        op = params.odometry
        minimizer = {
            "PointToPlaneIcp": "point_to_plane",
            "PointToPointIcp": "point_to_point",
            "GeneralizedIcp": "gicp",
        }[op.scan_matching.cloud_registration_type]
        self.icp_cfg = ICPConfig(
            max_iterations=op.scan_matching.icp.max_n_iter,
            max_correspondence_dist=op.scan_matching.icp.max_correspondence_dist,
            minimizer=minimizer,
            use_normal_gate=(minimizer == "point_to_plane"),
            matcher=resolve_matcher("auto"),
        )
        self.prev_cloud: Optional[PointCloud] = None
        self.prev_grid = None
        self._prev_ref = None
        self.odom_to_range_sensor = np.eye(4, dtype=np.float32)
        self.buffer = TransformInterpolationBuffer()
        self.rejected_jumps = 0
        self.low_fitness = 0

    def set_initial_transform(self, T: np.ndarray) -> None:
        self.odom_to_range_sensor = np.asarray(T, dtype=np.float32).copy()

    def _preprocess(self, raw: PointCloud) -> PointCloud:
        sp = self.params.odometry.scan_processing
        crop = sp.scan_cropping
        return scan_processing.preprocess_scan(
            raw, wide_min_radius=crop.cropping_radius_min,
            wide_max_radius=crop.cropping_radius_max, voxel_size=sp.voxel_size,
            downsampling_ratio=1.0, capacity=sp.point_capacity, estimate_scan_normals=True)

    def _set_reference(self, cloud: PointCloud) -> None:
        self.prev_cloud = cloud
        self.prev_grid = hashgrid.passthrough(cloud, self.icp_cfg.max_correspondence_dist)
        self._prev_ref = icp_mod.prepare_reference(self.icp_cfg, self.prev_grid)

    @timing.traced("odometry")
    def add_range_scan(self, raw_scan: PointCloud, time: float) -> bool:
        """≙ LidarOdometry::addRangeScan (Odometry.cpp:29-95)."""
        cloud = self._preprocess(raw_scan.to(self.device))
        if self.prev_cloud is None:
            self._set_reference(cloud)
            self.buffer.push(time, self.odom_to_range_sensor)
            return True
        with timing.span("odometry/register", launches=cuda_nn.launch_count):
            res = icp_mod.register(cloud, self.prev_grid,
                                   torch.eye(4, dtype=torch.float32, device=self.device),
                                   self.icp_cfg, self._prev_ref,
                                   # Read back below, so the loop may poll and stop.
                                   poll_every=icp_mod.POLL_EVERY)
        self._set_reference(cloud)
        back = [res.transform, res.match_ratio]
        if timing.active():
            back.append(res.iterations)  # the trips that moved the pose
        with timing.span("odometry/readback_wait"):
            vals = HostCopy(back).wait()
        dT, fitness = vals[:2]
        if len(vals) > 2:
            timing.count("odometry/icp_trips_active", int(vals[2]))
        dT = np.array(dT, np.float32)
        ok = True
        if np.linalg.norm(dT[:3, 3]) > ODOMETRY_JUMP_THRESHOLD_M:
            self.rejected_jumps += 1
            dT = np.eye(4, dtype=np.float32)
            ok = False
        if float(fitness) < ODOMETRY_MIN_FITNESS:
            self.low_fitness += 1
            dT = np.eye(4, dtype=np.float32)
            ok = False
        # dT maps the current scan into the previous-scan frame = sensor motion.
        self.odom_to_range_sensor = (self.odom_to_range_sensor @ dT).astype(np.float32)
        self.buffer.push(time, self.odom_to_range_sensor)
        return ok
