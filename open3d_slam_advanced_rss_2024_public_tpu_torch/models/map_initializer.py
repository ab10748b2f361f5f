"""Localization bootstrap: load a prior map and an initial pose.

Counterpart of the JAX package's ``models/map_initializer.py`` (reference
SlamMapInitializer.cpp:28-200): load a PCD map, install it as the initial
submap, set the initial map->sensor transform (from the parameters' POSE
block or an alignment the caller hands in), and optionally refine a rough
pose of the first scan against the map with ICP (the non-interactive
analogue of the RViz /initialpose flow).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops import filters
from ..ops.registration.icp import ICPConfig, register_clouds
from ..utils import io as io_utils
from ..utils import se3
from ..utils.config import MapInitializerParameters
from ..utils.device import HostCopy, to_device
from ..utils.pointcloud import PointCloud
from .mapper import resolve_matcher
from .slam import SlamWrapper


def pose_from_config(p) -> np.ndarray:
    """POSE block (x, y, z and roll, pitch, yaw in degrees, as the
    reference's Lua schema has them) -> 4x4."""
    rpy = torch.tensor(np.deg2rad([p.roll, p.pitch, p.yaw]), dtype=torch.float32)
    T = se3.make_transform(se3.rpy_to_matrix(rpy),
                           torch.tensor([p.x, p.y, p.z], dtype=torch.float32))
    return T.numpy().astype(np.float32)


class SlamMapInitializer:
    def __init__(self, slam: SlamWrapper, params: MapInitializerParameters):
        self.slam = slam
        self.params = params

    def initialize(self, map_cloud: Optional[PointCloud] = None,
                   init_pose: Optional[np.ndarray] = None,
                   map_capacity: int = 262144) -> None:
        """≙ SlamMapInitializer::initialize (SlamMapInitializer.cpp:50-80)."""
        if map_cloud is None:
            if not self.params.pcd_file_path:
                raise ValueError("map initializer needs a cloud or pcd_file_path")
            map_cloud = io_utils.load_pcd(self.params.pcd_file_path, capacity=map_capacity,
                                          device=self.slam.device)
        if init_pose is None:
            init_pose = pose_from_config(self.params.init_pose)
        self.slam.set_initial_transform(init_pose)
        self.slam.set_initial_map(map_cloud)

    def align_first_scan(self, scan: PointCloud, rough_pose: np.ndarray,
                         max_correspondence_dist: float = 1.0) -> np.ndarray:
        """Refine a rough pose of ``scan`` against the prior map with ICP
        (the programmatic analogue of the interactive-marker alignment)."""
        dev = self.slam.device
        map_cloud = self.slam.mapper.submaps.active_submap.map.cloud
        cfg = ICPConfig(max_iterations=40, max_correspondence_dist=max_correspondence_dist,
                        matcher=resolve_matcher("auto"))
        scan_ds = filters.voxel_downsample(scan.to(dev), 0.15, capacity=8192, order="lex")
        res = register_clouds(scan_ds, map_cloud, to_device(rough_pose, dev), cfg)
        refined = np.array(HostCopy([res.transform]).wait()[0], dtype=np.float32)
        self.slam.set_initial_transform(refined)
        return refined
