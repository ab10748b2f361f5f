"""Submaps: bounded map chunks with a lifecycle, and their adjacency graph.

Counterpart of ``Submap`` and ``AdjacencyMatrix`` of the JAX package's
``models/submap.py`` (reference Submap.cpp:27-288, AdjacencyMatrix.cpp):
the sparse voxel-mean map, the optional dense map, the feature cloud with
its FPFH descriptors (filled when the submap is finished), and the rigid
move that loop-closure feedback applies.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, Optional, Set

import numpy as np
import torch

from ..ops import voxel_map
from ..ops.voxel_map import VoxelMap
from ..utils.device import HostCopy, to_device
from ..utils.pointcloud import PointCloud


class AdjacencyMatrix:
    """Undirected submap graph (host-side; a handful of nodes)."""

    def __init__(self) -> None:
        self._adj: Dict[int, Set[int]] = {}

    def add_edge(self, a: int, b: int) -> None:
        self._adj.setdefault(a, set()).add(b)
        self._adj.setdefault(b, set()).add(a)

    def is_adjacent(self, a: int, b: int) -> bool:
        return b in self._adj.get(a, ())

    def bfs_distance(self, start: int, targets: Set[int]) -> int:
        """Graph distance from ``start`` to the nearest node in ``targets``
        (≙ AdjacencyMatrix.cpp:23-54); a large value when unreachable."""
        if start in targets:
            return 0
        seen = {start}
        frontier = deque([(start, 0)])
        while frontier:
            node, d = frontier.popleft()
            for nb in self._adj.get(node, ()):
                if nb in targets:
                    return d + 1
                if nb not in seen:
                    seen.add(nb)
                    frontier.append((nb, d + 1))
        return 1 << 30


@dataclasses.dataclass
class Submap:
    """One bounded map chunk.  Device data: ``map`` (its voxel table),
    ``dense_map``, and the feature cloud with descriptors."""

    submap_id: int
    parent_id: int
    creation_time: float
    map: VoxelMap
    dense_map: Optional[VoxelMap] = None
    # Pose of the submap frame in the map frame.
    pose: np.ndarray = dataclasses.field(default_factory=lambda: np.eye(4, dtype=np.float32))
    feature_cloud: Optional[PointCloud] = None
    features: Optional[torch.Tensor] = None  # [M, 33] FPFH
    n_scans: int = 0
    # Map-cloud centroid, computed ONCE when the submap is finished
    # (≙ computeSubmapCenter, Submap.cpp:282-286); while the submap is
    # active its "center" is the creation origin (Submap.cpp:203-205).
    _center: Optional[np.ndarray] = None
    # In-flight centroid readback (resolved lazily by center()).
    _center_copy: Optional[HostCopy] = None
    # True when transform() moved the accumulator content without re-keying
    # the table (the cheap path for closed submaps); ensure_keys() rebuilds
    # before any further insert (re-activation).
    keys_stale: bool = False

    def is_empty(self) -> bool:
        return self.n_scans == 0

    def center(self) -> np.ndarray:
        if self._center is None and self._center_copy is not None:
            if not self._center_copy.ready():
                # Still behind queued device work: use the creation origin
                # rather than block the host (proximity gating tolerates
                # one stale read; the centroid adopts on a later call).
                return self.pose[:3, 3].copy()
            self._center = self._center_copy.wait()[0].astype(np.float64)
            self._center_copy = None
        if self._center is not None:
            return self._center
        return self.pose[:3, 3].copy()

    def compute_center(self) -> None:
        """≙ Submap::computeSubmapCenter: the masked mean of the voxel
        means on the device (the creation origin for an empty map); the
        3-float readback is issued without waiting."""
        cloud = self.map.cloud
        n = cloud.mask.sum(dtype=torch.float32)
        c = torch.where(cloud.mask[:, None], cloud.xyz, 0.0).sum(0) / torch.clamp(n, min=1.0)
        fallback = to_device(self.pose[:3, 3], c.device)
        self._center = None
        self._center_copy = HostCopy([torch.where(n > 0, c, fallback)])

    def transform(self, T: np.ndarray) -> None:
        """Rigidly move every layer (≙ Submap::transform).  The tables move
        by content only, valid because pose-graph feedback targets closed
        submaps, which receive no inserts; ``ensure_keys`` re-keys lazily if
        this submap is active again.  Pose and center update in numpy."""
        Td = to_device(np.asarray(T, np.float32), self.map.device)
        self.map = voxel_map.transform_content(self.map, Td)
        if self.dense_map is not None:
            self.dense_map = voxel_map.transform_content(self.dense_map, Td)
        self.keys_stale = True
        if self.feature_cloud is not None:
            self.feature_cloud = self.feature_cloud.transform(Td)
        self._after_transform(np.asarray(T, dtype=np.float64))

    def ensure_keys(self) -> None:
        """Re-key the table(s) if a content-only transform left the stored
        voxel keys stale: required before this submap accepts inserts again
        (re-activation on revisit, chain rebuild)."""
        if not self.keys_stale:
            return
        self.map = voxel_map.rekey(self.map)
        if self.dense_map is not None:
            self.dense_map = voxel_map.rekey(self.dense_map)
        self.keys_stale = False

    def _after_transform(self, Tn: np.ndarray) -> None:
        if self._center_copy is not None:
            # Resolve a pending centroid BEFORE moving the frame (waiting
            # is fine on the rare loop-closure feedback path; adopting the
            # creation-origin fallback would freeze the wrong center).
            self._center = self._center_copy.wait()[0].astype(np.float64)
            self._center_copy = None
        self.pose = (Tn @ self.pose.astype(np.float64)).astype(np.float32)
        if self._center is not None:
            self._center = Tn[:3, :3] @ self._center + Tn[:3, 3]
