"""Submap lifecycle management (host control / device data).

Counterpart of the lifecycle of the JAX package's
``models/submap_collection.py`` (``:141-252``; reference
SubmapCollection.cpp:28-409): active-submap selection, new submap on travel
distance or point budget, the scan-overlap buffer replayed into fresh
submaps, the dense map, the finished-submap queue for feature computation,
the loop-closure candidate queue, and optimized pose-graph transforms
applied with parent-chain propagation, and periodic space carving of the
active submap.
"""
from __future__ import annotations

from collections import deque
from typing import Deque, List, Optional, Tuple

import numpy as np

from ..ops import filters, fpfh, voxel_map
from ..ops import normals as normals_ops
from ..utils.config import MapperParameters
from ..utils.device import to_device
from ..utils.pointcloud import PointCloud
from .submap import AdjacencyMatrix, Submap


def _resolve(cloud_or_thunk) -> PointCloud:
    """Merge clouds arrive directly or as zero-arg thunks (the Mapper
    slices stacked block outputs only when a consumer needs them)."""
    return cloud_or_thunk() if callable(cloud_or_thunk) else cloud_or_thunk


class SubmapCollection:
    def __init__(self, params: MapperParameters, device="cuda"):
        self.params = params
        self.device = device
        self.submaps: List[Submap] = []
        self.active_idx: int = 0
        self.adjacency = AdjacencyMatrix()
        self.num_scans_merged_in_active: int = 0
        self.finished_queue: Deque[Tuple[int, float]] = deque()
        self.lc_candidate_queue: Deque[Tuple[int, float]] = deque()
        self.loop_closure_submaps: set = set()
        self.overlap_buffer: Deque[Tuple[PointCloud, np.ndarray, float]] = deque(
            maxlen=max(params.submaps.submaps_num_scan_overlap, 1))
        self._force_new = False
        self.is_localization_mode = False

    @property
    def active_submap(self) -> Submap:
        return self.submaps[self.active_idx]

    def empty(self) -> bool:
        return not self.submaps

    def find_closest_submap(self, position: np.ndarray) -> int:
        """≙ findClosestSubmap (SubmapCollection.cpp:164-174)."""
        return int(np.argmin([np.linalg.norm(position - s.center()) for s in self.submaps]))

    def total_num_points(self) -> int:
        """Occupied voxels over every submap (reads each count back)."""
        return sum(int(s.map.count()) for s in self.submaps)

    def _create_new_submap(self, map_to_range_sensor: np.ndarray, time: float) -> None:
        """≙ createNewSubmap (SubmapCollection.cpp:150-162).  Two slots per
        point of budget: open addressing needs load factor <= ~0.5."""
        parent = self.active_idx if self.submaps else 0
        slots = 2 * self.params.submaps.point_capacity
        self.submaps.append(Submap(
            submap_id=len(self.submaps), parent_id=parent, creation_time=time,
            map=voxel_map.empty(slots, device=self.device),
            dense_map=(voxel_map.empty(slots, device=self.device)
                       if self.params.mapper_localizer.is_build_dense_map else None),
            pose=np.asarray(map_to_range_sensor, dtype=np.float32).copy()))
        self.active_idx = len(self.submaps) - 1
        self.num_scans_merged_in_active = 0

    def _update_active_submap(self, map_to_range_sensor: np.ndarray, time: float,
                              active_count: Optional[int] = None) -> None:
        """≙ updateActiveSubmap (SubmapCollection.cpp:94-148).
        ``active_count``: the active table's occupied count when the caller
        has it on the host (the step returns it), else read back here."""
        p = self.params.submaps
        pos = np.asarray(map_to_range_sensor)[:3, 3]
        if self._force_new:
            self._create_new_submap(map_to_range_sensor, time)
            self._force_new = False
            return
        if self.num_scans_merged_in_active < p.min_num_range_data:
            return
        if self.is_localization_mode:
            return
        active = self.submaps[self.active_idx]
        if active_count is None:
            active_count = int(active.map.count())
        if active_count > p.point_capacity * 0.95:
            self._force_new = True  # point-budget rollover (≙ maxNumPoints_)
        closest_idx = self.find_closest_submap(pos)
        closest = self.submaps[closest_idx]
        if np.linalg.norm(pos - closest.center()) < p.submap_size:
            if closest_idx == self.active_idx:
                return
            if self.adjacency.is_adjacent(closest.submap_id, active.submap_id):
                # Revisiting an adjacent submap: switch back to it (re-key
                # its table first if loop-closure feedback content-moved it).
                closest.ensure_keys()
                self.active_idx = closest_idx
            elif np.linalg.norm(pos - active.center()) > p.submap_size:
                self._create_new_submap(map_to_range_sensor, time)
        else:
            self._create_new_submap(map_to_range_sensor, time)

    def _maybe_carve(self, scan_map_frame, map_to_range_sensor: np.ndarray) -> None:
        """Ray-cast space carving of the active submap every N scans (≙
        Submap::insertScan's carving branch, Submap.cpp:56-80)."""
        mb = self.params.map_builder
        if not mb.is_carving_enabled:
            return
        every = max(int(mb.space_carving.carve_space_every_n_scans), 1)
        sm = self.active_submap
        if sm.n_scans == 0 or sm.n_scans % every != 0:
            return
        sm.map = voxel_map.carve(
            sm.map, _resolve(scan_map_frame),
            to_device(np.asarray(map_to_range_sensor)[:3, 3], sm.map.device),
            carve_voxel_size=mb.space_carving.voxel_size,
            truncation_distance=mb.space_carving.truncation_distance,
            max_ray_length=mb.space_carving.max_raytracing_length)

    def ensure_active(self, map_to_range_sensor: np.ndarray, time: float) -> None:
        """Create the first submap if none exists."""
        if not self.submaps:
            self._create_new_submap(map_to_range_sensor, time)

    def note_fused_insert(self) -> None:
        """Count a scan the pipeline step already fused on the device."""
        self.submaps[self.active_idx].n_scans += 1
        self.num_scans_merged_in_active += 1

    def post_insert_update(self, merge_cloud_map_frame, map_to_range_sensor: np.ndarray,
                           time: float, active_count: Optional[int] = None) -> bool:
        """Lifecycle after a fused on-device insertion: overlap buffer,
        rollover decision, adjacency, overlap replay into a fresh submap.
        Returns True if the active submap changed."""
        self.overlap_buffer.append(
            (merge_cloud_map_frame, np.asarray(map_to_range_sensor), time))
        self.submaps[self.active_idx].n_scans += 1
        changed = self.lifecycle_check(map_to_range_sensor, time, active_count=active_count)
        if not changed:
            # After the insert, where the JAX package carves too: only
            # free space short of the truncation boundary is cleared, so
            # the surface just inserted stays.
            self._maybe_carve(merge_cloud_map_frame, map_to_range_sensor)
        self.num_scans_merged_in_active += 1
        return changed

    def _finish_rollover(self, prev_active: int, time: float) -> None:
        """Close ``prev_active`` and replay the overlap buffer into the new
        active submap (≙ SubmapCollection.cpp:210-246)."""
        self.submaps[prev_active].compute_center()
        self.finished_queue.append((prev_active, time))
        self.num_scans_merged_in_active = 0
        self.adjacency.add_edge(self.submaps[prev_active].submap_id,
                                self.active_submap.submap_id)
        new = self.active_submap
        for cloud, _, _ in list(self.overlap_buffer):
            new.map = voxel_map.insert(new.map, _resolve(cloud),
                                       self.params.map_builder.map_voxel_size)
            new.n_scans += 1
        self.overlap_buffer.clear()

    def lifecycle_check(self, map_to_range_sensor: np.ndarray, time: float,
                        active_count: Optional[int] = None) -> bool:
        """Active-submap selection + rollover finalization without inserting
        anything.  Returns True if the active submap changed."""
        prev_active = self.active_idx
        self._update_active_submap(map_to_range_sensor, time, active_count=active_count)
        changed = prev_active != self.active_idx
        if changed:
            self._finish_rollover(prev_active, time)
        return changed

    def insert_scan(self, merge_cloud_map_frame, map_to_range_sensor: np.ndarray,
                    time: float) -> bool:
        """Insert a preprocessed scan already in the map frame (≙ insertScan,
        SubmapCollection.cpp:189-246).  Returns True if the active submap
        changed."""
        voxel = self.params.map_builder.map_voxel_size
        merge_cloud_map_frame = _resolve(merge_cloud_map_frame)
        if not self.submaps:
            self._create_new_submap(map_to_range_sensor, time)
            sm = self.active_submap
            sm.map = voxel_map.insert(sm.map, merge_cloud_map_frame, voxel)
            sm.n_scans += 1
            self.num_scans_merged_in_active += 1
            return False
        self.overlap_buffer.append((merge_cloud_map_frame,
                                    np.asarray(map_to_range_sensor), time))
        prev_active = self.active_idx
        self._update_active_submap(map_to_range_sensor, time)
        changed = prev_active != self.active_idx
        if changed:
            # Final insertion into the submap being closed.
            old = self.submaps[prev_active]
            old.map = voxel_map.insert(old.map, merge_cloud_map_frame, voxel)
            old.n_scans += 1
            self._finish_rollover(prev_active, time)
        else:
            sm = self.active_submap
            self._maybe_carve(merge_cloud_map_frame, map_to_range_sensor)
            sm.map = voxel_map.insert(sm.map, merge_cloud_map_frame, voxel)
            sm.n_scans += 1
        self.num_scans_merged_in_active += 1
        return changed

    def insert_dense(self, cloud_map_frame: PointCloud) -> None:
        """≙ Submap::insertScanDenseMap via denseMapWorker
        (SlamWrapper.cpp:1014-1037)."""
        sm = self.active_submap
        if sm.dense_map is not None:
            sm.dense_map = voxel_map.insert(sm.dense_map, cloud_map_frame,
                                            self.params.dense_map_builder.map_voxel_size)

    # -- features / loop-closure hand-off -----------------------------------

    def compute_features_for_finished(self) -> List[int]:
        """Drain the finished queue: build each submap's feature cloud and
        FPFH descriptors and queue it as a loop-closure candidate
        (≙ SubmapCollection.cpp:257-281 + Submap.cpp:255-275)."""
        pr = self.params.place_recognition
        done = []
        while self.finished_queue:
            idx, time = self.finished_queue.popleft()
            sm = self.submaps[idx]
            feat_cloud = filters.voxel_downsample(
                sm.map.cloud, pr.feature_voxel_size, capacity=pr.feature_point_capacity,
                order="lex")
            feat_cloud = normals_ops.estimate_normals(
                feat_cloud, radius=pr.feature_map_normal_estimation_radius,
                k=pr.feature_normal_knn, sensor_origin=sm.pose[:3, 3])
            sm.feature_cloud = feat_cloud
            sm.features = fpfh.compute_fpfh(feat_cloud, radius=pr.feature_radius,
                                            k=min(pr.feature_knn, 48))
            self.lc_candidate_queue.append((idx, time))
            done.append(idx)
        return done

    def pop_loop_closure_candidates(self) -> List[Tuple[int, float]]:
        out = list(self.lc_candidate_queue)
        self.lc_candidate_queue.clear()
        return out

    # -- pose-graph feedback -------------------------------------------------

    def apply_transforms(self, increments: dict) -> dict:
        """Apply optimized per-submap transform increments, propagating each
        unoptimized submap by its parent chain
        (≙ SubmapCollection::transform, SubmapCollection.cpp:324-375)."""
        applied = {}
        for sm in self.submaps:
            # Walk up the parent chain to the nearest optimized ancestor.
            cur = sm
            dT = np.eye(4, dtype=np.float32)
            seen = set()
            while True:
                if cur.submap_id in increments:
                    dT = np.asarray(increments[cur.submap_id], dtype=np.float32)
                    break
                if cur.parent_id == cur.submap_id or cur.parent_id in seen:
                    break
                seen.add(cur.submap_id)
                cur = self.submaps[cur.parent_id]
            if not np.allclose(dT, np.eye(4), atol=1e-9):
                sm.transform(dT)
            applied[sm.submap_id] = dT
        # The ACTIVE submap keeps receiving inserts (the mapper rebuilds its
        # chain from this table): restore valid keys now; closed submaps
        # re-key lazily on re-activation (Submap.ensure_keys).
        if self.submaps:
            self.active_submap.ensure_keys()
        return applied

    def mark_loop_closure_submaps(self, ids) -> None:
        self.loop_closure_submaps.update(ids)
