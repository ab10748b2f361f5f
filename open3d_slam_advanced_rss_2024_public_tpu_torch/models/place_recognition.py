"""Loop-closure proposal: candidate gating, RANSAC, consistency, refinement.

Counterpart of the JAX package's ``models/place_recognition.py`` (reference
PlaceRecognition.cpp:35-287): candidate gating by distance, adjacency and
submaps between closures (:231-285), RANSAC over FPFH correspondences
(:79-90), the drift-consistency check (:92-95, 182-229), overlap-restricted
ICP refinement with a fitness gate (:97-121) and the information matrix from
the point clouds (:148-150).  Also hosts the odometry constraint builder
(≙ constraint_builders.cpp:33-119).

Dispatch, then read once.  Every candidate (and every odometry edge) is
evaluated in full on the device with no host gate between its stages; the
small outputs of a whole batch are packed into one tensor, copied to pinned
host memory without waiting, and resolved through one event.  All gates are
then applied on the host.  These functions run on background threads that
share the Mapper's stream, so nothing here may wait for the device before
that one read.

The ICP refinements and the information matrices match through
``mapper.resolve_matcher("auto")``: kernel K1 on CUDA tensors (its plain
twin on the CPU), with one prepared reference per overlap cloud.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..ops import hashgrid
from ..ops.registration import icp as icp_mod
from ..ops.registration.icp import ICPConfig
from ..ops.registration.ransac import (information_matrix_from_point_clouds,
                                       register_features)
from ..utils import se3
from ..utils.config import MapperParameters
from ..utils.device import HostCopy
from ..utils.pointcloud import PointCloud, compact
from .mapper import resolve_matcher
from .pose_graph import Constraint
from .submap import AdjacencyMatrix, Submap

Tensor = torch.Tensor

# ≙ the reference's magic constants (include/open3d_slam/magic.hpp:12-17).
VOXEL_SIZE_IF_MAP_VOXEL_ZERO = 0.04
EXPANSION_FACTOR_OVERLAP = 20.0
EXPANSION_FACTOR_ICP_CORRESPONDENCE = 1.5
RUN_UNTIL_CONVERGENCE_ITERS = 100


def overlap_clouds(a: PointCloud, b: PointCloud, voxel_size: float, capacity: int,
                   T_a: Optional[Tensor] = None):
    """Restrict two map-frame clouds to their mutual voxel overlap and
    compact to a fixed capacity.  ``T_a`` pre-transforms ``a`` for the
    overlap test only (the returned cloud stays in a's frame).
    ≙ computeIndicesOfOverlappingPoints + SelectByIndex (helpers.cpp:320-345)."""
    a_probe = a if T_a is None else a.transform(T_a)
    in_b = hashgrid.occupancy_lookup(b.xyz, b.mask, a_probe.xyz, a_probe.mask, voxel_size)
    in_a = hashgrid.occupancy_lookup(a_probe.xyz, a_probe.mask, b.xyz, b.mask, voxel_size)
    return compact(a.with_mask(in_b), capacity), compact(b.with_mask(in_a), capacity)


def _pack(*parts: Tensor) -> Tensor:
    """Small outputs of one evaluation as one flat f32 row."""
    return torch.cat([p.to(torch.float32).reshape(-1) for p in parts])


def _lc_candidate_eval(q_feat: PointCloud, q_feats: Tensor, c_feat: PointCloud,
                       c_feats: Tensor, q_map: PointCloud, c_map: PointCloud,
                       generator: torch.Generator, ransac_max_corr: float,
                       checker_dist: float, checker_edge: float, overlap_voxel: float,
                       info_max_dist: float, overlap_capacity: int, refine_cfg: ICPConfig,
                       ransac_batch: int) -> Tensor:
    """One loop-closure candidate, fully evaluated on the device: RANSAC ->
    overlap restriction -> ICP refinement -> information matrix
    (≙ PlaceRecognition.cpp:79-150 minus the host gates).  Returns the row
    (T[16], n_inliers, n_q, n_c, T_refined[16], fitness, info[36])."""
    T, n_inliers, _, _, _ = register_features(
        q_feat.xyz, q_feat.mask, q_feats, c_feat.xyz, c_feat.mask, c_feats, generator,
        max_correspondence_dist=ransac_max_corr, checker_distance=checker_dist,
        checker_edge_length=checker_edge, batch=ransac_batch)
    q_ov, c_ov = overlap_clouds(q_map, c_map, overlap_voxel, overlap_capacity, T_a=T)
    grid = hashgrid.passthrough(c_ov, refine_cfg.max_correspondence_dist)
    nn_ref = icp_mod.prepare_reference(refine_cfg, grid)
    res = icp_mod.register(q_ov, grid, T, refine_cfg, nn_ref, poll_every=icp_mod.POLL_EVERY)
    info, _ = information_matrix_from_point_clouds(
        q_ov.xyz, q_ov.mask, grid, res.transform, info_max_dist,
        matcher=refine_cfg.matcher, nn_ref=nn_ref)
    return _pack(T, n_inliers, q_ov.count(), c_ov.count(), res.transform,
                 res.match_ratio, info)


def _odo_edge_eval(parent_map: PointCloud, child_map: PointCloud, overlap_voxel: float,
                   icp_max_dist: float, overlap_capacity: int, refine_cfg: ICPConfig,
                   do_refine: bool) -> Tensor:
    """One parent->child odometry edge, fully evaluated on the device:
    overlap restriction -> optional ICP refinement -> information matrix
    (≙ constraint_builders.cpp:43-90 minus the host gates).  Returns the row
    (n_p, n_c, T_corr[16], info[36])."""
    p_ov, c_ov = overlap_clouds(parent_map, child_map, overlap_voxel, overlap_capacity)
    grid = hashgrid.passthrough(c_ov, icp_max_dist)
    nn_ref = icp_mod.prepare_reference(refine_cfg, grid)
    T_corr = torch.eye(4, dtype=torch.float32, device=p_ov.device)
    if do_refine:
        T_corr = icp_mod.register(p_ov, grid, T_corr, refine_cfg, nn_ref,
                                  poll_every=icp_mod.POLL_EVERY).transform
    info, _ = information_matrix_from_point_clouds(
        p_ov.xyz, p_ov.mask, grid, T_corr, icp_max_dist, matcher=refine_cfg.matcher,
        nn_ref=nn_ref)
    return _pack(p_ov.count(), c_ov.count(), T_corr, info)


def _read_rows(rows: List[Tensor]) -> np.ndarray:
    """One pinned non-blocking copy and one event for a batch of rows."""
    if not rows:
        return np.zeros((0, 0), np.float32)
    return HostCopy([torch.stack(rows)]).wait()[0]


class PlaceRecognition:
    def __init__(self, params: MapperParameters):
        self.params = params
        pr = params.place_recognition
        self.refine_cfg = ICPConfig(
            max_iterations=40,
            max_correspondence_dist=pr.max_icp_correspondence_distance,
            minimizer="point_to_plane",
            matcher=resolve_matcher("auto"),
        )
        # Seeds the RANSAC generator of each candidate.
        self._rng = np.random.RandomState(7)

    def _map_voxel_size(self) -> float:
        """≙ getMapVoxelSize with the magic fallback when the map is
        unvoxelized (constraint_builders.cpp:34-36)."""
        v = float(self.params.map_builder.map_voxel_size)
        return v if v > 0 else VOXEL_SIZE_IF_MAP_VOXEL_ZERO

    # -- candidate gating (≙ getLoopClosureCandidatesIdxs, :231-285) --------

    def candidate_indices(self, submaps: List[Submap], adjacency: AdjacencyMatrix,
                          query_idx: int, active_idx: int,
                          loop_closure_submaps: set) -> List[int]:
        pr = self.params.place_recognition
        query = submaps[query_idx]
        qc = query.center()
        out = []
        for i, s in enumerate(submaps):
            if i == query_idx or i == active_idx:
                continue
            if s.features is None:
                continue
            if adjacency.is_adjacent(s.submap_id, query.submap_id):
                continue
            if np.linalg.norm(s.center() - qc) > pr.loop_closure_search_radius:
                continue
            # Spacing gate: graph distance from the nearest loop-closure
            # submap (≙ AdjacencyMatrix::getDistanceToNearest...).
            if loop_closure_submaps:
                d = adjacency.bfs_distance(query.submap_id, set(loop_closure_submaps))
                if d < pr.min_submaps_between_loop_closures:
                    continue
            out.append(i)
        return out

    # -- consistency (≙ isRegistrationConsistent, :182-229) ------------------

    def is_consistent(self, T_correction: np.ndarray) -> bool:
        cc = self.params.place_recognition.consistency_check
        R = torch.from_numpy(np.ascontiguousarray(T_correction[:3, :3], dtype=np.float32))
        rpy = np.rad2deg(se3.matrix_to_rpy(R).numpy())
        t = T_correction[:3, 3]
        return (abs(rpy[0]) <= cc.max_drift_roll and abs(rpy[1]) <= cc.max_drift_pitch
                and abs(rpy[2]) <= cc.max_drift_yaw and abs(t[0]) <= cc.max_drift_x
                and abs(t[1]) <= cc.max_drift_y and abs(t[2]) <= cc.max_drift_z)

    # -- main entry (≙ buildLoopClosureConstraints, :50-150) -----------------

    def build_loop_closure_constraints(self, submaps: List[Submap],
                                       adjacency: AdjacencyMatrix, query_idx: int,
                                       active_idx: int,
                                       loop_closure_submaps: set) -> List[Constraint]:
        pr = self.params.place_recognition
        query = submaps[query_idx]
        if query.features is None or query.feature_cloud is None:
            return []
        # Phase 1 — dispatch every candidate's full device pipeline.
        voxel_for_overlap = EXPANSION_FACTOR_OVERLAP * self._map_voxel_size()
        cands, rows = [], []
        for cand_idx in self.candidate_indices(submaps, adjacency, query_idx, active_idx,
                                               loop_closure_submaps):
            cand = submaps[cand_idx]
            # A host-side generator: the same triplets on any device.
            generator = torch.Generator()
            generator.manual_seed(int(self._rng.randint(0, 2**31 - 1)))
            rows.append(_lc_candidate_eval(
                query.feature_cloud, query.features, cand.feature_cloud, cand.features,
                query.map.cloud, cand.map.cloud, generator,
                pr.ransac_max_correspondence_dist,
                pr.ransac_correspondence_checker_distance,
                pr.ransac_correspondence_checker_edge_length,
                voxel_for_overlap, pr.max_icp_correspondence_distance,
                overlap_capacity=pr.overlap_point_capacity, refine_cfg=self.refine_cfg,
                ransac_batch=pr.ransac_batch_size))
            cands.append(cand)
        # Phase 2 — ONE readback for every candidate, then all gates on host.
        out: List[Constraint] = []
        for cand, v in zip(cands, _read_rows(rows)):
            T, n_inliers, n_q, n_c = v[:16].reshape(4, 4), v[16], v[17], v[18]
            T_refined, fitness, info = v[19:35].reshape(4, 4), v[35], v[36:72].reshape(6, 6)
            if int(n_inliers) < pr.ransac_min_corresondence_set_size:
                continue
            # Drift consistency: both clouds live in the map frame, so T
            # itself is the correction this closure implies.
            if not self.is_consistent(T):
                continue
            if int(n_q) < pr.ransac_min_corresondence_set_size or \
               int(n_c) < pr.ransac_min_corresondence_set_size:
                continue
            if float(fitness) < pr.min_icp_refinement_fitness:
                continue
            if not self.is_consistent(T_refined):
                continue
            # T_refined corrects query's map-frame cloud onto cand's:
            # corrected query pose X_q' = T_refined @ X_q, measured as a
            # source(cand) -> target(query) relative pose.
            X_q = query.pose.astype(np.float64)
            X_c = cand.pose.astype(np.float64)
            T_rel = np.linalg.inv(X_c) @ (T_refined.astype(np.float64) @ X_q)
            out.append(Constraint(
                source_id=cand.submap_id, target_id=query.submap_id,
                T_source_target=T_rel.astype(np.float32),
                # Raw correspondence-sum information, so odometry and
                # loop-closure edges carry comparable, data-driven weight.
                information=np.array(info, np.float32), is_odometry=False))
        return out


def _odo_edge_dispatch(parent: Submap, child: Submap, map_voxel_size: float,
                       overlap_capacity: int, refine: bool) -> Tensor:
    """Dispatch one odometry edge's device evaluation (no blocking)."""
    v = map_voxel_size if map_voxel_size > 0 else VOXEL_SIZE_IF_MAP_VOXEL_ZERO
    icp_max_dist = EXPANSION_FACTOR_ICP_CORRESPONDENCE * v
    cfg = ICPConfig(max_iterations=RUN_UNTIL_CONVERGENCE_ITERS,
                    max_correspondence_dist=icp_max_dist, minimizer="point_to_plane",
                    matcher=resolve_matcher("auto"))
    return _odo_edge_eval(parent.map.cloud, child.map.cloud, EXPANSION_FACTOR_OVERLAP * v,
                          icp_max_dist, overlap_capacity=overlap_capacity, refine_cfg=cfg,
                          do_refine=refine)


def _odo_edge_finish(parent: Submap, child: Submap, v: np.ndarray) -> Constraint:
    """Apply the host gates to one edge's read-back row."""
    n_p, n_c = v[0], v[1]
    T_corr = np.eye(4, dtype=np.float64)
    info = np.eye(6, dtype=np.float32)
    if int(n_p) > 10 and int(n_c) > 10:
        T_corr = v[2:18].reshape(4, 4).astype(np.float64)
        info = np.array(v[18:54].reshape(6, 6), np.float32)
        # A degenerate overlap yields a singular matrix; keep the edge
        # solvable (the reference relies on Open3D's identity fallback).
        if not np.isfinite(info).all() or np.trace(info) < 1.0:
            info = np.eye(6, dtype=np.float32)
    # The clouds live in the map frame, so T_corr corrects the parent side
    # in map frame; fold it into the relative measurement.
    X_p = T_corr @ parent.pose.astype(np.float64)
    T_rel = np.linalg.inv(X_p) @ child.pose.astype(np.float64)
    return Constraint(source_id=parent.submap_id, target_id=child.submap_id,
                      T_source_target=T_rel.astype(np.float32), information=info,
                      is_odometry=True)


def build_odometry_constraint(parent: Submap, child: Submap, map_voxel_size: float,
                              overlap_capacity: int = 16384,
                              refine: bool = False) -> Constraint:
    """One parent->child odometry edge with an overlap-computed information
    matrix and optional ICP refinement (≙ buildOdometryConstraint,
    constraint_builders.cpp:33-90): overlap-restricted map clouds (voxel
    20x map voxel), optional point-to-plane ICP run to convergence at
    1.5x-map-voxel correspondence distance, information matrix on the
    overlap clouds."""
    row = _odo_edge_dispatch(parent, child, map_voxel_size, overlap_capacity, refine)
    return _odo_edge_finish(parent, child, _read_rows([row])[0])


def compute_odometry_constraints(submaps: List[Submap], finished_ids: List[int],
                                 map_voxel_size: float = 0.0,
                                 overlap_capacity: int = 16384,
                                 refine: bool = False) -> List[Constraint]:
    """Parent->child odometry constraints for finished submaps
    (≙ computeOdometryConstraints, constraint_builders.cpp:92-119): one edge
    per finished submap from its parent, skipping roots (duplicates are
    dropped by ``OptimizationProblem.insert_odometry_constraints``).  All
    edges dispatch first, then one readback."""
    pairs, rows = [], []
    for idx in finished_ids:
        sm = submaps[idx]
        if sm.parent_id == sm.submap_id:
            continue
        parent = next((s for s in submaps if s.submap_id == sm.parent_id), None)
        if parent is None:
            continue
        pairs.append((parent, sm))
        rows.append(_odo_edge_dispatch(parent, sm, map_voxel_size, overlap_capacity, refine))
    return [_odo_edge_finish(p, c, v) for (p, c), v in zip(pairs, _read_rows(rows))]
