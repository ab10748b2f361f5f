"""A whole sharded SLAM session on a mesh of ranks: mapper -> submap
rollover -> features and loop closure -> distributed pose-graph solve ->
feedback.

Counterpart of the JAX package's ``parallel/sharded_session.py``: the
sharded pieces (``sharded_slam``, ``distributed_pose_graph``) composed into
the control flow of the single-device SlamWrapper (≙ reference
SlamWrapper.cpp:619-1140), with the map spatially partitioned over the
ranks.  Every rank runs the whole session: the mapper on its own shard,
and the host-side bookkeeping, the features and the loop-closure proposal
replicated, so that the ranks stay in step.

``comm_volume`` keeps the JAX package's accounting (its formulas and byte
counts).  What the port's collectives move is set out in ``sharded_slam``
and ``distributed_pose_graph``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..models import pose_graph as pg
from ..models.pipeline import PipelineConfig
from ..ops import filters, fpfh as fpfh_ops, hashgrid, normals as normals_ops, voxel_map
from ..ops.registration import icp as icp_mod
from ..ops.registration.icp import ICPConfig
from ..ops.registration.ransac import register_features
from ..utils.pointcloud import PointCloud, compact
from .distributed_pose_graph import make_distributed_solver, padded_arrays
from .mesh import Mesh, from_rank0
from .sharded_map import restack
from .sharded_slam import make_sharded_mapper

Tensor = torch.Tensor

# The session's seed for the loop-closure RANSAC draws (JAX: PRNGKey(3)).
RANSAC_SEED = 3
SOLVE_ITERATIONS = 12


def comm_volume(n_query: int, icp_iters: int, n_nodes: int, lm_iters: int) -> dict:
    """The JAX package's count of the bytes one sharded-ICP scan and one
    distributed solve move: 7 floats a query a trip, and (36 N^2 + 6 N)
    floats an LM trip."""
    return {
        "icp_bytes_per_scan": 7 * 4 * n_query * icp_iters,
        "solve_bytes_per_solve": (36 * n_nodes * n_nodes + 6 * n_nodes) * 4 * lm_iters,
    }


@dataclasses.dataclass
class ShardedSubmap:
    """A closed sharded submap: gathered cloud, pose and features."""

    pose: np.ndarray
    cloud: PointCloud                 # gathered over the ranks, compacted
    feature_cloud: Optional[PointCloud] = None
    features: Optional[Tensor] = None


def _gather_map_cloud(mesh: Mesh, maps: voxel_map.VoxelMap, capacity: int) -> PointCloud:
    """Every rank's table, all-gathered on the device, as one compact cloud:
    the occupied voxels of positive weight, their means (others at the
    sentinel 3.0e7) and unnormalised normal means, as the JAX package's
    host gather computes them."""
    stacked = restack(mesh, maps)
    acc = stacked.acc
    w = acc[..., 6]
    m = stacked.occupied & (w > 0)
    denom = torch.clamp(w, min=1e-9)[..., None]
    xyz = torch.where(m[..., None], acc[..., 0:3] / denom, 3.0e7)
    flat = PointCloud(xyz=xyz.reshape(-1, 3), normals=(acc[..., 3:6] / denom).reshape(-1, 3),
                      mask=m.reshape(-1))
    return compact(flat, capacity)


def run_sharded_slam_session(mesh: Mesh, gt: List[np.ndarray], scans: List[PointCloud],
                             odom_deltas: List[np.ndarray], scans_per_submap: int = 6,
                             capacity_per_device: int = 4096, block_size: float = 4.0,
                             scan_capacity: int = 1024, feature_capacity: int = 1024,
                             map_voxel_size: float = 0.15, loop_closure: bool = True,
                             generator: torch.Generator = None) -> dict:
    """Run the whole sharded flow and return a result dict.

    The mapper steps every scan on the mesh; every ``scans_per_submap``
    scans the active sharded map closes (rollover): its cloud is gathered
    and featurised (voxel downsample -> normals -> FPFH, ≙
    Submap::computeFeatures), and a fresh sharded map starts at the current
    pose.  After the trajectory, RANSAC between the first and the last
    submap's features proposes a loop closure (draws from ``generator``, a
    host generator, seeded with RANSAC_SEED when None), ICP refines it, the
    distributed solver solves the graph, and the increments apply to the
    submap poses and the trajectory.
    """
    dev = mesh.device
    if generator is None:
        generator = torch.Generator().manual_seed(RANSAC_SEED)
    pcfg = PipelineConfig(
        icp=ICPConfig(max_iterations=6, matcher="sharded", max_correspondence_dist=0.6),
        scan_voxel_size=map_voxel_size, scan_capacity=scan_capacity,
        crop_min_radius=0.4, crop_max_radius=18.0, map_patch_capacity=2 * scan_capacity,
        map_voxel_size=map_voxel_size, min_refinement_fitness=0.2)
    empty_state, step_fn = make_sharded_mapper(
        mesh, pcfg, capacity_per_device=capacity_per_device, block_size=block_size)
    eye = torch.eye(4, dtype=torch.float32, device=dev)

    maps, last_ins = empty_state(), eye
    pose = np.asarray(gt[0], dtype=np.float32)
    submaps: List[ShardedSubmap] = []
    submap_pose = pose.copy()
    scan_submap_ids: List[int] = []
    traj: List[np.ndarray] = []

    def close_submap():
        nonlocal maps, last_ins
        submaps.append(ShardedSubmap(pose=submap_pose.copy(),
                                     cloud=_gather_map_cloud(mesh, maps, 4 * scan_capacity)))
        maps, last_ins = empty_state(), eye

    for i, scan in enumerate(scans):
        est = (pose @ odom_deltas[i]).astype(np.float32)
        maps, T, _, last_ins = step_fn(maps, last_ins, scan, est)
        pose = T.cpu().numpy()
        traj.append(pose.copy())
        scan_submap_ids.append(len(submaps))
        if (i + 1) % scans_per_submap == 0 and i + 1 < len(scans):
            close_submap()
            submap_pose = pose.copy()
    close_submap()

    # Features per submap (≙ Submap::computeFeatures, Submap.cpp:255-275).
    for sm in submaps:
        fc = filters.voxel_downsample(sm.cloud, 2.0 * map_voxel_size, capacity=feature_capacity,
                                      order="lex")
        fc = normals_ops.estimate_normals(fc, radius=1.0, k=12, sensor_origin=sm.pose[:3, 3])
        sm.feature_cloud = fc
        sm.features = fpfh_ops.compute_fpfh(fc, radius=1.5, k=24)

    # Pose graph: odometry edges between consecutive submaps.
    n_nodes = len(submaps)
    cs: List[pg.Constraint] = []
    for a in range(n_nodes - 1):
        T_rel = (np.linalg.inv(submaps[a].pose.astype(np.float64))
                 @ submaps[a + 1].pose.astype(np.float64))
        cs.append(pg.Constraint(a, a + 1, T_rel.astype(np.float32),
                                np.eye(6, dtype=np.float32) * 10.0, True))

    lc_found = False
    if loop_closure and n_nodes >= 3:
        proposal = torch.zeros((17,), dtype=torch.float32, device=dev)
        q, c = submaps[-1], submaps[0]
        T_lc, n_inl, _, _, _ = register_features(
            q.feature_cloud.xyz, q.feature_cloud.mask, q.features,
            c.feature_cloud.xyz, c.feature_cloud.mask, c.features, generator,
            max_correspondence_dist=0.6, checker_distance=0.8, checker_edge_length=0.5,
            batch=2048)
        if int(n_inl) >= 10:
            # ICP refinement of the RANSAC proposal on the full submap
            # clouds (≙ PlaceRecognition.cpp:97-121), with K1 on the
            # candidate's cloud in Morton order.
            rcfg = ICPConfig(max_iterations=30, max_correspondence_dist=0.5,
                             minimizer="point_to_plane", matcher="cuda")
            ref = hashgrid.passthrough(hashgrid.morton_sort(c.cloud, 0.5), 0.5)
            res = icp_mod.register(q.cloud, ref, T_lc.to(torch.float32), rcfg,
                                   poll_every=icp_mod.POLL_EVERY)
            T_ref = res.transform.cpu().numpy().astype(np.float64)
            # T_ref moves the query's map-frame cloud onto the candidate's;
            # the relative measurement runs source (c) -> target (q).
            X_q = q.pose.astype(np.float64)
            X_c = c.pose.astype(np.float64)
            T_rel = np.linalg.inv(X_c) @ (T_ref @ X_q)
            proposal = torch.cat([proposal.new_ones((1,)), torch.as_tensor(
                T_rel.reshape(16), dtype=torch.float32, device=dev)])
        # The features and RANSAC agree across ranks only to rounding on
        # CUDA, so whether the edge exists, and its measurement, are rank
        # 0's: every rank must solve the same graph.
        proposal = from_rank0(mesh, proposal).cpu().numpy()
        if proposal[0] > 0.5:
            cs.append(pg.Constraint(0, n_nodes - 1, proposal[1:].reshape(4, 4),
                                    np.eye(6, dtype=np.float32) * 20.0, False))
            lc_found = True

    # The distributed solve (edges split over the ranks).
    D = mesh.size
    max_edges = ((len(cs) + D - 1) // D) * D
    graph = padded_arrays([s.pose for s in submaps], cs, max_nodes=n_nodes,
                          max_edges=max_edges, device=dev)
    solver = make_distributed_solver(mesh, max_nodes=n_nodes, max_iterations=SOLVE_ITERATIONS)
    X, _ = solver(graph, 0, 2.0)
    X = X.cpu().numpy()

    # Feedback: per-submap increments onto poses and the trajectory
    # (≙ updateSubmapsAndTrajectory, SlamWrapper.cpp:1105-1140).
    incs = [X[i].astype(np.float64) @ np.linalg.inv(submaps[i].pose.astype(np.float64))
            for i in range(n_nodes)]
    corrected = [incs[scan_submap_ids[i]] @ traj[i].astype(np.float64)
                 for i in range(len(traj))]
    graph_poses = [s.pose for s in submaps]
    for i, sm in enumerate(submaps):
        sm.pose = (incs[i] @ sm.pose.astype(np.float64)).astype(np.float32)

    def ate(poses):
        errs = [np.linalg.norm(np.asarray(p)[:3, 3] - gt[i][:3, 3])
                for i, p in enumerate(poses)]
        return float(np.sqrt(np.mean(np.square(errs))))

    return {
        "n_submaps": n_nodes,
        "lc_found": lc_found,
        "ate_before": ate(traj),
        "ate_after": ate(corrected),
        "total_voxels": sum(int(sm.cloud.count()) for sm in submaps),
        "comm": comm_volume(scan_capacity, pcfg.icp.max_iterations, n_nodes,
                            SOLVE_ITERATIONS),
        "trajectory": traj,
        "corrected": corrected,
        # The solved graph: its node poses and constraints, and the solution.
        "graph": (graph_poses, cs),
        "solved": X,
    }
