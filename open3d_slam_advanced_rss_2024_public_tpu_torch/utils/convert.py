"""State carried across from the JAX package, as numpy arrays.

Turns the JAX package's map, submap, pipeline and pose-graph state (read
out with ``numpy.asarray``) into the port's, so that both sides can start a
stage from the same state; parameters load through the copied strict
loader.  The module takes arrays and plain Python values only: the caller
reads them out of the JAX objects.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.hashgrid import HashGrid
from ..ops.voxel_map import VoxelMap
from ..utils.pointcloud import PointCloud
from .config import SlamParameters, load_parameters


def voxel_map_from_arrays(ptable, origin, acc, cell, dropped, device="cuda") -> VoxelMap:
    """The fields of a JAX ``VoxelMap`` -> the port's (same slot layout)."""
    def t(x, dtype):
        return torch.as_tensor(np.array(x), dtype=dtype, device=device)

    return VoxelMap(ptable=t(ptable, torch.int32), origin=t(origin, torch.int32),
                    acc=t(acc, torch.float32), cell=t(cell, torch.float32),
                    dropped=t(dropped, torch.float32))


def voxel_map_from_jax(jmap, device="cuda") -> VoxelMap:
    """A JAX ``VoxelMap`` object (any object with its array fields) -> the
    port's."""
    return voxel_map_from_arrays(jmap.ptable, jmap.origin, jmap.acc, jmap.cell,
                                 jmap.dropped, device=device)


def voxel_map_shard_from_jax(jmaps, rank: int, device="cuda") -> VoxelMap:
    """Rank ``rank``'s table out of a JAX ``[D, C, ...]``-stacked sharded map
    (``parallel.sharded_map``): the state one rank of the port holds."""
    return voxel_map_from_arrays(*(np.asarray(x)[rank] for x in (
        jmaps.ptable, jmaps.origin, jmaps.acc, jmaps.cell, jmaps.dropped)), device=device)


def cloud_from_arrays(xyz, normals, mask, device="cuda", attrs=None,
                      attr_names=()) -> PointCloud:
    """The fields of a JAX ``PointCloud`` -> the port's, lane for lane."""
    return PointCloud(
        xyz=torch.as_tensor(np.array(xyz), dtype=torch.float32, device=device),
        normals=torch.as_tensor(np.array(normals), dtype=torch.float32, device=device),
        mask=torch.as_tensor(np.array(mask), dtype=torch.bool, device=device),
        attrs=None if attrs is None else torch.as_tensor(np.array(attrs), dtype=torch.float32,
                                                         device=device),
        attr_names=tuple(attr_names))


def cloud_from_jax(jcloud, device="cuda") -> PointCloud:
    """A JAX ``PointCloud`` object -> the port's, descriptor channels
    included."""
    return cloud_from_arrays(jcloud.xyz, jcloud.normals, jcloud.mask, device=device,
                             attrs=jcloud.attrs, attr_names=jcloud.attr_names)


def hash_grid_from_arrays(points, normals, perm, start, count, cell,
                          device="cuda", desc=None) -> HashGrid:
    """The fields of a JAX ``HashGrid`` -> the port's (the same CSR layout)."""
    def t(x, dtype):
        return torch.as_tensor(np.array(x), dtype=dtype, device=device)

    return HashGrid(points=t(points, torch.float32), normals=t(normals, torch.float32),
                    perm=t(perm, torch.int32), start=t(start, torch.int32),
                    count=t(count, torch.int32), cell=t(cell, torch.float32),
                    desc=None if desc is None else t(desc, torch.float32))


def hash_grid_from_jax(jgrid, device="cuda") -> HashGrid:
    """A JAX ``HashGrid`` object -> the port's."""
    return hash_grid_from_arrays(jgrid.points, jgrid.normals, jgrid.perm, jgrid.start,
                                 jgrid.count, jgrid.cell, device=device, desc=jgrid.desc)


def submap_from_jax(jsub, device="cuda"):
    """A JAX ``Submap`` -> the port's: tables, pose, feature cloud and
    descriptors, scan count, frozen center and ``keys_stale``."""
    from ..models.submap import Submap

    fc = jsub.feature_cloud
    # A centroid still in flight is read out here (waiting for it), not
    # through center(), which answers the creation origin until it lands.
    center = jsub._center if jsub._center is not None else jsub._center_dev
    return Submap(
        submap_id=int(jsub.submap_id), parent_id=int(jsub.parent_id),
        creation_time=float(jsub.creation_time),
        map=voxel_map_from_jax(jsub.map, device),
        dense_map=None if jsub.dense_map is None else voxel_map_from_jax(jsub.dense_map, device),
        pose=np.array(jsub.pose, dtype=np.float32),
        feature_cloud=None if fc is None else cloud_from_arrays(fc.xyz, fc.normals, fc.mask,
                                                                device),
        features=None if jsub.features is None else torch.as_tensor(
            np.array(jsub.features), dtype=torch.float32, device=device),
        n_scans=int(jsub.n_scans),
        _center=None if center is None else np.array(center, dtype=np.float64),
        keys_stale=bool(jsub.keys_stale))


def constraints_from_jax(jconstraints):
    """A list of JAX ``Constraint`` objects -> the port's."""
    from ..models.pose_graph import Constraint

    return [Constraint(source_id=int(c.source_id), target_id=int(c.target_id),
                       T_source_target=np.array(c.T_source_target, np.float32),
                       information=np.array(c.information, np.float32),
                       is_odometry=bool(c.is_odometry)) for c in jconstraints]


def pose_graph_arrays_from_jax(jgraph, device="cuda"):
    """A JAX ``PoseGraphArrays`` (padded to its capacity) -> the port's,
    lane for lane (the layout the distributed solver takes)."""
    from ..models.pose_graph import PoseGraphArrays

    def t(x, dtype):
        return torch.as_tensor(np.array(x), dtype=dtype, device=device)

    return PoseGraphArrays(
        node_poses=t(jgraph.node_poses, torch.float32), node_mask=t(jgraph.node_mask, torch.bool),
        edge_src=t(jgraph.edge_src, torch.int64), edge_dst=t(jgraph.edge_dst, torch.int64),
        edge_T=t(jgraph.edge_T, torch.float32), edge_info=t(jgraph.edge_info, torch.float32),
        edge_uncertain=t(jgraph.edge_uncertain, torch.bool),
        edge_mask=t(jgraph.edge_mask, torch.bool))


def optimization_problem_from_dict(d: dict, max_nodes: int = 128, max_edges: int = 512,
                                   device="cuda"):
    """``OptimizationProblem.to_dict()`` of either package -> the port's."""
    from ..models.pose_graph import OptimizationProblem

    return OptimizationProblem.from_dict(d, max_nodes, max_edges, device=device)


def map_state_from_arrays(ptable, origin, acc, cell, dropped, pose,
                          last_insertion_pose, device="cuda"):
    """The fields of a JAX ``pipeline.MapState`` -> the port's."""
    from ..models.pipeline import MapState

    vmap = voxel_map_from_arrays(ptable, origin, acc, cell, dropped, device=device)
    return MapState(map=vmap,
                    pose=torch.as_tensor(np.array(pose), dtype=torch.float32, device=device),
                    last_insertion_pose=torch.as_tensor(np.array(last_insertion_pose),
                                                        dtype=torch.float32, device=device))


def params_from_dict(d: dict) -> SlamParameters:
    """Nested parameter overrides (as the JAX package's ``load_parameters``
    takes them) -> SlamParameters."""
    return load_parameters(d)
