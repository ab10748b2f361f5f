"""Spatially sharded voxel map: map blocks partitioned across the ranks.

Counterpart of the JAX package's ``parallel/sharded_map.py``.  A block is
a voxel cell of ``block_size``; its owner is the spatial hash of the block
modulo D (``block_owner``).  Every rank holds its own ``VoxelMap`` of
``capacity_per_device`` slots with only the voxels of its own blocks, so
the total capacity grows with the mesh; insertion is owner-partitioned and
needs no communication.  A query batch is replicated: every rank answers
from its shard with kernel K1 and the winners reduce over the mesh
(``mesh.reduce_winners``).

The JAX package keeps the maps as one ``[D, C, ...]`` array sharded over
the mesh.  Here a rank holds only its own table, and the stacked view
exists only as what ``restack`` all-gathers (``gather_fn``, and the
session's rollover).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import cuda_nn, voxel_map
from ..ops.hashgrid import hash_key, morton_sort, voxel_key
from ..utils.pointcloud import PointCloud
from .mesh import Mesh, all_gather, reduce_winners

Tensor = torch.Tensor


def block_owner(xyz: Tensor, block_size, n_devices: int) -> Tensor:
    """The rank owning each point's spatial block (int32[N])."""
    key = voxel_key(xyz, block_size)
    return (hash_key(key, 1 << 20) % n_devices).to(torch.int32)


def stack_empty_maps(n_devices: int, capacity_per_device: int,
                     device="cuda") -> voxel_map.VoxelMap:
    """A [D, ...]-stacked empty VoxelMap (one table per rank), the layout
    of ``restack``'s output."""
    one = voxel_map.empty(capacity_per_device, device=device)
    return _map_fields(one, lambda x: x.expand((n_devices,) + x.shape).clone())


def local_view(stacked: voxel_map.VoxelMap, rank: int) -> voxel_map.VoxelMap:
    """Rank ``rank``'s table out of a [D, ...]-stacked view."""
    return _map_fields(stacked, lambda x: x[rank])


def restack(mesh: Mesh, local: voxel_map.VoxelMap) -> voxel_map.VoxelMap:
    """Every rank's table, all-gathered into the [D, ...]-stacked view
    (one all-gather a field)."""
    return _map_fields(local, lambda x: all_gather(mesh, x))


def _map_fields(vm: voxel_map.VoxelMap, fn) -> voxel_map.VoxelMap:
    return dataclasses.replace(
        vm, ptable=fn(vm.ptable), origin=fn(vm.origin), acc=fn(vm.acc), cell=fn(vm.cell),
        dropped=fn(vm.dropped), sum_attrs=None if vm.sum_attrs is None else fn(vm.sum_attrs))


def insert_owned(mesh: Mesh, vm: voxel_map.VoxelMap, scan: PointCloud, voxel_size,
                 block_size, enable=True) -> voxel_map.VoxelMap:
    """Fuse the lanes of a replicated map-frame ``scan`` that fall in this
    rank's blocks (and ``enable``) into this rank's table."""
    mine = (block_owner(scan.xyz, block_size, mesh.size) == mesh.rank) & enable
    return voxel_map.insert(vm, scan.with_mask(mine), voxel_size)


def make_sharded_map_ops(mesh: Mesh, capacity_per_device: int, map_voxel_size: float,
                         block_size: float = 8.0):
    """(empty_fn, insert_fn, nn_fn, gather_fn) over a fixed mesh.

    insert_fn(maps, scan)                        -> maps  (scan replicated)
    nn_fn(maps, queries, mask, max_dist)         -> (xyz of match, nrm, d2, found)
    gather_fn(maps)                              -> PointCloud [D*C] (all blocks)

    ``maps`` is this rank's table; the outputs of ``nn_fn`` and
    ``gather_fn`` are replicated.
    """

    def empty_maps() -> voxel_map.VoxelMap:
        return voxel_map.empty(capacity_per_device, device=mesh.device)

    def insert_fn(maps: voxel_map.VoxelMap, scan: PointCloud) -> voxel_map.VoxelMap:
        return insert_owned(mesh, maps, scan, map_voxel_size, block_size)

    def nn_fn(maps: voxel_map.VoxelMap, query_xyz: Tensor, query_mask: Tensor, max_dist):
        # The table in Morton order keeps K1's tiles spatially tight.
        ref = morton_sort(maps.cloud, max_dist)
        idx, d2 = cuda_nn.nn(query_xyz, ref.xyz, max_dist)
        r = np.float32(max_dist)
        found = query_mask & (d2 <= float(r * r))
        best, won = reduce_winners(mesh, torch.where(found, d2, float("inf")),
                                   torch.cat([ref.xyz[idx], ref.normals[idx]], dim=-1))
        return won[:, 0:3], won[:, 3:6], best, torch.isfinite(best)

    def gather_fn(maps: voxel_map.VoxelMap) -> PointCloud:
        cloud = restack(mesh, maps).cloud
        return PointCloud(xyz=cloud.xyz.reshape(-1, 3), normals=cloud.normals.reshape(-1, 3),
                          mask=cloud.mask.reshape(-1))

    return empty_maps, insert_fn, nn_fn, gather_fn
