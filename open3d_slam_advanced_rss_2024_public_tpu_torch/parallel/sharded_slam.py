"""End-to-end sharded SLAM step: the pipeline step over a mesh of ranks.

Counterpart of the JAX package's ``parallel/sharded_slam.py``.  The
single-device step (``models/pipeline.mapper_step``) runs preprocess ->
map-patch crop -> ICP -> fitness gate -> voxel fusion; this module runs the
same step with the map partitioned across the ranks:

  - map storage: spatial blocks owned by ranks (block hash mod D,
    ``sharded_map.block_owner``), one table a rank;
  - preprocessing: replicated (every rank preprocesses the same scan, with
    kernel K2 for the normals);
  - correspondence search: every rank searches the patch cropped from its
    own shard, with K1, inside the ICP loop; the winners reduce over the
    mesh (``ICPConfig(matcher="sharded")``: two ``pmin`` and one packed
    ``psum`` a trip), so every rank holds the same correspondences and
    solves the same 6x6 system;
  - gates: the map count is ``psum``-reduced before the empty-map gate,
    in the same all-reduce that hands every rank rank 0's ICP result;
  - insertion: the registered scan is owner-partitioned and fused
    rank-locally (no communication).

A scan therefore costs 3 collectives a trip plus two (the reference
centroid and the map count), the same on every rank and in the same order.
``init_distributed`` starts the process group the mesh is built on.
"""
from __future__ import annotations

import dataclasses
import datetime
import os

import torch
import torch.distributed as dist

from ..models import pipeline, scan_processing
from ..models.pipeline import PipelineConfig
from ..ops import voxel_map
from ..ops.registration import icp as icp_mod
from ..utils.device import resolve_device, to_device
from ..utils.pointcloud import PointCloud
from .mesh import Mesh, psum
from .sharded_map import insert_owned

Tensor = torch.Tensor

# Seconds a collective may wait for the other ranks before it fails.
DEFAULT_TIMEOUT_S = 300.0


def make_sharded_mapper(mesh: Mesh, cfg: PipelineConfig, capacity_per_device: int,
                        block_size: float = 8.0):
    """(empty_state_fn, step_fn) of the sharded mapper.

    step_fn(maps, last_insertion_pose, raw_scan, estimate_T)
        -> (maps', pose, match_ratio, last_insertion_pose')

    ``maps`` is this rank's table; the scan, the estimate and every pose
    are replicated.  Nothing waits for the device (on NCCL).
    """
    icp_cfg = dataclasses.replace(cfg.icp, matcher="sharded", shard_axis=mesh.axis)
    true = torch.ones((), dtype=torch.bool, device=mesh.device)

    def step_fn(maps: voxel_map.VoxelMap, last_insertion_pose, raw_scan: PointCloud,
                estimate_T):
        est = to_device(estimate_T, mesh.device)
        last_ins = to_device(last_insertion_pose, mesh.device)
        wide, match = pipeline._preprocess(raw_scan, cfg)
        # The shard's own patch around the estimate, Morton-sorted for K1.
        _, grid = scan_processing.crop_submap_and_index(
            maps.cloud, est[:3, 3], min_radius=0.0, max_radius=cfg.crop_max_radius,
            match_dist=icp_cfg.max_correspondence_dist, capacity=cfg.map_patch_capacity,
            build_hash=False)
        res = icp_mod.register(match, grid, est, icp_cfg)
        # One all-reduce: the map's total count (the empty-map gate) and rank
        # 0's ICP result, to which the other ranks add exact zeros.  Every
        # rank preprocesses the same scan, but on CUDA the results agree
        # only to rounding (``index_add_``'s atomic sums), and the pose must
        # be the same on every rank, bit for bit.
        mine = torch.cat([res.transform.reshape(16), res.match_ratio[None]])
        packed = psum(mesh, torch.cat([maps.count().to(torch.float32)[None],
                                       mine if mesh.rank == 0 else torch.zeros_like(mine)]))
        res = dataclasses.replace(res, transform=packed[1:17].reshape(4, 4),
                                  match_ratio=packed[17])
        empty_map = packed[0] == 0
        T, insert_ok = pipeline._gate(cfg, res, est, empty_map, last_ins, true)
        maps = insert_owned(mesh, maps, wide.transform(T), cfg.map_voxel_size, block_size,
                            insert_ok)
        return maps, T, res.match_ratio, torch.where(insert_ok, T, last_ins)

    def empty_state() -> voxel_map.VoxelMap:
        return voxel_map.empty(capacity_per_device, device=mesh.device)

    return empty_state, step_fn


def init_distributed(coordinator_address: str = None, num_processes: int = None,
                     process_id: int = None, device=None, backend: str = None,
                     timeout: float = DEFAULT_TIMEOUT_S) -> None:
    """Start the default process group that ``make_mesh`` builds on: one
    rank per device.

        init_distributed()                            # torchrun's environment,
                                                      # or a world of one
        init_distributed("10.0.0.1:1234", 4, i)       # explicit coordinator
        init_distributed("file:///tmp/store", 4, i)   # a shared-file store

    The backend follows the device (``cuda`` unless the caller asks for the
    CPU): NCCL on CUDA, gloo on the CPU; ``backend="gloo"`` runs several
    ranks on one card, which NCCL refuses.  On CUDA the rank binds to the
    card of its local rank.  ``timeout`` bounds every collective, so that
    ranks that disagree on the collectives fail instead of hanging.  With
    neither an address nor torchrun's environment the world is this one
    process on a local store.  A no-op when a group exists; any error of
    the initialisation propagates.
    """
    if dist.is_initialized():
        return
    dev = resolve_device(device)
    kwargs = dict(backend=backend or ("nccl" if dev.type == "cuda" else "gloo"),
                  timeout=datetime.timedelta(seconds=timeout))
    if coordinator_address is not None or num_processes is not None:
        if None in (coordinator_address, num_processes, process_id):
            raise ValueError("an explicit coordinator needs coordinator_address, "
                             "num_processes and process_id")
        url = (coordinator_address if "://" in coordinator_address
               else f"tcp://{coordinator_address}")
        local = process_id
        kwargs.update(init_method=url, world_size=num_processes, rank=process_id)
    elif "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        local = int(os.environ.get("LOCAL_RANK", os.environ["RANK"]))
        kwargs.update(init_method="env://")
    else:
        local = 0
        kwargs.update(store=dist.HashStore(), world_size=1, rank=0)
    if dev.type == "cuda":
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(**kwargs)
