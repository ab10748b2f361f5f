"""The SLAM pipeline step on the device: preprocess -> map-patch crop ->
ICP -> fitness gate -> voxel fusion.

Counterpart of the JAX package's ``models/pipeline.py``.  There each entry
point is one jitted XLA program; here they are eager PyTorch functions
that enqueue their kernels on the current stream and never wait for the
device, so the Mapper can chain blocks without host round-trips.  The
``lax.scan`` over the K scans of a block is a Python loop, and its
``vmap`` a batch dimension.  Steps are functional (MapState in, MapState
out): no input table is modified.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..ops import voxel_map
from ..ops.registration import icp as icp_mod
from ..ops.registration.icp import ICPConfig, ICPResult
from ..utils import timing
from ..utils.device import to_device
from ..utils.pointcloud import PointCloud
from . import scan_processing

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Static configuration of the step (the JAX package's fields)."""

    icp: ICPConfig = dataclasses.field(default_factory=ICPConfig)
    scan_voxel_size: float = 0.1
    scan_capacity: int = 8192
    crop_min_radius: float = 0.7
    crop_max_radius: float = 30.0
    normal_knn: int = 10
    map_patch_capacity: int = 32768
    map_voxel_size: float = 0.1
    min_refinement_fitness: float = 0.3
    # "auto" -> radius-moments normals (kernel K2) on every device.
    normal_engine: str = "auto"
    min_movement_between_steps: float = 0.0
    block_ref_margin: float = 4.0
    shared_block_reference: bool = True


@dataclasses.dataclass(frozen=True)
class MapState:
    """Device-side pipeline state: the active map + pose bookkeeping."""

    map: voxel_map.VoxelMap
    pose: Tensor                 # f32[4,4] current map->sensor
    last_insertion_pose: Tensor  # f32[4,4]


@dataclasses.dataclass(frozen=True)
class StepOutput:
    """Per-scan outputs read back by the Mapper (stacked [K, ...] for a
    block): the ICP result, the preprocessed merge cloud in map frame,
    whether the insertion gate admitted it, the gated pose, and the
    table's occupied count and cumulative drop counter after insertion."""

    res: ICPResult
    merged: PointCloud
    inserted: Tensor
    pose: Tensor
    map_count: Tensor
    dropped: Tensor


def init_state(map_capacity: int, init_pose=None, device="cuda") -> MapState:
    """An empty table of ``map_capacity`` slots at ``init_pose`` (identity
    when None)."""
    T = (torch.eye(4, dtype=torch.float32, device=device) if init_pose is None
         else to_device(init_pose, device))
    return MapState(map=voxel_map.empty(map_capacity, device=device), pose=T,
                    last_insertion_pose=T.clone())


def make_state(vmap: voxel_map.VoxelMap, pose, last_insertion_pose) -> MapState:
    """Rebuild a chained device state from host truth (submap table + host
    poses).  Host poses go through pinned memory with a non-blocking copy:
    a pageable host-to-device copy makes torch synchronise the stream."""
    return MapState(map=vmap, pose=to_device(pose, vmap.device),
                    last_insertion_pose=to_device(last_insertion_pose, vmap.device))


def _preprocess(raw: PointCloud, cfg: PipelineConfig):
    wide = scan_processing.preprocess_scan(
        raw, wide_min_radius=cfg.crop_min_radius, wide_max_radius=cfg.crop_max_radius,
        voxel_size=cfg.scan_voxel_size, downsampling_ratio=1.0,
        capacity=cfg.scan_capacity, estimate_scan_normals=True,
        normal_knn=cfg.normal_knn, normal_engine=cfg.normal_engine)
    return wide, scan_processing.narrow_crop(wide, cfg.crop_min_radius, cfg.crop_max_radius)


def _gate(cfg: PipelineConfig, res: ICPResult, estimate_T: Tensor, empty_map: Tensor,
          last_ins: Tensor, insert_enable: Tensor):
    """Fitness gate (the empty first map trusts the estimate) and the
    min-motion x merge-suppression insertion gate."""
    use_icp = (res.match_ratio >= cfg.min_refinement_fitness) & ~empty_map
    T = torch.where(use_icp, res.transform, estimate_T)
    motion = torch.linalg.vector_norm(T[:3, 3] - last_ins[:3, 3])
    insert_ok = insert_enable & ((motion >= cfg.min_movement_between_steps) | empty_map)
    return T, insert_ok


def _poll_every(cfg: PipelineConfig) -> int:
    """Trips between the non-blocking looks at the ICP loop's done flag:
    ``register`` stops enqueuing trips once a look that has landed shows
    the loop converged, with the fixed-trip result.  The sharded matcher
    runs every trip on every rank, so it never polls."""
    return 0 if cfg.icp.matcher == "sharded" else icp_mod.POLL_EVERY


def _step(state: MapState, raw_scan: PointCloud, estimate_T: Tensor,
          cfg: PipelineConfig, insert_enable: Tensor):
    with timing.span("mapper/preprocess"):
        wide, match = _preprocess(raw_scan, cfg)
    with timing.span("mapper/reference"):
        _, grid = scan_processing.crop_submap_and_index(
            state.map.cloud, estimate_T[:3, 3], min_radius=0.0,
            max_radius=cfg.crop_max_radius, match_dist=cfg.icp.max_correspondence_dist,
            capacity=cfg.map_patch_capacity,
            build_hash=cfg.icp.matcher == "hashgrid")
    with timing.span("mapper/icp"):
        res = icp_mod.register(match, grid, estimate_T, cfg.icp,
                               poll_every=_poll_every(cfg))
        empty_map = state.map.count() == 0
        T, insert_ok = _gate(cfg, res, estimate_T, empty_map, state.last_insertion_pose,
                             insert_enable)
    with timing.span("mapper/insert"):
        merged = wide.transform(T)
        new_map = voxel_map.insert(state.map, merged.with_mask(merged.mask & insert_ok),
                                   cfg.map_voxel_size)
    new_state = MapState(map=new_map, pose=T,
                         last_insertion_pose=torch.where(insert_ok, T,
                                                         state.last_insertion_pose))
    return new_state, StepOutput(res=res, merged=merged, inserted=insert_ok, pose=T,
                                 map_count=new_map.count(), dropped=new_map.dropped)


def _as_bool(x, device) -> Tensor:
    if isinstance(x, Tensor):
        return x.to(device=device, dtype=torch.bool)
    return torch.full((), bool(x), dtype=torch.bool, device=device)


def mapper_step(state: MapState, raw_scan: PointCloud, estimate_T: Tensor,
                cfg: PipelineConfig, insert_enable=True) -> Tuple[MapState, StepOutput]:
    """One scan through the full pipeline."""
    return _step(state, raw_scan, estimate_T, cfg,
                 _as_bool(insert_enable, state.pose.device))


def mapper_step_delta(state: MapState, raw_scan: PointCloud, odom_delta: Tensor,
                      cfg: PipelineConfig, insert_enable=True) -> Tuple[MapState, StepOutput]:
    """``mapper_step`` with the initial guess composed on the device from
    the odometry motion: estimate = pose x delta (≙ Mapper.cpp:265-300), so
    that steps chain without reading the refined pose back."""
    return mapper_step(state, raw_scan, state.pose @ odom_delta, cfg, insert_enable)


def _stack_outputs(outs) -> StepOutput:
    return StepOutput(
        res=ICPResult(**{f.name: torch.stack([getattr(o.res, f.name) for o in outs])
                         for f in dataclasses.fields(ICPResult)}),
        merged=PointCloud(xyz=torch.stack([o.merged.xyz for o in outs]),
                          normals=torch.stack([o.merged.normals for o in outs]),
                          mask=torch.stack([o.merged.mask for o in outs])),
        inserted=torch.stack([o.inserted for o in outs]),
        pose=torch.stack([o.pose for o in outs]),
        map_count=torch.stack([o.map_count for o in outs]),
        dropped=torch.stack([o.dropped for o in outs]))


def mapper_step_block(state: MapState, scans: PointCloud, odom_deltas: Tensor,
                      insert_enables: Tensor,
                      cfg: PipelineConfig) -> Tuple[MapState, StepOutput]:
    """K chained scans (stacked [K, ...]) through ``_step`` in turn, with
    estimate = previous pose x odometry delta; outputs stacked [K, ...]."""
    outs = []
    for k in range(scans.xyz.shape[0]):
        scan_k = scans.map(lambda t: t[k])
        state, out = _step(state, scan_k, state.pose @ odom_deltas[k], cfg,
                           insert_enables[k])
        outs.append(out)
    return state, _stack_outputs(outs)


def _flat_block(merged: PointCloud, record_mask: Tensor) -> PointCloud:
    """[K, N] merged clouds -> one [K*N] cloud, masked per record."""
    K, N = merged.mask.shape
    flat = PointCloud(xyz=merged.xyz.reshape(K * N, 3),
                      normals=merged.normals.reshape(K * N, 3),
                      mask=merged.mask.reshape(K * N))
    return flat.with_mask(flat.mask & record_mask.repeat_interleave(N))


def chain_insert(state: MapState, cloud_map_frame: PointCloud, voxel_size) -> MapState:
    """Fuse an already registered map-frame cloud into the chained table
    without touching the pose chain."""
    return MapState(map=voxel_map.insert(state.map, cloud_map_frame, voxel_size),
                    pose=state.pose, last_insertion_pose=state.last_insertion_pose)


def chain_insert_block(state: MapState, merged_stacked: PointCloud,
                       record_mask: Tensor, voxel_size) -> MapState:
    """Fuse a whole block's merged clouds ([K, N] stacked step outputs,
    per-record enable mask bool[K]) into the chained table in one insert,
    without touching the pose chain (post-rollover tail records)."""
    return MapState(
        map=voxel_map.insert(state.map, _flat_block(merged_stacked, record_mask),
                             voxel_size),
        pose=state.pose, last_insertion_pose=state.last_insertion_pose)


def mapper_step_block_shared_ref(state: MapState, scans: PointCloud,
                                 odom_deltas: Tensor, insert_enables: Tensor,
                                 cfg: PipelineConfig) -> Tuple[MapState, StepOutput]:
    """``mapper_step_block`` with the two block-level restructurings of the
    JAX package (``pipeline.py:284-374``): preprocessing batched over the
    K scans (K2 runs once at [K, N]); the ICP reference (map-patch crop +
    Morton sort, and what the matcher prepares from it) built ONCE per block
    from the state at block start (≙ the reference's periodic reference
    re-init, Mapper.cpp:349-380), with ``block_ref_margin`` extra radius;
    and ONE fused insert for the block.  As in the JAX package, the first
    block after an empty map trusts the odometry estimates and inserts
    them."""
    with timing.span("mapper/preprocess"):
        wides, matches = _preprocess(scans, cfg)
    with timing.span("mapper/reference"):
        _, grid = scan_processing.crop_submap_and_index(
            state.map.cloud, state.pose[:3, 3], min_radius=0.0,
            max_radius=cfg.crop_max_radius + cfg.block_ref_margin,
            match_dist=cfg.icp.max_correspondence_dist,
            capacity=cfg.map_patch_capacity,
            build_hash=cfg.icp.matcher == "hashgrid")
        nn_ref = icp_mod.prepare_reference(cfg.icp, grid)
    empty_map = state.map.count() == 0
    pose, last_ins = state.pose, state.last_insertion_pose
    results, Ts, oks = [], [], []
    with timing.span("mapper/icp"):
        for k in range(scans.xyz.shape[0]):
            estimate_T = pose @ odom_deltas[k]
            res = icp_mod.register(matches.map(lambda t: t[k]), grid, estimate_T, cfg.icp,
                                   nn_ref, poll_every=_poll_every(cfg))
            pose, insert_ok = _gate(cfg, res, estimate_T, empty_map, last_ins,
                                    insert_enables[k])
            last_ins = torch.where(insert_ok, pose, last_ins)
            results.append(res)
            Ts.append(pose)
            oks.append(insert_ok)
    with timing.span("mapper/insert"):
        Ts, insert_oks = torch.stack(Ts), torch.stack(oks)
        mergeds = wides.transform(Ts)
        new_map = voxel_map.insert(state.map, _flat_block(mergeds, insert_oks),
                                   cfg.map_voxel_size)
    K = Ts.shape[0]
    outs = StepOutput(
        res=ICPResult(**{f.name: torch.stack([getattr(r, f.name) for r in results])
                         for f in dataclasses.fields(ICPResult)}),
        merged=mergeds, inserted=insert_oks, pose=Ts,
        map_count=new_map.count().expand(K), dropped=new_map.dropped.expand(K))
    return MapState(map=new_map, pose=pose, last_insertion_pose=last_ins), outs


def run_sequence(state: MapState, scans: PointCloud, odom_deltas: Tensor,
                 cfg: PipelineConfig) -> Tuple[MapState, Tensor]:
    """Scan-at-a-time loop: the stacked scans [S, ...] through ``_step``
    in turn, each from the previous pose x its odometry delta f32[S, 4, 4]
    (the JAX package's ``lax.scan``).  Returns the final state and the
    refined poses f32[S, 4, 4]."""
    enable = _as_bool(True, state.pose.device)
    poses = []
    for k in range(scans.xyz.shape[0]):
        state, _ = _step(state, scans.map(lambda t: t[k]), state.pose @ odom_deltas[k], cfg,
                         enable)
        poses.append(state.pose)
    return state, torch.stack(poses)
