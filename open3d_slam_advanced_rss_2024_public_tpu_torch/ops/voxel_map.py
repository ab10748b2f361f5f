"""Persistent voxelized point map: an open-addressed voxel hash table.

Counterpart of the JAX package's ``ops/voxel_map.py`` (reference
Voxel.hpp:19-80, VoxelHashMap.hpp:25-98).  A fixed-capacity table keyed by
an exact 30-bit packed voxel key (``rel = key - origin + 512`` per axis,
a 1024-cell cube around the first insert's centroid); one int32 per slot
holds the packed key, INT32_MAX marks an empty slot.  Sums live in one
f32[C, 8] accumulator (sum_xyz | sum_normal | weight | pad), so fusing a
scan is one ``index_add_``; descriptor channels (intensity, colors; ≙
AggregatedVoxel::aggregateColor) sum in an optional f32[C, A] block with
the same weights and come out as means in the ``cloud`` view.

Differences from the JAX package, each kept to the same results:
  - the probing loop (``_assign_slots``) runs a fixed ``_MAX_ROUNDS``
    trips with a device-side active mask instead of a ``while_loop``, so
    the host never waits on the device;
  - ``_mix32`` (``ops/hashgrid.py``) multiplies in int64 and masks to 32
    bits (torch's uint32 support is partial);
  - the slot claim ``.at[].min(mode="drop")`` is ``scatter_reduce_("amin")``
    with dropped lanes sent to a scratch slot C;
  - the accumulation is ``index_add_``, atomic on CUDA: the order of the
    sums changes from run to run, so the means agree to rounding, not to
    the bit.
Every operation returns a new table (the Mapper keeps aliases of earlier
tables, as the JAX package's immutable arrays allow).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..utils.pointcloud import SENTINEL, PointCloud
from .hashgrid import _EMPTY, _mix32, pack_keys, voxel_key

Tensor = torch.Tensor

_WINDOW = 8          # probe slots examined per round
_MAX_ROUNDS = 16     # round budget (binds only on full tables)
_HALF = 512          # packing bias: rel coords in [0, 1024)


@dataclasses.dataclass(frozen=True)
class VoxelMap:
    ptable: Tensor   # int32[C] packed voxel key per slot (_EMPTY = free)
    origin: Tensor   # int32[3] packing origin (voxel coords)
    acc: Tensor      # f32[C, 8] = sum_xyz[3] | sum_normal[3] | weight | pad
    cell: Tensor     # f32 scalar voxel edge length (0 until first insert)
    dropped: Tensor  # f32 scalar — points lost to capacity/range overflow
    sum_attrs: Optional[Tensor] = None  # f32[C, A] descriptor sums
    attr_names: Tuple[str, ...] = ()

    @property
    def capacity(self) -> int:
        return self.ptable.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.ptable.device

    @property
    def occupied(self) -> Tensor:
        return self.ptable != _EMPTY

    def to(self, device) -> "VoxelMap":
        """A copy with every tensor on ``device``."""
        return dataclasses.replace(
            self, ptable=self.ptable.to(device), origin=self.origin.to(device),
            acc=self.acc.to(device), cell=self.cell.to(device), dropped=self.dropped.to(device),
            sum_attrs=None if self.sum_attrs is None else self.sum_attrs.to(device))

    @property
    def sum_xyz(self) -> Tensor:
        return self.acc[..., 0:3]

    @property
    def weight(self) -> Tensor:
        return self.acc[..., 6]

    def count(self) -> Tensor:
        return (self.occupied & (self.weight > 0.0)).sum(dtype=torch.int32)

    @property
    def cloud(self) -> PointCloud:
        """Voxel means as a fixed-capacity masked PointCloud."""
        m = self.occupied & (self.weight > 0.0)
        denom = torch.clamp(self.weight, min=1e-9)[..., None]
        xyz = torch.where(m[..., None], self.sum_xyz / denom, SENTINEL)
        nrm = self.acc[..., 3:6] / denom
        nlen = torch.linalg.vector_norm(nrm, dim=-1, keepdim=True)
        nrm = torch.where(m[..., None] & (nlen > 1e-6), nrm / (nlen + 1e-12), 0.0)
        attrs = None
        if self.sum_attrs is not None:
            attrs = torch.where(m[..., None], self.sum_attrs / denom, 0.0)
        return PointCloud(xyz=xyz, normals=nrm, mask=m, attrs=attrs,
                          attr_names=self.attr_names)


def _round_up_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def empty(capacity: int, device="cuda", attr_names: Tuple[str, ...] = ()) -> VoxelMap:
    """An empty table with capacity rounded up to a power of two, with
    descriptor sums for ``attr_names``."""
    C = _round_up_pow2(max(capacity, 2))
    return VoxelMap(
        ptable=torch.full((C,), _EMPTY, dtype=torch.int32, device=device),
        origin=torch.zeros((3,), dtype=torch.int32, device=device),
        acc=torch.zeros((C, 8), dtype=torch.float32, device=device),
        cell=torch.zeros((), dtype=torch.float32, device=device),
        dropped=torch.zeros((), dtype=torch.float32, device=device),
        sum_attrs=(torch.zeros((C, len(attr_names)), dtype=torch.float32, device=device)
                   if attr_names else None),
        attr_names=tuple(attr_names))


def _pack_keys(key: Tensor, origin: Tensor, ok: Tensor):
    """int32[..., 3] voxel coords -> (packed int32[...], in_range bool[...])."""
    return pack_keys(key, origin, ok, _HALF)


def _assign_slots(ptable: Tensor, pk: Tensor, ok: Tensor):
    """Resolve one table slot per scan point (or -1 on overflow).

    Windowed concurrent open addressing: per round, each still-active
    point gathers ``_WINDOW`` consecutive slots, takes the first holding
    its key, else claims the first empty one by a scatter-min of its key
    (the smallest key wins a contested slot; losers advance past it).
    Claims only target slots observed empty this round, so an occupied
    slot is never overwritten.  Fixed ``_MAX_ROUNDS`` trips: rounds after
    every point is assigned change nothing.
    """
    C = ptable.shape[0]
    dev = ptable.device
    base = (_mix32(pk) & (C - 1))
    span = torch.arange(_WINDOW, device=dev)
    assigned = torch.full_like(base, -1)
    # Slot C is scratch: claims of inactive lanes land there.
    pt = torch.cat([ptable, ptable.new_full((1,), _EMPTY)])
    for _ in range(_MAX_ROUNDS):
        active = (assigned < 0) & ok
        idx = (base[:, None] + span) & (C - 1)
        win = pt[idx]
        is_mine = win == pk[:, None]
        is_empty = win == _EMPTY
        any_mine, any_empty = is_mine.any(-1), is_empty.any(-1)
        mine_j = torch.argmax(is_mine.to(torch.uint8), dim=-1, keepdim=True)
        empty_j = torch.argmax(is_empty.to(torch.uint8), dim=-1, keepdim=True)
        mine_slot = torch.gather(idx, 1, mine_j)[:, 0]
        claim_slot = torch.gather(idx, 1, empty_j)[:, 0]
        assigned = torch.where(active & any_mine, mine_slot, assigned)
        want = active & ~any_mine & any_empty
        target = torch.where(want, claim_slot, C)
        pt = pt.scatter_reduce(0, target, pk, reduce="amin")
        got = want & (pt[claim_slot] == pk)
        assigned = torch.where(got, claim_slot, assigned)
        lost = want & ~got
        stuck = active & ~any_mine & ~any_empty
        base = torch.where(lost, base + empty_j[:, 0],
                           torch.where(stuck, base + _WINDOW, base))
    return pt[:C], assigned


def insert(vmap: VoxelMap, scan: PointCloud, voxel_size, weights: Tensor = None) -> VoxelMap:
    """Fuse a scan (already in map frame, [N] lanes) into the voxel map:
    exact weighted running means per voxel.  Descriptor channels fuse with
    the same weights; the map adopts the scan's channels on first contact
    and afterwards takes the scan's channels in the map's order (a scan
    that lacks one of them adds zeros), as the JAX package does."""
    C = vmap.capacity
    dev = vmap.device
    sum_attrs, attr_names = vmap.sum_attrs, vmap.attr_names
    if sum_attrs is None and scan.attrs is not None:
        sum_attrs = torch.zeros((C, scan.attrs.shape[-1]), dtype=torch.float32, device=dev)
        attr_names = scan.attr_names
    scan_attrs = None
    if sum_attrs is not None and scan.attrs is not None:
        if tuple(scan.attr_names) == tuple(attr_names):
            scan_attrs = scan.attrs
        elif all(k in scan.attr_names for k in attr_names):
            scan_attrs = scan.select(attr_names).attrs
    cell = (voxel_size.to(torch.float32) if isinstance(voxel_size, Tensor) else
            torch.full((), float(voxel_size), dtype=torch.float32, device=dev))
    w = (torch.ones((scan.capacity,), dtype=torch.float32, device=dev)
         if weights is None else weights.to(torch.float32))
    w = torch.where(scan.mask, w, 0.0)
    key = voxel_key(scan.xyz, cell)
    has_origin = vmap.occupied.any()
    nv = torch.clamp(scan.mask.sum(dtype=torch.float32), min=1.0)
    centroid = torch.where(scan.mask[:, None], scan.xyz, 0.0).sum(0) / nv
    origin = torch.where(has_origin, vmap.origin, voxel_key(centroid, cell))
    pk, ok = _pack_keys(key, origin, scan.mask)
    pt, assigned = _assign_slots(vmap.ptable, pk, ok)
    idx = torch.where(assigned >= 0, assigned, C)
    contrib = torch.cat([scan.xyz * w[:, None], scan.normals * w[:, None], w[:, None],
                         torch.zeros_like(w)[:, None]], dim=-1)
    acc = torch.cat([vmap.acc, vmap.acc.new_zeros((1, 8))])
    acc.index_add_(0, idx, contrib)
    if sum_attrs is not None:
        a = (scan_attrs * w[:, None] if scan_attrs is not None
             else w.new_zeros((scan.capacity, sum_attrs.shape[-1])))
        sum_attrs = torch.cat([sum_attrs, sum_attrs.new_zeros((1, sum_attrs.shape[-1]))])
        sum_attrs = sum_attrs.index_add_(0, idx, a)[:C]
    n_dropped = (scan.mask & (assigned < 0)).sum(dtype=torch.float32)
    return VoxelMap(ptable=pt, origin=origin, acc=acc[:C], cell=cell,
                    dropped=vmap.dropped + n_dropped, sum_attrs=sum_attrs,
                    attr_names=attr_names)


def from_cloud(template: VoxelMap, cloud: PointCloud, weights: Tensor,
               cell: Tensor) -> VoxelMap:
    """A fresh table (same capacity and channels as ``template``) holding a
    weighted point set — used to rebuild after an eviction or a rigid
    transform, which invalidates every stored voxel key."""
    fresh = empty(template.capacity, device=template.device, attr_names=template.attr_names)
    return insert(fresh, cloud, cell, weights=weights)


def _cell_or_one(vmap: VoxelMap) -> Tensor:
    """Guard the empty map (cell 0 would collapse every key to one voxel)."""
    return torch.where(vmap.cell > 0, vmap.cell, 1.0)


def transform(vmap: VoxelMap, T: Tensor) -> VoxelMap:
    """Rigidly move the whole map and rebuild the table: the transformed
    voxel means are re-inserted with their accumulated weights (≙
    Submap::transform, Submap.cpp:115-128)."""
    moved = vmap.cloud.transform(T.to(torch.float32))
    return from_cloud(vmap, moved, vmap.weight, _cell_or_one(vmap))


def transform_content(vmap: VoxelMap, T: Tensor) -> VoxelMap:
    """Rigidly move the map's CONTENT (the accumulated sums) without
    re-keying the table: elementwise over the accumulator.  ``cloud`` is
    then right in the new frame but the stored voxel KEYS are stale, so a
    further ``insert`` would bin by the old geometry: for CLOSED submaps on
    pose-graph feedback, with ``rekey`` before the submap is active again."""
    T = T.to(torch.float32)
    R, t = T[:3, :3], T[:3, 3]
    w = vmap.weight[..., None]
    acc = torch.cat([vmap.sum_xyz @ R.T + t * w, vmap.acc[..., 3:6] @ R.T,
                     vmap.acc[..., 6:]], dim=-1)
    return dataclasses.replace(vmap, acc=acc)


def rekey(vmap: VoxelMap) -> VoxelMap:
    """Rebuild the table's keys from the current voxel means (after
    ``transform_content``); keeps the cumulative drop counter."""
    out = from_cloud(vmap, vmap.cloud, vmap.weight, _cell_or_one(vmap))
    return dataclasses.replace(out, dropped=vmap.dropped)


def _rebuild_keeping(vmap: VoxelMap, keep: Tensor) -> VoxelMap:
    cloud = vmap.cloud
    survivors = PointCloud(xyz=torch.where(keep[:, None], cloud.xyz, SENTINEL),
                           normals=cloud.normals, mask=keep, attrs=cloud.attrs,
                           attr_names=cloud.attr_names)
    out = from_cloud(vmap, survivors, torch.where(keep, vmap.weight, 0.0),
                     _cell_or_one(vmap))
    # Preserve the cumulative drop counter (observability).
    return dataclasses.replace(out, dropped=vmap.dropped)


def _keep_first(order: Tensor, C: int, keep_n: int) -> Tensor:
    keep = torch.zeros((C,), dtype=torch.bool, device=order.device)
    keep[order[:keep_n]] = True
    return keep


def evict_low_weight(vmap: VoxelMap, keep_fraction: float = 0.75) -> VoxelMap:
    """Overflow policy: keep the ``keep_fraction`` highest-weight voxels
    and rebuild the table (see the JAX package's docstring for why weight
    is the default)."""
    C = vmap.capacity
    w = torch.where(vmap.occupied & (vmap.weight > 0.0), vmap.weight, -1.0)
    keep = _keep_first(torch.argsort(-w, stable=True), C, max(int(C * keep_fraction), 1))
    return _rebuild_keeping(vmap, keep & (w > 0.0))


def evict_far(vmap: VoxelMap, center: Tensor, keep_fraction: float = 0.75) -> VoxelMap:
    """Overflow policy: keep the ``keep_fraction`` voxels nearest to
    ``center`` (the current sensor position) and rebuild the table."""
    C = vmap.capacity
    occ = vmap.occupied & (vmap.weight > 0.0)
    mean = vmap.sum_xyz / torch.clamp(vmap.weight, min=1e-9)[..., None]
    d2 = ((mean - center.to(torch.float32)) ** 2).sum(-1)
    d2 = torch.where(occ, d2, float("inf"))
    keep = _keep_first(torch.argsort(d2, stable=True), C, max(int(C * keep_fraction), 1))
    return _rebuild_keeping(vmap, keep & occ)


def carve(vmap: VoxelMap, scan: PointCloud, sensor_origin: Tensor, carve_voxel_size,
          truncation_distance, max_ray_length, steps: int = 64) -> VoxelMap:
    """Ray-cast space carving: clear map voxels on the free-space segment
    of each scan ray (reference helpers.cpp:238-281 getIdxsOfCarvedPoints,
    Submap.cpp:130-157).  ``steps`` samples along every valid ray between
    the sensor and (hit distance - truncation), at fractions (i + 0.5) /
    steps; a voxel mean that falls in a sampled ``carve_voxel_size`` voxel
    is tombstoned: its key stays (probe windows stay intact) and its sums
    go to zero, so it accumulates again if observed again."""
    from .hashgrid import occupancy_lookup

    origin = sensor_origin.to(torch.float32)
    ray = torch.where(scan.mask[:, None], scan.xyz - origin, 0.0)
    hit_dist = torch.linalg.vector_norm(ray, dim=-1, keepdim=True)
    direction = ray / torch.clamp(hit_dist, min=1e-9)
    free_len = torch.clamp(hit_dist - truncation_distance, max=max_ray_length)
    frac = (torch.arange(steps, dtype=torch.float32, device=ray.device) + 0.5) / steps
    samples = origin + direction[:, None, :] * (frac[None, :, None] * free_len[:, None, :])
    sample_ok = scan.mask[:, None] & (free_len > 0).expand(-1, steps)
    means = vmap.cloud
    carved = occupancy_lookup(samples.reshape(-1, 3), sample_ok.reshape(-1), means.xyz,
                              means.mask, carve_voxel_size, table_size=1 << 16)
    return dataclasses.replace(
        vmap, acc=torch.where(carved[:, None], 0.0, vmap.acc),
        sum_attrs=None if vmap.sum_attrs is None
        else torch.where(carved[:, None], 0.0, vmap.sum_attrs))


def overlap_mask(vmap_grid, other: PointCloud) -> Tensor:
    """Mask of ``other``'s points that fall in occupied voxels of a hashed
    map grid (reference helpers.cpp:320-345
    computeIndicesOfOverlappingPoints)."""
    from .hashgrid import occupied_voxel_lookup

    return occupied_voxel_lookup(vmap_grid, other.xyz, other.mask)
