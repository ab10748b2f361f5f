"""Voxel keys, Morton (Z-order) sorting, the voxel-hash matcher grid and
the hashed occupancy test.

Counterpart of the JAX package's ``ops/hashgrid.py``.  The brute-force and
kernel matchers only read a grid's points and normals, in Morton order so
that the NN kernel's tile bounding boxes stay tight (``passthrough``).  The
hashed grid (``build``) bins points into a power-of-two table by a
sort-based CSR construction (voxel key -> bucket -> stable argsort ->
per-bucket start and count); a query probes the 27 voxels around it and
reduces over up to ``max_per_bucket`` candidates of each bucket.  A hash
collision only adds real candidates; a candidate is missed only where its
bucket holds more than ``max_per_bucket`` points.

torch has no uint32 arithmetic: the spatial hash and the murmur finalizer
multiply in int64 and mask to 32 bits after every product, which gives
the bit pattern of the JAX package's uint32 products.  Counts go through
``index_add_`` into a fixed ``table_size + 1`` buffer (``bincount`` on
CUDA reads its maximum back to size its output).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..utils.device import to_device
from ..utils.pointcloud import PointCloud

Tensor = torch.Tensor


def voxel_key(xyz: Tensor, cell) -> Tensor:
    """Quantize positions to int32 voxel coordinates.

    The cell goes in as a device tensor: torch divides a CUDA tensor by a
    Python scalar as a multiplication by its reciprocal, which rounds
    differently from the float32 division the JAX package does and would
    move points that sit on a voxel boundary.
    """
    if not isinstance(cell, Tensor):
        cell = torch.full((), float(cell), dtype=torch.float32, device=xyz.device)
    return torch.floor(xyz / cell).to(torch.int32)


def _part1by2(x: Tensor) -> Tensor:
    """Spread the low 10 bits of x to every 3rd bit (Morton interleave —
    the standard public bit-dilation constants)."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def _interleave(k: Tensor) -> Tensor:
    return (_part1by2(k[..., 0]) << 2) | (_part1by2(k[..., 1]) << 1) | _part1by2(k[..., 2])


def morton_code(xyz: Tensor, mask: Tensor, cell) -> Tensor:
    """30-bit Morton code of each point's ``cell``-sized voxel, relative to
    the cloud's valid minimum corner (1024 cells per axis; coordinates
    clamp beyond).  Invalid lanes get code 2^30 and sort last."""
    key = voxel_key(xyz, cell)
    lo = torch.where(mask[..., None], key, 2 ** 30).amin(dim=-2, keepdim=True)
    code = _interleave(torch.clamp(key - lo, 0, 1023))
    return torch.where(mask, code, 1 << 30)


def morton_sort(cloud: PointCloud, cell) -> PointCloud:
    """Reorder a cloud by Morton code (valid points first, spatially
    coherent).  Stable, as ``jnp.argsort`` is: equal codes keep their
    order, so the tile layout matches the JAX package's."""
    code = morton_code(cloud.xyz, cloud.mask, cell)
    return cloud.take(torch.argsort(code, dim=-1, stable=True))


@dataclasses.dataclass(frozen=True)
class HashGrid:
    """Matcher reference set.  ``points``/``normals`` f32[N, 3]; ``perm``
    int32[N]; ``start``/``count`` are the CSR span fields of the hashed
    index, empty for a passthrough grid; ``cell`` f32 scalar."""

    points: Tensor
    normals: Tensor
    perm: Tensor
    start: Tensor
    count: Tensor
    cell: Tensor
    desc: Optional[Tensor] = None

    @property
    def capacity(self) -> int:
        return self.points.shape[0]

    @property
    def table_size(self) -> int:
        return self.start.shape[0]


def passthrough(cloud: PointCloud, cell_size, desc_channel: Optional[str] = None) -> HashGrid:
    """A HashGrid carrying the cloud in its ORIGINAL order with no CSR index
    (for the brute-force and kernel matchers).  ``desc_channel`` names the
    cloud's descriptor channel that the grid carries (the matched reference
    point's descriptor, which GenericDescriptorOutlierFilter reads)."""
    dev = cloud.device
    n = cloud.capacity
    return HashGrid(
        points=cloud.xyz,
        normals=cloud.normals,
        perm=torch.arange(n, dtype=torch.int32, device=dev),
        start=torch.zeros((1,), dtype=torch.int32, device=dev),
        count=torch.zeros((1,), dtype=torch.int32, device=dev),
        cell=torch.full((), float(cell_size), dtype=torch.float32, device=dev),
        desc=None if desc_channel is None else cloud.attr(desc_channel),
    )


_MASK32 = 0xFFFFFFFF
_EMPTY = 0x7FFFFFFF  # > any 30-bit packed key


def _mul32(h: Tensor, c: int) -> Tensor:
    """(h * c) mod 2^32 for h in [0, 2^32), without int64 overflow: the
    high 16 bits of c contribute only their product's low 16 bits."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def _mix32(h: Tensor) -> Tensor:
    """murmur3 finalizer on the uint32 bit pattern of int32 keys; returns
    int64 values in [0, 2^32).  torch has no uint32 arithmetic, so the
    products are masked to 32 bits in int64 and the shifts are logical
    because the values are non-negative."""
    h = h.to(torch.int64) & _MASK32
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def pack_keys(key: Tensor, origin: Tensor, ok: Tensor, half: int = 512):
    """int32[..., 3] voxel coords -> (packed int32[...], in_range bool[...]):
    an exact 30-bit key of the cell relative to ``origin``, ``_EMPTY``
    outside the +-``half``-cell cube or where ``ok`` is False."""
    rel = key - origin + half
    in_range = ok & ((rel >= 0) & (rel < 2 * half)).all(dim=-1)
    pk = (rel[..., 0] << 20) | (rel[..., 1] << 10) | rel[..., 2]
    return torch.where(in_range, pk, _EMPTY), in_range


def occupancy_lookup(ref_xyz: Tensor, ref_mask: Tensor, query_xyz: Tensor,
                     query_mask: Tensor, cell, table_size: int = 1 << 15) -> Tensor:
    """True when a query point's ``cell``-voxel contains any reference point.

    Each reference voxel is packed into an exact 30-bit key relative to the
    reference centroid and scatter-min'd into a ``table_size`` hash table;
    a query is one gather and a key comparison.  Two voxels colliding on a
    slot keep only the smaller key, so a colliding voxel can read as
    unoccupied (conservative for overlap restriction); queries beyond the
    +-512-cell cube also read unoccupied."""
    c = (cell.to(torch.float32) if isinstance(cell, Tensor) else
         torch.full((), float(cell), dtype=torch.float32, device=ref_xyz.device))
    nv = torch.clamp(ref_mask.sum(dtype=torch.float32), min=1.0)
    centroid = torch.where(ref_mask[:, None], ref_xyz, 0.0).sum(0) / nv
    origin = voxel_key(centroid, c)
    rpk, r_ok = pack_keys(voxel_key(ref_xyz, c), origin, ref_mask)
    h = _mix32(rpk) & (table_size - 1)
    # Slot ``table_size`` is scratch for the dropped lanes.
    table = torch.full((table_size + 1,), _EMPTY, dtype=torch.int32, device=ref_xyz.device)
    table = table.scatter_reduce(0, torch.where(r_ok, h, table_size), rpk, reduce="amin")
    qpk, q_ok = pack_keys(voxel_key(query_xyz, c), origin, query_mask)
    return q_ok & (table[_mix32(qpk) & (table_size - 1)] == qpk)


# Large primes of the 3D spatial hash (as the reference's EigenVec3iHash,
# VoxelHashMap.hpp:25-35), reduced to a power-of-two table by masking.
_P1, _P2, _P3 = 73856093, 19349669, 83492791


def hash_key(key: Tensor, table_size: int) -> Tensor:
    """int32[..., 3] voxel coords -> bucket id int64 in [0, table_size)."""
    k = key.to(torch.int64) & _MASK32
    h = _mul32(k[..., 0], _P1) ^ _mul32(k[..., 1], _P2) ^ _mul32(k[..., 2], _P3)
    return h & (table_size - 1)


def build(cloud: PointCloud, cell_size, table_size: int = 1 << 14,
          desc_channel: Optional[str] = None) -> HashGrid:
    """Build the index; ``table_size`` must be a power of two.  The argsort
    is stable, so the CSR layout equals the JAX package's."""
    if table_size & (table_size - 1):
        raise ValueError("table_size must be a power of 2")
    dev = cloud.device
    cell = torch.full((), float(cell_size), dtype=torch.float32, device=dev)
    # Invalid points go to a virtual bucket table_size, sorted to the end.
    bucket = torch.where(cloud.mask, hash_key(voxel_key(cloud.xyz, cell), table_size),
                         table_size)
    order = torch.argsort(bucket, stable=True)
    counts = torch.zeros(table_size + 1, dtype=torch.int32, device=dev).index_add_(
        0, bucket, torch.ones_like(bucket, dtype=torch.int32))[:table_size]
    start = torch.cumsum(counts, 0, dtype=torch.int32) - counts
    return HashGrid(points=cloud.xyz[order], normals=cloud.normals[order],
                    perm=order.to(torch.int32), start=start, count=counts, cell=cell,
                    desc=None if desc_channel is None else cloud.attr(desc_channel)[order])


# The 27-neighbourhood, centre first (a stable sort by L1 norm), so that at
# equal distances the own-voxel candidate wins, as in the JAX package.
_OFFSETS27 = sorted([(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
                     for dz in (-1, 0, 1)], key=lambda o: abs(o[0]) + abs(o[1]) + abs(o[2]))


def _offsets27(device) -> Tensor:
    return to_device(_OFFSETS27, device, dtype=torch.int32)


def _candidate_slots(grid: HashGrid, qkey: Tensor, max_per_bucket: int, offsets: Tensor):
    """Candidate slots of each query: (slots int64[M, 27 K], valid
    bool[M, 27 K]), indices into the grid's sorted arrays."""
    b = hash_key(qkey[:, None, :] + offsets[None], grid.table_size)   # [M, 27]
    s = grid.start[b].to(torch.int64)
    c = torch.clamp(grid.count[b], max=max_per_bucket)
    k = torch.arange(max_per_bucket, device=qkey.device)
    valid = k < c[..., None]
    slots = torch.where(valid, s[..., None] + k, 0)
    M = qkey.shape[0]
    return slots.reshape(M, -1), valid.reshape(M, -1)


# Query rows per chunk: bounds the candidate block to CHUNK x 27 K x 3.
_QUERY_CHUNK = 4096


def _chunked_over_rows(core, query_xyz: Tensor, query_mask: Tensor):
    """``core(xyz_block, mask_block)`` over row blocks of the queries, the
    outputs concatenated."""
    outs = [core(query_xyz[i:i + _QUERY_CHUNK], query_mask[i:i + _QUERY_CHUNK])
            for i in range(0, query_xyz.shape[0], _QUERY_CHUNK)]
    if len(outs) == 1:
        return outs[0]
    if isinstance(outs[0], Tensor):
        return torch.cat(outs)
    return tuple(torch.cat(parts) for parts in zip(*outs))


def _candidate_d2(grid: HashGrid, qxyz: Tensor, max_per_bucket: int, offsets: Tensor):
    slots, valid = _candidate_slots(grid, voxel_key(qxyz, grid.cell), max_per_bucket,
                                    offsets)
    d2 = ((grid.points[slots] - qxyz[:, None, :]) ** 2).sum(-1)
    return slots, valid, d2


def _sq(x, device) -> Tensor:
    """max_dist^2 in float32, as ``jnp.asarray(max_dist) ** 2`` forms it."""
    if not isinstance(x, Tensor):
        x = torch.full((), float(x), dtype=torch.float32, device=device)
    return x * x


def query_nn(grid: HashGrid, query_xyz: Tensor, query_mask: Tensor, max_dist,
             max_per_bucket: int = 32):
    """Nearest neighbour within max_dist of each query: (index int64[M]
    into the grid's sorted arrays, sq_dist f32[M], found bool[M]); the
    original point id is ``grid.perm[index]``.  Exact where cell >=
    max_dist and no probed bucket holds more than ``max_per_bucket``
    points (≙ libnabo knn=1 maxDist, MatchersImpl.cpp:118-133)."""
    r2, offsets = _sq(max_dist, query_xyz.device), _offsets27(query_xyz.device)

    def core(qxyz, qmask):
        slots, valid, d2 = _candidate_d2(grid, qxyz, max_per_bucket, offsets)
        d2 = torch.where(valid, d2, float("inf"))
        best = torch.argmin(d2, dim=-1, keepdim=True)
        best_d2 = torch.gather(d2, -1, best)[:, 0]
        return torch.gather(slots, -1, best)[:, 0], best_d2, qmask & (best_d2 <= r2)

    return _chunked_over_rows(core, query_xyz, query_mask)


def query_knn(grid: HashGrid, query_xyz: Tensor, query_mask: Tensor, max_dist,
              k: int = 8, max_per_bucket: int = 32):
    """k nearest neighbours within max_dist: (indices int64[M, k] into the
    sorted arrays, sq_dists f32[M, k] ascending, valid bool[M, k])."""
    r2, offsets = _sq(max_dist, query_xyz.device), _offsets27(query_xyz.device)

    def core(qxyz, qmask):
        slots, valid, d2 = _candidate_d2(grid, qxyz, max_per_bucket, offsets)
        kd2, top = torch.topk(torch.where(valid, d2, float("inf")), k, dim=-1,
                              largest=False, sorted=True)
        return torch.gather(slots, -1, top), kd2, qmask[:, None] & (kd2 <= r2)

    return _chunked_over_rows(core, query_xyz, query_mask)


def query_radius_count(grid: HashGrid, query_xyz: Tensor, query_mask: Tensor, radius,
                       max_per_bucket: int = 32) -> Tensor:
    """Number of grid points within ``radius`` of each query point."""
    r2, offsets = _sq(radius, query_xyz.device), _offsets27(query_xyz.device)

    def core(qxyz, qmask):
        _, valid, d2 = _candidate_d2(grid, qxyz, max_per_bucket, offsets)
        n = (valid & (d2 <= r2)).sum(-1, dtype=torch.int32)
        return torch.where(qmask, n, 0)

    return _chunked_over_rows(core, query_xyz, query_mask)


def occupied_voxel_lookup(grid: HashGrid, query_xyz: Tensor, query_mask: Tensor,
                          max_per_bucket: int = 16) -> Tensor:
    """True when the query point's own voxel holds a grid point (≙
    VoxelMap::hasVoxelContainingPoint): bucket candidates are verified by
    voxel key, so a hash collision never gives a false positive."""
    qkey = voxel_key(query_xyz, grid.cell)
    b = hash_key(qkey, grid.table_size)
    offs = torch.arange(max_per_bucket, device=query_xyz.device)
    slots = torch.clamp(grid.start[b].to(torch.int64)[:, None] + offs, 0,
                        grid.points.shape[0] - 1)
    in_bucket = offs < grid.count[b][:, None]
    same_voxel = (voxel_key(grid.points[slots], grid.cell) == qkey[:, None, :]).all(-1)
    return query_mask & (in_bucket & same_voxel).any(-1)
