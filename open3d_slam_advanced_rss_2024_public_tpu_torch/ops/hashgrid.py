"""Voxel keys, Morton (Z-order) sorting, the passthrough matcher grid and
the hashed occupancy test.

Counterpart of the JAX package's ``ops/hashgrid.py`` (``:46-146``,
``:321-370``).  The brute-force and kernel matchers only read a grid's
points and normals, in Morton order so that the NN kernel's tile bounding
boxes stay tight; the sort-based CSR voxel-hash index
(``build``/``query_nn``) is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

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


def passthrough(cloud: PointCloud, cell_size) -> HashGrid:
    """A HashGrid carrying the cloud in its ORIGINAL order with no CSR index
    (for the brute-force and kernel matchers)."""
    dev = cloud.device
    n = cloud.capacity
    return HashGrid(
        points=cloud.xyz,
        normals=cloud.normals,
        perm=torch.arange(n, dtype=torch.int32, device=dev),
        start=torch.zeros((1,), dtype=torch.int32, device=dev),
        count=torch.zeros((1,), dtype=torch.int32, device=dev),
        cell=torch.full((), float(cell_size), dtype=torch.float32, device=dev),
    )


def build(*args, **kwargs):
    raise NotImplementedError(
        "the hashed CSR grid is not ported yet (ROADMAP §1 item 12: "
        "hashgrid.build/query_nn)")


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
