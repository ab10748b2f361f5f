"""Point-cloud filters as fixed-shape tensor transforms.

Counterpart of the JAX package's ``ops/filters.py`` (reference
helpers.cpp:117-192 and :404, libpointmatcher's VoxelGrid, RandomSampling,
MaxPointCount, RemoveNaN, MaxDist/MinDist/BoundingBox/DistanceLimit
DataPointsFilters): non-finite removal, distance and box limits, random
sampling, the voxel down-sampling (Morton-ordered on the hot path,
``filters.py:79-159``, or lexicographic) with descriptor channels averaged
like positions, and per-voxel de-duplication.  All filters preserve
capacity; "removal" = masking.  ``remove_non_finite`` and
``voxel_downsample`` take leading batch dimensions (the K scans of a lag
block).

The random filters take their uniform draws as an argument (``u``,
f32[N] in [0, 1)): ``uniform`` draws them on the host from an explicit
generator and sends them up in one pinned copy, so that a seed gives the
same draws on the card and on the CPU.  The JAX package draws from
``jax.random`` on the device, whose bits torch cannot reproduce; the
arithmetic after the draws is the same (tests feed it JAX's draws).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..utils.device import to_device
from ..utils.pointcloud import SENTINEL, PointCloud, compact, gather_lanes, gather_rows
from .hashgrid import _interleave, voxel_key

Tensor = torch.Tensor


def fold_in(seed: int, data: int) -> int:
    """A seed derived from ``seed`` and ``data`` (the role of
    ``jax.random.fold_in``: one independent stream per filter of a
    pipeline)."""
    return int(np.random.SeedSequence([seed, data]).generate_state(1, np.uint64)[0] >> 1)


def uniform(seed: int, n: int, device) -> Tensor:
    """``n`` uniforms in [0, 1) drawn on the host from a generator seeded
    with ``seed``, on ``device`` through one pinned copy (no stream
    synchronisation)."""
    return to_device(torch.rand(n, generator=torch.Generator().manual_seed(seed)), device)


def norm3(v: Tensor) -> Tensor:
    """|v| over the last axis of size 3, summed in the order XLA sums
    ``jnp.linalg.norm``'s squares, so that thresholds cut where JAX cuts."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return torch.sqrt((x * x + y * y) + z * z)


def remove_non_finite(cloud: PointCloud) -> PointCloud:
    return cloud.with_mask(torch.isfinite(cloud.xyz).all(dim=-1))


def distance_limit(cloud: PointCloud, min_dist=0.0, max_dist=math.inf) -> PointCloud:
    r = norm3(torch.where(cloud.mask[..., None], cloud.xyz, 0.0))
    return cloud.with_mask((r >= min_dist) & (r <= max_dist))


def bounding_box(cloud: PointCloud, lo, hi, invert: bool = False) -> PointCloud:
    """Keep the points inside the box [lo, hi] (host sequences of three),
    or outside it with ``invert``."""
    lo = np.asarray(lo, np.float32).tolist()
    hi = np.asarray(hi, np.float32).tolist()
    inside = torch.ones_like(cloud.mask)
    for a in range(3):
        inside = inside & (cloud.xyz[..., a] >= lo[a]) & (cloud.xyz[..., a] <= hi[a])
    return cloud.with_mask(~inside if invert else inside)


def random_sampling(cloud: PointCloud, u: Tensor, prob: float) -> PointCloud:
    """Keep each valid point independently with probability ``prob``
    (``u``: one uniform draw a lane)."""
    return cloud.with_mask(u < prob)


def max_point_count(cloud: PointCloud, u: Tensor, max_count: int) -> PointCloud:
    """Random subsample down to at most ``max_count`` valid points (the
    reference MaxPointCountDataPointsFilter: random, not truncation); the
    ``max_count`` valid lanes of smallest draw stay."""
    priority = torch.where(cloud.mask, u, math.inf)
    order = torch.argsort(priority, stable=True)
    keep = torch.zeros_like(cloud.mask).scatter(0, order[:max_count], True)
    return cloud.with_mask(keep)


def _segment_sum(values: Tensor, seg: Tensor, n: int) -> Tensor:
    """Per-row segment sums: values [B, N, C], seg [B, N] in [0, n)."""
    B, N, C = values.shape
    flat = (seg + torch.arange(B, device=seg.device)[:, None] * n).reshape(-1)
    out = values.new_zeros((B * n, C))
    out.index_add_(0, flat, values.reshape(-1, C))
    return out.reshape(B, n, C)


def voxel_downsample(cloud: PointCloud, voxel_size, capacity: int,
                     order: str = "morton") -> PointCloud:
    """Voxel-grid down-sampling with per-voxel averaging of position+normal.

    ``order="lex"`` (what the submap features ask for): exact
    lexicographic grouping by three stable sorts on the voxel key.
    ``order="morton"`` (the default here, what the scan path asks for):
    grouped AND sorted by the hierarchical Morton code of the voxel, so the
    output comes out in Z-order (the NN kernel's tiles stay compact).

    Descriptor channels average like positions.  Exact up to 2^20 cells
    per axis: the 30-bit code of the low 10 bits of
    each relative cell coordinate sorts first; where a cloud spans 1024
    cells or more, a second stable sort on the code of the high bits runs
    coarse-major.  The JAX package takes that branch with ``lax.cond``; the
    port computes both orders and selects per batch row on the device, so
    no host branch (and no synchronisation) is needed.
    """
    if order not in ("lex", "morton"):
        raise ValueError(f"unknown voxel order: {order!r}")
    batched = cloud.mask.dim() == 2
    if not batched:
        cloud = cloud.map(lambda t: t[None])
    n = cloud.capacity
    big = 2 ** 30
    mask = cloud.mask
    vkey = torch.where(mask[..., None], voxel_key(cloud.xyz, voxel_size), big)
    if order == "lex":
        order_idx = torch.arange(n, device=mask.device).expand(mask.shape)
        for axis in (2, 1, 0):
            o = torch.argsort(torch.gather(vkey[..., axis], -1, order_idx), dim=-1,
                              stable=True)
            order_idx = torch.gather(order_idx, -1, o)
        return _average_sorted(cloud, vkey, order_idx, capacity, batched)
    lo_corner = torch.where(mask[..., None], vkey, big).amin(dim=-2, keepdim=True)
    k = torch.where(mask[..., None], vkey - lo_corner, 0)
    k_lo, k_hi = k & 1023, torch.clamp(k >> 10, 0, 1023)
    code_lo = torch.where(mask, _interleave(k_lo), 1 << 30)
    code_hi = torch.where(mask, _interleave(k_hi), 1 << 30)
    o1 = torch.argsort(code_lo, dim=-1, stable=True)
    o2 = torch.gather(o1, -1, torch.argsort(torch.gather(code_hi, -1, o1),
                                            dim=-1, stable=True))
    span_ok = torch.where(mask[..., None], k, 0).amax(dim=(-2, -1)) < 1024
    order_idx = torch.where(span_ok[:, None], o1, o2)
    return _average_sorted(cloud, vkey, order_idx, capacity, batched)


def _average_sorted(cloud: PointCloud, vkey: Tensor, order_idx: Tensor, capacity: int,
                    batched: bool) -> PointCloud:
    """Per-voxel means of a [B, N] cloud whose lanes ``order_idx`` sorts so
    that equal voxel keys are adjacent; compacted to ``capacity``."""
    n = cloud.capacity
    big = 2 ** 30
    mask = cloud.mask
    smask = gather_lanes(mask, order_idx)
    sk = torch.where(smask[..., None], gather_rows(vkey, order_idx), big)
    new_seg = (sk != torch.roll(sk, 1, dims=-2)).any(dim=-1)
    new_seg[:, 0].fill_(True)
    seg = torch.cumsum(new_seg.to(torch.int32), dim=-1) - 1
    w = smask.to(torch.float32)[..., None]
    cols = [gather_rows(cloud.xyz, order_idx) * w, gather_rows(cloud.normals, order_idx) * w, w]
    if cloud.attrs is not None:
        cols.append(gather_rows(cloud.attrs, order_idx) * w)
    sums = _segment_sum(torch.cat(cols, -1), seg, n)
    cnt = sums[..., 6]
    denom = torch.clamp(cnt, min=1.0)[..., None]
    mean_xyz = sums[..., 0:3] / denom
    mean_nrm = sums[..., 3:6] / denom
    nrm_len = torch.linalg.vector_norm(mean_nrm, dim=-1, keepdim=True)
    mean_nrm = torch.where(nrm_len > 1e-6, mean_nrm / (nrm_len + 1e-12), 0.0)
    seg_valid = cnt > 0
    mean_attrs = None
    if cloud.attrs is not None:
        mean_attrs = torch.where(seg_valid[..., None], sums[..., 7:] / denom, 0.0)
    out = PointCloud(xyz=torch.where(seg_valid[..., None], mean_xyz, SENTINEL),
                     normals=torch.where(seg_valid[..., None], mean_nrm, 0.0),
                     mask=seg_valid, attrs=mean_attrs,
                     attr_names=cloud.attr_names if mean_attrs is not None else ())
    out = compact(out, capacity)
    return out if batched else out.map(lambda t: t[0])


def _lex_order(vkey: Tensor) -> Tensor:
    """Stable lexicographic order of the [N, 3] voxel keys (three stable
    sorts, last axis first)."""
    order = torch.arange(vkey.shape[0], device=vkey.device)
    for axis in (2, 1, 0):
        order = order[torch.argsort(vkey[order, axis], stable=True)]
    return order


def voxel_downsample_within_volume(cloud: PointCloud, voxel_size, volume_mask: Tensor,
                                   capacity: int) -> PointCloud:
    """Voxelize only the points inside ``volume_mask`` and drop the rest
    (≙ voxelizeWithinCroppingVolume, reference helpers.cpp:117-192);
    lexicographic grouping, the JAX package's default."""
    return voxel_downsample(cloud.with_mask(volume_mask), voxel_size, capacity, order="lex")


def remove_duplicate_points_in_voxels(cloud: PointCloud, voxel_size) -> PointCloud:
    """Keep only the first valid point of each occupied voxel, mask only
    (≙ removeDuplicatePointsWithinSameVoxels, reference Voxel.cpp)."""
    vkey = torch.where(cloud.mask[:, None], voxel_key(cloud.xyz, voxel_size), 2 ** 30)
    order = _lex_order(vkey)
    sk = vkey[order]
    first = (sk != torch.roll(sk, 1, dims=0)).any(dim=-1)
    first[0].fill_(True)
    keep = torch.zeros_like(cloud.mask).scatter(0, order, first)
    return cloud.with_mask(keep)
