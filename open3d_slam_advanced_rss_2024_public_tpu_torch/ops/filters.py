"""Point-cloud filters as fixed-shape tensor transforms.

Counterpart of the JAX package's ``ops/filters.py``: non-finite removal
and the Morton-ordered voxel down-sampling of the hot path
(``voxel_downsample(order="morton")``, ``filters.py:79-159``).  All
filters preserve capacity; "removal" = masking.  Every function takes
leading batch dimensions (the K scans of a lag block).
"""
from __future__ import annotations

import torch

from ..utils.pointcloud import SENTINEL, PointCloud, compact, gather_lanes, gather_rows
from .hashgrid import _interleave, voxel_key

Tensor = torch.Tensor


def remove_non_finite(cloud: PointCloud) -> PointCloud:
    return cloud.with_mask(torch.isfinite(cloud.xyz).all(dim=-1))


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

    Exact up to 2^20 cells per axis: the 30-bit code of the low 10 bits of
    each relative cell coordinate sorts first; where a cloud spans 1024
    cells or more, a second stable sort on the code of the high bits runs
    coarse-major.  The JAX package takes that branch with ``lax.cond``; the
    port computes both orders and selects per batch row on the device, so
    no host branch (and no synchronisation) is needed.
    """
    if order not in ("lex", "morton"):
        raise ValueError(f"unknown voxel order: {order!r}")
    if cloud.attrs is not None:
        raise NotImplementedError(
            "descriptor channels are not ported yet (ROADMAP §1, slice 3)")
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
    sums = _segment_sum(torch.cat([gather_rows(cloud.xyz, order_idx) * w,
                                   gather_rows(cloud.normals, order_idx) * w, w], -1),
                        seg, n)
    cnt = sums[..., 6]
    denom = torch.clamp(cnt, min=1.0)[..., None]
    mean_xyz = sums[..., 0:3] / denom
    mean_nrm = sums[..., 3:6] / denom
    nrm_len = torch.linalg.vector_norm(mean_nrm, dim=-1, keepdim=True)
    mean_nrm = torch.where(nrm_len > 1e-6, mean_nrm / (nrm_len + 1e-12), 0.0)
    seg_valid = cnt > 0
    out = PointCloud(xyz=torch.where(seg_valid[..., None], mean_xyz, SENTINEL),
                     normals=torch.where(seg_valid[..., None], mean_nrm, 0.0),
                     mask=seg_valid)
    out = compact(out, capacity)
    return out if batched else out.map(lambda t: t[0])
