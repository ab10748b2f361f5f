"""FPFH descriptors as batched, fixed-shape tensor operations.

Counterpart of the JAX package's ``ops/fpfh.py`` (reference Submap.cpp:255-275:
FPFH on a voxel-downsampled, normal-estimated copy of the submap; consumed
by RANSAC matching in PlaceRecognition.cpp:79-85).

Classic Rusu FPFH: per-point SPFH = 3 x 11-bin histograms of the Darboux
angles (alpha, phi, theta) over neighbours, then FPFH(p) = SPFH(p) +
(1/k) * sum_j SPFH(j) / d(p, j).  The histograms are ``scatter_add_`` of the
validity weights at the bin indices; no per-point loops.
"""
from __future__ import annotations

import math

import torch

from ..utils.pointcloud import PointCloud
from . import bruteforce

Tensor = torch.Tensor

N_BINS = 11
FEATURE_DIM = 3 * N_BINS  # 33


def _hist(x: Tensor, valid: Tensor, lo: float, hi: float) -> Tensor:
    """[N, K] values -> [N, N_BINS] counts of the valid ones.  The bin index
    truncates toward zero, as the JAX package's ``astype(int32)`` does."""
    bins = torch.clamp(((x - lo) / (hi - lo) * N_BINS).to(torch.int32), 0, N_BINS - 1)
    out = x.new_zeros((x.shape[0], N_BINS))
    return out.scatter_add_(1, bins.long(), valid.to(x.dtype))


def _spfh(xyz: Tensor, nrm: Tensor, nbr_xyz: Tensor, nbr_nrm: Tensor, valid: Tensor) -> Tensor:
    """Per-point SPFH histograms.  xyz/nrm: [N, 3]; nbr_*: [N, K, 3]."""
    d = nbr_xyz - xyz[:, None, :]
    dist = torch.linalg.vector_norm(d, dim=-1)
    valid = valid & (dist > 1e-9)
    u = nrm[:, None, :].expand_as(d)  # source normal
    du = d / torch.clamp(dist[..., None], min=1e-9)
    # Darboux frame: u, v = du x u, w = u x v.
    v = torch.linalg.cross(du, u)
    v = v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-9)
    w = torch.linalg.cross(u, v)
    alpha = (v * nbr_nrm).sum(-1)
    phi = (u * du).sum(-1)
    theta = torch.arctan2((w * nbr_nrm).sum(-1), (u * nbr_nrm).sum(-1))
    h = torch.cat([_hist(alpha, valid, -1.0, 1.0), _hist(phi, valid, -1.0, 1.0),
                   _hist(theta, valid, -math.pi, math.pi)], dim=-1)
    cnt = torch.clamp(valid.sum(-1, keepdim=True, dtype=torch.float32), min=1.0)
    return h * (100.0 / cnt)  # percentage normalization (Open3D convention)


def fpfh_from_neighbors(cloud: PointCloud, idx: Tensor, d2: Tensor, ok: Tensor) -> Tensor:
    """FPFH features f32[N, 33] from a given neighbour set (``idx`` [N, K]
    into the cloud, their squared distances and validity)."""
    spfh = _spfh(cloud.xyz, cloud.normals, cloud.xyz[idx], cloud.normals[idx], ok)
    dist = torch.sqrt(torch.clamp(d2, min=1e-12))
    w = torch.where(ok & ~(dist < 1e-6), 1.0 / torch.clamp(dist, min=1e-6), 0.0)
    kcnt = torch.clamp((w > 0).sum(-1, keepdim=True, dtype=torch.float32), min=1.0)
    fpfh = spfh + (spfh[idx] * w[..., None]).sum(1) / kcnt
    return torch.where(cloud.mask[:, None], fpfh, 0.0)


def compute_fpfh(cloud: PointCloud, radius, k: int = 32) -> Tensor:
    """FPFH features f32[N, 33] for every valid point (zeros for invalid).
    ``radius``/``k`` mirror KDTreeSearchParamHybrid(feature_radius,
    feature_knn) in the reference (Submap.cpp:270-274)."""
    idx, d2, ok = bruteforce.knn_approx(cloud.xyz, cloud.mask, cloud.xyz, radius, k=k)
    return fpfh_from_neighbors(cloud, idx, d2, ok)


def feature_distance_matrix(fa: Tensor, fb: Tensor) -> Tensor:
    """Pairwise squared L2 distances between feature sets, one matrix
    product.  fa: [N, 33], fb: [M, 33] -> [N, M]."""
    a2 = (fa * fa).sum(-1, keepdim=True)
    b2 = (fb * fb).sum(-1, keepdim=True).T
    return torch.clamp(a2 + b2 - 2.0 * (fa @ fb.T), min=0.0)


def mutual_nearest_correspondences(fa: Tensor, mask_a: Tensor, fb: Tensor, mask_b: Tensor):
    """Mutual nearest-neighbour matches in feature space.  Returns
    (idx_b_for_a int64[N], mutual bool[N]): the a->b assignment and whether
    it is reciprocal (Open3D's RANSAC correspondence seeding)."""
    big = 3.0e38
    d = feature_distance_matrix(fa, fb)
    d = torch.where(mask_a[:, None], d, big)
    d = torch.where(mask_b[None, :], d, big)
    ab = torch.argmin(d, dim=1)
    ba = torch.argmin(d, dim=0)
    mutual = ba[ab] == torch.arange(fa.shape[0], device=fa.device)
    return ab, mask_a & mutual & mask_b[ab]
