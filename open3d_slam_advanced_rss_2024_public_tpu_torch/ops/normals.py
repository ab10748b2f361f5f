"""Surface normals via PCA over radius neighbourhoods.

Counterpart of the JAX package's ``ops/normals.py``:
``smallest_eigenvector_3x3`` (``:28-60``), ``estimate_normals_radius``
(``:94-120``), which gets the per-point count and covariance from kernel K2
(``ops/cuda_moments.py``), and the kNN engine ``estimate_normals``
(``:64-91``) that the submap feature clouds use.
"""
from __future__ import annotations

import math

import torch

from ..utils.device import to_device
from ..utils.pointcloud import PointCloud
from ..utils.se3 import det_3x3
from . import bruteforce, cuda_moments

Tensor = torch.Tensor


def smallest_eigenvector_3x3(C: Tensor):
    """Batched closed-form smallest eigenpair of symmetric 3x3 matrices:
    the trigonometric (Cardano) eigenvalues, then a cross-product
    eigenvector extraction.  Branch-free; the determinant is the closed
    form (``torch.linalg.det`` would run a batched LU).
    Returns (eigvec f32[..., 3], eigvals ascending f32[..., 3])."""
    q = (C[..., 0, 0] + C[..., 1, 1] + C[..., 2, 2]) / 3.0
    I = torch.eye(3, dtype=C.dtype, device=C.device)
    A = C - q[..., None, None] * I
    p2 = (A * A).sum(dim=(-2, -1)) / 6.0
    p = torch.sqrt(torch.clamp(p2, min=1e-20))
    B = A / p[..., None, None]
    phi = torch.arccos(torch.clamp(det_3x3(B) / 2.0, -1.0, 1.0)) / 3.0
    e1 = q + 2.0 * p * torch.cos(phi)
    e3 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    e2 = 3.0 * q - e1 - e3
    evals = torch.stack([e3, e2, e1], dim=-1)
    # Any nonzero column of (C - e1 I)(C - e2 I) spans the e3 eigenvector;
    # take the largest for stability.
    M = (C - e1[..., None, None] * I) @ (C - e2[..., None, None] * I)
    best = torch.argmax((M * M).sum(dim=-2), dim=-1)
    v = torch.gather(M, -1, best[..., None, None].expand(M.shape[:-1] + (1,)))[..., 0]
    vn = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    # Degenerate case (isotropic / planar-degenerate): fall back to z.
    fallback = torch.zeros_like(v)
    fallback[..., 2].fill_(1.0)
    v = torch.where(vn > 1e-12, v / (vn + 1e-20), fallback)
    return v, evals


def _orient_and_gate(cloud: PointCloud, n: Tensor, count: Tensor, sensor_origin,
                     min_neighbors: int) -> PointCloud:
    """Flip normals toward ``sensor_origin`` (default: the cloud frame
    origin) and zero those of points with fewer than ``min_neighbors``."""
    to_sensor = -cloud.xyz
    if sensor_origin is not None:
        to_sensor = to_sensor + to_device(sensor_origin, cloud.device)
    n = torch.where((n * to_sensor).sum(-1, keepdim=True) < 0, -n, n)
    good = cloud.mask & (count >= min_neighbors)
    return cloud.with_normals(torch.where(good[..., None], n, 0.0))


def estimate_normals_radius(cloud: PointCloud, radius, sensor_origin=None,
                            min_neighbors: int = 3) -> PointCloud:
    """PCA normals over the full r-ball (count and covariance from K2),
    oriented toward ``sensor_origin``.  Points with fewer than
    ``min_neighbors`` neighbours get zero normals.  Accepts a leading batch
    dimension."""
    count, C = cuda_moments.radius_moments(cloud.xyz, cloud.mask, radius)
    n, _ = smallest_eigenvector_3x3(C)
    return _orient_and_gate(cloud, n, count, sensor_origin, min_neighbors)


def estimate_normals(cloud: PointCloud, radius, k: int = 16, sensor_origin=None,
                     min_neighbors: int = 3) -> PointCloud:
    """PCA normals from up to k neighbours within ``radius`` (Open3D's
    hybrid search), oriented toward ``sensor_origin``.  One cloud [N] or a
    leading batch of them."""
    if cloud.mask.dim() == 2:
        from ..utils.pointcloud import stack

        return stack([estimate_normals(cloud.map(lambda t: t[b]), radius, k, sensor_origin,
                                       min_neighbors) for b in range(cloud.mask.shape[0])])
    idx, _, ok = bruteforce.knn(cloud.xyz, cloud.mask, cloud.xyz, radius, k=k)
    nbr = cloud.xyz[idx]
    w = ok.to(torch.float32)[..., None]
    cnt = w.sum(-2)
    mean = (nbr * w).sum(-2) / torch.clamp(cnt, min=1.0)
    d = (nbr - mean[:, None, :]) * w
    C = torch.einsum("nki,nkj->nij", d, d) / torch.clamp(cnt[..., None], min=1.0)
    n, _ = smallest_eigenvector_3x3(C)
    return _orient_and_gate(cloud, n, cnt[..., 0], sensor_origin, min_neighbors)
