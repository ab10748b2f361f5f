"""Surface normals via PCA over radius neighbourhoods.

Counterpart of the JAX package's ``ops/normals.py``:
``smallest_eigenvector_3x3`` (``:28-60``), ``estimate_normals_radius``
(``:94-120``), which gets the per-point count and covariance from kernel K2
(``ops/cuda_moments.py``), the kNN engine ``estimate_normals``
(``:64-91``) that the submap feature clouds use, the local-PCA
``surface_descriptors`` (``:124``) and the range-image window normals
``organized_surface_normals`` (``:150``).  ``eigh_3x3`` is the full
symmetric eigensystem by a fixed number of Jacobi sweeps, where the JAX
package calls ``jnp.linalg.eigh``: on CUDA, ``torch.linalg.eigh`` reads
its ``info`` back and synchronises.
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


# Constant 3 x 3 patterns of the Jacobi rotation in the (p, q) plane:
# J = I + (c - 1) D + s S, D = e_p e_p^T + e_q e_q^T, S = e_p e_q^T - e_q e_p^T.
_PAIRS = ((0, 1), (0, 2), (1, 2))
_SWEEPS = 6


def eigh_3x3(C: Tensor, sweeps: int = _SWEEPS):
    """Eigenvalues (ascending) and eigenvectors (columns) of batched
    symmetric 3 x 3 matrices: cyclic Jacobi, ``sweeps`` x 3 rotations, no
    data-dependent control flow (so no host synchronisation).  Six sweeps
    bring the off-diagonal of a float32 matrix to rounding.  The sign of
    each eigenvector is chosen so that its largest-magnitude component is
    positive (LAPACK's sign, which ``jnp.linalg.eigh`` returns, follows no
    rule a caller can rely on)."""
    dt, dev = C.dtype, C.device
    eye = torch.eye(3, dtype=dt, device=dev)
    A = C.clone()
    V = eye.expand(C.shape).clone()
    # The patterns are host constants, sent up through one pinned copy.
    host = torch.zeros((len(_PAIRS), 2, 3, 3), dtype=dt)
    for i, (p, q) in enumerate(_PAIRS):
        host[i, 0, p, p] = host[i, 0, q, q] = 1.0
        host[i, 1, p, q], host[i, 1, q, p] = 1.0, -1.0
    pat = to_device(host, dev, dtype=dt)
    pats = [(p, q, pat[i, 0], pat[i, 1]) for i, (p, q) in enumerate(_PAIRS)]
    for _ in range(sweeps):
        for p, q, D, S in pats:
            apq = A[..., p, q]
            tiny = apq.abs() <= 1e-30
            theta = (A[..., q, q] - A[..., p, p]) / (2.0 * torch.where(tiny, 1.0, apq))
            sgn = torch.where(theta >= 0, 1.0, -1.0)
            t = sgn / (theta.abs() + torch.sqrt(theta * theta + 1.0))
            t = torch.where(tiny, 0.0, t)
            c = torch.rsqrt(t * t + 1.0)
            J = eye + (c - 1.0)[..., None, None] * D + (t * c)[..., None, None] * S
            A = J.transpose(-1, -2) @ A @ J
            V = V @ J
    evals, order = torch.sort(torch.diagonal(A, dim1=-2, dim2=-1), dim=-1)
    V = torch.gather(V, -1, order[..., None, :].expand(V.shape))
    lead = torch.gather(V, -2, V.abs().argmax(dim=-2, keepdim=True))
    return evals, V * torch.where(lead < 0, -1.0, 1.0)


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


def surface_descriptors(cloud: PointCloud, radius, k: int = 16) -> Tensor:
    """Linearity / planarity / curvature from the local PCA of up to ``k``
    neighbours within ``radius`` (reference SurfaceNormalEstimatorPCA.cpp
    descriptors).  Returns f32[N, 3]."""
    idx, _, ok = bruteforce.knn(cloud.xyz, cloud.mask, cloud.xyz, radius, k=k)
    nbr = cloud.xyz[idx]
    w = ok.to(torch.float32)[..., None]
    cnt = w.sum(-2)
    mean = (nbr * w).sum(-2) / torch.clamp(cnt, min=1.0)
    d = (nbr - mean[:, None, :]) * w
    C = torch.einsum("nki,nkj->nij", d, d) / torch.clamp(cnt[..., None], min=1.0)
    _, evals = smallest_eigenvector_3x3(C)
    e0, e1, e2 = evals[..., 0], evals[..., 1], evals[..., 2]
    safe = torch.clamp(e2, min=1e-12)
    out = torch.stack([(e2 - e1) / safe, (e1 - e0) / safe,
                       e0 / torch.clamp(e0 + e1 + e2, min=1e-12)], dim=-1)
    return torch.where(cloud.mask[:, None], out, 0.0)


def organized_surface_normals(cloud: PointCloud, rows: int, cols: int, knn: int = 5,
                              max_dist=math.inf, sensor_origin=None,
                              min_neighbors: int = 3) -> PointCloud:
    """Window-PCA normals and surface descriptors of an ORGANIZED cloud
    (≙ OrganizedCloudSurfaceNormalDataPointsFilter, reference
    OrganizedCloudSurfaceNormal.cpp:95-227): the neighbours of a pixel are
    the range image's [-knn//2, knn//2) window, the cloud in row-major image
    order with ``rows * cols`` lanes.  Adds the channels densities,
    linearity, planarity and curvature (sqrt-eigenvalue spans)."""
    if cloud.capacity != rows * cols:
        raise ValueError("the cloud must be image-ordered with rows * cols lanes")
    half = knn // 2
    img = torch.where(cloud.mask[:, None], cloud.xyz, 0.0).reshape(rows, cols, 3)
    msk = cloud.mask.reshape(rows, cols)
    img_p = torch.nn.functional.pad(img, (0, 0, half, half, half, half))
    msk_p = torch.nn.functional.pad(msk, (half, half, half, half))
    shifts = [(dr, dc) for dr in range(-half, half) for dc in range(-half, half)]
    nbr = torch.stack([img_p[half + dr:half + dr + rows, half + dc:half + dc + cols]
                       for dr, dc in shifts], dim=2)
    ok = torch.stack([msk_p[half + dr:half + dr + rows, half + dc:half + dc + cols]
                      for dr, dc in shifts], dim=2)
    diff = nbr - img[:, :, None, :]
    d2 = (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]) + diff[..., 2] * diff[..., 2]
    md = torch.tensor(float(max_dist), dtype=torch.float32)
    ok = ok & (d2 <= float(md * md)) & msk[:, :, None]
    w = ok.to(torch.float32)[..., None]
    cnt = w.sum(2)
    mean = (nbr * w).sum(2) / torch.clamp(cnt, min=1.0)
    d = (nbr - mean[:, :, None, :]) * w
    C = torch.einsum("rcki,rckj->rcij", d, d) / torch.clamp(cnt[..., None], min=1.0)
    n, evals = smallest_eigenvector_3x3(C.reshape(-1, 3, 3))
    count = cnt.reshape(-1)
    out = _orient_and_gate(cloud, n, count, sensor_origin, min_neighbors)
    good = cloud.mask & (count >= min_neighbors)
    s = torch.sqrt(torch.clamp(evals, min=0.0))
    s0, s1, s2 = s[..., 0], s[..., 1], s[..., 2]
    safe = torch.clamp(s2, min=1e-12)
    r_max2 = torch.where(ok, d2, 0.0).amax(dim=2).reshape(-1)
    volume = (4.0 / 3.0) * math.pi * r_max2 * torch.sqrt(r_max2)
    for name, val in (("densities", count / torch.clamp(volume, min=1e-12)),
                      ("linearity", (s2 - s1) / safe), ("planarity", (s1 - s0) / safe),
                      ("curvature", s0 / torch.clamp(s0 + s1 + s2, min=1e-12))):
        out = out.with_attr(name, torch.where(good, val, 0.0))
    return out
