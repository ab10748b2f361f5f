"""Plain geometry for the reference: crops, voxel means, neighbourhood
normals, nearest neighbours and point-to-plane registration, in float64
with dense sweeps over x-sorted slabs.  Nothing here comes from the program
under test.
"""
from __future__ import annotations

import torch

from . import se3

Tensor = torch.Tensor


def radius_crop(xyz: Tensor, lo: float, hi: float) -> Tensor:
    r = torch.linalg.vector_norm(xyz, dim=-1)
    return xyz[(r >= lo) & (r <= hi)]


def voxel_keys(xyz32: Tensor, cell: float) -> Tensor:
    """floor(p / cell) with the float32 division a configuration's voxel
    size means: the same key for the same float32 point, whoever computes
    it."""
    return torch.floor(xyz32.float() / torch.tensor(cell, dtype=torch.float32,
                                                    device=xyz32.device)).long()


def voxel_means(xyz: Tensor, cell: float) -> Tensor:
    """The mean of the points in each occupied voxel of edge ``cell``."""
    keys = voxel_keys(xyz.float(), cell)
    _, inv = torch.unique(keys, dim=0, return_inverse=True)
    n = int(inv.max()) + 1 if inv.numel() else 0
    sums = torch.zeros((n, 3), dtype=torch.float64, device=xyz.device).index_add_(
        0, inv, xyz.double())
    counts = torch.zeros(n, dtype=torch.float64, device=xyz.device).index_add_(
        0, inv, torch.ones_like(inv, dtype=torch.float64))
    return sums / counts[:, None]


QUERY_BLOCK = 4096


def _slabs(q: Tensor, r: Tensor, reach: float):
    """Blocks of queries sorted along x, each with the slice of the
    references (sorted along x too) that lie within ``reach`` of the
    block along x: every pair closer than ``reach`` is in some block's
    slice.  Yields (query indices, reference indices)."""
    qo = torch.argsort(q[:, 0])
    ro = torch.argsort(r[:, 0])
    rx = r[ro, 0].contiguous()
    for i in range(0, q.shape[0], QUERY_BLOCK):
        qi = qo[i:i + QUERY_BLOCK]
        lo = torch.searchsorted(rx, q[qi, 0].min() - reach)
        hi = torch.searchsorted(rx, q[qi, 0].max() + reach, right=True)
        yield qi, ro[lo:hi]


def _sq_dists(q: Tensor, r: Tensor) -> Tensor:
    """All squared distances of two small sets, float64: |q|^2 + |r|^2 - 2 q.r."""
    q, r = q.double(), r.double()
    return torch.addmm((r * r).sum(-1), q, r.T, alpha=-2.0) + (q * q).sum(-1, keepdim=True)


def nearest(q: Tensor, r: Tensor, max_dist: float):
    """Index and squared distance of each query's nearest reference point
    within ``max_dist`` (+inf and index 0 where there is none)."""
    idx = torch.zeros(q.shape[0], dtype=torch.long, device=q.device)
    d2 = torch.full((q.shape[0],), torch.inf, dtype=torch.float64, device=q.device)
    center = r.mean(0)
    qc, rc = (q - center).double(), (r - center).double()
    for qi, ri in _slabs(qc, rc, max_dist):
        if ri.numel() == 0:
            continue
        dmin, arg = _sq_dists(qc[qi], rc[ri]).min(dim=1)
        d2[qi], idx[qi] = dmin.clamp(min=0.0), ri[arg]
    far = d2 > max_dist * max_dist
    return torch.where(far, 0, idx), torch.where(far, torch.inf, d2)


def count_within(q: Tensor, r: Tensor, radius: float) -> int:
    """Pairs (query, reference) no farther apart than ``radius``."""
    total = 0
    center = r.mean(0)
    qc, rc = (q - center).double(), (r - center).double()
    for qi, ri in _slabs(qc, rc, radius):
        if ri.numel():
            total += int((_sq_dists(qc[qi], rc[ri]) <= radius * radius).sum())
    return total


def radius_normals(xyz: Tensor, radius: float) -> Tensor:
    """Unit normal of each point: the least eigenvector of the covariance of
    the points within ``radius`` (zero where fewer than three)."""
    p = (xyz - xyz.mean(0)).double()
    out = torch.zeros_like(p)
    for qi, ri in _slabs(p, p, radius):
        w = (_sq_dists(p[qi], p[ri]) <= radius * radius).double()
        n = w.sum(1)
        pr = p[ri]
        mean = (w @ pr) / n[:, None]
        m2 = torch.stack([w @ (pr[:, a] * pr[:, b]) for a in range(3) for b in range(3)],
                         -1).reshape(-1, 3, 3) / n[:, None, None]
        _, vec = torch.linalg.eigh(m2 - mean[:, :, None] * mean[:, None, :])
        out[qi] = torch.where((n >= 3)[:, None], vec[:, :, 0], 0.0)
    return out


def point_to_plane(src: Tensor, ref: Tensor, ref_normals: Tensor, T0: Tensor,
                   max_dist: float, trimmed_ratio: float, iterations: int = 60,
                   tol: float = 1e-7) -> Tensor:
    """Register ``src`` (sensor frame) to ``ref`` from the pose ``T0``: each
    trip matches every point to its nearest reference point, keeps matches
    within ``max_dist`` and at or below the ``trimmed_ratio`` quantile of
    the squared distances, and solves the point-to-plane normal equations
    for a twist (a reference point without a normal adds nothing).  The
    quantile is the ``floor(ratio * n)``-th of the n sorted squared
    distances, unmatched points as +inf.  Returns the pose where a trip
    moves it by less than ``tol`` (metres and radians)."""
    T = T0.double().clone()
    src, ref, nrm = src.double(), ref.double(), ref_normals.double()
    k = min(int(trimmed_ratio * src.shape[0]), src.shape[0] - 1)
    for _ in range(iterations):
        p = se3.apply(T, src)
        idx, d2 = nearest(p, ref, max_dist)
        found = torch.isfinite(d2)
        thresh = torch.sort(torch.where(found, d2, torch.inf)).values[k]
        keep = found & (d2 <= thresh)
        q, n, pk = ref[idx][keep], nrm[idx][keep], p[keep]
        r = ((pk - q) * n).sum(-1)
        J = torch.cat([torch.cross(pk, n, dim=-1), n], -1)  # d r / d (omega, v), left
        H = J.T @ J
        b = -(J.T @ r)
        xi = torch.linalg.solve(H + 1e-12 * torch.eye(6, dtype=H.dtype, device=H.device), b)
        T = se3.se3_exp(xi) @ T
        if float(torch.linalg.vector_norm(xi)) < tol:
            break
    return T
