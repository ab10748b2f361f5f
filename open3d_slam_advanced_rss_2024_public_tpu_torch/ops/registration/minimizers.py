"""Error minimizers: the Gauss-Newton steps, the closed-form alignment and
the solution covariances.

Counterpart of the JAX package's ``ops/registration/minimizers.py``
(reference ErrorMinimizers/PointToPlane.cpp:108-254, PointToPoint.cpp,
PointToPointSimilarity.cpp, PointToPlaneWithCov.cpp and the generalized
ICP that CloudRegistration.cpp wraps).  Clouds arrive de-meaned at the
reference centroid (ICP.cpp:293-326), so float32 normal equations stay
healthy.

Nothing here reads a tensor back: the 6x6 solve is ``cholesky_ex`` and two
triangular solves, GICP's per-correspondence 3x3 inverses are the closed
form adjugate over the determinant, the covariances invert through
``inv_ex``, and the Umeyama rotation comes from Horn's quaternion method
(``se3.horn_rotation``) instead of ``linalg.svd``: the checked forms of
these (``cholesky``, ``solve``, ``inv``, ``svd``) read their ``info`` back
to the host and synchronise the stream on every ICP iteration.
"""
from __future__ import annotations

import torch

from ...utils import se3

Tensor = torch.Tensor


def _eye(k: int, like: Tensor) -> Tensor:
    return torch.eye(k, dtype=like.dtype, device=like.device)


def solve_6x6(A: Tensor, b: Tensor, damping: float = 1e-6) -> Tensor:
    """Solve A x = b for symmetric PSD kxk A with relative Tikhonov damping
    (a small multiple of trace(A)/k keeps the solve branch-free)."""
    k = A.shape[-1]
    scale = torch.diagonal(A, dim1=-2, dim2=-1).sum(-1) / k + 1e-12
    A_reg = A + (damping * scale)[..., None, None] * _eye(k, A)
    L, _ = torch.linalg.cholesky_ex(A_reg)
    y = torch.linalg.solve_triangular(L, b[..., None], upper=False)
    return torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True)[..., 0]


def point_to_plane_step(src_xyz: Tensor, ref_xyz: Tensor, ref_normals: Tensor,
                        weights: Tensor, damping: float = 1e-6,
                        force4dof: bool = False, force2d: bool = False):
    """One weighted point-to-plane Gauss-Newton step: minimizes
    sum_i w_i (n_i . (p_i + omega x p_i + t - q_i))^2 over the twist
    xi = (omega, t).  Returns (xi f32[6], mean_sq_residual).

    force4dof restricts rotation to yaw (rows (p x n)_z, n; a 4x4 solve,
    PointToPlane.cpp:124-135); force2d also drops z translation and
    projects residuals onto the XY plane (a 3x3 solve, :246-254)."""
    cross = torch.linalg.cross(src_xyz, ref_normals)
    delta = src_xyz - ref_xyz
    if force2d:
        r = (delta[..., :2] * ref_normals[..., :2]).sum(-1)
        g = torch.cat([cross[..., 2:3], ref_normals[..., :2]], dim=-1)
    elif force4dof:
        r = (delta * ref_normals).sum(-1)
        g = torch.cat([cross[..., 2:3], ref_normals], dim=-1)
    else:
        r = (delta * ref_normals).sum(-1)
        g = torch.cat([cross, ref_normals], dim=-1)
    wg = g * weights[..., None]
    A = wg.transpose(-1, -2) @ g
    b = -(wg.transpose(-1, -2) @ r[..., None])[..., 0]
    x = solve_6x6(A, b, damping)
    if force2d or force4dof:
        z = torch.zeros(x.shape[:-1] + (2,), dtype=x.dtype, device=x.device)
        xi = torch.cat([z, x, z[..., :1]] if force2d else [z, x], dim=-1)
    else:
        xi = x
    wsum = torch.clamp(weights.sum(-1), min=1e-6)
    return xi, (weights * r * r).sum(-1) / wsum


def point_to_point_umeyama(src_xyz: Tensor, ref_xyz: Tensor, weights: Tensor,
                           with_scale: bool = False):
    """Weighted closed-form rigid (or similarity) alignment mapping src ->
    ref (PointToPoint.cpp / PointToPointSimilarity.cpp, Umeyama).  The
    scale is trace(R^T S) / var(src), which equals Umeyama's
    sum(D * diag(C)) / var(src).  Returns (4x4 transform, scale)."""
    w = weights / torch.clamp(weights.sum(-1), min=1e-9)
    mu_s = (src_xyz * w[..., None]).sum(-2)
    mu_r = (ref_xyz * w[..., None]).sum(-2)
    ds = src_xyz - mu_s[..., None, :]
    dr = ref_xyz - mu_r[..., None, :]
    # M[i, j] = sum_k w_k ds_k,i dr_k,j: the cross-covariance S^T.
    M = (ds * w[..., None]).transpose(-1, -2) @ dr
    R = se3.horn_rotation(M)
    if with_scale:
        var_s = (w * (ds * ds).sum(-1)).sum(-1)
        scale = (R * M.transpose(-1, -2)).sum((-2, -1)) / torch.clamp(var_s, min=1e-12)
    else:
        scale = torch.ones((), dtype=src_xyz.dtype, device=src_xyz.device)
    t = mu_r - scale[..., None] * (R @ mu_s[..., None])[..., 0]
    return se3.make_transform(scale[..., None, None] * R, t), scale


def point_to_point_mean_sq(src_xyz: Tensor, ref_xyz: Tensor, weights: Tensor) -> Tensor:
    d = src_xyz - ref_xyz
    return (weights * (d * d).sum(-1)).sum(-1) / torch.clamp(weights.sum(-1), min=1e-6)


def point_to_point_step(src_xyz: Tensor, ref_xyz: Tensor, weights: Tensor):
    """Umeyama as an incremental step, so that the ICP loop treats
    point-to-point like point-to-plane: returns (xi, mean_sq_residual)."""
    T, _ = point_to_point_umeyama(src_xyz, ref_xyz, weights)
    return se3.se3_log(T), point_to_point_mean_sq(src_xyz, ref_xyz, weights)


def _regularized_inverse(A: Tensor, sensor_std: float) -> Tensor:
    scale = torch.diagonal(A, dim1=-2, dim2=-1).sum(-1) / 6.0 + 1e-12
    inv, _ = torch.linalg.inv_ex(A + (1e-6 * scale)[..., None, None] * _eye(6, A))
    return (sensor_std * sensor_std) * inv


def point_to_plane_covariance(src_xyz: Tensor, ref_normals: Tensor, weights: Tensor,
                              sensor_std: float = 0.01) -> Tensor:
    """6x6 covariance of the point-to-plane solution (PointToPlaneWithCov,
    Censi-style): sigma^2 (J^T W J)^-1 with J_i = [p_i x n_i ; n_i]."""
    g = torch.cat([torch.linalg.cross(src_xyz, ref_normals), ref_normals], dim=-1)
    return _regularized_inverse((g * weights[..., None]).transpose(-1, -2) @ g, sensor_std)


def _point_jacobian(src_xyz: Tensor) -> Tensor:
    """J_i = [-[p_i]x | I], [N, 3, 6]."""
    px = se3.skew(src_xyz)
    return torch.cat([-px, _eye(3, src_xyz).expand(px.shape)], dim=-1)


def point_to_point_covariance(src_xyz: Tensor, weights: Tensor,
                              sensor_std: float = 0.01) -> Tensor:
    """6x6 covariance of the point-to-point solution (PointToPointWithCov)."""
    J = _point_jacobian(src_xyz)
    return _regularized_inverse(torch.einsum("nij,nik,n->jk", J, J, weights), sensor_std)


def gicp_step(src_xyz: Tensor, ref_xyz: Tensor, src_cov: Tensor, ref_cov: Tensor,
              weights: Tensor, damping: float = 1e-6):
    """Generalized-ICP step: plane-to-plane metric with the residuals
    weighted by M_i = (Cr_i + Cs_i + 1e-6 I)^-1.  The 3x3 inverses are the
    adjugate over the determinant, elementwise over the correspondences."""
    delta = src_xyz - ref_xyz
    M = ref_cov + src_cov + 1e-6 * _eye(3, src_xyz)
    cof = se3._cofactor_3x3(M)
    Minv = cof.transpose(-1, -2) / (M[..., 0, :] * cof[..., 0, :]).sum(-1)[..., None, None]
    J = _point_jacobian(src_xyz)
    WJ = Minv @ J
    A = torch.einsum("nij,nik,n->jk", J, WJ, weights)
    b = -torch.einsum("nij,ni,n->j", WJ, delta, weights)
    xi = solve_6x6(A, b, damping)
    wsum = torch.clamp(weights.sum(), min=1e-6)
    mean_sq = torch.einsum("ni,nij,nj,n->", delta, Minv, delta, weights) / wsum
    return xi, mean_sq
