"""SE(3) / SO(3) utilities on 4x4 float32 tensors, batched over leading dims.

Counterpart of the JAX package's ``utils/se3.py``.  Everything is written
with elementwise tensor ops and small matmuls: no LAPACK call, because
torch's LAPACK wrappers on CUDA check their ``info`` result on the host and
so synchronise the stream.
"""
from __future__ import annotations

import math

import torch

Tensor = torch.Tensor

_EPS = 1e-9


def identity(dtype=torch.float32, device=None) -> Tensor:
    return torch.eye(4, dtype=dtype, device=device)


def make_transform(R: Tensor, t: Tensor) -> Tensor:
    """Assemble a 4x4 transform from a 3x3 rotation and 3-translation.
    The corner is set with ``fill_``: assigning a Python number to a 0-dim
    CUDA view copies a host tensor and synchronises the stream."""
    T = R.new_zeros(R.shape[:-2] + (4, 4))
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3].fill_(1.0)
    return T


def rotation(T: Tensor) -> Tensor:
    return T[..., :3, :3]


def translation(T: Tensor) -> Tensor:
    return T[..., :3, 3]


def inverse(T: Tensor) -> Tensor:
    Rt = rotation(T).transpose(-1, -2)
    return make_transform(Rt, -(Rt @ translation(T)[..., None])[..., 0])


def apply(T: Tensor, pts: Tensor) -> Tensor:
    """Apply SE(3) to points [..., N, 3]."""
    return pts @ rotation(T).transpose(-1, -2) + translation(T)[..., None, :]


def rotate(T: Tensor, vecs: Tensor) -> Tensor:
    """Apply only the rotation part (normals / directions)."""
    return vecs @ rotation(T).transpose(-1, -2)


def skew(w: Tensor) -> Tensor:
    """[..., 3] -> [..., 3, 3] cross-product matrix."""
    z = torch.zeros_like(w[..., 0])
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    return torch.stack([
        torch.stack([z, -wz, wy], dim=-1),
        torch.stack([wz, z, -wx], dim=-1),
        torch.stack([-wy, wx, z], dim=-1),
    ], dim=-2)


def _coefficients(theta2: Tensor):
    """Taylor-safe (A, B, C) = (sin t / t, (1 - cos t) / t^2, (1 - A) / t^2)."""
    theta = torch.sqrt(theta2 + _EPS)
    small = theta2 < 1e-3
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    B = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    C = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (1.0 - A) / theta2)
    return A, B, C


def so3_exp(w: Tensor) -> Tensor:
    """Rodrigues formula, stable near zero angle."""
    A, B, _ = _coefficients((w * w).sum(-1))
    W = skew(w)
    I = torch.eye(3, dtype=w.dtype, device=w.device)
    return I + A[..., None, None] * W + B[..., None, None] * (W @ W)


def se3_exp(xi: Tensor) -> Tensor:
    """Twist [..., 6] = (omega, v) -> 4x4 transform."""
    w, v = xi[..., :3], xi[..., 3:]
    A, B, C = _coefficients((w * w).sum(-1))
    W = skew(w)
    W2 = W @ W
    I = torch.eye(3, dtype=xi.dtype, device=xi.device)
    R = I + A[..., None, None] * W + B[..., None, None] * W2
    V = I + B[..., None, None] * W + C[..., None, None] * W2
    return make_transform(R, (V @ v[..., None])[..., 0])


def compose(A: Tensor, B: Tensor) -> Tensor:
    return A @ B


def so3_log(R: Tensor) -> Tensor:
    """Rotation matrix -> axis-angle vector (theta * unit_axis).  The same
    three branches as the JAX package (``se3.py:94-139``): a series in
    (1 - cos) below ~4.5e-3 rad, the vector part of the skew component
    elsewhere, and the diagonal extraction within 1e-3 of pi."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    c = torch.clamp((trace - 1.0) / 2.0, -1.0, 1.0)
    small = c > 1.0 - 1e-5
    c_safe = torch.where(small, 0.0, c)
    theta = torch.arccos(c_safe)
    v = torch.stack([R[..., 2, 1] - R[..., 1, 2],
                     R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    sin_theta = torch.sqrt(torch.clamp(1.0 - c_safe * c_safe, min=1e-12))
    scale_series = 0.5 + (1.0 - c) / 6.0 + (1.0 - c) ** 2 * (7.0 / 90.0)
    scale = torch.where(small, scale_series, theta / (2.0 * sin_theta))
    theta = torch.where(small, torch.sqrt(torch.clamp(2.0 * (1.0 - c), min=0.0)), theta)
    w = scale[..., None] * v
    # Near pi the vector part degenerates; use diagonal extraction.
    near_pi = theta > (math.pi - 1e-3)
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    axis = torch.sqrt(torch.clamp((diag + 1.0) / 2.0, 0.0, 1.0))
    sign_ref = torch.stack([torch.ones_like(theta),
                            torch.sign(R[..., 0, 1] + R[..., 1, 0] + _EPS),
                            torch.sign(R[..., 0, 2] + R[..., 2, 0] + _EPS)], dim=-1)
    axis = axis * sign_ref
    axis = axis / (torch.linalg.vector_norm(axis, dim=-1, keepdim=True) + _EPS)
    return torch.where(near_pi[..., None], axis * theta[..., None], w)


def se3_log(T: Tensor) -> Tensor:
    """4x4 transform -> twist [..., 6] = (omega, v)."""
    w = so3_log(rotation(T))
    theta2 = (w * w).sum(-1)
    A, B, _ = _coefficients(theta2)
    small = theta2 < 1e-3
    W = skew(w)
    I = torch.eye(3, dtype=T.dtype, device=T.device)
    # V^{-1} = I - W/2 + (1/theta2)(1 - A/(2B)) W^2
    coef = torch.where(small, 1.0 / 12.0,
                       (1.0 - A / (2.0 * B)) / torch.where(small, 1.0, theta2))
    Vinv = I - 0.5 * W + coef[..., None, None] * (W @ W)
    return torch.cat([w, (Vinv @ translation(T)[..., None])[..., 0]], dim=-1)


def _blocks_2x2(a: Tensor, b: Tensor, c: Tensor, d: Tensor) -> Tensor:
    return torch.cat([torch.cat([a, b], dim=-1), torch.cat([c, d], dim=-1)], dim=-2)


def adjoint(T: Tensor) -> Tensor:
    """Adjoint Ad_T [..., 6, 6] for twists ordered (omega, v):
    Ad = [[R, 0], [[t]x R, R]]."""
    R = rotation(T)
    return _blocks_2x2(R, torch.zeros_like(R), skew(translation(T)) @ R, R)


def ad(xi: Tensor) -> Tensor:
    """Algebra adjoint ad_xi [..., 6, 6]: [[w^, 0], [v^, w^]]."""
    W = skew(xi[..., :3])
    return _blocks_2x2(W, torch.zeros_like(W), skew(xi[..., 3:]), W)


def log_right_jacobian_inv(r: Tensor) -> Tensor:
    """Inverse right Jacobian of the SE(3) log at twist r [..., 6], in the
    series form I + 1/2 ad(r) + 1/12 ad(r)^2 (exact to O(|r|^3))."""
    a = ad(r)
    return torch.eye(6, dtype=r.dtype, device=r.device) + 0.5 * a + (1.0 / 12.0) * (a @ a)


def matrix_to_rpy(R: Tensor) -> Tensor:
    """Rotation matrix -> roll, pitch, yaw (XYZ extrinsic)."""
    p = torch.arcsin(torch.clamp(-R[..., 2, 0], -1.0, 1.0))
    r = torch.arctan2(R[..., 2, 1], R[..., 2, 2])
    y = torch.arctan2(R[..., 1, 0], R[..., 0, 0])
    return torch.stack([r, p, y], dim=-1)


def rpy_to_matrix(rpy: Tensor) -> Tensor:
    """Roll-pitch-yaw (XYZ extrinsic = ZYX intrinsic) -> rotation matrix."""
    r, p, y = rpy[..., 0], rpy[..., 1], rpy[..., 2]
    cr, sr, cp, sp, cy, sy = (torch.cos(r), torch.sin(r), torch.cos(p), torch.sin(p),
                              torch.cos(y), torch.sin(y))
    return torch.stack([
        torch.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr], dim=-1),
        torch.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr], dim=-1),
        torch.stack([-sp, cp * sr, cp * cr], dim=-1),
    ], dim=-2)


def quat_to_matrix(q: Tensor) -> Tensor:
    """Unit quaternion [..., 4] (w, x, y, z) -> rotation matrix [..., 3, 3]."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], dim=-2)


def quat_from_matrix(R: Tensor) -> Tensor:
    """Rotation matrix [..., 3, 3] -> unit quaternion [..., 4] (w, x, y, z):
    Shepperd's four branches, the largest per element, then the sign that
    makes w >= 0 (JAX ``se3.py:225-247``)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    cases = torch.stack([
        torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], -1),
        torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], -1),
        torch.stack([m02 - m20, m01 + m10, 1.0 + m11 - m00 - m22, m12 + m21], -1),
        torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 + m22 - m00 - m11], -1),
    ], dim=-2)
    mags = torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 + m11 - m00 - m22,
                        1.0 + m22 - m00 - m11], -1)
    best = mags.argmax(-1)
    q = torch.gather(cases, -2, best[..., None, None].expand(best.shape + (1, 4)))[..., 0, :]
    q = q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + _EPS)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def quat_slerp(q0: Tensor, q1: Tensor, alpha) -> Tensor:
    """Spherical interpolation along the shortest arc; linear where the two
    are nearly equal."""
    alpha = torch.as_tensor(alpha, dtype=q0.dtype, device=q0.device)
    dot = (q0 * q1).sum(-1, keepdim=True)
    q1 = torch.where(dot < 0, -q1, q1)
    theta = torch.arccos(torch.clamp(dot.abs(), -1.0, 1.0))
    sin_theta = torch.sin(theta)
    small = sin_theta < 1e-5
    safe = torch.where(small, 1.0, sin_theta)
    w0 = torch.where(small, 1.0 - alpha, torch.sin((1.0 - alpha) * theta) / safe)
    w1 = torch.where(small, alpha, torch.sin(alpha * theta) / safe)
    q = w0 * q0 + w1 * q1
    return q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + _EPS)


def interpolate(T0: Tensor, T1: Tensor, alpha) -> Tensor:
    """Pose interpolation: slerp of the rotation, lerp of the translation;
    ``alpha`` a scalar or batched like the poses' leading dims
    (≙ reference Transform.cpp:16-60)."""
    alpha = torch.as_tensor(alpha, dtype=T0.dtype, device=T0.device)
    q = quat_slerp(quat_from_matrix(rotation(T0)), quat_from_matrix(rotation(T1)),
                   alpha[..., None])
    a = alpha[..., None]
    return make_transform(quat_to_matrix(q), (1.0 - a) * translation(T0) + a * translation(T1))


def extrapolate(T0: Tensor, T1: Tensor, alpha) -> Tensor:
    """Continue the motion T0 -> T1: alpha 0 gives T0, 1 gives T1, 2 gives
    T1 (T0^-1 T1) (≙ reference Transform.cpp:62-118)."""
    alpha = torch.as_tensor(alpha, dtype=T0.dtype, device=T0.device)
    delta = se3_log(compose(inverse(T0), T1))
    return compose(T0, se3_exp(alpha[..., None] * delta))


def horn_rotation(M: Tensor, steps: int = 30) -> Tensor:
    """The rotation R maximizing trace(R M^T) for a cross-covariance
    M[..., i, j] = sum_k src_k,i dst_k,j (src -> dst), by Horn's quaternion
    method: the dominant eigenvector of the 4x4 profile matrix, found by
    ``steps`` power steps after a shift that makes the largest eigenvalue
    the largest in magnitude.  It is always a proper rotation, as the SVD
    form with its reflection guard (Umeyama) gives, and it needs no batched
    SVD, whose CUDA path reads its ``info`` back to the host."""
    xx, xy, xz = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    yx, yy, yz = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    zx, zy, zz = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    N = torch.stack([
        torch.stack([xx + yy + zz, yz - zy, zx - xz, xy - yx], -1),
        torch.stack([yz - zy, xx - yy - zz, xy + yx, zx + xz], -1),
        torch.stack([zx - xz, xy + yx, -xx + yy - zz, yz + zy], -1),
        torch.stack([xy - yx, zx + xz, yz + zy, -xx - yy + zz], -1),
    ], dim=-2)
    shift = torch.sqrt((M * M).sum(dim=(-2, -1)))[..., None, None] * 2.0 + 1e-6
    Ns = N + shift * torch.eye(4, dtype=M.dtype, device=M.device)
    v = M.new_full(M.shape[:-2] + (4,), 0.5)
    for _ in range(steps):
        v = (Ns @ v[..., None])[..., 0]
        v = v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-12)
    return quat_to_matrix(v)


def _cofactor_3x3(R: Tensor) -> Tensor:
    """Cofactor matrix: cof(R) = det(R) R^{-T}, closed form."""
    c0 = torch.linalg.cross(R[..., 1, :], R[..., 2, :])
    c1 = torch.linalg.cross(R[..., 2, :], R[..., 0, :])
    c2 = torch.linalg.cross(R[..., 0, :], R[..., 1, :])
    return torch.stack([c0, c1, c2], dim=-2)


def det_3x3(M: Tensor) -> Tensor:
    """Closed-form batched 3x3 determinant (torch.linalg.det runs an LU)."""
    return (M[..., 0, :] * torch.linalg.cross(M[..., 1, :], M[..., 2, :])).sum(-1)


def orthonormalize(T: Tensor, iterations: int = 3) -> Tensor:
    """Re-project the rotation block onto SO(3) (accumulation drift fix).

    The JAX package takes U Vᵀ from an SVD; that is the polar factor of R,
    which Newton's iteration R <- (R + R^{-T}) / 2 reaches quadratically
    from a near-orthonormal start (ICP composes exp-map updates, so the
    drift is ~1e-6 and three steps reach float32 rounding) — with no
    batched SVD, whose CUDA path checks ``info`` on the host.
    """
    R = rotation(T)
    for _ in range(iterations):
        cof = _cofactor_3x3(R)
        det = (R[..., 0, :] * cof[..., 0, :]).sum(-1)
        R = 0.5 * (R + cof / det[..., None, None])
    return make_transform(R, translation(T))


def rotation_angle(T: Tensor) -> Tensor:
    """Geodesic rotation angle of the transform (radians)."""
    tr = T[..., 0, 0] + T[..., 1, 1] + T[..., 2, 2]
    return torch.arccos(torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0))


def translation_norm(T: Tensor) -> Tensor:
    return torch.linalg.vector_norm(translation(T), dim=-1)
