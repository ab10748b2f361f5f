"""Plain SE(3) algebra in float64 for the benchmark's generator and reference.

Twists are (omega, v), rotation first.  Every function takes a leading batch
of any shape and works on CPU or CUDA tensors.  Nothing here comes from the
program under test.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def hat(w: Tensor) -> Tensor:
    z = torch.zeros_like(w[..., 0])
    return torch.stack([torch.stack([z, -w[..., 2], w[..., 1]], -1),
                        torch.stack([w[..., 2], z, -w[..., 0]], -1),
                        torch.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def _coefficients(theta2: Tensor):
    """A = sin t / t, B = (1 - cos t) / t^2, C = (t - sin t) / t^3, with
    their series below 1e-8 rad^2."""
    small = theta2 < 1e-8
    t2 = torch.where(small, torch.ones_like(theta2), theta2)
    t = torch.sqrt(t2)
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(t) / t)
    B = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(t)) / t2)
    C = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (t - torch.sin(t)) / (t2 * t))
    return A, B, C


def so3_exp(w: Tensor) -> Tensor:
    A, B, _ = _coefficients((w * w).sum(-1))
    W = hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    return eye + A[..., None, None] * W + B[..., None, None] * (W @ W)


def se3_exp(xi: Tensor) -> Tensor:
    w, v = xi[..., :3], xi[..., 3:]
    A, B, C = _coefficients((w * w).sum(-1))
    W = hat(w)
    WW = W @ W
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device).expand(W.shape)
    R = eye + A[..., None, None] * W + B[..., None, None] * WW
    V = eye + B[..., None, None] * W + C[..., None, None] * WW
    T = torch.zeros(xi.shape[:-1] + (4, 4), dtype=xi.dtype, device=xi.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = (V @ v[..., None])[..., 0]
    T[..., 3, 3] = 1.0
    return T


def so3_log(R: Tensor) -> Tensor:
    """Rotation -> axis-angle, for angles well below pi (relative motions)."""
    vee = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                       R[..., 1, 0] - R[..., 0, 1]], -1)
    cos = ((R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]) - 1.0) / 2.0
    theta = torch.arccos(torch.clamp(cos, -1.0, 1.0))
    small = theta < 1e-6
    s = torch.where(small, torch.ones_like(theta), torch.sin(theta))
    scale = torch.where(small, 0.5 + theta * theta / 12.0, theta / (2.0 * s))
    return scale[..., None] * vee


def se3_log(T: Tensor) -> Tensor:
    w = so3_log(T[..., :3, :3])
    A, B, C = _coefficients((w * w).sum(-1))
    W = hat(w)
    eye = torch.eye(3, dtype=T.dtype, device=T.device).expand(W.shape)
    V = eye + B[..., None, None] * W + C[..., None, None] * (W @ W)
    v = torch.linalg.solve(V, T[..., :3, 3:4])[..., 0]
    return torch.cat([w, v], -1)


def inverse(T: Tensor) -> Tensor:
    R = T[..., :3, :3].transpose(-1, -2)
    out = torch.zeros_like(T)
    out[..., :3, :3] = R
    out[..., :3, 3] = -(R @ T[..., :3, 3:4])[..., 0]
    out[..., 3, 3] = 1.0
    return out


def geodesic(T0: Tensor, T1: Tensor, alpha: Tensor) -> Tensor:
    """T0 exp(alpha log(T0^-1 T1)): constant-twist motion from T0 to T1."""
    xi = se3_log(inverse(T0) @ T1)
    return T0 @ se3_exp(alpha[..., None] * xi)


def apply(T: Tensor, p: Tensor) -> Tensor:
    """Points [..., N, 3] through the transform(s) [..., 4, 4]."""
    return p @ T[..., :3, :3].transpose(-1, -2) + T[..., None, :3, 3]


def pose_gap(Ta: Tensor, Tb: Tensor, lever_m: float) -> Tensor:
    """How far two poses move a point ``lever_m`` from the sensor, at most:
    the translation gap plus the rotation gap times the lever, in metres."""
    D = inverse(Ta) @ Tb
    return (torch.linalg.vector_norm(D[..., :3, 3], dim=-1)
            + lever_m * torch.linalg.vector_norm(so3_log(D[..., :3, :3]), dim=-1))


def matrix_to_quaternion(R) -> tuple:
    """(qx, qy, qz, qw) of a rotation matrix given as nested floats (Shepperd)."""
    m = [[float(R[i][j]) for j in range(3)] for i in range(3)]
    tr = m[0][0] + m[1][1] + m[2][2]
    if tr > 0.0:
        s = 2.0 * (tr + 1.0) ** 0.5
        return ((m[2][1] - m[1][2]) / s, (m[0][2] - m[2][0]) / s, (m[1][0] - m[0][1]) / s,
                0.25 * s)
    i = max(range(3), key=lambda k: m[k][k])
    j, k = (i + 1) % 3, (i + 2) % 3
    s = 2.0 * (1.0 + m[i][i] - m[j][j] - m[k][k]) ** 0.5
    q = [0.0, 0.0, 0.0]
    q[i] = 0.25 * s
    q[j] = (m[j][i] + m[i][j]) / s
    q[k] = (m[k][i] + m[i][k]) / s
    return q[0], q[1], q[2], (m[k][j] - m[j][k]) / s


def quaternion_to_matrix(qx, qy, qz, qw) -> Tensor:
    n = (qx * qx + qy * qy + qz * qz + qw * qw) ** 0.5
    x, y, z, w = qx / n, qy / n, qz / n, qw / n
    return torch.tensor([[1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                         [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                         [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]],
                        dtype=torch.float64)
