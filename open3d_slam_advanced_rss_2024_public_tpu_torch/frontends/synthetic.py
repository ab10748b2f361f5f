"""Synthetic LiDAR worlds and trajectories.

Counterpart of the JAX package's ``frontends/synthetic.py``: a corridor
with walls, floor, ceiling and pillars, or a ground plane with randomly
sized and rotated boxes, cylinders and spheres, scanned by a virtual LiDAR
along a circular loop or a straight line, with a drifting odometry source.  The world is drawn on the host from
a numpy seed; scans are drawn on the world's device from a
``torch.Generator``.  The random bits differ from the JAX package's; the
geometry and its statistics are the same.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..ops import generators
from ..utils import se3
from ..utils.pointcloud import PointCloud, compact, make_cloud
from ..utils.timebuf import _so3_exp


def _yaw(yaw: float) -> np.ndarray:
    c, s = np.cos(yaw), np.sin(yaw)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def corridor_world(seed: int = 0, length: float = 80.0, width: float = 8.0,
                   height: float = 4.0, points_per_m2: float = 28.0, n_pillars: int = 14,
                   device="cuda") -> PointCloud:
    """A corridor along +x: floor, ceiling and side walls as thin boxes,
    and ``n_pillars`` cylinders of radius 0.3 m at random places (pillars
    break the translational aliasing of bare corridors), with the JAX
    package's point counts."""
    rng = np.random.default_rng(seed)
    parts = []

    def wall(center, he):
        n = int(points_per_m2 * (4 * (he[0] + he[1] + he[2]) ** 2) ** 0.5 * 10)
        p, nrm = generators.uniform_box(rng, max(n, 500), half_extents=he)
        parts.append((p + np.asarray(center, np.float32), nrm))

    wall((length / 2, 0.0, 0.0), (length / 2, width / 2, 0.02))
    wall((length / 2, 0.0, height), (length / 2, width / 2, 0.02))
    wall((length / 2, -width / 2, height / 2), (length / 2, 0.02, height / 2))
    wall((length / 2, width / 2, height / 2), (length / 2, 0.02, height / 2))
    px = rng.uniform(3.0, length - 3.0, n_pillars)
    py = rng.uniform(-width / 2 + 1.0, width / 2 - 1.0, n_pillars)
    for x, y in zip(px, py):
        p, nrm = generators.uniform_cylinder(rng, 1500, radius=0.3, height=height)
        parts.append((p + np.array([x, y, height / 2], np.float32), nrm))
    return make_cloud(np.concatenate([p for p, _ in parts]).astype(np.float32),
                      normals=np.concatenate([n for _, n in parts]).astype(np.float32),
                      device=device)


def cluttered_world(seed: int = 0, extent: float = 30.0, n_objects: int = 40,
                    device="cuda") -> PointCloud:
    """Ground plane + randomly sized/rotated boxes, cylinders and spheres."""
    rng = np.random.default_rng(seed)
    xyz, nrm = generators.uniform_plane(rng, 12000, half_extents=(extent / 2, extent / 2))
    parts = [(xyz + np.array([extent / 2, 0.0, 0.0], np.float32), nrm)]
    for _ in range(n_objects):
        kind = int(rng.integers(0, 3))
        size = float(rng.uniform(0.3, 1.6))
        pos = rng.uniform([1.0, -extent / 2 + 1, 0.2], [extent - 1.0, extent / 2 - 1, 2.0])
        if kind == 0:
            p, n = generators.uniform_box(rng, 1200, half_extents=(size * 0.7, size * 0.4, size))
            R = _yaw(float(rng.uniform(0.0, 3.14)))
            p, n = p @ R.T, n @ R.T
        elif kind == 1:
            p, n = generators.uniform_cylinder(rng, 1000, radius=size * 0.4, height=size * 2)
        else:
            p, n = generators.uniform_sphere(rng, 800, radius=size * 0.5)
        parts.append((p + pos, n))
    return make_cloud(np.concatenate([p for p, _ in parts]).astype(np.float32),
                      normals=np.concatenate([n for _, n in parts]).astype(np.float32),
                      device=device)


def render_scan(world: PointCloud, sensor_pose, generator: torch.Generator,
                max_range: float = 30.0, min_range: float = 0.5,
                n_points: int = 8192, noise: float = 0.0) -> PointCloud:
    """Virtual LiDAR: world points within range of the sensor, in the sensor
    frame, randomly subsampled to ``n_points`` and optionally jittered by
    Gaussian noise.  ``generator`` lives on the world's device."""
    T = torch.as_tensor(np.asarray(sensor_pose, np.float32), device=world.device)
    local = world.transform(se3.inverse(T))
    r = torch.linalg.vector_norm(torch.where(local.mask[:, None], local.xyz, 0.0), dim=-1)
    visible = local.with_mask((r > min_range) & (r < max_range))
    u = torch.rand(visible.capacity, generator=generator, device=world.device)
    order = torch.argsort(torch.where(visible.mask, u, float("inf")))
    keep = torch.zeros(visible.capacity, dtype=torch.bool, device=world.device)
    keep[order[:n_points]] = True
    visible = visible.with_mask(keep)
    if noise > 0:
        jitter = torch.randn(visible.xyz.shape, generator=generator, device=world.device)
        visible = visible.with_xyz(visible.xyz + noise * jitter)
    return compact(visible, n_points)


def loop_trajectory(n_steps: int, radius: float = 14.0,
                    center: Tuple[float, float] = (20.0, 0.0),
                    z: float = 1.2) -> List[np.ndarray]:
    """A closed circular loop of sensor poses, heading along the tangent."""
    poses = []
    for i in range(n_steps):
        theta = 2.0 * np.pi * i / n_steps
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = _yaw(theta + np.pi / 2.0)
        T[:3, 3] = [center[0] + radius * np.cos(theta), center[1] + radius * np.sin(theta), z]
        poses.append(T)
    return poses


def straight_trajectory(n_steps: int, step: float = 0.4, yaw_rate: float = 0.0,
                        start: Tuple[float, float, float] = (2.0, 0.0, 1.2)) -> List[np.ndarray]:
    """Constant-velocity poses marching along +x (with optional yaw drift)."""
    dT = np.eye(4)
    dT[:3, :3] = _yaw(yaw_rate)
    dT[:3, 3] = [step, 0.0, 0.0]
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = start
    poses = []
    for _ in range(n_steps):
        poses.append(T.copy())
        T = (T @ dT).astype(np.float32)
    return poses


def perturb_odometry(poses: List[np.ndarray], drift_per_step: float = 0.002,
                     yaw_drift_per_step: float = 0.0005, seed: int = 0) -> List[np.ndarray]:
    """Integrate noisy relative motions: a drifting odometry source (what
    the reference consumes from an external estimator).  The noise comes
    from ``np.random.RandomState(seed)`` in the JAX package's order."""
    rng = np.random.RandomState(seed)
    out = [poses[0].copy()]
    for i in range(1, len(poses)):
        rel = np.linalg.inv(poses[i - 1]) @ poses[i]
        noise_t = drift_per_step * rng.randn(3)
        noise_w = yaw_drift_per_step * rng.randn(3)
        dN = np.eye(4)
        dN[:3, :3] = _so3_exp(noise_w)
        dN[:3, 3] = noise_t
        out.append((out[-1] @ rel @ dN).astype(np.float32))
    return out
