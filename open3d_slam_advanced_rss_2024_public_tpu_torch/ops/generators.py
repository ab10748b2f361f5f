"""Synthetic point-cloud primitives for tests and the chip smoke run.

Counterpart of the primitives of the JAX package's ``ops/generators.py``
(reference PointCloudGenerator.cpp:107-378): points sampled uniformly on a
box, sphere, plane or cylinder, with outward normals.  Sampled on the host
from a ``numpy.random.Generator`` (the JAX package draws from
``jax.random``, so the bits differ); returns numpy (xyz, normals).
``lidar_room_scan`` and ``add_noise`` draw from an explicit
``torch.Generator`` on the host and return clouds.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.device import to_device
from ..utils.pointcloud import PointCloud, make_cloud


def uniform_box(rng: np.random.Generator, n: int, half_extents=(1.0, 1.0, 1.0)):
    he = np.asarray(half_extents, dtype=np.float64)
    areas = np.array([he[1] * he[2]] * 2 + [he[0] * he[2]] * 2 + [he[0] * he[1]] * 2)
    face = rng.choice(6, size=n, p=areas / areas.sum())
    uv = rng.uniform(-1.0, 1.0, (n, 2))
    sign = np.where(face % 2 == 0, 1.0, -1.0)
    axis = face // 2
    xyz = np.zeros((n, 3))
    nrm = np.zeros((n, 3))
    for a in range(3):
        o1, o2 = [i for i in range(3) if i != a]
        sel = axis == a
        xyz[sel, a] = sign[sel] * he[a]
        xyz[sel, o1] = uv[sel, 0] * he[o1]
        xyz[sel, o2] = uv[sel, 1] * he[o2]
        nrm[sel, a] = sign[sel]
    return xyz.astype(np.float32), nrm.astype(np.float32)


def uniform_sphere(rng: np.random.Generator, n: int, radius: float = 1.0):
    v = rng.standard_normal((n, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True) + 1e-12
    return (v * radius).astype(np.float32), v.astype(np.float32)


def uniform_plane(rng: np.random.Generator, n: int, half_extents=(1.0, 1.0)):
    uv = rng.uniform(-1.0, 1.0, (n, 2)) * np.asarray(half_extents)
    xyz = np.concatenate([uv, np.zeros((n, 1))], axis=-1)
    nrm = np.tile([[0.0, 0.0, 1.0]], (n, 1))
    return xyz.astype(np.float32), nrm.astype(np.float32)


def uniform_cylinder(rng: np.random.Generator, n: int, radius: float = 1.0,
                     height: float = 2.0):
    theta = rng.uniform(0.0, 2.0 * np.pi, n)
    z = rng.uniform(-height / 2, height / 2, n)
    c, s = np.cos(theta), np.sin(theta)
    xyz = np.stack([radius * c, radius * s, z], axis=-1)
    nrm = np.stack([c, s, np.zeros_like(z)], axis=-1)
    return xyz.astype(np.float32), nrm.astype(np.float32)


def lidar_room_scan(gen: torch.Generator, n: int = 8192, room=(10.0, 8.0, 3.0),
                    sensor=(0.0, 0.0, 1.0), noise: float = 0.0, device="cuda") -> PointCloud:
    """A structured indoor-like scan: walls, floor and ceiling of a box room
    seen from ``sensor``, normals facing inward (the JAX package's
    ``lidar_room_scan``, ``generators.py:73``).  Drawn from the host
    generator ``gen`` (a ``torch.Generator`` on the CPU)."""
    he = torch.tensor(room, dtype=torch.float64) / 2.0
    areas = torch.stack([he[1] * he[2]] * 2 + [he[0] * he[2]] * 2 + [he[0] * he[1]] * 2)
    face = torch.multinomial(areas / areas.sum(), n, replacement=True, generator=gen)
    uv = torch.rand((n, 2), generator=gen, dtype=torch.float64) * 2.0 - 1.0
    sign = torch.where(face % 2 == 0, 1.0, -1.0).to(torch.float64)
    axis = face // 2
    xyz = torch.zeros((n, 3), dtype=torch.float64)
    nrm = torch.zeros((n, 3), dtype=torch.float64)
    for a in range(3):
        o1, o2 = [i for i in range(3) if i != a]
        sel = axis == a
        xyz[:, a] = torch.where(sel, sign * he[a], xyz[:, a])
        xyz[:, o1] = torch.where(sel, uv[:, 0] * he[o1], xyz[:, o1])
        xyz[:, o2] = torch.where(sel, uv[:, 1] * he[o2], xyz[:, o2])
        nrm[:, a] = torch.where(sel, sign, nrm[:, a])
    xyz = xyz.to(torch.float32)
    if noise > 0:
        xyz = xyz + noise * torch.randn((n, 3), generator=gen)
    xyz = xyz - torch.tensor(sensor, dtype=torch.float32)
    return make_cloud(to_device(xyz, device), normals=to_device(-nrm, device))


def add_noise(gen: torch.Generator, cloud: PointCloud, sigma: float) -> PointCloud:
    """Gaussian position noise of std ``sigma``, drawn on the host from
    ``gen``."""
    noise = to_device(torch.randn(tuple(cloud.xyz.shape), generator=gen), cloud.device)
    return cloud.with_xyz(cloud.xyz + sigma * noise)
