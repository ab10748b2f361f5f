"""Cropping volumes as masked predicates over fixed-capacity clouds.

Counterpart of the JAX package's ``ops/croppers.py`` (reference
croppers.cpp:23-246: Cylinder, MinRadius, MaxRadius and MinMaxRadius
croppers with an invert flag, pose-settable).  Each cropper returns a
boolean mask; callers combine it with ``PointCloud.with_mask``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..utils import se3
from ..utils.pointcloud import PointCloud

Tensor = torch.Tensor

_INF = 3.0e38


@dataclasses.dataclass(frozen=True)
class CropVolume:
    """Spherical-shell / vertical-cylinder crop volume positioned by
    ``pose`` (the volume frame in the cloud frame; None = identity);
    ``invert`` keeps the complement."""

    pose: Optional[Tensor] = None
    min_radius: float = 0.0
    max_radius: float = _INF
    cylinder_radius: float = _INF
    half_height: float = _INF
    invert: bool = False

    def contains(self, xyz: Tensor) -> Tensor:
        local = xyz
        if self.pose is not None:
            local = se3.apply(se3.inverse(self.pose.to(xyz.device)), xyz)
        x, y, z = local[..., 0], local[..., 1], local[..., 2]
        # sqrt of the sum of squares, the same arithmetic as jnp.linalg.norm.
        rho2 = x * x + y * y
        r = torch.sqrt(rho2 + z * z)
        inside = (r >= self.min_radius) & (r <= self.max_radius)
        inside &= (torch.sqrt(rho2) <= self.cylinder_radius) & (z.abs() <= self.half_height)
        return ~inside if self.invert else inside

    def crop_mask(self, cloud: PointCloud) -> Tensor:
        return cloud.mask & self.contains(cloud.xyz)

    def crop(self, cloud: PointCloud) -> PointCloud:
        return cloud.with_mask(self.contains(cloud.xyz))

    def with_pose(self, pose: Tensor) -> "CropVolume":
        return dataclasses.replace(self, pose=pose)


def max_radius_cropper(radius, pose=None, invert: bool = False) -> CropVolume:
    return CropVolume(pose=pose, max_radius=float(radius), invert=invert)


def min_radius_cropper(radius, pose=None, invert: bool = False) -> CropVolume:
    return CropVolume(pose=pose, min_radius=float(radius), invert=invert)


def min_max_radius_cropper(min_radius, max_radius, pose=None,
                           invert: bool = False) -> CropVolume:
    return CropVolume(pose=pose, min_radius=float(min_radius),
                      max_radius=float(max_radius), invert=invert)


def cylinder_cropper(radius, half_height, pose=None, invert: bool = False) -> CropVolume:
    return CropVolume(pose=pose, cylinder_radius=float(radius),
                      half_height=float(half_height), invert=invert)


def cropper_from_config(kind: str, min_radius, max_radius, pose=None,
                        invert: bool = False) -> CropVolume:
    """Factory by name, as croppingVolumeFactory (croppers.cpp:23-47)."""
    kind = kind.lower()
    if kind in ("maxradius", "max_radius"):
        return max_radius_cropper(max_radius, pose, invert)
    if kind in ("minradius", "min_radius"):
        return min_radius_cropper(min_radius, pose, invert)
    if kind in ("minmaxradius", "min_max_radius"):
        return min_max_radius_cropper(min_radius, max_radius, pose, invert)
    if kind == "cylinder":
        return cylinder_cropper(max_radius, half_height=max_radius, pose=pose, invert=invert)
    raise ValueError(f"unknown cropper kind: {kind}")
