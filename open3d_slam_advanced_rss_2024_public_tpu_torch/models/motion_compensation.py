"""Constant-velocity LiDAR de-skewing.

Counterpart of the JAX package's ``models/motion_compensation.py``
(reference MotionCompensation.cpp:24-150: velocity estimated from the last N
poses of the pose buffer :32-66, per-point azimuth phase :129-148, per-point
SE(3) correction :73-127).  Given the scan and the (angular, linear) twist
over one scan period, every point is moved by exp((phase_i - 1) * xi), the
phase from the per-point time channel where the scan has one; the host
estimates the twist from its pose buffer.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..utils import se3
from ..utils.pointcloud import PointCloud
from ..utils.timebuf import TransformInterpolationBuffer

Tensor = torch.Tensor


def compute_phase(xyz: Tensor, is_spinning_clockwise: bool = True) -> Tensor:
    """Relative scan phase in [0, 1] per point from azimuth: 0 at the start
    of the sweep (azimuth pi, the atan2 branch cut), 1 at its end
    (≙ computePhase, MotionCompensation.cpp:129-148)."""
    azimuth = torch.arctan2(xyz[..., 1], xyz[..., 0])  # (-pi, pi]
    frac = (math.pi - azimuth) / (2.0 * math.pi)
    return frac if is_spinning_clockwise else 1.0 - frac


def undistort(scan: PointCloud, twist: Tensor, is_spinning_clockwise: bool = True) -> PointCloud:
    """Apply the per-point motion correction exp((phase - 1) * twist).
    ``twist`` is the se(3) motion (omega, v) of the sensor over one full
    scan period in the sensor frame; points measured earlier in the sweep
    are corrected forward to the scan-end frame.  Where the scan carries a
    per-point time channel ``t`` (seconds from the sweep's first point, as
    ``frontends/rosbag.py`` decodes it), the phase is t over the largest t
    of a valid lane, clamped to [0, 1]; else it is the azimuth phase.  The
    span stays on the device: nothing is read back."""
    if scan.has_attr("t"):
        t = scan.attr("t")
        span = torch.clamp(torch.where(scan.mask, t, 0.0).amax(-1, keepdim=True), min=1e-6)
        phase = torch.clamp(t / span, 0.0, 1.0)
    else:
        phase = compute_phase(scan.xyz, is_spinning_clockwise)
    alpha = (phase - 1.0)[:, None]  # 0 for the newest points, -1 for the oldest
    T = se3.se3_exp(alpha * twist.to(torch.float32)[None, :])  # [N, 4, 4]
    xyz = (T[:, :3, :3] @ scan.xyz[:, :, None])[:, :, 0] + T[:, :3, 3]
    nrm = (T[:, :3, :3] @ scan.normals[:, :, None])[:, :, 0]
    return dataclasses.replace(scan, xyz=torch.where(scan.mask[:, None], xyz, scan.xyz),
                               normals=torch.where(scan.mask[:, None], nrm, 0.0))


def estimate_twist_from_buffer(buffer: TransformInterpolationBuffer, scan_duration: float,
                               num_poses: int = 3, calibration=None) -> np.ndarray:
    """Host-side velocity estimate over the last ``num_poses`` buffer poses
    (≙ estimateLinearAndAngularVelocity, MotionCompensation.cpp:32-66).
    Returns the se(3) twist covering one scan_duration, in the cloud frame:
    where the buffer holds an external odometry's body frame,
    ``calibration`` (cloud <- body, the Mapper's) conjugates the motion
    into the cloud frame, as the Mapper's initial guess does.  (The JAX
    package takes the body-frame twist; the two agree where the
    calibration is the identity.)"""
    if len(buffer) < 2:
        return np.zeros(6, dtype=np.float32)
    items = buffer.items()[-min(num_poses, len(buffer)):]
    t0, T0 = items[0]
    t1, T1 = items[-1]
    dt = max(t1 - t0, 1e-6)
    T0 = torch.from_numpy(np.asarray(T0, np.float32))
    T1 = torch.from_numpy(np.asarray(T1, np.float32))
    delta = se3.compose(se3.inverse(T0), T1)
    if calibration is not None:
        C = torch.from_numpy(np.asarray(calibration, np.float32))
        delta = C @ delta @ se3.inverse(C)
    return se3.se3_log(delta).numpy() * (scan_duration / dt)
