"""IMU buffer with gravity-based attitude initialization.

≙ reference ImuBuffer + ImuSignalLowPassFilter
(reference: ros/open3d_slam_ros/src/ImuBuffer.cpp, include/.../
ImuBuffer.hpp:21-60 — ring buffer of IMU samples, exponential low-pass on
accelerometer, estimateAttitudeFromImu gravity-aligns the start pose and
estimates gyro bias while stationary).  A copy of the JAX package's
``models/imu.py`` on numpy: it needs no device.
"""
from __future__ import annotations

from collections import deque
from typing import Deque, Optional, Tuple

import numpy as np

from ..utils.timebuf import _so3_exp


class ImuLowPassFilter:
    """First-order exponential low-pass (≙ ImuSignalLowPassFilter.hpp)."""

    def __init__(self, alpha: float = 0.1):
        self.alpha = alpha
        self._state: Optional[np.ndarray] = None

    def update(self, x) -> np.ndarray:
        x = np.asarray(x, dtype=np.float64)
        if self._state is None:
            self._state = x.copy()
        else:
            self._state = self.alpha * x + (1.0 - self.alpha) * self._state
        return self._state.copy()


class ImuBuffer:
    def __init__(self, size_limit: int = 4000, lowpass_alpha: float = 0.1):
        self._buf: Deque[Tuple[float, np.ndarray, np.ndarray]] = deque(maxlen=size_limit)
        self.accel_filter = ImuLowPassFilter(lowpass_alpha)

    def __len__(self) -> int:
        return len(self._buf)

    def push(self, time: float, linear_acceleration, angular_velocity) -> None:
        acc = self.accel_filter.update(linear_acceleration)
        self._buf.append((float(time),
                          np.asarray(acc, np.float64),
                          np.asarray(angular_velocity, np.float64)))

    def estimate_attitude(self, window: int = 200):
        """Gravity-aligned initial attitude + gyro bias from a (nominally
        stationary) window of samples.

        Returns (R_world_imu 3x3 rotating the IMU frame so its mean
        acceleration points along +z/world gravity, gyro_bias [3]).
        ≙ estimateAttitudeFromImu (ImuBuffer.hpp:50).
        """
        if not self._buf:
            return np.eye(3, dtype=np.float32), np.zeros(3, dtype=np.float32)
        samples = list(self._buf)[-window:]
        acc = np.mean([s[1] for s in samples], axis=0)
        gyro_bias = np.mean([s[2] for s in samples], axis=0)
        g_meas = acc / max(np.linalg.norm(acc), 1e-9)
        g_world = np.array([0.0, 0.0, 1.0])
        # Rotation taking measured gravity direction to world +z.
        v = np.cross(g_meas, g_world)
        c = float(np.dot(g_meas, g_world))
        if np.linalg.norm(v) < 1e-9:
            R = np.eye(3) if c > 0 else np.diag([1.0, -1.0, -1.0])
        else:
            angle = np.arccos(np.clip(c, -1.0, 1.0))
            axis = v / np.linalg.norm(v)
            R = _so3_exp(axis * angle)
        return R.astype(np.float32), gyro_bias.astype(np.float32)

    def latest(self):
        return self._buf[-1] if self._buf else None
