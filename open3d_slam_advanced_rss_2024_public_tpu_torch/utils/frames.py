"""Frame/transform registry — the framework's tiny TF buffer (a copy of
the JAX package's ``utils/frames.py``, which the port may not import).

≙ the reference's use of tf2_ros::Buffer for STATIC calibration lookups
(OnlineRangeDataProcessorRos.cpp:32-102: rangeSensorFrame <-
assumed_external_odometry_tracked_frame, rangeSensorFrame <- imuFrame).
The SLAM core only ever needs static (time-invariant) frame relations —
dynamic transforms live in TransformInterpolationBuffer — so this is a
graph of fixed 4x4s with path composition, not a time-indexed buffer.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

import numpy as np


class StaticTransformBuffer:
    """Thread-safe store of static frame relations with path lookup.

    ``set_transform(parent, child, T)`` records child->parent ( = pose of
    ``child`` expressed in ``parent``).  ``lookup(target, source)`` returns
    the 4x4 mapping source-frame coordinates into target-frame coordinates,
    composing along any path in the frame graph (inverses included), or
    None when the frames are not (yet) connected — the caller retries,
    exactly like tf2's canTransform polling.
    """

    def __init__(self):
        self._edges: Dict[Tuple[str, str], np.ndarray] = {}
        self._lock = threading.Lock()

    def set_transform(self, parent: str, child: str, T: np.ndarray) -> None:
        T = np.asarray(T, dtype=np.float32).reshape(4, 4)
        with self._lock:
            self._edges[(parent, child)] = T.copy()
            self._edges[(child, parent)] = np.linalg.inv(T).astype(np.float32)

    def can_transform(self, target: str, source: str) -> bool:
        return self.lookup(target, source) is not None

    def lookup(self, target: str, source: str) -> Optional[np.ndarray]:
        if target == source:
            return np.eye(4, dtype=np.float32)
        with self._lock:
            edges = dict(self._edges)
        # BFS over the frame graph (small: a handful of sensor frames).
        frontier: List[Tuple[str, np.ndarray]] = [
            (target, np.eye(4, dtype=np.float32))]
        seen = {target}
        while frontier:
            frame, T_target_frame = frontier.pop(0)
            for (parent, child), T_pc in edges.items():
                if parent != frame or child in seen:
                    continue
                T_target_child = (T_target_frame @ T_pc).astype(np.float32)
                if child == source:
                    return T_target_child
                seen.add(child)
                frontier.append((child, T_target_child))
        return None
