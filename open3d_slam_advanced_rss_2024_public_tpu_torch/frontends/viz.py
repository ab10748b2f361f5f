"""Visualization export: colored submap assembly, trajectory tube, axes.

Counterpart of the JAX package's ``frontends/viz.py``, the replacement for
the reference's RViz-facing surface (ros/open3d_slam_ros/src/helpers_ros.cpp
— colored submap assembly and coordinate-axes markers;
RosbagRangeDataProcessorRos.cpp:283-345 — the trajectory exported as a tube
sampled into a PCD; visualizer_node.cpp — the standalone map publisher).
Everything renders to colored point clouds written as PLY/PCD.

The submaps' voxel tables live on the device.  Each is read back through
one pinned copy and an event (``utils/device.HostCopy``): the caller's
thread only enqueues the copies, and the thread that renders waits on the
events, so a publisher fed from the Mapper's thread never makes it wait on
the device.  The rendering itself is host numpy.
"""
from __future__ import annotations

import concurrent.futures
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..utils import io as cloud_io
from ..utils.device import HostCopy
from ..utils.pointcloud import make_cloud

# A rotating, maximally-distinct palette for submap coloring (like the
# reference's Colors helpers in pointmatcher_ros visualization utils).
_PALETTE = np.asarray([
    [230, 25, 75], [60, 180, 75], [255, 225, 25], [0, 130, 200],
    [245, 130, 48], [145, 30, 180], [70, 240, 240], [240, 50, 230],
    [210, 245, 60], [250, 190, 212], [0, 128, 128], [220, 190, 255],
    [170, 110, 40], [255, 250, 200], [128, 0, 0], [170, 255, 195],
], dtype=np.uint8)

HostClouds = List[Tuple[np.ndarray, np.ndarray]]


def submap_color(i: int) -> np.ndarray:
    return _PALETTE[i % len(_PALETTE)]


def _copy_submaps(submaps: Sequence) -> List[HostCopy]:
    """Enqueue the copy of each submap's voxel means (xyz, normals, mask)
    to pinned host memory; nothing waits."""
    return [HostCopy([c.xyz, c.normals, c.mask]) for c in (sm.map.cloud for sm in submaps)]


def _land(copies: List[HostCopy]) -> HostClouds:
    """Wait for the copies; each submap's valid (xyz, normals)."""
    out = []
    for h in copies:
        xyz, nrm, mask = h.wait()
        out.append((xyz[mask], nrm[mask]))
    return out


def _assemble(clouds: HostClouds) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    xyzs, nrms, cols = [], [], []
    for i, (xyz, nrm) in enumerate(clouds):
        if xyz.shape[0] == 0:
            continue
        xyzs.append(xyz)
        nrms.append(nrm)
        cols.append(np.tile(submap_color(i), (xyz.shape[0], 1)))
    if not xyzs:
        return (np.zeros((0, 3), np.float32),) * 2 + (np.zeros((0, 3), np.uint8),)
    return (np.concatenate(xyzs).astype(np.float32),
            np.concatenate(nrms).astype(np.float32),
            np.concatenate(cols))


def colored_submap_assembly(submaps: Sequence) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Assemble all submap clouds, one color per submap.

    ≙ helpers_ros assembleColoredPointCloud.  Returns (xyz [N,3],
    normals [N,3], colors u8[N,3]).
    """
    return _assemble(_land(_copy_submaps(submaps)))


def _save_colored(path: str, clouds: HostClouds) -> int:
    xyz, nrm, col = _assemble(clouds)
    cloud_io.save_ply(path, make_cloud(xyz, normals=nrm, device="cpu"), binary=True,
                      colors=col)
    return xyz.shape[0]


def save_colored_submaps(path: str, submaps: Sequence) -> int:
    """Write the colored assembly as PLY; returns the point count."""
    return _save_colored(path, _land(_copy_submaps(submaps)))


def trajectory_tube_cloud(poses: Sequence[np.ndarray], radius: float = 0.1,
                          n_ring: int = 12, step_subdiv: int = 4) -> np.ndarray:
    """Sample a tube of points around the trajectory polyline.

    ≙ the reference's trajectory tube-mesh PCD export
    (RosbagRangeDataProcessorRos.cpp:283-345: path -> cylinder marker chain
    -> sampled point cloud -> PCD).  Returns xyz f32[N,3].
    """
    pts: List[np.ndarray] = []
    centers = np.asarray([np.asarray(T)[:3, 3] for T in poses], dtype=np.float32)
    if len(centers) < 2:
        return centers.reshape(-1, 3)
    ring_angles = np.linspace(0.0, 2 * np.pi, n_ring, endpoint=False)
    for a, b in zip(centers[:-1], centers[1:]):
        d = b - a
        L = np.linalg.norm(d)
        if L < 1e-9:
            continue
        d = d / L
        # Orthonormal frame around the segment direction.
        up = np.array([0.0, 0.0, 1.0], np.float32)
        if abs(d @ up) > 0.99:
            up = np.array([1.0, 0.0, 0.0], np.float32)
        u = np.cross(d, up)
        u /= np.linalg.norm(u)
        v = np.cross(d, u)
        for t in np.linspace(0.0, 1.0, step_subdiv, endpoint=False):
            c = a + t * L * d
            ring = c[None, :] + radius * (
                np.cos(ring_angles)[:, None] * u[None, :]
                + np.sin(ring_angles)[:, None] * v[None, :])
            pts.append(ring.astype(np.float32))
    return np.concatenate(pts) if pts else centers.reshape(-1, 3)


def save_trajectory_tube(path: str, poses: Sequence[np.ndarray],
                         radius: float = 0.1) -> int:
    xyz = trajectory_tube_cloud(poses, radius=radius)
    cloud_io.save_cloud(path, make_cloud(xyz, device="cpu"))
    return xyz.shape[0]


def axes_cloud(pose: np.ndarray, length: float = 1.0,
               n_samples: int = 20) -> Tuple[np.ndarray, np.ndarray]:
    """Sample a coordinate-axes glyph at ``pose``: x=red, y=green, z=blue.

    ≙ helpers_ros submap coordinate-axes markers (generateMarkersForSubmaps).
    Returns (xyz [3*n,3], colors u8[3*n,3]).
    """
    T = np.asarray(pose, dtype=np.float32)
    ts = np.linspace(0.0, length, n_samples, dtype=np.float32)
    xyzs, cols = [], []
    axis_colors = np.asarray([[255, 0, 0], [0, 255, 0], [0, 0, 255]], np.uint8)
    for ax in range(3):
        seg = T[:3, 3][None, :] + ts[:, None] * T[:3, ax][None, :]
        xyzs.append(seg)
        cols.append(np.tile(axis_colors[ax], (n_samples, 1)))
    return np.concatenate(xyzs), np.concatenate(cols)


def _save_origins(path: str, poses: Sequence[np.ndarray], length: float = 1.0) -> int:
    xyzs, cols = [], []
    for pose in poses:
        xyz, col = axes_cloud(pose, length=length)
        xyzs.append(xyz)
        cols.append(col)
    if not xyzs:
        return 0
    xyz = np.concatenate(xyzs)
    cloud_io.save_ply(path, make_cloud(xyz, device="cpu"), binary=True,
                      colors=np.concatenate(cols))
    return xyz.shape[0]


def save_submap_origins(path: str, submaps: Sequence, length: float = 1.0) -> int:
    """Write per-submap origin axes glyphs as one colored PLY
    (≙ submap_origins RViz topic)."""
    return _save_origins(path, [sm.pose for sm in submaps], length=length)


def export_visualization_bundle(out_dir: str, slam, radius: float = 0.1) -> dict:
    """One-call export of the observability surface for a SlamWrapper:
    colored submaps, trajectory tube, submap origin axes.

    ≙ the reference's per-scan RViz publishing set (SlamWrapperRos.cpp:
    313-330) rendered to files instead of topics.
    """
    os.makedirs(out_dir, exist_ok=True)
    written = {}
    submaps = slam.mapper.submaps.submaps
    written["colored_submaps"] = save_colored_submaps(
        os.path.join(out_dir, "submaps_colored.ply"), submaps)
    written["trajectory_tube"] = save_trajectory_tube(
        os.path.join(out_dir, "trajectory_tube.pcd"), slam.trajectory_poses,
        radius=radius)
    written["submap_origins"] = save_submap_origins(
        os.path.join(out_dir, "submap_origins.ply"), submaps)
    return written


class LiveVisualizationPublisher:
    """The live publishing surface (≙ SlamWrapperRos visualization worker,
    SlamWrapperRos.cpp:247-330, publishing assembled map / submaps /
    submap-origin axes / tracked + best-guess paths at a fixed rate, and
    helpers_ros publishIfSubscriberExists).

    Transport-agnostic: every tick renders the current bundle into
    ``out_dir`` via ATOMIC tmp+rename (a viewer or file-watcher always sees
    a complete file — the "topic"), and optionally invokes ``publish_fn``
    with the written paths (wire it to any IPC/network transport).  Ticks
    are skipped while nothing new arrived (the subscriber-exists analogue:
    no work without consumers of fresh data).

    Reads only the submaps' latest flushed tables and the host pose
    buffers; it never flushes or locks the Mapper.  ``tick(slam,
    wait=False)`` only snapshots and enqueues the tables' copies on the
    caller's thread and renders on the publisher's own thread (``close``
    waits for those renders).
    """

    def __init__(self, out_dir: str, publish_fn=None, tube_radius: float = 0.05):
        self.out_dir = out_dir
        self.publish_fn = publish_fn
        self.tube_radius = tube_radius
        self._last_count = -1
        self.publish_count = 0
        self._pool: Optional[concurrent.futures.ThreadPoolExecutor] = None
        self._pending: List[concurrent.futures.Future] = []
        os.makedirs(out_dir, exist_ok=True)

    def _atomic(self, name: str, write):
        path = os.path.join(self.out_dir, name)
        base, ext = os.path.splitext(path)
        tmp = base + ".tmp" + ext  # keep the extension for format sniffing
        write(tmp)
        os.replace(tmp, path)
        return path

    def tick(self, slam, wait: bool = True):
        """Render one bundle if the trajectory advanced: the written paths,
        or None when skipped; with ``wait=False`` a future of them."""
        n_poses = len(slam.trajectory_poses)
        if n_poses == self._last_count or n_poses == 0:
            return None
        self._last_count = n_poses
        submaps = list(slam.mapper.submaps.submaps)
        snapshot = (_copy_submaps(submaps), [sm.pose.copy() for sm in submaps],
                    [p.copy() for p in list(slam.trajectory_poses)],
                    [T for _, T in slam.mapper.best_guess_buffer.items()])
        if wait:
            return self._render(*snapshot)
        if self._pool is None:
            self._pool = concurrent.futures.ThreadPoolExecutor(1, thread_name_prefix="viz")
        future = self._pool.submit(self._render, *snapshot)
        self._pending.append(future)
        return future

    def _render(self, copies, origins, poses, best) -> dict:
        clouds = _land(copies)
        written = {"submaps_colored": self._atomic(
            "submaps_colored.ply", lambda p: _save_colored(p, clouds))}
        written["trajectory_tube"] = self._atomic(
            "trajectory_tube.pcd",
            lambda p: save_trajectory_tube(p, poses, radius=self.tube_radius))
        if best:
            written["best_guess_tube"] = self._atomic(
                "best_guess_tube.pcd",
                lambda p: save_trajectory_tube(p, best, radius=self.tube_radius * 0.6))
        written["submap_origins"] = self._atomic(
            "submap_origins.ply", lambda p: _save_origins(p, origins))
        self.publish_count += 1
        if self.publish_fn is not None:
            self.publish_fn(written)
        return written

    def close(self) -> None:
        """Wait for every render started with ``wait=False`` (raising the
        first one's error) and stop the publisher's thread."""
        pending, self._pending = self._pending, []
        try:
            for future in pending:
                future.result()
        finally:
            if self._pool is not None:
                self._pool.shutdown(wait=True)
                self._pool = None
