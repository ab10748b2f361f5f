"""Cloud and trajectory IO: PCD maps, TUM pose logs, trajectory error.

Counterpart of the parts of the JAX package's ``utils/io.py`` that the SLAM
runtime calls: PCD ascii/binary export and import of maps (reference
SlamWrapper::saveMap, SlamWrapper.cpp:545-582), the TUM-style pose log
(reference RosbagRangeDataProcessorRos.cpp:267-277, '# timestamp x y z q_x
q_y q_z q_w') and the absolute trajectory error.  Host-side numpy.
"""
from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

from .pointcloud import PointCloud, make_cloud
from .timebuf import _quat_from_matrix, _quat_to_matrix


def to_numpy(cloud: PointCloud):
    """The valid points as host numpy arrays (xyz, normals)."""
    mask = cloud.mask.cpu().numpy()
    return cloud.xyz.cpu().numpy()[mask], cloud.normals.cpu().numpy()[mask]


def save_pcd(path: str, cloud: PointCloud, binary: bool = True) -> None:
    """Write a PCD v0.7 file with xyz (+ normals when present)."""
    xyz, normals = to_numpy(cloud)
    has_n = np.any(np.abs(normals) > 1e-9)
    fields = ["x", "y", "z"] + (["normal_x", "normal_y", "normal_z"] if has_n else [])
    data = np.hstack([xyz, normals]) if has_n else xyz
    n = xyz.shape[0]
    header = "\n".join([
        "# .PCD v0.7 - Point Cloud Data file format",
        "VERSION 0.7",
        f"FIELDS {' '.join(fields)}",
        f"SIZE {' '.join(['4'] * len(fields))}",
        f"TYPE {' '.join(['F'] * len(fields))}",
        f"COUNT {' '.join(['1'] * len(fields))}",
        f"WIDTH {n}",
        "HEIGHT 1",
        "VIEWPOINT 0 0 0 1 0 0 0",
        f"POINTS {n}",
        f"DATA {'binary' if binary else 'ascii'}",
    ]) + "\n"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    if binary:
        with open(path, "wb") as f:
            f.write(header.encode())
            f.write(data.astype("<f4").tobytes())
    else:
        with open(path, "w") as f:
            f.write(header)
            np.savetxt(f, data, fmt="%.6f")


def load_pcd(path: str, capacity: Optional[int] = None, device="cuda") -> PointCloud:
    """Read PCD v0.7 ascii/binary with float32 fields."""
    with open(path, "rb") as f:
        fields, n = [], 0
        data_mode = "ascii"
        while True:
            line = f.readline().decode("ascii", errors="replace").strip()
            if line.startswith("FIELDS"):
                fields = line.split()[1:]
            elif line.startswith("POINTS"):
                n = int(line.split()[1])
            elif line.startswith("DATA"):
                data_mode = line.split()[1]
                break
        ncol = len(fields)
        if data_mode == "binary":
            data = np.frombuffer(f.read(n * ncol * 4), dtype="<f4").reshape(n, ncol).copy()
        else:
            data = np.loadtxt(f, dtype=np.float32).reshape(n, ncol)
    col = {name: i for i, name in enumerate(fields)}
    xyz = data[:, [col["x"], col["y"], col["z"]]]
    normals = None
    if "normal_x" in col:
        normals = data[:, [col["normal_x"], col["normal_y"], col["normal_z"]]]
    return make_cloud(xyz, normals=normals, capacity=capacity, device=device)


def save_tum_trajectory(path: str, times: List[float], poses: List[np.ndarray]) -> None:
    """TUM format: '# timestamp x y z q_x q_y q_z q_w', one pose per line."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write("# timestamp x y z q_x q_y q_z q_w\n")
        for t, T in zip(times, poses):
            T = np.asarray(T)
            q = _quat_from_matrix(T[:3, :3])  # (w, x, y, z)
            x, y, z = T[:3, 3]
            f.write(f"{t:.9f} {x:.6f} {y:.6f} {z:.6f} "
                    f"{q[1]:.6f} {q[2]:.6f} {q[3]:.6f} {q[0]:.6f}\n")


def load_tum_trajectory(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (times [N], poses [N, 4, 4])."""
    rows = np.loadtxt(path, comments="#", dtype=np.float64)
    if rows.ndim == 1:
        rows = rows[None, :]
    poses = []
    for r in rows:
        x, y, z, qx, qy, qz, qw = r[1:8]
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = _quat_to_matrix(np.array([qw, qx, qy, qz]))
        T[:3, 3] = [x, y, z]
        poses.append(T)
    return rows[:, 0], np.stack(poses)


def ate_rmse(est_poses: np.ndarray, gt_poses: np.ndarray, align: bool = True) -> float:
    """Absolute trajectory error RMSE after optional SE(3) (Umeyama)
    alignment."""
    p_est = np.asarray([T[:3, 3] for T in est_poses])
    p_gt = np.asarray([T[:3, 3] for T in gt_poses])
    if align and len(p_est) >= 3:
        mu_e, mu_g = p_est.mean(0), p_gt.mean(0)
        de, dg = p_est - mu_e, p_gt - mu_g
        U, _, Vt = np.linalg.svd(dg.T @ de / len(p_est))
        C = np.eye(3)
        C[2, 2] = np.sign(np.linalg.det(U @ Vt))
        p_est = (U @ C @ Vt @ de.T).T + mu_g
        p_gt = dg + mu_g
    err = p_est - p_gt
    return float(np.sqrt((err ** 2).sum(axis=1).mean()))
