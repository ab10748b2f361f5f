"""Cloud and trajectory IO: CSV, PCD, PLY and VTK clouds, TUM pose logs,
trajectory error.

Counterpart of the JAX package's ``utils/io.py``: the libpointmatcher
DataPoints formats (reference IO.cpp: CSV with header autodetect, PLY,
legacy VTK) with load/save dispatch on the extension, PCD ascii/binary
export and import of maps (reference SlamWrapper::saveMap,
SlamWrapper.cpp:545-582), the TUM-style pose log (reference
RosbagRangeDataProcessorRos.cpp:267-277, '# timestamp x y z q_x q_y q_z
q_w') and the absolute trajectory error.  Files are decoded on the host
with numpy; ``make_cloud`` uploads the arrays through pinned memory.
"""
from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from . import se3
from .pointcloud import PointCloud, make_cloud, to_numpy
from .timebuf import _quat_to_matrix


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


def load_csv_cloud(path: str, capacity: Optional[int] = None, device="cuda") -> PointCloud:
    """An x,y,z[,nx,ny,nz] cloud in CSV or whitespace table form, headered
    ('x,y,z,nx,ny,nz') or not (IO.cpp's CSV loader autodetects the same
    way)."""
    with open(path) as f:
        first = f.readline().strip()
    delimiter = "," if "," in first else None
    tokens = first.split(",") if delimiter else first.split()
    try:
        [float(tok) for tok in tokens]
        has_header = False
    except ValueError:
        has_header = True
    data = np.loadtxt(path, delimiter=delimiter, skiprows=1 if has_header else 0,
                      dtype=np.float32)
    if data.ndim == 1:
        data = data[None, :]
    normals = None
    if has_header:
        col = {c.strip().lower(): i for i, c in enumerate(tokens)}
        xyz = data[:, [col["x"], col["y"], col["z"]]]
        if all(k in col for k in ("nx", "ny", "nz")):
            normals = data[:, [col["nx"], col["ny"], col["nz"]]]
    else:
        xyz = data[:, :3]
        normals = data[:, 3:6] if data.shape[1] >= 6 else None
    return make_cloud(xyz, normals=normals, capacity=capacity, device=device)


_RGB = ("r", "g", "b")


def save_ply(path: str, cloud: PointCloud, binary: bool = True,
             colors: Optional[np.ndarray] = None) -> None:
    """Write a PLY file (ascii or binary_little_endian) with xyz, normals
    when present and uint8 RGB colors, given or from the cloud's r, g, b
    channels in [0, 1] (≙ DataPoints PLY save, IO.h:182-227)."""
    xyz, normals = to_numpy(cloud)
    if colors is None and cloud.attrs is not None and set(_RGB) <= set(cloud.attr_names):
        mask = cloud.mask.cpu().numpy()
        attrs = cloud.attrs.cpu().numpy()[mask]
        rgb = np.stack([attrs[:, cloud.attr_names.index(k)] for k in _RGB], -1)
        colors = np.clip(rgb * 255.0, 0, 255).astype(np.uint8)
    has_n = np.any(np.abs(normals) > 1e-9)
    n = xyz.shape[0]
    props = ["property float x", "property float y", "property float z"]
    fields = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
    if has_n:
        props += ["property float nx", "property float ny", "property float nz"]
        fields += [("nx", "<f4"), ("ny", "<f4"), ("nz", "<f4")]
    if colors is not None:
        colors = np.asarray(colors, dtype=np.uint8)[:n]
        props += ["property uchar red", "property uchar green", "property uchar blue"]
        fields += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
    header = "\n".join(["ply", f"format {'binary_little_endian' if binary else 'ascii'} 1.0",
                        f"element vertex {n}"] + props + ["end_header"]) + "\n"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    columns = [xyz] + ([normals] if has_n else [])
    if binary:
        rec = np.empty(n, dtype=fields)
        names = [name for name, _ in fields]
        values = np.hstack(columns)
        for i, name in enumerate(names[:values.shape[1]]):
            rec[name] = values[:, i]
        if colors is not None:
            rec["red"], rec["green"], rec["blue"] = colors[:, 0], colors[:, 1], colors[:, 2]
        with open(path, "wb") as f:
            f.write(header.encode())
            f.write(rec.tobytes())
    else:
        with open(path, "w") as f:
            f.write(header)
            for i in range(n):
                line = " ".join(f"{v:.6f}" for c in columns for v in c[i])
                if colors is not None:
                    line += " " + " ".join(str(int(v)) for v in colors[i])
                f.write(line + "\n")


_PLY_TYPES = {"float": "<f4", "float32": "<f4", "double": "<f8", "uchar": "u1",
              "uint8": "u1", "char": "i1", "int8": "i1", "short": "<i2", "ushort": "<u2",
              "int": "<i4", "int32": "<i4", "uint": "<u4", "uint32": "<u4"}


def load_ply(path: str, capacity: Optional[int] = None, device="cuda") -> PointCloud:
    """Read PLY (ascii / binary_little_endian) vertex clouds with optional
    normals; red/green/blue colors load into r/g/b channels in [0, 1]."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt, n, props, in_vertex = None, 0, [], False
        while True:
            line = f.readline().decode("ascii").strip()
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("element"):
                _, name, cnt = line.split()
                in_vertex = name == "vertex"
                if in_vertex:
                    n = int(cnt)
            elif line.startswith("property") and in_vertex:
                toks = line.split()
                if toks[1] == "list":
                    raise ValueError("list properties unsupported in vertex element")
                props.append((toks[1], toks[2]))
            elif line == "end_header":
                break
        if fmt == "binary_little_endian":
            rec_dt = np.dtype([(name, _PLY_TYPES[t]) for t, name in props])
            rec = np.frombuffer(f.read(n * rec_dt.itemsize), dtype=rec_dt, count=n)

            def get(name):
                return rec[name].astype(np.float32)
        elif fmt == "ascii":
            data = np.loadtxt(f, dtype=np.float64, max_rows=n)
            if data.ndim == 1:
                data = data[None, :]
            cols = {name: i for i, (_, name) in enumerate(props)}

            def get(name):
                return data[:, cols[name]].astype(np.float32)
        else:
            raise ValueError(f"unsupported PLY format: {fmt}")
    names = [name for _, name in props]
    xyz = np.stack([get("x"), get("y"), get("z")], axis=-1)
    normals = None
    if all(k in names for k in ("nx", "ny", "nz")):
        normals = np.stack([get("nx"), get("ny"), get("nz")], axis=-1)
    cloud = make_cloud(xyz, normals=normals, capacity=capacity, device=device)
    if all(k in names for k in ("red", "green", "blue")):
        rgb = np.zeros((cloud.capacity, 3), np.float32)
        rgb[:n] = np.stack([get(k) / 255.0 for k in ("red", "green", "blue")], -1)
        from .device import to_device

        cloud = dataclasses.replace(cloud, attrs=to_device(rgb, cloud.device),
                                    attr_names=_RGB)
    return cloud


def save_vtk(path: str, cloud: PointCloud) -> None:
    """Write a legacy-ASCII VTK POLYDATA point cloud (+ normals when
    present), the format of DataPoints::saveVTK and libpointmatcher's
    golden-test clouds."""
    xyz, normals = to_numpy(cloud)
    has_n = np.any(np.abs(normals) > 1e-9)
    n = xyz.shape[0]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write("# vtk DataFile Version 3.0\n")
        f.write("open3d_slam_advanced_rss_2024_public_tpu_torch cloud\n")
        f.write("ASCII\nDATASET POLYDATA\n")
        f.write(f"POINTS {n} float\n")
        np.savetxt(f, xyz, fmt="%.6f")
        f.write(f"VERTICES {n} {2 * n}\n")
        for i in range(n):
            f.write(f"1 {i}\n")
        if has_n:
            f.write(f"POINT_DATA {n}\n")
            f.write("NORMALS normals float\n")
            np.savetxt(f, normals, fmt="%.6f")


def load_vtk(path: str, capacity: Optional[int] = None, device="cuda") -> PointCloud:
    """Read legacy-ASCII VTK POLYDATA/UNSTRUCTURED_GRID points + NORMALS."""
    with open(path) as f:
        lines = f.readlines()
    xyz = normals = None
    i = n = 0

    def read_floats(start: int, count: int) -> Tuple[np.ndarray, int]:
        vals: List[float] = []
        j = start
        while len(vals) < count and j < len(lines):
            vals.extend(float(tok) for tok in lines[j].split())
            j += 1
        return np.asarray(vals[:count], dtype=np.float32), j

    while i < len(lines):
        toks = lines[i].split()
        if toks and toks[0] == "POINTS":
            n = int(toks[1])
            flat, i = read_floats(i + 1, 3 * n)
            xyz = flat.reshape(n, 3)
            continue
        if toks and toks[0] == "NORMALS":
            flat, i = read_floats(i + 1, 3 * n)
            normals = flat.reshape(n, 3)
            continue
        i += 1
    if xyz is None:
        raise ValueError(f"{path}: no POINTS section found")
    return make_cloud(xyz, normals=normals, capacity=capacity, device=device)


_LOADERS = {".csv": load_csv_cloud, ".xyz": load_csv_cloud, ".pcd": load_pcd,
            ".ply": load_ply, ".vtk": load_vtk}


def load_cloud(path: str, capacity: Optional[int] = None, device="cuda") -> PointCloud:
    """Load a cloud, dispatching on the extension (csv/xyz/pcd/ply/vtk),
    ≙ DataPoints::load."""
    ext = os.path.splitext(path)[1].lower()
    if ext not in _LOADERS:
        raise ValueError(f"unsupported cloud format {ext!r} (known: {sorted(_LOADERS)})")
    return _LOADERS[ext](path, capacity=capacity, device=device)


def save_cloud(path: str, cloud: PointCloud, binary: bool = True) -> None:
    """Save a cloud, dispatching on the extension (pcd/ply/vtk)."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".pcd":
        save_pcd(path, cloud, binary=binary)
    elif ext == ".ply":
        save_ply(path, cloud, binary=binary)
    elif ext == ".vtk":
        save_vtk(path, cloud)
    else:
        raise ValueError(f"unsupported cloud format {ext!r} (known: .pcd .ply .vtk)")


def save_tum_trajectory(path: str, times: List[float], poses: List[np.ndarray]) -> None:
    """TUM format: '# timestamp x y z q_x q_y q_z q_w', one pose per line."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write("# timestamp x y z q_x q_y q_z q_w\n")
        for t, T in zip(times, poses):
            T = np.asarray(T)
            # (w, x, y, z) with w >= 0, as the JAX package writes it.
            q = se3.quat_from_matrix(torch.as_tensor(T[:3, :3], dtype=torch.float32)).numpy()
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
