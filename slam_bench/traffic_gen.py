"""The one traffic generator: a seeded world, a path through it, and the
sensor data a deployment's configuration records along it, written as a
rosbag or as a KITTI odometry directory.

Frozen copies, written for the benchmark, of what ``chip_smoke.py`` and the
port's synthetic frontend do (``kitti_world``, ``write_kitti_dir``, the
OS1-32 bag writer, the lap, ``straight_trajectory``, ``perturb_odometry``,
``render_scan``), so that a change to the program changes no traffic.  The
traffic file gives the world and the path, the configuration file the
sensor.  ``--seed`` draws the sensor's points and noise, the odometry's
drift and the scans the check samples; the world's layout comes from the
traffic file's world seed where it gives one, so that every run does the
same work.
"""
from __future__ import annotations

import dataclasses
import math
import os
import shutil
from typing import Dict, List, Optional

import numpy as np
import torch

from . import bagfile
from .reference import se3


@dataclasses.dataclass
class Sequence:
    """What one mission replays, and what it stands for."""

    kind: str            # "rosbag" or "kitti"
    root: str            # the bag file or the KITTI root
    truth: np.ndarray    # f64[S, 4, 4] sensor pose at each frame
    bytes_written: int
    extras: Dict[str, object] = dataclasses.field(default_factory=dict)  # by extension


# Streams of ``seeds(seed, n)``: the world, the rendering and the odometry's
# drift (``generate``), the checked scans (``harness.measure``), then one for
# each extension in the configuration's order.
CHECK_STREAM, EXTENSION_STREAM = 3, 4


def seeds(seed: int, n: int) -> List[np.random.SeedSequence]:
    """``n`` independent streams from any whole number."""
    return np.random.SeedSequence([abs(int(seed)), int(seed < 0)]).spawn(n)


def torch_seed(ss: np.random.SeedSequence) -> int:
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


# -- world -------------------------------------------------------------------

def _box(rng, n, he):
    he = np.asarray(he, np.float64)
    areas = np.array([he[1] * he[2]] * 2 + [he[0] * he[2]] * 2 + [he[0] * he[1]] * 2)
    face = rng.choice(6, size=n, p=areas / areas.sum())
    uv = rng.uniform(-1.0, 1.0, (n, 2))
    sign = np.where(face % 2 == 0, 1.0, -1.0)
    axis = face // 2
    xyz = np.zeros((n, 3))
    for a in range(3):
        o1, o2 = [i for i in range(3) if i != a]
        sel = axis == a
        xyz[sel, a] = sign[sel] * he[a]
        xyz[sel, o1] = uv[sel, 0] * he[o1]
        xyz[sel, o2] = uv[sel, 1] * he[o2]
    return xyz


def _cylinder(rng, n, radius, height):
    theta = rng.uniform(0.0, 2.0 * np.pi, n)
    z = rng.uniform(-height / 2, height / 2, n)
    return np.stack([radius * np.cos(theta), radius * np.sin(theta), z], -1)


def _sphere(rng, n, radius):
    v = rng.standard_normal((n, 3))
    return v / (np.linalg.norm(v, axis=-1, keepdims=True) + 1e-12) * radius


def path_clearance(path: dict, x: float, y: float) -> float:
    """Distance in the plane from (x, y) to the path."""
    if path["kind"] == "ring":
        return abs(math.hypot(x, y) - path["radius_m"])
    x0 = path["start"][0]
    x1 = x0 + path["step_m"] * (path["steps"] - 1)
    dx = max(x0 - x, 0.0, x - x1)
    return math.hypot(dx, y - path["start"][1])


def make_world(world: dict, path: dict, ss: np.random.SeedSequence, device) -> torch.Tensor:
    """A ground plane and objects standing on it (boxes, cylinders, spheres),
    none within ``clearance_m`` of the path: f32[P, 3] on ``device``.  A
    traffic file that gives the world a ``seed`` fixes its layout (the same
    work for every run); else the layout comes from ``ss``."""
    rng = np.random.default_rng(world["seed"] if "seed" in world else ss)
    half = world["half_extent_m"]
    lo, hi = world["object_size_m"]
    uv = rng.uniform(-1.0, 1.0, (world["ground_points"], 2)) * half
    parts = [np.concatenate([uv, np.zeros((len(uv), 1))], -1)]
    while len(parts) <= world["objects"]:
        x, y = rng.uniform(-half + 2.0, half - 2.0, 2)
        if path_clearance(path, x, y) < world["clearance_m"]:
            continue
        kind, size = int(rng.integers(0, 3)), float(rng.uniform(lo, hi))
        if kind == 0:
            p = _box(rng, 1500, (size * 0.7, size * 0.4, size))
            c, s = np.cos(rng.uniform(0.0, np.pi)), np.sin(rng.uniform(0.0, np.pi))
            p, z = p @ np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]]).T, size
        elif kind == 1:
            p, z = _cylinder(rng, 1200, size * 0.4, size * 2), size
        else:
            p, z = _sphere(rng, 1000, size * 0.5), size * 0.5
        parts.append(p + np.array([x, y, z]))
    return torch.as_tensor(np.concatenate(parts), dtype=torch.float32, device=device)


# -- path and odometry ---------------------------------------------------------

def _yaw(theta: float) -> np.ndarray:
    T = np.eye(4)
    T[:2, :2] = [[math.cos(theta), -math.sin(theta)], [math.sin(theta), math.cos(theta)]]
    return T


def make_path(path: dict) -> np.ndarray:
    """f64[S, 4, 4]: a ring heading along its tangent (closed on its first
    pose where ``close``), or a straight line along +x."""
    poses = []
    if path["kind"] == "ring":
        n, r = path["steps"], path["radius_m"]
        for i in range(n):
            theta = 2.0 * math.pi * i / n
            T = _yaw(theta + math.pi / 2.0)
            T[:3, 3] = [r * math.cos(theta), r * math.sin(theta), path["z_m"]]
            poses.append(T)
        if path.get("close"):
            poses.append(poses[0].copy())
    else:
        x0, y0, z0 = path["start"]
        for i in range(path["steps"]):
            T = np.eye(4)
            T[:3, 3] = [x0 + path["step_m"] * i, y0, z0]
            poses.append(T)
    return np.stack(poses)


def drifting_odometry(truth: np.ndarray, drift_m: float, drift_rad: float,
                      ss: np.random.SeedSequence) -> np.ndarray:
    """Integrate the true relative motions, each perturbed by Gaussian noise
    of ``drift_m`` per axis and ``drift_rad`` per rotation axis."""
    rng = np.random.default_rng(ss)
    out = [truth[0].copy()]
    for i in range(1, len(truth)):
        rel = np.linalg.inv(truth[i - 1]) @ truth[i]
        noise = torch.as_tensor(np.concatenate([drift_rad * rng.standard_normal(3),
                                                drift_m * rng.standard_normal(3)]))
        out.append(out[-1] @ rel @ se3.se3_exp(noise).numpy())
    return np.stack(out)


# -- rendering -------------------------------------------------------------------

def render(world: torch.Tensor, pose: np.ndarray, gen: torch.Generator, n_points: int,
           noise_m: float, max_range_m: float, min_range_m: float) -> torch.Tensor:
    """A virtual LiDAR at ``pose``: ``n_points`` world points within range,
    drawn at random, in the sensor frame, with Gaussian noise: f32[n, 3]."""
    T = torch.as_tensor(pose, dtype=torch.float32, device=world.device)
    local = (world - T[:3, 3]) @ T[:3, :3]
    r = torch.linalg.vector_norm(local, dim=-1)
    visible = (r > min_range_m) & (r < max_range_m)
    u = torch.rand(world.shape[0], generator=gen, device=world.device)
    order = torch.argsort(torch.where(visible, u, 2.0))[:n_points]
    if int(visible.sum()) < n_points:
        raise RuntimeError(f"only {int(visible.sum())} world points within "
                           f"{max_range_m} m of a pose, {n_points} needed")
    pts = local[order]
    return pts + noise_m * torch.randn(pts.shape, generator=gen, device=world.device)


# -- writers ---------------------------------------------------------------------

OUSTER_FIELDS = [("x", 0, "f4", 7), ("y", 4, "f4", 7), ("z", 8, "f4", 7),
                 ("intensity", 16, "f4", 7), ("t", 20, "u4", 6),
                 ("reflectivity", 24, "u2", 4), ("ring", 26, "u2", 4),
                 ("ambient", 28, "u2", 4), ("range", 32, "u4", 6)]


def _ouster_body(xyz: np.ndarray, t_ns: np.ndarray, ring: np.ndarray) -> bytes:
    dt = np.dtype({"names": [f[0] for f in OUSTER_FIELDS],
                   "formats": [f[2] for f in OUSTER_FIELDS],
                   "offsets": [f[1] for f in OUSTER_FIELDS], "itemsize": 48})
    rec = np.zeros(xyz.shape[0], dt)
    rec["x"], rec["y"], rec["z"] = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    rng_m = np.linalg.norm(xyz, axis=1)
    rec["intensity"] = 3000.0 / (1.0 + rng_m)
    rec["t"], rec["ring"] = t_ns, ring
    rec["reflectivity"] = np.clip(rec["intensity"], 0, 65535).astype(np.uint16)
    rec["ambient"] = 50
    rec["range"] = (rng_m * 1000.0).astype(np.uint32)
    return rec.tobytes()


def write_bag(path: str, world: torch.Tensor, truth: np.ndarray, odom: np.ndarray,
              sensor: dict, gen: torch.Generator) -> Sequence:
    """A spinning multi-beam sensor's sweeps and the odometry as a rosbag.
    Sweep k ends at pose k, stamped (k + 1) sweep periods, and covers the
    motion from pose k - 1 (the first sweep at rest); each point is measured
    from the pose of its column's time and carries that time in ns."""
    rings, cols, sweep = sensor["rings"], sensor["columns"], sensor["sweep_s"]
    steps = int(round(sensor["odometry_hz"] * sweep))
    dev = world.device
    G = torch.as_tensor(truth, dtype=torch.float64, device=dev)
    O = torch.as_tensor(odom, dtype=torch.float64)
    col_alpha = torch.arange(cols, dtype=torch.float64, device=dev) / cols
    odo_alpha = torch.arange(steps, dtype=torch.float64) / steps
    w = bagfile.BagWriter(path)
    fields = [(f[0], f[1], f[3]) for f in OUSTER_FIELDS]
    for k in range(len(truth)):
        stamp, j = sweep * (k + 1), max(k - 1, 0)
        between = se3.geodesic(O[j].expand(steps, 4, 4), O[k].expand(steps, 4, 4), odo_alpha)
        for m in range(steps):
            T = between[m].numpy()
            w.write(sensor["odometry_topic"], "nav_msgs/Odometry", stamp - sweep + sweep * m / steps,
                    bagfile.odometry(stamp - sweep + sweep * m / steps, T,
                                     se3.matrix_to_quaternion(T[:3, :3]),
                                     child_frame_id=sensor["frame"]))
        col_pose = se3.geodesic(G[j].expand(cols, 4, 4), G[k].expand(cols, 4, 4), col_alpha)
        mid = col_pose[cols // 2]
        local = render(world, mid.cpu().numpy(), gen, rings * cols, sensor["noise_m"],
                       sensor["max_range_m"], sensor["min_range_m"]).double()
        az = torch.atan2(local[:, 1], local[:, 0])
        col = ((math.pi - az) / (2 * math.pi) * cols).long().clamp(0, cols - 1)
        world_xyz = se3.apply(mid, local)
        inv = se3.inverse(col_pose)[col]
        xyz = (inv[:, :3, :3] @ world_xyz[:, :, None])[:, :, 0] + inv[:, :3, 3]
        elev = torch.rad2deg(torch.atan2(xyz[:, 2], torch.linalg.vector_norm(xyz[:, :2], dim=1)))
        fov = sensor["fov_deg"]
        ring = ((elev + fov) / (2 * fov) * (rings - 1)).round().clamp(0, rings - 1).long()
        order = torch.argsort(ring * cols + col, stable=True)
        xyz = xyz[order].float().cpu().numpy()
        t_ns = (col[order].cpu().numpy() * (sweep * 1e9 / cols)).astype(np.uint32)
        body = _ouster_body(xyz, t_ns, ring[order].cpu().numpy().astype(np.uint16))
        w.write(sensor["topic"], "sensor_msgs/PointCloud2", stamp,
                bagfile.pointcloud2(stamp, sensor["frame"], rings, cols, fields, 48, body))
    T = O[-1].numpy()
    w.write(sensor["odometry_topic"], "nav_msgs/Odometry", sweep * len(truth),
            bagfile.odometry(sweep * len(truth), T, se3.matrix_to_quaternion(T[:3, :3]),
                             child_frame_id=sensor["frame"]))
    w.close()
    return Sequence(kind="rosbag", root=path, truth=truth, bytes_written=os.path.getsize(path))


def write_kitti(root: str, world: torch.Tensor, truth: np.ndarray, sensor: dict,
                gen: torch.Generator) -> Sequence:
    """KITTI odometry's layout: ``sequences/00/velodyne/%06d.bin`` of float32
    x, y, z, reflectance, ``calib.txt`` with ``Tr`` and ``poses/00.txt``."""
    velo = os.path.join(root, "sequences", "00", "velodyne")
    os.makedirs(velo)
    total = 0
    for i, T in enumerate(truth):
        xyz = render(world, T, gen, sensor["points"], sensor["noise_m"],
                     sensor["max_range_m"], sensor["min_range_m"]).cpu().numpy()
        rec = np.zeros((len(xyz), 4), np.float32)
        rec[:, :3] = xyz
        rec[:, 3] = np.linalg.norm(xyz, axis=1) / sensor["max_range_m"]
        rec.tofile(os.path.join(velo, f"{i:06d}.bin"))
        total += rec.nbytes
    Tr = np.asarray(sensor["Tr"], np.float64).reshape(3, 4)
    with open(os.path.join(root, "sequences", "00", "calib.txt"), "w") as f:
        f.write("Tr: " + " ".join(f"{v:.6e}" for v in Tr.reshape(-1)) + "\n")
    Tr4 = np.vstack([Tr, [0.0, 0.0, 0.0, 1.0]])
    os.makedirs(os.path.join(root, "poses"))
    with open(os.path.join(root, "poses", "00.txt"), "w") as f:
        for T in truth:
            f.write(" ".join(f"{v:.9e}" for v in (T @ np.linalg.inv(Tr4))[:3].reshape(-1))
                    + "\n")
    return Sequence(kind="kitti", root=root, truth=truth, bytes_written=total)


def generate(config: dict, traffic: dict, seed: int, out_dir: str, device,
             extensions: Optional[Dict[str, object]] = None) -> Sequence:
    """The cell's sequence under ``out_dir`` (emptied first); then each
    extension's ``prepare(config, traffic, world, truth, out_dir, ss)``,
    kept in ``extras`` under its name."""
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    s_world, s_render, s_odom = seeds(seed, 3)
    sensor = config["sensor"]
    path = traffic["path"]
    world = make_world(traffic["world"], path, s_world, device)
    truth = make_path(path)
    gen = torch.Generator(device=device).manual_seed(torch_seed(s_render))
    if sensor["format"] == "rosbag":
        odom = drifting_odometry(truth, sensor["odometry_drift_m"],
                                 sensor["odometry_drift_rad"], s_odom)
        seq = write_bag(os.path.join(out_dir, "sequence.bag"), world, truth, odom, sensor, gen)
    elif sensor["format"] == "kitti":
        seq = write_kitti(os.path.join(out_dir, "kitti"), world, truth, sensor, gen)
    else:
        raise ValueError(f"unknown sensor format {sensor['format']!r}")
    exts = extensions or {}
    streams = seeds(seed, EXTENSION_STREAM + len(exts))[EXTENSION_STREAM:]
    for (name, module), ss in zip(exts.items(), streams):
        if hasattr(module, "prepare"):
            seq.extras[name] = module.prepare(config, traffic, world, truth, out_dir, ss)
    return seq
