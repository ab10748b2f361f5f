"""Whether what the timed path produced is right: the sampled answers of the
window against the plain reference (``reference/checks.py``), each number
beside the limit the configuration file states for it.

``judge`` reads the program's answers; with ``control=True`` it reads
instead the answers of the reference with the configuration's guarantee
broken (every registration and solve returns its starting value: the
mapper's pose is the odometry's guess, the odometry's motion the identity,
the pose graph its starting poses), which is how ``control.py`` reads the
upper ends of the limits.  Each of the configuration's extensions that
defines ``judge(capture, seq, config, device, control)`` adds its numbers,
read the same two ways; each has to have its limit.
"""
from __future__ import annotations

import os
from typing import Dict, List

import numpy as np
import torch

from . import spec
from .reference import checks, geometry, se3

MIN_SCANS = 3  # eligible scan samples a run needs before it can be judged


def _frame_pose(bag, k):
    """The odometry the frontend pairs with cloud k: at its header stamp."""
    return checks.lookup(bag[2], bag[3], float(bag[1][k]))


def judge(capture, seq, config: dict, device, control: bool = False,
          details: list = None) -> Dict[str, float]:
    """The compared numbers over the window's samples; ``details`` (a list)
    receives one row a judged sample, with its gaps to the ground truth."""
    ref = config["reference"]
    sensor = config["sensor"]
    lo, hi = ref["crop_m"]
    cell = ref["map_voxel_m"]
    readings: Dict[str, float] = {"decode_lanes_off": 0.0}
    gaps: Dict[str, List[float]] = {"scan_gap_mm": [], "map_miss_pct": [], "odom_gap_mm": []}
    bag = None
    if seq.kind == "rosbag":
        bag = checks.bag_index(seq.root, sensor["topic"], sensor["odometry_topic"])
    kitti_dir = os.path.join(seq.root, "sequences", "00", "velodyne")

    def raw(k):
        if bag is not None:
            _, xyz, t = checks.decode_bag_cloud(bag[0][k])
            return xyz, t
        return checks.decode_kitti_scan(os.path.join(kitti_dir, f"{k:06d}.bin")), None

    for s in capture.scans:
        xyz, t = raw(s.index)
        readings["decode_lanes_off"] += checks.lanes_off(s.cloud, xyz, t)
        p = torch.as_tensor(xyz, device=device)
        if bag is not None and ref["deskew"]:
            first = max(s.index - ref["velocity_poses"] + 1, 0)
            ks = list(range(first, s.index + 1))
            twist = checks.deskew_twist([_frame_pose(bag, k) for k in ks],
                                        [float(bag[1][k]) for k in ks], ref["scan_period_s"])
            p = checks.deskew(p, torch.as_tensor(t, device=device), twist)
        wide = geometry.voxel_means(geometry.radius_crop(p.double(), lo, hi), ref["voxel_m"])
        match = geometry.radius_crop(wide, lo, hi)
        if bag is not None:
            motion = np.linalg.inv(_frame_pose(bag, s.index - 1)) @ _frame_pose(bag, s.index)
        elif control:
            motion = np.eye(4)  # the control's odometry returns its start too
        else:
            motion = np.linalg.inv(s.odo_before) @ s.odo_after
        guess = torch.as_tensor(s.prev_pose.astype(np.float64) @ motion, device=device)
        if sensor["format"] == "kitti" and s.index >= 1:
            gap, motion, best = _odometry_gap(s, raw, ref, device, control)
            gaps["odom_gap_mm"].append(gap)
            if details is not None:
                truth = torch.as_tensor(np.linalg.inv(seq.truth[s.index - 1]) @ seq.truth[s.index],
                                        device=device)
                details.append({"index": s.index, "odom_gap_mm": gap,
                                "answer_truth_mm": _mm(motion, truth),
                                "reference_truth_mm": _mm(best, truth)})
        if not s.eligible or s.index < 2:
            continue
        answer = guess if control else torch.as_tensor(s.pose, dtype=torch.float64, device=device)
        patch, normals = checks.patch(s.map_before, guess[:3, 3], hi, ref["patch_points"], cell,
                                      ref["normal_radius_m"])
        best = geometry.point_to_plane(match, patch, normals, answer, ref["match_m"],
                                       ref["trimmed_ratio"])
        gaps["scan_gap_mm"].append(_mm(answer, best))
        expected = geometry.voxel_keys(se3.apply(best, wide).float(), cell)
        if control:
            got = geometry.voxel_keys(se3.apply(answer, wide).float(), cell)
            got_w = torch.ones(got.shape[0], dtype=torch.float64, device=device)
        else:
            got, got_w = checks.gained(s.map_before, s.map_after, cell)
        gaps["map_miss_pct"].append(checks.miss_pct(expected, got, got_w))
        if details is not None:
            truth = torch.as_tensor(seq.truth[s.index], device=device)
            details.append({"index": s.index, "scan_gap_mm": gaps["scan_gap_mm"][-1],
                            "map_miss_pct": gaps["map_miss_pct"][-1],
                            "answer_truth_mm": _mm(answer, truth),
                            "reference_truth_mm": _mm(best, truth)})
    for name, values in gaps.items():
        if values:
            readings[name] = max(values)
    # Every point of every scan of the window lands in its table: the
    # program's own count of the scan points its tables dropped, over every
    # mission; the reference's map drops none.
    readings["voxels_dropped"] = 0.0 if control else float(
        sum(m["voxels_dropped"] for m in capture.missions))
    graph = []
    for solve in capture.solves:
        best = checks.solve_graph(solve.node_poses, solve.constraints, solve.preference,
                                  solve.reference_node)
        X0 = np.stack(solve.node_poses)
        X = X0 if control else np.stack([solve.increments[i] @ X0[i] for i in range(len(X0))])
        graph.append(checks.graph_gap(X, best) * 1e3)
    if graph:
        readings["graph_gap_mm"] = max(graph)
    for name, numbers in spec.call(capture.extensions, "judge", capture, seq, config, device,
                                   control).items():
        taken = set(numbers) & (set(readings) | {"scans_judged"})
        if taken:
            raise ValueError(f"extension {name!r} reads {sorted(taken)}, "
                             f"which the check reads already")
        unlimited = set(numbers) - set(config["limits"])
        if unlimited:
            raise ValueError(f"extension {name!r} reads {sorted(unlimited)}, "
                             f"which the configuration's limits do not name")
        readings.update({k: float(v) for k, v in numbers.items()})
    readings["scans_judged"] = float(len(gaps["scan_gap_mm"]))
    return readings


def _mm(Ta, Tb) -> float:
    return float(se3.pose_gap(torch.as_tensor(Ta).double(), torch.as_tensor(Tb).double(),
                              checks.LEVER_M)) * 1e3


def _odometry_gap(s, raw, ref: dict, device, control: bool):
    """The program's motion between scans k - 1 and k against the
    reference's GICP of its own clouds of the two, run as the configuration
    runs it from the identity."""
    o = ref["odometry"]
    clouds = []
    for k in (s.index, s.index - 1):
        xyz = torch.as_tensor(raw(k)[0], device=device).double()
        means = geometry.voxel_means(geometry.radius_crop(xyz, *o["crop_m"]), o["voxel_m"])
        clouds.append((means, geometry.radius_normals(means, o["normal_radius_m"])))
    (src, src_n), (dst, dst_n) = clouds
    eye = torch.eye(4, dtype=torch.float64, device=device)
    motion = eye if control else torch.as_tensor(np.linalg.inv(s.odo_before) @ s.odo_after,
                                                 dtype=torch.float64, device=device)
    best = checks.odometry_motion(src, src_n, dst, dst_n, o)
    return _mm(motion, best), motion, best


def verdict(readings: Dict[str, float], limits: Dict[str, float]):
    """(correct, [(name, value, limit)]) over the numbers the run read."""
    rows = [(name, readings[name], limits[name]) for name in limits if name in readings]
    ok = all(v <= lim for _, v, lim in rows) and readings.get("scans_judged", 0) >= MIN_SCANS
    rows.append(("scans_judged", readings.get("scans_judged", 0.0), float(MIN_SCANS)))
    return ok, rows
