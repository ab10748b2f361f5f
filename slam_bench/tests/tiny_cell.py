"""A cell small enough for a test run on the CPU, where the port takes the
plain twins of its kernels: 2048-point sweeps on an 8-scan straight run
through a 40 m world, with the capacities of the port's own CPU tests and
limits of its own (its ICP stops after at most 10 trips on a sparse map,
so its poses sit farther from the reference's optimum than the cells' do:
its sound scan gap reads 40-53 mm, the control's 146 mm)."""
import copy
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from slam_bench import spec  # noqa: E402

torch.set_num_threads(4)  # several test processes share the host

N = 2048
PARAMETERS = {
    "odometry": {"scan_processing": {"voxel_size": 0.15, "point_capacity": N}},
    "mapper": {"mapper_localizer": {
        "is_print_timing_information": False,
        "scan_to_map_registration": {"icp": {"max_n_iter": 10},
                                     "scan_processing": {"voxel_size": 0.15, "point_capacity": N},
                                     "map_patch_capacity": 4096}},
        "submaps": {"point_capacity": 32768},
        "map_builder": {"map_voxel_size": 0.12},
        "place_recognition": {"feature_point_capacity": 1024, "overlap_point_capacity": 2048,
                              "ransac_batch_size": 512}}}
LIMITS = {"decode_lanes_off": 0, "scan_gap_mm": 65.0, "map_miss_pct": 20.0, "odom_gap_mm": 20.0,
          "graph_gap_mm": 20.0, "voxels_dropped": 0}


def cell(kind: str = "rosbag") -> spec.Cell:
    c = copy.deepcopy(spec.cell("os1-32-loop" if kind == "rosbag" else "kitti-hdl64-loop"))
    sensor = c.config["sensor"]
    params = json.loads(json.dumps(PARAMETERS))
    if kind == "rosbag":
        sensor.update(rings=16, columns=128, capacity=N, max_range_m=16.0)
        params["motion_compensation"] = {"is_undistort_scan": True}
    else:
        sensor.update(points=N, capacity=N, max_range_m=16.0)
        c.config["reference"]["odometry"]["voxel_m"] = 0.15
    c.config["parameters"] = params
    c.config["reference"].update(voxel_m=0.15, map_voxel_m=0.12, patch_points=4096)
    c.config["limits"] = dict(LIMITS)
    c.traffic = {"name": "tiny",
                 "world": {"half_extent_m": 20.0, "ground_points": 30000, "objects": 40,
                           "clearance_m": 2.0, "object_size_m": [0.5, 2.0]},
                 "path": {"kind": "line", "start": [-4.0, 0.0, 1.5], "steps": 8,
                          "step_m": 0.3},
                 "warmup_scans": 3, "check_scans": 5}
    return c
