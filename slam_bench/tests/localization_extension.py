"""A localization-shaped extension, kept for the tests and not shipped: a
user maps a site once, then localizes against the saved map with merging
off.  ``prepare`` writes a thinned prior map of the traffic's world as a
PCD file, ``start`` hands it to the program's ``SlamMapInitializer``, and
``judge`` reads ``prior_map_voxels_changed``: the voxels of the active
table (the prior map) whose weight changed in a sampled call, gained or
lost, which is 0 where the map stays as it was loaded.  Its control merges:
each sampled scan's voxels at the program's pose, each of which a merge
changes."""
import os

import numpy as np
import torch

from slam_bench.reference import checks, geometry, se3

NAME = "localization"  # the name the configuration lists it under
MAP_VOXEL_M = 0.5      # the prior map keeps one point, the mean, in each such voxel
MARGIN_M = 1.0         # and the world's points within the sensor's range and this of a pose


def prepare(config, traffic, world, truth, out_dir, ss):
    reach = config["sensor"]["max_range_m"] + MARGIN_M
    path_xy = torch.as_tensor(truth[:, :2, 3], dtype=world.dtype, device=world.device)
    near = torch.cdist(world[:, :2], path_xy).min(1).values <= reach
    xyz = geometry.voxel_means(world[near], MAP_VOXEL_M).cpu().numpy().astype("<f4")
    path = os.path.join(out_dir, "prior_map.pcd")
    header = (f"VERSION 0.7\nFIELDS x y z\nSIZE 4 4 4\nTYPE F F F\nCOUNT 1 1 1\n"
              f"WIDTH {len(xyz)}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {len(xyz)}\n"
              f"DATA binary\n")
    with open(path, "wb") as f:
        f.write(header.encode() + xyz.tobytes())
    return path


def start(slam, seq, config, device):
    from open3d_slam_advanced_rss_2024_public_tpu_torch.models.map_initializer import \
        SlamMapInitializer
    from open3d_slam_advanced_rss_2024_public_tpu_torch.utils import io

    prior = io.load_pcd(seq.extras[NAME], device=device)
    SlamMapInitializer(slam, slam.params.mapper.map_initializer).initialize(
        map_cloud=prior, init_pose=slam.mapper.map_to_range_sensor.copy())


def judge(capture, seq, config, device, control):
    cell = config["reference"]["map_voxel_m"]
    changed = 0
    for s in capture.scans:
        if control:
            xyz = s.cloud.xyz[s.cloud.mask].to(device).double()
            pose = torch.as_tensor(np.asarray(s.pose, np.float64), device=device)
            keys = geometry.voxel_keys(se3.apply(pose, xyz).float(), cell)
            changed += keys.unique(dim=0).shape[0]
        else:
            changed += int((checks.gained(s.map_before, s.map_after, cell)[1] != 0).sum())
    return {"prior_map_voxels_changed": float(changed)}
