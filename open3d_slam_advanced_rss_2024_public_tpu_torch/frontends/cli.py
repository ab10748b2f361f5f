"""Command-line entry point.

Counterpart of the JAX package's ``frontends/cli.py`` (≙ reference
mapping_node, mapping_node.cpp:16-54: load the parameters, run the replay
processor, optionally start from a prior map) with dataset adapters
instead of ROS topics.  It runs on the CUDA device unless ``--device cpu``
is given, and raises where no CUDA device exists.

  python -m open3d_slam_advanced_rss_2024_public_tpu_torch.frontends.cli \\
      --dataset kitti --kitti-root /data/kitti --sequence 00 --eval-ate
  python -m ... --dataset synthetic --steps 100 --output /tmp/run1
  python -m ... --dataset pcd-dir --pcd-dir scans/ --odometry odom.tum
  python -m ... --dataset rosbag --bag run.bag --cloud-topic /points \\
      --odometry-topic /odom --viz-dir /tmp/viz
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np

# The most points ``--initial-map`` may hold (the JAX package's map lanes).
MAX_INITIAL_MAP_POINTS = 262144


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="LiDAR SLAM on PyTorch and CUDA")
    ap.add_argument("--dataset", choices=["synthetic", "kitti", "pcd-dir", "rosbag"],
                    default="synthetic")
    ap.add_argument("--bag", help="rosbag path (V2.0)")
    ap.add_argument("--cloud-topic", default="/rslidar_points")
    ap.add_argument("--odometry-topic", help="nav_msgs/Odometry topic for "
                    "external-odometry pairing (optional)")
    ap.add_argument("--params", help="parameter file: .lua (reference-compatible "
                    "Lua schema), .yaml (legacy YAML schema) or .json, "
                    "deep-merged onto defaults")
    ap.add_argument("--params-search-dir", action="append", default=[],
                    help="extra include search dirs for .lua params "
                    "(repeatable; ≙ ConfigurationFileResolver)")
    ap.add_argument("--output", default="./slam_output")
    ap.add_argument("--steps", type=int, default=100, help="synthetic: frame count")
    ap.add_argument("--trajectory", default="loop", choices=["loop", "straight"])
    ap.add_argument("--kitti-root")
    ap.add_argument("--sequence", default="00")
    ap.add_argument("--max-frames", type=int)
    ap.add_argument("--pcd-dir")
    ap.add_argument("--odometry", help="TUM-format external odometry file")
    ap.add_argument("--initial-map", help="PCD prior map (localization mode)")
    ap.add_argument("--eval-ate", action="store_true",
                    help="report ATE vs ground truth when available")
    ap.add_argument("--viz-dir", help="write the live visualization bundle "
                    "here during the run (serve it with "
                    "frontends.visualizer_node)")
    ap.add_argument("--viz-every", type=int, default=25,
                    help="publish the bundle every N frames")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default) or cpu")
    return ap


def load_params(path, search_dirs=()):
    """The parameters of a .lua, .yaml/.yml or .json file, or the package
    defaults where ``path`` is None; the Lua loader's warnings go to
    stderr."""
    from ..utils.config import load_parameters, load_parameters_file

    if path and path.endswith(".lua"):
        from ..utils.lua_config import load_lua_parameters

        params, warnings = load_lua_parameters(path, search_dirs=list(search_dirs))
        for w in warnings:
            print(f"[params] {w}", file=sys.stderr)
        return params
    if path and path.endswith((".yaml", ".yml")):
        from ..utils.yaml_config import load_legacy_yaml

        return load_legacy_yaml(path)
    if path:
        return load_parameters_file(path)
    return load_parameters(None)


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    from ..utils import io as io_utils
    from ..utils.device import resolve_device
    from . import replay as replay_mod

    device = resolve_device(args.device)
    params = load_params(args.params, args.params_search_dir)
    runner = replay_mod.ReplayRunner(params, output_dir=args.output, device=device,
                                     viz_dir=args.viz_dir, viz_every=args.viz_every)

    if args.initial_map:
        from ..models.map_initializer import SlamMapInitializer

        # At the file's own size, which torch allows, up to the JAX
        # package's bound: it pads the map to MAX_INITIAL_MAP_POINTS lanes
        # and raises beyond.  The map's brute-force kNN normals grow with the
        # square of its points.
        prior = io_utils.load_pcd(args.initial_map, device=device)
        if prior.capacity > MAX_INITIAL_MAP_POINTS:
            raise ValueError(
                f"capacity {MAX_INITIAL_MAP_POINTS} < points {prior.capacity}: the prior map "
                f"{args.initial_map} holds more points than the map initializer takes; "
                f"thin it first (a voxel filter)")
        SlamMapInitializer(runner.slam, params.mapper.map_initializer).initialize(
            map_cloud=prior)

    gt = None
    if args.dataset == "synthetic":
        frames = replay_mod.synthetic_sequence(0, n_steps=args.steps,
                                               trajectory=args.trajectory, device=device)
    elif args.dataset == "kitti":
        from . import kitti

        frames = kitti.kitti_sequence(args.kitti_root, args.sequence,
                                      max_frames=args.max_frames, device=device)
        gt = kitti.kitti_ground_truth(args.kitti_root, args.sequence)
    elif args.dataset == "rosbag":
        from . import rosbag as rosbag_mod

        frames = rosbag_mod.rosbag_sequence(args.bag, args.cloud_topic,
                                            odometry_topic=args.odometry_topic, device=device)
    else:
        frames = replay_mod.pcd_directory_sequence(args.pcd_dir, trajectory_file=args.odometry,
                                                   device=device)

    slam = runner.run(frames)
    print(f"processed {len(slam.trajectory_poses)} scans, "
          f"{len(slam.mapper.submaps.submaps)} submaps, "
          f"{slam.loop_closure_count} loop closures; "
          f"avg {runner.timer.avg_ms:.1f} ms/scan", file=sys.stderr)
    if args.eval_ate and gt is not None:
        n = min(len(gt), len(slam.trajectory_poses))
        ate = io_utils.ate_rmse(np.stack(slam.trajectory_poses[:n]), gt[:n])
        print(json.dumps({"ate_rmse_m": round(float(ate), 4), "frames": n}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
