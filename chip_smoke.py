#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``open3d_slam_advanced_rss_2024_public_tpu_torch/csrc``
(``nvcc``, at first use), holds each kernel (the two tile-planning kernels, K1
and K2) against its plain PyTorch twin at the shapes of the main path, then
drives the main path — ``Mapper.add_range_measurement``
over the 100-scan synthetic loop with ``bench.py``'s parameters (8192-point scans,
a 32768-point map patch, a 2^18-slot voxel table, lag-8 blocks) — and checks the
trajectory against ground truth.  Then it drives the second path, the SLAM
runtime: ``SlamWrapper.use_pair_for_registration`` ... ``finish_processing``
over a 48-scan loop closed on its first pose with drifting odometry, 8 m
submaps and the package's default feature, overlap and RANSAC sizes (submap
features, odometry constraints, loop-closure proposal, pose-graph solve and
feedback), the online workers over 12 scans, the stepper on its own
scan-to-scan odometry with motion compensation, K1 and K2 at the shapes the
SLAM runtime gives them (16384 x 16384 overlap clouds, scan x scan in the
odometry, single-scan blocks) and the information matrix with unmatched
queries against their plain versions, the SLAM runtime on the card against
itself on the CPU (a closed 16-scan loop with every stage on, and the
loop-closure stages one by one from a common state at full width), and one
pose-graph solve of the loop on its own (trips, host time and device
operations a trip).  Then the command line at the package defaults
(``cli.main`` in this process) on a 101-scan lap that the script writes under
build/ in KITTI odometry's layout, at a reduced width (16384-point scans,
whose voxels fit the defaults' lanes): GICP odometry, the Mapper, submaps,
loop closure and the pose graph, held to an ATE below 0.2 m and the
odometry's; K1 and K2 at the defaults' shapes, one GICP registration and one
carve on the card against the CPU, the hashed grid against K1, the command
line on 20 scans at HDL-64E width (120000 points, read but held to no
accuracy bar), and a localization run from a Lua parameter file on the
saved map, thinned to the map initializer's 262144 points.  Then the
libpointmatcher ICP chain: the reference's production icp.yaml chain,
written to build/icp.yaml and loaded with ``chain.from_yaml``, registers
each of the lap's first 20 full-width scans against the one before (and 5
pairs again at ``KDTreeMatcher``'s default maxDist inf), from the true
motion perturbed by 0.1 m and 0.5 degrees, held to 0.05 m and 0.5 degrees
and below the guess's error; an ``ICPSequence`` registers the 20 scans
against a voxelised patch of the lap's world; each of the 28
DataPointsFilters runs on a full-width scan with no host sync and on 8192
lanes card against CPU; the chain runs card against CPU on one pair; and
K1 is held against its twin at the chain's shapes.  Then the rosbag path:
the lap written under build/rosbag/ as a bag of 100 Ouster OS1-32 sweeps
(1024 x 10, 32768 points in the Ouster 48-byte point layout, each point
measured from its column's pose, with a u32 nanosecond time channel) and
100 Hz drifting odometry; ``cli.main --dataset rosbag`` on it at the
package defaults with deskewing on and 32768 lanes a scan, publishing the
live visualization bundle (held to an ATE below 0.2 m and the odometry's;
again without the bundle and without deskewing, for their cost and
effect); K1 and K2 at its shapes; ``undistort`` on one sweep's time
channel, card against CPU with no host sync; the first 24 sweeps through
``OnlineRangeDataProcessor`` with the odometry of a body frame 60 degrees
off and the calibration from a ``StaticTransformBuffer``; and the bundle
reloaded and served by ``visualizer_node`` on a loopback port, with ``POST
/initialpose``.  Then the multi-chip path (``parallel/`` on
``torch.distributed``): ``parallel world 1 nccl`` starts NCCL at world size
1 in this process and drives ``make_sharded_mapper`` over the main path's
100-scan loop at ``bench.py``'s shapes (a 2^17-slot table a rank, 8 m
blocks), its warm-up under torch's sync debug mode, every pose held within
5 mm of ``pipeline.mapper_step`` on the same scans and estimates, with K1
and K2 held against their twins at its shapes and its collectives counted;
``parallel world 4 gloo`` spawns four processes on the one card (gloo over
CUDA tensors: NCCL refuses two ranks on one card) that run the mapper over
the loop's first 20 scans (within 5 mm of world 1), the map shards (each
rank's voxels in its own blocks; one scan inserted owner-partitioned into
exactly one table's voxels), ``sharded_map.nn_fn`` against K1 over the
gathered map, the data-parallel register against world 1's, the
distributed solver on a 24-node loop against ``pose_graph.solve``, and the
whole session at ``__graft_entry__.py``'s size (loop closed, ATE lowered).
Every phase prints one line; any failure ends the run
with a non-zero exit.  The second-to-last line is a JSON object
with each kernel's launches on the main path (K1's two chain rows also as
``launches_chain``, each its own pass's; ``launches_parallel`` those of
``parallel world 1 nccl``), error against its twin, times and
bound (``bound_ms`` counts the valid pairs inside the tile pairs this run's
kernels admitted;
``jax_tiling_bound_ms`` beside it the pairs of the JAX kernels' coarser tiling,
the figure earlier runs reported; ``ms`` is the device time of the kernels one call enqueues, replayed from
a CUDA graph so that no host gap is counted; ``wrapper_ms`` the whole wrapper as
the main path calls it, host dispatch included); the last line is
``{"ok": true, "device": {...}}``.  ``python3 chip_smoke.py --kernels`` stops
after the kernel checks.  On a machine with four cards, world 4 runs on NCCL
with one rank a card.

Needs a CUDA device: without one it exits non-zero and prints no result.  It
imports nothing of the JAX package.
"""
from __future__ import annotations

import json
import math
import pathlib
import subprocess
import sys
import time
import warnings

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
OUT = ROOT / "build"

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and non-tensor float32 FLOP/s.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# Float32 operations per evaluated pair, K1 and K2 alike: three subtractions,
# three multiplications and two additions for d2, and the compare.  K2 adds,
# per admitted pair, the count, three first-moment additions and six
# multiplications and six additions for the second moments.
K1_OPS_PER_PAIR = 9
K2_OPS_PER_PAIR = 9
K2_OPS_PER_ADMITTED = 16
# The most distances one cdist call of a library timing holds (16 GB of float32).
LIBRARY_BLOCK = 1 << 32

# The JAX kernels' tiling (ops/pallas_nn.py TQ, TP), counted beside the bounds.
JAX_TQ = 256
JAX_TP = 1024

N_SCAN = 8192
N_PATCH = 32768
N_BIG = 1 << 18          # refs beyond the TPU kernel's N_MAX = 131072
LAG = 8
N_SCANS = 100
MAX_DIST = 0.5
RADIUS = 0.5


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def phase(name: str, **fields) -> None:
    print(f"[{name}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds of ``fn`` on the device (CUDA events around reps)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(n_bytes: float, n_ops: float):
    """Least time for the work on this card, and what bounds it."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / F32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def needed_pairs(torch, cuda_tiles, tile_list, tile_count, q_valid, r_valid) -> float:
    """The (valid query, valid ref) pairs inside the tile pairs that a plan
    admits: the work the function needs on these inputs, which the bounds
    count.  ``tile_list`` [..., nq, np] and ``tile_count`` [..., nq] as the
    plan kernel wrote them; ``q_valid`` [..., M], ``r_valid`` [..., N]."""
    import torch.nn.functional as F

    nq, npt = tile_list.shape[-2:]
    lead = tile_list.shape[:-2]
    qv = F.pad(q_valid.to(torch.float64), (0, nq * cuda_tiles.TQ - q_valid.shape[-1]))
    rv = F.pad(r_valid.to(torch.float64), (0, npt * cuda_tiles.TP - r_valid.shape[-1]))
    qv = qv.reshape(lead + (nq, cuda_tiles.TQ)).sum(-1)
    rv = rv.reshape(lead + (npt, cuda_tiles.TP)).sum(-1)
    used = torch.arange(npt, device=tile_list.device) < tile_count[..., None]
    ids = torch.where(used, tile_list.long(), 0).clamp(0, npt - 1)
    refs = torch.where(used, torch.gather(rv[..., None, :].expand(ids.shape), -1, ids), 0.0)
    return float((qv * refs.sum(-1)).sum())


def bench_params(lag: int, scan_points: int, patch: int, table_points: int, matcher="auto"):
    """``bench.py``'s Mapper parameters (bench.py:170-195)."""
    from open3d_slam_advanced_rss_2024_public_tpu_torch.utils.config import load_parameters

    return load_parameters({"mapper": {
        "mapper_localizer": {
            "is_print_timing_information": False,
            "pose_readback_lag": lag,
            "scan_to_map_registration": {
                "min_refinement_fitness": 0.3,
                "scan_to_map_refinement_type": "PointToPlaneIcp",
                "matcher": matcher,
                "icp": {"max_n_iter": 15, "max_correspondence_dist": MAX_DIST},
                "scan_processing": {
                    "voxel_size": 0.1, "point_capacity": scan_points,
                    "scan_cropping": {"cropping_radius_max": 25.0,
                                      "cropping_radius_min": 0.7}},
                "map_patch_capacity": patch}},
        "submaps": {"point_capacity": table_points, "submap_size": 25.0},
        "map_builder": {"map_voxel_size": 0.1}}})


def run_loop(mapper, scans, gt):
    """Feed the loop through the user's entry point; returns the refined
    poses [S, 4, 4] after the final flush."""
    mapper.set_map_to_range_sensor(gt[0])
    for i, scan in enumerate(scans):
        mapper.odom_buffer.push(0.1 * i, gt[i])
        mapper.add_range_measurement(scan, 0.1 * i)
    mapper.flush()
    return np.stack([p for _, p in mapper.map_to_range_sensor_buffer.items()])


def trajectory_errors(poses, gt):
    err = np.linalg.norm(poses[:, :3, 3] - np.stack(gt)[:, :3, 3], axis=-1)
    return float(err[-1]), float(np.sqrt(np.mean(err ** 2)))


def graph_ms(fn, reps: int = 20, replays: int = 5) -> float:
    """Mean milliseconds of device time of ``fn``: ``reps`` calls captured
    into a CUDA graph and replayed, so that the kernels run back to back
    and no host dispatch gap is counted."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def jax_tiling_pairs(cuda_tiles, q, q_valid, p, p_valid, max_dist) -> float:
    """Candidate pairs that the JAX package's kernels evaluate on these
    inputs: admissible tile pairs of its 256-query x 1024-ref tiling, from
    the plain helpers.  A finer tiling admits fewer pairs for the same
    answer, so this is no lower bound on the work: ``bound_ms`` counts the
    pairs that this run's kernels swept, and the figure from this count is
    printed beside it (``jax_tiling_bound_ms``) only so that rows measured
    before the kernels' tiles shrank stay comparable."""
    import torch.nn.functional as F

    def boxes(x, valid, tile):
        pad = (-x.shape[-2]) % tile
        return cuda_tiles.tile_aabbs(F.pad(x, (0, 0, 0, pad)), F.pad(valid, (0, pad)), tile)

    _, count = cuda_tiles.admissible_lists(*boxes(q, q_valid, JAX_TQ),
                                           *boxes(p, p_valid, JAX_TP), max_dist)
    return float(count.sum()) * JAX_TQ * JAX_TP


def check_nn(torch, cuda_nn, q, r, label, prepared=False, max_dist=MAX_DIST, min_share=0.5):
    """K1 against its twin on queries and refs that may hold sentinel
    lanes: for every valid query whose NN is within ``max_dist``, the same
    index except on an exact distance tie, a valid ref, and identical d2.
    Returns (max |d2 error|, share of identical indices)."""
    ki, kd2 = cuda_nn.nn(q, cuda_nn.prepare_ref(r) if prepared else r, max_dist)
    pi, pd2 = cuda_nn.nn_plain(q, r, max_dist)
    torch.cuda.synchronize()
    if ki.dtype != torch.int64 or kd2.dtype != torch.float32 or ki.shape != pi.shape:
        fail(f"K1 {label}: returned {ki.dtype}{tuple(ki.shape)}, {kd2.dtype}")
    q_valid = q[:, 0].abs() < 1e7
    within = q_valid & (pd2 <= max_dist ** 2)
    if int(within.sum()) < int(q_valid.sum()) * min_share:
        fail(f"K1 {label}: only {int(within.sum())} of {int(q_valid.sum())} valid "
             "queries have a NN in range")
    same = (ki == pi) | (kd2 == pd2)
    if not bool(same[within].all()):
        fail(f"K1 {label}: {int((~same & within).sum())} indices differ from the twin")
    if not bool((r[ki[within], 0].abs() < 1e7).all()):
        fail(f"K1 {label}: a query within range matched a sentinel ref")
    if bool((torch.isfinite(kd2) & (kd2 <= max_dist ** 2))[~q_valid].any()):
        fail(f"K1 {label}: an invalid query passes the distance gate")
    err = float((kd2 - pd2)[within].abs().max())
    if err > 0.0:
        fail(f"K1 {label}: d2 differs from the twin by {err}")
    return err, float((ki == pi)[within].float().mean())


def max_abs_diff(torch, a, b) -> float:
    """Largest |a - b| over two float tensors, 0 where both hold the same
    infinity (the box of a tile with no valid lane)."""
    return float(torch.where(a == b, torch.zeros_like(a), (a - b).abs()).max())


def check_tiles(torch, cuda_tiles, xyz, mask, ref_xyz, ref_mask, label, own_plan):
    """Both tile-planning kernels against their plain versions on [B, N, 3]
    inputs: identical coordinate rows and boxes; each kernel list ascending
    and a superset of the plain list, identical wherever the plain
    admission test is not on its rounding edge.  ``tiles.cuh`` is compiled
    into the K1 and K2 libraries as well, so ``own_plan(center)`` returns
    the (tile_list, tile_count) that the sweep's own launch function wrote
    for these inputs, and that plan must equal the one checked here.
    Returns (the kernels' outputs, the plain tile counts, list entries
    written, largest error of prepare's rows and boxes, of plan's boxes)."""
    valid = ref_xyz[..., 0].abs() < 1e7
    center = cuda_tiles.centroid(ref_xyz, valid if ref_mask is None else valid & ref_mask)
    k_prep = cuda_tiles.tile_prepare(ref_xyz, ref_mask, center)
    p_prep = cuda_tiles.tile_prepare_plain(ref_xyz, ref_mask, center)
    prep_err = max(max_abs_diff(torch, a, b) for a, b in zip(k_prep, p_prep))
    if prep_err != 0.0:  # nan included
        fail(f"tile_prepare {label}: rows or boxes differ from the plain version "
             f"by {prep_err}")
    k_list, k_count, k_qmin, k_qmax = cuda_tiles.tile_plan(xyz, mask, center, k_prep[1],
                                                           k_prep[2], MAX_DIST)
    _, p_count, p_qmin, p_qmax = cuda_tiles.tile_plan_plain(xyz, mask, center, p_prep[1],
                                                            p_prep[2], MAX_DIST)
    torch.cuda.synchronize()
    plan_err = max(max_abs_diff(torch, k_qmin, p_qmin), max_abs_diff(torch, k_qmax, p_qmax))
    if plan_err != 0.0:
        fail(f"tile_plan {label}: query-tile boxes differ from the plain version "
             f"by {plan_err}")
    n_tiles = k_list.shape[-1]
    slot = torch.arange(n_tiles, device=xyz.device)
    k_used = slot < k_count[..., None]
    k_seen = torch.zeros(k_list.shape, dtype=torch.int32, device=xyz.device)
    k_seen.scatter_add_(-1, torch.where(k_used, k_list, 0).long(), k_used.int())
    if bool((k_seen > 1).any()):
        fail(f"tile_plan {label}: a list holds a tile twice")
    k_adm = k_seen > 0
    ascending = (k_list[..., 1:] > k_list[..., :-1]) | ~k_used[..., 1:]
    if not bool(ascending.all()):
        fail(f"tile_plan {label}: a list is not in ascending order")
    gap2 = cuda_tiles.box_gap2(p_qmin, p_qmax, p_prep[1], p_prep[2])
    r2 = cuda_tiles.r2_of(MAX_DIST)
    p_adm = gap2 <= r2
    if not torch.equal(p_adm.sum(-1, dtype=torch.int32), p_count):
        fail(f"tile_plan {label}: the plain count disagrees with the plain test")
    if bool((p_adm & ~k_adm).any()):
        fail(f"tile_plan {label}: the kernel dropped {int((p_adm & ~k_adm).sum())} tile "
             "pairs that the plain version admits")
    on_edge = (gap2 - r2).abs() <= 1e-5 * r2
    if bool(((k_adm != p_adm) & ~on_edge).any()):
        fail(f"tile_plan {label}: lists differ away from the rounding edge")
    own_list, own_count = own_plan(center)
    torch.cuda.synchronize()
    own_list, own_count = own_list.view(k_list.shape), own_count.view(k_count.shape)
    if not (torch.equal(own_count, k_count)
            and torch.equal(torch.where(k_used, own_list, 0), torch.where(k_used, k_list, 0))):
        fail(f"tile_plan {label}: the plan written inside the sweep's launch function "
             "differs from the kernel's on its own")
    return (center, k_prep, k_list, k_count), p_count, int(k_count.sum()), prep_err, plan_err


def kernel_inputs(torch, dev, gen, world):
    """The kernels' inputs, built as the main path builds them: a lag block
    of scans, cropped and Morton-downsampled (K2's input, with its masked
    slots); the voxel map of the block's scans 1..K-1 in a 2^18-slot table,
    and the Morton-sorted patch cropped from it (K1's refs, padded with the
    sentinel); scan 0 under a pose estimate 6 cm off, applied as an ICP
    iteration applies it (K1's queries).  Returns (q, r, block)."""
    from open3d_slam_advanced_rss_2024_public_tpu_torch.frontends import synthetic
    from open3d_slam_advanced_rss_2024_public_tpu_torch.models import pipeline, scan_processing
    from open3d_slam_advanced_rss_2024_public_tpu_torch.ops import voxel_map
    from open3d_slam_advanced_rss_2024_public_tpu_torch.utils import pointcloud as pc
    from open3d_slam_advanced_rss_2024_public_tpu_torch.utils import se3

    pose_map = np.eye(4, dtype=np.float32)
    pose_map[:3, 3] = [12.0, 0.0, 1.0]
    sensor = [pose_map @ _step_along_x(0.4 * k) for k in range(LAG)]
    raw = pc.stack([synthetic.render_scan(world, sensor[k], gen, n_points=N_SCAN,
                                          max_range=25.0, noise=0.004) for k in range(LAG)])
    blk = scan_processing.preprocess_scan(raw, 0.7, 25.0, 0.1, 1.0, N_SCAN,
                                          estimate_scan_normals=False)
    merged = blk.transform(torch.as_tensor(np.stack(sensor), device=dev))
    vmap = voxel_map.insert(voxel_map.empty(1 << 18, device=dev),
                            pipeline._flat_block(merged, torch.arange(LAG, device=dev) > 0),
                            0.1)
    est = sensor[0].copy()
    est[:3, 3] += [0.05, -0.03, 0.02]
    est = torch.as_tensor(est, device=dev)
    _, grid = scan_processing.crop_submap_and_index(
        vmap.cloud, est[:3, 3], 0.0, 25.0 + pipeline.PipelineConfig.block_ref_margin,
        MAX_DIST, N_PATCH, build_hash=False)
    return se3.apply(est, blk.xyz[0]), grid.points, blk


def kernel_checks(torch, dev, gen, world):
    """Phases 2-3: every kernel against its plain version at the main
    path's shapes and on inputs built as the main path builds them, and
    their times.  Returns the rows of the kernels line
    (without their launch counts)."""
    from open3d_slam_advanced_rss_2024_public_tpu_torch.ops import (cuda_moments, cuda_nn,
                                                                    cuda_tiles, hashgrid)
    from open3d_slam_advanced_rss_2024_public_tpu_torch.utils import pointcloud as pc

    q, r, blk = kernel_inputs(torch, dev, gen, world)
    rows = []

    # -- 3a. the tile-planning kernels against their plain versions ---------
    (center, prep, k_list, k_count), p_count, entries, prep_err, plan_err = check_tiles(
        torch, cuda_tiles, q[None], None, r[None], None, "K1 inputs",
        lambda c: cuda_nn._launch(q, cuda_nn.prepare_ref(r), MAX_DIST, with_plan=True)[2:])
    (center2, prep2, k_list2, k_count2), p_count2, _, prep_err2, plan_err2 = check_tiles(
        torch, cuda_tiles, blk.xyz, blk.mask, blk.xyz, blk.mask, "K2 inputs",
        lambda c: cuda_moments._launch(blk.xyz, blk.mask, c, RADIUS, with_plan=True)[2:])
    extra = int(k_count.sum()) - int(p_count.sum())
    extra2 = int(k_count2.sum()) - int(p_count2.sum())
    nq, npt = k_list.shape[-2:]
    phase("tile plan", tiles=f"{cuda_tiles.TQ}x{cuda_tiles.TP}",
          k1_tile_pairs=f"{int(k_count.sum())}/{nq * npt}",
          k1_extra_vs_plain=extra,
          k1_longest_list=int(k_count.max()),
          k2_tile_pairs=f"{int(k_count2.sum())}/{k_count2.numel() * prep2[1].shape[-2]}",
          k2_extra_vs_plain=extra2,
          k2_longest_list=int(k_count2.max()))
    # Times at both call sites of each kernel: K1's reference and queries
    # ([1, N]) and K2's lag block ([K, N]); the row reports K1's, the shape
    # launched 1575 times a run, and the phase line both.
    prep_ms = graph_ms(lambda: cuda_tiles.tile_prepare(r[None], None, center))
    prep_ms2 = graph_ms(lambda: cuda_tiles.tile_prepare(blk.xyz, blk.mask, center2))
    prep_plain_ms = cuda_ms(lambda: cuda_tiles.tile_prepare_plain(r[None], None, center))
    plan_ms = graph_ms(lambda: cuda_tiles.tile_plan(q[None], None, center, prep[1], prep[2],
                                                    MAX_DIST))
    plan_ms2 = graph_ms(lambda: cuda_tiles.tile_plan(blk.xyz, blk.mask, center2, prep2[1],
                                                     prep2[2], MAX_DIST))
    plan_plain_ms = cuda_ms(lambda: cuda_tiles.tile_plan_plain(q[None], None, center, prep[1],
                                                               prep[2], MAX_DIST))
    # Bytes: points in, rows and boxes out (prepare); points and boxes in,
    # boxes, counts and the list entries written out (plan).  Operations:
    # ~20 per tile-pair test (plan), a handful per point (both).
    prep_bound, prep_by = bound_ms(r.numel() * 4 + 12 + prep[0].numel() * 4
                                   + 2 * prep[1].numel() * 4, r.numel() * 2)
    plan_bound, plan_by = bound_ms(q.numel() * 4 + 12 + 2 * prep[1].numel() * 4
                                   + nq * (24 + 4) + entries * 4,
                                   q.numel() * 2 + nq * npt * 20)
    phase("tile kernels", prepare_ms=f"{prep_ms:.4f}", prepare_k2_ms=f"{prep_ms2:.4f}",
          prepare_plain_ms=f"{prep_plain_ms:.4f}", prepare_bound_ms=f"{prep_bound:.6f}",
          plan_ms=f"{plan_ms:.4f}", plan_k2_ms=f"{plan_ms2:.4f}",
          plan_plain_ms=f"{plan_plain_ms:.4f}", plan_bound_ms=f"{plan_bound:.6f}")
    source = "open3d_slam_advanced_rss_2024_public_tpu_torch/csrc/"
    jax_ops = "open3d_slam_advanced_rss_2024_public_tpu/ops/"
    rows.append({"name": "tile_prepare", "route": "cuda", "source": source + "tiles.cuh",
                 "replaces": jax_ops + "pallas_nn.py:108",
                 "max_abs_err": max(prep_err, prep_err2), "ms": prep_ms,
                 "wrapper_ms": cuda_ms(lambda: cuda_tiles.tile_prepare(r[None], None, center)),
                 "plain_ms": prep_plain_ms, "bound_ms": prep_bound, "bound_by": prep_by,
                 "library_ms": None})
    rows.append({"name": "tile_plan", "route": "cuda", "source": source + "tiles.cuh",
                 "replaces": jax_ops + "pallas_nn.py:122",
                 "max_abs_err": max(plan_err, plan_err2),
                 "extra_tile_pairs": extra + extra2, "ms": plan_ms,
                 "wrapper_ms": cuda_ms(lambda: cuda_tiles.tile_plan(
                     q[None], None, center, prep[1], prep[2], MAX_DIST)),
                 "plain_ms": plan_plain_ms, "bound_ms": plan_bound, "bound_by": plan_by,
                 "library_ms": None})

    # -- 3b. K1 against its twin ------------------------------------------------
    err1, exact1 = check_nn(torch, cuda_nn, q, r, "main")
    check_nn(torch, cuda_nn, q, r, "main, prepared reference", prepared=True)
    # The bound counts the valid pairs of the sweep's own admissible tile
    # pairs, as the plan kernel listed them; swept_pairs the lanes it sweeps.
    swept = float(k_count.sum()) * cuda_tiles.TQ * cuda_tiles.TP
    pairs = needed_pairs(torch, cuda_tiles, k_list, k_count, q[None, :, 0].abs() < 1e7,
                         r[None, :, 0].abs() < 1e7)
    qd, rd, _ = cuda_nn._demean(q, r)
    jax_pairs = jax_tiling_pairs(cuda_tiles, qd, qd[:, 0].abs() < 1e7, rd,
                                 rd[:, 0].abs() < 1e7, MAX_DIST)
    ref = cuda_nn.prepare_ref(r)
    k1_ms = graph_ms(lambda: cuda_nn._launch(q, ref, MAX_DIST))
    k1_wrapper_ms = cuda_ms(lambda: cuda_nn.nn(q, ref, MAX_DIST), reps=100)
    k1_raw_ms = cuda_ms(lambda: cuda_nn.nn(q, r, MAX_DIST))
    k1_prepare_ms = cuda_ms(lambda: cuda_nn.prepare_ref(r))
    k1_plain_ms = cuda_ms(lambda: cuda_nn.nn_plain(q, r, MAX_DIST), reps=5)
    k1_lib_ms = cuda_ms(lambda: torch.cdist(q[None], r[None])[0].argmin(-1), reps=5)
    k1_bytes = q.numel() * 4 + r.numel() * 4 + q.shape[0] * (8 + 4)
    k1_bound, k1_by = bound_ms(k1_bytes, pairs * K1_OPS_PER_PAIR)
    k1_jax_bound, _ = bound_ms(k1_bytes, jax_pairs * K1_OPS_PER_PAIR)
    phase("K1 nn", shape=f"{q.shape[0]}x{r.shape[0]}",
          valid=f"{int((q[:, 0].abs() < 1e7).sum())}x{int((r[:, 0].abs() < 1e7).sum())}",
          max_abs_err_d2=err1, exact_idx_share=f"{exact1:.6f}",
          swept_pairs=f"{swept:.0f}", needed_pairs=f"{pairs:.0f}",
          jax_tiling_pairs=f"{jax_pairs:.0f}",
          ms=f"{k1_ms:.4f}", wrapper_ms=f"{k1_wrapper_ms:.4f}",
          prepare_ref_ms=f"{k1_prepare_ms:.4f}", unprepared_wrapper_ms=f"{k1_raw_ms:.4f}",
          plain_ms=f"{k1_plain_ms:.4f}", cdist_argmin_ms=f"{k1_lib_ms:.4f}",
          bound_ms=f"{k1_bound:.6f}", bound_by=k1_by,
          jax_tiling_bound_ms=f"{k1_jax_bound:.6f}")
    rng = np.random.default_rng(11)
    big_r = torch.as_tensor(rng.uniform(-30.0, 30.0, (N_BIG, 3)).astype(np.float32), device=dev)
    big_q = big_r[torch.as_tensor(rng.choice(N_BIG, N_SCAN, replace=False), device=dev)]
    big_q = big_q + 0.05 * torch.randn(big_q.shape, generator=gen, device=dev)
    err_big, exact_big = check_nn(
        torch, cuda_nn, hashgrid.morton_sort(pc.make_cloud(big_q), MAX_DIST).xyz,
        hashgrid.morton_sort(pc.make_cloud(big_r), MAX_DIST).xyz, "big")
    phase("K1 nn N>131072", shape=f"{N_SCAN}x{N_BIG}", max_abs_err_d2=err_big,
          exact_idx_share=f"{exact_big:.6f}")
    # Long lists, merged across blocks: the queries in random order, so that
    # every query tile spans the scene and admits every ref tile, and the
    # refs twice over, so that every query has two exact nearest neighbours
    # 32768 indices apart, in ref tiles that different blocks sweep: the
    # 64-bit atomic minimum must return the lower index, as the twin does.
    shuffled = q[torch.randperm(q.shape[0], generator=gen, device=dev)]
    twice = torch.cat([r, r])
    ref2 = cuda_nn.prepare_ref(twice)
    _, split_count, _, _ = cuda_tiles.tile_plan(shuffled[None], None, ref2.center[None],
                                                ref2.p_min[None], ref2.p_max[None], MAX_DIST)
    longest = int(split_count.max())
    per_block = cuda_nn.tiles_per_block(longest, ref2.p_min.shape[0])
    if longest <= per_block:
        fail("K1 split: no query tile's list is long enough to be split over blocks")
    err_split, exact_split = check_nn(torch, cuda_nn, shuffled, twice, "split")
    if exact_split < 1.0:
        fail(f"K1 split: only {exact_split:.6f} of the tied queries got the lower index")
    phase("K1 nn split lists", shape=f"{q.shape[0]}x{twice.shape[0]}",
          longest_list=longest, blocks=-(-longest // per_block),
          max_abs_err_d2=err_split, exact_idx_share=f"{exact_split:.6f}")
    rows.append({"name": "nn", "route": "cuda", "source": source + "nn.cu",
                 "replaces": jax_ops + "pallas_nn.py:154", "max_abs_err": err1, "ms": k1_ms,
                 "wrapper_ms": k1_wrapper_ms, "prepare_ref_ms": k1_prepare_ms,
                 "plain_ms": k1_plain_ms, "bound_ms": k1_bound, "bound_by": k1_by,
                 "jax_tiling_bound_ms": k1_jax_bound, "library_ms": k1_lib_ms})

    # -- 3c. K2 against its twin ------------------------------------------------
    kc, kcov = cuda_moments.radius_moments(blk.xyz, blk.mask, RADIUS)
    pcnt, pcov = cuda_moments.radius_moments_plain(blk.xyz, blk.mask, RADIUS)
    torch.cuda.synchronize()
    m = blk.mask
    if kc.shape != m.shape or kcov.shape != m.shape + (3, 3):
        fail(f"K2: returned shapes {tuple(kc.shape)}, {tuple(kcov.shape)}")
    if not torch.equal(kc[m], pcnt[m]):
        fail(f"K2: {int((kc != pcnt)[m].sum())} neighbourhood counts differ from the twin")
    err2 = float((kcov - pcov)[m].abs().max())
    # Covariances of d = q - p over |d| <= 0.5 m: entries up to 0.25 m^2,
    # sums of up to a few hundred terms in another order (and with FMAs).
    if not err2 <= 1e-5:
        fail(f"K2: covariance differs from the twin by {err2} (> 1e-5)")
    xd, pd, valid2 = cuda_nn._demean(blk.xyz, blk.xyz, blk.mask)
    swept2 = float(k_count2.sum()) * cuda_tiles.TQ * cuda_tiles.TP
    pairs2 = needed_pairs(torch, cuda_tiles, k_list2, k_count2, valid2, valid2)
    jax_pairs2 = jax_tiling_pairs(cuda_tiles, xd, valid2, pd, valid2, RADIUS)
    admitted = float(kc[m].sum())
    k2_ms = graph_ms(lambda: cuda_moments._launch(blk.xyz, blk.mask, center2, RADIUS))
    k2_wrapper_ms = cuda_ms(lambda: cuda_moments.radius_moments(blk.xyz, blk.mask, RADIUS))
    k2_plain_ms = cuda_ms(lambda: cuda_moments.radius_moments_plain(blk.xyz, blk.mask, RADIUS),
                          reps=3, warmup=1)
    k2_bytes = blk.xyz.numel() * 4 + m.numel() + m.numel() * 4 * (1 + 9)
    k2_bound, k2_by = bound_ms(k2_bytes,
                               pairs2 * K2_OPS_PER_PAIR + admitted * K2_OPS_PER_ADMITTED)
    k2_jax_bound, _ = bound_ms(k2_bytes,
                               jax_pairs2 * K2_OPS_PER_PAIR + admitted * K2_OPS_PER_ADMITTED)
    phase("K2 moments", shape=f"{LAG}x{N_SCAN}", max_abs_err_cov=err2,
          mean_count=f"{admitted / float(m.sum()):.2f}", swept_pairs=f"{swept2:.0f}",
          needed_pairs=f"{pairs2:.0f}",
          jax_tiling_pairs=f"{jax_pairs2:.0f}",
          ms=f"{k2_ms:.4f}", wrapper_ms=f"{k2_wrapper_ms:.4f}", plain_ms=f"{k2_plain_ms:.4f}",
          bound_ms=f"{k2_bound:.6f}", bound_by=k2_by,
          jax_tiling_bound_ms=f"{k2_jax_bound:.6f}")
    rows.append({"name": "moments", "route": "cuda", "source": source + "moments.cu",
                 "replaces": jax_ops + "pallas_moments.py:130", "max_abs_err": err2,
                 "ms": k2_ms, "wrapper_ms": k2_wrapper_ms, "plain_ms": k2_plain_ms,
                 "bound_ms": k2_bound, "bound_by": k2_by,
                 "jax_tiling_bound_ms": k2_jax_bound, "library_ms": None})
    return rows


SLAM_SCANS = 48
SLAM_OVERLAP = 16384
SLAM_MAP_VOXEL = 0.12


def slam_params(scan_points: int, patch: int, submap_points: int, feature_points: int,
                overlap_points: int, ransac_batch: int):
    """The loop-closure configuration of ``tests/test_full_slam.py:15-49``
    with the capacities given."""
    from open3d_slam_advanced_rss_2024_public_tpu_torch.utils.config import load_parameters

    return load_parameters({"mapper": {
        "mapper_localizer": {
            "is_print_timing_information": False,
            "is_attempt_loop_closures": True,
            "scan_to_map_registration": {
                "min_refinement_fitness": 0.25,
                "scan_to_map_refinement_type": "PointToPlaneIcp",
                "icp": {"max_n_iter": 15, "max_correspondence_dist": 0.6},
                "scan_processing": {
                    "voxel_size": 0.15, "point_capacity": scan_points,
                    "scan_cropping": {"cropping_radius_max": 18.0,
                                      "cropping_radius_min": 0.5}},
                "map_patch_capacity": patch}},
        "submaps": {"point_capacity": submap_points, "submap_size": 8.0,
                    "min_num_range_data": 3, "submaps_num_scan_overlap": 3},
        "map_builder": {"map_voxel_size": SLAM_MAP_VOXEL},
        "place_recognition": {
            "feature_voxel_size": 0.4,
            "feature_map_normal_estimation_radius": 1.2,
            "feature_radius": 1.8,
            "ransac_min_corresondence_set_size": 20,
            "min_icp_refinement_fitness": 0.4,
            "max_icp_correspondence_distance": 0.5,
            "loop_closure_search_radius": 12.0,
            "min_submaps_between_loop_closures": 0,
            "feature_point_capacity": feature_points,
            "overlap_point_capacity": overlap_points,
            "ransac_batch_size": ransac_batch}}})


# Printed field -> the tracer's loop-closure span (``utils/timing.py``).
LOOP_CLOSURE_STAGES = {"features": "loop_closure/features",
                       "odom_constraints": "loop_closure/odometry_constraints",
                       "lc_build": "loop_closure/candidates",
                       "pose_graph_solve": "loop_closure/solve",
                       "lc_apply_transforms": "loop_closure/apply"}


def loop_closure_stage_ms(timing) -> dict:
    """``<field>_ms``: "total host ms/calls" of each loop-closure span the
    tracer recorded."""
    spans = timing.records()["spans"]
    out = {}
    for field, name in LOOP_CLOSURE_STAGES.items():
        ms = [(s.end_ns - s.start_ns) * 1e-6 for s in spans if s.name == name]
        if ms:
            out[f"{field}_ms"] = f"{sum(ms):.1f}/{len(ms)}"
    return out


def span(values) -> str:
    return f"{min(values)}..{max(values)}" if values else "none"


def run_slam(slam, scans, odom, gt0):
    """Feed scans with their odometry through the offline stepper."""
    slam.set_initial_transform(gt0)
    for i, scan in enumerate(scans):
        slam.use_pair_for_registration(scan, odom[i], 0.1 * i)
    slam.finish_processing()
    return np.stack(slam.trajectory_poses)


def record_builder_evaluations(pr, cuda_nn, capacity: int):
    """Wrap the constraint builders' two device evaluations (one odometry
    edge, one loop-closure candidate) so that each records the K1 launches
    made inside it and keeps its output row, which holds the valid lanes of
    its two overlap clouds.  The offline stepper runs every stage on the
    caller's thread, so the differences are exact.  Returns ``finish``,
    which puts the functions back and returns the launches by
    (kind, whether both overlap clouds fill every lane) and the valid-lane
    counts by kind."""
    real = {"closure": (pr._lc_candidate_eval, 17), "edge": (pr._odo_edge_eval, 0)}
    records = []

    def wrap(kind):
        def inner(*args, **kwargs):
            before = cuda_nn.launches
            row = real[kind][0](*args, **kwargs)
            records.append((kind, cuda_nn.launches - before, row))
            return row
        return inner
    pr._lc_candidate_eval, pr._odo_edge_eval = wrap("closure"), wrap("edge")

    def finish():
        pr._lc_candidate_eval, pr._odo_edge_eval = real["closure"][0], real["edge"][0]
        launches = {(kind, full): 0 for kind in real for full in (False, True)}
        lanes = {kind: [] for kind in real}
        for kind, n, row in records:
            at = real[kind][1]
            valid = [int(v) for v in row[at:at + 2].cpu()]
            lanes[kind] += valid
            launches[(kind, min(valid) == capacity)] += n
        return launches, lanes
    return finish


def slam_loop(torch, dev, gen):
    """Phase ``slam loop``: the SLAM runtime with loop closure at full
    width.  Returns (slam, launches of this path, the run's inputs, and the
    poses, constraints and arguments of its last pose-graph solve)."""
    from open3d_slam_advanced_rss_2024_public_tpu_torch.frontends import synthetic
    from open3d_slam_advanced_rss_2024_public_tpu_torch.models import place_recognition as pr
    from open3d_slam_advanced_rss_2024_public_tpu_torch.models.slam import SlamWrapper
    from open3d_slam_advanced_rss_2024_public_tpu_torch.ops import (cuda_moments, cuda_nn,
                                                                    cuda_tiles)
    from open3d_slam_advanced_rss_2024_public_tpu_torch.utils import io, timing

    world = synthetic.cluttered_world(11, extent=34.0, n_objects=50, device=dev)
    gt = synthetic.loop_trajectory(SLAM_SCANS, radius=10.0, center=(17.0, 0.0), z=1.0)
    gt.append(gt[0])  # close the loop physically
    odom = synthetic.perturb_odometry(gt, drift_per_step=0.015, yaw_drift_per_step=0.002,
                                      seed=3)
    scans = [synthetic.render_scan(world, gt[i], gen, n_points=N_SCAN, max_range=18.0,
                                   noise=0.004) for i in range(SLAM_SCANS + 1)]
    params = slam_params(N_SCAN, N_PATCH, 131072, 8192, SLAM_OVERLAP, 4096)
    # Warm-up (allocator, cuSOLVER handle) on a run that rolls over once.
    run_slam(SlamWrapper(params, device=dev), scans[:10], odom, gt[0])
    torch.cuda.synchronize()
    timing.reset()
    timing.enable()
    cuda_nn.reset_launches()
    cuda_moments.reset_launches()
    cuda_tiles.reset_launches()
    slam = SlamWrapper(params, device=dev)
    finish_record = record_builder_evaluations(pr, cuda_nn, SLAM_OVERLAP)
    # The graph of every solve with a closure in it, to run the last again
    # on its own (``pose_graph_solve``).
    solves = []
    solve_async = slam.optimization.solve_async

    def keeping(node_poses, **kwargs):
        solves.append(([np.array(x) for x in node_poses], slam.optimization.to_dict(), kwargs))
        return solve_async(node_poses, **kwargs)
    slam.optimization.solve_async = keeping
    t0 = time.perf_counter()
    est = run_slam(slam, scans, odom, gt[0])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    timing.disable()
    builders, lanes = finish_record()
    launches = {"nn": cuda_nn.launches, "moments": cuda_moments.launches,
                "tile_prepare": cuda_tiles.prepare_launches,
                "tile_plan": cuda_tiles.plan_launches, "builders": builders}
    from_edges = builders[("edge", False)] + builders[("edge", True)]
    from_closures = builders[("closure", False)] + builders[("closure", True)]
    gt_arr, odom_arr = np.stack(gt[:len(est)]), np.stack(odom[:len(est)])
    ate_est = io.ate_rmse(est, gt_arr, align=False)
    ate_odom = io.ate_rmse(odom_arr, gt_arr, align=False)
    phase("slam loop", scans=len(est), ms_per_scan=f"{wall / len(est) * 1e3:.3f}",
          submaps=len(slam.mapper.submaps.submaps), closures=slam.loop_closure_count,
          ate_odometry_m=f"{ate_odom:.4f}", ate_slam_m=f"{ate_est:.4f}",
          nn_launches=launches["nn"], nn_launches_odometry_edges=from_edges,
          nn_launches_loop_closures=from_closures,
          nn_launches_on_full_overlap_clouds=builders[("edge", True)]
          + builders[("closure", True)],
          edge_overlap_lanes=span(lanes["edge"]), closure_overlap_lanes=span(lanes["closure"]),
          moments_launches=launches["moments"], **loop_closure_stage_ms(timing))
    if est.shape != (SLAM_SCANS + 1, 4, 4) or not np.isfinite(est).all():
        fail(f"slam loop: poses of shape {est.shape}, finite={np.isfinite(est).all()}")
    if len(slam.mapper.submaps.submaps) < 3:
        fail(f"slam loop: only {len(slam.mapper.submaps.submaps)} submaps")
    if slam.loop_closure_count < 1:
        fail("slam loop: no loop closure was found on a closed loop")
    if not (ate_est < ate_odom and ate_est < 0.5):
        fail(f"slam loop: ATE {ate_est:.3f} m against the odometry's {ate_odom:.3f} m")
    if min(from_edges, from_closures) <= 0 or launches["nn"] <= from_edges + from_closures:
        fail(f"slam loop: K1 launches {launches} (odometry edges, loop-closure candidates "
             "and mapper all must launch it)")
    if launches["moments"] < SLAM_SCANS:
        fail(f"slam loop: K2 launched {launches['moments']} times for {SLAM_SCANS + 1} scans")
    return slam, launches, (scans, odom, gt, params), solves[-1]


def slam_online(torch, dev, gen):
    """Phase ``slam online``: 12 scans through the worker threads."""
    from open3d_slam_advanced_rss_2024_public_tpu_torch.frontends import synthetic
    from open3d_slam_advanced_rss_2024_public_tpu_torch.models.slam import SlamWrapper

    n = 12
    world = synthetic.cluttered_world(14, extent=24.0, n_objects=24, device=dev)
    # Travel farther than submap_size (8 m): at least one submap finishes.
    gt = synthetic.straight_trajectory(n, step=1.1, start=(2.0, 0.0, 1.0))
    scans = [synthetic.render_scan(world, gt[i], gen, n_points=N_SCAN, max_range=14.0)
             for i in range(n)]
    slam = SlamWrapper(slam_params(N_SCAN, N_PATCH, 131072, 8192, SLAM_OVERLAP, 4096),
                       device=dev)
    slam.set_initial_transform(gt[0])
    slam.start_workers()
    t0 = time.perf_counter()
    try:
        for i in range(n):
            slam.add_odometry_pose(0.1 * i, gt[i])
            while not slam.add_range_scan(scans[i], 0.1 * i):
                time.sleep(0.002)
        deadline = time.perf_counter() + 120.0
        while time.perf_counter() < deadline and (
                len(slam.trajectory_poses) < n or slam.mapper.submaps.finished_queue):
            time.sleep(0.01)
        online_threads = list(slam._feature_compute_threads)
        slam.finish_processing()
    finally:
        slam.stop_workers()
    wall = time.perf_counter() - t0
    err = max(np.linalg.norm(p[:3, 3] - gt[i][:3, 3])
              for i, p in enumerate(slam.trajectory_poses))
    phase("slam online", scans=n, trajectory_entries=len(slam.trajectory_poses),
          submaps=len(slam.mapper.submaps.submaps), wall_s=f"{wall:.2f}",
          max_pose_err_m=f"{err:.4f}", feature_threads=",".join(online_threads) or "none")
    if len(slam.trajectory_poses) != n or slam._scans_accepted != n:
        fail(f"slam online: {len(slam.trajectory_poses)} trajectory entries for "
             f"{slam._scans_accepted} accepted scans")
    if not (np.diff(np.asarray(slam.trajectory_times)) > 0).all():
        fail("slam online: trajectory times out of order")
    if not online_threads or any(t != "slam-features" for t in online_threads):
        fail(f"slam online: the feature pass ran on {online_threads}")
    if not any(s.features is not None for s in slam.mapper.submaps.submaps):
        fail("slam online: no finished submap got its descriptors")
    if not err < 0.5:
        fail(f"slam online: pose error {err:.3f} m")


def nn_shape_row(torch, label: str, q, r, max_dist: float, launches: int):
    """K1 against its twin on queries ``q`` and refs ``r`` at ``max_dist``,
    from raw refs and from a prepared reference, with its times and its
    bound (the valid pairs of the tile pairs its own lists admit on these
    inputs), and ``cdist`` + ``argmin`` in query chunks of at most
    LIBRARY_BLOCK distances.  Prints the phase line and returns the row of
    the kernels line; ``launches`` is the count of the path that gives K1
    this shape."""
    from open3d_slam_advanced_rss_2024_public_tpu_torch.ops import cuda_nn, cuda_tiles

    err, exact = check_nn(torch, cuda_nn, q, r, label, max_dist=max_dist, min_share=0.05)
    check_nn(torch, cuda_nn, q, r, label + ", prepared reference", prepared=True,
             max_dist=max_dist, min_share=0.05)
    ref = cuda_nn.prepare_ref(r)
    _, _, k_list, k_count = cuda_nn._launch(q, ref, max_dist, with_plan=True)
    # The kernel's lists hold the plain version's (a pair more only on the
    # rounding edge, which maxDist inf does not have; no empty tile there).
    _, p_count, _, _ = cuda_tiles.tile_plan_plain(q[None], None, ref.center[None],
                                                  ref.p_min[None], ref.p_max[None], max_dist)
    if bool((k_count < p_count[0]).any()) or (
            math.isinf(max_dist) and not torch.equal(k_count, p_count[0])):
        fail(f"K1 {label}: the plan admitted {int(k_count.sum())} tile pairs, the plain "
             f"version {int(p_count.sum())}")
    swept = float(k_count.sum()) * cuda_tiles.TQ * cuda_tiles.TP
    pairs = needed_pairs(torch, cuda_tiles, k_list, k_count, q[:, 0].abs() < 1e7,
                         r[:, 0].abs() < 1e7)
    ms = graph_ms(lambda: cuda_nn._launch(q, ref, max_dist))
    wrapper_ms = cuda_ms(lambda: cuda_nn.nn(q, ref, max_dist), reps=50)
    plain_ms = cuda_ms(lambda: cuda_nn.nn_plain(q, r, max_dist), reps=3, warmup=1)
    chunk = max(1, LIBRARY_BLOCK // r.shape[0])

    def library():
        for i in range(0, q.shape[0], chunk):
            torch.cdist(q[None, i:i + chunk], r[None])[0].argmin(-1)
    torch.cuda.empty_cache()
    lib_ms = cuda_ms(library, reps=3, warmup=1)
    torch.cuda.empty_cache()
    bound, by = bound_ms(q.numel() * 4 + r.numel() * 4 + q.shape[0] * (8 + 4),
                         pairs * K1_OPS_PER_PAIR)
    phase("K1 nn " + label, shape=f"{q.shape[0]}x{r.shape[0]}",
          valid=f"{int((q[:, 0].abs() < 1e7).sum())}x{int((r[:, 0].abs() < 1e7).sum())}",
          max_dist=f"{max_dist:g}", launches=launches, max_abs_err_d2=err,
          exact_idx_share=f"{exact:.6f}", swept_pairs=f"{swept:.0f}",
          needed_pairs=f"{pairs:.0f}", ms=f"{ms:.4f}", wrapper_ms=f"{wrapper_ms:.4f}",
          plain_ms=f"{plain_ms:.4f}", cdist_argmin_ms=f"{lib_ms:.4f}",
          cdist_argmin_chunks=-(-q.shape[0] // chunk), bound_ms=f"{bound:.6f}", bound_by=by)
    return {"name": f"nn ({label})", "route": "cuda",
            "source": "open3d_slam_advanced_rss_2024_public_tpu_torch/csrc/nn.cu",
            "replaces": "open3d_slam_advanced_rss_2024_public_tpu/ops/pallas_nn.py:154",
            "launches": launches, "max_abs_err": err, "ms": ms, "wrapper_ms": wrapper_ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by, "library_ms": lib_ms}


def moments_shape_row(torch, label: str, blk, launches: int):
    """K2 against its twin on a [1, N] block at ``RADIUS``, with its times
    and its bound (the pairs its own tile lists sweep).  Prints the phase
    line and returns the row of the kernels line; ``launches`` is the count
    of the path that gives K2 this shape."""
    from open3d_slam_advanced_rss_2024_public_tpu_torch.ops import cuda_moments, cuda_tiles

    kc, kcov = cuda_moments.radius_moments(blk.xyz, blk.mask, RADIUS)
    pcnt, pcov = cuda_moments.radius_moments_plain(blk.xyz, blk.mask, RADIUS)
    torch.cuda.synchronize()
    m = blk.mask
    if not torch.equal(kc[m], pcnt[m]):
        fail(f"K2 {label}: {int((kc != pcnt)[m].sum())} neighbourhood counts differ from the twin")
    err2 = float((kcov - pcov)[m].abs().max())
    if not err2 <= 1e-5:
        fail(f"K2 {label}: covariance differs from the twin by {err2} (> 1e-5)")
    center = cuda_tiles.centroid(blk.xyz, m)
    _, _, k_list2, k_count2 = cuda_moments._launch(blk.xyz, m, center, RADIUS, with_plan=True)
    swept2 = float(k_count2.sum()) * cuda_tiles.TQ * cuda_tiles.TP
    valid2 = m & (blk.xyz[..., 0].abs() < 1e7)
    pairs2 = needed_pairs(torch, cuda_tiles, k_list2, k_count2, valid2, valid2)
    admitted = float(kc[m].sum())
    ms2 = graph_ms(lambda: cuda_moments._launch(blk.xyz, m, center, RADIUS))
    wrapper_ms2 = cuda_ms(lambda: cuda_moments.radius_moments(blk.xyz, m, RADIUS))
    plain_ms2 = cuda_ms(lambda: cuda_moments.radius_moments_plain(blk.xyz, m, RADIUS),
                        reps=3, warmup=1)
    bound2, by2 = bound_ms(blk.xyz.numel() * 4 + m.numel() + m.numel() * 4 * (1 + 9),
                           pairs2 * K2_OPS_PER_PAIR + admitted * K2_OPS_PER_ADMITTED)
    phase("K2 moments " + label, shape=f"{m.shape[0]}x{m.shape[1]}", valid=int(m.sum()),
          launches=launches, max_abs_err_cov=err2,
          mean_count=f"{admitted / float(m.sum()):.2f}", swept_pairs=f"{swept2:.0f}",
          needed_pairs=f"{pairs2:.0f}", ms=f"{ms2:.4f}", wrapper_ms=f"{wrapper_ms2:.4f}", plain_ms=f"{plain_ms2:.4f}",
          bound_ms=f"{bound2:.6f}", bound_by=by2)
    return {"name": f"moments ({label})", "route": "cuda",
            "source": "open3d_slam_advanced_rss_2024_public_tpu_torch/csrc/moments.cu",
            "replaces": "open3d_slam_advanced_rss_2024_public_tpu/ops/pallas_moments.py:130",
            "launches": launches, "max_abs_err": err2, "ms": ms2, "wrapper_ms": wrapper_ms2,
            "plain_ms": plain_ms2, "bound_ms": bound2, "bound_by": by2, "library_ms": None}


def slam_own_odometry(torch, dev, gen):
    """Phase ``slam own odometry``: 8 scans through the stepper with no
    odometry pose handed in, so that the scan-to-scan ``LidarOdometry``
    (K1 at scan x scan, K2 over one scan) feeds the mapper's prior, with
    motion compensation on.  Then K1 against its twin at that shape: two
    consecutive scans preprocessed as the odometry preprocesses them, at its
    correspondence distance.  Returns the row of the kernels line."""
    import dataclasses

    from open3d_slam_advanced_rss_2024_public_tpu_torch.frontends import synthetic
    from open3d_slam_advanced_rss_2024_public_tpu_torch.models.slam import SlamWrapper
    from open3d_slam_advanced_rss_2024_public_tpu_torch.ops import cuda_nn
    from open3d_slam_advanced_rss_2024_public_tpu_torch.utils.config import load_parameters

    n = 8
    world = synthetic.cluttered_world(12, extent=20.0, n_objects=25, device=dev)
    gt = synthetic.straight_trajectory(n, step=0.4, start=(2.0, 0.0, 1.0))
    scans = [synthetic.render_scan(world, gt[i], gen, n_points=N_SCAN, max_range=15.0,
                                   noise=0.004) for i in range(n)]
    base = slam_params(N_SCAN, N_PATCH, 131072, 8192, SLAM_OVERLAP, 4096)
    extra = load_parameters({
        "odometry": {"scan_matching": {"cloud_registration_type": "PointToPlaneIcp"},
                     "scan_processing": {"voxel_size": 0.15, "point_capacity": N_SCAN}},
        "motion_compensation": {"is_undistort_scan": True, "scan_duration": 0.01}})
    slam = SlamWrapper(dataclasses.replace(base, odometry=extra.odometry,
                                           motion_compensation=extra.motion_compensation),
                       device=dev)
    slam.set_initial_transform(gt[0])
    counted = {"nn": 0}
    add_range_scan = slam.odometry.add_range_scan

    def counting(scan, time):
        before = cuda_nn.launches
        ok = add_range_scan(scan, time)
        counted["nn"] += cuda_nn.launches - before
        return ok
    slam.odometry.add_range_scan = counting
    t0 = time.perf_counter()
    for i, scan in enumerate(scans):
        slam.use_pair_for_registration(scan, None, 0.1 * i)
    slam.finish_processing()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    odom_err = float(np.linalg.norm(slam.odometry.odom_to_range_sensor[:3, 3] - gt[-1][:3, 3]))
    map_err = float(np.linalg.norm(slam.trajectory_poses[-1][:3, 3] - gt[-1][:3, 3]))
    phase("slam own odometry", scans=n, ms_per_scan=f"{wall / n * 1e3:.3f}",
          nn_launches_odometry=counted["nn"], rejected_jumps=slam.odometry.rejected_jumps,
          low_fitness=slam.odometry.low_fitness, odometry_end_err_m=f"{odom_err:.4f}",
          mapper_end_err_m=f"{map_err:.4f}")
    if slam.use_external_odometry or len(slam.trajectory_poses) != n:
        fail("slam own odometry: the stepper did not run on its own odometry")
    if counted["nn"] < n - 1:
        fail(f"slam own odometry: K1 launched {counted['nn']} times from the odometry")
    if not (odom_err < 0.15 and map_err < 0.05):
        fail(f"slam own odometry: end error {odom_err:.3f} m (odometry), {map_err:.3f} m (mapper)")
    # The first trip of a registration: the new scan under the identity
    # against the scan before it.
    prev, cur = (slam.odometry._preprocess(scans[i]) for i in (n - 2, n - 1))
    return nn_shape_row(torch, "odometry, scan x scan", cur.xyz.contiguous(),
                        prev.xyz.contiguous(), slam.odometry.icp_cfg.max_correspondence_dist,
                        counted["nn"])


def slam_shape_checks(torch, dev, slam, launches, raw_scan):
    """K1 and K2 at the shapes the SLAM runtime gives them, against their
    plain versions: the overlap clouds of two neighbouring submaps
    (16384 x 16384, compacted) with masked lanes at the tail and with every
    lane filled, each at the loop-closure refinement's 0.5 m and at the
    odometry edges' 1.5 x map voxel; K2 over a single-scan block; and the
    information matrix with unmatched queries.  Each K1 case carries the
    launches that the loop's builders made on such clouds at that radius,
    and goes into the kernels line if there were any.  Returns the new rows
    of the kernels line."""
    from open3d_slam_advanced_rss_2024_public_tpu_torch.models import place_recognition as pr
    from open3d_slam_advanced_rss_2024_public_tpu_torch.models import scan_processing
    from open3d_slam_advanced_rss_2024_public_tpu_torch.ops import hashgrid
    from open3d_slam_advanced_rss_2024_public_tpu_torch.ops.registration import ransac

    rows = []
    subs = slam.mapper.submaps.submaps
    # Two neighbouring submaps, each cut to 9 m around its own centre: in
    # this 34 m world whole submaps overlap in more points than the capacity
    # holds, and the compacted clouds then have no masked tail.
    cut = [s.map.cloud.with_mask(torch.linalg.vector_norm(
        s.map.cloud.xyz - torch.as_tensor(s.center(), dtype=torch.float32, device=dev),
        dim=-1) < 9.0) for s in subs[:2]]
    overlap_voxel = pr.EXPANSION_FACTOR_OVERLAP * SLAM_MAP_VOXEL
    p_ov, c_ov = pr.overlap_clouds(cut[0], cut[1], overlap_voxel, SLAM_OVERLAP)
    n_q, n_r = int(p_ov.mask.sum()), int(c_ov.mask.sum())
    if not (0 < n_q < SLAM_OVERLAP and 0 < n_r < SLAM_OVERLAP):
        fail(f"K1 overlap: the overlap clouds hold {n_q} and {n_r} of {SLAM_OVERLAP} lanes "
             "(no masked tail)")
    p_all, c_all = pr.overlap_clouds(subs[0].map.cloud, subs[1].map.cloud, overlap_voxel,
                                     SLAM_OVERLAP)
    if int(p_all.mask.sum()) < SLAM_OVERLAP or int(c_all.mask.sum()) < SLAM_OVERLAP:
        fail("K1 overlap: the whole submaps' overlap leaves lanes empty")
    edge_dist = pr.EXPANSION_FACTOR_ICP_CORRESPONDENCE * SLAM_MAP_VOXEL
    for kind, max_dist in (("closure", 0.5), ("edge", edge_dist)):
        for full, (a, b) in ((False, (p_ov, c_ov)), (True, (p_all, c_all))):
            label = f"overlap {max_dist:g} m, " + ("every lane filled" if full else "masked tail")
            row = nn_shape_row(torch, label, a.xyz.contiguous(), b.xyz.contiguous(), max_dist,
                               launches["builders"][(kind, full)])
            if row["launches"] > 0:
                rows.append(row)

    # K2 over one scan (the offline stepper's blocks hold one scan).
    blk = scan_processing.preprocess_scan(raw_scan, 0.5, 18.0, 0.15, 1.0, N_SCAN,
                                          estimate_scan_normals=False).map(lambda t: t[None])
    rows.append(moments_shape_row(torch, "single-scan block", blk, launches["moments"]))

    # The information matrix where some queries have no reference within
    # max_dist: K1 answers index 0 / +inf there and the twin the nearest
    # reference at any distance, and both must give the same matrix.
    far = p_ov.xyz.clone()
    far[::3] += 40.0
    grid = hashgrid.passthrough(c_ov, 0.5)
    eye = torch.eye(4, device=dev)
    info_k, n_k = ransac.information_matrix_from_point_clouds(far, p_ov.mask, grid, eye, 0.5,
                                                              matcher="cuda")
    info_p, n_p = ransac.information_matrix_from_point_clouds(far, p_ov.mask, grid, eye, 0.5,
                                                              matcher="bruteforce")
    torch.cuda.synchronize()
    rel = float((info_k - info_p).abs().max() / info_p.abs().max())
    phase("information matrix kernel vs twin", matched=f"{int(n_k)}/{n_q}",
          unmatched_moved=int(p_ov.mask[::3].sum()), max_rel_diff=f"{rel:.3e}")
    if int(n_k) != int(n_p) or int(n_k) == 0 or not rel <= 1e-5:
        fail(f"information matrix: kernel and twin differ ({int(n_k)} vs {int(n_p)} matches, "
             f"relative difference {rel:.3e})")
    return rows


TWIN_SCANS = 16


def transform_difference(a: np.ndarray, b: np.ndarray):
    """(translation m, rotation rad) of a^-1 b.  The angle comes from the
    skew part and the trace together (atan2), which resolves the small
    angles that float32 matrices leave: arccos of the trace alone cannot
    tell anything below 0.3 mrad from zero."""
    rel = np.linalg.inv(a.astype(np.float64)) @ b.astype(np.float64)
    R = rel[:3, :3]
    sin = 0.5 * np.linalg.norm([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return float(np.linalg.norm(rel[:3, 3])), float(np.arctan2(sin, (np.trace(R) - 1) / 2))


def edge_differences(edges_a, edges_b):
    """Largest differences between two lists of graph edges, pair by pair:
    (translation m, rotation rad, information relative to its largest entry)."""
    d_trans = d_rot = d_info = 0.0
    for a, b in zip(edges_a, edges_b):
        t, r = transform_difference(a.T_source_target, b.T_source_target)
        d_trans, d_rot = max(d_trans, t), max(d_rot, r)
        d_info = max(d_info, float(np.abs(a.information - b.information).max()
                                   / np.abs(b.information).max()))
    return d_trans, d_rot, d_info


def run_slam_keeping_first_feedback(slam, scans, odom, gt0):
    """``run_slam``; also returns the trajectory and the graph's edges as
    they stood just before the first pose-graph result was applied (those
    of the whole run where none was)."""
    kept = {}
    check = slam.check_if_optimized_graph_available

    def keeping():
        if slam.optimized_graph_available and not kept:
            kept["poses"] = np.stack(slam.trajectory_poses)
            kept["edges"] = list(slam.optimization.odometry_constraints)
        check()
    slam.check_if_optimized_graph_available = keeping
    est = run_slam(slam, scans, odom, gt0)
    return est, kept.get("poses", est), kept.get("edges", slam.optimization.odometry_constraints)


def slam_kernel_vs_twin(torch, dev):
    """Phase ``slam kernel path vs twin path``: a 16-scan, 2048-point closed
    loop (radius 5 m, three rollovers, loop-closure candidates within the
    12 m search radius) through the SLAM runtime on the card and on the CPU
    from the same scans, odometry and seeds, every stage on both sides, the
    stopping tests as the runtime has them.  The two sides differ by the
    kernels against their twins and by the order of the devices' sums.

    Held to bars up to the first pose-graph feedback, where each side is a
    chain of registrations: the trajectory within 10 mm (as the Mapper's
    phase), the graph's odometry edges within 10 mm, 2 mrad and 5% of the
    information matrix's largest entry (the matrix sums over the overlap
    points matched within 1.5 x map voxel, and a millimetre of pose moves
    points across that radius).  What follows is printed and held
    only to the runtime's own bar (each side's ATE below the odometry's): a
    loop-closure proposal picks the best of 512 three-point hypotheses by an
    integer inlier count and refines it by an ICP that stops at 1 cm / 1 mrad
    steps, so a rounding difference can change which closures a run of
    this size accepts and moves the closed trajectory by centimetres; the
    closure's stages are held against the CPU one by one from a common
    state in ``slam closure stages`` instead."""
    from open3d_slam_advanced_rss_2024_public_tpu_torch.frontends import synthetic
    from open3d_slam_advanced_rss_2024_public_tpu_torch.models.slam import SlamWrapper
    from open3d_slam_advanced_rss_2024_public_tpu_torch.ops.registration import ransac

    # The draws themselves, on a mask with holes: the same lanes on both devices.
    mask = torch.arange(1024) % 3 != 0
    draws = [ransac.draw_picks(mask.to(d), 512, 256, torch.Generator().manual_seed(5))
             for d in (dev, "cpu")]
    if not all(torch.equal(a.cpu(), b) for a, b in zip(*draws)):
        fail("slam kernel path vs twin path: RANSAC draws differ between card and CPU")

    # Scans from a host-side generator of their own: they move neither with
    # the device nor with the draws that the phases before took.
    world = synthetic.cluttered_world(11, extent=34.0, n_objects=50, device="cpu")
    gt = synthetic.loop_trajectory(TWIN_SCANS - 1, radius=5.0, center=(17.0, 0.0), z=1.0)
    gt.append(gt[0])  # close the loop physically
    odom = synthetic.perturb_odometry(gt, drift_per_step=0.015, yaw_drift_per_step=0.002,
                                      seed=3)
    gen = torch.Generator().manual_seed(8)
    scans = [synthetic.render_scan(world, gt[i], gen, n_points=2048, max_range=18.0,
                                   noise=0.004) for i in range(TWIN_SCANS)]
    params = slam_params(2048, 4096, 8192, 1024, 2048, 512)
    gpu, cpu = SlamWrapper(params, device=dev), SlamWrapper(params, device="cpu")
    p_gpu, first_gpu, edges_gpu = run_slam_keeping_first_feedback(
        gpu, [s.to(dev) for s in scans], odom, gt[0])
    p_cpu, first_cpu, edges_cpu = run_slam_keeping_first_feedback(cpu, scans, odom, gt[0])
    n_first = min(len(first_gpu), len(first_cpu))
    n_edges = min(len(edges_gpu), len(edges_cpu))
    diff_first = float(np.abs(first_gpu[:n_first, :3, 3] - first_cpu[:n_first, :3, 3]).max())
    same_edges = [(e.source_id, e.target_id) for e in edges_gpu[:n_edges]] == \
        [(e.source_id, e.target_id) for e in edges_cpu[:n_edges]]
    d_trans, d_rot, d_info = edge_differences(edges_gpu[:n_edges], edges_cpu[:n_edges])
    diff_end = float(np.abs(p_gpu[:, :3, 3] - p_cpu[:, :3, 3]).max())
    gt_arr = np.stack(gt[:TWIN_SCANS])
    ate = [float(np.sqrt(np.mean(np.sum((x[:, :3, 3] - gt_arr[:, :3, 3]) ** 2, -1))))
           for x in (p_gpu, p_cpu, np.stack(odom[:TWIN_SCANS]))]
    phase("slam kernel path vs twin path", scans=TWIN_SCANS, points=2048,
          submaps=f"{len(gpu.mapper.submaps.submaps)}/{len(cpu.mapper.submaps.submaps)}",
          scans_before_first_feedback=f"{len(first_gpu)}/{len(first_cpu)}",
          max_pose_diff_mm=f"{diff_first * 1e3:.4f}", edges_compared=n_edges,
          max_edge_diff_mm=f"{d_trans * 1e3:.4f}", max_edge_diff_mrad=f"{d_rot * 1e3:.4f}",
          max_information_rel_diff=f"{d_info:.3e}",
          closures=f"{gpu.loop_closure_count}/{cpu.loop_closure_count}",
          max_pose_diff_after_feedback_mm=f"{diff_end * 1e3:.4f}",
          ate_card_m=f"{ate[0]:.4f}", ate_cpu_m=f"{ate[1]:.4f}", ate_odometry_m=f"{ate[2]:.4f}")
    if len(gpu.mapper.submaps.submaps) != len(cpu.mapper.submaps.submaps) or \
            len(gpu.mapper.submaps.submaps) < 3 or n_edges < 1 or not same_edges:
        fail("slam kernel path and twin path built different graphs")
    if n_first < TWIN_SCANS // 2:
        fail(f"slam kernel path vs twin path: only {n_first} scans before the first feedback")
    if not diff_first <= 0.01:
        fail(f"slam kernel path and twin path differ by {diff_first * 1e3:.2f} mm (> 10 mm)")
    if not (d_trans <= 0.01 and d_rot <= 2e-3 and d_info <= 0.05):
        fail(f"slam kernel path and twin path: graph edges differ by {d_trans * 1e3:.2f} mm, "
             f"{d_rot * 1e3:.2f} mrad, information {d_info:.3e}")
    if min(gpu.loop_closure_count, cpu.loop_closure_count) < 1:
        fail("slam kernel path vs twin path: a side closed no loop")
    if not max(ate[0], ate[1]) < ate[2]:
        fail(f"slam kernel path vs twin path: ATE {ate[0]:.3f} m (card), {ate[1]:.3f} m (CPU) "
             f"against the odometry's {ate[2]:.3f} m")


def submap_on(sm, device):
    """A copy of a submap with its tensors on ``device``."""
    import dataclasses

    return dataclasses.replace(
        sm, map=sm.map.to(device),
        dense_map=None if sm.dense_map is None else sm.dense_map.to(device),
        feature_cloud=None if sm.feature_cloud is None else sm.feature_cloud.to(device),
        features=None if sm.features is None else sm.features.to(device),
        pose=sm.pose.copy(), _center=np.array(sm.center()), _center_copy=None)


def slam_closure_stages(torch, dev, slam, params, node_poses, graph, solve_kwargs):
    """Phase ``slam closure stages``: the loop-closure stages at full width
    on the card against the CPU, each from the same state, taken from the
    finished ``slam loop``: the feature pass of one submap; one loop-closure
    candidate that the loop accepted, evaluated again in full (RANSAC with
    the same draws, overlap restriction, ICP refinement with K1 or its twin
    and the stopping test on, information matrix); the loop's last
    pose-graph solve; and the feedback of its increments onto all submaps.
    Bars: feature clouds equal lane for lane, descriptors within 1% of
    their norm on 95% of the lanes; the refined closure within the ICP's own
    stopping step (10 mm, 2 mrad), fitness within 0.02, information within
    2%; solved poses within 1 mm and 0.1 mrad; poses after feedback within
    1e-5 m, moved voxel means within 1e-4 m."""
    from open3d_slam_advanced_rss_2024_public_tpu_torch.models import place_recognition as pr
    from open3d_slam_advanced_rss_2024_public_tpu_torch.models import pose_graph
    from open3d_slam_advanced_rss_2024_public_tpu_torch.models.submap_collection import (
        SubmapCollection)

    subs = slam.mapper.submaps.submaps
    # The newest closure of the last solve: the edge the loop accepted last.
    closure = graph["loop_closure_constraints"][-1]
    by_id = {s.submap_id: s for s in subs}
    cand, query = by_id[closure["source"]], by_id[closure["target"]]
    place = params.mapper.place_recognition
    t0 = time.perf_counter()

    # -- features of the query submap, from the same map --------------------
    feats = {}
    for d in (dev, "cpu"):
        sc = SubmapCollection(params.mapper, device=d)
        sc.submaps = [submap_on(query, d)]
        sc.finished_queue.append((0, 0.0))
        sc.compute_features_for_finished()
        feats[d] = sc.submaps[0]
    fc, ff = feats[dev].feature_cloud.to("cpu"), feats[dev].features.cpu()
    hc, hf = feats["cpu"].feature_cloud, feats["cpu"].features
    m = hc.mask
    same_lanes = torch.equal(fc.mask, m)
    xyz_err = float((fc.xyz - hc.xyz)[m].abs().max()) if same_lanes else float("inf")
    # Lanes whose normals are parallel, or degenerate (zero) on both sides.
    dots = (fc.normals * hc.normals).sum(-1).abs()
    none = (fc.normals.abs().sum(-1) == 0) & (hc.normals.abs().sum(-1) == 0)
    normals_share = float(((dots > 1 - 1e-3) | none)[m].float().mean())
    rel = torch.linalg.vector_norm(ff - hf, dim=-1) / torch.linalg.vector_norm(hf, dim=-1).clamp(
        min=1e-9)
    fpfh_share = float((rel[m] <= 0.01).float().mean())

    # -- one accepted candidate again, from the card's features on both sides
    voxel = pr.EXPANSION_FACTOR_OVERLAP * SLAM_MAP_VOXEL
    rows = {}
    for d in (dev, "cpu"):
        q, c = submap_on(query, d), submap_on(cand, d)
        gen = torch.Generator().manual_seed(11)
        rows[d] = pr._lc_candidate_eval(
            q.feature_cloud, q.features, c.feature_cloud, c.features, q.map.cloud, c.map.cloud,
            gen, place.ransac_max_correspondence_dist,
            place.ransac_correspondence_checker_distance,
            place.ransac_correspondence_checker_edge_length, voxel,
            place.max_icp_correspondence_distance, overlap_capacity=place.overlap_point_capacity,
            refine_cfg=pr.PlaceRecognition(params.mapper).refine_cfg,
            ransac_batch=place.ransac_batch_size).cpu().numpy()
    k, h = rows[dev], rows["cpu"]
    ransac_d = transform_difference(k[:16].reshape(4, 4), h[:16].reshape(4, 4))
    refined_d = transform_difference(k[19:35].reshape(4, 4), h[19:35].reshape(4, 4))
    info_d = float(np.abs(k[36:72] - h[36:72]).max() / np.abs(h[36:72]).max())

    # -- the loop's last solve ------------------------------------------------
    solved = {}
    for d in (dev, "cpu"):
        problem = pose_graph.OptimizationProblem.from_dict(graph, device=d)
        solved[d] = (problem.solve(node_poses, **solve_kwargs), problem.last_switch_weights)
    solve_d = [transform_difference(solved[dev][0][i], solved["cpu"][0][i]) for i in solved[dev][0]]
    switch_d = float(np.abs(solved[dev][1] - solved["cpu"][1]).max())

    # -- feedback of the card's increments onto all submaps ------------------
    moved = {}
    for d in (dev, "cpu"):
        sc = SubmapCollection(params.mapper, device=d)
        sc.submaps = [submap_on(s, d) for s in subs]
        sc.active_idx = slam.mapper.submaps.active_idx
        sc.apply_transforms(solved[dev][0])
        moved[d] = sc
    pose_d = max(float(np.abs(a.pose - b.pose).max())
                 for a, b in zip(moved[dev].submaps, moved["cpu"].submaps))
    cloud_d, same_voxels = 0.0, True
    for a, b in zip(moved[dev].submaps, moved["cpu"].submaps):
        ca, cb = a.map.cloud.to("cpu"), b.map.cloud
        same_voxels &= torch.equal(ca.mask, cb.mask) and a.keys_stale == b.keys_stale
        if same_voxels:
            cloud_d = max(cloud_d, float((ca.xyz - cb.xyz)[cb.mask].abs().max()))
    increment = max(float(np.linalg.norm(dT[:3, 3])) for dT in solved[dev][0].values())
    phase("slam closure stages", query=query.submap_id, candidate=cand.submap_id,
          seconds=f"{time.perf_counter() - t0:.1f}",
          feature_lanes=f"{int(fc.mask.sum())}/{int(m.sum())}", feature_xyz_err=f"{xyz_err:.2e}",
          normals_same_share=f"{normals_share:.4f}", fpfh_within_1pct_share=f"{fpfh_share:.4f}",
          ransac_inliers=f"{int(k[16])}/{int(h[16])}",
          ransac_diff_mm=f"{ransac_d[0] * 1e3:.3f}", ransac_diff_mrad=f"{ransac_d[1] * 1e3:.3f}",
          overlap_lanes=f"{int(k[17])},{int(k[18])}/{int(h[17])},{int(h[18])}",
          refined_diff_mm=f"{refined_d[0] * 1e3:.4f}",
          refined_diff_mrad=f"{refined_d[1] * 1e3:.4f}", fitness=f"{k[35]:.4f}/{h[35]:.4f}",
          information_rel_diff=f"{info_d:.3e}",
          solve_diff_mm=f"{max(t for t, _ in solve_d) * 1e3:.4f}",
          solve_diff_mrad=f"{max(r for _, r in solve_d) * 1e3:.4f}",
          switch_weight_diff=f"{switch_d:.2e}", largest_increment_m=f"{increment:.4f}",
          feedback_pose_diff=f"{pose_d:.2e}", feedback_voxel_mean_diff=f"{cloud_d:.2e}")
    if not (same_lanes and xyz_err <= 1e-5 and normals_share >= 0.98 and fpfh_share >= 0.95):
        fail("slam closure stages: the feature pass differs between card and CPU")
    if int(k[16]) < place.ransac_min_corresondence_set_size or \
            k[35] < place.min_icp_refinement_fitness:
        fail("slam closure stages: the card rejects a closure that the loop accepted")
    if not (refined_d[0] <= 0.01 and refined_d[1] <= 2e-3 and abs(k[35] - h[35]) <= 0.02
            and info_d <= 0.02):
        fail("slam closure stages: the refined closure differs between card and CPU")
    if not (max(t for t, _ in solve_d) <= 1e-3 and max(r for _, r in solve_d) <= 1e-4
            and switch_d <= 1e-2):
        fail("slam closure stages: the pose-graph solve differs between card and CPU")
    if not (same_voxels and pose_d <= 1e-5 and cloud_d <= 1e-4):
        fail("slam closure stages: the feedback differs between card and CPU")


def pose_graph_solve(torch, dev, node_poses, graph, solve_kwargs):
    """Phase ``pose graph solve``: the last solve of the ``slam loop`` (its
    node poses and constraints as they stood, a closure still uncertain) run
    again on its own: LM trips dispatched before the polled flag stopped the
    loop, host time to dispatch them and to wait for the result, and, from a
    traced repeat, the device operations a trip."""
    from open3d_slam_advanced_rss_2024_public_tpu_torch.models import pose_graph

    trips = {"n": 0}
    assemble = pose_graph.assemble_normal_equations

    def counting(*args, **kwargs):
        trips["n"] += 1
        return assemble(*args, **kwargs)

    def solve():
        problem = pose_graph.OptimizationProblem.from_dict(graph, device=dev)
        trips["n"] = 0
        t0 = time.perf_counter()
        handle = problem.solve_async(node_poses, **solve_kwargs)
        t1 = time.perf_counter()
        increments = problem.resolve_async(handle)
        return (t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3, increments, problem

    pose_graph.assemble_normal_equations = counting
    try:
        solve()  # warm-up
        torch.cuda.synchronize()
        dispatch_ms, wait_ms, increments, problem = solve()
        n_trips = trips["n"]
        by_name, _ = trace_device_ops(torch, solve)
        traced_trips = trips["n"]
    finally:
        pose_graph.assemble_normal_equations = assemble
    n_ops = sum(c for c, _ in by_name.values())
    busy_ms = sum(us for _, us in by_name.values()) / 1e3
    moved = max(float(np.linalg.norm(dT[:3, 3])) for dT in increments.values())
    n_edges = len(problem.odometry_constraints) + len(problem.loop_closure_constraints)
    phase("pose graph solve", nodes=len(node_poses), edges=n_edges,
          uncertain_edges=len(problem.loop_closure_constraints),
          max_iterations=solve_kwargs["max_iterations"], trips=n_trips,
          dispatch_ms=f"{dispatch_ms:.1f}", dispatch_ms_per_trip=f"{dispatch_ms / n_trips:.2f}",
          wait_for_result_ms=f"{wait_ms:.1f}", traced_trips=traced_trips, device_ops=n_ops,
          device_ops_per_trip=f"{n_ops / traced_trips:.0f}", device_busy_ms=f"{busy_ms:.2f}",
          largest_increment_m=f"{moved:.4f}")
    if not all(np.isfinite(dT).all() for dT in increments.values()):
        fail("pose graph solve: an increment is not finite")


# -- the command-line path at the package defaults ------------------------------

# One lap of a 12 m circle in 100 scans, 0.754 m apart (10 Hz at 27 km/h), the
# sensor 1.73 m above the ground (KITTI's HDL-64E).  The odometry rejects a
# scan-to-scan step longer than 0.8 m as a jump (the reference's constant,
# odometry.py), so KITTI's 1 m steps at 36 km/h would all be rejected.
# The lap is written at a reduced width, KITTI_POINTS points a scan within
# KITTI_RANGE, so that every scan's 0.1 m voxels fit the defaults' 16384
# lanes.  An HDL-64E scan holds ~120000 points (~96000 voxels); where the
# voxels overflow, the scan path keeps the first 16384 in Morton order, as
# the JAX package does: one corner of the scan.  The lap's first
# KITTI_FULL_SCANS scans are also written at that width (KITTI_FULL_POINTS),
# and ``cli kitti full width`` reports what the defaults make of them.
KITTI_LAP = 100
KITTI_RADIUS = 12.0
KITTI_POINTS = 16384
KITTI_FULL_POINTS = 120000
KITTI_FULL_SCANS = 20
KITTI_RANGE = 30.0
KITTI_DIR = OUT / "kitti_synthetic"
KITTI_FULL_DIR = OUT / "kitti_synthetic_full"
# The velodyne -> camera-0 calibration of KITTI odometry sequence 00 (calib.txt "Tr").
KITTI_TR = np.array([[4.276802e-04, -9.999672e-01, -8.084491e-03, -1.198459e-02],
                     [-7.210626e-03, 8.081198e-03, -9.999413e-01, -5.403984e-02],
                     [9.999738e-01, 4.859485e-04, -7.206933e-03, -2.921968e-01],
                     [0.0, 0.0, 0.0, 1.0]])
LOCALIZATION_SCANS = 10
LOCALIZATION_VOXEL = 0.2


def kitti_world(dev):
    """A seeded world around the lap, dense enough that every scan of it
    holds about KITTI_POINTS points within KITTI_RANGE: a 100 m ground plane
    and 220 boxes, cylinders and spheres standing on it, none within 3 m of
    the lap."""
    from open3d_slam_advanced_rss_2024_public_tpu_torch.ops import generators
    from open3d_slam_advanced_rss_2024_public_tpu_torch.utils.pointcloud import make_cloud

    rng = np.random.default_rng(40)
    half = 50.0
    parts = [generators.uniform_plane(rng, 320000, half_extents=(half, half))]
    while len(parts) < 221:
        x, y = rng.uniform(-half + 2.0, half - 2.0, 2)
        if abs(np.hypot(x, y) - KITTI_RADIUS) < 3.0:
            continue
        kind, size = int(rng.integers(0, 3)), float(rng.uniform(0.5, 2.5))
        if kind == 0:
            p, n = generators.uniform_box(rng, 1500, half_extents=(size * 0.7, size * 0.4, size))
            c, s = np.cos(rng.uniform(0.0, np.pi)), np.sin(rng.uniform(0.0, np.pi))
            R = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]], np.float32)
            p, n, z = p @ R.T, n @ R.T, size
        elif kind == 1:
            p, n = generators.uniform_cylinder(rng, 1200, radius=size * 0.4, height=size * 2)
            z = size
        else:
            p, n = generators.uniform_sphere(rng, 1000, radius=size * 0.5)
            z = size * 0.5
        parts.append((p + np.array([x, y, z], np.float32), n))
    return make_cloud(np.concatenate([p for p, _ in parts]),
                      normals=np.concatenate([n for _, n in parts]), device=dev)


def write_kitti_dir(root, world, gt, n_points: int, gen):
    """A directory in KITTI odometry's layout: the scans at the poses ``gt``
    as ``sequences/00/velodyne/%06d.bin`` (float32 x, y, z, reflectance),
    ``sequences/00/calib.txt`` with the ``Tr:`` line and ``poses/00.txt``
    with the ground truth in the camera frame.  Returns the points a scan."""
    import shutil

    from open3d_slam_advanced_rss_2024_public_tpu_torch.frontends import synthetic

    shutil.rmtree(root, ignore_errors=True)
    velo = root / "sequences" / "00" / "velodyne"
    velo.mkdir(parents=True)
    counts = []
    for i, T in enumerate(gt):
        scan = synthetic.render_scan(world, T, gen, max_range=KITTI_RANGE,
                                     n_points=n_points, noise=0.01)
        xyz = scan.xyz[scan.mask].cpu().numpy()
        rec = np.zeros((len(xyz), 4), np.float32)
        rec[:, :3] = xyz
        rec[:, 3] = np.linalg.norm(xyz, axis=1) / KITTI_RANGE  # a stand-in reflectance
        rec.tofile(velo / f"{i:06d}.bin")
        counts.append(len(xyz))
    (root / "sequences" / "00" / "calib.txt").write_text(
        "Tr: " + " ".join(f"{v:.6e}" for v in KITTI_TR[:3].reshape(-1)) + "\n")
    (root / "poses").mkdir()
    cam = [T.astype(np.float64) @ np.linalg.inv(KITTI_TR) for T in gt]
    (root / "poses" / "00.txt").write_text(
        "\n".join(" ".join(f"{v:.9e}" for v in T[:3].reshape(-1)) for T in cam) + "\n")
    return counts


def write_kitti_sequence(torch, dev):
    """Phase ``kitti sequence``: the lap under build/ in KITTI odometry's
    layout at the reduced width (KITTI_DIR), and its first KITTI_FULL_SCANS
    scans at HDL-64E width (KITTI_FULL_DIR).  The lap closes on its first
    pose.  Returns the ground truth in the velodyne frame."""
    from open3d_slam_advanced_rss_2024_public_tpu_torch.frontends import synthetic

    t0 = time.perf_counter()
    world = kitti_world(dev)
    gt = synthetic.loop_trajectory(KITTI_LAP, radius=KITTI_RADIUS, center=(0.0, 0.0), z=1.73)
    gt.append(gt[0])
    gen = torch.Generator(device=dev).manual_seed(41)
    counts = write_kitti_dir(KITTI_DIR, world, gt, KITTI_POINTS, gen)
    full = write_kitti_dir(KITTI_FULL_DIR, world, gt[:KITTI_FULL_SCANS], KITTI_FULL_POINTS, gen)
    phase("kitti sequence", scans=len(gt), world_points=int(world.mask.sum()),
          points_per_scan=span(counts), full_width_scans=len(full),
          full_width_points_per_scan=span(full), seconds=f"{time.perf_counter() - t0:.1f}")
    if min(counts) < KITTI_POINTS or min(full) < KITTI_FULL_POINTS:
        fail(f"kitti sequence: a scan holds only {min(counts)} and {min(full)} points within "
             f"{KITTI_RANGE} m")
    return gt


class _Counting:
    """Counts K1 and K2 launches and host time inside the odometry's and
    the Mapper's entry points, apart (outermost calls only: the Mapper's
    entry points call each other), and keeps the odometry's pose after each scan and the
    ``SlamWrapper`` of each replay.  Every stage of the offline stepper runs
    on the caller's thread, so the differences are exact."""

    def __init__(self):
        from open3d_slam_advanced_rss_2024_public_tpu_torch.frontends import replay
        from open3d_slam_advanced_rss_2024_public_tpu_torch.models.mapper import Mapper
        from open3d_slam_advanced_rss_2024_public_tpu_torch.models.odometry import LidarOdometry
        from open3d_slam_advanced_rss_2024_public_tpu_torch.ops import cuda_moments, cuda_nn

        self.counts = {k: 0 for k in ("odometry_nn", "odometry_moments", "mapper_nn",
                                      "mapper_moments")}
        self.host_ms = {"odometry": 0.0, "mapper": 0.0}
        self.odom_poses, self.slams, self._depth = [], [], {"odometry": 0, "mapper": 0}
        self._real = [(LidarOdometry, "add_range_scan"), (Mapper, "add_range_measurement"),
                      (Mapper, "flush"), (replay.ReplayRunner, "run")]
        self._saved = [getattr(cls, name) for cls, name in self._real]
        counting = self

        def counted(fn, who):
            def inner(obj, *args, **kwargs):
                counting._depth[who] += 1
                nn0, m0 = cuda_nn.launches, cuda_moments.launches
                t0 = time.perf_counter()
                try:
                    return fn(obj, *args, **kwargs)
                finally:
                    counting._depth[who] -= 1
                    if counting._depth[who] == 0:
                        counting.host_ms[who] += (time.perf_counter() - t0) * 1e3
                        counting.counts[who + "_nn"] += cuda_nn.launches - nn0
                        counting.counts[who + "_moments"] += cuda_moments.launches - m0
                        if who == "odometry":
                            counting.odom_poses.append(obj.odom_to_range_sensor.copy())
            return inner

        def run(runner, *args, **kwargs):
            counting.slams.append(runner.slam)
            return self._saved[3](runner, *args, **kwargs)

        LidarOdometry.add_range_scan = counted(self._saved[0], "odometry")
        Mapper.add_range_measurement = counted(self._saved[1], "mapper")
        Mapper.flush = counted(self._saved[2], "mapper")
        replay.ReplayRunner.run = run

    def restore(self):
        for (cls, name), fn in zip(self._real, self._saved):
            setattr(cls, name, fn)


def run_cli(argv):
    """``cli.main(argv)`` in this process: (exit code, its standard output
    lines, its standard error)."""
    import contextlib
    import io as text_io

    from open3d_slam_advanced_rss_2024_public_tpu_torch.frontends import cli

    out, err = text_io.StringIO(), text_io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    return rc, out.getvalue().splitlines(), err.getvalue()


def cli_kitti(torch, dev, gt):
    """Phase ``cli kitti``, this slice's path: the command-line entry point
    on the KITTI-layout lap (reduced width) with no parameter file, so that every
    parameter is the package default (scan-to-scan GICP odometry, the Mapper
    with K1 and K2, submaps, features, loop closure, the pose graph).  The
    launch counts are set to 0 just before the run and read just after.
    Returns (the SlamWrapper, the launches of the run, the counts apart)."""
    from open3d_slam_advanced_rss_2024_public_tpu_torch import native
    from open3d_slam_advanced_rss_2024_public_tpu_torch.ops import (cuda_moments, cuda_nn,
                                                                    cuda_tiles)
    from open3d_slam_advanced_rss_2024_public_tpu_torch.utils import io, timing

    out = OUT / "cli_kitti"
    counting = _Counting()
    timing.reset()
    timing.enable()
    cuda_nn.reset_launches()
    cuda_moments.reset_launches()
    cuda_tiles.reset_launches()
    t0 = time.perf_counter()
    try:
        rc, lines, _ = run_cli(["--dataset", "kitti", "--kitti-root", str(KITTI_DIR),
                                "--sequence", "00", "--output", str(out), "--eval-ate"])
        torch.cuda.synchronize()
    finally:
        counting.restore()
        timing.disable()
    wall = time.perf_counter() - t0
    launches = {"nn": cuda_nn.launches, "moments": cuda_moments.launches,
                "tile_prepare": cuda_tiles.prepare_launches,
                "tile_plan": cuda_tiles.plan_launches}
    slam, counts = counting.slams[0], counting.counts
    n = len(gt)
    result = json.loads(lines[-1]) if lines else {}
    est = np.stack(slam.trajectory_poses)
    ate = io.ate_rmse(est, np.stack(gt[:len(est)]))
    odom = np.stack(counting.odom_poses)
    ate_odom = io.ate_rmse(odom, np.stack(gt[:len(odom)]))
    poses = np.loadtxt(out / "slam_poses", ndmin=2)
    map_points = int(io.load_pcd(str(out / "map.pcd"), device=dev).mask.sum())
    graph = json.loads((out / "pose_graph.json").read_text())
    odo = slam.odometry
    phase("cli kitti", scans=n, trajectory_entries=len(est), ms_per_scan=f"{wall / n * 1e3:.3f}",
          odometry_ms=f"{counting.host_ms['odometry']:.1f}",
          mapper_ms=f"{counting.host_ms['mapper']:.1f}",
          **loop_closure_stage_ms(timing),
          submaps=len(slam.mapper.submaps.submaps), closures=slam.loop_closure_count,
          ate_rmse_m=result.get("ate_rmse_m"), ate_slam_m=f"{ate:.4f}",
          ate_odometry_m=f"{ate_odom:.4f}", minimizer=odo.icp_cfg.minimizer,
          matcher=odo.icp_cfg.matcher, rejected_jumps=odo.rejected_jumps,
          low_fitness=odo.low_fitness, nn_launches=launches["nn"],
          nn_launches_odometry=counts["odometry_nn"], nn_launches_mapper=counts["mapper_nn"],
          moments_launches=launches["moments"],
          moments_launches_odometry=counts["odometry_moments"],
          moments_launches_mapper=counts["mapper_moments"],
          map_points=map_points, graph_edges=len(graph["odometry_constraints"]),
          graph_closures=len(graph["loop_closure_constraints"]),
          native_reader=native.backend())
    if rc != 0 or result.get("frames") != n:
        fail(f"cli kitti: exit code {rc}, result line {lines[-1:] }")
    if len(est) != n or poses.shape[0] != n or not np.isfinite(est).all():
        fail(f"cli kitti: {len(est)} trajectory entries and {poses.shape[0]} logged poses "
             f"for {n} scans")
    if odo.icp_cfg.minimizer != "gicp" or odo.rejected_jumps or odo.low_fitness:
        fail(f"cli kitti: odometry {odo.icp_cfg.minimizer}, {odo.rejected_jumps} rejected "
             f"jumps, {odo.low_fitness} low-fitness scans")
    if min(counts["odometry_nn"], counts["mapper_nn"]) <= 0 or min(launches.values()) <= 0:
        fail(f"cli kitti: launches {launches}, apart {counts}")
    if abs(result["ate_rmse_m"] - round(ate, 4)) > 1e-9:
        fail(f"cli kitti: the CLI reports an ATE of {result['ate_rmse_m']}, its poses {ate:.4f}")
    if not (ate < 0.2 and ate <= ate_odom):
        fail(f"cli kitti: ATE {ate:.4f} m against the odometry's {ate_odom:.4f} m (bar 0.2 m)")
    if map_points <= 10000:
        fail(f"cli kitti: map.pcd reloads with {map_points} points")
    return slam, launches, counts


def cli_default_shapes(torch, dev, slam, counts, gt):
    """K1 and K2 at the shapes of the package defaults against their plain
    versions (``K1 nn odometry defaults``: two consecutive preprocessed
    scans of the lap, 16384 x 16384 at 1.0 m; ``K1 nn mapper defaults``: a
    scan against the final submap's default 65536-point patch at 1.0 m;
    ``K2 moments odometry``: one scan, [1, 16384] at 0.5 m); one default GICP
    registration on the card and on the CPU (``gicp register``); the hashed
    grid against K1 on the mapper's patch and a short Mapper run on it
    (``hashgrid matcher``); one carve of the full-width submap with a
    full-width scan, card against CPU (``carve``).  Returns the new rows of
    the kernels line."""
    import dataclasses

    from open3d_slam_advanced_rss_2024_public_tpu_torch.frontends import kitti
    from open3d_slam_advanced_rss_2024_public_tpu_torch.models import scan_processing
    from open3d_slam_advanced_rss_2024_public_tpu_torch.ops import cuda_nn, hashgrid, voxel_map
    from open3d_slam_advanced_rss_2024_public_tpu_torch.ops.registration import icp
    from open3d_slam_advanced_rss_2024_public_tpu_torch.utils.device import HostCopy

    rows = []
    odo = slam.odometry
    cfg = odo.icp_cfg
    k = len(gt) // 2
    raw = [kitti.read_velodyne_bin(str(KITTI_DIR / "sequences" / "00" / "velodyne"
                                       / f"{i:06d}.bin"), capacity=131072, device=dev)
           for i in (k - 1, k)]
    prev, cur = (odo._preprocess(r) for r in raw)
    rows.append(nn_shape_row(torch, "odometry defaults", cur.xyz.contiguous(),
                             prev.xyz.contiguous(), cfg.max_correspondence_dist,
                             counts["odometry_nn"]))
    sp = slam.params.odometry.scan_processing
    blk = scan_processing.preprocess_scan(
        raw[1], sp.scan_cropping.cropping_radius_min, sp.scan_cropping.cropping_radius_max,
        sp.voxel_size, 1.0, sp.point_capacity, estimate_scan_normals=False)
    rows.append(moments_shape_row(torch, "odometry", blk.map(lambda t: t[None]),
                                  counts["odometry_moments"]))

    # -- the mapper's patch at the defaults: the final submap around the last
    # pose, and the last scan placed there.
    pcfg = slam.mapper.pipe_cfg
    pose = torch.as_tensor(slam.trajectory_poses[-1], device=dev)
    submap = slam.mapper.submaps.active_submap.map
    crop = dict(min_radius=0.0, max_radius=pcfg.crop_max_radius + pcfg.block_ref_margin,
                match_dist=pcfg.icp.max_correspondence_dist, capacity=pcfg.map_patch_capacity)
    _, flat = scan_processing.crop_submap_and_index(submap.cloud, pose[:3, 3],
                                                    build_hash=False, **crop)
    _, hashed = scan_processing.crop_submap_and_index(submap.cloud, pose[:3, 3], **crop)
    last = odo._preprocess(kitti.read_velodyne_bin(
        str(KITTI_DIR / "sequences" / "00" / "velodyne" / f"{len(gt) - 1:06d}.bin"),
        capacity=131072, device=dev))
    q = last.transform(pose).xyz.contiguous()
    r = flat.points.contiguous()
    rows.append(nn_shape_row(torch, "mapper defaults", q, r, pcfg.icp.max_correspondence_dist,
                             counts["mapper_nn"]))

    # -- the hashed grid against K1 on that patch -----------------------------
    # ``query_nn`` is exact where none of the 27 probed buckets holds more
    # than ``max_per_bucket`` points.  With the budget raised to the fullest
    # probed bucket it must give K1's answer on every query; at the default
    # budget it must give on the card what it gives on the CPU.
    max_dist, budget = pcfg.icp.max_correspondence_dist, pcfg.icp.max_per_bucket
    q_valid = q[:, 0].abs() < 1e7
    ki, kd2 = cuda_nn.nn(q, r, max_dist)
    kfound = q_valid & (kd2 <= max_dist ** 2)
    probed = hashgrid.hash_key(hashgrid.voxel_key(q, hashed.cell)[:, None, :]
                               + hashgrid._offsets27(dev)[None], hashed.table_size)
    fullest = int(hashed.count[probed][q_valid].max())
    hi, hd2, hfound = hashgrid.query_nn(hashed, q, q_valid, max_dist, max_per_bucket=fullest)
    both = kfound & hfound
    same_point = (r[ki] == hashed.points[hi]).all(-1)
    # K1 forms d2 from coordinates de-meaned at the reference's centroid,
    # the hashed grid from the coordinates as they are: 30 m coordinates
    # round at 2e-6 m, which moves d2 <= 1 m^2 by up to ~1e-5 m^2.  Another
    # point than K1's is a tie within that rounding.
    tol = 2e-5
    d2_err = float((kd2 - hd2)[both].abs().max()) if bool(both.any()) else 0.0
    agree = float((kfound == hfound)[q_valid].float().mean())
    # The default budget, card against CPU, every query.
    bi, bd2, bfound = hashgrid.query_nn(hashed, q, q_valid, max_dist, max_per_bucket=budget)
    host_grid = dataclasses.replace(hashed, **{f.name: getattr(hashed, f.name).cpu()
                                               for f in dataclasses.fields(hashed)
                                               if getattr(hashed, f.name) is not None})
    ci, cd2, cfound = hashgrid.query_nn(host_grid, q.cpu(), q_valid.cpu(), max_dist,
                                        max_per_bucket=budget)
    bi, bd2, bfound = bi.cpu(), bd2.cpu(), bfound.cpu()
    budget_index_differ = int((bfound & (bi != ci)).sum())
    budget_d2_err = float((bd2 - cd2)[bfound | cfound].abs().max())
    budget_found_differ = int((bfound != cfound).sum())
    exact = (hashed.count[probed] <= budget).all(-1).cpu() & bfound
    budget_farther = float((bfound & ~exact & (bd2 > hd2.cpu() + tol)).float().sum()
                           / max(int(bfound.sum()), 1))
    ref = cuda_nn.prepare_ref(r)
    k1_ms = cuda_ms(lambda: cuda_nn.nn(q, ref, max_dist), reps=50)
    hash_ms = cuda_ms(lambda: hashgrid.query_nn(hashed, q, q_valid, max_dist,
                                                max_per_bucket=budget), reps=20)
    full_ms = cuda_ms(lambda: hashgrid.query_nn(hashed, q, q_valid, max_dist,
                                                max_per_bucket=fullest), reps=5)
    build_ms = cuda_ms(lambda: scan_processing.crop_submap_and_index(submap.cloud, pose[:3, 3],
                                                                     **crop), reps=10)
    mapper_ms, mapper_err = hashgrid_mapper_run(torch, dev, slam, gt)
    phase("hashgrid matcher", shape=f"{q.shape[0]}x{r.shape[0]}",
          valid=f"{int(q_valid.sum())}x{int((r[:, 0].abs() < 1e7).sum())}",
          fullest_probed_bucket=fullest, found_k1=int(kfound.sum()),
          found_hashgrid=int(hfound.sum()), found_agree_share=f"{agree:.6f}",
          same_point_share=f"{float(same_point[both].float().mean()):.6f}",
          max_abs_err_d2=f"{d2_err:.3e}", budget=budget,
          budget_within=int(exact.sum()), budget_farther_share=f"{budget_farther:.6f}",
          budget_card_vs_cpu_index_differ=budget_index_differ,
          budget_card_vs_cpu_found_differ=budget_found_differ,
          budget_card_vs_cpu_d2_err=f"{budget_d2_err:.3e}",
          k1_wrapper_ms=f"{k1_ms:.4f}", query_nn_ms=f"{hash_ms:.4f}",
          query_nn_full_budget_ms=f"{full_ms:.4f}", crop_and_build_ms=f"{build_ms:.4f}",
          mapper_ms_per_scan=f"{mapper_ms:.3f}", mapper_max_pose_err_m=f"{mapper_err:.4f}")
    if bool((both & ~same_point & ((kd2 - hd2).abs() > tol)).any()) or d2_err > tol:
        fail(f"hashgrid matcher: with a budget of {fullest}, {int((both & ~same_point).sum())} "
             f"queries found another point than K1's, d2 apart by up to {d2_err:.3e}")
    if not agree >= 0.999:
        fail(f"hashgrid matcher: found sets agree on {agree:.6f} of the valid queries")
    if budget_index_differ or budget_found_differ or budget_d2_err > 1e-6:
        fail(f"hashgrid matcher: at a budget of {budget}, card and CPU differ on "
             f"{budget_index_differ} indices and {budget_found_differ} found flags, d2 by up "
             f"to {budget_d2_err:.3e}")
    if not mapper_err < 0.1:
        fail(f"hashgrid matcher: the Mapper on the hashed grid ends {mapper_err:.3f} m off")

    # -- one default GICP registration, card against CPU ----------------------
    gicp_register(torch, cfg, prev, cur)

    # -- one carve of the full-width submap with a KITTI-width scan ------------
    # The lap closes on its first pose, where the full-width scan 0 was taken.
    mb = slam.params.mapper.map_builder
    sc = mb.space_carving
    scan_map = kitti.read_velodyne_bin(str(KITTI_FULL_DIR / "sequences" / "00" / "velodyne"
                                           / "000000.bin"), device=dev).transform(pose)
    kw = dict(carve_voxel_size=sc.voxel_size, truncation_distance=sc.truncation_distance,
              max_ray_length=sc.max_raytracing_length)
    host = submap.to("cpu")
    t0 = time.perf_counter()
    on_card = voxel_map.carve(submap, scan_map, pose[:3, 3], **kw)
    torch.cuda.synchronize()
    card_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    on_cpu = voxel_map.carve(host, scan_map.to("cpu"), pose[:3, 3].cpu(), **kw)
    cpu_ms = (time.perf_counter() - t0) * 1e3

    def tombstones(vm):
        return set(HostCopy([torch.nonzero(vm.occupied & (vm.weight == 0.0))[:, 0]])
                   .wait()[0].tolist())
    before, card, cpu = tombstones(submap), tombstones(on_card), tombstones(on_cpu)
    phase("carve", submap_capacity=submap.capacity, occupied=int(submap.occupied.sum()),
          scan_points=int(scan_map.mask.sum()), tombstoned_before=len(before),
          carved_card=len(card - before), carved_cpu=len(cpu - before),
          differ=len(card ^ cpu), card_ms=f"{card_ms:.1f}", cpu_ms=f"{cpu_ms:.1f}")
    if card != cpu or not card - before:
        fail(f"carve: card and CPU tombstone {len(card - before)} and {len(cpu - before)} "
             f"voxels, {len(card ^ cpu)} apart")
    return rows


def cli_kitti_full_width(torch, dev, gt):
    """Phase ``cli kitti full width``: the command line at the package
    defaults on the lap's first KITTI_FULL_SCANS scans at HDL-64E width,
    where every scan holds more 0.1 m voxels than the defaults' 16384 lanes
    and the scan path keeps the first of them in Morton order, as the JAX
    package does.  A reading of that limit (``PERF.md`` §7), held to no
    accuracy bar: the run must write a finite pose for every scan."""
    from open3d_slam_advanced_rss_2024_public_tpu_torch.frontends import kitti
    from open3d_slam_advanced_rss_2024_public_tpu_torch.ops import filters
    from open3d_slam_advanced_rss_2024_public_tpu_torch.utils import io
    from open3d_slam_advanced_rss_2024_public_tpu_torch.utils.config import load_parameters

    sp = load_parameters(None).odometry.scan_processing
    first = kitti.read_velodyne_bin(str(KITTI_FULL_DIR / "sequences" / "00" / "velodyne"
                                        / "000000.bin"), device=dev)
    voxels = int(filters.voxel_downsample(first, sp.voxel_size, first.capacity).mask.sum())
    counting = _Counting()
    t0 = time.perf_counter()
    try:
        rc, lines, _ = run_cli(["--dataset", "kitti", "--kitti-root", str(KITTI_FULL_DIR),
                                "--output", str(OUT / "cli_kitti_full"), "--eval-ate"])
        torch.cuda.synchronize()
    finally:
        counting.restore()
    wall = time.perf_counter() - t0
    n, slam = KITTI_FULL_SCANS, counting.slams[0]
    est, odom = np.stack(slam.trajectory_poses), np.stack(counting.odom_poses)
    result = json.loads(lines[-1]) if lines else {}
    phase("cli kitti full width", scans=n, voxels_first_scan=voxels, lanes=sp.point_capacity,
          ms_per_scan=f"{wall / n * 1e3:.3f}", ate_rmse_m=result.get("ate_rmse_m"),
          ate_odometry_m=f"{io.ate_rmse(odom, np.stack(gt[:len(odom)])):.4f}",
          rejected_jumps=slam.odometry.rejected_jumps, low_fitness=slam.odometry.low_fitness)
    if rc != 0 or result.get("frames") != n or len(est) != n or not np.isfinite(est).all():
        fail(f"cli kitti full width: exit code {rc}, {len(est)} poses for {n} scans, "
             f"result line {lines[-1:]}")


def gicp_register(torch, cfg, prev, cur):
    """Phase ``gicp register``: one registration of two consecutive scans at
    the odometry's default configuration (GICP, K1, polled), on the card
    under torch's sync debug mode and on the CPU from the same clouds; the
    host time of the call, the trips it dispatched and, from a traced
    repeat, the device operations a trip."""
    from open3d_slam_advanced_rss_2024_public_tpu_torch.ops import hashgrid
    from open3d_slam_advanced_rss_2024_public_tpu_torch.ops.registration import icp
    from open3d_slam_advanced_rss_2024_public_tpu_torch.utils.device import HostCopy

    trips = {"n": 0}
    step = icp.iteration_step

    def counting(*args, **kwargs):
        trips["n"] += 1
        return step(*args, **kwargs)

    def register(a, b):
        grid = hashgrid.passthrough(b, cfg.max_correspondence_dist)
        eye = torch.eye(4, dtype=torch.float32, device=a.xyz.device)
        return icp.register(a, grid, eye, cfg, icp.prepare_reference(cfg, grid),
                            poll_every=icp.POLL_EVERY)

    icp.iteration_step = counting
    try:
        register(cur, prev)  # warm-up
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            trips["n"] = 0
            t0 = time.perf_counter()
            res = register(cur, prev)
            dispatch_ms = (time.perf_counter() - t0) * 1e3
            torch.cuda.set_sync_debug_mode("default")
        T, it = HostCopy([res.transform, res.iterations]).wait()
        wait_ms = (time.perf_counter() - t0) * 1e3 - dispatch_ms
        n_trips = trips["n"]
        by_name, _ = trace_device_ops(torch, lambda: HostCopy([register(cur, prev).transform])
                                      .wait())
        traced = trips["n"] - n_trips
        t0 = time.perf_counter()
        host = register(cur.to("cpu"), prev.to("cpu"))
        cpu_ms = (time.perf_counter() - t0) * 1e3
    finally:
        icp.iteration_step = step
    syncs = [w for w in caught if "called a synchronizing CUDA operation" in str(w.message)]
    d_t, d_r = transform_difference(np.array(T), host.transform.numpy())
    n_ops = sum(c for c, _ in by_name.values())
    busy_ms = sum(us for _, us in by_name.values()) / 1e3
    phase("gicp register", shape=f"{cur.capacity}x{prev.capacity}",
          valid=f"{int(cur.mask.sum())}x{int(prev.mask.sum())}", iterations=int(it),
          iterations_cpu=int(host.iterations), trips_dispatched=n_trips,
          host_syncs=len(syncs), dispatch_ms=f"{dispatch_ms:.2f}",
          dispatch_ms_per_trip=f"{dispatch_ms / n_trips:.3f}", wait_ms=f"{wait_ms:.2f}",
          device_ops_per_trip=f"{n_ops / max(traced, 1):.0f}",
          device_busy_ms_per_trip=f"{busy_ms / max(traced, 1):.4f}", cpu_ms=f"{cpu_ms:.1f}",
          diff_mm=f"{d_t * 1e3:.4f}", diff_mrad=f"{d_r * 1e3:.4f}")
    if syncs:
        fail("gicp register synchronised with the device at "
             + ", ".join(sorted({f"{w.filename}:{w.lineno}" for w in syncs})))
    if not (d_t <= 1e-3 and d_r <= 1e-3 and int(it) == int(host.iterations)):
        fail(f"gicp register: card and CPU differ by {d_t * 1e3:.3f} mm, {d_r * 1e3:.3f} mrad, "
             f"{int(it)} and {int(host.iterations)} iterations")


def hashgrid_mapper_run(torch, dev, slam, gt, n: int = 16):
    """A short Mapper run at the package defaults but ``matcher="hashgrid"``,
    on the KITTI-layout scans with the ground truth as odometry: (ms a scan,
    largest pose error)."""
    from open3d_slam_advanced_rss_2024_public_tpu_torch.frontends import kitti
    from open3d_slam_advanced_rss_2024_public_tpu_torch.models.mapper import Mapper
    from open3d_slam_advanced_rss_2024_public_tpu_torch.utils.config import load_parameters

    params = load_parameters({"mapper": {"mapper_localizer": {
        "is_print_timing_information": False,
        "scan_to_map_registration": {"matcher": "hashgrid"}}}})
    frames = list(kitti.kitti_sequence(str(KITTI_DIR), max_frames=n, device=dev))
    mapper = Mapper(params, device=dev)
    if mapper.pipe_cfg.icp.matcher != "hashgrid":
        fail(f"hashgrid matcher: the Mapper resolved {mapper.pipe_cfg.icp.matcher}")
    t0 = time.perf_counter()
    poses = run_loop(mapper, [f.scan for f in frames], gt[:n])
    torch.cuda.synchronize()
    err = max(float(np.linalg.norm(p[:3, 3] - gt[i][:3, 3])) for i, p in enumerate(poses))
    return (time.perf_counter() - t0) / n * 1e3, err


LOCALIZATION_BASE_LUA = """-- Base parameters in the reference's Lua schema.
function deepcopy(orig, copies)
    copies = copies or {}
    if type(orig) == 'table' then
        for k, v in next, orig, nil do end
    end
    return copy
end

DEFAULT_PARAMETERS = {
    odometry = { scan_matching = { cloud_registration_type = "GeneralizedIcp" } },
    map_builder = { map_voxel_size = 0.1, space_carving = { voxel_size = 0.2 } },
    mapper_localizer = { is_attempt_loop_closures = true, map_merge_delay_in_seconds = 10.0 },
    map_initializer = { init_pose = { x = 0.0, y = 0.0, z = 0.0 } },
}
"""

LOCALIZATION_LUA = """-- Localization against a prior map, with space carving.
include "base.lua"
params = deepcopy(DEFAULT_PARAMETERS)
params.map_builder.is_carving_enabled = true
params.map_builder.space_carving.carve_space_every_n_scans = 2.0
params.mapper_localizer.is_carving_enabled = true
params.mapper_localizer.is_merge_scans_into_map = true
params.mapper_localizer.map_merge_delay_in_seconds = 0.3
params.map_initializer.init_pose = { x = 0.0, y = 0.0, z = 0.0, roll = 0.0, pitch = 0.0, yaw = 0.0 }
return params
"""


def cli_localization(torch, dev, gt):
    """Phase ``cli localization``: a Lua parameter file in the reference's
    schema (an ``include`` of a base file, dotted assignments, carving on,
    an ``init_pose`` block) and the map of ``cli kitti`` as the prior map;
    the command line runs the first LOCALIZATION_SCANS scans of the lap.
    map.pcd holds the voxel means of every submap, more points than the
    command line takes as a prior map (``cli.MAX_INITIAL_MAP_POINTS``, the
    JAX package's bound; the map initializer's brute-force kNN normals grow
    with the square of the map): the phase checks that the command line
    refuses it with a message, and thins it to one point per
    LOCALIZATION_VOXEL voxel.  Localization merges no scan into the prior
    map unless asked to, and carving runs where a scan is merged, so the
    file asks for merging after 0.3 s."""
    import dataclasses

    from open3d_slam_advanced_rss_2024_public_tpu_torch.frontends import cli
    from open3d_slam_advanced_rss_2024_public_tpu_torch.ops import filters, voxel_map
    from open3d_slam_advanced_rss_2024_public_tpu_torch.utils import io
    from open3d_slam_advanced_rss_2024_public_tpu_torch.utils.lua_config import (
        load_lua_parameters)

    d = OUT / "cli_localization"
    d.mkdir(exist_ok=True)
    saved_path = str(OUT / "cli_kitti" / "map.pcd")
    saved = io.load_pcd(saved_path, device=dev)
    refused = None
    if saved.capacity > cli.MAX_INITIAL_MAP_POINTS:
        try:
            run_cli(["--dataset", "kitti", "--kitti-root", str(KITTI_DIR), "--max-frames", "1",
                     "--initial-map", saved_path, "--output", str(d / "refused")])
        except ValueError as e:
            refused = str(e)
        if not refused or str(cli.MAX_INITIAL_MAP_POINTS) not in refused:
            fail(f"cli localization: map.pcd's {saved.capacity} points were not refused "
                 f"({refused})")
    prior = filters.voxel_downsample(saved, LOCALIZATION_VOXEL, saved.capacity, order="lex")
    n_prior = int(prior.mask.sum())
    if n_prior > cli.MAX_INITIAL_MAP_POINTS:
        fail(f"cli localization: the thinned map still holds {n_prior} points")
    io.save_pcd(str(d / "prior.pcd"), prior)  # the valid points only
    (d / "base.lua").write_text(LOCALIZATION_BASE_LUA)
    (d / "localization.lua").write_text(LOCALIZATION_LUA)
    params, warns = load_lua_parameters(str(d / "localization.lua"))
    mb = params.mapper.map_builder
    expected = {"is_carving_enabled": (mb.is_carving_enabled, True),
                "carve_space_every_n_scans": (mb.space_carving.carve_space_every_n_scans, 2.0),
                "carve voxel_size": (mb.space_carving.voxel_size, 0.2),
                "mapper_localizer.is_carving_enabled": (
                    params.mapper.mapper_localizer.is_carving_enabled, True),
                "is_merge_scans_into_map": (
                    params.mapper.mapper_localizer.is_merge_scans_into_map, True),
                "map_merge_delay_in_seconds": (
                    params.mapper.mapper_localizer.map_merge_delay_in_seconds, 0.3),
                "init_pose": (dataclasses.astuple(params.mapper.map_initializer.init_pose),
                              (0.0,) * 6),
                "cloud_registration_type": (
                    params.odometry.scan_matching.cloud_registration_type, "GeneralizedIcp")}
    wrong = {k: v for k, v in expected.items() if v[0] != v[1]}
    carves = {"n": 0}
    carve = voxel_map.carve

    def counting(*args, **kwargs):
        carves["n"] += 1
        return carve(*args, **kwargs)

    counting_run = _Counting()
    voxel_map.carve = counting
    t0 = time.perf_counter()
    try:
        rc, lines, err = run_cli(["--dataset", "kitti", "--kitti-root", str(KITTI_DIR),
                                  "--max-frames", str(LOCALIZATION_SCANS),
                                  "--params", str(d / "localization.lua"),
                                  "--initial-map", str(d / "prior.pcd"),
                                  "--output", str(d / "out"), "--eval-ate"])
        torch.cuda.synchronize()
    finally:
        voxel_map.carve = carve
        counting_run.restore()
    wall = time.perf_counter() - t0
    slam = counting_run.slams[0]
    end = slam.trajectory_poses[-1]
    truth = np.linalg.inv(gt[0]) @ gt[LOCALIZATION_SCANS - 1]
    end_err = float(np.linalg.norm(end[:3, 3] - truth[:3, 3]))
    loader_lines = [line for line in err.splitlines() if line.startswith("[params]")]
    phase("cli localization", scans=len(slam.trajectory_poses), seconds=f"{wall:.1f}",
          map_pcd_points=saved.capacity, map_pcd_refused=refused is not None,
          prior_map_points=n_prior, prior_voxel_m=LOCALIZATION_VOXEL,
          loader_warnings=len(warns) + len(loader_lines), wrong_values=len(wrong),
          carving_enabled=slam.params.mapper.map_builder.is_carving_enabled,
          carves=carves["n"], submaps=len(slam.mapper.submaps.submaps),
          end_err_m=f"{end_err:.4f}", result=lines[-1] if lines else None)
    if rc != 0 or len(slam.trajectory_poses) != LOCALIZATION_SCANS:
        fail(f"cli localization: exit code {rc}, {len(slam.trajectory_poses)} poses")
    if wrong or warns or loader_lines or not slam.params.mapper.map_builder.is_carving_enabled:
        fail(f"cli localization: the Lua file loaded with warnings {warns + loader_lines} "
             f"and these values off: {wrong}")
    if carves["n"] < 1:
        fail("cli localization: carving never ran")
    if not end_err < 0.05:
        fail(f"cli localization: the last pose is {end_err:.3f} m from the ground truth")


# -- the libpointmatcher ICP chain (icp.yaml) -------------------------------

# The chain of the reference's icp.yaml (ros/open3d_slam_ros/param/icp.yaml),
# as tests/test_chain.py's PRODUCTION_CHAIN, with the NullLogger.
PRODUCTION_CHAIN = {
    "readingDataPointsFilters": [{"RandomSamplingDataPointsFilter": {"prob": 0.9}}],
    "referenceDataPointsFilters": [{"SurfaceNormalDataPointsFilter": {"knn": 10,
                                                                      "radius": 0.8}}],
    "matcher": {"KDTreeMatcher": {"knn": 1, "maxDist": 0.5}},
    "outlierFilters": [{"TrimmedDistOutlierFilter": {"ratio": 0.90}},
                       {"SurfaceNormalOutlierFilter": {"maxAngle": 1.57}}],
    "errorMinimizer": "PointToPlaneErrorMinimizer",
    "transformationCheckers": [
        {"CounterTransformationChecker": {"maxIterationCount": 15}},
        {"DifferentialTransformationChecker": {"minDiffRotErr": 0.001, "minDiffTransErr": 0.01,
                                               "smoothLength": 3}}],
    "inspector": "NullInspector",
    "logger": "NullLogger",
}
CHAIN_GUESS_M = 0.1        # the guess: the true motion perturbed by 0.1 m ...
CHAIN_GUESS_DEG = 0.5      # ... and 0.5 degrees, in seeded random directions
CHAIN_BAR_M = 0.05
CHAIN_BAR_DEG = 0.5
CHAIN_INF_PAIRS = 5        # pairs registered at maxDist inf (KDTreeMatcher's default)
CHAIN_MAP_RADIUS = 25.0    # the sequence's map patch around scan 10 ...
CHAIN_MAP_VOXEL = 0.25     # ... voxelised to fit the package's map_patch_capacity
CHAIN_MAP_CAPACITY = 65536
CHAIN_FILTER_POINTS = 8192
CHAIN_TWIN_POINTS = 16384
BINNING_SHARE = 1e-3       # lanes a direction-binning filter may move, card vs CPU

CHAIN_FILTERS = [
    ("IdentityDataPointsFilter", {}),
    ("RemoveNaNDataPointsFilter", {}),
    ("MaxDistDataPointsFilter", {"maxDist": 20.0}),
    ("MinDistDataPointsFilter", {"minDist": 3.0}),
    ("DistanceLimitDataPointsFilter", {"dim": 1, "dist": 10.0, "removeInside": 1}),
    ("BoundingBoxDataPointsFilter", {"xMin": -15.0, "xMax": 15.0, "yMin": -15.0,
                                     "yMax": 15.0, "zMin": -3.0, "zMax": 3.0}),
    ("MaxQuantileOnAxisDataPointsFilter", {"ratio": 0.5, "dim": 0}),
    ("MaxDensityDataPointsFilter", {"maxDensity": 100.0}),
    ("SurfaceNormalDataPointsFilter", {"knn": 10, "radius": 0.8}),
    ("SamplingSurfaceNormalDataPointsFilter", {"ratio": 0.5, "knn": 7}),
    ("OrientNormalsDataPointsFilter", {"towardCenter": 1}),
    ("ObservationDirectionDataPointsFilter", {}),
    ("IncidenceAngleDataPointsFilter", {}),
    ("RandomSamplingDataPointsFilter", {"prob": 0.9}),
    ("MaxPointCountDataPointsFilter", {"maxCount": 50000}),
    ("FixStepSamplingDataPointsFilter", {"startStep": 3}),
    ("ShadowDataPointsFilter", {"eps": 0.1}),
    ("SimpleSensorNoiseDataPointsFilter", {"sensorType": 1}),
    ("VoxelGridDataPointsFilter", {"vSizeX": 0.2}),
    ("NormalSpaceDataPointsFilter", {"nbSample": 20000}),
    ("CovarianceSamplingDataPointsFilter", {"nbSample": 20000}),
    ("OctreeGridDataPointsFilter", {"maxSizeByNode": 0.3}),
    ("HiddenPointRemovalDataPointsFilter", {}),
    ("CutAtDescriptorThresholdDataPointsFilter", {"descName": "ranges", "threshold": 15.0}),
    ("RemoveSensorBiasDataPointsFilter", {}),
    # The scan as a 64-row range image (HDL-64E: 64 lasers; ``range_image``).
    ("OrganizedCloudSurfaceNormalDataPointsFilter", {"rows": 64, "knn": 5, "maxDist": 1.0}),
    ("ElipsoidsDataPointsFilter", {"knn": 7, "samplingMethod": 1, "keepEigenValues": 1,
                                   "keepEigenVectors": 1, "keepShapes": 1}),
    ("GestaltDataPointsFilter", {"ratio": 0.3, "radius": 2.0, "keepMeans": 1,
                                 "keepEigenValues": 1}),
]
# Filters that bin view or normal directions (atan2/arcsin round per device),
# and gestalt, whose keypoint gates sit on its eigenvectors.
CHAIN_BINNING = ("normalspace", "hiddenpointremoval", "gestalt")


def read_kitti_scan(torch, path, dev):
    """A KITTI velodyne record file as a cloud with its reflectance as the
    ``intensity`` channel."""
    from open3d_slam_advanced_rss_2024_public_tpu_torch.utils.pointcloud import make_cloud

    data = np.fromfile(path, dtype=np.float32).reshape(-1, 4)
    return make_cloud(data[:, :3], device=dev, attrs={"intensity": data[:, 3]})


def perturbed(T: np.ndarray, rng) -> np.ndarray:
    """``T`` moved by CHAIN_GUESS_M and turned by CHAIN_GUESS_DEG about
    seeded random directions."""
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    shift = rng.normal(size=3)
    K = np.array([[0.0, -axis[2], axis[1]], [axis[2], 0.0, -axis[0]], [-axis[1], axis[0], 0.0]])
    a = np.radians(CHAIN_GUESS_DEG)
    D = np.eye(4)
    D[:3, :3] = np.eye(3) + np.sin(a) * K + (1.0 - np.cos(a)) * K @ K
    D[:3, 3] = shift * CHAIN_GUESS_M / np.linalg.norm(shift)
    return (T @ D).astype(np.float32)


def chain_accuracy(label, est, truth, guess):
    """(translation m, rotation deg) of ``est`` against ``truth``; fails
    beyond CHAIN_BAR_M / CHAIN_BAR_DEG or above the guess's error."""
    dt, dr = transform_difference(truth, est)
    gt_, gr = transform_difference(truth, guess)
    dr, gr = np.degrees(dr), np.degrees(gr)
    if not (dt < CHAIN_BAR_M and dr < CHAIN_BAR_DEG and dt < gt_ and dr < gr):
        fail(f"{label}: {dt:.4f} m and {dr:.4f} deg off the truth (guess {gt_:.4f} m, "
             f"{gr:.4f} deg; bar {CHAIN_BAR_M} m, {CHAIN_BAR_DEG} deg)")
    return dt, dr


def chain_production(torch, dev, gt):
    """Phase ``chain production``: PRODUCTION_CHAIN written to build/icp.yaml
    and loaded with the port's ``chain.from_yaml`` (matcher "auto": K1),
    then scan i registered against scan i - 1 over the lap's first
    KITTI_FULL_SCANS scans at HDL-64E width (pmicp's use of the chain), from
    the true motion perturbed by 0.1 m and 0.5 degrees; then the first
    CHAIN_INF_PAIRS pairs again at maxDist inf.  Returns (the chain, K1
    launches at 0.5 and at inf, the last pair's reading, reference and guess)."""
    import yaml

    from open3d_slam_advanced_rss_2024_public_tpu_torch.ops import cuda_nn, filters
    from open3d_slam_advanced_rss_2024_public_tpu_torch.ops.registration import chain

    path = OUT / "icp.yaml"
    path.write_text(yaml.safe_dump(PRODUCTION_CHAIN))
    c = chain.from_yaml(str(path))
    if c.config.matcher != "cuda" or c.config.max_correspondence_dist != 0.5:
        fail(f"chain production: loaded {c.config}")
    velo = KITTI_FULL_DIR / "sequences" / "00" / "velodyne"
    scans = [read_kitti_scan(torch, velo / f"{i:06d}.bin", dev) for i in range(KITTI_FULL_SCANS)]
    rng = np.random.default_rng(50)
    launches = {}
    for label, maxd, n in (("chain production", 0.5, KITTI_FULL_SCANS),
                           ("chain production maxDist inf", float("inf"), CHAIN_INF_PAIRS + 1)):
        spec = json.loads(json.dumps(PRODUCTION_CHAIN))
        spec["matcher"]["KDTreeMatcher"]["maxDist"] = maxd
        cc = c if maxd == 0.5 else chain.from_dict(spec)
        errs, ms, iters, nn_calls = [], [], [], []
        for i in range(1, n):
            truth = (np.linalg.inv(gt[i - 1]) @ gt[i]).astype(np.float32)
            guess = perturbed(truth, rng)
            torch.cuda.synchronize()
            n0, t0 = cuda_nn.launches, time.perf_counter()
            res = cc.register(scans[i], scans[i - 1], guess, seed=i)
            T = res.transform.cpu().numpy()
            ms.append((time.perf_counter() - t0) * 1e3)
            nn_calls.append(cuda_nn.launches - n0)
            iters.append(int(res.iterations))
            errs.append(chain_accuracy(f"{label} pair {i - 1}-{i}", T, truth, guess))
        launches[maxd] = sum(nn_calls)
        phase(label, pairs=n - 1, points=span([int(s.mask.sum()) for s in scans[:n]]),
              reading_after_filters=int(cc.process_reading(
                  scans[1], seed=filters.fold_in(1, 0)).mask.sum()),
              ms_per_pair=f"{np.mean(ms):.2f}", ms_first=f"{ms[0]:.2f}",
              iterations=span(iters), k1_launches=launches[maxd],
              k1_launches_per_pair=span(nn_calls),
              max_err_m=f"{max(e[0] for e in errs):.5f}",
              max_err_deg=f"{max(e[1] for e in errs):.5f}",
              guess_m=CHAIN_GUESS_M, guess_deg=CHAIN_GUESS_DEG)
    last = KITTI_FULL_SCANS - 1
    truth = (np.linalg.inv(gt[last - 1]) @ gt[last]).astype(np.float32)
    return c, launches, (last, scans[last], scans[last - 1], perturbed(truth, rng)), scans


def chain_sequence(torch, dev, c, gt, scans):
    """Phase ``chain sequence``: ``ICPSequence(chain=...)``; ``set_map`` once
    on a patch of the lap's world within CHAIN_MAP_RADIUS of scan 10,
    voxelised to fit CHAIN_MAP_CAPACITY lanes (fails on overflow), then
    ``compute`` for the KITTI_FULL_SCANS full-width scans against it, from
    the true poses perturbed as in ``chain production``."""
    from open3d_slam_advanced_rss_2024_public_tpu_torch.ops import filters
    from open3d_slam_advanced_rss_2024_public_tpu_torch.ops.registration import ICPSequence
    from open3d_slam_advanced_rss_2024_public_tpu_torch.utils.pointcloud import compact

    world = kitti_world(dev)
    center = torch.tensor(gt[10][:3, 3], dtype=torch.float32).to(dev)
    near = filters.norm3(world.xyz - center) <= CHAIN_MAP_RADIUS
    patch = filters.voxel_downsample(world.with_mask(near), CHAIN_MAP_VOXEL, world.capacity,
                                     order="lex")
    voxels = int(patch.mask.sum())
    if voxels > CHAIN_MAP_CAPACITY:
        fail(f"chain sequence: {voxels} voxels overflow {CHAIN_MAP_CAPACITY} lanes")
    patch = compact(patch, CHAIN_MAP_CAPACITY)
    seq = ICPSequence(chain=c)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    seq.set_map(patch)
    torch.cuda.synchronize()
    set_ms = (time.perf_counter() - t0) * 1e3
    rng = np.random.default_rng(51)
    errs, ms = [], []
    for i, scan in enumerate(scans):
        truth = gt[i].astype(np.float32)
        guess = perturbed(truth, rng)
        t0 = time.perf_counter()
        T = seq.compute(scan, guess, seed=i).transform.cpu().numpy()
        ms.append((time.perf_counter() - t0) * 1e3)
        errs.append(chain_accuracy(f"chain sequence scan {i}", T, truth, guess))
    phase("chain sequence", map_voxels=voxels, map_lanes=CHAIN_MAP_CAPACITY,
          voxel=CHAIN_MAP_VOXEL, scans=len(scans), set_map_ms=f"{set_ms:.2f}",
          ms_per_compute=f"{np.mean(ms):.2f}", ms_first=f"{ms[0]:.2f}",
          max_err_m=f"{max(e[0] for e in errs):.5f}",
          max_err_deg=f"{max(e[1] for e in errs):.5f}")


def range_image(torch, cloud, rows: int, cols: int):
    """The scan as an organized ``rows`` x ``cols`` range image: elevation
    rows and azimuth columns spanning the scan's extent, each pixel the
    nearest point that falls in it, empty pixels masked (the organized
    filter's input; a real sensor delivers its scan in this order)."""
    x, y, z = cloud.xyz.unbind(-1)
    rng = torch.sqrt((x * x + y * y) + z * z)
    el = torch.where(cloud.mask, torch.atan2(z, torch.sqrt(x * x + y * y)), 0.0)
    lo = torch.where(cloud.mask, el, float("inf")).amin()
    hi = torch.where(cloud.mask, el, -float("inf")).amax()
    r = torch.clamp(((el - lo) / (hi - lo) * rows).long(), 0, rows - 1)
    c = torch.clamp(((torch.atan2(y, x) + np.pi) / (2 * np.pi) * cols).long(), 0, cols - 1)
    pixel = torch.where(cloud.mask, r * cols + c, rows * cols)
    order = torch.argsort(torch.where(cloud.mask, rng, float("inf")), stable=True)
    order = order[torch.argsort(pixel[order], stable=True)]
    first = torch.ones_like(cloud.mask)
    first[1:] = pixel[order][1:] != pixel[order][:-1]
    lane = torch.full((rows * cols + 1,), -1, dtype=torch.long, device=cloud.device)
    lane[torch.where(first, pixel[order], rows * cols)] = order
    lane = lane[:rows * cols]
    return cloud.take(lane.clamp(min=0), lane >= 0)


def chain_pipeline(name, params, cloud):
    """The filter's pipeline for ``cloud`` (the organized filter: the image
    width from the cloud's lanes)."""
    from open3d_slam_advanced_rss_2024_public_tpu_torch.ops.registration import chain

    if chain._canon(name) == "organizedcloudsurfacenormal":
        params = dict(params, cols=cloud.capacity // params["rows"])
    return chain.FilterPipeline([(name, params)])


def with_normals(torch, scan, n_lanes):
    """The first ``n_lanes`` lanes of a scan (a multiple of 64), with kNN
    normals, as the filters' input."""
    from open3d_slam_advanced_rss_2024_public_tpu_torch.ops import normals

    cut = scan.map(lambda t: t[:n_lanes])
    return normals.estimate_normals(cut, radius=0.8, k=10)


def chain_filters(torch, dev, scans):
    """Phase ``chain filters``: every one of the 28 DataPointsFilters on one
    full-width scan on the card (its ms, and 0 host syncs under torch's sync
    debug mode, as the main path's warm-up is checked); then each on a
    CHAIN_FILTER_POINTS-lane scan on the card against the CPU with the same
    draws: masks equal (directional binning: BINNING_SHARE of the lanes),
    values within 1e-5 (and 1e-5 relative) on all but BINNING_SHARE of the
    lanes; eigenvectors up to sign."""
    from open3d_slam_advanced_rss_2024_public_tpu_torch.ops.registration import chain

    full = with_normals(torch, scans[0], scans[0].capacity // 64 * 64)
    small = with_normals(torch, scans[1], CHAIN_FILTER_POINTS)
    # The organized filter's inputs: the full scan as a 64-row range image,
    # and a 64 x 128 window of it.
    image = range_image(torch, full, 64, full.capacity // 64)
    cols = torch.arange(image.capacity, device=dev).reshape(64, -1)
    window = image.take(cols[:, :CHAIN_FILTER_POINTS // 64].reshape(-1))
    torch.cuda.synchronize()
    rows = []
    for name, params in CHAIN_FILTERS:
        canon = chain._canon(name)
        inp, sinp = ((image, window) if canon == "organizedcloudsurfacenormal"
                     else (full, small))
        pipe = chain_pipeline(name, params, inp)
        pipe(inp, seed=7)
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as syncs:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            t0 = time.perf_counter()
            out = pipe(inp, seed=7)
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        syncs = [w for w in syncs if "called a synchronizing CUDA operation" in str(w.message)]
        if syncs:
            fail(f"chain filters {name}: {len(syncs)} host syncs, at "
                 + ", ".join(sorted({f"{w.filename}:{w.lineno}" for w in syncs})))
        t0 = time.perf_counter()
        sp = chain_pipeline(name, params, sinp)
        a, b = sp(sinp, seed=9), sp(sinp.to("cpu"), seed=9)
        mask_diff, value_share, value_err = compare_filtered(torch, canon, params, a, b)
        rows.append(f"{canon}:{ms:.2f}")
        phase(f"chain filter {canon}", ms=f"{ms:.3f}", kept=f"{int(out.mask.sum())}/{full.capacity}",
              host_syncs=0, card_vs_cpu_s=f"{time.perf_counter() - t0:.2f}",
              card_vs_cpu_mask_diff=mask_diff,
              card_vs_cpu_share_beyond_1e5=f"{value_share:.6f}",
              card_vs_cpu_max_err=f"{value_err:.3g}")
    phase("chain filters", filters=len(CHAIN_FILTERS), full_width=full.capacity,
          small=small.capacity, ms=" ".join(rows))


def knn_planar(torch, cloud, params):
    """Lanes whose kNN neighbourhood (the filter's k and radius) is a plane,
    its smallest covariance eigenvalue below a fifth of the middle one:
    where the normal is defined beyond rounding (at near-equal eigenvalues a
    rounding difference in the matmul-ranked neighbours or the closed-form
    eigenvector turns it)."""
    from open3d_slam_advanced_rss_2024_public_tpu_torch.ops import bruteforce

    idx, _, ok = bruteforce.knn(cloud.xyz, cloud.mask, cloud.xyz,
                                float(params.get("radius", 0.5)), k=int(params["knn"]))
    w = ok.float()[..., None]
    d = (cloud.xyz[idx] - ((cloud.xyz[idx] * w).sum(1) / w.sum(1).clamp(min=1.0))[:, None]) * w
    ev = torch.linalg.eigvalsh(torch.einsum("nki,nkj->nij", d, d).double())
    return (ev[:, 0] < 0.2 * ev[:, 1]) & (ok.sum(-1) >= 5)


def compare_filtered(torch, canon, params, a, b):
    """Card output ``a`` against CPU output ``b`` of one filter: (lanes whose
    mask differs, share of the common lanes whose values differ beyond 1e-5,
    the largest difference on the rest).  Fails beyond the bars.  kNN
    normals are held where their neighbourhood is a plane, within 1e-4."""
    a = a.to("cpu")
    diff = int((a.mask != b.mask).sum())
    if diff > (BINNING_SHARE * a.capacity if canon in CHAIN_BINNING else 0):
        fail(f"chain filter {canon}: masks differ on {diff} of {a.capacity} lanes, card vs CPU")
    if a.attr_names != b.attr_names:
        fail(f"chain filter {canon}: channels {a.attr_names} on the card, {b.attr_names} on "
             "the CPU")
    both = a.mask & b.mask
    # (card, CPU, sign-free, lanes): eigenvectors (the surfel normals,
    # eigVectors*) compare up to sign where their eigenvalue stands 1% of
    # the largest apart from the others (closer, float32 rounding turns them
    # by more than 1e-5).
    apart = [both] * 3
    if "eigValues0" in a.attr_names:
        ev = torch.stack([b.attr(f"eigValues{j}") for j in range(3)], -1).double()
        scale = ev.abs().amax(-1).clamp(min=1e-30)
        apart = [both & (torch.stack([(ev[:, j] - ev[:, k]).abs() for k in range(3) if k != j])
                         .amin(0) > 1e-2 * scale) for j in range(3)]
    fields = [("xyz", a.xyz, b.xyz, False, both)]
    if canon in ("surfacenormal", "samplingsurfacenormal"):
        planar = both & knn_planar(torch, b, params)
        d = (a.normals - b.normals).abs()[planar]
        if bool((d > 1e-4).any()):
            fail(f"chain filter {canon}: normals of {int((d > 1e-4).any(-1).sum())} planar "
                 "lanes differ by more than 1e-4, card vs CPU")
    elif canon in ("elipsoids", "gestalt"):
        fields.append(("normals", a.normals, b.normals, True, apart[0]))
    elif canon == "organizedcloudsurfacenormal":
        # The closed-form eigenvalues (the JAX package's arccos of the scaled
        # determinant, kept for parity) carry ~1e-4 of the largest one
        # where two of them nearly coincide, which float32 rounding decides
        # differently on the two devices: the sqrt-eigenvalue descriptors are
        # held where the eigenvalues are resolved (e0 at least 4% of e2, the
        # gaps e1 - e0 and e2 - e1 at least 5% of it), the normals within
        # 1e-4 where the window is a plane (e0 < 0.2 e1, as the kNN
        # normals') whose middle eigenvalue is resolved (e1 at least 4% of
        # e2: a line-like window's normal is not), the densities everywhere.
        # Eigenvalues from the descriptors, in units of e2.
        lin, pla = b.attr("linearity"), b.attr("planarity")
        e1, e0 = (1.0 - lin) ** 2, (1.0 - lin - pla) ** 2
        spread = both & (e0 >= 0.04) & (e1 - e0 >= 0.05) & (1.0 - e1 >= 0.05)
        planar = both & (b.normals.abs().sum(-1) > 0) & (e0 < 0.2 * e1) & (e1 >= 0.04)
        d = (a.normals - b.normals).abs()[planar]
        if bool((d > 1e-4).any()):
            fail(f"chain filter {canon}: normals of {int((d > 1e-4).any(-1).sum())} of "
                 f"{int(planar.sum())} planar windows differ by more than 1e-4, card vs CPU")
    else:
        fields.append(("normals", a.normals, b.normals, False, both))
    for k, key in enumerate(a.attr_names):
        vec = key.startswith("eigVectors")
        lanes = apart[int(key[10:]) % 3] if vec else both
        if canon == "organizedcloudsurfacenormal" and key != "densities":
            lanes = spread
        fields.append((key, a.attrs[:, k:k + 1], b.attrs[:, k:k + 1], vec, lanes))
    bad = torch.zeros_like(both)
    worst = 0.0
    for _, x, y, signless, lanes in fields:
        if signless and x.shape[-1] == 3:
            x = torch.where((x * y).sum(-1, keepdim=True) < 0, -x, x)
        elif signless:
            x, y = x.abs(), y.abs()
        d = (x - y).abs()
        off = (d > 1e-5 + 1e-5 * y.abs()).any(-1) & lanes
        bad |= off
        if bool((lanes & ~off).any()):
            worst = max(worst, float(d[lanes & ~off].max()))
    share = float(bad.sum()) / max(int(both.sum()), 1)
    if share > BINNING_SHARE:
        per_field = []
        for key, x, y, _, lanes in fields:
            d = (x - y).abs().amax(-1)[lanes]
            per_field.append(f"{key}: {int((d > 1e-5).sum())} lanes, "
                             f"max {float(d.max()) if d.numel() else 0.0:.3g}")
        fail(f"chain filter {canon}: {int(bad.sum())} of {int(both.sum())} lanes differ by more "
             "than 1e-5, card vs CPU (" + "; ".join(per_field) + ")")
    return diff, share, worst


def chain_card_vs_cpu(torch, dev, c, gt):
    """Phase ``chain card vs cpu``: the production chain on one pair of
    CHAIN_TWIN_POINTS-point scans (the lap at its reduced width), on the
    card and on the CPU with the same draws: transforms within 0.1 mm and
    0.001 degrees."""
    velo = KITTI_DIR / "sequences" / "00" / "velodyne"
    a, b = (read_kitti_scan(torch, velo / f"{i:06d}.bin", dev) for i in (0, 1))
    truth = (np.linalg.inv(gt[0]) @ gt[1]).astype(np.float32)
    guess = perturbed(truth, np.random.default_rng(52))
    t0 = time.perf_counter()
    Tg = c.register(b, a, guess, seed=3).transform.cpu().numpy()
    gpu_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    Tc = c.register(b.to("cpu"), a.to("cpu"), guess, seed=3).transform.numpy()
    cpu_ms = (time.perf_counter() - t0) * 1e3
    dt, dr = transform_difference(Tg, Tc)
    err = chain_accuracy("chain card vs cpu", Tg, truth, guess)
    phase("chain card vs cpu", points=f"{int(b.mask.sum())}x{int(a.mask.sum())}",
          diff_mm=f"{dt * 1e3:.5f}", diff_deg=f"{np.degrees(dr):.6f}", card_ms=f"{gpu_ms:.1f}",
          cpu_ms=f"{cpu_ms:.1f}", err_m=f"{err[0]:.5f}", err_deg=f"{err[1]:.5f}")
    if not (dt <= 1e-4 and np.degrees(dr) <= 1e-3):
        fail(f"chain card vs cpu: {dt * 1e3:.4f} mm and {np.degrees(dr):.6f} deg apart")


def chain_kernel_rows(torch, c, last, launches):
    """Phase ``K1 nn chain``: K1 against its twin at the chain's shape (the
    last pair's filtered reading under its guess, in Morton order, against
    the reference in Morton order) at maxDist 0.5 and inf, with times and
    bounds; the rows of the kernels line."""
    from open3d_slam_advanced_rss_2024_public_tpu_torch.ops import filters
    from open3d_slam_advanced_rss_2024_public_tpu_torch.ops.registration import chain
    from open3d_slam_advanced_rss_2024_public_tpu_torch.utils import se3

    i, reading, reference, guess = last
    src = chain.kernel_order(c.process_reading(reading, seed=filters.fold_in(i, 0)), c.config)
    ref = chain.reference_grid(c.process_reference(reference, seed=filters.fold_in(i, 1)),
                               c.config)
    q = se3.apply(torch.tensor(guess).to(src.device), src.xyz)
    rows = []
    for label, maxd in (("chain", 0.5), ("chain, maxDist inf", float("inf"))):
        row = nn_shape_row(torch, label, q, ref.points, maxd, launches[maxd])
        row["launches_chain"] = launches[maxd]  # K1's launches over this pass of the chain
        rows.append(row)
    return rows


# -- the rosbag path ----------------------------------------------------------
BAG_RINGS = 32             # an Ouster OS1-32 ...
BAG_COLUMNS = 1024         # ... in 1024x10 mode: 32768 points a 0.1 s sweep
BAG_POINTS = BAG_RINGS * BAG_COLUMNS
BAG_SWEEP = 0.1
BAG_SWEEPS = 100           # the cli kitti lap's 100 poses
BAG_ODOM_STEPS = 10        # /odom at 100 Hz
BAG_FOV_DEG = 22.5         # the OS1's vertical field of view, +-22.5 degrees
BAG_DIR = OUT / "rosbag"
BAG_PATH = BAG_DIR / "os1_32_lap.bag"
BAG_TOPIC = "/os_cloud_node/points"
BAG_ODOM_TOPIC = "/odom"
BAG_FRAME = "os_sensor"
BAG_VIZ_DIR = OUT / "viz"
BAG_VIZ_EVERY = 25
BAG_ONLINE_SCANS = 24
# The package defaults with two changes: deskewing on, and a scan's lanes
# the sensor's 32768 points, so that every 0.1 m voxel of a scan fits.
BAG_PARAMS = {"motion_compensation": {"is_undistort_scan": True},
              "mapper": {"mapper_localizer": {"scan_to_map_registration": {
                  "scan_processing": {"point_capacity": BAG_POINTS}}}}}
# The Ouster OS1 point layout, 48 bytes a point: name, offset, numpy
# type and PointField datatype code.
OUSTER_FIELDS = [("x", 0, "f4", 7), ("y", 4, "f4", 7), ("z", 8, "f4", 7),
                 ("intensity", 16, "f4", 7), ("t", 20, "u4", 6),
                 ("reflectivity", 24, "u2", 4), ("ring", 26, "u2", 4),
                 ("ambient", 28, "u2", 4), ("range", 32, "u4", 6)]


def ouster_cloud_message(xyz, t_ns, ring, intensity, stamp: float) -> bytes:
    """A sensor_msgs/PointCloud2 in the Ouster OS1 point layout (BAG_RINGS
    rows of BAG_COLUMNS, 48-byte points), packed by hand."""
    import struct

    from open3d_slam_advanced_rss_2024_public_tpu_torch.frontends import rosbag

    dt = np.dtype({"names": [f[0] for f in OUSTER_FIELDS],
                   "formats": [f[2] for f in OUSTER_FIELDS],
                   "offsets": [f[1] for f in OUSTER_FIELDS], "itemsize": 48})
    rec = np.zeros(xyz.shape[0], dt)
    rec["x"], rec["y"], rec["z"] = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    rec["intensity"], rec["t"], rec["ring"] = intensity, t_ns, ring
    rec["reflectivity"] = np.clip(intensity, 0, 65535).astype(np.uint16)
    rec["ambient"] = 50
    rec["range"] = (np.linalg.norm(xyz, axis=1) * 1000.0).astype(np.uint32)  # millimetres
    body = rec.tobytes()
    secs, nsecs = rosbag._split_ros_time(stamp)
    out = bytearray(struct.pack("<III", 0, secs, nsecs))
    out += struct.pack("<I", len(BAG_FRAME)) + BAG_FRAME.encode()
    out += struct.pack("<III", BAG_RINGS, BAG_COLUMNS, len(OUSTER_FIELDS))
    for name, off, _, code in OUSTER_FIELDS:
        out += struct.pack("<I", len(name)) + name.encode() + struct.pack("<IBI", off, code, 1)
    out += struct.pack("<BII", 0, 48, 48 * BAG_COLUMNS)
    out += struct.pack("<I", len(body)) + body + struct.pack("<B", 1)
    return bytes(out)


def bag_odometry(gt):
    """The lap's odometry at the sweep ends, drifting as ``slam loop``'s does
    (1.5 cm and 2 mrad a step)."""
    from open3d_slam_advanced_rss_2024_public_tpu_torch.frontends import synthetic

    return synthetic.perturb_odometry(gt[:BAG_SWEEPS], drift_per_step=0.015,
                                      yaw_drift_per_step=0.002, seed=3)


def rosbag_write(torch, dev, gt):
    """Phase ``rosbag write``: the ``cli kitti`` world and lap as a bag of
    BAG_SWEEPS Ouster OS1-32 sweeps (1024 x 10, 32768 points) on BAG_TOPIC
    and BAG_ODOM_STEPS odometry messages a sweep on BAG_ODOM_TOPIC.  Sweep
    k ends at the lap's pose k, stamped (k + 1) x 0.1 s, and covers the
    motion from pose k - 1; the robot stands still through the first sweep,
    as a recording starts (the deskewing twist comes from the odometry of
    earlier sweeps, so a first sweep in motion would enter the map skewed).
    Each point is measured from the sensor pose of its column's time,
    interpolated along the lap (``se3.interpolate``), and carries that time
    as u32 nanoseconds.  Then the whole bag is read and decoded on the
    host.  Returns the odometry at the sweep ends."""
    from open3d_slam_advanced_rss_2024_public_tpu_torch.frontends import rosbag, synthetic
    from open3d_slam_advanced_rss_2024_public_tpu_torch.utils import se3

    BAG_DIR.mkdir(parents=True, exist_ok=True)
    world = kitti_world(dev)
    poses, odom = gt[:BAG_SWEEPS], bag_odometry(gt)
    gen = torch.Generator(device=dev).manual_seed(43)
    G = torch.as_tensor(np.stack(poses), device=dev)
    O = torch.as_tensor(np.stack(odom), device=dev)
    col_alpha = torch.arange(BAG_COLUMNS, device=dev, dtype=torch.float32) / BAG_COLUMNS
    odo_alpha = torch.arange(BAG_ODOM_STEPS, device=dev, dtype=torch.float32) / BAG_ODOM_STEPS
    t0 = time.perf_counter()
    w = rosbag.RosbagWriter(str(BAG_PATH))
    shift = []
    for k in range(len(poses)):
        stamp, j = BAG_SWEEP * (k + 1), max(k - 1, 0)
        sweep = se3.interpolate(O[j].expand(BAG_ODOM_STEPS, 4, 4),
                                O[k].expand(BAG_ODOM_STEPS, 4, 4), odo_alpha).cpu().numpy()
        for m in range(BAG_ODOM_STEPS):
            w.write_odometry(BAG_ODOM_TOPIC, sweep[m], stamp - BAG_SWEEP * (1 - m / BAG_ODOM_STEPS),
                             child_frame_id=BAG_FRAME)
        cols = se3.interpolate(G[j].expand(BAG_COLUMNS, 4, 4), G[k].expand(BAG_COLUMNS, 4, 4),
                               col_alpha)
        mid = cols[BAG_COLUMNS // 2]
        scan = synthetic.render_scan(world, mid.cpu().numpy(), gen, max_range=KITTI_RANGE,
                                     n_points=BAG_POINTS, noise=0.01)
        if int(scan.mask.sum()) != BAG_POINTS:
            fail(f"rosbag write: sweep {k} holds {int(scan.mask.sum())} points within "
                 f"{KITTI_RANGE} m, not {BAG_POINTS}")
        # The column from the azimuth (a clockwise sweep from azimuth pi, as
        # motion_compensation.compute_phase has it), the point from its
        # column's pose.
        az = torch.atan2(scan.xyz[:, 1], scan.xyz[:, 0])
        col = ((math.pi - az) / (2 * math.pi) * BAG_COLUMNS).long().clamp(0, BAG_COLUMNS - 1)
        world_xyz = se3.apply(mid, scan.xyz)
        inv = se3.inverse(cols)[col]
        xyz = (inv[:, :3, :3] @ world_xyz[:, :, None])[:, :, 0] + inv[:, :3, 3]
        end_xyz = se3.apply(se3.inverse(G[k]), world_xyz)
        shift.append(float(torch.linalg.vector_norm(xyz - end_xyz, dim=1).max()))
        elev = torch.rad2deg(torch.atan2(xyz[:, 2], torch.linalg.vector_norm(xyz[:, :2], dim=1)))
        ring = ((elev + BAG_FOV_DEG) / (2 * BAG_FOV_DEG) * (BAG_RINGS - 1)).round()
        ring = ring.clamp(0, BAG_RINGS - 1).long()
        order = torch.argsort(ring * BAG_COLUMNS + col, stable=True)
        xyz, col, ring = xyz[order].cpu().numpy(), col[order].cpu().numpy(), ring[order].cpu().numpy()
        t_ns = (col * (BAG_SWEEP * 1e9 / BAG_COLUMNS)).astype(np.uint32)
        intensity = (3000.0 / (1.0 + np.linalg.norm(xyz, axis=1))).astype(np.float32)
        w.write(BAG_TOPIC, "sensor_msgs/PointCloud2", stamp,
                ouster_cloud_message(xyz, t_ns, ring, intensity, stamp))
    w.write_odometry(BAG_ODOM_TOPIC, odom[-1], BAG_SWEEP * len(poses), child_frame_id=BAG_FRAME)
    w.close()
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    frames = list(rosbag.rosbag_sequence(str(BAG_PATH), BAG_TOPIC,
                                         odometry_topic=BAG_ODOM_TOPIC, device="cpu"))
    read_s = time.perf_counter() - t0
    n = len(poses)
    phase("rosbag write", sweeps=n, points_per_sweep=BAG_POINTS, point_step=48,
          odometry_hz=BAG_ODOM_STEPS / BAG_SWEEP, bag_bytes=BAG_PATH.stat().st_size,
          write_s=f"{write_s:.2f}", read_decode_s=f"{read_s:.2f}",
          read_decode_ms_per_sweep=f"{read_s / n * 1e3:.2f}",
          sweep_shift_max_m=f"{max(shift):.4f}")
    first = frames[0].scan if frames else None
    if len(frames) != n or first.attr_names != ("intensity", "t") or \
            int(first.mask.sum()) != BAG_POINTS:
        fail(f"rosbag write: the bag reads back as {len(frames)} frames, the first with "
             f"channels {None if first is None else first.attr_names}")
    t_max = float(first.attr("t").max())
    if not abs(t_max - BAG_SWEEP * (BAG_COLUMNS - 1) / BAG_COLUMNS) < 1e-6:
        fail(f"rosbag write: the time channel reads back to {t_max} s")
    return odom


def run_bag_cli(torch, params, out, viz_dir=None):
    """The command line on the bag with ``params`` (written to a JSON file
    under build/): (exit code, the SlamWrapper, ms a scan, counting)."""
    params_file = OUT / f"rosbag_params_{out.name}.json"
    params_file.write_text(json.dumps(params))
    argv = ["--dataset", "rosbag", "--bag", str(BAG_PATH), "--cloud-topic", BAG_TOPIC,
            "--odometry-topic", BAG_ODOM_TOPIC, "--params", str(params_file),
            "--output", str(out)]
    if viz_dir is not None:
        argv += ["--viz-dir", str(viz_dir), "--viz-every", str(BAG_VIZ_EVERY)]
    counting = _Counting()
    t0 = time.perf_counter()
    try:
        rc, _, _ = run_cli(argv)
        torch.cuda.synchronize()
    finally:
        counting.restore()
    wall = time.perf_counter() - t0
    slam = counting.slams[0]
    return rc, slam, wall / max(len(slam.trajectory_poses), 1) * 1e3, counting


def cli_rosbag(torch, dev, gt, odom):
    """Phase ``cli rosbag``, this slice's path: ``cli.main --dataset rosbag``
    on the bag at the package defaults with deskewing on and 32768 lanes a
    scan, publishing the live visualization bundle every BAG_VIZ_EVERY
    scans.  The launch counts are set to 0 just before the run and read
    just after.  Then the same run without the bundle (its cost) and with
    deskewing off (its effect, no bar).  Returns (the SlamWrapper, the
    launches of the run, the counts apart)."""
    import copy
    import shutil

    from open3d_slam_advanced_rss_2024_public_tpu_torch.frontends import rosbag
    from open3d_slam_advanced_rss_2024_public_tpu_torch.ops import (cuda_moments, cuda_nn,
                                                                    cuda_tiles, filters)
    from open3d_slam_advanced_rss_2024_public_tpu_torch.utils import io
    from open3d_slam_advanced_rss_2024_public_tpu_torch.utils.config import load_parameters

    sp = load_parameters(BAG_PARAMS).mapper.mapper_localizer.scan_to_map_registration \
        .scan_processing
    first = next(iter(rosbag.rosbag_sequence(str(BAG_PATH), BAG_TOPIC,
                                             odometry_topic=BAG_ODOM_TOPIC, device=dev))).scan
    voxels = int(filters.voxel_downsample(first, sp.voxel_size, first.capacity).mask.sum())
    shutil.rmtree(BAG_VIZ_DIR, ignore_errors=True)
    out = OUT / "cli_rosbag"
    cuda_nn.reset_launches()
    cuda_moments.reset_launches()
    cuda_tiles.reset_launches()
    rc, slam, ms, counting = run_bag_cli(torch, BAG_PARAMS, out, viz_dir=BAG_VIZ_DIR)
    launches = {"nn": cuda_nn.launches, "moments": cuda_moments.launches,
                "tile_prepare": cuda_tiles.prepare_launches,
                "tile_plan": cuda_tiles.plan_launches}
    counts = counting.counts
    n = BAG_SWEEPS
    truth, odo = np.stack(gt[:BAG_SWEEPS]), np.stack(odom)
    est = np.stack(slam.trajectory_poses) if slam.trajectory_poses else np.zeros((0, 4, 4))
    ate = io.ate_rmse(est, truth[:len(est)]) if len(est) >= 3 else float("inf")
    ate_odom = io.ate_rmse(odo, truth)
    rows = np.loadtxt(out / "slam_poses", ndmin=2) if (out / "slam_poses").exists() else []
    map_points = int(io.load_pcd(str(out / "map.pcd"), device=dev).mask.sum())
    graph = json.loads((out / "pose_graph.json").read_text())
    _, plain_slam, plain_ms, _ = run_bag_cli(torch, BAG_PARAMS, OUT / "cli_rosbag_plain")
    skewed = copy.deepcopy(BAG_PARAMS)
    skewed["motion_compensation"]["is_undistort_scan"] = False
    _, skew_slam, skew_ms, _ = run_bag_cli(torch, skewed, OUT / "cli_rosbag_skewed")
    skew_est = np.stack(skew_slam.trajectory_poses)
    ate_skew = io.ate_rmse(skew_est, truth[:len(skew_est)])
    phase("cli rosbag", scans=n, trajectory_entries=len(est), tum_rows=len(rows),
          voxels_first_scan=voxels, lanes=sp.point_capacity, ms_per_scan=f"{ms:.3f}",
          ms_per_scan_no_viz=f"{plain_ms:.3f}", viz_ms_per_scan=f"{ms - plain_ms:.3f}",
          mapper_ms=f"{counting.host_ms['mapper']:.1f}",
          submaps=len(slam.mapper.submaps.submaps), closures=slam.loop_closure_count,
          ate_slam_m=f"{ate:.4f}", ate_odometry_m=f"{ate_odom:.4f}",
          ate_no_deskew_m=f"{ate_skew:.4f}", ms_per_scan_no_deskew=f"{skew_ms:.3f}",
          nn_launches=launches["nn"], nn_launches_mapper=counts["mapper_nn"],
          moments_launches=launches["moments"],
          moments_launches_mapper=counts["mapper_moments"],
          tile_prepare_launches=launches["tile_prepare"],
          tile_plan_launches=launches["tile_plan"], map_points=map_points,
          graph_edges=len(graph["odometry_constraints"]),
          viz_publishes=len(list(BAG_VIZ_DIR.glob("*.p*"))))
    if rc != 0 or len(est) != n or len(rows) != n or not np.isfinite(est).all():
        fail(f"cli rosbag: exit code {rc}, {len(est)} poses and {len(rows)} TUM rows for "
             f"{n} sweeps")
    if voxels > sp.point_capacity:
        fail(f"cli rosbag: the first scan holds {voxels} voxels in {sp.point_capacity} lanes")
    if min(launches.values()) <= 0 or counts["mapper_nn"] <= 0 or counts["mapper_moments"] <= 0:
        fail(f"cli rosbag: launches {launches}, apart {counts}")
    if not (ate < 0.2 and ate < ate_odom):
        fail(f"cli rosbag: ATE {ate:.4f} m against the odometry's {ate_odom:.4f} m (bar 0.2 m)")
    if map_points <= 10000 or len(plain_slam.trajectory_poses) != n:
        fail(f"cli rosbag: map.pcd reloads with {map_points} points, the run without the "
             f"bundle wrote {len(plain_slam.trajectory_poses)} poses")
    return slam, launches, counts


def bag_kernel_rows(torch, dev, slam, counts):
    """K1 and K2 against their plain versions at the shapes ``cli rosbag``
    gives them: ``K1 nn mapper rosbag``, the last sweep preprocessed at
    32768 lanes, at its refined pose, against the final submap's
    65536-point patch; ``K2 moments mapper rosbag``, that sweep's voxels
    [1, 32768] at the normals' 0.5 m.  Returns the rows of the kernels
    line."""
    from open3d_slam_advanced_rss_2024_public_tpu_torch.frontends import rosbag
    from open3d_slam_advanced_rss_2024_public_tpu_torch.models import pipeline, scan_processing

    pcfg = slam.mapper.pipe_cfg
    last = None
    for last in rosbag.rosbag_sequence(str(BAG_PATH), BAG_TOPIC, device=dev):
        pass
    pose = torch.as_tensor(slam.trajectory_poses[-1], device=dev)
    _, match = pipeline._preprocess(last.scan, pcfg)
    _, grid = scan_processing.crop_submap_and_index(
        slam.mapper.submaps.active_submap.map.cloud, pose[:3, 3], min_radius=0.0,
        max_radius=pcfg.crop_max_radius + pcfg.block_ref_margin,
        match_dist=pcfg.icp.max_correspondence_dist, capacity=pcfg.map_patch_capacity,
        build_hash=False)
    rows = [nn_shape_row(torch, "mapper rosbag", match.transform(pose).xyz.contiguous(),
                         grid.points.contiguous(), pcfg.icp.max_correspondence_dist,
                         counts["mapper_nn"])]
    blk = scan_processing.preprocess_scan(last.scan, pcfg.crop_min_radius, pcfg.crop_max_radius,
                                          pcfg.scan_voxel_size, 1.0, pcfg.scan_capacity,
                                          estimate_scan_normals=False)
    rows.append(moments_shape_row(torch, "mapper rosbag", blk.map(lambda t: t[None]),
                                  counts["mapper_moments"]))
    return rows


def undistort_t_channel(torch, dev, gt):
    """Phase ``undistort t channel``: ``motion_compensation.undistort`` on
    the bag's second sweep, decoded with its time channel, under the lap's
    motion over that sweep: card against CPU, no host sync, device time."""
    from open3d_slam_advanced_rss_2024_public_tpu_torch.frontends import rosbag
    from open3d_slam_advanced_rss_2024_public_tpu_torch.models import motion_compensation
    from open3d_slam_advanced_rss_2024_public_tpu_torch.utils import se3

    frames = rosbag.rosbag_sequence(str(BAG_PATH), BAG_TOPIC, device=dev)
    next(frames)  # the first sweep stands still
    scan = next(frames).scan
    T0, T1 = (torch.as_tensor(g, device=dev) for g in gt[:2])
    twist = se3.se3_log(se3.inverse(T0) @ T1)
    with warnings.catch_warnings(record=True) as syncs:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        out = motion_compensation.undistort(scan, twist)
        torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in syncs if "called a synchronizing CUDA operation" in str(w.message)]
    cpu = motion_compensation.undistort(scan.to("cpu"), twist.cpu())
    m = scan.mask.cpu()
    err = float((out.xyz.cpu() - cpu.xyz)[m].abs().max())
    moved = float(torch.linalg.vector_norm(out.xyz - scan.xyz, dim=1)[scan.mask].max())
    ms = cuda_ms(lambda: motion_compensation.undistort(scan, twist))
    phase("undistort t channel", lanes=scan.capacity, valid=int(m.sum()),
          max_abs_err_m=f"{err:.3g}", host_syncs=len(syncs), max_shift_m=f"{moved:.4f}",
          ms=f"{ms:.4f}")
    if syncs:
        fail(f"undistort t channel: {len(syncs)} host syncs")
    if not err <= 1e-4 or not moved > 0.1:
        fail(f"undistort t channel: card against CPU {err} m, largest shift {moved} m")


def run_online(dev, frames, T_cal):
    """The frames through ``OnlineRangeDataProcessor`` on a fresh card
    ``SlamWrapper``, one sweep at a time, as a sensor feeds a processor
    that keeps up: the deskewing twist comes from the newest odometry in
    the buffer, which must not run ahead of the sweep.  Returns (the
    SlamWrapper, whether the calibration was set after the first cloud,
    wall seconds)."""
    from open3d_slam_advanced_rss_2024_public_tpu_torch.frontends.online import (
        OnlineRangeDataProcessor)
    from open3d_slam_advanced_rss_2024_public_tpu_torch.models.slam import SlamWrapper
    from open3d_slam_advanced_rss_2024_public_tpu_torch.utils.config import load_parameters
    from open3d_slam_advanced_rss_2024_public_tpu_torch.utils.frames import (
        StaticTransformBuffer)

    tf = StaticTransformBuffer()
    tf.set_transform(BAG_FRAME, "base", T_cal)
    slam = SlamWrapper(load_parameters(BAG_PARAMS), device=dev)
    slam.set_initial_transform(frames[0].odom_pose)
    proc = OnlineRangeDataProcessor(slam, tf, odometry_frame="base")
    calibrated_after_first = False
    proc.start_processing()
    t0 = time.perf_counter()
    try:
        for k, f in enumerate(frames):
            deadline = time.perf_counter() + 60.0
            while len(slam.trajectory_poses) < k and time.perf_counter() < deadline:
                time.sleep(0.002)
            proc.odometry_callback(f.odom_pose @ T_cal, f.time)
            while not proc.cloud_callback(f.scan, f.time, frame_id=BAG_FRAME):
                time.sleep(0.002)
            if k == 0:
                calibrated_after_first = proc.calibration_set
        deadline = time.perf_counter() + 120.0
        while time.perf_counter() < deadline and len(slam.trajectory_poses) < len(frames):
            time.sleep(0.01)
        slam.finish_processing()
    finally:
        proc.stop_processing()
    return slam, calibrated_after_first, time.perf_counter() - t0


def online_bag(torch, dev, gt, odom):
    """Phase ``online bag``: the bag's first BAG_ONLINE_SCANS sweeps through
    ``OnlineRangeDataProcessor`` on a ``SlamWrapper`` on the card, workers
    started and stopped, deskewing on, with the odometry of a body frame 60
    degrees from the sensor and 0.22 m off
    (``tests/test_online_calibration.py:81-121``) and the calibration from a
    ``StaticTransformBuffer``; ``ms_per_scan`` is a sweep's latency.  Then
    the same run with the deskewing twist taken in the body frame, as the
    JAX package takes it (``ate_body_frame_twist_m``, no bar)."""
    import itertools

    from open3d_slam_advanced_rss_2024_public_tpu_torch.frontends import rosbag
    from open3d_slam_advanced_rss_2024_public_tpu_torch.models import motion_compensation
    from open3d_slam_advanced_rss_2024_public_tpu_torch.utils import io

    n = BAG_ONLINE_SCANS
    frames = list(itertools.islice(rosbag.rosbag_sequence(
        str(BAG_PATH), BAG_TOPIC, odometry_topic=BAG_ODOM_TOPIC, device=dev), n))
    c, s = math.cos(math.pi / 3), math.sin(math.pi / 3)
    T_cal = np.array([[c, -s, 0, 0.2], [s, c, 0, -0.1], [0, 0, 1, 0], [0, 0, 0, 1]],
                     np.float32)  # cloud <- odometry body
    slam, calibrated_after_first, wall = run_online(dev, frames, T_cal)
    est = np.stack(slam.trajectory_poses)
    ate = io.ate_rmse(est, np.stack(gt[:len(est)]))
    ate_odom = io.ate_rmse(np.stack(odom[:n]), np.stack(gt[:n]))
    cloud_frame_twist = motion_compensation.estimate_twist_from_buffer
    motion_compensation.estimate_twist_from_buffer = \
        lambda buffer, duration, num_poses, calibration=None: cloud_frame_twist(
            buffer, duration, num_poses)
    try:
        body, _, _ = run_online(dev, frames, T_cal)
    finally:
        motion_compensation.estimate_twist_from_buffer = cloud_frame_twist
    body_est = np.stack(body.trajectory_poses)
    phase("online bag", scans=n, trajectory_entries=len(est),
          calibration_set_after_first=calibrated_after_first,
          calibration_err=f"{np.abs(slam.mapper.calibration - T_cal).max():.2e}",
          wall_s=f"{wall:.2f}", ms_per_scan=f"{wall / n * 1e3:.3f}",
          ate_slam_m=f"{ate:.4f}", ate_odometry_m=f"{ate_odom:.4f}",
          ate_body_frame_twist_m=f"{io.ate_rmse(body_est, np.stack(gt[:len(body_est)])):.4f}",
          workers_alive=sum(t.is_alive() for t in slam._workers))
    if not calibrated_after_first or not np.abs(slam.mapper.calibration - T_cal).max() < 1e-5:
        fail("online bag: the calibration was not installed after the first cloud")
    if len(est) != n or not np.isfinite(est).all() or slam._workers:
        fail(f"online bag: {len(est)} poses for {n} sweeps, {len(slam._workers)} workers left")
    if not ate < ate_odom:
        fail(f"online bag: ATE {ate:.4f} m against the odometry's {ate_odom:.4f} m")


def viz_bundle(torch, dev):
    """Phase ``viz bundle``: the files ``cli rosbag`` published reload;
    ``visualizer_node.serve`` on a free loopback port serves the index and
    one file; ``POST /initialpose`` sets a card SlamWrapper's pose."""
    import urllib.request

    from open3d_slam_advanced_rss_2024_public_tpu_torch.frontends import visualizer_node
    from open3d_slam_advanced_rss_2024_public_tpu_torch.models.map_initializer import (
        pose_from_config)
    from open3d_slam_advanced_rss_2024_public_tpu_torch.models.slam import SlamWrapper
    from open3d_slam_advanced_rss_2024_public_tpu_torch.utils import io

    counts = {}
    for name in ("submaps_colored.ply", "trajectory_tube.pcd", "best_guess_tube.pcd",
                 "submap_origins.ply"):
        path = BAG_VIZ_DIR / name
        if not path.exists():
            fail(f"viz bundle: {name} was not written")
        counts[name.split(".")[0]] = int(io.load_cloud(str(path), device="cpu").count())
    slam = SlamWrapper(device=dev)
    server = visualizer_node.serve(str(BAG_VIZ_DIR), port=0, background=True, slam=slam)
    try:
        port = server.server_address[1]
        index = urllib.request.urlopen(f"http://127.0.0.1:{port}/", timeout=10).read().decode()
        body = urllib.request.urlopen(f"http://127.0.0.1:{port}/submap_origins.ply",
                                      timeout=10).read()
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/initialpose",
            data=json.dumps({"x": 3.0, "y": -2.0, "z": 1.0, "yaw": 30.0}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=10) as r:
            status = r.status
    finally:
        server.shutdown()
        server.server_close()

    class _Pose:
        x, y, z, roll, pitch, yaw = 3.0, -2.0, 1.0, 0.0, 0.0, 30.0
    pose_err = float(np.abs(slam.mapper.map_to_range_sensor - pose_from_config(_Pose)).max())
    phase("viz bundle", **{f"{k}_points": v for k, v in counts.items()}, http_port=port,
          index_bytes=len(index), served_bytes=len(body), initialpose_status=status,
          initialpose_err=f"{pose_err:.2e}")
    if min(counts.values()) <= 0 or "submaps_colored.ply" not in index:
        fail(f"viz bundle: {counts}, index lists {index.count('<li>')} files")
    if body != (BAG_VIZ_DIR / "submap_origins.ply").read_bytes():
        fail("viz bundle: the served file differs from the bundle's")
    if status != 200 or not pose_err <= 1e-6:
        fail(f"viz bundle: POST /initialpose answered {status}, pose off by {pose_err}")


# -- the multi-chip path: parallel/ on torch.distributed ------------------------

PAR_CAPACITY = 1 << 17     # capacity_per_device: bench.py's 2^17-slot table
PAR_BLOCK = 8.0            # the map partition's block edge, m
PAR_RANKS = 4
PAR_W4_SCANS = 20          # the world-4 mapper runs the loop's first 20 scans
PAR_REG_SCAN = 50          # the scan the data-parallel register aligns
PAR_GRAPH_NODES = 24       # the distributed solver's graph: a 24-node loop
PAR_SESSION_SCANS = 24     # __graft_entry__.py's session: 24 scans of 1024
PAR_SESSION_POINTS = 1024  # points, 6 a submap
PAR_TIMEOUT_S = 180.0
PAR_VOXEL_GAP = 32         # world 4's voxels against world 1's: 4 x the largest measured gap
PAR_DIR = OUT / "parallel"


def parallel_config(scan_points: int = N_SCAN, patch: int = N_PATCH):
    """``bench.py``'s Mapper step (bench.py:158-195) as the step's own
    configuration: scans voxelised at 0.1 m into ``scan_points`` lanes,
    cropped at 0.7-25 m, point-to-plane ICP of 15 trips at 0.5 m with K1, a
    ``patch``-point map patch, 0.1 m map voxels, normals from K2."""
    from open3d_slam_advanced_rss_2024_public_tpu_torch.models.pipeline import PipelineConfig
    from open3d_slam_advanced_rss_2024_public_tpu_torch.ops.registration.icp import ICPConfig

    return PipelineConfig(icp=ICPConfig(max_iterations=15, max_correspondence_dist=MAX_DIST,
                                        matcher="cuda"),
                          scan_voxel_size=0.1, scan_capacity=scan_points, crop_min_radius=0.7,
                          crop_max_radius=25.0, map_patch_capacity=patch, map_voxel_size=0.1,
                          min_refinement_fitness=0.3)


class CollectiveCount:
    """Counts the calls and the bytes of ``torch.distributed.all_reduce``
    and ``all_gather`` made while it is active (the mesh's collectives go
    through them)."""

    def __init__(self):
        self.calls = {"all_reduce": 0, "all_gather": 0}
        self.bytes = {"all_reduce": 0, "all_gather": 0}

    def __enter__(self):
        import torch.distributed as dist

        self._orig = {name: getattr(dist, name) for name in self.calls}

        def counting(name):
            orig = self._orig[name]

            def fn(*args, **kwargs):
                t = args[0] if name == "all_reduce" else args[1]
                self.calls[name] += 1
                self.bytes[name] += t.numel() * t.element_size()
                return orig(*args, **kwargs)
            return fn
        for name in self.calls:
            setattr(dist, name, counting(name))
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist

        for name, fn in self._orig.items():
            setattr(dist, name, fn)


def _cloud_arrays(cloud):
    return tuple(t.cpu().numpy() for t in (cloud.xyz, cloud.normals, cloud.mask))


def _cloud_on(torch, a, dev):
    from open3d_slam_advanced_rss_2024_public_tpu_torch.utils.pointcloud import PointCloud

    return PointCloud(*(torch.as_tensor(x, device=dev) for x in a))


def parallel_register_config():
    """``bench.py``'s "icp fixed-15" (bench.py:149-152): 15 trips at 0.5 m
    with the differential checker off, here with K1."""
    from open3d_slam_advanced_rss_2024_public_tpu_torch.ops.registration.icp import ICPConfig

    return ICPConfig(max_iterations=15, max_correspondence_dist=MAX_DIST, matcher="cuda",
                     min_diff_rot=0.0, min_diff_trans=0.0)


def parallel_register_inputs(torch, cfg, scan, pose, maps):
    """The data-parallel register's problem: a preprocessed scan (8192 rows
    with K2's normals) against the Morton-sorted patch of the map around
    its refined pose, from that pose moved by 4 cm and 0.6 degrees."""
    from open3d_slam_advanced_rss_2024_public_tpu_torch.models import pipeline, scan_processing
    from open3d_slam_advanced_rss_2024_public_tpu_torch.utils import se3

    _, match = pipeline._preprocess(scan, cfg)
    _, grid = scan_processing.crop_submap_and_index(
        maps.cloud, pose[:3, 3], 0.0, cfg.crop_max_radius, MAX_DIST, cfg.map_patch_capacity,
        build_hash=False)
    off = se3.make_transform(se3.so3_exp(torch.tensor([0.0, 0.0, 0.01], device=pose.device)),
                             torch.tensor([0.03, -0.02, 0.015], device=pose.device))
    return match, grid, pose @ off


def parallel_world1(torch, dev, scans, gt):
    """Phase ``parallel world 1 nccl``, the multi-chip path at full width on
    one card: this process starts NCCL at world size 1 (a file store under
    build/), builds the mesh on ``cuda`` and drives ``make_sharded_mapper``
    over the main path's 100-scan loop at ``bench.py``'s shapes with a
    2^17-slot table a rank and 8 m blocks, the estimate composed on the
    device from the refined pose and the exact odometry.  The warm-up runs
    under torch's sync debug mode; the launch counts are set to 0 just
    before the counted run and read just after, and the collectives are
    counted.  Every pose is held within 5 mm of the port's single-process
    ``pipeline.mapper_step`` on the same scans and estimates; K1 and K2 are
    held against their twins at the shapes this path gives them; the
    data-parallel register runs once for world 4 to compare with.  Returns
    (kernel rows, launches, what world 4 is held against)."""
    import os

    import torch.distributed as dist

    from open3d_slam_advanced_rss_2024_public_tpu_torch.models import pipeline, scan_processing
    from open3d_slam_advanced_rss_2024_public_tpu_torch.ops import (cuda_moments, cuda_nn,
                                                                    cuda_tiles)
    from open3d_slam_advanced_rss_2024_public_tpu_torch.parallel import mesh as pmesh
    from open3d_slam_advanced_rss_2024_public_tpu_torch.parallel import (sharded_icp,
                                                                         sharded_slam)
    from open3d_slam_advanced_rss_2024_public_tpu_torch.utils.device import to_device

    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    PAR_DIR.mkdir(parents=True, exist_ok=True)
    store = PAR_DIR / "store_w1"
    store.unlink(missing_ok=True)
    sharded_slam.init_distributed(f"file://{store}", 1, 0, device=dev, timeout=PAR_TIMEOUT_S)
    try:
        mesh = pmesh.make_mesh(1, device=dev)
        backend = dist.get_backend()
        pmesh.psum(mesh, torch.ones(1, device=dev))  # NCCL's communicator, set up once
        torch.cuda.synchronize()
        cfg = parallel_config()
        empty, step = sharded_slam.make_sharded_mapper(mesh, cfg, PAR_CAPACITY, PAR_BLOCK)
        deltas = [to_device(np.eye(4), dev)] + [
            to_device(np.linalg.inv(gt[i - 1]) @ gt[i], dev) for i in range(1, len(gt))]
        T0 = to_device(gt[0], dev)

        def run(n):
            maps, T, last = empty(), T0, T0
            ests, poses, count_w4 = [], [], None
            for i in range(n):
                est = T @ deltas[i]
                maps, T, _, last = step(maps, last, scans[i], est)
                ests.append(est)
                poses.append(T)
                if i + 1 == PAR_W4_SCANS:
                    count_w4 = maps.count()
            return maps, ests, poses, count_w4
        with warnings.catch_warnings(record=True) as syncs:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            run(2 * LAG + 1)
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        syncs = [w for w in syncs if "called a synchronizing CUDA operation" in str(w.message)]
        if syncs:
            fail(f"parallel world 1: {len(syncs)} host syncs, at "
                 + ", ".join(sorted({f"{w.filename}:{w.lineno}" for w in syncs})))
        cuda_nn.reset_launches()
        cuda_moments.reset_launches()
        cuda_tiles.reset_launches()
        with CollectiveCount() as coll:
            t0 = time.perf_counter()
            maps, ests, poses, count_w4 = run(N_SCANS)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = {"nn": cuda_nn.launches, "moments": cuda_moments.launches,
                    "tile_prepare": cuda_tiles.prepare_launches,
                    "tile_plan": cuda_tiles.plan_launches}
        poses_np = torch.stack(poses).cpu().numpy()
        final_err, ate = trajectory_errors(poses_np, gt)
        state = pipeline.init_state(PAR_CAPACITY, gt[0], device=dev)
        single = []
        t0 = time.perf_counter()
        for i in range(N_SCANS):
            state, _ = pipeline.mapper_step(state, scans[i], ests[i], cfg)
            single.append(state.pose)
        torch.cuda.synchronize()
        single_wall = time.perf_counter() - t0
        single = torch.stack(single).cpu().numpy()
        diff_t = float(np.linalg.norm(poses_np[:, :3, 3] - single[:, :3, 3], axis=-1).max())
        diff_r = float(np.abs(poses_np[:, :3, :3] - single[:, :3, :3]).max())
        # K1 and K2 at this path's shapes: the last scan at its refined pose
        # against the patch of the rank's table, and its voxels [1, 8192].
        _, match = pipeline._preprocess(scans[-1], cfg)
        _, grid = scan_processing.crop_submap_and_index(
            maps.cloud, poses[-1][:3, 3], 0.0, cfg.crop_max_radius, MAX_DIST,
            cfg.map_patch_capacity, build_hash=False)
        rows = [nn_shape_row(torch, "parallel world 1", match.transform(poses[-1]).xyz.contiguous(),
                             grid.points.contiguous(), MAX_DIST, launches["nn"])]
        blk = scan_processing.preprocess_scan(scans[-1], cfg.crop_min_radius,
                                              cfg.crop_max_radius, cfg.scan_voxel_size, 1.0,
                                              cfg.scan_capacity, estimate_scan_normals=False)
        rows.append(moments_shape_row(torch, "parallel world 1", blk.map(lambda t: t[None]),
                                      launches["moments"]))
        src, reg_grid, guess = parallel_register_inputs(torch, cfg, scans[PAR_REG_SCAN],
                                                        poses[PAR_REG_SCAN], maps)
        reg = sharded_icp.make_sharded_register(mesh, parallel_register_config())(
            src, reg_grid, guess)
        reg_err = float(torch.linalg.vector_norm(reg.transform[:3, 3]
                                                 - poses[PAR_REG_SCAN][:3, 3]))
        w1 = {"scans": [_cloud_arrays(s) for s in scans[:PAR_W4_SCANS]],
              "gt": [np.asarray(g, np.float32) for g in gt[:PAR_W4_SCANS]],
              "poses": poses_np[:PAR_W4_SCANS], "count": int(count_w4),
              "reg_src": _cloud_arrays(src),
              "reg_grid": tuple(t.cpu().numpy() for t in (
                  reg_grid.points, reg_grid.normals, reg_grid.points[:, 0].abs() < 1e7)),
              "reg_guess": guess.cpu().numpy(), "reg_T": reg.transform.cpu().numpy(),
              "reg_iterations": int(reg.iterations)}
    finally:
        dist.destroy_process_group()
    per_scan = {k: v / N_SCANS for k, v in coll.calls.items()}
    phase("parallel world 1 nccl", backend=backend, ranks=mesh.size, device=str(mesh.device),
          scans=N_SCANS, ms_per_scan=f"{wall / N_SCANS * 1e3:.3f}",
          mapper_step_ms_per_scan=f"{single_wall / N_SCANS * 1e3:.3f}",
          final_pose_err_cm=f"{final_err * 100:.4f}", ate_rmse_cm=f"{ate * 100:.4f}",
          max_diff_vs_mapper_step_mm=f"{diff_t * 1e3:.4f}",
          max_rot_diff_vs_mapper_step=f"{diff_r:.2e}", host_syncs=len(syncs),
          map_voxels=int(maps.count()), nn_launches=launches["nn"],
          moments_launches=launches["moments"],
          tile_prepare_launches=launches["tile_prepare"],
          tile_plan_launches=launches["tile_plan"],
          all_reduces_per_scan=f"{per_scan['all_reduce']:.2f}",
          all_reduce_bytes_per_scan=f"{coll.bytes['all_reduce'] / N_SCANS:.0f}",
          all_gathers=coll.calls["all_gather"], register_trips=int(reg.iterations),
          register_err_cm=f"{reg_err * 100:.4f}")
    if backend != "nccl" or mesh.device.type != "cuda":
        fail(f"parallel world 1: backend {backend} on {mesh.device}")
    if not np.isfinite(poses_np).all() or not final_err <= 0.02:
        fail(f"parallel world 1: final pose error {final_err * 100:.3f} cm > 2 cm")
    if not (diff_t <= 5e-3 and diff_r <= 2e-3):
        fail(f"parallel world 1: {diff_t * 1e3:.3f} mm and {diff_r:.2e} from mapper_step")
    if min(launches.values()) <= 0:
        fail(f"parallel world 1 did not launch every kernel: {launches}")
    if not reg_err <= 0.01:
        fail(f"parallel world 1: the data-parallel register ends {reg_err * 100:.2f} cm "
             "from the mapper's pose, from a guess 4 cm off")
    return rows, launches, w1


def parallel_graph():
    """A 24-node loop of radius 10 m with drifting odometry edges and one
    loop closure back to the first node: (node poses, constraint rows)."""
    from open3d_slam_advanced_rss_2024_public_tpu_torch.frontends import synthetic

    gt = synthetic.loop_trajectory(PAR_GRAPH_NODES, radius=10.0, center=(0.0, 0.0))
    est = synthetic.perturb_odometry(gt, drift_per_step=0.02, yaw_drift_per_step=0.004, seed=3)
    rows = [(i, i + 1, (np.linalg.inv(est[i].astype(np.float64)) @ est[i + 1])
             .astype(np.float32), np.eye(6, dtype=np.float32) * 100.0, True)
            for i in range(PAR_GRAPH_NODES - 1)]
    rows.append((PAR_GRAPH_NODES - 1, 0, (np.linalg.inv(gt[-1].astype(np.float64)) @ gt[0])
                 .astype(np.float32), np.eye(6, dtype=np.float32) * 100.0, False))
    return est, rows


def parallel_session_inputs(torch, dev):
    """``__graft_entry__.py``'s session (:166-181): a 16 m cluttered world,
    a loop of 24 poses of radius 4 m, scans of 1024 points within 14 m, the
    odometry's yaw biased by 0.025 rad a step."""
    from open3d_slam_advanced_rss_2024_public_tpu_torch.frontends import synthetic

    world = synthetic.cluttered_world(0, extent=16.0, n_objects=24, device=dev)
    gt = synthetic.loop_trajectory(PAR_SESSION_SCANS, radius=4.0, center=(6.0, 0.0), z=1.0)
    gen = torch.Generator(device=dev).manual_seed(5)
    scans = [_cloud_arrays(synthetic.render_scan(world, T, gen, n_points=PAR_SESSION_POINTS,
                                                 max_range=14.0, noise=0.004)) for T in gt]
    c, s = math.cos(0.025), math.sin(0.025)
    bias = np.array([[c, -s, 0, 0], [s, c, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]], np.float32)
    deltas = [((np.eye(4, dtype=np.float32) if i == 0 else
                (np.linalg.inv(gt[i - 1]) @ gt[i]).astype(np.float32)) @ bias)
              for i in range(PAR_SESSION_SCANS)]
    return gt, scans, deltas


def _parallel_rank(rank: int, store: str, directory: str) -> None:
    """One rank of ``parallel world 4``: the inputs' backend on the tensors
    of their device, every part of the phase in turn; the results go to
    rank<r>.pkl for the parent to check."""
    import os
    import pickle

    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    from open3d_slam_advanced_rss_2024_public_tpu_torch.ops import (_build, cuda_moments,
                                                                    cuda_nn, cuda_tiles,
                                                                    voxel_map)
    from open3d_slam_advanced_rss_2024_public_tpu_torch.ops.hashgrid import passthrough
    from open3d_slam_advanced_rss_2024_public_tpu_torch.models import pipeline
    from open3d_slam_advanced_rss_2024_public_tpu_torch.parallel import (
        distributed_pose_graph, sharded_icp, sharded_map, sharded_session, sharded_slam)
    from open3d_slam_advanced_rss_2024_public_tpu_torch.parallel import mesh as pmesh
    from open3d_slam_advanced_rss_2024_public_tpu_torch.models import pose_graph as pg

    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    torch.set_num_threads(1)
    directory = pathlib.Path(directory)
    inp = pickle.loads((directory / "inputs.pkl").read_bytes())
    dev = torch.device(inp["device"])
    if dev.type == "cuda":
        _build.build_all()  # loads the parent's libraries
    seconds = {}
    t_all = time.perf_counter()
    sharded_slam.init_distributed(store, PAR_RANKS, rank, device=dev, backend=inp["backend"],
                                  timeout=PAR_TIMEOUT_S)
    try:
        mesh = pmesh.make_mesh(PAR_RANKS, device=dev)
        out = {"backend": dist.get_backend(), "device": str(mesh.device)}
        # The mapper over the loop's first scans.
        t = time.perf_counter()
        cfg = parallel_config(inp["scan_points"], inp["patch"])
        empty, step = sharded_slam.make_sharded_mapper(mesh, cfg, inp["capacity"], PAR_BLOCK)
        gt = inp["gt"]
        maps, last, T = empty(), gt[0], torch.as_tensor(gt[0], device=dev)
        scans, poses = [_cloud_on(torch, a, dev) for a in inp["scans"]], []
        cuda_nn.reset_launches()
        cuda_moments.reset_launches()
        cuda_tiles.reset_launches()
        for i, scan in enumerate(scans):
            delta = np.eye(4) if i == 0 else np.linalg.inv(gt[i - 1]) @ gt[i]
            maps, T, _, last = step(maps, last, scan,
                                    T @ torch.as_tensor(delta, dtype=torch.float32, device=dev))
            poses.append(T)
        out["launches"] = {"nn": cuda_nn.launches, "moments": cuda_moments.launches,
                           "tile_prepare": cuda_tiles.prepare_launches,
                           "tile_plan": cuda_tiles.plan_launches}
        out["poses"] = torch.stack(poses).cpu().numpy()
        c = maps.cloud
        out["count"] = int(maps.count())
        out["own_blocks"] = bool((sharded_map.block_owner(c.xyz[c.mask], PAR_BLOCK, mesh.size)
                                  == mesh.rank).all())
        seconds["mapper"] = time.perf_counter() - t
        # The map operations: owner-partitioned insertion of one registered
        # scan (exactly the single table's voxels), and the cross-shard NN
        # against K1 over the gathered map.
        t = time.perf_counter()
        empty_maps, insert_fn, nn_fn, gather_fn = sharded_map.make_sharded_map_ops(
            mesh, inp["capacity"], cfg.map_voxel_size, PAR_BLOCK)
        wide, match = pipeline._preprocess(scans[-1], cfg)
        merged = wide.transform(T)
        one = insert_fn(empty_maps(), merged)
        out["insert_count"] = int(one.count())
        out["insert_count_single"] = int(voxel_map.insert(
            voxel_map.empty(PAR_RANKS * inp["capacity"], device=dev), merged,
            cfg.map_voxel_size).count())
        q = match.transform(T)
        xyz, _, d2, found = nn_fn(maps, q.xyz, q.mask, MAX_DIST)
        full = gather_fn(maps)
        _, d2_k1 = cuda_nn.nn(q.xyz, full.xyz, MAX_DIST)
        found_k1 = q.mask & (d2_k1 <= MAX_DIST ** 2)
        out["nn_found"] = (int(found.sum()), int(found_k1.sum()),
                           int((found != found_k1).sum()))
        both = found & found_k1
        out["nn_max_d2_diff"] = float((d2 - d2_k1)[both].abs().max()) if bool(both.any()) else 0.0
        out["gathered"] = int(full.mask.sum())
        seconds["map_ops"] = time.perf_counter() - t
        # The data-parallel register against world 1's.
        t = time.perf_counter()
        reg = sharded_icp.make_sharded_register(mesh, parallel_register_config())(
            _cloud_on(torch, inp["reg_src"], dev),
            passthrough(_cloud_on(torch, inp["reg_grid"], dev), MAX_DIST),
            torch.as_tensor(inp["reg_guess"], device=dev))
        out["reg_T"], out["reg_iterations"] = reg.transform.cpu().numpy(), int(reg.iterations)
        seconds["register"] = time.perf_counter() - t
        # The distributed solver on the 24-node loop.
        t = time.perf_counter()
        nodes, rows = inp["graph"]
        cs = [pg.Constraint(*r) for r in rows]
        graph = distributed_pose_graph.padded_arrays(nodes, cs, len(nodes), len(cs), device=dev)
        X, _ = distributed_pose_graph.make_distributed_solver(mesh, len(nodes), 30)(graph, 0, 2.0)
        out["solve_X"] = X.cpu().numpy()
        seconds["solve"] = time.perf_counter() - t
        # The whole session.
        t = time.perf_counter()
        s_gt, s_scans, s_deltas = inp["session"]
        res = sharded_session.run_sharded_slam_session(
            mesh, s_gt, [_cloud_on(torch, a, dev) for a in s_scans], s_deltas,
            scans_per_submap=6)
        out["session"] = {k: res[k] for k in ("n_submaps", "lc_found", "ate_before",
                                             "ate_after", "total_voxels", "comm")}
        seconds["session"] = time.perf_counter() - t
    finally:
        dist.destroy_process_group()
    seconds["total"] = time.perf_counter() - t_all
    out["seconds"] = seconds
    (directory / f"rank{rank}.pkl").write_bytes(pickle.dumps(out))


def parallel_world4(torch, dev, w1, scan_points: int = N_SCAN, patch: int = N_PATCH,
                    capacity: int = PAR_CAPACITY, backend: str = "gloo"):
    """Phase ``parallel world 4 gloo``: four processes on the one card, on
    the gloo backend over CUDA tensors (NCCL refuses two ranks on one
    card); with ``backend="nccl"`` on a four-card machine, one rank a card.
    Each rank runs: the mapper over the loop's first 20 scans (each
    pose within 5 mm of world 1's; the launch counts set to 0 just before
    and read just after, and every kernel launched on every rank); the map shards (every voxel of a rank
    in a block it owns, at least 3 ranks holding voxels, the ranks'
    occupied counts against world 1's table, and one registered scan
    inserted owner-partitioned into exactly the voxels of one table);
    ``sharded_map.nn_fn`` against K1 over the gathered map; the data-parallel
    register against world 1's; the distributed solver on a 24-node loop
    with one closure against ``pose_graph.solve``; and the whole session at
    ``__graft_entry__.py``'s size, which must close the loop and lower the
    ATE."""
    import pickle

    import torch.multiprocessing as mp

    from open3d_slam_advanced_rss_2024_public_tpu_torch.models import pose_graph as pg

    PAR_DIR.mkdir(parents=True, exist_ok=True)
    store = PAR_DIR / "store_w4"
    store.unlink(missing_ok=True)
    for old in PAR_DIR.glob("rank*.pkl"):
        old.unlink()
    graph = parallel_graph()
    inp = dict(w1, device=str(dev), backend=backend, scan_points=scan_points, patch=patch,
               capacity=capacity, graph=graph, session=parallel_session_inputs(torch, dev))
    (PAR_DIR / "inputs.pkl").write_bytes(pickle.dumps(inp))
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mp.start_processes(_parallel_rank, args=(f"file://{store}", str(PAR_DIR)),
                       nprocs=PAR_RANKS, join=True, start_method="spawn")
    wall = time.perf_counter() - t0
    outs = [pickle.loads((PAR_DIR / f"rank{r}.pkl").read_bytes()) for r in range(PAR_RANKS)]
    o = outs[0]
    pose_diff = max(float(np.linalg.norm(x["poses"][:, :3, 3] - w1["poses"][:, :3, 3],
                                         axis=-1).max()) for x in outs)
    rot_diff = max(float(np.abs(x["poses"][:, :3, :3] - w1["poses"][:, :3, :3]).max())
                   for x in outs)
    counts = [x["count"] for x in outs]
    launches = {k: [x["launches"][k] for x in outs] for k in o["launches"]}
    reg_t = float(np.linalg.norm(o["reg_T"][:3, 3] - w1["reg_T"][:3, 3]))
    reg_r = float(np.abs(o["reg_T"][:3, :3] - w1["reg_T"][:3, :3]).max())
    nodes, rows = graph
    X_host, _, _ = pg.solve(pg.build_arrays(nodes, [pg.Constraint(*r) for r in rows],
                                            len(nodes), len(rows), device=dev),
                            0, 2.0, 0.2, max_iterations=30)
    solve_diff = float(np.abs(o["solve_X"] - X_host.cpu().numpy()).max())
    sess = o["session"]
    phase(f"parallel world 4 {backend}", backend=o["backend"],
          devices=sorted({x["device"] for x in outs}), ranks=PAR_RANKS,
          scans=len(w1["poses"]), max_pose_diff_vs_world1_mm=f"{pose_diff * 1e3:.4f}",
          max_rot_diff_vs_world1=f"{rot_diff:.2e}", voxels_per_rank=counts,
          voxels_sum=sum(counts), voxels_world1=w1["count"],
          mapper_launches_per_rank=launches,
          insert_voxels=f"{sum(x['insert_count'] for x in outs)}/{o['insert_count_single']}",
          nn_found=o["nn_found"], nn_max_d2_diff=f"{o['nn_max_d2_diff']:.3g}",
          register_diff_mm=f"{reg_t * 1e3:.4f}", register_rot_diff=f"{reg_r:.2e}",
          register_trips=f"{o['reg_iterations']}/{w1['reg_iterations']}",
          solve_max_diff=f"{solve_diff:.3g}", session_submaps=sess["n_submaps"],
          session_lc_found=sess["lc_found"], session_ate_before_m=f"{sess['ate_before']:.4f}",
          session_ate_after_m=f"{sess['ate_after']:.4f}", session_comm=sess["comm"],
          seconds=f"{wall:.1f}",
          seconds_per_rank=[f"{x['seconds']['total']:.1f}" for x in outs],
          mapper_seconds_per_rank=[f"{x['seconds']['mapper']:.1f}" for x in outs],
          session_seconds_per_rank=[f"{x['seconds']['session']:.1f}" for x in outs])
    if any(x["backend"] != backend or not x["device"].startswith(dev.type) for x in outs):
        fail(f"parallel world 4: {[(x['backend'], x['device']) for x in outs]}")
    for x in outs[1:]:
        if not np.array_equal(x["poses"], o["poses"]) or not np.array_equal(x["solve_X"],
                                                                           o["solve_X"]):
            fail("parallel world 4: the ranks' poses or solutions differ")
    if not (pose_diff <= 5e-3 and rot_diff <= 2e-3):
        fail(f"parallel world 4: {pose_diff * 1e3:.3f} mm and {rot_diff:.2e} from world 1")
    if min(min(v) for v in launches.values()) <= 0:
        fail(f"parallel world 4: a rank's mapper did not launch every kernel: {launches}")
    if not all(x["own_blocks"] for x in outs) or sum(c > 0 for c in counts) < 3:
        fail(f"parallel world 4: voxels outside their blocks, or {counts} voxels per rank")
    # The shards hold world 1's map up to the voxels that the two worlds'
    # pose differences move across a voxel boundary.  The poses differ by
    # 0.34-0.48 mm on the card because the matchers see different patches:
    # world 1's 32768-point patch is cut from a table of ~36600 voxels,
    # each rank's holds its whole shard.  Gaps of up to 8 voxels were
    # measured; the bound is four times that.
    if not abs(sum(counts) - w1["count"]) <= PAR_VOXEL_GAP:
        fail(f"parallel world 4: {sum(counts)} voxels over the ranks, {w1['count']} in world 1")
    if sum(x["insert_count"] for x in outs) != o["insert_count_single"]:
        fail("parallel world 4: the owner-partitioned insert lost or doubled voxels")
    if o["nn_found"][2] > 0 or not o["nn_max_d2_diff"] <= 1e-5 or o["nn_found"][0] == 0:
        fail(f"parallel world 4: nn_fn against K1 over the gathered map: {o['nn_found']}, "
             f"d2 {o['nn_max_d2_diff']}")
    if not (reg_t <= 5e-3 and reg_r <= 2e-3):
        fail(f"parallel world 4: the register ends {reg_t * 1e3:.3f} mm from world 1's")
    if not solve_diff <= 1e-3:
        fail(f"parallel world 4: the distributed solve is {solve_diff} from pose_graph.solve")
    if not (sess["lc_found"] and sess["ate_after"] < sess["ate_before"]
            and sess["n_submaps"] >= 3):
        fail(f"parallel world 4: the session: {sess}")


def run_parallel_phases(torch, dev, scans, gt):
    """The multi-chip phases: world 1 on NCCL, then world 4 on NCCL with
    one rank a card where the machine has four cards, else on gloo with
    the four ranks sharing the card.  Returns world 1's (kernel rows,
    launches)."""
    seconds = {}
    t = time.perf_counter()
    rows, launches, w1 = parallel_world1(torch, dev, scans, gt)
    seconds["world1"] = f"{time.perf_counter() - t:.1f}"
    t = time.perf_counter()
    parallel_world4(torch, dev, w1,
                    backend="nccl" if torch.cuda.device_count() >= PAR_RANKS else "gloo")
    seconds["world4"] = f"{time.perf_counter() - t:.1f}"
    phase("parallel phases seconds", **seconds,
          total=f"{sum(float(v) for v in seconds.values()):.1f}")
    return rows, launches


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on the GPU")
    sys.path.insert(0, str(ROOT))
    from open3d_slam_advanced_rss_2024_public_tpu_torch.frontends import synthetic
    from open3d_slam_advanced_rss_2024_public_tpu_torch.models.mapper import Mapper
    from open3d_slam_advanced_rss_2024_public_tpu_torch.ops import (_build, cuda_moments,
                                                                    cuda_nn, cuda_tiles)
    from open3d_slam_advanced_rss_2024_public_tpu_torch.ops.registration import icp

    dev = torch.device("cuda")
    OUT.mkdir(exist_ok=True)

    # -- 1. device and build -------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    phase("build", seconds=f"{time.perf_counter() - t0:.2f}", torch=torch.__version__,
          cuda=torch.version.cuda, python=sys.version.split()[0])
    for name, report in _build.ptxas_report.items():
        for line in report.splitlines():
            if "Compiling" in line or "registers" in line or "spill" in line:
                phase(f"ptxas {name}", info=line.strip())

    world = synthetic.cluttered_world(0, extent=30.0, n_objects=40, device=dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    kernels = kernel_checks(torch, dev, gen, world)
    if "--kernels" in sys.argv[1:]:
        return

    # -- 4. the main path ---------------------------------------------------------
    gt = synthetic.loop_trajectory(N_SCANS, radius=9.0, center=(15.0, 0.0), z=1.2)
    scans = [synthetic.render_scan(world, gt[i], gen, n_points=N_SCAN, max_range=25.0,
                                   noise=0.004) for i in range(N_SCANS)]
    params = bench_params(LAG, N_SCAN, N_PATCH, 1 << 17)
    # Warm-up, with torch's sync debug mode on: the caller's thread only
    # dispatches, so no operation on the path may wait for the device.
    with warnings.catch_warnings(record=True) as syncs:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        run_loop(Mapper(params, device=dev), scans[:2 * LAG + 1], gt)
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    syncs = [w for w in syncs if "called a synchronizing CUDA operation" in str(w.message)]
    phase("host syncs on the path", scans=2 * LAG + 1, count=len(syncs))
    if syncs:
        fail(f"the main path synchronised with the device {len(syncs)} times, at "
             + ", ".join(sorted({f"{w.filename}:{w.lineno}" for w in syncs})))
    # ICP iterations per scan, as the JAX package's while loop would run
    # them (the port freezes the carry from convergence on, and stops
    # enqueuing trips once a polled done flag has landed).
    iterations = []
    register = icp.register

    def recording_register(*args, **kwargs):
        res = register(*args, **kwargs)
        iterations.append(res.iterations)
        return res
    icp.register = recording_register
    cuda_nn.reset_launches()
    cuda_moments.reset_launches()
    cuda_tiles.reset_launches()
    t0 = time.perf_counter()
    mapper = Mapper(params, device=dev)
    poses = run_loop(mapper, scans, gt)
    mapper.materialize()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    icp.register = register
    mean_iters = float(torch.stack(iterations).float().mean())
    launches = {"nn": cuda_nn.launches, "moments": cuda_moments.launches,
                "tile_prepare": cuda_tiles.prepare_launches,
                "tile_plan": cuda_tiles.plan_launches}
    if poses.shape != (N_SCANS, 4, 4) or not np.isfinite(poses).all():
        fail(f"main path: poses of shape {poses.shape}, finite={np.isfinite(poses).all()}")
    final_err, ate = trajectory_errors(poses, gt)
    cloud = mapper.get_assembled_map()
    n_vox = int(cloud.mask.sum())
    if not bool(torch.isfinite(cloud.xyz[cloud.mask]).all()) or n_vox == 0:
        fail("main path: the assembled map is empty or not finite")
    phase("main path", scans=N_SCANS, lag=LAG, ms_per_scan=f"{wall / N_SCANS * 1e3:.3f}",
          final_pose_err_cm=f"{final_err * 100:.4f}", ate_rmse_cm=f"{ate * 100:.4f}",
          map_voxels=n_vox, nn_launches=launches["nn"], moments_launches=launches["moments"],
          tile_prepare_launches=launches["tile_prepare"],
          tile_plan_launches=launches["tile_plan"],
          submaps=len(mapper.submaps.submaps), icp_registrations=len(iterations),
          icp_iterations_mean=f"{mean_iters:.3f}")
    if not final_err <= 0.02:
        fail(f"main path: final pose error {final_err * 100:.3f} cm > 2 cm")
    if min(launches.values()) <= 0:
        fail(f"main path did not launch every kernel: {launches}")

    # -- 5. kernel path against the twin path, small loop ---------------------
    small = bench_params(4, 2048, 4096, 1 << 14)
    s_scans = [synthetic.render_scan(world, gt[i], gen, n_points=2048, max_range=25.0,
                                     noise=0.004) for i in range(12)]
    p_gpu = run_loop(Mapper(small, device=dev), s_scans, gt[:12])
    p_cpu = run_loop(Mapper(small, device="cpu"), [s.to("cpu") for s in s_scans], gt[:12])
    twin_diff = float(np.abs(p_gpu[:, :3, 3] - p_cpu[:, :3, 3]).max())
    phase("kernel path vs twin path", scans=12, points=2048,
          max_pose_diff_mm=f"{twin_diff * 1e3:.4f}")
    # ICP over sparse scans amplifies rounding (index_add_ order) to the mm level.
    if not twin_diff <= 0.01:
        fail(f"kernel path and twin path differ by {twin_diff * 1e3:.2f} mm (> 10 mm)")

    # -- 6. where the time goes (profiled, after the counted run) -------------
    profile_main_path(torch, Mapper, params, scans[:3 * LAG + 1], gt)

    # -- 7. the SLAM runtime: loop closure, online workers, new shapes ---------
    slam, slam_launches, slam_run, last_solve = slam_loop(torch, dev, gen)
    new_rows = slam_shape_checks(torch, dev, slam, slam_launches, slam_run[0][-1])
    slam_online(torch, dev, gen)
    new_rows.append(slam_own_odometry(torch, dev, gen))
    slam_kernel_vs_twin(torch, dev)
    slam_closure_stages(torch, dev, slam, slam_run[3], *last_solve)
    pose_graph_solve(torch, dev, *last_solve)
    profile_slam_loop(torch, dev, *slam_run)

    # -- 8. the command-line path at the package defaults ----------------------
    kitti_gt = write_kitti_sequence(torch, dev)
    cli_slam, cli_launches, cli_counts = cli_kitti(torch, dev, kitti_gt)
    new_rows += cli_default_shapes(torch, dev, cli_slam, cli_counts, kitti_gt)
    cli_kitti_full_width(torch, dev, kitti_gt)
    cli_localization(torch, dev, kitti_gt)

    # -- 9. the libpointmatcher ICP chain (icp.yaml) ----------------------------
    seconds = {}

    def timed(key, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        seconds[key] = f"{time.perf_counter() - t:.1f}"
        return out
    cuda_nn.reset_launches()
    c, chain_launches, last_pair, full_scans = timed("production", chain_production, torch,
                                                     dev, kitti_gt)
    timed("sequence", chain_sequence, torch, dev, c, kitti_gt, full_scans)
    timed("filters", chain_filters, torch, dev, full_scans)
    timed("card_vs_cpu", chain_card_vs_cpu, torch, dev, c, kitti_gt)
    new_rows += timed("k1_rows", chain_kernel_rows, torch, c, last_pair, chain_launches)
    phase("chain phases seconds", **seconds,
          total=f"{sum(float(v) for v in seconds.values()):.1f}")

    # -- 10. the rosbag path: bag replay, deskewing, online, the viz bundle -----
    seconds = {}
    bag_odom = timed("write", rosbag_write, torch, dev, kitti_gt)
    bag_slam, bag_launches, bag_counts = timed("cli", cli_rosbag, torch, dev, kitti_gt, bag_odom)
    new_rows += timed("k1_k2_rows", bag_kernel_rows, torch, dev, bag_slam, bag_counts)
    timed("undistort", undistort_t_channel, torch, dev, kitti_gt)
    timed("online", online_bag, torch, dev, kitti_gt, bag_odom)
    timed("viz", viz_bundle, torch, dev)
    phase("rosbag phases seconds", **seconds,
          total=f"{sum(float(v) for v in seconds.values()):.1f}")

    # -- 11. the multi-chip path: parallel/ on torch.distributed ----------------
    par_rows, par_launches = run_parallel_phases(torch, dev, scans, gt)
    new_rows += par_rows

    for row in kernels:
        row["launches"] = launches[row["name"]]
        row["launches_slam_loop"] = slam_launches[row["name"]]
        row["launches_cli_kitti"] = cli_launches[row["name"]]
        row["launches_cli_rosbag"] = bag_launches[row["name"]]
        row["launches_parallel"] = par_launches[row["name"]]
    kernels += new_rows
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


def _step_along_x(d: float) -> np.ndarray:
    """A sensor displacement of ``d`` m (a block of nearby scans)."""
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = [d, 0.3 * d, 0.0]
    return T


def profile_main_path(torch, Mapper, params, scans, gt) -> None:
    """Device time by kernel and the device's busy share over a short run of
    the main path; the whole table goes to build/chip_smoke_profile.tsv."""
    mapper = Mapper(params, device="cuda")
    profile_run(torch, "profile", lambda: run_loop(mapper, scans, gt[:len(scans)]),
                len(scans), "chip_smoke_profile.tsv")


SLAM_TRACE_FROM = 32


def profile_slam_loop(torch, dev, scans, odom, gt, params) -> None:
    """The same for the SLAM runtime's loop-closure run: the first 32 scans
    run untraced, the closing third of the loop (where the closures, the
    solves and the feedback happen) and ``finish_processing`` under the
    profiler; table in build/chip_smoke_profile_slam.tsv."""
    from open3d_slam_advanced_rss_2024_public_tpu_torch.models.slam import SlamWrapper

    slam = SlamWrapper(params, device=dev)
    slam.set_initial_transform(gt[0])
    for i in range(SLAM_TRACE_FROM):
        slam.use_pair_for_registration(scans[i], odom[i], 0.1 * i)
    before = slam.loop_closure_count

    def closing_third():
        for i in range(SLAM_TRACE_FROM, len(scans)):
            slam.use_pair_for_registration(scans[i], odom[i], 0.1 * i)
        slam.finish_processing()
    profile_run(torch, "profile slam", closing_third, len(scans) - SLAM_TRACE_FROM,
                "chip_smoke_profile_slam.tsv")
    phase("profile slam run", scans=f"{SLAM_TRACE_FROM}..{len(scans) - 1}",
          submaps=len(slam.mapper.submaps.submaps), closures_before=before,
          closures_traced=slam.loop_closure_count - before)
    if slam.loop_closure_count - before < 1:
        fail("profile slam: the traced part of the loop holds no loop closure")


def trace_device_ops(torch, run):
    """``run`` under the profiler: {kernel or copy name: (calls, device us)}
    from the trace, and the host's wall time in us."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    trace = OUT / "chip_smoke_trace.json"
    prof.export_chrome_trace(str(trace))
    by_name: dict = {}
    for ev in json.loads(trace.read_text()).get("traceEvents", []):
        if ev.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            calls, us = by_name.get(ev["name"], (0, 0.0))
            by_name[ev["name"]] = (calls + 1, us + float(ev.get("dur", 0.0)))
    trace.unlink()
    return by_name, wall_us


def profile_run(torch, label: str, run, n_scans: int, tsv_name: str) -> None:
    """Device time by kernel and the device's busy share over ``run``, from
    the profiler's trace; the whole table (device us, calls, kernel) goes to
    build/<tsv_name>."""
    by_name, wall_us = trace_device_ops(torch, run)
    busy = sum(us for _, us in by_name.values())
    if busy <= 0.0:
        fail(f"{label}: the trace holds no device activity")
    n_ops = sum(c for c, _ in by_name.values())
    phase(label, scans=n_scans, wall_ms=f"{wall_us / 1e3:.1f}",
          device_busy_ms=f"{busy / 1e3:.1f}", busy_share=f"{busy / wall_us:.3f}",
          device_ops=n_ops, device_ops_per_scan=f"{n_ops / n_scans:.0f}")
    for kernel_label, kernel_names in (("K1", ("nn_sweep_kernel",)),
                                       ("K2", ("moments_sweep_kernel",)),
                                       ("tiles", ("tile_plan_kernel", "tile_prepare_kernel"))):
        hits = [(c, us) for name, (c, us) in by_name.items()
                if any(k in name for k in kernel_names)]
        phase(f"{label} {kernel_label}", launches=sum(c for c, _ in hits),
              device_ms=f"{sum(us for _, us in hits) / 1e3:.3f}",
              share=f"{sum(us for _, us in hits) / busy:.3f}")
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    (OUT / tsv_name).write_text("".join(
        f"{us:.1f}\t{calls}\t{name}\n" for name, (calls, us) in ranked))
    for name, (calls, us) in ranked[:10]:
        phase(f"{label} top", kernel=name[:70].replace(" ", "_"), calls=calls,
              device_ms=f"{us / 1e3:.3f}", share=f"{us / busy:.3f}")


if __name__ == "__main__":
    main()
