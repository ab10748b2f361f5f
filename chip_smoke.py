#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``open3d_slam_advanced_rss_2024_public_tpu_torch/csrc``
(``nvcc``, at first use), holds each kernel (the two tile-planning kernels, K1
and K2) against its plain PyTorch twin at the shapes of the main path, then
drives the main path — ``Mapper.add_range_measurement``
over the 100-scan synthetic loop with ``bench.py``'s parameters (8192-point scans,
a 32768-point map patch, a 2^18-slot voxel table, lag-8 blocks) — and checks the
trajectory against ground truth.  Every phase prints one line; any failure
ends the run with a non-zero exit.  The second-to-last line is a JSON object
with each kernel's launches on the main path, error against its twin, times and
bound (``bound_ms`` counts the candidate pairs this run's kernels swept;
``jax_tiling_bound_ms`` beside it the pairs of the JAX kernels' coarser tiling,
the figure earlier runs reported; ``ms`` is the device time of the kernels one call enqueues, replayed from
a CUDA graph so that no host gap is counted; ``wrapper_ms`` the whole wrapper as
the main path calls it, host dispatch included); the last line is
``{"ok": true, "device": {...}}``.  ``python3 chip_smoke.py --kernels`` stops
after the kernel checks.

Needs a CUDA device: without one it exits non-zero and prints no result.  It
imports nothing of the JAX package.
"""
from __future__ import annotations

import json
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


def check_nn(torch, cuda_nn, q, r, label, prepared=False):
    """K1 against its twin on queries and refs that may hold sentinel
    lanes: for every valid query whose NN is within MAX_DIST, the same
    index except on an exact distance tie, a valid ref, and identical d2.
    Returns (max |d2 error|, share of identical indices)."""
    ki, kd2 = cuda_nn.nn(q, cuda_nn.prepare_ref(r) if prepared else r, MAX_DIST)
    pi, pd2 = cuda_nn.nn_plain(q, r, MAX_DIST)
    torch.cuda.synchronize()
    if ki.dtype != torch.int64 or kd2.dtype != torch.float32 or ki.shape != pi.shape:
        fail(f"K1 {label}: returned {ki.dtype}{tuple(ki.shape)}, {kd2.dtype}")
    q_valid = q[:, 0].abs() < 1e7
    within = q_valid & (pd2 <= MAX_DIST ** 2)
    if int(within.sum()) < int(q_valid.sum()) // 2:
        fail(f"K1 {label}: only {int(within.sum())} of {int(q_valid.sum())} valid "
             "queries have a NN in range")
    same = (ki == pi) | (kd2 == pd2)
    if not bool(same[within].all()):
        fail(f"K1 {label}: {int((~same & within).sum())} indices differ from the twin")
    if not bool((r[ki[within], 0].abs() < 1e7).all()):
        fail(f"K1 {label}: a query within range matched a sentinel ref")
    if bool((kd2[~q_valid] <= MAX_DIST ** 2).any()):
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
    (center2, prep2, _, k_count2), p_count2, _, prep_err2, plan_err2 = check_tiles(
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
    # The bound counts the pairs that the sweep evaluates on these inputs:
    # its own admissible tile pairs, as the plan kernel listed them.
    pairs = float(k_count.sum()) * cuda_tiles.TQ * cuda_tiles.TP
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
          swept_pairs=f"{pairs:.0f}", jax_tiling_pairs=f"{jax_pairs:.0f}",
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
    pairs2 = float(k_count2.sum()) * cuda_tiles.TQ * cuda_tiles.TP
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
          mean_count=f"{admitted / float(m.sum()):.2f}", swept_pairs=f"{pairs2:.0f}",
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
    # them (the port runs max_iterations trips and freezes the carry after).
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

    for row in kernels:
        row["launches"] = launches[row["name"]]
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
    the main path, from the profiler's trace; the whole table goes to
    build/chip_smoke_profile.tsv (device us, calls, kernel)."""
    from torch.profiler import ProfilerActivity, profile

    mapper = Mapper(params, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_loop(mapper, scans, gt[:len(scans)])
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
    busy = sum(us for _, us in by_name.values())
    if busy <= 0.0:
        fail("profile: the trace holds no device activity")
    n_ops = sum(c for c, _ in by_name.values())
    phase("profile", scans=len(scans), wall_ms=f"{wall_us / 1e3:.1f}",
          device_busy_ms=f"{busy / 1e3:.1f}", busy_share=f"{busy / wall_us:.3f}",
          device_ops=n_ops, device_ops_per_scan=f"{n_ops / len(scans):.0f}")
    for label, kernel_names in (("K1", ("nn_sweep_kernel",)), ("K2", ("moments_sweep_kernel",)),
                                ("tiles", ("tile_plan_kernel", "tile_prepare_kernel"))):
        hits = [(c, us) for name, (c, us) in by_name.items()
                if any(k in name for k in kernel_names)]
        phase(f"profile {label}", launches=sum(c for c, _ in hits),
              device_ms=f"{sum(us for _, us in hits) / 1e3:.3f}",
              share=f"{sum(us for _, us in hits) / busy:.3f}")
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    (OUT / "chip_smoke_profile.tsv").write_text("".join(
        f"{us:.1f}\t{calls}\t{name}\n" for name, (calls, us) in ranked))
    for name, (calls, us) in ranked[:10]:
        phase("profile top", kernel=name[:70].replace(" ", "_"), calls=calls,
              device_ms=f"{us / 1e3:.3f}", share=f"{us / busy:.3f}")


if __name__ == "__main__":
    main()
