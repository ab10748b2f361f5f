"""Scan preprocessing for matching + merging.

Counterpart of the JAX package's ``models/scan_processing.py`` (reference
ScanToMapRegistration.cpp:36-96): wide crop -> Morton voxel downsample ->
PCA normals (kernel K2, or kNN) -> narrow crop, and the per-block map-patch
crop that builds the ICP reference.  Every function takes a leading batch
dimension: the JAX package ``vmap``s preprocessing over the K scans of a
lag block, so that K2 runs once per block at [K, N].
"""
from __future__ import annotations

import torch

from ..ops import croppers, filters, hashgrid, normals
from ..utils.pointcloud import PointCloud, compact

Tensor = torch.Tensor


def resolve_normal_engine(name: str) -> str:
    """"auto" -> the radius-moments engine (kernel K2) on every device.
    The JAX package sends CPU and GPU to kNN normals; the port's "auto"
    resolves to its hand-written kernel instead (its plain twin on CPU
    tensors), and "knn" selects the kNN engine."""
    if name in ("auto", "moments", "moments_interpret"):
        return "moments"
    if name == "knn":
        return "knn"
    raise ValueError(f"unknown normal engine: {name!r}")


def preprocess_scan(scan: PointCloud, wide_min_radius: float, wide_max_radius: float,
                    voxel_size: float, downsampling_ratio: float, capacity: int,
                    estimate_scan_normals: bool = True, normal_radius: float = 0.5,
                    normal_knn: int = 10, seed: int = 0,
                    normal_engine: str = "auto") -> PointCloud:
    """Wide crop -> voxel downsample (Morton order) -> normals -> random
    downsample.  ≙ ScanToMapIcp::preprocess (ScanToMapRegistration.cpp:36-45).
    The random stage draws from a host generator seeded with ``seed``, the
    same draws for every scan and replay (the reference's reproducibility
    note, :43-44), and the same on the card and the CPU."""
    engine = resolve_normal_engine(normal_engine)
    scan = filters.remove_non_finite(scan)
    wide = croppers.min_max_radius_cropper(wide_min_radius, wide_max_radius)
    scan = scan.with_mask(wide.contains(scan.xyz))
    out = filters.voxel_downsample(scan, voxel_size, capacity, order="morton")
    if estimate_scan_normals and engine == "moments":
        out = normals.estimate_normals_radius(out, radius=normal_radius)
    elif estimate_scan_normals:
        out = normals.estimate_normals(out, radius=normal_radius, k=normal_knn)
    if downsampling_ratio < 1.0:
        out = filters.random_sampling(out, filters.uniform(seed, out.capacity, out.device),
                                      downsampling_ratio)
    return out


def narrow_crop(cloud: PointCloud, min_radius, max_radius) -> PointCloud:
    """Scan-matcher crop of the preprocessed scan (identity pose)."""
    return cloud.with_mask(croppers.min_max_radius_cropper(min_radius, max_radius)
                           .contains(cloud.xyz))


def crop_submap_and_index(map_cloud: PointCloud, robot_position: Tensor,
                          min_radius, max_radius, match_dist, capacity: int,
                          table_size: int = 1 << 15, build_hash: bool = True):
    """Crop the active submap around the robot and build the matcher grid
    (≙ ScanToMapIcp::cropSubmap, ScanToMapRegistration.cpp:90-96, and
    ICP::initReference's matcher build, ICP.cpp:291-326): the hashed grid
    for the hashed matcher (``build_hash``), else the Morton-sorted patch,
    on which the NN kernel's tiles stay spatially tight."""
    rel = torch.where(map_cloud.mask[:, None], map_cloud.xyz - robot_position, 0.0)
    r = torch.sqrt((rel[:, 0] * rel[:, 0] + rel[:, 1] * rel[:, 1]) + rel[:, 2] * rel[:, 2])
    patch = compact(map_cloud.with_mask((r >= min_radius) & (r <= max_radius)), capacity)
    if build_hash:
        return patch, hashgrid.build(patch, match_dist, table_size=table_size)
    return patch, hashgrid.passthrough(hashgrid.morton_sort(patch, match_dist), match_dist)
