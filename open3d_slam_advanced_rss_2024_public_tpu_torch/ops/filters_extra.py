"""The rest of libpointmatcher's DataPointsFilters as masked tensor transforms.

Counterpart of the JAX package's ``ops/filters_extra.py`` (reference
pointmatcher/Registry.cpp:67-95 and pointmatcher/DataPointsFilters/*.cpp):
shadow, max-quantile-on-axis, max-density, fix-step, observation direction,
orient normals, incidence angle, simple sensor noise, normal-space and
covariance sampling, sampling surface normal, octree grid, hidden point
removal, cut-at-descriptor, remove sensor bias, elipsoids and gestalt.
Removal is masking, as in ``ops/filters.py``; the fixed capacity stays.

Differences from the JAX package, each on purpose:
  - the random filters take their uniform draws ``u`` as an argument
    (``filters.uniform`` draws them on the host from a seeded generator);
  - the 3 x 3 eigensystems of elipsoids and gestalt are ``normals.eigh_3x3``
    (fixed Jacobi sweeps, eigenvectors signed by their largest component)
    where JAX calls ``jnp.linalg.eigh``, and covariance sampling inverts with
    ``torch.linalg.inv_ex``: the checked CUDA routines read ``info`` back;
  - ``jnp.lexsort`` becomes stable sorts, least significant key first, and
    every ``argsort`` is stable, as ``jnp.argsort`` is.
Nothing here reads a tensor back to the host.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..utils.device import to_device
from ..utils.pointcloud import PointCloud
from . import bruteforce, filters, hashgrid, normals
from .filters import norm3

Tensor = torch.Tensor


def _const(values, like: Tensor) -> Tensor:
    """A host sequence as an f32 tensor on ``like``'s device, through a
    pinned copy (no stream synchronisation)."""
    return to_device(values, like.device)


def _has_normal(cloud: PointCloud) -> Tensor:
    return norm3(cloud.normals) > 1e-6


def _scatter_keep(order: Tensor, keep_sorted: Tensor) -> Tensor:
    """keep[order[i]] = keep_sorted[i]."""
    return torch.zeros_like(keep_sorted).scatter(0, order, keep_sorted)


def shadow_filter(cloud: PointCloud, eps: float = 0.1) -> PointCloud:
    """Drop shadow points, whose normal is almost orthogonal to the viewing
    ray (≙ ShadowDataPointsFilter: eps = least |cos| kept)."""
    ray = cloud.xyz / torch.clamp(norm3(cloud.xyz), min=1e-9)[..., None]
    cosang = (cloud.normals * ray).sum(-1).abs()
    return cloud.with_mask(torch.where(_has_normal(cloud), cosang > eps, True))


def max_quantile_on_axis(cloud: PointCloud, ratio: float = 0.5, axis: int = 0) -> PointCloud:
    """Keep the points below the ``ratio`` quantile along an axis
    (≙ MaxQuantileOnAxisDataPointsFilter)."""
    vals = torch.where(cloud.mask, cloud.xyz[:, axis], math.inf)
    sorted_vals = torch.sort(vals).values
    n_valid = cloud.mask.sum(dtype=torch.int32).to(torch.float32)
    kth = torch.clamp((ratio * n_valid).to(torch.int64), 0, cloud.capacity - 1)
    thresh = sorted_vals.gather(0, kth[None])
    return cloud.with_mask(cloud.xyz[:, axis] <= thresh)


def max_density(cloud: PointCloud, u: Tensor, max_density_pts_per_m3: float = 100.0,
                radius: float = 0.5, k: int = 16) -> PointCloud:
    """Thin regions denser than the target density at random: a point stays
    with probability target / local density (≙ MaxDensityDataPointsFilter)."""
    _, _, ok = bruteforce.knn(cloud.xyz, cloud.mask, cloud.xyz, radius, k=k)
    density = ok.sum(-1).to(torch.float32) / (4.0 / 3.0 * math.pi * radius ** 3)
    p_keep = torch.clamp(max_density_pts_per_m3 / torch.clamp(density, min=1e-9), 0.0, 1.0)
    return cloud.with_mask(u < p_keep)


def fix_step_sampling(cloud: PointCloud, step: int = 2) -> PointCloud:
    """Keep every ``step``-th valid point (≙ FixStepSamplingDataPointsFilter)."""
    valid_rank = torch.cumsum(cloud.mask.to(torch.int32), 0) - 1
    return cloud.with_mask(valid_rank % step == 0)


def observation_direction(cloud: PointCloud, sensor=(0.0, 0.0, 0.0)) -> Tensor:
    """Unit vectors from the points toward the sensor, f32[N, 3]
    (≙ ObservationDirectionDataPointsFilter's descriptor)."""
    v = _const(sensor, cloud.xyz) - cloud.xyz
    v = v / torch.clamp(norm3(v), min=1e-9)[..., None]
    return torch.where(cloud.mask[:, None], v, 0.0)


def orient_normals(cloud: PointCloud, sensor=(0.0, 0.0, 0.0),
                   toward_sensor: bool = True) -> PointCloud:
    """Flip normals to face toward (or away from) the sensor
    (≙ OrientNormalsDataPointsFilter)."""
    dot = (cloud.normals * observation_direction(cloud, sensor)).sum(-1, keepdim=True)
    flip = (dot if toward_sensor else -dot) < 0
    return cloud.with_normals(torch.where(flip, -cloud.normals, cloud.normals))


def with_observation_direction(cloud: PointCloud, sensor=(0.0, 0.0, 0.0)) -> PointCloud:
    """The point -> sensor unit direction as descriptor channels
    ``observationDirections_{x,y,z}``; geometry unchanged."""
    d = observation_direction(cloud, sensor)
    for i, ax in enumerate("xyz"):
        cloud = cloud.with_attr(f"observationDirections_{ax}", d[:, i])
    return cloud


def incidence_angle(cloud: PointCloud, sensor=(0.0, 0.0, 0.0)) -> Tensor:
    """Angle between the viewing ray and the normal, f32[N]
    (≙ IncidenceAngleDataPointsFilter's descriptor)."""
    dot = (cloud.normals * observation_direction(cloud, sensor)).sum(-1)
    ang = torch.where(_has_normal(cloud), torch.arccos(torch.clamp(dot.abs(), 0.0, 1.0)), 0.0)
    return torch.where(cloud.mask, ang, 0.0)


def with_incidence_angle(cloud: PointCloud, sensor=(0.0, 0.0, 0.0)) -> PointCloud:
    """The ``incidenceAngles`` channel (≙ IncidenceAngle.cpp)."""
    return cloud.with_attr("incidenceAngles", incidence_angle(cloud, sensor))


def simple_sensor_noise(cloud: PointCloud, sensor_type: str = "lms",
                        gain: float = 1.0) -> Tensor:
    """Expected range-noise sigma a point, f32[N]
    (≙ SimpleSensorNoiseDataPointsFilter's distance-proportional models)."""
    r = norm3(torch.where(cloud.mask[:, None], cloud.xyz, 0.0))
    if sensor_type == "lms":
        sigma = 0.012 + 0.0019 * r
    elif sensor_type == "hdl":
        sigma = 0.02 + 0.0 * r
    else:
        sigma = 0.01 + 0.001 * r
    return torch.where(cloud.mask, gain * sigma, 0.0)


def with_simple_sensor_noise(cloud: PointCloud, sensor_type: str = "lms",
                             gain: float = 1.0) -> PointCloud:
    """The ``simpleSensorNoise`` sigma channel (≙ SimpleSensorNoise.cpp)."""
    return cloud.with_attr("simpleSensorNoise", simple_sensor_noise(cloud, sensor_type, gain))


def _rank_in_run(sorted_keys: Tensor) -> Tensor:
    """Position of each lane within its run of equal consecutive keys."""
    n = sorted_keys.shape[0]
    lane = torch.arange(n, device=sorted_keys.device)
    new = sorted_keys != torch.roll(sorted_keys, 1)
    new[0].fill_(True)
    return lane - torch.cummax(torch.where(new, lane, 0), 0).values


def normal_space_sampling(cloud: PointCloud, u: Tensor, target: int,
                          n_bins: int = 26) -> PointCloud:
    """Subsample evenly over normal directions so that flat regions do not
    dominate the constraint set (≙ NormalSpaceDataPointsFilter): azimuth x
    elevation bins, a per-bin quota of target / bins, random order within a
    bin."""
    n = cloud.normals
    az = torch.atan2(n[:, 1], n[:, 0])
    el = torch.arcsin(torch.clamp(n[:, 2], -1.0, 1.0))
    na = int(math.sqrt(n_bins))
    az_bin = torch.clamp(((az + math.pi) / (2 * math.pi) * na).to(torch.int32), 0, na - 1)
    el_bin = torch.clamp(((el + math.pi / 2) / math.pi * na).to(torch.int32), 0, na - 1)
    bin_id = az_bin * na + el_bin
    valid = cloud.mask & _has_normal(cloud)
    order = torch.argsort(torch.where(valid, bin_id.to(torch.float32) + u * 0.999, math.inf),
                          stable=True)
    keep = _scatter_keep(order, _rank_in_run(bin_id[order]) < max(target // (na * na), 1))
    return cloud.with_mask(valid & keep)


def covariance_sampling(cloud: PointCloud, target: int) -> PointCloud:
    """Keep the ``target`` points of largest leverage on the 6-DOF
    constraint matrix (torque and force rows; a greedy-score form of
    CovarianceSamplingDataPointsFilter)."""
    g = torch.cat([torch.linalg.cross(cloud.xyz, cloud.normals), cloud.normals], dim=-1)
    gm = torch.where(cloud.mask[:, None], g, 0.0)
    A = gm.T @ gm
    A_inv = torch.linalg.inv_ex(A + 1e-3 * torch.eye(6, dtype=A.dtype, device=A.device)).inverse
    leverage = ((g @ A_inv) * g).sum(-1)
    order = torch.argsort(-torch.where(cloud.mask, leverage, -math.inf), stable=True)
    return cloud.with_mask(torch.zeros_like(cloud.mask).scatter(0, order[:target], True))


def sampling_surface_normal(cloud: PointCloud, u: Tensor, ratio: float = 0.5,
                            knn: int = 7, radius: float = 0.5) -> PointCloud:
    """Random subsample, then local PCA normals on the kept set
    (≙ SamplingSurfaceNormalDataPointsFilter)."""
    return normals.estimate_normals(filters.random_sampling(cloud, u, ratio),
                                    radius=radius, k=knn)


def _first_per_voxel(kx: Tensor, ky: Tensor, kz: Tensor):
    """(order, is_first): the lanes sorted by (kx, ky, kz, lane), as
    ``jnp.lexsort((lane, kz, ky, kx))`` sorts them, and whether each sorted
    lane opens its voxel."""
    order = torch.arange(kx.shape[0], device=kx.device)
    for key in (kz, ky, kx):
        order = order[torch.argsort(key[order], stable=True)]
    sk = torch.stack([kx, ky, kz], dim=-1)[order]
    is_first = torch.cat([torch.ones_like(order[:1], dtype=torch.bool),
                          (sk[1:] != sk[:-1]).any(dim=-1)])
    return order, is_first


def octree_grid(cloud: PointCloud, max_size_by_node: float = 0.2,
                sample_mode: int = 0) -> PointCloud:
    """One representative a leaf of an octree whose leaves are at most
    ``max_size_by_node`` (≙ OctreeGridDataPointsFilter): the terminal level
    is a uniform voxel grid.  sample_mode 0/1: the first point of each leaf
    (mask only); 2/3: the leaf centroid (voxel averaging)."""
    if sample_mode >= 2:
        return filters.voxel_downsample(cloud, max_size_by_node, cloud.capacity, order="lex")
    key3 = hashgrid.voxel_key(cloud.xyz, max_size_by_node)
    kx = torch.where(cloud.mask, key3[:, 0], 2 ** 31 - 1)
    order, is_first = _first_per_voxel(kx, key3[:, 1], key3[:, 2])
    return cloud.with_mask(_scatter_keep(order, is_first))


def hidden_point_removal(cloud: PointCloud, sensor=(0.0, 0.0, 0.0),
                         radius_scale: float = 100.0, n_azimuth: int = 256,
                         n_elevation: int = 64) -> PointCloud:
    """Keep the points visible from the sensor (≙
    HiddenPointRemovalDataPointsFilter): view directions binned into an
    azimuth x elevation grid, the closest point of each bin kept (within
    1e-4 relative).  ``radius_scale`` is accepted for configuration
    compatibility, as in the JAX package."""
    del radius_scale
    rel = cloud.xyz - _const(sensor, cloud.xyz)
    rng = norm3(rel)
    az = torch.atan2(rel[:, 1], rel[:, 0])
    el = torch.arcsin(torch.clamp(rel[:, 2] / torch.clamp(rng, min=1e-9), -1.0, 1.0))
    ia = torch.clamp(((az + math.pi) / (2 * math.pi) * n_azimuth).to(torch.int64),
                     0, n_azimuth - 1)
    ie = torch.clamp(((el + math.pi / 2) / math.pi * n_elevation).to(torch.int64),
                     0, n_elevation - 1)
    bin_id = ie * n_azimuth + ia
    big = 3.0e38
    bin_min = torch.full((n_azimuth * n_elevation,), big, dtype=torch.float32,
                         device=rng.device).scatter_reduce(
        0, torch.where(cloud.mask, bin_id, 0), torch.where(cloud.mask, rng, big), "amin")
    return cloud.with_mask(rng <= bin_min[bin_id] * 1.0001)


def cut_at_descriptor_threshold(cloud: PointCloud, descriptor="incidenceAngles",
                                threshold: float = 0.5, use_larger_than: bool = True,
                                sensor=(0.0, 0.0, 0.0)) -> PointCloud:
    """Mask points by a per-point descriptor threshold (≙
    CutAtDescriptorThresholdDataPointsFilter): ``descriptor`` is
    "incidenceAngles", "ranges" or an f32[N] tensor; ``use_larger_than``
    cuts the points above the threshold."""
    if isinstance(descriptor, str):
        if descriptor == "incidenceAngles":
            desc = incidence_angle(cloud, sensor)
        elif descriptor == "ranges":
            desc = torch.where(cloud.mask, norm3(cloud.xyz), 0.0)
        else:
            raise ValueError(f"unknown descriptor name: {descriptor}")
    else:
        desc = descriptor
    return cloud.with_mask(desc <= threshold if use_larger_than else desc >= threshold)


def remove_sensor_bias(cloud: PointCloud, sensor=(0.0, 0.0, 0.0),
                       angle_threshold: float = 0.785) -> PointCloud:
    """Drop points whose incidence angle is too grazing for a reliable range
    (≙ RemoveSensorBiasDataPointsFilter's rejection stage; the
    sensor-specific bias correction is left out, as in the JAX package)."""
    keep = incidence_angle(cloud, sensor) <= angle_threshold
    return cloud.with_mask(torch.where(_has_normal(cloud), keep, True))


# ---------------------------------------------------------------------------
# Surfel-decomposition descriptors: Elipsoids and Gestalt.
# ---------------------------------------------------------------------------

def _segment_surfels(xyz: Tensor, mask: Tensor, knn: int):
    """Morton-sort the cloud and group ``knn`` consecutive points into a
    segment (the JAX package's fixed-shape stand-in for the reference's
    recursive median split, Elipsoids.cpp:237-282).  Returns (order, n,
    mean, cov, box_dim, max_r2, S) with S = ceil(N / knn) segments over the
    sorted lanes."""
    N = xyz.shape[0]
    order = torch.argsort(hashgrid.morton_code(xyz, mask, 0.25), stable=True)
    S = -(-N // knn)
    pad = S * knn - N
    xs = torch.nn.functional.pad(xyz[order], (0, 0, 0, pad)).reshape(S, knn, 3)
    ms = torch.nn.functional.pad(mask[order], (0, pad)).reshape(S, knn)
    w = ms.to(torch.float32)
    n = w.sum(1)
    mean = (xs * w[..., None]).sum(1) / torch.clamp(n, min=1.0)[:, None]
    ctr = torch.where(ms[..., None], xs - mean[:, None, :], 0.0)
    cov = torch.einsum("ski,skj->sij", ctr, ctr)
    big = 3.0e38
    lo = torch.where(ms[..., None], xs, big).amin(1)
    hi = torch.where(ms[..., None], xs, -big).amax(1)
    box_dim = torch.where(n[:, None] > 0, hi - lo, 0.0).amax(-1)
    max_r2 = torch.where(ms, (ctr * ctr).sum(-1), 0.0).amax(1)
    return order, n, mean, cov, box_dim, max_r2, S


def elipsoids(cloud: PointCloud, u: Tensor, ratio: float = 0.5, knn: int = 7,
              sampling_method: int = 0, max_box_dim: float = math.inf,
              min_planarity: float = 0.0, keep_normals: bool = True,
              keep_densities: bool = False, keep_eigen_values: bool = False,
              keep_eigen_vectors: bool = False, keep_covariances: bool = False,
              keep_weights: bool = False, keep_means: bool = False,
              keep_shapes: bool = False,
              average_existing_descriptors: bool = True) -> PointCloud:
    """Subsampling surfels (≙ ElipsoidsDataPointsFilter, Elipsoids.cpp:236-501):
    boxes of ``knn`` Morton-consecutive points, each box's mean and scatter
    eigensystem (normal = smallest eigenvector; eigenvalues ascending, the
    shape descriptors from the descending normalised ones); then either the
    original points kept at random with probability ``ratio`` (``u``: one
    draw a sorted lane; samplingMethod 0) or one point a box at its mean
    (samplingMethod 1).  Boxes of fewer than 3 points, larger than
    ``max_box_dim`` or flatter than ``min_planarity`` are dropped.  The
    output lanes are in Morton order."""
    order, n, mean, cov, box_dim, max_r2, S = _segment_surfels(cloud.xyz, cloud.mask, knn)
    va, ve = normals.eigh_3x3(cov)
    normal = ve[:, :, 0]
    vsum = torch.clamp(va.sum(-1), min=1e-12)
    vdesc = torch.flip(va, dims=(-1,)) / vsum[:, None]
    planarity = 2.0 * (vdesc[:, 1] - vdesc[:, 2])
    cylindricality = vdesc[:, 0] - vdesc[:, 1]
    sphericality = 3.0 * vdesc[:, 2]
    density = n / torch.clamp((4.0 / 3.0) * math.pi * max_r2 * torch.sqrt(max_r2), min=1e-12)
    fit = (n >= 3) & (box_dim <= max_box_dim)
    if min_planarity > 0:
        fit = fit & (planarity >= min_planarity)

    N = cloud.capacity
    lane = torch.arange(N, device=cloud.device)
    lane_seg = lane // knn
    sorted_cloud = cloud.take(order)
    seg_fit = fit[lane_seg]
    if sampling_method == 0:
        keep = sorted_cloud.mask & seg_fit & (u < ratio)
        out = sorted_cloud.with_mask(keep)
    else:
        keep = sorted_cloud.mask & seg_fit & (lane % knn == 0)
        out = dataclasses.replace(
            sorted_cloud, xyz=torch.where(keep[:, None], mean[lane_seg], sorted_cloud.xyz)
        ).with_mask(keep)
        if average_existing_descriptors and cloud.attrs is not None:
            a = sorted_cloud.attrs
            w = sorted_cloud.mask.to(torch.float32)
            pad = S * knn - N
            aseg = torch.nn.functional.pad(a * w[:, None], (0, 0, 0, pad)).reshape(
                S, knn, -1).sum(1)
            aavg = aseg / torch.clamp(torch.nn.functional.pad(w, (0, pad)).reshape(
                S, knn).sum(1), min=1.0)[:, None]
            out = dataclasses.replace(out, attrs=torch.where(keep[:, None], aavg[lane_seg], a))
    if keep_normals:
        out = dataclasses.replace(
            out, normals=torch.where(keep[:, None], normal[lane_seg], out.normals))

    def seg_cols(out, prefix, vals):
        vals = vals.reshape(S, -1)
        for c in range(vals.shape[1]):
            name = prefix if vals.shape[1] == 1 else f"{prefix}{c}"
            out = out.with_attr(name, torch.where(keep, vals[lane_seg, c], 0.0))
        return out

    for flag, prefix, vals in (
            (keep_densities, "densities", density), (keep_eigen_values, "eigValues", va),
            (keep_eigen_vectors, "eigVectors", ve), (keep_covariances, "covariance", cov),
            (keep_weights, "weights", n), (keep_means, "means", mean),
            (keep_shapes, "shapes", torch.stack([planarity, cylindricality, sphericality], -1))):
        if flag:
            out = seg_cols(out, prefix, vals)
    return out


def _gestalt_core(xyz: Tensor, mask: Tensor, kp_idx: Tensor, kp_valid: Tensor, radius: float,
                  keep_gestalt_features: bool):
    """Per-keypoint Gestalt evaluation over a dense [K, N] box test."""
    K = kp_idx.shape[0]
    kp = xyz[kp_idx]
    rel = xyz[None, :, :] - kp[:, None, :]
    inbox = (rel.abs() <= radius).all(-1)
    lane = torch.arange(xyz.shape[0], device=xyz.device)
    w = (inbox & (lane[None, :] != kp_idx[:, None]) & mask[None, :]
         & kp_valid[:, None]).to(torch.float32)
    n = w.sum(1)
    mean = torch.einsum("kn,kni->ki", w, rel) / torch.clamp(n, min=1.0)[:, None]
    ctr = rel - mean[:, None, :]
    cov = torch.einsum("kni,knj->kij", w[..., None] * ctr, ctr)
    va, ve = normals.eigh_3x3(cov)
    normal = ve[:, :, 0]
    planarity = 2.0 * (va[:, 1] - va[:, 0]) / torch.clamp(va.sum(-1), min=1e-12)
    vert_angle = torch.arccos(torch.clamp(normal[:, 2], -1.0, 1.0))
    ok = kp_valid & (n > 0)
    if keep_gestalt_features:
        # Gestalt.cpp:451-462: near-planar keypoints and normals within 10
        # degrees of vertical are discarded.
        ok = ok & (planarity <= 0.9) & (vert_angle >= math.radians(10.0))
    # The covariance-oriented horizontal basis (Gestalt.cpp:440-449).
    zero = torch.zeros_like(normal[:, 0])
    nx = torch.stack([normal[:, 0], normal[:, 1], zero], dim=-1)
    nx = nx / torch.clamp(norm3(nx), min=1e-9)[:, None]
    ny = torch.stack([-nx[:, 1], nx[:, 0], zero], dim=-1)  # up x nx
    ny = ny / torch.clamp(norm3(ny), min=1e-9)[:, None]
    ax = torch.einsum("kni,ki->kn", rel, nx)
    ay = torch.einsum("kni,ki->kn", rel, ny)
    az = rel[..., 2]
    # Polar bins (Gestalt.cpp:598-627): atan2(x, y) wrapped to [0, 2 pi).
    ang = torch.atan2(ax, ay)
    ang = torch.where(ang < 0, ang + 2 * math.pi, ang)
    rad = torch.sqrt(ax * ax + ay * ay)
    rbin = torch.clamp((rad / (radius / 4.0)).to(torch.int64), 0, 3)
    abin = torch.clamp((ang / (math.pi / 4.0)).to(torch.int64), 0, 7)
    flat = (torch.arange(K, device=xyz.device)[:, None] * 32 + rbin * 8 + abin).reshape(-1)
    wf, hz = w.reshape(-1), az.reshape(-1)
    cnt = torch.zeros(K * 32, dtype=torch.float32, device=xyz.device).index_add_(0, flat, wf)
    hsum = torch.zeros_like(cnt).index_add_(0, flat, wf * hz)
    gmean = torch.where(cnt > 0, hsum / torch.clamp(cnt, min=1.0), 0.0)
    dev = hz - gmean[flat]
    gvar = torch.zeros_like(cnt).index_add_(0, flat, wf * dev * dev).reshape(K, 4, 8)
    gmean, cnt = gmean.reshape(K, 4, 8), cnt.reshape(K, 4, 8)
    # Normalised variances where populated; an empty ring takes the values
    # of the ring inside it (Gestalt.cpp:503-533).
    means = [gmean[:, 0]]
    vars_ = [torch.where(cnt[:, 0] > 0, gvar[:, 0] / torch.clamp(cnt[:, 0], min=1.0),
                         gvar[:, 0])]
    for r in range(1, 4):
        empty = gmean[:, r] == 0.0
        norm_var = torch.where(cnt[:, r] > 0, gvar[:, r] / torch.clamp(cnt[:, r], min=1.0),
                               gvar[:, r])
        vars_.append(torch.where(empty, vars_[-1], norm_var))
        means.append(torch.where(empty, means[-1], gmean[:, r]))
    gmean = torch.stack(means, 1).reshape(K, 32)
    gvar = torch.stack(vars_, 1).reshape(K, 32)
    return kp, ok, mean + kp, cov, va, ve, normal, gmean, gvar


def gestalt(cloud: PointCloud, u: Tensor, ratio: float = 0.1, radius: float = 5.0,
            knn: int = 7, vsize=(1.0, 1.0, 1.0), max_keypoints: int = 512,
            keep_normals: bool = True, keep_means: bool = False,
            keep_eigen_values: bool = False, keep_eigen_vectors: bool = False,
            keep_covariances: bool = False, keep_gestalt_features: bool = True,
            average_existing_descriptors: bool = True) -> PointCloud:
    """Gestalt descriptors (Bosse & Zlot, ICRA 2013; ≙ GestaltDataPointsFilter,
    Gestalt.cpp:214-595): the first point of each ``vsize`` voxel as a
    keypoint, kept at random with probability ``ratio`` (``u``: one draw a
    lane), at most ``max_keypoints`` of them in lane order; each keypoint's
    +-radius box neighbourhood gives its normal, the planarity and
    vertical-normal gates and the 4 x 8 polar height mean/variance
    descriptor.  ``knn`` is accepted for configuration compatibility.  The
    output capacity is ``max_keypoints``."""
    del knn
    key3 = torch.floor(cloud.xyz / _const(vsize, cloud.xyz)).to(torch.int32)
    kx = torch.where(cloud.mask, key3[:, 0], 2 ** 31 - 1)
    order, is_first = _first_per_voxel(kx, key3[:, 1], key3[:, 2])
    kp_mask = _scatter_keep(order, is_first) & cloud.mask & (u < ratio)
    sel = torch.argsort((~kp_mask).to(torch.int8), stable=True)[:max_keypoints]
    kp_valid = kp_mask[sel]
    kp, ok, mean_abs, cov, va, ve, normal, gmeans, gvars = _gestalt_core(
        cloud.xyz, cloud.mask, sel, kp_valid, float(radius), keep_gestalt_features)
    out = PointCloud(
        xyz=torch.where(ok[:, None], kp, 3.0e7),
        normals=torch.where(ok[:, None], normal, 0.0) if keep_normals else torch.zeros_like(kp),
        mask=ok)
    if average_existing_descriptors and cloud.attrs is not None:
        out = dataclasses.replace(out, attrs=cloud.attrs[sel], attr_names=cloud.attr_names)
    K = sel.shape[0]
    for flag, prefix, vals in ((keep_means, "means", mean_abs), (keep_eigen_values, "eigValues", va),
                               (keep_eigen_vectors, "eigVectors", ve),
                               (keep_covariances, "covariance", cov),
                               (keep_gestalt_features, "gestaltMeans", gmeans),
                               (keep_gestalt_features, "gestaltVariances", gvars)):
        if flag:
            vals = vals.reshape(K, -1)
            for c in range(vals.shape[1]):
                out = out.with_attr(prefix if vals.shape[1] == 1 else f"{prefix}{c}",
                                    torch.where(ok, vals[:, c], 0.0))
    return out
