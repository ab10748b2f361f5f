"""The ICP driver: a fixed-trip registration loop with on-device stopping.

Counterpart of the JAX package's ``ops/registration/icp.py`` (reference
pointmatcher/ICP.cpp:258-468: match -> outlier weights -> minimize ->
transformation checkers).  The JAX package compiles the loop as one
``lax.while_loop`` (``icp.py:420``); eager PyTorch would need the stopping
test on the host, and a ``.item()`` per iteration would make the host wait
on the device for every scan.  So the loop runs ``max_iterations`` trips
and a device-side ``active`` flag freezes the carry through
``torch.where`` once the differential checker fires: the transform and
the iteration count are those of the while loop.  The hot callers (the
Mapper's scan-to-map step, the odometry, the constraint builders, the ICP
chain) pass ``poll_every``: the converged flag is then copied to pinned
host memory every few trips without waiting, and the loop stops
dispatching once a copy that has landed says converged.  The host still
never waits, and the result is the fixed-trip result, because the carry is
frozen from the converged trip on; where no copy has landed, the loop runs
all ``max_iterations`` trips and discards those after convergence.

The whole surface of the JAX package's ICP loop is here: every minimizer
(point-to-plane with its 4-DOF and 2-D restrictions, point-to-point, GICP,
similarity, identity), kNN matching, the per-point match radius from a
descriptor channel (``max_dist_field``, ≙ KDTreeVarDistMatcher), every
``outlier_chain`` filter including ``generic_desc`` (weights from the
matched reference point's descriptor), the bound checker, and the kernel,
brute-force, hashed-grid and sharded matchers.  The sharded matcher
(``parallel/``) searches each rank's own map shard with kernel K1 (JAX:
brute force) and reduces the winners over the mesh that ``make_mesh``
registered under ``shard_axis``; its loop never polls, since a rank that
stopped on its own clock would leave the others in a collective.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ...utils import se3, timing
from ...utils.device import HostCopy
from ...utils.pointcloud import PointCloud
from .. import bruteforce, cuda_nn, hashgrid
from ..hashgrid import HashGrid
from . import minimizers, outliers

Tensor = torch.Tensor

# Matcher names that select kernel K1 ("pallas" keeps JAX parameter files valid).
KERNEL_MATCHERS = ("cuda", "pallas")
MATCHERS = KERNEL_MATCHERS + ("bruteforce", "hashgrid", "sharded")


def resolve_matcher(name: str) -> str:
    """"auto" -> the hand-written NN kernel K1 on every device (its plain
    twin on CPU tensors).  The JAX package sends CPU and GPU to brute force
    (``mapper.py:53-59``, and ``chain.from_dict``'s default); the port's
    kernel is its GPU matcher."""
    return "cuda" if name == "auto" else name


# Trips between two non-blocking looks at a loop's device-side done flag, for
# every loop whose caller reads its result back anyway (``register`` with
# ``poll_every``, the pose graph's LM loop).
POLL_EVERY = 5


@dataclasses.dataclass(frozen=True)
class ICPConfig:
    """ICP chain configuration (the JAX package's fields and defaults;
    reference icp.yaml: knn=1 maxDist=0.5, trimmed 0.90, normal-angle gate
    1.57, differential checker 0.001 rad / 0.01 m over 3, counter 15)."""

    max_iterations: int = 15
    max_correspondence_dist: float = 0.5
    trimmed_ratio: float = 0.90
    normal_max_angle: float = 1.57
    use_normal_gate: bool = True
    min_diff_rot: float = 0.001
    min_diff_trans: float = 0.01
    smooth_length: int = 3
    minimizer: str = "point_to_plane"
    force4dof: bool = False
    force2d: bool = False
    knn: int = 1
    max_dist_field: Optional[str] = None
    robust_kernel: Optional[str] = None
    robust_k: float = 0.5
    max_per_bucket: int = 32
    damping: float = 1e-6
    outlier_chain: Optional[tuple] = None
    bound_max_rot: Optional[float] = None
    bound_max_trans: Optional[float] = None
    # "cuda" (kernel K1; alias "pallas"), "bruteforce", "hashgrid" or
    # "sharded" (each rank searches its map shard with K1, the winners
    # reduce over the mesh registered under ``shard_axis``).
    matcher: str = "bruteforce"
    # The mesh axis of the "sharded" matcher; also sums the reference
    # centroid over the mesh.
    shard_axis: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class ICPResult:
    """transform: 4x4 mapping source frame -> reference frame; match_ratio
    ≙ Open3D fitness; rmse ≙ inlier point-to-plane RMSE.  Every field is a
    device tensor (batched [K, ...] when stacked over a lag block)."""

    transform: Tensor
    iterations: Tensor
    converged: Tensor
    match_ratio: Tensor
    rmse: Tensor
    diverged: Tensor

    def map(self, fn) -> "ICPResult":
        return ICPResult(**{f.name: fn(getattr(self, f.name))
                            for f in dataclasses.fields(self)})


def _mesh(cfg: ICPConfig):
    """The mesh registered under ``cfg.shard_axis`` (imported here: the
    parallel package builds on this module)."""
    from ...parallel.mesh import mesh_for_axis

    return mesh_for_axis(cfg.shard_axis)


def check_supported(cfg: ICPConfig) -> None:
    """Raise ValueError on an unknown matcher, and on a sharded
    configuration whose mesh axis no ``make_mesh`` registered (JAX asserts
    at ``icp.py:216``)."""
    if cfg.matcher not in MATCHERS:
        raise ValueError(f"unknown matcher: {cfg.matcher!r}")
    if cfg.matcher == "sharded" and cfg.shard_axis is None:
        raise ValueError("the sharded matcher needs shard_axis")
    if cfg.shard_axis is not None:
        _mesh(cfg)


def _weights(cfg: ICPConfig, sq_dists, found, src_nrm, ref_nrm, slot_mask, p2plane_sq,
             ref_desc=None):
    """Compose the outlier-filter chain into per-correspondence weights
    (``icp.py:115-181``).  ``slot_mask`` is the quantile basis (valid
    reading lanes x knn, not-found matches included as +inf);
    ``p2plane_sq`` the squared point-to-plane residuals that the robust
    filter's point2plane distance reads; ``ref_desc`` the matched reference
    point's descriptor that ``generic_desc`` reads."""
    if cfg.outlier_chain is not None:
        w = found.to(torch.float32)
        for entry in cfg.outlier_chain:
            name, params = entry[0], entry[1:]
            if name == "trimmed":
                w = w * outliers.trimmed_dist_weights(sq_dists, found, *params,
                                                      slot_mask=slot_mask)
            elif name == "surface_normal":
                w = w * outliers.surface_normal_weights(src_nrm, ref_nrm, found, *params)
            elif name == "var_trimmed":
                w = w * outliers.var_trimmed_dist_weights(sq_dists, found, *params)
            elif name == "median":
                w = w * outliers.median_dist_weights(sq_dists, found, *params,
                                                     slot_mask=slot_mask)
            elif name == "max_dist":
                w = w * outliers.max_dist_weights(sq_dists, found, *params)
            elif name == "min_dist":
                w = w * outliers.min_dist_weights(sq_dists, found, *params)
            elif name == "robust":
                kind, tuning, scale_est, dist_type, approx = params
                w = w * outliers.robust_weights(
                    sq_dists, found, kind, tuning, scale_estimator=scale_est,
                    p2plane_sq=p2plane_sq, distance_type=dist_type, approximation=approx)
            elif name == "generic_desc":
                # GenericDescriptorOutlierFilter (OutlierFiltersImpl.cpp:304-369):
                # the soft mode weighs by the descriptor over its maximum.
                soft, larger, threshold = params
                if ref_desc is None:
                    raise ValueError("GenericDescriptorOutlierFilter needs a reference "
                                     "grid built with desc_channel=<descName>")
                if soft:
                    g = torch.where(found, ref_desc, 0.0)
                    w = w * g / torch.clamp(g.max(), min=1e-12)
                elif larger:
                    w = w * (ref_desc > threshold).to(torch.float32)
                else:
                    w = w * (ref_desc < threshold).to(torch.float32)
            elif name != "null":
                raise ValueError(f"unknown outlier filter: {name}")
        return w
    w = outliers.trimmed_dist_weights(sq_dists, found, cfg.trimmed_ratio,
                                      slot_mask=slot_mask)
    if cfg.use_normal_gate:
        w = w * outliers.surface_normal_weights(src_nrm, ref_nrm, found,
                                                cfg.normal_max_angle)
    if cfg.robust_kernel is not None:
        w = w * outliers.robust_weights(sq_dists, found, cfg.robust_kernel, cfg.robust_k)
    return w


def prepare_reference(cfg: ICPConfig, ref_grid: HashGrid) -> Optional[cuda_nn.NNRef]:
    """What the matcher derives from the reference alone, computed once for
    every registration against ``ref_grid`` (kernel K1's prepared
    reference; the other matchers need nothing)."""
    if cfg.matcher in KERNEL_MATCHERS + ("sharded",) and cfg.knn == 1:
        return cuda_nn.prepare_ref(ref_grid.points)
    return None


def _match(cfg: ICPConfig, src: Tensor, src_nrm: Tensor, mask: Tensor, ref_grid: HashGrid,
           nn_ref: Optional[cuda_nn.NNRef] = None):
    """Correspondence search honouring ``cfg.matcher`` and ``cfg.knn``.
    Returns per-correspondence (src, src_nrm, slot_mask, ref_pts, ref_nrm,
    d2, found), flattened to [N * knn], per_point_found [N], and the matched
    reference points' descriptor (None unless the grid carries one)."""
    if cfg.knn > 1:
        # kNN matches stack as correspondences (KDTreeMatcher knn > 1 ≙
        # stacked ErrorElements, MatchersImpl.cpp:118-133), on the
        # brute-force top-k whatever the matcher, as in the JAX package.
        k = cfg.knn
        idx, d2, ok = bruteforce.knn(src, mask, ref_grid.points,
                                     cfg.max_correspondence_dist, k=k)
        flat = idx.reshape(-1)
        return (src.repeat_interleave(k, dim=0), src_nrm.repeat_interleave(k, dim=0),
                mask.repeat_interleave(k), ref_grid.points[flat], ref_grid.normals[flat],
                d2.reshape(-1), ok.reshape(-1), ok.any(-1),
                None if ref_grid.desc is None else ref_grid.desc[flat])
    if cfg.matcher == "sharded":
        return _match_sharded(cfg, src, src_nrm, mask, ref_grid, nn_ref)
    if cfg.matcher in KERNEL_MATCHERS:
        idx, d2 = cuda_nn.nn(src, ref_grid.points if nn_ref is None else nn_ref,
                             cfg.max_correspondence_dist)
        found = mask & (d2 <= cfg.max_correspondence_dist ** 2)
    elif cfg.matcher == "bruteforce":
        idx, d2, found = bruteforce.nn(src, mask, ref_grid.points,
                                       cfg.max_correspondence_dist)
    else:
        idx, d2, found = hashgrid.query_nn(ref_grid, src, mask, cfg.max_correspondence_dist,
                                           max_per_bucket=cfg.max_per_bucket)
    return (src, src_nrm, mask, ref_grid.points[idx], ref_grid.normals[idx], d2, found,
            found, None if ref_grid.desc is None else ref_grid.desc[idx])


def _match_sharded(cfg: ICPConfig, src: Tensor, src_nrm: Tensor, mask: Tensor,
                   ref_grid: HashGrid, nn_ref: Optional[cuda_nn.NNRef]):
    """The sharded matcher (JAX ``icp.py:210-235``): every rank searches its
    own reference shard with K1 for the same (replicated) queries, and the
    global winner -- its point, normal and descriptor -- reduces over the
    mesh (``mesh.reduce_winners``), so that ranks that pass the same
    queries get the same correspondences."""
    from ...parallel.mesh import reduce_winners

    idx, d2 = cuda_nn.nn(src, ref_grid.points if nn_ref is None else nn_ref,
                         cfg.max_correspondence_dist)
    r = np.float32(cfg.max_correspondence_dist)
    found = mask & (d2 <= float(r * r))
    parts = [ref_grid.points[idx], ref_grid.normals[idx]]
    if ref_grid.desc is not None:
        parts.append(ref_grid.desc[idx][:, None])
    best, won = reduce_winners(_mesh(cfg), torch.where(found, d2, float("inf")),
                               torch.cat(parts, dim=-1))
    found = mask & torch.isfinite(best)
    return (src, src_nrm, mask, won[:, 0:3], won[:, 3:6], torch.where(found, best, float("inf")),
            found, found, won[:, 6] if ref_grid.desc is not None else None)


def _vardist_gate(cfg: ICPConfig, source: PointCloud, d2: Tensor, found: Tensor,
                  per_point_found: Tensor):
    """Per-point maximum match distance (≙ KDTreeVarDistMatcher,
    MatchersImpl.h:119-148): reject matches beyond the radius stored in the
    reading's ``cfg.max_dist_field`` channel."""
    if cfg.max_dist_field is None:
        return found, per_point_found
    vd = source.attr(cfg.max_dist_field)
    if cfg.knn > 1:
        found = found & (d2 <= (vd * vd).repeat_interleave(cfg.knn))
        return found, found.reshape(-1, cfg.knn).any(-1)
    found = found & (d2 <= vd * vd)
    return found, found


def reference_centroid(ref_grid: HashGrid, shard_axis: Optional[str] = None) -> Tensor:
    """Centroid of the valid reference points (the de-meaned solving frame,
    ≙ ICP.cpp:293-326).  With ``shard_axis`` the count and the sum reduce
    over the mesh (one packed ``psum``), so every shard solves in the same
    global frame."""
    ref_valid = ref_grid.points[:, 0].abs() < 1e7
    nref = ref_valid.sum(dtype=torch.float32)
    total = torch.where(ref_valid[:, None], ref_grid.points, 0.0).sum(0)
    if shard_axis is not None:
        from ...parallel.mesh import mesh_for_axis, psum

        both = psum(mesh_for_axis(shard_axis), torch.cat([nref[None], total]))
        nref, total = both[0], both[1:]
    return total / torch.clamp(nref, min=1.0)


def _disk_cov(n: Tensor, eps: float = 1e-3) -> Tensor:
    """GICP's plane-disk covariance from a normal: unit variance in the
    plane, ``eps`` along the normal (Open3D's GeneralizedICP model)."""
    return (torch.eye(3, dtype=n.dtype, device=n.device)
            - (1.0 - eps) * (n[..., :, None] * n[..., None, :]))


def _matched(cfg: ICPConfig, source: PointCloud, ref_grid: HashGrid, T: Tensor,
             nn_ref: Optional[cuda_nn.NNRef]):
    """Match the source under ``T`` and weigh the matches: (src, src_nrm,
    ref_pts, ref_nrm, found, per_point_found, weights)."""
    src = se3.apply(T, source.xyz)
    src_nrm = se3.rotate(T, source.normals)
    (src, src_nrm, slot_mask, ref_pts, ref_nrm, d2, found, per_point_found,
     ref_desc) = _match(cfg, src, src_nrm, source.mask, ref_grid, nn_ref)
    found, per_point_found = _vardist_gate(cfg, source, d2, found, per_point_found)
    pp = ((src - ref_pts) * ref_nrm).sum(-1)
    w = _weights(cfg, d2, found, src_nrm, ref_nrm, slot_mask, pp * pp, ref_desc)
    return src, src_nrm, ref_pts, ref_nrm, found, per_point_found, w


def iteration_step(cfg: ICPConfig, source: PointCloud, ref_grid: HashGrid,
                   centroid: Tensor, T: Tensor, nn_ref: Optional[cuda_nn.NNRef] = None):
    """One ICP iteration: match -> weigh -> minimize -> compose.
    Returns (T_new, rot_delta, trans_delta, match_ratio, rmse)."""
    src, src_nrm, ref_pts, ref_nrm, found, per_point_found, w = _matched(
        cfg, source, ref_grid, T, nn_ref)
    src_c = torch.where(found[:, None], src - centroid, 0.0)
    ref_c = torch.where(found[:, None], ref_pts - centroid, 0.0)
    if cfg.minimizer == "point_to_plane":
        xi, mean_sq = minimizers.point_to_plane_step(src_c, ref_c, ref_nrm, w, cfg.damping,
                                                     force4dof=cfg.force4dof,
                                                     force2d=cfg.force2d)
    elif cfg.minimizer == "point_to_point":
        xi, mean_sq = minimizers.point_to_point_step(src_c, ref_c, w)
    elif cfg.minimizer == "similarity":
        # The scaled closed form composes directly; the checker's deltas
        # come from its rigid part.
        S, scale_s = minimizers.point_to_point_umeyama(src_c, ref_c, w, with_scale=True)
        mean_sq = minimizers.point_to_point_mean_sq(src_c, ref_c, w)
    elif cfg.minimizer == "identity":
        xi = torch.zeros((6,), dtype=src.dtype, device=src.device)
        mean_sq = minimizers.point_to_point_mean_sq(src_c, ref_c, w)
    elif cfg.minimizer == "gicp":
        xi, mean_sq = minimizers.gicp_step(src_c, ref_c, _disk_cov(src_nrm), _disk_cov(ref_nrm),
                                           w, cfg.damping)
    else:
        raise ValueError(f"unsupported minimizer: {cfg.minimizer}")
    if cfg.minimizer == "similarity":
        dT = S
        rot_delta = se3.rotation_angle(se3.make_transform(
            S[:3, :3] / torch.clamp(scale_s, min=1e-9), S[:3, 3]))
        trans_delta = torch.linalg.vector_norm(S[:3, 3])
    else:
        dT = se3.se3_exp(xi)
        rot_delta = torch.linalg.vector_norm(xi[:3])
        trans_delta = torch.linalg.vector_norm(xi[3:])
    shift = se3.make_transform(torch.eye(3, dtype=T.dtype, device=T.device), centroid)
    T_new = shift @ dT @ se3.inverse(shift) @ T
    n_valid = torch.clamp(source.mask.sum(dtype=torch.float32), min=1.0)
    match_ratio = per_point_found.sum(dtype=torch.float32) / n_valid
    return T_new, rot_delta, trans_delta, match_ratio, torch.sqrt(mean_sq)


def _out_of_bounds(cfg: ICPConfig, T: Tensor, init_inv: Tensor) -> Tensor:
    """BoundTransformationChecker (TransformationCheckersImpl.h:117-141):
    the accumulated correction against the initial guess beyond a bound."""
    bad = torch.zeros((), dtype=torch.bool, device=T.device)
    if cfg.bound_max_rot is None and cfg.bound_max_trans is None:
        return bad
    delta = T @ init_inv
    if cfg.bound_max_rot is not None:
        bad = bad | (se3.rotation_angle(delta) > cfg.bound_max_rot)
    if cfg.bound_max_trans is not None:
        bad = bad | (se3.translation_norm(delta) > cfg.bound_max_trans)
    return bad


def register(source: PointCloud, ref_grid: HashGrid, init_T: Tensor,
             cfg: ICPConfig = ICPConfig(),
             nn_ref: Optional[cuda_nn.NNRef] = None, poll_every: int = 0) -> ICPResult:
    """Register ``source`` against a prebuilt reference grid; ``init_T``
    maps the source frame into the reference frame.  ``nn_ref`` is
    ``prepare_reference(cfg, ref_grid)`` where the caller registers several
    scans against one grid; without it the reference is prepared here, once
    for all iterations.  No host synchronisation: the stopping tests (the
    differential checker, the counter, the bound checker) stay on the
    device.  ``poll_every`` > 0 stops dispatching trips once a non-blocking
    look at the done flag, taken every ``poll_every`` trips, shows that
    the loop has stopped (same result, fewer launches); the Mapper's step
    and the odometry pass ``POLL_EVERY``.  The sharded matcher refuses it
    (each rank would stop on its own clock)."""
    check_supported(cfg)
    if poll_every > 0 and cfg.matcher == "sharded":
        raise ValueError("the sharded matcher runs every trip on every rank: "
                         "poll_every must be 0")
    if nn_ref is None:
        nn_ref = prepare_reference(cfg, ref_grid)
    dev = source.device
    centroid = reference_centroid(ref_grid, cfg.shard_axis)
    smooth = max(cfg.smooth_length, 1)
    T = init_T.to(torch.float32)
    init_inv = se3.inverse(T)
    it = torch.zeros((), dtype=torch.int32, device=dev)
    ring = torch.full((smooth, 2), float("inf"), dtype=torch.float32, device=dev)
    match_ratio = torch.zeros((), dtype=torch.float32, device=dev)
    rmse = torch.full((), float("inf"), dtype=torch.float32, device=dev)

    def converged_of(ring):
        mean = ring.mean(0)
        return (mean[0] < cfg.min_diff_rot) & (mean[1] < cfg.min_diff_trans)

    polls = []
    trips = 0
    for trip in range(cfg.max_iterations):
        if any(p.ready() and bool(p.host[0]) for p in polls):
            break
        trips += 1
        active = ((it < smooth) | ~converged_of(ring)) & ~_out_of_bounds(cfg, T, init_inv)
        if poll_every > 0 and trip > 0 and trip % poll_every == 0:
            polls.append(HostCopy([~active]))
        T_new, rot_d, trans_d, mr, rm = iteration_step(cfg, source, ref_grid, centroid, T,
                                                       nn_ref)
        ring_new = torch.cat([torch.stack([rot_d, trans_d])[None], ring[:-1]])
        T = torch.where(active, T_new, T)
        ring = torch.where(active, ring_new, ring)
        match_ratio = torch.where(active, mr, match_ratio)
        rmse = torch.where(active, rm, rmse)
        it = it + active.to(torch.int32)
    # The trips enqueued; ``iterations`` counts those that moved the pose.
    # Only the Mapper's and the odometry's calls are counted: their
    # ``*_active_trips_pct`` read the pair.
    timing.count_in_layer("icp_trips_dispatched", trips, layers=("mapper", "odometry"))
    diverged = _out_of_bounds(cfg, T, init_inv)
    if cfg.minimizer == "similarity":
        # Keep the estimated scale: factor T = s R | t, re-orthonormalize R
        # and apply s again (a plain orthonormalize would erase it).
        s = torch.pow(torch.clamp(se3.det_3x3(T[:3, :3]), min=1e-12), 1.0 / 3.0)
        T_out = se3.orthonormalize(se3.make_transform(T[:3, :3] / s, T[:3, 3]))
        T_out = se3.make_transform(s * T_out[:3, :3], T_out[:3, 3])
    else:
        T_out = se3.orthonormalize(T)
    return ICPResult(transform=T_out, iterations=it,
                     converged=converged_of(ring) & ~diverged, match_ratio=match_ratio,
                     rmse=rmse, diverged=diverged)


def register_clouds(source: PointCloud, reference: PointCloud, init_T: Tensor,
                    cfg: ICPConfig = ICPConfig(), table_size: int = 1 << 14) -> ICPResult:
    """Build the reference grid, then register (≙ CloudRegistration::
    registerClouds, CloudRegistration.cpp:57-61, for one-shot use)."""
    grid = hashgrid.build(reference, cfg.max_correspondence_dist, table_size=table_size)
    return register(source, grid, init_T, cfg)


def register_with_covariance(source: PointCloud, ref_grid: HashGrid, init_T: Tensor,
                             cfg: ICPConfig = ICPConfig(), sensor_std: float = 0.01,
                             poll_every: int = 0):
    """Register, then return (ICPResult, 6x6 solution covariance) evaluated
    at the converged pose over the final correspondence set, with the
    solve's matcher (≙ PointToPlaneWithCov / PointToPointWithCov).
    ``poll_every`` as in ``register``."""
    nn_ref = prepare_reference(cfg, ref_grid)
    res = register(source, ref_grid, init_T, cfg, nn_ref=nn_ref, poll_every=poll_every)
    src, _, _, ref_nrm, found, _, w = _matched(cfg, source, ref_grid, res.transform, nn_ref)
    src_c = torch.where(found[:, None], src - reference_centroid(ref_grid, cfg.shard_axis),
                        0.0)
    if cfg.minimizer == "point_to_plane":
        return res, minimizers.point_to_plane_covariance(src_c, ref_nrm, w, sensor_std)
    return res, minimizers.point_to_point_covariance(src_c, w, sensor_std)


def evaluate_registration(source: PointCloud, target_grid: HashGrid, T: Tensor,
                          max_dist: float, max_per_bucket: int = 32):
    """Open3D-style (fitness, inlier_rmse) of a candidate transform
    (EvaluateRegistration, as PlaceRecognition.cpp:117-121 uses it), with
    kernel K1 as the exact matcher (the JAX package's brute force; its
    plain twin on CPU tensors)."""
    src = se3.apply(T, source.xyz)
    _, d2 = cuda_nn.nn(src, target_grid.points, max_dist)
    found = source.mask & (d2 <= float(max_dist) ** 2)
    n_valid = torch.clamp(source.mask.sum(dtype=torch.float32), min=1.0)
    n_found = found.sum(dtype=torch.float32)
    inlier_sq = torch.where(found, d2, 0.0).sum() / torch.clamp(n_found, min=1.0)
    return n_found / n_valid, torch.sqrt(inlier_sq)
