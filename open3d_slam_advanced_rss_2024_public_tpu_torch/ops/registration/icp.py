"""The ICP driver: a fixed-trip registration loop with on-device stopping.

Counterpart of the JAX package's ``ops/registration/icp.py`` (reference
pointmatcher/ICP.cpp:258-468: match -> outlier weights -> minimize ->
transformation checkers).  The JAX package compiles the loop as one
``lax.while_loop`` (``icp.py:420``); eager PyTorch would need the stopping
test on the host, and a ``.item()`` per iteration would make the host wait
on the device for every scan.  So the loop runs ``max_iterations`` trips
and a device-side ``active`` flag freezes the carry through
``torch.where`` once the differential checker fires: the transform and
the iteration count are those of the while loop, at the cost of the
iterations after convergence (their launches run and are discarded).
Callers that run long loops off the Mapper's path (the constraint builders:
40 and 100 trips) pass ``poll_every``: the converged flag is then copied to
pinned host memory every few trips without waiting, and the loop stops
dispatching once a copy that has landed says converged.  The host still
never waits, and the result is the fixed-trip result, because the carry is
frozen from the converged trip on.

Ported: the point-to-plane minimizer, the default outlier chain
(trimmed distance + normal gate), the kernel and brute-force matchers, and
the differential and counter checkers.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ...utils import se3
from ...utils.device import HostCopy
from ...utils.pointcloud import PointCloud
from .. import bruteforce, cuda_nn
from ..hashgrid import HashGrid
from . import minimizers, outliers

Tensor = torch.Tensor

# Matcher names that select kernel K1 ("pallas" keeps JAX parameter files valid).
KERNEL_MATCHERS = ("cuda", "pallas")
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
    # "cuda" (kernel K1; alias "pallas") or "bruteforce".
    matcher: str = "bruteforce"
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


def check_supported(cfg: ICPConfig) -> None:
    """Raise on the parts of the JAX package's ICP surface not ported yet."""
    later = {
        "minimizer": (cfg.minimizer != "point_to_plane", "ROADMAP §1 item 17"),
        "force4dof/force2d": (cfg.force4dof or cfg.force2d, "ROADMAP §1 item 17"),
        "knn > 1": (cfg.knn != 1, "ROADMAP §1 item 17"),
        "max_dist_field": (cfg.max_dist_field is not None, "ROADMAP §1 item 17"),
        "robust_kernel": (cfg.robust_kernel is not None, "ROADMAP §1 item 17"),
        "outlier_chain": (cfg.outlier_chain is not None, "ROADMAP §1 item 17"),
        "bound checker": (cfg.bound_max_rot is not None
                          or cfg.bound_max_trans is not None, "ROADMAP §1 item 17"),
        "matcher='hashgrid'": (cfg.matcher == "hashgrid", "ROADMAP §1 item 12"),
        "matcher='sharded'": (cfg.matcher == "sharded" or cfg.shard_axis is not None,
                              "ROADMAP §1 item 19"),
    }
    for what, (used, item) in later.items():
        if used:
            raise NotImplementedError(f"ICP {what} is not ported yet ({item})")
    if cfg.matcher not in KERNEL_MATCHERS + ("bruteforce",):
        raise ValueError(f"unknown matcher: {cfg.matcher!r}")


def _weights(cfg: ICPConfig, sq_dists, found, src_nrm, ref_nrm, slot_mask):
    """The default outlier chain (``icp.py:175-181``)."""
    w = outliers.trimmed_dist_weights(sq_dists, found, cfg.trimmed_ratio,
                                      slot_mask=slot_mask)
    if cfg.use_normal_gate:
        w = w * outliers.surface_normal_weights(src_nrm, ref_nrm, found,
                                                cfg.normal_max_angle)
    return w


def prepare_reference(cfg: ICPConfig, ref_grid: HashGrid) -> Optional[cuda_nn.NNRef]:
    """What the matcher derives from the reference alone, computed once for
    every registration against ``ref_grid`` (kernel K1's prepared
    reference; the brute-force matcher needs nothing)."""
    if cfg.matcher in KERNEL_MATCHERS:
        return cuda_nn.prepare_ref(ref_grid.points)
    return None


def _match(cfg: ICPConfig, src: Tensor, mask: Tensor, ref_grid: HashGrid,
           nn_ref: Optional[cuda_nn.NNRef] = None):
    """Correspondence search -> (ref_pts, ref_nrm, d2, found)."""
    if cfg.matcher in KERNEL_MATCHERS:
        idx, d2 = cuda_nn.nn(src, ref_grid.points if nn_ref is None else nn_ref,
                             cfg.max_correspondence_dist)
        found = mask & (d2 <= cfg.max_correspondence_dist ** 2)
    else:
        idx, d2, found = bruteforce.nn(src, mask, ref_grid.points,
                                       cfg.max_correspondence_dist)
    return ref_grid.points[idx], ref_grid.normals[idx], d2, found


def reference_centroid(ref_grid: HashGrid) -> Tensor:
    """Centroid of the valid reference points (the de-meaned solving frame,
    ≙ ICP.cpp:293-326)."""
    ref_valid = ref_grid.points[:, 0].abs() < 1e7
    nref = ref_valid.sum(dtype=torch.float32)
    total = torch.where(ref_valid[:, None], ref_grid.points, 0.0).sum(0)
    return total / torch.clamp(nref, min=1.0)


def iteration_step(cfg: ICPConfig, source: PointCloud, ref_grid: HashGrid,
                   centroid: Tensor, T: Tensor, nn_ref: Optional[cuda_nn.NNRef] = None):
    """One ICP iteration: match -> weigh -> minimize -> compose.
    Returns (T_new, rot_delta, trans_delta, match_ratio, rmse)."""
    src = se3.apply(T, source.xyz)
    src_nrm = se3.rotate(T, source.normals)
    ref_pts, ref_nrm, d2, found = _match(cfg, src, source.mask, ref_grid, nn_ref)
    w = _weights(cfg, d2, found, src_nrm, ref_nrm, slot_mask=source.mask)
    src_c = torch.where(found[:, None], src - centroid, 0.0)
    ref_c = torch.where(found[:, None], ref_pts - centroid, 0.0)
    xi, mean_sq = minimizers.point_to_plane_step(src_c, ref_c, ref_nrm, w, cfg.damping)
    dT = se3.se3_exp(xi)
    I = torch.eye(3, dtype=T.dtype, device=T.device)
    shift = se3.make_transform(I, centroid)
    T_new = shift @ dT @ se3.inverse(shift) @ T
    n_valid = torch.clamp(source.mask.sum(dtype=torch.float32), min=1.0)
    match_ratio = found.sum(dtype=torch.float32) / n_valid
    return (T_new, torch.linalg.vector_norm(xi[:3]), torch.linalg.vector_norm(xi[3:]),
            match_ratio, torch.sqrt(mean_sq))


def register(source: PointCloud, ref_grid: HashGrid, init_T: Tensor,
             cfg: ICPConfig = ICPConfig(),
             nn_ref: Optional[cuda_nn.NNRef] = None, poll_every: int = 0) -> ICPResult:
    """Register ``source`` against a prebuilt reference grid; ``init_T``
    maps the source frame into the reference frame.  ``nn_ref`` is
    ``prepare_reference(cfg, ref_grid)`` where the caller registers several
    scans against one grid; without it the reference is prepared here, once
    for all iterations.  No host synchronisation: the stopping test stays
    on the device.  ``poll_every`` > 0 stops dispatching trips once a
    non-blocking look at the converged flag, taken every ``poll_every``
    trips, shows convergence (same result, fewer launches)."""
    check_supported(cfg)
    if nn_ref is None:
        nn_ref = prepare_reference(cfg, ref_grid)
    dev = source.device
    centroid = reference_centroid(ref_grid)
    smooth = max(cfg.smooth_length, 1)
    T = init_T.to(torch.float32)
    it = torch.zeros((), dtype=torch.int32, device=dev)
    ring = torch.full((smooth, 2), float("inf"), dtype=torch.float32, device=dev)
    match_ratio = torch.zeros((), dtype=torch.float32, device=dev)
    rmse = torch.full((), float("inf"), dtype=torch.float32, device=dev)

    def converged_of(ring):
        mean = ring.mean(0)
        return (mean[0] < cfg.min_diff_rot) & (mean[1] < cfg.min_diff_trans)

    polls = []
    for trip in range(cfg.max_iterations):
        if any(p.ready() and bool(p.host[0]) for p in polls):
            break
        active = (it < smooth) | ~converged_of(ring)
        if poll_every > 0 and trip > 0 and trip % poll_every == 0:
            polls.append(HostCopy([~active]))
        T_new, rot_d, trans_d, mr, rm = iteration_step(cfg, source, ref_grid, centroid, T, nn_ref)
        ring_new = torch.cat([torch.stack([rot_d, trans_d])[None], ring[:-1]])
        T = torch.where(active, T_new, T)
        ring = torch.where(active, ring_new, ring)
        match_ratio = torch.where(active, mr, match_ratio)
        rmse = torch.where(active, rm, rmse)
        it = it + active.to(torch.int32)
    diverged = torch.zeros((), dtype=torch.bool, device=dev)
    return ICPResult(transform=se3.orthonormalize(T), iterations=it,
                     converged=converged_of(ring), match_ratio=match_ratio,
                     rmse=rmse, diverged=diverged)
