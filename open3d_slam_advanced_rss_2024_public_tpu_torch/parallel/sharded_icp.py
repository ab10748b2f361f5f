"""Multi-device scan-to-map ICP: source rows sharded, reductions over the mesh.

Counterpart of the JAX package's ``parallel/sharded_icp.py``.  The source
scan is split by rows over the ranks (``shard_points``), the reference
grid is replicated, and each Gauss-Newton trip computes the shard's share
of the normal equations.  One packed ``psum`` sums A (36 floats), b (6),
the residual and weight sums and the found and valid counts, so that
every rank solves the same 6x6 system and the pose stays replicated.

The trimmed-distance filter needs a global distance quantile; as in the
JAX package it is the mean of the per-shard quantiles (one ``pmean`` a
trip), so the result depends on the row split, which is JAX's.  The loop
runs ``max_iterations`` trips with a device-side freeze after the
differential checker fires (the iteration count and transform of JAX's
``while_loop``), and no trip looks at the host: every rank makes the same
collectives.  The matcher is the single-device one of ``cfg.matcher``
(``icp._match``): kernel K1 for "cuda", the hashed grid, or brute force.
"""
from __future__ import annotations

import torch

from ..ops.hashgrid import HashGrid
from ..ops.registration import icp as icp_mod
from ..ops.registration import minimizers, outliers
from ..ops.registration.icp import ICPConfig, ICPResult
from ..utils import se3
from ..utils.device import to_device
from ..utils.pointcloud import PointCloud
from .mesh import Mesh, pmean, psum, shard_points

Tensor = torch.Tensor


def _local_trimmed_threshold(sq_dists: Tensor, valid: Tensor, ratio: float) -> Tensor:
    """The shard's ``ratio`` quantile of the valid squared distances."""
    n = sq_dists.shape[-1]
    d_sorted = torch.sort(torch.where(valid, sq_dists, float("inf")), dim=-1).values
    n_valid = valid.sum(-1, dtype=torch.int32)
    kth = torch.clamp((ratio * n_valid.to(torch.float32)).to(torch.int64), 0, n - 1)
    return torch.gather(d_sorted, -1, kth[..., None])[..., 0]


def make_sharded_register(mesh: Mesh, cfg: ICPConfig):
    """run(source [N rows, N divisible by D], grid [replicated], init_T
    [replicated]) -> ICPResult (replicated; ``diverged`` False)."""
    if cfg.matcher == "sharded" or cfg.knn != 1:
        raise ValueError("the sharded register splits the source: it takes a "
                         "single-device matcher with knn=1")
    icp_mod.check_supported(cfg)
    smooth = max(cfg.smooth_length, 1)

    def converged_of(ring):
        mean = ring.mean(0)
        return (mean[0] < cfg.min_diff_rot) & (mean[1] < cfg.min_diff_trans)

    def run(source: PointCloud, grid: HashGrid, init_T) -> ICPResult:
        src = source.map(lambda t: shard_points(mesh, t))
        dev = mesh.device
        nn_ref = icp_mod.prepare_reference(cfg, grid)
        centroid = icp_mod.reference_centroid(grid)
        shift = se3.make_transform(torch.eye(3, dtype=torch.float32, device=dev), centroid)
        T = to_device(init_T, dev)
        it = torch.zeros((), dtype=torch.int32, device=dev)
        ring = torch.full((smooth, 2), float("inf"), dtype=torch.float32, device=dev)
        match_ratio = torch.zeros((), dtype=torch.float32, device=dev)
        rmse = torch.full((), float("inf"), dtype=torch.float32, device=dev)
        for _ in range(cfg.max_iterations):
            active = (it < smooth) | ~converged_of(ring)
            xyz, nrm = se3.apply(T, src.xyz), se3.rotate(T, src.normals)
            _, _, _, ref_pts, ref_nrm, d2, found, _, _ = icp_mod._match(
                cfg, xyz, nrm, src.mask, grid, nn_ref)
            thresh = pmean(mesh, _local_trimmed_threshold(d2, found, cfg.trimmed_ratio))
            w = (found & (d2 <= thresh)).to(torch.float32)
            if cfg.use_normal_gate:
                w = w * outliers.surface_normal_weights(nrm, ref_nrm, found,
                                                        cfg.normal_max_angle)
            src_c = torch.where(found[:, None], xyz - centroid, 0.0)
            ref_c = torch.where(found[:, None], ref_pts - centroid, 0.0)
            r = ((src_c - ref_c) * ref_nrm).sum(-1)
            g = torch.cat([torch.linalg.cross(src_c, ref_nrm), ref_nrm], dim=-1)
            wg = g * w[:, None]
            sums = psum(mesh, torch.cat([
                (wg.T @ g).reshape(36), -(wg.T @ r),
                torch.stack([(w * r * r).sum(), w.sum(), found.sum(dtype=torch.float32),
                             src.mask.sum(dtype=torch.float32)])]))
            xi = minimizers.solve_6x6(sums[:36].reshape(6, 6), sums[36:42], cfg.damping)
            T_new = shift @ se3.se3_exp(xi) @ se3.inverse(shift) @ T
            ring_new = torch.cat([torch.stack([torch.linalg.vector_norm(xi[:3]),
                                               torch.linalg.vector_norm(xi[3:])])[None],
                                  ring[:-1]])
            T = torch.where(active, T_new, T)
            ring = torch.where(active, ring_new, ring)
            match_ratio = torch.where(active, sums[44] / torch.clamp(sums[45], min=1.0),
                                      match_ratio)
            rmse = torch.where(active, torch.sqrt(sums[42] / torch.clamp(sums[43], min=1e-6)),
                               rmse)
            it = it + active.to(torch.int32)
        return ICPResult(transform=se3.orthonormalize(T), iterations=it,
                         converged=converged_of(ring), match_ratio=match_ratio, rmse=rmse,
                         diverged=torch.zeros((), dtype=torch.bool, device=dev))

    return run
