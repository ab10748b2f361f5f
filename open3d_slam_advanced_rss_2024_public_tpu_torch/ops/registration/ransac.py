"""Global registration: batched-hypothesis RANSAC over feature matches.

Counterpart of the JAX package's ``ops/registration/ransac.py`` (Open3D's
RegistrationRANSACBasedOnFeatureMatching as the reference uses it for
loop-closure proposals, PlaceRecognition.cpp:79-90: FPFH correspondences,
3-point model, edge-length and distance checkers, a minimum correspondence
set).  All ``batch`` hypotheses are drawn, solved in closed form and scored
at once.

The random draws are split from the arithmetic: ``ransac_core`` takes the
triplets ``picks`` and the scoring subset ``sub`` as tensors, and
``ransac_from_correspondences`` draws them (``draw_picks``) from an explicit
host-side ``torch.Generator``: lanes drawn on the host, the valid ones
chosen on the device, so that one seed gives the same draws on the card and
on the CPU.  The JAX package draws with
``jax.random.choice``, whose bits torch cannot reproduce; given the same
indices both cores return the same hypothesis.
"""
from __future__ import annotations

import torch

from ...utils import se3
from ...utils.device import to_device
from .. import bruteforce, cuda_nn, hashgrid
from .. import fpfh as fpfh_ops

Tensor = torch.Tensor


# The quaternion helpers live in ``utils/se3.py``, shared with the
# point-to-point minimizer.
_quat_to_rot = se3.quat_to_matrix


def _kabsch_3pt(src: Tensor, dst: Tensor):
    """Closed-form rigid alignment of 3 point pairs.  src, dst: [B, 3, 3].

    Horn's quaternion form with 30 shifted power steps
    (``se3.horn_rotation``), step for step as the JAX package does it: a
    batched SVD or eigendecomposition of thousands of tiny matrices is a
    poor fit for the GPU's dense solvers and would pick other rotations for
    degenerate triplets (collinear points, tied eigenvalues), which the
    checkers and the inlier score reject either way.
    """
    mu_s = src.mean(dim=1, keepdim=True)
    mu_d = dst.mean(dim=1, keepdim=True)
    R = se3.horn_rotation(torch.einsum("bki,bkj->bij", src - mu_s, dst - mu_d))
    t = mu_d[:, 0, :] - torch.einsum("bij,bj->bi", R, mu_s[:, 0, :])
    return R, t


def _edges(x: Tensor) -> Tensor:
    return torch.stack([torch.linalg.vector_norm(x[:, 0] - x[:, 1], dim=-1),
                        torch.linalg.vector_norm(x[:, 1] - x[:, 2], dim=-1),
                        torch.linalg.vector_norm(x[:, 2] - x[:, 0], dim=-1)], dim=-1)


def ransac_core(src_xyz: Tensor, dst_xyz: Tensor, corr_src: Tensor, corr_dst: Tensor,
                corr_mask: Tensor, picks: Tensor, sub,
                max_correspondence_dist: float = 0.75, checker_distance: float = 0.8,
                checker_edge_length: float = 0.6):
    """The arithmetic of RANSAC for given draws.  ``picks`` int64[B, 3]
    index the correspondence set (one triplet per hypothesis); ``sub``
    int64[S] is the subset the hypotheses are ranked on, or None for the
    full set.  Returns (T 4x4 src->dst, inlier_count, inlier_mask bool[M],
    best int64 — the winning hypothesis)."""
    a = src_xyz[corr_src[picks]]  # [B, 3, 3]
    b = dst_xyz[corr_dst[picks]]
    # Edge-length checker: corresponding triangle edges of similar length.
    ea, eb = _edges(a), _edges(b)
    edge_ok = ((ea > checker_edge_length * eb) & (eb > checker_edge_length * ea)).all(-1)
    R, t = _kabsch_3pt(a, b)
    # Distance checker on the sampled points themselves.
    a_tr = torch.einsum("bij,bkj->bki", R, a) + t[:, None, :]
    samp_ok = (torch.linalg.vector_norm(a_tr - b, dim=-1) < checker_distance).all(-1)

    s_all = src_xyz[corr_src]  # [M, 3]
    d_all = dst_xyz[corr_dst]
    if sub is None:
        s_sc, d_sc, m_sc = s_all, d_all, corr_mask
    else:
        s_sc, d_sc, m_sc = s_all[sub], d_all[sub], corr_mask[sub]
    s_tr = torch.einsum("bij,mj->bmi", R, s_sc) + t[:, None, :]  # [B, S, 3]
    dist = torch.linalg.vector_norm(s_tr - d_sc[None], dim=-1)
    inlier_sc = (dist < max_correspondence_dist) & m_sc[None, :]
    checked = edge_ok & samp_ok
    score = inlier_sc.sum(-1) * checked
    best = torch.argmax(score)
    T = se3.make_transform(R[best], t[best])
    # Full-set inliers for the winner only ([M], not [B, M]).
    s_best = s_all @ R[best].T + t[best]
    best_inliers = (torch.linalg.vector_norm(s_best - d_all, dim=-1)
                    < max_correspondence_dist) & corr_mask
    return T, best_inliers.sum() * checked[best], best_inliers, best


# Lanes tried per draw before ``draw_picks`` falls back to the next valid lane.
DRAW_TRIES = 8


def draw_picks(corr_mask: Tensor, batch: int, score_subset: int,
               generator: torch.Generator):
    """The random part of RANSAC: ``batch`` triplets and a scoring subset,
    drawn with replacement from the valid correspondences.
    ``generator`` is a CPU generator whatever device ``corr_mask`` is on:
    for every draw ``DRAW_TRIES`` lanes are drawn uniformly on the host, go
    over in one pinned copy that does not wait, and the first of them that
    is valid is taken on the device (uniform over the valid lanes; the mask
    is never read back).  A draw whose tries all miss takes the next valid
    lane after its last try, cyclically.  The draws therefore depend on
    the seed and the mask alone, not on the device, and a mask that differs
    in a few lanes (the card's and the CPU's sums round differently)
    changes only the draws that fall on those lanes.
    Returns (picks int64[batch, 3], sub int64[score_subset] or None)."""
    M = corr_mask.shape[0]
    n_sub = score_subset if 0 < score_subset < M else 0
    tries = torch.randint(0, M, (DRAW_TRIES, batch * 3 + n_sub), generator=generator)
    tries = to_device(tries.numpy(), corr_mask.device, dtype=torch.int64)
    hit = corr_mask[tries]
    lanes = tries.gather(0, hit.to(torch.float32).argmax(0)[None])[0]
    # The fallback: with c valid lanes before the last try, the (c + 1)-th
    # valid lane, or the first one past the end.  A set with no valid pair
    # draws from every lane (all rejected later).
    cum = torch.cumsum(corr_mask, 0)
    last = tries[-1]
    want = cum[last] - corr_mask[last].to(torch.int64) + 1
    nxt = torch.searchsorted(cum, torch.where(want > cum[-1], 1, want)).clamp(max=M - 1)
    lanes = torch.where(hit.any(0), lanes, torch.where(cum[-1] > 0, nxt, last))
    return lanes[:batch * 3].reshape(batch, 3), (lanes[batch * 3:] if n_sub else None)


def ransac_from_correspondences(src_xyz: Tensor, dst_xyz: Tensor, corr_src: Tensor,
                                corr_dst: Tensor, corr_mask: Tensor,
                                generator: torch.Generator,
                                max_correspondence_dist: float = 0.75,
                                checker_distance: float = 0.8,
                                checker_edge_length: float = 0.6,
                                batch: int = 4096, score_subset: int = 1024):
    """RANSAC over a precomputed correspondence set.  corr_src/corr_dst:
    int64[M] paired indices; corr_mask: bool[M].  Hypotheses are ranked on
    a ``score_subset``-sized draw of the set (0: the full set); the count
    and mask returned for the winner are over the full set.
    Returns (T 4x4 src->dst, inlier_count, inlier_mask bool[M])."""
    picks, sub = draw_picks(corr_mask, batch, score_subset, generator)
    T, n_best, inliers, _ = ransac_core(
        src_xyz, dst_xyz, corr_src, corr_dst, corr_mask, picks, sub,
        max_correspondence_dist=max_correspondence_dist,
        checker_distance=checker_distance, checker_edge_length=checker_edge_length)
    return T, n_best, inliers


def register_features(src_xyz: Tensor, src_mask: Tensor, src_feat: Tensor,
                      dst_xyz: Tensor, dst_mask: Tensor, dst_feat: Tensor,
                      generator: torch.Generator,
                      max_correspondence_dist: float = 0.75,
                      checker_distance: float = 0.8,
                      checker_edge_length: float = 0.6, batch: int = 4096):
    """Mutual-NN FPFH correspondences + batched RANSAC.
    Returns (T src->dst, inlier_count, corr_src, corr_dst, inlier_mask)."""
    ab, ok = fpfh_ops.mutual_nearest_correspondences(src_feat, src_mask, dst_feat, dst_mask)
    corr_src = torch.arange(src_xyz.shape[0], device=src_xyz.device)
    T, n_inliers, inlier_mask = ransac_from_correspondences(
        src_xyz, dst_xyz, corr_src, ab, ok, generator,
        max_correspondence_dist=max_correspondence_dist,
        checker_distance=checker_distance, checker_edge_length=checker_edge_length,
        batch=batch)
    return T, n_inliers, corr_src, ab, inlier_mask


def information_matrix_from_point_clouds(src_xyz: Tensor, src_mask: Tensor, ref_grid,
                                         T: Tensor, max_dist, matcher: str = "cuda",
                                         nn_ref=None):
    """Open3D GetInformationMatrixFromPointClouds: Sigma = sum over matched
    points of G^T G with G = [-[q]x | I] rows, q the matched reference
    point.  ``matcher``: "cuda" (kernel K1, its plain twin on CPU tensors),
    "bruteforce", or "hashgrid" (the JAX package's default; ``ref_grid``
    then comes from ``hashgrid.build``); ``nn_ref`` is K1's prepared reference where the caller
    has one.  A query with no reference within ``max_dist`` has weight 0 and
    its gathered point is replaced by zeros before it is used: K1 returns
    index 0 for such a lane and the twin the nearest reference at any
    distance, and neither may reach the sum.
    Returns (info f32[6, 6], matched count)."""
    from .icp import KERNEL_MATCHERS

    src = se3.apply(T, src_xyz)
    if matcher in KERNEL_MATCHERS:
        idx, d2 = cuda_nn.nn(src, ref_grid.points if nn_ref is None else nn_ref, max_dist)
        found = src_mask & (d2 <= float(max_dist) ** 2)
    elif matcher == "bruteforce":
        idx, d2, found = bruteforce.nn(src, src_mask, ref_grid.points, max_dist)
    else:
        idx, d2, found = hashgrid.query_nn(ref_grid, src, src_mask, max_dist)
    q = torch.where(found[:, None], ref_grid.points[idx], 0.0)
    w = found.to(torch.float32)
    I = torch.eye(3, dtype=q.dtype, device=q.device).expand(q.shape[0], 3, 3)
    G = torch.cat([-se3.skew(q), I], dim=-1) * w[:, None, None]
    return torch.einsum("nij,nik->jk", G, G), w.sum()
