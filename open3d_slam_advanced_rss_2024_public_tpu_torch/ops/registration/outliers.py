"""Correspondence outlier weighting — batched, mask-aware.

Counterpart of the JAX package's ``ops/registration/outliers.py``
(reference OutlierFiltersImpl.{h,cpp}:59-594): the TrimmedDist and
SurfaceNormal filters of the production icp.yaml chain, MaxDist, MinDist,
MedianDist, VarTrimmedDist, and RobustOutlierFilter's eight M-estimator
kernels with their scale estimators.  Each filter maps a match set to
per-correspondence weights in [0, 1]; weights multiply.  The quantile takes
the sort branch of ``_dists_quantile`` (``outliers.py:71-75``); the radix
select above it was written for the TPU and is not ported.

``torch.median`` returns the lower of the two middle values and
``torch.std`` is unbiased; the JAX package's ``nanmedian`` interpolates
linearly between them and its ``nanstd`` divides by n, so both are written
out here to the JAX semantics.
"""
from __future__ import annotations

import math

import torch

Tensor = torch.Tensor


def _dists_quantile(sq_dists: Tensor, valid: Tensor, ratio, slot_mask: Tensor = None):
    """``Matches::getDistsQuantile``: the distance at floor(ratio * n) of
    the sorted list, n counting every slot of ``slot_mask`` (not-found
    matches sort as +inf)."""
    if slot_mask is None:
        slot_mask = valid
    n = sq_dists.shape[-1]
    d = torch.where(valid, sq_dists, float("inf"))
    n_slots = slot_mask.sum(-1, dtype=torch.int32).to(torch.float32)
    kth = torch.clamp((ratio * n_slots).to(torch.int64), 0, n - 1)
    d_sorted, _ = torch.sort(d, dim=-1)
    return torch.gather(d_sorted, -1, kth[..., None])[..., 0], d


def trimmed_dist_weights(sq_dists: Tensor, valid: Tensor, ratio: float,
                         slot_mask: Tensor = None) -> Tensor:
    """Keep matches at or below the ``ratio`` distance quantile."""
    thresh, d = _dists_quantile(sq_dists, valid, ratio, slot_mask)
    return (valid & (d <= thresh[..., None])).to(torch.float32)


def surface_normal_weights(src_normals: Tensor, ref_normals: Tensor, valid: Tensor,
                           max_angle: float) -> Tensor:
    """Reject matches whose normals disagree by more than max_angle; points
    without a normal (zero vector) pass."""
    dot = (src_normals * ref_normals).sum(-1).abs()
    has_n = ((torch.linalg.vector_norm(src_normals, dim=-1) > 1e-6)
             & (torch.linalg.vector_norm(ref_normals, dim=-1) > 1e-6))
    ok = dot >= math.cos(max_angle)
    return (valid & torch.where(has_n, ok, True)).to(torch.float32)


def max_dist_weights(sq_dists: Tensor, valid: Tensor, max_dist: float) -> Tensor:
    return (valid & (sq_dists <= max_dist ** 2)).to(torch.float32)


def min_dist_weights(sq_dists: Tensor, valid: Tensor, min_dist: float) -> Tensor:
    return (valid & (sq_dists >= min_dist ** 2)).to(torch.float32)


def median_dist_weights(sq_dists: Tensor, valid: Tensor, factor: float,
                        slot_mask: Tensor = None) -> Tensor:
    """Keep matches below factor * median sq-distance (MedianDistOutlierFilter:
    ``dists <= factor * getDistsQuantile(0.5)``)."""
    med, d = _dists_quantile(sq_dists, valid, 0.5, slot_mask)
    return (valid & (d <= factor * med[..., None])).to(torch.float32)


def var_trimmed_dist_weights(sq_dists: Tensor, valid: Tensor, min_ratio: float = 0.05,
                             max_ratio: float = 0.99, lam: float = 0.95) -> Tensor:
    """Adaptive trimming: the ratio minimizing the FRMSD criterion
    (VarTrimmedDistOutlierFilter::optimizeInlierRatio)."""
    n = sq_dists.shape[-1]
    d = torch.where(valid, sq_dists, float("inf"))
    d_sorted, _ = torch.sort(d, dim=-1)
    n_valid = torch.clamp(valid.sum(-1, dtype=torch.int32), min=1)
    ranks = torch.arange(1, n + 1, dtype=torch.float32, device=d.device)
    ratios = ranks / n_valid.to(torch.float32)[..., None]
    csum = torch.cumsum(torch.where(torch.isfinite(d_sorted), d_sorted, 0.0), dim=-1)
    mse = csum / ranks
    frmsd = torch.where((ratios >= min_ratio) & (ratios <= max_ratio),
                        mse / torch.pow(torch.clamp(ratios, 1e-6, 1.0), 2.0 * lam),
                        float("inf"))
    thresh = torch.gather(d_sorted, -1, torch.argmin(frmsd, dim=-1, keepdim=True))[..., 0]
    return (valid & (d <= thresh[..., None])).to(torch.float32)


# --- Robust M-estimator kernels (RobustOutlierFilter) ---------------------

def nanmedian(x: Tensor) -> Tensor:
    """Median over the last axis ignoring NaN, as ``jnp.nanmedian``: linear
    interpolation at 0.5 * (n - 1) of the sorted non-NaN values (the mean
    of the two middle values for an even count), NaN where none is left."""
    n = (~torch.isnan(x)).sum(-1, dtype=torch.int32).to(x.dtype)
    s, _ = torch.sort(x, dim=-1)  # NaN sorts last
    q = 0.5 * (n - 1.0)
    low, high = torch.floor(q), torch.ceil(q)
    hw = q - low
    last = torch.clamp(n - 1.0, min=0.0)
    lo = torch.gather(s, -1, torch.clamp(low, min=0.0).minimum(last).long()[..., None])[..., 0]
    hi = torch.gather(s, -1, torch.clamp(high, min=0.0).minimum(last).long()[..., None])[..., 0]
    return lo * (1.0 - hw) + hi * hw


def nanstd(x: Tensor) -> Tensor:
    """Population standard deviation (ddof 0) over the last axis ignoring
    NaN, as ``jnp.nanstd``."""
    ok = ~torch.isnan(x)
    n = ok.sum(-1, dtype=torch.int32).to(x.dtype)
    mean = torch.where(ok, x, 0.0).sum(-1) / n
    centered = torch.where(ok, x - mean[..., None], 0.0)
    return torch.sqrt((centered * centered).sum(-1) / n)


def robust_scale(sq_dists: Tensor, valid: Tensor, estimator: str) -> Tensor:
    """Scale estimators of RobustOutlierFilter (OutlierFiltersImpl.cpp:
    503-536) over the found matches: mad -> sqrt(median |d2 - median d2|),
    std -> sqrt(std d2), berg -> 1.9 sqrt(median d2) (its first-iteration
    seed), none -> 1."""
    d = torch.where(valid, sq_dists, float("nan"))
    if estimator == "mad":
        med = nanmedian(d)
        return torch.sqrt(torch.clamp(nanmedian((d - med[..., None]).abs()), min=1e-12))
    if estimator == "std":
        return torch.sqrt(torch.clamp(nanstd(d), min=1e-12))
    if estimator == "berg":
        return 1.9 * torch.sqrt(torch.clamp(nanmedian(d), min=1e-12))
    return torch.ones((), dtype=torch.float32, device=sq_dists.device)


def robust_weights(sq_dists: Tensor, valid: Tensor, kind: str, k: float,
                   scale_estimator: str = "none", p2plane_sq: Tensor = None,
                   distance_type: str = "point2point",
                   approximation: float = float("inf")) -> Tensor:
    """RobustOutlierFilter weights (OutlierFiltersImpl.cpp:497-594):
    e2 = dist^2 / scale^2, dist^2 the match distance (point2point) or the
    squared point-to-plane residual (point2plane); matches beyond
    ``approximation`` get weight 0."""
    dists = sq_dists if distance_type == "point2point" else p2plane_sq
    scale = robust_scale(dists, valid, scale_estimator)
    e2 = dists / torch.clamp(scale * scale, min=1e-20)
    k2 = k * k
    kind = kind.lower()
    if kind == "cauchy":
        w = 1.0 / (1.0 + e2 / k2)
    elif kind == "welsch":
        w = torch.exp(-e2 / k2)
    elif kind in ("sc", "switchable", "switchableconstraint"):
        w = torch.where(e2 < k, 1.0, 4.0 * k2 / torch.clamp(k + e2, min=1e-12) ** 2)
    elif kind in ("gm", "gemanmcclure"):
        w = k2 / torch.clamp(k + e2, min=1e-12) ** 2
    elif kind == "tukey":
        w = torch.where(e2 < k2, (1.0 - e2 / k2) ** 2, 0.0)
    elif kind == "huber":
        w = torch.where(e2 < k2, 1.0, k / torch.sqrt(torch.clamp(e2, min=1e-20)))
    elif kind == "l1":
        w = 1.0 / torch.sqrt(torch.clamp(e2, min=1e-12))
    elif kind == "student":
        d_dim = 3.0
        p = torch.pow(1.0 + e2 / k, -(k + d_dim) / 2.0)
        w = p * (k + d_dim) / torch.clamp(k + e2, min=1e-12)
    else:
        raise ValueError(f"unknown robust kernel: {kind}")
    if approximation != float("inf"):
        w = torch.where(e2 >= approximation * approximation, 0.0, w)
    return torch.where(valid, w, 0.0).to(torch.float32)
