"""The chip's peaks and the least work of the two hand-written kernels.

A kernel call's least time is the larger of its bytes over the HBM rate and
its float32 operations over the non-tensor float32 rate.  The bytes are
every input byte read once and every output byte written once, by the
call's contract; the operations are those its inputs need, counted from the
inputs alone, so that any implementation of the same contract is held to
the same count:

* K1, ``nn(query f32[M, 3], ref f32[N, 3], max_dist) -> (idx i64[M],
  d2 f32[M])``: every valid (query, ref) pair within ``max_dist`` is a
  candidate that has to be measured, 8 operations (3 differences, 3
  squares, 2 sums) and a compare;
* K2, ``radius_moments(xyz f32[K, M, 3], mask bool[K, M], radius) ->
  (count f32[K, M], cov f32[K, M, 3, 3])``: every valid pair within
  ``radius`` is measured (9) and accumulated into the count, the first and
  the six second moments (16); each valid point's covariance takes 20 more.
"""
from __future__ import annotations

import torch

from .reference import geometry

# NVIDIA H100 SXM5 80 GB data sheet, dense, at the 700 W limit.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
SENTINEL_ABS = 1e7  # a lane whose |x| reaches this is no point (the contract's mask)


def least_seconds(n_bytes: float, n_ops: float) -> float:
    return max(n_bytes / PEAK_BYTES_PER_S, n_ops / PEAK_F32_OPS_PER_S)


def _valid(xyz: torch.Tensor) -> torch.Tensor:
    return xyz[..., 0].abs() < SENTINEL_ABS


def nn_work(query: torch.Tensor, ref: torch.Tensor, max_dist: float):
    """(bytes, operations) of one K1 call."""
    m, n = query.shape[0], ref.shape[0]
    pairs = geometry.count_within(query[_valid(query)], ref[_valid(ref)], float(max_dist))
    return 12.0 * m + 12.0 * n + 12.0 * m, 9.0 * pairs


def moments_work(xyz: torch.Tensor, mask: torch.Tensor, radius: float):
    """(bytes, operations) of one K2 call."""
    if xyz.dim() == 2:
        xyz, mask = xyz[None], mask[None]
    k, m = mask.shape
    ops = 0.0
    for b in range(k):
        p = xyz[b][mask[b] & _valid(xyz[b])]
        ops += 25.0 * geometry.count_within(p, p, float(radius)) + 20.0 * p.shape[0]
    return 13.0 * k * m + 40.0 * k * m, ops
