"""Brute-force exact nearest neighbours — the ``matcher="bruteforce"`` engine
and the k-nearest search of the normal and FPFH estimators.

Counterpart of ``_demean``, ``nn``, ``knn`` and ``knn_approx`` of the JAX
package's ``ops/bruteforce.py`` (``:47-142``).  The JAX version ranks by the
|q|^2 + |r|^2 - 2 q.r expansion, which its TPU matrix unit favours; here
the sweep is the direct float32 one of K1's plain twin
(``cuda_nn.nn_plain``), so the brute-force matcher and the kernel return
the same neighbours.  ``knn`` ranks by the expansion, as the JAX package
does (one matrix product per query chunk), and returns the exact distances
of the gathered neighbours.  ``knn_approx`` is ``knn``: the JAX package's is
``lax.approx_max_k`` at ~98% recall, which has no counterpart here, and the
exact top-k is what its callers approximate.
"""
from __future__ import annotations

import numpy as np
import torch

from .cuda_nn import _demean, nn_plain

Tensor = torch.Tensor


def nn(query_xyz: Tensor, query_mask: Tensor, ref_xyz: Tensor, max_dist):
    """Exact nearest neighbour within max_dist.
    Returns (index int64[M] into ref, sq_dist f32[M], found bool[M])."""
    idx, d2 = nn_plain(query_xyz, ref_xyz, max_dist)
    r = np.float32(max_dist)
    return idx, d2, query_mask & (d2 <= float(r * r))


# Query rows per chunk: bounds the transient [chunk, N] distance block.
_CHUNK = 2048


def knn(query_xyz: Tensor, query_mask: Tensor, ref_xyz: Tensor, max_dist, k: int = 16):
    """Exact k nearest neighbours within max_dist.
    Returns (indices int64[M, k], sq_dists f32[M, k] ascending, ok bool[M, k])."""
    q, r, _ = _demean(query_xyz, ref_xyz)
    r2 = (r * r).sum(-1)
    idx = torch.empty((q.shape[0], k), dtype=torch.int64, device=q.device)
    for i in range(0, q.shape[0], _CHUNK):
        qc = q[i:i + _CHUNK]
        d2 = (qc * qc).sum(-1, keepdim=True) + r2[None, :] - 2.0 * (qc @ r.T)
        idx[i:i + _CHUNK] = torch.topk(d2, k, dim=-1, largest=False, sorted=True).indices
    # Exact distances from the gathered matches (the ranked d2 carries the
    # expansion's rounding).
    diff = q[:, None, :] - r[idx]
    d2 = (diff * diff).sum(-1)
    r_max = np.float32(max_dist)
    return idx, d2, query_mask[:, None] & (d2 <= float(r_max * r_max))


knn_approx = knn
