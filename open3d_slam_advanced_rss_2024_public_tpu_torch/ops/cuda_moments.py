"""K2: radius-neighbourhood moments — CUDA kernel wrapper and plain twin.

Replaces the Pallas TPU kernel ``_moments_kernel`` of the JAX package's
``ops/pallas_moments.py`` (``pallas_moments.py:52-79``, launched from
``radius_moments`` at ``:130``).  The kernel itself is ``csrc/moments.cu``.

Contract (the JAX function's): ``radius_moments(xyz f32[..., M, 3],
mask bool[..., M], radius) -> (count f32[..., M], cov f32[..., M, 3, 3])``
— for every point, the number of valid points within ``radius`` (itself
included) and their covariance.  Outputs of invalid lanes are garbage;
callers gate on their mask.  A leading batch dimension carries the K scans
of a lag block: one launch per block.

One call on a CUDA tensor is one host call that enqueues three kernels
(``tile_prepare`` and ``tile_plan`` of ``csrc/tiles.cuh``, then the sweep)
and allocates three buffers; count and covariance come out of the sweep as
they are returned.

What bounds it on an H100 and what the design does about it: see the note
at the top of ``csrc/moments.cu``.

``radius_moments`` launches the kernels for CUDA tensors and uses
``radius_moments_plain`` only for tensors on the CPU.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, cuda_tiles
from .cuda_nn import _demean, _sq_dist
from .cuda_tiles import TP, TQ

Tensor = torch.Tensor

# Launches of the sweep kernel since the last reset, one per call of
# ``radius_moments`` on CUDA tensors.
launches = 0

# Where the six sums of the upper triangle sit in a row-major 3x3.
_SYMMETRIC = [0, 1, 2, 1, 3, 4, 2, 4, 5]


def reset_launches() -> None:
    global launches
    launches = 0


def _count_cov(acc: Tensor):
    """acc [..., 10] = (n, Σd, Σ dd^T upper triangle) with d = q - p ->
    (count, covariance of the neighbourhood), in the sweep's epilogue
    arithmetic: sums over max(n, 1), then m2 - mean mean^T."""
    count = acc[..., 0]
    denom = torch.clamp(count, min=1.0)[..., None]
    mean = acc[..., 1:4] / denom
    m2 = (acc[..., 4:10] / denom)[..., _SYMMETRIC].reshape(acc.shape[:-1] + (3, 3))
    return count, m2 - mean[..., :, None] * mean[..., None, :]


def moments_plain(x: Tensor, p: Tensor, r2: float) -> Tensor:
    """acc [K, M, 10] by a dense sweep: x [K, M, 3] queries, p [K, N, 3]
    refs, the kernel's float32 d2 and admission test."""
    K, M, _ = x.shape
    chunk = max(1, (1 << 22) // max(p.shape[1], 1))
    acc = x.new_empty((K, M, 10))
    for b in range(K):
        for i in range(0, M, chunk):
            q = x[b, i:i + chunk, None, :]
            d = [q[..., c] - p[b, None, :, c] for c in range(3)]
            w = (_sq_dist(q, p[b, None]) <= r2).to(torch.float32)
            wd = [w * dc for dc in d]
            acc[b, i:i + chunk] = torch.stack(
                [w.sum(-1)] + [v.sum(-1) for v in wd]
                + [(wd[a] * d[c]).sum(-1) for a, c in
                   ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))], dim=-1)
    return acc


def radius_moments_plain(xyz: Tensor, mask: Tensor, radius):
    """The kernel's plain twin (same contract, dense sweep)."""
    batched = xyz.dim() == 3
    if not batched:
        xyz, mask = xyz[None], mask[None]
    x, p, _ = _demean(xyz, xyz, mask)
    count, cov = _count_cov(moments_plain(x, p, cuda_tiles.r2_of(radius)))
    return (count, cov) if batched else (count[0], cov[0])


def _check(xyz: Tensor, mask: Tensor) -> None:
    if xyz.dim() != 3 or mask.dim() != 2:
        raise ValueError(f"need xyz [K, M, 3] and mask [K, M], got "
                         f"{tuple(xyz.shape)} and {tuple(mask.shape)}")
    cuda_tiles.check_points("xyz", xyz, mask)


_launch_fn = None


def _kernel():
    global _launch_fn
    if _launch_fn is None:
        lib = _build.library("moments")
        cuda_tiles.check_constants(lib, "moments")
        fn = lib.moments_launch
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_float] * 2
                       + [ctypes.c_void_p] * 8 + [ctypes.POINTER(ctypes.c_int)])
        fn.restype = ctypes.c_int
        _launch_fn = fn
    return _launch_fn


def _launch(xyz: Tensor, mask: Tensor, center: Tensor, radius, with_plan: bool = False):
    """One call of the launch function on the current stream: the two plan
    kernels and the sweep -> (count f32[K, M], cov f32[K, M, 3, 3]), and
    with ``with_plan`` also the plan it swept (tile_list int32[K, M_pad/TQ,
    M_pad/TP], tile_count int32[K, M_pad/TQ]).  Adds the kernels the call
    enqueued to the counts."""
    global launches
    K, m, _ = xyz.shape
    nq_tiles, np_tiles = -(-m // TQ), -(-m // TP)
    count = torch.empty((K, m), dtype=torch.float32, device=xyz.device)
    cov = torch.empty((K, m, 3, 3), dtype=torch.float32, device=xyz.device)
    buf, (soa, p_min, p_max, tile_list, tile_count) = cuda_tiles.scratch(
        xyz.device, K * 3 * np_tiles * TP, K * np_tiles * 3, K * np_tiles * 3,
        K * nq_tiles * np_tiles, K * nq_tiles)
    enqueued = (ctypes.c_int * 3)()
    err = _kernel()(xyz.data_ptr(), mask.data_ptr(), center.data_ptr(), K, m,
                    cuda_tiles.r2_of(radius), cuda_tiles.admit_r2(radius), soa, p_min, p_max,
                    tile_list, tile_count, count.data_ptr(), cov.data_ptr(),
                    cuda_tiles.stream_of(xyz), enqueued)
    cuda_tiles.prepare_launches += enqueued[0]
    cuda_tiles.plan_launches += enqueued[1]
    launches += enqueued[2]
    _build.check(err, "moments_launch")
    if with_plan:
        return (count, cov, cuda_tiles.piece(buf, tile_list, (K, nq_tiles, np_tiles)),
                cuda_tiles.piece(buf, tile_count, (K, nq_tiles)))
    return count, cov


def radius_moments(xyz: Tensor, mask: Tensor, radius):
    """Per-point neighbourhood count and covariance (module contract)."""
    if xyz.device.type == "cpu" and mask.device.type == "cpu":
        return radius_moments_plain(xyz, mask, radius)
    batched = xyz.dim() == 3
    if not batched:
        xyz, mask = xyz[None], mask[None]
    xyz, mask = xyz.contiguous(), mask.contiguous()
    _check(xyz, mask)
    center = cuda_tiles.centroid(xyz, mask & (xyz[..., 0].abs() < 1e7))
    count, cov = _launch(xyz, mask, center, radius)
    return (count, cov) if batched else (count[0], cov[0])
