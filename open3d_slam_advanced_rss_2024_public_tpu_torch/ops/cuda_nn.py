"""K1: radius-bounded nearest neighbour — CUDA kernel wrapper and plain twin.

Replaces the Pallas TPU kernel ``_nn_kernel`` of the JAX package's
``ops/pallas_nn.py`` (``pallas_nn.py:65-105``, launched from ``_nn_block``
at ``:154`` through ``nn_pallas``, ``:175-242``).  The kernel itself is
``csrc/nn.cu``.

Contract (the JAX wrapper's): ``nn(query f32[M,3], ref, max_dist) ->
(idx int64[M], d2 f32[M])``, where ``ref`` is the reference points
``f32[N,3]`` or an ``NNRef`` prepared from them.  Points with ``|x| >= 1e7``
(the mask sentinel) are invalid.  For every valid query whose nearest valid
ref lies within ``max_dist`` the result is the exact nearest neighbour, the
lowest index on an exact distance tie, and ``d2`` the float32
``sum_c (q_c - p_c)^2`` of that pair after both were shifted by the valid
refs' centroid.  Beyond ``max_dist`` the candidate is unspecified and
callers gate on ``d2``: the plain twin returns the nearest ref whatever its
distance, the kernel the nearest among the admissible tiles, or index 0
with ``d2 = +inf`` for a query with none (or an invalid one).

The reference side of the search — centroid, padded coordinate rows,
ref-tile boxes — depends on the refs alone.  ``prepare_ref`` computes it
once; ICP prepares its reference once per lag block and hands the ``NNRef``
to every iteration.  A call with a prepared reference is one host call that
enqueues two kernels (the query-side tile plan and the sweep) and allocates
three buffers.

What bounds it on an H100 and what the design does about it: see the note
at the top of ``csrc/nn.cu``.

``nn`` launches the kernels for CUDA tensors and uses ``nn_plain`` only for
tensors on the CPU; ``chip_smoke.py`` holds the kernels against ``nn_plain``
on the card.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Union

import torch

from . import _build, cuda_tiles
from .cuda_tiles import FAR as _FAR
from .cuda_tiles import TQ

Tensor = torch.Tensor

# The most blocks one query tile's list of ref tiles is cut into.
MAX_CHUNKS = 32

# Launches of the sweep kernel since the last reset, one per call of ``nn``
# on CUDA tensors (chip_smoke.py reads it to show the main path made them).
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def launch_count() -> int:
    """``launches`` now: the tracer notes it where a span enqueues sweeps."""
    return launches


@dataclasses.dataclass(frozen=True)
class NNRef:
    """A reference prepared for ``nn``.  ``points`` are the refs as given;
    on a CUDA device ``center`` f32[3] is their valid centroid, ``soa``
    f32[3, N_pad] the shifted refs as coordinate rows padded with ``_FAR``,
    and ``p_min``/``p_max`` f32[N_pad/TP, 3] the ref-tile boxes.  On the
    CPU only ``points`` is set: the plain twin needs nothing prepared."""

    points: Tensor
    center: Optional[Tensor] = None
    soa: Optional[Tensor] = None
    p_min: Optional[Tensor] = None
    p_max: Optional[Tensor] = None


def _demean(query_xyz: Tensor, ref_xyz: Tensor, ref_mask: Tensor = None):
    """Shift both clouds by the valid-ref centroid (per leading batch row);
    invalid refs (the sentinel, or ``ref_mask`` False) go to ``_FAR``.
    Distances are translation-invariant; near the origin the float32
    differences keep more bits.  Returns (q, r, ref_valid)."""
    ref_valid = ref_xyz[..., 0].abs() < 1e7
    if ref_mask is not None:
        ref_valid = ref_valid & ref_mask
    center = cuda_tiles.centroid(ref_xyz, ref_valid)
    q = query_xyz - center[..., None, :]
    r = torch.where(ref_valid[..., None], ref_xyz - center[..., None, :], _FAR)
    return q, r, ref_valid


def _sq_dist(a: Tensor, b: Tensor) -> Tensor:
    """float32 sum_c (a_c - b_c)^2 in the kernel's operation order."""
    dx, dy, dz = (a[..., c] - b[..., c] for c in range(3))
    return (dx * dx + dy * dy) + dz * dz


def nn_plain(query_xyz: Tensor, ref_xyz: Tensor, max_dist=0.5):
    """The kernel's plain twin: the same contract by a dense sweep over
    every ref (chunked over queries), with the kernel's float32 arithmetic
    — so within ``max_dist`` it returns bit-identical d2 and the same
    index, ties included."""
    q, r, _ = _demean(query_xyz, ref_xyz)
    m, n = q.shape[0], r.shape[0]
    chunk = max(1, (1 << 24) // max(n, 1))
    idx = torch.empty((m,), dtype=torch.int64, device=q.device)
    for i in range(0, m, chunk):
        qc = q[i:i + chunk]
        d2 = _sq_dist(qc[:, None, :], r[None, :, :])
        idx[i:i + chunk] = torch.argmin(d2, dim=-1)
    return idx, _sq_dist(q, r[idx])


def _check(name: str, t: Tensor) -> None:
    cuda_tiles.check_points(name, t, dim=2)


_fns = None


def _kernel():
    global _fns
    if _fns is None:
        lib = _build.library("nn")
        cuda_tiles.check_constants(lib, "nn")
        fn = lib.nn_launch
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4
                       + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_int]
                       + [ctypes.c_void_p] * 7 + [ctypes.POINTER(ctypes.c_int)])
        fn.restype = ctypes.c_int
        _fns = fn
    return _fns


def prepare_ref(ref_xyz: Tensor) -> NNRef:
    """The reference side of ``nn``, computed once per reference.  The
    centroid comes from the very torch operations the plain twin uses, so
    kernel and twin shift by the same float32 vector."""
    if ref_xyz.device.type == "cpu":
        return NNRef(points=ref_xyz)
    ref_xyz = ref_xyz.contiguous()
    _check("ref_xyz", ref_xyz)
    if ref_xyz.shape[0] == 0:
        raise ValueError("ref_xyz is empty")
    center = cuda_tiles.centroid(ref_xyz, ref_xyz[:, 0].abs() < 1e7)
    soa, p_min, p_max = cuda_tiles.tile_prepare(ref_xyz[None], None, center[None])
    return NNRef(points=ref_xyz, center=center, soa=soa[0], p_min=p_min[0], p_max=p_max[0])


def tiles_per_block(list_length: int, np_tiles: int) -> int:
    """Ref tiles one block of the sweep takes from a list of ``list_length``
    (``nn_sweep_kernel`` derives the same split on the device)."""
    return max(1, -(-list_length // min(MAX_CHUNKS, np_tiles)))


def _launch(query_xyz: Tensor, ref: NNRef, max_dist, with_plan: bool = False):
    """One call of the launch function on the current stream: the tile
    plan and the sweep -> (idx int64[M], d2 f32[M]), and with ``with_plan``
    also the plan it swept (tile_list int32[M_pad/TQ, N_pad/TP], tile_count
    int32[M_pad/TQ]).  Adds the kernels the call enqueued to the counts."""
    global launches
    m, n = query_xyz.shape[0], ref.points.shape[0]
    nq_tiles, np_tiles = -(-m // TQ), ref.p_min.shape[0]
    dev = query_xyz.device
    idx = torch.empty((m,), dtype=torch.int64, device=dev)
    d2 = torch.empty((m,), dtype=torch.float32, device=dev)
    buf, (tile_list, tile_count, tickets, keys) = cuda_tiles.scratch(
        dev, nq_tiles * np_tiles, nq_tiles, nq_tiles, 2 * nq_tiles * TQ)
    enqueued = (ctypes.c_int * 2)()
    err = _kernel()(query_xyz.data_ptr(), m, ref.center.data_ptr(), ref.soa.data_ptr(),
                    ref.p_min.data_ptr(), ref.p_max.data_ptr(), np_tiles, n,
                    cuda_tiles.admit_r2(max_dist), min(MAX_CHUNKS, np_tiles), tile_list,
                    tile_count, keys, tickets, idx.data_ptr(), d2.data_ptr(),
                    cuda_tiles.stream_of(query_xyz), enqueued)
    cuda_tiles.plan_launches += enqueued[0]
    launches += enqueued[1]
    _build.check(err, "nn_launch")
    if with_plan:
        return (idx, d2, cuda_tiles.piece(buf, tile_list, (nq_tiles, np_tiles)),
                cuda_tiles.piece(buf, tile_count, (nq_tiles,)))
    return idx, d2


def nn(query_xyz: Tensor, ref: Union[Tensor, NNRef], max_dist=0.5):
    """Nearest neighbour within ``max_dist`` (module contract above)."""
    points = ref.points if isinstance(ref, NNRef) else ref
    if query_xyz.device.type == "cpu" and points.device.type == "cpu":
        return nn_plain(query_xyz, points, max_dist)
    query_xyz = query_xyz.contiguous()
    _check("query_xyz", query_xyz)
    if query_xyz.device != points.device:
        raise ValueError("query_xyz and ref_xyz are on different devices")
    if not isinstance(ref, NNRef):
        ref = prepare_ref(ref)
    return _launch(query_xyz, ref, max_dist)
