"""Tile planning for K1 and K2 — CUDA kernel wrappers and plain versions.

Both sweeps (``ops/cuda_nn.py``, ``ops/cuda_moments.py``) visit, for every
tile of queries, only the tiles of reference points whose bounding box lies
within the search radius of the query tile's box.  The JAX package does that
bookkeeping in XLA around its Pallas kernels (``_tile_aabbs`` and
``_admissible_lists`` of ``ops/pallas_nn.py:108-135``, the de-meaning and
padding of ``nn_pallas``, ``:187-215``); here it is two hand-written
kernels, ``csrc/tiles.cuh``:

``tile_prepare`` (reference side)
    ``xyz f32[B, N, 3], mask bool[B, N] | None, center f32[B, 3] ->
    (soa f32[B, 3, N_pad], p_min f32[B, N_pad/TP, 3], p_max)``.  Valid
    points (``|x| < 1e7`` and ``mask``) shifted by ``center``, every other
    lane and the padding at ``FAR``, as three coordinate rows; and each
    TP-point tile's box over its valid lanes (``+inf, -inf`` when empty).
``tile_plan`` (query side)
    ``xyz f32[B, M, 3], mask, center, p_min, p_max, max_dist ->
    (tile_list int32[B, M_pad/TQ, N_pad/TP], tile_count int32[B, M_pad/TQ],
    q_min, q_max)``.  Each TQ-query tile's box over its valid lanes
    (``|x - center| < 1e7`` and ``mask``) and the ids of the reference tiles
    whose box gap is at most ``max_dist``, ascending, ``tile_count`` of them;
    the rest of a row is unspecified.  A tile with no valid lane admits no
    pair (its infinite gap would pass at ``max_dist`` inf).

The kernel admits a pair when the squared gap is at most ``admit_r2`` — a
few ulps above ``max_dist**2`` — so its list always holds the plain
version's (which tests against ``max_dist**2`` itself, as the JAX package
does) and may hold a pair more where the plain test sits on its rounding
edge.  A superset costs a little work and never an answer.

Each wrapper launches its kernel for CUDA tensors and uses its plain version
only for tensors on the CPU.  On the main path ``tile_prepare`` is launched
from here (once per ICP reference, by ``cuda_nn.prepare_ref``) and from
inside K2's launch function; ``tile_plan`` from inside K1's and K2's.  Those
launch functions report which kernels they enqueued, and their wrappers add
that report to the counts below straight after the call.

``csrc/tiles.cuh`` is compiled into each of the three libraries (``tiles``,
``nn``, ``moments``), so the kernels ``tile_prepare`` and ``tile_plan``
launch here are builds of the same source as the ones K1 and K2 enqueue, not
the same binary; ``chip_smoke.py`` therefore also holds the lists that K1's
and K2's own launch functions wrote against the plain version.  The tile
sizes and the two sentinels below mirror the header's constants (the plain
versions and the buffer sizes need them on the host); every library is held
against them when it is loaded (``check_constants``).
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from . import _build

Tensor = torch.Tensor

TQ = 64            # queries per tile
TP = 128           # refs per tile
FAR = 3.0e7        # padded / invalid refs: never admissible, never winning
VALID_ABS = 1.0e7  # |x| at or beyond this marks an invalid point

# Kernel launches since the last reset.
prepare_launches = 0
plan_launches = 0


def reset_launches() -> None:
    global prepare_launches, plan_launches
    prepare_launches = 0
    plan_launches = 0


@functools.lru_cache(maxsize=None)
def r2_of(radius) -> float:
    """float32 ``radius**2``, the sweeps' admission threshold."""
    r = np.float32(radius)
    return float(r * r)


@functools.lru_cache(maxsize=None)
def admit_r2(max_dist) -> float:
    """The plan kernel's threshold on the squared box gap: eight ulps above
    float32 ``max_dist**2``."""
    return float(np.float32(r2_of(max_dist)) * np.float32(1.000001))


def centroid(xyz: Tensor, valid: Tensor) -> Tensor:
    """Mean of the valid points, [..., N, 3] -> [..., 3] (0 when none)."""
    nv = torch.clamp(valid.sum(-1, dtype=torch.float32), min=1.0)
    return torch.where(valid[..., None], xyz, 0.0).sum(-2) / nv[..., None]


def tile_aabbs(xyz: Tensor, valid: Tensor, tile: int):
    """Per-tile AABBs of the valid points: xyz [..., n_tiles*tile, 3] ->
    (mins, maxs) [..., n_tiles, 3]; empty tiles get (+inf, -inf)."""
    t = xyz.reshape(xyz.shape[:-2] + (-1, tile, 3))
    v = valid.reshape(valid.shape[:-1] + (-1, tile, 1))
    return (torch.where(v, t, float("inf")).amin(dim=-2),
            torch.where(v, t, float("-inf")).amax(dim=-2))


def box_gap2(q_min, q_max, p_min, p_max) -> Tensor:
    """Squared gap between every query-tile box and every ref-tile box,
    [..., nq, np]: a lower bound of the squared distance of any pair."""
    gap = torch.clamp(torch.maximum(q_min[..., :, None, :] - p_max[..., None, :, :],
                                    p_min[..., None, :, :] - q_max[..., :, None, :]),
                      min=0.0)
    return (gap * gap).sum(-1)


def admissible_lists(q_min, q_max, p_min, p_max, max_dist):
    """Exact AABB-pair lower bounds -> (list int32[..., nq, np],
    count int32[..., nq]).  Rows hold the admissible ref-tile ids first, in
    ascending order (a stable sort, as in the JAX package).  Empty boxes
    (a tile with no valid lane) admit nothing."""
    adm = ((box_gap2(q_min, q_max, p_min, p_max) <= r2_of(max_dist))
           & (q_min[..., 0] <= q_max[..., 0])[..., :, None]
           & (p_min[..., 0] <= p_max[..., 0])[..., None, :])
    order = torch.argsort((~adm).to(torch.int8), dim=-1, stable=True)
    return order.to(torch.int32), adm.sum(-1, dtype=torch.int32)


def tile_prepare_plain(xyz: Tensor, mask, center: Tensor, tile: int = TP):
    """``tile_prepare``'s plain version (module docstring)."""
    valid = xyz[..., 0].abs() < VALID_ABS
    if mask is not None:
        valid = valid & mask
    p = torch.where(valid[..., None], xyz - center[..., None, :], FAR)
    pad = (-xyz.shape[-2]) % tile
    p = F.pad(p, (0, 0, 0, pad), value=FAR)
    p_min, p_max = tile_aabbs(p, F.pad(valid, (0, pad)), tile)
    return p.transpose(-1, -2).contiguous(), p_min, p_max


def tile_plan_plain(xyz: Tensor, mask, center: Tensor, p_min: Tensor, p_max: Tensor,
                    max_dist, tile: int = TQ):
    """``tile_plan``'s plain version (module docstring)."""
    q = xyz - center[..., None, :]
    valid = q[..., 0].abs() < VALID_ABS
    if mask is not None:
        valid = valid & mask
    pad = (-xyz.shape[-2]) % tile
    q_min, q_max = tile_aabbs(F.pad(q, (0, 0, 0, pad)), F.pad(valid, (0, pad)), tile)
    tile_list, tile_count = admissible_lists(q_min, q_max, p_min, p_max, max_dist)
    return tile_list, tile_count, q_min, q_max


def check_points(name: str, xyz: Tensor, mask=None, dim: int = 3) -> None:
    """Raise unless ``xyz`` is what the kernels take: contiguous float32
    [B, N, 3] (``dim`` 3) or [N, 3] (``dim`` 2) on a CUDA device, with a
    contiguous bool mask of its leading shape (or none) beside it."""
    if xyz.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {xyz.device}")
    if xyz.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {xyz.dtype}")
    if xyz.dim() != dim or xyz.shape[-1] != 3 or not xyz.is_contiguous():
        raise ValueError(f"{name} must be contiguous {'[B, N, 3]' if dim == 3 else '[N, 3]'}, "
                         f"got {tuple(xyz.shape)}")
    if mask is not None:
        if mask.device != xyz.device:
            raise ValueError(f"{name} and its mask are on different devices")
        if mask.dtype != torch.bool:
            raise TypeError(f"the mask of {name} must be bool, got {mask.dtype}")
        if mask.shape != xyz.shape[:-1] or not mask.is_contiguous():
            raise ValueError(f"the mask of {name} must be contiguous "
                             f"{tuple(xyz.shape[:-1])}, got {tuple(mask.shape)}")


def stream_of(t: Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def scratch(device, *words: int):
    """One uninitialised buffer cut into pieces of ``words`` 4-byte words
    each, every piece 16-byte aligned.  Returns (buffer, [address of each
    piece]).  The caller holds the buffer until its kernels are enqueued;
    torch's allocator then hands the memory out again only to work that
    follows them on the stream."""
    sizes = [(w + 3) // 4 * 4 for w in words]
    buf = torch.empty((sum(sizes),), dtype=torch.int32, device=device)
    pieces, at = [], buf.data_ptr()
    for size in sizes:
        pieces.append(at)
        at += 4 * size
    return buf, pieces


def piece(buf: Tensor, address: int, shape) -> Tensor:
    """The piece of a ``scratch`` buffer at ``address`` as an int32 tensor."""
    at = (address - buf.data_ptr()) // 4
    return buf[at:at + int(np.prod(shape))].view(shape)


def check_constants(lib, name: str) -> None:
    """Raise unless ``lib`` was compiled with this module's constants."""
    tq, tp, far, valid_abs = ctypes.c_int(), ctypes.c_int(), ctypes.c_float(), ctypes.c_float()
    lib.tile_constants(ctypes.byref(tq), ctypes.byref(tp), ctypes.byref(far),
                       ctypes.byref(valid_abs))
    built = (tq.value, tp.value, far.value, valid_abs.value)
    if built != (TQ, TP, FAR, VALID_ABS):
        raise RuntimeError(f"the {name} library was built with (TQ, TP, FAR, VALID_ABS) = "
                           f"{built}, this module expects {(TQ, TP, FAR, VALID_ABS)}")


_fns = None


def _kernels():
    global _fns
    if _fns is None:
        lib = _build.library("tiles")
        check_constants(lib, "tiles")
        prepare, plan = lib.tile_prepare_launch, lib.tile_plan_launch
        prepare.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 4
        plan.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
                         + [ctypes.c_int, ctypes.c_float] + [ctypes.c_void_p] * 5)
        prepare.restype = plan.restype = ctypes.c_int
        _fns = (prepare, plan)
    return _fns


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def tile_prepare(xyz: Tensor, mask, center: Tensor):
    """Reference side of the plan (module docstring); one kernel launch."""
    global prepare_launches
    if xyz.device.type == "cpu":
        return tile_prepare_plain(xyz, mask, center)
    check_points("xyz", xyz, mask)
    B, n, _ = xyz.shape
    if n == 0:
        raise ValueError("xyz holds no points")
    np_tiles = -(-n // TP)
    soa = torch.empty((B, 3, np_tiles * TP), dtype=torch.float32, device=xyz.device)
    boxes = torch.empty((2, B, np_tiles, 3), dtype=torch.float32, device=xyz.device)
    center = center.contiguous()
    err = _kernels()[0](xyz.data_ptr(), _ptr(mask), center.data_ptr(), B, n, soa.data_ptr(),
                        boxes[0].data_ptr(), boxes[1].data_ptr(), stream_of(xyz))
    _build.check(err, "tile_prepare_kernel")
    prepare_launches += 1
    return soa, boxes[0], boxes[1]


def tile_plan(xyz: Tensor, mask, center: Tensor, p_min: Tensor, p_max: Tensor, max_dist):
    """Query side of the plan (module docstring); one kernel launch."""
    global plan_launches
    if xyz.device.type == "cpu":
        return tile_plan_plain(xyz, mask, center, p_min, p_max, max_dist)
    check_points("xyz", xyz, mask)
    B, m, _ = xyz.shape
    nq_tiles, np_tiles = -(-m // TQ), p_min.shape[-2]
    tile_list = torch.empty((B, nq_tiles, np_tiles), dtype=torch.int32, device=xyz.device)
    tile_count = torch.empty((B, nq_tiles), dtype=torch.int32, device=xyz.device)
    boxes = torch.empty((2, B, nq_tiles, 3), dtype=torch.float32, device=xyz.device)
    center, p_min, p_max = center.contiguous(), p_min.contiguous(), p_max.contiguous()
    err = _kernels()[1](xyz.data_ptr(), _ptr(mask), center.data_ptr(), B, m, p_min.data_ptr(),
                        p_max.data_ptr(), np_tiles, admit_r2(max_dist), tile_list.data_ptr(),
                        tile_count.data_ptr(), boxes[0].data_ptr(), boxes[1].data_ptr(),
                        stream_of(xyz))
    _build.check(err, "tile_plan_kernel")
    plan_launches += 1
    return tile_list, tile_count, boxes[0], boxes[1]
