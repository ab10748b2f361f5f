"""The device mesh of the multi-chip path: one rank per device.

Counterpart of the JAX package's ``parallel/mesh.py``.  There a mesh is a
set of devices inside one program, and ``shard_map`` runs a body on each
of them; here each mesh device is a process (a rank of the default
``torch.distributed`` group) that runs the body itself, and the JAX
collectives are plain functions on tensors:

  - ``psum``, ``pmin``, ``pmean``: ``dist.all_reduce`` over the mesh's
    group, on a copy (the input is left as it was);
  - ``all_gather``: every rank's tensor, stacked ``[D, ...]``;
  - ``from_rank0``: rank 0's value on every rank (a ``psum`` to which the
    others add zeros);
  - ``axis_index``: this rank's position on the axis.

On NCCL the collectives are enqueued on the stream and the host never
waits for them; gloo stages CUDA tensors through the host, and so waits.
Every rank must make the same collectives in the same order, so the
callers keep fixed trip counts and never branch on a rank-local value.

``shard_points`` is ``P(axis)`` of the JAX package: the leading dimension
split into D equal contiguous blocks, of which this rank takes its own.
``make_mesh`` registers the mesh under its axis name, which is how the
``"sharded"`` matcher of ``icp.py`` finds it from ``ICPConfig.shard_axis``.
Nothing here starts a process group: ``sharded_slam.init_distributed`` does.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.distributed as dist

from ..utils.device import resolve_device

Tensor = torch.Tensor

DATA_AXIS = "data"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: ``size`` ranks along ``axis``; this process is ``rank``,
    its tensors live on ``device``, and the collectives run over
    ``group``."""

    axis: str
    size: int
    rank: int
    group: object
    device: torch.device

    @property
    def shape(self) -> Dict[str, int]:
        """{axis: size}, as the JAX mesh's ``shape``."""
        return {self.axis: self.size}


_MESHES: Dict[str, Mesh] = {}


def make_mesh(n_devices: Optional[int] = None, axis: str = DATA_AXIS,
              device=None) -> Mesh:
    """A mesh over every rank of the initialized default group, on
    ``device`` (``cuda`` unless the caller asks for the CPU).  A mesh spans
    the whole group: ``n_devices`` may only restate the world size.  NCCL
    needs CUDA tensors; gloo takes tensors on either device."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call sharded_slam.init_distributed() first")
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"a mesh spans every rank of the group: n_devices={n_devices}, "
                         f"world size {world}")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dist.get_backend() == "nccl" and dev.type != "cuda":
        raise ValueError("the NCCL backend needs a CUDA device")
    mesh = Mesh(axis=axis, size=world, rank=dist.get_rank(), group=dist.group.WORLD,
                device=dev)
    _MESHES[axis] = mesh
    return mesh


def mesh_for_axis(axis: str) -> Mesh:
    """The mesh ``make_mesh`` registered under ``axis``, while the process
    group it was built on lives; a mesh whose group was destroyed (or
    replaced by a new one) is dropped from the registry."""
    mesh = _MESHES.get(axis)
    if mesh is None or not dist.is_initialized() or mesh.group is not dist.group.WORLD:
        _MESHES.pop(axis, None)
        raise ValueError(f"no mesh has the axis {axis!r} on a live process group: "
                         f"make_mesh(axis={axis!r}) registers one")
    return mesh


def shard_points(mesh: Mesh, x: Tensor) -> Tensor:
    """This rank's contiguous block of the leading dimension (D equal
    blocks; the length must divide by D, as ``shard_map`` requires)."""
    n = x.shape[0]
    if n % mesh.size:
        raise ValueError(f"a leading dimension of {n} does not split into {mesh.size} "
                         "equal blocks")
    b = n // mesh.size
    return x[mesh.rank * b:(mesh.rank + 1) * b]


def replicated(mesh: Mesh, x):
    """``P()``: every rank holds the whole value."""
    return x


def axis_index(mesh: Mesh) -> int:
    return mesh.rank


def _check(mesh: Mesh, x: Tensor) -> None:
    if x.device.type != mesh.device.type:
        raise ValueError(f"a {x.device.type} tensor in a collective of a mesh on "
                         f"{mesh.device}")


def _all_reduce(mesh: Mesh, x: Tensor, op) -> Tensor:
    _check(mesh, x)
    y = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, op=op, group=mesh.group)
    return y


def psum(mesh: Mesh, x: Tensor) -> Tensor:
    return _all_reduce(mesh, x, dist.ReduceOp.SUM)


def pmin(mesh: Mesh, x: Tensor) -> Tensor:
    return _all_reduce(mesh, x, dist.ReduceOp.MIN)


def pmean(mesh: Mesh, x: Tensor) -> Tensor:
    return psum(mesh, x) / mesh.size


def from_rank0(mesh: Mesh, x: Tensor) -> Tensor:
    """Rank 0's ``x`` on every rank, bit for bit: one ``psum`` to which the
    other ranks add exact zeros.  Values that every rank computes alike
    agree across ranks only to rounding on CUDA (``index_add_``'s atomic
    sums), so a value that must be the same everywhere is rank 0's."""
    return psum(mesh, x if mesh.rank == 0 else torch.zeros_like(x))


def all_gather(mesh: Mesh, x: Tensor) -> Tensor:
    """Every rank's ``x``, stacked [D, ...] in rank order."""
    _check(mesh, x)
    x = x.contiguous()
    out = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(out, x, group=mesh.group)
    return torch.stack(out)


def reduce_winners(mesh: Mesh, d2: Tensor, payload: Tensor):
    """The global nearest neighbour of replicated queries from each rank's
    own candidates: ``d2`` f32[M] (+inf where the rank found nothing) and
    ``payload`` f32[M, P] (what each rank's candidate carries).  The lowest
    d2 wins and, on a tie, the lowest rank.  Three collectives: ``pmin`` of
    d2, ``pmin`` of the claiming rank, and one ``psum`` of the packed
    payload, to which every rank but the winner adds exact zeros.
    Returns (best d2 f32[M], the winner's payload f32[M, P])."""
    best = pmin(mesh, d2)
    claim = torch.where(d2 <= best, float(mesh.rank), float("inf"))
    is_winner = claim == pmin(mesh, claim)
    return best, psum(mesh, torch.where(is_winner[:, None], payload, 0.0))
